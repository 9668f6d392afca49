"""How the port's kernels are built, on the CPU: the key of a build covers
the source and every local header it includes, so an edited header is
rebuilt; and the SASS counter's parsing of a ``cuobjdump -sass`` listing."""

import ast
import collections
import contextlib
import ctypes
import re

import pytest
import torch

from msid_tpu_torch.benchmarks import sass_count
from msid_tpu_torch.ops import _build


def test_library_path_follows_every_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n  # include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    assert _build.sources("k") == [tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh")]
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "unused.cuh").write_text("// edited, still not included\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")         # included through a.cuh
    edited = _build.library_path("k")
    assert edited != first and edited.name.startswith("k-")
    assert _build.library_path("k", ("MSID_C=48",)) not in (first, edited)


def test_the_bf16_resblocks_share_one_header():
    """K1 and K3 are two kernels of one source, built once per width, on the
    device code of one header; every source launches through the one host
    header ``launch.cuh``, and K2 includes nothing else."""
    header = _build.CSRC / "hopper_common.cuh"
    launch = _build.CSRC / "launch.cuh"
    assert _build.sources("resblock") == [_build.CSRC / "resblock.cu", header, launch]
    source = (_build.CSRC / "resblock.cu").read_text()
    for name in ("resblock_kernel", "resblock_v2_kernel", "msid_resblock_forward",
                 "msid_resblock_v2_forward"):
        assert f" {name}(" in source or f"\n    {name}(" in source
    assert not (_build.CSRC / "resblock_v2.cu").exists()
    assert _build.sources("noise") == [_build.CSRC / "noise.cu", launch]
    for name in ("resblock_fp32", "any_dma", "batchnorm", "layernorm"):
        assert _build.sources(name) == [_build.CSRC / f"{name}.cu", launch]


def test_sass_count_parses_a_listing():
    listing = """
	code for sm_90a
		Function : _Z6kernelPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
                                                                      /* 0x000fe20000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;     /* 0x0000000403027225 */
        /*0020*/              @!P0 LOP3.LUT R5, R6, R7, R8, 0x96, !PT ;
        /*0030*/                   MUFU.LG2 R9, R9 ;
        /*0040*/                   NOP ;
        /*0050*/               @P1 BRA 0x70 ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""
    got = sass_count.count(listing)
    (first, a), (_, b) = got.items()
    assert "kernel" in first
    assert a == {"instructions": 5, "IMAD.WIDE": 1, "LOP3": 1, "MUFU": 1, "BRA": 1,
                 "op LDC": 1, "op IMAD": 1, "op LOP3": 1, "op MUFU": 1, "op BRA": 1}
    assert b == {"instructions": 1, "op EXIT": 1}


LOOPS = """
	code for sm_90a
		Function : _Z6kernelPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;             /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   FFMA R5, R4, R4, R5 ;
.L_x_0:
        /*0030*/                   IADD3 R6, R6, -0x1, RZ ;
        /*0040*/               @P0 BRA `(.L_x_0) ;
        /*0050*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0060*/               @P1 BRA `(.L_x_1) ;
        /*0070*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0080*/                   LDS R9, [R8] ;
        /*0090*/                   NOP ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*00b0*/              @!P1 BRA 0x70 ;
        /*00c0*/                   BRA `(.L_x_2) ;
.L_x_2:
        /*00d0*/                   EXIT ;
"""


def test_sass_loops_count_one_pass_of_each_loop_and_find_the_element_loops():
    """A backward branch closes a loop: its instructions run from the
    branch's target (a label or an address) to the branch, a nested loop's
    once; forward branches close none. Of the loops that load and store
    global memory, the one that reads shared memory (the stripes) is the
    gated one."""
    (name, loops), = sass_count.loops(LOOPS).items()
    assert "kernel" in name
    assert loops == [
        {"start": 0x10, "end": 0x60, "instructions": 6, "LDG": 1, "STG": 1, "LDS": 0},
        {"start": 0x30, "end": 0x40, "instructions": 2, "LDG": 0, "STG": 0, "LDS": 0},
        {"start": 0x70, "end": 0xb0, "instructions": 4, "LDG": 1, "STG": 1, "LDS": 1},
    ]
    found = sass_count.element_loops(loops)
    assert found == {"plain": loops[0], "gated": loops[2]}
    with pytest.raises(ValueError, match="two element loops"):
        sass_count.element_loops(loops[:2])


class _FakeEntry:
    """A C function as ctypes gives it, counting assignments of its types."""

    def __init__(self):
        self.__dict__["sets"] = []

    def __setattr__(self, name, value):
        self.sets.append(name)
        self.__dict__[name] = value

    def __call__(self, *args):
        return len(args)


def test_bind_sets_an_entry_points_types_once(monkeypatch):
    """An entry point is looked up and typed once per library and entry;
    later binds are a dictionary lookup that loads nothing."""
    entry, loads = _FakeEntry(), []

    class Library:
        msid_entry = entry

    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "load_library",
                        lambda name, defines=(): loads.append((name, defines)) or Library)
    types = [ctypes.c_void_p, ctypes.c_int]
    for _ in range(3):
        fn = _build.bind("k", "msid_entry", types, defines=("MSID_C=48",))
    assert fn is entry and fn.argtypes == types and fn.restype is ctypes.c_int
    assert entry.sets == ["argtypes", "restype"] and loads == [("k", ("MSID_C=48",))]
    other = _build.bind("k", "msid_entry", types, ctypes.c_longlong)   # another build
    assert other is entry and len(loads) == 2 and entry.restype is ctypes.c_longlong


def test_a_loaded_library_is_returned_without_the_lock(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock was taken for a loaded library")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setattr(_build, "_libraries", {("k", ()): lib})
    monkeypatch.setattr(_build, "_lock", NoLock())
    assert _build.load_library("k") is lib


def _bound_entry(monkeypatch, fn, name="k", entry="msid_entry", defines=()):
    """``fn`` as the bound ``entry`` of ``csrc/<name>.cu``'s build, and an
    empty ``launched``."""
    monkeypatch.setattr(_build, "_bound", {(name, defines, entry): fn})
    monkeypatch.setattr(_build, "launched", collections.Counter())


@pytest.mark.parametrize("current,entered", [(0, False), (1, True)])
def test_launch_passes_the_stream_and_enters_only_another_device(monkeypatch, current,
                                                                 entered):
    """The stream of the tensor's device goes last; the device is entered
    only when it is not the current one."""
    seen, calls = [], []

    @contextlib.contextmanager
    def device(d):
        seen.append(d)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    _bound_entry(monkeypatch, lambda *a: calls.append(a) or 0, defines=("MSID_C=48",))
    target = torch.device("cuda", 0)
    _build.launch("k", "msid_entry", [], target, 7, 8, defines=("MSID_C=48",))
    assert calls == [(7, 8, 1234)]
    assert seen == ([target] if entered else [])


@pytest.mark.parametrize("rc,kernels,counted", [(0, 1, 1), (0, 3, 3), (700, 1, 0)])
def test_launch_counts_kernels_where_the_entry_point_succeeded(monkeypatch, rc, kernels,
                                                               counted):
    """``launched[entry]`` moves by the device kernels the entry started, for
    every kernel alike (what a graph capture counts); a refused launch
    raises, naming the source, the entry and the CUDA error, and counts
    nothing."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1,
                        raising=False)
    _bound_entry(monkeypatch, lambda *a: rc)
    _build.launched["msid_other"] = 5
    if rc:
        with pytest.raises(RuntimeError, match=f"csrc/k.cu: msid_entry .*cudaError {rc}"):
            _build.launch("k", "msid_entry", [], torch.device("cuda", 0), 7, kernels=kernels)
    else:
        _build.launch("k", "msid_entry", [], torch.device("cuda", 0), 7, kernels=kernels)
    assert _build.launched == collections.Counter(msid_other=5, msid_entry=counted)


def _launching_entries() -> set[str]:
    """The C entry points of ``csrc/*.cu`` that take a stream: those that
    launch a kernel."""
    found = set()
    for path in _build.CSRC.glob("*.cu"):
        for entry, params in re.findall(r'extern "C" \w+ (msid_\w+)\(([^)]*)\)',
                                        path.read_text()):
            if params.split(",")[-1].split()[-1] == "stream":
                found.add(entry)
    return found


def test_every_launch_goes_through_the_one_path():
    """Read the port's sources: no module but ``ops/_build.py`` defines a
    launch counter, looks a library up or calls ``call``, and every entry
    point a module binds outside ``_build.launch`` is one that launches
    nothing (a stream-taking entry is reached through ``launch`` alone)."""
    launching = _launching_entries()
    assert launching == {"msid_resblock_forward", "msid_resblock_v2_forward",
                         "msid_resblock_fp32_forward", "msid_noise_forward",
                         "msid_any_dma_scale", "msid_bn_forward", "msid_bn_backward",
                         "msid_bias_free_norm"}
    package = _build.CSRC.parent
    bound, launched = set(), set()
    for path in sorted(package.rglob("*.py")):
        if path == package / "ops" / "_build.py":
            continue
        where = path.relative_to(package)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                assert not any("launch" in n for n in node.names), where
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) and node in tree.body:
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                assert not any(isinstance(t, ast.Name) and "launch" in t.id
                               for t in targets), where
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("_build"):
                assert not {a.name for a in node.names} & {"bind", "launch", "launched"}, where
            if not isinstance(node, ast.Call):
                continue
            func = ast.unparse(node.func)
            assert func.split(".")[-1] not in ("load_library", "CDLL"), (where, func)
            assert func != "_build.call", where
            if func in ("_build.bind", "_build.launch"):
                entry = node.args[1]
                if isinstance(entry, ast.Constant):
                    (bound if func == "_build.bind" else launched).add(entry.value)
                else:
                    assert func == "_build.launch", (where, ast.unparse(node))
    assert bound and not bound & launching
    assert launched <= launching
