"""How the port's kernels are built, on the CPU: the key of a build covers
the source and every local header it includes, so an edited header is
rebuilt; and the SASS counter's parsing of a ``cuobjdump -sass`` listing."""

import pytest

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
    device code of one header; K2 includes none."""
    header = _build.CSRC / "hopper_common.cuh"
    assert _build.sources("resblock") == [_build.CSRC / "resblock.cu", header]
    source = (_build.CSRC / "resblock.cu").read_text()
    for name in ("resblock_kernel", "resblock_v2_kernel", "msid_resblock_forward",
                 "msid_resblock_v2_forward"):
        assert f" {name}(" in source or f"\n    {name}(" in source
    assert not (_build.CSRC / "resblock_v2.cu").exists()
    assert _build.sources("noise") == [_build.CSRC / "noise.cu"]


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
