"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
library goes to ``build/kernels/<name>-<hash>.so`` at the repository root,
keyed by a hash of the source, every local header it includes
(``#include "..."``, found beside it, recursively), the compiler flags and
the ``-D`` defines, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. A
source with many template instantiations is built once per define (K1:
``MSID_C=<width>``), each build holding a part of them. Nothing here runs
at import time.

Every wrapper launches through the same path: ``bind`` looks an entry
point up once per library and sets its ``argtypes`` and ``restype`` then,
and ``call`` passes the current stream, entering the tensor's device only
when it is not the current one, and counts the launch in ``launches``.
After the first call neither takes a lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libraries: dict[tuple, ctypes.CDLL] = {}
_bound: dict[tuple, ctypes._CFuncPtr] = {}
# Launches that ``call`` made in this process, of every kernel together:
# what a CUDA graph's capture recorded (each wrapper also counts its own).
launches = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, each once, in the order first included."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc for inc in _LOCAL_INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the build of ``csrc/<name>.cu`` with ``-D`` ``defines`` goes
    (hash of the source and its local headers + flags + defines)."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    tag = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D<define>`` for each of
    ``defines``) unless its build exists; returns the path.

    The compiler writes to a temporary file that is renamed into place, so
    no process loads a partial library, and one build of a target runs at
    a time: processes that need it together (the ranks of a process group)
    wait on a lock file beside it, which the system releases with its
    holder, and the later ones load the first one's build.
    """
    target = library_path(name, defines)
    if target.exists():
        return target
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); set CUDA_HOME")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            _compile(name, defines, nvcc, target)
    return target


def _compile(name: str, defines: tuple[str, ...], nvcc: str, target: Path) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc={proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process (a
    loaded library is returned without taking the lock)."""
    lib = _libraries.get((name, defines))
    if lib is not None:
        return lib
    with _lock:
        lib = _libraries.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            _libraries[(name, defines)] = lib
        return lib


def bind(name: str, entry: str, argtypes: list, restype=ctypes.c_int,
         defines: tuple[str, ...] = ()) -> ctypes._CFuncPtr:
    """The C function ``entry`` of ``csrc/<name>.cu``'s build with
    ``defines``, its ``argtypes`` and ``restype`` set when it is first
    looked up and never again; later calls are one dictionary lookup."""
    key = (name, defines, entry)
    fn = _bound.get(key)
    if fn is not None:
        return fn
    lib = load_library(name, defines)
    with _lock:
        fn = _bound.get(key)
        if fn is None:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = restype
            _bound[key] = fn
        return fn


def call(fn: ctypes._CFuncPtr, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with the current CUDA stream of ``device``, the
    last argument of every launching entry point; ``device`` is entered
    only when it is not the current device. Returns what ``fn`` returns,
    and counts a launch in ``launches`` when that is 0 (success).
    The device and the stream come from torch's raw getters (what its own
    generated launchers call): one C call each, where
    ``torch.cuda.current_stream`` builds a ``Stream`` object per call."""
    global launches
    index = device.index
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err == 0:
        launches += 1
    return err


@functools.lru_cache(maxsize=None)
def multiprocessors(device: torch.device) -> int:
    """The SM count of a CUDA device, asked of CUDA once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def tensor_map_encodes(name: str, defines: tuple[str, ...] = ()) -> int:
    """Tensor maps the build of ``csrc/<name>.cu`` with ``defines`` has
    encoded in this process (its ``msid_tensor_map_encodes``)."""
    return bind(name, "msid_tensor_map_encodes", [], ctypes.c_longlong, defines)()
