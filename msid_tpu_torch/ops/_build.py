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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libraries: dict[tuple, ctypes.CDLL] = {}


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
    processes that build at the same time never load a partial library.
    """
    target = library_path(name, defines)
    if target.exists():
        return target
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked for {nvcc}); set CUDA_HOME")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return target


def load_library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libraries.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            _libraries[(name, defines)] = lib
        return lib
