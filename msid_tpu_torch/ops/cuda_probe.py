"""Asynchronous-copy probe: the port of K5.

Counterpart of the ``any_dma`` variant of ``benchmarks/pallas_probe.py``:
copy a ``[rows, W, C]`` fp32 array into on-chip memory with an explicit
asynchronous copy and its completion barrier, then write ``x * 2``. On the
TPU it gated the halo-window-by-DMA design of the fused ResidualBlock; here
it gates the TMA window load of K3 (``csrc/resblock.cu``): a tensor map
from ``cuTensorMapEncodeTiled``, ``cp.async.bulk.tensor`` and an
``mbarrier`` (``csrc/any_dma.cu``).

``any_dma_scale`` launches the kernel on a CUDA tensor or raises; a CPU
tensor takes the plain version ``any_dma_scale_reference``.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches so far in this process; chip_smoke.py zeroes the count
# before driving a path and reads it after.
launches_any_dma = 0


def any_dma_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the probe: ``x * 2``."""
    return x * 2


def any_dma_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` for x ``[rows, W, C]`` fp32 through an asynchronous bulk copy
    into shared memory. A row of ``W * C`` values must be a multiple of 16
    bytes (the tensor map's stride rule)."""
    global launches_any_dma
    if x.dim() != 3:
        raise ValueError(f"x must be [rows, W, C], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"the async-copy probe takes float32, got {x.dtype}")
    rows, n = x.shape[0], x.shape[1] * x.shape[2]
    if rows < 1 or n < 4 or n % 4 != 0:
        raise ValueError(f"a row of W*C = {n} fp32 values is not a positive "
                         f"multiple of 16 bytes (shape {tuple(x.shape)})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return any_dma_scale_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"the async-copy probe kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty_like(x)

    from msid_tpu_torch.ops._build import load_library

    fn = load_library("any_dma").msid_any_dma_scale
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"any_dma kernel launch failed: error {err}")
    launches_any_dma += 1
    return out
