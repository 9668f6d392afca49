"""Asynchronous-copy probe: the port of K5.

Counterpart of the ``any_dma`` variant of ``benchmarks/pallas_probe.py``:
copy a ``[rows, W, C]`` fp32 array into on-chip memory with an explicit
asynchronous copy and its completion barrier, then write ``x * 2``. On the
TPU it gated the halo-window-by-DMA design of the fused ResidualBlock; here
it gates the TMA path of K1 and K3 (``csrc/resblock.cu``): a tensor map
from ``cuTensorMapEncodeTiled``, ``cp.async.bulk.tensor`` and an
``mbarrier``, one box of at most 32 x 256 values a CTA
(``csrc/any_dma.cu``).

``any_dma_scale`` launches the kernel on a CUDA tensor or raises; a CPU
tensor takes the plain version ``any_dma_scale_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from msid_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def any_dma_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the probe: ``x * 2``."""
    return x * 2


def any_dma_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 2`` for x ``[rows, W, C]`` fp32 through an asynchronous bulk copy
    into shared memory. A row of ``W * C`` values must be a multiple of 16
    bytes (the tensor map's stride rule)."""
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
    _build.launch("any_dma", "msid_any_dma_scale", _ARGTYPES, x.device,
                  x.data_ptr(), out.data_ptr(), rows, n)
    return out
