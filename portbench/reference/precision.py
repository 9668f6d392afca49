"""Precision of the reference and of its lower-precision control.

``exact_fp32()``: float32 products are float32 on the card (no TF32) inside
the block. ``fp8_operands``: the control, the reference computed in the
step below the bfloat16 the configurations state, as fp8 training and
inference compute: every operand and every result of a product, and the
model's input and output, is scaled per tensor to float8 e4m3 (largest
448), rounded to it and scaled back, with float32 accumulation; in the
backward the gradient reaching each of those points is rounded likewise to
float8 e5m2 (largest 57344), so that the backward's products take fp8
operands too.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _rounded(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _rounded(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _rounded(grad, torch.float8_e5m2, 57344.0)


def fp8_operands(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)
