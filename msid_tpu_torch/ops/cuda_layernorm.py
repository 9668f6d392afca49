"""Restormer's bias-free LayerNorm as one kernel (N2).

``y = x * rsqrt(var_c(x) + eps) * w`` over the channels of each pixel of a
channels-last ``[B, C, H, W]`` tensor, in one launch of
``csrc/layernorm.cu``: x read once and y written once, where the port's
composition (``models/restormer.py``, ``bias_free_norm_plain``) makes
five passes. The kernel accumulates in fp32, takes the variance about
each row's mean in a second pass over the row (biased, as
``var(correction=0)``), and rounds ``x * rstd * w`` once to the output
dtype, which is torch's promotion of x's and w's: bf16 for both bf16,
else fp32.

``bias_free_norm`` reads x as it lies and copies it to no other layout: a
tensor the kernel cannot read raises (``check``), so a norm never leaves
the kernel unnoticed. ``bias_free_norm_op`` is the operator
``msid::bias_free_norm`` on it, which ``models/restormer.py`` calls on a
card: its fake implementation keeps the kernel in a program that
``torch.export`` traces, and its backward (``bias_free_norm_backward``, the
closed-form gradient in PyTorch: Restormer's training is not ported) lets
a forward under autograd run the kernel too. No kernel of the TPU package
is replaced: the JAX package has no Restormer.
"""

from __future__ import annotations

import ctypes

import torch

from msid_tpu_torch.ops import _build

WIDTHS = (48, 96, 192, 384)     # C = 48 * 2^k: the source's instances
# (x dtype, w dtype) -> the source's ``kinds``; y is torch's promotion of the two
KINDS = {(torch.bfloat16, torch.bfloat16): 0, (torch.float32, torch.float32): 1,
         (torch.bfloat16, torch.float32): 2}

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
         ctypes.c_int, _P]      # x, w, y, kinds, C, rows, eps, sms, stream


def check(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel reads x and ``weight`` as they
    lie: x 4-D, non-empty, channels-last, starting on 16 bytes, with C in
    ``WIDTHS``; x and w a dtype pair of ``KINDS``; w contiguous ``[C]`` on
    16 bytes on x's device; and x on a card. The error names the first of
    these that fails."""
    def refuse(what: str) -> None:
        raise ValueError(f"the bias-free LayerNorm kernel cannot read {what}: got x "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}, "
                         f"w {weight.dtype} {tuple(weight.shape)} on {weight.device}")

    if (x.dtype, weight.dtype) not in KINDS:
        refuse("dtypes other than bf16 or fp32 x with w in x's dtype or fp32")
    if x.dim() != 4 or x.numel() == 0:
        refuse("a tensor that is not 4-D and non-empty")
    if not x.is_contiguous(memory_format=torch.channels_last):
        refuse("a tensor that is not channels-last")
    if x.shape[1] not in WIDTHS:
        refuse(f"a width other than {WIDTHS}")
    if weight.device != x.device or tuple(weight.shape) != (x.shape[1],) \
            or not weight.is_contiguous():
        refuse("a weight other than a contiguous [C] on x's device")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        refuse("a tensor that does not start on 16 bytes")
    if x.device.type != "cuda":
        refuse("a tensor off the card")


def bias_free_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(var_c(x) + eps) * weight`` for a channels-last x on a
    card: a new channels-last tensor of torch's promotion of the two dtypes,
    from one kernel launch on the current stream. Raises where ``check``
    refuses x or the weight."""
    check(x, weight)
    y = torch.empty(x.shape, dtype=torch.result_type(x, weight), device=x.device,
                    memory_format=torch.channels_last)
    c = x.shape[1]
    _build.launch("layernorm", "msid_bias_free_norm", _ARGS, x.device, x.data_ptr(),
                  weight.data_ptr(), y.data_ptr(), KINDS[x.dtype, weight.dtype], c,
                  x.numel() // c, eps, _build.multiprocessors(x.device))
    return y


# The operator is defined on a library fragment, its kernel registered for
# CUDA tensors as it is: ``torch.library.custom_op`` would wrap the kernel
# so that its first call imports torch._dynamo (seconds of every process's
# set-up).
_LIB = torch.library.Library("msid", "FRAGMENT")
_LIB.define("bias_free_norm(Tensor x, Tensor weight, float eps) -> Tensor")
_LIB.impl("bias_free_norm", bias_free_norm, "CUDA")
bias_free_norm_op = torch.ops.msid.bias_free_norm.default


@torch.library.register_fake("msid::bias_free_norm", lib=_LIB)
def _bias_free_norm_fake(x, weight, eps):
    return torch.empty(x.shape, dtype=torch.promote_types(x.dtype, weight.dtype),
                       device=x.device, memory_format=torch.channels_last)


def bias_free_norm_backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``y = x * r * w``, ``r = rsqrt(var_c(x) + eps)``, in
    float32 from x, w and dy: ``dx = r g - r^3 (x - mean_c x) mean_c(g x)``
    with ``g = dy w``, and ``dw`` the sum over the pixels of ``dy x r``;
    dx in x's dtype, dw in w's."""
    xf = x.float().permute(0, 2, 3, 1)                          # [B, H, W, C]
    dyf = dy.float().permute(0, 2, 3, 1)
    centred = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(centred.square().mean(dim=-1, keepdim=True) + eps)
    g = dyf * weight.float()
    dx = rstd * g - rstd.pow(3) * centred * (g * xf).mean(dim=-1, keepdim=True)
    dw = (dyf * xf * rstd).sum(dim=(0, 1, 2))
    return dx.to(x.dtype).permute(0, 3, 1, 2), dw.to(weight.dtype)


def _save_for_backward(ctx, inputs, output):
    x, weight, ctx.eps = inputs
    ctx.save_for_backward(x, weight)


def _backward(ctx, dy):
    x, weight = ctx.saved_tensors
    return (*bias_free_norm_backward(x, weight, dy, ctx.eps), None)


torch.library.register_autograd("msid::bias_free_norm", _backward,
                                setup_context=_save_for_backward, lib=_LIB)
