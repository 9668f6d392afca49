"""Train-mode BatchNorm as one kernel set (N1): moments, apply, backward.

``Norm`` (``models/blocks.py``) sends a train-mode batch norm here when
``serves`` says so: x on a card in bf16 or fp32, and no cross-device
group. ``batch_norm_train`` is the function, an autograd ``Function``
whose forward and backward each make three launches of
``csrc/batchnorm.cu``. It reads x as it lies and copies it to no other
layout: a tensor the kernels cannot read raises (``check``), so a norm
never leaves the kernels unnoticed.

The arithmetic is flax's BatchNorm as the port's composition computes it
(``Norm._train_batch_norm``), written as the kernels compute it:

    s1 = sum x, s2 = sum x^2                          per channel, fp32 (M values)
    mean = s1 / M, var = max(s2 / M - mean^2, 0)      the biased variance
    rstd = rsqrt(var + eps), scale = w * rstd, shift = b - mean * scale
    running_mean += momentum * (mean - running_mean), the same for var
    y = x * scale + shift                             in x's dtype

and backward, from the saved x, mean and rstd alone:

    db = sum dy, dw = rstd * sum dy * (x - mean)
    k = w * rstd, cc = k * db / M, b2 = k * rstd * dw / M
    dx = k * dy - cc - (x - mean) * b2                in x's dtype

No kernel of the TPU package is replaced: the JAX package leaves the norm
to XLA (``csrc/batchnorm.cu`` says what bounds it and how it is laid out).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.autograd.graph import increment_version

from msid_tpu_torch.ops import _build

MAX_CHANNELS = 2048       # R * C of a CTA fits its 16 KB of shared memory
_MAX_ROW_THREADS = 512    # C / VEC threads at most own a row
_THREADS = 256            # a CTA's target size
_UNROLL = 4               # rows a thread loads at once (csrc: kUnroll)
_MIN_ROWS = 64            # rows a CTA reduces at least: the workspace stays small
_CTAS_PER_SM = 4          # reduce and apply CTAs a launch (one wave)
DTYPES = (torch.bfloat16, torch.float32)

_P = ctypes.c_void_p
_I, _L, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLAN = [_I, _I, _L, _I, _I, _L, _I]       # bf16, vec, rows, C, parts, per, threads
_FORWARD_ARGS = [_P] * 7 + _PLAN + [_F, _F, _P]
_BACKWARD_ARGS = [_P] * 6 + _PLAN + [_P]


def vector(x: torch.Tensor) -> int:
    """Elements a kernel thread loads at once: a 16-byte vector when C is a
    multiple of one and x starts on 16 bytes, else 1."""
    width = 16 // x.element_size()
    return width if x.shape[1] % width == 0 and x.data_ptr() % 16 == 0 else 1


def serves(x: torch.Tensor) -> bool:
    """Whether ``Norm`` sends a train-mode batch norm of x (with no
    cross-device group) to the kernel set: x on a card in bf16 or fp32."""
    return x.device.type == "cuda" and x.dtype in DTYPES


def check(x: torch.Tensor, *params: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernels read x and ``params``
    (weight, bias, running mean, running var) as they lie: x bf16 or fp32,
    4-D, non-empty and channels-last (an NCHW tensor is not copied: no norm
    of the repo's decoders sees one), at most ``MAX_CHANNELS`` channels
    and ``_MAX_ROW_THREADS`` loads a row; the parameters fp32 contiguous
    ``[C]`` on x's device; and x on a card. The error names the first of
    these that fails."""
    def refuse(what: str) -> None:
        raise ValueError(f"the batchnorm kernels cannot read {what}: got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()} on {x.device}")

    if x.dtype not in DTYPES:
        refuse("a dtype other than bf16 or fp32")
    if x.dim() != 4 or x.numel() == 0:
        refuse("a tensor that is not 4-D and non-empty")
    if not x.is_contiguous(memory_format=torch.channels_last):
        refuse("a tensor that is not channels-last")
    c = x.shape[1]
    if c > MAX_CHANNELS or c // vector(x) > _MAX_ROW_THREADS:
        refuse(f"more than {MAX_CHANNELS} channels or {_MAX_ROW_THREADS} loads a row")
    if not all(p.device == x.device and p.dtype == torch.float32 and p.is_contiguous()
               and tuple(p.shape) == (c,) for p in params):
        refuse("parameters other than fp32 contiguous [C] on x's device")
    if x.device.type != "cuda":
        refuse("a tensor off the card")


@functools.lru_cache(maxsize=512)
def geometry(rows: int, c: int, vec: int, sms: int) -> tuple[int, int, int]:
    """``(parts, per, threads)`` of the launches on ``rows`` rows of C loaded
    ``vec`` elements at a time, on a card of ``sms`` SMs: ``threads`` = (C /
    vec) x R row slots, R = 256 // (C / vec) (at least 1); CTA p reduces and
    applies rows ``[p * per, + per)``, about ``_CTAS_PER_SM`` CTAs an SM and
    at least ``_MIN_ROWS`` rows each."""
    v = c // vec
    slots = max(1, _THREADS // v)
    per = max(_MIN_ROWS, slots * _UNROLL, -(-rows // (_CTAS_PER_SM * sms)))
    return -(-rows // per), per, v * slots


def plan(x: torch.Tensor) -> tuple:
    """The launches' arguments after the pointers: ``(bf16, vec, rows, C,
    parts, per, threads)``."""
    c = x.shape[1]
    rows, vec = x.numel() // c, vector(x)
    return (int(x.dtype == torch.bfloat16), int(vec > 1), rows, c,
            *geometry(rows, c, vec, _build.multiprocessors(x.device)))


def _forward_kernels(x, weight, bias, running_mean, running_var, momentum, eps):
    """y and the ``[4, C]`` statistics (a view of the launches' workspace),
    the running statistics updated in place: three kernels, one call."""
    args = plan(x)
    c, parts = args[3:5]
    work = torch.empty(parts * 2 * c + 4 * c, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    _build.launch("batchnorm", "msid_bn_forward", _FORWARD_ARGS, x.device, x.data_ptr(),
                  y.data_ptr(), work.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  running_mean.data_ptr(), running_var.data_ptr(), *args, momentum, eps,
                  kernels=3)
    for t in (running_mean, running_var):      # written in place by the kernel
        increment_version(t)
    return y, work[parts * 2 * c:].view(4, c)


def _backward_kernels(x, dy, weight, stats, need_dx: bool):
    """dx (None unless ``need_dx``) and the ``[5, C]`` (dw, db, k, cc, b2):
    three kernels (two without dx), one call. A dy that is not
    channels-last in x's dtype on 16 bytes is copied into one first."""
    if (not dy.is_contiguous(memory_format=torch.channels_last) or dy.dtype != x.dtype
            or dy.data_ptr() % 16 != 0):
        dy = torch.empty_like(x).copy_(dy)
    args = plan(x)
    c, parts = args[3:5]
    work = torch.empty(parts * 2 * c + 5 * c, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    _build.launch("batchnorm", "msid_bn_backward", _BACKWARD_ARGS, x.device, x.data_ptr(),
                  dy.data_ptr(), dx.data_ptr() if need_dx else None, stats.data_ptr(),
                  work.data_ptr(), weight.data_ptr(), *args, kernels=2 + need_dx)
    return dx, work[parts * 2 * c:].view(5, c)


class _BatchNormTrain(torch.autograd.Function):
    """The kernels; only x (in its own dtype) and the ``[4, C]`` statistics
    are saved."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        y, stats = _forward_kernels(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, grads = _backward_kernels(x, dy, weight, stats, ctx.needs_input_grad[0])
        return dx, grads[0], grads[1], None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float) -> torch.Tensor:
    """Train-mode batch norm of an NCHW-shaped x on the kernel set:
    normalised by the batch's moments (the biased variance),
    ``running_mean``/``running_var`` moved toward them by ``momentum`` in
    place, and differentiable in x, weight and bias. Raises where ``check``
    refuses x or the parameters."""
    check(x, weight, bias, running_mean, running_var)
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps)
