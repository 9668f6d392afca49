"""Convolutional building blocks of the decoder (PyTorch, NCHW channels-last).

Counterparts of ``msid_tpu/models/blocks.py``: ``Norm``, ``ConvBlock``,
``ResidualBlock``, ``UpsampleBlock``, ``DepthwiseSeparableConv``,
``SqueezeExcitation`` and ``SpatialAttention``. Tensors are NCHW in shape
and channels-last in memory, so that ``x.permute(0, 2, 3, 1)`` is the
contiguous NHWC view the fused ResidualBlock kernel takes. GELU is the tanh
approximation throughout (flax ``nn.gelu``'s default), and every conv pads
as XLA's ``SAME`` does (``SameConv2d``). The eval-mode batch-norm
``ResidualBlock`` reaches a hand-written kernel (K1 or K4), and so does a
train-mode batch ``Norm`` on a card (the set N1, ``ops/cuda_norm.py``, in
place of the fp32 composition XLA fuses on the TPU); the other blocks are
library convs, as their JAX counterparts reach no Pallas kernel.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.ops import cuda_norm
from msid_tpu_torch.ops.cuda_decoder import (
    SUPPORTED_WIDTHS,
    fused_residual_block,
    fused_residual_block_op,
    prepare_bf16_weights,
)
from msid_tpu_torch.utils.profiling import annotate

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch convention: flax momentum 0.9 keeps 0.9 of the old value
GN_EPS = 1e-6       # flax GroupNorm default


# The weight-only operands (folded norms, kernel-layout weights) made in one
# call of an exported program, by module, shared by that call's TTA views;
# None outside such a call (``sharing_weight_operands``).
_SHARED = contextvars.ContextVar("msid_shared_weight_operands", default=None)


@contextlib.contextmanager
def sharing_weight_operands():
    """Inside the block, each module makes its weight-only operands once and
    every later forward of it reuses them: one exported program computes
    them once for all its dihedral views, not once a view."""
    token = _SHARED.set({})
    try:
        yield
    finally:
        _SHARED.reset(token)


def _shared(module: nn.Module, key, make):
    memo = _SHARED.get()
    if memo is None:
        return make()
    if (id(module), key) not in memo:
        memo[id(module), key] = make()
    return memo[id(module), key]


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, cast only when it is not (an exported graph
    records even a cast to the same dtype)."""
    return t if t.dtype == dtype else t.to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """XLA 'SAME' padding: the odd pixel goes after (an even size padded
    for a stride-2 3x3 conv gets (0, 1), not torch's (1, 1))."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv2d(nn.Conv2d):
    """A square ``nn.Conv2d`` padded as XLA's ``SAME`` at any kernel size and
    stride (flax ``nn.Conv``'s default): symmetric ``k // 2`` for an odd
    kernel at stride 1, else ``same_pad`` before an unpadded conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, groups: int = 1):
        self.same = stride == 1 and kernel_size % 2 == 1
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=kernel_size // 2 if self.same else 0, bias=bias,
                         groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same:
            x = same_pad(x, self.kernel_size[0], self.stride[0])
        return super().forward(x)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class Norm(nn.Module):
    """Selectable normalization: ``batch`` or ``group``.

    Parameters and running statistics stay fp32 whatever the model's
    compute dtype. In train mode ``batch`` normalizes with the biased batch
    variance and updates the running stats with it, as flax does.

    Cross-replica BatchNorm (the JAX ``axis_name``, and GSPMD's global
    statistics on a mesh): with a ``data_group`` (``set_data_group``), a
    train-mode ``batch`` norm takes its moments over the global batch, from
    ``[sum x, sum x^2, n]`` summed over the group by an all-reduce whose
    backward sums the gradients too (``parallel/collectives.py``). Eval
    mode and ``group`` norms are per sample and never communicate.

    Without a group, a train-mode ``batch`` norm of a bf16 or fp32 tensor
    on a card (``cuda_norm.serves``) runs the kernel set, inside a
    ``msid.norm.fused`` span, and raises where the kernels cannot read the
    tensor (``cuda_norm.check``); the CPU, a group and other dtypes keep
    the fp32 composition below.
    """

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind not in ("batch", "group"):
            raise ValueError(f"Unknown norm kind: {kind}")
        self.kind = kind
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))
        else:
            groups = min(32, features)
            while features % groups != 0:
                groups -= 1
            self.num_groups = groups

    def __deepcopy__(self, memo: dict):
        from msid_tpu_torch.parallel.collectives import deepcopy_sharing_groups

        return deepcopy_sharing_groups(self, memo, "data_group")

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode BN as ``x * a + b`` (fp32)."""
        weight, bias, mean, var = (_as(t, torch.float32) for t in (
            self.weight, self.bias, self.running_mean, self.running_var))
        a = weight * torch.rsqrt(var + BN_EPS)
        return a, bias - mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "group":
            y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                             self.bias.float(), GN_EPS)
            return y.to(x.dtype)
        if not self.training:
            a, b = _shared(self, x.dtype, lambda: [t.to(x.dtype)[:, None, None]
                                                   for t in self.folded()])
            return x * a + b
        with annotate("msid.norm.train"):
            return self._train_batch_norm(x)

    def _train_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_group is None and cuda_norm.serves(x):
            with annotate("msid.norm.fused"):
                return cuda_norm.batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                                  self.running_var, BN_MOMENTUM, BN_EPS)
        xf = x.float()
        if self.data_group is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            from msid_tpu_torch.parallel.collectives import all_reduce_sum

            c = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // c)
            sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                             (xf * xf).sum(dim=(0, 2, 3)), count]),
                                  self.data_group)
            mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = (mean_sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, BN_MOMENTUM)
            self.running_var.lerp_(var, BN_MOMENTUM)
        scale = self.weight.float() * torch.rsqrt(var + BN_EPS)
        shift = self.bias.float() - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def set_data_group(model: nn.Module, group) -> nn.Module:
    """Make every batch ``Norm`` of ``model`` take its train-mode moments
    over the process group ``group`` (None: over the local batch, as on
    one device). Returns the model."""
    for m in model.modules():
        if isinstance(m, Norm) and m.kind == "batch":
            m.data_group = group
    return model


class ConvBlock(nn.Module):
    """Conv-Norm-GELU-Conv-Norm plus a residual, GELU out. The residual is a
    1x1 conv (no bias, at the block's stride) when the width or the
    stride changes, else the input. No conv has a bias. flax names the
    convs in creation order: ``Conv_0`` is the 1x1 residual when there is
    one, then the two kxk convs (``conv0``, ``conv1`` here)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = "batch"):
        super().__init__()
        self.residual = (SameConv2d(in_features, features, 1, stride, bias=False)
                         if in_features != features or stride != 1 else None)
        self.conv0 = SameConv2d(in_features, features, kernel_size, stride, bias=False)
        self.norm0 = Norm(features, norm)
        self.conv1 = SameConv2d(features, features, kernel_size, bias=False)
        self.norm1 = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.residual is None else self.residual(x)
        y = gelu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        return gelu(y + residual)


class ResidualBlock(nn.Module):
    """Conv3x3-Norm-GELU-Conv3x3-Norm, residual add, GELU.

    In eval mode with BatchNorm the block is the fused kernel's function:
    both BNs fold into a ``[4, C]`` affine and ``fused_residual_block``
    computes it (the Hopper kernel on a CUDA tensor). Under autocast, x
    and both conv weights go to the autocast dtype first, as autocast
    would cast a conv's operands. The folded affine and the weights in the
    kernel's dtype and layout are prepared once and kept on the module
    (``prepared_operands``); they are made again when a source tensor was
    written (its ``_version``), replaced, or the dtype or device changed.
    While the block is being exported (``torch.export``) they are graph ops
    of its parameters instead, made on every call of the exported program
    and never kept, and the block is one ``msid::fused_residual_block``
    node. In train mode, or with GroupNorm, it is plain convs and norms.
    """

    def __init__(self, features: int, norm: str = "batch"):
        super().__init__()
        self.conv0 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm0 = Norm(features, norm)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = Norm(features, norm)
        self._prepared: tuple | None = None     # (key, (w1, w2, affines))

    def train(self, mode: bool = True):
        if mode:
            self._prepared = None               # training rewrites every source
        return super().train(mode)

    def __getstate__(self) -> dict:
        # A copy (copy.deepcopy, pickling) prepares its own operands.
        return {**super().__getstate__(), "_prepared": None}

    @property
    def kept_operands(self) -> tuple | None:
        """The ``(w1, w2, affines)`` that ``prepared_operands`` last made and
        keeps, or None."""
        return None if self._prepared is None else self._prepared[1]

    def prepared_operands(self, dtype: torch.dtype, device: torch.device) -> tuple:
        """``(w1, w2, affines)`` as ``fused_residual_block`` takes them for an
        x of ``dtype`` on ``device``: the fp32 ``[4, C]`` affine of the two
        folded BNs, and the conv weights in ``dtype``: K1's K-major
        operands for bf16 on a card, contiguous HWIO for fp32 on a card,
        HWIO views on the CPU."""
        sources = [self.conv0.weight, self.conv1.weight]
        for norm in (self.norm0, self.norm1):
            sources += [norm.weight, norm.bias, norm.running_mean, norm.running_var]
        try:
            key = (dtype, device, tuple((t._version, t.data_ptr(), t.dtype) for t in sources))
        except RuntimeError:                    # inference tensors carry no version
            key = None
        if key is not None and self._prepared is not None and self._prepared[0] == key:
            return self._prepared[1]
        with torch.no_grad():
            operands = self._operands(dtype, device)
        self._prepared = (key, operands) if key is not None else None
        return operands

    def _operands(self, dtype: torch.dtype, device: torch.device) -> tuple:
        affines = torch.stack([*self.norm0.folded(), *self.norm1.folded()])
        weights = [_as(w, dtype).permute(2, 3, 1, 0)
                   for w in (self.conv0.weight, self.conv1.weight)]
        if device.type == "cuda" and dtype == torch.bfloat16 \
                and weights[0].shape[-1] in SUPPORTED_WIDTHS:
            weights = [prepare_bf16_weights(w) for w in weights]
        elif device.type == "cuda":
            weights = [w.contiguous() for w in weights]
        return weights[0], weights[1], affines

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or self.norm0.kind != "batch":
            y = gelu(self.norm0(self.conv0(x)))
            y = self.norm1(self.conv1(y))
            return gelu(x + y)
        dtype = x.dtype
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
        if torch.compiler.is_exporting():
            w1, w2, affines = _shared(self, dtype, lambda: self._operands(dtype, x.device))
            block = fused_residual_block_op
        else:
            w1, w2, affines = self.prepared_operands(dtype, x.device)
            block = fused_residual_block
        out = block(channels_last(x.to(dtype)).permute(0, 2, 3, 1), w1, w2, affines)
        return out.permute(0, 3, 1, 2)


class UpsampleBlock(nn.Module):
    """2x upsample: ConvTranspose(k=2, s=2) or conv + pixel shuffle, then
    Norm-GELU."""

    def __init__(self, in_features: int, features: int,
                 use_pixel_shuffle: bool = False, norm: str = "batch"):
        super().__init__()
        self.use_pixel_shuffle = use_pixel_shuffle
        if use_pixel_shuffle:
            self.conv = nn.Conv2d(in_features, features * 4, 3, padding=1)
        else:
            self.conv = nn.ConvTranspose2d(in_features, features, 2, stride=2)
        self.norm = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.use_pixel_shuffle:
            # Depth-to-space with channel index (i*2 + j)*C + c, as the JAX
            # block reshapes NHWC (not F.pixel_shuffle's c*4 + i*2 + j).
            b, c4, h, w = y.shape
            c = c4 // 4
            y = y.view(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
            y = channels_last(y.reshape(b, c, h * 2, w * 2))
        return gelu(self.norm(y))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise kxk conv (``groups=in_features``, at the stride), pointwise
    1x1 conv, Norm, GELU; neither conv has a bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = "batch"):
        super().__init__()
        self.depthwise = SameConv2d(in_features, in_features, kernel_size, stride,
                                    bias=False, groups=in_features)
        self.pointwise = SameConv2d(in_features, features, 1, bias=False)
        self.norm = Norm(features, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.norm(self.pointwise(self.depthwise(x))))


class SqueezeExcitation(nn.Module):
    """Channel attention: the spatial mean through a 1x1 conv down to
    ``max(C // reduction, 8)`` channels, GELU, a 1x1 conv back to C and a
    sigmoid scale the input (both convs with a bias)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        reduced = max(channels // reduction, 8)
        self.conv0 = SameConv2d(channels, reduced, 1)
        self.conv1 = SameConv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv1(gelu(self.conv0(s))))


class SpatialAttention(nn.Module):
    """Spatial gate: a 7x7 conv (with a bias) to one channel, a sigmoid,
    times the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = SameConv2d(channels, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))
