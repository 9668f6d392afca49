"""The train-mode BatchNorm kernel set N1 (``ops/cuda_norm.py``) on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them to
the composition there). Here: their plain twin ``batch_norm_train_reference``
(the moments, finalize and apply forward and the explicit backward formulas,
as the kernels compute them) against autograd of ``Norm``'s fp32
composition, in bf16 and fp32, at every width the flagship and capacity_2x
decoders train at, channels-last and NCHW; what the kernels read as it lies
(``check``, which raises on anything else) and the launch geometry the
wrapper picks; and ``Norm``'s dispatch, which sends a bf16 or fp32 tensor on
a card to the kernels and keeps the composition on the CPU, under a data
group, for GroupNorm and in eval mode.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd.function import once_differentiable

from msid_tpu_torch.models import blocks
from msid_tpu_torch.models.blocks import BN_EPS, BN_MOMENTUM, Norm
from msid_tpu_torch.ops import _build, cuda_norm

torch.set_num_threads(2)


def _count(x: torch.Tensor) -> float:
    """Values a channel: N * H * W."""
    return float(x.numel() // x.shape[1])


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


def moments_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 sums of x and x^2 (N, H, W summed)."""
    xf = x.float()
    return xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))


def finalize_forward_reference(s1, s2, count: float, weight, bias, running_mean,
                               running_var, momentum: float, eps: float) -> torch.Tensor:
    """``[4, C]`` fp32 (mean, rstd, scale, shift) from the sums over
    ``count`` values a channel; the running statistics move toward the
    batch's mean and biased variance, in place."""
    mean = s1 / count
    var = (s2 / count - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    scale = weight.float() * rstd
    with torch.no_grad():
        running_mean.lerp_(mean, momentum)
        running_var.lerp_(var, momentum)
    return torch.stack([mean, rstd, scale, bias.float() - mean * scale])


def apply_reference(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """``x * scale + shift`` in fp32, stored in x's dtype."""
    return (x.float() * _per_channel(stats[2]) + _per_channel(stats[3])).to(x.dtype)


def backward_reduce_reference(x: torch.Tensor, dy: torch.Tensor,
                              mean: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 sums of dy and dy * (x - mean)."""
    dyf = dy.float()
    return dyf.sum(dim=(0, 2, 3)), (dyf * (x.float() - _per_channel(mean))).sum(dim=(0, 2, 3))


def finalize_backward_reference(sdy, sdyc, count: float, weight,
                                stats: torch.Tensor) -> torch.Tensor:
    """``[5, C]`` fp32 (dw, db, k, cc, b2): the parameters' gradients and
    dx's coefficients."""
    rstd = stats[1]
    dw = sdyc * rstd
    k = weight.float() * rstd
    return torch.stack([dw, sdy, k, k * sdy / count, k * rstd * dw / count])


def dx_reference(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
                 grads: torch.Tensor) -> torch.Tensor:
    """``k * dy - cc - (x - mean) * b2`` in fp32, stored in x's dtype."""
    k, cc, b2 = (_per_channel(g) for g in grads[2:])
    xc = x.float() - _per_channel(stats[0])
    return (k * dy.float() - cc - xc * b2).to(x.dtype)


class _Twin(torch.autograd.Function):
    """The kernel set's function in plain PyTorch: the moments, finalize and
    apply forward; the explicit backward formulas. Only x (in its own
    dtype), the weight and the ``[4, C]`` statistics are saved, as the
    kernels save them."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        stats = finalize_forward_reference(*moments_reference(x), _count(x), weight, bias,
                                           running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        return apply_reference(x, stats)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        grads = finalize_backward_reference(*backward_reduce_reference(x, dy, stats[0]),
                                            _count(x), weight, stats)
        return dx_reference(x, dy, stats, grads), grads[0], grads[1], None, None, None, None


def batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                               momentum: float, eps: float) -> torch.Tensor:
    """``cuda_norm.batch_norm_train``'s function on any device."""
    return _Twin.apply(x, weight, bias, running_mean, running_var, momentum, eps)

WIDTHS = (32, 48, 96, 192, 384, 768)      # flagship 32..384, capacity_2x up to 768
LAYOUTS = ("rows", "planes")              # channels-last (the kernels'), NCHW


def seeded_norm(c: int, seed: int) -> Norm:
    norm = Norm(c)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, generator=g) + 0.5)
        norm.bias.copy_(torch.rand(c, generator=g) - 0.5)
        norm.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
        norm.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return norm


def inputs(c: int, layout: str, dtype: torch.dtype, seed: int, shape=(3, 5, 7)):
    """x with a mean and a scale of its own per channel, and dy, in
    ``layout``."""
    b, h, w = shape
    g = torch.Generator().manual_seed(seed)
    loc = torch.randn(c, 1, 1, generator=g)
    x = (torch.randn(b, c, h, w, generator=g) * (1 + torch.rand(c, 1, 1, generator=g)) + loc)
    dy = torch.randn(b, c, h, w, generator=g)
    x, dy = x.to(dtype), dy.to(dtype)
    if layout == "rows":
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    return x, dy


def close(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> None:
    """fp32: the same arithmetic with sums in another order. bf16: both
    round one fp32 value to bf16, so an element may land one ulp apart
    (2 ** -8 of it), or further where its fp32 value is a cancellation
    near zero (1e-4 of the largest)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    bound = rtol * want.abs() + 1e-4 * scale if dtype == torch.bfloat16 \
        else rtol * want.abs() + 1e-6 * scale
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


def run(norm: Norm, x: torch.Tensor, dy: torch.Tensor, twin: bool):
    """y, dx, dw, db and the running statistics after one train-mode step of
    ``norm`` (the composition) or of the twin on ``norm``'s parameters."""
    xr = x.clone().requires_grad_()
    if twin:
        y = batch_norm_train_reference(xr, norm.weight, norm.bias, norm.running_mean,
                                       norm.running_var, BN_MOMENTUM, BN_EPS)
    else:
        y = norm.train()(xr)
    y.backward(dy)
    return (y.detach(), xr.grad, norm.weight.grad, norm.bias.grad,
            norm.running_mean.clone(), norm.running_var.clone())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_twin_matches_autograd_of_the_composition(dtype, c, layout):
    norm = seeded_norm(c, seed=c)
    x, dy = inputs(c, layout, dtype, seed=c + 1)
    want = run(copy.deepcopy(norm), x, dy, twin=False)
    got = run(copy.deepcopy(norm), x, dy, twin=True)
    for name, g, w in zip(("y", "dx"), got[:2], want[:2]):
        assert g.dtype == w.dtype == dtype and g.stride() == x.stride(), name
        close(g, w, dtype)
    for g, w in zip(got[2:], want[2:]):             # dw, db, running mean and var: fp32
        assert g.dtype == torch.float32
        close(g, w, torch.float32)
    # the running variance is the biased one (flax's), moved by BN_MOMENTUM
    xf = x.float()
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(got[5], torch.lerp(norm.running_var, var, BN_MOMENTUM),
                               rtol=1e-5, atol=1e-6)


def test_the_twin_keeps_a_constant_channel_finite():
    """A channel of one value: the variance clamps at 0, rstd is
    1/sqrt(eps), y is the bias, dx takes no x-hat term and dw is 0 (the
    composition's dw there is a cancellation, rstd * (sum dy x - mean sum
    dy), its round-off times 316)."""
    norm = seeded_norm(8, seed=0)
    x, dy = inputs(8, "rows", torch.float32, seed=1)
    x[:, 3] = 2.5
    got = run(copy.deepcopy(norm), x, dy, twin=True)
    want = run(copy.deepcopy(norm), x, dy, twin=False)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    torch.testing.assert_close(got[0][:, 3], torch.full_like(got[0][:, 3], norm.bias[3].item()),
                               rtol=0, atol=1e-3)     # x * scale - mean * scale, scale ~ 316
    assert float(got[2][3]) == 0.0
    got[2][3] = want[2][3]
    for g, w in zip(got, want):
        close(g, w, torch.float32)


def test_the_twin_saves_only_x_and_the_statistics():
    norm = seeded_norm(16, seed=2)
    x, _ = inputs(16, "rows", torch.bfloat16, seed=3)
    x.requires_grad_()
    y = batch_norm_train_reference(x, norm.weight, norm.bias, norm.running_mean,
                                   norm.running_var, BN_MOMENTUM, BN_EPS)
    saved = y.grad_fn.saved_tensors
    assert saved[0] is x and saved[0].dtype == torch.bfloat16
    assert [tuple(t.shape) for t in saved[1:]] == [(16,), (4, 16)]


def params(c: int, dtype=torch.float32) -> tuple:
    norm = seeded_norm(c, seed=c)
    return tuple(t.to(dtype) for t in (norm.weight.detach(), norm.bias.detach(),
                                       norm.running_mean, norm.running_var))


@pytest.mark.parametrize("shape,memory,dtype", [
    ((2, 48, 4, 4), torch.channels_last, torch.bfloat16),
    ((2, 48, 4, 4), torch.channels_last, torch.float32),
    ((2, 8, 1, 1), torch.contiguous_format, torch.bfloat16),     # one pixel: both layouts
    ((2, 1, 4, 4), torch.contiguous_format, torch.float32),      # one channel: both
    ((1, 2048, 2, 2), torch.channels_last, torch.bfloat16),      # the widest
    ((2, 13, 3, 3), torch.channels_last, torch.bfloat16),        # single-element loads
])
def test_the_kernels_read_a_channels_last_tensor_as_it_lies(shape, memory, dtype):
    """Every check passes but the last: the tensor is on the CPU."""
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=memory)
    with pytest.raises(ValueError, match="off the card"):
        cuda_norm.check(x, *params(shape[1]))


@pytest.mark.parametrize("case,reason", [
    ("nchw", "not channels-last"), ("stepped", "not channels-last"),
    ("3-d", "not 4-D"), ("empty", "not 4-D"), ("fp16", "dtype"),
    ("too-wide", "more than 2048 channels"), ("wide-unaligned", "loads a row"),
    ("bf16-params", "parameters"), ("params-shape", "parameters")])
def test_what_the_kernels_do_not_read_raises(case, reason):
    """An NCHW or stepped tensor, another rank or dtype, no elements, more
    than 2048 channels (or more than 512 single-element loads a row), and
    parameters that are not fp32 [C]: ``check`` names what it cannot read,
    and copies nothing to another layout."""
    c, dtype, memory, shape = 48, torch.bfloat16, torch.channels_last, (2, 48, 4, 4)
    p = params(c)
    if case == "nchw":
        memory = torch.contiguous_format
    elif case == "empty":
        shape = (0, 48, 4, 4)
    elif case == "fp16":
        dtype = torch.float16
    elif case == "too-wide":
        c, shape, p = 2056, (1, 2056, 1, 1), params(2056)
    elif case == "wide-unaligned":
        c, shape, p = 1001, (1, 1001, 2, 2), params(1001)
    elif case == "bf16-params":
        p = params(c, torch.bfloat16)
    elif case == "params-shape":
        p = (p[0][:-1],) + p[1:]
    x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=memory)
    if case == "stepped":
        x = torch.zeros(2, 48, 4, 8, dtype=dtype).contiguous(
            memory_format=torch.channels_last)[..., ::2]
    elif case == "3-d":
        x = x[0]
    with pytest.raises(ValueError, match=reason):
        cuda_norm.check(x, *p)


@pytest.mark.parametrize("device,dtype,served", [
    ("cuda", torch.bfloat16, True), ("cuda", torch.float32, True),
    ("cuda", torch.float16, False), ("cuda", torch.float64, False),
    ("cpu", torch.bfloat16, False), ("cpu", torch.float32, False)])
def test_serves_a_bf16_or_fp32_tensor_on_a_card(device, dtype, served):
    """What ``Norm`` sends to the kernel set reads the device and the dtype
    alone: the layout is the kernels' to check, and to refuse aloud."""
    x = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert cuda_norm.serves(x) is served


def test_vector_width_follows_the_channels_and_the_alignment():
    x = torch.zeros(2, 48, 2, 2, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert cuda_norm.vector(x) == 8 and cuda_norm.vector(x.float()) == 4
    assert cuda_norm.vector(torch.zeros(2, 13, 2, 2, dtype=torch.bfloat16)) == 1
    flat = torch.zeros(2 * 48 * 4 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 2, 2, 48).permute(0, 3, 1, 2)      # 2 bytes past 16
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert cuda_norm.vector(shifted) == 1


@pytest.mark.parametrize("c,vec", [(c, 8) for c in WIDTHS] + [(13, 1), (2048, 8), (512, 1),
                                                              (2048, 4), (3, 1)])
def test_geometry_covers_every_row_and_fits_the_kernel(c, vec):
    """Threads (C / vec) x R row slots, R * C within the CTA's 2 x 2048
    floats of shared memory, at most 512 threads; parts x per covers the
    rows, none empty; about four CTAs an SM on large tensors."""
    for rows in (1, 63, 2000, 64 * 192 * 192):
        parts, per, threads = cuda_norm.geometry(rows, c, vec, 132)
        slots = threads // (c // vec)
        assert threads == slots * (c // vec) <= 512 and slots * c <= 2048
        assert parts * per >= rows > (parts - 1) * per
        assert per >= max(64, slots * 4) and parts <= 4 * 132


def test_batch_norm_train_refuses_the_cpu_and_launches_nothing():
    norm = seeded_norm(8, seed=4)
    x, _ = inputs(8, "rows", torch.bfloat16, seed=5)
    params = (norm.weight, norm.bias, norm.running_mean, norm.running_var)
    before = _build.launched.copy()
    with pytest.raises(ValueError, match="off the card"):
        cuda_norm.batch_norm_train(x, *params, BN_MOMENTUM, BN_EPS)
    assert _build.launched == before


def kernel_path(monkeypatch) -> list:
    """Make ``Norm`` see a card: ``serves`` says yes, and
    ``batch_norm_train`` records its calls and computes by the twin."""
    calls = []

    def record(x, *args):
        calls.append(tuple(x.shape))
        return batch_norm_train_reference(x, *args)

    monkeypatch.setattr(cuda_norm, "serves", lambda x: True)
    monkeypatch.setattr(cuda_norm, "batch_norm_train", record)
    return calls


def test_norm_keeps_the_composition_on_the_cpu(monkeypatch):
    """With the real ``serves``, a CPU tensor never reaches the kernel set:
    the composition's result, bit for bit."""
    calls = []
    monkeypatch.setattr(cuda_norm, "batch_norm_train", lambda *a: calls.append(a))
    norm = seeded_norm(48, seed=6)
    x, _ = inputs(48, "rows", torch.bfloat16, seed=7)
    y = norm.train()(x)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    scale = norm.weight * torch.rsqrt(var + BN_EPS)
    want = (xf * scale[:, None, None] + (norm.bias - mean * scale)[:, None, None]).to(x.dtype)
    assert calls == [] and torch.equal(y, want.detach())


def test_norm_sends_a_train_mode_batch_norm_to_the_kernel_set(monkeypatch):
    calls = kernel_path(monkeypatch)
    norm = seeded_norm(32, seed=8)
    x, dy = inputs(32, "rows", torch.float32, seed=9)
    got = run(copy.deepcopy(norm), x, dy, twin=False)
    assert calls == [tuple(x.shape)]
    monkeypatch.undo()
    want = run(copy.deepcopy(norm), x, dy, twin=False)
    for g, w in zip(got, want):
        close(g, w, torch.float32)


def test_norm_keeps_the_composition_under_a_data_group(monkeypatch):
    """A data group takes its moments over the group by an all-reduce,
    which the kernel set does not do: the composition runs (its all-reduce
    stands in for a one-rank group here)."""
    calls = kernel_path(monkeypatch)
    reduced = []

    def all_reduce_sum(t, group):
        reduced.append(group)
        return t

    from msid_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "all_reduce_sum", all_reduce_sum)
    norm = seeded_norm(16, seed=10)
    norm.data_group = "group"
    x, _ = inputs(16, "rows", torch.bfloat16, seed=11)
    norm.train()(x)
    assert calls == [] and reduced == ["group"]


def test_group_norm_and_eval_mode_never_reach_the_kernel_set(monkeypatch):
    calls = kernel_path(monkeypatch)
    x, _ = inputs(16, "rows", torch.bfloat16, seed=12)
    Norm(16, "group").train()(x)
    seeded_norm(16, seed=13).eval()(x)
    assert calls == []


def test_blocks_import_the_module_they_dispatch_to():
    assert blocks.cuda_norm is cuda_norm


def test_the_twin_on_a_tiny_model_step_matches_the_composition(monkeypatch):
    """A whole decoder block trained one step through the kernel path (the
    twin on the CPU) against the composition: outputs, every gradient and
    the running statistics."""
    from msid_tpu_torch.models.blocks import ConvBlock

    torch.manual_seed(0)
    block = ConvBlock(8, 16, stride=2).train()
    x = torch.randn(2, 8, 12, 12).contiguous(memory_format=torch.channels_last)

    def step(module):
        module = copy.deepcopy(module)
        y = module(x)
        y.square().mean().backward()
        grads = [p.grad.clone() for p in module.parameters()]
        stats = [b.clone() for b in module.buffers()]
        return [y.detach(), *grads, *stats]

    want = step(block)
    kernel_path(monkeypatch)
    got = step(block)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(w.abs().max()))
