"""Fused sensor corruption (the port of K2): Philox draws, one pass.

Counterpart of ``msid_tpu/ops/pallas_noise.py``. ``apply_sensor_noise_kernel``
runs the hand-written Hopper kernel (``csrc/noise.cu``) on a CUDA tensor
and the plain PyTorch version ``apply_sensor_noise_kernel_reference`` on a
CPU tensor. There is no other route: a CUDA tensor the kernel does not
take raises.

What it computes is the TPU kernel's composition (see ``csrc/noise.cu``):
speckle, dead-band mask, one combined Gaussian+thermal normal, stripes,
clamp to [-3, 3]. Its random numbers are not the TPU's: both versions here
draw the same counter-based Philox4x32-10 stream, keyed by the seed, with
counters ``(index, sub-stream, sample, stream)``, so the plain version
reproduces the kernel's draws and every draw depends on (seed, sample,
position) only. ``sample_offset`` makes local sample b draw as sample
``b + sample_offset`` of a global batch, so a data-parallel rank holding
rows ``[offset, offset + B)`` corrupts them as one device corrupts those
rows of the whole batch.

The plain version builds Philox from int64 tensor ops: torch has no
uint32 multiply and a 32x32-bit product overflows int64, so each
``mulhi``/``mullo`` is assembled from 16-bit halves.
"""

from __future__ import annotations

import ctypes
import math

import torch

from msid_tpu_torch.ops import _build
from msid_tpu_torch.ops.noise import CLAMP_HI, CLAMP_LO, NoiseConfig

# Kernel launches so far in this process; chip_smoke.py zeroes it before
# driving the training path and reads it after.
launches = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_THREADS = 256
_TARGET_CTAS = 1056          # 8 per SM of an H100's 132
_SMEM_LIMIT = 227 * 1024     # bytes a CTA may use on Hopper
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
             + [ctypes.c_uint] * 3 + [ctypes.c_float] * 6 + [ctypes.c_void_p])


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key (k0, k1): the low and high 32 bits of a 64-bit seed."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed & _MASK32, (seed >> 32) & _MASK32


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``m * c`` for a 32-bit constant ``m`` and an
    int64 tensor of 32-bit values, from 16-bit halves of ``c`` so no
    intermediate passes 2**49."""
    a = c & 0xFFFF
    a = a * m                                   # < 2**48
    b = (c >> 16) * m                           # < 2**48
    s = a + ((b & 0xFFFF) << 16)                # < 2**49
    return (b >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0, c1, c2, c3, seed: int) -> list[torch.Tensor]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under ``seed``: four
    int64 tensors of 32-bit words. Counters are int64 tensors (or ints)
    that broadcast together."""
    k0, k1 = seed_key(seed)
    c = [torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3)]
    device = next((v.device for v in c if v.dim() > 0), c[0].device)
    c = [v.to(device) for v in c]
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def uniform(words: torch.Tensor) -> torch.Tensor:
    """fp32 uniforms (k + 0.5) * 2**-23 from the top 23 bits: exact, in
    (0, 1)."""
    return ((words >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def box_muller(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent fp32 N(0, 1) from two word tensors, computed in
    float64 (the kernel's fp32 ``logf``/``sincospif`` are within an ulp)."""
    r = torch.sqrt(-2.0 * torch.log(uniform(a).double()))
    angle = math.pi * (2.0 * uniform(b).double())
    return (r * torch.cos(angle)).float(), (r * torch.sin(angle)).float()


def kernel_draws(seed: int, batch: int, n: int, wc: int, channels: int,
                 device: torch.device | str = "cpu", sample_offset: int = 0) -> dict:
    """The kernel's random draws for a batch of ``batch`` samples of ``n``
    elements, sample b drawn as sample ``b + sample_offset``: ``u_dead``
    [B, C] and ``u_gate`` [B] uniforms, stripe normals ``stripe`` [B, wc],
    and per-element normals ``n1``, ``n2`` [B, n]."""
    b = torch.arange(sample_offset, sample_offset + batch, device=device,
                     dtype=torch.int64)[:, None]
    q = torch.arange((channels + 4) // 4, device=device, dtype=torch.int64)
    words = philox4x32(q[None, :], 0, b, 0, seed)
    u = uniform(torch.stack(words, dim=-1).reshape(batch, -1))
    stripe_words = philox4x32(torch.arange(wc, device=device)[None, :], 1, b, 0, seed)
    stripe, _ = box_muller(stripe_words[0], stripe_words[1])
    pairs = torch.arange((n + 1) // 2, device=device, dtype=torch.int64)[None, :]
    w = philox4x32(pairs, 0, b, 1, seed)
    even = box_muller(w[0], w[1])                 # element 2p
    odd = box_muller(w[2], w[3])                  # element 2p + 1
    n1 = torch.stack([even[0], odd[0]], dim=-1).reshape(batch, -1)[:, :n]
    n2 = torch.stack([even[1], odd[1]], dim=-1).reshape(batch, -1)[:, :n]
    return {"u_dead": u[:, :channels], "u_gate": u[:, channels], "stripe": stripe,
            "n1": n1, "n2": n2}


def compose(x: torch.Tensor, cfg: NoiseConfig, draws: dict,
            return_masks: bool = False):
    """The kernel's arithmetic on given draws (see ``kernel_draws``): fp32
    throughout, the result cast to x's dtype. With ``return_masks`` also
    returns ``[B, C+1]`` fp32: the alive mask per band, then the gate."""
    bsz, h, w, c = x.shape
    p_stripe = stripe_probability(cfg)
    alive = (draws["u_dead"] >= cfg.dead_band_prob).float()            # [B, C]
    gate = (draws["u_gate"] < p_stripe).float()                         # [B]
    a = alive[:, None, None, :]
    y = x.float() * (1.0 + draws["n1"].reshape(x.shape) * cfg.speckle_sigma)
    y = y * a
    chan = torch.arange(c, dtype=torch.float32, device=x.device)
    weight = 1.0 + chan / float(max(c - 1, 1))
    var = cfg.thermal_scale ** 2 * weight * weight + cfg.gaussian_sigma ** 2 * a
    y = y + draws["n2"].reshape(x.shape) * torch.sqrt(var)
    stripes = draws["stripe"].reshape(bsz, 1, w, c) * cfg.stripe_sigma
    y = torch.where(gate[:, None, None, None] > 0, y + stripes, y)
    out = torch.clamp(y, CLAMP_LO, CLAMP_HI).to(x.dtype)
    if return_masks:
        return out, torch.cat([alive, gate[:, None]], dim=1)
    return out


def stripe_probability(cfg: NoiseConfig) -> float:
    """The gate's probability: 0 when striping is off."""
    return cfg.stripe_prob if cfg.enable_striping and cfg.stripe_prob > 0 else 0.0


def apply_sensor_noise_kernel_reference(seed: int, x: torch.Tensor,
                                        cfg: NoiseConfig = NoiseConfig(),
                                        return_masks: bool = False,
                                        sample_offset: int = 0):
    """Plain PyTorch version of the kernel: the same Philox draws, the same
    composition. x is NHWC, any float dtype."""
    bsz, h, w, c = x.shape
    check_sample_offset(sample_offset, bsz)
    draws = kernel_draws(seed, bsz, h * w * c, w * c, c, x.device, sample_offset)
    return compose(x, cfg, draws, return_masks)


def check_sample_offset(sample_offset: int, batch: int) -> None:
    """The global sample indices ``[offset, offset + batch)`` must be 32-bit
    Philox counters."""
    if int(sample_offset) < 0 or int(sample_offset) + batch >= 2 ** 32:
        raise ValueError(f"sample_offset {sample_offset} + batch {batch} must lie "
                         f"in [0, 2**32)")


def launch_shape(batch: int, n: int) -> tuple[int, int]:
    """``(chunks, per_cta)`` of a launch on ``batch`` samples of ``n``
    elements: CTA x of a sample takes the groups of 4 elements ``[x *
    per_cta, (x + 1) * per_cta)``: about ``_TARGET_CTAS`` CTAs in all, but
    no more than gives each thread about one group, and none idle."""
    groups = -(-n // 4)
    chunks = max(1, min(-(-_TARGET_CTAS // batch), -(-groups // _THREADS)))
    per_cta = -(-groups // chunks)
    return -(-groups // per_cta), per_cta


def smem_bytes(channels: int, wc: int) -> int:
    """Shared memory of one CTA: alive and sd per band, the gate, the
    ``wc`` stripes."""
    return (2 * channels + 1 + wc) * 4


def apply_sensor_noise_kernel(seed: int, x: torch.Tensor,
                              cfg: NoiseConfig = NoiseConfig(),
                              return_masks: bool = False, sample_offset: int = 0):
    """Corrupt an NHWC batch with the fused kernel. Returns the corrupted
    batch in x's dtype (and, with ``return_masks``, the ``[B, C+1]`` fp32
    alive mask and gate). Sample b draws as sample ``b + sample_offset``
    of a global batch.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (fp32 or bf16) or raise.
    """
    global launches
    if x.device.type == "cpu":
        return apply_sensor_noise_kernel_reference(seed, x, cfg, return_masks,
                                                   sample_offset)
    if x.device.type != "cuda":
        raise ValueError(f"the noise kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the noise kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got shape {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    n = h * w * c
    if smem_bytes(c, w * c) > _SMEM_LIMIT:
        raise ValueError(f"W*C = {w * c} stripes do not fit in shared memory")
    if bsz * n >= 2 ** 31 or bsz >= 2 ** 16:
        raise ValueError(f"batch {tuple(x.shape)} too large for one launch")
    check_sample_offset(sample_offset, bsz)
    k0, k1 = seed_key(seed)
    x = x.contiguous()
    out = torch.empty_like(x)
    masks = torch.empty(bsz, c + 1, device=x.device) if return_masks else None
    align = 16 if x.dtype == torch.float32 else 8
    vec = n % 4 == 0 and x.data_ptr() % align == 0 and out.data_ptr() % align == 0
    chunks, per_cta = launch_shape(bsz, n)

    fn = _build.bind("noise", "msid_noise_forward", _ARGTYPES)
    err = _build.call(fn, x.device, x.data_ptr(), out.data_ptr(),
                      masks.data_ptr() if masks is not None else None,
                      0 if x.dtype == torch.float32 else 1, int(vec), bsz, n, w * c, c,
                      chunks, per_cta, k0, k1, int(sample_offset),
                      cfg.dead_band_prob, cfg.speckle_sigma, cfg.gaussian_sigma ** 2,
                      cfg.thermal_scale ** 2, stripe_probability(cfg), cfg.stripe_sigma)
    if err != 0:
        raise RuntimeError(f"noise kernel launch failed: cudaError {err}")
    launches += 1
    return (out, masks) if return_masks else out
