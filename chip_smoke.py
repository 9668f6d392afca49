#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, the result lines
    python3 chip_smoke.py kernel kernel_fp32   # those phases alone (also noise,
                                               # probe, hybrid), no result lines

From the repository root, on a machine with a CUDA card, ``nvcc`` and no
network. Phases, each of which must pass:

1. build: compile the four sources of ``msid_tpu_torch/csrc/`` (resblock,
   which holds K1 and K3 and includes ``hopper_common.cuh``; noise,
   resblock_fp32, any_dma) for sm_90a, one ``nvcc`` per source (four for
   resblock, one per channel width), started together, with each build's
   seconds;
2. kernel: the fused ResidualBlock kernel (K1, wgmma) against its plain
   PyTorch version at the flagship decoder's four shapes, B=1 and B=16
   (rtol 0.03 / atol 0.02), after one tiny launch synchronised on its
   own, with its tile, cluster and time beside the plain version's, a
   cuDNN bf16 composition's and the card's bound;
3. kernel_fp32: the fp32 fused ResidualBlock (K4, 3xTF32 on the tensor
   cores) against its plain version at the four flagship shapes and two
   tiny widths (C=8 @ 64², C=24 @ 16²), B=1 and B=16 (max abs error <=
   1e-4, relative RMS <= 1e-5, TF32 off), with its geometry and time
   beside the plain version's, a cuDNN fp32 composition's, the bound of
   three TF32 passes on the tensor cores and the bound at the fp32 FMA
   peak;
4. noise: the fused corruption kernel (K2) against its plain version at
   [64,192,192,13] and [4,192,192,13] fp32 and [16,192,192,13] bf16, at
   5 bands and at an unaligned n (the element-wise kernel), with striping
   off and on: dead-band masks and stripe gates exactly
   equal, fp32 within 1e-6, bf16 within one ulp (+1e-6); the
   distribution checks of the JAX package's TPU test; its time in fp32
   and bf16 beside the plain version, the bytes bound, the issue bound
   (the SASS instructions of one pass of the element loop the run takes,
   counted in the library this run built, per element, over the SMs'
   issue rate) and the share of HBM peak;
5. serve: the full-width bf16 flagship (``long_skip_fill.yaml``) with
   seeded random weights answers 4 requests at B=1 and 4 at B=16 through
   ``InferenceSession.predict``; exactly 8 K1 launches per forward;
   the B=1 output is held against the same weights in fp32 on the CPU;
   latency by host clock (predict) and CUDA events (device), and device
   time by kernel from ``torch.profiler``;
6. serve_fp32: the same weights served in fp32 at B=1 and B=16, exactly 8
   K4 launches (and no K1) per forward, the B=1 output within relative
   RMS 1e-4 of the CPU's; then one bf16 ``InferenceSession(tta=8)`` at
   B=1, 64 K1 launches per forward;
7. train: one bf16 train step of the flagship at B=2 on the card against
   the same step in fp32 on the CPU (every noise component off); then
   ``setup_training_session(synthetic=True, epochs=1)`` into a temporary
   directory and ``Trainer.fit``: 6 train steps of 64 tiles and 2 padded validation
   batches, finite history, no skipped step, encoder blocks 0-5 unchanged,
   every other parameter moved, one K2 launch per train step and per
   validation batch and 8 K1 launches per validation batch; then step
   times with the kernel and with the plain composition (``noise.impl:
   jnp``) in turns, peak memory, and a profiler breakdown of one step;
8. evaluate: ``msid_tpu_torch.scripts.train`` trains the flagship for one
   epoch into a temporary directory and writes its checkpoint; then
   ``msid_tpu_torch.scripts.evaluate`` scores it in bf16 (the trainer's
   last validation line within 1e-5 relative), in fp32 (8 K4 launches
   per forward, no K1; 8 tiles corrupted once on the card and restored
   on the card and on the CPU agree within relative RMS 1e-4, their
   metrics within 1e-4), with ``--tta 8`` (64 K1 launches per validation
   batch) and with ``--ensemble`` of the same checkpoint (equal to the
   single score within 1e-5); the checkpoint's size and save time and
   each evaluation's time are printed;
9. probe: the async-copy probe kernel (K5) against ``x * 2`` at
   [8,192,48] and [3072,192,48] fp32 (exactly equal), timed beside
   ``x * 2`` and its bytes bound; the nine-tap fused ResidualBlock (K3)
   against its plain version and against K1's output at the four flagship
   shapes, B=1 and B=16, and at the probe's [64,192,192,48] (rtol 0.03 /
   atol 0.02), also at a caller tile of 5 x 7 that leaves ragged edges;
   with its tile, cluster and ring, timed with its prepared weights and
   through the functional entry, beside K1, a cuDNN bf16 composition and
   the bound;
   then ``msid_tpu_torch.benchmarks.kernel_probe.main`` for every variant,
   each kernel's launch counter moving by that variant's calls and no
   other counter moving;
10. hybrid: the default full-width model (``unet_light`` 384/192/96/48, no
   fill) in bf16: ``InferenceSession(optimize="auto")`` serves the module's
   forward at B=1 and the hybrid graph at B=16, ``optimize=True`` the
   fastpath; each folded graph within relative RMS 2e-2 of the module's
   forward in bf16 and 1e-4 in fp32, launching no fused-block kernel (the
   module's forward launches 8); device p50 of the three graphs at B=1, 16
   and 128; then ``long_skip.yaml`` trained one epoch and scored by
   ``scripts.evaluate --forward apply`` and ``--forward hybrid`` in fp32
   (metrics within 1e-4 relative) and under bf16 autocast (within 2e-2),
   and ``--forward hybrid`` refused with
   ``ValueError`` on the flagship (it has the input fill stage).

The fp32 phases run with torch's TF32 flags as they are: the port turns
TF32 off around its own fp32 forwards and steps, and this script around
the fp32 plain versions and library yardsticks it computes itself. The
last lines are the kernels JSON line (K1 to K5, with their launches on
each path), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that last line; so does a machine with no card, or a
directory without the package. Everything written goes to temporary
directories that are removed at the end.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "experiments" / "long_skip_fill.yaml"
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 66.9e12  # H100 SXM fp32 peak outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core peak
TF32_PASSES = 3            # K4 multiplies every fp32 product as three TF32 products
BF16_B1_LAUNCHES_BEFORE = 559   # device launches of one bf16 B=1 flagship forward
                                # before the blocks kept their prepared operands
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192))   # (C, H=W) per stage
BATCHES = (1, 16)
REQUESTS = 4
RTOL, ATOL = 0.03, 0.02          # the TPU kernel v3's golden tolerance
MAX_REL_RMS = 2e-2               # bf16 GPU forward vs fp32 CPU forward
# csrc/<name>.cu with its -D defines, built in parallel (K1 and K3 once per width)
KERNELS = tuple(("resblock", (f"MSID_C={c}",)) for c in (384, 192, 96, 48)) + (
    ("noise", ()), ("resblock_fp32", ()), ("any_dma", ()))
# K4 against its plain version (cuDNN fp32, TF32 off): both fp32, sums in
# another order over K = 9C.
FP32_SHAPES = SHAPES + ((8, 64), (24, 16))
FP32_MAX_ABS, FP32_MAX_REL_RMS = 1e-4, 1e-5
FP32_FORWARD_REL_RMS = 1e-4       # fp32 GPU forward vs fp32 CPU forward
EVAL_RTOL = 1e-5                  # evaluate vs the trainer's validation line
FP32_METRIC_RTOL = 1e-4           # fp32 GPU metrics vs fp32 CPU metrics
EVAL_SEED = 1234                  # the trainer's and evaluate's eval_seed
# K2 against its plain version: both compute in fp32 from the same Philox
# words; logf/sincospif against torch's log/cos differ by an ulp or two.
NOISE_ATOL = 1e-6
NOISE_CASES = (((64, 192, 192, 13), "float32"), ((4, 192, 192, 13), "float32"),
               ((16, 192, 192, 13), "bfloat16"),
               ((3, 64, 64, 5), "float32"),          # another band count
               ((3, 37, 29, 13), "bfloat16"))        # n % 4 != 0: element-wise loads
SM_ISSUE_PER_CLOCK = 4 * 32   # thread-instructions per SM per clock: 4 schedulers
K3_RAGGED_TILE = (5, 7)       # divides none of the flagship's sides
# One train step, bf16 autocast on the card against fp32 on the CPU: bf16
# keeps ~3 digits through 12 ViT blocks, the decoder and the backward; the
# gradient norm sums squares of ~10^8 bf16-rounded terms, hence the looser bound.
PARITY_BATCH = 2
PARITY_LOSS_RTOL = 1e-2
PARITY_GNORM_RTOL = 5e-2
TIMED_STEPS = 4
PROBE_SHAPE = (64, 192, 192, 48)  # the kernel probe's default block
PROBE_ITERS = 20
ANY_DMA_SHAPES = ((8, 192, 48), (3072, 192, 48))   # the probe's slice; a 113 MB array
SKIP_CONFIG = ROOT / "configs" / "experiments" / "long_skip.yaml"   # full width, no fill
HYBRID_BATCHES = (1, 16, 128)
HYBRID_FP32_REL_RMS = 1e-4        # folded graphs vs the module's forward, fp32, TF32 off
HYBRID_METRIC_RTOL = 1e-4         # --forward hybrid vs --forward apply, fp32
# The same under bf16 autocast: the two graphs round at different places
# (outputs differ by ~6e-3 relative RMS), as the serving check allows.
HYBRID_BF16_METRIC_RTOL = 2e-2


def load_flagship() -> dict:
    from msid_tpu_torch.utils.config import load_config

    return load_config(CONFIG)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` runs after warmup."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def block_bound(c: int, s: int, b: int, itemsize: int = 2,
                peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str, float, float]:
    """Least time for one block on the card, operands of ``itemsize`` bytes
    at ``peak_flops``: (ms, bound_by, flops, bytes)."""
    flops = 2 * 2 * 9 * c * c * s * s * b
    nbytes = (2 * b * s * s * c + 2 * 9 * c * c) * itemsize + 4 * c * 4
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def random_block_inputs(torch, c: int, s: int, b: int, seed: int, dtype=None):
    from msid_tpu_torch.ops.cuda_decoder import fold_batchnorm

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, s, c)).astype(np.float32)
    w1, w2 = (rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c))
             for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]])
    dev = torch.device("cuda")
    dtype = dtype or torch.bfloat16
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(w1).to(dev, dtype),
            torch.from_numpy(w2).to(dev, dtype),
            torch.from_numpy(aff.astype(np.float32)).to(dev))


def library_block(torch, F):
    """The block as a cuDNN composition in x's dtype (yardstick only, never
    used by the port): channels-last convs, affine, GELU, residual."""
    def run(x, k1, k2, aff):
        xc = x.permute(0, 3, 1, 2)
        a = aff.to(x.dtype)[:, :, None, None]
        h = F.gelu(F.conv2d(xc, k1, padding=1) * a[0] + a[1], approximate="tanh")
        y = F.conv2d(h, k2, padding=1) * a[2] + a[3] + xc
        return F.gelu(y, approximate="tanh")
    return run


def phase_kernel(torch, F, failures: list) -> list[dict]:
    """K1 against its plain version at the flagship shapes, through the
    functional entry (HWIO weights) and with the prepared K-major operands
    the model keeps, timed with the latter."""
    from msid_tpu_torch.ops import cuda_decoder

    lib = library_block(torch, F)
    # A wrong byte count on a barrier would hang: the first launch is a
    # small one, synchronised on its own.
    tiny = random_block_inputs(torch, 48, 8, 1, seed=1)
    if not within(torch, cuda_decoder.fused_residual_block(*tiny),
                  cuda_decoder.fused_residual_block_reference(*tiny)):
        failures.append("resblock [1,8,8,48]: disagrees with its plain version")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c, s in SHAPES:
        for b in BATCHES:
            x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b)
            p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
            got = cuda_decoder.fused_residual_block(x, p1, p2, aff)
            functional = cuda_decoder.fused_residual_block(x, w1, w2, aff)
            want = cuda_decoder.fused_residual_block_reference(x, w1, w2, aff)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            max_err = float(diff.max())
            ok = bool(within(torch, got, want) and torch.equal(got, functional))
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
            th, tw, g, stages = cuda_decoder.bf16_tiling(c, s, s, b, sms)
            row = {
                "check": "resblock", "C": c, "H": s, "W": s, "B": b,
                "tile": [th, tw], "cluster": g, "stages": stages,
                "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                    x, p1, p2, aff)),
                "functional_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                    x, w1, w2, aff)),
                "plain_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_reference(
                    x, w1, w2, aff)),
                "library_ms": time_ms(torch, lambda: lib(x, k1, k2, aff)),
                "library": "cuDNN bf16 conv2d composition (channels-last)",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": nbytes,
                "max_abs_err": max_err, "ok": ok,
            }
            row["tflops"] = flops / row["kernel_ms"] / 1e9
            row["share_of_bound"] = bound_ms / row["kernel_ms"]
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"resblock C={c} H={s} B={b}: max_abs_err {max_err}")
    return rows


def phase_kernel_fp32(torch, F, failures: list) -> list[dict]:
    """K4 against its plain version (both fp32, TF32 off) at the flagship
    and tiny widths, with times beside a cuDNN fp32 composition's, the
    bound of its route (three TF32 passes on the tensor cores) and the
    bound at the fp32 FMA peak."""
    from msid_tpu_torch.models.restoration import exact_fp32
    from msid_tpu_torch.ops import cuda_decoder

    def exact(fn, *args):          # the fp32 yardsticks in fp32: TF32 off
        with exact_fp32(torch.float32):
            return fn(*args)

    lib = library_block(torch, F)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c, s in FP32_SHAPES:
        for b in BATCHES:
            x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b,
                                                 dtype=torch.float32)
            got = cuda_decoder.fused_residual_block(x, w1, w2, aff)
            want = exact(cuda_decoder.fused_residual_block_reference, x, w1, w2, aff)
            torch.cuda.synchronize()
            diff = got - want
            max_err = float(diff.abs().max())
            rel = float(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
            ok = bool(max_err <= FP32_MAX_ABS and rel <= FP32_MAX_REL_RMS
                      and torch.isfinite(got).all())
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            ffma_ms, _, flops, nbytes = block_bound(c, s, b, 4, PEAK_FP32_FLOPS)
            bound_ms, bound_by, _, _ = block_bound(c, s, b, 4, PEAK_TF32_FLOPS / TF32_PASSES)
            th, tw, nt, nu, g, kc = cuda_decoder.fp32_tiling(c, s, s, b, sms)
            row = {
                "check": "resblock_fp32", "C": c, "H": s, "W": s, "B": b,
                "tile": [th, tw], "cluster": g,
                "geometry": {"nt": nt, "nu": nu, "kc": kc},
                "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                    x, w1, w2, aff), iters=10),
                "plain_ms": time_ms(torch, lambda: exact(
                    cuda_decoder.fused_residual_block_reference, x, w1, w2, aff), iters=10),
                "library_ms": time_ms(torch, lambda: exact(lib, x, k1, k2, aff), iters=10),
                "library": "cuDNN fp32 conv2d composition (channels-last, TF32 off)",
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_ffma_ms": ffma_ms,
                "flops": flops, "bytes": nbytes,
                "max_abs_err": max_err, "rel_rms": rel, "ok": ok,
            }
            row["tflops"] = flops / row["kernel_ms"] / 1e9
            row["share_of_bound"] = bound_ms / row["kernel_ms"]
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"resblock_fp32 C={c} H={s} B={b}: max_abs_err "
                                f"{max_err}, rel RMS {rel}")
    return rows


def randomize_(torch, model, seed: int) -> None:
    """Seeded random values for every parameter and BN statistic, including
    the zero-init head and mask condition and the identity fill Gram."""
    from torch import nn

    from msid_tpu_torch.models.blocks import Norm

    g = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                else m.weight[0].numel()
            normal(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                normal(m.bias, 0.1)
        elif isinstance(m, (Norm, nn.LayerNorm)):
            normal(m.weight, 0.1, 1.0)
            normal(m.bias, 0.1)
            if isinstance(m, Norm) and m.kind == "batch":
                normal(m.running_mean, 0.1)
                with torch.no_grad():
                    m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 1.5 + 0.5)
    normal(model.encoder.pos_embed, 0.02)
    if model.input_fill:
        n = model.fill_gram.shape[0]
        a = torch.randn(n, n, generator=g)
        with torch.no_grad():
            model.fill_gram.copy_(a @ a.T / n + 0.1 * torch.eye(n))


def noisy_tiles(b: int, size: int, bands: int, seed: int) -> np.ndarray:
    """Model-space tiles, each with 1-2 killed bands (thermal noise only)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, size, size, bands)).astype(np.float32)
    for i in range(b):
        for c in rng.choice(bands, size=rng.integers(1, 3), replace=False):
            x[i, :, :, c] = rng.normal(0, 0.005, (size, size))
    return x


def rel_rms(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def device_profile(torch, fn, iters: int = 3, tags: dict | None = None) -> dict:
    """Device time and launches per call of ``fn``, by kernel name, from the
    device-side events of ``torch.profiler`` (CUPTI). ``tags`` maps a
    result key to a substring of kernel names whose times it sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
            launches += 1
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"device_busy_ms": sum(per_kernel.values()),
           "device_launches": launches / iters,
           "top_ms": [[k[:80], v] for k, v in top]}
    for key, tag in (tags or {}).items():
        out[key] = sum(v for k, v in per_kernel.items() if tag in k)
    return out


def profile_forward(torch, model, x: np.ndarray, iters: int = 3) -> dict:
    """Device profile of one forward; ``resblock_ms`` sums the block kernel
    of the model's dtype (K1 ``resblock_kernel``, K4 ``resblock_fp32_kernel``)."""
    xd = torch.from_numpy(x).to("cuda", model.dtype)
    tag = "resblock_fp32_kernel" if model.dtype == torch.float32 else "resblock_kernel"
    with torch.inference_mode():
        return device_profile(torch, lambda: model(xd), iters, {"resblock_ms": tag})


def phase_serve(torch, failures: list, card: str) -> tuple[dict, tuple]:
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder, cuda_noise

    cfg = load_flagship()
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    randomize_(torch, cpu_model, seed=0)
    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    model.load_state_dict(cpu_model.state_dict())
    size, bands = cpu_model.image_size, cpu_model.in_channels

    result = {"check": "serve", "config": str(CONFIG.relative_to(ROOT)),
              "dtype": "bfloat16", "card": card}
    launches_total = noise_launches = 0
    for b in BATCHES:
        session = InferenceSession(model, batch_size=b, image_size=size,
                                   num_bands=bands)
        requests = [noisy_tiles(b, size, bands, seed=100 * b + i)
                    for i in range(REQUESTS)]
        session.predict(requests[0])                    # warmup
        cuda_decoder.launches = cuda_noise.launches = 0
        outs = [session.predict(r) for r in requests]
        launches = cuda_decoder.launches
        launches_total += launches
        noise_launches += cuda_noise.launches
        for out in outs:
            if out.shape != (b, size, size, bands) or not np.isfinite(out).all():
                failures.append(f"serve B={b}: bad output {out.shape}, "
                                f"finite={bool(np.isfinite(out).all())}")
        if launches != 8 * REQUESTS:
            failures.append(f"serve B={b}: {launches} kernel launches for "
                            f"{REQUESTS} forwards, expected {8 * REQUESTS}")
        host_ms = []
        for r in requests * 5:
            t0 = time.perf_counter()
            session.predict(r)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        bench = session.benchmark(warmup_runs=5, benchmark_iterations=30)
        p50 = float(np.percentile(host_ms, 50))
        prof = profile_forward(torch, model, requests[0])
        if not prof["device_busy_ms"] > 0 or not prof["resblock_ms"] > 0:
            failures.append(f"serve B={b}: the profiler saw no device time "
                            f"(or none in the resblock kernel): {prof}")
        if b == 1 and not prof["device_launches"] < BF16_B1_LAUNCHES_BEFORE:
            failures.append(f"serve B=1: {prof['device_launches']} device launches per "
                            f"forward, not fewer than {BF16_B1_LAUNCHES_BEFORE}")
        result[f"b{b}"] = {
            "launches": launches, "forwards": REQUESTS,
            "predict_p50_ms": p50, "predict_tiles_per_s": b * 1e3 / p50,
            "device_p50_ms": bench["p50_ms"],
            "device_tiles_per_s": bench["images_per_sec"],
            "device_idle_share": 1 - prof["device_busy_ms"] / bench["p50_ms"],
            "profile": prof,
        }
        if b == 1:
            torch.set_num_threads(8)
            with torch.no_grad():
                ref = cpu_model(torch.from_numpy(requests[0])).numpy()
            x0 = requests[0]
            result["rel_rms_vs_cpu_fp32"] = rel_rms(outs[0], ref)
            # the same without the global residual's identity part
            result["rel_rms_residual_part"] = rel_rms(outs[0] - x0, ref - x0)
            if not result["rel_rms_vs_cpu_fp32"] <= MAX_REL_RMS:
                failures.append(f"serve: rel RMS {result['rel_rms_vs_cpu_fp32']} "
                                f"vs fp32 CPU > {MAX_REL_RMS}")
    result["launches"] = launches_total
    result["noise_launches"] = noise_launches
    emit(result)
    return result, (cpu_model, x0, ref)


def phase_serve_fp32(torch, failures: list, card: str, reference: tuple) -> dict:
    """The serve phase's weights in fp32 through K4 at B=1 and B=16, held to
    the same fp32 forward on the CPU; then one bf16 session with tta=8."""
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder

    cpu_model, x0, ref = reference
    cfg = load_flagship()
    model = SatMAERestoration.from_config(cfg)
    model.load_state_dict(cpu_model.state_dict())
    size, bands = cpu_model.image_size, cpu_model.in_channels
    result = {"check": "serve_fp32", "config": str(CONFIG.relative_to(ROOT)),
              "dtype": "float32", "card": card}
    k4_total = 0
    for b in BATCHES:
        session = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands)
        requests = [x0] if b == 1 else [noisy_tiles(b, size, bands, seed=200 + i)
                                         for i in range(REQUESTS)]
        session.predict(requests[0])                    # warmup
        cuda_decoder.launches = cuda_decoder.launches_fp32 = 0
        outs = [session.predict(r) for r in requests]
        k4, k1 = cuda_decoder.launches_fp32, cuda_decoder.launches
        k4_total += k4
        if k4 != 8 * len(requests) or k1 != 0:
            failures.append(f"serve_fp32 B={b}: {k4} K4 and {k1} K1 launches for "
                            f"{len(requests)} forwards, expected {8 * len(requests)} and 0")
        for out in outs:
            if out.shape != (b, size, size, bands) or not np.isfinite(out).all():
                failures.append(f"serve_fp32 B={b}: bad output {out.shape}")
        host_ms = []
        for r in requests * (20 // len(requests)):
            t0 = time.perf_counter()
            session.predict(r)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        bench = session.benchmark(warmup_runs=3, benchmark_iterations=20)
        prof = profile_forward(torch, model, requests[0])
        if not prof["resblock_ms"] > 0:
            failures.append(f"serve_fp32 B={b}: the profiler saw no K4 time: {prof}")
        result[f"b{b}"] = {
            "k4_launches": k4, "k1_launches": k1, "forwards": len(requests),
            "predict_p50_ms": float(np.percentile(host_ms, 50)),
            "device_p50_ms": bench["p50_ms"],
            "device_tiles_per_s": bench["images_per_sec"],
            "device_busy_ms": prof["device_busy_ms"], "k4_ms": prof["resblock_ms"],
            "k4_share_of_busy": prof["resblock_ms"] / prof["device_busy_ms"],
            "device_idle_share": 1 - prof["device_busy_ms"] / bench["p50_ms"],
            "top_ms": prof["top_ms"][:5],
        }
        if b == 1:
            result["rel_rms_vs_cpu_fp32"] = rel_rms(outs[0], ref)
            result["rel_rms_residual_part"] = rel_rms(outs[0] - x0, ref - x0)
            if not result["rel_rms_vs_cpu_fp32"] <= FP32_FORWARD_REL_RMS:
                failures.append(f"serve_fp32: rel RMS {result['rel_rms_vs_cpu_fp32']} "
                                f"vs fp32 CPU > {FP32_FORWARD_REL_RMS}")
    result["k4_launches"] = k4_total

    bf16 = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(cpu_model.state_dict())
    session = InferenceSession(bf16, batch_size=1, image_size=size, num_bands=bands, tta=8)
    session.predict(x0)                                  # warmup
    cuda_decoder.launches = 0
    host_ms = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        out = session.predict(x0)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    tta_launches = cuda_decoder.launches
    result["tta8_bf16_b1"] = {
        "k1_launches": tta_launches, "forwards": REQUESTS,
        "predict_p50_ms": float(np.percentile(host_ms, 50)),
        "device_p50_ms": session.benchmark(warmup_runs=2, benchmark_iterations=10)["p50_ms"],
        "rel_rms_vs_cpu_fp32_single_view": rel_rms(out, ref),
    }
    result["k1_launches"] = tta_launches
    if tta_launches != 64 * REQUESTS or not np.isfinite(out).all():
        failures.append(f"serve tta=8: {tta_launches} K1 launches for {REQUESTS} "
                        f"forwards, expected {64 * REQUESTS}")
    emit(result)
    return result


def bf16_ulp(torch, v):
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def noise_bound_ms(b: int, n: int, itemsize: int) -> float:
    """Bytes bound of one corruption pass: read x once, write out once."""
    return 2 * b * n * itemsize / PEAK_HBM_BYTES * 1e3


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def noise_loop_instructions(dtype_name: str) -> dict:
    """SASS instructions of one pass of the element loops (gated and plain
    sample) of K2's vector kernel in ``dtype_name``, in the library this
    run built (``cuobjdump -sass``), and the elements a pass covers."""
    from msid_tpu_torch.benchmarks import sass_count
    from msid_tpu_torch.ops import _build

    ctype = {"float32": "float", "bfloat16": "__nv_bfloat16"}[dtype_name]
    found = sass_count.loops(sass_count.sass_of(_build.build("noise")))
    name = next(k for k in found if f"noise_group_kernel<{ctype}, true>(" in k)
    loops = sass_count.element_loops(found[name])
    return {"kernel": name, "elements_per_pass": 4,
            **{k: v["instructions"] for k, v in loops.items()}}


def noise_issue_bound_ms(torch, loop: dict, n: int, gates: list, clock_hz: float) -> float:
    """Least time to issue the element loops' instructions for samples of
    ``n`` elements, gated as ``gates`` says, on every SM at ``clock_hz``
    (set-up and the rarely taken slow paths not counted)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pass = sum(loop["gated" if g else "plain"] for g in gates)
    return n * per_pass / loop["elements_per_pass"] / (sms * SM_ISSUE_PER_CLOCK * clock_hz) * 1e3


def phase_noise(torch, failures: list) -> dict:
    """K2 against its plain version (masks and gates exactly, fp32 to
    NOISE_ATOL, bf16 to one ulp), the distribution checks, and times."""
    from msid_tpu_torch.ops import cuda_noise
    from msid_tpu_torch.ops.noise import NoiseConfig, apply_sensor_noise

    kernel, plain = (cuda_noise.apply_sensor_noise_kernel,
                     cuda_noise.apply_sensor_noise_kernel_reference)
    rows, max_err = [], 0.0
    for shape, dtype_name in NOISE_CASES:
        dtype = getattr(torch, dtype_name)
        for striping in (False, True):
            cfg = NoiseConfig(enable_striping=striping, stripe_prob=0.5)
            g = torch.Generator(device="cuda").manual_seed(shape[0])
            x = (torch.rand(shape, device="cuda", generator=g) * 5 - 2.5).to(dtype)
            seed = 1000 + shape[0] + striping
            got, masks = kernel(seed, x, cfg, return_masks=True)
            want, want_masks = plain(seed, x, cfg, return_masks=True)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.float32:
                ok = err <= NOISE_ATOL
                max_err = max(max_err, err)
            else:
                # the fp32 results differ by up to NOISE_ATOL before rounding
                ulp = bf16_ulp(torch, torch.maximum(got.float().abs(), want.float().abs()))
                ok = bool((diff <= ulp + NOISE_ATOL).all())
            masks_equal = torch.equal(masks, want_masks)
            gates = int(masks[:, -1].sum())
            row = {"check": "noise", "shape": list(shape), "dtype": dtype_name,
                   "striping": striping, "max_abs_err": err, "masks_equal": masks_equal,
                   "dead_bands": int((masks[:, :-1] == 0).sum()), "gated_samples": gates,
                   "ok": ok and masks_equal and (gates > 0 or not striping or shape[0] < 16)}
            emit(row)
            rows.append(row)
            if not row["ok"]:
                failures.append(f"noise {shape} {dtype} striping={striping}: {row}")

    zeros = torch.zeros(4, 192, 192, 13, device="cuda")
    gauss = kernel(3, zeros, NoiseConfig(gaussian_sigma=0.02, speckle_sigma=0,
                                         dead_band_prob=0, thermal_scale=0))
    thermal = kernel(5, zeros, NoiseConfig(gaussian_sigma=0, speckle_sigma=0,
                                           dead_band_prob=0, thermal_scale=0.01))
    dead = kernel(7, torch.ones(8, 192, 192, 13, device="cuda"), NoiseConfig())
    stats = {"check": "noise_statistics",
             "gauss_mean": float(gauss.mean()), "gauss_std": float(gauss.std()),
             "thermal_std_band1": float(thermal[..., 0].std()),
             "thermal_std_band13": float(thermal[..., 12].std()),
             "dead_of_104": int((dead.abs().mean(dim=(1, 2)) < 0.1).sum())}
    stats["ok"] = (abs(stats["gauss_mean"]) < 1e-3 and abs(stats["gauss_std"] - 0.02) < 1e-3
                   and abs(stats["thermal_std_band1"] - 0.01) < 1e-3
                   and abs(stats["thermal_std_band13"] - 0.02) < 2e-3
                   and 1 <= stats["dead_of_104"] <= 20)
    emit(stats)
    if not stats["ok"]:
        failures.append(f"noise statistics: {stats}")

    b, h, w, c = NOISE_CASES[0][0]
    n = h * w * c
    cfg = NoiseConfig()
    clock_hz = sm_clock_hz()
    timing = {"check": "noise_time", "shape": [b, h, w, c], "dtype": "float32",
              "max_abs_err": max_err, "sm_clock_mhz": clock_hz / 1e6}
    for dtype_name, itemsize in (("float32", 4), ("bfloat16", 2)):
        x = (torch.rand(b, h, w, c, device="cuda") * 4 - 2).to(getattr(torch, dtype_name))
        gates = [bool(v) for v in kernel(11, x, cfg, return_masks=True)[1][:, -1].tolist()]
        loop = noise_loop_instructions(dtype_name)
        row = timing[dtype_name] = {
            "kernel_ms": time_ms(torch, lambda: kernel(11, x, cfg)),
            "bound_ms": noise_bound_ms(b, n, itemsize), "bound_by": "bytes",
            "loop_instructions": loop, "gated_samples": sum(gates),
            "instructions_per_element": sum(loop["gated" if g else "plain"] for g in gates)
            / (b * loop["elements_per_pass"]),
            "issue_bound_ms": noise_issue_bound_ms(torch, loop, n, gates, clock_hz),
        }
        if dtype_name == "float32":
            row["plain_ms"] = time_ms(torch, lambda: plain(11, x, cfg), iters=5, warmup=1)
            row["jnp_impl_ms"] = time_ms(torch, lambda: apply_sensor_noise(11, x, cfg))
        row["hbm_share_of_peak"] = row["bound_ms"] / row["kernel_ms"]
        row["issue_share"] = row["issue_bound_ms"] / row["kernel_ms"]
    timing.update({k: timing["float32"][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "bound_by", "issue_bound_ms",
        "instructions_per_element", "hbm_share_of_peak")})
    emit(timing)
    return timing


def train_batch(bands: int, b: int, seed: int) -> np.ndarray:
    """Raw synthetic DN tiles, as the trainer's loader yields them."""
    from msid_tpu_torch.data.dataset import SyntheticEuroSAT

    ds = SyntheticEuroSAT(num_samples=4 * b, split="train", seed=seed, num_bands=bands)
    return np.stack([ds[i] for i in range(b)])


def train_step_parity(torch, cfg: dict, failures: list) -> dict:
    """One bf16 train step on the card against the same step in fp32 on the
    CPU, from the same random weights, every noise component off."""
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState, make_train_step

    zero = NoiseConfig(gaussian_sigma=0, speckle_sigma=0, dead_band_prob=0,
                       thermal_scale=0, enable_striping=False)
    batch = train_batch(13, PARITY_BATCH, seed=5)
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        model = SatMAERestoration.from_config(cfg, device="cpu")
        randomize_(torch, model, seed=1)
        model.to(device)
        optimizer, _ = build_optimizer_from_config(cfg, model)
        step = make_train_step(model, LossConfig.from_config(cfg), zero,
                               image_size=model.image_size, compute_dtype=dtype)
        _, metrics = step(TrainState.create(model, optimizer), batch, 0)
        out[device] = {k: float(metrics[k]) for k in ("loss", "mse", "grad_norm")}
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    result = {"cpu_fp32": out["cpu"], "gpu_bf16": out["cuda"], "rel_diff": rel,
              "ok": rel["loss"] <= PARITY_LOSS_RTOL and rel["grad_norm"] <= PARITY_GNORM_RTOL}
    if not result["ok"]:
        failures.append(f"train-step parity: {result}")
    return result


def phase_train(torch, failures: list, card: str) -> dict:
    """The flagship trains on the card: parity, a 1-epoch Trainer.fit with
    the launch counts, then step times, memory and a profiler breakdown."""
    from msid_tpu_torch.ops import cuda_decoder, cuda_noise
    from msid_tpu_torch.training.train_state import make_train_step
    from msid_tpu_torch.utils.config import load_config
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    cfg = load_config(CONFIG)
    result = {"check": "train", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    t0 = time.perf_counter()
    result["parity"] = train_step_parity(torch, cfg, failures)
    result["parity_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    session = setup_training_session(cfg, output_dir=run_dir.name, synthetic=True, epochs=1,
                                     seed=0)
    trainer, model = session["trainer"], session["model"]
    result["setup_seconds"] = time.perf_counter() - t0
    result["accum_steps"] = trainer.accum_steps
    print(f"train: accum_steps={trainer.accum_steps}", flush=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    labels = trainer.state.optimizer.labels
    train_loader, val_loader = session["train_loader"], session["val_loader"]
    steps, val_batches = len(train_loader), len(val_loader)

    torch.cuda.reset_peak_memory_stats()
    cuda_noise.launches = cuda_decoder.launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(train_loader, val_loader, epochs=1)
    torch.cuda.synchronize()
    result["fit_seconds"] = time.perf_counter() - t0
    launches = {"noise": cuda_noise.launches, "resblock": cuda_decoder.launches}
    result.update(launches=launches, steps=steps, val_batches=val_batches,
                  nan_skips=trainer.state.nan_skips, history=history,
                  fit_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    finite = all(np.isfinite(v).all() for k, v in history.items() if k != "lr")
    frozen_changed = [k for k in before if labels[k] == "frozen" and
                      not torch.equal(before[k], model.get_parameter(k))]
    stuck = [k for k in before if labels[k] != "frozen" and
             torch.equal(before[k], model.get_parameter(k))]
    frozen_blocks = {k.split(".")[2] for k in before
                     if k.startswith("encoder.blocks.") and labels[k] == "frozen"}
    checks = {
        "finite": finite, "nan_skips": trainer.state.nan_skips == 0,
        "frozen_unchanged": not frozen_changed, "others_changed": not stuck,
        "frozen_blocks_0_5": frozen_blocks == {str(i) for i in range(6)},
        "noise_launches": launches["noise"] == steps + val_batches,
        "resblock_launches": launches["resblock"] == 8 * val_batches,
        "steps": steps == 6 and val_batches == 2,
    }
    result["checks"] = checks
    for name, ok in checks.items():
        if not ok:
            failures.append(f"train: {name} failed ({frozen_changed[:3]} {stuck[:3]} "
                            f"{launches} steps={steps} val={val_batches})")

    batch = next(iter(train_loader))
    times: dict[str, list] = {"pallas": [], "jnp": []}
    turns = []
    steps_by_impl = {impl: make_train_step(
        model, trainer.loss_cfg, trainer.noise_cfg, image_size=model.image_size,
        noise_impl=impl, compute_dtype=trainer.compute_dtype) for impl in times}
    torch.cuda.reset_peak_memory_stats()
    for impl in ("pallas", "jnp", "jnp", "pallas"):      # in turns, after a warmup
        for i in range(TIMED_STEPS + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            steps_by_impl[impl](trainer.state, batch, 100 + i)
            end.record()
            torch.cuda.synchronize()
            if i:
                times[impl].append((start.elapsed_time(end), (time.perf_counter() - t0) * 1e3))
        turns.append([impl, float(np.median([p[0] for p in times[impl][-TIMED_STEPS:]]))])
    result["step_turns_device_p50_ms"] = turns
    for impl, pairs in times.items():
        dev = float(np.median([p[0] for p in pairs]))
        host = float(np.median([p[1] for p in pairs]))
        result[f"step_{impl}"] = {"device_p50_ms": dev, "host_p50_ms": host,
                                  "tiles_per_s": batch.shape[0] * 1e3 / host,
                                  "steps": len(pairs)}
    result["step_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof = device_profile(torch, lambda: steps_by_impl["pallas"](trainer.state, batch, 7),
                          iters=2, tags={"noise_ms": "noise_"})
    prof["noise_share_of_busy"] = prof["noise_ms"] / prof["device_busy_ms"]
    prof["device_idle_share"] = 1 - prof["device_busy_ms"] / result["step_pallas"]["host_p50_ms"]
    result["profile"] = prof
    session["checkpoint_manager"].wait_until_finished()
    run_dir.cleanup()
    emit(result)
    return result


def evaluate_fp32_against_cpu(torch, fp32_config: Path, ckpt_dir: Path) -> dict:
    """8 tiles of the first validation batch, corrupted once on the card
    (K2, the first batch's eval seed), restored in fp32 by the checkpoint's
    weights on the card (K4) and on the CPU from the same noisy tensor."""
    from msid_tpu_torch.data.pipeline import get_dataloaders
    from msid_tpu_torch.ops import cuda_decoder
    from msid_tpu_torch.ops.metrics import batch_metric_sums
    from msid_tpu_torch.ops.noise import NoiseConfig, corrupt, fold_in
    from msid_tpu_torch.ops.preprocess import preprocess_tiles
    from msid_tpu_torch.training.eval import split_batch_item
    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.config import load_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    config = load_config(fp32_config)
    config["data"]["root_dir"] = "/nonexistent-forces-synthetic"
    saved, _, step = CheckpointManager(ckpt_dir).load_latest()
    weights = dict(saved["model"], **(saved["ema"] or {}))
    models = {}
    for device in ("cuda", "cpu"):
        models[device], _ = create_model_from_config(config, 0, device)
        models[device].load_state_dict(weights)
        models[device].eval()
    _, val_loader = get_dataloaders(config)
    batch, _ = split_batch_item(next(iter(val_loader)))
    with torch.no_grad():
        clean = preprocess_tiles(
            torch.from_numpy(np.ascontiguousarray(batch[:8])).cuda(), models["cuda"].image_size)
        noisy = corrupt(fold_in(EVAL_SEED, 0), clean, NoiseConfig.from_config(config),
                        impl="pallas")
        cuda_decoder.launches = cuda_decoder.launches_fp32 = 0
        out = models["cuda"](noisy)
        torch.cuda.synchronize()
        k4, k1 = cuda_decoder.launches_fp32, cuda_decoder.launches
        torch.set_num_threads(8)
        t0 = time.perf_counter()
        ref = models["cpu"](noisy.cpu())
        cpu_seconds = time.perf_counter() - t0
        got_m = {k: float(v) / 8 for k, v in batch_metric_sums(out, clean).items()}
        want_m = {k: float(v) / 8 for k, v in batch_metric_sums(ref, clean.cpu()).items()}
    rel_metrics = {k: abs(got_m[k] - want_m[k]) / max(abs(want_m[k]), 1e-12)
                   for k in ("psnr", "ssim", "sam", "rmse")}
    return {"step": step, "tiles": 8, "k4_launches": k4, "k1_launches": k1,
            "rel_rms_vs_cpu_fp32": rel_rms(out.cpu().numpy(), ref.numpy()),
            "gpu_metrics": got_m, "cpu_metrics": want_m, "rel_metric_diff": rel_metrics,
            "cpu_forward_seconds": cpu_seconds}


def phase_evaluate(torch, failures: list, card: str) -> dict:
    """The evaluate path through the CLIs a user runs: train one epoch and
    checkpoint, then score the checkpoint in bf16, fp32, with TTA and as an
    ensemble, holding each to the trainer's validation line or the CPU."""
    from msid_tpu_torch.ops import cuda_decoder, cuda_noise
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from msid_tpu_torch.scripts import train as train_cli
    from msid_tpu_torch.utils import checkpointing

    result = {"check": "evaluate", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    metrics = ("loss", "psnr", "ssim", "sam", "rmse")
    launches = {"resblock": 0, "noise": 0, "resblock_fp32": 0}
    write_step = checkpointing._write_step
    save_seconds = []

    def timed_write_step(*args, **kwargs):
        t0 = time.perf_counter()
        write_step(*args, **kwargs)
        save_seconds.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "run" / "checkpoints"
        common = ["--synthetic", "--device", "cuda"]
        checkpointing._write_step = timed_write_step
        try:
            t0 = time.perf_counter()
            history = train_cli.main(["--config", str(CONFIG), *common, "--epochs", "1",
                                      "--output-dir", str(tmp / "run")])
            result["train_seconds"] = time.perf_counter() - t0
        finally:
            checkpointing._write_step = write_step
        steps = sorted(int(d.name) for d in ckpt.iterdir() if d.name.isdigit())
        files = [f for f in (ckpt / str(steps[-1])).iterdir()]
        result["checkpoint"] = {
            "steps": steps, "bytes": sum(f.stat().st_size for f in files),
            "save_seconds": save_seconds,
            "files": {f.name: f.stat().st_size for f in files}}
        last = {k: history[f"val_{k}"][-1] for k in metrics}
        result["trainer_last_val"] = last

        fp32_config = tmp / "fp32.yaml"
        fp32_config.write_text(f"inherits: {CONFIG}\ntraining:\n  mixed_precision: false\n")
        runs = {
            "bf16": ["--config", str(CONFIG)],
            "fp32": ["--config", str(fp32_config)],
            "tta8_bf16": ["--config", str(CONFIG), "--tta", "8"],
            "ensemble2_bf16": ["--config", str(CONFIG), "--ensemble", str(ckpt)],
        }
        for name, argv in runs.items():
            cuda_decoder.launches = cuda_decoder.launches_fp32 = cuda_noise.launches = 0
            t0 = time.perf_counter()
            out = evaluate_cli.main([*argv, *common, "--checkpoint", str(ckpt),
                                     "--output-dir", str(tmp / name)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {"resblock": cuda_decoder.launches, "noise": cuda_noise.launches,
                      "resblock_fp32": cuda_decoder.launches_fp32}
            for k, v in counts.items():
                launches[k] += v
            result[name] = {"seconds": seconds, "launches": counts,
                            **{k: out[k] for k in metrics}, "num_samples": out["num_samples"]}
        val_batches = result["bf16"]["launches"]["noise"]
        result["val_batches"] = val_batches

        def rel(a, b):
            return {k: abs(a[k] - b[k]) / abs(b[k]) for k in metrics}

        result["bf16_vs_trainer"] = rel(result["bf16"], last)
        result["ensemble_vs_single"] = rel(result["ensemble2_bf16"], result["bf16"])
        result["fp32_vs_cpu"] = evaluate_fp32_against_cpu(torch, fp32_config, ckpt)

    fp32_cpu = result["fp32_vs_cpu"]
    checks = {
        "val_batches": val_batches == 2 and all(
            result[n]["launches"]["noise"] == val_batches for n in runs),
        "bf16_reproduces_trainer": max(result["bf16_vs_trainer"].values()) <= EVAL_RTOL,
        "bf16_launches": result["bf16"]["launches"]["resblock"] == 8 * val_batches
        and result["bf16"]["launches"]["resblock_fp32"] == 0,
        "fp32_launches": result["fp32"]["launches"]["resblock_fp32"] == 8 * val_batches
        and result["fp32"]["launches"]["resblock"] == 0,
        "fp32_forward_launches": fp32_cpu["k4_launches"] == 8 and fp32_cpu["k1_launches"] == 0,
        "fp32_matches_cpu": fp32_cpu["rel_rms_vs_cpu_fp32"] <= FP32_FORWARD_REL_RMS
        and max(fp32_cpu["rel_metric_diff"].values()) <= FP32_METRIC_RTOL,
        "tta8_launches": result["tta8_bf16"]["launches"]["resblock"] == 64 * val_batches,
        "ensemble_equals_single": max(result["ensemble_vs_single"].values()) <= EVAL_RTOL
        and result["ensemble2_bf16"]["launches"]["resblock"] == 16 * val_batches,
        "finite": all(np.isfinite([result[n][k] for k in metrics]).all() for n in runs),
        "checkpoint_written": bool(result["checkpoint"]["steps"]),
    }
    result["checks"] = checks
    result["launches"] = launches
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"evaluate: {name} failed")
    return result


def within(torch, got, want) -> bool:
    """|got - want| <= ATOL + RTOL |want| everywhere, and got finite."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= ATOL + RTOL * want.float().abs()).all()
                and torch.isfinite(got.float()).all())


def phase_probe(torch, F, failures: list) -> dict:
    """K5 and K3 against their plain versions (K3 against K1 too), with
    times, then the kernel probe's entry point for every variant."""
    from msid_tpu_torch.benchmarks import kernel_probe
    from msid_tpu_torch.ops import cuda_decoder, cuda_probe

    result: dict = {"k5": [], "k3": []}
    for shape in ANY_DMA_SHAPES:                       # the small one first
        g = torch.Generator(device="cuda").manual_seed(shape[0])
        x = torch.randn(shape, device="cuda", generator=g)
        got = cuda_probe.any_dma_scale(x)
        want = cuda_probe.any_dma_scale_reference(x)
        torch.cuda.synchronize()
        row = {"check": "any_dma", "shape": list(shape),
               "max_abs_err": float((got - want).abs().max()),
               "ok": torch.equal(got, want),
               "kernel_ms": time_ms(torch, lambda: cuda_probe.any_dma_scale(x)),
               "plain_ms": time_ms(torch, lambda: cuda_probe.any_dma_scale_reference(x)),
               "library_ms": time_ms(torch, lambda: x * 2),
               "library": "x * 2 (one elementwise kernel)",
               "bytes": 2 * x.numel() * 4,
               "bound_ms": 2 * x.numel() * 4 / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes"}
        row["hbm_share_of_peak"] = row["bound_ms"] / row["kernel_ms"]
        emit(row)
        result["k5"].append(row)
        if not row["ok"]:
            failures.append(f"any_dma {shape}: not equal to x * 2 ({row['max_abs_err']})")

    lib = library_block(torch, F)
    # A wrong byte count on the barrier would hang: the first launch is a
    # small one, synchronised on its own.
    tiny = random_block_inputs(torch, 48, 8, 1, seed=1)
    if not within(torch, cuda_decoder.fused_residual_block_v2(*tiny),
                  cuda_decoder.fused_residual_block_v2_reference(*tiny)):
        failures.append("resblock_v2 [1,8,8,48]: disagrees with its plain version")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(c, s, b, random_block_inputs(torch, c, s, b, seed=c + b), 20)
             for c, s in SHAPES for b in BATCHES]
    pb, ph, pw, pc = PROBE_SHAPE
    cases.append((pc, ph, pb, kernel_probe.make_inputs(PROBE_SHAPE, torch.device("cuda")), 5))
    for c, s, b, (x, w1, w2, aff), iters in cases:
        got = cuda_decoder.fused_residual_block_v2(x, w1, w2, aff)
        ragged = cuda_decoder.fused_residual_block_v2(x, w1, w2, aff, *K3_RAGGED_TILE)
        want = cuda_decoder.fused_residual_block_v2_reference(x, w1, w2, aff)
        k1 = cuda_decoder.fused_residual_block(x, w1, w2, aff)
        torch.cuda.synchronize()
        ok_plain, ok_k1 = within(torch, got, want), within(torch, got, k1)
        ok_ragged = within(torch, ragged, want)
        kw1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        kw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
        geometry = cuda_decoder.v2_tile(c, s, s, b, sms=sms)
        w1k, w2k = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        row = {
            "check": "resblock_v2", "C": c, "H": s, "W": s, "B": b,
            "tile": list(geometry[:2]), "cluster": geometry[2], "stages": geometry[3],
            "k1_geometry": list(cuda_decoder.bf16_tiling(c, s, s, b, sms)),
            "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2(
                x, w1k, w2k, aff), iters=iters),
            "functional_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2(
                x, w1, w2, aff), iters=iters),
            "k1_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                x, w1k, w2k, aff), iters=iters),
            "plain_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2_reference(
                x, w1, w2, aff), iters=min(iters, 10), warmup=1),
            "library_ms": time_ms(torch, lambda: lib(x, kw1, kw2, aff), iters=iters),
            "library": "cuDNN bf16 conv2d composition (channels-last)",
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_abs_vs_k1": float((got.float() - k1.float()).abs().max()),
            "ragged_tile": list(K3_RAGGED_TILE),
            "ragged_max_abs_err": float((ragged.float() - want.float()).abs().max()),
            "ok": ok_plain and ok_k1 and ok_ragged,
        }
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["share_of_bound"] = bound_ms / row["kernel_ms"]
        emit(row)
        result["k3"].append(row)
        if not row["ok"]:
            failures.append(f"resblock_v2 C={c} H={s} B={b}: vs plain {row['max_abs_err']} "
                            f"({ok_plain}), vs K1 {row['max_abs_vs_k1']} ({ok_k1}), tile "
                            f"{K3_RAGGED_TILE} vs plain {row['ragged_max_abs_err']} ({ok_ragged})")
    del cases

    # The entry point, one variant per call as a user runs it. Each variant
    # moves its own kernel's counter by the calls it makes, and no other.
    counters = {"resblock": (cuda_decoder, "launches"),
                "resblock_fp32": (cuda_decoder, "launches_fp32"),
                "resblock_v2": (cuda_decoder, "launches_v2"),
                "any_dma": (cuda_probe, "launches_any_dma")}
    moves = {"xla": None, "xla_bf16": None, "fused": "resblock_fp32", "v3": "resblock",
             "v2": "resblock_v2", "v2:8:32": "resblock_v2", "any_dma": "any_dma"}
    for module, attr in counters.values():
        setattr(module, attr, 0)
    result["launches"] = {k: 0 for k in counters}
    result["variants"] = {}
    for variant, kernel in moves.items():
        before = {k: getattr(m, a) for k, (m, a) in counters.items()}
        out = kernel_probe.main([variant, "--shape", ",".join(map(str, PROBE_SHAPE)),
                                 "--iters", str(PROBE_ITERS)])
        torch.cuda.synchronize()
        moved = {k: getattr(m, a) - before[k] for k, (m, a) in counters.items()}
        expected = {k: (out["calls"] if k == kernel else 0) for k in counters}
        out["launches"] = moved
        result["variants"][variant] = out
        for k, v in moved.items():
            result["launches"][k] += v
        if moved != expected:
            failures.append(f"probe {variant}: counters moved by {moved}, expected {expected}")
        if variant == "any_dma":
            if out["correct"] is not True:
                failures.append("probe any_dma: not correct")
        elif not (np.isfinite(out["ms"]) and out["ms"] > 0):
            failures.append(f"probe {variant}: bad time {out['ms']}")
        elif out["max_abs_vs_xla"] is not None and not out["max_abs_vs_xla"] <= 0.25:
            # bf16 outputs of |y| <= ~16 differ from the fp32-output block's
            # by a few bf16 ulps (2^-4 at 8..16)
            failures.append(f"probe {variant}: max|d| vs xla {out['max_abs_vs_xla']}")
    emit({"check": "probe", "shape": list(PROBE_SHAPE), "iters": PROBE_ITERS,
          "variants": result["variants"], "launches": result["launches"]})
    return result


def phase_hybrid(torch, failures: list, card: str) -> dict:
    """The folded-BN graphs on the default full-width model: the session's
    choice, agreement with the module's forward, launch counts, device
    times; then ``--forward hybrid`` through the evaluate CLI."""
    from msid_tpu_torch.deployment import fastpath
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from msid_tpu_torch.scripts import train as train_cli

    def block_counts():
        return (cuda_decoder.launches, cuda_decoder.launches_fp32, cuda_decoder.launches_v2)

    cpu_model = SatMAERestoration().eval()               # the defaults: the model bench.py times
    randomize_(torch, cpu_model, seed=2)
    models = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        models[name] = SatMAERestoration().set_compute_dtype(dtype).to("cuda").eval()
        models[name].load_state_dict(cpu_model.state_dict())
    del cpu_model
    model = models["bfloat16"]
    size, bands = model.image_size, model.in_channels
    result = {"check": "hybrid", "model": "SatMAERestoration() defaults: ViT-Base, "
              "unet_light 384/192/96/48, no fill", "card": card}
    launches = {"resblock": 0, "resblock_fp32": 0}

    def session(b, optimize, m=model):
        return InferenceSession(m, batch_size=b, image_size=size, num_bands=bands,
                                optimize=optimize)

    chosen = {"auto_b1": session(1, "auto").optimized, "auto_b16": session(16, "auto").optimized,
              "true_b1": session(1, True).optimized, "false_b16": session(16, False).optimized}
    result["chosen"] = chosen
    if chosen != {"auto_b1": False, "auto_b16": "hybrid", "true_b1": "fastpath",
                  "false_b16": False}:
        failures.append(f"hybrid: the session chose {chosen}")

    # Agreement and launch counts: bf16 at B=16 through the sessions a user
    # builds, fp32 at B=2 with the graphs called directly (auto would serve
    # the module's forward at B=2).
    x16 = noisy_tiles(16, size, bands, seed=300)
    cuda_decoder.launches = cuda_decoder.launches_fp32 = cuda_decoder.launches_v2 = 0
    ref = session(16, False).predict(x16)
    after_apply = block_counts()
    outs = {"hybrid": session(16, "auto").predict(x16),
            "fastpath": session(16, True).predict(x16)}
    after_folded = block_counts()
    launches["resblock"] += after_folded[0]
    result["bf16_b16"] = {"apply_launches": list(after_apply),
                          "folded_launches": [a - b for a, b in zip(after_folded, after_apply)],
                          "rel_rms_vs_apply": {k: rel_rms(v, ref) for k, v in outs.items()}}
    if after_apply != (8, 0, 0) or after_folded != after_apply:
        failures.append(f"hybrid bf16: block-kernel counters {after_apply} after the module's "
                        f"forward, {after_folded} after the folded graphs")
    for k, v in result["bf16_b16"]["rel_rms_vs_apply"].items():
        if not (v <= MAX_REL_RMS and np.isfinite(outs[k]).all()):
            failures.append(f"hybrid bf16 {k}: rel RMS {v} vs the module's forward")

    m32 = models["float32"]
    x2 = torch.from_numpy(noisy_tiles(2, size, bands, seed=301)).cuda()
    with torch.inference_mode():
        cuda_decoder.launches = cuda_decoder.launches_fp32 = cuda_decoder.launches_v2 = 0
        ref32 = m32(x2)
        after_apply = block_counts()
        tree = fastpath.optimize_for_inference(m32, upsample="both")
        outs32 = {
            "fastpath_matmul": fastpath.make_fast_inference_fn(m32, True)(tree, x2),
            "fastpath_ct": fastpath.make_fast_inference_fn(m32, False)(tree, x2),
            "hybrid": fastpath.make_hybrid_inference_fn(m32)(
                fastpath.optimize_for_hybrid(m32), x2),
            "hybrid_live_fold": fastpath.make_hybrid_forward(m32)(None, x2),
        }
        torch.cuda.synchronize()
        after_folded = block_counts()
    launches["resblock_fp32"] += after_folded[1]
    result["fp32_b2"] = {"apply_launches": list(after_apply),
                         "rel_rms_vs_apply": {k: rel_rms(v.cpu().numpy(), ref32.cpu().numpy())
                                              for k, v in outs32.items()}}
    if after_apply != (0, 8, 0) or after_folded != after_apply:
        failures.append(f"hybrid fp32: block-kernel counters {after_apply} after the module's "
                        f"forward, {after_folded} after the folded graphs")
    for k, v in result["fp32_b2"]["rel_rms_vs_apply"].items():
        if not v <= HYBRID_FP32_REL_RMS:
            failures.append(f"hybrid fp32 {k}: rel RMS {v} vs the module's forward")
    del tree, outs32, ref32, m32, models["float32"]
    torch.cuda.empty_cache()

    # Device p50 of the three graphs, in turns (there and back), each called
    # as the session calls it ("auto" itself serves the module's forward
    # below 8, so a session cannot be asked for the hybrid graph at B=1).
    before = cuda_decoder.launches
    times: dict = {}
    for b in HYBRID_BATCHES:
        iters, warmup = (30, 5) if b < 128 else (10, 3)
        xb = torch.from_numpy(np.random.default_rng(b).uniform(
            -2.0, 2.0, (b, size, size, bands)).astype(np.float32)).cuda()
        hybrid_fn = fastpath.make_hybrid_inference_fn(model)
        fast_fn = fastpath.make_fast_inference_fn(model, matmul_upsample=True)
        with torch.inference_mode():
            hybrid_w = fastpath.optimize_for_hybrid(model)
            fast_w = fastpath.optimize_for_inference(model, upsample="matmul")

        def run_apply():
            with torch.inference_mode():
                return model(xb.to(model.dtype)).float()

        def run_hybrid():
            with torch.inference_mode():
                return hybrid_fn(hybrid_w, xb).float()

        def run_fast():
            with torch.inference_mode():
                return fast_fn(fast_w, xb).float()

        graphs = {"apply": run_apply, "hybrid": run_hybrid, "fastpath": run_fast}
        turns: dict = {k: [] for k in graphs}
        for name in ("apply", "hybrid", "fastpath", "fastpath", "hybrid", "apply"):
            turns[name].append(time_ms(torch, graphs[name], iters, warmup))
        profiles = {k: device_profile(torch, fn, iters=2) for k, fn in graphs.items()}
        times[f"b{b}"] = {
            k: {"device_p50_ms_turns": v, "device_p50_ms": float(np.mean(v)),
                "tiles_per_s": b * 1e3 / float(np.mean(v)),
                "device_busy_ms": profiles[k]["device_busy_ms"],
                "device_launches": profiles[k]["device_launches"],
                "device_idle_share": 1 - profiles[k]["device_busy_ms"] / float(np.mean(v))}
            for k, v in turns.items()}
        del xb, hybrid_w, fast_w
        torch.cuda.empty_cache()
    launches["resblock"] += cuda_decoder.launches - before
    result["device_times"] = times

    # --forward hybrid through the CLIs, fp32, on the flagship without its
    # fill stage; and its refusal on the flagship.
    metrics = ("loss", "psnr", "ssim", "sam", "rmse")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as tmp:
        tmp = Path(tmp)
        common = ["--synthetic", "--device", "cuda"]
        t0 = time.perf_counter()
        train_cli.main(["--config", str(SKIP_CONFIG), *common, "--epochs", "1",
                        "--output-dir", str(tmp / "run")])
        result["train_seconds"] = time.perf_counter() - t0
        fp32_config = tmp / "fp32.yaml"
        fp32_config.write_text(
            f"inherits: {SKIP_CONFIG}\ntraining:\n  mixed_precision: false\n")
        scores = {}
        for name, config, impl in (("apply", fp32_config, "apply"),
                                   ("hybrid", fp32_config, "hybrid"),
                                   ("apply_bf16", SKIP_CONFIG, "apply"),
                                   ("hybrid_bf16", SKIP_CONFIG, "hybrid")):
            cuda_decoder.launches = cuda_decoder.launches_fp32 = cuda_decoder.launches_v2 = 0
            t0 = time.perf_counter()
            out = evaluate_cli.main(["--config", str(config), *common, "--forward", impl,
                                     "--checkpoint", str(tmp / "run" / "checkpoints"),
                                     "--output-dir", str(tmp / name)])
            torch.cuda.synchronize()
            scores[name] = {"seconds": time.perf_counter() - t0,
                            "block_launches": list(block_counts()),
                            **{k: out[k] for k in metrics}}
        launches["resblock_fp32"] += scores["apply"]["block_launches"][1]
        launches["resblock"] += scores["apply_bf16"]["block_launches"][0]
        refused = False
        try:
            evaluate_cli.main(["--config", str(CONFIG), *common, "--forward", "hybrid",
                               "--output-dir", str(tmp / "refused")])
        except ValueError as err:
            refused = "input_fill" in str(err)
    result["evaluate"] = scores
    result["evaluate_rel_diff"] = {k: abs(scores["hybrid"][k] - scores["apply"][k])
                                   / abs(scores["apply"][k]) for k in metrics}
    result["evaluate_rel_diff_bf16"] = {
        k: abs(scores["hybrid_bf16"][k] - scores["apply_bf16"][k])
        / abs(scores["apply_bf16"][k]) for k in metrics}
    result["flagship_forward_hybrid_refused"] = refused
    checks = {
        "evaluate_hybrid_equals_apply":
            max(result["evaluate_rel_diff"].values()) <= HYBRID_METRIC_RTOL,
        "evaluate_apply_launches_k4": scores["apply"]["block_launches"][1] > 0
        and scores["apply"]["block_launches"][0] == 0,
        "evaluate_hybrid_launches_no_block_kernel": scores["hybrid"]["block_launches"] == [0, 0, 0]
        and scores["hybrid_bf16"]["block_launches"] == [0, 0, 0],
        "evaluate_bf16_hybrid_close_to_apply":
            max(result["evaluate_rel_diff_bf16"].values()) <= HYBRID_BF16_METRIC_RTOL
            and scores["apply_bf16"]["block_launches"][0] > 0,
        "flagship_refused": refused,
        "finite": all(np.isfinite([scores[i][k] for k in metrics]).all() for i in scores),
    }
    result["checks"] = checks
    result["launches"] = launches
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"hybrid: {name} failed")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from msid_tpu_torch.ops._build import build, load_library, nvcc_path

    card = card_line()
    print(card, flush=True)
    failures: list[str] = []

    t0 = time.perf_counter()
    def timed_build(kernel):
        start = time.perf_counter()
        build(*kernel)
        return time.perf_counter() - start

    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per build, together
        build_seconds = list(pool.map(timed_build, KERNELS))
    for name, defines in KERNELS:
        load_library(name, defines)
    emit({"check": "build",
          "sources": sorted({f"msid_tpu_torch/csrc/{k}.cu" for k, _ in KERNELS}),
          "builds": {" ".join((k, *d)): t for (k, d), t in zip(KERNELS, build_seconds)},
          "nvcc": nvcc_path(), "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    only = sys.argv[1:]
    if only:
        # Named phases alone, while working on one: no result lines.
        partial = {"kernel": lambda: phase_kernel(torch, F, failures),
                   "kernel_fp32": lambda: phase_kernel_fp32(torch, F, failures),
                   "noise": lambda: phase_noise(torch, failures),
                   "probe": lambda: phase_probe(torch, F, failures),
                   "hybrid": lambda: phase_hybrid(torch, failures, card)}
        for name in only:
            if name not in partial:
                print(f"chip_smoke: only {sorted(partial)} run alone, got {name!r}",
                      file=sys.stderr)
                return 2
            partial[name]()
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        print(f"partial run of {only}: {'failed' if failures else 'passed'}", flush=True)
        return 1 if failures else 0

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    rows = timed("kernel", phase_kernel, torch, F, failures)
    rows_fp32 = timed("kernel_fp32", phase_kernel_fp32, torch, F, failures)
    noise = timed("noise", phase_noise, torch, failures)
    serve, reference = timed("serve", phase_serve, torch, failures, card)
    serve_fp32 = timed("serve_fp32", phase_serve_fp32, torch, failures, card, reference)
    train = timed("train", phase_train, torch, failures, card)
    evaluate = timed("evaluate", phase_evaluate, torch, failures, card)
    probe = timed("probe", phase_probe, torch, F, failures)
    hybrid = timed("hybrid", phase_hybrid, torch, failures, card)
    emit({"check": "phase_seconds", **seconds})

    def per_forward(kernel_rows):
        big = [r for r in kernel_rows if r["B"] == max(BATCHES) and (r["C"], r["H"]) in SHAPES]
        out = {k: 2 * sum(r[k] for r in big)       # 2 blocks per stage
               for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "bound_ffma_ms")
               if k in big[0]}
        out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in big)
                           else "bytes")
        return out

    k1, k4 = per_forward(rows), per_forward(rows_fp32)
    resblock_by_path = {"serve": serve["launches"], "serve_fp32": serve_fp32["k1_launches"],
                        "train": train["launches"]["resblock"],
                        "evaluate": evaluate["launches"]["resblock"],
                        "probe": probe["launches"]["resblock"],
                        "hybrid": hybrid["launches"]["resblock"]}
    noise_by_path = {"serve": serve["noise_launches"], "train": train["launches"]["noise"],
                     "evaluate": evaluate["launches"]["noise"]}
    fp32_by_path = {"evaluate": evaluate["launches"]["resblock_fp32"],
                    "serve_fp32": serve_fp32["k4_launches"],
                    "probe": probe["launches"]["resblock_fp32"],
                    "hybrid": hybrid["launches"]["resblock_fp32"]}
    v2_by_path = {"probe": probe["launches"]["resblock_v2"]}
    any_dma_by_path = {"probe": probe["launches"]["any_dma"]}
    k3 = per_forward(probe["k3"])
    k3_probe = probe["k3"][-1]              # one launch at the probe's shape
    k5_small, k5_large = probe["k5"]
    # Serving corrupts nothing: K2 runs on the training and evaluate paths.
    for name, by_path, paths in (
            ("fused_residual_block", resblock_by_path, resblock_by_path),
            ("apply_sensor_noise", noise_by_path, ("train", "evaluate")),
            ("fused_residual_block_fp32", fp32_by_path, fp32_by_path),
            ("fused_residual_block_v2", v2_by_path, v2_by_path),
            ("any_dma_scale", any_dma_by_path, any_dma_by_path)):
        if not all(by_path[p] > 0 for p in paths):
            failures.append(f"{name}: a path launched it no time: {by_path}")
    emit({"kernels": [{
        "name": "fused_residual_block",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:402",
        "launches": sum(resblock_by_path.values()),
        "launches_by_path": resblock_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
        "tiles": {f"C{r['C']}B{r['B']}": r["tile"] + [r["cluster"]] for r in rows},
    }, {
        "name": "apply_sensor_noise",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/noise.cu",
        "replaces": "msid_tpu/ops/pallas_noise.py:152",
        "launches": sum(noise_by_path.values()),
        "launches_by_path": noise_by_path,
        "max_abs_err": noise["max_abs_err"],
        "ms": noise["kernel_ms"],
        "plain_ms": noise["plain_ms"],
        "bound_ms": noise["bound_ms"],
        "bound_by": noise["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call draws and composes the five "
                   "noise components",
        "per": "one launch on a [64,192,192,13] fp32 batch (one train step)",
        "issue_bound_ms": noise["issue_bound_ms"],
        "instructions_per_element": noise["instructions_per_element"],
        "loop_instructions": noise["float32"]["loop_instructions"],
        "hbm_share_of_peak": noise["hbm_share_of_peak"],
        "bf16": {k: noise["bfloat16"][k] for k in (
            "kernel_ms", "bound_ms", "issue_bound_ms", "instructions_per_element",
            "hbm_share_of_peak")},
    }, {
        "name": "fused_residual_block_fp32",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock_fp32.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:470",
        "launches": sum(fp32_by_path.values()),
        "launches_by_path": fp32_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows_fp32),
        "ms": k4["kernel_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "bound_ffma_ms": k4["bound_ffma_ms"],
        "library_ms": k4["library_ms"],
        "library": "cuDNN fp32 conv2d composition of the same block (TF32 off)",
        "peak": "bound_ms: three TF32 passes at 495 TFLOP/s dense on the tensor cores "
                "(165 TFLOP/s of fp32 work), the route the kernel takes; bound_ffma_ms: "
                "66.9 TFLOP/s fp32 outside the tensor cores; 3.35 TB/s HBM (H100 SXM)",
        "tiles": {f"C{r['C']}B{r['B']}": r["tile"] + [r["cluster"]] for r in rows_fp32},
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
    }, {
        "name": "fused_residual_block_v2",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:220",
        "launches": sum(v2_by_path.values()),
        "launches_by_path": v2_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in probe["k3"]),
        "ms": k3_probe["kernel_ms"],
        "plain_ms": k3_probe["plain_ms"],
        "bound_ms": k3_probe["bound_ms"],
        "bound_by": k3_probe["bound_by"],
        "library_ms": k3_probe["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "functional_ms": k3_probe["functional_ms"],
        "k1_ms": k3_probe["k1_ms"],
        "tile": k3_probe["tile"], "cluster": k3_probe["cluster"],
        "per": f"one launch at the probe's {list(PROBE_SHAPE)} (its main path)",
        "flagship_forward": dict(
            k3, k1_ms=2 * sum(r["k1_ms"] for r in probe["k3"][:-1] if r["B"] == max(BATCHES)),
            per=f"8 launches at the shapes of one B={max(BATCHES)} flagship forward"),
    }, {
        "name": "any_dma_scale",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/any_dma.cu",
        "replaces": "benchmarks/pallas_probe.py:145",
        "launches": sum(any_dma_by_path.values()),
        "launches_by_path": any_dma_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in probe["k5"]),
        "ms": k5_small["kernel_ms"],
        "plain_ms": k5_small["plain_ms"],
        "bound_ms": k5_small["bound_ms"],
        "bound_by": k5_small["bound_by"],
        "library_ms": k5_small["library_ms"],
        "library": "x * 2 (one elementwise kernel; also the plain version)",
        "per": f"one launch on {k5_small['shape']} fp32 (the probe's slice)",
        "large": {k: k5_large[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "hbm_share_of_peak")},
    }]})
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
