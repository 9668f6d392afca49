#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, on a machine with a CUDA card, ``nvcc`` and no
network. Phases, each of which must pass:

1. build: compile ``msid_tpu_torch/csrc/{resblock,noise}.cu`` for sm_90a,
   one ``nvcc`` per source, started together;
2. kernel: the fused ResidualBlock kernel (K1) against its plain PyTorch
   version at the flagship decoder's four shapes, B=1 and B=16
   (rtol 0.03 / atol 0.02), with its time beside the plain version's, a
   cuDNN bf16 composition's and the card's bound;
3. noise: the fused corruption kernel (K2) against its plain version at
   [64,192,192,13] and [4,192,192,13] fp32 and [16,192,192,13] bf16, with
   striping off and on: dead-band masks and stripe gates exactly equal,
   fp32 within 1e-6, bf16 within one ulp; the distribution checks of the
   JAX package's TPU test; its time beside the plain version's and its
   bytes bound;
4. serve: the full-width bf16 flagship (``long_skip_fill.yaml``) with
   seeded random weights answers 4 requests at B=1 and 4 at B=16 through
   ``InferenceSession.predict``; exactly 8 K1 launches per forward;
   the B=1 output is held against the same weights in fp32 on the CPU;
   latency by host clock (predict) and CUDA events (device), and device
   time by kernel from ``torch.profiler``;
5. train: one bf16 train step of the flagship at B=2 on the card against
   the same step in fp32 on the CPU (every noise component off); then
   ``setup_training_session(synthetic=True, epochs=1)`` and
   ``Trainer.fit``: 6 train steps of 64 tiles and 2 padded validation
   batches, finite history, no skipped step, encoder blocks 0-5 unchanged,
   every other parameter moved, one K2 launch per train step and per
   validation batch and 8 K1 launches per validation batch; then step
   times with the kernel and with the plain composition (``noise.impl:
   jnp``) in turns, peak memory, and a profiler breakdown of one step.

The last lines are the kernels JSON line (K1 and K2, with their launches on
the serving and training paths), the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that last line; so does a machine with no card, or a
directory without the package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "experiments" / "long_skip_fill.yaml"
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192))   # (C, H=W) per stage
BATCHES = (1, 16)
REQUESTS = 4
RTOL, ATOL = 0.03, 0.02          # the TPU kernel v3's golden tolerance
MAX_REL_RMS = 2e-2               # bf16 GPU forward vs fp32 CPU forward
KERNELS = ("resblock", "noise")   # csrc/<name>.cu, built in parallel
# K2 against its plain version: both compute in fp32 from the same Philox
# words; logf/sincospif against torch's log/cos differ by an ulp or two.
NOISE_ATOL = 1e-6
NOISE_CASES = (((64, 192, 192, 13), "float32"), ((4, 192, 192, 13), "float32"),
               ((16, 192, 192, 13), "bfloat16"))
# One train step, bf16 autocast on the card against fp32 on the CPU: bf16
# keeps ~3 digits through 12 ViT blocks, the decoder and the backward; the
# gradient norm sums squares of ~10^8 bf16-rounded terms, hence the looser bound.
PARITY_BATCH = 2
PARITY_LOSS_RTOL = 1e-2
PARITY_GNORM_RTOL = 5e-2
TIMED_STEPS = 4


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


def block_bound(c: int, s: int, b: int) -> tuple[float, str, float, float]:
    """Least time for one block on the card: (ms, bound_by, flops, bytes)."""
    flops = 2 * 2 * 9 * c * c * s * s * b
    nbytes = 2 * b * s * s * c * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def random_block_inputs(torch, c: int, s: int, b: int, seed: int):
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
    return (torch.from_numpy(x).to(dev, torch.bfloat16),
            torch.from_numpy(w1).to(dev, torch.bfloat16),
            torch.from_numpy(w2).to(dev, torch.bfloat16),
            torch.from_numpy(aff.astype(np.float32)).to(dev))


def library_block(torch, F):
    """The block as a cuDNN bf16 composition (yardstick only, never used by
    the port): channels-last bf16 convs, affine, GELU, residual."""
    def run(x, k1, k2, aff):
        xc = x.permute(0, 3, 1, 2)
        a = aff.to(torch.bfloat16)[:, :, None, None]
        h = F.gelu(F.conv2d(xc, k1, padding=1) * a[0] + a[1], approximate="tanh")
        y = F.conv2d(h, k2, padding=1) * a[2] + a[3] + xc
        return F.gelu(y, approximate="tanh")
    return run


def phase_kernel(torch, F, failures: list) -> list[dict]:
    from msid_tpu_torch.ops import cuda_decoder

    lib = library_block(torch, F)
    rows = []
    for c, s in SHAPES:
        for b in BATCHES:
            x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b)
            got = cuda_decoder.fused_residual_block(x, w1, w2, aff)
            want = cuda_decoder.fused_residual_block_reference(x, w1, w2, aff)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            max_err = float(diff.max())
            ok = bool((diff <= ATOL + RTOL * want.float().abs()).all()
                      and torch.isfinite(got.float()).all())
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
            row = {
                "check": "resblock", "C": c, "H": s, "W": s, "B": b,
                "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
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
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"resblock C={c} H={s} B={b}: max_abs_err {max_err}")
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
    xd = torch.from_numpy(x).to("cuda", model.dtype)
    with torch.inference_mode():
        return device_profile(torch, lambda: model(xd), iters,
                              {"resblock_ms": "resblock_kernel"})


def phase_serve(torch, failures: list, card: str) -> dict:
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder, cuda_noise
    from msid_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
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
    return result


def bf16_ulp(torch, v):
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def noise_bound_ms(b: int, n: int, itemsize: int) -> float:
    """Bytes bound of one corruption pass: read x once, write out once."""
    return 2 * b * n * itemsize / PEAK_HBM_BYTES * 1e3


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
    x = torch.rand(b, h, w, c, device="cuda") * 4 - 2
    cfg = NoiseConfig()
    timing = {"check": "noise_time", "shape": [b, h, w, c], "dtype": "float32",
              "kernel_ms": time_ms(torch, lambda: kernel(11, x, cfg)),
              "plain_ms": time_ms(torch, lambda: plain(11, x, cfg), iters=5, warmup=1),
              "jnp_impl_ms": time_ms(torch, lambda: apply_sensor_noise(11, x, cfg)),
              "bound_ms": noise_bound_ms(b, h * w * c, 4), "bound_by": "bytes",
              "max_abs_err": max_err}
    timing["hbm_share_of_peak"] = timing["bound_ms"] / timing["kernel_ms"]
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
    session = setup_training_session(cfg, synthetic=True, epochs=1, seed=0)
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
                          iters=2, tags={"noise_ms": "noise_kernel"})
    prof["noise_share_of_busy"] = prof["noise_ms"] / prof["device_busy_ms"]
    prof["device_idle_share"] = 1 - prof["device_busy_ms"] / result["step_pallas"]["host_p50_ms"]
    result["profile"] = prof
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from msid_tpu_torch.ops._build import build, load_library, nvcc_path

    # The plain versions are the yardstick: full fp32, no TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    failures: list[str] = []

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, together
        list(pool.map(build, KERNELS))
    for name in KERNELS:
        load_library(name)
    emit({"check": "build", "sources": [f"msid_tpu_torch/csrc/{k}.cu" for k in KERNELS],
          "nvcc": nvcc_path(), "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = phase_kernel(torch, F, failures)
    noise = phase_noise(torch, failures)
    serve = phase_serve(torch, failures, card)
    train = phase_train(torch, failures, card)

    big = [r for r in rows if r["B"] == max(BATCHES)]
    per_forward = {k: 2 * sum(r[k] for r in big)       # 2 blocks per stage
                   for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    resblock_by_path = {"serve": serve["launches"], "train": train["launches"]["resblock"]}
    noise_by_path = {"serve": serve["noise_launches"], "train": train["launches"]["noise"]}
    emit({"kernels": [{
        "name": "fused_residual_block",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:402",
        "launches": sum(resblock_by_path.values()),
        "launches_by_path": resblock_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward["kernel_ms"],
        "plain_ms": per_forward["plain_ms"],
        "bound_ms": per_forward["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in big)
        else "bytes",
        "library_ms": per_forward["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
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
