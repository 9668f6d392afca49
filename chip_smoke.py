#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, on a machine with a CUDA card, ``nvcc`` and no
network. Phases, each of which must pass:

1. build: compile ``msid_tpu_torch/csrc/resblock.cu`` for sm_90a;
2. kernel: the fused ResidualBlock kernel against its plain PyTorch
   version at the flagship decoder's four shapes, B=1 and B=16
   (rtol 0.03 / atol 0.02), with its time beside the plain version's, a
   cuDNN bf16 composition's and the card's bound;
3. serve: the full-width bf16 flagship (``long_skip_fill.yaml``) with
   seeded random weights answers 4 requests at B=1 and 4 at B=16 through
   ``InferenceSession.predict``; exactly 8 kernel launches per forward;
   the B=1 output is held against the same weights in fp32 on the CPU;
   latency by host clock (predict) and CUDA events (device), and device
   time by kernel from ``torch.profiler``.

The last lines are the kernels JSON line, the card's ``nvidia-smi`` name
and power limit, and ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero without that last line; so does a machine with no card,
or a directory without the package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def profile_forward(torch, model, x: np.ndarray, iters: int = 3) -> dict:
    """Device time and launches per forward, by kernel name, from the
    device-side events of ``torch.profiler`` (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xd = torch.from_numpy(x).to("cuda", model.dtype)
    with torch.inference_mode():
        model(xd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                model(xd)
            torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
            launches += 1
    busy = sum(per_kernel.values())
    resblock = sum(v for k, v in per_kernel.items() if "resblock_kernel" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"device_busy_ms": busy, "resblock_ms": resblock,
            "device_launches": launches / iters,
            "top_ms": [[k[:80], v] for k, v in top]}


def phase_serve(torch, failures: list, card: str) -> dict:
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder
    from msid_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    randomize_(torch, cpu_model, seed=0)
    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    model.load_state_dict(cpu_model.state_dict())
    size, bands = cpu_model.image_size, cpu_model.in_channels

    result = {"check": "serve", "config": str(CONFIG.relative_to(ROOT)),
              "dtype": "bfloat16", "card": card}
    launches_total = 0
    for b in BATCHES:
        session = InferenceSession(model, batch_size=b, image_size=size,
                                   num_bands=bands)
        requests = [noisy_tiles(b, size, bands, seed=100 * b + i)
                    for i in range(REQUESTS)]
        session.predict(requests[0])                    # warmup
        cuda_decoder.launches = 0
        outs = [session.predict(r) for r in requests]
        launches = cuda_decoder.launches
        launches_total += launches
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
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from msid_tpu_torch.ops._build import load_library, nvcc_path

    # The plain versions are the yardstick: full fp32, no TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    failures: list[str] = []

    t0 = time.perf_counter()
    load_library("resblock")
    emit({"check": "build", "source": "msid_tpu_torch/csrc/resblock.cu",
          "nvcc": nvcc_path(), "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = phase_kernel(torch, F, failures)
    serve = phase_serve(torch, failures, card)

    big = [r for r in rows if r["B"] == max(BATCHES)]
    per_forward = {k: 2 * sum(r[k] for r in big)       # 2 blocks per stage
                   for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    emit({"kernels": [{
        "name": "fused_residual_block",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:402",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward["kernel_ms"],
        "plain_ms": per_forward["plain_ms"],
        "bound_ms": per_forward["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in big)
        else "bytes",
        "library_ms": per_forward["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
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
