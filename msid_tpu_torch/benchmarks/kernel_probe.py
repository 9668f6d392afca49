"""Probe harness for the fused decoder ResidualBlock kernels: counterpart
of ``benchmarks/pallas_probe.py``.

Times one variant per invocation against the same inputs (numpy seed 0, as
the JAX probe draws them), on the GPU with CUDA events after warmup:

    python -m msid_tpu_torch.benchmarks.kernel_probe xla       # library convs, fp32 outputs
    python -m msid_tpu_torch.benchmarks.kernel_probe xla_bf16  # folded pure-bf16 convs
    python -m msid_tpu_torch.benchmarks.kernel_probe fused     # K4, the fp32 kernel (v1)
    python -m msid_tpu_torch.benchmarks.kernel_probe v3        # K1
    python -m msid_tpu_torch.benchmarks.kernel_probe v2:8:16   # K3, output tile 8 x 16
    python -m msid_tpu_torch.benchmarks.kernel_probe any_dma   # K5, the async-copy gate

``--shape B,H,W,C`` (default 64,192,192,48) sets the block's shape and
``--device cpu`` runs every variant through its plain PyTorch version on
the CPU (small shapes; the time it prints is a host-clock time of the
plain version, not a device time). ``main(argv)`` returns what it printed
as a dict.

What differs from the JAX probe, and why:
  * ``xla`` upcasts the bf16 operands and runs the library convolution
    with fp32 outputs; cuDNN may use TF32 there, which is exact for
    bf16-valued operands (8 significant bits in a 10-bit mantissa, fp32
    accumulation), so the result is the fp32-output block either way.
  * ``fused``: the TPU kernel v1 takes the probe's bf16 inputs and casts
    them to fp32 inside. K4 takes fp32, so x and the weights are cast to
    fp32 before the timed loop and the timed call is K4 plus the cast of
    its output back to bf16.
  * ``v3`` has no options: K1's cost model picks its tile and cluster.
  * ``v2:<row_block>:<col_block>`` names the output tile of a cluster
    (``v2_tile`` picks the cluster and weight ring for it); with no suffix
    the wrapper takes the cost model's tile (the TPU default of 16 x 96
    does not fit a CTA's shared memory and raises). As for ``v3``, the
    weights are prepared once into the kernel's layout before the timed
    loop.
  * ``any_dma`` lets a failure raise instead of reporting "still blocked".
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops import cuda_decoder, cuda_probe

DEFAULT_SHAPE = (64, 192, 192, 48)
ANY_DMA_ROWS = 8


@functools.lru_cache(maxsize=1)
def _make_inputs(shape: tuple, device: torch.device, dtype: torch.dtype):
    b, h, w, c = shape
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    w1 = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32)
    aff = np.stack([
        rng.uniform(0.5, 1.5, c), rng.uniform(-0.1, 0.1, c),
        rng.uniform(0.5, 1.5, c), rng.uniform(-0.1, 0.1, c),
    ]).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(w1).to(device, dtype),
            torch.from_numpy(w2).to(device, dtype), torch.from_numpy(aff).to(device))


def make_inputs(shape: Sequence[int], device: torch.device,
                dtype: torch.dtype = torch.bfloat16):
    """x [B,H,W,C], w1, w2 [3,3,C,C] HWIO in ``dtype`` and the affine
    [4,C] fp32, drawn as ``pallas_probe.make_inputs`` draws them. The last
    draw is kept (seconds of numpy at the default shape), so variants run
    one after another in one process share it; no variant writes to it."""
    return _make_inputs(tuple(shape), device, dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def xla_block(x, w1, w2, aff):
    """Eval-mode ResidualBlock with folded BN on library convs with fp32
    outputs and fp32 elementwise math, h rounded to x's dtype."""
    xf = x.float().permute(0, 3, 1, 2)
    a = aff[:, :, None, None]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        y1 = _gelu(F.conv2d(xf, _oihw(w1.float()), padding=1) * a[0] + a[1])
        y1 = y1.to(x.dtype).float()
        y2 = F.conv2d(y1, _oihw(w2.float()), padding=1) * a[2] + a[3]
    return _gelu(y2 + xf).to(x.dtype).permute(0, 2, 3, 1)


def xla_bf16_block(x, w1, w2, aff):
    """What ``deployment.fastpath._fast_decode`` runs for a block: pure-bf16
    convs with the BN scale folded into the weights and the bias added in
    bf16, bf16 GELUs."""
    xc = x.permute(0, 3, 1, 2)

    def conv(v, w, scale, bias):
        k = _oihw((w.float() * scale).to(v.dtype))
        return F.conv2d(v, k, padding=1) + bias.to(v.dtype)[:, None, None]

    z = _gelu(conv(xc, w1, aff[0], aff[1]))
    z = conv(z, w2, aff[2], aff[3])
    return _gelu(xc + z).permute(0, 2, 3, 1)


def timeit(fn: Callable[[], torch.Tensor], device: torch.device, iters: int,
           warmup: int = 3) -> float:
    """ms per call: CUDA events around ``iters`` calls after ``warmup`` on
    the GPU, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Probe the fused ResidualBlock kernels")
    p.add_argument("variant", nargs="?", default="xla",
                   help="xla | xla_bf16 | fused | v3 | v2[:<row_block>:<col_block>] | any_dma")
    p.add_argument("--shape", type=str, default=",".join(map(str, DEFAULT_SHAPE)),
                   help="B,H,W,C of the block")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--iters", type=int, default=50, help="timed calls after 3 warmup calls")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    which = args.variant
    shape = tuple(int(v) for v in args.shape.split(","))
    if len(shape) != 4:
        raise SystemExit(f"--shape takes B,H,W,C, got {args.shape!r}")
    device = resolve_device(args.device)
    b, h, w, c = shape
    x, w1, w2, aff = make_inputs(shape, device)
    gflop = 2 * 2 * b * h * w * 9 * c * c / 1e9
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"variant": which, "shape": list(shape), "device": where}

    if which == "any_dma":
        xs = x[0, :ANY_DMA_ROWS].float().contiguous()            # [rows, W, C]
        got = cuda_probe.any_dma_scale(xs)
        ok = bool(torch.allclose(got, xs * 2.0, atol=1e-6))
        how = ("an asynchronous bulk copy into shared memory under an mbarrier"
               if device.type == "cuda" else "the plain version, no copy engine")
        print(f"any_dma: RAN, correct={ok} (torch {torch.__version__}, {where}): {how}")
        result.update(correct=ok, calls=1)
        return result

    parts = which.split(":")
    if which == "xla":
        fn = functools.partial(xla_block, x, w1, w2, aff)
    elif which == "xla_bf16":
        fn = functools.partial(xla_bf16_block, x, w1, w2, aff)
    elif which == "fused":
        xf, w1f, w2f = x.float(), w1.float(), w2.float()

        def fn():
            return cuda_decoder.fused_residual_block(xf, w1f, w2f, aff).to(x.dtype)
    elif which == "v3" or (parts[0] == "v2" and len(parts) <= 3):
        k1, k2 = w1, w2
        if x.device.type == "cuda":          # the kernels' K-major operands, made once
            k1, k2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        if which == "v3":
            fn = functools.partial(cuda_decoder.fused_residual_block, x, k1, k2, aff)
        else:
            tile = [int(v) for v in parts[1:]] + [None] * (3 - len(parts))
            fn = functools.partial(cuda_decoder.fused_residual_block_v2, x, k1, k2, aff,
                                   row_block=tile[0], col_block=tile[1])
    else:
        raise SystemExit(f"unknown probe {which}")

    ms = timeit(fn, device, args.iters)
    calls = 3 + args.iters
    err = None
    if parts[0] in ("v2", "v3"):          # the hand-written bf16 kernels: also compared
        err = _max_abs(fn(), xla_block(x, w1, w2, aff))
        calls += 1
        print(f"max|d| vs xla: {err:.4f}")
    note = "" if device.type == "cuda" else "  [cpu: host clock, plain versions]"
    print(f"{which}: {ms:.2f} ms  ({gflop / ms:.1f} TF/s effective){note}")
    result.update(ms=ms, tflops=gflop / ms, max_abs_vs_xla=err, calls=calls)
    return result


if __name__ == "__main__":
    main()
