"""Time K4 (``csrc/resblock_fp32.cu``) and K1 (``csrc/resblock.cu``) over
their launch geometries, on the card.

    python -m msid_tpu_torch.scripts.sweep_k4_tiles [--kernel k4|k1|both]
        [--out tiles.jsonl] [--top 10]

K4: for the flagship decoder's four shapes and two tiny widths, at B=1
and B=16, the ``--top`` cheapest geometries of ``fp32_candidates`` (output
tile, channel units per CTA, cluster size, staging depth) by its cost
estimate, and the cheapest of every other cluster size, are launched,
held to the plain version (max abs error <= 1e-4), then timed as the
median of CUDA events. K1: the same over ``bf16_candidates`` (output
tile, cluster size, weight-ring depth) at the four flagship shapes, held
to rtol 0.03 / atol 0.02. One JSON line per kernel and shape gives the
times by geometry, the fastest and the one the picker takes. Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192), (8, 64), (24, 16))
BATCHES = (1, 16)


def block_inputs(torch, c: int, s: int, b: int, dtype):
    rng = np.random.default_rng(c + b)
    x = torch.from_numpy(rng.normal(0, 1, (b, s, s, c)).astype(np.float32)).cuda().to(dtype)
    w1, w2 = (torch.from_numpy(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c))
                               .astype(np.float32)).cuda().to(dtype) for _ in range(2))
    aff = torch.from_numpy(np.stack([rng.normal(1, 0.1, c), rng.normal(0, 0.1, c)] * 2)
                           .astype(np.float32)).cuda()
    return x, w1, w2, aff


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(e) for a, e in pairs]))


def sweep(torch, cd, kernel: str, c: int, s: int, b: int, top: int, iters: int, sms: int) -> dict:
    """One line of the sweep: every chosen geometry of ``kernel`` at one shape."""
    if kernel == "k4":
        x, w1, w2, aff = block_inputs(torch, c, s, b, torch.float32)
        found = cd.fp32_candidates(c, s, s, b, sms)
        cluster_of, launch = 4, cd._fused_residual_block_fp32
        names = "th, tw, nt, nu, g, kc"
    else:
        x, w1, w2, aff = block_inputs(torch, c, s, b, torch.bfloat16)
        found = cd.bf16_candidates(c, s, s, b, sms)
        cluster_of, launch = 2, cd._fused_residual_block_bf16
        names = "th, tw, g, stages"
    want = cd.fused_residual_block_reference(x, w1, w2, aff).float()
    if kernel == "k1":
        w1, w2 = cd.prepare_bf16_weights(w1), cd.prepare_bf16_weights(w2)
    picked = found[0][1]
    chosen = [geometry for _, geometry in found[:top]]
    for g in {geometry[cluster_of] for _, geometry in found}:   # the best of each cluster size
        chosen.append(next(geo for _, geo in found if geo[cluster_of] == g))
    ms, ok, worst = {}, True, 0.0
    for geometry in dict.fromkeys(chosen):
        def run():
            return launch(x, w1, w2, aff, geometry=geometry)
        diff = (run().float() - want).abs()
        worst = max(worst, float(diff.max()))
        ok &= bool((diff <= (1e-4 if kernel == "k4" else 0.02 + 0.03 * want.abs())).all())
        ms[geometry] = time_ms(torch, run, iters)
    best = min(ms, key=ms.get)
    return {"kernel": kernel, "C": c, "H": s, "B": b, "picked": list(picked),
            "picked_ms": ms[picked], "best": list(best), "best_ms": ms[best],
            "ms_by_geometry": [[list(k), v] for k, v in ms.items()], "geometry": names,
            "max_abs_err": worst, "ok": ok, "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=("k4", "k1", "both"), default="both")
    p.add_argument("--out", type=str, default=None, help="also write the lines here")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    import torch

    from msid_tpu_torch.ops import cuda_decoder as cd

    if not torch.cuda.is_available():
        print("sweep_k4_tiles: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []
    if args.kernel in ("k4", "both"):
        # What FP32_ACTIVE_CLUSTERS holds: clusters of g CTAs the card runs at once.
        from msid_tpu_torch.ops._build import load_library

        fn = load_library("resblock_fp32").msid_resblock_fp32_active_clusters
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
        print(json.dumps({"kernel": "k4", "smem_bytes": 200000, "active_clusters": {
            g: fn(g, 200000) for g in (1, 2, 4, 8)}, "assumed": cd.FP32_ACTIVE_CLUSTERS}),
            flush=True)
    for kernel in ("k4", "k1") if args.kernel == "both" else (args.kernel,):
        for c, s in SHAPES:
            if kernel == "k1" and c not in cd.SUPPORTED_WIDTHS:
                continue
            for b in BATCHES:
                line = sweep(torch, cd, kernel, c, s, b, args.top, args.iters, sms)
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(l) + "\n" for l in lines))
    return 0 if all(l["ok"] for l in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
