"""Two source trees' kernels in turns on one card: K2 and K3 timed, and K1,
K2 and K3's outputs compared between the trees.

    python -m msid_tpu_torch.benchmarks.kernel_turns --other DIR

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked by ``git archive``). Each turn is a child process started
in one tree with only that tree on its path: it builds the kernels there
(the builds its ``chip_smoke.py`` lists, all started together), times each with
CUDA events (median of ``ITERS`` calls after warmup) on seeded inputs, and
saves a few outputs. The turns run other, this, this, other, so that a
drift of the card's clock shows. The child calls only entry points that
both trees have: ``apply_sensor_noise_kernel(seed, x, cfg)``,
``fused_residual_block_v2(x, w1, w2, aff)`` with HWIO weights (as the
kernel probe calls it) and ``fused_residual_block(x, w1k, w2k, aff)`` with
``prepare_bf16_weights`` operands (as the model calls K1).

Prints one JSON line: the card, each turn's times, each tree's mean, and
per kernel whether the trees' outputs are equal (and their largest
difference). Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ITERS = 20

# The child's code: run as ``python -c`` in a tree, with argv [out_file].
CHILD = r'''
import json, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
import chip_smoke
from msid_tpu_torch.ops import _build, cuda_decoder, cuda_noise
from msid_tpu_torch.ops.noise import NoiseConfig

SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192))
ITERS = int(sys.argv[2])
t0 = time.perf_counter()
with ThreadPoolExecutor(len(chip_smoke.KERNELS)) as pool:   # the tree's own builds
    list(pool.map(lambda k: _build.build(*k), chip_smoke.KERNELS))
build_seconds = time.perf_counter() - t0


def time_ms(fn, warmup=3):
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(ITERS)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def block(c, s, b, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (b, s, s, c)).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c)).astype(np.float32))
              for _ in range(2))
    aff = torch.from_numpy(np.stack([rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                                     rng.normal(1, 0.1, c), rng.normal(0, 0.1, c)])
                           .astype(np.float32))
    return (x.cuda().bfloat16(), w1.cuda().bfloat16(), w2.cuda().bfloat16(), aff.cuda())


times, outputs = {}, {}
kernel = cuda_noise.apply_sensor_noise_kernel
g = torch.Generator(device="cuda").manual_seed(0)
cfg = NoiseConfig()
for dtype in (torch.float32, torch.bfloat16):
    x = (torch.rand(64, 192, 192, 13, device="cuda", generator=g) * 4 - 2).to(dtype)
    times[f"k2_{str(dtype)[6:]}_64x192x192x13"] = time_ms(lambda: kernel(11, x, cfg))
x = torch.rand(4, 192, 192, 13, device="cuda", generator=g) * 5 - 2.5
outputs["k2_fp32_striped"] = kernel(
    12, x, NoiseConfig(enable_striping=True, stripe_prob=0.5)).cpu()
outputs["k2_bf16"] = kernel(13, x.bfloat16(), cfg).cpu()

args = block(48, 192, 64, seed=0)                 # the kernel probe's block
times["k3_64x192x192x48"] = time_ms(lambda: cuda_decoder.fused_residual_block_v2(*args))
del args
for c, s in SHAPES:
    for b in (16, 1):
        x, w1, w2, aff = block(c, s, b, seed=c + b)
        p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        if b == 16:
            times[f"k3_16x{s}x{s}x{c}"] = time_ms(
                lambda: cuda_decoder.fused_residual_block_v2(x, w1, w2, aff))
            times[f"k1_16x{s}x{s}x{c}"] = time_ms(
                lambda: cuda_decoder.fused_residual_block(x, p1, p2, aff))
        else:
            outputs[f"k3_1x{s}x{s}x{c}"] = cuda_decoder.fused_residual_block_v2(
                x, w1, w2, aff).cpu()
            outputs[f"k1_1x{s}x{s}x{c}"] = cuda_decoder.fused_residual_block(
                x, p1, p2, aff).cpu()
torch.cuda.synchronize()
torch.save(outputs, sys.argv[1])
print(json.dumps({"build_seconds": build_seconds, "times": times}))
'''


def run_turn(tree: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out), str(ITERS)], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed (rc={proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare(torch, a: dict, b: dict) -> dict:
    """Per output: equal, and the largest difference."""
    return {k: {"equal": bool(torch.equal(a[k], b[k])),
                "max_abs_diff": float((a[k].float() - b[k].float()).abs().max())}
            for k in a}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="root of the other tree (e.g. the parent's git archive)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    trees = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    with tempfile.TemporaryDirectory(prefix="kernel_turns_") as tmp:
        for name in ("other", "this", "this", "other"):
            out = Path(tmp) / f"{name}.pt"
            turns.append({"tree": name, **run_turn(trees[name], out)})
        outputs = {name: torch.load(Path(tmp) / f"{name}.pt") for name in trees}
    mean = {name: {k: float(np.mean([t["times"][k] for t in turns if t["tree"] == name]))
                   for k in turns[0]["times"]} for name in trees}
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "iters": ITERS,
              "turns": turns, "mean_ms": mean,
              "this_vs_other": {k: mean["this"][k] / mean["other"][k] for k in mean["this"]},
              "outputs_this_vs_other": compare(torch, outputs["this"], outputs["other"])}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
