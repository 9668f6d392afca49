"""Two source trees' kernels in turns on one card: K1, K2, K3 and K5 timed,
and K1, K2, K3 and K4's outputs compared between the trees.

    python -m msid_tpu_torch.benchmarks.kernel_turns --other DIR

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked by ``git archive``). Each turn is a child process started
in one tree with only that tree on its path: it builds the kernels there
(the builds its ``chip_smoke.py`` lists, all started together), times each
with CUDA events (median of ``ITERS`` calls after warmup) on seeded
inputs (K1 at B=1, 16 and 64 of the flagship's four stage shapes and at
B=16 and 64 of a 768-wide decoder's 24x24 stage at the wide builds' widths
256, 300, 384, 500, 512, 640, 700 and 768, K3 at B=16 and the probe's
block), and saves a few outputs; K5 and ``x * 2`` also per call in a CUDA
graph of 100 (device time) beside their call time. Both timings are this
tree's ``chip_smoke.time_ms`` and ``chip_smoke.graph_ms``, loaded by path
in every turn, so that both trees are timed alike. The turns run other,
this, this, other, so that a drift of the card's clock shows. The child
calls only entry points that both trees have:
``apply_sensor_noise_kernel(seed, x, cfg)``,
``fused_residual_block_v2(x, w1k, w2k, aff)`` and
``fused_residual_block(x, w1k, w2k, aff)`` with ``prepare_bf16_weights``
operands (as the kernel probe calls K3 and the model K1), K3 on HWIO
weights for the compared outputs,
``fused_residual_block`` on fp32 x with HWIO weights (K4) and
``any_dma_scale(x)`` (K5).

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

# The child's code: run as ``python -c`` in a tree, with argv [out_file,
# iterations, the timing helpers' file].
CHILD = r'''
import importlib.util, json, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
import chip_smoke
from msid_tpu_torch.ops import _build, cuda_decoder, cuda_noise, cuda_probe
from msid_tpu_torch.ops.noise import NoiseConfig

SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192))
WIDE = ((256, 24), (300, 24), (384, 24), (500, 24), (512, 24), (640, 24), (700, 24), (768, 24))
ITERS = int(sys.argv[2])
spec = importlib.util.spec_from_file_location("turn_timing", sys.argv[3])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
t0 = time.perf_counter()
with ThreadPoolExecutor(len(chip_smoke.KERNELS)) as pool:   # the tree's own builds
    list(pool.map(lambda k: _build.build(*k), chip_smoke.KERNELS))
build_seconds = time.perf_counter() - t0


def time_ms(fn):
    return timing.time_ms(torch, fn, ITERS)


def graph_ms(fn):
    return timing.graph_ms(torch, fn)


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

for rows in (8, 3072):                            # K5 and x * 2: device and call time
    x = torch.randn(rows, 192, 48, device="cuda", generator=g)
    for name, fn in (("k5", lambda: cuda_probe.any_dma_scale(x)), ("x2", lambda: x * 2)):
        times[f"{name}_device_{rows}x192x48"] = graph_ms(fn)
        times[f"{name}_call_{rows}x192x48"] = time_ms(fn)
    del x

x, w1, w2, aff = block(48, 192, 64, seed=0)       # the kernel probe's block
p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
times["k3_64x192x192x48"] = time_ms(lambda: cuda_decoder.fused_residual_block_v2(x, p1, p2, aff))
del x, w1, w2, aff, p1, p2
for c, s in SHAPES:
    for b in (16, 64, 1):
        x, w1, w2, aff = block(c, s, b, seed=c + b)
        p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        times[f"k1_{b}x{s}x{s}x{c}"] = time_ms(
            lambda: cuda_decoder.fused_residual_block(x, p1, p2, aff))
        if b == 16:
            times[f"k3_16x{s}x{s}x{c}"] = time_ms(
                lambda: cuda_decoder.fused_residual_block_v2(x, p1, p2, aff))
        elif b == 1:
            outputs[f"k3_1x{s}x{s}x{c}"] = cuda_decoder.fused_residual_block_v2(
                x, w1, w2, aff).cpu()
            outputs[f"k1_1x{s}x{s}x{c}"] = cuda_decoder.fused_residual_block(
                x, p1, p2, aff).cpu()
            outputs[f"k4_1x{s}x{s}x{c}"] = cuda_decoder.fused_residual_block(
                x.float(), w1.float(), w2.float(), aff).cpu()
for c, s in WIDE:                                 # K1's wide builds
    for b in (16, 64):
        if f"k1_{b}x{s}x{s}x{c}" in times:
            continue
        x, w1, w2, aff = block(c, s, b, seed=c + b)
        p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        times[f"k1_{b}x{s}x{s}x{c}"] = time_ms(
            lambda: cuda_decoder.fused_residual_block(x, p1, p2, aff))
torch.cuda.synchronize()
torch.save(outputs, sys.argv[1])
print(json.dumps({"build_seconds": build_seconds, "times": times}))
'''


def run_turn(tree: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out), str(ITERS),
                           str(ROOT / "chip_smoke.py")], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=1200)
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
