"""Tiny cells of the benchmark for CPU tests: every cell of BENCHMARK.json
with its configuration cut to a few layers and narrow widths, its traffic
to a few small units, so that a whole run (set-up, window, check) takes
seconds on the CPU. Not sizes that measure anything."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest

# A few threads a test process: the tests run in several workers at once.
os.environ.setdefault("OMP_NUM_THREADS", "2")

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import registry  # noqa: E402

torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

TINY_TRAFFIC = {
    "scene": dict(scene_side=150, scenes=2, model_size=64, batch=8, traced_scenes=1),
    "train": dict(check_steps=3, warmup_steps=1, traced_steps=2),
    "serve": dict(tile_size=64, pool=8, rate=40, warmup=2, traced_requests=6, sample=4),
}


def shrink(config: dict) -> dict:
    config["data"].update(image_size=64, synthetic_samples=40)
    config["model"]["encoder"].update(embed_dim=96, depth=2, num_heads=4, freeze_layers=[0])
    config["model"]["decoder"]["channels"] = [
        max(8, c // 8) for c in config["model"]["decoder"]["channels"]]
    config["training"].update(micro_batch_size=2, gradient_accumulation_steps=4)
    config["noise"]["impl"] = "pallas"      # K2's draws (its plain version on the CPU)
    return config


# A cell whose files are here but that BENCHMARK.json does not list yet (its
# p95 spread between runs is too wide to bound: PERF.md, open questions).
UNLISTED = [{"name": "flagship.serve.b1", "config": "flagship", "traffic": "serve.b1",
             "chips": 1, "why": "single tiles at B=1, open loop"}]


def tiny_cell(name: str, dtype: str = "float32") -> dict:
    bench = registry.load_benchmark(ROOT)
    bench["workloads"] = bench["workloads"] + UNLISTED
    cell = registry.cell(bench, name)
    shrink(cell["config"]["config"])
    cell["config"]["dtype"] = dtype
    if dtype == "float32":
        cell["config"]["config"]["training"]["mixed_precision"] = False
    cell["traffic"].update(TINY_TRAFFIC[cell["traffic"]["kind"]])
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
