"""Readings that the limits of ``checks/<cell>.json`` are set from, at the
cell's own size, on the card (the benchmark's runs never run this).

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--control]
        [--fault unchanged|half|altered] [--seconds 2]

For each seed, in one process: the cell's set-up, a short window, and the
run's own check (the program's reading); with ``--control``, the control's
reading too: the plain reference computed in fp8 (``reference/
precision.py``) put in the program's place, against the float32
reference. ``--fault`` plants a fault in the program first (``planted``).
Each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from portbench import registry


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted, for the cell's set-up and window:
    ``unchanged``, an optimizer step that leaves the state as it was;
    ``half``, a train step that takes half of its batch (the mean over the
    rest); ``altered``, an answer altered where it is produced (the first
    window of every scene batch, or an 8x8 patch of every served tile, set
    to 0)."""
    from msid_tpu_torch.deployment import inference, sliding_window
    from msid_tpu_torch.training import optim, trainer

    patches = []

    def patch(owner, name, make):
        patches.append((owner, name, getattr(owner, name)))
        setattr(owner, name, make(getattr(owner, name)))

    if fault == "unchanged":
        patch(optim.GroupedAdamW, "step", lambda step: lambda self, count: None)
    elif fault == "half":
        def make(make_train_step):
            def faulty(*args, **kwargs):
                step = make_train_step(*args, **kwargs)

                def half(state, batch, seed):
                    return step(state, batch[:batch.shape[0] // 2], seed)

                half.prepare = step.prepare
                return half
            return faulty
        patch(trainer, "make_train_step", make)
    elif fault == "altered":
        def scene(run):
            def faulty(self, batch):
                out = run(self, batch).clone()
                out[0] = 0.0
                return out
            return faulty

        def serve(predict):
            def faulty(self, x):
                out = predict(self, x)
                out[:, :8, :8] = 0.0
                return out
            return faulty
        patch(sliding_window.SceneStep, "run", scene)
        patch(inference.InferenceSession, "predict", serve)
    elif fault is not None:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for owner, name, original in reversed(patches):
            setattr(owner, name, original)


def readings(cell: dict, seed: int, seconds: float, control: bool, fault, device) -> dict:
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    t0 = time.perf_counter()
    with planted(fault):
        driver = kind.Driver(cell, seed, device)
        driver.window(seconds)
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["program"] = driver.check()
    if control:
        out["control"] = driver.control()
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=("unchanged", "half", "altered"))
    args = parser.parse_args(argv)
    cell = registry.cell(registry.load_benchmark(Path.cwd()), args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, args.seconds, args.control, args.fault,
                       torch.device("cuda", 0))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
