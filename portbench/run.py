"""One run of one benchmark cell of the PyTorch port on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run sets the cell up from the seed
(weights made on the device, inputs, the program's warm-up of every shape
the cell uses), measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or profiles a fixed sub-window (``--trace 1``: its
per-layer metrics), then, with the program's state freed, checks what the
timed path produced against the plain reference (``reference/``). The
last line of standard output is the result, a JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.

A run fails, and prints no result, without as many cards as the cell asks
for, and when JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import registry  # noqa: E402
from portbench.trace import device_ops, idle_gaps, profiled  # noqa: E402

# Top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msid_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
            log=print) -> dict:
    """Set up, measure and check one run; the result object (without
    ``device``'s card fields) and the numbers compared."""
    import torch

    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    driver = kind.Driver(cell, seed, device)
    setup_s = time.perf_counter() - t0
    if trace:
        if hasattr(driver, "unprofiled"):
            driver.unprofiled()
        _, record = profiled(torch, driver.traced, device.type == "cuda")
        record.extra.update(driver.extra)
        metrics = {}
        for m in cell["per_layer"]:
            value = registry.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        measured = driver.window(seconds)
        measured["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(measured[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = driver.attempted, driver.failed
    for line in driver.notes():
        log(line)
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    checked = {}
    for name, value in numbers.items():
        limit = float(cell["checks"][name]["limit"])
        checked[name] = {"value": float(value), "limit": limit}
    correct = bool(checked) and all(v["value"] <= v["limit"] for v in checked.values()) \
        and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=record.busy_s, window_s=record.window_s)
        result["breakdown"] = {"device_ops": device_ops(record),
                               "idle_gaps": idle_gaps(record)}
    result["checked"] = checked
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = registry.load_benchmark(Path.cwd())
    cell = registry.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}", file=sys.stderr)

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = execute(cell, args.seed, args.seconds, bool(args.trace), device, T0, log)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": cell["chips"], **result["device"]}
    checked = result.pop("checked")
    result["checked"] = checked
    for name, v in checked.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
