"""Finds what a run needs by name, from files of their own.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and traffic mixes, and the metrics. Beside it, under
``portbench/``:

* ``configs/<config>.json``: the configuration as it is run (the resolved
  YAML under ``config``, the compute ``dtype``, its source);
* ``workloads/<traffic>.json``: a traffic mix, the parameters that the
  generator of its ``kind`` (``kinds/<kind>.py``) reads;
* ``checks/<cell>.json``: the limit of each number that decides ``correct``
  in that cell, with the readings it was set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(trace) -> float | None``.

A cell, a configuration, a mix or a metric is added by adding its files
and its entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(folder: str, name: str, base: Path = HERE) -> dict:
    path = base / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, base: Path = HERE) -> dict:
    """Everything a run of cell ``name`` reads: its entry, its configuration
    file, its traffic file, its limits, and the metrics it reports, each
    with its unit (``end_to_end`` and ``per_layer``)."""
    entry = _by_name(bench["workloads"], name, "workload")
    config = _json("configs", entry["config"], base)
    traffic = _json("workloads", entry["traffic"], base)
    return {
        "name": name,
        "chips": int(entry["chips"]),
        "config_name": entry["config"],
        "config": config,
        "traffic_name": entry["traffic"],
        "traffic": traffic,
        "checks": _json("checks", name, base),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in bench["per_layer"] if reports(m, name)],
    }
