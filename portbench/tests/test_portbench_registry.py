"""Cells, configurations, traffic mixes, limits and metric readers are
found by name from files of their own; a cell is added by files alone.
BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import registry
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture
def bench():
    return registry.load_benchmark(ROOT)


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["kind"] in ("scene", "train", "serve")
        assert set(cell["checks"]) and all("limit" in v for v in cell["checks"].values())
        ends = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in ends and len(ends) >= 2 and cell["per_layer"]
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    with pytest.raises(KeyError):
        registry.cell(bench, "no.such.cell")


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs_are_the_yaml_as_resolved():
    from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config

    for path in (registry.HERE / "configs").glob("*.json"):
        entry = json.loads(path.read_text())
        resolved = coerce_scheduler_params(load_config(ROOT / entry["yaml"]))
        resolved["data"]["root_dir"] = entry["config"]["data"]["root_dir"]
        assert resolved == entry["config"], path.name


def test_a_cell_added_as_files_only(tmp_path, bench):
    copy = tmp_path / "portbench"
    shutil.copytree(registry.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "workloads" / "scene.b16.json").write_text(json.dumps(
        dict(registry.cell(bench, "flagship.scene.b64")["traffic"], batch=16)))
    (copy / "checks" / "flagship.scene.b16.json").write_text(
        json.dumps({"worst_block_rel_rms": {"limit": 0.01}}))
    (copy / "metrics" / "scene.windows.py").write_text(
        "def read(trace):\n    return trace.extra.get('tiles')\n")
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "flagship.scene.b16", "config": "flagship", "traffic": "scene.b16",
         "chips": 1, "why": "smaller batches"}]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "scene.windows", "unit": "tiles", "better": "higher", "source": "host_clock",
         "layer": "model step (models.restoration)", "moves": "restore_mpix_per_s",
         "workloads": ["flagship.scene.b16"]}]
    cell = registry.cell(bench, "flagship.scene.b16", base=copy)
    assert cell["traffic"]["batch"] == 16 and cell["config"]["name"] == "flagship"
    assert [m["name"] for m in cell["per_layer"]][-1] == "scene.windows"
    from portbench.trace import Trace

    reader = registry.metric_reader("scene.windows", base=copy)
    assert reader(Trace([], [], 1.0, extra={"tiles": 64})) == 64
    assert all(p.read_bytes() == data for p, data in before.items())
