"""The group-channel cell and the K1 scene cell at a tiny size on the CPU:
a sound run reads near zero in float32, the fp8 control and a planted fault
come out as not correct, and the grouped reference restores a scene as the
program does."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import registry, run, traffic
from portbench.control import planted
from portbench.kinds import program_model, scene, scene_grouped
from portbench.reference import grouped
from portbench.reference import scene as ref_scene
from portbench.tests.conftest import ROOT, TINY_TRAFFIC, shrink

GROUPED = "satmae_gcl.scene96.b64"
CELLS = [GROUPED, "capacity2x.scene.k1"]


def tiny(name: str) -> dict:
    cell = registry.cell(registry.load_benchmark(ROOT), name)
    config = shrink(cell["config"]["config"])
    if "channel_embed" in config["model"]["encoder"]:
        config["model"]["encoder"]["channel_embed"] = 32
    cell["config"]["dtype"] = "float32"
    cell["traffic"].update(TINY_TRAFFIC["scene"])
    return cell


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_near_zero_in_float32(cpu, cell):
    result = run.execute(tiny(cell), 2 ** 33 + 19, 0.5, False, cpu, time.perf_counter(),
                         log=lambda line: None)
    assert result["correct"] and result["failed"] == 0
    assert result["checked"]["worst_block_rel_rms"]["value"] < 1e-4


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_are_not_correct(cpu, cell):
    c = tiny(cell)
    kind = scene_grouped if cell == GROUPED else scene
    driver = kind.Driver(c, 2 ** 35 + 19, cpu)
    driver.window(0.3)
    assert driver.control()["worst_block_rel_rms"] > c["checks"]["worst_block_rel_rms"]["limit"]
    with planted("altered"):
        result = run.execute(c, 2 ** 34 + 19, 0.3, False, cpu, time.perf_counter(),
                             log=lambda line: None)
    assert result["correct"] is False


def test_traced_run_records_tokens_and_groups(cpu):
    c = tiny(GROUPED)
    driver = scene_grouped.Driver(c, 7, cpu)
    driver.traced()
    assert driver.extra["tokens"] == 3 * (64 // 8) ** 2 and driver.extra["groups"] == 3
    assert driver.extra["scenes"] == 1 and driver.extra["batch"] == 8


def test_grouped_reference_scene_is_the_program_restore(cpu):
    from msid_tpu_torch.deployment.sliding_window import restore_scene

    c = tiny(GROUPED)
    config, t = c["config"]["config"], c["traffic"]
    state = grouped.seeded_state(config, 9, cpu)
    raw = traffic.scenes(dict(t, scene_side=130), 9, cpu)[0]
    got = restore_scene(program_model(c["config"], state, cpu, torch.float32), None, raw,
                        t["window"], t["overlap"], t["model_size"], t["batch"],
                        device_assembly=True, device=cpu)
    want = ref_scene.restore(grouped.reference_model(config, state, cpu).eval(), raw,
                             t["window"], t["overlap"], t["model_size"], t["batch"], cpu)
    assert np.abs(got - want).max() < 1e-4
