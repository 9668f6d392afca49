"""The plain reference against the program on the CPU at a tiny size (in
float32 the two compute the same function), and the controls: the
reference in fp8 in the program's place reads above each cell's limit."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.kinds import program_model
from portbench.weights import reference_model, seeded_state

CELLS = ["flagship.scene.b64", "capacity2x.scene.b64", "flagship.train.b64",
         "flagship.serve.b1"]


@pytest.mark.parametrize("cell", ["flagship.scene.b64", "capacity2x.scene.b64"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_reference_is_the_program_in_float32(tiny, cpu, cell, mode):
    c = tiny(cell)
    config = c["config"]["config"]
    state = seeded_state(config, 2 ** 40 + 3, cpu)
    program = program_model(c["config"], state, cpu, torch.float32)
    ref = reference_model(config, state, cpu)
    getattr(program, mode)()
    getattr(ref, mode)()
    x = torch.randn(3, 64, 64, 13) * 0.5
    x[1, :, :, 4] *= 1e-3                       # a dead band: the fill path
    with torch.no_grad():
        got, want = program(x), ref(x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_scene_is_the_program_restore(tiny, cpu):
    from msid_tpu_torch.deployment.sliding_window import restore_scene

    from portbench import traffic
    from portbench.reference import scene as ref_scene

    c = tiny("flagship.scene.b64")
    config, t = c["config"]["config"], c["traffic"]
    state = seeded_state(config, 9, cpu)
    scene = traffic.scenes(dict(t, scene_side=130), 9, cpu)[0]
    got = restore_scene(program_model(c["config"], state, cpu, torch.float32), None, scene,
                        t["window"], t["overlap"], t["model_size"], t["batch"],
                        device_assembly=True, device=cpu)
    want = ref_scene.restore(reference_model(config, state, cpu).eval(), scene, t["window"],
                             t["overlap"], t["model_size"], t["batch"], cpu)
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_near_zero_in_float32(tiny, cpu, cell):
    result = run.execute(tiny(cell), 2 ** 33 + 11, 0.5, False, cpu, time.perf_counter(),
                         log=lambda line: None)
    assert result["correct"] and result["failed"] == 0
    for name, v in result["checked"].items():
        assert v["value"] < 1e-3, name
    assert list(result)[-1] == "checked"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(tiny, cpu, cell):
    """The control (fp8 operands, ``reference/precision.py``) comes out as
    not correct against the cell's limits; on the card it is read at the
    cell's size by ``portbench/control.py``."""
    import importlib

    c = tiny(cell)
    driver = importlib.import_module(f"portbench.kinds.{c['traffic']['kind']}").Driver(
        c, 2 ** 35 + 1, cpu)
    driver.window(0.3)
    numbers = driver.control()
    assert any(v > float(c["checks"][k]["limit"]) for k, v in numbers.items()), numbers
