"""A whole run on the CPU at a tiny size, past the look for a card, with
the timed path broken underneath (``control.planted``): ``correct`` comes
out false for each fault the cell can have. The cells have no exchange
between chips, so that fault does not apply."""

from __future__ import annotations

import time

import pytest

from portbench import run
from portbench.control import planted

FAULTS = [("flagship.scene.b64", "altered"), ("capacity2x.scene.b64", "altered"),
          ("flagship.serve.b1", "altered"), ("flagship.train.b64", "unchanged"),
          ("flagship.train.b64", "half")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(tiny, cpu, cell, fault):
    with planted(fault):
        result = run.execute(tiny(cell), 2 ** 34 + 5, 0.5, False, cpu, time.perf_counter(),
                             log=lambda line: None)
    assert result["correct"] is False, result["checked"]


def test_faults_leave_the_program_as_it_was(tiny, cpu):
    from msid_tpu_torch.training import trainer

    before = trainer.make_train_step
    with planted("half"):
        assert trainer.make_train_step is not before
    assert trainer.make_train_step is before
