"""``train.norm_fused_share``'s reader on hand-built traces: the share of
``msid.norm.train`` spans that hold a ``msid.norm.fused``."""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.trace import Trace


def read(trace):
    return registry.metric_reader("train.norm_fused_share")(trace)


def norms(fused: int, plain: int) -> list:
    """Train-mode norm spans, the first ``fused`` with a fused span inside."""
    spans = []
    for i in range(fused + plain):
        spans.append(("msid.norm.train", i + 0.1, i + 0.9))
        if i < fused:
            spans.append(("msid.norm.fused", i + 0.2, i + 0.8))
    return spans


@pytest.mark.parametrize("fused,plain,want", [(29, 0, 100.0), (0, 29, 0.0), (3, 1, 75.0)])
def test_share_of_norms_that_ran_the_kernels(fused, plain, want):
    trace = Trace(device=[("k", 0.0, 1.0)], spans=norms(fused, plain) + [
        ("msid.train.update", 40.0, 41.0)], window_s=50.0)
    assert read(trace) == pytest.approx(want)


def test_nothing_to_read_without_norms_or_device_records():
    assert read(Trace(device=[("k", 0.0, 1.0)], spans=[("msid.train.update", 0, 1)],
                      window_s=2.0)) is None
    assert read(Trace(device=[], spans=norms(2, 0), window_s=2.0)) is None


def test_the_metric_is_listed_for_the_train_cell_alone():
    bench = registry.load_benchmark(registry.HERE.parent)
    entry, = [m for m in bench["per_layer"] if m["name"] == "train.norm_fused_share"]
    assert entry["workloads"] == ["flagship.train.b64"]
    assert entry["moves"] == "train_tiles_per_s" and entry["source"] == "program_span"
    assert entry["layer"] == "model step (models.restoration)"
