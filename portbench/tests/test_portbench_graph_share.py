"""``train.graph_share``'s reader on hand-built traces: the share of
``msid.train.update`` spans whose step opened a ``msid.train.replay``."""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.trace import Trace


def read(trace):
    return registry.metric_reader("train.graph_share")(trace)


def steps(replayed: int, eager: int) -> list:
    """Train steps' spans, the first ``replayed`` inside a replay span."""
    spans = []
    for i in range(replayed + eager):
        if i < replayed:
            spans.append(("msid.train.replay", i + 0.1, i + 0.9))
        spans += [("msid.train.forward", i + 0.2, i + 0.3),
                  ("msid.train.update", i + 0.6, i + 0.8)]
    return spans


@pytest.mark.parametrize("replayed,eager,want", [(4, 0, 100.0), (0, 4, 0.0), (3, 1, 75.0)])
def test_share_of_steps_that_replayed(replayed, eager, want):
    trace = Trace(device=[("k", 0.0, 1.0)], spans=steps(replayed, eager), window_s=10.0)
    assert read(trace) == pytest.approx(want)


def test_nothing_to_read_without_update_spans():
    assert read(Trace(device=[("k", 0.0, 1.0)], spans=[("msid.train.replay", 0, 1)],
                      window_s=2.0)) is None
    assert read(Trace(device=[("k", 0.0, 1.0)], spans=[], window_s=2.0)) is None


def test_the_metric_is_listed_for_the_train_cell_alone():
    bench = registry.load_benchmark(registry.HERE.parent)
    entry, = [m for m in bench["per_layer"] if m["name"] == "train.graph_share"]
    assert entry["workloads"] == ["flagship.train.b64"]
    assert entry["moves"] == "train_tiles_per_s" and entry["source"] == "program_span"
    assert entry["layer"] == "trainer step (training.train_state)"
