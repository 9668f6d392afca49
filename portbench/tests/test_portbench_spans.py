"""The readers of the program's ``msid.*`` spans (``portbench/spans.py`` and
the metrics that use it) on hand-built traces, and a CPU rehearsal that a
span the port opens reaches ``Trace.spans`` under its name."""

from __future__ import annotations

import pytest

from portbench import registry, spans
from portbench.trace import Trace, idle_gaps

SCENE = ("scene.transfer_ms", "scene.transfer_idle_share", "scene.batch_idle_share")
TRAIN = ("train.prepare_idle_ms", "train.forward_idle_ms", "train.norm_idle_ms",
         "train.backward_idle_ms", "train.update_idle_ms", "train.loader_ms")


def read(name, trace):
    return registry.metric_reader(name)(trace)


def test_nested_and_repeated_spans_count_once():
    # idle: [0, 1), [2, 4), [5, 6)
    trace = Trace(device=[("k", 1.0, 2.0), ("k", 4.0, 5.0)],
                  spans=[("msid.scene.upload", 0.5, 3.0), ("msid.scene.upload", 0.5, 3.0),
                         ("msid.scene.download", 2.5, 3.5), ("aten::copy_", 0.0, 6.0)],
                  window_s=6.0, extra={"scenes": 1})
    assert spans.span_seconds(trace, ["msid.scene.upload", "msid.scene.download"]) \
        == pytest.approx(3.0)
    # idle under [0.5, 3.5): [0.5, 1) and [2, 3.5)
    assert spans.idle_under(trace, ["msid.scene.upload", "msid.scene.download"]) \
        == pytest.approx(2.0)
    assert read("scene.transfer_ms", trace) == pytest.approx(3000.0)
    assert read("scene.transfer_idle_share", trace) == pytest.approx(100 * 2.0 / 6.0)


def test_idle_outside_the_named_spans_is_not_counted():
    trace = Trace(device=[("k", 1.0, 2.0)],
                  spans=[("msid.scene.replay", 1.2, 1.8), ("msid.scene.blend", 2.5, 2.75),
                         ("msid.scene.upload", 0.0, 0.5)],
                  window_s=4.0, extra={"scenes": 1})
    # the replay is all device time; the blend a quarter second of the idle 2-4
    assert read("scene.batch_idle_share", trace) == pytest.approx(100 * 0.25 / 4.0)
    assert read("scene.transfer_idle_share", trace) == pytest.approx(100 * 0.5 / 4.0)


def test_leading_and_trailing_gaps_count_as_idle_gaps_counts_them():
    trace = Trace(device=[("k", 0.5, 1.0), ("k", 1.0, 3.0)],
                  spans=[("msid.scene.upload", 0.0, 4.0)], window_s=4.0,
                  extra={"scenes": 1})
    assert spans.idle_intervals(trace) == [(0.0, 0.5), (3.0, 4.0)]
    assert sum(g[1] for g in idle_gaps(trace)) == pytest.approx(1.5)
    assert spans.idle_under(trace, ["msid.scene.upload"]) == pytest.approx(1.5)
    # a span reaching past the window counts only inside it
    late = Trace(trace.device, [("msid.scene.upload", 3.5, 9.0)], 4.0, {"scenes": 1})
    assert read("scene.transfer_ms", late) == pytest.approx(500.0)


def test_per_scene_and_per_step_division():
    trace = Trace(device=[("k", 0.0, 1.0), ("k", 5.0, 6.0)],
                  spans=[("msid.scene.upload", 1.0, 2.0), ("msid.scene.download", 4.0, 5.0)],
                  window_s=6.0, extra={"scenes": 2})
    assert read("scene.transfer_ms", trace) == pytest.approx(1000.0)

    steps, device = [], []
    for k in range(4):      # 1 s steps: 0.1 s idle in each phase, half the forward's in Norm
        t = float(k)
        steps += [("msid.data.batch", t, t + 0.05),
                  ("msid.train.prepare", t + 0.05, t + 0.2),
                  ("msid.train.forward", t + 0.2, t + 0.5),
                  ("msid.norm.train", t + 0.3, t + 0.35),
                  ("msid.train.backward", t + 0.5, t + 0.8),
                  ("msid.train.update", t + 0.8, t + 1.0)]
        device += [("k", t + 0.15, t + 0.3), ("k", t + 0.35, t + 0.45),
                   ("k", t + 0.5, t + 0.7), ("k", t + 0.9, t + 1.0)]
    trace = Trace(device=device, spans=steps, window_s=4.0)
    assert read("train.loader_ms", trace) == pytest.approx(50.0)
    assert read("train.prepare_idle_ms", trace) == pytest.approx(100.0)
    assert read("train.forward_idle_ms", trace) == pytest.approx(100.0)
    assert read("train.norm_idle_ms", trace) == pytest.approx(50.0)
    assert read("train.backward_idle_ms", trace) == pytest.approx(100.0)
    assert read("train.update_idle_ms", trace) == pytest.approx(100.0)


@pytest.mark.parametrize("name", SCENE + TRAIN)
def test_none_without_device_records_or_spans(name):
    every = [(n, 0.0, 1.0) for n in ("msid.scene.upload", "msid.scene.download",
                                     "msid.scene.cut", "msid.scene.replay",
                                     "msid.scene.blend", "msid.train.prepare",
                                     "msid.train.forward", "msid.norm.train",
                                     "msid.train.backward", "msid.train.update",
                                     "msid.data.batch")]
    device = [("k", 0.5, 1.5)]
    assert read(name, Trace(device, every, 2.0, {"scenes": 1})) is not None
    assert read(name, Trace([], every, 2.0, {"scenes": 1})) is None
    assert read(name, Trace(device, [("aten::mm", 0.0, 1.0)], 2.0, {"scenes": 1})) is None


def test_train_readers_need_a_step():
    trace = Trace([("k", 0.5, 1.5)], [("msid.train.forward", 0.0, 1.0)], 2.0)
    assert read("train.forward_idle_ms", trace) is None


def test_a_port_span_reaches_the_trace_on_the_cpu():
    import torch

    from msid_tpu_torch.utils.profiling import annotate
    from portbench.trace import profiled

    def work():
        with annotate("msid.scene.upload"):
            return torch.ones(16, 16).sum()

    result, trace = profiled(torch, work, cuda=False)
    assert float(result) == 256.0 and trace.device == []
    (_, w0, w1), = [s for s in trace.spans if s[0] == "portbench.window"]
    (_, start, end), = [s for s in trace.spans if s[0] == "msid.scene.upload"]
    assert w0 == 0.0 <= start <= end <= w1
