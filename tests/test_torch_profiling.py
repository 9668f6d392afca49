"""The port's ``utils/profiling.py`` on the CPU: every case of
``tests/test_profiling.py`` on the port, and the port's results against
the JAX functions' (keys, rolling-window arithmetic)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from msid_tpu.utils import profiling as jax_profiling
from msid_tpu_torch.utils import profiling
from msid_tpu_torch.utils.profiling import (
    _complete,
    _first_tensor,
    annotate,
    benchmark_fn,
    live_memory,
    step_timer,
    trace,
)
from msid_tpu_torch.utils.setup_helpers import device_memory_stats

KEYS = ("mean_ms", "std_ms", "min_ms", "max_ms", "p50_ms", "p99_ms", "fps", "images_per_sec")


def test_benchmark_fn_stats_contract():
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        return x + 1.0

    x = torch.ones((4,))
    stats = benchmark_fn(fn, x, warmup_runs=3, benchmark_iterations=10)
    assert calls["n"] == 13  # warmup + timed
    for key in KEYS:
        assert key in stats and np.isfinite(stats[key])
    assert stats["min_ms"] <= stats["p50_ms"] <= stats["max_ms"]
    # fps is derived from the mean; images_per_call defaults to 1
    assert stats["fps"] == pytest.approx(1000.0 / stats["mean_ms"])
    assert stats["images_per_sec"] == pytest.approx(stats["fps"])

    batched = benchmark_fn(fn, x, warmup_runs=1, benchmark_iterations=5, images_per_call=32)
    assert batched["images_per_sec"] == pytest.approx(32 * batched["fps"])
    import jax.numpy as jnp

    theirs = jax_profiling.benchmark_fn(lambda a: a + 1.0, jnp.ones((4,)), warmup_runs=1,
                                        benchmark_iterations=2)
    assert list(stats) == list(theirs) == list(KEYS)


def test_benchmark_fn_measures_real_time():
    def slow(x):
        time.sleep(0.01)
        return x

    stats = benchmark_fn(slow, torch.zeros(()), warmup_runs=0, benchmark_iterations=3)
    assert stats["mean_ms"] >= 10.0


def test_benchmark_fn_completes_the_first_tensor_of_any_output(monkeypatch):
    """The counterpart of the reference's value fetch: the device of the
    output's first tensor is synchronized before the clock stops."""
    a, b = torch.zeros(2), torch.ones(3)
    assert _first_tensor({"y": (None, [a, b])}) is a
    assert _first_tensor((1, "x")) is None
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))

    class OnCard:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(profiling, "_first_tensor", lambda x: x)
    _complete(OnCard())
    _complete(a)                    # a CPU result is complete when returned
    assert synced == [torch.device("cuda", 1)]


def test_step_timer_math(monkeypatch):
    t = step_timer(window=4)
    assert t.tick(8) == {"steps_per_sec": 0.0, "images_per_sec": 0.0}
    # Deterministic clock: tick() itself must compute 3 steps / 24 images
    # over dt=1.5 s from the fabricated window.
    t._stamps = [(0.0, 0), (0.5, 8), (1.0, 8)]
    monkeypatch.setattr("msid_tpu_torch.utils.profiling.time.perf_counter", lambda: 1.5)
    stats = t.tick(8)
    assert t._stamps == [(0.0, 0), (0.5, 8), (1.0, 8), (1.5, 8)]
    assert stats["steps_per_sec"] == pytest.approx(3 / 1.5)
    assert stats["images_per_sec"] == pytest.approx(24 / 1.5)
    # Window trims the oldest stamp once full (window=4).
    monkeypatch.setattr("msid_tpu_torch.utils.profiling.time.perf_counter", lambda: 2.0)
    stats = t.tick(4)
    assert t._stamps == [(0.5, 8), (1.0, 8), (1.5, 8), (2.0, 4)]
    assert stats["steps_per_sec"] == pytest.approx(3 / 1.5)
    assert stats["images_per_sec"] == pytest.approx(20 / 1.5)


def test_step_timer_is_the_references_on_one_clock(monkeypatch):
    """Both timers tick at the same instants (two at t=0: a zero span)."""
    now = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    ours, theirs = step_timer(window=3), jax_profiling.step_timer(window=3)
    for t, images in zip((0.0, 0.0, 0.2, 0.5, 0.9, 1.4), (4, 8, 8, 2, 6, 0)):
        now["t"] = t
        assert ours.tick(images) == theirs.tick(images)


def test_live_memory_contract():
    stats = live_memory()
    assert isinstance(stats, dict)
    # the contract is a dict keyed per device with numeric values when present
    for _, v in stats.items():
        assert isinstance(v, dict)
        for _, n in v.items():
            assert isinstance(n, (int, float))
    assert stats == device_memory_stats() == {}       # no card here


def test_trace_and_annotate_smoke(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as where:
        with annotate("unit-test-region"):
            torch.sum(torch.ones((8, 8)))
    assert where == logdir
    # the profiler must have written something under the logdir
    found = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert found, "profiler trace produced no files"
    events = json.loads(open(found[0]).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit-test-region" in names and "aten::sum" in names
