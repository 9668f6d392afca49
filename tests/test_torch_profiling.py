"""The port's ``utils/profiling.py`` on the CPU: the cases of
``tests/test_profiling.py`` that the port keeps, its results against the
JAX functions' (keys), and the program's ``msid.*`` spans: what
``annotate`` costs and records, and where the scene path, the train step,
``Norm`` and the device tile cache open them."""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msid_tpu.utils import profiling as jax_profiling
from msid_tpu_torch.data.dataset import SyntheticEuroSAT
from msid_tpu_torch.data.pipeline import DeviceCachedLoader
from msid_tpu_torch.deployment import sliding_window as sw
from msid_tpu_torch.models.blocks import Norm
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.training.optim import build_optimizer_from_config
from msid_tpu_torch.training.train_state import TrainState, make_train_step
from msid_tpu_torch.utils import profiling
from msid_tpu_torch.utils.config import load_config
from msid_tpu_torch.utils.profiling import (
    _complete,
    _first_tensor,
    annotate,
    benchmark_fn,
    live_memory,
    trace,
)
from msid_tpu_torch.utils.setup_helpers import device_memory_stats

TINY = Path(__file__).resolve().parents[1] / "configs" / "experiments" / "tiny_cpu.yaml"

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


def msid_spans(prof) -> list:
    """The ``msid.*`` host spans a profile recorded, as ``(name, start_us,
    end_us)`` in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("msid.")), key=lambda r: r[1])


def tiny_model():
    config = load_config(TINY)
    torch.manual_seed(0)
    return config, SatMAERestoration.from_config(config, device="cpu")


def test_annotate_without_a_profiler_builds_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record function was built for {name}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    with annotate("msid.off"):
        y = torch.ones(4).sum()
    assert float(y) == 4.0
    assert annotate("msid.a") is annotate("msid.b")       # one shared no-op span


def test_annotate_is_a_host_op_on_the_profilers_clock(tmp_path):
    """Under the profiler a span is a ``cpu_op`` (Kineto mirrors no such
    record onto a device's timeline, as it does a ``user_annotation``),
    nested under the span around it, and in ``prof.events()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("msid.outer"):
            with annotate("msid.inner"):
                torch.ones(8, 8).sum()
    (outer, o0, o1), (inner, i0, i1) = msid_spans(prof)
    assert (outer, inner) == ("msid.outer", "msid.inner") and o0 <= i0 <= i1 <= o1
    assert [e.cpu_parent.name for e in prof.events() if e.name == "msid.inner"] == ["msid.outer"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("msid.")}
    assert cats == {"msid.outer": "cpu_op", "msid.inner": "cpu_op"}


def test_device_scene_assembly_spans_per_scene_and_batch():
    """Per scene one upload and one download; per batch a cut, a replay
    and a blend, in that order (6 windows in batches of 4: 2 batches)."""
    _, model = tiny_model()
    step = sw.make_device_scene_step(model.eval(), None, 64, 64, 16, device="cpu")
    rng = np.random.default_rng(0)
    scenes = [rng.integers(0, 10000, (100, 131, 13), dtype=np.uint16) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for s in scenes:
            out = sw.restore_scene(None, None, s, window=64, overlap=16, model_size=64,
                                   batch_size=4, step=step, device_assembly=True,
                                   device="cpu")
    assert out.shape == (100, 131, 13)
    batch = ["msid.scene.cut", "msid.scene.replay", "msid.scene.blend"]
    scene = ["msid.scene.upload"] + batch * 2 + ["msid.scene.download"]
    assert [name for name, _, _ in msid_spans(prof)] == scene * 2


def test_a_host_layout_span_only_where_no_axis_order_is_contiguous():
    """A band-major (BSQ) and a band-interleaved-by-line (BIL) scene go up
    as they lie in memory: no ``msid.scene.host_layout``. A stepped view,
    which no axis order makes contiguous, is copied on the host once, inside
    the upload."""
    _, model = tiny_model()
    step = sw.make_device_scene_step(model.eval(), None, 64, 64, 16, device="cpu")
    rng = np.random.default_rng(1)
    bsq = rng.integers(0, 10000, (13, 100, 131), dtype=np.uint16).transpose(1, 2, 0)
    bil = rng.integers(0, 10000, (100, 13, 131), dtype=np.uint16).transpose(0, 2, 1)
    stepped = rng.integers(0, 10000, (100, 262, 13), dtype=np.uint16)[:, ::2]
    for s, copies in ((bsq, 0), (bil, 0), (stepped, 1)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sw.restore_scene(None, None, s, window=64, overlap=16, model_size=64,
                             batch_size=4, step=step, device_assembly=True, device="cpu")
        spans = msid_spans(prof)
        (_, u0, u1), = [span for span in spans if span[0] == "msid.scene.upload"]
        layouts = [span for span in spans if span[0] == "msid.scene.host_layout"]
        assert len(layouts) == copies
        assert all(u0 <= l0 <= l1 <= u1 for _, l0, l1 in layouts)


def test_train_step_spans_with_norm_inside_the_forward():
    config, model = tiny_model()
    optimizer, _ = build_optimizer_from_config(config, model)
    step = make_train_step(model, image_size=64)
    state = TrainState.create(model, optimizer)
    tiles = np.random.default_rng(0).uniform(500, 4000, (4, 32, 32, 13)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, tiles, 7)
    assert metrics["skipped"] == 0 and state.step == 1
    spans = msid_spans(prof)
    phases = [s for s in spans if s[0].startswith("msid.train.")]
    assert [name for name, _, _ in phases] == [
        "msid.train.prepare", "msid.train.forward", "msid.train.backward", "msid.train.update"]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    _, f0, f1 = phases[1]
    norms = [s for s in spans if s[0] == "msid.norm.train"]
    batch_norms = sum(isinstance(m, Norm) and m.kind == "batch" for m in model.modules())
    assert len(norms) == batch_norms > 0
    assert all(f0 <= s0 <= s1 <= f1 for _, s0, s1 in norms)


@pytest.mark.parametrize("kernel_path", [False, True], ids=["fallback", "kernel"])
def test_norm_fused_span_nests_in_norm_train_only_on_the_kernel_path(monkeypatch,
                                                                      kernel_path):
    """On the kernel path (``cuda_norm.serves`` says yes, as on a card; a
    plain batch norm stands in for the kernels here) every
    ``msid.norm.train`` holds one ``msid.norm.fused``; on the composition's
    path (the CPU) there is none."""
    from msid_tpu_torch.ops import cuda_norm

    def stand_in(x, weight, bias, running_mean, running_var, momentum, eps):
        xf = x.float()
        mean, var = xf.mean(dim=(0, 2, 3)), xf.var(dim=(0, 2, 3), unbiased=False)
        scale = weight * torch.rsqrt(var + eps)
        return (xf * scale[:, None, None] + (bias - mean * scale)[:, None, None]).to(x.dtype)

    if kernel_path:
        monkeypatch.setattr(cuda_norm, "serves", lambda x: True)
        monkeypatch.setattr(cuda_norm, "batch_norm_train", stand_in)
    config, model = tiny_model()
    optimizer, _ = build_optimizer_from_config(config, model)
    step = make_train_step(model, image_size=64)
    state = TrainState.create(model, optimizer)
    tiles = np.random.default_rng(0).uniform(500, 4000, (4, 32, 32, 13)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, tiles, 7)
    assert metrics["skipped"] == 0
    spans = msid_spans(prof)
    norms = [s for s in spans if s[0] == "msid.norm.train"]
    fused = [s for s in spans if s[0] == "msid.norm.fused"]
    assert len(norms) > 0
    if not kernel_path:
        assert fused == []
        return
    assert len(fused) == len(norms)
    assert all(n0 <= f0 <= f1 <= n1 for (_, n0, n1), (_, f0, f1) in zip(norms, fused))
    assert [e.cpu_parent.name for e in prof.events() if e.name == "msid.norm.fused"] \
        == ["msid.norm.train"] * len(norms)


def test_device_cached_loader_batch_span():
    ds = SyntheticEuroSAT(num_samples=20, split="train", seed=0)
    loader = DeviceCachedLoader(ds, batch_size=8, seed=3, device="cpu")
    batches = iter(loader)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = next(batches)
    assert tuple(batch.shape[:1]) == (8,)
    assert [name for name, _, _ in msid_spans(prof)] == ["msid.data.batch"]


def test_group_embed_and_fold_spans_in_a_forward_and_a_train_step():
    """The group-channel restorer opens ``msid.encoder.group_embed`` and
    then ``msid.encoder.fold`` once a forward, eager or in a train step (in
    its forward, not in the backward's recomputation of the blocks); the
    one-embed restorer opens neither."""
    config = load_config(TINY.parent / "satmae_group_large.yaml")
    config["data"]["image_size"] = 32
    config["model"]["encoder"].update(embed_dim=32, channel_embed=8, depth=1, num_heads=2,
                                      freeze_layers=[])
    config["model"]["decoder"]["channels"] = [8, 8, 8]
    torch.manual_seed(0)
    model = SatMAERestoration.from_config(config, device="cpu")
    x = torch.randn(2, 32, 32, 13)
    spans = ["msid.encoder.group_embed", "msid.encoder.fold"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.eval()(x)
    assert [name for name, _, _ in msid_spans(prof)] == spans
    optimizer, _ = build_optimizer_from_config(config, model)
    step = make_train_step(model.train(), image_size=32)
    state = TrainState.create(model, optimizer)
    tiles = np.random.default_rng(0).uniform(500, 4000, (2, 16, 16, 13)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, tiles, 7)
    found = msid_spans(prof)
    (_, f0, f1), = [s for s in found if s[0] == "msid.train.forward"]
    ours = [s for s in found if s[0].startswith("msid.encoder.")]
    assert [name for name, _, _ in ours] == spans
    assert all(f0 <= s0 <= s1 <= f1 for _, s0, s1 in ours)
    _, plain = tiny_model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            plain.eval()(torch.randn(1, 64, 64, 13))
    assert not [s for s in msid_spans(prof) if s[0].startswith("msid.encoder.")]
