"""The benchmark's arithmetic: union busy time and idle share, the
breakdown, the rates and the tail, the roofline and FLOP counts against
hand counts and against torch's own counter at a tiny width."""

from __future__ import annotations

import pytest
import torch

from portbench import registry, roofline
from portbench.trace import Trace, device_ops, idle_gaps, union_seconds


def read(name, trace):
    return registry.metric_reader(name)(trace)


def test_union_counts_overlap_once():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == pytest.approx(4.0)
    assert union_seconds([(0, 4), (1, 2)]) == pytest.approx(4.0)
    assert union_seconds([]) == 0.0


def test_idle_share_from_the_union_never_below_zero():
    # a copy overlapping a kernel: the sum of records (3.5) exceeds the window
    trace = Trace(device=[("kernel", 0.0, 2.0), ("Memcpy HtoD", 0.5, 2.0), ("k2", 2.5, 3.0)],
                  spans=[], window_s=3.0)
    assert trace.busy_s == pytest.approx(2.5)
    for name in ("scene.idle_share", "train.idle_share"):
        assert read(name, trace) == pytest.approx(100 * (1 - 2.5 / 3.0))
    assert read("scene.idle_share", Trace([], [], 1.0)) is None


def test_breakdown_names_gaps_by_the_host_span():
    trace = Trace(device=[("a", 0.0, 1.0), ("b", 1.5, 2.0), ("a", 3.0, 3.5)],
                  spans=[("portbench.window", 0.0, 4.0), ("portbench.scene", 1.0, 3.5),
                         ("aten::copy_", 2.1, 2.9)], window_s=4.0)
    gaps = idle_gaps(trace)
    assert [g[1] for g in gaps] == pytest.approx([1.0, 0.5, 0.5])
    assert gaps[0][0] == "portbench.scene/aten::copy_"
    assert device_ops(trace)[0] == ["a", pytest.approx(1.5)]


def test_block_bound_hand_count():
    seconds, flops, nbytes = roofline.block_bound(8, 4, 2)
    assert flops == 2 * 2 * 9 * 64 * 16 * 2
    assert nbytes == (2 * 2 * 16 * 8 + 2 * 9 * 64) * 2 + 4 * 8 * 4
    assert seconds == max(flops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_HBM_BYTES)


@pytest.mark.parametrize("cell", ["flagship.scene.b64", "capacity2x.scene.b64"])
def test_forward_flops_match_torch_counter(tiny, cell):
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.model import Restorer

    config = tiny(cell)["config"]["config"]
    model = Restorer(config).eval()
    x = torch.randn(1, 64, 64, 13) * 0.5
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    counted = counter.get_total_flops()
    fill = 2 * 64 * 64 * 13 * 13 if model.fill else 0          # the fill's prediction
    assert roofline.forward_flops(config) + fill == pytest.approx(counted, rel=1e-3)


def test_train_flops_hand_count(tiny):
    config = tiny("flagship.train.b64")["config"]["config"]
    ops = roofline.forward_ops(config)
    kinds = {k for _, k in ops}
    assert kinds == {"input", "weight", "frozen", "pair"}
    expect = sum(f * {"input": 2, "weight": 3, "frozen": 2, "pair": 3}[k] for f, k in ops)
    assert roofline.train_flops(config) == pytest.approx(expect)
    assert 2 * roofline.forward_flops(config) < roofline.train_flops(config) \
        < 3 * roofline.forward_flops(config)


def test_published_widths_flops():
    cell = registry.cell(registry.load_benchmark(registry.HERE.parent), "flagship.scene.b64")
    assert roofline.forward_flops(cell["config"]["config"]) == pytest.approx(54.8e9, rel=0.01)


def test_k1_roofline_reader_per_launch_width(tiny):
    config = tiny("flagship.scene.b64")["config"]["config"]
    stages = dict(roofline.decoder_stages(config))
    names = [f"void (anonymous namespace)::resblock_kernel<{c}, 2, 2, false, 0>(...)"
             for c in stages]
    device = [(n, float(i), float(i) + 1e-3) for i, n in enumerate(names)]
    device.append(("ampere_bf16_gemm", 9.0, 9.5))
    trace = Trace(device=device, spans=[], window_s=10.0, extra={"config": config, "batch": 8})
    least = sum(roofline.block_bound(c, s, 8)[0] for c, s in stages.items())
    assert read("scene.k1_roofline", trace) == pytest.approx(100 * least / (len(names) * 1e-3))
    assert read("scene.k1_roofline", Trace(device[-1:], [], 1.0,
                                           {"config": config, "batch": 8})) is None


def test_mfu_readers(tiny):
    config = tiny("flagship.scene.b64")["config"]["config"]
    trace = Trace(device=[("k", 0.0, 1.0)], spans=[], window_s=2.0,
                  extra={"config": config, "tiles": 100})
    assert read("scene.mfu", trace) == pytest.approx(
        100 * roofline.forward_flops(config) * 100 / 2.0 / roofline.PEAK_BF16_FLOPS)
    assert read("train.mfu", trace) == pytest.approx(
        100 * roofline.train_flops(config) * 100 / 2.0 / roofline.PEAK_BF16_FLOPS)


def test_serve_readers():
    trace = Trace([], [], 1.0, extra={"replay_ms": [2.0, 2.2, 9.0], "predict_ms": [3.0, 3.5, 4.0]})
    assert read("serve.replay_ms", trace) == pytest.approx(2.2)
    assert read("serve.host_ms", trace) == pytest.approx(3.5 - 2.2)
    assert read("serve.replay_ms", Trace([], [], 1.0)) is None
    assert read("train.data_wait_ms", Trace([], [], 1.0, extra={"data_wait_ms": 0.25})) == 0.25
