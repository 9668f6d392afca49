"""The port's scene restoration (``msid_tpu_torch/deployment/sliding_window.py``)
against the JAX package's, on the CPU, with the JAX model's weights
(randomized, then converted) in both packages.

Tolerances, fixed before the runs:
- window origins and blend weights: equal (``np.array_equal``);
- a port restore against the JAX one: the model parity tolerance of
  ``test_torch_model.py``, ``atol 1e-4`` of the output's scale (fp32 both
  sides, sums in another order);
- device against host assembly: 1e-4 (the reference's own bound: the same
  windows, weights and order, different accumulation arithmetic);
- streaming against the whole-scene device path: 1e-5 relative (the
  reference's: only the grouping of the sums differs);
- a uint16 upload against the same values as float32: equal (the cast is
  exact);
- a scene in any axis order of memory against its pixel-major copy: equal
  (the device lays out the same values);
- float16 output against float32: 4e-3 (fp16's 2^-11 over model range ~[-2, 2]).
"""

import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msid_tpu.deployment import sliding_window as jsw
from msid_tpu.models import SatMAERestoration as JaxModel, init_model
from msid_tpu_torch.deployment import sliding_window as sw
from msid_tpu_torch.models.from_jax import load_jax_variables
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.preprocess import preprocess_tiles
from test_torch_model import randomize_variables

torch.set_num_threads(2)

SMALL = dict(image_size=64, patch_size=16, embed_dim=64, depth=1, num_heads=2,
             decoder_channels=(16, 8, 8, 8), norm="group")
KW = dict(window=64, overlap=16, model_size=64, batch_size=3, device="cpu")
PARITY = 1e-4           # of the output's scale, as test_torch_model.py
DEVICE_VS_HOST = 1e-4
STREAM_RTOL = 1e-5
FP16_ATOL = 4e-3


def both(seed=0, **kwargs):
    """``(jax_model, jax_variables, port_model)`` with the same randomized
    weights."""
    jmodel = JaxModel(**kwargs, gradient_checkpointing=False)
    variables = randomize_variables(init_model(jmodel, jax.random.PRNGKey(seed)), seed)
    model = SatMAERestoration(**kwargs).eval()
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def small():
    return both(**SMALL)


def scene(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint16:
        return rng.integers(0, 10000, shape, dtype=np.uint16)
    return rng.uniform(0, 10000, shape).astype(dtype)


def assert_parity(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY * scale)


@pytest.mark.parametrize("size,window,stride", [
    (200, 64, 48), (50, 64, 48), (64, 64, 48), (1111, 64, 48), (1000, 64, 64), (113, 32, 24)])
def test_window_origins_equal_jax_and_cover(size, window, stride):
    starts = sw._window_origins(size, window, stride)
    assert starts == jsw._window_origins(size, window, stride)
    covered = np.zeros(max(size, window), bool)
    for s in starts:
        covered[s:s + window] = True
    assert covered[:size].all() and starts[-1] == max(0, size - window)


@pytest.mark.parametrize("window,overlap", [(64, 16), (32, 8), (64, 0), (48, 47)])
def test_blend_weights_equal_jax(window, overlap):
    w = sw._blend_weights(window, overlap)
    assert np.array_equal(w, jsw._blend_weights(window, overlap))
    assert w.shape == (window, window) and (w > 0).all()
    if 0 < 2 * overlap < window:
        assert w[window // 2, window // 2] == pytest.approx(1.0) and w[0, window // 2] < 0.2


@pytest.mark.parametrize("rows", [2, 3, 16])
def test_band_plan_equals_jax(rows):
    ys = sw._window_origins(1000, 64, 48)
    assert sw._band_plan(ys, 64, 48, rows) == jsw._band_plan(ys, 64, 48, rows)


def test_host_restore_matches_jax_and_an_inline_assembly(small):
    jmodel, variables, model = small
    s = scene((112, 160, 13), 3)
    got = sw.restore_scene(model, None, s, **KW)
    assert got.shape == s.shape and got.dtype == np.float32 and np.isfinite(got).all()
    want = jsw.restore_scene(jmodel, variables, s, window=64, overlap=16, model_size=64,
                             batch_size=3)
    assert_parity(got, want)
    # one window at a time through the port's step, no batching or padding
    step = sw.make_scene_step(model, None, window=64, model_size=64, device="cpu")
    wts = sw._blend_weights(64, 16)[:, :, None]
    num, den = np.zeros_like(got), np.zeros((112, 160, 1), np.float32)
    for y in sw._window_origins(112, 64, 48):
        for x in sw._window_origins(160, 64, 48):
            pred = sw.device_get(*step(s[None, y:y + 64, x:x + 64]))[0]
            num[y:y + 64, x:x + 64] += pred * wts
            den[y:y + 64, x:x + 64] += wts
    np.testing.assert_allclose(got, num / den, atol=1e-4)


def test_a_scene_of_one_window_is_the_direct_forward(small):
    jmodel, variables, model = small
    s = scene((64, 64, 13), 0)
    got = sw.restore_scene(model, None, s, window=64, overlap=16, model_size=64,
                           batch_size=2, device="cpu")
    with torch.no_grad():
        direct = model(preprocess_tiles(torch.from_numpy(s)[None], 64))[0].numpy()
    np.testing.assert_allclose(got, direct, atol=1e-4)
    want = np.asarray(jmodel.apply(variables, preprocess_tiles_jax(s), train=False))[0]
    assert_parity(got, want)


def preprocess_tiles_jax(s):
    from msid_tpu.ops.preprocess import preprocess_tiles as jax_preprocess

    return jax_preprocess(jnp.asarray(s)[None], 64)


def test_mismatched_steps_are_refused(small):
    _, _, model = small
    s = np.zeros((96, 96, 13), np.float32)
    host_step = sw.make_scene_step(model, None, window=64, model_size=64, device="cpu")
    dev_step = sw.make_device_scene_step(model, None, window=64, model_size=64, overlap=16,
                                         device="cpu")
    assert (host_step.assembly, dev_step.assembly) == ("host", "device")
    with pytest.raises(ValueError, match="host assembly"):
        sw.restore_scene(model, None, s, step=host_step, device_assembly=True, **KW)
    with pytest.raises(ValueError, match="device assembly"):
        sw.restore_scene(model, None, s, step=dev_step, device_assembly=False, **KW)
    with pytest.raises(ValueError, match="assembly"):
        sw.restore_scene_streaming(model, None, s, step=host_step, **KW)
    with pytest.raises(ValueError, match="overlap"):
        sw.restore_scene(model, None, s, window=64, overlap=64, device="cpu")


def test_device_assembly_matches_host_and_jax(small):
    jmodel, variables, model = small
    s = scene((112, 160, 13), 5)
    host = sw.restore_scene(model, None, s, **KW)
    seen = []
    dev = sw.restore_scene(model, None, s, device_assembly=True,
                           progress=lambda i, n: seen.append((i, n)), **KW)
    assert dev.shape == s.shape and np.isfinite(dev).all()
    np.testing.assert_allclose(dev, host, rtol=DEVICE_VS_HOST, atol=DEVICE_VS_HOST)
    assert seen == [(0, 6), (3, 6)]                           # 2 x 3 windows in 2 batches
    want = jsw.restore_scene(jmodel, variables, s, window=64, overlap=16, model_size=64,
                             batch_size=3, device_assembly=True)
    assert_parity(dev, want)


def test_a_uint16_upload_equals_float32(small):
    _, _, model = small
    s = scene((96, 112, 13), 7, np.uint16)
    step = sw.make_device_scene_step(model, None, window=64, model_size=64, overlap=16,
                                     device="cpu")
    as_f32 = sw.restore_scene(model, None, s.astype(np.float32), device_assembly=True,
                              step=step, **KW)
    as_u16 = sw.restore_scene(model, None, s, device_assembly=True, step=step, **KW)
    np.testing.assert_array_equal(as_u16, as_f32)


# Memory layouts by axis, slowest first: "CHW" is band-sequential (BSQ),
# "HCW" band-interleaved by line (BIL), "HWC" pixel-major.
LAYOUTS = ["".join(p) for p in itertools.permutations("HWC")]


@pytest.fixture(scope="module")
def device_step(small):
    return sw.make_device_scene_step(small[2], None, window=64, model_size=64, overlap=16,
                                     device="cpu")


def laid_out(s, layout):
    """The ``[H, W, C]`` view of ``s``'s values in memory laid out as ``layout``."""
    order = ["HWC".index(a) for a in layout]
    return np.ascontiguousarray(s.transpose(order)).transpose(np.argsort(order))


@pytest.mark.parametrize("layout,dtype,shape", [
    *[(layout, dtype, (96, 112, 13)) for layout in LAYOUTS for dtype in (np.uint16, np.float32)],
    ("CHW", np.uint16, (40, 50, 13)),           # smaller than a window: edge-padded
    ("stepped", np.uint16, (96, 112, 13)),      # no axis order makes it contiguous
])
def test_a_scene_in_any_memory_order_restores_as_its_contiguous_copy(small, device_step,
                                                                     layout, dtype, shape):
    if layout == "stepped":
        view = scene((shape[0], 2 * shape[1], shape[2]), 19, dtype)[:, ::2]
    else:
        s = scene(shape, 19, dtype)
        view = laid_out(s, layout)
        np.testing.assert_array_equal(view, s)
    assert view.flags.c_contiguous == (layout == "HWC")
    kw = dict(KW, step=device_step, device_assembly=True)
    got = sw.restore_scene(None, None, view, **kw)
    want = sw.restore_scene(None, None, np.ascontiguousarray(view), **kw)
    assert got.shape == view.shape
    np.testing.assert_array_equal(got, want)


def test_streaming_matches_the_device_path_and_jax(small):
    jmodel, variables, model = small
    # 200 rows, window 64, stride 48: origins [0, 48, 96, 136], so 2 origin
    # rows a band make two bands, a carried seam and the flush-bottom origin
    s = scene((200, 112, 13), 11)
    whole = sw.restore_scene(model, None, s, device_assembly=True, **KW)
    seen = []
    streamed = sw.restore_scene_streaming(
        model, None, s, band_origin_rows=2, output_dtype=np.float32,
        progress=lambda done, total: seen.append((done, total)), **KW)
    assert streamed.shape == s.shape and streamed.dtype == np.float32
    np.testing.assert_allclose(streamed, whole, rtol=STREAM_RTOL, atol=STREAM_RTOL)
    assert seen[-1] == (8, 8)                                 # 4 x 2 windows
    one_band = sw.restore_scene_streaming(model, None, s, band_origin_rows=64,
                                          output_dtype=np.float32, **KW)
    np.testing.assert_allclose(one_band, whole, rtol=STREAM_RTOL, atol=STREAM_RTOL)
    want = jsw.restore_scene_streaming(jmodel, variables, s, window=64, overlap=16,
                                       model_size=64, batch_size=3, band_origin_rows=2,
                                       output_dtype=np.float32)
    assert_parity(streamed, want)


def test_streaming_uint16_in_float16_out_and_a_reused_step(small):
    _, _, model = small
    s = scene((160, 96, 13), 13, np.uint16)
    ref = sw.restore_scene(model, None, s, device_assembly=True, **KW)
    step = sw.make_device_scene_step(model, None, window=64, model_size=64, overlap=16,
                                     device="cpu")
    for _ in range(2):
        out = sw.restore_scene_streaming(model, None, s, band_origin_rows=2, step=step, **KW)
        assert out.dtype == np.float16
        np.testing.assert_allclose(out, ref, atol=FP16_ATOL)


def test_streaming_an_undersized_scene(small):
    _, _, model = small
    s = scene((40, 50, 13), 17)
    ref = sw.restore_scene(model, None, s, device_assembly=True, **KW)
    host = sw.restore_scene(model, None, s, **KW)
    out = sw.restore_scene_streaming(model, None, s, output_dtype=np.float32, **KW)
    assert out.shape == ref.shape == host.shape == s.shape
    np.testing.assert_allclose(out, ref, rtol=STREAM_RTOL, atol=STREAM_RTOL)
    np.testing.assert_allclose(host, ref, rtol=DEVICE_VS_HOST, atol=DEVICE_VS_HOST)


@pytest.mark.parametrize("device_assembly", [False, True])
def test_float16_output_rounds_float32(small, device_assembly):
    _, _, model = small
    s = scene((96, 96, 13), 9)
    full = sw.restore_scene(model, None, s, device_assembly=device_assembly, **KW)
    half = sw.restore_scene(model, None, s, device_assembly=device_assembly,
                            output_dtype=np.float16, **KW)
    assert half.dtype == np.float16
    np.testing.assert_allclose(half, full, atol=FP16_ATOL)


def run_guarded(fn):
    box = {}

    def target():
        try:
            fn()
            box["result"] = "returned"
        except Exception as e:
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "restore_scene_streaming deadlocked"
    return box


def test_a_failing_step_raises_promptly():
    """The step fails on the second band, while the uploader is parked on
    its bounded queue."""
    calls = {"n": 0}

    def boom_step(band, out_sum, w_sum, chunk, valid):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("synthetic step failure")
        return out_sum, w_sum

    boom_step.assembly = "device"
    box = run_guarded(lambda: sw.restore_scene_streaming(
        None, None, scene((200, 96, 13), 19), window=64, overlap=16, model_size=64,
        batch_size=64, band_origin_rows=1, step=boom_step, device="cpu"))
    assert "synthetic step failure" in str(box["error"])


def test_a_failing_download_raises_after_the_drain(monkeypatch):
    def ok_step(band, out_sum, w_sum, chunk, valid):
        return out_sum, w_sum

    def failing_get(*_a, **_k):
        raise RuntimeError("synthetic download failure")

    ok_step.assembly = "device"
    monkeypatch.setattr(sw, "device_get", failing_get)
    box = run_guarded(lambda: sw.restore_scene_streaming(
        None, None, scene((200, 96, 13), 19), window=64, overlap=16, model_size=64,
        batch_size=64, band_origin_rows=1, step=ok_step, device="cpu"))
    assert "synthetic download failure" in str(box["error"])


def test_a_failing_upload_raises(monkeypatch):
    def ok_step(band, out_sum, w_sum, chunk, valid):
        return out_sum, w_sum

    ok_step.assembly = "device"
    real_pad = np.pad

    def failing_pad(*a, **k):                    # the last band is padded on the uploader
        if "uploader" in threading.current_thread().name:
            raise RuntimeError("synthetic upload failure")
        return real_pad(*a, **k)

    monkeypatch.setattr(sw.np, "pad", failing_pad)
    box = run_guarded(lambda: sw.restore_scene_streaming(
        None, None, scene((200, 96, 13), 19), window=64, overlap=16, model_size=64,
        batch_size=64, band_origin_rows=1, step=ok_step, device="cpu"))
    assert "synthetic upload failure" in str(box["error"])


FILL = dict(image_size=64, patch_size=16, embed_dim=96, depth=2, num_heads=4,
            decoder_channels=(48, 24, 12, 8), input_fill=True, residual_output=True)


def test_a_fill_model_takes_its_module_forward_under_auto():
    """The JAX package's round-5 regression: "auto" on a model with the
    input fill stage serves the module's forward; True raises."""
    jmodel, variables, model = both(**FILL)
    s = scene((96, 96, 13), 0, np.uint16)
    kw = dict(KW, batch_size=4)
    out = sw.restore_scene(model, None, s, device_assembly=True, **kw)
    assert out.shape == (96, 96, 13) and np.isfinite(out).all()
    want = jsw.restore_scene(jmodel, variables, s, window=64, overlap=16, model_size=64,
                             batch_size=4, device_assembly=True)
    assert_parity(out, want)
    with pytest.raises(ValueError, match="input_fill"):
        sw.make_device_scene_step(model, None, window=64, model_size=64, overlap=16,
                                  optimize=True, device="cpu")


def test_a_batchnorm_model_takes_the_hybrid_graph_under_auto():
    bn = dict(image_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=2,
              decoder_channels=(16, 8, 8, 8))
    jmodel, variables, model = both(**bn)
    batch = np.random.default_rng(1).uniform(0, 10000, (2, 64, 64, 13)).astype(np.float32)
    plain = sw.make_scene_step(model, None, window=64, model_size=32, optimize=False,
                               device="cpu")
    hybrid = sw.make_scene_step(model, None, window=64, model_size=32, device="cpu")
    got = sw.device_get(*hybrid(batch))
    np.testing.assert_allclose(got, sw.device_get(*plain(batch)), rtol=2e-4, atol=2e-5)
    want = np.asarray(jsw.make_scene_step(jmodel, variables, window=64, model_size=32)(
        jnp.asarray(batch)))
    assert_parity(got, want)
    with pytest.raises(ValueError, match="optimize"):
        sw.make_scene_step(model, None, window=64, model_size=32, optimize="fast",
                           device="cpu")


def test_model_size_other_than_the_window_matches_jax():
    """Windows of 64 upsampled to a 32-pixel model's input are downsampled
    from 64 to 32 first and come back by the bilinear resize 32 -> 64."""
    tiny = dict(image_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=4,
                decoder_channels=(16, 8, 8, 8), norm="group")
    jmodel, variables, model = both(**tiny)
    s = scene((80, 100, 13), 21)
    got = sw.restore_scene(model, None, s, window=64, overlap=16, model_size=32,
                           batch_size=2, device="cpu")
    want = jsw.restore_scene(jmodel, variables, s, window=64, overlap=16, model_size=32,
                             batch_size=2)
    assert_parity(got, want)


def test_tta_on_the_host_path_equals_the_device_path_and_jax():
    tiny = dict(image_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=4,
                decoder_channels=(16, 8, 8, 8), norm="group")
    jmodel, variables, model = both(**tiny)
    s = scene((48, 40, 13), 13)
    kw = dict(window=32, overlap=8, model_size=32, batch_size=2, device="cpu")
    host = sw.restore_scene(model, None, s, tta=2, **kw)
    dev = sw.restore_scene(model, None, s, tta=2, device_assembly=True, **kw)
    np.testing.assert_allclose(host, dev, atol=DEVICE_VS_HOST)
    assert not np.allclose(host, sw.restore_scene(model, None, s, **kw), atol=1e-4)
    want = jsw.restore_scene(jmodel, variables, s, window=32, overlap=8, model_size=32,
                             batch_size=2, tta=2)
    assert_parity(host, want)


def test_a_step_serves_the_weights_it_was_given(small):
    """The step keeps its own copy of the model: the variables it was built
    with, whatever happens to the caller's model afterwards."""
    _, _, model = small
    s = scene((64, 96, 13), 23)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    other = {k: v + 0.01 if v.is_floating_point() else v for k, v in state.items()}
    step = sw.make_device_scene_step(model, other, window=64, model_size=64, overlap=16,
                                     device="cpu")
    before = sw.restore_scene(model, None, s, device_assembly=True, step=step, **KW)
    assert step.model is not model
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    copy_of = SatMAERestoration(**SMALL).eval()
    copy_of.load_state_dict(other)
    np.testing.assert_array_equal(
        before, sw.restore_scene(copy_of, None, s, device_assembly=True, **KW))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    try:
        after = sw.restore_scene(model, None, s, device_assembly=True, step=step, **KW)
    finally:
        model.load_state_dict(state)
    np.testing.assert_array_equal(before, after)
    assert step.compiled is None and step.captured_launches is None and step.replays == 0


def test_scenes_on_cuda_raise_without_a_card(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: scenes run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sw.make_scene_step(small[2], None, window=64, model_size=64)
