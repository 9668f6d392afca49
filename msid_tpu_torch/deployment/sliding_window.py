"""Sliding-window restoration of whole scenes (PyTorch): counterpart of
``msid_tpu/deployment/sliding_window.py``.

A scene (a Sentinel-2 tile is 10980x10980x13 uint16) is restored as
overlapping windows. Each native-resolution window goes through the
training tiles' preprocessing (its own range scale, the bilinear upsample
to the model's size, the model range), the restorer, and the bilinear
resize back to the window; the windows are blended with a separable
raised-cosine weight, so that no seam shows, and divided by the summed
weight.

Three assemblies, with the same window origins, blend weights and forward:

* ``restore_scene`` (host): windows are cut and stacked on the host, one
  batch is restored on the device while the previous one is blended into
  numpy accumulators; each result comes back by an asynchronous copy into
  pinned memory that an event orders.
* ``restore_scene(device_assembly=True)``: the scene is uploaded once in
  its own dtype (uint16 DN stay uint16: the cast to float32 inside the
  preprocessing is exact) and in the axis order its bytes lie in host
  memory (a band-major view goes up as it lies and is laid out pixel-major
  by one device copy), windows are cut on the device by slices at
  host-side origins, and each batch is blended into device accumulators
  by a loop of slice adds in window order (overlapping windows of one
  batch must not race, as a scatter-add would); the restored scene comes
  back once.
* ``restore_scene_streaming``: the device assembly over row bands. An
  uploader thread copies each band's rows from pinned memory on a side
  stream and records an event that the compute stream waits for; the main
  thread restores the band, carries its last ``window`` rows of sums into
  the next band on the device and finalizes the rows it owns; a
  downloader thread copies finished bands to the host on another stream.
  A failure in either thread is raised after both are joined.

On the card a step captures its raw per-batch function (preprocess,
forward, float32, resize) into a CUDA graph (``CapturedForward``) at the
first batch's shape and dtype, and every batch replays it: the port's
counterpart of the reference's ``jax.jit``. A capture that fails raises.
The step keeps its own copy of the model (with the given weights) and the
operands its graph reads. Whether a forward is the folded hybrid graph
(``deployment/fastpath.py``) or the module's own follows ``optimize``:
``"auto"`` takes the hybrid graph where the model supports it, so a model
with an ``input_fill`` stage, such as the flagship, runs its module forward
and with it the fused ResidualBlock kernels (K1 in bf16, K4 in float32).
"""

from __future__ import annotations

import copy
import functools
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from msid_tpu_torch.deployment.inference import CapturedForward
from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops.preprocess import preprocess_tiles, resize_bilinear
from msid_tpu_torch.ops.tta import wrap_forward
from msid_tpu_torch.utils.profiling import annotate


def _blend_weights(window: int, overlap: int) -> np.ndarray:
    """[window, window] separable blend weight: 1 inside, a raised-cosine
    ramp over the overlap margin; strictly positive, so the summed weight
    never divides by zero."""
    w = np.ones(window, np.float32)
    ramp_len = max(1, overlap)
    ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(ramp_len) + 0.5) / ramp_len)
    w[:ramp_len] = ramp
    w[-ramp_len:] = ramp[::-1]
    return np.outer(w, w).astype(np.float32)


def _window_origins(size: int, window: int, stride: int) -> list:
    """Start offsets covering [0, size), the last window flush right."""
    if size <= window:
        return [0]
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return starts


def _make_scene_forward(model, variables: Optional[dict], window: int, model_size: int,
                        optimize: bool | str, tta: int, device: torch.device):
    """``(model, raw_step)``: a copy of ``model`` on ``device`` holding
    ``variables`` (a ``{name: tensor}`` state dict; None keeps the model's
    own), and ``raw_step(batch)``, which takes raw windows ``[B, window,
    window, C]`` of any real dtype to restored float32 windows of the same
    shape, in model range. The forward is the hybrid graph when ``optimize``
    is True or ``"auto"`` and the model supports it (True raises
    ``ValueError`` when it does not), else the module's, in the model's
    dtype; ``tta`` > 1 averages it over that many dihedral views."""
    model = copy.deepcopy(model)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(device).eval()
    dtype = model.dtype
    forward = None
    if optimize is True or optimize == "auto":
        from msid_tpu_torch.deployment.fastpath import (
            make_hybrid_inference_fn,
            optimize_for_hybrid,
        )

        try:
            with torch.no_grad():
                weights = optimize_for_hybrid(model, dtype=dtype)
            forward = functools.partial(make_hybrid_inference_fn(model), weights)
        except ValueError:
            if optimize is True:
                raise
    elif optimize is not False:
        raise ValueError(f"optimize must be 'auto', True or False, got {optimize!r}")
    if forward is None:
        def forward(x: torch.Tensor) -> torch.Tensor:
            return model(x.to(dtype))
    forward = wrap_forward(forward, tta, model_size, model_size)

    def raw_step(batch: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = forward(preprocess_tiles(batch, model_size)).float()
            return resize_bilinear(out, window)

    return model, raw_step


class SceneStep:
    """The per-batch step of a scene restore on one device; ``assembly``
    names the restore it serves (``"host"`` or ``"device"``), and a
    restore given the other kind raises ``ValueError``.

    ``run(batch)`` restores a batch of raw windows. On the card it copies
    the batch (on the device, or in pinned host memory for an asynchronous
    upload) into the static input of the CUDA graph captured for its shape
    and dtype (the first such batch captures it), replays the graph and
    returns its output, which the next replay overwrites. ``compiled`` is
    ``"cuda_graph"`` there and None on the CPU; ``captured_launches`` is the
    count of hand-written kernel launches each replay runs, ``replays`` the
    replays so far.
    """

    def __init__(self, model, variables: Optional[dict], window: int, model_size: int,
                 optimize: bool | str, tta: int, device: str | torch.device, assembly: str,
                 overlap: Optional[int] = None):
        self.device = resolve_device(device)
        self.window = window
        self.assembly = assembly
        self.model, self._raw = _make_scene_forward(
            model, variables, window, model_size, optimize, tta, self.device)
        self.compiled = "cuda_graph" if self.device.type == "cuda" else None
        self._graphs: dict[tuple, CapturedForward] = {}
        self._captured_operands: list[tuple] = []
        self.weights = None if overlap is None else torch.from_numpy(
            _blend_weights(window, overlap))[:, :, None].to(self.device)

    @property
    def captured_launches(self) -> Optional[int]:
        return max((g.launches for g in self._graphs.values()), default=None)

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs.values())

    def run(self, batch: torch.Tensor) -> torch.Tensor:
        if self.compiled is None:
            return self._raw(batch)
        key = (tuple(batch.shape), batch.dtype)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = CapturedForward(self._raw, batch.to(self.device))
            # What the warmup prepared and the capture read by address.
            self._captured_operands = [
                m.kept_operands for m in self.model.modules()
                if isinstance(m, ResidualBlock) and m.kept_operands is not None]
        else:
            graph.input.copy_(batch, non_blocking=True)
        return graph()


class HostSceneStep(SceneStep):
    """``step(batch)`` for host assembly: a numpy batch of raw windows in,
    ``(result, ready)`` out, to be read by :func:`device_get`. On the card
    the batch goes up through pinned memory and the result comes back by
    an asynchronous copy into pinned memory, queued before the next
    batch's replay, with ``ready`` the event recorded after it; on the CPU
    ``result`` is the restored batch and ``ready`` None. The batch goes
    from pinned memory straight into the graph's static input."""

    def __call__(self, batch: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self.compiled is None:
            return self.run(x), None
        out = self.run(x.pin_memory())
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready


class DeviceSceneStep(SceneStep):
    """``step(scene, out_sum, w_sum, origins, valid)`` for device assembly:
    cut the windows at ``origins`` (``[B, 2]`` host ints, relative to the
    device-resident ``scene``), restore them, and add each window with
    ``valid`` set, weighted, into the device accumulators ``out_sum``
    ``[H, W, C]`` and ``w_sum`` ``[H, W, 1]`` (float32), in place and in
    window order; padded slots (``valid`` 0) add nothing. Returns
    ``(out_sum, w_sum)``."""

    def __call__(self, scene: torch.Tensor, out_sum: torch.Tensor, w_sum: torch.Tensor,
                 origins: np.ndarray, valid: np.ndarray):
        win = self.window
        with annotate("msid.scene.cut"):
            batch = torch.stack([scene[y:y + win, x:x + win] for y, x in origins.tolist()])
        with annotate("msid.scene.replay"):
            tiles = self.run(batch)
        with annotate("msid.scene.blend"):
            for tile, (y, x), v in zip(tiles, origins.tolist(), valid.tolist()):
                if v:
                    out_sum[y:y + win, x:x + win].addcmul_(tile, self.weights)
                    w_sum[y:y + win, x:x + win].add_(self.weights)
        return out_sum, w_sum


def make_scene_step(model, variables: Optional[dict], window: int, model_size: int,
                    optimize: bool | str = "auto", tta: int = 1,
                    device: str | torch.device = "cuda") -> HostSceneStep:
    """The per-batch step of :func:`restore_scene`'s host assembly: raw
    windows -> preprocess -> restore -> back to the window's resolution, in
    model range (see :class:`HostSceneStep`). ``variables`` None serves the
    model's own weights; ``optimize`` and ``tta`` as in
    :func:`_make_scene_forward`. Reusable across scenes."""
    return HostSceneStep(model, variables, window, model_size, optimize, tta, device, "host")


def make_device_scene_step(model, variables: Optional[dict], window: int, model_size: int,
                           overlap: int, optimize: bool | str = "auto", tta: int = 1,
                           device: str | torch.device = "cuda") -> DeviceSceneStep:
    """The per-batch step of the device assembly (whole scene or streamed
    bands): gather, restore and blend-accumulate on the device (see
    :class:`DeviceSceneStep`). Reusable across scenes."""
    return DeviceSceneStep(model, variables, window, model_size, optimize, tta, device,
                           "device", overlap=overlap)


def device_get(x: torch.Tensor, ready: Optional[torch.cuda.Event] = None) -> np.ndarray:
    """The host copy of a restored batch or band, as numpy: the one place a
    result leaves the device. ``ready`` is an event recorded once ``x`` was
    written. A CUDA ``x`` is copied into pinned memory on a side stream that
    waits for ``ready`` (or for the current stream), so the copy overlaps the
    work queued behind it; a host ``x``, whose copy is already under way, is
    waited for."""
    if x.device.type != "cuda":
        if ready is not None:
            ready.synchronize()
        return x.numpy()
    stream = torch.cuda.Stream(x.device)
    if ready is None:
        stream.wait_stream(torch.cuda.current_stream(x.device))
    else:
        stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
    stream.synchronize()
    return host.numpy()


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _pad_chunk(chunk: np.ndarray, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(origins, valid)`` of one batch: ``chunk`` padded to ``batch_size``
    with origin (0, 0) and valid 0."""
    valid = np.ones(len(chunk), np.float32)
    pad = batch_size - len(chunk)
    if pad > 0:
        chunk = np.concatenate([chunk, np.zeros((pad, 2), chunk.dtype)], axis=0)
        valid = np.concatenate([valid, np.zeros(pad, np.float32)])
    return chunk, valid


def _edge_pad(scene: np.ndarray, window: int) -> np.ndarray:
    """A scene smaller than one window, edge-padded up to it (cropped after)."""
    h0, w0 = scene.shape[:2]
    if h0 >= window and w0 >= window:
        return scene
    return np.pad(scene, ((0, max(0, window - h0)), (0, max(0, window - w0)), (0, 0)),
                  mode="edge")


def _upload(scene: np.ndarray, device: torch.device) -> torch.Tensor:
    """``scene`` on ``device``, contiguous with its axes as given. Its bytes
    go up in the order they lie in host memory (the axis order that sorts
    the strides from largest to smallest) and one device copy lays them
    out. Only a view that no axis order makes contiguous (a stepped slice,
    negative or zero strides, a foreign byte order) is copied on the host
    first, in ``msid.scene.host_layout``."""
    order = sorted(range(scene.ndim), key=lambda a: -scene.strides[a])
    flat = scene.transpose(order)
    if not (flat.flags.c_contiguous and flat.dtype.isnative):
        with annotate("msid.scene.host_layout"):
            flat = np.ascontiguousarray(scene, scene.dtype.newbyteorder("="))
        order = list(range(scene.ndim))
    return torch.from_numpy(flat).to(device).permute(np.argsort(order).tolist()).contiguous()


def _band_plan(ys: list, window: int, stride: int, band_origin_rows: int):
    """``(groups, band_height)``: the row origins in groups of
    ``band_origin_rows`` consecutive ones, each ``(y_start, [origins...])``,
    and the static band height ``band_origin_rows * stride + window``, which
    covers any group's span and the carried seam."""
    g = max(1, band_origin_rows)
    groups = [(ys[i], ys[i:i + g]) for i in range(0, len(ys), g)]
    return groups, g * stride + window


def _carry_into(next_out: torch.Tensor, next_w: torch.Tensor, prev_out: torch.Tensor,
                prev_w: torch.Tensor, carry_rows: int, offset: int):
    """Add the previous band's sums of rows ``[offset, offset + carry_rows)``
    into the first ``carry_rows`` rows of the next band's, in place, on the
    device."""
    next_out[:carry_rows] += prev_out[offset:offset + carry_rows]
    next_w[:carry_rows] += prev_w[offset:offset + carry_rows]
    return next_out, next_w


def _finalize_band(out_sum: torch.Tensor, w_sum: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The band's restored rows in ``dtype``; the guard keeps the padded
    rows below the scene (weight 0, cropped on the host) finite."""
    return (out_sum / torch.clamp(w_sum, min=1e-12)).to(dtype)


def restore_scene_streaming(
    model,
    variables: Optional[dict],
    scene: np.ndarray,
    window: int = 64,
    overlap: int = 16,
    model_size: int = 192,
    batch_size: int = 64,
    band_origin_rows: int = 16,
    step: Optional[Callable] = None,
    output_dtype=np.float16,
    tta: int = 1,
    progress: Optional[Callable] = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """:func:`restore_scene`'s device assembly over row bands, with the
    upload, the compute and the download overlapped (see the module's
    docstring). The window origins and blend weights are the whole scene's;
    only the grouping of the sums differs, so the result matches the
    whole-scene device path to float rounding, not bit for bit. Only
    ``band_origin_rows * stride + window`` rows of the scene and of the two
    accumulators are on the device at a time (a band and the next one in
    flight). Returns ``[H, W, C]`` in model range as ``output_dtype``
    (float16 by default: half the download). ``progress(done, total)`` is
    called with the windows restored so far."""
    if not 0 <= overlap < window:
        raise ValueError(f"overlap ({overlap}) must be in [0, window={window})")
    if step is None:
        step = make_device_scene_step(model, variables, window, model_size, overlap,
                                      tta=tta, device=device)
    elif getattr(step, "assembly", None) not in (None, "device"):
        raise ValueError("streaming restore needs a make_device_scene_step step, "
                         f"got assembly={step.assembly!r}")
    device = resolve_device(getattr(step, "device", device))
    cuda = device.type == "cuda"
    scene = np.asarray(scene)
    h0, w0 = scene.shape[:2]
    scene = _edge_pad(scene, window)
    h, w, c = scene.shape
    stride = window - overlap
    ys = _window_origins(h, window, stride)
    xs = _window_origins(w, window, stride)
    groups, band_h = _band_plan(ys, window, stride, band_origin_rows)

    # The uploader keeps at most one band in flight beyond the one being
    # restored; its trailing None also tells the main loop that it failed.
    upload_q: queue.Queue = queue.Queue(maxsize=2)
    errors: list = []
    stop_upload = threading.Event()
    upload_stream = torch.cuda.Stream(device) if cuda else None

    def uploader():
        try:
            for y_start, _ in groups:
                if stop_upload.is_set():
                    return
                rows = scene[y_start:y_start + band_h]
                if rows.shape[0] < band_h:          # the last band: zero rows below
                    rows = np.pad(rows, ((0, band_h - rows.shape[0]), (0, 0), (0, 0)))
                host = torch.from_numpy(np.ascontiguousarray(rows))
                ready = None
                if cuda:
                    with torch.cuda.stream(upload_stream):
                        host = host.pin_memory().to(device, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record(upload_stream)
                upload_q.put((host, ready))
        except Exception as e:
            errors.append(e)
        finally:
            upload_q.put(None)

    # After a failure the downloader goes on draining (and dropping) what
    # it is given, so the main loop's bounded put never blocks.
    out_host = np.zeros((h, w, c), dtype=output_dtype)
    download_q: queue.Queue = queue.Queue(maxsize=2)

    def downloader():
        while True:
            item = download_q.get()
            if item is None:
                return
            if errors:
                continue
            try:
                band, ready, y_start, n_rows = item
                out_host[y_start:y_start + n_rows] = device_get(band, ready)[:n_rows]
            except Exception as e:
                errors.append(e)

    up_t = threading.Thread(target=uploader, daemon=True)
    down_t = threading.Thread(target=downloader, daemon=True)
    up_t.start()
    down_t.start()

    out_sum = torch.zeros((band_h, w, c), dtype=torch.float32, device=device)
    w_sum = torch.zeros((band_h, w, 1), dtype=torch.float32, device=device)
    out_dtype = _torch_dtype(output_dtype)
    done, total = 0, len(ys) * len(xs)
    try:
        for k, (y_start, sub_ys) in enumerate(groups):
            item = upload_q.get()
            if item is None:                      # the uploader failed
                break
            band, ready = item
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                band.record_stream(compute)
            origins = np.asarray([(y - y_start, x) for y in sub_ys for x in xs], np.int64)
            for i in range(0, len(origins), batch_size):
                chunk, valid = _pad_chunk(origins[i:i + batch_size], batch_size)
                out_sum, w_sum = step(band, out_sum, w_sum, chunk, valid)
                done += int(valid.sum())
                if progress:
                    progress(done, total)
            if k + 1 < len(groups):
                n_final = groups[k + 1][0] - y_start      # rows only this band reaches
                next_out, next_w = _carry_into(torch.zeros_like(out_sum),
                                               torch.zeros_like(w_sum), out_sum, w_sum,
                                               window, n_final)
            else:
                n_final = min(band_h, h - y_start)
            final = _finalize_band(out_sum, w_sum, out_dtype)
            finished = None
            if cuda:
                finished = torch.cuda.Event()
                finished.record()
            download_q.put((final, finished, y_start, n_final))
            if k + 1 < len(groups):
                out_sum, w_sum = next_out, next_w
    finally:
        # Unblock the downloader, then the uploader, which may be parked on
        # its bounded put: stop it and drain its queue up to its sentinel.
        download_q.put(None)
        down_t.join()
        stop_upload.set()
        while up_t.is_alive():
            try:
                if upload_q.get(timeout=0.2) is None:
                    break
            except queue.Empty:
                continue
        up_t.join()
    if errors:
        raise errors[0]
    return out_host[:h0, :w0]


def restore_scene(
    model,
    variables: Optional[dict],
    scene: np.ndarray,
    window: int = 64,
    overlap: int = 16,
    model_size: int = 192,
    batch_size: int = 64,
    progress: Optional[Callable] = None,
    step: Optional[Callable] = None,
    device_assembly: bool = False,
    output_dtype=np.float32,
    tta: int = 1,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Restore a whole ``[H, W, C]`` scene of any real dtype; returns
    ``[H, W, C]`` in model range as ``output_dtype`` (``ops.preprocess.
    from_model_range`` gives reflectance).

    ``window`` is the native-resolution window (the training tile, 64),
    ``overlap`` the pixels neighbours share, ``model_size`` the model's
    input size, ``batch_size`` the windows restored at a time (the last
    batch is padded). ``step`` reuses a :func:`make_scene_step` (host
    assembly) or :func:`make_device_scene_step` (``device_assembly``)
    across scenes; a step of the other kind raises ``ValueError``. ``tta``
    > 1 averages each window over that many dihedral views (ignored with a
    given ``step``). ``variables`` None serves the model's own weights.
    Neither path guards the division by the summed weight: every pixel of
    the scene has a positive one. A scene smaller than a window is
    edge-padded to one and cropped after.

    The scene may lie in host memory in any axis order: a band-major
    ``(C, H, W)`` array viewed as ``[H, W, C]``, as raster readers return
    one, is as good as a pixel-major one. The device assembly uploads it as
    it lies and lays it out on the device; only a view that no axis order
    makes contiguous (a stepped slice, say) is copied on the host first.
    """
    if not 0 <= overlap < window:
        raise ValueError(f"overlap ({overlap}) must be in [0, window={window})")
    tag = getattr(step, "assembly", None)
    if tag is not None and tag != ("device" if device_assembly else "host"):
        raise ValueError(
            f"step was built for {tag} assembly but device_assembly={device_assembly} "
            "— build it with " + ("make_device_scene_step" if device_assembly
                                  else "make_scene_step"))
    scene = np.asarray(scene)
    h0, w0, c = scene.shape
    h, w = max(h0, window), max(w0, window)       # after _edge_pad
    stride = window - overlap
    ys = _window_origins(h, window, stride)
    xs = _window_origins(w, window, stride)
    origins = [(y, x) for y in ys for x in xs]

    if device_assembly:
        if step is None:
            step = make_device_scene_step(model, variables, window, model_size, overlap,
                                          tta=tta, device=device)
        device = resolve_device(getattr(step, "device", device))
        with annotate("msid.scene.upload"):
            dev_scene = _upload(_edge_pad(scene, window), device)
            out_sum = torch.zeros((h, w, c), dtype=torch.float32, device=device)
            w_sum = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
        all_origins = np.asarray(origins, np.int64)
        for i in range(0, len(origins), batch_size):
            chunk, valid = _pad_chunk(all_origins[i:i + batch_size], batch_size)
            out_sum, w_sum = step(dev_scene, out_sum, w_sum, chunk, valid)
            if progress:
                progress(i, len(origins))
        with annotate("msid.scene.download"):
            out = out_sum.div_(w_sum).to(_torch_dtype(output_dtype))
            return device_get(out)[:h0, :w0]

    if step is None:
        step = make_scene_step(model, variables, window, model_size, tta=tta, device=device)
    scene = _edge_pad(scene, window)
    weights = _blend_weights(window, overlap)
    out_sum = np.zeros((h, w, c), np.float32)
    w_sum = np.zeros((h, w, 1), np.float32)
    pending = []            # (step result, origins): one batch in flight
    for i in range(0, len(origins), batch_size):
        chunk = origins[i:i + batch_size]
        batch = np.stack([scene[y:y + window, x:x + window] for y, x in chunk]
                         ).astype(np.float32)
        if len(chunk) < batch_size:         # the static batch: repeat the first window
            pad = np.repeat(batch[:1], batch_size - len(chunk), axis=0)
            batch = np.concatenate([batch, pad], axis=0)
        pending.append((step(batch), chunk))
        if len(pending) > 1:
            _drain(pending.pop(0), out_sum, w_sum, weights, window)
            if progress:
                progress(i, len(origins))
    while pending:
        _drain(pending.pop(0), out_sum, w_sum, weights, window)
    return (out_sum / w_sum)[:h0, :w0].astype(output_dtype, copy=False)


def _drain(entry, out_sum: np.ndarray, w_sum: np.ndarray, weights: np.ndarray,
           window: int) -> None:
    (result, ready), chunk = entry
    tiles = device_get(result, ready)[:len(chunk)]
    wt = weights[:, :, None]
    for tile, (y, x) in zip(tiles, chunk):
        out_sum[y:y + window, x:x + window] += tile * wt
        w_sum[y:y + window, x:x + window] += wt
