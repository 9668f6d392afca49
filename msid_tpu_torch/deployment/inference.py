"""Inference session (PyTorch): counterpart of ``msid_tpu/deployment/inference.py``.

``predict`` takes a model-space noisy NHWC float32 numpy batch and returns
the restored NHWC float32 batch, computed in the model's dtype on the
session's device (the GPU unless ``device="cpu"``). ``optimize`` picks the
inference graph (``deployment/fastpath.py``): the module's own forward
(``apply``: a bf16 model's decoder blocks run K1, an fp32 model's K4), the
hybrid graph (module encoder + folded-BN conv-transpose decoder) or the
full fastpath (fused QKV, patch embed and upsample as matmuls); the folded
graphs run library convs and launch no fused-block kernel. ``tta`` > 1
averages each prediction over that many dihedral views of the input
(``ops/tta.py``), around whichever graph was chosen, checked when the
session is built. An fp32 session computes in fp32 on the card: each
graph turns TF32 off around itself (``exact_fp32``).

A session serves the weights it was built with, as the reference's
does (its compiled executable holds the variables it was given): it
keeps its own copy of the model (``self.model``), so training or writing
the caller's model afterwards changes nothing it serves. On the card the
session is compiled ahead of time, as the reference's is by
``jax.jit(...).lower(...).compile()``: the chosen forward, with its TTA
views and its dtype, is captured once at construction into a CUDA graph
at the session's fixed batch (``CapturedForward``), and every call
replays it, so no call pays the host's launch costs again
(``self.compiled == "cuda_graph"``). The graph reads its operands by
address, so the session also holds every operand the capture read,
among them the decoder blocks' prepared operands, which a block drops
when it is put in train mode. A capture that fails raises; the session
never serves eagerly instead. A CPU session runs its forward eagerly
(``self.compiled is None``). ``benchmark`` times the replays with
CUDA events and returns the reference's result; with ``donate_input`` the
upload of a fresh host batch is inside every timed call, as in the
reference, where a donated input buffer cannot be used twice.

A session can also serve an exported artifact (``artifact_path``,
``deployment/export.py``) in place of a model: the loaded program, with its
payload bound, is the forward, captured on the card as a live session's
is (inside ``exact_fp32`` for an fp32 artifact); its decoder blocks are
``msid::fused_residual_block`` nodes, which launch K1 or K4. Such a session
has no ``model`` and refuses ``tta`` > 1 (an artifact bakes its own views).

Mesh serving (``InferenceSession(model, mesh=...)``, with a serving mesh
of ``parallel.make_mesh(devices=...)``, builds a ``MeshSession``): the
counterpart of the reference's data-parallel session, whose batch is
sharded over the mesh's data axis. It holds one ``InferenceSession`` per
device of ``mesh.devices``, of ``batch_size / data`` rows on that device,
each with its own copy of the model and, on a card, its own captured
graph; a call splits the batch in order, runs each replica on its rows
(the replays on several cards overlap) and gathers the outputs on
``devices[0]``. ``batch_size`` must divide by the data axis; an artifact
cannot be served over a mesh (it is one device's program).
"""

from __future__ import annotations

import copy
import functools
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from msid_tpu_torch.models.blocks import ResidualBlock
from msid_tpu_torch.models.restoration import resolve_device
from msid_tpu_torch.ops import _build
from msid_tpu_torch.ops.tta import wrap_forward

# The batch-size switch points of optimize="auto" are the JAX package's
# (msid_tpu/deployment/inference.py), kept as behaviour, not as a claim
# about this card: the H100 times of the three graphs at B=1, 16 and 128
# are in PERF.md.
# Largest batch at which "auto" picks the full fastpath (0: never).
FASTPATH_AUTO_MAX_BATCH = 0
# Smallest batch at which "auto" picks the hybrid graph; below it "auto"
# serves the module's own forward (self.optimized = False).
HYBRID_AUTO_MIN_BATCH = 8
# Eager forwards before a capture, on a side stream: they make what the
# forward allocates or sets up once (cuBLAS workspaces, cuDNN plans, the
# blocks' prepared operands, each kernel's tensor maps and shared-memory
# limit), so that the capture only records launches.
CAPTURE_WARMUP = 2


class CapturedForward:
    """``forward`` captured once into a CUDA graph at the shape, dtype and
    device of ``example``: the port's counterpart of an ahead-of-time
    compiled executable. Calling it copies x (any device) into the static
    input, replays the graph and returns the static output, which the next
    call overwrites. ``launches`` is the count of hand-written kernel
    launches the capture recorded (``_build.launches``), which every
    replay runs on the device (the wrappers' counts move at the capture,
    not at a replay); ``replays`` counts the replays. A capture that fails
    raises ``RuntimeError`` with the reason."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 example: torch.Tensor, warmup: int = CAPTURE_WARMUP):
        device = example.device
        self.input = example.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                forward(self.input)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = _build.launches
        try:
            with torch.cuda.graph(self.graph):
                self.output = forward(self.input)
        except Exception as err:
            raise RuntimeError(f"capturing the forward as a CUDA graph failed: "
                               f"{type(err).__name__}: {err}") from err
        self.launches = _build.launches - before
        self.replays = 0

    def __call__(self, x: torch.Tensor | None = None) -> torch.Tensor:
        if x is not None:
            self.input.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.output


class InferenceSession:
    """Restoration inference at a fixed batch size on one device; with
    ``mesh``, a ``MeshSession`` over the mesh's devices."""

    def __new__(cls, model: torch.nn.Module | None = None, *args, mesh=None, **kwargs):
        if mesh is not None:
            return MeshSession(model, *args, mesh=mesh, **kwargs)
        return super().__new__(cls)

    def __init__(self, model: torch.nn.Module | None = None, batch_size: int = 1,
                 image_size: int = 192, num_bands: int = 13,
                 device: str | torch.device = "cuda", tta: int = 1,
                 optimize: bool | str = "auto", donate_input: bool = False,
                 artifact_path: str | Path | None = None, mesh=None):
        """``optimize`` selects the inference graph. ``"auto"`` (default)
        picks by batch size and serves the module's own forward for models
        the folded graphs do not support: below ``HYBRID_AUTO_MIN_BATCH``
        the module's forward, from there up the hybrid graph (the full
        fastpath only up to ``FASTPATH_AUTO_MAX_BATCH``, i.e. never).
        ``True`` forces the full fastpath and raises ``ValueError`` for
        unsupported models; ``False`` always uses the module's forward.
        ``self.optimized`` records the choice: ``"fastpath"``, ``"hybrid"``
        or ``False``. ``donate_input`` is the reference's: the caller gives
        up each input, so ``benchmark`` uploads a fresh host batch in every
        timed call. ``self.model`` is the session's own copy of ``model``,
        which is left as it is. On the card the forward is captured here
        (see the module's docstring); ``self.compiled`` names the compiled form
        (``"cuda_graph"``, or None on the CPU) and
        ``self.captured_launches`` counts the hand-written kernel launches
        of one captured forward. With ``artifact_path`` (and no model) the
        session serves that exported artifact, loaded for its device.
        ``mesh`` makes the call build a ``MeshSession`` instead (see the
        module's docstring)."""
        self.tta = int(tta)
        self.donate_input = bool(donate_input)
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.input_shape = (batch_size, image_size, image_size, num_bands)
        self.optimized: bool | str = False
        self.model: torch.nn.Module | None = None
        if artifact_path is not None:
            if self.tta > 1:
                raise ValueError("tta ensembling needs model+variables, "
                                 "not a serialized artifact")
            from msid_tpu_torch.deployment.export import load_exported, read_meta

            self.dtype = getattr(torch, read_meta(artifact_path).get("dtype", "float32"))
            infer = load_exported(artifact_path, self.device)
        elif model is None:
            raise ValueError("Provide model or artifact_path")
        else:
            self.model = copy.deepcopy(model).to(self.device).eval()
            self.dtype = getattr(model, "dtype", torch.float32)
            infer = self._model_graph(optimize)
        self._infer = wrap_forward(infer, self.tta, image_size, image_size)
        self.compiled: str | None = None
        self.captured_launches: int | None = None
        self._graph: CapturedForward | None = None
        self._captured_operands: list[tuple] = []
        self._lock = threading.Lock()            # one replay at a time
        if self.device.type == "cuda":
            self._graph = CapturedForward(
                self.forward_eager, torch.zeros(self.input_shape, device=self.device))
            self.compiled = "cuda_graph"
            self.captured_launches = self._graph.launches
            # What the warmup prepared and the capture read by address.
            self._captured_operands = [
                m.kept_operands for m in (self.model.modules() if self.model is not None else ())
                if isinstance(m, ResidualBlock) and m.kept_operands is not None]

    @property
    def replays(self) -> int:
        """Replays of the captured graph so far (0 on the CPU)."""
        return 0 if self._graph is None else self._graph.replays

    def _model_graph(self, optimize: bool | str) -> Callable[[torch.Tensor], torch.Tensor]:
        """The model's inference graph that ``optimize`` picks (see
        ``__init__``); sets ``self.optimized``."""
        if optimize is False:
            return self._model_forward
        if optimize is not True and optimize != "auto":
            raise ValueError(f"optimize must be 'auto', True or False, got {optimize!r}")
        from msid_tpu_torch.deployment.fastpath import (
            make_fast_inference_fn,
            make_hybrid_inference_fn,
            optimize_for_hybrid,
            optimize_for_inference,
        )

        small = self.batch_size <= FASTPATH_AUTO_MAX_BATCH
        try:
            if optimize == "auto" and not small and self.batch_size < HYBRID_AUTO_MIN_BATCH:
                return self._model_forward     # below the hybrid switch point: the raw graph
            if optimize is True or small:
                # The JAX package's choice of upsample form: matmul +
                # depth-to-space for unet_light, conv-transpose for unet_skip.
                mm = self.model.decoder_arch != "unet_skip"
                with torch.no_grad():
                    weights = optimize_for_inference(
                        self.model, dtype=self.dtype, upsample="matmul" if mm else "ct")
                self.optimized = "fastpath"
                return functools.partial(
                    make_fast_inference_fn(self.model, matmul_upsample=mm), weights)
            with torch.no_grad():
                weights = optimize_for_hybrid(self.model, dtype=self.dtype)
            self.optimized = "hybrid"
            return functools.partial(make_hybrid_inference_fn(self.model), weights)
        except ValueError:
            if optimize is True:
                raise
            return self._model_forward

    def _model_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype))

    def forward_eager(self, x: torch.Tensor) -> torch.Tensor:
        """The session's forward run eagerly on a tensor on its device: what
        the graph was captured from (for comparing the two)."""
        with torch.inference_mode():
            return self._infer(x).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The restored batch of a float32 tensor of the session's input
        shape: a replay of the graph on the card (a new tensor, never the
        graph's own buffer), the eager forward on the CPU."""
        if self._graph is None:
            return self.forward_eager(x)
        with self._lock:
            return self._graph(x).clone()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Restore a noisy NHWC float32 batch; checks rank, shape and batch."""
        xt = checked_input(x, self.input_shape)
        if self._graph is None:
            return self.forward_eager(xt.to(self.device)).cpu().numpy()
        with self._lock:
            return self._graph(xt).cpu().numpy()       # a host copy of the output

    def benchmark(self, warmup_runs: int = 10, benchmark_iterations: int = 100,
                  seed: int = 0, pipelined: bool = False) -> dict:
        """Device time of one replay of the captured forward on a
        device-resident batch, after ``warmup_runs`` calls: CUDA events
        around each call, or with ``pipelined`` around all of them, one
        trailing sync, so the calls queue back to back. With
        ``donate_input`` each call first uploads the host batch into the
        graph's input, inside the timed span. The reference's result:
        ``mean_ms``, ``fps`` and ``images_per_sec`` from the mean; a
        pipelined run is one aggregate sample, so its
        ``std/min/max/p50/p99_ms`` are None. A CPU session raises: it has
        no device time to report."""
        if self._graph is None:
            raise RuntimeError("benchmark times the GPU with CUDA events; "
                               f"this session runs on {self.device}")
        x_host = torch.from_numpy(np.random.default_rng(seed).uniform(
            -2.0, 2.0, self.input_shape).astype(np.float32))
        with self._lock:
            self._graph.input.copy_(x_host)

            def call():
                self._graph(x_host if self.donate_input else None)

            for _ in range(warmup_runs):
                call()
            times_ms = _timed_ms(call, benchmark_iterations, pipelined, self.device)
        return benchmark_summary(times_ms, self.batch_size, benchmark_iterations, pipelined,
                                 torch.cuda.get_device_name(self.device))


class MeshSession:
    """An ``InferenceSession`` over a serving mesh (see the module's
    docstring), built by ``InferenceSession(model, ..., mesh=mesh)``:
    ``replicas`` are the per-device sessions; ``predict`` and ``forward``
    split the batch over them and gather on the first replica's device.
    The replicas' attributes that describe the whole (``tta``, ``dtype``,
    ``optimized``, ``compiled``, ``model``) are the first's, and
    ``captured_launches`` and ``replays`` their sums. It has no
    ``benchmark``: time a replica (``replicas[i].benchmark()``)."""

    def __init__(self, model: torch.nn.Module | None, batch_size: int = 1,
                 image_size: int = 192, num_bands: int = 13,
                 device: str | torch.device | None = None, tta: int = 1,
                 optimize: bool | str = "auto", donate_input: bool = False,
                 artifact_path: str | Path | None = None, *, mesh):
        """``device`` is ignored: the replicas run on ``mesh.devices``."""
        if artifact_path is not None:
            raise ValueError("mesh serving needs model+variables, not a serialized artifact")
        if model is None:
            raise ValueError("Provide model or artifact_path")
        if mesh.distributed:
            raise ValueError("a session serves over a local mesh of devices "
                             "(parallel.make_mesh(devices=...)), not a process group's")
        if batch_size % mesh.data != 0:
            raise ValueError(f"batch_size {batch_size} must divide by the mesh data axis "
                             f"({mesh.data})")
        self.replicas = [InferenceSession(model, batch_size // mesh.data, image_size,
                                          num_bands, device=d, tta=tta, optimize=optimize,
                                          donate_input=donate_input)
                         for d in mesh.devices]
        first = self.replicas[0]
        self.device, self.batch_size = first.device, batch_size
        self.input_shape = (batch_size, *first.input_shape[1:])
        self.tta, self.dtype, self.model = first.tta, first.dtype, first.model
        self.optimized, self.compiled = first.optimized, first.compiled
        self.captured_launches = (None if first.captured_launches is None else
                                  sum(r.captured_launches for r in self.replicas))

    @property
    def replays(self) -> int:
        """The replicas' replays of their captured graphs so far."""
        return sum(r.replays for r in self.replicas)

    def _over_replicas(self, x: torch.Tensor, call) -> torch.Tensor:
        """``call(replica, rows)`` for each replica on its rows of ``x``, in
        order, the outputs gathered on the first replica's device."""
        outs = [call(r, rows.to(r.device))
                for r, rows in zip(self.replicas, x.chunk(len(self.replicas)))]
        return torch.cat([o.to(self.device) for o in outs])

    def forward_eager(self, x: torch.Tensor) -> torch.Tensor:
        """The replicas' eager forwards on their rows of ``x``."""
        return self._over_replicas(x, lambda r, rows: r.forward_eager(rows))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The restored batch of a float32 tensor of the session's input
        shape, each replica on its rows."""
        return self._over_replicas(x, lambda r, rows: r.forward(rows))

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Restore a noisy NHWC float32 batch; checks rank, shape and batch."""
        return self.forward(checked_input(x, self.input_shape)).cpu().numpy()


def checked_input(x: np.ndarray, input_shape: tuple) -> torch.Tensor:
    """A host tensor of the float32 batch ``x``, after checking its rank,
    shape and batch against a session's ``input_shape``."""
    x = np.asarray(x)
    if x.ndim != 4:
        raise ValueError(f"Expected 4D NHWC input, got ndim={x.ndim}")
    if x.shape[1:] != input_shape[1:]:
        raise ValueError(f"Expected shape [*,{input_shape[1:]}], got {x.shape}")
    if x.dtype != np.float32:
        x = x.astype(np.float32)
    if x.shape[0] != input_shape[0]:
        raise ValueError(f"session built for batch {input_shape[0]}, got {x.shape[0]}")
    return torch.from_numpy(np.ascontiguousarray(x))


def _timed_ms(call: Callable[[], object], iterations: int, pipelined: bool,
             device: torch.device) -> np.ndarray:
    """ms per ``call()`` by CUDA events: one pair per call, or with
    ``pipelined`` one pair around all of them (the mean per call)."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(1 if pipelined else iterations)]
    if pipelined:
        pairs[0][0].record()
        for _ in range(iterations):
            call()
        pairs[0][1].record()
    else:
        for start, end in pairs:
            start.record()
            call()
            end.record()
    torch.cuda.synchronize(device)
    times_ms = np.asarray([start.elapsed_time(end) for start, end in pairs])
    return times_ms / iterations if pipelined else times_ms


def benchmark_summary(times_ms: np.ndarray, batch_size: int, iterations: int,
                      pipelined: bool, device: str) -> dict:
    """``InferenceSession.benchmark``'s result from its per-call times (one
    aggregate time when ``pipelined``), in the reference's keys."""
    mean_ms = float(np.mean(times_ms))
    result = {
        "mean_ms": mean_ms,
        "fps": 1e3 / mean_ms,
        "images_per_sec": batch_size * 1e3 / mean_ms,
        "batch_size": batch_size,
        "iterations": iterations,
        "device": device,
    }
    if pipelined:
        result.update(std_ms=None, min_ms=None, max_ms=None, p50_ms=None, p99_ms=None)
    else:
        result.update(std_ms=float(np.std(times_ms)), min_ms=float(np.min(times_ms)),
                      max_ms=float(np.max(times_ms)),
                      p50_ms=float(np.percentile(times_ms, 50)),
                      p99_ms=float(np.percentile(times_ms, 99)))
    return result
