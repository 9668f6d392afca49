"""Profiling and tracing (PyTorch): counterpart of ``msid_tpu/utils/profiling.py``.

  * ``trace(logdir)``: a context manager around ``torch.profiler.profile``
    (host ops, and the card's kernels when a card is there) that writes a
    Chrome trace (``trace_*.json``, readable in Perfetto or TensorBoard)
    under ``logdir`` and yields ``logdir``;
  * ``annotate(name)``: a named span of the program's host work, recorded
    only while a profiler records (see its docstring for the spans the
    program marks and how to see them);
  * ``benchmark_fn``: warmup and a timed loop, each call completed before
    the clock stops (the device of the output's first tensor is
    synchronized: the counterpart of the reference's value fetch);
  * ``live_memory``: per-device memory in use, peak and limit.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str | Path = "outputs/trace", with_stack: bool = False) -> Iterator:
    """Profile the block: host ops, and CUDA kernels when a card is present.
    The card is synchronized before the profiler stops, so work queued in
    the block is in the trace. ``with_stack`` also records the Python
    calls (``nn.Module`` forwards among them), which names the module that
    launched each kernel, at the cost of a slower host."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities, with_stack=with_stack)
    prof.start()
    try:
        yield logdir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class _NoSpan:
    """What ``annotate`` gives while nothing records: a shared context
    manager that does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NO_SPAN = _NoSpan()


def annotate(name: str):
    """A span named ``name`` over the host work of a ``with`` block.

    While no profiler records, this is one read of the profiler's flag and
    a shared no-op context manager. Under ``torch.profiler.profile`` (or
    ``trace`` above) or ``torch.autograd.profiler.emit_nvtx`` it is a
    ``torch._C._profiler._RecordFunctionFast``: a host operation
    (``cpu_op``) on the profiler's clock, nested under the span or
    operation around it, and never mirrored onto the device's timeline, so
    a span does not count as device time. To see the spans:

      * ``with utils.profiling.trace(logdir): ...`` writes a Chrome trace
        that Perfetto or TensorBoard opens;
      * ``with torch.autograd.profiler.emit_nvtx(): ...`` under
        ``nsys profile`` makes each span an NVTX range.

    The program's spans, all named ``msid.*``: ``msid.scene.upload``
    (with ``msid.scene.host_layout`` inside it where a scene's view must be
    copied on the host before it goes up), ``msid.scene.cut``,
    ``msid.scene.replay``, ``msid.scene.blend`` and ``msid.scene.download``
    (``restore_scene``'s device assembly);
    ``msid.train.prepare``, ``msid.train.forward``, ``msid.train.backward``
    and ``msid.train.update`` (the train step); ``msid.norm.train`` (a
    batch ``Norm`` in train mode); ``msid.data.batch`` (a
    ``DeviceCachedLoader`` batch); ``msid.encoder.group_embed`` (the
    group-channel encoder's patch embeds and position and group embedding)
    and ``msid.encoder.fold`` (its tokens folded to the decoder's grid),
    seen in eager forwards and training: a scene step replays a captured
    graph, whose host work the spans do not see.
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _complete(x) -> None:
    """Wait until the work that made ``x`` is done: synchronize the device
    of its first tensor (a CPU result is done when it is returned)."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def benchmark_fn(
    fn: Callable,
    *args,
    warmup_runs: int = 10,
    benchmark_iterations: int = 100,
    images_per_call: int = 1,
) -> dict:
    """Latency and throughput of ``fn(*args)``: warmup, then a timed loop on
    the host clock, each call completed before the clock stops; ms
    statistics, ``fps`` and ``images_per_sec`` from the mean."""
    for _ in range(warmup_runs):
        _complete(fn(*args))

    times = []
    for _ in range(benchmark_iterations):
        t0 = time.perf_counter()
        _complete(fn(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    times = np.asarray(times)
    mean = float(times.mean())
    return {
        "mean_ms": mean,
        "std_ms": float(times.std()),
        "min_ms": float(times.min()),
        "max_ms": float(times.max()),
        "p50_ms": float(np.percentile(times, 50)),
        "p99_ms": float(np.percentile(times, 99)),
        "fps": 1000.0 / mean,
        "images_per_sec": images_per_call * 1000.0 / mean,
    }


def live_memory() -> dict:
    """Per-device memory (bytes in use, peak, limit); ``{}`` without a card."""
    from msid_tpu_torch.utils.setup_helpers import device_memory_stats

    return device_memory_stats()
