"""Profiling and tracing (PyTorch): counterpart of ``msid_tpu/utils/profiling.py``.

  * ``trace(logdir)``: a context manager around ``torch.profiler.profile``
    (host ops, and the card's kernels when a card is there) that writes a
    Chrome trace (``trace_*.json``, readable in Perfetto or TensorBoard)
    under ``logdir`` and yields ``logdir``;
  * ``annotate(name)``: a labelled region in that trace
    (``torch.profiler.record_function``), and an NVTX range when CUDA is
    there;
  * ``benchmark_fn``: warmup and a timed loop, each call completed before
    the clock stops (the device of the output's first tensor is
    synchronized: the counterpart of the reference's value fetch);
  * ``step_timer``: rolling steps/s and images/s over a window;
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a region in the profiler's timeline (and in NVTX on a card)."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


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


class step_timer:
    """Rolling steps/s and images/s over a window of ``tick`` calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._stamps: list = []

    def tick(self, images: int = 0) -> dict:
        now = time.perf_counter()
        self._stamps.append((now, images))
        if len(self._stamps) > self.window:
            self._stamps.pop(0)
        if len(self._stamps) < 2:
            return {"steps_per_sec": 0.0, "images_per_sec": 0.0}
        dt = self._stamps[-1][0] - self._stamps[0][0]
        n = len(self._stamps) - 1
        imgs = sum(i for _, i in self._stamps[1:])
        return {
            "steps_per_sec": n / dt if dt > 0 else 0.0,
            "images_per_sec": imgs / dt if dt > 0 else 0.0,
        }


def live_memory() -> dict:
    """Per-device memory (bytes in use, peak, limit); ``{}`` without a card."""
    from msid_tpu_torch.utils.setup_helpers import device_memory_stats

    return device_memory_stats()
