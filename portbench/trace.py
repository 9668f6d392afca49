"""The traced run's record, reduced for the per-layer metric readers.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activity) and returns a ``Trace``: every device record (kernels, copies,
sets) as ``(name, start_s, end_s)``, the benchmark's own host spans
(``torch.profiler.record_function`` names starting ``portbench.``), the
wall time of the traced window, and whatever the cell's driver adds under
``extra``. Times are seconds from the profiler's start.

The device's busy time is the union of its records, not their sum: a copy
and a kernel that overlap count once, so the idle share never reads below
zero.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."
TOP = 10


@dataclass
class Trace:
    device: list            # (name, start_s, end_s), sorted by start
    spans: list             # (name, start_s, end_s) of the host
    window_s: float
    extra: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def kernels(self, part: str) -> list:
        return [(name, e - s) for name, s, e in self.device if part in name]


def union_seconds(intervals) -> float:
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total, reach = total + end - start, end
        elif end > reach:
            total, reach = total + end - reach, end
    return total


def idle_gaps(trace: Trace) -> list:
    """The device's idle gaps inside the window, longest first, each named
    by the innermost benchmark span and the innermost host operation that
    cover its middle: ``[(name, seconds), ...]``."""
    gaps, reach = [], 0.0
    for _, start, end in trace.device:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if trace.window_s > reach:
        gaps.append((reach, trace.window_s))
    named = []
    for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (start + end) / 2
        covering = [(s, n) for n, s, e in trace.spans if s <= mid <= e]
        ours = [c for c in covering if c[1].startswith(SPAN_PREFIX)]
        other = [c for c in covering if not c[1].startswith(SPAN_PREFIX)]
        name = "/".join(max(group)[1] for group in (ours, other) if group) or "no host span"
        named.append([name[:160], end - start])
    return named


def device_ops(trace: Trace) -> list:
    sums: dict = {}
    for name, start, end in trace.device:
        sums[name] = sums.get(name, 0.0) + end - start
    return [[n[:160], s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def profiled(torch, fn, cuda: bool = True) -> tuple:
    """``(fn's result, Trace)``: ``fn`` run once under the profiler, the
    device synchronised before the window closes (``cuda`` False: a CPU
    rehearsal, which records no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            t0 = time.perf_counter()
            result = fn()
            sync()
            window_s = time.perf_counter() - t0
    events = prof.events()
    origin = None
    for e in events:
        if e.name == SPAN_PREFIX + "window" and e.device_type == DeviceType.CPU:
            origin = e.time_range.start
            break
    if origin is None:
        raise RuntimeError("the profiler recorded no window span")
    device, spans = [], []
    for e in events:
        rec = (e.name, (e.time_range.start - origin) / 1e6, (e.time_range.end - origin) / 1e6)
        (device if e.device_type == DeviceType.CUDA else spans).append(rec)
    # The profiler mirrors each host span onto the device's timeline (a
    # user annotation over the whole span); only the device's own records
    # are kept.
    device = sorted((r for r in device if not r[0].startswith(SPAN_PREFIX)
                     and r[2] > 0 and r[1] < window_s), key=lambda r: r[1])
    return result, Trace(device=device, spans=spans, window_s=window_s)
