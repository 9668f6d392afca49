"""The program's own host spans in a traced run, for the per-layer readers.

The port marks its phases with ``msid.*`` spans (``utils.profiling.
annotate``): host operations on the profiler's clock, which ``Trace.spans``
holds beside every other host operation. A reader asks either how long the
host spent inside some of them (``span_seconds``) or how long the device
sat idle while the host was inside them (``idle_under``). Idle time is the
complement of the union of the device's records in ``[0, window_s]``, with
the leading and trailing gaps that ``trace.idle_gaps`` counts. Spans of the
given names count as their union: a span nested in another, or repeated,
counts once.

Both return None when the trace has no device records or no span of those
names: a parent commit without the spans, or a rehearsal without a card.
"""

from __future__ import annotations


def merged(intervals) -> list:
    """Sorted, disjoint ``(start, end)`` intervals covering ``intervals``."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def idle_intervals(trace) -> list:
    """The device's idle intervals inside ``[0, window_s]``."""
    gaps, reach = [], 0.0
    for _, start, end in trace.device:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if trace.window_s > reach:
        gaps.append((reach, trace.window_s))
    return gaps


def _spans(trace, names) -> list:
    names = set(names)
    return merged((max(s, 0.0), min(e, trace.window_s))
                  for n, s, e in trace.spans if n in names and e > 0 and s < trace.window_s)


def overlap_seconds(a: list, b: list) -> float:
    """The measure of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_seconds(trace, names):
    """Host seconds inside the union of the spans named ``names``."""
    spans = _spans(trace, names)
    if not trace.device or not spans:
        return None
    return sum(e - s for s, e in spans)


def idle_under(trace, names):
    """Seconds in which the device is idle while the host is inside a span
    named in ``names``."""
    spans = _spans(trace, names)
    if not trace.device or not spans:
        return None
    return overlap_seconds(idle_intervals(trace), spans)


def count(trace, name: str) -> int:
    """How many spans named ``name`` the trace holds."""
    return sum(n == name for n, _, _ in trace.spans)


def per_step_ms(seconds, trace):
    """``seconds`` in ms a train step, the steps counted by their
    ``msid.train.update`` spans; None without either."""
    steps = count(trace, "msid.train.update")
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps
