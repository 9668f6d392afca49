"""serve.replay_ms: the median device time of one replay of the session's
captured B=1 graph, from CUDA events that the benchmark places around each
replay of the traced requests. Moves ``serve_p95_ms``."""

import statistics


def read(trace):
    times = trace.extra.get("replay_ms")
    return statistics.median(times) if times else None
