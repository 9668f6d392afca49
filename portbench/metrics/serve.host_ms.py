"""serve.host_ms: the median of ``predict``'s wall time on the host clock
(upload, launch, download, the session's own Python) less the median
replay (``serve.replay_ms``), over the traced requests. Moves
``serve_p95_ms``."""

import statistics


def read(trace):
    replays, walls = trace.extra.get("replay_ms"), trace.extra.get("predict_ms")
    if not replays or not walls:
        return None
    return statistics.median(walls) - statistics.median(replays)
