"""scene.transfer_ms: host milliseconds a scene inside the scene path's
transfers, the union of ``msid.scene.upload`` (the raw scene's upload and
the accumulators' allocation) and ``msid.scene.download`` (the division,
the copy into pinned memory and its wait), over the traced scenes. Moves
``restore_mpix_per_s``."""

from portbench.spans import span_seconds

TRANSFERS = ("msid.scene.upload", "msid.scene.download")


def read(trace):
    seconds = span_seconds(trace, TRANSFERS)
    if seconds is None or not trace.extra.get("scenes"):
        return None
    return 1e3 * seconds / trace.extra["scenes"]
