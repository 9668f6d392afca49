"""scene.idle_share: 1 - (union of every device record) / (traced window),
in %, over whole scenes. Moves ``restore_mpix_per_s``."""


def read(trace):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
