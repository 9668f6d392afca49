"""scene.batch_idle_share: the share of the traced window, in %, in which
the device is idle while the host works on a batch of windows: the union
of ``msid.scene.cut``, ``msid.scene.replay`` and ``msid.scene.blend``.
Moves ``restore_mpix_per_s``."""

from portbench.spans import idle_under

BATCH = ("msid.scene.cut", "msid.scene.replay", "msid.scene.blend")


def read(trace):
    seconds = idle_under(trace, BATCH)
    return None if seconds is None else 100.0 * seconds / trace.window_s
