"""scene.transfer_idle_share: the share of the traced window, in %, in
which the device is idle while the host is in ``msid.scene.upload`` or
``msid.scene.download``. Moves ``restore_mpix_per_s``."""

from portbench.spans import idle_under

TRANSFERS = ("msid.scene.upload", "msid.scene.download")


def read(trace):
    seconds = idle_under(trace, TRANSFERS)
    return None if seconds is None else 100.0 * seconds / trace.window_s
