"""scene.mfu: the restorer's forward FLOPs (from shapes, ``roofline.
forward_flops``) for every tile of the window batches the traced scenes ran,
over the traced window's wall time, as a share of the card's dense bf16
peak. Moves ``restore_mpix_per_s``."""

from portbench.roofline import PEAK_BF16_FLOPS, forward_flops


def read(trace):
    if "tiles" not in trace.extra or not trace.device:
        return None
    flops = forward_flops(trace.extra["config"]) * trace.extra["tiles"]
    return 100.0 * flops / trace.window_s / PEAK_BF16_FLOPS
