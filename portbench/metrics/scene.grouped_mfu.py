"""scene.grouped_mfu: the group-channel restorer's forward FLOPs (from
shapes, ``roofline_grouped.forward_flops``) for every tile of the window
batches the traced scenes ran, over the traced window's wall time, as a
share of the card's dense bf16 peak. Moves ``restore_mpix_per_s``."""

from portbench.roofline import PEAK_BF16_FLOPS
from portbench.roofline_grouped import forward_flops


def read(trace):
    config = trace.extra.get("config")
    if "tiles" not in trace.extra or not trace.device or \
            "channel_groups" not in config["model"]["encoder"]:
        return None
    flops = forward_flops(config) * trace.extra["tiles"]
    return 100.0 * flops / trace.window_s / PEAK_BF16_FLOPS
