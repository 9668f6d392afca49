"""train.mfu: the forward and backward FLOPs a train step needs for its
tiles (from shapes, ``roofline.train_flops``: frozen blocks get no weight
gradient, checkpoint recomputation is not counted), over the traced
window's wall time, as a share of the card's dense bf16 peak. Moves
``train_tiles_per_s``."""

from portbench.roofline import PEAK_BF16_FLOPS, train_flops


def read(trace):
    if "tiles" not in trace.extra or not trace.device:
        return None
    return 100.0 * train_flops(trace.extra["config"]) * trace.extra["tiles"] \
        / trace.window_s / PEAK_BF16_FLOPS
