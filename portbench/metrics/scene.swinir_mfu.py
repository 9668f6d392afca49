"""scene.swinir_mfu: SwinIR's forward FLOPs at the traced run's
``model_size`` (from shapes, ``roofline_swinir.forward_flops``) for every
tile of the window batches the traced scenes ran, over the traced window's
wall time, as a share of the card's dense bf16 peak; null on another
architecture. Moves ``restore_mpix_per_s``."""

from portbench.roofline import PEAK_BF16_FLOPS
from portbench.roofline_swinir import forward_flops


def read(trace):
    extra = trace.extra
    if not trace.device or "tiles" not in extra or "model_size" not in extra or \
            extra["config"]["model"].get("architecture") != "swinir":
        return None
    flops = forward_flops(extra["config"], extra["model_size"]) * extra["tiles"]
    return 100.0 * flops / trace.window_s / PEAK_BF16_FLOPS
