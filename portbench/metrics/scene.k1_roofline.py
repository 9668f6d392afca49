"""scene.k1_roofline: the fused residual block kernel K1 (``resblock_kernel``
of ``csrc/resblock.cu``) against its roofline: the sum over its launches of
each launch's least time (``roofline.block_bound`` at the launch's width,
side and batch; the width is the build's padded width in the kernel's
name, each configuration having one decoder stage per build) over K1's
summed device time, in %. Moves ``restore_mpix_per_s``."""

import re

from portbench.roofline import block_bound, decoder_stages

NAME = re.compile(r"resblock_kernel<(\d+),")


def read(trace):
    if "config" not in trace.extra:
        return None
    stages = {}
    for c, side in decoder_stages(trace.extra["config"]):
        stages[c] = side
    least = spent = 0.0
    for name, seconds in trace.kernels("resblock_kernel<"):
        width = int(NAME.search(name).group(1))
        if width not in stages:
            return None
        least += block_bound(width, stages[width], trace.extra["batch"])[0]
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None
