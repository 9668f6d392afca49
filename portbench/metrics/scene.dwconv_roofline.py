"""scene.dwconv_roofline: Restormer's depthwise 3x3 convs (``qkv_dwconv``
and GDFN's ``dwconv``, two a block) against their roofline: the sum over
the traced forwards of each conv's least time
(``roofline_restormer.depthwise_bound`` at the window batch, its channels
and its side: its bf16 input read and output written once and its weights,
at the HBM peak) over the summed device time of the depthwise kernels, in
%. The kernels are found by name in the device trace (``NAMES``: cuDNN's
``conv2d_c1_k1_nhwc_specialized``, which the H100's cuDNN runs for every
channels-last bf16 depthwise conv of the model, one launch a conv;
PyTorch's own depthwise kernel and cuDNN's grouped direct conv, which other
layouts and dtypes take); the reading is null when none is found, or when
their launches are not a whole number a conv (a record the profiler
dropped). Moves ``restore_mpix_per_s``."""

from portbench.roofline_restormer import depthwise_bound, depthwise_convs

NAMES = ("conv2d_c1_k1_nhwc", "conv_depthwise2d", "conv2d_grouped_direct_kernel")


def read(trace):
    extra = trace.extra
    if "tiles" not in extra or "model_size" not in extra or \
            extra["config"]["model"].get("architecture") != "restormer":
        return None
    batch = extra["batch"]
    convs = depthwise_convs(extra["config"], extra["model_size"]) * (extra["tiles"] // batch)
    spent = [seconds for name, seconds in trace.kernels("")
             if any(part in name for part in NAMES)]
    if not spent or len(spent) % len(convs) or sum(spent) <= 0:
        return None
    least = sum(depthwise_bound(batch, c, side) for c, side in convs)
    return 100.0 * least / sum(spent)
