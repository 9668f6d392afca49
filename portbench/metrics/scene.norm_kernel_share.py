"""scene.norm_kernel_share: the share of Restormer's bias-free LayerNorms
that ran the port's kernel N2 (``csrc/layernorm.cu``), as 100 x its
launches in the traced device record (found by the fragment ``NAME`` of
its kernel's name) over the norms of the traced forwards: two a block of
every level (``roofline_restormer._levels``) for each window batch
(``tiles // batch``). 100 when every norm takes the kernel; 0 on a program
whose norms all run PyTorch's composition; null on another architecture.
Moves ``restore_mpix_per_s``."""

from portbench.roofline_restormer import _levels

NAME = "bias_free_norm_rows"


def read(trace):
    extra = trace.extra
    if not trace.device or "tiles" not in extra or "model_size" not in extra or \
            extra["config"]["model"].get("architecture") != "restormer":
        return None
    blocks = sum(n for _, _, n, _ in _levels(extra["config"], extra["model_size"]))
    norms = 2 * blocks * (extra["tiles"] // extra["batch"])
    if not norms:
        return None
    return 100.0 * len(trace.kernels(NAME)) / norms
