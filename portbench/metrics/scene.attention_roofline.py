"""scene.attention_roofline: the encoder's fused attention kernel against its
roofline: the sum over its launches of each launch's least time
(``roofline_grouped.attention_bound`` at the window batch, the heads, the
encoder's ``tokens`` a tile and the head width) over the kernel's summed
device time, in %. The kernel is found by its name in the device trace
(PyTorch's flash, memory-efficient or cuDNN attention). Moves
``restore_mpix_per_s``."""

from portbench.roofline_grouped import attention_bound

NAMES = ("flash_fwd", "fmha_cutlass", "sdpa")


def read(trace):
    if "tokens" not in trace.extra or "batch" not in trace.extra:
        return None
    enc = trace.extra["config"]["model"]["encoder"]
    heads = int(enc["num_heads"])
    least = attention_bound(trace.extra["batch"], heads, trace.extra["tokens"],
                            int(enc["embed_dim"]) // heads)
    spent = [seconds for name, seconds in trace.kernels("")
             if any(part in name for part in NAMES)]
    return 100.0 * least * len(spent) / sum(spent) if spent and sum(spent) > 0 else None
