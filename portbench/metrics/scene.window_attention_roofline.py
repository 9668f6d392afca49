"""scene.window_attention_roofline: SwinIR's window attention, one fused
launch a Swin block, against its roofline: the sum over the traced
forwards (``tiles // batch``) of each block's least time
(``roofline_swinir.attention_bound`` at the window batch, the tile's
``attention_windows``, the block's heads, ``window_size**2`` tokens and the
head width: q, k, v read, the output written and the bias read once, or
the products at the bf16 peak) over the summed device time of the
attention kernels, in %. The kernels are found by name in the device trace
(``NAMES``: cuDNN's fused attention, ``cudnn_generated_fort_native_sdpa_
sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_...``, which the H100 runs for
every block of the model at the cell's shapes in bf16; PyTorch's
memory-efficient ``fmha_cutlassF_...`` and flash's ``flash_fwd`` where
another back end takes it); the reading is null when none is found, or when their launches are
not a whole number a forward's blocks (a record the profiler dropped, or a
back end that splits a block), and on another architecture. Moves
``restore_mpix_per_s``."""

from portbench.roofline_swinir import attention_bound, attention_launches

NAMES = ("fmha_cutlass", "sdpa", "flash_fwd")


def read(trace):
    extra = trace.extra
    if "tiles" not in extra or "attention_windows" not in extra or \
            extra["config"]["model"].get("architecture") != "swinir":
        return None
    config, batch = extra["config"], extra["batch"]
    tokens = int(config["model"]["encoder"]["window_size"]) ** 2
    launches = attention_launches(config) * (extra["tiles"] // batch)
    spent = [seconds for name, seconds in trace.kernels("")
             if any(part in name for part in NAMES)]
    if not spent or len(spent) % len(launches) or sum(spent) <= 0:
        return None
    least = sum(attention_bound(batch, extra["attention_windows"], heads, tokens, width)
                for heads, width in launches)
    return 100.0 * least / sum(spent)
