"""train.norm_fused_share: the share of train-mode batch norms that ran the
kernel set N1 (``ops/cuda_norm.py``), as 100 x the ``msid.norm.fused``
spans over the ``msid.norm.train`` spans they nest in. 100 when every
``Norm`` of the step takes the kernels; 0 on a program whose norms all keep
the fp32 composition (one without the span). Moves ``train_tiles_per_s``."""

from portbench.spans import count


def read(trace):
    norms = count(trace, "msid.norm.train")
    if not trace.device or not norms:
        return None
    return 100.0 * count(trace, "msid.norm.fused") / norms
