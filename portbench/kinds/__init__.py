"""Drivers of the program under test, one per kind of traffic.

A driver is built with ``(cell, seed, device)``: its constructor is the
run's set-up (weights, inputs, the program's own set-up and warm-up of the
shapes the cell uses). Then ``window(seconds)`` measures and returns the
end-to-end metrics by name, or ``traced()`` runs the fixed sub-window that
the profiler records, leaving what the readers need in ``extra`` (a driver
may take beforehand, in ``unprofiled()``, what the profiler's own cost on
the host would distort).
``attempted`` and ``failed`` count the units of work; ``notes()`` gives
lines for standard error; ``release()`` frees the program's state; and
``check()`` returns the numbers compared with the reference, by name.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_model(config_file: dict, state: dict, device: torch.device, dtype: torch.dtype):
    """The port's restorer built on ``device`` from the configuration,
    computing in ``dtype``, holding the benchmark's seeded ``state``."""
    from msid_tpu_torch.models.restoration import SatMAERestoration

    with torch.device(device):
        model = SatMAERestoration.from_config(config_file["config"], dtype=dtype,
                                              device=device)
    model.load_state_dict(state)
    return model


def rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - ref) ** 2)) / torch.sqrt(torch.mean(ref ** 2)))


def worst_block_rel_rms(out, ref, block: int) -> float:
    """The largest relative RMS gap over the ``block x block`` squares (all
    bands) of an ``[H, W, C]`` output against the reference's."""
    out, ref = torch.as_tensor(out).double(), torch.as_tensor(ref).double()
    h, w, _ = ref.shape
    worst = 0.0
    for y in range(0, h, block):
        sq = ((out[y:y + block] - ref[y:y + block]) ** 2).sum(dim=2)
        rs = (ref[y:y + block] ** 2).sum(dim=2)
        for x in range(0, w, block):
            num = sq[:, x:x + block].sum()
            den = rs[:, x:x + block].sum()
            worst = max(worst, float(torch.sqrt(num / den)))
    return worst
