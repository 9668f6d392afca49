"""Time K4 (``csrc/resblock_fp32.cu``) at every output tile that fits, on the card.

    python -m msid_tpu_torch.scripts.sweep_k4_tiles [--out k4_tiles.jsonl]

For the flagship decoder's four shapes and two tiny widths, at B=1 and
B=16, every square tile from 3 up whose shared memory and region fit is launched
with the cluster size ``fp32_tiling`` picks and with clusters of one CTA,
held to the plain version (max abs error <= 1e-4), then timed as the
median of CUDA events. One JSON line per shape gives the times by tile,
the fastest tile and the one ``fp32_tiling`` picks. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192), (8, 64), (24, 16))
BATCHES = (1, 16)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default=None, help="also write the lines here")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)

    import torch

    from msid_tpu_torch.ops import cuda_decoder as cd
    from msid_tpu_torch.ops._build import load_library

    if not torch.cuda.is_available():
        print("sweep_k4_tiles: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    fn = load_library("resblock_fp32").msid_resblock_fp32_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []
    for c, s in SHAPES:
        tn, cg = cd.fp32_channel_block(c)
        nb = tn * cg
        region = cd.FP32_SLOTS * cd.FP32_THREADS // cg * cd.FP32_TM
        for b in BATCHES:
            rng = np.random.default_rng(c + b)
            x = torch.from_numpy(rng.normal(0, 1, (b, s, s, c)).astype(np.float32)).cuda()
            w1, w2 = (torch.from_numpy(rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c))
                                       .astype(np.float32)).cuda() for _ in range(2))
            aff = torch.from_numpy(np.stack([rng.normal(1, 0.1, c), rng.normal(0, 0.1, c)] * 2)
                                   .astype(np.float32)).cuda()
            want = cd.fused_residual_block_reference(x, w1, w2, aff)
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream
            picked, _, g = cd.fp32_tiling(c, s, s, b, sms)

            def launch(tile, g):
                err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), aff.data_ptr(),
                         out.data_ptr(), b, s, s, c, tile, tile, nb, g, stream)
                if err:
                    raise RuntimeError(f"K4 launch failed: cudaError {err}")

            def timed(tile, g):
                launch(tile, g)
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                for _ in range(2):
                    launch(tile, g)
                pairs = [(torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)) for _ in range(args.iters)]
                for start, end in pairs:
                    start.record()
                    launch(tile, g)
                    end.record()
                torch.cuda.synchronize()
                return float(np.median([a.elapsed_time(e) for a, e in pairs])), err

            ms_by_tile, ms_by_tile_g1, errs = {}, {}, []
            for cluster, times in ((g, ms_by_tile), (1, ms_by_tile_g1)):
                tile = 3                 # smaller tiles recompute most of conv1
                while ((tile + 2) ** 2 <= region and tile <= s
                       and cd.fp32_smem_bytes(c, tile, nb, cluster) <= cd.MAX_SMEM):
                    times[tile], err = timed(tile, cluster)
                    errs.append(err)
                    tile += 1
            best = min(ms_by_tile, key=ms_by_tile.get)
            line = {"C": c, "H": s, "B": b, "nb": nb, "g": g, "picked": picked,
                    "picked_ms": ms_by_tile[picked], "best": best,
                    "best_ms": ms_by_tile[best], "ms_by_tile": ms_by_tile,
                    "g1_best_ms": min(ms_by_tile_g1.values()),
                    "ms_by_tile_g1": ms_by_tile_g1,
                    "max_abs_err": max(errs), "ok": max(errs) <= 1e-4,
                    "card": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(l) + "\n" for l in lines))
    return 0 if all(l["ok"] for l in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
