#!/usr/bin/env python
"""Quick-start walkthrough of the PyTorch port (reference
notebooks/00_quick_setup_test.ipynb): environment check, data setup,
dataset exploration, forward-pass smoke test, noise visualization.

It runs on the GPU, and on the CPU only with ``--device cpu``; with no
card and no ``--device cpu`` it raises.

Run:  python msid_tpu_torch/examples/00_quick_start.py [--device cpu] [--config ...] [--synthetic]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/experiments/tiny_cpu.yaml")
    p.add_argument("--device", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output-dir", default="outputs/quick_start")
    args = p.parse_args()

    # -- 1. environment ------------------------------------------------
    import torch

    from msid_tpu_torch.utils.setup_helpers import setup_config, setup_device

    devices = setup_device(args.device)
    device = devices[0]
    print(f"torch {torch.__version__} devices: {devices}")

    config = setup_config(args.config)
    config.setdefault("data", {})["synthetic_fallback"] = True
    if args.synthetic:
        config["data"]["root_dir"] = "/nonexistent"

    # -- 2. data (EuroSAT-MS under data.root_dir if present, else synthetic) --
    from msid_tpu_torch.utils.download import verify_downloads

    report = verify_downloads(config)
    print(f"dataset present: {report['dataset_present']} ({report['dataset_path']})")

    from msid_tpu_torch.data import get_dataloaders

    train_loader, val_loader = get_dataloaders(config, device)
    print(f"train batches: {len(train_loader)}, val batches: {len(val_loader)}")

    batch = next(iter(train_loader))  # host numpy, or a tensor of the device tile cache
    tiles = torch.as_tensor(batch).to(device, torch.float32)
    print(f"raw tile batch: {tuple(tiles.shape)} {batch.dtype} "
          f"range [{tiles.min():.1f}, {tiles.max():.1f}]")

    # -- 3. model + forward smoke test ---------------------------------
    from msid_tpu_torch.training.trainer import compute_dtype_from_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config, print_config_summary

    print_config_summary(config)
    model, counts = create_model_from_config(config, device=device)
    print(f"params: {counts['total'] / 1e6:.1f}M")

    from msid_tpu_torch.ops import NoiseConfig, apply_sensor_noise, preprocess_tiles

    image_size = int(config["data"].get("image_size", 192))
    clean = preprocess_tiles(tiles, image_size)
    noisy = apply_sensor_noise(0, clean, NoiseConfig.from_config(config))
    dtype = compute_dtype_from_config(config)  # bf16 under mixed precision
    with torch.no_grad(), torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32):
        restored = model.eval()(noisy.to(dtype))
    print(f"forward: {tuple(noisy.shape)} -> {tuple(restored.shape)} ({restored.dtype})")

    # -- 4. untrained metrics (sanity floor) ----------------------------
    from msid_tpu_torch.ops import batch_metric_sums

    sums = {k: float(v) for k, v in batch_metric_sums(restored.float(), clean).items()}
    n = sums["count"]
    print(f"untrained model: PSNR {sums['psnr']/n:.2f} dB, "
          f"SSIM {sums['ssim']/n:.4f}, SAM {sums['sam']/n:.2f} deg")

    # -- 5. noise visualization -----------------------------------------
    out = Path(args.output_dir)
    from msid_tpu_torch.utils.visualization import plot_restoration_triptych

    plot_restoration_triptych(
        *(a[0].float().cpu().numpy() for a in (noisy, clean, restored)),
        save_path=out / "noise_preview.png",
    )
    print(f"wrote {out / 'noise_preview.png'}")


if __name__ == "__main__":
    main()
