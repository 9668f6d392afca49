#!/usr/bin/env python
"""Evaluation + deployment walkthrough of the PyTorch port (reference
notebooks/03_evaluation.ipynb): checkpoint eval with on-device metrics,
visual + spectral analysis, ``torch.export`` with numerical verification,
inference benchmark, evaluation_results.json. It runs on the GPU, and on
the CPU only with ``--device cpu``.

Run:  python msid_tpu_torch/examples/03_evaluation_and_export.py --checkpoint <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/experiments/tiny_cpu.yaml")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output-dir", default="outputs/evaluation")
    args = p.parse_args()

    from msid_tpu_torch.utils.setup_helpers import setup_device

    device = setup_device(args.device)[0]

    import torch

    from msid_tpu_torch.data import get_dataloaders
    from msid_tpu_torch.training.trainer import compute_dtype_from_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config, setup_config

    config = setup_config(args.config)
    config["model"]["encoder"]["pretrained_path"] = None
    if args.synthetic:
        config.setdefault("data", {})["root_dir"] = "/nonexistent"
    compute_dtype = compute_dtype_from_config(config)  # bf16 under mixed precision

    model, _ = create_model_from_config(config, device=device)
    if args.checkpoint:
        from msid_tpu_torch.training import TrainState, build_optimizer_from_config
        from msid_tpu_torch.utils.checkpointing import CheckpointManager

        optimizer, _ = build_optimizer_from_config(config, model)
        mgr = CheckpointManager(args.checkpoint)
        out = mgr.load_best(target=TrainState.create(model, optimizer))
        if out:
            model.load_state_dict(out[0].eval_variables())  # EMA shadow when enabled
            print(f"restored best checkpoint (step {out[2]})")

    # -- 1. metric evaluation ------------------------------------------
    from msid_tpu_torch.ops import NoiseConfig
    from msid_tpu_torch.training import LossConfig, evaluate_model

    _, val_loader = get_dataloaders(config, device)
    results = evaluate_model(
        model, None, val_loader,
        loss_cfg=LossConfig.from_config(config),
        noise_cfg=NoiseConfig.from_config(config),
        image_size=int(config["data"].get("image_size", 192)),
        compute_dtype=compute_dtype,
    )
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "evaluation_results.json").write_text(json.dumps(results, indent=2))
    print(f"PSNR {results['psnr']:.2f} dB, SSIM {results['ssim']:.4f}, "
          f"SAM {results['sam']:.2f} deg")

    # -- 2. visual + spectral analysis ----------------------------------
    from msid_tpu_torch.utils.visualization import save_restoration_triptychs

    save_restoration_triptychs(
        model, None, val_loader, out_dir / "figures",
        noise_cfg=NoiseConfig.from_config(config),
        image_size=int(config["data"].get("image_size", 192)), num_samples=3,
        compute_dtype=compute_dtype,
    )

    # -- 3. export + verify ---------------------------------------------
    from msid_tpu_torch.deployment import (
        compare_live_vs_exported,
        export_program,
        verify_exported_model,
    )

    model.set_compute_dtype(compute_dtype)  # serve in the training precision
    size = int(config["data"].get("image_size", 192))
    shape = (1, size, size, int(config["data"].get("num_bands", 13)))
    artifact = export_program(model, out_dir / "model", input_shape=shape)
    ok = verify_exported_model(artifact, input_shape=shape, device=device)
    cmp = compare_live_vs_exported(model, None, artifact, input_shape=shape)
    print(f"export verified={ok}, {cmp}")

    # -- 4. inference benchmark ------------------------------------------
    from msid_tpu_torch.deployment import InferenceSession

    # optimize="auto" (default) picks the inference graph per batch size:
    # the module's own forward for small batches, the hybrid folded-BN
    # decoder graph for large ones. On the card the session captures that
    # forward as a CUDA graph when it is built, and every call replays it.
    session = InferenceSession(model, batch_size=1, image_size=size,
                               num_bands=shape[3], device=device)
    print(f"inference graph: {session.optimized or 'module forward'} "
          f"(compiled: {session.compiled})")
    if device.type == "cuda":  # the benchmark times the card with CUDA events
        stats = session.benchmark(warmup_runs=5, benchmark_iterations=20)
        print(f"b=1 latency: {stats['mean_ms']:.2f} ms ({stats['images_per_sec']:.0f} img/s)")
    else:
        print("b=1 latency: not measured (no card)")


if __name__ == "__main__":
    main()
