#!/usr/bin/env python
"""Two-stage training walkthrough of the PyTorch port (reference
notebooks/02_training.ipynb):

  Stage A — frozen encoder, decoder-only training (all 12 blocks frozen,
            lr 1e-4, configs/experiments/stage_a_decoder.yaml);
  Stage B — partial fine-tune (blocks 0-5 frozen, lr 1e-5, early stopping,
            configs/experiments/stage_b_finetune.yaml), resumed from
            stage A's best-PSNR checkpoint.

Stage B unfreezes blocks that stage A froze: the resume restores the
AdamW moments by parameter name, so the blocks trained from stage B on
start with fresh ones.

History from both stages is merged and persisted as JSON + curves PNG,
mirroring the notebook's artifacts (training_history.json,
training_curves.png). It runs on the GPU, and on the CPU only with
``--device cpu``.

Run:  python msid_tpu_torch/examples/02_two_stage_training.py [--device cpu] [--synthetic]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def run_stage(config_path, output_dir, synthetic, device, epochs=None, resume_from=None):
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    session = setup_training_session(config_path, output_dir=output_dir, epochs=epochs,
                                     synthetic=synthetic, device=device)

    trainer = session["trainer"]
    if resume_from is not None:
        from msid_tpu_torch.utils.checkpointing import CheckpointManager

        start = trainer.load_checkpoint(CheckpointManager(resume_from), best=True)
        print(f"resumed from {resume_from} (epoch {start})")

    # load_checkpoint restores the PREVIOUS stage's history into the
    # trainer, and fit() appends to it — snapshot the restored length so
    # this stage's return contains only its own epochs (otherwise the
    # cross-stage merge below double-counts stage A).
    restored = {k: len(v) for k, v in trainer.history.items()}
    history = trainer.fit(
        session["train_loader"], session["val_loader"],
        int(session["config"]["training"]["epochs"]),
    )
    history = {k: v[restored.get(k, 0):] for k, v in history.items()}
    return history, session


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--stage-a-config", default="configs/experiments/stage_a_decoder.yaml")
    p.add_argument("--stage-b-config", default="configs/experiments/stage_b_finetune.yaml")
    p.add_argument("--epochs", type=int, default=None, help="override both stages")
    p.add_argument("--output-dir", default="outputs/two_stage")
    args = p.parse_args()

    from msid_tpu_torch.utils.setup_helpers import setup_device

    device = setup_device(args.device)[0]
    out = Path(args.output_dir)

    print("=== Stage A: decoder-only (encoder frozen) ===")
    hist_a, _ = run_stage(args.stage_a_config, out / "stage_a", args.synthetic, device,
                          epochs=args.epochs)

    print("=== Stage B: partial fine-tune (blocks 0-5 frozen) ===")
    hist_b, _ = run_stage(args.stage_b_config, out / "stage_b", args.synthetic, device,
                          epochs=args.epochs,
                          resume_from=out / "stage_a" / "checkpoints")

    # merge histories like the notebook (cells 24-27)
    merged = {k: hist_a.get(k, []) + hist_b.get(k, []) for k in hist_a}
    (out / "logs").mkdir(parents=True, exist_ok=True)
    (out / "logs" / "training_history.json").write_text(json.dumps(merged, indent=2))

    from msid_tpu_torch.utils.visualization import plot_training_curves

    plot_training_curves(merged, save_path=out / "logs" / "training_curves.png")
    best = max(merged["val_psnr"]) if merged.get("val_psnr") else float("nan")
    print(f"done. best val PSNR {best:.2f} dB; artifacts in {out / 'logs'}")


if __name__ == "__main__":
    main()
