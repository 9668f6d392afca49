"""Train the restorer with the PyTorch port: counterpart of ``scripts/train.py``.

    python -m msid_tpu_torch.scripts.train --config configs/experiments/tiny_cpu.yaml \\
        --synthetic --device cpu --output-dir /tmp/t

The flags are the JAX script's. The run goes to the card unless ``--device
cpu``; checkpoints go to ``<output-dir>/checkpoints`` and the history to
``<output-dir>/logs/training_history.json``. ``--resume`` continues from
the latest checkpoint there (or under ``--checkpoint``); ``--init-from``
is a weights-only warm start from another run's checkpoints, with a fresh
optimizer and schedule.

Under torchrun it trains data-parallel, one rank per device (the global
batch is the config's, split over the ranks; every rank ends with the
same weights):

    torchrun --nproc_per_node 2 -m msid_tpu_torch.scripts.train \
        --config configs/experiments/tiny_cpu.yaml --synthetic --device cpu --output-dir /tmp/t

Each rank joins the process group (NCCL on cards, rank r on ``cuda:r``;
gloo with ``--device cpu``), and only rank 0 logs and writes checkpoints
and the history. Run without torchrun it is one process, as before.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train the SatMAE multi-spectral "
                                            "denoiser (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/base.yaml")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--init-from", type=str, default=None,
                   help="weights-only warm start from another run's checkpoint "
                        "directory (parameters and BN statistics grafted, fresh "
                        "optimizer and schedule)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--epochs", type=int, default=None, help="override training.epochs")
    p.add_argument("--synthetic", action="store_true", help="force the synthetic dataset")
    p.add_argument("--output-dir", type=str, default="outputs")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the training history."""
    args = parse_args(argv)
    if args.init_from and (args.resume or args.checkpoint):
        raise SystemExit("--init-from is a weights-only warm start; it cannot be "
                         "combined with --resume/--checkpoint")
    from msid_tpu_torch.parallel.distributed import joined_from_env, shutdown

    device, joined = joined_from_env(args.device)
    try:
        return _train(args, device)
    finally:
        if joined:
            shutdown()


def _train(args: argparse.Namespace, device) -> dict:
    import torch.distributed as dist

    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    logger = logging.getLogger("train")

    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    session = setup_training_session(args.config, output_dir=args.output_dir,
                                     epochs=args.epochs, synthetic=args.synthetic,
                                     device=device)
    config, trainer = session["config"], session["trainer"]
    logger.info("train batches/epoch: %d, val batches: %d",
                len(session["train_loader"]), len(session["val_loader"]))

    start_epoch = 0
    if args.init_from:
        out = CheckpointManager(args.init_from).load_weights(trainer.state)
        if out is None:
            raise FileNotFoundError(f"No checkpoint under {args.init_from}")
        logger.info("Warm-started weights from %s (step %d); fresh optimizer",
                    args.init_from, out[2])
    elif args.resume or args.checkpoint:
        manager = (CheckpointManager(args.checkpoint) if args.checkpoint
                   else session["checkpoint_manager"])
        start_epoch = trainer.load_checkpoint(manager)
        logger.info("Resumed from epoch %d", start_epoch)

    history = trainer.fit(session["train_loader"], session["val_loader"],
                          int(config["training"]["epochs"]), start_epoch=start_epoch)
    session["checkpoint_manager"].close()

    if main_rank:
        hist_path = Path(args.output_dir) / "logs" / "training_history.json"
        hist_path.parent.mkdir(parents=True, exist_ok=True)
        hist_path.write_text(json.dumps(history, indent=2))
    logger.info("Training complete. Best val PSNR: %.2f dB",
                max(history["val_psnr"]) if history["val_psnr"] else float("nan"))
    return history


if __name__ == "__main__":
    main()
