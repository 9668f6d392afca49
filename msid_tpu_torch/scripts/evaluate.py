"""Evaluate a trained restorer with the PyTorch port: counterpart of
``scripts/evaluate.py``.

    python -m msid_tpu_torch.scripts.evaluate --config configs/experiments/tiny_cpu.yaml \\
        --synthetic --device cpu --checkpoint /tmp/t/checkpoints --output-dir /tmp/e

The flags are the JAX script's. The validation split is corrupted with the
trainer's fixed seeds and its ``noise.impl``, so a checkpoint's metrics
reproduce the trainer's last validation line. The best checkpoint (by
``val_psnr``, else the latest) is scored with its EMA shadow when it kept
one (``--raw-weights``: the live parameters), in bf16 under
``training.mixed_precision`` and in fp32 otherwise (the eval step turns
TF32 off around its forward). ``--ensemble`` scores the mean restoration of several checkpoints
and ``--tta N`` averages N dihedral views; both compose. ``--forward
hybrid`` scores through the module's encoder and the folded-BN decoder
(``deployment/fastpath.py``); it raises ``ValueError`` for models with an
``input_fill`` stage or without batch norm. Results go to
``<output-dir>/evaluation_results.json``.

Under torchrun (``torchrun --nproc_per_node N -m msid_tpu_torch.scripts.evaluate
... [--device cpu]``) the ranks split each validation batch, every rank
loads the checkpoints, the metric sums are reduced over the ranks (the
same numbers as one process), and rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate a trained denoiser (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/base.yaml")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory (a CheckpointManager root)")
    p.add_argument("--save_visualizations", action="store_true")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--raw-weights", action="store_true",
                   help="evaluate the live params even when the checkpoint carries "
                        "an EMA shadow")
    p.add_argument("--ensemble", type=str, nargs="+", default=None, metavar="CKPT_DIR",
                   help="further checkpoint directories to ensemble with --checkpoint: "
                        "metrics score the mean restoration of all of them")
    p.add_argument("--tta", type=int, nargs="?", const=8, default=1, metavar="N",
                   help="self-ensemble over N dihedral views of each noisy input "
                        "(1-8; bare --tta means 8)")
    p.add_argument("--forward", choices=("auto", "apply", "hybrid"), default="auto",
                   help="eval forward graph: auto (= apply), apply (the module's "
                        "forward) or hybrid (module encoder + folded-BN decoder; "
                        "unet_light/unet_skip with batch norm and no input_fill)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns what it writes to ``evaluation_results.json``."""
    args = parse_args(argv)
    if args.save_visualizations:
        raise NotImplementedError("--save_visualizations needs utils/visualization.py "
                                  "(matplotlib), not ported")
    if args.ensemble and not args.checkpoint:
        raise SystemExit("--ensemble extends --checkpoint; pass --checkpoint too")
    from msid_tpu_torch.parallel.distributed import joined_from_env, shutdown

    device, joined = joined_from_env(args.device)
    try:
        return _evaluate(args, device)
    finally:
        if joined:
            shutdown()


def _evaluate(args: argparse.Namespace, device) -> dict:
    import torch.distributed as dist

    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("evaluate")

    from msid_tpu_torch.data.pipeline import get_dataloaders
    from msid_tpu_torch.models.restoration import resolve_device
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.ops.tta import orbit_prefix
    from msid_tpu_torch.training.eval import evaluate_model
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState
    from msid_tpu_torch.training.trainer import compute_dtype_from_config, mesh_from_process_group
    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    config = coerce_scheduler_params(load_config(args.config))
    config["model"]["encoder"]["pretrained_path"] = None
    image_size = int(config["data"].get("image_size", 192))
    orbit_prefix(args.tta, image_size, image_size)      # before any checkpoint is read
    if args.synthetic:
        config.setdefault("data", {})["root_dir"] = "/nonexistent-forces-synthetic"
    mesh = mesh_from_process_group(config, device)
    device = resolve_device(device)
    compute_dtype = compute_dtype_from_config(config)
    model, _ = create_model_from_config(config, int(config.get("seed", 42)), device)

    variables = None
    restored_step = None
    ensemble_steps = []
    if args.checkpoint:
        optimizer, _ = build_optimizer_from_config(config, model)
        target = TrainState.create(model, optimizer)

        def load_eval_variables(ckpt_dir: str):
            manager = CheckpointManager(ckpt_dir)
            out = manager.load_best(target=target) or manager.load_latest(target=target)
            if out is None:
                raise FileNotFoundError(f"No checkpoint found under {ckpt_dir}")
            state, _, step = out
            if args.raw_weights and state.ema is not None:
                logger.info("--raw-weights: evaluating live params, not the EMA shadow")
            logger.info("Restored checkpoint step %d from %s", step, ckpt_dir)
            return state.eval_variables(raw=args.raw_weights), int(step)

        variables, restored_step = load_eval_variables(args.checkpoint)
        if args.ensemble:
            members, ensemble_steps = [variables], [restored_step]
            for extra in args.ensemble:
                v, s = load_eval_variables(extra)
                members.append(v)
                ensemble_steps.append(s)
            variables = tuple(members)
            logger.info("Ensembling %d checkpoints (mean restoration)", len(members))

    _, val_loader = get_dataloaders(config, device, mesh)
    results = evaluate_model(
        model, variables, val_loader, loss_cfg=LossConfig.from_config(config),
        noise_cfg=NoiseConfig.from_config(config), image_size=image_size, tta=args.tta,
        forward_impl=args.forward, compute_dtype=compute_dtype,
        noise_impl=str(config.get("noise", {}).get("impl", "auto")), mesh=mesh,
        verbose=main_rank)
    if args.tta > 1:
        results["tta"] = args.tta
        logger.info("Metrics above use %d-view dihedral self-ensembling", args.tta)
    if args.ensemble:
        results["ensemble"] = len(ensemble_steps)
    results["provenance"] = {
        "config": args.config,
        "checkpoint": args.checkpoint,
        "checkpoint_step": restored_step,
        "ensemble": args.ensemble,
        "ensemble_steps": ensemble_steps or None,
        "forward": args.forward,
        "tta": args.tta,
        "raw_weights": bool(args.raw_weights),
        "dtype": str(compute_dtype).removeprefix("torch."),
        "device": str(device),
        "date_utc": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"),
    }
    if main_rank:
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "evaluation_results.json").write_text(json.dumps(results, indent=2) + "\n")
    return results


if __name__ == "__main__":
    main()
