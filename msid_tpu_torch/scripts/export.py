"""Export the restorer with the PyTorch port: counterpart of ``scripts/export.py``.

    python -m msid_tpu_torch.scripts.export --model-config configs/experiments/tiny_cpu.yaml \\
        --checkpoint /tmp/t/checkpoints --output /tmp/x/model --verify --device cpu

The flags are the JAX script's: ``--config`` (the deployment YAML),
``--model-config``, ``--checkpoint``, ``--output``, ``--verify``,
``--benchmark``, ``--int8``, ``--optimize`` and ``--tta [N]``. The artifact
(``deployment/export.py``: ``module.pt2``, the payload and ``meta.json``)
is exported on the card unless ``--device cpu``, and runs only on the
device type it was exported on. The weights are the checkpoint's best (by
``val_psnr``, else its latest) with its EMA shadow when it kept one, else
the seeded initialization. The compute dtype is bf16 unless the deployment
config's ``bf16_inference`` is false, then the training precision.
``--verify`` runs the artifact at batches 1 and 2 and compares it with the
live model: allclose for a plain artifact, cosine similarity above 0.99
for int8 and 0.999 for the optimized graph, exiting 1 on a failure.
``--benchmark`` times a live ``InferenceSession`` on the card.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export the denoiser (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/deployment.yaml")
    p.add_argument("--model-config", type=str, default="configs/base.yaml")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only quantized payload (reference INT8 path)")
    p.add_argument("--optimize", action="store_true",
                   help="export the fastpath graph (fused QKV + folded BN)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tta", type=int, nargs="?", const=8, default=1, metavar="N",
                   help="bake an N-view dihedral self-ensemble into the artifact "
                        "(1-8; bare --tta means 8)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Run the CLI; returns the artifact directory."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("export")

    import torch

    from msid_tpu_torch.deployment.export import (
        compare_live_vs_exported,
        export_program,
        verify_exported_model,
    )
    from msid_tpu_torch.models.restoration import resolve_device
    from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    deploy_cfg = load_config(args.config)
    config = coerce_scheduler_params(load_config(args.model_config))
    config["model"]["encoder"]["pretrained_path"] = None
    device = resolve_device(args.device)

    # bf16_inference (default true) wins; when it is off, follow the training
    # precision, so an fp32-trained model is not exported as a bf16 artifact.
    export_cfg = deploy_cfg.get("export", {})
    opt_cfg = export_cfg.get("optimization", {})
    mixed = bool(config.get("training", {}).get("mixed_precision", True))
    bf16 = bool(opt_cfg.get("bf16_inference", True)) or mixed
    model, _ = create_model_from_config(config, int(config.get("seed", 42)), device)

    if args.checkpoint:
        from msid_tpu_torch.training.optim import build_optimizer_from_config
        from msid_tpu_torch.training.train_state import TrainState
        from msid_tpu_torch.utils.checkpointing import CheckpointManager

        optimizer, _ = build_optimizer_from_config(config, model)
        target = TrainState.create(model, optimizer)
        manager = CheckpointManager(args.checkpoint)
        out = manager.load_best(target=target) or manager.load_latest(target=target)
        if out is None:
            raise FileNotFoundError(f"No checkpoint under {args.checkpoint}")
        # EMA runs serve the shadow weights (the same choice as evaluate).
        model.load_state_dict(out[0].eval_variables())
        logger.info("Restored checkpoint from %s", args.checkpoint)
    model.set_compute_dtype(torch.bfloat16 if bf16 else torch.float32).eval()

    output = Path(args.output or export_cfg.get("output_path",
                                                "outputs/export/satmae_denoiser"))
    # The export shape defaults to the model's own geometry; an explicit
    # deployment input_shape overrides the batch only.
    data_cfg = config.get("data", {})
    size = int(data_cfg.get("image_size", 192))
    default_shape = (1, size, size, int(data_cfg.get("num_bands", 13)))
    input_shape = tuple(export_cfg.get("input_shape", default_shape))
    if input_shape[1:] != default_shape[1:]:
        logger.warning("deployment input_shape %s does not match model geometry %s — "
                       "using the model's", input_shape, default_shape)
        input_shape = (input_shape[0], *default_shape[1:])

    use_int8 = bool(args.int8 or opt_cfg.get("use_int8_quantization", False))
    use_opt = bool(args.optimize or opt_cfg.get("simplify_graph", False))
    if use_opt and use_int8:
        # Explicit CLI flags beat config keys; two explicit flags conflict.
        if args.optimize and args.int8:
            raise SystemExit("--optimize and --int8 are not combinable")
        if args.optimize:
            logger.warning("--optimize overrides the config's use_int8_quantization — "
                           "exporting the optimized graph without int8")
            use_int8 = False
        else:  # --int8 explicit, or both from config: int8 wins
            logger.warning("int8 export takes precedence — skipping graph "
                           "optimization (not combinable)")
            use_opt = False
    dynamic = bool(export_cfg.get("dynamic_batch", True))
    path = export_program(model, output, input_shape=input_shape, dynamic_batch=dynamic,
                          int8_weights=use_int8, optimize=use_opt, tta=args.tta)
    if use_int8:
        from msid_tpu_torch.deployment.quantize import quantization_report

        state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
        report = quantization_report(state, model)
        logger.info("int8 weights: %.1f MB -> %.1f MB (%.1fx)", report["original_mb"],
                    report["quantized_mb"], report["compression"])

    if args.verify:
        # A static-batch program only takes its own batch size.
        sizes = (1, 2) if dynamic else (int(input_shape[0]),)
        ok = verify_exported_model(path, input_shape=input_shape, batch_sizes=sizes,
                                   device=device)
        # int8 rounding is deliberate loss, and the optimized graph reorders
        # the arithmetic: both are held to cosine similarity, not allclose.
        if use_int8:
            kwargs = dict(rtol=0.1, atol=0.05)
        elif use_opt:
            kwargs = dict(rtol=0.02, atol=0.02)
        else:
            kwargs = {}
        result = compare_live_vs_exported(model, None, path, input_shape=input_shape,
                                          **kwargs)
        logger.info("verify=%s, %s", ok, result)
        if use_int8:
            passed = result.cosine_similarity > 0.99
        elif use_opt:
            passed = result.cosine_similarity > 0.999
        else:
            passed = result.allclose
        if not ok or not passed:
            sys.exit(1)

    if args.benchmark:
        from msid_tpu_torch.deployment.inference import InferenceSession

        inf_cfg = deploy_cfg.get("inference", {})
        session = InferenceSession(
            model, batch_size=int(inf_cfg.get("batch_size", 1)), image_size=input_shape[1],
            num_bands=input_shape[3], device=device,
            donate_input=bool(opt_cfg.get("donate_input", False)))
        stats = session.benchmark(
            warmup_runs=int(inf_cfg.get("warmup_runs", 10)),
            benchmark_iterations=int(inf_cfg.get("benchmark_iterations", 100)))
        logger.info("benchmark: %s", stats)
    return path


def cli() -> None:
    """The ``msid-torch-export`` console entry point: ``main`` with its
    return value dropped, which ``sys.exit`` would read as a failure."""
    main()


if __name__ == "__main__":
    main()
