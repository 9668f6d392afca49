"""Restore a whole scene with the PyTorch port: counterpart of ``scripts/restore.py``.

    python -m msid_tpu_torch.scripts.restore --config configs/experiments/tiny_cpu.yaml \\
        --checkpoint /tmp/t/checkpoints --input scene.tif --output restored.tif --device cpu

The flags are the JAX script's. The scene (``.tif``/``.tiff`` through the
port's own reader, or ``.npy``, ``[H, W, C]``) is restored by the
sliding-window pipeline (``deployment/sliding_window.py``) with the device
assembly: whole for scenes up to ``AUTO_STREAM_PIXELS``, streamed as row
bands above it (``--streaming auto``), or as ``--streaming on|off`` says.
The weights are the checkpoint's best (by ``val_psnr``, else its latest)
with its EMA shadow when it kept one (``--raw-weights``: the live
parameters), in bf16 under ``training.mixed_precision`` and in float32
otherwise. The run goes to the card unless ``--device cpu``.
``--reflectance`` writes [0, 1] reflectance, computed on the host.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# Above this many pixels "--streaming auto" streams row bands, whose
# device memory does not grow with the scene's height.
AUTO_STREAM_PIXELS = 16e6


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Restore a whole scene (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/base.yaml")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint directory (a CheckpointManager root)")
    p.add_argument("--input", type=str, required=True,
                   help="scene: .tif/.tiff or .npy [H,W,C]")
    p.add_argument("--output", type=str, required=True,
                   help="restored scene: .tif/.tiff or .npy")
    p.add_argument("--window", type=int, default=64,
                   help="native-resolution window size (the training tile size)")
    p.add_argument("--overlap", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--tta", type=int, nargs="?", const=8, default=1, metavar="N",
                   help="dihedral self-ensemble over N views (1-8; bare --tta means 8)")
    p.add_argument("--streaming", choices=("auto", "on", "off"), default="auto",
                   help="restore row bands with upload, compute and download "
                        "overlapped (auto: scenes above 16 Mpix)")
    p.add_argument("--reflectance", action="store_true",
                   help="write [0,1] reflectance instead of model range")
    p.add_argument("--output-dtype", choices=("float32", "float16"), default="float32")
    p.add_argument("--raw-weights", action="store_true",
                   help="use the live params even when the checkpoint carries an "
                        "EMA shadow")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_scene(path: str) -> np.ndarray:
    """An ``[H, W, C]`` scene from a .tif/.tiff or .npy file (a 2-D one
    gets a band axis); another format or rank exits."""
    p = Path(path)
    if p.suffix.lower() in (".tif", ".tiff"):
        from msid_tpu_torch.data.tiff import read_tiff

        scene = read_tiff(p)
    elif p.suffix.lower() == ".npy":
        scene = np.load(p)
    else:
        raise SystemExit(f"unsupported input format {p.suffix!r} (use .tif/.tiff/.npy)")
    if scene.ndim == 2:
        scene = scene[:, :, None]
    if scene.ndim != 3:
        raise SystemExit(f"expected [H,W,C] scene, got shape {scene.shape}")
    return scene


def save_scene(path: str, scene: np.ndarray) -> None:
    """Write ``scene`` as .tif/.tiff or .npy; another format exits."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if p.suffix.lower() in (".tif", ".tiff"):
        from msid_tpu_torch.data.tiff import write_tiff

        write_tiff(p, scene)
    elif p.suffix.lower() == ".npy":
        np.save(p, scene)
    else:
        raise SystemExit(f"unsupported output format {p.suffix!r}")


def to_reflectance(restored: np.ndarray, dtype) -> np.ndarray:
    """``ops.preprocess.from_model_range`` on the host, in ``dtype``: a whole
    scene is GBs, and the affine needs no device."""
    return np.clip(restored.astype(np.float32) * 0.25 + 0.5, 0.0, 1.0).astype(dtype)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Run the CLI; returns the restored scene it writes to ``--output``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("restore")

    from msid_tpu_torch.deployment.sliding_window import (
        restore_scene,
        restore_scene_streaming,
    )
    from msid_tpu_torch.models.restoration import resolve_device
    from msid_tpu_torch.ops.tta import orbit_prefix
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState
    from msid_tpu_torch.training.trainer import compute_dtype_from_config
    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.config import coerce_scheduler_params, load_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    config = coerce_scheduler_params(load_config(args.config))
    config["model"]["encoder"]["pretrained_path"] = None
    image_size = int(config["data"].get("image_size", 192))
    orbit_prefix(args.tta, image_size, image_size)      # before anything is read

    scene = load_scene(args.input)
    logger.info("Scene %s: %s %s", args.input, scene.shape, scene.dtype)
    want_bands = int(config["model"]["encoder"].get("input_channels", 13))
    if scene.shape[2] != want_bands:
        raise SystemExit(f"scene has {scene.shape[2]} bands but the model expects "
                         f"{want_bands} (model.encoder.input_channels)")

    device = resolve_device(args.device)
    # Built and loaded on the host: the scene step moves its own copy to the device.
    model, _ = create_model_from_config(config, int(config.get("seed", 42)), "cpu")
    optimizer, _ = build_optimizer_from_config(config, model)
    manager = CheckpointManager(args.checkpoint)
    target = TrainState.create(model, optimizer)
    out = manager.load_best(target=target) or manager.load_latest(target=target)
    if out is None:
        raise FileNotFoundError(f"No checkpoint found under {args.checkpoint}")
    state, _, step = out
    variables = state.eval_variables(raw=args.raw_weights)
    logger.info("Restored checkpoint step %d from %s", step, args.checkpoint)
    del target, state, optimizer
    model.set_compute_dtype(compute_dtype_from_config(config))

    h, w = scene.shape[:2]
    stream = args.streaming == "on" or (args.streaming == "auto" and h * w > AUTO_STREAM_PIXELS)
    out_dtype = np.dtype(args.output_dtype)
    kwargs = dict(window=args.window, overlap=args.overlap, model_size=image_size,
                  batch_size=args.batch_size, tta=args.tta, output_dtype=out_dtype,
                  device=device)
    t0 = time.perf_counter()
    if stream:
        logger.info("Streaming restore (row bands, upload/compute/download overlapped)")
        restored = restore_scene_streaming(model, variables, scene, **kwargs)
    else:
        restored = restore_scene(model, variables, scene, device_assembly=True, **kwargs)
    dt = time.perf_counter() - t0
    logger.info("Restored %.1f Mpix in %.1f s (%.3f Mpix/s)", h * w / 1e6, dt,
                h * w / 1e6 / dt)
    if args.reflectance:
        restored = to_reflectance(restored, out_dtype)
    save_scene(args.output, restored)
    logger.info("Wrote %s (%s, %s)", args.output, restored.shape, restored.dtype)
    return restored


def cli() -> None:
    """The ``msid-torch-restore`` console entry point: ``main`` with its
    return value dropped, which ``sys.exit`` would read as a failure."""
    main()


if __name__ == "__main__":
    main()
