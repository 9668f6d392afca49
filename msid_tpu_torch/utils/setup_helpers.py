"""Session bootstrap (PyTorch): counterpart of ``setup_device``,
``create_model_from_config``, ``estimate_memory``, ``device_memory_stats``,
``create_training_components``, ``setup_training_session`` and
``print_config_summary`` of ``msid_tpu/utils/setup_helpers.py``.

``setup_training_session`` returns everything ``Trainer.fit`` needs on one
device, the GPU unless ``device="cpu"`` is passed. It loads the encoder
from a SatMAE checkpoint when ``model.encoder.pretrained_path`` exists
(``models/convert.py``), then fits the dead-band fill's Gram matrix over
the train split when the model has ``input_fill``, and builds the
checkpoint manager under ``output_dir/checkpoints`` (``outputs`` by
default, as in the reference) from the ``checkpoint:`` section. Under a
data-parallel mesh (given, or the one ``Trainer`` would make over a
process group that is up) the model goes to the rank's device, the
loaders yield the rank's shard of each batch, and the trainer gives the
norms the data group and rank 0's weights.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def setup_config(config_path: str | Path) -> dict:
    """Load, coerce and validate a config file."""
    from msid_tpu_torch.utils.config import (
        coerce_scheduler_params,
        load_config,
        validate_config,
    )

    config = coerce_scheduler_params(load_config(config_path))
    validate_config(config)
    return config


def setup_device(platform: Optional[str] = None) -> list[torch.device]:
    """The devices to run on: the CUDA cards (``platform`` None, ``"cuda"``
    or ``"gpu"``; raises when there is none), or the CPU when asked for
    (``"cpu"``). The port never falls back to the CPU by itself."""
    if platform == "cpu":
        devices = [torch.device("cpu")]
    elif platform in (None, "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the port runs on the GPU "
                               "unless platform='cpu' is passed")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"platform must be 'cuda', 'gpu' or 'cpu', got {platform!r}")
    logger.info("platform=%s devices=%d", devices[0].type, len(devices))
    return devices


def estimate_memory(config: dict, num_params: int) -> dict:
    """Analytic training-memory estimate in GB: fp32 params, AdamW moments
    and grads, and activations of a micro batch with one bf16 activation
    kept per ViT block boundary plus a few fp32 copies of the images."""
    training = config.get("training", {})
    data = config.get("data", {})
    micro = int(training.get("micro_batch_size", 8))
    size = int(data.get("image_size", 192))
    bands = int(data.get("num_bands", 13))
    enc = config.get("model", {}).get("encoder", {})
    depth = int(enc.get("depth", 12))
    dim = int(enc.get("embed_dim", 768))
    patch = int(enc.get("patch_size", 16))
    tokens = (size // patch) ** 2 * len(enc.get("channel_groups") or (None,))
    params_gb = num_params * 4 / 1e9
    optimizer_gb = num_params * 8 / 1e9
    grads_gb = num_params * 4 / 1e9
    acts = micro * (depth + 2) * tokens * dim * 2
    acts += micro * size * size * bands * 4 * 4
    activations_gb = acts / 1e9
    return {
        "params_gb": params_gb,
        "optimizer_gb": optimizer_gb,
        "grads_gb": grads_gb,
        "activations_gb": activations_gb,
        "total_gb": params_gb + optimizer_gb + grads_gb + activations_gb,
    }


def create_model_from_config(config: dict, seed: int = 0,
                             device: str | torch.device = "cuda"):
    """``(model, param_counts)``: the restorer ``model.architecture`` names
    (``models.restoration.restorer_from_config``), fp32 parameters
    initialized on the CPU from ``seed`` (the global RNG is left as it
    was), then moved to ``device``. The training-memory estimate is logged
    for the SatMAE restorer only (it counts ViT activations)."""
    from msid_tpu_torch.models.restoration import (
        count_parameters,
        resolve_device,
        restorer_from_config,
    )

    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = restorer_from_config(config, device="cpu")
    model.to(device)
    counts = count_parameters(model)
    parts = "".join(f"{k}={n / 1e6:.1f}M " for k, n in counts.items() if k != "total")
    memory = ""
    if config["model"].get("architecture", "satmae") == "satmae":
        memory = f", est. training memory {estimate_memory(config, counts['total'])['total_gb']:.2f} GB"
    logger.info("model: %s %stotal=%.1fM params%s", type(model).__name__, parts,
                counts["total"] / 1e6, memory)
    return model, counts


def device_memory_stats() -> dict:
    """Live per-card memory from ``torch.cuda``, under the JAX package's
    keys: ``bytes_in_use`` and ``peak_bytes_in_use`` of torch's allocator
    and the card's ``bytes_limit``; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_allocated(i),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
        "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
    } for i in range(torch.cuda.device_count())}


def create_training_components(config: dict, model, steps_per_epoch: int = 1):
    """``(optimizer, schedule, loss_cfg, noise_cfg)``."""
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer_from_config

    optimizer, schedule = build_optimizer_from_config(config, model, steps_per_epoch)
    return optimizer, schedule, LossConfig.from_config(config), NoiseConfig.from_config(config)


def build_checkpoint_manager(config: dict, directory: str | Path):
    """The ``CheckpointManager`` of the ``checkpoint:`` section: top-K by
    ``metric`` (minimised when it names a loss), ``save_every``,
    ``moments_dtype`` and ``background_transfer``."""
    from msid_tpu_torch.utils.checkpointing import CheckpointManager

    ckpt = config.get("checkpoint", {})
    metric = str(ckpt.get("metric", "val_psnr"))
    return CheckpointManager(
        directory,
        keep_top_k=int(ckpt.get("keep_top_k", 3)),
        metric=metric,
        mode="min" if "loss" in metric else "max",
        save_every=int(ckpt.get("save_every", 1)),
        moments_dtype=ckpt.get("moments_dtype"),
        background_transfer=bool(ckpt.get("background_transfer", False)),
    )


def setup_training_session(config_path: str | Path | dict,
                           output_dir: str | Path = "outputs",
                           seed: Optional[int] = None,
                           epochs: Optional[int] = None, synthetic: bool = False,
                           device: str | torch.device = "cuda", mesh=None) -> dict:
    """Everything ``Trainer.fit`` needs, in one call: a dict with
    ``config``, ``model``, ``state``, ``trainer``, ``train_loader``,
    ``val_loader``, ``checkpoint_manager`` and ``param_counts``. The
    manager writes under ``output_dir/checkpoints`` (``outputs`` by
    default, as in the reference).

    ``config_path`` may be a loaded config dict (deep-copied). ``epochs``
    overrides ``training.epochs``; ``synthetic`` forces the synthetic
    dataset whatever ``data.root_dir`` says. ``mesh`` (default: the
    trainer's mesh over a process group, if one is up) places the session
    on this rank's device, which ``device`` must name (else it raises),
    and shards its loaders.
    """
    from msid_tpu_torch.data.pipeline import get_dataloaders
    from msid_tpu_torch.models.restoration import resolve_device
    from msid_tpu_torch.ops.fill import fit_gram_from_config
    from msid_tpu_torch.parallel.mesh import on_mesh_device
    from msid_tpu_torch.training.train_state import TrainState
    from msid_tpu_torch.training.trainer import Trainer, mesh_from_process_group

    config = (copy.deepcopy(config_path) if isinstance(config_path, dict)
              else setup_config(config_path))
    if mesh is None:
        mesh = mesh_from_process_group(config, device)
    device = resolve_device(device if mesh is None else on_mesh_device(mesh, device))
    if epochs is not None:
        config.setdefault("training", {})["epochs"] = int(epochs)
    if synthetic:
        config.setdefault("data", {})["root_dir"] = "/nonexistent-forces-synthetic"
    seed = int(config.get("seed", 42)) if seed is None else seed

    train_loader, val_loader = get_dataloaders(config, device, mesh)
    model, counts = create_model_from_config(config, seed, device)

    pretrained = config.get("model", {}).get("encoder", {}).get("pretrained_path")
    if pretrained and Path(pretrained).exists():
        from msid_tpu_torch.models.convert import load_pretrained_encoder

        logger.info("Loading pretrained SatMAE weights from %s", pretrained)
        load_pretrained_encoder(pretrained, model, model.in_channels)
    elif pretrained:
        logger.warning("pretrained_path %s not found — training from scratch", pretrained)

    if model.input_fill:
        logger.info("Fitting dead-band fill Gram on the train split...")
        gram = torch.from_numpy(fit_gram_from_config(config, device))
        with torch.no_grad():
            model.fill_gram.copy_(gram)

    optimizer, schedule, _, _ = create_training_components(
        config, model, steps_per_epoch=max(1, len(train_loader)))
    state = TrainState.create(model, optimizer)
    manager = build_checkpoint_manager(config, Path(output_dir) / "checkpoints")
    trainer = Trainer(model, state, config=config, checkpoint_manager=manager,
                      lr_schedule=schedule, seed=seed, device=device, mesh=mesh)
    return {
        "config": config,
        "model": model,
        "state": state,
        "trainer": trainer,
        "train_loader": train_loader,
        "val_loader": val_loader,
        "checkpoint_manager": manager,
        "param_counts": counts,
        "mesh": mesh,
    }


def print_config_summary(config: dict) -> None:
    """A human-readable summary of a config's key facts."""
    data = config.get("data", {})
    enc = config.get("model", {}).get("encoder", {})
    training = config.get("training", {})
    print("=" * 56)
    print("msid_tpu configuration")
    print("-" * 56)
    print(f"  data:    {data.get('root_dir')}  {data.get('image_size')}px "
          f"x{data.get('num_bands')} bands")
    print(f"  encoder: dim={enc.get('embed_dim')} depth={enc.get('depth')} "
          f"heads={enc.get('num_heads')} frozen={enc.get('freeze_layers')}")
    print(f"  train:   epochs={training.get('epochs')} "
          f"eff_batch={training.get('effective_batch_size')} "
          f"micro={training.get('micro_batch_size')} "
          f"lr={training.get('optimizer', {}).get('lr')}")
    print(f"  loss:    {training.get('loss')}")
    print("=" * 56)
