"""Model export with ``torch.export``: counterpart of ``msid_tpu/deployment/export.py``.

Serialize the inference function to a portable artifact, verify that it
runs, and compare the deployed artifact numerically with the live model.

Artifact layout (a directory):
    module.pt2       the ``torch.export`` program, with the weights as INPUTS
    params.npz       the weights, fp32, '/'-joined keys (npz has no bf16)
    params_int8.npz  instead of params.npz with ``int8_weights``: int8
                     kernels as ``<key>`` and their scales as ``<key>@scale``
    meta.json        {"optimized", "dtype", "tta", "device_type", "torch"}

Three things a plain ``torch.export`` of the model would get wrong, and
what is done about each:

  * **The weights would be baked in.** A module that holds the model as a
    submodule exports its whole state dict inside the program, and the
    example inputs are saved beside it. The program here is a function of
    ``(flat weights, x)`` over a model held outside the module tree
    (``torch.func.functional_call``), and its example inputs are dropped
    before saving, so ``module.pt2`` holds the graph only.
  * **The fused ResidualBlock would vanish.** Traced as Python, the block's
    dispatch by device would record the plain composition (on the CPU) or
    reach the kernel launch with tensors that have no memory (on the card).
    While exporting, the block is the custom operator
    ``msid::fused_residual_block`` (``ops/cuda_decoder.py``) with its
    operands made by graph ops, one node per batch-norm block, which
    launches K1 (bf16) or K4 (fp32) when the program runs on the card.
    Restormer's LayerNorm is the operator ``msid::bias_free_norm``
    (``ops/cuda_layernorm.py``) on the card, one node per norm, which
    launches N2.
  * **fp32 would stop being fp32.** ``exact_fp32`` sets process-wide TF32
    flags, which a trace does not record; ``load_exported``'s callable runs
    an fp32 program inside ``exact_fp32`` itself.

A traced graph keeps the device of the tensors it creates, as a JAX export
keeps its platform: an artifact runs on the device type it was exported on
(``meta.json``'s ``device_type``), and ``load_exported`` refuses any other.
The batch is a ``torch.export.Dim`` unless ``dynamic_batch=False``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from msid_tpu_torch.models.blocks import sharing_weight_operands
from msid_tpu_torch.models.restoration import exact_fp32, resolve_device
from msid_tpu_torch.ops import cuda_decoder  # noqa: F401  registers msid::fused_residual_block
from msid_tpu_torch.ops import cuda_layernorm  # noqa: F401  registers msid::bias_free_norm
from msid_tpu_torch.ops.tta import wrap_forward

logger = logging.getLogger(__name__)

MODULE_FILE = "module.pt2"
PARAMS_FILE = "params.npz"
QPARAMS_FILE = "params_int8.npz"  # int8 payload: <key> + <key>@scale pairs
META_FILE = "meta.json"


def make_inference_fn(model: nn.Module) -> Callable:
    """Pure inference function ``(variables, x) -> y`` of an eval-mode model:
    ``variables`` is a ``{name: tensor}`` state dict (None: the model's
    own), x a float32 NHWC batch, y float32. The weights are an argument by
    design, never closed over (see the module's docstring)."""

    def infer(variables: Optional[dict], x: torch.Tensor) -> torch.Tensor:
        x = x.to(model.dtype)
        out = model(x) if variables is None else functional_call(model, variables, (x,))
        return out.float()

    return infer


def _flatten_variables(variables, prefix: str = "") -> dict:
    """Flatten a dict/list tree to '/'-joined keys. List elements get a
    ``name#i`` key segment so :func:`_unflatten_variables` can rebuild the
    list (the fastpath tree nests lists: blocks, stages, res). Empty lists
    round-trip through an explicit ``name#_empty`` marker; an empty dict
    would be dropped, so it raises. Leaves are kept as they are."""
    flat = {}
    if isinstance(variables, dict):
        items = list(variables.items())
    else:  # list/tuple
        items = [(f"{i}", v) for i, v in enumerate(variables)]
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (list, tuple)) and len(v) == 0:
            flat[f"{key}#_empty"] = np.zeros((0,), np.float32)
            continue
        if isinstance(v, dict) and len(v) == 0:
            raise ValueError(f"cannot serialize empty dict at {key!r} — it would "
                             "not survive the flat key/value round trip")
        if isinstance(v, dict):
            flat.update(_flatten_variables(v, key))
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                sub = f"{key}#{i}"
                if isinstance(item, (dict, list, tuple)):
                    flat.update(_flatten_variables(item, sub))
                else:
                    flat[sub] = item
        else:
            flat[key] = v
    return flat


def _listify(node):
    """Turn ``name#i`` sibling groups (see :func:`_flatten_variables`) back
    into lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    groups: dict = {}
    for k in list(node.keys()):
        if "#" in k:
            name, idx = k.rsplit("#", 1)
            if idx == "_empty":  # explicit empty-list marker
                node.pop(k)
                node[name] = []
                continue
            groups.setdefault(name, {})[int(idx)] = node.pop(k)
    for name, items in groups.items():
        node[name] = [items[i] for i in range(len(items))]
    return node


def _unflatten_variables(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _listify(tree)


class _Program(nn.Module):
    """What is exported: ``(flat weights, x) -> y``. ``infer`` is a plain
    function over a model this module does not register, so the program
    has no state of its own."""

    def __init__(self, infer: Callable, tta: int, height: int, width: int):
        super().__init__()
        self.infer, self.tta, self.height, self.width = infer, tta, height, width

    def forward(self, flat: dict, x: torch.Tensor) -> torch.Tensor:
        tree = _unflatten_variables(flat)
        with sharing_weight_operands():          # once for all the TTA views
            return wrap_forward(functools.partial(self.infer, tree), self.tta,
                                self.height, self.width)(x)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(t)


def export_program(model: nn.Module, output_path: str | Path,
                   input_shape: tuple = (1, 192, 192, 13), dynamic_batch: bool = True,
                   int8_weights: bool = False, optimize: bool = False,
                   tta: int = 1) -> Path:
    """Export the model's inference function and weights to an artifact
    directory, on the model's device (the card, unless the model is on the
    CPU), in the model's dtype. Fixed spatial shape; with ``dynamic_batch``
    any batch from 1 up (the trace runs at a batch of at least 2).

    ``int8_weights`` stores per-output-channel int8 kernels and their
    scales (``deployment/quantize.py``), dequantized at load. ``optimize``
    exports the fastpath graph and tree (``deployment/fastpath.py``:
    fused QKV, folded BN; matmul upsample for ``unet_light``,
    conv-transpose for ``unet_skip``); it raises ``ValueError`` for
    configurations the fastpath does not support and with
    ``int8_weights`` (the quantizer targets the model's own kernels).
    ``tta`` > 1 bakes that many dihedral views into the program
    (``ops/tta.py``), recorded in meta.json."""
    if optimize and int8_weights:
        raise ValueError("optimize=True is not supported with int8_weights")
    start = time.perf_counter()
    device = next(model.parameters()).device
    dtype = model.dtype
    training = model.training
    model.eval()
    try:
        if optimize:
            from msid_tpu_torch.deployment.fastpath import (
                make_fast_inference_fn,
                optimize_for_inference,
            )

            # The payload is fp32 (npz has no bf16); the program's inputs are
            # the compute dtype, and load_exported casts the payload to them.
            mm = getattr(model, "decoder_arch", None) != "unet_skip"
            with torch.no_grad():
                host = optimize_for_inference(model, dtype=torch.float32,
                                              upsample="matmul" if mm else "ct")
            traced = _flatten_variables(host)
            traced = {k: torch.as_tensor(v).to(device, dtype) for k, v in traced.items()}
            infer = make_fast_inference_fn(model, matmul_upsample=mm)
        else:
            traced = {k: v.detach() for k, v in model.state_dict().items()}
            infer = make_inference_fn(model)
        program = _Program(infer, tta, input_shape[1], input_shape[2])
        batch = max(2, input_shape[0]) if dynamic_batch else input_shape[0]
        x = torch.zeros((batch, *input_shape[1:]), device=device)
        dims = {0: torch.export.Dim("batch", min=1)} if dynamic_batch else None
        with torch.no_grad():
            exported = torch.export.export(program, (traced, x), strict=False,
                                           dynamic_shapes=({k: None for k in traced}, dims))
    finally:
        model.train(training)
    exported.example_inputs = None       # they would be the weights, saved again

    out_dir = Path(output_path)
    if out_dir.suffix:  # a file-like path was given; use it as a directory
        out_dir = out_dir.with_suffix("")
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out_dir / MODULE_FILE)
    host = {k: _to_numpy(v) for k, v in traced.items()}
    if int8_weights:
        from msid_tpu_torch.deployment.quantize import quantize_params

        qtree, stree = quantize_params(host, model)
        payload = dict(qtree)
        payload.update({k + "@scale": s for k, s in stree.items() if s.size})
        np.savez(out_dir / QPARAMS_FILE, **payload)
    else:
        np.savez(out_dir / PARAMS_FILE, **host)
    (out_dir / META_FILE).write_text(json.dumps({
        "optimized": bool(optimize),
        "dtype": str(dtype).removeprefix("torch."),
        "tta": int(tta),
        "device_type": device.type,
        "torch": torch.__version__,
    }))
    total_mb = sum(f.stat().st_size for f in out_dir.iterdir()) / 1e6
    logger.info("Exported artifact: %s (%.2f MB, module %.2f MB) in %.1f s", out_dir,
                total_mb, (out_dir / MODULE_FILE).stat().st_size / 1e6,
                time.perf_counter() - start)
    return out_dir


def read_meta(path: str | Path) -> dict:
    meta = Path(path) / META_FILE
    return json.loads(meta.read_text()) if meta.exists() else {}


def load_exported(path: str | Path, device: str | torch.device = "cuda") -> Callable:
    """Load an artifact directory to a callable ``fn(x) -> y`` on ``device``
    (the card unless told otherwise): x a float32 NHWC batch (a tensor on
    any device, or numpy), y a float32 tensor on ``device``. The payload is
    cast to the dtype of each program input (dequantized first when it is
    int8) and bound. An artifact exported on another device type raises
    ``ValueError``; an fp32 artifact runs inside ``exact_fp32``. The
    callable's ``static_batch`` is the batch a static-batch artifact takes
    (None for a dynamic batch)."""
    path = Path(path)
    device = resolve_device(device)
    meta = read_meta(path)
    exported_on = meta.get("device_type", "cpu")
    if exported_on != device.type:
        raise ValueError(
            f"artifact {path} was exported on {exported_on!r} and cannot run on "
            f"{device.type!r}: its graph keeps the device it was traced on; load it "
            f"with device={exported_on!r}, or export it again on {device.type!r}")
    exported = torch.export.load(path / MODULE_FILE)
    if (path / QPARAMS_FILE).exists():
        from msid_tpu_torch.deployment.quantize import dequantize_params

        with np.load(path / QPARAMS_FILE) as z:
            flat = {k: z[k] for k in z.files}
        keys = [k for k in flat if not k.endswith("@scale")]
        empty = np.zeros((0,), np.float32)
        flat = dequantize_params({k: flat[k] for k in keys},
                                 {k: flat.get(k + "@scale", empty) for k in keys})
    else:
        with np.load(path / PARAMS_FILE) as z:
            flat = {k: z[k] for k in z.files}
    # The program's own inputs: the weights and x. Tensors the trace made
    # (SwinIR's shift mask is built from lifted constants) are bound by
    # ``module()``.
    given = {spec.arg.name for spec in exported.graph_signature.input_specs
             if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT}
    inputs = [n.meta["val"] for n in exported.graph.nodes
              if n.op == "placeholder" and n.name in given]
    if len(inputs) != len(flat) + 1:
        raise ValueError(f"artifact {path}: the program takes {len(inputs) - 1} weights, "
                         f"the payload holds {len(flat)}")
    variables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, spec.dtype)
                 for (k, v), spec in zip(flat.items(), inputs)}
    module = exported.module()
    dtype = getattr(torch, meta.get("dtype", "float32"))
    batch = inputs[-1].shape[0]

    def call(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device, torch.float32)
        with torch.inference_mode(), exact_fp32(dtype):
            return module(variables, x)

    call.static_batch = batch if isinstance(batch, int) else None
    return call


def verify_exported_model(path: str | Path, input_shape: tuple = (1, 192, 192, 13),
                          batch_sizes: tuple = (1, 2),
                          device: str | torch.device = "cuda") -> bool:
    """Smoke-test the artifact: load it and run it at several batch sizes;
    the output must have the input's shape and be finite."""
    fn = load_exported(path, device)
    for b in batch_sizes:
        x = np.zeros((b, *input_shape[1:]), np.float32)
        try:
            y = fn(x).cpu().numpy()
        except Exception as e:
            logger.error("Exported model failed at batch %d: %s", b, e)
            return False
        if y.shape != x.shape:
            logger.error("Exported model output shape %s != input %s", y.shape, x.shape)
            return False
        if not np.all(np.isfinite(y)):
            logger.error("Exported model produced non-finite output")
            return False
    logger.info("Exported model verification passed (batches %s)", list(batch_sizes))
    return True


@dataclasses.dataclass
class ComparisonResult:
    max_abs_diff: float
    mean_abs_diff: float
    cosine_similarity: float
    allclose: bool

    def __str__(self) -> str:
        return (f"max|Δ|={self.max_abs_diff:.3e} mean|Δ|={self.mean_abs_diff:.3e} "
                f"cos={self.cosine_similarity:.6f} allclose={self.allclose}")


def compare_live_vs_exported(model: nn.Module, variables: Optional[dict], path: str | Path,
                             input_shape: tuple = (1, 192, 192, 13), rtol: float = 1e-3,
                             atol: float = 1e-5, seed: int = 0) -> ComparisonResult:
    """Numerical parity of the live model (with ``variables``, None: its
    own weights) and the artifact on its device, on a uniform [-2, 2)
    batch: max and mean absolute difference, cosine similarity and
    ``allclose`` at rtol 1e-3 / atol 1e-5. When the artifact bakes a
    dihedral ensemble (meta.json ``tta``), the live side ensembles too."""
    device = next(model.parameters()).device
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        -2.0, 2.0, input_shape).astype(np.float32)).to(device)
    infer = make_inference_fn(model)
    live_fn = wrap_forward(functools.partial(infer, variables),
                           int(read_meta(path).get("tta", 1)), input_shape[1], input_shape[2])
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            live = live_fn(x).cpu().numpy()
    finally:
        model.train(training)
    deployed = load_exported(path, device)(x).cpu().numpy()

    diff = np.abs(live - deployed)
    lf, df = live.ravel(), deployed.ravel()
    cos = float(np.dot(lf, df) / (np.linalg.norm(lf) * np.linalg.norm(df) + 1e-12))
    result = ComparisonResult(
        max_abs_diff=float(diff.max()), mean_abs_diff=float(diff.mean()),
        cosine_similarity=cos,
        allclose=bool(np.allclose(live, deployed, rtol=rtol, atol=atol)))
    logger.info("Live vs exported: %s", result)
    return result
