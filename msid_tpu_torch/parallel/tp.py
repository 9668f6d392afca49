"""Megatron tensor parallelism of the ViT: counterpart of ``msid_tpu/parallel/tp.py``.

The JAX package places the arrays of a train state with sharding specs
over the mesh's ``model`` axis and lets GSPMD insert the collectives. Here
each rank of a model group holds its shard of a sharded block's weights,
as a parameter of the same name, and the block's attention and MLP run in
Megatron's form (``parallel/collectives.py``): ``f`` before the
column-parallel q/k/v and fc1, ``g`` (one all-reduce) after the
row-parallel out projection and fc2, whose biases are added once after it.

The rules, on the port's parameter names (torch ``Linear`` weights are
``[out, in]``): q/k/v weights and biases split by heads on dim 0; the out
weight on dim 1; the fc1 weight and bias on dim 0; the fc2 weight on dim 1;
the out and fc2 biases and everything else replicated. A block is sharded
only when both its heads and its MLP width divide by the model size, else
all of it stays replicated (the JAX rules replicate leaf by leaf, which
GSPMD can afford and collectives placed by hand cannot).

``shard_train_state`` shards a ``TrainState`` in place: the module's
parameters, the AdamW moments and the EMA shadow keep their names, so
the optimizer's groups, the EMA and the converter still resolve them. The
global gradient norm counts each sharded tensor's shards once (their
squares summed over the model group) and each replicated one once.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from msid_tpu_torch.models.encoder import MlpBlock, MultiHeadAttention, ViTBlock, attend
from msid_tpu_torch.parallel.collectives import (
    copy_to_model_parallel,
    deepcopy_sharing_groups,
    reduce_from_model_parallel,
)
from msid_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

logger = logging.getLogger(__name__)

# (name suffix, rank, dim sharded over the model axis, unit that must divide)
_RULES = (
    (("mlp", "fc1", "weight"), 2, 0, "rows"),
    (("mlp", "fc1", "bias"), 1, 0, "rows"),
    (("mlp", "fc2", "weight"), 2, 1, "rows"),
    (("attn", "query", "weight"), 2, 0, "heads"),
    (("attn", "key", "weight"), 2, 0, "heads"),
    (("attn", "value", "weight"), 2, 0, "heads"),
    (("attn", "query", "bias"), 1, 0, "heads"),
    (("attn", "key", "bias"), 1, 0, "heads"),
    (("attn", "value", "bias"), 1, 0, "heads"),
    (("attn", "out", "weight"), 2, 1, "heads"),
)


def spec_for_path(name: str, shape, model_size: int,
                  num_heads: Optional[int] = None) -> Optional[int]:
    """The dim of parameter ``name`` (of ``shape``) sharded over a model
    axis of ``model_size``, or None for replicated: a rule matches the
    name's suffix and rank, and the sharded dim divides, counted in
    heads (``num_heads``) for the attention rules when it is given."""
    keys = tuple(name.split("."))
    shape = tuple(shape)
    for suffix, rank, dim, unit in _RULES:
        if len(shape) == rank and keys[-len(suffix):] == suffix:
            count = num_heads if unit == "heads" and num_heads else shape[dim]
            return dim if count % model_size == 0 else None
    return None


class TensorParallelAttention(MultiHeadAttention):
    """``MultiHeadAttention`` over this rank's ``num_heads`` local heads:
    ``f``, the local q/k/v projections and attention, the local out
    projection, ``g``, then the out bias."""

    model_group = None

    def __deepcopy__(self, memo: dict):
        return deepcopy_sharing_groups(self, memo, "model_group")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        x = copy_to_model_parallel(x, self.model_group)
        width = self.query.weight.shape[0]
        hd = width // self.num_heads

        def heads(t):
            return t.view(b, n, self.num_heads, hd).transpose(1, 2)

        y = attend(heads(F.linear(x, self.query.weight, self.query.bias)),
                   heads(F.linear(x, self.key.weight, self.key.bias)),
                   heads(F.linear(x, self.value.weight, self.value.bias)))
        y = y.transpose(1, 2).reshape(b, n, width)
        y = reduce_from_model_parallel(F.linear(y, self.out.weight), self.model_group)
        return y + self.out.bias.to(y.dtype)


class TensorParallelMlp(MlpBlock):
    """``MlpBlock`` over this rank's share of the hidden width: ``f``,
    fc1 and GELU on the local columns, the local rows of fc2, ``g``, then
    the fc2 bias."""

    model_group = None

    def __deepcopy__(self, memo: dict):
        return deepcopy_sharing_groups(self, memo, "model_group")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model_parallel(x, self.model_group)
        h = F.gelu(F.linear(x, self.fc1.weight, self.fc1.bias), approximate=self.gelu)
        y = reduce_from_model_parallel(F.linear(h, self.fc2.weight), self.model_group)
        return y + self.fc2.bias.to(y.dtype)


def _shard_of(t: torch.Tensor, parts: int, index: int, dim: int) -> torch.Tensor:
    """A contiguous copy of part ``index`` of ``parts`` of ``t`` along ``dim``."""
    return t.chunk(parts, dim)[index].clone(memory_format=torch.contiguous_format)


def _shard_block(prefix: str, block: ViTBlock, mesh: Mesh) -> dict[str, tuple]:
    """Shard one block's parameters in place and swap its forwards;
    ``{name: (old, new, dim)}`` of the sharded parameters."""
    mp, m = mesh.model, mesh.model_rank
    heads = block.attn.num_heads
    done = {}
    for local, p in list(block.named_parameters()):
        dim = spec_for_path(f"{prefix}.{local}", p.shape, mp, heads)
        if dim is None:
            continue
        owner = block.get_submodule(local.rsplit(".", 1)[0])
        shard = nn.Parameter(_shard_of(p.detach(), mp, m, dim),
                             requires_grad=p.requires_grad)
        setattr(owner, local.rsplit(".", 1)[1], shard)
        done[f"{prefix}.{local}"] = (p, shard, dim)
    block.attn.__class__ = TensorParallelAttention
    block.attn.num_heads = heads // mp
    block.attn.model_group = mesh.model_group
    block.mlp.__class__ = TensorParallelMlp
    block.mlp.model_group = mesh.model_group
    return done


def shard_train_state(state, mesh: Mesh):
    """Shard ``state`` (a ``TrainState``: module, optimizer, EMA) over the
    mesh's model axis in place, by the rules above; returns it. The module
    records ``tp_shard_dims`` (``{name: dim}``) and the optimizer which of
    its parameters are sharded, for the global norm."""
    if mesh.model <= 1 or mesh.model_group is None:
        raise ValueError(f"mesh has no '{MODEL_AXIS}' axis: {mesh.axis_names}")
    model, optimizer = state.model, state.optimizer
    sharded: dict[str, tuple] = {}
    for prefix, block in model.named_modules():
        if not isinstance(block, ViTBlock):
            continue
        heads, hidden = block.attn.num_heads, block.mlp.fc1.out_features
        if heads % mesh.model or hidden % mesh.model:
            logger.warning("%s stays replicated: %d heads / MLP width %d do not divide "
                           "by the model size %d", prefix, heads, hidden, mesh.model)
            continue
        sharded.update(_shard_block(prefix, block, mesh))
    model.tp_shard_dims = {name: dim for name, (_, _, dim) in sharded.items()}

    swap = {id(old): (new, dim) for old, new, dim in sharded.values()}
    optimizer.params = [swap.get(id(p), (p,))[0] for p in optimizer.params]
    adamw = optimizer.adamw
    for group in adamw.param_groups:
        group["params"] = [swap.get(id(p), (p,))[0] for p in group["params"]]
    for old, new, dim in sharded.values():
        entry = adamw.state.pop(old, None)
        if entry:
            adamw.state[new] = {
                k: (_shard_of(v, mesh.model, mesh.model_rank, dim)
                    if torch.is_tensor(v) and v.shape == old.shape else v)
                for k, v in entry.items()}
    new_ids = {id(new) for _, new, _ in sharded.values()}
    optimizer.model_group = mesh.model_group
    optimizer.sharded = [id(p) in new_ids for p in optimizer.params]
    if state.ema is not None:
        for name, (_, _, dim) in sharded.items():
            state.ema[name] = _shard_of(state.ema[name], mesh.model, mesh.model_rank, dim)
    return state


def gather_state_dict(model: nn.Module, mesh: Mesh) -> dict:
    """The module's state dict with every sharded tensor whole again (a
    collective over the model group: every rank of it must call)."""
    import torch.distributed as dist

    dims = getattr(model, "tp_shard_dims", {})
    out = {}
    for name, value in model.state_dict().items():
        if name not in dims:
            out[name] = value.detach().clone()
            continue
        dim = dims[name]
        shape = list(value.shape)
        shape[dim] *= mesh.model
        full = value.new_zeros(shape)
        full.narrow(dim, mesh.model_rank * value.shape[dim], value.shape[dim]).copy_(value)
        dist.all_reduce(full, group=mesh.model_group)       # shards are disjoint
        out[name] = full
    return out


def describe_sharding(state, max_lines: int = 12) -> str:
    """How many bytes of the state (parameters, AdamW moments, EMA) are
    sharded over the model axis and how many replicated, counted whole as
    the JAX function counts a global array, and the first sharded names."""
    model = state.model
    dims = getattr(model, "tp_shard_dims", {})
    size = getattr(getattr(state.optimizer, "model_group", None), "size", lambda: 1)()
    moments = state.optimizer.adamw.state
    sharded = replicated = 0
    lines = []
    for name, p in model.named_parameters():
        tensors = [p] + [v for v in moments.get(p, {}).values()
                         if torch.is_tensor(v) and v.shape == p.shape]
        if state.ema is not None:
            tensors.append(state.ema[name])
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        if name in dims:
            sharded += nbytes * size
            if len(lines) < max_lines:
                lines.append(f"  {name}: dim {dims[name]} over '{MODEL_AXIS}'")
        else:
            replicated += nbytes
    replicated += sum(b.numel() * b.element_size() for b in model.buffers())
    head = (f"model-sharded {sharded / 1e6:.1f} MB, "
            f"replicated {replicated / 1e6:.1f} MB")
    return "\n".join([head] + lines)
