"""The collectives GSPMD places in the JAX package, written out by hand.

Under JAX one program spans the mesh and XLA makes every reduction
global, forward and backward. With one process per device each reduction
has to be placed, and its backward with it:

  * ``all_reduce_sum``: sum over a group forward, and the gradients summed
    over the group backward. Cross-replica BatchNorm's batch moments: each
    rank's loss depends on every rank's rows through them, so the
    gradient of a rank's partial sums is the sum of every rank's gradient
    of the global sums.
  * ``copy_to_model_parallel`` (Megatron's ``f``): identity forward,
    all-reduce backward; before the column-parallel q/k/v and fc1.
  * ``reduce_from_model_parallel`` (Megatron's ``g``): all-reduce forward,
    identity backward; after the row-parallel out projection and fc2.
    (``torch.distributed.nn.functional.all_reduce`` would all-reduce the
    backward too, multiplying the gradients that reach the LayerNorms and
    the embeddings by the model-parallel size.)

Reductions of a low-precision tensor are made in fp32 and cast back.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; its backward sums the gradients."""
    return _AllReduceSum.apply(x, group)


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its backward sums the gradients over ``group``."""
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; its backward passes the gradient on."""
    return _ReduceFromModelParallel.apply(x, group)


def all_reduce_mean_(tensors: list[torch.Tensor], group, size: int) -> None:
    """Replace every tensor by its mean over ``group`` of ``size`` ranks, in
    place, by one all-reduce of one flat buffer per dtype (a bucket)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.mul_(1.0 / size)
        torch._foreach_copy_(same, [v.view_as(t) for v, t in
                                    zip(flat.split([t.numel() for t in same]), same)])


def deepcopy_sharing_groups(module, memo: dict, *attrs: str):
    """``copy.deepcopy`` of ``module`` whose process groups (the attributes
    ``attrs``) are shared with the copy, not copied (a group cannot be)."""
    for name in attrs:
        group = getattr(module, name, None)
        if group is not None:
            memo[id(group)] = group
    new = module.__class__.__new__(module.__class__)
    memo[id(module)] = new
    for k, v in module.__dict__.items():
        new.__dict__[k] = copy.deepcopy(v, memo)
    return new
