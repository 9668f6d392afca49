"""The port's schedules and grouped AdamW against the JAX package's optax
chain, on the CPU. The optimizer runs on a toy module whose parameter names
are the flagship's kinds: frozen and trainable encoder blocks, the position
embedding, a decoder layer and ``fill_gram``; both sides get the same
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from msid_tpu.training.optim import build_optimizer as jax_build_optimizer
from msid_tpu.training.optim import label_params as jax_label_params
from msid_tpu.training.schedules import build_schedule as jax_build_schedule
from msid_tpu.training.schedules import cosine_warm_restarts as jax_sgdr
from msid_tpu_torch.training.optim import build_optimizer, label_params
from msid_tpu_torch.training.schedules import build_schedule, cosine_warm_restarts

PARAM_ATOL = 1e-6


@pytest.mark.parametrize("args", [
    (1e-4, 10, 2, 1e-6, 1),       # the flagship's SGDR, T_0 in steps
    (1e-3, 5, 1, 0.0, 1),
    (3e-4, 2, 3, 1e-5, 7),        # T_0 in epochs of 7 steps
])
def test_sgdr_curve_matches_jax(args):
    """To 1e-7 of the curve's scale (the base LR): torch's and XLA's fp32
    cosines differ by an ulp, and 1 + cos cancels near each trough."""
    ours, theirs = cosine_warm_restarts(*args), jax_sgdr(*args)
    got = np.array([ours(s) for s in range(301)])
    want = np.array([float(theirs(s)) for s in range(301)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7 * args[0])


@pytest.mark.parametrize("sched", [
    {"type": "CosineAnnealingWarmRestarts", "T_0": 4, "T_mult": 2, "eta_min": 1e-6,
     "unit": "epoch"},
    {"type": "cosine", "T_max": 3, "eta_min": 1e-6},
    {"type": "constant"},
])
def test_build_schedule_matches_jax(sched):
    config = {"training": {"optimizer": {"lr": 2e-4}, "scheduler": sched}}
    ours, theirs = build_schedule(config, 5), jax_build_schedule(config, 5)
    for step in range(40):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)


class Toy(nn.Module):
    """Parameters named like the flagship's."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(nn.Linear(3, 4) for _ in range(2))
        self.encoder.pos_embed = nn.Parameter(torch.zeros(1, 2, 4))
        self.decoder = nn.Linear(4, 2)
        self.fill_gram = nn.Parameter(torch.eye(3))


def toy_params(seed=0):
    """The JAX pytree and the same values in a Toy module."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    tree = {"encoder": {"blocks_0": {"kernel": r(3, 4), "bias": r(4)},
                        "blocks_1": {"kernel": r(3, 4), "bias": r(4)},
                        "pos_embed": r(1, 2, 4)},
            "decoder": {"kernel": r(4, 2), "bias": r(2)},
            "fill_gram": r(3, 3)}
    return tree


def to_named(tree):
    """Port parameter name -> numpy value (Linear weights are [out, in])."""
    enc = tree["encoder"]
    named = {"encoder.pos_embed": enc["pos_embed"], "fill_gram": tree["fill_gram"],
             "decoder.weight": tree["decoder"]["kernel"].T,
             "decoder.bias": tree["decoder"]["bias"]}
    for i in range(2):
        named[f"encoder.blocks.{i}.weight"] = enc[f"blocks_{i}"]["kernel"].T
        named[f"encoder.blocks.{i}.bias"] = enc[f"blocks_{i}"]["bias"]
    return {k: np.asarray(v) for k, v in named.items()}


def test_label_params_matches_jax():
    labels = label_params(Toy(), freeze_layers=(0,))
    jax_labels = to_named(jax.tree_util.tree_map(
        lambda lab: np.array(lab), jax_label_params(toy_params(), freeze_layers=(0,))))
    assert labels == {k: str(v) for k, v in jax_labels.items()}
    assert labels["fill_gram"] == "frozen" and labels["encoder.blocks.0.weight"] == "frozen"
    assert labels["encoder.pos_embed"] == "encoder" and labels["decoder.bias"] == "decoder"


@pytest.mark.parametrize("grad_scale,clip", [(5.0, 1.0), (0.05, 1.0), (5.0, 0.0)])
def test_three_grouped_adamw_steps_match_optax(grad_scale, clip):
    opt_kwargs = dict(weight_decay=0.05, betas=(0.9, 0.999), gradient_clip=clip,
                      encoder_lr_scale=0.1, freeze_layers=(0,))
    schedule_args = (1e-2, 2, 2, 1e-4)          # restarts within the three steps
    params = toy_params()
    tx = jax_build_optimizer(jax_sgdr(*schedule_args), params=params, **opt_kwargs)
    opt_state = tx.init(params)

    model = Toy()
    start = to_named(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(start[name]))
    optimizer = build_optimizer(model, cosine_warm_restarts(*schedule_args), **opt_kwargs)

    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(0, 1, x.shape) * grad_scale).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        named_grads = to_named(grads)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(named_grads[name].copy())
        norm = optimizer.global_norm()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        optimizer.clip_(norm)
        optimizer.step(step)
        optimizer.zero_grad()

        want = to_named(params)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"step {step} {name}")
    assert np.array_equal(model.fill_gram.detach().numpy(), start["fill_gram"])
    assert np.array_equal(model.encoder.blocks[0].weight.detach().numpy(),
                          start["encoder.blocks.0.weight"])


def test_clip_is_optax_not_clip_grad_norm():
    """g * max / norm only when norm >= max; below it the gradient is kept
    exactly (clip_grad_norm_ would scale by max / (norm + 1e-6))."""
    model = Toy()
    optimizer = build_optimizer(model, cosine_warm_restarts(1e-3, 10), gradient_clip=1.0)
    for scale in (0.05, 3.0):          # global norms 0.38 and 23
        grads = {n: torch.full_like(p, scale) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        norm = optimizer.global_norm()
        optimizer.clip_(norm)
        want = optax.clip_by_global_norm(1.0).update(
            {n: jnp.asarray(g.numpy()) for n, g in grads.items()}, None)[0]
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[n]), rtol=1e-7)
        if scale < 1:
            assert all(torch.equal(p.grad, grads[n]) for n, p in model.named_parameters())
