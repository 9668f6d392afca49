"""The port's parallel layer in one process, against the JAX package's
where it has a counterpart: mesh layout and checks, ``pad_batch_to_multiple``,
the tensor-parallel rules on converted names, sharded loaders, draws by
global sample (K2's plain version, the ``jnp`` impl, the band
permutation), ``initialize_from_env``, cross-replica BatchNorm and the
trainer over a one-rank gloo group, and mesh serving over two CPU
"devices". Several processes: ``test_torch_distributed.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from msid_tpu.parallel import pad_batch_to_multiple as jax_pad_batch_to_multiple
from msid_tpu.parallel.tp import spec_for_path as jax_spec_for_path
from msid_tpu_torch.data.dataset import SyntheticEuroSAT
from msid_tpu_torch.data.pipeline import BatchLoader, DeviceCachedLoader
from msid_tpu_torch.deployment.inference import InferenceSession, MeshSession
from msid_tpu_torch.models.blocks import Norm, set_data_group
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.ops.cuda_noise import apply_sensor_noise_kernel_reference
from msid_tpu_torch.ops.noise import NoiseConfig, corrupt
from msid_tpu_torch.ops.preprocess import random_band_permutation
from msid_tpu_torch.parallel import (
    Mesh,
    describe_sharding,
    initialize_from_env,
    make_mesh,
    pad_batch_to_multiple,
    shard_batch,
    spec_for_path,
)
from msid_tpu_torch.parallel import distributed as distributed_module
from msid_tpu_torch.parallel.dryrun import free_port
from msid_tpu_torch.parallel.mesh import on_mesh_device
from msid_tpu_torch.training import trainer as trainer_module
from msid_tpu_torch.training.eval import split_batch_item
from msid_tpu_torch.training.losses import LossConfig
from msid_tpu_torch.training.optim import build_optimizer
from msid_tpu_torch.training.schedules import constant
from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step
from msid_tpu_torch.utils.setup_helpers import setup_training_session

torch.set_num_threads(2)

TINY = dict(image_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=2,
            decoder_arch="unet_skip", decoder_channels=(16, 8, 8, 8), residual_output=True)
NOISE = NoiseConfig(enable_striping=True, stripe_prob=0.5)
CPU = torch.device("cpu")
FIT_CONFIG = "configs/experiments/tiny_cpu.yaml"


# ---------------- meshes ----------------


@pytest.mark.parametrize("rank,data_rank,model_rank,data_ranks", [
    (0, 0, 0, [0, 2]), (1, 0, 1, [1, 3]), (2, 1, 0, [0, 2]), (3, 1, 1, [1, 3]),
])
def test_mesh_layout_is_the_jax_reshape(rank, data_rank, model_rank, data_ranks):
    mesh = Mesh(2, 2, rank, CPU, (CPU,))
    assert (mesh.data_rank, mesh.model_rank) == (data_rank, model_rank)
    assert mesh.data_ranks() == data_ranks
    assert mesh.rows(3) == (3 * data_rank, 6)
    assert mesh.axis_names == ("data", "model") and mesh.size == 4


def test_serving_mesh_and_its_checks():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert (mesh.data, mesh.model, mesh.distributed) == (4, 1, False)
    assert mesh.axis_names == ("data",)
    assert make_mesh(num_devices=2, devices=["cpu"] * 4).data == 2
    assert make_mesh(data_parallel=3, devices=["cpu"] * 4).data == 3
    with pytest.raises(ValueError, match="exceeds 4 devices"):
        make_mesh(data_parallel=5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(model_parallel=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="splits its batch"):
        shard_batch(np.zeros((4, 2)), mesh)
    one = make_mesh(devices=["cpu"])
    assert shard_batch(np.arange(3), one).tolist() == [0, 1, 2]


@pytest.mark.parametrize("shape,multiple", [((13, 4, 4, 2), 8), ((16, 2), 8), ((3, 5), 4),
                                            ((1, 2), 2), ((7,), 7)])
def test_pad_batch_to_multiple_matches_jax(shape, multiple):
    batch = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, n = pad_batch_to_multiple(batch, multiple)
    want, m = jax_pad_batch_to_multiple(batch, multiple)
    assert n == m and got.dtype == want.dtype and np.array_equal(got, want)


# ---------------- tensor-parallel rules ----------------


def jax_leaves(depth, dim, heads, hidden):
    """The JAX ViT's leaves as (path, shape, port name, port dim of each JAX
    axis): Dense kernels [in, out] transpose, q/k/v [D, H, hd] and out
    [H, hd, D] flatten their head axes first."""
    hd = dim // heads
    out = []
    for i in range(depth):
        jb, pb = ("encoder", f"blocks_{i}"), f"encoder.blocks.{i}"
        for proj in ("query", "key", "value"):
            out.append((jb + ("attn", proj, "kernel"), (dim, heads, hd),
                        f"{pb}.attn.{proj}.weight", {1: 0}))
            out.append((jb + ("attn", proj, "bias"), (heads, hd),
                        f"{pb}.attn.{proj}.bias", {0: 0}))
        out.append((jb + ("attn", "out", "kernel"), (heads, hd, dim),
                    f"{pb}.attn.out.weight", {0: 1}))
        out.append((jb + ("attn", "out", "bias"), (dim,), f"{pb}.attn.out.bias", {}))
        out.append((jb + ("mlp", "fc1", "kernel"), (dim, hidden), f"{pb}.mlp.fc1.weight",
                    {1: 0}))
        out.append((jb + ("mlp", "fc1", "bias"), (hidden,), f"{pb}.mlp.fc1.bias", {0: 0}))
        out.append((jb + ("mlp", "fc2", "kernel"), (hidden, dim), f"{pb}.mlp.fc2.weight",
                    {0: 1}))
        out.append((jb + ("mlp", "fc2", "bias"), (dim,), f"{pb}.mlp.fc2.bias", {}))
        for norm in ("norm1", "norm2"):
            out.append((jb + (norm, "scale"), (dim,), f"{pb}.{norm}.weight", {}))
    out.append((("encoder", "pos_embed"), (1, 16, dim), "encoder.pos_embed", {}))
    out.append((("decoder", "head_out", "kernel"), (3, 3, 8, 13),
                "decoder.head_out.weight", {}))
    return out


@pytest.mark.parametrize("heads,model_size", [(4, 2), (12, 4), (3, 2), (2, 4)])
def test_spec_for_path_is_the_jax_rule_on_converted_names(heads, model_size):
    dim = 96
    port = SatMAERestoration(image_size=64, embed_dim=dim, depth=2, num_heads=heads,
                             decoder_channels=(8, 8, 8, 8))
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    sharded = 0
    for path, shape, name, axes in jax_leaves(2, dim, heads, 4 * dim):
        spec = jax_spec_for_path(path, np.zeros(shape, np.float32), model_size)
        jax_axis = next((a for a, e in enumerate(spec) if e == "model"), None)
        want = None if jax_axis is None else axes[jax_axis]
        assert spec_for_path(name, shapes[name], model_size, heads) == want, (name, spec)
        sharded += want is not None
    assert sharded == (20 if heads % model_size == 0 else 6)     # else fc1 and fc2 only


def test_describe_sharding_of_a_replicated_state_reads_as_the_jax_format():
    model = SatMAERestoration(**TINY)
    state = TrainState.create(model, build_optimizer(model, constant(1e-3)))
    assert describe_sharding(state).startswith("model-sharded 0.0 MB, replicated ")


# ---------------- sharded loaders ----------------


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kw", [dict(shuffle=True, drop_last=True, pad_last=False),
                                dict(shuffle=False, drop_last=False, pad_last=True)])
def test_loader_shards_together_are_the_one_device_batches(cached, kw):
    ds = SyntheticEuroSAT(num_samples=14, split="train", train_split=1.0, seed=3, tile_size=8)
    make = ((lambda **a: DeviceCachedLoader(ds, 4, seed=5, device="cpu", **kw, **a))
            if cached else (lambda **a: BatchLoader(ds, 4, seed=5, prefetch=1, **kw, **a)))
    for _ in range(2):                         # two epochs: each reshuffles alike
        whole = [split_batch_item(b) for b in make()]
        shards = [[split_batch_item(b) for b in make(num_shards=2, shard_index=i)]
                  for i in range(2)]
        assert len(whole) == len(shards[0]) == len(shards[1]) == (3 if kw["drop_last"] else 4)
        for (b, n), (b0, n0), (b1, n1) in zip(whole, *shards):
            assert b0.shape[0] == b1.shape[0] == 2
            assert n == n0 == n1 if kw["pad_last"] else n0 == n1 == 2   # the global count
            assert np.array_equal(np.concatenate([np.asarray(b0), np.asarray(b1)]),
                                  np.asarray(b))
    with pytest.raises(ValueError, match="not divisible by 3"):
        make(num_shards=3, shard_index=0)


# ---------------- draws by global sample ----------------


def test_k2_plain_version_with_an_offset_draws_the_rows_of_the_whole_batch():
    x = torch.rand(4, 8, 8, 13) * 4 - 2
    whole, masks = apply_sensor_noise_kernel_reference(9, x, NOISE, return_masks=True)
    rows, rows_masks = apply_sensor_noise_kernel_reference(9, x[1:3], NOISE, return_masks=True,
                                                           sample_offset=1)
    assert torch.equal(rows, whole[1:3]) and torch.equal(rows_masks, masks[1:3])
    assert torch.equal(corrupt(9, x[2:], NOISE, "pallas", sample_offset=2, global_batch=4),
                       whole[2:])
    assert torch.equal(corrupt(9, x, NOISE, "pallas"),
                       apply_sensor_noise_kernel_reference(9, x, NOISE))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        apply_sensor_noise_kernel_reference(9, x, NOISE, sample_offset=2 ** 32 - 2)


def test_jnp_impl_and_band_permutation_keep_the_rows_of_the_whole_batch():
    x = torch.rand(4, 8, 8, 13) * 4 - 2
    whole = corrupt(7, x, NOISE, "jnp")
    assert torch.equal(corrupt(7, x[2:], NOISE, "jnp", sample_offset=2, global_batch=4),
                       whole[2:])
    assert torch.equal(corrupt(7, x, NOISE, "jnp", global_batch=4), whole)
    with pytest.raises(ValueError, match="global_batch"):
        corrupt(7, x[2:], NOISE, "jnp", sample_offset=2)
    with pytest.raises(ValueError, match="not in a batch of 4"):
        corrupt(7, x[1:], NOISE, "jnp", sample_offset=2, global_batch=4)

    def permuted(rows, offset, n):
        return random_band_permutation(rows, 0.5, torch.Generator().manual_seed(3), offset, n)

    full = random_band_permutation(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(permuted(x, 0, None), full)
    assert torch.equal(permuted(x[1:3], 1, 4), full[1:3])
    assert not torch.equal(full, x)                      # some sample was permuted


# ---------------- process groups ----------------


def test_initialize_from_env_without_torchrun_is_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_from_env("cpu") is False
    assert not dist.is_initialized()


def test_initialize_from_env_raises_where_jax_falls_back(monkeypatch):
    """A deliberate divergence from the JAX function: a failed join raises."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))     # no rank 0 listens there
    with pytest.raises(Exception):
        initialize_from_env("cpu", timeout_s=2)
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "99")
    with pytest.raises(RuntimeError, match="no card cuda:99"):
        initialize_from_env("cuda", timeout_s=2)
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        initialize_from_env("cpu", timeout_s=2)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process, for one test."""
    store = tmp_path / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield make_mesh(devices=["cpu"])
    dist.destroy_process_group()


def test_mesh_over_a_process_group_and_its_checks(one_rank_group):
    mesh = one_rank_group
    assert (mesh.data, mesh.model, mesh.rank, mesh.distributed) == (1, 1, 0, True)
    assert mesh.device == CPU and mesh.is_main
    with pytest.raises(ValueError, match="cannot be shrunk"):
        make_mesh(num_devices=2)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh(model_parallel=2)


def test_a_mesh_never_picks_the_cpu_by_itself(one_rank_group, monkeypatch, tmp_path):
    """A gloo group the caller joined names no device: the rank's device
    must be given; a device other than the one initialize_from_env gave
    the rank is refused."""
    with pytest.raises(ValueError, match="this rank's device is unknown"):
        make_mesh()
    monkeypatch.setattr(distributed_module, "_rank_device", CPU)
    assert make_mesh().device == CPU
    with pytest.raises(ValueError, match="asked to run on cuda:0"):
        make_mesh(devices=["cuda:0"])


def test_a_serving_mesh_defaults_to_the_cards_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(devices=["cpu"]).devices == (CPU,)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_a_session_on_a_mesh_refuses_another_device(device):
    """The trainer and the session set-up run on the mesh's device or
    raise; they never move a caller's ``device="cuda"`` to the CPU."""
    mesh = Mesh(1, 1, 0, CPU, (CPU,))
    assert on_mesh_device(mesh, "cpu") == CPU
    with pytest.raises(ValueError, match=f"asked to run on {device}, but this rank's"):
        setup_training_session(FIT_CONFIG, device=device, mesh=mesh)
    torch.manual_seed(0)
    model = SatMAERestoration(**TINY)
    state = TrainState.create(model, build_optimizer(model, constant(1e-3)))
    with pytest.raises(ValueError, match=f"asked to run on {device}, but this rank's"):
        trainer_module.Trainer(model, state, config={}, device=device, mesh=mesh)


def test_cross_replica_batch_norm_over_one_rank_is_the_local_one(one_rank_group):
    x = torch.randn(3, 5, 4, 4, requires_grad=True)
    grads, outs = [], []
    for group in (None, one_rank_group.data_group):
        norm = Norm(5)
        norm.data_group = group
        x.grad = None
        y = norm(x)
        (y * torch.arange(5.0)[:, None, None]).sum().backward()
        outs.append((y.detach(), norm.running_mean.clone(), norm.running_var.clone()))
        grads.append(x.grad.clone())
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_data_parallel_steps_over_one_rank_are_the_plain_steps(one_rank_group):
    batch = np.random.default_rng(0).uniform(500, 9500, (4, 16, 16, 13)).astype(np.float32)
    results = []
    for mesh in (None, one_rank_group):
        torch.manual_seed(0)
        model = SatMAERestoration(**TINY)
        set_data_group(model, None if mesh is None else mesh.data_group)
        state = TrainState.create(model, build_optimizer(model, constant(1e-3)))
        step = make_train_step(model, LossConfig(), NOISE, image_size=32, noise_impl="pallas",
                               band_permutation_prob=0.5, mesh=mesh)
        _, metrics = step(state, batch, 3)
        sums = make_eval_step(model, LossConfig(), NOISE, image_size=32, mesh=mesh)(batch, 4, 3)
        results.append((metrics, sums, model.state_dict()))
    (m0, s0, w0), (m1, s1, w1) = results
    for key in ("loss", "mse", "grad_norm"):
        assert float(m1[key]) == pytest.approx(float(m0[key]), rel=1e-6)
    assert float(s1["count"]) == 3.0
    for key in s0:
        assert float(s1[key]) == pytest.approx(float(s0[key]), rel=1e-5)
    for key in w0:
        torch.testing.assert_close(w1[key], w0[key], rtol=1e-4, atol=2e-3)


def test_trainer_mesh_rules(one_rank_group, monkeypatch):
    assert trainer_module.mesh_from_process_group({}) is None        # one rank: no mesh
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="cannot be shrunk"):
        trainer_module.mesh_from_process_group({"parallel": {"num_devices": 1}})
    assert trainer_module.mesh_from_process_group({"parallel": {"enabled": False}}) is None


# ---------------- mesh serving ----------------


def test_mesh_session_serves_as_one_device_session():
    torch.manual_seed(0)
    model = SatMAERestoration(**TINY).eval()
    x = np.random.default_rng(0).normal(0, 1, (4, 32, 32, 13)).astype(np.float32)
    mesh = make_mesh(devices=["cpu", "cpu"])
    session = InferenceSession(model, batch_size=4, image_size=32, device="cpu", mesh=mesh)
    assert isinstance(session, MeshSession) and session.compiled is None
    assert len(session.replicas) == 2 and session.replicas[0].batch_size == 2
    got = session.predict(x)
    single = InferenceSession(model, batch_size=4, image_size=32, device="cpu")
    np.testing.assert_allclose(got, single.predict(x), rtol=1e-3, atol=5e-5)  # the JAX bound
    half = InferenceSession(model, batch_size=2, image_size=32, device="cpu")
    assert np.array_equal(got[:2], half.predict(x[:2]))
    assert np.array_equal(got[2:], half.predict(x[2:]))
    assert torch.equal(session.forward(torch.from_numpy(x)), torch.from_numpy(got))
    with pytest.raises(ValueError, match="divide"):
        InferenceSession(model, batch_size=3, image_size=32, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="not a serialized artifact"):
        InferenceSession(batch_size=4, image_size=32, artifact_path="unused", mesh=mesh)
