"""Multi-process runs of the port's parallel step: counterpart of
``dryrun_multichip`` (``__graft_entry__.py``).

    python -m msid_tpu_torch.parallel.dryrun 4      # 4 gloo ranks on the CPU

``dryrun_multichip(n)`` starts ``n`` processes, joins them into one gloo
process group on this machine (``parallel.initialize_from_env``, as
torchrun would) and takes one train step of a tiny flagship (unet_skip
decoder with the input pyramid, dead-band fill, global residual head,
BatchNorm, remat, block 0 frozen, striping on, bf16 autocast) on a global
batch of ``2n`` tiles: a ``(n/2 x 2)`` (data x model) mesh at n >= 4 with
the ViT's blocks sharded Megatron-style, pure data parallelism below.

``spawn(world, runs)`` is the launcher under it, also for checks of the
parallel path against one process: every rank runs each of ``runs``
(``{key: spec}``, each spec naming its ``task`` and, in
``model_parallel``, its mesh) and writes its results, which the launcher
gathers. The ``step`` task builds a model, its optimizer and steps from
the spec (``build``), takes its rows of a global batch, and returns its
noisy rows, the step's metrics, optionally the whole updated weights and
an eval step's sums; the ``fit`` task trains a config for an epoch with
``setup_training_session``. Every rendezvous and collective carries
``timeout_s``, and so does the wait for the children: a rank that fails
or hangs fails the launch, and the others are killed.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_TIMEOUT_S = 120.0

TINY_FLAGSHIP = dict(
    image_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
    decoder_arch="unet_skip", residual_output=True, input_fill=True,
    decoder_channels=(32, 16, 8, 8), gradient_checkpointing=True,
)


def free_port() -> int:
    """A TCP port of this machine that is free now, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, runs: dict, timeout_s: float = DEFAULT_TIMEOUT_S,
          device: str = "cpu", backend: Optional[str] = None,
          share_device: bool = False, threads: int = 1) -> list[dict]:
    """Run each spec of ``runs`` (``{key: spec}``) in ``world`` ranks of one
    process group on this machine, each with ``threads`` CPU threads;
    returns each rank's ``{key: result}``, by rank. ``device`` is the
    kind of device the ranks run on (``cuda``: rank r on ``cuda:r``, or all
    on ``cuda:0`` with ``share_device``, which needs the gloo ``backend``:
    NCCL refuses two ranks on one card). The ranks load the kernels'
    builds under this checkout; one not built yet is built by one rank
    while the others wait (``ops/_build.py``). Raises when a rank fails or
    the launch outlasts ``timeout_s``."""
    with tempfile.TemporaryDirectory(prefix="msid_spawn_") as tmp:
        tmp = Path(tmp)
        spec_path = tmp / "spec.json"
        spec_path.write_text(json.dumps(dict(runs=runs, device=device, backend=backend,
                                             timeout_s=timeout_s, threads=threads)))
        port = free_port()
        procs, logs = [], []
        try:
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(0 if share_device else rank),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           PYTHONPATH=os.pathsep.join(
                               p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
                log = open(tmp / f"rank{rank}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "msid_tpu_torch.parallel.dryrun", "--worker",
                     str(spec_path), str(tmp / f"rank{rank}.pt")],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            for rank, proc in enumerate(procs):
                try:
                    proc.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise TimeoutError(f"{list(runs)}: rank {rank} of {world} still running "
                                       f"after {timeout_s:.0f} s\n{_tail(logs[rank])}") from None
                if proc.returncode != 0:
                    raise RuntimeError(f"{list(runs)}: rank {rank} of {world} exited with "
                                       f"{proc.returncode}\n{_tail(logs[rank])}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for log in logs:
                log.close()
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _tail(log, limit: int = 4000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-limit:]


def build(spec: dict, device: torch.device, mesh=None) -> dict:
    """Model, train state, train step and eval step of ``spec`` on
    ``device``: the model from ``config`` (a YAML path; its optimizer,
    schedule, loss and noise) or from ``model`` (keyword arguments; then
    ``optimizer`` keyword arguments with a constant ``lr``, ``loss`` and
    ``noise``), its weights from ``weights`` (a ``torch.save``d state
    dict) when given. With ``mesh`` the norms get the data group (unless
    ``local_norms``), the weights are made data rank 0's, and at a model
    axis > 1 the state is sharded (``parallel/tp.py``)."""
    from msid_tpu_torch.models.blocks import set_data_group
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.parallel.mesh import replicate
    from msid_tpu_torch.parallel.tp import shard_train_state
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer, build_optimizer_from_config
    from msid_tpu_torch.training.schedules import constant
    from msid_tpu_torch.training.train_state import TrainState, make_eval_step, make_train_step

    cfg = None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(spec.get("init_seed", 0)))
        if spec.get("config"):
            from msid_tpu_torch.utils.config import load_config

            cfg = load_config(spec["config"])
            model = SatMAERestoration.from_config(cfg, device="cpu")
        else:
            model = SatMAERestoration(**spec["model"])
    if cfg is not None:
        loss_cfg, noise_cfg = LossConfig.from_config(cfg), NoiseConfig.from_config(cfg)
    else:
        loss_cfg = LossConfig(**spec.get("loss", {}))
        noise_cfg = NoiseConfig(**spec.get("noise", {}))
    if spec.get("weights"):
        model.load_state_dict(torch.load(spec["weights"], map_location="cpu"))
    model.to(device)
    if mesh is not None:
        # ``local_norms`` is a control: every rank's norms take the moments of
        # its own rows, as a step without cross-replica BatchNorm would.
        set_data_group(model, None if spec.get("local_norms") else mesh.data_group)
        replicate(model, mesh)
    if cfg is not None:
        optimizer, _ = build_optimizer_from_config(cfg, model)
    else:
        opt = dict(spec.get("optimizer", {}))
        optimizer = build_optimizer(model, constant(float(opt.pop("lr", 1e-3))), **opt)
    state = TrainState.create(model, optimizer, ema=float(spec.get("ema_decay", 0)) > 0)
    if mesh is not None and mesh.model > 1:
        shard_train_state(state, mesh)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    common = dict(image_size=model.image_size, noise_impl=spec.get("noise_impl", "auto"),
                  compute_dtype=dtype, mesh=mesh)
    step = make_train_step(model, loss_cfg, noise_cfg,
                           accum_steps=int(spec.get("accum_steps", 1)),
                           band_permutation_prob=float(spec.get("band_permutation_prob", 0)),
                           ema_decay=float(spec.get("ema_decay", 0)), **common)
    eval_step = make_eval_step(model, loss_cfg, noise_cfg, **common)
    return {"model": model, "state": state, "step": step, "eval_step": eval_step}


def run_step(spec: dict, device: torch.device, mesh=None) -> dict:
    """The ``step`` task on this rank (or, without ``mesh``, on the whole
    batch in one process): with ``eval`` (``batch``, ``count``, ``seed``)
    an eval step's sums on the starting weights; then noisy rows, metrics
    and K2 launches of one train step on the global ``batch`` (a ``.npy``)
    with ``seed``; the whole updated state dict with ``save_state``."""
    from msid_tpu_torch.ops import _build
    from msid_tpu_torch.parallel.mesh import shard_batch
    from msid_tpu_torch.parallel.tp import describe_sharding, gather_state_dict

    built = build(spec, device, mesh)
    model, step = built["model"], built["step"]

    def rows(path):
        batch = np.load(path)
        return batch if mesh is None else shard_batch(batch, mesh)

    out = {"device": str(device)}
    if spec.get("eval"):
        ev = spec["eval"]
        sums = built["eval_step"](rows(ev["batch"]), int(ev.get("seed", 0)), int(ev["count"]))
        out["eval"] = {k: float(v) for k, v in sums.items()}
    batch, seed = rows(spec["batch"]), int(spec.get("seed", 0))
    _, noisy = step.prepare(batch, seed)
    before = _build.launched["msid_noise_forward"]
    state, metrics = step(built["state"], batch, seed)
    out.update(metrics={k: float(v) for k, v in metrics.items()}, noisy=noisy.cpu(),
               noise_launches=_build.launched["msid_noise_forward"] - before, step=state.step)
    if spec.get("save_state"):
        sd = (gather_state_dict(model, mesh) if mesh is not None and mesh.model > 1
              else model.state_dict())
        out["state"] = {k: v.detach().cpu().clone() for k, v in sd.items()}
    if mesh is not None and mesh.model > 1:
        out["sharding"] = describe_sharding(state)
    return out


def run_dryrun(spec: dict, device: torch.device, mesh) -> dict:
    """The ``dryrun`` task: one train step of the tiny flagship on a batch
    of ``2 * world`` uniform tiles."""
    n = mesh.size
    batch = np.random.default_rng(0).uniform(0, 10000, (2 * n, 64, 64, 13)).astype(np.float32)
    path = Path(spec["scratch"]) / "batch.npy"
    if mesh.is_main:
        np.save(path, batch)
    torch.distributed.barrier()
    out = run_step(dict(spec, model=TINY_FLAGSHIP, optimizer=dict(freeze_layers=(0,)),
                        noise=dict(enable_striping=True), dtype="bfloat16",
                        batch=str(path)), device, mesh)
    out["mesh"] = [mesh.data, mesh.model]
    return out


def run_fit(spec: dict, device: torch.device, mesh) -> dict:
    """The ``fit`` task: ``setup_training_session`` on the YAML ``config``
    (synthetic tiles, ``epochs``) into ``output_dir`` and ``Trainer.fit``;
    the history, the checkpoint steps on disk and the state's step."""
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    session = setup_training_session(spec["config"], output_dir=spec["output_dir"],
                                     epochs=int(spec.get("epochs", 1)), synthetic=True,
                                     device=device, mesh=mesh)
    trainer = session["trainer"]
    history = trainer.fit(session["train_loader"], session["val_loader"],
                          int(session["config"]["training"]["epochs"]))
    session["checkpoint_manager"].close()
    ckpt = Path(spec["output_dir"]) / "checkpoints"
    resumed = setup_training_session(spec["config"], output_dir=spec["output_dir"],
                                     synthetic=True, device=device, mesh=mesh)
    return {"history": history, "step": trainer.state.step,
            "checkpoints": sorted(p.name for p in ckpt.iterdir()),
            "train_batch": next(iter(session["train_loader"])).shape[0],
            "resumed_epoch": resumed["trainer"].load_checkpoint(),
            "resumed_step": resumed["trainer"].state.step}


def run_trainer_rules(spec: dict, device: torch.device, mesh) -> dict:
    """The ``trainer_rules`` task: a data-parallel ``Trainer`` fed by
    unsharded loaders of global batches (``batch``): its refusal of a
    train batch of 7 tiles, and its validation of a batch that the data
    axis does not divide (trimmed) and of one smaller than it (skipped)."""
    from msid_tpu_torch.training.trainer import Trainer

    built = build(spec, device, mesh)
    trainer = Trainer(built["model"], built["state"], config={}, device=device, mesh=mesh,
                      eval_step=built["eval_step"])
    batch = np.load(spec["batch"])
    try:
        trainer.train_epoch([batch[:7]], 0)
        refusal = None
    except ValueError as err:
        refusal = str(err)
    n = mesh.data if mesh is not None else 1
    return {"refusal": refusal,
            "val": trainer.validate([(batch, batch.shape[0] - 1), batch[:n - 1]])}


TASKS = {"step": run_step, "dryrun": run_dryrun, "fit": run_fit,
         "trainer_rules": run_trainer_rules}


def worker(spec_path: str, out_path: str) -> None:
    """One rank: join the group, and for each run build its mesh and run
    its task; write the results and leave the group."""
    from msid_tpu_torch.parallel.distributed import initialize_from_env, rank_device, shutdown
    from msid_tpu_torch.parallel.mesh import make_mesh

    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(int(spec["threads"]))
    if not initialize_from_env(spec["device"], spec["backend"], spec["timeout_s"]):
        raise SystemExit("a worker needs torchrun's environment")
    try:
        out = {}
        for key, run in spec["runs"].items():
            mesh = make_mesh(model_parallel=int(run.get("model_parallel", 1)),
                             timeout_s=spec["timeout_s"])
            out[key] = TASKS[run["task"]](run, rank_device(), mesh)
        torch.save(out, out_path)
    finally:
        shutdown()


def dryrun_run(n_devices: int, scratch: str) -> dict:
    """The dry run's spec for ``spawn`` over ``n_devices`` ranks, writing
    its batch under ``scratch``: a ``(n/2 x 2)`` mesh at n >= 4 (even),
    else pure data parallelism."""
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return {"task": "dryrun", "scratch": scratch, "model_parallel": model_parallel}


def check_dryrun(results: list[dict]) -> float:
    """The loss of the dry run from every rank's ``dryrun`` result; raises
    when it is not finite, or when the ranks disagree on it or on the step."""
    losses = [r["metrics"]["loss"] for r in results]
    loss = losses[0]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if any(v != loss for v in losses) or any(r["step"] != 1 for r in results):
        raise RuntimeError(f"ranks disagree: {[(r['metrics'], r['step']) for r in results]}")
    return loss


def dryrun_multichip(n_devices: int, timeout_s: float = DEFAULT_TIMEOUT_S) -> float:
    """One step of the tiny flagship over ``n_devices`` gloo ranks on the
    CPU (see the module docstring); prints and returns the loss."""
    with tempfile.TemporaryDirectory(prefix="msid_dryrun_") as scratch:
        results = spawn(n_devices, {"dryrun": dryrun_run(n_devices, scratch)}, timeout_s)
    loss = check_dryrun([r["dryrun"] for r in results])
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.5f}", flush=True)
    return loss


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:4])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
