"""Device mesh of the port: counterpart of ``msid_tpu/parallel/mesh.py``.

JAX runs one process over every device and lays them out as an array of
shape ``(data, model)``; GSPMD then makes every reduction global. The port
runs one process per device (``torch.distributed``, NCCL on cards, gloo on
the CPU), and a ``Mesh`` is this rank's view of the same layout: the JAX
reshape ``(dp, mp)`` of the ranks, so global rank ``r = d * mp + m`` has
data index ``d`` and model index ``m``. Its ``data_group`` holds the ranks
with this rank's ``m`` (they hold different rows of a global batch: the
gradients, the loss and the BatchNorm statistics are reduced over it), its
``model_group`` the ranks with this rank's ``d`` (they hold different
shards of the ViT, ``parallel/tp.py``).

With no process group up, ``make_mesh`` lays a mesh over local devices in
one process: that is for serving only (``InferenceSession(mesh=...)``,
one replica per device), as a step needs one rank per device.

A mesh never picks the CPU by itself: a serving mesh defaults to the
machine's cards and raises when there are none, and a rank's device is
the one ``initialize_from_env`` gave it, the current card under NCCL, or
the one the caller names; ``on_mesh_device`` refuses a caller's device
that is not the mesh's.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
GROUP_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``(data, model)`` layout of ``data * model``
    devices: its global ``rank``, its ``device``, the process groups of its
    data and model axes (None with no process group up; the model group
    also when ``model`` is 1), and ``devices``, the local devices of a
    serving mesh (this rank's device alone under a process group)."""

    data: int
    model: int
    rank: int
    device: torch.device
    devices: tuple
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans ranks of a process group."""
        return self.data_group is not None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def axis_names(self) -> tuple:
        return (DATA_AXIS,) if self.model == 1 else (DATA_AXIS, MODEL_AXIS)

    @property
    def is_main(self) -> bool:
        """Rank 0, which logs and writes."""
        return self.rank == 0

    def data_ranks(self) -> list[int]:
        """Global ranks of this rank's data group, by data index."""
        return [d * self.model + self.model_rank for d in range(self.data)]

    def rows(self, local_batch: int) -> tuple[int, int]:
        """``(offset, global_batch)`` of this data rank's ``local_batch`` rows
        of a global batch split evenly over the data axis."""
        return self.data_rank * local_batch, self.data * local_batch


def local_devices() -> list[torch.device]:
    """Every card of this machine; raises when it has none (a mesh over the
    CPU names its devices: ``make_mesh(devices=["cpu", ...])``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; a mesh runs on the cards unless "
                           "its devices are named (make_mesh(devices=['cpu', ...]))")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def on_mesh_device(mesh: Mesh, device: str | torch.device) -> torch.device:
    """The device of a session on ``mesh`` that its caller asked to run on
    ``device``: the mesh's, which ``device`` must name (the same kind, and
    the same index where it gives one). Raises otherwise, rather than run
    the session on another device than asked."""
    return _named_by(device, mesh.device)


def _named_by(requested: str | torch.device, device: torch.device) -> torch.device:
    requested = torch.device(requested)
    if requested.type != device.type or requested.index not in (None, device.index):
        raise ValueError(f"asked to run on {requested}, but this rank's device is {device}")
    return device


def _rank_device(devices: Optional[Sequence]) -> torch.device:
    """This rank's device under the process group: the first of ``devices``,
    else the one ``initialize_from_env`` gave it, else under NCCL the
    current card. Raises when it is none of these, or when ``devices``
    names another device than ``initialize_from_env`` gave it."""
    from msid_tpu_torch.parallel.distributed import rank_device

    joined = rank_device()
    if devices:
        device = torch.device(devices[0])
        if joined is not None:
            return _named_by(device, joined)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if joined is not None:
        return joined
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"this rank's device is unknown: its {dist.get_backend()} process "
                     f"group was not joined through initialize_from_env; pass "
                     f"devices=[<this rank's device>]")


def make_mesh(num_devices: int = -1, data_parallel: Optional[int] = None,
              model_parallel: int = 1, devices: Optional[Sequence] = None,
              timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """A ``(data[, model])`` mesh, with the JAX function's checks.

    With a process group up it spans all of its ranks (every rank must call
    it, in the same order as any other group it makes): ``num_devices``
    and ``data_parallel`` may only restate the world size, since a launched
    world cannot be shrunk; ``model_parallel`` > 1 makes the data and model
    groups. ``devices`` then names this rank's device (default: the one
    ``initialize_from_env`` gave it, else by the backend).

    With no process group it is a serving mesh over ``devices`` (default:
    every local card, else the CPU), the first ``num_devices`` of them, a
    pure data axis.
    """
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        if num_devices > 0 and num_devices != n:
            raise ValueError(f"num_devices={num_devices} but the process group has {n} "
                             f"ranks: a launched world cannot be shrunk")
        if model_parallel <= 1:
            if data_parallel not in (None, n):
                raise ValueError(f"data_parallel={data_parallel} but the process group has "
                                 f"{n} ranks")
            dp, mp = n, 1
        else:
            dp, mp = data_parallel or n // model_parallel, model_parallel
            if dp * mp != n:
                raise ValueError(f"{dp}x{mp} mesh does not cover {n} devices")
        rank = dist.get_rank()
        device = _rank_device(devices)
        timeout = datetime.timedelta(seconds=timeout_s)
        if mp == 1:
            data_group, model_group = dist.group.WORLD, None
        else:
            data_groups = [dist.new_group([d * mp + m for d in range(dp)], timeout=timeout)
                           for m in range(mp)]
            model_groups = [dist.new_group([d * mp + m for m in range(mp)], timeout=timeout)
                            for d in range(dp)]
            data_group, model_group = data_groups[rank % mp], model_groups[rank // mp]
        return Mesh(dp, mp, rank, device, (device,), data_group, model_group)

    devs = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if num_devices > 0:
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs)
    if model_parallel > 1:
        raise ValueError("tensor parallelism needs a process group with one rank per "
                         "device (torchrun); a local mesh serves data-parallel only")
    if data_parallel is not None:
        if not 0 < data_parallel <= n:
            raise ValueError(f"data_parallel={data_parallel} exceeds {n} devices")
        devs = devs[:data_parallel]
    return Mesh(len(devs), 1, 0, devs[0], tuple(devs))


def make_mesh_from_config(config: dict) -> Mesh:
    """The mesh of the ``parallel:`` section (``num_devices``,
    ``model_parallel``)."""
    par = config.get("parallel", {})
    return make_mesh(num_devices=int(par.get("num_devices", -1)),
                     model_parallel=int(par.get("model_parallel", 1)))


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make every parameter and buffer of ``module`` (on this rank's
    device) equal to data rank 0's, by a broadcast over the data group;
    returns the module. Nothing to do on a serving mesh."""
    if not mesh.distributed:
        return module
    src = mesh.data_ranks()[0]
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src, group=mesh.data_group)
    return module


def shard_batch(batch, mesh: Mesh):
    """This data rank's rows of a global batch (numpy or tensor): rows
    ``[d * n / dp, (d + 1) * n / dp)``. The batch must divide by the data
    axis. A serving mesh of several devices splits its batch itself."""
    if not mesh.distributed and mesh.data > 1:
        raise ValueError("a serving mesh splits its batch in the session, not here")
    n = batch.shape[0]
    if n % mesh.data:
        raise ValueError(f"batch size {n} not divisible by the {mesh.data}-way data "
                         f"axis of the mesh")
    per = n // mesh.data
    return batch[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def pad_batch_to_multiple(batch: np.ndarray, multiple: int) -> tuple:
    """Pad the leading axis to a multiple (for sharding); returns
    (padded, true_count)."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[:1], multiple - rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
