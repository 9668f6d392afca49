"""Parallelism layer of the port: meshes over a process group, data and
tensor parallelism, the process-group entry (counterpart of
``msid_tpu/parallel``; ``batch_sharded`` and ``replicated`` are JAX
shardings and have no counterpart)."""

from msid_tpu_torch.models.blocks import set_data_group
from msid_tpu_torch.parallel.distributed import initialize_from_env
from msid_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    make_mesh_from_config,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
from msid_tpu_torch.parallel.tp import (
    describe_sharding,
    gather_state_dict,
    shard_train_state,
    spec_for_path,
)

__all__ = [
    "describe_sharding",
    "gather_state_dict",
    "shard_train_state",
    "spec_for_path",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "initialize_from_env",
    "make_mesh",
    "make_mesh_from_config",
    "pad_batch_to_multiple",
    "replicate",
    "set_data_group",
    "shard_batch",
]
