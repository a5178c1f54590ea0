from fastscnn_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    make_mesh_for_batch,
    replicate_sharding,
)
from fastscnn_tpu_torch.parallel.multihost import host_shard, initialize_multihost, is_primary_host
from fastscnn_tpu_torch.parallel.train import (
    Optimizer,
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
)

__all__ = [
    "Mesh",
    "Optimizer",
    "TrainState",
    "batch_sharding",
    "create_train_state",
    "host_shard",
    "initialize_multihost",
    "is_primary_host",
    "make_eval_step",
    "make_mesh",
    "make_mesh_for_batch",
    "make_optimizer",
    "make_split_aug_train_step",
    "make_train_step",
    "replicate_sharding",
]
