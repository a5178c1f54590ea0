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
    "Optimizer",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_split_aug_train_step",
    "make_train_step",
]
