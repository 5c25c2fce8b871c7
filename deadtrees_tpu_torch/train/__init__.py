from deadtrees_tpu_torch.train.loss import CompoundLoss, CompoundLossConfig, build_loss
from deadtrees_tpu_torch.train.optim import (
    MultiStageConfig,
    Optimizer,
    OptimizerConfig,
    cosine_annealing_schedule,
    encoder_grad_mask,
    global_norm,
    load_optimizer_state_dict,
    make_optimizer,
    optimizer_from_bytes,
    optimizer_state_dict,
    optimizer_to_bytes,
)
from deadtrees_tpu_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_predict_step,
    make_train_step,
)
from deadtrees_tpu_torch.train.trainer import Trainer, train

__all__ = [
    "CompoundLoss",
    "CompoundLossConfig",
    "MultiStageConfig",
    "Optimizer",
    "OptimizerConfig",
    "TrainState",
    "Trainer",
    "build_loss",
    "cosine_annealing_schedule",
    "encoder_grad_mask",
    "global_norm",
    "load_optimizer_state_dict",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_train_step",
    "optimizer_from_bytes",
    "optimizer_state_dict",
    "optimizer_to_bytes",
    "train",
]
