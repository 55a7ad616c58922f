"""Training: the train and eval steps, schedule, optimizer, checkpoints, the
epoch driver, and the model and weights the command line builds."""

from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint, run_training
from patchmatchnet_torch.train.loop import (
    batch_to_device,
    build_stage_pyramid,
    eval_step,
    find_latest_checkpoint,
    load_train_checkpoint,
    make_optimizer,
    multistep_lr,
    save_train_checkpoint,
    train_step,
)

__all__ = [
    "batch_to_device",
    "build_model",
    "build_stage_pyramid",
    "eval_step",
    "find_latest_checkpoint",
    "load_any_checkpoint",
    "load_train_checkpoint",
    "make_optimizer",
    "multistep_lr",
    "run_training",
    "save_train_checkpoint",
    "train_step",
]
