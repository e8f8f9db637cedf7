"""Training substrate (the port of ``repro.train``): AdamW with its
schedule, and the train and eval step factories."""

from .optim import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    schedule_lr,
)
from .steps import make_eval_step, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "make_eval_step", "make_train_step",
           "schedule_lr"]
