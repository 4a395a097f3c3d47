"""Training (port of ``repro.train``, one device): the train step with
microbatch accumulation, clipping and AdamW, and the host loop."""
from .trainer import (StragglerWatchdog, TrainConfig, Trainer, make_grads_fn,
                      make_loss_fn, make_train_step, value_and_grad)

__all__ = ["StragglerWatchdog", "TrainConfig", "Trainer", "make_grads_fn",
           "make_loss_fn", "make_train_step", "value_and_grad"]
