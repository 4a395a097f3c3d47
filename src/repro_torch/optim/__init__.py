"""Optimizers (port of ``repro.optim``): AdamW (+ factored second moment),
schedules, clipping, decay masks."""
from .adamw import (NO_DECAY_KEYS, OptimConfig, apply_updates, decay_mask,
                    global_norm, init_opt_state, lr_schedule)

__all__ = ["NO_DECAY_KEYS", "OptimConfig", "apply_updates", "decay_mask",
           "global_norm", "init_opt_state", "lr_schedule"]
