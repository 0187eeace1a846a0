"""Optimizers and learning-rate schedules, counterparts of `repro.optim`."""
from .optimizers import (adam, adamw, apply_updates, clip_by_global_norm,
                         clip_scale, global_norm, sgd)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = ["adam", "adamw", "sgd", "apply_updates", "global_norm",
           "clip_by_global_norm", "clip_scale", "constant", "cosine_decay",
           "linear_warmup_cosine"]
