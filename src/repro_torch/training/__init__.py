"""The LLM trainer on one device, counterpart of `repro.training`."""
from .trainer import (SYNC_MODES, TrainConfig, Trainer, init_train_state,
                      make_train_step, train_state_from_params)

__all__ = ["SYNC_MODES", "TrainConfig", "Trainer", "init_train_state",
           "make_train_step", "train_state_from_params"]
