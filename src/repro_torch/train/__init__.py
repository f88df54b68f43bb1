"""Training substrate of the LM (port of ``repro.train``): AdamW and the
microbatched train step."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "make_train_step"]
