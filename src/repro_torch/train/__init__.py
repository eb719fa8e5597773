"""Training: AdamW, the train step and the fault-tolerant trainer (after
``repro.train``)."""

from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         cosine_schedule)
from repro_torch.train.train_step import (TrainState, make_train_state,
                                          train_step)

__all__ = [
    "adamw_init", "adamw_update", "cosine_schedule",
    "TrainState", "make_train_state", "train_step",
]
