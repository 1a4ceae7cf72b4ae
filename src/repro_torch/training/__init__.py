from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.training.train_step import TrainConfig, make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "TrainConfig", "make_train_step"]
