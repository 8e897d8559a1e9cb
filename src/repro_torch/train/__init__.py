"""The training loop on one device (`trainer.py`)."""

from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

__all__ = ["Trainer", "TrainerConfig", "make_train_step"]
