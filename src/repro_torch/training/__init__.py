"""Training (PyTorch port of ``repro.training``): AdamW, the train step,
checkpoints, fault tolerance and synthetic data."""
from .checkpoint import CheckpointManager
from .optimizer import adamw_init, adamw_update, clip_by_global_norm
from .train_step import make_train_step

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "make_train_step", "CheckpointManager"]
