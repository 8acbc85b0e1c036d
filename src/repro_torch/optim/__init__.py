"""Optimizer and schedules: the JAX package's AdamW and warmup-cosine."""
from repro_torch.optim.adamw import (
    AdamWConfig, OptState, global_norm, init, update,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "update",
           "warmup_cosine"]
