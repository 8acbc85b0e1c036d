"""Optimizer and schedules: the JAX package's AdamW (with its ZeRO-1
state specs, and the ZeRO-1 step per rank) and warmup-cosine."""
from repro_torch.optim.adamw import (
    AdamWConfig, OptState, global_norm, init, state_specs, update,
    zero1_gather, zero1_init, zero1_spec, zero1_update,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "state_specs",
           "update", "warmup_cosine", "zero1_gather", "zero1_init",
           "zero1_spec", "zero1_update"]
