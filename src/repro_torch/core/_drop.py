"""Scatters that discard writes aimed one row past the end.

The JAX package scatters with ``mode="drop"``: a write whose row index is
out of range vanishes. Its callers use that on purpose, aiming the writes
they want discarded at row ``len(t)`` (one past the last, and so one past
a resident sentinel row where the array has one). Torch raises on such an
index, and masking the writes out with a boolean index would sync the
host. So these helpers scatter into a copy one row longer and slice it
off: no host sync, and the sentinel row is never written.
"""
from __future__ import annotations

import torch


def _padded(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def set_drop(t: torch.Tensor, index: tuple, vals) -> torch.Tensor:
    """``t.at[index].set(vals, mode="drop")`` for an index tuple whose first
    component lies in ``[0, len(t)]``; returns a new tensor."""
    pad = _padded(t)
    pad.index_put_(index, torch.as_tensor(vals, dtype=t.dtype, device=t.device))
    return pad[:-1]


def add_drop(t: torch.Tensor, index: tuple, vals) -> torch.Tensor:
    """``t.at[index].add(vals, mode="drop")``, same index contract."""
    pad = _padded(t)
    pad.index_put_(
        index, torch.as_tensor(vals, dtype=t.dtype, device=t.device),
        accumulate=True,
    )
    return pad[:-1]
