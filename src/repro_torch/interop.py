"""Carry state between the JAX package and this one, through numpy.

A state crosses as a dict (nested for the engine) of numpy arrays keyed by
the NamedTuple field names, which both packages share. :func:`to_numpy`
turns any NamedTuple state of either package into that form; the
``*_from_numpy`` functions build this package's states from it on a
chosen device. Every array is COPIED on the way: ``np.asarray`` of a JAX
array is a read-only view of JAX's buffer, and ``torch.from_numpy`` would
share that memory, so an in-place commit here would write into the JAX
state a test compares against.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cpoll as cp
from repro_torch.core import engine as eng
from repro_torch.core import kvstore as kv
from repro_torch.core import ringbuf as rb
from repro_torch.core import scheduler as sched


def to_numpy(state):
    """A NamedTuple state (of tensors or of JAX arrays) as a nested dict of
    numpy arrays, every array a fresh copy. Plain tuples and lists become
    lists; other leaves convert with ``np.array``."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return {k: to_numpy(v) for k, v in state._asdict().items()}
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return [to_numpy(v) for v in state]
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy().copy()
    return np.array(state, copy=True)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _named(cls, d, device):
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def kv_state_from_numpy(d, device) -> kv.KVState:
    return _named(kv.KVState, d, device)


def engine_state_from_numpy(d, device) -> eng.EngineState:
    """An ``EngineState`` serving the KVS, from its nested dict."""
    return eng.EngineState(
        req=_named(rb.RingState, d["req"], device),
        resp=_named(rb.RingState, d["resp"], device),
        cpoll=_named(cp.CpollState, d["cpoll"], device),
        sched=_named(sched.SchedState, d["sched"], device),
        app=kv_state_from_numpy(d["app"], device),
        **{f: _tensor(d[f], device)
           for f in ("steps", "served", "timed_out", "shed")},
    )
