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

from repro_torch import optim
from repro_torch.core import cpoll as cp
from repro_torch.core import engine as eng
from repro_torch.core import kvstore as kv
from repro_torch.core import ringbuf as rb
from repro_torch.core import scheduler as sched
from repro_torch.core import transaction as tx
from repro_torch.models import model as lm
from repro_torch.serving import kv_cache as pk


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
        t = state.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16 of its own; ml_dtypes' is the one JAX
            # arrays convert to, so both sides compare as the same dtype
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
        return t.numpy().copy()
    return np.array(state, copy=True)


def _tensor(x, device) -> torch.Tensor:
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


def _named(cls, d, device):
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def kv_state_from_numpy(d, device) -> kv.KVState:
    return _named(kv.KVState, d, device)


def replica_state_from_numpy(d, device) -> tx.ReplicaState:
    """A ``ReplicaState``: one replica, or a chain (leading replica axis)."""
    return _named(tx.ReplicaState, d, device)


def dlrm_params_from_numpy(d, device) -> dict:
    """DLRM params ``{"tables", "bottom": [{"w", "b"}, ...], "top": [...]}``
    with every array's dtype kept (bf16 included)."""
    return {
        "tables": _tensor(d["tables"], device),
        **{part: [{k: _tensor(v, device) for k, v in layer.items()}
                  for layer in d[part]]
           for part in ("bottom", "top")},
    }


def engine_state_from_numpy(d, device,
                            app_from_numpy=kv_state_from_numpy
                            ) -> eng.EngineState:
    """An ``EngineState`` from its nested dict. ``app_from_numpy(d, device)``
    builds the app's state: :func:`kv_state_from_numpy` (the default) for
    the KVS, :func:`replica_state_from_numpy` for a TX chain,
    :func:`dlrm_params_from_numpy` for DLRM."""
    return eng.EngineState(
        req=_named(rb.RingState, d["req"], device),
        resp=_named(rb.RingState, d["resp"], device),
        cpoll=_named(cp.CpollState, d["cpoll"], device),
        sched=_named(sched.SchedState, d["sched"], device),
        app=app_from_numpy(d["app"], device),
        **{f: _tensor(d[f], device)
           for f in ("steps", "served", "timed_out", "shed")},
    )


def lm_params_from_numpy(d, device) -> dict:
    """LM params (the JAX package's nested tree: ``embed``, L-stacked
    ``layers``, ``final_norm``[, ``lm_head``]) with every array's dtype
    kept, bf16 included: any family's subtrees (``attn``, ``mlp``,
    ``moe`` with its f32 router, ``tmix``/``cmix``, ``ssm``)."""
    if isinstance(d, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in d.items()}
    return _tensor(d, device)


def opt_state_from_numpy(d, device) -> optim.OptState:
    """An AdamW ``OptState`` (moments ``m``/``v`` shaped like the params,
    ``step``) with every dtype kept: f32 or bf16 moments, int32 step."""
    return optim.OptState(m=lm_params_from_numpy(d["m"], device),
                          v=lm_params_from_numpy(d["v"], device),
                          step=_tensor(d["step"], device))


def paged_kv_state_from_numpy(d, device) -> pk.PagedKVState:
    return _named(pk.PagedKVState, d, device)


def decode_state_from_numpy(d, device) -> lm.DecodeState:
    """A dense ``models.DecodeState`` (L-stacked ring caches)."""
    return lm.DecodeState(layers=lm_params_from_numpy(d["layers"], device),
                          pos=_tensor(d["pos"], device))


def lm_engine_state_from_numpy(d, device) -> eng.LMEngineState:
    """An ``LMEngineState`` from its nested dict; the decode side is a
    ``PagedKVState`` when it has page fields, else a ``DecodeState``."""
    dec = d["decode"]
    decode = (paged_kv_state_from_numpy(dec, device) if "k_pages" in dec
              else decode_state_from_numpy(dec, device))
    return eng.LMEngineState(
        req=_named(rb.RingState, d["req"], device),
        resp=_named(rb.RingState, d["resp"], device),
        cpoll=_named(cp.CpollState, d["cpoll"], device),
        sched=_named(sched.SchedState, d["sched"], device),
        decode=decode,
        **{f: _tensor(d[f], device) for f in eng.LMEngineState._fields
           if f not in ("req", "resp", "cpoll", "sched", "decode")},
    )
