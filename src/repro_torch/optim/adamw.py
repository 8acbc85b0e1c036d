"""AdamW over trees of tensors, the JAX package's optimizer
(``repro/optim/adamw.py``): global-norm clipping, bias-corrected moments
kept in ``state_dtype`` (f32 by default, bf16 to halve them), weight
decay on the leaves of two or more dimensions only, every update in f32.
(``torch.optim.AdamW`` is another function: no global clip, decay on
every leaf, moments in the parameter's dtype.) The ZeRO-1 state specs
need a mesh and are not here."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.tree import leaves, tree_map, unzip

F32 = torch.float32


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # () int32: updates applied


def init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype``, step 0, on the params'
    device."""
    dt = dtype_of(cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (f32), leaves in order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def update(grads, state: OptState, params, lr, cfg: AdamWConfig):
    """One AdamW step. ``lr`` is a float or an f32 scalar tensor. Returns
    (new params, new state, {"grad_norm"}); nothing is written in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    dt = dtype_of(cfg.state_dtype)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        u = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
        if p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        new_p = p.float() - lr * u
        return new_p.to(p.dtype), m1.to(dt), v1.to(dt)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = unzip(out, 3)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm}
