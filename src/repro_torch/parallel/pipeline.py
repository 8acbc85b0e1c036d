"""GPipe-style pipeline parallelism over the pod axis — the JAX package's
``repro/parallel/pipeline.py``, per rank.

Cross-pod links are the slow ones, so the multi-pod decomposition puts
pipeline stages at pod boundaries: activations cross once a microbatch a
stage boundary, instead of every gradient in a pod-spanning all-reduce.

:func:`pipeline_apply` runs on every rank of a running mesh with a pod
axis: this rank's stage holds its contiguous block of the L-stacked
layers, and the schedule is the classic fill-drain, ``M + P - 1`` ticks;
at tick t stage s runs microbatch ``t - s``, and the boundary transfer is
one ``ppermute`` a tick. The last stage's outputs are replicated over the
pod axis by a ``psum`` (every other stage contributes zeros).

Positions must be batch-broadcastable ((1, S) or (3, 1, S)): token
positions do not vary across the microbatched rows.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import ParallelContext


def pipeline_apply(layers, x, cfg: ModelConfig, ctx: ParallelContext,
                   positions, *, microbatches: int = 4, chunk: int = 512):
    """``layers``: this stage's block of the stacked layer params (the
    leading L dim split over the pod axis: L / P layers); ``x``: (B_loc,
    S, D), this rank's rows (split over the data axes, equal over pod).
    Returns y shaped like ``x``, equal on every stage."""
    mesh, pod = ctx.mesh, ctx.pod_axis
    assert mesh is not None and pod is not None
    p_stages = mesh.shape[pod]
    assert cfg.num_layers % p_stages == 0, "layers must split evenly"
    stage_cfg = cfg.replace(num_layers=cfg.num_layers // p_stages)
    plan = tf.plan_for(cfg, ctx)
    m = microbatches
    stage = coll.axis_index(mesh, pod)
    b = x.shape[0]
    assert b % m == 0, "local batch must divide microbatches"
    mb = x.reshape(m, b // m, *x.shape[1:])

    buf = torch.zeros_like(mb[0])
    outs = torch.zeros_like(mb)
    for t in range(m + p_stages - 1):
        m_idx = t - stage
        active = 0 <= m_idx < m
        if active:
            inp = mb[m_idx] if stage == 0 else buf
            y, _ = tf.stack_apply(layers, inp, stage_cfg, plan,
                                  ctx._replace(mesh=None), positions,
                                  chunk=chunk)
            if stage == p_stages - 1:
                outs[m_idx] = y
        else:
            y = torch.zeros_like(buf)  # an idle stage sends zeros
        buf = coll.ppermute(y, mesh, pod,
                            [(i, i + 1) for i in range(p_stages - 1)])
    # replicate the last stage's result (one broadcast a step)
    outs = coll.psum(outs, mesh, pod)
    return outs.reshape(x.shape)
