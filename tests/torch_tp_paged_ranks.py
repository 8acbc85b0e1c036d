"""The cases of ``test_torch_tp_paged.py`` and their per-rank bodies: the
paged LM engine (``launch.serve.build_engine`` with ``paged=True``) on
each rank of a ``(1, tp)`` mesh, its blocks of the JAX package's
padded-plan params, the requests of ``torch_tp_ranks``, run until every
request completes; the whole engine state back as numpy arrays.
Module-level functions (the ``spawn`` start method pickles them by
name) that import only torch, numpy and the port."""
from __future__ import annotations

import numpy as np
import torch

import torch_tp_ranks as tpr
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve
from repro_torch.parallel.sharding import param_blocks

DENSE, MOE = tpr.DENSE, tpr.MOE
# the engine of torch_tp_ranks on the page pool, the plain page walk
ENGINE = dict(tpr.ENGINE, paged=True, kernel_backend="ref")
MOE_CF = 1.0  # the admission prefill drops assignments at it
# name -> the arch, the mesh, the config's overrides, the context's knobs.
# The MoE cases run GSPMD moe_apply (the admitted prefix, its capacity
# the padded batch's) and the EP shard_map dispatch (the whole padded
# batch: its send buffers are sized from each model rank's block)
CASES = {
    "dense_1x2": dict(arch=DENSE, mesh=(1, 2)),
    "dense_1x4": dict(arch=DENSE, mesh=(1, 4)),
    "moe_gspmd_1x2": dict(arch=MOE, mesh=(1, 2),
                          cfg={"capacity_factor": MOE_CF}),
    "moe_ep_shardmap_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True,
                                cfg={"capacity_factor": MOE_CF}),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})


def case_config(case):
    spec = CASES[case]
    return reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))


def case_context(case, mesh):
    return lmesh.make_context(mesh, case_config(case))._replace(
        ep_shardmap=CASES[case].get("ep_shardmap", False))


def run_engine(step, state, inject, prompts, caps, q, n):
    """Inject the requests ``q`` at a time, then step until ``n`` have
    completed (at most n x gen_len steps)."""
    for lo in range(0, len(prompts), q):
        m = len(prompts[lo:lo + q])
        state = inject(state, np.arange(m, dtype=np.int32),
                       prompts[lo:lo + q], caps[lo:lo + q])
    for _ in range(n * ENGINE["gen_len"]):
        state = step(state)
        if int(state.completed) == n:
            break
    return state


def _engine(z, mesh, case):
    cfg = case_config(case)
    ctx = case_context(case, mesh)
    params = param_blocks(interop.lm_params_from_numpy(
        tpr._unflat(z, f"{case}/params/"), "cpu"), ctx)
    ecfg = eng.LMEngineConfig(**ENGINE)
    step, state = serve.build_engine(cfg, ctx, ecfg, params, "cpu")
    prompts, caps = tpr.engine_requests(cfg.vocab_size)

    def inject(s, qids, p, c):
        return eng.lm_inject(s, torch.from_numpy(qids), p, gen_caps=c)

    state = run_engine(step, state, inject, prompts, caps,
                       ecfg.num_queues, tpr.ENGINE_REQUESTS)
    return interop.to_numpy(state)


def paged_rank(rank, world, params_path, shape, cases):
    """Every case of one mesh on this rank: its model coordinate and each
    case's final engine state."""
    torch.set_grad_enabled(False)
    z = np.load(params_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    return mesh.coord("model"), {c: _engine(z, mesh, c) for c in cases}
