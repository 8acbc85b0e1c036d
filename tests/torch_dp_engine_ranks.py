"""The cases of ``test_torch_dp_engine.py`` and their per-rank bodies: the
LM engine (``launch.serve.build_engine``, dense or paged, and the paged
engine's swap service) on each rank of a ``(data, model)`` mesh, its
blocks of the JAX package's padded-plan params, the seeded requests, run
until every request completes, with the engine state after every step
back as numpy arrays. Module-level functions (the ``spawn`` start method
pickles them by name) that import only torch, numpy and the port; the
JAX side imports the case table and the driver loop from here too."""
from __future__ import annotations

import shutil
import tempfile

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
VLM, HYBRID, SSM = "qwen2-vl-7b", "hymba-1.5b", "rwkv6-1.6b"
ENGINE = dict(num_queues=2, capacity=8, prompt_len=8, gen_len=6, slots=4,
              admit_per_step=2, cache_len=16, kernel_backend="ref")
PAGED = dict(ENGINE, paged=True, page_size=4)
# the swap service: pages of 2 tokens, a pool of two worst-case requests
# (mppr 7) for 4 slots, a host tier of the 3 victims the engine may need
# to park (the config's floor): decode stalls, and the service evicts
# and restores
MPPR = 7
SWAP = dict(PAGED, page_size=2, num_pages=2 * MPPR, host_pages=3 * MPPR)
REQUESTS = 6
SWAP_REQUESTS = 8
MOE_CF = 1.0  # the admission prefills drop assignments at it

# name -> the arch, the mesh, the engine, the config's overrides, the
# context's knobs, and whether the swap service runs before every step
CASES = {
    "dense_2x1": dict(arch=DENSE, mesh=(2, 1), engine=ENGINE),
    "dense_paged_2x1": dict(arch=DENSE, mesh=(2, 1), engine=PAGED),
    "moe_2x1": dict(arch=MOE, mesh=(2, 1), engine=ENGINE,
                    cfg={"capacity_factor": MOE_CF}),
    "moe_paged_2x1": dict(arch=MOE, mesh=(2, 1), engine=PAGED,
                          cfg={"capacity_factor": MOE_CF}),
    "vlm_2x1": dict(arch=VLM, mesh=(2, 1), engine=ENGINE),
    "hybrid_2x1": dict(arch=HYBRID, mesh=(2, 1), engine=ENGINE),
    # three slots over two data ranks: the rows are replicated
    "dense_odd_slots_2x1": dict(arch=DENSE, mesh=(2, 1),
                                engine=dict(ENGINE, slots=3)),
    "swap_2x1": dict(arch=DENSE, mesh=(2, 1), engine=SWAP, swap=True),
    "dense_2x2": dict(arch=DENSE, mesh=(2, 2), engine=ENGINE),
    "dense_paged_2x2": dict(arch=DENSE, mesh=(2, 2), engine=PAGED),
    "moe_paged_2x2": dict(arch=MOE, mesh=(2, 2), engine=PAGED,
                          cfg={"capacity_factor": MOE_CF}),
    "moe_ep_2x2": dict(arch=MOE, mesh=(2, 2), engine=ENGINE,
                       ep_shardmap=True, cfg={"capacity_factor": MOE_CF}),
    "moe_ep_paged_2x2": dict(arch=MOE, mesh=(2, 2), engine=PAGED,
                             ep_shardmap=True,
                             cfg={"capacity_factor": MOE_CF}),
    "ssm_2x2": dict(arch=SSM, mesh=(2, 2), engine=ENGINE),
    "swap_2x2": dict(arch=DENSE, mesh=(2, 2), engine=SWAP, swap=True),
    "swap_1x2": dict(arch=DENSE, mesh=(1, 2), engine=SWAP, swap=True),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})


def case_config(case):
    spec = CASES[case]
    return reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))


def case_context(case, mesh):
    return lmesh.make_context(mesh, case_config(case))._replace(
        ep_shardmap=CASES[case].get("ep_shardmap", False))


def requests(case, vocab):
    """The case's prompts (n, prompt_len) and caps (n,), int32."""
    e = CASES[case]["engine"]
    n = SWAP_REQUESTS if CASES[case].get("swap") else REQUESTS
    rng = np.random.default_rng(11)
    prompts = rng.integers(1, vocab, (n, e["prompt_len"]))
    caps = rng.integers(1, e["gen_len"] + 1, n)
    return prompts.astype(np.int32), caps.astype(np.int32)


def run_engine(case, step, state, inject, snap, swap=None):
    """Inject the case's requests (a queue each, in turn), then step (the
    swap service first, when given) until all complete; ``snap(state)``
    after every step. Returns the final state."""
    e = CASES[case]["engine"]
    prompts, caps = requests(case, 128)
    n, q = len(prompts), e["num_queues"]
    for lo in range(0, n, q):
        m = len(prompts[lo:lo + q])
        state = inject(state, np.arange(m, dtype=np.int32),
                       prompts[lo:lo + q], caps[lo:lo + q])
    for _ in range(n * (e["gen_len"] + 4)):
        if swap is not None:
            state = swap(state)
        state = step(state)
        snap(state)
        if int(state.completed) == n:
            break
    return state


def _case(z, mesh, case):
    cfg = case_config(case)
    ctx = case_context(case, mesh)
    params = param_blocks(interop.lm_params_from_numpy(
        tpr._unflat(z, f"{case}/params/"), "cpu"), ctx)
    ecfg = eng.LMEngineConfig(**CASES[case]["engine"])
    step, state = serve.build_engine(cfg, ctx, ecfg, params, "cpu")
    swap = cold = mgr = None
    if CASES[case].get("swap"):
        swap, cold, _ = eng.make_swap_service(ecfg, cfg, ctx)
        mgr = _flusher(cold)
    steps, colds = [], []

    def snap(s):
        steps.append(interop.to_numpy(s))
        if cold is not None:
            colds.append({k: v.numpy() for k, v in
                          cold.state_arrays().items()})
            mgr.flush(s)

    def inject(s, qids, p, c):
        return eng.lm_inject(s, torch.from_numpy(qids), p, gen_caps=c)

    assert cfg.vocab_size == 128
    state = run_engine(case, step, state, inject, snap, swap)
    out = {"steps": steps}
    if cold is not None:
        out.update(cold=colds, evictions=cold.evictions,
                   restores=cold.restores,
                   parks=[s for s in range(ecfg.slots) if cold.parks(s)],
                   flush=_recovered(mgr, state, cold, ecfg, cfg, ctx))
    return out


def _flusher(cold):
    """A ``fault.DurabilityManager`` flushing this rank's paged state and
    cold tier after every step (a full snapshot, then deltas) into a new
    directory."""
    from repro_torch.fault import DurabilityConfig, DurabilityManager

    d = tempfile.mkdtemp(prefix="dp_flush_")
    return DurabilityManager(DurabilityConfig(d, every=1, mode="delta"),
                             cold=cold)


def _recovered(mgr, state, cold, ecfg, cfg, ctx):
    """Recover this rank's flushes into a fresh state and a fresh tier of
    its slots: whether every leaf of both came back bit for bit."""
    from repro_torch.fault import recovery as frec
    from repro_torch.serving import kv_cache as pk

    mgr.wait()
    d = mgr.cfg.directory
    fresh_cold = pk.HostColdTier(cold.cfg, cold.host_pages,
                                 dtype=cold.dtype, slots=cold.slots)
    like = eng.lm_make_paged(ecfg, cfg, ctx, "cpu")
    got, _ = frec.recover(d, like, cold=fresh_cold)
    same = _bits_equal(interop.to_numpy(state), interop.to_numpy(got)) \
        and _bits_equal(
            {k: v.numpy() for k, v in cold.state_arrays().items()},
            {k: v.numpy() for k, v in fresh_cold.state_arrays().items()})
    kinds = [r.kind for r in mgr.records]
    shutil.rmtree(d, ignore_errors=True)
    return {"bit_equal": bool(same), "records": len(kinds),
            "deltas": kinds.count("delta")}


def _bits_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k])
                                            for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def dp_rank(rank, world, params_path, shape, cases):
    """Every case of one mesh on this rank: its (data, model) coordinates
    and each case's per-step states."""
    torch.set_grad_enabled(False)
    z = np.load(params_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    return (mesh.coord("data"), mesh.coord("model"),
            {c: _case(z, mesh, c) for c in cases})


# the swap service with a host-memory budget of BUDGET_PAGES[i] parked
# pages a rank (the first too small for any victim: every eviction
# refused, on every rank, though only the victim's rank parks it; the
# second enough for one)
BUDGET_CASE, BUDGET_PAGES = "swap_2x1", (2, 8)


@torch.no_grad()
def budget_run(mesh, pages):
    """:data:`BUDGET_CASE`'s engine on ``mesh`` (None: one process) from
    the port's seeded params, the swap service charging a
    ``placement.MemoryBudget`` of ``pages`` parked pages before every
    step, over the case's requests (:func:`run_engine`). Returns (every
    integer leaf of the state after each step, the tier's evictions,
    restores)."""
    from repro_torch.core import placement
    from repro_torch.models import model
    from repro_torch.parallel.sharding import local_context
    from repro_torch.serving import kv_cache as pk

    cfg = case_config(BUDGET_CASE)
    ctx = local_context() if mesh is None else case_context(BUDGET_CASE,
                                                            mesh)
    ecfg = eng.LMEngineConfig(**CASES[BUDGET_CASE]["engine"])
    step, state = serve.build_engine(cfg, ctx, ecfg,
                                     model.init_params(5, cfg, ctx, "cpu"),
                                     "cpu")
    page_bytes = pk.HostColdTier(eng.lm_paged_kv_config(ecfg, cfg, ctx),
                                 1).page_bytes
    swap, cold, _ = eng.make_swap_service(
        ecfg, cfg, ctx, budget=placement.MemoryBudget(
            dram_bytes=pages * page_bytes, nvm_bytes=0))
    ints = []

    def snap(s):
        ints.append(_int_leaves(interop.to_numpy(s)))

    def inject(s, qids, p, c):
        return eng.lm_inject(s, torch.from_numpy(qids), p, gen_caps=c)

    run_engine(BUDGET_CASE, step, state, inject, snap, swap)
    return ints, cold.evictions, cold.restores


def _int_leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return {} if tree.dtype.kind == "f" else {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_int_leaves(v, f"{prefix}/{k}"))
    return out


def budget_rank(rank, world, pages):
    """:func:`budget_run` on this rank of a (world, 1) mesh."""
    return budget_run(lmesh.make_test_mesh((world, 1), ("data", "model")),
                      pages)


# ---------------------------------------------------------------------------
# On the card: data ranks that share it (gloo, host-staged)
# ---------------------------------------------------------------------------

CUDA_PROMPTS = (4, 128)  # prompts x tokens (a flash block of 128)
CUDA_STEPS = 3
CUDA_PAGE = 16


def cuda_paged_decode(params, cfg, ctx, prompts):
    """The paged path as the engine over data ranks runs it, on the card:
    the whole batch's prefill on every rank (``model.whole_batch``, the
    flash kernel) landed in a pool whose allocator takes every row and
    whose pages this rank writes for its rows, then CUDA_STEPS greedy
    ``paged_decode_step``s (``paged_attention_stats`` on the rank's rows;
    the tokens gathered over the data axis). Returns the logits of this
    rank's rows each step, on the host."""
    from repro_torch.models import model
    from repro_torch.models.layers import dtype_of
    from repro_torch.parallel import collectives as coll
    from repro_torch.serving import kv_cache as pk

    b, s = prompts.shape
    rows = model.batch_rows(b, ctx)
    maxp = -(-(s + CUDA_STEPS) // CUDA_PAGE)
    pcfg = model.make_paged_kv_config(cfg, ctx, num_pages=b * maxp,
                                      page_size=CUDA_PAGE,
                                      max_pages_per_seq=maxp)
    kv = pk.make(pcfg, batch=b, dtype=dtype_of(cfg.dtype), device="cuda")
    k, v, lg = model.prefill_kv(params, prompts, cfg,
                                model.whole_batch(ctx), kernel_backend="cuda")
    ids = torch.arange(b, dtype=torch.int32, device="cuda")
    every = torch.ones((b,), dtype=torch.bool, device="cuda")
    kv, _ = pk.prefill_into_pages(kv, pcfg, ids, k, v, every,
                                  own=(ids >= rows.start) & (ids < rows.stop))
    out = [lg[rows].cpu()]
    tok = lg.argmax(-1).to(torch.int32)
    for _ in range(CUDA_STEPS):
        kv, lg, _ = model.paged_decode_step(params, tok, kv, pcfg, cfg, ctx,
                                            kernel_backend="cuda")
        out.append(lg.cpu())
        tok = coll.data_gather(lg.argmax(-1).to(torch.int32), ctx)
    return out


def cuda_dp_paged_rank(rank, world, prompts):
    """The seeded params of ``torch_tp_ranks.cuda_tp_config`` on this rank
    of a (world, 1) mesh on the card: :func:`cuda_paged_decode`'s logits,
    the kernels' launches and the rank's rows."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model

    torch.cuda.set_device(0)
    torch.set_grad_enabled(False)
    cfg = tpr.cuda_tp_config()
    mesh = lmesh.make_test_mesh((world, 1), ("data", "model"))
    ctx = lmesh.make_context(mesh, cfg)
    params = model.init_params(3, cfg, ctx, "cuda")
    fa.reset_launches()
    pa.reset_launches()
    logits = cuda_paged_decode(params, cfg, ctx,
                               torch.from_numpy(prompts).cuda())
    rows = model.batch_rows(prompts.shape[0], ctx)
    return ([x.float().numpy() for x in logits],
            {**fa.launches, **pa.launches}, (rows.start, rows.stop))
