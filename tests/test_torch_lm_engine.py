"""The LM serving slice of the PyTorch port against the JAX package: the
same seeded prompts through JAX's engine and the port's (dense ring
caches, the paged pool with the plain stats walk, and the paged pool with
a forced host-tier eviction), on reduced f32 configs of qwen2.5-14b (GQA),
qwen1.5-0.5b (tied embeddings), qwen3-moe-30b-a3b (MoE) and qwen2-vl-7b
(M-RoPE); hymba-1.5b (attention + Mamba, prompts longer than its window)
and rwkv6-1.6b (attention-free) run the dense engine only, as JAX keeps
recurrent state off the paged path. Greedy token streams must be equal,
page pools and recurrent states within 1e-5, every other state field
equal, and the pool must drain to empty."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import engine as jeng
from repro.core import ringbuf as jrb
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import init_params as jax_init_params
from repro.parallel.sharding import local_context as jax_local_context
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.core import ringbuf as rb
from repro_torch.launch.serve import build_engine
from repro_torch.parallel.sharding import local_context
from repro_torch.serving import kv_cache as pk

P, G = 8, 6
CPU = torch.device("cpu")
POOL_TOL = 1e-5


def _jax_setup(arch, **kw):
    cfg = jax_reduced(jax_get_config(arch)).replace(dtype="float32", **kw)
    ctx = jax_local_context()
    return cfg, ctx, jax_init_params(jax.random.key(0), cfg, ctx)


def _torch_setup(arch, jparams, **kw):
    cfg = reduced(get_config(arch)).replace(dtype="float32", **kw)
    params = interop.lm_params_from_numpy(interop.to_numpy(jparams), CPU)
    return cfg, local_context(), params


def _ecfg(mod, **kw):
    base = dict(num_queues=4, capacity=8, prompt_len=P, gen_len=G, slots=4,
                admit_per_step=2, cache_len=P + G + 2, page_size=4)
    base.update(kw)
    return mod.LMEngineConfig(**base)


class _Jax:
    eng, rb = jeng, jrb

    @staticmethod
    def arr(x):
        return jnp.asarray(x)

    @staticmethod
    def np(x):
        return np.asarray(x)


class _Torch:
    eng, rb = eng, rb

    @staticmethod
    def arr(x):
        return torch.as_tensor(np.asarray(x))

    @staticmethod
    def np(x):
        return x.numpy()


def _serve(fw, step, state, ecfg, prompts, swap=None, max_ticks=400):
    """Drive an engine with at most one request in flight per queue (so
    per-queue FIFO matching of responses to prompts is exact). Returns
    ({prompt: tokens}, final state, ticks)."""
    got, inflight = {}, {q: None for q in range(ecfg.num_queues)}
    sent = 0
    for tick in range(max_ticks):
        for q in range(ecfg.num_queues):
            if sent < len(prompts) and inflight[q] is None:
                state = fw.eng.lm_inject(
                    state, fw.arr(np.asarray([q], np.int32)),
                    fw.arr(prompts[sent][None]),
                    gen_caps=fw.arr(np.zeros((1,), np.int32)))
                inflight[q] = prompts[sent]
                sent += 1
        state = step(state)
        if swap is not None:
            state = swap(state)
        avail = fw.np(fw.rb.available(state.resp))
        for q in range(ecfg.num_queues):
            if avail[q]:
                assert avail[q] == 1
                ent = fw.np(fw.rb.peek(state.resp,
                                       fw.arr(np.asarray([q], np.int32)),
                                       fw.arr(np.asarray([0], np.int32))))[0]
                n = int(ent[0])
                assert 1 <= n <= ecfg.gen_len and not ent[1 + n:].any()
                got[tuple(inflight[q].tolist())] = ent[1:1 + n].tolist()
                inflight[q] = None
        if avail.sum():
            state = state._replace(resp=fw.rb.pop(
                state.resp, fw.arr(np.arange(ecfg.num_queues, dtype=np.int32)),
                fw.arr(avail.astype(np.int32))))
        if len(got) == len(prompts):
            return got, state, tick + 1
    raise AssertionError(f"only {len(got)} of {len(prompts)} completed")


def _compare_states(jstate, tstate):
    """Every field equal; the page pools (or ring caches) within 1e-5."""
    a, b = interop.to_numpy(jstate), interop.to_numpy(tstate)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
            return
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=POOL_TOL, atol=POOL_TOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(y, x, err_msg=path)

    walk(a, b, "state")


ARCHS = ["qwen2.5-14b", "qwen1.5-0.5b", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
         "hymba-1.5b", "rwkv6-1.6b"]
DENSE_ONLY = ("hymba-1.5b", "rwkv6-1.6b")
PROMPT_LEN = {"hymba-1.5b": 12}  # past the reduced window of 8


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_jax_streams_and_state(arch):
    """Dense, paged (plain stats walk) and paged with a host-tier eviction
    (the recurrent families: dense only): token streams equal to JAX's,
    states equal (pools and recurrent states within 1e-5), pools
    drained."""
    jcfg, jctx, jparams = _jax_setup(arch)
    tcfg, tctx, tparams = _torch_setup(arch, jparams)
    plen = PROMPT_LEN.get(arch, P)
    shape = dict(prompt_len=plen, cache_len=plen + G + 2)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, jcfg.vocab_size, (6, plen)).astype(np.int32)
    mppr = jeng.lm_max_pages_per_request(_ecfg(jeng, paged=True, **shape))
    arms = {
        "dense": dict(paged=False),
        "paged": dict(paged=True, kernel_backend="ref"),
        "paged_evict": dict(paged=True, kernel_backend="ref", num_pages=mppr,
                            host_pages=3 * mppr, expected_gen_len=G // 2),
    }
    if arch in DENSE_ONLY:
        arms = {"dense": arms["dense"]}
    streams = {}
    for name, kw in arms.items():
        kw = {**shape, **kw}
        jcf, tcf = _ecfg(jeng, **kw), _ecfg(eng, **kw)
        jstep, jstate = jax_build_engine(jcfg, jctx, jcf, jparams)
        tstep, tstate = build_engine(tcfg, tctx, tcf, tparams, CPU)
        jswap = tswap = jcold = tcold = None
        if kw.get("host_pages"):
            jswap, jcold, _ = jeng.make_swap_service(jcf, jcfg, jctx)
            tswap, tcold, _ = eng.make_swap_service(tcf, tcfg, tctx)
        jgot, jfinal, jticks = _serve(_Jax, jstep, jstate, jcf, prompts, jswap)
        tgot, tfinal, tticks = _serve(_Torch, tstep, tstate, tcf, prompts,
                                      tswap)
        assert tgot == jgot, name
        assert tticks == jticks, name
        _compare_states(jfinal, tfinal)
        # the converters carry JAX's whole engine state across exactly
        _compare_states(jfinal, interop.lm_engine_state_from_numpy(
            interop.to_numpy(jfinal), CPU))
        streams[name] = tgot
        if kw["paged"]:
            pcfg = eng.lm_paged_kv_config(tcf, tcfg, tctx)
            assert int(pk.pages_in_use(tfinal.decode, pcfg)) == 0
            assert bool((tfinal.decode.page_table < 0).all())
            assert bool((tfinal.decode.residency == pk.HOT).all())
        if tcold is not None:
            assert tcold.evictions >= 1, "the tiny pool must force an eviction"
            assert (tcold.evictions, tcold.restores) == (
                jcold.evictions, jcold.restores)
            assert tcold.pages_used == 0
    assert all(s == streams["dense"] for s in streams.values())


def test_moe_paged_prefill_sizes_capacity_from_the_padded_batch():
    """MoE at capacity factor 0.5 through the paged engine, one request in
    flight at a time, so every admission step admits one prompt of an
    admission batch of two. The port prefills only that prompt, JAX the
    padded batch; with the capacity sized from the padded batch's count
    (the engine's repair) the token streams and states are JAX's. Sized
    from the admitted prompt alone, the capacity halves and the prefill
    differs (checked directly below)."""
    from repro_torch.models import prefill_kv

    arch, plen = "qwen3-moe-30b-a3b", 32
    jcfg, jctx, jparams = _jax_setup(arch, capacity_factor=0.5)
    tcfg, tctx, tparams = _torch_setup(arch, jparams, capacity_factor=0.5)
    kw = dict(num_queues=1, prompt_len=plen, cache_len=plen + G + 2,
              paged=True, kernel_backend="ref")
    jcf, tcf = _ecfg(jeng, **kw), _ecfg(eng, **kw)
    assert tcf.admit_per_step == 2
    prompts = np.random.default_rng(4).integers(
        1, jcfg.vocab_size, (3, plen)).astype(np.int32)
    jstep, jstate = jax_build_engine(jcfg, jctx, jcf, jparams)
    tstep, tstate = build_engine(tcfg, tctx, tcf, tparams, CPU)
    jgot, jfinal, jticks = _serve(_Jax, jstep, jstate, jcf, prompts)
    tgot, tfinal, tticks = _serve(_Torch, tstep, tstate, tcf, prompts)
    assert tgot == jgot and tticks == jticks
    _compare_states(jfinal, tfinal)

    one = torch.as_tensor(prompts[:1])
    _, _, padded = prefill_kv(tparams, one, tcfg, tctx,
                              capacity_tokens=tcf.admit_per_step * plen)
    _, _, own = prefill_kv(tparams, one, tcfg, tctx)
    assert not torch.allclose(own, padded, rtol=POOL_TOL, atol=POOL_TOL)
