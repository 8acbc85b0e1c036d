"""The port's recurrent mixers (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py``: the chunked GLA engine in both
modes at two chunk sizes, with a carried state and with a decay strong
enough to overflow a naive factorisation; the one-token step; RWKV6's time
and channel mix with and without carried state; the Mamba branch, whole
and token by token. Inputs are made with numpy from a seed, parameters
cross from JAX through ``interop``; f32, held to 1e-5 unless stated."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs, interop
from repro_torch.models import ssm

TOL = 1e-5
CPU = torch.device("cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(interop.to_numpy(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _gla_inputs(seed, b=2, s=37, h=2, dk=4, dv=6, decay=3.0, rwkv=True,
                carried=False):
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(2, b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    logw = -(rng.uniform(size=(b, s, h, dk)) * decay).astype(np.float32)
    u = (rng.normal(size=(h, dk)) * 0.3).astype(np.float32) if rwkv else None
    st = rng.normal(size=(b, h, dk, dv)).astype(np.float32) if carried \
        else None
    return q, k, v, logw, u, st


def _both(fn_j, fn_t, *arrays, **kw):
    """The same numpy inputs (None passes through) into JAX and the port."""
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    return fn_j(*j, **kw), fn_t(*t, **kw)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("chunk", [5, 16])
def test_chunked_gla_matches_jax(chunk, rwkv, carried):
    q, k, v, logw, u, st = _gla_inputs(chunk, rwkv=rwkv, carried=carried)

    def jfn(q, k, v, w, u, st, chunk):
        return jssm.chunked_gla(q, k, v, w, u, chunk=chunk, state=st)

    def tfn(q, k, v, w, u, st, chunk):
        return ssm.chunked_gla(q, k, v, w, u, chunk=chunk, state=st)

    (yj, sj), (yt, st_) = _both(jfn, tfn, q, k, v, logw, u, st, chunk=chunk)
    assert yt.dtype == torch.float32 and st_.dtype == torch.float32
    _close(yt, yj)
    _close(st_, sj)


def test_chunked_gla_chunk_and_block_invariance():
    """The chunk size and the number of chunks batched in one block leave
    the result as it was (the boundary-factored construction)."""
    q, k, v, logw, u, _ = _gla_inputs(7)
    t = [torch.from_numpy(a) for a in (q, k, v, logw, u)]
    ref_y, ref_s = ssm.chunked_gla(*t, chunk=4)
    for chunk in (1, 8, 37):
        y, s = ssm.chunked_gla(*t, chunk=chunk)
        torch.testing.assert_close(y, ref_y, rtol=5e-5, atol=5e-5)
        torch.testing.assert_close(s, ref_s, rtol=5e-5, atol=5e-5)
    keep = ssm.BLOCK_ELEMENTS
    try:
        ssm.BLOCK_ELEMENTS = 1  # one chunk a block
        y, s = ssm.chunked_gla(*t, chunk=4)
    finally:
        ssm.BLOCK_ELEMENTS = keep
    torch.testing.assert_close(y, ref_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, ref_s, rtol=TOL, atol=TOL)


def test_strong_decay_no_overflow():
    """log w = -8 a token sums to -512 over a 64-token chunk: finite, and
    JAX's values (tests/test_ssm.py::test_strong_decay_no_overflow)."""
    b, s, h, dk, dv = 1, 64, 1, 4, 4
    ones = np.ones((b, s, h, dk), np.float32)
    logw = np.full((b, s, h, dk), -8.0, np.float32)
    v = np.ones((b, s, h, dv), np.float32)
    (yj, sj), (yt, st) = _both(
        lambda *a: jssm.chunked_gla(*a, None, chunk=64),
        lambda *a: ssm.chunked_gla(*a, None, chunk=64), ones, ones, v, logw)
    assert bool(torch.isfinite(yt).all()) and bool(torch.isfinite(st).all())
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("rwkv", [False, True])
def test_gla_step_chain_matches_chunked_and_jax(rwkv):
    q, k, v, logw, u, _ = _gla_inputs(3, s=9, dv=4, decay=1.0, rwkv=rwkv)
    t = [None if a is None else torch.from_numpy(a)
         for a in (q, k, v, logw, u)]
    y_all, s_all = ssm.chunked_gla(*t, chunk=4)
    sj = jnp.zeros((2, 2, 4, 4), jnp.float32)
    st = torch.zeros((2, 2, 4, 4))
    ys = []
    for i in range(q.shape[1]):
        yj, sj = jssm.gla_step(*(jnp.asarray(a[:, i]) for a in (q, k, v,
                                                                 logw)),
                               None if u is None else jnp.asarray(u), sj)
        y, st = ssm.gla_step(*(x[:, i] for x in t[:4]), t[4], st)
        _close(y, yj)
        _close(st, sj)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_all, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(st, s_all, rtol=2e-4, atol=2e-4)


def _layer_params(arch, part, key=1):
    """One layer's ``part`` subtree of the reduced f32 ``arch`` from the
    JAX package's block init, and its port copy."""
    from repro.models import transformer as jtf
    from repro.parallel import sharding as jsharding

    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32")
    plan = jtf.plan_for(jcfg, jsharding.local_context())
    jp = jtf.block_init(jax.random.key(key), jcfg, plan)[part]
    tcfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    return jcfg, tcfg, jp, interop.lm_params_from_numpy(
        interop.to_numpy(jp), CPU)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_time_and_channel_mix_match_jax(carried):
    jcfg, tcfg, jp, tp = _layer_params("rwkv6-1.6b", "tmix")
    _, _, jc, tcm = _layer_params("rwkv6-1.6b", "cmix", key=2)
    rng = np.random.default_rng(11)
    b, s, d = 2, 13, jcfg.d_model
    h = d // jcfg.resolved_head_dim
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    prev = rng.normal(size=(b, d)).astype(np.float32) if carried else None
    st = rng.normal(size=(b, h, 8, 8)).astype(np.float32) if carried \
        else None
    (yj, (lj, sj)), (yt, (lt, st_)) = _both(
        lambda x, p, s: jssm.rwkv_tmix_apply(jp, x, jcfg, prev=p, state=s,
                                             chunk=4),
        lambda x, p, s: ssm.rwkv_tmix_apply(tp, x, tcfg, prev=p, state=s,
                                            chunk=4), x, prev, st)
    _close(yt, yj)
    _close(lt, lj)
    _close(st_, sj)
    (cj, clj), (ct, clt) = _both(
        lambda x, p: jssm.rwkv_cmix_apply(jc, x, prev=p),
        lambda x, p: ssm.rwkv_cmix_apply(tcm, x, prev=p), x, prev)
    _close(ct, cj)
    _close(clt, clj)


@pytest.mark.parametrize("chunk", [4, 32])
def test_mamba_apply_matches_jax_and_its_step_chain(chunk):
    jcfg, tcfg, jp, tp = _layer_params("hymba-1.5b", "ssm")
    rng = np.random.default_rng(chunk)
    b, s = 2, 11
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    (yj, sj), (yt, st) = _both(
        lambda x: jssm.mamba_apply(jp, x, jcfg, chunk=chunk),
        lambda x: ssm.mamba_apply(tp, x, tcfg, chunk=chunk), x)
    _close(yt, yj)
    _close(st, sj)
    _, din, hd, h = ssm._mamba_dims(tcfg)
    assert st.shape == (b, h, tcfg.ssm_state, hd)
    state = torch.zeros_like(st)
    xt = torch.from_numpy(x)
    for i in range(s):
        y, state = ssm.mamba_step(tp, xt[:, i], tcfg, state)
        torch.testing.assert_close(y, yt[:, i], rtol=TOL, atol=TOL)
    torch.testing.assert_close(state, st, rtol=TOL, atol=TOL)
