"""The plain versions of the port's LM kernels (paged_attention_stats,
flash_attention) against the JAX package's oracles and its Pallas kernels
(interpret mode), over the sweeps of the JAX package's own kernel tests:
zero lengths, unmapped (-1) table entries, G in {1, 2, 4}, windows, f32
and bf16. Tolerances are the JAX package's: 1e-5 in f32 (2e-5 for flash)
and 3e-2 in bf16. The CUDA kernels themselves are held against these
plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                       torch.bfloat16)}


def _pair(x, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jd)
    return j, interop._tensor(np.asarray(j), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(interop.to_numpy(got), np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _paged_inputs(rng, ps, maxp, g, lengths, dtype, unmapped=()):
    b, kvh, hd = len(lengths), 2, 16
    npages = b * maxp + 2
    q = rng.normal(size=(b, kvh, g, hd)) * hd ** -0.5
    kp = rng.normal(size=(npages, ps, kvh, hd))
    vp = rng.normal(size=(npages, ps, kvh, hd))
    kp[-1] = vp[-1] = 0.0  # the zero sentinel
    pt = rng.permutation(npages - 1)[: b * maxp].reshape(b, maxp)
    for i, j in unmapped:
        pt[i, j] = -1
    jq, tq = _pair(q, "f32")
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    jpt, tpt = jnp.asarray(pt, jnp.int32), torch.as_tensor(pt, dtype=torch.int32)
    ln = np.asarray(lengths, np.int32)
    return (jq, jk, jv, jpt, jnp.asarray(ln)), (tq, tk, tv, tpt,
                                                torch.as_tensor(ln))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ps,maxp,g", [(4, 3, 1), (8, 5, 4), (16, 2, 2)])
def test_paged_attention_stats_matches_jax(dtype, ps, maxp, g):
    """(acc, m, l) of the plain version equal JAX's oracle and its Pallas
    kernel: a zero-length row, a full row, a row with -1 entries inside
    and past its length."""
    rng = np.random.default_rng(5)
    lengths = [0, ps * maxp, ps * maxp - 3]
    jin, tin = _paged_inputs(rng, ps, maxp, g, lengths, dtype,
                             unmapped=[(2, 0), (2, maxp - 1)])
    tol = 1e-5 if dtype == "f32" else 3e-2
    got = ops.paged_attention_stats(*tin)
    gold = jref.paged_attention_stats(*jin)
    kern = jops.paged_attention_stats(*jin)
    for a, b_, c in zip(got, gold, kern):
        _close(a, b_, tol)
        _close(a, c, tol)
    # the empty softmax of the zero-length row, exactly
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ps,maxp,g", [(4, 3, 1), (8, 5, 4), (16, 2, 2)])
def test_paged_attention_matches_jax(dtype, ps, maxp, g):
    rng = np.random.default_rng(2)
    lengths = [1, ps * maxp, ps * maxp - 3]
    jin, tin = _paged_inputs(rng, ps, maxp, g, lengths, dtype)
    tol = 1e-5 if dtype == "f32" else 3e-2
    got = ops.paged_attention(*tin)
    _close(got, jref.paged_attention(*jin), tol)
    _close(got, jops.paged_attention(*jin), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,bq,bk,window,g", [
    (64, 16, 16, 0, 1), (64, 32, 16, 0, 2), (128, 32, 32, 48, 4),
    (32, 8, 8, 8, 1),
])
def test_flash_attention_matches_jax(dtype, s, bq, bk, window, g):
    rng = np.random.default_rng(3)
    b, kvh, hd = 2, 2, 8
    h = kvh * g
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, kvh, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, kvh, s, hd)), dtype)
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype
    tol = 2e-5 if dtype == "f32" else 3e-2
    _close(got, jref.flash_attention(jq, jk, jv, window=window), tol)
    _close(got, jops.flash_attention(jq, jk, jv, window=window, block_q=bq,
                                     block_k=bk), tol)


def test_flash_attention_matches_chunked_prefill():
    """The plain flash version agrees with the model's chunked prefill
    attention (layout (B,H,S,hd) against (B,S,H,hd))."""
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(4)
    b, h, kvh, s, hd = 2, 4, 2, 64, 8
    q = torch.as_tensor(rng.normal(size=(b, s, h, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(b, s, kvh, hd)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(b, s, kvh, hd)), dtype=torch.float32)
    want = chunked_attention(q, k, v, chunk=16)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_dispatch_routes_cpu_tensors_and_refuses_cuda_backend():
    """On CPU tensors ``auto`` and ``ref`` take the plain versions and
    ``cuda`` raises: there is no kernel to run and no quiet fallback."""
    rng = np.random.default_rng(0)
    _, tin = _paged_inputs(rng, 4, 2, 2, [3, 8], "f32")
    for backend in ("auto", "ref"):
        got = ops.paged_attention_stats(*tin, backend=backend)
        for a, b_ in zip(got, ref.paged_attention_stats(*tin)):
            assert torch.equal(a, b_)
    with pytest.raises(ValueError):
        ops.paged_attention_stats(*tin, backend="cuda")
    q = torch.zeros((1, 2, 8, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, backend="cuda")


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("ps,maxp", [(4, 7), (8, 5), (16, 3)])
def test_paged_split_merge_matches_jax(splits, ps, maxp):
    """The plain model of the CUDA kernel's split walk (contiguous token
    ranges of ceil(MaxP PS / S) tokens, LSE-merged) against JAX's oracle
    and Pallas kernel in f32: ranges past a short length are empty, range
    boundaries fall inside pages (ps 4 and 8 do not divide every range),
    -1 entries inside a length read the zero sentinel, and a zero-length
    row comes out exactly (0, -1e30, 0). m equal, acc and l within the
    JAX package's f32 tolerance (the merge adds in another order)."""
    rng = np.random.default_rng(11 + splits)
    full = ps * maxp
    lengths = [0, full, full - 3, 1, ps + 1, full // 2]
    jin, tin = _paged_inputs(rng, ps, maxp, 3, lengths, "f32",
                             unmapped=[(2, 0), (4, 1), (5, maxp - 1)])
    parts = ref.paged_attention_stats_splits(*tin, splits)
    assert parts[0].shape[0] == splits
    got = ref.merge_stats(*parts)
    gold = jref.paged_attention_stats(*jin)
    kern = jops.paged_attention_stats(*jin)
    np.testing.assert_array_equal(interop.to_numpy(got[1]),
                                  np.asarray(gold[1]))
    for a, b_, c in zip(got, gold, kern):
        _close(a, b_, 1e-5)
        _close(a, c, 1e-5)
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())
    # the split of the 1-token row past its first range holds the empty
    # state exactly
    if splits > 1:
        assert bool((parts[1][1:, 3] == -1e30).all())
        assert float(parts[2][1:, 3].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_strided_views_match_jax(dtype, window):
    """(B, S, H, hd) tensors passed as their (B, H, S, hd) views, as the
    model passes them, give the JAX package's result for the same
    values."""
    rng = np.random.default_rng(6)
    b, h, kvh, s, hd = 2, 4, 2, 32, 8
    jq, tq = _pair(rng.normal(size=(b, s, h, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, s, kvh, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, s, kvh, hd)), dtype)
    views = [t.transpose(1, 2) for t in (tq, tk, tv)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views, window=window, backend="ref")
    want = jref.flash_attention(*(x.transpose(0, 2, 1, 3)
                                  for x in (jq, jk, jv)), window=window)
    _close(got, want, 2e-5 if dtype == "f32" else 3e-2)
