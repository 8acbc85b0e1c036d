"""The five hash-table kernels of the PyTorch port against the JAX package's
Pallas kernels, bit for bit (int32 data).

On the CPU the port's dispatcher takes the plain versions
(``repro_torch.kernels.ref``); the Pallas kernels run in interpret mode,
as the JAX package's own tests run them. Inputs are made from a seed with
numpy and given to both.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_probe as jhp
from repro_torch.kernels import hash_probe as thp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_port_helpers import assert_same, t

ROOT = Path(__file__).resolve().parents[1]
# (num_buckets, ways, key_words, pool_size) — the verify skill's tiny configs
SHAPES = [(8, 2, 2, 24), (32, 4, 2, 64)]
BATCHES = [1, 7, 32]
VW = 4
KEYSPACE = 6  # key words drawn from [-2, 4): repeats, zeros and negatives


def _store(rng, nb, w, kw, np_):
    """Random sentinel-resident bucket arrays and pool: some ways live,
    some empty (ptr -1) with stale key words, the zero key among them."""
    bk = rng.integers(-2, KEYSPACE - 2, (nb + 1, w, kw)).astype(np.int32)
    bp = rng.integers(0, np_, (nb + 1, w)).astype(np.int32)
    bp[rng.random((nb + 1, w)) < 0.35] = -1
    bk[nb], bp[nb] = 0, 0
    pool = rng.integers(-1000, 1000, (np_ + 1, VW)).astype(np.int32)
    pool[np_] = 0
    return bk, bp, pool


def _queries(rng, b, nb, kw, bk, bp):
    """Keys and bucket ids: about half the rows aim at a live way of their
    primary or overflow bucket (hits), the rest are random (mostly misses,
    some the zero key); h1 may be the sentinel row NB."""
    keys = rng.integers(-2, KEYSPACE - 2, (b, kw)).astype(np.int32)
    keys[rng.random(b) < 0.2] = 0  # the zero key
    h1 = rng.integers(0, nb + 1, b).astype(np.int32)
    h2 = rng.integers(0, nb, b).astype(np.int32)
    live = np.argwhere(bp[:nb] >= 0)
    for i in np.flatnonzero(rng.random(b) < 0.5):
        bucket, way = live[rng.integers(len(live))]
        keys[i] = bk[bucket, way]
        (h1 if rng.random() < 0.5 else h2)[i] = bucket
    return keys, h1, h2


def _cases():
    for shape in SHAPES:
        for b in BATCHES:
            yield shape, b


@pytest.mark.parametrize("shape,b", list(_cases()))
def test_probe_matches_pallas(shape, b):
    nb, w, kw, np_ = shape
    rng = np.random.default_rng(nb * 100 + b)
    bk, bp, _ = _store(rng, nb, w, kw, np_)
    keys, h1, h2 = _queries(rng, b, nb, kw, bk, bp)
    want = jhp.probe(jnp.asarray(bk), jnp.asarray(bp), jnp.asarray(keys),
                     jnp.asarray(h1), jnp.asarray(h2), interpret=True)
    got = tops.hash_probe(t(bk), t(bp), t(keys), t(h1), t(h2))
    assert_same(want, got, "probe")
    assert bool(np.asarray(want[0]).any()) or b == 1  # some rows hit
    assert not bool(np.asarray(want[0]).all()) or b == 1  # some miss


@pytest.mark.parametrize("shape,b", list(_cases()))
def test_fetch_and_get_match_pallas(shape, b):
    nb, w, kw, np_ = shape
    rng = np.random.default_rng(nb * 100 + b + 1)
    bk, bp, pool = _store(rng, nb, w, kw, np_)
    ptr = rng.integers(0, np_ + 1, b).astype(np.int32)  # np_ = sentinel
    want = jhp.fetch(jnp.asarray(pool), jnp.asarray(ptr), interpret=True)
    assert_same(want, tref.fetch(t(pool), t(ptr)), "fetch")
    keys, h1, h2 = _queries(rng, b, nb, kw, bk, bp)
    want = jhp.get(jnp.asarray(bk), jnp.asarray(bp), jnp.asarray(pool),
                   jnp.asarray(keys), jnp.asarray(h1), jnp.asarray(h2),
                   interpret=True)
    got = tops.hash_get(t(bk), t(bp), t(pool), t(keys), t(h1), t(h2))
    assert_same(want, got, "get")


@pytest.mark.parametrize("shape,b", list(_cases()))
def test_cache_probe_matches_pallas(shape, b):
    cs, cw, kw, _ = shape
    rng = np.random.default_rng(cs * 100 + b + 2)
    # per set, distinct keys (kvstore admits each key once), some ways empty
    ck = np.zeros((cs + 1, cw, kw), np.int32)
    for s in range(cs):
        codes = rng.choice(KEYSPACE ** kw, size=cw, replace=False)
        for j in range(kw):
            ck[s, :, j] = (codes // KEYSPACE ** j) % KEYSPACE - 2
    cv = rng.integers(-1000, 1000, (cs + 1, cw, VW)).astype(np.int32)
    cm = rng.integers(0, 17, (cs + 1, cw)).astype(np.int32)
    cm[rng.random((cs + 1, cw)) < 0.3] = 0
    ck[cs], cv[cs], cm[cs] = 0, 0, 0
    keys = rng.integers(-2, KEYSPACE - 2, (b, kw)).astype(np.int32)
    keys[rng.random(b) < 0.2] = 0
    cset = rng.integers(0, cs + 1, b).astype(np.int32)
    want = jhp.cache_probe(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(cm),
                           jnp.asarray(keys), jnp.asarray(cset),
                           interpret=True)
    got = tops.cache_probe(t(ck), t(cv), t(cm), t(keys), t(cset))
    assert_same(want, got, "cache_probe")


def _plan(rng, b, nb, w, np_):
    """A commit plan with unique live targets and sentinel-aimed entries
    (tb == NB / wp == NP) carrying non-zero payloads that must not land."""
    pairs = rng.permutation(nb * w)[:b]
    live = rng.random(b) < 0.6
    tb = np.where(live[: len(pairs)], pairs // w, nb)
    tb = np.concatenate([tb, np.full(b - len(pairs), nb)]).astype(np.int32)
    tw = np.concatenate([pairs % w, rng.integers(0, w, b - len(pairs))])
    tw = tw.astype(np.int32)
    bptr_val = rng.integers(0, np_, b).astype(np.int32)
    rows = rng.permutation(np_)[:b]
    wlive = rng.random(b) < 0.6
    wp = np.full(b, np_, np.int32)
    wp[: len(rows)] = np.where(wlive[: len(rows)], rows, np_)
    return tb, tw, bptr_val, wp


@pytest.mark.parametrize("shape,b", list(_cases()))
def test_commit_buckets_and_write_rows_match_pallas(shape, b):
    nb, w, kw, np_ = shape
    rng = np.random.default_rng(nb * 100 + b + 3)
    bk, bp, pool = _store(rng, nb, w, kw, np_)
    keys = rng.integers(-5, 5, (b, kw)).astype(np.int32)
    vals = rng.integers(-1000, 1000, (b, VW)).astype(np.int32)
    tb, tw, bptr_val, wp = _plan(rng, b, nb, w, np_)
    want = jhp.insert(jnp.asarray(bk), jnp.asarray(bp), jnp.asarray(pool),
                      jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(tb),
                      jnp.asarray(tw), jnp.asarray(bptr_val), jnp.asarray(wp),
                      interpret=True)
    tbk, tbp, tpool = t(bk), t(bp), t(pool)
    out = tref.commit_buckets(tbk, tbp, t(keys), t(tb), t(tw), t(bptr_val))
    assert out[0] is tbk and out[1] is tbp  # in place
    assert tref.write_rows(tpool, t(vals), t(wp)) is tpool
    assert_same(want, (tbk, tbp, tpool), "insert")
    assert not tbk[nb].any() and not tbp[nb].any() and not tpool[np_].any()
    # the dispatcher commits in place too, to the same result
    tbk2, tbp2, tpool2 = t(bk), t(bp), t(pool)
    tops.hash_put(tbk2, tbp2, tpool2, t(keys), t(vals), t(tb), t(tw),
                  t(bptr_val), t(wp))
    assert_same(want, (tbk2, tbp2, tpool2), "hash_put")


# ------------------------------ dispatch -----------------------------------

def test_cuda_backend_on_cpu_tensors_raises():
    rng = np.random.default_rng(0)
    bk, bp, pool = _store(rng, 8, 2, 2, 24)
    keys, h1, h2 = _queries(rng, 4, 8, 2, bk, bp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.hash_probe(t(bk), t(bp), t(keys), t(h1), t(h2), backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        thp.probe(t(bk), t(bp), t(keys), t(h1), t(h2))
    with pytest.raises(ValueError, match="unknown kernel_backend"):
        tops.hash_get(t(bk), t(bp), t(pool), t(keys), t(h1), t(h2),
                      backend="pallas")
    assert tops.resolve_backend("auto", torch.device("cpu")) is True
    assert tops.resolve_backend("ref", torch.device("cpu")) is True


# ------------------------------ guards -------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop\n"
        "import repro_torch.core.engine, repro_torch.core.kvstore\n"
        "import repro_torch.core.transaction, repro_torch.core.tx_app\n"
        "import repro_torch.core.dlrm\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.hash_probe\n"
        "import repro_torch.kernels.tx_commit\n"
        "import repro_torch.kernels.embedding_reduce\n"
        "import repro_torch.kernels.paged_attention\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs, repro_torch.parallel\n"
        "import repro_torch.models, repro_torch.serving\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
