"""A plain numpy model of the CUDA PUT commit kernels ``commit_buckets`` and
``write_rows`` (``src/repro_torch/kernels/csrc/hash_probe.cu``), held on
the CPU against the port's plain versions and the JAX package's Pallas
``insert`` (interpret mode), so that the kernels' index logic is checked
before it runs on a card:

- the launch plan: the instance each entry point takes (``commit_buckets``:
  W 8, KW 2 with 8-byte aligned keys and bucket_keys, else the run-time
  one; ``write_rows``: 16-byte chunks where VW % 4 == 0 and pool and vals
  are 16-byte aligned, else 4-byte words), the lanes a row and the CTAs;
- the lane map: one lane an entry for ``commit_buckets``; for
  ``write_rows`` L = 2^shift lanes a row (its chunks rounded up to a
  power of two, at most 32), the row's first lane loading its wp and the
  others taking it by a shuffle;
- the sentinel pass: a dead entry stores nothing; each warp that holds a
  dead entry zeroes each way of row NB it aims at once, and each CTA
  that holds a dead row zeroes row NP once.

The model follows the kernels lane by lane and records every load and
store, so a word stored twice, a dead entry that stores, a sentinel word
written outside the sentinel pass, or a load after the first round where
the serve instance allows none fails a test. The model reads the CTA
sizes from the source's defaults.
"""
from __future__ import annotations

import re
from collections import Counter, defaultdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvs_commit_cases import BATCHES, CASES, IN_RANGE, SHAPES, commit_case, \
    plain_commit, to_torch
from repro.kernels import hash_probe as jhp

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "hash_probe.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARP = 32
BUCKET_THREADS = _constant("kBucketThreads")  # threads a CTA
ROW_THREADS = _constant("kRowThreads")
MAX_BATCH, U32 = 1 << 26, 2**32


def buckets_plan(b, w, kw, aligned=True):
    """``orca_commit_buckets``'s choices: the serve instance, threads a CTA
    and CTAs; a warp zeroes the ways its dead entries aim at, by lane
    (W <= 32) or by the first lane aiming at the way."""
    assert 0 < b <= MAX_BATCH and w > 0 and kw > 0
    return dict(serve=w == 8 and kw == 2 and aligned,
                threads=BUCKET_THREADS, blocks=-(-b // BUCKET_THREADS),
                by_lane=w <= WARP)


def rows_plan(b, vw, aligned=True):
    """``orca_write_rows``'s choices: words a chunk (4 or 1), chunks a row,
    log2 of the lanes a row, threads a CTA and CTAs."""
    assert 0 < b <= MAX_BATCH and vw > 0
    vec = 4 if vw % 4 == 0 and aligned else 1
    chunks = vw // vec
    shift = 0
    while (1 << shift) < chunks and shift < 5:
        shift += 1
    return dict(vec=vec, chunks=chunks, shift=shift, threads=ROW_THREADS,
                blocks=-(-(b << shift) // ROW_THREADS))


def model_commit_buckets(rows, w, kw, keys, tb, tw, bptr_val, aligned=True):
    """The commit_buckets kernel on a bucket array of ``rows`` rows (NB =
    rows - 1) of ``w`` ways of ``kw`` words. Returns (stores, loads,
    plan): ``stores`` lists (array, element offset, words, pass, warp,
    entry) and ``loads[i]`` entry i's loads as (what, bytes, round)."""
    b, nb = len(tb), rows - 1
    plan = buckets_plan(b, w, kw, aligned)
    unit = WARP
    stores, loads = [], defaultdict(list)
    aimed = defaultdict(set)  # warp -> the ways its dead entries aim at
    for i in range(plan["blocks"] * plan["threads"]):
        assert i < U32
        if i >= b:
            continue
        loads[i] += [("tb", 4, 1), ("tw", 4, 1), ("bptr_val", 4, 1)]
        if plan["serve"]:
            loads[i].append(("key", 8, 1))
        bi, wi = int(tb[i]), int(tw[i])
        way_ok = wi % U32 < w  # unsigned compare
        if way_ok and bi % U32 < nb:
            slot = bi * w + wi
            if plan["serve"]:
                stores.append(("bucket_keys", slot * 2, tuple(keys[i]),
                               "scatter", i // unit, i))
            else:
                for j in range(kw):
                    loads[i].append(("key", 4, 2))
                    stores.append(("bucket_keys", slot * kw + j,
                                   (keys[i, j],), "scatter", i // unit, i))
            stores.append(("bucket_ptr", slot, (bptr_val[i],), "scatter",
                           i // unit, i))
        elif way_ok and bi == nb:
            aimed[i // unit].add(wi)
    for group, ways in sorted(aimed.items()):
        for way in sorted(ways):
            slot = nb * w + way
            if plan["serve"]:
                stores.append(("bucket_keys", slot * 2, (0, 0), "sentinel",
                               group, None))
            else:
                stores += [("bucket_keys", slot * kw + j, (0,), "sentinel",
                            group, None) for j in range(kw)]
            stores.append(("bucket_ptr", slot, (0,), "sentinel", group,
                           None))
    return stores, loads, plan


def model_write_rows(rows, vw, vals, wp, aligned=True):
    """The write_rows kernel on a pool of ``rows`` rows (NP = rows - 1) of
    ``vw`` words. Returns (stores, loads, plan): ``stores`` lists (array,
    element offset, words, pass, CTA, entry) and ``loads[i]`` entry i's
    loads as (what, chunk, lane, round)."""
    b, np_ = len(wp), rows - 1
    plan = rows_plan(b, vw, aligned)
    vec, chunks, shift = plan["vec"], plan["chunks"], plan["shift"]
    group = (1 << shift) - 1
    stores, loads = [], defaultdict(list)
    for blk in range(plan["blocks"]):
        dead = False
        for warp in range(ROW_THREADS // WARP):
            t0 = blk * ROW_THREADS + warp * WARP
            assert t0 + WARP <= U32
            target = [-1] * WARP
            for lane in range(WARP):  # round 1: wp and the payload
                row, c0 = (t0 + lane) >> shift, lane & group
                if row < b and c0 == 0:
                    target[lane] = int(wp[row])
                    loads[row].append(("wp", None, lane, 1))
                if row < b and c0 < chunks:
                    loads[row].append(("vals", c0, lane, 1))
            for lane in range(WARP):  # the shuffle, then the stores
                row, c0 = (t0 + lane) >> shift, lane & group
                tgt = target[lane & ~group]
                if tgt % U32 < np_:
                    for c in range(c0, chunks, WARP):
                        if c > c0:
                            loads[row].append(("vals", c, lane, 2))
                        stores.append((
                            "pool", tgt * vw + c * vec,
                            tuple(vals[row, c * vec:(c + 1) * vec]),
                            "scatter", blk, row))
                dead |= tgt == np_
        if dead:  # the CTA's vote
            stores += [("pool", np_ * vw + c * vec, (0,) * vec, "sentinel",
                        blk, None) for c in range(chunks)]
    return stores, loads, plan


def apply(stores, arrays):
    """Copies of ``arrays`` ({name: numpy array}) with ``stores`` written
    into their flat views."""
    out = {k: v.copy() for k, v in arrays.items()}
    for name, off, words, *_ in stores:
        flat = out[name].reshape(-1)
        flat[off:off + len(words)] = words
    return out


def model_commit(c, aligned=True):
    """Both kernels on case ``c``: (result arrays, bucket stores, bucket
    loads, bucket plan, pool stores, pool loads, pool plan)."""
    rows, w, kw = c["bucket_keys"].shape
    sb, lb, pb = model_commit_buckets(rows, w, kw, c["keys"], c["tb"],
                                      c["tw"], c["bptr_val"], aligned)
    sp, lp, pp = model_write_rows(c["pool"].shape[0], c["pool"].shape[1],
                                  c["vals"], c["wp"], aligned)
    out = apply(sb + sp, {k: c[k] for k in ("bucket_keys", "bucket_ptr",
                                            "pool")})
    return out, sb, lb, pb, sp, lp, pp


def _check_bucket_stores(c, stores, loads, plan):
    """Every live entry stores its KW key words and its pointer once (the
    key as one 8-byte store at the serve widths), in the scatter pass; no
    dead or skipped entry stores; the sentinel pass writes only the
    aimed-at ways of row NB, each word once per warp that holds an entry
    aimed at it; the serve instance loads in one round."""
    rows, w, kw = c["bucket_keys"].shape
    nb, tb, tw = rows - 1, c["tb"], c["tw"]
    live = [i for i in range(len(tb)) if 0 <= tb[i] < nb and 0 <= tw[i] < w]
    per = Counter(e for *_, p, _, e in stores if p == "scatter")
    assert per == Counter({i: (1 if plan["serve"] else kw) + 1
                           for i in live})
    scattered = Counter((a, off + j) for a, off, wd, p, *_ in stores
                        if p == "scatter" for j in range(len(wd)))
    assert set(scattered.values()) <= {1}
    for a, off, wd, p, *_ in stores:
        per_row = w * (kw if a == "bucket_keys" else 1)
        assert (off // per_row == nb) == (p == "sentinel")
        if a == "bucket_keys" and plan["serve"]:
            assert len(wd) == 2 and off % 2 == 0
    dead = [i for i in range(len(tb)) if tb[i] == nb and 0 <= tw[i] < w]
    voters = Counter()  # (warp, way) of a dead entry
    for i in dead:
        voters[(i // WARP, int(tw[i]))] = 1
    zeroed = Counter((g, (off // (kw if a == "bucket_keys" else 1)) % w)
                     for a, off, wd, p, g, _ in stores if p == "sentinel")
    want = Counter({k: (1 if plan["serve"] else kw) + 1 for k in voters})
    assert zeroed == want
    if plan["serve"]:
        assert all(r == 1 for ld in loads.values() for *_, r in ld)


def _check_pool_stores(c, stores, loads, plan):
    """Every live row stored once, chunk by chunk (16 bytes at the serve
    widths), its wp loaded once by its first lane; no dead or skipped row
    stores; row NP written only by the sentinel pass, whole, once per CTA
    that holds a dead row."""
    np_, vw = c["pool"].shape[0] - 1, c["pool"].shape[1]
    wp, vec = c["wp"], plan["vec"]
    live = {i for i in range(len(wp)) if 0 <= wp[i] < np_}
    words = Counter(off + j for _, off, wd, p, *_ in stores
                    if p == "scatter" for j in range(len(wd)))
    want = Counter(int(wp[i]) * vw + j for i in live for j in range(vw))
    assert words == want
    assert all(len(wd) == vec for _, _, wd, *_ in stores)
    assert {e for *_, p, _, e in stores if p == "scatter"} == live
    for _, off, _, p, *_ in stores:
        assert (off // vw == np_) == (p == "sentinel")
    for i in range(len(wp)):
        got = [ld for ld in loads[i] if ld[0] == "wp"]
        assert got == [("wp", None, (i << plan["shift"]) % WARP, 1)]
    dead = [i for i in range(len(wp)) if wp[i] == np_]
    ctas = {(i << plan["shift"]) // plan["threads"] for i in dead}
    zeroed = Counter(cta for *_, p, cta, _ in stores if p == "sentinel")
    assert zeroed == Counter({cta: plan["chunks"] for cta in ctas})
    if plan["chunks"] <= WARP:
        assert all(ld[3] == 1 for v in loads.values() for ld in v)


def _pallas_insert(c):
    out = jhp.insert(*(jnp.asarray(c[k]) for k in (
        "bucket_keys", "bucket_ptr", "pool", "keys", "vals", "tb", "tw",
        "bptr_val", "wp")), interpret=True)
    return [np.asarray(x) for x in out]


def _plain(c):
    return [x.numpy() for x in plain_commit(**to_torch(c))]


def test_launch_plans_at_the_main_path_batches():
    """The serve widths: ``commit_buckets`` one lane an entry in CTAs of
    64 threads, so 4 CTAs at the engine's batch (256) and 1,024 at the
    load phase's (65,536); ``write_rows`` 16-byte chunks, 4 lanes a row, 8
    rows a warp, CTAs of 256 threads: 4 CTAs and 1,024. Unaligned or
    other widths take the run-time instances."""
    assert buckets_plan(256, 8, 2) == dict(
        serve=True, threads=64, blocks=4, by_lane=True)
    assert buckets_plan(65536, 8, 2)["blocks"] == 1024
    assert not buckets_plan(256, 8, 2, aligned=False)["serve"]
    assert not buckets_plan(256, 16, 2)["serve"]
    assert not buckets_plan(7, 40, 3)["by_lane"]
    assert rows_plan(256, 16) == dict(
        vec=4, chunks=4, shift=2, threads=256, blocks=4)
    assert rows_plan(65536, 16)["blocks"] == 1024
    assert [rows_plan(5, vw)["shift"] for vw in (1, 3, 8, 16, 17, 132)] == \
        [0, 2, 1, 2, 5, 5]
    assert rows_plan(5, 16, aligned=False)["vec"] == 1
    assert rows_plan(5, 16, aligned=False)["shift"] == 4
    with pytest.raises(AssertionError):
        rows_plan(MAX_BATCH + 1, 16)
    with pytest.raises(AssertionError):
        buckets_plan(MAX_BATCH + 1, 8, 2)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_commit_model_matches_plain_versions(case, shape, b):
    """The model's arrays equal the plain versions' (entries outside the
    arrays skipped), and its stores and loads are the lane maps'."""
    nb, w, kw, np_, vw = shape
    c = commit_case(case, seed=nb * 7 + vw + b, nb=nb, w=w, kw=kw, np_=np_,
                    vw=vw, b=b)
    out, sb, lb, pb, sp, lp, pp = model_commit(c)
    for got, want in zip(out.values(), _plain(c)):
        np.testing.assert_array_equal(got, want)
    _check_bucket_stores(c, sb, lb, pb)
    _check_pool_stores(c, sp, lp, pp)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", IN_RANGE)
def test_commit_model_matches_pallas_insert(case, shape):
    """Where every target lies in the arrays, the model equals the JAX
    package's Pallas ``insert``: its payload zeroing and whole-row staging
    leave the same words, non-zero sentinel rows included."""
    nb, w, kw, np_, vw = shape
    c = commit_case(case, seed=nb + vw, nb=nb, w=w, kw=kw, np_=np_, vw=vw,
                    b=37)
    out, *_ = model_commit(c)
    for got, want in zip(out.values(), _pallas_insert(c)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aligned", [True, False])
def test_commit_model_both_instances(aligned):
    """Both instances of each kernel at the serve widths over a multi-CTA
    batch give the plain versions' arrays; views offset by one word take
    the run-time instances."""
    c = commit_case("some_dead", seed=11, nb=64, w=8, kw=2, np_=400, vw=16,
                    b=300)
    out, sb, lb, pb, sp, lp, pp = model_commit(c, aligned)
    assert pb["serve"] == aligned and pp["vec"] == (4 if aligned else 1)
    for got, want in zip(out.values(), _plain(c)):
        np.testing.assert_array_equal(got, want)
    _check_bucket_stores(c, sb, lb, pb)
    _check_pool_stores(c, sp, lp, pp)


def test_sentinel_rows_change_only_where_aimed():
    """A non-zero sentinel row: with no dead entry it keeps every word;
    with dead entries only their ways of row NB become zero, and all of
    row NP."""
    c = commit_case("none_dead", seed=1, nb=64, w=8, kw=2, np_=400, vw=16,
                    b=37)
    out, *_ = model_commit(c)
    np.testing.assert_array_equal(out["bucket_keys"][64],
                                  c["bucket_keys"][64])
    np.testing.assert_array_equal(out["bucket_ptr"][64], c["bucket_ptr"][64])
    np.testing.assert_array_equal(out["pool"][400], c["pool"][400])
    c = commit_case("serve_mix", seed=2, nb=64, w=8, kw=2, np_=400, vw=16,
                    b=256)
    out, *_ = model_commit(c)
    assert not out["bucket_keys"][64, 0].any()
    assert not out["bucket_ptr"][64, 0]
    np.testing.assert_array_equal(out["bucket_keys"][64, 1:],
                                  c["bucket_keys"][64, 1:])
    assert c["bucket_ptr"][64, 1:].all() and not out["pool"][400].any()


def test_serve_mix_stores_nothing_for_dead_entries():
    """The serve mix at the engine's batch: about 244 of 256 entries dead,
    all at way 0; the commit stores only the live entries' words and, in
    the sentinel pass, way 0 of row NB (3 words) once per warp and row NP
    (4 chunks) once per CTA holding a dead entry."""
    c = commit_case("serve_mix", seed=3, nb=64, w=8, kw=2, np_=400, vw=16,
                    b=256)
    _, sb, _, pb, sp, _, pp = model_commit(c)
    live_b = int((c["tb"] < 64).sum())
    live_p = int((c["wp"] < 400).sum())
    assert live_b < 40 and live_p < 40
    assert sum(p == "scatter" for *_, p, _, _ in sb) == 2 * live_b
    assert sum(p == "sentinel" for *_, p, _, _ in sb) == 2 * 256 // WARP
    assert sum(p == "scatter" for *_, p, _, _ in sp) == 4 * live_p
    assert sum(p == "sentinel" for *_, p, _, _ in sp) <= 4 * pp["blocks"]


def test_offsets_past_32_bits_at_the_papers_pool():
    """NP = 2^27 rows of 16 words and NB = 2^27 buckets of 8 ways (addresses
    only, nothing allocated): the sentinel rows lie past INT32_MAX words,
    so element offsets are computed in 64 bits, while the lane indices
    stay in 32."""
    np_, vw = 1 << 27, 16
    wp = np.array([np_ - 1, np_ - 2, np_, 5], np.int64).astype(np.int32)
    vals = np.arange(4 * vw, dtype=np.int32).reshape(4, vw)
    stores, _, plan = model_write_rows(np_ + 1, vw, vals, wp)
    offs = sorted({off for _, off, _, p, *_ in stores if p == "scatter"})
    assert offs[-1] == (np_ - 1) * vw + 12 == 2**31 - 4
    sentinel = {off for _, off, _, p, *_ in stores if p == "sentinel"}
    assert sentinel == {np_ * vw + 4 * c for c in range(4)}
    assert min(sentinel) == 2**31
    nb = 1 << 27
    tb = np.array([nb - 1, nb, 3], np.int64).astype(np.int32)
    tw = np.array([7, 5, 0], np.int32)
    keys = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    stores, _, _ = model_commit_buckets(nb + 1, 8, 2, keys, tb, tw,
                                        np.array([9, 8, 7], np.int32))
    key_offs = {off: p for a, off, _, p, *_ in stores if a == "bucket_keys"}
    assert key_offs == {((nb - 1) * 8 + 7) * 2: "scatter", 3 * 8 * 2 + 0:
                        "scatter", (nb * 8 + 5) * 2: "sentinel"}
    assert max(key_offs) == 2**31 + 10


def test_model_follows_the_source_defaults():
    """The CTA sizes the model uses are the source's build defaults, which
    the A/B script overrides with -DORCA_COMMIT_THREADS."""
    assert (BUCKET_THREADS, ROW_THREADS) == (64, 256)
    assert "kBucketThreads = ORCA_COMMIT_THREADS" in SOURCE
    assert "kRowThreads = ORCA_COMMIT_THREADS" in SOURCE


def test_card_side_cases_import_neither_jax_nor_repro():
    """The cases shared with the card tests run where there is no JAX."""
    import ast

    tree = ast.parse((Path(__file__).resolve().parent /
                      "kvs_commit_cases.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods


def test_plain_commit_equals_the_dispatcher_on_in_range_cases():
    """``plain_commit`` on in-range targets is ``ops.hash_put`` with the
    plain backend: the helper adds only the skipping of outside targets."""
    from repro_torch.kernels import ops

    c = commit_case("some_dead", seed=5, nb=32, w=16, kw=2, np_=400, vw=8,
                    b=37)
    want = _plain(c)
    t = to_torch(c)
    got = ops.hash_put(t["bucket_keys"], t["bucket_ptr"], t["pool"],
                       t["keys"], t["vals"], t["tb"], t["tw"],
                       t["bptr_val"], t["wp"], backend="ref")
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert isinstance(got[0], torch.Tensor)


def test_chip_smoke_names_the_commit_instances():
    """``chip_smoke.py``'s SASS scan names both instances of each commit
    kernel, whose template argument is a way count or an element type."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_commit", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ns = "_ZN36_INTERNAL_52bc5651_13_hash_probe_cu_a59e75e2"
    assert cs.kernel_name(ns + "21commit_buckets_kernelILi8EEEvPiS1_") \
        == "commit_buckets_kernel<8>"
    assert cs.kernel_name(ns + "21commit_buckets_kernelILi0EEEvPiS1_") \
        == "commit_buckets_kernel<0>"
    assert cs.kernel_name(ns + "17write_rows_kernelI4int4EEvPiPKiS3_") \
        == "write_rows_kernel<int4>"
    assert cs.kernel_name(ns + "17write_rows_kernelIiEEvPiPKiS2_") == \
        "write_rows_kernel<int>"
    assert cs.kernel_name(ns + "12probe_kernelILi8ELi2EEEvPKiS2_") == \
        "probe_kernel<8,2>"
