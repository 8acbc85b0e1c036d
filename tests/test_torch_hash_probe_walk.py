"""A plain numpy model of the CUDA lookup kernels ``probe`` and
``cache_probe`` (``src/repro_torch/kernels/csrc/hash_probe.cu``), held on
the CPU against the port's plain versions and the JAX package's Pallas
kernels (interpret mode), so that the kernels' lane maps are checked
before they run on a card:

- the launch plan: the instance the entry point takes (the serve widths
  with aligned arrays, else the run-time one), the lanes a request, and
  CTAs of 256 threads;
- ``probe``: a group of 2L lanes a request, lane l on bucket l / L and
  ways l % L, l % L + L, ...; each lane loads its id, the query and its
  ways' key words and pointers; a max over each bucket's L lanes by
  xor-shuffles, one shuffle bringing h2's to lane 0, which stores;
- ``cache_probe`` at the serve widths: 16 lanes a request, lane l loading
  16 bytes of the set's value block and lanes 0..CW-1 a way's key words
  and meta; a max over those lanes, a broadcast, and the 4 lanes holding
  the winning line store it; at other widths a warp a request and the
  winning line loaded after the max.

The model follows the kernels lane by lane and records each request's
loads (what, where, how wide, and whether before or after the lane
group's reduction) and stores, so a way loaded twice or never, a load
aimed out of range, a line read after the reduction at the serve widths,
or an output stored twice fails a test.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hash_probe_cases import CACHE_CASES, CACHE_PALLAS, CACHE_SHAPES, \
    GET_CASES, GET_IN_RANGE, GET_SHAPES, PROBE_CASES, PROBE_IN_RANGE, \
    PROBE_SHAPES, cache_case, get_case, plain_cache_probe, plain_get, \
    plain_probe, probe_case, to_torch
from repro.kernels import hash_probe as jhp

WARP, THREADS, MAX_LOOKUPS = 32, 256, 1 << 26
BATCHES = [1, 37]
# the GET walk's: one request, the engine's batch, a ragged multi-CTA one
GET_BATCHES = [1, 256, 401]
PROBE_KEYS = ("bucket_keys", "bucket_ptr", "keys", "h1", "h2")
GET_KEYS = ("bucket_keys", "bucket_ptr", "pool", "keys", "h1", "h2")


def probe_plan(b, w, kw, aligned=True):
    """``orca_probe``'s choices: the serve instance, log2 of the lanes a
    bucket (L), threads a CTA and CTAs."""
    assert 0 < b <= MAX_LOOKUPS
    hs = 0
    while (1 << hs) < w and hs < 4:
        hs += 1
    lanes = b << (hs + 1)
    return dict(serve=w == 8 and kw == 2 and aligned, half_shift=hs,
                threads=THREADS, blocks=-(-lanes // THREADS))


def get_plan(b, w, kw, vw, aligned=True):
    """``orca_get``'s choices: probe's, with the serve instance only at 16
    value words (a lane a word of the row)."""
    return probe_plan(b, w, kw, aligned and vw == 16)


def cache_plan(b, cw, kw, vw, aligned=True):
    """``orca_cache_probe``'s choices: the serve instance, the lanes a
    request, threads a CTA and CTAs."""
    assert 0 < b <= MAX_LOOKUPS
    serve = (cw, kw, vw) == (4, 2, 16) and aligned
    group = 16 if serve else 32
    return dict(serve=serve, group=group, threads=THREADS,
                blocks=-(-b * group // THREADS))


def _lanes(plan, group_shift):
    """(block, warp, [(lane, request, group lane)]) of every warp."""
    for blk in range(plan["blocks"]):
        for wp in range(plan["threads"] // WARP):
            yield [(lane, (blk * plan["threads"] + wp * WARP + lane)
                    >> group_shift, lane & ((1 << group_shift) - 1))
                   for lane in range(WARP)]


def _xor_max(v, offsets):
    for off in offsets:
        v = [max(v[lane], v[lane ^ off]) for lane in range(WARP)]
    return v


def _probe_groups(bucket_keys, bucket_ptr, keys, h1, h2, plan, loads):
    """``probe_group``, the lane map that ``probe`` and ``get_walk`` share,
    on numpy arrays, warp by warp: yields each warp's lanes [(lane,
    request, group lane)] and the request's pointer as each lane resolves
    it (h1's max if it matched, else h2's; -1 for a miss), after recording
    each request's loads in ``loads`` as (what, row, way, bytes)."""
    bk, bp = bucket_keys, bucket_ptr
    rows, w, kw = bk.shape
    b = keys.shape[0]
    hs = plan["half_shift"]
    half = 1 << hs
    for lanes in _lanes(plan, hs + 1):
        best = [-1] * WARP
        for lane, i, gl in lanes:
            if i >= b:
                continue
            side = 0 if gl < half else 1
            bid = int((h1, h2)[side][i])
            loads[i].append(("id", side, None, 4))
            q = keys[i]
            if plan["serve"]:
                loads[i].append(("query", None, None, 8))
            if not 0 <= bid < rows:
                continue
            for way in range(gl & (half - 1), w, half):
                p, k = int(bp[bid, way]), bk[bid, way]
                loads[i].append(("ptr", bid, way, 4))
                if plan["serve"]:
                    loads[i].append(("key", bid, way, 8))
                else:
                    loads[i] += [("key", bid, way, 4)] * kw
                    loads[i] += [("query", None, None, 4)] * kw
                eq = p >= 0 and bool((k == q).all())
                best[lane] = max(best[lane], p if eq else -1)
        offs = []
        off = half >> 1
        while off:
            offs.append(off)
            off >>= 1
        best = _xor_max(best, offs)
        other = [best[lane ^ half] for lane in range(WARP)]
        resolved = []
        for lane, _, gl in lanes:
            p1, p2 = ((best[lane], other[lane]) if gl < half
                      else (other[lane], best[lane]))
            resolved.append(p1 if p1 >= 0 else p2)
        yield lanes, resolved


def model_probe(bucket_keys, bucket_ptr, keys, h1, h2, aligned=True):
    """The probe kernel on numpy arrays. Returns (found, ptr, loads, stores,
    plan): ``loads[i]`` lists request i's loads as (what, row, way, bytes),
    ``stores[i]`` counts its stores of (found, ptr)."""
    rows, w, kw = bucket_keys.shape
    b = keys.shape[0]
    plan = probe_plan(b, w, kw, aligned)
    found = np.zeros(b, bool)
    ptr = np.full(b, -99, np.int32)  # not stored
    loads, stores = defaultdict(list), Counter()
    for lanes, r in _probe_groups(bucket_keys, bucket_ptr, keys, h1, h2,
                                  plan, loads):
        for lane, i, gl in lanes:
            if gl == 0 and i < b:
                found[i], ptr[i] = r[lane] >= 0, max(r[lane], 0)
                stores[i] += 1
    return found, ptr, loads, stores, plan


def model_get_walk(bucket_keys, bucket_ptr, pool, keys, h1, h2,
                   aligned=True):
    """The get_walk kernel on numpy arrays: probe's lane map, then each
    lane of a group copies words gl, gl + 2L, ... of pool row min(r, NP)
    on a hit and stores zeros on a miss; lane 0 stores found. Returns
    (vals, found, loads, stores, plan): ``loads[i]`` as in
    :func:`model_probe` plus ("row", row, word, 4) after the reduction;
    ``stores[i]`` counts its stores per output word (-1: found). Every
    lane of a group must resolve the same pointer."""
    rows, w, kw = bucket_keys.shape
    np_row, vw = pool.shape[0] - 1, pool.shape[1]
    b = keys.shape[0]
    plan = get_plan(b, w, kw, vw, aligned)
    group = 2 << plan["half_shift"]
    found = np.zeros(b, bool)
    vals = np.full((b, vw), -99, np.int32)  # not stored
    loads, stores = defaultdict(list), defaultdict(Counter)
    seen = defaultdict(set)
    for lanes, r in _probe_groups(bucket_keys, bucket_ptr, keys, h1, h2,
                                  plan, loads):
        for lane, i, gl in lanes:
            if i >= b:
                continue
            seen[i].add(r[lane])
            if gl == 0:
                found[i] = r[lane] >= 0
                stores[i][-1] += 1
            at = min(r[lane], np_row)
            for j in range(gl, vw, group):
                if r[lane] >= 0:
                    vals[i, j] = pool[at, j]
                    loads[i].append(("row", at, j, 4))
                else:
                    vals[i, j] = 0
                stores[i][j] += 1
    assert all(len(v) == 1 for v in seen.values()), "a group disagrees"
    return vals, found, loads, stores, plan


def model_cache_probe(cache_keys, cache_vals, cache_meta, keys, cset,
                      aligned=True):
    """The cache_probe kernel on numpy arrays. Returns (hit, way, vals,
    loads, stores, plan): ``loads[i]`` lists request i's loads as (what,
    set, word or way, bytes, after the reduction); ``stores[i]`` counts
    its stores per output word (-1: hit and way)."""
    ck, cv, cm = cache_keys, cache_vals, cache_meta
    sets, cw, kw = ck.shape
    vw = cv.shape[2]
    b = keys.shape[0]
    plan = cache_plan(b, cw, kw, vw, aligned)
    hit = np.zeros(b, bool)
    way_out = np.full(b, -99, np.int32)
    vals = np.full((b, vw), -99, np.int32)
    loads, stores = defaultdict(list), defaultdict(Counter)
    block = cv.reshape(sets, cw * vw)
    if plan["serve"]:
        chunks = vw // 4
        for lanes in _lanes(plan, 4):
            cand, held = [-1] * WARP, [np.zeros(4, np.int32)] * WARP
            for lane, i, gl in lanes:
                if i >= b:
                    continue
                s = int(cset[i])
                loads[i] += [("id", None, None, 4, False),
                             ("query", None, None, 8, False)]
                if not 0 <= s < sets:
                    continue
                held[lane] = block[s, gl * 4:gl * 4 + 4]
                loads[i].append(("vals", s, gl * 4, 16, False))
                if gl < cw:
                    loads[i] += [("key", s, gl, 8, False),
                                 ("meta", s, gl, 4, False)]
                    eq = cm[s, gl] > 0 and bool((ck[s, gl] == keys[i]).all())
                    cand[lane] = gl if eq else -1
            cand = _xor_max(cand, (2, 1))
            win = [cand[lane & ~15] for lane in range(WARP)]
            for lane, i, gl in lanes:
                if i >= b:
                    continue
                h = win[lane] >= 0
                if gl // chunks == (win[lane] if h else 0):
                    c = (gl % chunks) * 4
                    vals[i, c:c + 4] = held[lane] if h else 0
                    stores[i].update(range(c, c + 4))
                if gl == 0:
                    hit[i], way_out[i] = h, win[lane] if h else 0
                    stores[i][-1] += 1
    else:
        for lanes in _lanes(plan, 5):
            best = [-1] * WARP
            for lane, i, _ in lanes:
                if i >= b:
                    continue
                s = int(cset[i])
                if lane == 0:
                    loads[i].append(("id", None, None, 4, False))
                if not 0 <= s < sets:
                    continue
                for w in range(lane, cw, WARP):
                    loads[i].append(("meta", s, w, 4, False))
                    loads[i] += [("key", s, w, 4, False)] * kw
                    if cm[s, w] > 0 and (ck[s, w] == keys[i]).all():
                        best[lane] = w
            best = _xor_max(best, (16, 8, 4, 2, 1))
            for lane, i, _ in lanes:
                if i >= b:
                    continue
                h = best[lane] >= 0
                s = int(cset[i])
                if lane == 0:
                    hit[i], way_out[i] = h, best[lane] if h else 0
                    stores[i][-1] += 1
                for j in range(lane, vw, WARP):
                    vals[i, j] = cv[s, best[lane], j] if h else 0
                    if h:
                        loads[i].append(("vals", s, best[lane] * vw + j, 4,
                                         True))
                    stores[i][j] += 1
    return hit, way_out, vals, loads, stores, plan


def _pallas_probe(c):
    want = jhp.probe(*(jnp.asarray(c[k]) for k in (
        "bucket_keys", "bucket_ptr", "keys", "h1", "h2")), interpret=True)
    return [np.asarray(x) for x in want]


def _pallas_cache_probe(c):
    want = jhp.cache_probe(*(jnp.asarray(c[k]) for k in (
        "cache_keys", "cache_vals", "cache_meta", "keys", "cset")),
        interpret=True)
    return [np.asarray(x) for x in want]


def test_launch_plans_at_the_main_path_batches():
    """The serve widths (W 8, KW 2; CW 4, VW 16): 16 lanes a request, two
    requests a warp, CTAs of 256 threads: 16 at the engine's batch (256),
    4,096 at the load phase's (65,536), one at B = 1. Other widths: L =
    min(16, W to a power of two) lanes a bucket, a warp a cache
    request."""
    assert probe_plan(256, 8, 2) == dict(serve=True, half_shift=3,
                                         threads=256, blocks=16)
    assert probe_plan(65536, 8, 2) == dict(serve=True, half_shift=3,
                                           threads=256, blocks=4096)
    assert probe_plan(1, 8, 2)["blocks"] == 1
    assert cache_plan(256, 4, 2, 16) == dict(serve=True, group=16,
                                             threads=256, blocks=16)
    assert cache_plan(65536, 4, 2, 16)["blocks"] == 4096
    assert not probe_plan(256, 8, 2, aligned=False)["serve"]
    assert [probe_plan(7, w, 2)["half_shift"] for w in (1, 2, 3, 8, 16, 40)] \
        == [0, 1, 2, 3, 4, 4]
    assert cache_plan(256, 40, 3, 33) == dict(serve=False, group=32,
                                              threads=256, blocks=32)


def _check_probe_loads(c, loads, stores, plan, b):
    """Every request stores once; each in-range side loads every way of
    its bucket exactly once, an out-of-range side none; at the serve widths
    one 8-byte key load and one pointer load a lane, a side's key loads one
    whole 64-byte bucket row."""
    rows, w, _ = c["bucket_keys"].shape
    assert sorted(stores) == list(range(b)) and set(stores.values()) == {1}
    for i in range(b):
        got = loads[i]
        for side, h in enumerate((c["h1"][i], c["h2"][i])):
            assert got.count(("id", side, None, 4)) == 1 << plan["half_shift"]
        ways = Counter((r, wy) for what, r, wy, _ in got if what == "ptr")
        want = Counter((int(h), wy) for h in (c["h1"][i], c["h2"][i])
                       if 0 <= h < rows for wy in range(w))
        assert ways == want
        if plan["serve"]:
            keyl = [(r, wy) for what, r, wy, n in got if what == "key"]
            assert sorted(keyl) == sorted(want.elements())
            assert all(n == 8 for what, _, _, n in got if what == "key")


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", PROBE_SHAPES)
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_model_matches_plain_and_pallas(case, shape, b):
    """The model's found/ptr equal the plain version's (ids out of range
    matching nothing) and, where every id is in range, the Pallas
    kernel's; its loads and stores are the lane map's."""
    nb, w, kw = shape
    c = probe_case(case, seed=nb * 10 + b, nb=nb, w=w, kw=kw, b=b)
    found, ptr, loads, stores, plan = model_probe(**c)
    want = plain_probe(**to_torch(c))
    np.testing.assert_array_equal(found, want[0].numpy())
    np.testing.assert_array_equal(ptr, want[1].numpy())
    if case in PROBE_IN_RANGE:
        pf, pp = _pallas_probe(c)
        np.testing.assert_array_equal(found, pf)
        np.testing.assert_array_equal(ptr, pp)
    _check_probe_loads(c, loads, stores, plan, b)


def test_probe_model_unaligned_keys_take_the_run_time_instance():
    """Keys that start 4-byte but not 8-byte aligned: the run-time instance
    (4-byte key loads, a pointer load and KW key loads a way), the same
    answers."""
    c = probe_case("random", seed=3, nb=16, w=8, kw=2, b=37)
    found, ptr, loads, stores, plan = model_probe(**c, aligned=False)
    assert not plan["serve"]
    want = plain_probe(**to_torch(c))
    np.testing.assert_array_equal(found, want[0].numpy())
    np.testing.assert_array_equal(ptr, want[1].numpy())
    _check_probe_loads(c, loads, stores, plan, 37)
    assert all(n == 4 for ld in loads.values() for _, _, _, n in ld)


def test_probe_model_covers_a_multi_cta_batch_once():
    """401 requests at the serve widths: 26 CTAs, the last one ragged,
    each request stored once, the plain version's answers."""
    c = probe_case("random", seed=5, nb=64, w=8, kw=2, b=401)
    found, ptr, loads, stores, plan = model_probe(**c)
    assert plan["blocks"] == 26
    want = plain_probe(**to_torch(c))
    np.testing.assert_array_equal(found, want[0].numpy())
    np.testing.assert_array_equal(ptr, want[1].numpy())
    _check_probe_loads(c, loads, stores, plan, 401)


def _check_cache_loads(c, loads, stores, plan, b):
    """Each output word stored once, hit and way once; at the serve widths
    the set's whole value block loaded once in 16-byte chunks, every way's
    key and meta once, nothing after the reduction; otherwise the winning
    line after it, VW words of it on a hit and none on a miss. An
    out-of-range set loads nothing but its id and the query."""
    sets, cw, _ = c["cache_keys"].shape
    vw = c["cache_vals"].shape[2]
    for i in range(b):
        assert stores[i] == Counter({j: 1 for j in range(-1, vw)})
        s = int(c["cset"][i])
        state = [ld for ld in loads[i] if ld[0] not in ("id", "query")]
        if not 0 <= s < sets:
            assert state == []
            continue
        assert Counter(w for what, _, w, _, _ in state if what == "meta") \
            == Counter(range(cw))
        if plan["serve"]:
            words = sorted(x for what, _, x, _, _ in state if what == "vals")
            assert words == list(range(0, cw * vw, 4))
            assert not any(after for *_, after in state)
        else:
            line = [x for what, _, x, _, after in state
                    if what == "vals" and after]
            assert len(line) in (0, vw)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", CACHE_SHAPES)
@pytest.mark.parametrize("case", CACHE_CASES)
def test_cache_probe_model_matches_plain_and_pallas(case, shape, b):
    """The model's hit/way/line equal the plain version's (set ids out of
    range hitting nothing) and, where ids are in range and at most one way
    matches, the Pallas kernel's; its loads and stores are the lane
    map's."""
    cs, cw, kw, vw = shape
    c = cache_case(case, seed=cs * 10 + b, cs=cs, cw=cw, kw=kw, vw=vw, b=b)
    hit, way, vals, loads, stores, plan = model_cache_probe(**c)
    want = plain_cache_probe(**to_torch(c))
    for got, ref_out in zip((hit, way, vals), want):
        np.testing.assert_array_equal(got, ref_out.numpy())
    if case in CACHE_PALLAS:
        for got, pal in zip((hit, way, vals), _pallas_cache_probe(c)):
            np.testing.assert_array_equal(got, pal)
    _check_cache_loads(c, loads, stores, plan, b)


@pytest.mark.parametrize("aligned", [True, False])
def test_cache_probe_model_serve_widths_both_instances(aligned):
    """The serve widths over a multi-CTA batch, aligned (the speculative
    16-lane map) and not (the warp a request): the same answers."""
    c = cache_case("random", seed=9, cs=64, cw=4, kw=2, vw=16, b=300)
    hit, way, vals, loads, stores, plan = model_cache_probe(
        **c, aligned=aligned)
    assert plan["serve"] == aligned and plan["blocks"] > 1
    want = plain_cache_probe(**to_torch(c))
    for got, ref_out in zip((hit, way, vals), want):
        np.testing.assert_array_equal(got, ref_out.numpy())
    _check_cache_loads(c, loads, stores, plan, 300)
    assert int(hit.sum()) > 0 and not hit.all()


def _check_get_loads(c, loads, stores, plan, b, found):
    """probe's loads and one found store a request; then each output word
    stored once, and VW row loads, one a word, of row min(ptr, NP) on a
    hit, none on a miss."""
    _check_probe_loads(c, loads, Counter({i: stores[i][-1]
                                          for i in range(b)}), plan, b)
    np_row, vw = c["pool"].shape[0] - 1, c["pool"].shape[1]
    ptr = plain_probe(**to_torch({k: c[k] for k in PROBE_KEYS}))[1].numpy()
    for i in range(b):
        assert stores[i] == Counter({j: 1 for j in range(-1, vw)})
        row = sorted((r, j) for what, r, j, n in loads[i] if what == "row")
        assert row == ([(min(int(ptr[i]), np_row), j) for j in range(vw)]
                       if found[i] else [])


def _get_against_plain_and_pallas(c, case, b, aligned=True):
    """The model's vals and found against the plain version's (ids out of
    range matching nothing) and, where every id is in range, the Pallas
    ``get``'s; its loads and stores against the lane map. Returns the
    model's plan and found."""
    vals, found, loads, stores, plan = model_get_walk(
        *(c[k] for k in GET_KEYS), aligned=aligned)
    want = plain_get(**to_torch({k: c[k] for k in GET_KEYS}))
    np.testing.assert_array_equal(vals, want[0].numpy())
    np.testing.assert_array_equal(found, want[1].numpy())
    if case in GET_IN_RANGE:
        pv, pf = jhp.get(*(jnp.asarray(c[k]) for k in GET_KEYS),
                         interpret=True)
        np.testing.assert_array_equal(vals, np.asarray(pv))
        np.testing.assert_array_equal(found, np.asarray(pf))
    _check_get_loads(c, loads, stores, plan, b, found)
    return plan, found


def test_get_walk_launch_plans_at_the_main_path_batches():
    """orca_get launches as orca_probe does (16 lanes a request at the
    serve widths: 16 CTAs at the engine's batch, 4,096 at 65,536), and
    takes the serve instance only at 16 value words with aligned keys."""
    assert get_plan(256, 8, 2, 16) == probe_plan(256, 8, 2)
    assert get_plan(65536, 8, 2, 16)["blocks"] == 4096
    assert not get_plan(256, 8, 2, 8)["serve"]
    assert not get_plan(256, 8, 2, 16, aligned=False)["serve"]
    assert get_plan(401, 40, 3, 33) == dict(serve=False, half_shift=4,
                                            threads=256, blocks=51)


@pytest.mark.parametrize("b", GET_BATCHES)
@pytest.mark.parametrize("shape", GET_SHAPES)
@pytest.mark.parametrize("case", GET_CASES)
def test_get_walk_model_matches_plain_and_pallas(case, shape, b):
    """Every case at both instances (the serve widths, then the run-time
    ones): the model's vals and found equal the plain ``hash_get``'s and
    the Pallas ``get``'s bit for bit; rows are read on hits only, at
    min(ptr, NP), and every output word is stored once."""
    nb, w, kw, np_, vw = shape
    c = get_case(case, seed=nb * 10 + b, nb=nb, w=w, kw=kw, np_=np_, vw=vw,
                 b=b)
    plan, found = _get_against_plain_and_pallas(c, case, b)
    assert plan["serve"] == (shape == GET_SHAPES[0])
    if case in ("all_miss", "out_of_range") or b == 1:
        return
    assert found.any()
    if case == "ptr_above_np":  # some hits read the sentinel row
        ptr = plain_probe(**to_torch({k: c[k] for k in PROBE_KEYS}))[1]
        assert bool((found & (ptr.numpy() >= np_)).any())


@pytest.mark.parametrize("case", ["random", "retargeted", "ptr_above_np"])
def test_get_walk_model_unaligned_keys_take_the_run_time_instance(case):
    """Keys that start 4-byte but not 8-byte aligned at the serve widths:
    the run-time instance (4-byte loads, a lane a word of the row), the
    same answers."""
    c = get_case(case, seed=3, nb=16, w=8, kw=2, np_=1000, vw=16, b=256)
    plan, _ = _get_against_plain_and_pallas(c, case, 256, aligned=False)
    assert not plan["serve"]


def test_pallas_cache_kernel_sums_two_matching_ways():
    """Why ``max_way`` is held against the plain version only: the Pallas
    kernel returns the sum of the matching ways' lines (kvstore admits a
    key once a set), the plain versions and the CUDA kernel the max way's
    line."""
    c = cache_case("max_way", seed=1, cs=8, cw=4, kw=2, vw=16, b=5)
    hit, way, vals, *_ = model_cache_probe(**c)
    pal = _pallas_cache_probe(c)
    np.testing.assert_array_equal(hit, pal[0])
    np.testing.assert_array_equal(way, pal[1])
    assert not np.array_equal(vals, pal[2])
    s = c["cset"]
    np.testing.assert_array_equal(vals, c["cache_vals"][s, way])


@pytest.mark.parametrize("name", ["scripts/hash_probe_ab.py",
                                  "tests/hash_probe_cases.py"])
def test_card_side_files_import_neither_jax_nor_repro(name):
    """The A/B script and the cases it shares with the card tests run where
    there is no JAX."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / name)
                     .read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], mods


def test_chip_smoke_names_kernels_under_any_namespace_hash():
    """``chip_smoke.py``'s device phase finds the lookups by name in nvcc's
    mangled names, whose namespace for a file is a hash of its path: the
    shortest <length><identifier> ending in ``_kernel`` is the name, even
    where the hash's digits spell a longer one."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_names", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ns = "_ZN36_INTERNAL_52bc5651_13_hash_probe_cu_a59e75e2"
    assert cs.kernel_name(ns + "12probe_kernelILi8ELi2EEEvPKiS2_") == \
        "probe_kernel<8,2>"
    assert cs.kernel_name(ns + "18cache_probe_kernelILi0ELi0ELi0EEEvPKi") \
        == "cache_probe_kernel<0,0,0>"
    assert cs.kernel_name(ns + "18cache_probe_kernelEPKiS2_") == \
        "cache_probe_kernel"
    assert cs.kernel_name(ns + "15get_walk_kernelILi8ELi2ELi16EEEvPKiS2_") \
        == "get_walk_kernel<8,2,16>"
    assert cs.kernel_name("_ZN12_GLOBAL__N_118flash_wgmma_kernelI13__nv_"
                          "bfloat16Li128EEEvPKS1_") == \
        "flash_wgmma_kernel<bf16,128>"


def test_chip_smoke_kvs_kernels_name_their_tpu_functions():
    """``chip_smoke.py`` lists every hash kernel of the port, each beside
    the def line of the JAX function it replaces (``get_walk``: ``get``,
    which composes the Pallas ``probe`` and ``fetch``), and splits them
    into the engine's path and ``fetch``, held in the kernel phase only."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import hash_probe as hp

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_kvs",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.KVS_MAIN_PATH) | set(cs.CHECK_ONLY) == set(hp.KERNELS)
    assert not set(cs.KVS_MAIN_PATH) & set(cs.CHECK_ONLY)
    for name in hp.KERNELS:
        src, jax_file, line = cs.KERNELS[name]
        assert src == "hash_probe.cu"
        want = "get" if name == "get_walk" else name
        text = (root / jax_file).read_text().splitlines()[line - 1]
        assert text.startswith(f"def {want}("), (name, text)
