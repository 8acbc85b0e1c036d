"""A plain numpy model of the CUDA TX commit kernel
(``src/repro_torch/kernels/csrc/tx_commit.cu``), held on the CPU against
the plain version, so that the kernel's index logic is checked before it
runs on a card:

- the launch plan: T transactions a CTA (the most whose warp tasks fit in
  32 warps), one warp per task, 16-byte chunks where a part's width and
  pointers allow them;
- the lane map of a task: a 32-chunk segment of one row (wide rows) or
  ``32 // chunks`` whole rows (narrow ones), the row's target loaded by
  one lane and taken from it by a shuffle, the payload loaded once and
  written to every replica;
- the sentinel rule: a sentinel target stores nothing in its task; one
  more CTA beside the scattering ones reads every target of the launch
  and zeroes each sentinel row that some target aims at, once.

The model follows the kernel lane by lane and counts its stores, so a
chunk written twice, or a store aimed at a sentinel row outside the
zeroing pass, fails a test.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tx_commit_cases import CASES, edge_case, plain_dropping_out_of_range, \
    to_torch

WARP, MAX_WARPS, SCAN_WARPS, HOLD, SCAN = 32, 4, 16, 8, 16


def make_part(limit, words, vec, rows, cta_rows, tgt_stride):
    """``make_part`` of the kernel: a part's geometry."""
    chunks = words // vec if words > 0 else 1
    task_rows = WARP // chunks if chunks <= WARP else 1
    tasks = -(-cta_rows // task_rows) if rows > 0 and words > 0 else 0
    return dict(limit=limit, words=words, vec=vec, rows=rows,
                cta_rows=cta_rows, tgt_stride=tgt_stride, chunks=chunks,
                task_rows=task_rows, tasks=tasks, rpl=WARP // task_rows)


def launch_plan(b, m, tw, vw, lc, nk, rows_stride, vl, vs, r=3):
    """(T, blocks, threads, log part, store part, speculate) as
    ``launch`` picks them, blocks counting the zeroing CTA; vl/vs: 4 where
    a part moves as int4, else 1; r replicas. ``speculate``: the zeroing
    CTA has a thread for every sentinel word and zeroes them as it
    starts."""
    def tasks(t):
        return (make_part(0, tw, vl, 1, t, 0)["tasks"]
                + make_part(0, vw, vs, 1, t * m, 0)["tasks"])

    t = 1
    while t < b and tasks(t + 1) <= MAX_WARPS:
        t += 1
    lp = make_part(lc, tw, vl, b, t, b)
    sp = make_part(nk, vw, vs, b * m, t * m, rows_stride)

    def jobs(n, vectors):
        return vectors * -(-n // (SCAN * WARP))

    scan_jobs = jobs(b, r) + jobs(b * m, r if rows_stride else 1)
    word_warps = -(-r * (tw + vw) // WARP)
    speculate = r <= WARP and word_warps <= SCAN_WARPS
    warps = max(lp["tasks"] + sp["tasks"], scan_jobs,
                word_warps if speculate else 0)
    warps = min(warps, SCAN_WARPS)
    return t, -(-b // t) + 1, warps * WARP, lp, sp, speculate


def div_small(n, d):
    """The kernel's n / d for a lane index: a multiply by ceil(2^32 / d)
    (64 bits) and a shift."""
    assert 0 <= n < 4096 and 1 <= d <= 1024
    return (n * ((2**32 + d - 1) // d) % 2**64) >> 32


def lane_of(p, lane):
    wide = p["chunks"] > WARP
    row = 0 if wide else div_small(lane, p["chunks"])
    chunk0 = lane if wide else lane - row * p["chunks"]
    t_rep = div_small(lane, p["task_rows"])
    t_row = lane - t_rep * p["task_rows"]
    return dict(row=row, chunk0=chunk0, t_rep=t_rep, t_row=t_row,
                t_valid=t_rep < p["rpl"])


def scatter(p, dst, src, tgt, block, task, replicas, stores):
    """One warp task of part ``p`` in CTA ``block``; ``dst`` (R, limit+1,
    W), ``src`` (rows, W), ``tgt`` flat; counts stores per chunk written
    in ``stores`` (R, limit+1)."""
    lanes = [lane_of(p, lane) for lane in range(WARP)]
    row0 = task * p["task_rows"]
    base = block * p["cta_rows"]
    vec = p["vec"]
    in_task = [ln["row"] < p["task_rows"] and row0 + ln["row"] < p["cta_rows"]
               and base + row0 + ln["row"] < p["rows"] for ln in lanes]
    for c00 in range(0, p["chunks"], HOLD * WARP):
        val = []
        for ln, a in zip(lanes, in_task):
            row = base + row0 + ln["row"]
            held = []
            for h in range(HOLD):
                c = c00 + ln["chunk0"] + h * WARP
                held.append(src[row, c * vec:(c + 1) * vec].copy()
                            if a and c < p["chunks"] else None)
            val.append(held)
        for r0 in range(0, replicas, p["rpl"]):
            t = []
            for ln in lanes:
                tr, trow = r0 + ln["t_rep"], row0 + ln["t_row"]
                ok = (ln["t_valid"] and tr < replicas
                      and trow < p["cta_rows"] and base + trow < p["rows"])
                t.append(int(tgt[tr * p["tgt_stride"] + base + trow]) if ok
                         else -1)
            for r in range(r0, min(replicas, r0 + p["rpl"])):
                for ln, a, held in zip(lanes, in_task, val):
                    g = t[((r - r0) * p["task_rows"] + ln["row"]) % WARP]
                    if not a or not 0 <= g < p["limit"]:
                        continue
                    for h, v in enumerate(held):
                        c = c00 + ln["chunk0"] + h * WARP
                        if c < p["chunks"]:
                            dst[r, g, c * vec:(c + 1) * vec] = v
                            stores[r, g] += 1


def zero_sentinels(p, dst, tgt, replicas, stores, speculate):
    """The zeroing CTA: every target read, each aimed-at sentinel row made
    zero once, word by word; speculating, every sentinel row is zeroed
    first and a row no target aims at is put back (two stores a word)."""
    for r in range(replicas):
        mine = tgt[r * p["tgt_stride"]:r * p["tgt_stride"] + p["rows"]]
        aimed = (mine == p["limit"]).any()
        if speculate:
            old = dst[r, p["limit"]].copy()
            dst[r, p["limit"]] = 0
            stores[r, p["limit"]] += p["words"]
            if not aimed:
                dst[r, p["limit"]] = old
                stores[r, p["limit"]] += p["words"]
        elif aimed:
            dst[r, p["limit"]] = 0
            stores[r, p["limit"]] += p["words"]


def model_commit(log, store, batch, values, slot, rows, vl=1, vs=1):
    """The kernel on numpy arrays, IN PLACE: log (R, LC+1, TW), store
    (R, NK+1, VW), slot (R, B), rows (B*M,) or (R, B*M). Returns the
    stores per log row and per store row, the zeroing included, and the
    plan."""
    r, lcp, tw = log.shape
    vw = store.shape[2]
    b, m = values.shape[:2]
    stride = 0 if rows.ndim == 1 else b * m
    plan = launch_plan(b, m, tw, vw, lcp - 1, store.shape[1] - 1, stride,
                       vl, vs, r)
    t, blocks, threads, lp, sp, speculate = plan
    parts = ((lp, log, batch, slot.reshape(-1)),
             (sp, store, values.reshape(b * m, vw), rows.reshape(-1)))
    counts = [np.zeros(x.shape[:2], np.int64) for x in (log, store)]
    for block in range(blocks - 1):
        for warp in range(threads // WARP):
            for task in range(warp, lp["tasks"] + sp["tasks"],
                              threads // WARP):
                k = 0 if task < lp["tasks"] else 1
                p, dst, src, tgt = parts[k]
                scatter(p, dst, src, tgt, block,
                        task - (lp["tasks"] if k else 0), r, counts[k])
    for (p, dst, _, tgt), n in zip(parts, counts):
        zero_sentinels(p, dst, tgt, r, n, speculate)
    return counts, plan


def _vec(words):
    return 4 if words % 4 == 0 else 1


def test_launch_plan_at_the_engine_and_replay_shapes():
    """The TX serve shape (B 256, M 8, VW 16, TW 137): 2 transactions a
    CTA (a log row and 8 store rows a warp), 128 CTAs and the zeroing CTA,
    15 warps (the zeroing CTA's 15 jobs of targets, and a thread for each
    of the 459 sentinel words); a replayed record: one CTA and the zeroing
    CTA, of 5 warps (a thread for each of the 153 sentinel words)."""
    tw = 1 + 8 * 17
    t, blocks, threads, lp, sp, spec = launch_plan(
        256, 8, tw, 16, 2**18, 2**24, 256 * 8, 1, 4)
    assert (t, blocks, threads) == (2, 129, 15 * WARP)
    assert (lp["tasks"], sp["task_rows"], sp["tasks"], spec) == \
        (2, 8, 2, True)
    assert launch_plan(1, 8, tw, 16, 2**18, 2**24, 0, 1, 4, r=1)[:3] == \
        (1, 2, 5 * WARP)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("r,b,m,vw,shared", [
    (3, 9, 8, 16, False),   # the engine's widths: wide log, int4 store rows
    (3, 7, 4, 3, True),     # VW 3: no 16-byte stores, 10 rows a task
    (1, 1, 8, 16, False),   # a replayed record
    (2, 13, 3, 41, False),  # VW 41: scalar store rows of two segments
    (3, 6, 2, 12, True),    # TW 27 scalar, VW 12 in int4 chunks
    (2, 10, 3, 4, False),   # TW 16: int4 log rows too; a store row a lane
    (3, 5, 4, 40, False),   # 615 sentinel words: zeroed after the read
])
def test_model_matches_plain_version(case, r, b, m, vw, shared):
    """The model gives the plain version's state on every edge case, writes
    each live chunk once per replica, and stores to a sentinel row only in
    the zeroing pass: its width once, where a target aims at it."""
    tw = 1 + m * (1 + vw)
    lc, nk = 3 * b + 2, 4 * b * m + 5
    c = edge_case(case, seed=r * 100 + b, r=r, b=b, m=m, vw=vw, lc=lc,
                  nk=nk, shared_rows=shared)
    want = to_torch(c)
    plain_dropping_out_of_range(want["log"], want["store"], want["batch"],
                                want["values"], want["slot"], want["rows"])
    log, store = c["log"].copy(), c["store"].copy()
    (n_log, n_store), plan = model_commit(
        log, store, c["batch"], c["values"], c["slot"], c["rows"],
        _vec(tw), _vec(vw))
    np.testing.assert_array_equal(log, want["log"].numpy())
    np.testing.assert_array_equal(store, want["store"].numpy())
    rows = c["rows"] if c["rows"].ndim == 2 else np.broadcast_to(
        c["rows"], (r, b * m))
    for k in range(r):
        live_s = c["slot"][k][(c["slot"][k] >= 0) & (c["slot"][k] < lc)]
        live_w = rows[k][(rows[k] >= 0) & (rows[k] < nk)]
        assert (n_log[k, live_s] == plan[3]["chunks"]).all()
        assert (n_store[k, live_w] == plan[4]["chunks"]).all()
        assert n_log[k, :lc].sum() == live_s.size * plan[3]["chunks"]
        assert n_store[k, :nk].sum() == live_w.size * plan[4]["chunks"]
        # an aimed-at row: zeroed once; one no target aims at: untouched,
        # or, speculating, zeroed and put back
        for n, aimed, width in ((n_log[k, lc], (c["slot"][k] == lc).any(), tw),
                                (n_store[k, nk], (rows[k] == nk).any(), vw)):
            assert n == (width if aimed else 2 * width if plan[5] else 0)


def test_model_covers_a_multi_cta_batch_once():
    """A batch of several CTAs with a ragged last one, every target live:
    each (replica, row, chunk) is written exactly once, vectors and
    scalars alike, and the sentinel rows keep their contents."""
    r, b, m, vw = 2, 53, 3, 8
    tw = 1 + m * (1 + vw)
    c = edge_case("sentinel_not_aimed", seed=5, r=r, b=b, m=m, vw=vw,
                  lc=b, nk=b * m)
    for vl, vs in ((1, 1), (1, 4)):
        log, store = c["log"].copy(), c["store"].copy()
        (n_log, n_store), plan = model_commit(
            log, store, c["batch"], c["values"], c["slot"], c["rows"], vl, vs)
        assert plan[1] > 2 and b % plan[0]
        again = 2 if plan[5] else 0  # speculating: zeroed and put back
        assert (n_log[:, :b] == tw // vl).all()
        assert (n_log[:, b] == again * tw).all()
        assert (n_store[:, :b * m] == vw // vs).all()
        assert (n_store[:, b * m] == again * vw).all()
        assert (log[:, :b] == c["batch"][np.argsort(c["slot"], axis=1)]).all()
        want = to_torch(c)
        plain_dropping_out_of_range(*(want[k] for k in (
            "log", "store", "batch", "values", "slot", "rows")))
        np.testing.assert_array_equal(store, want["store"].numpy())
        assert torch.equal(torch.from_numpy(log), want["log"])


def test_model_zeroes_an_aimed_sentinel_once_per_launch():
    """A batch over several CTAs, most of whose targets aim at the
    sentinel rows: each row takes its width in stores once, however many
    CTAs meet it, and the state is the plain version's."""
    r, b, m, vw = 3, 30, 8, 16
    c = edge_case("sentinel_aimed", seed=9, r=r, b=b, m=m, vw=vw, lc=64,
                  nk=512)
    want = to_torch(c)
    plain_dropping_out_of_range(*(want[k] for k in (
        "log", "store", "batch", "values", "slot", "rows")))
    (n_log, n_store), plan = model_commit(
        c["log"], c["store"], c["batch"], c["values"], c["slot"], c["rows"],
        1, 4)
    assert plan[1] > 2
    assert (n_log[:, 64] == 1 + m * (1 + vw)).all()
    assert (n_store[:, 512] == vw).all()
    np.testing.assert_array_equal(c["log"], want["log"].numpy())
    np.testing.assert_array_equal(c["store"], want["store"].numpy())
