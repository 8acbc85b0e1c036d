#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the ORCA request engine serving the KVS app
— through the hand-written CUDA kernels, at the size of the paper's KVS
working set, and holds every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line:

1. device  — the card's name and power limit (nvidia-smi), the kernel build;
2. load    — 2^26 distinct keys PUT into a store of 2^24 buckets x 8 ways
             and 2^27 64-B values behind a 65,536 x 4 hot-set cache;
3. kernels — each kernel against its plain version at the engine's batch
             (256 requests on the loaded store), bit for bit, and timed;
4. serve   — 200 engine steps at budget 256 (95% GET / 5% PUT, zipf 0.99
             keys, 1% absent) through two engines, ``auto`` (the kernels)
             and ``ref`` (the plain versions on the card): responses and
             final states must be equal, every GET of a loaded key no PUT
             touched must return its loaded value, and every kernel must
             have launched.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
Any mismatch raises and exits non-zero before the last line. Without a
CUDA device, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# the paper's KVS working set: ~7 GB of 64-B values behind a 512 MB-class
# cache (benchmarks/bench_kvs.py); here ~8.6 GB of pool + 1.6 GB of buckets
KV_SHAPE = dict(num_buckets=2**24, ways=8, key_words=2, val_words=16,
                pool_size=2**27, cache_sets=65536, cache_ways=4)
N_KEYS = 2**26
FILL_BATCH = 65536
BATCH = 256  # the paper's outstanding requests = the engine budget
STEPS = 200
QUEUES = 32
CAPACITY = 64
ZIPF = 0.99
KEY_MULT = 0x9E3779B1 % N_KEYS | 1  # odd: rank -> key index is a bijection

# the TPU kernel each CUDA kernel replaces: its def line in the JAX package
KERNELS = {
    "probe": 67, "fetch": 170, "cache_probe": 122, "commit_buckets": 226,
    "write_rows": 277,
}
JAX_FILE = "src/repro/kernels/hash_probe.py"
SOURCE = "src/repro_torch/kernels/csrc/hash_probe.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _fmix32(x):
    """murmur3's 32-bit finaliser on int64 tensors: a bijection of 32-bit
    values that spreads every input bit over the low bits the bucket and
    set hashes keep."""
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def key_words(idx, torch):
    """(N, 2) int32 keys of key indices ``idx`` (int64, < 2^32): word 0 is a
    bijection of the index, so distinct indices give distinct keys."""
    words = torch.stack([_fmix32(idx), _fmix32(idx ^ 0x5BD1E995)], dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def loaded_values(idx, val_words, torch):
    """(N, VW) int32 value of key index ``idx``: a function of the key."""
    j = torch.arange(val_words, dtype=torch.int64, device=idx.device)
    v = ((idx[:, None] * 16 + j[None, :]) * 2246822519 + 12345) & 0x7FFFFFFF
    return v.to(torch.int32)


def time_us(torch, fn, reps=50, warmup=5):
    """Median per-call time in µs by CUDA events (one pair per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1000.0


def device_us(torch, fn, reps=20):
    """Run ``fn`` ``reps`` times under torch.profiler. Returns (device µs per
    call over every kernel and copy it ran on the card, {kernel name:
    (device µs, launches) per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per.get(e.name, (0.0, 0.0))
            per[e.name] = (us + e.device_time_total / reps, n + 1 / reps)
    return sum(us for us, _ in per.values()), per


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| (0 when equal), over the differing elements
    only: the commit outputs are whole multi-GB state arrays."""
    diff = got != want
    if not bool(diff.any()):
        return 0
    return int((got[diff].to(torch.int64) - want[diff].to(torch.int64))
               .abs().max())


def mismatches(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    return int((got != want).sum())


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


def phase_device(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build(build.sources())
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0})
    return smi


def phase_load(torch, kv, hp):
    cfg = kv.KVConfig(**KV_SHAPE)
    state = kv.make(cfg, device="cuda")
    stored = torch.zeros((N_KEYS,), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, N_KEYS, FILL_BATCH):
        idx = torch.arange(start, start + FILL_BATCH, device="cuda")
        state, ok = kv.put(state, key_words(idx, torch),
                           loaded_values(idx, cfg.val_words, torch),
                           backend="auto")
        stored[start: start + FILL_BATCH] = ok
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    out = {"phase": "load", "keys": N_KEYS, "batch": FILL_BATCH,
           "fill_s": fill_s, "puts_per_s": N_KEYS / fill_s,
           "ok": int(stored.sum()), "alloc": int(state.alloc),
           "dropped": int(state.dropped),
           "state_gb": sum(t.numel() * 4 for t in state) / 1e9,
           "launches": dict(hp.launches)}
    emit(out)
    if out["ok"] + out["dropped"] != N_KEYS:
        raise AssertionError(f"load: {out['ok']} ok + {out['dropped']} "
                             f"dropped != {N_KEYS}")
    return cfg, state, stored.cpu().numpy()


def phase_kernels(torch, kv, hp, ref, cfg, state):
    """Each kernel against its plain version at the engine's batch."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dev = "cuda"
    # GET mix: recently loaded (likely cached), random loaded, absent
    recent = N_KEYS - 1 - torch.randint(0, FILL_BATCH, (BATCH // 4,),
                                        generator=g, device=dev)
    loaded = torch.randint(0, N_KEYS, (BATCH // 2,), generator=g, device=dev)
    absent = N_KEYS + torch.randint(0, N_KEYS, (BATCH // 4,), generator=g,
                                    device=dev)
    keys = key_words(torch.cat([recent, loaded, absent]), torch)
    nb, np_ = state.num_buckets, state.pool_size
    h1 = kv.hash_keys(keys, nb)
    h2 = kv.hash_keys(keys, nb, salt=kv.OVERFLOW_SALT)
    cset = kv.hash_keys(keys, state.cache_sets, salt=kv.CACHE_SALT)

    # a planned PUT batch: updates, inserts, in-batch duplicates and
    # masked rows (the last two aim at the sentinel rows)
    put_idx = torch.cat([loaded[: BATCH // 2], absent,
                         loaded[: BATCH // 8], recent[: BATCH // 8]])
    put_keys = key_words(put_idx, torch)
    put_vals = torch.randint(-2**31, 2**31 - 1, (BATCH, cfg.val_words),
                             generator=g, device=dev, dtype=torch.int32)
    put_mask = torch.rand((BATCH,), generator=g, device=dev) > 0.1
    plan = kv.plan_put(state, put_keys, put_mask, backend="ref")

    entries = {}

    def record(name, outs_k, outs_p, k_fn, p_fn, nbytes, lib_fn=None):
        miss = sum(mismatches(torch, a, b) for a, b in zip(outs_k, outs_p))
        err = max(max_abs_err(torch, a, b) for a, b in zip(outs_k, outs_p))
        us = time_us(torch, k_fn)
        plain_us = time_us(torch, p_fn)
        lib_us = time_us(torch, lib_fn) if lib_fn is not None else None
        k_dev, k_kernels = device_us(torch, k_fn)
        p_dev, p_kernels = device_us(torch, p_fn)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        entries[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{JAX_FILE}:{KERNELS[name]}",
            "jax_function": f"{JAX_FILE}::{name}", "mismatches": miss,
            "max_abs_err": err, "ms": us / 1e3, "plain_ms": plain_us / 1e3,
            "bound_ms": bound_us / 1e3, "bound_by": "bytes",
            "library_ms": None if lib_us is None else lib_us / 1e3,
            "us": us, "plain_us": plain_us, "library_us": lib_us,
            "bound_us": bound_us, "bytes": nbytes, "batch": BATCH,
            "device_us": k_dev, "plain_device_us": p_dev,
            "plain_device_launches": sum(n for _, n in p_kernels.values()),
        }

    kw, vw, w = cfg.key_words, cfg.val_words, cfg.ways
    cw = cfg.cache_ways
    found_k, ptr_k = hp.probe(state.bucket_keys, state.bucket_ptr, keys, h1, h2)
    found_p, ptr_p = ref.hash_probe(state.bucket_keys, state.bucket_ptr, keys,
                                    h1, h2)
    record("probe", (found_k, ptr_k), (found_p, ptr_p),
           lambda: hp.probe(state.bucket_keys, state.bucket_ptr, keys, h1, h2),
           lambda: ref.hash_probe(state.bucket_keys, state.bucket_ptr, keys,
                                  h1, h2),
           BATCH * (kw * 4 + 8 + 2 * w * (kw + 1) * 4 + 1 + 4))

    ptr = torch.where(found_p, torch.clamp(ptr_p, 0, np_), np_).to(torch.int32)
    ptr64 = ptr.to(torch.int64)
    record("fetch", (hp.fetch(state.pool, ptr),), (ref.fetch(state.pool, ptr),),
           lambda: hp.fetch(state.pool, ptr),
           lambda: ref.fetch(state.pool, ptr),
           BATCH * (4 + 2 * vw * 4),
           lambda: torch.index_select(state.pool, 0, ptr64))

    ck, cv, cm = state.cache_keys, state.cache_vals, state.cache_meta
    outs_k = hp.cache_probe(ck, cv, cm, keys, cset)
    outs_p = ref.cache_probe(ck, cv, cm, keys, cset)
    record("cache_probe", outs_k, outs_p,
           lambda: hp.cache_probe(ck, cv, cm, keys, cset),
           lambda: ref.cache_probe(ck, cv, cm, keys, cset),
           BATCH * (kw * 4 + 4 + cw * (kw + 1) * 4 + 2 * vw * 4 + 5))
    entries["cache_probe"]["hits"] = int(outs_p[0].sum())
    entries["probe"]["found"] = int(found_p.sum())

    # the commits, each applied to its own clone of the state arrays
    bk_k, bp_k = state.bucket_keys.clone(), state.bucket_ptr.clone()
    bk_p, bp_p = state.bucket_keys.clone(), state.bucket_ptr.clone()
    args = (put_keys, plan.tb, plan.tw, plan.bptr_val)
    hp.commit_buckets(bk_k, bp_k, *args)
    ref.commit_buckets(bk_p, bp_p, *args)
    record("commit_buckets", (bk_k, bp_k), (bk_p, bp_p),
           lambda: hp.commit_buckets(bk_k, bp_k, *args),
           lambda: ref.commit_buckets(bk_p, bp_p, *args),
           BATCH * (kw * 4 + 12 + (kw + 1) * 4))
    del bk_k, bp_k, bk_p, bp_p

    pool_k, pool_p = state.pool.clone(), state.pool.clone()
    hp.write_rows(pool_k, put_vals, plan.wp)
    ref.write_rows(pool_p, put_vals, plan.wp)
    wp64 = plan.wp.to(torch.int64)
    record("write_rows", (pool_k,), (pool_p,),
           lambda: hp.write_rows(pool_k, put_vals, plan.wp),
           lambda: ref.write_rows(pool_p, put_vals, plan.wp),
           BATCH * (4 + 2 * vw * 4),
           lambda: pool_k.index_copy_(0, wp64, put_vals))
    entries["write_rows"]["sentinel_entries"] = int((plan.wp == np_).sum())
    del pool_k, pool_p
    torch.cuda.empty_cache()

    emit({"phase": "kernels_vs_plain",
          "results": {k: {f: v[f] for f in ("mismatches", "us", "plain_us",
                                            "library_us", "bound_us",
                                            "device_us", "plain_device_us")}
                      for k, v in entries.items()}})
    bad = {k: v["mismatches"] for k, v in entries.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return entries


def make_stream(torch, cfg, kv):
    """STEPS * BATCH request payloads (on the card) and their key indices,
    ops and absent flags (on the host)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = STEPS * BATCH
    ranks = torch.arange(1, N_KEYS + 1, dtype=torch.float64, device="cuda")
    cdf = torch.cumsum(ranks.pow(-ZIPF), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n,), generator=g, device="cuda", dtype=torch.float64)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=N_KEYS - 1)
    del ranks, cdf
    idx = (rank * KEY_MULT) % N_KEYS
    absent = torch.rand((n,), generator=g, device="cuda") < 0.01
    idx = torch.where(
        absent, N_KEYS + torch.randint(0, N_KEYS, (n,), generator=g,
                                       device="cuda"), idx)
    is_put = torch.rand((n,), generator=g, device="cuda") < 0.05
    op = torch.where(is_put, kv.OP_PUT, kv.OP_GET).to(torch.int32)
    vals = torch.randint(-2**31, 2**31 - 1, (n, cfg.val_words), generator=g,
                         device="cuda", dtype=torch.int32)
    vals = torch.where(is_put[:, None], vals, 0)
    payloads = torch.cat([op[:, None], key_words(idx, torch), vals], dim=1)
    return payloads, idx.cpu().numpy(), op.cpu().numpy(), absent.cpu().numpy()


def serve(torch, eng, kv, cfg, state, payloads, backend):
    """STEPS steps of inject / run_steps / drain. Returns the final state,
    the drained responses, per-step times and the cache counter deltas."""
    w = kv.request_words(cfg)
    ecfg = eng.EngineConfig(num_queues=QUEUES, capacity=CAPACITY,
                            req_words=w, resp_words=w, budget=BATCH,
                            kernel_backend=backend)
    es = eng.make(ecfg, state)
    app_fn = eng.bind_app(kv.app_step, cfg, ecfg)
    qids = torch.arange(QUEUES, dtype=torch.int32, device="cuda")
    waves = BATCH // QUEUES
    drained, step_s = [], []
    totals = {k: 0 for k in ("served", "cache_hits", "cache_misses",
                             "cache_evictions")}
    stats_dev = []
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for s in range(STEPS):
        for v in range(waves):
            lo = (s * waves + v) * QUEUES
            es, accepted = eng.inject(es, qids, payloads[lo: lo + QUEUES],
                                      with_accepted=True)
            if not bool(accepted.all()):
                raise AssertionError(f"step {s}: ring rejected a request")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, stats = eng.run_steps(es, app_fn, ecfg, 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        stats_dev.append(stats)
        pay, counts, es = eng.drain_responses(es, CAPACITY)
        drained.append((pay, counts))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    for st in stats_dev:
        for k in totals:
            totals[k] += int(st[k].sum())
    return es, drained, step_s, loop_s, totals


def profile_steps(torch, eng, kv, cfg, es, payloads, steps=7):
    """Device time of ``steps`` more kernel-engine steps (rings filled first,
    so only the steps are profiled): µs per step summed over every kernel
    and copy, device launches per step, and the costliest kernels."""
    steps = min(steps, STEPS)
    w = kv.request_words(cfg)
    ecfg = eng.EngineConfig(num_queues=QUEUES, capacity=CAPACITY,
                            req_words=w, resp_words=w, budget=BATCH)
    app_fn = eng.bind_app(kv.app_step, cfg, ecfg)
    _, es = eng.drain_responses(es, CAPACITY)[1:]
    qids = torch.arange(QUEUES, dtype=torch.int32, device="cuda")
    for v in range(steps * BATCH // QUEUES):
        es = eng.inject(es, qids, payloads[v * QUEUES: (v + 1) * QUEUES])
    box = [es]

    def run():
        box[0], _ = eng.run_steps(box[0], app_fn, ecfg, steps)

    total, per = device_us(torch, run, reps=1)
    top = sorted(per.items(), key=lambda kv_: -kv_[1][0])[:8]
    return {"steps": steps, "device_us_per_step": total / steps,
            "device_launches_per_step": sum(n for _, n in per.values())
            / steps,
            "top_kernels_us_per_step": {k[:90]: us / steps
                                        for k, (us, _) in top}}


def check_responses(np, drained, idx, op, absent, stored, val_words,
                    loaded_fn):
    """Pair each response with its request (per-queue FIFO) and check it
    against the store's contents: PUTs of stored keys are acknowledged,
    GETs of stored keys that no PUT touched return the loaded value, GETs
    of absent keys that no PUT touched miss. Returns what was checked."""
    n = idx.shape[0]
    req_q = np.arange(n) % QUEUES  # wave-major injection: queue = i % Q
    per_q = [np.flatnonzero(req_q == q) for q in range(QUEUES)]
    head = [0] * QUEUES
    resp = np.full((n, 1 + val_words + 2), -99, np.int64)
    for pay, counts in drained:
        pay, counts = pay.cpu().numpy(), counts.cpu().numpy()
        for q in range(QUEUES):
            c = int(counts[q])
            rows = per_q[q][head[q]: head[q] + c]
            resp[rows] = pay[q, :c]
            head[q] += c
    if sum(head) != n:
        raise AssertionError(f"{sum(head)} responses for {n} requests")
    put_keys = set(idx[op == 2].tolist())
    untouched = np.array([k not in put_keys for k in idx.tolist()])
    is_get = op == 1
    was_stored = ~absent & stored[np.where(absent, 0, idx)]
    if not (resp[(op == 2) & was_stored, 0] == 1).all():
        raise AssertionError("a PUT of a stored key was not acknowledged")
    live = is_get & untouched & was_stored
    want = loaded_fn(idx[live])
    if not (resp[live, 0] == 1).all():
        raise AssertionError("a GET of a loaded key missed")
    if not np.array_equal(resp[live, 1: 1 + val_words], want):
        raise AssertionError("a GET of a loaded key returned a wrong value")
    dead = is_get & untouched & absent
    if not ((resp[dead, 0] == 0).all() and (resp[dead, 1:] == 0).all()):
        raise AssertionError("a GET of an absent key did not miss")
    return {"responses": n, "gets_checked_loaded": int(live.sum()),
            "gets_checked_absent": int(dead.sum()),
            "puts": int((op == 2).sum())}


def phase_serve(torch, np, eng, kv, hp, cfg, state, stored, smi):
    payloads, idx, op, absent = make_stream(torch, cfg, kv)
    runs = {}
    for backend in ("auto", "ref"):
        st = clone_state(state)
        torch.cuda.synchronize()
        hp.reset_launches()
        es, drained, step_s, loop_s, totals = serve(
            torch, eng, kv, cfg, st, payloads, backend)
        runs[backend] = (es, drained, step_s, loop_s, totals,
                         dict(hp.launches))
        del st
    es_k, dr_k, step_k, loop_k, tot_k, launches = runs["auto"]
    es_p, dr_p, step_p, loop_p, tot_p, launches_p = runs["ref"]

    for i, ((pk, ck), (pp, cp)) in enumerate(zip(dr_k, dr_p)):
        if not (torch.equal(ck, cp) and torch.equal(pk, pp)):
            raise AssertionError(f"step {i}: responses differ auto vs ref")

    def flat(x, path=""):
        if isinstance(x, torch.Tensor):
            return [(path, x)]
        return [p for f, v in x._asdict().items() for p in flat(v, f"{path}.{f}")]

    for (name, a), (_, b) in zip(flat(es_k), flat(es_p)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"final state {name} differs auto vs ref")
    dead = [k for k, v in launches.items() if v == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the main path: {dead}")
    if any(launches_p.values()):
        raise AssertionError(f"the ref engine launched kernels: {launches_p}")

    def loaded_fn(ix):
        t = torch.as_tensor(ix, dtype=torch.int64)
        return loaded_values(t, cfg.val_words, torch).numpy()

    checked = check_responses(np, dr_k, idx, op, absent, stored,
                              cfg.val_words, loaded_fn)
    profile = profile_steps(torch, eng, kv, cfg, es_k, payloads)
    profile["idle_share"] = 1 - profile["device_us_per_step"] / (
        statistics.median(step_k) * 1e6)
    out = {"phase": "serve", "nvidia_smi": smi, "steps": STEPS,
           "budget": BATCH, "queues": QUEUES, **checked,
           "served": tot_k["served"], "cache_hits": tot_k["cache_hits"],
           "cache_misses": tot_k["cache_misses"],
           "cache_evictions": tot_k["cache_evictions"],
           "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()},
           "profile": profile}
    for label, step_s, loop_s, tot in (("kernels", step_k, loop_k, tot_k),
                                      ("plain", step_p, loop_p, tot_p)):
        out[label] = {
            "step_us_median": statistics.median(step_s) * 1e6,
            "step_us_p90": sorted(step_s)[int(0.9 * len(step_s))] * 1e6,
            "requests_per_s_steps": tot["served"] / sum(step_s),
            "requests_per_s_loop": tot["served"] / loop_s,
        }
    emit(out)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import engine as eng
    from repro_torch.core import kvstore as kv
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ref

    torch.manual_seed(SEED)
    smi = phase_device(torch, _build)
    cfg, state, stored = phase_load(torch, kv, hp)
    entries = phase_kernels(torch, kv, hp, ref, cfg, state)
    launches = phase_serve(torch, np, eng, kv, hp, cfg, state, stored, smi)
    for name, e in entries.items():
        e["launches"] = launches[name]
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
