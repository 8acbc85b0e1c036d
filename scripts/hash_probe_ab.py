#!/usr/bin/env python3
"""Time two builds of the KVS hash kernels against each other on one card,
in turns (old, new, new, old), on ``chip_smoke.py``'s ``kernels_vs_plain``
inputs on the loaded store (2^24 buckets x 8 ways, 2^26 keys, a 65,536 x 4
cache):

- the lookups (``probe``, ``cache_probe``): the GET mix at B = 1, 256
  (the engine's batch) and 65,536 (the load phase's);
- the PUT commits (``commit_buckets``, ``write_rows``): (a) the kernel
  phase's PUT batch, (b) the serve mix (5% PUTs, about 244 of 256 entries
  aimed at the sentinel rows), (c) one live entry, (d) the load phase's
  65,536 fresh keys;
- the GET walk (``get``): the old build's ``orca_probe``, the clamp and
  select, ``orca_fetch`` and the select zeroing misses (five calls,
  ``chip_smoke.composed_get``) against the new ``orca_get`` (one), at
  B = 1, 256 and 65,536, with the device launches a call.

    git show <rev>:src/repro_torch/kernels/csrc/hash_probe.cu \\
        > _scratch/old/hash_probe.cu
    python3 scripts/hash_probe_ab.py _scratch/old/hash_probe.cu \\
        [--kernels probe,cache_probe,commit_buckets,write_rows,get]

"old" is the given source, built here with the port's nvcc flags into the
ignored build directory and called through its C entry points, which
every version shares (the GET walk through ``orca_probe`` and
``orca_fetch``); "new" is the checkout's ``csrc/hash_probe.cu`` through
its wrapper. Both are held against the plain version bit for bit on
every case, and on every edge case of ``tests/hash_probe_cases.py`` and
``tests/kvs_commit_cases.py``. Each turn reports device µs by
``torch.profiler`` (L2-warm), by CUDA events around calls queued behind a
spin kernel, and with L2 flushed; the report adds the medians of both
turns, the launch floor, the card's name and power limit (``nvidia-smi``),
the SASS scan of both libraries (per kernel: CALLs and global loads),
both builds' times on variants of the inputs that split the time (see
:func:`variants` and :func:`commit_variants`), and the new source built
at other CTA sizes (``ORCA_PROBE_THREADS``; ``ORCA_COMMIT_THREADS``,
which sets both commits' sizes) beside its own.
Prints one JSON line; exits non-zero without a card or on a mismatch.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
T0 = time.perf_counter()
MAX_RSS_GB = 64  # of the GPU machine's 96 GiB of host memory
TURNS = ("old", "new", "new", "old")
CTA_SIZES = (32, 64, 128)  # and the checkout's 256
COMMIT_CTA_SIZES = (32, 64, 128, 256)  # beside the checkout's own sizes
LOOKUPS = ("probe", "cache_probe")
COMMITS = ("commit_buckets", "write_rows")
GETS = ("get",)


class OutOfHostMemory(RuntimeError):
    pass


def progress(what):
    """One line on stderr: the step starting, seconds so far and this
    process's resident host memory; raises past MAX_RSS_GB."""
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS")) / 2**20
    print(f"hash_probe_ab: {what} t={time.perf_counter() - T0:.1f}s "
          f"rss={rss:.2f}GB", file=sys.stderr, flush=True)
    if rss > MAX_RSS_GB:
        raise OutOfHostMemory(f"{rss:.1f} GB resident at {what}")


def build_libs(build, sources: dict):
    """Build each {name: (source, extra nvcc flags)} into the build
    directory, all nvcc processes started together; returns {name:
    (library with the typed lookup entry points, its path)}."""
    from repro_torch.kernels._launch import LL, I, P

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in sources.items():
        out = build.BUILD_DIR / f"hash_probe_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{stderr}{stdout}")
        lib = ctypes.CDLL(str(out))
        lib.orca_probe.argtypes = [P] * 7 + [LL, LL, I, I, P]
        lib.orca_cache_probe.argtypes = [P] * 8 + [LL, LL, I, I, I, P]
        lib.orca_commit_buckets.argtypes = [P] * 6 + [LL, LL, I, I, P]
        lib.orca_write_rows.argtypes = [P] * 3 + [LL, LL, I, P]
        lib.orca_fetch.argtypes = [P] * 3 + [LL, LL, I, P]
        for entry in ("orca_probe", "orca_cache_probe",
                      "orca_commit_buckets", "orca_write_rows",
                      "orca_fetch"):
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, out)
    return libs


def lib_entries(torch, lib, what, cs):
    """The lookups and commits of a built library, called as the wrappers
    call the checkout's, and the GET walk composed of its probe and
    fetch."""
    def check(code):
        if code:
            raise RuntimeError(f"{what} hash_probe: CUDA error {code}")

    def probe(bk, bp, keys, h1, h2):
        b, kw = keys.shape
        found = torch.empty((b,), dtype=torch.bool, device=keys.device)
        ptr = torch.empty((b,), dtype=torch.int32, device=keys.device)
        check(lib.orca_probe(
            bk.data_ptr(), bp.data_ptr(), keys.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), found.data_ptr(), ptr.data_ptr(), b, bk.shape[0],
            bk.shape[1], kw, torch.cuda.current_stream().cuda_stream))
        return found, ptr

    def cache_probe(ck, cv, cm, keys, cset):
        b, kw = keys.shape
        vw = cv.shape[2]
        hit = torch.empty((b,), dtype=torch.bool, device=keys.device)
        way = torch.empty((b,), dtype=torch.int32, device=keys.device)
        vals = torch.empty((b, vw), dtype=torch.int32, device=keys.device)
        check(lib.orca_cache_probe(
            ck.data_ptr(), cv.data_ptr(), cm.data_ptr(), keys.data_ptr(),
            cset.data_ptr(), hit.data_ptr(), way.data_ptr(), vals.data_ptr(),
            b, ck.shape[0], ck.shape[1], kw, vw,
            torch.cuda.current_stream().cuda_stream))
        return hit, way, vals

    def commit_buckets(bk, bp, keys, tb, tw, bptr_val):
        check(lib.orca_commit_buckets(
            bk.data_ptr(), bp.data_ptr(), keys.data_ptr(), tb.data_ptr(),
            tw.data_ptr(), bptr_val.data_ptr(), keys.shape[0],
            bk.shape[0] - 1, bk.shape[1], keys.shape[1],
            torch.cuda.current_stream().cuda_stream))
        return bk, bp

    def write_rows(pool, vals, wp):
        check(lib.orca_write_rows(
            pool.data_ptr(), vals.data_ptr(), wp.data_ptr(), vals.shape[0],
            pool.shape[0] - 1, vals.shape[1],
            torch.cuda.current_stream().cuda_stream))
        return pool

    def fetch(pool, ptr):
        out = torch.empty((ptr.shape[0], pool.shape[1]), dtype=torch.int32,
                          device=ptr.device)
        check(lib.orca_fetch(
            pool.data_ptr(), ptr.data_ptr(), out.data_ptr(), ptr.shape[0],
            pool.shape[0], pool.shape[1],
            torch.cuda.current_stream().cuda_stream))
        return out

    halves = SimpleNamespace(probe=probe, fetch=fetch)

    def get(bucket_keys, bucket_ptr, pool, keys, h1, h2):
        return cs.composed_get(torch, halves, bucket_keys, bucket_ptr, pool,
                               keys, h1, h2)

    return {"probe": probe, "cache_probe": cache_probe,
            "commit_buckets": commit_buckets, "write_rows": write_rows,
            "get": get}


def timings(torch, cs, fn):
    return {"device_us": cs.device_us(torch, fn)[0],
            "device_events_us": cs.queued_us(torch, fn),
            "device_cold_us": cs.cold_device_us(torch, fn)}


def launches_per_call(torch, cs, fn):
    """Device launches a call of ``fn``, by the profiler."""
    return sum(n for _, n in cs.device_us(torch, fn)[1].values())


def _take(torch, idx, mask, n):
    """``n`` of the indices where ``mask`` holds, repeated if fewer; and
    how many distinct there were."""
    hit = idx[mask]
    if hit.numel() == 0:
        raise AssertionError("no candidate for a variant")
    reps = -(-n // hit.numel())
    return hit.repeat(reps)[:n], int(hit.numel())


def variants(torch, cs, kv, ref, state, batch, g):
    """Inputs that split the lookups' time: ``probe`` with every key
    absent, every key found in its h1, every key found in its h2 only, and
    h1 == h2 (loaded keys); ``cache_probe`` with every key cached (drawn
    from the live ways) and every key absent. Returns {name: (kernel,
    args, candidates: the distinct keys a variant drew from)}."""
    nb = state.num_buckets
    bk, bp = state.bucket_keys, state.bucket_ptr

    def ids(keys):
        return (kv.hash_keys(keys, nb),
                kv.hash_keys(keys, nb, salt=kv.OVERFLOW_SALT),
                kv.hash_keys(keys, state.cache_sets, salt=kv.CACHE_SALT))

    def keys_of(idx):
        return cs.key_words(idx, torch)

    absent = keys_of(cs.N_KEYS + torch.randint(0, cs.N_KEYS, (batch,),
                                               generator=g, device="cuda"))
    a1, a2, acs = ids(absent)
    # loaded candidates, those found in h1 and those found in h2 only
    cand = torch.randint(0, cs.N_KEYS, (min(64 * batch, 1 << 22),),
                         generator=g, device="cuda")
    ck_ = keys_of(cand)
    c1, c2, _ = ids(ck_)
    in1 = ref.hash_probe(bk, bp, ck_, c1, c1)[0]
    in2 = ref.hash_probe(bk, bp, ck_, c2, c2)[0] & ~in1
    out = {"probe/absent": ("probe", (absent, a1, a2), batch)}
    for name, mask in (("probe/h1", in1), ("probe/h2", in2)):
        idx, distinct = _take(torch, cand, mask, batch)
        k = keys_of(idx)
        h1, h2, _ = ids(k)
        out[name] = ("probe", (k, h1, h2), distinct)
    k = keys_of(cand[:batch])
    h1, _, _ = ids(k)
    out["probe/h1_eq_h2"] = ("probe", (k, h1, h1), batch)
    live = torch.nonzero(state.cache_meta[:-1] > 0)
    pick = live[torch.randint(0, live.shape[0], (batch,), generator=g,
                              device="cuda")]
    hot = state.cache_keys[pick[:, 0], pick[:, 1]].contiguous()
    out["cache_probe/all_hit"] = ("cache_probe",
                                  (hot, pick[:, 0].to(torch.int32)), batch)
    out["cache_probe/all_miss"] = ("cache_probe", (absent, acs), batch)
    return out


def edge_cases(torch, fns):
    """Mismatching elements of each build against the plain versions on
    every case of ``tests/hash_probe_cases.py``, at every lookup shape and
    at B = 1, 37 and 4,099."""
    sys.path.insert(0, str(ROOT / "tests"))
    import hash_probe_cases as hpc

    from chip_smoke import mismatches

    miss = dict.fromkeys(fns, 0)
    for b in (1, 37, 4099):
        for case in hpc.PROBE_CASES:
            for nb, w, kw in hpc.PROBE_SHAPES:
                c = hpc.probe_case(case, seed=nb + b, nb=nb, w=w, kw=kw, b=b)
                want = hpc.plain_probe(**hpc.to_torch(c, "cuda"))
                for k, f in fns.items():
                    got = f["probe"](*hpc.to_torch(c, "cuda").values())
                    miss[k] += sum(mismatches(torch, x, y)
                                   for x, y in zip(got, want))
        for case in hpc.CACHE_CASES:
            for cs_, cw, kw, vw in hpc.CACHE_SHAPES:
                c = hpc.cache_case(case, seed=cs_ + b, cs=cs_, cw=cw, kw=kw,
                                   vw=vw, b=b)
                want = hpc.plain_cache_probe(**hpc.to_torch(c, "cuda"))
                for k, f in fns.items():
                    got = f["cache_probe"](
                        *hpc.to_torch(c, "cuda").values())
                    miss[k] += sum(mismatches(torch, x, y)
                                   for x, y in zip(got, want))
    torch.cuda.synchronize()
    return miss


def _medians(turns, build):
    mine = [t for t in turns if t["build"] == build]
    return {m: statistics.median(t[m] for t in mine)
            for m in ("device_us", "device_events_us", "device_cold_us")}


def _sweep(torch, cs, fns, order, fn_of):
    """Device µs (profiler, queued events) of each build in ``order``, in
    turns forward and back; medians of the two."""
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        fn = fn_of(k)
        runs[k].append((cs.device_us(torch, fn)[0], cs.queued_us(torch, fn)))
    return {k: {"device_us": statistics.median(r[0] for r in v),
                "device_events_us": statistics.median(r[1] for r in v)}
            for k, v in runs.items()}


def lookup_report(torch, cs, kv, ref, fns, state, cfg, report, bad):
    """The lookups' cases, CTA sizes and variants into ``report``."""
    plain = {"probe": ref.hash_probe, "cache_probe": ref.cache_probe}
    tables = {"probe": (state.bucket_keys, state.bucket_ptr),
              "cache_probe": (state.cache_keys, state.cache_vals,
                              state.cache_meta)}
    # chip_smoke's seeds at the engine's batch and the load phase's
    seeds = {1: cs.SEED + 3, cs.BATCH: cs.SEED + 1, cs.FILL_BATCH: cs.SEED + 2}
    for b in seeds:
        progress(f"lookups@{b}")
        g = torch.Generator(device="cuda").manual_seed(seeds[b])
        keys, h1, h2, cset, _ = cs.kvs_lookups(torch, kv, state, b, g)
        inputs = {"probe": (keys, h1, h2), "cache_probe": (keys, cset)}
        for name in LOOKUPS:
            args = (*tables[name], *inputs[name])
            want = plain[name](*args)
            miss = {k: sum(cs.mismatches(torch, a, w)
                           for a, w in zip(fns[k][name](*args), want))
                    for k in ("old", "new")}
            bad += [f"{name}@{b} {k}" for k, n in miss.items() if n]
            turns = [{"build": k, **timings(
                torch, cs, lambda k=k: fns[k][name](*args))} for k in TURNS]
            nbytes = (cs.probe_bytes if name == "probe"
                      else cs.cache_probe_bytes)(cfg, b)
            out = {"batch": b, "mismatches": miss, "turns": turns,
                   "bytes": nbytes,
                   "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6,
                   "found" if name == "probe" else "hits": int(want[0].sum())}
            for k in ("old", "new"):
                out[k] = _medians(turns, k)
            report["cases"][f"{name}@{b}"] = out
            if b == 1:
                continue
            # CTA sizes: each other build and the checkout's, in turns
            # forward and back
            report["cta_sizes"][f"{name}@{b}"] = _sweep(
                torch, cs, fns, [f"t{n}" for n in CTA_SIZES] + ["new"],
                lambda k: lambda: fns[k][name](*args))
    breakdown = {}
    for b in (cs.BATCH, cs.FILL_BATCH):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
        for var, (name, args, distinct) in variants(
                torch, cs, kv, ref, state, b, g).items():
            args = (*tables[name], *args)
            want = plain[name](*args)
            miss = {k: sum(cs.mismatches(torch, a, w)
                           for a, w in zip(fns[k][name](*args), want))
                    for k in ("old", "new")}
            bad += [f"{var}@{b} {k}" for k, n in miss.items() if n]
            res = {"mismatches": miss, "candidates": distinct,
                   "found" if name == "probe" else "hits": int(want[0].sum())}
            for k in ("old", "new"):
                fn = fns[k][name]
                res[k] = {"device_us": statistics.median(
                    cs.device_us(torch, lambda: fn(*args))[0]
                    for _ in range(2)),
                    "device_events_us": statistics.median(
                    cs.queued_us(torch, lambda: fn(*args))
                    for _ in range(2))}
            breakdown[f"{var}@{b}"] = res
    report["breakdown"] = breakdown


def get_report(torch, cs, kv, ref, fns, state, cfg, report, bad):
    """The GET walk, old (five calls) against new (one), in turns, on
    chip_smoke's lookup inputs at B = 1, 256 and 65,536, into
    ``report``."""
    seeds = {1: cs.SEED + 3, cs.BATCH: cs.SEED + 1, cs.FILL_BATCH: cs.SEED + 2}
    tables = (state.bucket_keys, state.bucket_ptr, state.pool)
    for b, seed in seeds.items():
        progress(f"get@{b}")
        g = torch.Generator(device="cuda").manual_seed(seed)
        keys, h1, h2, _, _ = cs.kvs_lookups(torch, kv, state, b, g)
        args = (*tables, keys, h1, h2)
        want = ref.hash_get(*args)
        miss = {k: sum(cs.mismatches(torch, a, w)
                       for a, w in zip(fns[k]["get"](*args), want))
                for k in ("old", "new")}
        bad += [f"get@{b} {k}" for k, n in miss.items() if n]
        turns = [{"build": k, **timings(
            torch, cs, lambda k=k: fns[k]["get"](*args))} for k in TURNS]
        found = int(want[1].sum())
        nbytes = cs.get_walk_bytes(cfg, b, found)
        out = {"batch": b, "mismatches": miss, "turns": turns,
               "found": found, "bytes": nbytes,
               "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6,
               "device_launches": {k: launches_per_call(
                   torch, cs, lambda k=k: fns[k]["get"](*args))
                   for k in ("old", "new")}}
        for k in ("old", "new"):
            out[k] = _medians(turns, k)
        report["cases"][f"get@{b}"] = out


def get_edge_cases(torch, fns):
    """Mismatching elements of each build's GET walk against the plain
    version on every case of ``tests/hash_probe_cases.py``'s GET walk, at
    every shape and at B = 1, 37 and 4,099."""
    sys.path.insert(0, str(ROOT / "tests"))
    import hash_probe_cases as hpc

    from chip_smoke import mismatches

    miss = dict.fromkeys(fns, 0)
    for b in (1, 37, 4099):
        for case in hpc.GET_CASES:
            for nb, w, kw, np_, vw in hpc.GET_SHAPES:
                c = hpc.get_case(case, seed=nb + b, nb=nb, w=w, kw=kw,
                                 np_=np_, vw=vw, b=b)
                want = hpc.plain_get(**hpc.to_torch(c, "cuda"))
                for k, f in fns.items():
                    got = f["get"](**hpc.to_torch(c, "cuda"))
                    miss[k] += sum(mismatches(torch, x, y)
                                   for x, y in zip(got, want))
    torch.cuda.synchronize()
    return miss


def commit_cases(torch, cs, kv, cfg, state):
    """The commits' cases, {name: (keys, vals, plan, batch)}: (a) the
    kernel phase's PUT batch, (b) the serve mix, (c) one live entry (a
    fresh key), (d) the load phase's 65,536 fresh keys — chip_smoke's
    ``commit_batches`` on its own seeds."""
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    picked = cs.kvs_lookups(torch, kv, state, cs.BATCH, g)[4]
    batches = cs.commit_batches(torch, kv, cfg, state, g, *picked)
    load = batches[f"@{cs.FILL_BATCH}"]
    one = (load[0][:1], load[1][:1],
           kv.plan_put(state, load[0][:1], backend="ref"), 1)
    return {"a_kernel_phase": batches[""], "b_serve_mix": batches["@serve"],
            "c_one_live": one, "d_load_batch": load}


def commit_variants(torch, kv, state, cases):
    """Inputs that split the commits' time, {name: (keys, vals, plan,
    batch)}: every entry dead with the dead ``tw`` over every way (at 256
    and 65,536), and every entry live (256 fresh keys)."""
    from types import SimpleNamespace

    nb, np_, w = state.num_buckets, state.pool_size, state.bucket_ptr.shape[1]
    out = {}
    for case in ("b_serve_mix", "d_load_batch"):
        keys, vals, _, b = cases[case]
        i = torch.arange(b, device="cuda", dtype=torch.int32)
        full = torch.full((b,), nb, device="cuda", dtype=torch.int32)
        out[f"all_dead@{b}"] = (keys, vals, SimpleNamespace(
            tb=full, tw=i % w, bptr_val=i, wp=torch.full_like(full, np_)), b)
    keys, vals = (x[:256] for x in cases["d_load_batch"][:2])
    out["all_live@256"] = (keys, vals,
                           kv.plan_put(state, keys, backend="ref"), 256)
    return out


def commit_report(torch, cs, kv, ref, fns, state, cfg, report, bad):
    """The commits' cases (old and new in turns), their CTA-size builds,
    and their variants, into ``report``."""
    nb, np_ = state.num_buckets, state.pool_size
    plain = {"commit_buckets": ref.commit_buckets,
             "write_rows": ref.write_rows}

    def arrays(name):  # fresh clones of the arrays a commit writes
        if name == "commit_buckets":
            return state.bucket_keys.clone(), state.bucket_ptr.clone()
        return (state.pool.clone(),)

    def inputs(name, keys, vals, plan):
        if name == "commit_buckets":
            return keys, plan.tb, plan.tw, plan.bptr_val
        return vals, plan.wp

    def outs(x):  # commit_buckets returns two arrays, write_rows one
        return x if isinstance(x, tuple) else (x,)

    def check(name, args, builds, what):
        want = outs(plain[name](*arrays(name), *args))
        for k in builds:
            got = outs(fns[k][name](*arrays(name), *args))
            n = sum(cs.mismatches(torch, a, w) for a, w in zip(got, want))
            if n:
                bad.append(f"{what} {k}")
            yield k, n
            del got
        del want
        torch.cuda.empty_cache()

    def bounds(name, plan):
        if name == "commit_buckets":
            nbytes, sectors = cs.commit_buckets_bytes(cfg, plan, nb)
            return {"bytes": nbytes, "sector_bytes": sectors,
                    "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6,
                    "sector_bound_us": sectors / cs.HBM_BYTES_PER_S * 1e6,
                    "dead": int((plan.tb == nb).sum())}
        nbytes = cs.write_rows_bytes(cfg, plan.wp, np_)
        return {"bytes": nbytes,
                "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6,
                "dead": int((plan.wp == np_).sum())}

    cases = commit_cases(torch, cs, kv, cfg, state)
    others = [f"c{n}" for n in COMMIT_CTA_SIZES]

    def builds(name, args, dst, what):
        """The CTA sizes beside the checkout's build, in turns forward and
        back."""
        progress(f"{what} builds")
        return {"mismatches": dict(check(name, args, others, what)),
                **_sweep(torch, cs, fns, others + ["new"],
                         lambda k: lambda: fns[k][name](*dst, *args))}

    for case, (keys, vals, plan, b) in cases.items():
        for name in COMMITS:
            args = inputs(name, keys, vals, plan)
            what = f"{name}@{case}"
            progress(what)
            miss = dict(check(name, args, ("old", "new"), what))
            dst = arrays(name)
            turns = [{"build": k, **timings(
                torch, cs, lambda k=k: fns[k][name](*dst, *args))}
                for k in TURNS]
            out = {"batch": b, "mismatches": miss, "turns": turns,
                   **bounds(name, plan)}
            for k in ("old", "new"):
                out[k] = _medians(turns, k)
            report["cases"][what] = out
            report["commit_builds"][what] = builds(name, args, dst, what)
            del dst
            torch.cuda.empty_cache()
    for var, (keys, vals, plan, b) in commit_variants(
            torch, kv, state, cases).items():
        for name in COMMITS:
            args = inputs(name, keys, vals, plan)
            what = f"{name}/{var}"
            progress(what)
            miss = dict(check(name, args, ("old", "new"), what))
            dst = arrays(name)
            res = {"mismatches": miss, **bounds(name, plan)}
            for k in ("old", "new"):
                fn = fns[k][name]
                res[k] = {"device_us": statistics.median(
                    cs.device_us(torch, lambda: fn(*dst, *args))[0]
                    for _ in range(2)),
                    "device_events_us": statistics.median(
                    cs.queued_us(torch, lambda: fn(*dst, *args))
                    for _ in range(2))}
            report["commit_variants"][what] = res
            report["commit_builds"][what] = builds(name, args, dst, what)
            del dst
            torch.cuda.empty_cache()


def commit_edge_cases(torch, fns):
    """Mismatching elements of each build against the plain versions on
    every case, shape and batch of ``tests/kvs_commit_cases.py``."""
    sys.path.insert(0, str(ROOT / "tests"))
    import kvs_commit_cases as kcc

    from chip_smoke import mismatches

    miss = dict.fromkeys(fns, 0)
    for b in kcc.BATCHES:
        for case in kcc.CASES:
            for nb, w, kw, np_, vw in kcc.SHAPES:
                c = kcc.commit_case(case, seed=nb * 7 + vw + b, nb=nb, w=w,
                                    kw=kw, np_=np_, vw=vw, b=b)
                want = kcc.plain_commit(**kcc.to_torch(c, "cuda"))
                for k, f in fns.items():
                    t = kcc.to_torch(c, "cuda")
                    got = (*f["commit_buckets"](
                        t["bucket_keys"], t["bucket_ptr"], t["keys"],
                        t["tb"], t["tw"], t["bptr_val"]),
                        f["write_rows"](t["pool"], t["vals"], t["wp"]))
                    miss[k] += sum(mismatches(torch, x, y)
                                   for x, y in zip(got, want))
    torch.cuda.synchronize()
    return miss


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source")
    ap.add_argument("--kernels", default=",".join(LOOKUPS + COMMITS + GETS))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    kernels = a.kernels.split(",")
    unknown = set(kernels) - set(LOOKUPS + COMMITS + GETS)
    if unknown:
        ap.error(f"unknown kernels: {sorted(unknown)}")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import kvstore as kv
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import hash_probe as hp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    src = _build.CSRC / "hash_probe.cu"
    lookups = [k for k in LOOKUPS if k in kernels]
    commits = [k for k in COMMITS if k in kernels]
    gets = [k for k in GETS if k in kernels]
    sources = {"old": (Path(a.old_source).resolve(), ())}
    if lookups:
        sources.update({f"t{n}": (src, (f"-DORCA_PROBE_THREADS={n}",))
                        for n in CTA_SIZES})
    if commits:
        sources.update({f"c{n}": (src, (f"-DORCA_COMMIT_THREADS={n}",))
                        for n in COMMIT_CTA_SIZES})
    libs = build_libs(_build, sources)
    _build.build(["hash_probe"])
    fns = {k: lib_entries(torch, lib, k, cs)
           for k, (lib, _) in libs.items()}
    fns["new"] = {"probe": hp.probe, "cache_probe": hp.cache_probe,
                  "commit_buckets": hp.commit_buckets,
                  "write_rows": hp.write_rows, "get": hp.get}
    with contextlib.redirect_stdout(sys.stderr):  # the load phase's line
        cfg, state, _, _ = cs.phase_load(torch, kv, hp)
    x = torch.zeros((1,), dtype=torch.float32, device="cuda")
    report = {"tool": "hash_probe_ab", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "old_source": a.old_source, "kernels": kernels,
              "turns": list(TURNS),
              "launch_floor": timings(torch, cs, lambda: x.add_(1)),
              "cases": {}, "cta_sizes": {}, "commit_builds": {},
              "commit_variants": {}}
    bad = []
    try:
        if lookups:
            lookup_report(torch, cs, kv, ref, fns, state, cfg, report, bad)
        if commits:
            commit_report(torch, cs, kv, ref, fns, state, cfg, report, bad)
        if gets:
            get_report(torch, cs, kv, ref, fns, state, cfg, report, bad)
    except OutOfHostMemory as e:  # what was measured, then fail
        report["out_of_host_memory"] = str(e)
        print(json.dumps(report), flush=True)
        raise
    del state
    torch.cuda.empty_cache()
    progress("edge cases")
    builds = {k: fns[k] for k in ("old", "new")}
    if lookups:
        report["edge_case_mismatches"] = edge_cases(torch, builds)
        bad += [f"edge cases {k}" for k, n in
                report["edge_case_mismatches"].items() if n]
    if gets:
        report["get_edge_case_mismatches"] = get_edge_cases(torch, builds)
        bad += [f"get edge cases {k}" for k, n in
                report["get_edge_case_mismatches"].items() if n]
    if commits:
        report["commit_edge_case_mismatches"] = commit_edge_cases(
            torch, {**builds, "c32": fns["c32"]})
        bad += [f"commit edge cases {k}" for k, n in
                report["commit_edge_case_mismatches"].items() if n]
    progress("sass")
    report["sass"] = {
        "old": cs.sass_scan(_build, libs["old"][1]),
        "new": cs.sass_scan(_build, _build.library_path("hash_probe"))}
    print(json.dumps(report), flush=True)
    if bad:
        print(f"hash_probe_ab: mismatches against the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
