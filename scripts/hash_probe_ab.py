#!/usr/bin/env python3
"""Time two builds of the KVS lookup kernels (``probe``, ``cache_probe``)
against each other on one card, in turns (old, new, new, old), on
``chip_smoke.py``'s ``kernels_vs_plain`` inputs: the GET mix on the loaded
store (2^24 buckets x 8 ways, 2^26 keys, a 65,536 x 4 cache) at B = 1, 256
(the engine's batch) and 65,536 (the load phase's).

    git show <rev>:src/repro_torch/kernels/csrc/hash_probe.cu \\
        > _scratch/old/hash_probe.cu
    python3 scripts/hash_probe_ab.py _scratch/old/hash_probe.cu

"old" is the given source, built here with the port's nvcc flags into the
ignored build directory and called through its C entry points, which
every version shares; "new" is the checkout's ``csrc/hash_probe.cu``
through its wrapper. Both are held against the plain version bit for bit
on every case, and on every edge case of ``tests/hash_probe_cases.py``.
Each turn reports device µs by ``torch.profiler`` (L2-warm), by CUDA
events around calls queued behind a spin kernel, and with L2 flushed; the
report adds the medians of both turns, the launch floor, the card's name
and power limit (``nvidia-smi``), the SASS scan of both libraries (per
kernel: CALLs and global loads), both builds' times on variants of the
inputs that split the time (see :func:`variants`), and the new source
built at other CTA sizes (``ORCA_PROBE_THREADS``) beside its own. Prints one JSON line; exits non-zero without a card or on a
mismatch.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURNS = ("old", "new", "new", "old")
CTA_SIZES = (32, 64, 128)  # and the checkout's 256


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
        lib.orca_probe.restype = lib.orca_cache_probe.restype = ctypes.c_int
        libs[name] = (lib, out)
    return libs


def lib_entries(torch, lib, what):
    """``probe`` and ``cache_probe`` of a built library, called as the
    wrapper calls the checkout's."""
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

    return {"probe": probe, "cache_probe": cache_probe}


def timings(torch, cs, fn):
    return {"device_us": cs.device_us(torch, fn)[0],
            "device_events_us": cs.queued_us(torch, fn),
            "device_cold_us": cs.cold_device_us(torch, fn)}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("hash_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
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
    libs = build_libs(_build, {
        "old": (Path(sys.argv[1]).resolve(), ()),
        **{f"t{n}": (src, (f"-DORCA_PROBE_THREADS={n}",))
           for n in CTA_SIZES}})
    _build.build(["hash_probe"])
    fns = {k: lib_entries(torch, lib, k) for k, (lib, _) in libs.items()}
    fns["new"] = {"probe": hp.probe, "cache_probe": hp.cache_probe}
    plain = {"probe": ref.hash_probe, "cache_probe": ref.cache_probe}
    with contextlib.redirect_stdout(sys.stderr):  # the load phase's line
        cfg, state, _, _ = cs.phase_load(torch, kv, hp)
    tables = {"probe": (state.bucket_keys, state.bucket_ptr),
              "cache_probe": (state.cache_keys, state.cache_vals,
                              state.cache_meta)}
    x = torch.zeros((1,), dtype=torch.float32, device="cuda")
    report = {"tool": "hash_probe_ab", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "old_source": sys.argv[1], "turns": list(TURNS),
              "launch_floor": timings(torch, cs, lambda: x.add_(1)),
              "cases": {}, "cta_sizes": {}}
    bad = []
    # chip_smoke's seeds at the engine's batch and the load phase's
    seeds = {1: cs.SEED + 3, cs.BATCH: cs.SEED + 1, cs.FILL_BATCH: cs.SEED + 2}
    inputs = {}
    for b in seeds:
        g = torch.Generator(device="cuda").manual_seed(seeds[b])
        keys, h1, h2, cset, _ = cs.kvs_lookups(torch, kv, state, b, g)
        inputs[b] = {"probe": (keys, h1, h2), "cache_probe": (keys, cset)}
        for name in ("probe", "cache_probe"):
            args = (*tables[name], *inputs[b][name])
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
                mine = [t for t in turns if t["build"] == k]
                out[k] = {m: statistics.median(t[m] for t in mine)
                          for m in ("device_us", "device_events_us",
                                    "device_cold_us")}
            report["cases"][f"{name}@{b}"] = out
            if b == 1:
                continue
            # CTA sizes: each other build and the checkout's, in turns
            # forward and back
            order = [f"t{n}" for n in CTA_SIZES] + ["new"]
            runs = {k: [] for k in order}
            for k in order + order[::-1]:
                runs[k].append((cs.device_us(
                    torch, lambda k=k: fns[k][name](*args))[0], cs.queued_us(
                    torch, lambda k=k: fns[k][name](*args))))
            report["cta_sizes"][f"{name}@{b}"] = {
                k: {"device_us": statistics.median(r[0] for r in v),
                    "device_events_us": statistics.median(r[1] for r in v)}
                for k, v in runs.items()}
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
    del state, tables, inputs
    torch.cuda.empty_cache()
    report["edge_case_mismatches"] = edge_cases(
        torch, {k: fns[k] for k in ("old", "new")})
    bad += [f"edge cases {k}" for k, n in
            report["edge_case_mismatches"].items() if n]
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
