#!/usr/bin/env python3
"""Time two builds of the TX commit kernels against each other on one card,
in turns (old, new, new, old), on ``chip_smoke.py``'s ``tx_kernels``
inputs: ``commit_chain`` at the engine's shape (a chain of 3 replicas of
2^24 64-byte rows, 256 planned transactions, a dead replica), ``commit``
at B = 256 on replica 0, and ``commit`` at B = 1, one record planned as
log replay plans it (its shape on the main path).

    git show <rev>:src/repro_torch/kernels/csrc/tx_commit.cu \
        > _scratch/old/tx_commit.cu
    python3 scripts/tx_commit_ab.py _scratch/old/tx_commit.cu

"old" is the given source, built here with the port's nvcc flags into the
ignored build directory and called through its C entry points, which
every version shares; "new" is the checkout's ``csrc/tx_commit.cu``
through its wrapper. Both are held against the plain version bit for bit
on every case. Each turn reports device µs by ``torch.profiler``
(L2-warm), by CUDA events around calls queued behind a spin kernel, and
with L2 flushed; the report adds the medians of both turns, the launch
floor, the card's name and power limit (``nvidia-smi``) and the SASS scan
of both libraries, and both builds' times on variants of the targets
(see :func:`variants`), to show where the time goes. Prints one JSON
line; exits non-zero without a card or on a mismatch.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURNS = ("old", "new", "new", "old")


def load_old(build, source: Path):
    """Build ``source`` into the build directory; returns its library with
    the typed C entry points."""
    from repro_torch.kernels._launch import LL, I, P

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "tx_commit_old.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.orca_tx_commit.argtypes = [P] * 6 + [LL, I, I, I, LL, LL, P]
    lib.orca_tx_commit_chain.argtypes = [P] * 6 + [LL, LL, I, I, I, LL, LL,
                                                   LL, P]
    lib.orca_tx_commit.restype = lib.orca_tx_commit_chain.restype = \
        ctypes.c_int
    return lib, out


def old_entry(torch, lib, chain: bool):
    """The old library's ``commit_chain`` (chain) or ``commit``, called as
    the wrapper calls the new one."""
    def call(log, store, batch, values, slot, rows):
        b, tw = batch.shape
        m, vw = values.shape[1:]
        ptrs = [x.data_ptr() for x in (log, store, batch, values, slot,
                                       rows)]
        stream = torch.cuda.current_stream().cuda_stream
        if chain:
            stride = 0 if rows.dim() == 1 else b * m
            code = lib.orca_tx_commit_chain(
                *ptrs, log.shape[0], b, m, tw, vw, log.shape[1] - 1,
                store.shape[1] - 1, stride, stream)
        else:
            code = lib.orca_tx_commit(*ptrs, b, m, tw, vw, log.shape[0] - 1,
                                      store.shape[0] - 1, stream)
        if code:
            raise RuntimeError(f"old tx_commit: CUDA error {code}")
        return log, store
    return call


def timings(torch, cs, fn):
    return {"device_us": cs.device_us(torch, fn)[0],
            "device_events_us": cs.queued_us(torch, fn),
            "device_cold_us": cs.cold_device_us(torch, fn)}


def variants(torch, cfg, slot, rows):
    """The same plan with its targets changed, to split the time: live
    store rows renumbered by their rank (unique, all in the first rows of
    the store: no scattered pages); sentinel targets made out of range
    (skipped: no zeroing); every target a sentinel (an all-deferred
    batch: no payload stores); no target in range (no store at all);
    only the log or only the store written."""
    lc, nk = cfg.log_capacity, cfg.num_keys
    live = rows < nk
    rank = (torch.cumsum(live.to(torch.int32), dim=-1) - 1).to(torch.int32)
    skip = torch.full_like
    return {
        "real": (slot, rows),
        "rows_compact": (slot, torch.where(live, rank, rows)),
        "no_sentinel": (torch.where(slot == lc, -1, slot).to(torch.int32),
                        torch.where(rows == nk, -1, rows).to(torch.int32)),
        "all_sentinel": (skip(slot, lc), skip(rows, nk)),
        "none": (skip(slot, -1), skip(rows, -1)),
        "log_only": (slot, skip(rows, -1)),
        "store_only": (skip(slot, -1), rows),
    }


def breakdown(torch, cs, cfg, cases):
    """Device µs (profiler, queued events) of both builds, in turns, on
    the variants of ``commit_chain``'s and ``commit_b1``'s targets; the
    two builds' outputs held equal on each."""
    out = {}
    for name in ("commit_chain", "commit_b1"):
        log, store, args, old_fn, new_fn, _ = cases[name]
        for var, (slot, rows) in variants(torch, cfg, *args[2:]).items():
            a = (*args[:2], slot.contiguous(), rows.contiguous())
            states = {k: (log.clone(), store.clone()) for k in ("old", "new")}
            fns = {"old": old_fn, "new": new_fn}
            for k, st in states.items():
                fns[k](*st, *a)
            torch.cuda.synchronize()
            miss = sum(cs.mismatches(torch, x, y)
                       for x, y in zip(states["old"], states["new"]))
            res = {"old_vs_new_mismatches": miss}
            for k in ("old", "new"):
                st, fn = states[k], fns[k]
                res[k] = {"device_us": statistics.median(
                    cs.device_us(torch, lambda: fn(*st, *a))[0]
                    for _ in range(2)),
                    "device_events_us": statistics.median(
                    cs.queued_us(torch, lambda: fn(*st, *a))
                    for _ in range(2))}
            out[f"{name}/{var}"] = res
            del states
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tx_commit_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import transaction as tx
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import tx_commit as tc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    lib, lib_path = load_old(_build, Path(sys.argv[1]).resolve())
    _build.build(["tx_commit"])
    cfg = tx.TxConfig(**cs.TX_SHAPE)
    (chain, _, _, plan, slot, rows, rplan, rslot,
     rrows) = cs.tx_kernel_inputs(torch, tx, cfg)
    one = (plan.batch, plan.values, slot[0].contiguous(),
           rows[0].contiguous())
    cases = {
        "commit_chain": (chain.log, chain.store,
                         (plan.batch, plan.values, slot, rows),
                         old_entry(torch, lib, True), tc.commit_chain,
                         ref.tx_commit_chain),
        "commit": (chain.log[0], chain.store[0], one,
                   old_entry(torch, lib, False), tc.commit, ref.tx_commit),
        "commit_b1": (chain.log[0], chain.store[0],
                      (rplan.batch, rplan.values, rslot, rrows),
                      old_entry(torch, lib, False), tc.commit,
                      ref.tx_commit),
    }
    x = torch.zeros((1,), dtype=torch.float32, device="cuda")
    report = {"tool": "tx_commit_ab", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "old_source": sys.argv[1], "turns": list(TURNS),
              "launch_floor": timings(torch, cs, lambda: x.add_(1)),
              "cases": {}}
    bad = []
    for name, (log, store, args, old_fn, new_fn, plain_fn) in cases.items():
        states = {k: (log.clone(), store.clone())
                  for k in ("old", "new", "plain")}
        fns = {"old": old_fn, "new": new_fn, "plain": plain_fn}
        for k, st in states.items():
            fns[k](*st, *args)
        torch.cuda.synchronize()
        miss = {k: sum(cs.mismatches(torch, a, b)
                       for a, b in zip(states[k], states["plain"]))
                for k in ("old", "new")}
        bad += [f"{name} {k}" for k, n in miss.items() if n]
        turns = []
        for k in TURNS:
            st = states[k]
            turns.append({"build": k, **timings(
                torch, cs, lambda st=st, k=k: fns[k](*st, *args))})
        out = {"batch": args[0].shape[0],
               "replicas": log.shape[0] if log.dim() == 3 else 1,
               "mismatches": miss, "turns": turns,
               "bytes": cs.tx_commit_bytes(cfg, *args)}
        out["bound_us"] = out["bytes"] / cs.HBM_BYTES_PER_S * 1e6
        for k in ("old", "new"):
            mine = [t for t in turns if t["build"] == k]
            out[k] = {m: statistics.median(t[m] for t in mine)
                      for m in ("device_us", "device_events_us",
                                "device_cold_us")}
        report["cases"][name] = out
        del states
        torch.cuda.empty_cache()
    report["breakdown"] = breakdown(torch, cs, cfg, cases)
    report["sass"] = {
        "old": cs.sass_scan(_build, lib_path),
        "new": cs.sass_scan(_build, _build.library_path("tx_commit"))}
    print(json.dumps(report), flush=True)
    if bad:
        print(f"tx_commit_ab: mismatches against the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
