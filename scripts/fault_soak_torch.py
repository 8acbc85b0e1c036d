#!/usr/bin/env python
"""Fault-injection soak of the PyTorch/CUDA port (``repro_torch.fault.soak``),
the twin of ``scripts/fault_soak.py``: run the deterministic seeded fault
schedule against the TX engine and check the acceptance set — every fault
class fired at least once, every landed entry resolved to exactly one
response, every logical request recovered, and the surviving + revived
replicas ended bit-for-bit equal to a never-failed control run
(``run_soak``).

``--crash`` runs the crash-restart variant (``run_crash_soak``):
durability flushes on a cadence, an engine kill mid-run leaving a torn
``.tmp`` flush and a torn segment tail, restart via
``fault.recovery.recover`` + WAL replay, then resume — the recovered
state checked bit-for-bit against a never-crashed control twin.
``--crash --app lm`` aims it at the paged LM engine with a host cold tier
(``run_lm_crash_soak``).

Runs on the card by default (the CUDA kernels: the ``commit`` kernel on
every resync and WAL replay); ``--device cpu`` runs the plain versions::

    PYTHONPATH=src python scripts/fault_soak_torch.py --device cpu
    PYTHONPATH=src python scripts/fault_soak_torch.py --crash --app lm

Exits non-zero on any violation; prints the report as JSON on success
(``--out`` also writes it to a file)."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fault import soak  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=200,
                    help="warm-phase engine steps (drain adds more)")
    ap.add_argument("--crash", action="store_true",
                    help="crash-restart soak (durability + recovery) "
                         "instead of the fault-schedule soak")
    ap.add_argument("--app", choices=("tx", "lm"), default="tx",
                    help="crash-soak application: the TX chain engine, or "
                         "the paged LM engine with a host cold tier "
                         "(requires --crash)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=str, default=None,
                    help="also write the report JSON to this path")
    args = ap.parse_args(argv)
    if args.app == "lm" and not args.crash:
        ap.error("--app lm only has a crash arm; pass --crash")
    if args.app == "lm":
        report = soak.run_lm_crash_soak(seed=args.seed, steps=args.steps,
                                        device=args.device)
        main_run = report["main"]
        out = {
            "seed": args.seed, "mode": "crash-lm", "device": args.device,
            "covered": report["covered"], "crash_at": report["crash_at"],
            "torn_segment_truncated":
                main_run["crash"]["torn_segment_truncated"],
            "recover_s": main_run["crash"]["recover_s"],
            "delivered": {str(q): len(main_run["delivered"][q])
                          for q in main_run["delivered"]},
            "durability": report["stats"],
            "evictions": main_run["evictions"],
            "restores": main_run["restores"],
            "wall_ticks": main_run["wall_ticks"],
        }
    else:
        if args.crash:
            report = soak.run_crash_soak(seed=args.seed, steps=args.steps,
                                         device=args.device)
        else:
            report = soak.run_soak(seed=args.seed, steps=args.steps,
                                   device=args.device)
        out = {
            "seed": args.seed, "device": args.device,
            "mode": "crash" if args.crash else "soak",
            "steps": report["engine"]["steps"],
            "requests": report["requests"],
            "responses": report["responses"],
            "resubmits": report["resubmits"],
            "counters": report["counters"],
            "status_counts": {str(k): v for k, v in
                              sorted(report["status_counts"].items())},
            "engine": report["engine"],
            "monitor_events": report["monitor_events"],
        }
        if args.crash:
            crash = dict(report["crash"])
            crash.pop("recovered_state", None)
            out["crash"] = crash
            out["covered"] = report["covered"]
            out["flush_bytes"] = report["flush_bytes"]
            out["flushes"] = len(report["flush_records"])
            out["durability"] = report["durability_stats"]
    text = json.dumps(out, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
