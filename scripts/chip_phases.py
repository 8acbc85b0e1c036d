#!/usr/bin/env python3
"""Run a few of ``chip_smoke.py``'s phases alone on one card: the device
phase (the card's name and power limit, the kernels' build), then the
phases named, in the order given, each printing its JSON line.

    python3 scripts/chip_phases.py tx_spmd zero1_train
    python3 scripts/chip_phases.py tx_crash lm_crash
    python3 scripts/chip_phases.py lm_tp_serve
    python3 scripts/chip_phases.py zero1_train tp_train
    python3 scripts/chip_phases.py dp_moe_train lm_tp_serve
    python3 scripts/chip_phases.py lm_dp_serve lm_tp_families

Phases: ``tx_spmd``, ``zero1_train``, ``dp_moe_train``, ``tp_train``,
``tx_crash``, ``lm_crash``, ``lm_tp_serve``, ``lm_dp_serve``,
``lm_tp_families``. ``tp_train`` holds its ranks against zero1_train's
single-process steps, and ``dp_moe_train`` (the data-parallel MoE check)
runs in zero1_train's launch: named without zero1_train, either runs it
first (its line is printed once). ``lm_dp_serve`` and
``lm_tp_families`` run in lm_tp_serve's launches: any of the three runs
all three, once.
The checks are the script's own; the kernels line and the last line are
not printed (a phase's launches are in its own line). GPU only.
"""
from __future__ import annotations

import gc
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402

PHASES = ("tx_spmd", "zero1_train", "dp_moe_train", "tp_train", "tx_crash",
          "lm_crash", "lm_tp_serve", "lm_dp_serve", "lm_tp_families")
SERVE_RANKS = ("lm_tp_serve", "lm_dp_serve", "lm_tp_families")


def main(names) -> int:
    import torch

    from repro_torch.kernels import _build

    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        print(f"phases: {', '.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.phase_device(torch, _build)
    t0 = time.perf_counter()
    zero1 = {}  # zero1_train's single-process run, kept for tp_train
    served = False
    try:
        for name in names:
            gc.collect()
            torch.cuda.empty_cache()
            if name in ("tp_train", "dp_moe_train", "zero1_train") \
                    and "spec" not in zero1:
                run("zero1_train", smi, zero1)
                gc.collect()
                torch.cuda.empty_cache()
            if name in SERVE_RANKS:
                if not served:
                    run("lm_tp_serve", smi, zero1)
                served = True
            elif name not in ("dp_moe_train", "zero1_train"):
                run(name, smi, zero1)
    finally:
        if "root" in zero1:
            shutil.rmtree(zero1["root"], ignore_errors=True)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def run(name, smi, zero1) -> None:
    """One phase, as ``chip_smoke.main`` calls it."""
    import numpy as np
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch.core import engine as eng
    from repro_torch.core import ringbuf as rb
    from repro_torch.core import transaction as tx
    from repro_torch.fault import soak
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tx_commit as tc
    from repro_torch.models import model, moe
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context
    from repro_torch.serving import kv_cache as pk

    if name == "tx_spmd":
        cs.phase_tx_spmd(torch, coll, smi)
    elif name == "zero1_train":
        cs.phase_zero1_train(torch, np, lm_configs, model, coll, smi,
                             keep=zero1)
    elif name == "tp_train":
        cs.phase_tp_train(torch, np, lm_configs, model, moe, coll, smi,
                          zero1)
    elif name == "tx_crash":
        cs.phase_tx_crash(torch, tx, tc, soak, smi)
    elif name == "lm_tp_serve":
        cs.phase_lm_tp_serve(torch, np, eng, rb, lm_configs, model, moe, fa,
                             coll, smi)
    else:
        cs.phase_lm_crash(torch, eng, lm_configs, model, pk, pa, fa, soak,
                          local_context(), smi)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
