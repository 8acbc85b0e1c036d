#!/usr/bin/env python3
"""Run a few of ``chip_smoke.py``'s phases alone on one card: the device
phase (the card's name and power limit, the kernels' build), then the
phases named, in the order given, each printing its JSON line.

    python3 scripts/chip_phases.py tx_spmd zero1_train
    python3 scripts/chip_phases.py tx_crash lm_crash
    python3 scripts/chip_phases.py lm_tp_serve

Phases: ``tx_spmd``, ``zero1_train``, ``tx_crash``, ``lm_crash``,
``lm_tp_serve``. The
checks are the script's own; the kernels line and the last line are not
printed (a phase's launches are in its own line). GPU only.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402

PHASES = ("tx_spmd", "zero1_train", "tx_crash", "lm_crash", "lm_tp_serve")


def main(names) -> int:
    import numpy as np
    import torch

    from repro_torch import configs as lm_configs
    from repro_torch.core import engine as eng
    from repro_torch.core import ringbuf as rb
    from repro_torch.core import transaction as tx
    from repro_torch.fault import soak
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tx_commit as tc
    from repro_torch.models import model, moe
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context
    from repro_torch.serving import kv_cache as pk

    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        print(f"phases: {', '.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.phase_device(torch, _build)
    t0 = time.perf_counter()
    for name in names:
        gc.collect()
        torch.cuda.empty_cache()
        if name == "tx_spmd":
            cs.phase_tx_spmd(torch, coll, smi)
        elif name == "zero1_train":
            cs.phase_zero1_train(torch, np, lm_configs, model, coll, smi)
        elif name == "tx_crash":
            cs.phase_tx_crash(torch, tx, tc, soak, smi)
        elif name == "lm_tp_serve":
            cs.phase_lm_tp_serve(torch, np, eng, rb, lm_configs, model, moe,
                                 fa, coll, smi)
        else:
            cs.phase_lm_crash(torch, eng, lm_configs, model, pk, pa, fa,
                              soak, local_context(), smi)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
