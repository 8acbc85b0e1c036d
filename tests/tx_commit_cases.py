"""Edge cases of the TX commit kernels, shared by the CPU tests against the
Pallas kernels (``test_torch_tx.py``), the numpy model of the CUDA kernel
(``test_torch_tx_commit_walk.py``) and the card tests
(``test_torch_cuda.py``). Imports only numpy, torch and the port.

Every case starts from sentinel rows that are NOT zero, so a sentinel row
that the commit should zero, or should leave alone, shows either way:

- ``sentinel_aimed``: about a third of the log slots and store rows aim at
  the sentinel row, the rest at distinct live rows;
- ``sentinel_not_aimed``: every target is a distinct live row;
- ``all_deferred``: every target is the sentinel (a batch of which no
  transaction proceeds);
- ``out_of_range``: some targets lie outside [0, LC] and [0, NK] (skipped
  by the kernel), some at the sentinel, the rest live.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

CASES = ("sentinel_aimed", "sentinel_not_aimed", "all_deferred",
         "out_of_range")
# the cases whose targets the plain versions (and the Pallas kernels) take
IN_RANGE = CASES[:3]


def tx_words(m: int, vw: int) -> int:
    return 1 + m * (1 + vw)


def _targets(rng, name, n, limit):
    """(n,) int32 targets into rows [0, limit] for case ``name``."""
    out = rng.permutation(limit)[:n].astype(np.int32)
    pick = rng.random(n)
    if name == "all_deferred":
        out[:] = limit
    elif name == "sentinel_aimed":
        out[pick < 1 / 3] = limit
    elif name == "out_of_range":
        out[pick < 0.2] = limit
        bad = (pick >= 0.2) & (pick < 0.45)
        out[bad] = rng.choice([-1, -7, limit + 1, limit + 5, 2**31 - 1,
                               -2**31], int(bad.sum()))
    return out


def edge_case(name: str, seed: int, r: int, b: int, m: int, vw: int,
              lc: int, nk: int, shared_rows: bool = False) -> dict:
    """numpy int32 inputs of a commit on a chain of ``r`` replicas: log
    (r, lc + 1, TW) and store (r, nk + 1, VW) with random rows and
    non-zero sentinel rows, batch (b, TW), values (b, m, VW), slot (r, b)
    and rows (r, b*m), or (b*m,) when ``shared_rows``. Live targets are
    distinct per replica, so b <= lc and b*m <= nk."""
    assert b <= lc and b * m <= nk
    rng = np.random.default_rng(seed)
    tw = tx_words(m, vw)
    log = rng.integers(-99, 99, (r, lc + 1, tw)).astype(np.int32)
    store = rng.integers(-99, 99, (r, nk + 1, vw)).astype(np.int32)
    log[:, lc] = rng.integers(1, 99, (r, tw))
    store[:, nk] = rng.integers(1, 99, (r, vw))
    slot = np.stack([_targets(rng, name, b, lc) for _ in range(r)])
    nrows = 1 if shared_rows else r
    rows = np.stack([_targets(rng, name, b * m, nk) for _ in range(nrows)])
    return {
        "log": log, "store": store,
        "batch": rng.integers(-999, 999, (b, tw)).astype(np.int32),
        "values": rng.integers(-999, 999, (b, m, vw)).astype(np.int32),
        "slot": slot, "rows": rows[0] if shared_rows else rows,
    }


def replica(case: dict, k: int = 0) -> dict:
    """Replica ``k`` of a chain case as a one-replica commit's inputs."""
    rows = case["rows"]
    return dict(case, log=case["log"][k], store=case["store"][k],
                slot=case["slot"][k], rows=rows if rows.ndim == 1 else rows[k])


def to_torch(case: dict, device="cpu") -> dict:
    """Copies of a case's arrays as tensors on ``device``."""
    return {k: torch.tensor(v, device=device) for k, v in case.items()}


def plain_dropping_out_of_range(log, store, batch, values, slot, rows):
    """The plain version (``ref.tx_commit``) on the targets in range only,
    replica by replica, IN PLACE: what the CUDA kernel computes for any
    targets. Takes a chain (log (R, LC+1, TW), slot (R, B)) or one
    replica (log (LC+1, TW), slot (B,))."""
    logs, stores = log, store
    if log.dim() == 2:  # one replica: a chain of one, written through views
        logs, stores, slot, rows = log[None], store[None], slot[None], \
            rows[None]
    elif rows.dim() == 1:  # rows shared by every replica
        rows = rows[None].expand(log.shape[0], -1)
    lc, nk = logs.shape[1] - 1, stores.shape[1] - 1
    vals = values.reshape(-1, 1, values.shape[-1])
    for k in range(logs.shape[0]):
        s, w = slot[k], rows[k]
        keep_s = (s >= 0) & (s <= lc)
        keep_w = (w >= 0) & (w <= nk)
        ref.tx_commit(logs[k], stores[k], batch[keep_s], vals[keep_w],
                      s[keep_s], w[keep_w])
    return log, store
