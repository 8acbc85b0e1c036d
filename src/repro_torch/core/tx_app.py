"""ORCA-TX as an engine application: transactions through the same
ring-buffer → cpoll → scheduler → APU pipeline as the KVS (§IV-B end to
end).

Request slot layout = the redo-log entry format (count header + (offset,
value) tuples); the response carries [committed | deferred] so the client
retries deferred transactions — the paper's "buffered in the queue in the
order of arrival" behaviour lands on the client side of the credit loop,
which preserves arrival order per connection.
"""
from __future__ import annotations

import torch

from repro_torch.core import status as stc
from repro_torch.core import transaction as tx

I32 = torch.int32

RESP_COMMITTED = 1
RESP_DEFERRED = 2


def request_words(cfg: tx.TxConfig) -> int:
    return tx.tx_words(cfg)


def app_step(chain: tx.ReplicaState, payloads, valid, cfg: tx.TxConfig, *,
             kernel_backend="auto"):
    """Engine hook. payloads: (B, >= tx_words); any trailing words past the
    log-entry layout (e.g. the engine's deadline word) are ignored. A zero
    count header = no-op.

    Returns (chain, responses (B, W)) where responses carry the
    commit/deferred status in word 0 — or ``status.MALFORMED`` when
    payload validation fails (op-count overflow/negative, or a live op's
    raw offset outside the store): a malformed transaction is masked out
    of the commit walk entirely, NACKed instead of clipped into scattering
    garbage. ``kernel_backend`` dispatches the chain commit (``auto``/
    ``cuda`` = the CUDA kernel for CUDA tensors, ``ref`` = the plain
    version). The chain's log and store are committed IN PLACE."""
    b = payloads.shape[0]
    body = payloads[:, : tx.tx_words(cfg)]
    n_raw = body[:, 0]
    raw_off = body[:, 1:].reshape(b, cfg.max_ops, 1 + cfg.val_words)[..., 0]
    n_clip = torch.clamp(n_raw, 0, cfg.max_ops)
    live_op = (torch.arange(cfg.max_ops, device=payloads.device)[None, :]
               < n_clip[:, None])
    bad = valid & (
        (n_raw < 0) | (n_raw > cfg.max_ops)
        | torch.any(live_op & ((raw_off < 0) | (raw_off >= cfg.num_keys)),
                    dim=1)
    )
    live = valid & ~bad & (n_raw > 0)
    chain, committed, deferred = tx.chain_commit_local(
        chain, body, cfg, live, kernel_backend=kernel_backend
    )
    status = torch.where(
        committed, RESP_COMMITTED, torch.where(deferred, RESP_DEFERRED, 0)
    )
    status = torch.where(bad, stc.MALFORMED, status).to(I32)
    resp = torch.zeros_like(payloads)
    resp[:, 0] = status
    return chain, resp
