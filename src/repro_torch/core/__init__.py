"""ORCA core on PyTorch: the request engine and its apps.

ringbuf — SPSC request/response rings with credit flow control
cpoll — pointer-buffer doorbell notification
scheduler — round-robin water-fill and deadline shedding
engine — the request half of the cc-accelerator loop
placement — the hot-set cache budget against the card's L2
kvstore — ORCA-KV, the key-value store app
transaction, tx_app — ORCA-TX, chain-replicated transactions and their app
dlrm — ORCA-DLRM, recommendation inference and its app
"""
from repro_torch.core import (cpoll, dlrm, engine, kvstore, placement, ringbuf,
                              scheduler, status, transaction, tx_app)
