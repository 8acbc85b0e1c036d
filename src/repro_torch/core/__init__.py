"""ORCA core on PyTorch: the request engine and the KVS app.

ringbuf — SPSC request/response rings with credit flow control
cpoll — pointer-buffer doorbell notification
scheduler — round-robin water-fill and deadline shedding
engine — the request half of the cc-accelerator loop
placement — the hot-set cache budget against the card's L2
kvstore — ORCA-KV, the app the engine serves
"""
from repro_torch.core import cpoll, engine, kvstore, placement, ringbuf, scheduler, status
