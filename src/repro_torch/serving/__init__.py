"""Serving substrate: the paged KV cache pool and its host cold tier."""
from repro_torch.serving import kv_cache
