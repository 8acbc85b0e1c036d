"""Serving substrate: the paged KV cache pool and its host cold tier."""
from repro_torch.serving import kv_cache
from repro_torch.serving.kv_cache import (
    PagedKVConfig,
    PagedKVState,
    append_token,
    append_token_batch,
    attend,
    ensure_capacity,
    ensure_capacity_batch,
    kv_bytes_in_use,
    make,
    pages_in_use,
    prefill_into_pages,
    release,
    release_batch,
)
