"""The LM: layers, attention, MoE, the dense and MoE decoder stack, and
the model's prefill/decode entry points over either decode substrate
(dense per-slot ring caches, or the shared page pool of
``serving.kv_cache``)."""
from repro_torch.models.model import (
    DecodeState,
    check_paged_support,
    decode_step,
    init_params,
    make_decode_state,
    make_paged_kv_config,
    paged_decode_step,
    prefill,
    prefill_kv,
)
