"""The LM: layers, attention, MoE, the recurrent mixers, the decoder stack
of every family, and the model's training forward and loss and its
prefill/decode entry points over either decode substrate
(dense per-slot ring caches, or the shared page pool of
``serving.kv_cache``)."""
from repro_torch.models.model import (
    DecodeState,
    abstract_params,
    batch_specs,
    check_paged_support,
    decode_state_specs,
    decode_step,
    forward,
    init_params,
    input_specs,
    loss_fn,
    make_decode_state,
    make_paged_kv_config,
    paged_decode_step,
    postprocess_grads,
    prefill,
    prefill_kv,
)
