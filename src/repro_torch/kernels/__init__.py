"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the dispatch knob (``ops``).

hash_probe — the KVS walk: probe, fetch, cache_probe, commit_buckets,
             write_rows
tx_commit — the TX commit: commit (one replica), commit_chain
embedding_reduce — the DLRM embedding reduction
paged_attention — LM decode: the paged attention stats walk
flash_attention — LM prefill: causal flash attention
"""
from repro_torch.kernels import (
    embedding_reduce, flash_attention, hash_probe, ops, paged_attention, ref,
    tx_commit,
)
