"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the dispatch knob (``ops``).

hash_probe — the KVS walk: probe, fetch, cache_probe, commit_buckets,
             write_rows
tx_commit — the TX commit: commit (one replica), commit_chain
embedding_reduce — the DLRM embedding reduction
"""
from repro_torch.kernels import embedding_reduce, hash_probe, ops, ref, tx_commit
