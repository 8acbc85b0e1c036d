#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's three request apps — the KVS, chain-replicated
transactions (TX) and DLRM inference — and LM serving of Qwen2.5-14B,
Qwen3-MoE-30B-A3B and Qwen2-VL-7B (paged), Hymba-1.5B and RWKV6-1.6B
(dense ring engine) and MusicGen-large (prefill and decode) through the
ORCA engine and the hand-written CUDA kernels, at deployment sizes,
with the fault and durability layer (fault injection, chain failover,
snapshots, the WAL and crash recovery) on the TX, KVS and LM paths;
trains Qwen1.5-0.5B through the port's training launcher, data-parallel
(ZeRO-1) and tensor-parallel, and Qwen3-MoE-30B-A3B's gradient over two
data ranks; serves both LM models under tensor parallelism on two ranks
sharing the card, through the dense and the paged engine; and holds
every kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line:

1. device       — the card's name and power limit (nvidia-smi), the build,
                  ptxas usage and SASS scans (no CALL in the TX commit,
                  the lookups or the PUT commits, no spill in the
                  lookups), and the launch
                  floor: a one-element PyTorch kernel's device time;
2. load         — 2^26 distinct keys PUT into a store of 2^24 buckets x 8
                  ways and 2^27 64-B values behind a 65,536 x 4 cache;
3. kernels      — each KVS kernel against its plain version at the
                  engine's batch (256 requests on the loaded store);
                  probe, cache_probe and get_walk also at the load
                  phase's 65,536, get_walk beside the five calls it
                  replaces (probe, clamp, select, fetch, select);
                  commit_buckets and write_rows also at the serve mix
                  (5% PUTs: about 244 of 256 entries aim at the sentinel
                  rows) and at 65,536 fresh keys;
4. serve        — 200 KVS engine steps at budget 256 (95% GET / 5% PUT,
                  zipf 0.99 keys, 1% absent) through two engines, ``auto``
                  (the kernels) and ``ref`` (the plain versions on the
                  card): equal responses and final states, GETs of loaded
                  keys return their values, every kernel of the path
                  launched (the GET walk one get_walk a step, no fetch:
                  fetch runs in the kernel phase only); the
                  step's device µs and launches with the PUT plan's two
                  target sorts (which only the TPU commit needs) put back
                  and without them, in turns;
5. tx_kernels   — commit and commit_chain against their plain versions on
                  a chain of 3 replicas of 2^24 64-B rows and a 2^18-record
                  log, 256 planned transactions with conflicts, duplicates,
                  skewed tails and a dead replica, and commit at B = 1 on a
                  record planned as log replay plans it; the share of
                  targets that are sentinels;
6. tx_serve     — 200 TX engine steps at budget 256 (1-8 write ops, zipf
                  0.99 offsets, 0.5% MALFORMED, clients retry DEFERRED)
                  through an ``auto`` and a ``ref`` engine: equal responses
                  and states, replicas identical, the log holds exactly the
                  committed transactions in commit order and replays to the
                  store;
7. tx_resync    — the log records committed after step 180 replayed into a
                  replica cloned at step 180 (``replay_records``, one
                  ``commit`` launch per record) rebuild the final replica;
8. tx_soak      — ``fault.soak.run_soak`` at the TX shape (32 queues of
                  2^19 keys, seed 7, 200 steps): drops, duplicates,
                  corruption, delays, suppressed doorbells, replica 1 killed
                  and revived by log replay (``commit`` launches = records
                  replayed), a never-failed twin equal bit for bit, the
                  numpy oracle of the store;
9. tx_crash     — ``run_crash_soak`` at the same shape (seed 11, 40 steps
                  generating (cut from 80 for the time) then the drain,
                  a flush every 2, a full snapshot at most every 128
                  steps (cut from 32)): full snapshots and WAL deltas to a
                  temporary directory, a kill, ``recover`` equal bit for
                  bit to a never-crashed twin at the covered step, the
                  ``commit`` launches = the records replayed;
10. tx_spmd     — the chain of 3 as 3 ranks sharing the card (spawned
                  processes, gloo, CUDA tensors staged through page-locked
                  host buffers), one 1.22 GB replica each: the tx_serve
                  stream's 200 batches at budget 256 through
                  ``chain_commit_spmd`` (batch and decision hop by hop,
                  ``commit`` once a batch on every rank, the ACK back),
                  then a whole-chain twin through ``chain_commit_local``:
                  every replica and decision bit for bit; step times, hop
                  times by role (a forward hop's batch and proceed, an
                  ACK hop), the backend;
11. kvs_recover — the KVS store cut to 2^20 buckets and 2^23 values: the
                  durability arm, then a crash, ``recover`` equal to the
                  flushed state, and steps after recovery through the five
                  hash kernels equal to a twin's;
12. dlrm_kernels — embedding_reduce against its plain version on 8 tables of
                  2^20 x 64 rows (f32, and a bf16 copy), 256 queries,
                  beside embedding_bag L2-warm and cold; and a sweep of
                  1, 32 and 128 lookups a segment at the same 65,536
                  lookups;
13. dlrm_serve   — 200 DLRM engine steps at budget 256 through an ``auto``
                  and a ``ref`` engine: equal responses, logits equal a
                  direct ``forward``, malformed requests NACKed;
14. merci       — MERCI-rewritten queries at the JAX bench's table size:
                  kernel path equals the plain path, and the raw logits;
15. lm_kernels  — paged_attention_stats and flash_attention against their
                  plain versions at the serve shapes (a 32-sequence pool
                  of 16-token pages, 8 prompts of 512 tokens, 40 q / 8 kv
                  heads), bf16 and f32, flash also with window 128, and
                  the paged walk over 4 sequences of 16,384 tokens (bf16);
                  both again at the MoE model's heads (32 q / 4 kv, so
                  G = 8, the paged kernel's largest group), bf16, and
                  both at one of lm_tp_serve's 2 ranks' heads (flash
                  20 q / 4 kv and 16 q / 2 kv, the paged walk 4 kv of G
                  5 and 2 kv of G 8); the walk at one of lm_dp_serve's
                  data ranks' 16 slots (8 kv of G 5); flash at one of
                  lm_tp_families' ranks' heads (vlm 14 q / 2 kv; the
                  hybrid's 30 / 6 padded heads as 15 / 3, hd 64, window
                  1,024, 2,048 tokens; audio 16 / 16, hd 64); each
                  with its library call's device time where there is one,
                  the paged cases with their split count;
16. lm_serve_f32 — Qwen2.5-14B at full width cut to 4 layers, f32: the
                  kernel engine and the plain engine give equal token
                  streams and page pools within 1e-5 of each layer's scale;
17. lm_crash    — ``run_lm_crash_soak`` on that cut at its engine shape
                  (caps cut from 128 to 64 tokens for the time) and 32
                  requests, the pool at 3/4 of its worst case with a
                  host cold tier: a kill mid-decode, recovery bit for bit
                  the never-crashed twin's, token streams byte-identical to
                  the twin's and to a plain engine's (``ref``);
18. lm_serve    — 4 of its 48 layers (widths kept) in bf16 with the
                  flash prefill, 96
                  requests (512-token prompts, caps up to 128) through 32
                  slots: the kernel engine (the launch counts), the plain
                  engine (free-running agreement, reported), a
                  teacher-forced check over 40 decode steps that must
                  decide at least 10% (and 64) of its rows with equal
                  argmax, and a per-layer walk check of the live pool;
19. lm_moe_serve — the same for Qwen3-MoE-30B-A3B at full width cut to
                  4 of its 48 layers, in bf16 (128 experts, top 8; 7
                  GB of weights), after the dense weights are freed: the
                  same engine and requests, the same checks, and the share
                  of (token, layer) top-8 expert sets on which the kernel
                  and plain paths agree in the teacher-forced window
                  (reported);
20. lm_vlm_serve — Qwen2-VL-7B (M-RoPE, G 7), 4 of its 28 layers in bf16,
                  the
                  same engine and checks, 32 requests, and a media prefill
                  (1,024 media positions) against the plain version and
                  against no media, whose logits it must change;
21. lm_hybrid_serve — Hymba-1.5B (attention in a 1,024-token window beside
                  a Mamba branch), 4 of its 32 layers in bf16, 32
                  requests of
                  2,048 tokens through the dense ring engine with the
                  flash prefill, the plain engine beside it; the
                  teacher-forced rows of 8 prompts (every position, then
                  16 decode steps): in bf16 every decided row
                  argmax-equal, at least 64 decided, beside the control of
                  two plain versions; in f32 at full width and that depth
                  the 10% share; every layer's flash call against its plain
                  version; a crash-and-recover cycle (below);
22. lm_ssm_serve — RWKV6-1.6B (attention-free), 4 of its 24 layers in
                  bf16, 32 requests through the dense engine: no hand-written
                  kernel on its path; the card against the CPU in f32 at
                  4 layers, 8 requests: equal token streams, states within
                  1e-5 of each layer's scale; a crash-and-recover cycle:
                  the same requests through a fresh kernel engine, a full
                  snapshot through ``DurabilityManager`` every 8 steps, a
                  kill at step 20 (mid-decode, two flushes committed),
                  ``recover`` into a fresh state equal bit for bit to the
                  state flushed at the covered step, then steps to the end
                  whose final state and responses equal the never-crashed
                  kernel run's bit for bit (hybrid too, after phase 20's
                  kernel run; its admission prefills launch flash);
23. lm_audio     — MusicGen-large (4 codebooks, G 1), 12 of its 48 layers
                  in bf16: 8 x 512 frames through prefill with the flash
                  kernel, then 64 decode steps; the plain version beside
                  it; the teacher-forced rows with the 10% share; every
                  layer's flash call against its plain version;
24. lm_train     — Qwen1.5-0.5B trained at full width and depth in bf16
                  (remat on), 4 x 4,096 tokens a step: 4 steps through
                  the launcher's train step, data pipeline and schedule,
                  every loss and grad norm finite, with a checkpoint after
                  step 2; steps 3-4 resumed from it equal the
                  uninterrupted run bit for bit; every bf16 product of one
                  step (``layers.MatmulF32``) with its grads held against
                  the plain upcast product's on the same inputs and
                  cotangent; the card against the CPU in f32 at 2 layers.
                  No hand-written kernel runs on this path;
25. zero1_train  — Qwen1.5-0.5B at full width and depth in bf16 (remat
                  on), a global batch of 2 x 4,096 tokens over 2 data
                  ranks sharing the card (gloo, host-staged), 2 ZeRO-1
                  steps: the ranks' params bit-equal after every step;
                  losses, grad norms, params and first moment against the
                  single-process step on the global batch (the training
                  tolerance), and tightly against the half-batch
                  reference (the ranks' arithmetic in one process), the
                  params' change from step 0 included; rank 0 saves and
                  a one-rank ``elastic.resume`` restores params and
                  optimizer state bit for bit; then, on the same ranks
                  and mesh (its own line, dp_moe_train), Qwen3-MoE-30B-A3B
                  at full width cut to 2 layers in f32, GSPMD moe_apply
                  at the config's capacity factor 1.25, 2 x 512 tokens,
                  each rank its rows: the whole batch's capacity,
                  dispatch positions and router statistics; the ranks'
                  gradients summed (reduce-scattered) within 1e-4 of
                  each leaf's largest |grad| of the one-process gradient
                  of the whole batch, the loss and aux within 1e-5, and
                  the drops of both sides equal and above 0;
26. tp_train     — the same Qwen1.5-0.5B run (its seed and batches) on 2
                  model ranks sharing the card, mesh (1, 2), through the
                  launcher's ``build_train_step``: losses and grad norms
                  within the training tolerance of zero1_train's
                  single-process steps, the params' change from step 0 at
                  cosine 0.5 or more with the single run's (this rank's
                  block; the distance printed), each rank's update equal
                  to a one-device AdamW replay of its blocks on the
                  gradients its steps took (norm, m, v within 1e-4, the
                  change within 1e-2), the replicated
                  leaves bit-equal across the ranks after every step; then
                  f32 gradients at full width, Qwen1.5-0.5B (2 layers, 256
                  tokens) and Qwen3-MoE-30B-A3B (2 layers, 512 tokens, the
                  EP dispatch, dropless on both sides), each rank's blocks
                  within 1e-4 of each leaf's largest |grad| of the
                  one-process gradient on the card. No hand-written kernel
                  runs on this path;
27. lm_tp_serve  — Megatron tensor parallelism of LM serving on 2 model
                  ranks sharing the card (gloo, host-staged): Qwen2.5-14B
                  at full width cut to 2 of 48 layers (20 q / 4 kv heads
                  a rank) and Qwen3-MoE-30B-A3B cut to 2 (64 experts and
                  16 q / 2 kv heads a rank, the EP shard_map dispatch for
                  prefill), bf16, each rank its blocks of the seeded
                  params, 16 requests of 512 tokens through the dense ring
                  engine (8 admitted a step, caps of 32): the ranks'
                  responses equal, each rank's flash launches = layers x
                  admission steps; 8 prompts and 24 decode steps
                  teacher-forced against the one-process run of the same
                  params on the card (lm_serve's rule; MoE dropless on
                  both sides, the ranks at capacity factor 4 and the one
                  process at E/k, and failing if either drops; the
                  expert-set agreement reported); each
                  model at 2 layers in f32 against the one-process
                  f32 run within 1e-5 of each value's scale (logits and
                  ring caches); and the paged engine on the same ranks
                  and requests (each rank's page pool its kv heads, the
                  decode walk paged_attention_stats at the rank's shape,
                  KVH 4 G 5 and KVH 2 G 8): the ranks' responses equal,
                  its teacher-forced rows (prefill_kv, then 24
                  paged_decode_steps) held to the one-process paged
                  run's by the same rule, the paged launches = layers x
                  steps and the flash launches = layers x admission
                  steps on each rank, each rank's live pool walked by the
                  kernel against its plain version. The one-process runs
                  come first, their weights freed before the ranks
                  start;
28. lm_dp_serve  — the LM engine over 2 data ranks: lm_tp_serve's ranks
                  build a (2, 1) mesh and run Qwen2.5-14B (2 layers)
                  through the dense and the paged engine and
                  Qwen3-MoE-30B-A3B (2 layers, GSPMD moe_apply at E/k,
                  dropless) through the paged one over the same
                  requests, each rank 8 of the 16 slots (the integers
                  whole on every rank, the whole admission batch
                  prefilled on every rank, the paged walk on a rank's
                  slots): the ranks' integers equal, and equal to the one
                  process's (the dense engine's to the one process
                  decoding in the ranks' row blocks), the teacher-forced
                  rows of each rank's slots (ring and paged) by
                  lm_serve's rule, the launches layers x steps; then in
                  f32 at 2 layers the paged engine with the swap service
                  after every step (a pool of 5 of 8 worst-case requests):
                  every integer equal to the one process's run, an
                  eviction and a restore, each rank parking pages of its
                  own slots;
29. lm_tp_families — the vlm, hybrid (padded heads), ssm and audio models
                  at full width cut to 2 layers, bf16, on lm_tp_serve's
                  2 model ranks: a prefill (flash at a rank's heads) and
                  16 decode steps fed the one-process run's tokens, the
                  ranks' logits bit-equal, the rows by lm_serve's rule;
                  in f32 the logits and every decode-state leaf (the
                  rank's block) within 1e-5 of each value's scale. The
                  hybrid's one process runs the padded params at the
                  padded plan, its padded q heads masked.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
Any mismatch raises and exits non-zero before the last line. Without a
CUDA device, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# the paper's KVS working set: ~7 GB of 64-B values behind a 512 MB-class
# cache (benchmarks/bench_kvs.py); here ~8.6 GB of pool + 1.6 GB of buckets
KV_SHAPE = dict(num_buckets=2**24, ways=8, key_words=2, val_words=16,
                pool_size=2**27, cache_sets=65536, cache_ways=4)
N_KEYS = 2**26
FILL_BATCH = 65536
BATCH = 256  # the paper's outstanding requests = the engine budget
STEPS = 200
QUEUES = 32
CAPACITY = 64
ZIPF = 0.99
KEY_MULT = 0x9E3779B1 % N_KEYS | 1  # odd: rank -> key index is a bijection

# each CUDA kernel: its source, and the TPU kernel it replaces (its def
# line in the JAX package)
_CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {
    "probe": ("hash_probe.cu", "src/repro/kernels/hash_probe.py", 67),
    "fetch": ("hash_probe.cu", "src/repro/kernels/hash_probe.py", 170),
    "get_walk": ("hash_probe.cu", "src/repro/kernels/hash_probe.py", 192),
    "cache_probe": ("hash_probe.cu", "src/repro/kernels/hash_probe.py", 122),
    "commit_buckets": ("hash_probe.cu", "src/repro/kernels/hash_probe.py",
                       226),
    "write_rows": ("hash_probe.cu", "src/repro/kernels/hash_probe.py", 277),
    "commit": ("tx_commit.cu", "src/repro/kernels/tx_commit.py", 54),
    "commit_chain": ("tx_commit.cu", "src/repro/kernels/tx_commit.py", 118),
    "embedding_reduce": ("embedding_reduce.cu",
                         "src/repro/kernels/embedding_reduce.py", 37),
    "paged_attention_stats": ("paged_attention.cu",
                              "src/repro/kernels/paged_attention.py", 89),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py", 68),
}
# the KVS kernels that the engine's step launches; fetch runs on no main
# path (get_walk does the GET walk) and is held against its plain version
# in the kernel phase only
KVS_MAIN_PATH = ("probe", "get_walk", "cache_probe", "commit_buckets",
                 "write_rows")
CHECK_ONLY = ("fetch",)

# ORCA-TX: 64-B values (benchmarks/bench_tx.py), the usual chain
# replication factor of 3, a 2^18-record redo log per replica
TX_SHAPE = dict(num_keys=2**24, val_words=16, max_ops=8, chain_len=3,
                log_capacity=2**18)
TX_MALFORMED = 0.005
TX_KEY_MULT = 0x9E3779B1 % 2**24 | 1  # odd: rank -> offset is a bijection
TX_RESYNC_AT = 180
# ORCA-DLRM: the repo's widths (dim 64, the paper default); rows scaled up
# from 4,096 so the 2.1 GB of tables lies far outside the 50 MB L2
DLRM_SHAPE = dict(num_tables=8, rows=2**20, dim=64, lookups=32,
                  dense_features=13, bottom=(128, 64), top=(128, 64, 1))
DLRM_NOP, DLRM_BAD_INDEX = 0.01, 0.005
# MERCI at the JAX bench's size (benchmarks/bench_dlrm.py), where the
# host's pair-by-pair rewrite is affordable
MERCI_SHAPE = dict(num_tables=8, rows=16384, dim=64, lookups=32, cluster=4,
                   memo_ratio=0.25)
MERCI_BATCHES, MERCI_QUERIES, MERCI_HIT_RATE = 3, 64, 0.6
MALFORMED = -1  # the NACK status word (repro_torch/core/status.py)
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6  # tests/test_kernel_dispatch.py
MERCI_RTOL, MERCI_ATOL = 1e-3, 1e-4  # tests/test_dlrm.py
# LM serving: Qwen2.5-14B at its full width (src/repro_torch/configs/
# qwen2_5_14b.py: 48 layers, d_model 5120, 40 q / 8 kv heads, hd 128,
# d_ff 13824, vocab 152064, bf16), random weights from the seed
LM_ARCH = "qwen2.5-14b"
LM_LAYERS = 4  # lm_serve cut from 48 (widths kept), to make room for the
# multi-rank phases within the script's time limit (12 before tp_train,
# 8 before dp_moe_train and the paged lm_tp_serve, 6 before lm_dp_serve
# and lm_tp_families)
LM_ENGINE = dict(num_queues=8, capacity=16, prompt_len=512, gen_len=128,
                 slots=32, admit_per_step=8, paged=True, page_size=16)
LM_REQUESTS = 96
LM_F32_LAYERS, LM_F32_REQUESTS = 4, 32
# the long-context paged case: 4 sequences of 16,384 tokens on a bf16 pool
# at the serve head geometry (268 MB), where one CTA per (sequence, kv
# head) would be only 32 CTAs
LM_LONG = (4, 16384)
# MoE LM serving: Qwen3-MoE-30B-A3B at its full width (src/repro_torch/
# configs/qwen3_moe_30b_a3b.py: 48 layers, d_model 2048, 32 q / 4 kv heads,
# hd 128, 128 experts top-8 of expert ff 768, vocab 151936, bf16), random
# weights from the seed, through lm_serve's engine; its attention shapes
# (G = 8) in lm_kernels
LM_MOE_ARCH = "qwen3-moe-30b-a3b"
LM_MOE_REQUESTS = 48  # cut from lm_serve's 96 to keep the script's time
LM_MOE_LAYERS = 4  # cut from 48 (widths kept) for the script's time (8
# before dp_moe_train and the paged lm_tp_serve, 6 before lm_dp_serve and
# lm_tp_families)
LM_MOE_HEADS = (32, 4)
# the other four families, each at full width and depth in bf16 with
# random weights from the seed (src/repro_torch/configs/): Qwen2-VL-7B (28
# layers, d 3584, 28 q / 4 kv heads: G 7, M-RoPE, 1,024 media positions)
# through lm_serve's paged engine, cut to 32 requests (one wave of slots);
# Hymba-1.5B (32 layers, d 1600, 25 q / 5 kv heads of 64, a 1,024-token
# window beside a Mamba branch of state 16) through the dense engine with
# 2,048-token prompts, so that the window bites, its ring the window;
# RWKV6-1.6B (24 layers, d 2048, attention-free) through the dense engine;
# MusicGen-large (48 layers, d 2048, 32 q / 32 kv heads of 64, 4
# codebooks) through prefill and decode_step
LM_VLM_ARCH, LM_VLM_REQUESTS = "qwen2-vl-7b", 32
LM_VLM_LAYERS = 4  # cut from 28 (widths kept) for the script's time
LM_HYBRID_ARCH = "hymba-1.5b"
LM_HYBRID_LAYERS = 4  # cut from 32 (widths kept) for the script's time
# (6 before lm_dp_serve and lm_tp_families)
LM_HYBRID_ENGINE = dict(LM_ENGINE, paged=False, prompt_len=2048,
                        cache_len=1024)
LM_SSM_ARCH = "rwkv6-1.6b"
LM_SSM_LAYERS = 4  # cut from 24 (widths kept) for the script's time (6
# before lm_dp_serve and lm_tp_families)
LM_SSM_ENGINE = dict(LM_ENGINE, paged=False)
LM_DENSE_REQUESTS = 32  # hybrid and ssm
# their crash-and-recover cycles: a flush every LM_RECOVER_EVERY engine
# steps, the kill after step LM_RECOVER_KILL (mid-decode, two flushes
# committed)
LM_RECOVER_EVERY, LM_RECOVER_KILL = 8, 20
# the ssm card-against-CPU check: layers, requests, and its engine (8
# slots, caps up to 32: the CPU decodes every slot each step)
LM_SSM_CPU = (4, 8)
LM_SSM_CPU_ENGINE = dict(LM_SSM_ENGINE, slots=8, gen_len=32)
LM_AUDIO_ARCH = "musicgen-large"
LM_AUDIO_LAYERS = 12  # cut from 48 (widths kept) for the script's time
# (16 before lm_dp_serve and lm_tp_families)
LM_AUDIO_FRAMES = (8, 512)  # prompts x frames of 4 codebook tokens
LM_AUDIO_STEPS = 64  # decode steps after the prefill
LM_TF_PROMPTS = 8  # prompts of the prefill teacher-forced checks
LM_PREFILL_TF_STEPS = 16  # their decode steps after the prefill
LM_FAMILY_PROFILE_STEPS = 4  # the profiled steps of hybrid, ssm and audio
LM_SNAPSHOT_STEP = 24  # the engine step the teacher-forced check starts at
LM_TF_STEPS = 40  # teacher-forced decode steps (at least 32)
# training: Qwen1.5-0.5B at full width and depth (src/repro_torch/configs/
# qwen1_5_0_5b.py: 24 layers, d_model 1024, 16 q / 16 kv heads, d_ff 2816,
# vocab 151936, QKV bias, tied embeddings, remat), bf16, random weights
# from the seed, at train_4k's seq_len 4,096 with its global batch cut
# from 256 to 4 (16,384 tokens a step): LM_TRAIN_STEPS steps through the
# launcher's build_train_step, the data pipeline (seed 0) and the
# warmup-cosine rate, a checkpoint after step LM_TRAIN_SAVE_AT and a
# resume from it; each product's grads against the plain upcast product
# within LM_TRAIN_GRAD_TOL of the largest |plain grad|; the card against
# the CPU in f32 at LM_TRAIN_CPU (layers, batch, tokens) at full width,
# within LM_TRAIN_F32_TOL of each leaf's scale
LM_TRAIN_ARCH = "qwen1.5-0.5b"
LM_TRAIN_BATCH = 4
LM_TRAIN_STEPS, LM_TRAIN_SAVE_AT = 4, 2
LM_TRAIN_GRAD_TOL = 1e-2
LM_TRAIN_CPU = (2, 2, 256)
LM_TRAIN_F32_TOL = 1e-5
# multi-rank phases: ranks share the one card, so they talk over gloo
# (NCCL refuses two ranks on one device) and the collectives stage CUDA
# tensors through page-locked host buffers. tx_spmd: TX_SHAPE's chain of 3
# as 3 ranks, one replica each, the tx_serve stream (STEPS batches at
# BATCH). zero1_train: LM_TRAIN_ARCH at full width and depth, bf16 with
# remat, train_4k's 4,096 tokens, a global batch of ZERO1_BATCH over
# ZERO1_RANKS data ranks, ZERO1_STEPS steps; losses and grad norms within
# ZERO1_TOL of the single-process step on the same global batches (PR
# 24's bf16 product tolerance), the params within that of each leaf's
# scale plus 2 x the summed rate
RANK_BACKEND = "gloo"
RANK_TIMEOUT = 600  # s, each multi-rank phase's launch
# ZERO1_STEPS cut from 3 to 2 (tp_train's steps with it) for the
# script's time when dp_moe_train joined zero1_train's launch
ZERO1_RANKS, ZERO1_BATCH, ZERO1_STEPS = 2, 2, 2
ZERO1_TOL = 1e-2
# the first moment against the single-process step's. Each rank's bf16
# gradient comes from products over half the tokens, rounded to bf16
# before the f32 sum, where the single step rounds one product over all
# of them. This gate was 1e-2 and was raised to 3e-2 after a chip run
# failed it (m 2.09e-2 of the leaf's largest |m| apart, attention and MLP
# weights); the half-batch reference below tests that explanation
ZERO1_M_TOL = 3e-2
# the half-batch reference: after the ranks, the parent runs their
# arithmetic in one process (each rank's rows' bf16 gradient, scaled by
# its share, summed in f32, one AdamW update) from the same step-0 params,
# clipped by the ranks' global norm of each step (their sum runs in
# another order: left to itself the reference's norm differs in its last
# bits, a few bf16 roundings of step 2 flip, and on bf16 random weights
# those reach every gradient of step 3). Losses, its own grad norms, m and
# v within ZERO1_HALF_TOL (of each leaf's largest value for m and v); the
# params' change from step 0 within ZERO1_DELTA_TOL of the reference's
# (the norm of the difference over the norm of the change: a skipped
# update gives 1), and its cosine with the single step's change at least
# ZERO1_DELTA_COS
ZERO1_HALF_TOL = 1e-4
ZERO1_DELTA_TOL = 1e-2
ZERO1_DELTA_COS = 0.5
# tp_train: training under Megatron tensor parallelism, TP_TRAIN_RANKS
# model ranks sharing the card (gloo, host-staged). zero1_train's run
# (Qwen1.5-0.5B, full depth, bf16, remat, its global batches and seed)
# through build_train_step on a (1, 2) mesh, held against the
# single-process steps zero1_train ran: losses and grad norms within
# ZERO1_TOL, the change from step 0 at cosine ZERO1_DELTA_COS or more
# with the single run's (this rank's block), the replicated leaves
# bit-equal across the ranks. The update is held to a replay with the
# ranks' own arithmetic, as zero1_train's half-batch reference holds
# its ranks: on each rank, one-device AdamW of its blocks on the
# gradient blocks each step took, clipped by the ranks' norm; that norm
# summed afresh in f64, m and v within ZERO1_HALF_TOL and the change
# within ZERO1_DELTA_TOL of the replay's. The change's distance from the
# single run's is printed, not gated (0.114 on an NVIDIA H100 at full
# depth: at this rate most bf16 params do not move, and which cross a
# rounding boundary depends on the order of the sums; zero1_train prints
# its ranks' distance beside it). Then f32 gradients at full width,
# (layers, batch, tokens): Qwen1.5-0.5B and Qwen3-MoE-30B-A3B (EP
# shard_map dispatch, dropless as lm_tp_serve: the ranks at
# LM_TP_MOE_CF, the one process at E/k), each rank's blocks within
# TP_TRAIN_GRAD_TOL of each leaf's largest |grad| of the one-process
# gradient on the card
# dp_moe_train: data-parallel MoE training in zero1_train's launch (its
# (2, 1) mesh, after its steps): Qwen3-MoE-30B-A3B at full width cut to
# DP_MOE_TRAIN's layers, f32, GSPMD moe_apply at the config's own
# capacity factor (1.25: it drops), a global batch of rows x tokens, each
# data rank its rows. The whole batch's gradient (the ranks' share-
# weighted gradients summed, each rank keeping its half of every leaf: a
# reduce-scatter) against the one-process gradient of the whole batch on
# the card, within DP_MOE_GRAD_TOL of each leaf's largest |grad|; the
# loss and aux within DP_MOE_LOSS_TOL relative; the assignments the
# whole batch's capacity drops, counted on both sides from the routers'
# loads, equal and above 0
DP_MOE_TRAIN = (2, 2, 512)  # layers, global rows, tokens a row
DP_MOE_GRAD_TOL, DP_MOE_LOSS_TOL = 1e-4, 1e-5
TP_TRAIN_RANKS = 2
TP_TRAIN_DENSE_F32, TP_TRAIN_MOE_F32 = (2, 1, 256), (2, 1, 512)
TP_TRAIN_GRAD_TOL = 1e-4
# lm_tp_serve: Megatron tensor parallelism of LM serving over LM_TP_RANKS
# model ranks sharing the card (gloo, host-staged). The dense run is
# Qwen2.5-14B at full width cut to LM_TP_LAYERS of 48 layers (20 q / 4 kv
# heads a rank), the MoE run Qwen3-MoE-30B-A3B cut to LM_TP_MOE_LAYERS
# (64 experts, 16 q / 2 kv heads a rank; the EP shard_map dispatch for
# prefill), both bf16 with the flash prefill, through the dense ring
# engine (LM_TP_ENGINE: LM_TP_REQUESTS prompts of 512 tokens, every cap
# 32 tokens, 8 admitted a step, the ring the whole context). Checks: the
# ranks' responses equal; LM_TP_TF_PROMPTS prompts prefilled, then
# LM_TP_TF_STEPS decode steps fed the one-process run's greedy tokens,
# decided as lm_serve's check decides (the one-process run of the same
# params on the card is the reference); each model at
# LM_TP_F32_LAYERS layers in f32, held to the one-process f32 run by the
# f32 LM measure (POOL_REL_TOL of each value's scale: logits each step,
# each layer's ring caches on the rank's kv heads)
LM_TP_RANKS = 2
LM_TP_LAYERS, LM_TP_MOE_LAYERS, LM_TP_F32_LAYERS = 2, 2, 2
# the MoE run is dropless on both sides, so both compute one function
# (Qwen3-MoE itself drops nothing): the ranks' EP shard_map prefill
# sizes a send buffer from each rank's share of the tokens and an
# expert's buffer again at its rank, so at tp 2 with 128 experts of 8 a
# factor of 4 holds every assignment (a send buffer needs a factor of
# tp, an expert's buffer its square E/k); the one-process moe_apply sizes
# an expert's buffer from all the prefill's tokens and needs E/k (16),
# which the EP buffers cannot take (64 GB a rank). At the config's 1.25
# the two drop different assignments, in the JAX package too: this
# phase's first run on an NVIDIA H100 80GB HBM3 at 700.00 W decided 21
# of 200 teacher-forced rows. The phase fails if either side drops
LM_TP_MOE_CF = 4.0
LM_TP_ENGINE = dict(num_queues=8, capacity=16, prompt_len=512, gen_len=32,
                    slots=16, admit_per_step=8, paged=False, cache_len=544)
LM_TP_REQUESTS = 16
LM_TP_TF_PROMPTS, LM_TP_TF_STEPS, LM_TP_F32_STEPS = 8, 24, 4
# the paged engine on the same ranks and requests: each rank's pool holds
# its kv heads (dense 4, MoE 2), its decode walks them with
# paged_attention_stats at the rank's shape (B 16, KVH 4, G 5; KVH 2,
# G 8) and its admission prefills them with flash; its teacher-forced
# rows (the same prompts through prefill_kv and paged_decode_step) held
# to the one-process paged run by lm_serve's rule
LM_TP_PAGED_ENGINE = dict(LM_TP_ENGINE, paged=True,
                          page_size=LM_ENGINE["page_size"])
# lm_dp_serve: the LM engine over LM_DP_RANKS data ranks sharing the card
# (gloo, host-staged), in lm_tp_serve's two launches (the same ranks build
# a (2, 1) mesh after their (1, 2) one): Qwen2.5-14B at LM_TP_LAYERS
# layers through the dense and the paged engine, Qwen3-MoE-30B-A3B
# through the paged engine on GSPMD moe_apply at E/k (dropless, as the
# one process), both over lm_tp_serve's requests (LM_TP_ENGINE: 16 slots,
# 8 a rank; every rank prefills the whole admission batch and keeps its
# slots' rows), held to lm_tp_serve's one-process runs: every integer of
# each engine's final state, and the teacher-forced rows (the ring and
# the paged path, each rank its rows) by lm_serve's rule. Then the dense
# model at LM_TP_F32_LAYERS in f32 through the paged engine with the swap
# service after every step (LM_DP_SWAP_ENGINE: 8 slots of 64-token
# prompts and caps of 32, a pool of 5 of the 8 worst-case requests, the
# host tier the 7 victims the config needs): every integer equal to the
# one process's run, an eviction and a restore, and each rank parking
# pages of its own slots
LM_DP_RANKS = LM_TP_RANKS
LM_DP_SWAP_ENGINE = dict(num_queues=4, capacity=16, prompt_len=64,
                         gen_len=32, slots=8, admit_per_step=4, paged=True,
                         page_size=16, num_pages=5 * 6, host_pages=7 * 6)
LM_DP_SWAP_REQUESTS = 16
# lm_tp_families: the vlm, hybrid, ssm and audio models on lm_tp_serve's
# dense launch over its (1, 2) mesh, bf16 at full width cut to
# LM_FAM_TP_LAYERS layers: (arch, prompts, tokens) prefilled (flash at a
# rank's heads: rows 10g-10i), then LM_FAM_TP_STEPS decode steps fed the
# one-process run's greedy tokens, held to it by lm_serve's rule, the
# ranks' logits bit-equal; each again at LM_TP_F32_LAYERS in f32 for
# LM_TP_F32_STEPS steps, logits and every decode-state leaf (the rank's
# block) within POOL_REL_TOL of each value's scale. The hybrid's one
# process runs the ranks' padded params (30 q / 6 kv heads) at the padded
# plan, its padded q heads masked by attention.q_head_mask
LM_FAM_TP_LAYERS = 2
LM_FAM_TP = {"vlm": (LM_VLM_ARCH, 8, 512), "hybrid": (LM_HYBRID_ARCH, 8, 2048),
             "ssm": (LM_SSM_ARCH, 8, 512),
             "audio": (LM_AUDIO_ARCH, 8, LM_AUDIO_FRAMES[1])}
LM_FAM_TP_STEPS = 16
# the profiled window: a copy of the engine state after this step runs the
# next LM_PROFILE_STEPS steps under torch.profiler
LM_PROFILE_STEP, LM_PROFILE_STEPS = 40, 16
LM_DECIDED_SHARE, LM_DECIDED_MIN = 0.10, 64
# kernel vs plain version: tests/test_kernels.py (1e-5 f32, 2e-5 f32
# flash, 3e-2 bf16); the f32 pools of the two engines: max |diff| within
# 1e-5 of each layer's largest |value|
LM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
FLASH_F32_TOL = 2e-5
POOL_REL_TOL = 1e-5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
# fault tolerance and durability (src/repro_torch/fault): the seeded fault
# soak and the crash soak at the TX serve shape (TX_SHAPE as 32 queues of
# 2^19 keys each); the KVS store cut to 2^20 buckets and 2^23 values (a
# flush copies the whole store to the host); the LM crash soak through the
# 4-layer f32 Qwen2.5-14B cut of lm_serve_f32 at its engine shape and
# request count, its caps cut from 128 to 64 tokens for the script's time
# (about half the ticks), with the pool cut to 3/4 of its worst case (864
# of 32 x 36 pages) so that decode stalls and evicts into a host cold tier
# of the least size the engine accepts ((slots - 1) x 36 pages). tx_crash
# generates for 40 steps (cut from 80 for the time; the drain after them
# is as before), its kill at 13, crash at 21, revive at 26
TX_SOAK = dict(num_queues=32, keys_per_queue=2**19, max_ops=8, val_words=16,
               chain_len=3, log_capacity=2**18, capacity=64, budget=256)
TX_SOAK_SEED, TX_SOAK_STEPS = 7, 200
TX_CRASH_SEED, TX_CRASH_STEPS, TX_CRASH_EVERY = 11, 40, 2
# a full snapshot at most every 128 steps, cut from DurabilityConfig's
# default 32 for the script's time: the kill at step 21 recovers from the
# snapshot at step 2 and the WAL either way, and each later full snapshot
# only writes the whole chain (3.65 GB) to disk again (15 of them took 55
# GB and 71 s of flush waits at 32, PR 28)
TX_CRASH_SNAPSHOT_EVERY = 128
KV_RECOVER_SHAPE = dict(KV_SHAPE, num_buckets=2**20, pool_size=2**23)
KV_DURABILITY_STEPS = 64  # the overhead arm (soak.run_durability)
KV_RECOVER_STEPS, KV_RECOVER_AFTER = 24, 8  # crash run; steps after recovery
LM_CRASH_ENGINE = dict(LM_ENGINE, gen_len=64, num_pages=864,
                       host_pages=31 * 36)
LM_CRASH_SEED, LM_CRASH_STEPS, LM_CRASH_REQUESTS = 3, 36, LM_F32_REQUESTS
# WAL segments of 256 MiB: a TX delta at this shape carries both rings
# (2.3 MB) and an LM delta several 0.5 MB pages, past the 1 MiB default,
# where every record would rotate the segment and pay an fsync of its own
SEGMENT_BYTES = 256 << 20


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started when it was printed."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def _fmix32(x):
    """murmur3's 32-bit finaliser on int64 tensors: a bijection of 32-bit
    values that spreads every input bit over the low bits the bucket and
    set hashes keep."""
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def key_words(idx, torch):
    """(N, 2) int32 keys of key indices ``idx`` (int64, < 2^32): word 0 is a
    bijection of the index, so distinct indices give distinct keys."""
    words = torch.stack([_fmix32(idx), _fmix32(idx ^ 0x5BD1E995)], dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def loaded_values(idx, val_words, torch):
    """(N, VW) int32 value of key index ``idx``: a function of the key."""
    j = torch.arange(val_words, dtype=torch.int64, device=idx.device)
    v = ((idx[:, None] * 16 + j[None, :]) * 2246822519 + 12345) & 0x7FFFFFFF
    return v.to(torch.int32)


def time_us(torch, fn, reps=50, warmup=5):
    """Median per-call time in µs by CUDA events (one pair per call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1000.0


def loop_us(torch, fn, reps=50, warmup=5):
    """µs per call over ``reps`` back-to-back calls between one pair of
    CUDA events: the device time per call wherever the card, not the
    host's launches, is the slower side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1000.0 / reps


def queued_us(torch, fn, reps=100, spin_cycles=100_000_000):
    """Device µs per call by CUDA events, the calls queued behind a spin
    kernel (``torch.cuda._sleep``) so that the card runs them back to back
    whatever the host's launch time: what the profiler's device time
    measures, read from events where the profiler reads 0."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1000.0 / reps


def device_us(torch, fn, reps=20):
    """Run ``fn`` ``reps`` times under torch.profiler. Returns (device µs per
    call over every kernel and copy it ran on the card, {kernel name:
    (device µs, launches) per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per.get(e.name, (0.0, 0.0))
            per[e.name] = (us + e.device_time_total / reps, n + 1 / reps)
    return sum(us for us, _ in per.values()), per


def _bits(torch, t):
    """Integer view of a tensor, so equality is bit equality (floats too)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def cold_device_us(torch, fn, reps=20):
    """Device µs per call with the 50 MB L2 flushed before each call, as a
    caller that touched other memory in between finds it: the profiled
    time of (flush, call) less that of the flush alone."""
    flush = torch.empty((64 << 20,), dtype=torch.uint8, device="cuda")

    def both():
        flush.zero_()
        fn()

    total, _ = device_us(torch, both, reps)
    alone, _ = device_us(torch, flush.zero_, reps)
    return total - alone


def max_abs_err(torch, got, want):
    """Largest |got - want| (0 when bit-equal), over the differing elements
    only: the commit outputs are whole multi-GB state arrays."""
    diff = _bits(torch, got) != _bits(torch, want)
    if not bool(diff.any()):
        return 0
    if got.dtype.is_floating_point:
        return float((got[diff].double() - want[diff].double()).abs().max())
    return int((got[diff].to(torch.int64) - want[diff].to(torch.int64))
               .abs().max())


def mismatches(torch, got, want) -> int:
    """Elements that differ in their bits."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    return int((_bits(torch, got) != _bits(torch, want)).sum())


def kernel_entry(torch, name, outs_k, outs_p, k_fn, p_fn, nbytes, batch,
                 lib_fn=None):
    """One kernel against its plain version on the same inputs: the
    mismatching elements of its outputs, then its time (CUDA events,
    median of 50 calls, and device time from the profiler), the plain
    version's, the library call's if there is one (by CUDA events, and
    its device time from the profiler, L2-warm and cold, like for like
    with the kernel's), and its bound: the bytes it must move over the
    card's memory rate."""
    miss = sum(mismatches(torch, a, b) for a, b in zip(outs_k, outs_p))
    err = max(max_abs_err(torch, a, b) for a, b in zip(outs_k, outs_p))
    us = time_us(torch, k_fn)
    plain_us = time_us(torch, p_fn)
    lib_us = time_us(torch, lib_fn) if lib_fn is not None else None
    lib_dev = device_us(torch, lib_fn)[0] if lib_fn is not None else None
    lib_cold = cold_device_us(torch, lib_fn) if lib_fn is not None else None
    k_dev, _ = device_us(torch, k_fn)
    p_dev, p_kernels = device_us(torch, p_fn)
    k_loop = loop_us(torch, k_fn)
    k_queued = queued_us(torch, k_fn)
    k_cold = cold_device_us(torch, k_fn)
    bound_us = nbytes / HBM_BYTES_PER_S * 1e6
    src, jax_file, line = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": _CSRC + src,
        "replaces": f"{jax_file}:{line}",
        "jax_function": f"{jax_file}::{name}", "mismatches": miss,
        "max_abs_err": err, "ms": us / 1e3, "plain_ms": plain_us / 1e3,
        "bound_ms": bound_us / 1e3, "bound_by": "bytes",
        "library_ms": None if lib_us is None else lib_us / 1e3,
        "us": us, "plain_us": plain_us, "library_us": lib_us,
        "library_device_us": lib_dev, "library_device_cold_us": lib_cold,
        "bound_us": bound_us, "bytes": nbytes, "batch": batch,
        "device_us": k_dev, "device_cold_us": k_cold, "loop_us": k_loop,
        "device_events_us": k_queued, "plain_device_us": p_dev,
        "plain_device_launches": sum(n for _, n in p_kernels.values()),
    }


def check_entries(entries, phase):
    bad = {k: v["mismatches"] for k, v in entries.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"{phase}: kernels disagree with their plain "
                             f"versions: {bad}")


def entry_summary(entries):
    return {k: {f: v[f] for f in ("mismatches", "max_abs_err", "us",
                                  "plain_us", "library_us",
                                  "library_device_us",
                                  "library_device_cold_us", "bound_us",
                                  "device_us", "device_cold_us", "loop_us",
                                  "device_events_us", "plain_device_us",
                                  "sentinel_entries", "sector_bound_us")
                if f in v}
            for k, v in entries.items()}


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


PTXAS_SOURCES = ("flash_attention", "paged_attention", "embedding_reduce",
                 "tx_commit", "hash_probe")
# the lookups redesigned to wait on one dependent round trip: their SASS
# must call nothing (no 64-bit division routine) and ptxas must spill none
LOOKUP_KERNELS = ("probe_kernel", "get_walk_kernel", "cache_probe_kernel")
# the PUT commits, whose lane maps use shifts: their SASS calls nothing
COMMIT_KERNELS = ("commit_buckets_kernel", "write_rows_kernel")


def ptxas_usage(build, names=PTXAS_SOURCES):
    """Registers, spills and stack of every kernel in ``csrc/<name>.cu``
    as ``nvcc -Xptxas -v`` reports them, the sources compiled together
    into scratch files of the build directory. {kernel<template args>:
    {registers, spill_stores, spill_loads, stack}}."""
    import re
    import tempfile

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        fd, out = tempfile.mkstemp(suffix=".so", dir=build.BUILD_DIR)
        os.close(fd)
        procs.append((out, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             str(build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    usage, kernel = {}, None
    for out, proc in procs:
        stdout, stderr = proc.communicate()
        os.unlink(out)
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{stderr}{stdout}")
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
                usage[kernel] = {}
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m and kernel:
                usage[kernel].update(stack=int(m.group(1)),
                                     spill_stores=int(m.group(2)),
                                     spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                usage[kernel]["registers"] = int(m.group(1))
    return usage


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel of ``csrc/`` (its template
    arguments as numbers, bf16 or f32), the mangled name where it is not
    one. The name is the shortest <length><identifier> that ends in
    ``_kernel``: nvcc's namespace for a file is a hash of its path, whose
    digits can spell a longer one by chance."""
    import re

    found = []
    for m in re.finditer(r"\d", mangled):
        for k in (1, 2):
            digits = mangled[m.start():m.start() + k]
            at = m.start() + k
            name = mangled[at:at + int(digits)] if digits.isdigit() else ""
            if name.endswith("_kernel") and name.isidentifier() and \
                    len(name) == int(digits):
                found.append((len(name), at, name))
    if not found:
        return mangled
    _, at, name = min(found)
    t = re.match(r"I(\w*?)E[EvP]", mangled[at + len(name):])
    if t is None:
        return name
    args = {"i": "int", "4int4": "int4"}.get(t.group(1), t.group(1))
    args = (args.replace("13__nv_bfloat16Li", "bf16,")
            .replace("fLi", "f32,").replace("Li", "").replace("E", ","))
    return f"{name}<{args}>"


def sass_scan(build, library):
    """What ``cuobjdump -sass`` shows of a built kernel library: its
    kernels, its instructions and its CALL instructions, in all and for
    each kernel (with its global loads, LDG). nvcc inlines a 32-bit
    integer division and compiles a 64-bit one (and its remainder) to a
    called subroutine, so a kernel that calls nothing else divides in 64
    bits nowhere."""
    import re

    tool = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    parts = re.split(r"Function : (\S+)", sass)
    functions = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        functions[kernel_name(name)] = {
            "instructions": len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", body,
                                           re.M)),
            "calls": len(re.findall(r"\bCALL\.", body)),
            "global_loads": len(re.findall(r"\bLDG\.", body)),
        }
    return {
        "kernels": sorted(set(parts[1::2])),
        "instructions": len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", sass,
                                       re.M)),
        "calls": len(re.findall(r"\bCALL\.", sass)),
        "functions": functions,
    }


def phase_device(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build(build.sources())
    build_s = time.perf_counter() - t0
    sass = sass_scan(build, build.library_path("tx_commit"))
    hp_sass = sass_scan(build, build.library_path("hash_probe"))
    ptxas = ptxas_usage(build)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "build_s": build_s,
          "ptxas": ptxas, "tx_commit_sass": sass,
          "hash_probe_sass": hp_sass})
    if sass["calls"]:
        raise AssertionError(f"tx_commit: {sass['calls']} CALL instructions "
                             "in its SASS (a 64-bit division routine)")

    def lookup(name, kernels=LOOKUP_KERNELS):
        return name.split("<")[0] in kernels

    calls = {k: v["calls"] for k, v in hp_sass["functions"].items()
             if lookup(k, LOOKUP_KERNELS + COMMIT_KERNELS)}
    if len(calls) != 10 or any(calls.values()):
        raise AssertionError(f"hash_probe: CALL instructions in the lookup "
                             f"or commit kernels' SASS (or instances "
                             f"missing): {calls}")
    spills = {k: v for k, v in ptxas.items() if lookup(k)
              and (v.get("spill_stores") or v.get("spill_loads"))}
    if spills:
        raise AssertionError(f"hash_probe: the lookups spill: {spills}")
    return smi


def phase_launch_floor(torch, smi):
    """The least device time a launch shows: a one-element PyTorch kernel
    (``add_``) under the same profiler, and by queued CUDA events."""
    x = torch.zeros((1,), dtype=torch.float32, device="cuda")

    def fn():
        x.add_(1)

    dev, per = device_us(torch, fn)
    out = {"phase": "launch_floor", "nvidia_smi": smi,
           "kernel": "one-element torch add_", "device_us": dev,
           "device_launches": sum(n for _, n in per.values()),
           "device_events_us": queued_us(torch, fn), "us": time_us(torch, fn)}
    emit(out)
    return out


def phase_load(torch, kv, hp):
    cfg = kv.KVConfig(**KV_SHAPE)
    state = kv.make(cfg, device="cuda")
    stored = torch.zeros((N_KEYS,), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    hp.reset_launches()
    t0 = time.perf_counter()
    for start in range(0, N_KEYS, FILL_BATCH):
        idx = torch.arange(start, start + FILL_BATCH, device="cuda")
        state, ok = kv.put(state, key_words(idx, torch),
                           loaded_values(idx, cfg.val_words, torch),
                           backend="auto")
        stored[start: start + FILL_BATCH] = ok
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    out = {"phase": "load", "keys": N_KEYS, "batch": FILL_BATCH,
           "fill_s": fill_s, "puts_per_s": N_KEYS / fill_s,
           "ok": int(stored.sum()), "alloc": int(state.alloc),
           "dropped": int(state.dropped),
           "state_gb": sum(t.numel() * 4 for t in state) / 1e9,
           "launches": dict(hp.launches)}
    emit(out)
    if out["ok"] + out["dropped"] != N_KEYS:
        raise AssertionError(f"load: {out['ok']} ok + {out['dropped']} "
                             f"dropped != {N_KEYS}")
    return cfg, state, stored.cpu().numpy(), out["launches"]


def kvs_lookups(torch, kv, state, batch, g):
    """A GET mix of ``batch`` keys on the loaded store: a quarter recently
    loaded (likely cached), a quarter absent, the rest random loaded keys.
    Returns (keys, h1, h2, cset, (recent, loaded, absent) key indices)."""
    dev = "cuda"
    n_recent = n_absent = batch // 4
    recent = N_KEYS - 1 - torch.randint(0, FILL_BATCH, (n_recent,),
                                        generator=g, device=dev)
    loaded = torch.randint(0, N_KEYS, (batch - n_recent - n_absent,),
                           generator=g, device=dev)
    absent = N_KEYS + torch.randint(0, N_KEYS, (n_absent,), generator=g,
                                    device=dev)
    keys = key_words(torch.cat([recent, loaded, absent]), torch)
    nb = state.num_buckets
    h1 = kv.hash_keys(keys, nb)
    h2 = kv.hash_keys(keys, nb, salt=kv.OVERFLOW_SALT)
    cset = kv.hash_keys(keys, state.cache_sets, salt=kv.CACHE_SALT)
    return keys, h1, h2, cset, (recent, loaded, absent)


def probe_bytes(cfg, batch):
    """What ``probe`` must move: the query and both ids read, both buckets'
    key words and pointers read, found and ptr written."""
    kw, w = cfg.key_words, cfg.ways
    return batch * (kw * 4 + 8 + 2 * w * (kw + 1) * 4 + 1 + 4)


def get_walk_bytes(cfg, batch, found):
    """What ``get_walk`` must move: probe's reads (the query, both ids,
    both buckets' key words and pointers), found and the value rows
    written, and a pool row read for each of the ``found`` hits."""
    kw, w, vw = cfg.key_words, cfg.ways, cfg.val_words
    return (batch * (kw * 4 + 8 + 2 * w * (kw + 1) * 4 + 1 + vw * 4)
            + found * vw * 4)


def composed_get(torch, hp, bucket_keys, bucket_ptr, pool, keys, h1, h2):
    """The GET walk in five calls, as the port ran it before
    ``get_walk``: probe, a clamp and a select of the pointers, fetch, and
    a select zeroing the misses. Timed beside ``get_walk``."""
    found, ptr = hp.probe(bucket_keys, bucket_ptr, keys, h1, h2)
    np_ = pool.shape[0] - 1
    vals = hp.fetch(pool, torch.where(found, torch.clamp(ptr, 0, np_), np_))
    return torch.where(found[:, None], vals, 0), found


def composition_entry(torch, outs, want, fn):
    """The five-call walk on ``get_walk``'s inputs: its mismatches
    against the plain version, its summed times by the kernel entry's
    measures, and its device operations a call by name."""
    dev, per = device_us(torch, fn)
    return {"mismatches": sum(mismatches(torch, a, b)
                              for a, b in zip(outs, want)),
            "us": time_us(torch, fn), "device_us": dev,
            "device_launches": sum(n for _, n in per.values()),
            "device_ops": {k[:80]: n for k, (_, n) in per.items()},
            "device_events_us": queued_us(torch, fn),
            "device_cold_us": cold_device_us(torch, fn)}


def cache_probe_bytes(cfg, batch):
    """What ``cache_probe`` must move: the query and the set id read, the
    set's keys and meta read, one value line read and written, hit and way
    written."""
    kw, vw, cw = cfg.key_words, cfg.val_words, cfg.cache_ways
    return batch * (kw * 4 + 4 + cw * (kw + 1) * 4 + 2 * vw * 4 + 5)


def commit_buckets_bytes(cfg, plan, nb):
    """What ``commit_buckets`` must move on this plan: every entry's tb and
    tw read; a live entry's key words and pointer read and written; the
    key words and pointer of each aimed-at sentinel way written once.
    Returns (bytes, bytes in 32-byte sectors: every entry's tb, tw,
    bptr_val and key read, and each distinct sector of bucket_keys and
    bucket_ptr written)."""
    kw, w = cfg.key_words, cfg.ways
    b = plan.tb.shape[0]
    way_ok = (plan.tw >= 0) & (plan.tw < w)
    live = way_ok & (plan.tb >= 0) & (plan.tb < nb)
    dead = way_ok & (plan.tb == nb)
    aimed = int(plan.tw[dead].unique().numel())
    nbytes = b * 8 + int(live.sum()) * (kw + 1) * 4 * 2 + aimed * (kw + 1) * 4
    slot = (plan.tb.long() * w + plan.tw.long())[live | dead]
    sectors = ((slot * kw * 4 // 32).unique().numel()
               + (slot * 4 // 32).unique().numel())
    return nbytes, b * (12 + kw * 4) + sectors * 32


def write_rows_bytes(cfg, wp, np_):
    """What ``write_rows`` must move on these targets: every wp read; a
    live row read and written; row NP written once if some wp aims at
    it."""
    row = cfg.val_words * 4
    n_live = int(((wp >= 0) & (wp < np_)).sum())
    return wp.shape[0] * 4 + n_live * row * 2 + row * int(bool(
        (wp == np_).any()))


def commit_batches(torch, kv, cfg, state, g, recent, loaded, absent):
    """The kernel phase's planned PUT batches, {tag: (keys, vals, plan,
    batch)}, from the key indices ``kvs_lookups`` drew with ``g``:

    - "" — updates, inserts, in-batch duplicates and masked rows (the
      last two aim at the sentinel rows), B = 256;
    - "@serve" — the serve mix: the engine's batch with 5% PUTs, the rest
      masked as app_step masks its GETs (about 244 of 256 entries dead);
    - "@65536" — the load phase's batch: 65,536 keys never loaded, their
      rows from the bump allocator."""
    dev = "cuda"
    vw = cfg.val_words

    def planned(keys, vals, mask=None):
        return (keys, vals, kv.plan_put(state, keys, mask, backend="ref"),
                keys.shape[0])

    put_idx = torch.cat([loaded[: BATCH // 2], absent,
                         loaded[: BATCH // 8], recent[: BATCH // 8]])
    put_vals = torch.randint(-2**31, 2**31 - 1, (BATCH, vw), generator=g,
                             device=dev, dtype=torch.int32)
    put_mask = torch.rand((BATCH,), generator=g, device=dev) > 0.1
    out = {"": planned(key_words(put_idx, torch), put_vals, put_mask)}
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    mix_keys = kvs_lookups(torch, kv, state, BATCH, g)[0]
    mix_vals = torch.randint(-2**31, 2**31 - 1, (BATCH, vw), generator=g,
                             device=dev, dtype=torch.int32)
    mix_mask = torch.rand((BATCH,), generator=g, device=dev) < 0.05
    out["@serve"] = planned(mix_keys, mix_vals, mix_mask)
    fresh = N_KEYS + torch.arange(FILL_BATCH, device=dev)
    out[f"@{FILL_BATCH}"] = planned(key_words(fresh, torch),
                                    loaded_values(fresh, vw, torch))
    return out


def phase_kernels(torch, kv, hp, ref, cfg, state):
    """Each kernel against its plain version at the engine's batch; the
    lookups and get_walk also at the load phase's, get_walk beside the
    composition it replaces; the two commits also at the serve mix and at
    the load phase's batch. Each entry's ``kernel_phase_launches``: the
    wrapper's launches in this phase (not a main path)."""
    hp.reset_launches()
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    keys, h1, h2, cset, picked = kvs_lookups(torch, kv, state, BATCH, g)
    np_ = state.pool_size
    entries = {}

    def record(name, outs_k, outs_p, k_fn, p_fn, nbytes, lib_fn=None,
               batch=BATCH):
        entries[name] = kernel_entry(torch, name.split("@")[0], outs_k,
                                     outs_p, k_fn, p_fn, nbytes, batch,
                                     lib_fn)

    vw = cfg.val_words

    def lookups(keys, h1, h2, cset, batch, tag=""):
        bk, bp = state.bucket_keys, state.bucket_ptr
        found_p, ptr_p = ref.hash_probe(bk, bp, keys, h1, h2)
        record("probe" + tag, hp.probe(bk, bp, keys, h1, h2),
               (found_p, ptr_p), lambda: hp.probe(bk, bp, keys, h1, h2),
               lambda: ref.hash_probe(bk, bp, keys, h1, h2),
               probe_bytes(cfg, batch), batch=batch)
        ck, cv, cm = state.cache_keys, state.cache_vals, state.cache_meta
        outs_p = ref.cache_probe(ck, cv, cm, keys, cset)
        record("cache_probe" + tag, hp.cache_probe(ck, cv, cm, keys, cset),
               outs_p, lambda: hp.cache_probe(ck, cv, cm, keys, cset),
               lambda: ref.cache_probe(ck, cv, cm, keys, cset),
               cache_probe_bytes(cfg, batch), batch=batch)
        entries["cache_probe" + tag]["hits"] = int(outs_p[0].sum())
        entries["probe" + tag]["found"] = int(found_p.sum())
        pool = state.pool
        want = ref.hash_get(bk, bp, pool, keys, h1, h2)
        record("get_walk" + tag, hp.get(bk, bp, pool, keys, h1, h2), want,
               lambda: hp.get(bk, bp, pool, keys, h1, h2),
               lambda: ref.hash_get(bk, bp, pool, keys, h1, h2),
               get_walk_bytes(cfg, batch, int(found_p.sum())), batch=batch)

        def composed():
            return composed_get(torch, hp, bk, bp, pool, keys, h1, h2)

        entries["get_walk" + tag]["found"] = int(found_p.sum())
        entries["get_walk" + tag]["composition"] = composition_entry(
            torch, composed(), want, composed)
        return found_p, ptr_p

    found_p, ptr_p = lookups(keys, h1, h2, cset, BATCH)

    ptr = torch.where(found_p, torch.clamp(ptr_p, 0, np_), np_).to(torch.int32)
    ptr64 = ptr.to(torch.int64)
    record("fetch", (hp.fetch(state.pool, ptr),), (ref.fetch(state.pool, ptr),),
           lambda: hp.fetch(state.pool, ptr),
           lambda: ref.fetch(state.pool, ptr),
           BATCH * (4 + 2 * vw * 4),
           lambda: torch.index_select(state.pool, 0, ptr64))

    def commits(tag, keys_, vals_, plan_, batch):
        """Both commits on a planned batch, each kernel and its plain
        version applied to their own clones of the state arrays."""
        nb = state.num_buckets
        bk_k, bp_k = state.bucket_keys.clone(), state.bucket_ptr.clone()
        bk_p, bp_p = state.bucket_keys.clone(), state.bucket_ptr.clone()
        args = (keys_, plan_.tb, plan_.tw, plan_.bptr_val)
        hp.commit_buckets(bk_k, bp_k, *args)
        ref.commit_buckets(bk_p, bp_p, *args)
        nbytes, sector_bytes = commit_buckets_bytes(cfg, plan_, nb)
        record("commit_buckets" + tag, (bk_k, bp_k), (bk_p, bp_p),
               lambda: hp.commit_buckets(bk_k, bp_k, *args),
               lambda: ref.commit_buckets(bk_p, bp_p, *args), nbytes,
               batch=batch)
        e = entries["commit_buckets" + tag]
        e["sentinel_entries"] = int((plan_.tb == nb).sum())
        e["sector_bytes"] = sector_bytes
        e["sector_bound_us"] = sector_bytes / HBM_BYTES_PER_S * 1e6
        del bk_k, bp_k, bk_p, bp_p

        pool_k, pool_p = state.pool.clone(), state.pool.clone()
        hp.write_rows(pool_k, vals_, plan_.wp)
        ref.write_rows(pool_p, vals_, plan_.wp)
        wp64 = plan_.wp.to(torch.int64)
        record("write_rows" + tag, (pool_k,), (pool_p,),
               lambda: hp.write_rows(pool_k, vals_, plan_.wp),
               lambda: ref.write_rows(pool_p, vals_, plan_.wp),
               write_rows_bytes(cfg, plan_.wp, np_),
               lambda: pool_k.index_copy_(0, wp64, vals_), batch=batch)
        entries["write_rows" + tag]["sentinel_entries"] = int(
            (plan_.wp == np_).sum())
        del pool_k, pool_p
        torch.cuda.empty_cache()

    for tag, batch in commit_batches(torch, kv, cfg, state, g,
                                     *picked).items():
        commits(tag, *batch)

    # the lookups at the load phase's batch (a PUT plan's probe, the write-
    # through's cache_probe), on inputs of their own
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    lookups(*kvs_lookups(torch, kv, state, FILL_BATCH, g)[:4], FILL_BATCH,
            f"@{FILL_BATCH}")

    launched = dict(hp.launches)
    for k, v in entries.items():
        v["kernel_phase_launches"] = launched[k.split("@")[0]]
    emit({"phase": "kernels_vs_plain", "results": entry_summary(entries),
          "composition": {k: v["composition"] for k, v in entries.items()
                          if "composition" in v},
          "launches": launched})
    check_entries(entries, "kernels_vs_plain")
    bad = {k: v["composition"]["mismatches"] for k, v in entries.items()
           if v.get("composition", {}).get("mismatches")}
    if bad or not all(launched.values()):
        raise AssertionError(f"kernels_vs_plain: the composition disagrees "
                             f"{bad}, or a kernel unlaunched {launched}")
    return {k: v for k, v in entries.items() if "@" not in k}


def zipf_ranks(torch, g, n_items, n, device="cuda"):
    """``n`` ranks in [0, n_items) drawn zipf(ZIPF) on the card: rank 0 is
    the hottest item."""
    ranks = torch.arange(1, n_items + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-ZIPF), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n,), generator=g, device=device, dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cdf, u), max=n_items - 1)


def make_stream(torch, cfg, kv):
    """STEPS * BATCH request payloads (on the card) and their key indices,
    ops and absent flags (on the host)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = STEPS * BATCH
    rank = zipf_ranks(torch, g, N_KEYS, n)
    idx = (rank * KEY_MULT) % N_KEYS
    absent = torch.rand((n,), generator=g, device="cuda") < 0.01
    idx = torch.where(
        absent, N_KEYS + torch.randint(0, N_KEYS, (n,), generator=g,
                                       device="cuda"), idx)
    is_put = torch.rand((n,), generator=g, device="cuda") < 0.05
    op = torch.where(is_put, kv.OP_PUT, kv.OP_GET).to(torch.int32)
    vals = torch.randint(-2**31, 2**31 - 1, (n, cfg.val_words), generator=g,
                         device="cuda", dtype=torch.int32)
    vals = torch.where(is_put[:, None], vals, 0)
    payloads = torch.cat([op[:, None], key_words(idx, torch), vals], dim=1)
    return payloads, idx.cpu().numpy(), op.cpu().numpy(), absent.cpu().numpy()


def serve(torch, eng, app, app_cfg, state, backend, payloads_for,
          on_step=None):
    """STEPS steps of inject / run_steps / drain through an engine serving
    ``app`` (an app module: ``request_words``, ``app_step``) on ``state``.
    Step s injects ``payloads_for(s)`` (BATCH requests, wave v giving one
    to each queue, so request v*Q + q is queue q's v-th), runs one step,
    drains, and hands ``on_step(s, es, stats, pay)`` its results. Every
    request must be accepted and answered in its step. Returns the final
    state, the drained responses, the step times, the loop time, and the
    engine's app_fn and config."""
    w = app.request_words(app_cfg)
    ecfg = eng.EngineConfig(num_queues=QUEUES, capacity=CAPACITY,
                            req_words=w, resp_words=w, budget=BATCH,
                            kernel_backend=backend)
    es = eng.make(ecfg, state)
    app_fn = eng.bind_app(app.app_step, app_cfg, ecfg)
    qids = torch.arange(QUEUES, dtype=torch.int32, device="cuda")
    waves = BATCH // QUEUES
    drained, step_s, accepted = [], [], []
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for s in range(STEPS):
        batch = payloads_for(s)
        for v in range(waves):
            es, ok = eng.inject(es, qids, batch[v * QUEUES: (v + 1) * QUEUES],
                                with_accepted=True)
            accepted.append(ok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, stats = eng.run_steps(es, app_fn, ecfg, 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pay, counts, es = eng.drain_responses(es, CAPACITY)
        drained.append((pay, counts))
        if on_step is not None:
            on_step(s, es, stats, pay)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    if not bool(torch.stack(accepted).all()):
        raise AssertionError(f"{backend}: a ring rejected a request")
    if not all(bool((c == waves).all()) for _, c in drained):
        raise AssertionError(f"{backend}: a step left requests unanswered")
    return es, drained, step_s, loop_s, app_fn, ecfg


def same_responses(torch, dr_k, dr_p, what):
    for i, ((pk, ck), (pp, cp)) in enumerate(zip(dr_k, dr_p, strict=True)):
        if not (torch.equal(ck, cp) and torch.equal(pk, pp)):
            raise AssertionError(f"{what} step {i}: responses differ auto "
                                 "vs ref")


def profile_steps(torch, eng, es, app_fn, ecfg, payloads, steps=7):
    """Device time of ``steps`` more engine steps on ``payloads`` (rings
    filled first, so only the steps are profiled): µs per step summed over
    every kernel and copy, device launches per step, and the costliest
    kernels; and the engine state after them. The app state is updated by
    these steps."""
    steps = min(steps, STEPS)
    _, es = eng.drain_responses(es, CAPACITY)[1:]
    qids = torch.arange(QUEUES, dtype=torch.int32, device="cuda")
    for v in range(steps * BATCH // QUEUES):
        es = eng.inject(es, qids, payloads[v * QUEUES: (v + 1) * QUEUES])
    box = [es]

    def run():
        box[0], _ = eng.run_steps(box[0], app_fn, ecfg, steps)

    total, per = device_us(torch, run, reps=1)
    top = sorted(per.items(), key=lambda kv_: -kv_[1][0])[:8]
    return {"steps": steps, "device_us_per_step": total / steps,
            "device_launches_per_step": sum(n for _, n in per.values())
            / steps,
            "top_kernels_us_per_step": {k[:90]: us / steps
                                        for k, (us, _) in top}}, box[0]


def step_summary(step_s, loop_s, served):
    return {
        "step_us_median": statistics.median(step_s) * 1e6,
        "step_us_p90": sorted(step_s)[int(0.9 * len(step_s))] * 1e6,
        "requests_per_s_steps": served / sum(step_s),
        "requests_per_s_loop": served / loop_s,
    }


def same_state(torch, a, b, what):
    """Two states (NamedTuples, dicts, lists of tensors) equal leaf for leaf
    in dtype and bits. Dict fields are matched by name (the checkpointer
    rebuilds dicts with their keys sorted, as JAX's trees keep them)."""
    def flat(x, path=""):
        if isinstance(x, torch.Tensor):
            return [(path, x)]
        if isinstance(x, dict):
            return [p for k in sorted(x) for p in flat(x[k], f"{path}.{k}")]
        if hasattr(x, "_asdict"):
            return flat(x._asdict(), path)
        return [p for i, v in enumerate(x) for p in flat(v, f"{path}[{i}]")]

    fa, fb = flat(a), flat(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        raise AssertionError(f"{what}: the states have other fields")
    for (name, x), (_, y) in zip(fa, fb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def check_responses(np, drained, idx, op, absent, stored, val_words,
                    loaded_fn):
    """Pair each response with its request (per-queue FIFO) and check it
    against the store's contents: PUTs of stored keys are acknowledged,
    GETs of stored keys that no PUT touched return the loaded value, GETs
    of absent keys that no PUT touched miss. Returns what was checked."""
    n = idx.shape[0]
    req_q = np.arange(n) % QUEUES  # wave-major injection: queue = i % Q
    per_q = [np.flatnonzero(req_q == q) for q in range(QUEUES)]
    head = [0] * QUEUES
    resp = np.full((n, 1 + val_words + 2), -99, np.int64)
    for pay, counts in drained:
        pay, counts = pay.cpu().numpy(), counts.cpu().numpy()
        for q in range(QUEUES):
            c = int(counts[q])
            rows = per_q[q][head[q]: head[q] + c]
            resp[rows] = pay[q, :c]
            head[q] += c
    if sum(head) != n:
        raise AssertionError(f"{sum(head)} responses for {n} requests")
    put_keys = set(idx[op == 2].tolist())
    untouched = np.array([k not in put_keys for k in idx.tolist()])
    is_get = op == 1
    was_stored = ~absent & stored[np.where(absent, 0, idx)]
    if not (resp[(op == 2) & was_stored, 0] == 1).all():
        raise AssertionError("a PUT of a stored key was not acknowledged")
    live = is_get & untouched & was_stored
    want = loaded_fn(idx[live])
    if not (resp[live, 0] == 1).all():
        raise AssertionError("a GET of a loaded key missed")
    if not np.array_equal(resp[live, 1: 1 + val_words], want):
        raise AssertionError("a GET of a loaded key returned a wrong value")
    dead = is_get & untouched & absent
    if not ((resp[dead, 0] == 0).all() and (resp[dead, 1:] == 0).all()):
        raise AssertionError("a GET of an absent key did not miss")
    return {"responses": n, "gets_checked_loaded": int(live.sum()),
            "gets_checked_absent": int(dead.sum()),
            "puts": int((op == 2).sum())}


def target_sorts(torch, eng, kv, es, app_fn, ecfg, payloads):
    """The KVS step's device µs and launches a step with the PUT plan as it
    is and with the two stable argsorts of its targets (tb, wp) put back,
    which only the TPU commit needs, profiled in turns (without, with,
    with, without; medians)."""
    plan_put = kv.plan_put

    def plan_with_sorts(*args, **kwargs):
        plan = plan_put(*args, **kwargs)
        torch.argsort(plan.tb, stable=True).to(torch.int32)
        torch.argsort(plan.wp, stable=True).to(torch.int32)
        return plan

    turns = {"without": [], "with": []}
    try:
        for turn in ("without", "with", "with", "without"):
            kv.plan_put = plan_with_sorts if turn == "with" else plan_put
            prof, es = profile_steps(torch, eng, es, app_fn, ecfg, payloads)
            turns[turn].append(prof)
    finally:
        kv.plan_put = plan_put
    return {turn: {m: statistics.median(p[m] for p in profs)
                   for m in ("device_us_per_step",
                             "device_launches_per_step")}
            for turn, profs in turns.items()}


def phase_serve(torch, np, eng, kv, hp, cfg, state, stored, smi):
    payloads, idx, op, absent = make_stream(torch, cfg, kv)
    runs = {}
    for backend in ("auto", "ref"):
        stats = []
        torch.cuda.synchronize()
        hp.reset_launches()
        out = serve(torch, eng, kv, cfg, clone_state(state), backend,
                    lambda s: payloads[s * BATCH: (s + 1) * BATCH],
                    lambda s, es, st, pay: stats.append(st))
        totals = {k: sum(int(st[k].sum()) for st in stats)
                  for k in ("served", "cache_hits", "cache_misses",
                            "cache_evictions")}
        runs[backend] = (*out, totals, dict(hp.launches))
    es_k, dr_k, step_k, loop_k, app_fn, ecfg, tot_k, launches = runs["auto"]
    es_p, dr_p, step_p, loop_p, _, _, tot_p, launches_p = runs["ref"]
    same_responses(torch, dr_k, dr_p, "serve")
    same_state(torch, es_k, es_p, "serve: final state auto vs ref")
    dead = [k for k in KVS_MAIN_PATH if launches[k] == 0]
    if dead:
        raise AssertionError(f"kernels never launched on the main path: {dead}")
    if launches["get_walk"] != STEPS or any(launches[k] for k in CHECK_ONLY):
        raise AssertionError(f"serve: the GET walk is not one get_walk a "
                             f"step: {launches}")
    if any(launches_p.values()):
        raise AssertionError(f"the ref engine launched kernels: {launches_p}")

    def loaded_fn(ix):
        t = torch.as_tensor(ix, dtype=torch.int64)
        return loaded_values(t, cfg.val_words, torch).numpy()

    checked = check_responses(np, dr_k, idx, op, absent, stored,
                              cfg.val_words, loaded_fn)
    profile, es = profile_steps(torch, eng, es_k, app_fn, ecfg, payloads)
    profile["idle_share"] = 1 - profile["device_us_per_step"] / (
        statistics.median(step_k) * 1e6)
    profile["target_sorts"] = target_sorts(torch, eng, kv, es, app_fn, ecfg,
                                           payloads)
    out = {"phase": "serve", "nvidia_smi": smi, "steps": STEPS,
           "budget": BATCH, "queues": QUEUES, **checked,
           "served": tot_k["served"], "cache_hits": tot_k["cache_hits"],
           "cache_misses": tot_k["cache_misses"],
           "cache_evictions": tot_k["cache_evictions"],
           "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()},
           "profile": profile}
    for label, step_s, loop_s, tot in (("kernels", step_k, loop_k, tot_k),
                                      ("plain", step_p, loop_p, tot_p)):
        out[label] = step_summary(step_s, loop_s, tot["served"])
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# ORCA-TX
# ---------------------------------------------------------------------------

def tx_stream(torch, cfg, n, g, malformed=TX_MALFORMED, device="cuda"):
    """``n`` transaction records (n, TW) on the card: 1..M write ops at
    zipf offsets (hot offsets conflict across transactions and repeat
    within one), random values, and a ``malformed`` share whose op count
    overflows or whose first offset lies past the store. Returns the
    records and the malformed mask."""
    m, vw, nk = cfg.max_ops, cfg.val_words, cfg.num_keys
    dev = device
    n_ops = torch.randint(1, m + 1, (n,), generator=g, device=dev)
    off = (zipf_ranks(torch, g, nk, n * m, dev).reshape(n, m)
           * TX_KEY_MULT) % nk
    vals = torch.randint(-2**31, 2**31 - 1, (n, m, vw), generator=g,
                         device=dev, dtype=torch.int32)
    live = torch.arange(m, device=dev)[None, :] < n_ops[:, None]
    off = torch.where(live, off, 0)
    vals = torch.where(live[..., None], vals, 0)
    bad = torch.rand((n,), generator=g, device=dev) < malformed
    overflow = torch.rand((n,), generator=g, device=dev) < 0.5
    n_ops = torch.where(bad & overflow, m + 1, n_ops)
    off[:, 0] = torch.where(bad & ~overflow, nk, off[:, 0])
    ops = torch.cat([off[..., None].to(torch.int32), vals], dim=2)
    records = torch.cat([n_ops[:, None], ops.reshape(n, -1)], dim=1)
    return records.to(torch.int32).contiguous(), bad


def tx_kernel_inputs(torch, tx, cfg):
    """The commit kernels' inputs at the engine's shapes: a chain with
    random contents, skewed log tails (slots wrap the ring) and a dead
    replica (1); 256 planned transactions with conflicts and duplicates
    and their per-replica targets; and one of them re-planned as
    ``replay_records`` plans a record (proceed forced, B = 1) with its
    targets on replica 0. Returns (chain, batch, mask, plan, slot, rows,
    record plan, record slot, record rows)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    chain = tx.make_chain(cfg, device="cuda")
    chain.store.random_(-2**30, 2**30, generator=g)
    chain.log.random_(-2**30, 2**30, generator=g)
    chain.store[:, -1] = 0
    chain.log[:, -1] = 0
    lc = cfg.log_capacity
    tails = torch.tensor([lc - 40, 7, lc - 90], dtype=torch.int32,
                         device="cuda")
    chain = chain._replace(
        log_tail=tails, committed=tails.clone(),
        live=torch.tensor([True, False, True], device="cuda"))
    batch, _ = tx_stream(torch, cfg, BATCH, g, malformed=0.0)
    mask = torch.rand((BATCH,), generator=g, device="cuda") > 0.05
    plan = tx.plan_commit(batch, cfg, mask)
    slot, rows = tx.commit_targets(chain, plan)
    first = int(plan.proceed.nonzero()[0, 0])
    rplan = tx.plan_commit(batch[first:first + 1], cfg, proceed=torch.ones(
        (1,), dtype=torch.bool, device="cuda"))
    rep0 = tx.ReplicaState(*(x[0] for x in chain))
    rslot, rrows = tx.commit_targets(rep0, rplan)
    return chain, batch, mask, plan, slot, rows, rplan, rslot, rrows


def tx_commit_bytes(cfg, batch, values, slot, rows):
    """The bytes a commit must move: each input read once, each live row
    written once (a sentinel row is zeroed at most once, and is already
    zero in these states)."""
    b, tw = batch.shape
    live_slots = int((slot < cfg.log_capacity).sum())
    live_rows = int((rows < cfg.num_keys).sum())
    return ((batch.numel() + values.numel() + slot.numel() + rows.numel())
            * 4 + live_slots * tw * 4 + live_rows * cfg.val_words * 4)


def phase_tx_kernels(torch, tx, tc, ref, cfg):
    """commit_chain and commit against their plain versions on the engine's
    shapes: 256 planned transactions on a chain with random contents,
    skewed log tails (slots wrap the ring) and a dead replica; and commit
    at its main-path shape, one replayed record (B = 1). Returns the
    entries of the ``kernels`` line (commit at B = 256)."""
    (chain, batch, mask, plan, slot, rows, rplan, rslot,
     rrows) = tx_kernel_inputs(torch, tx, cfg)
    lc, nk = cfg.log_capacity, cfg.num_keys
    # the O(num_keys) part of every TX step: first-claimant concurrency
    # control fills and scatters an owner table of NK + 1 entries
    n_ops, offs, _ = tx.parse_tx(batch, cfg)

    def cc():
        return tx.concurrency_control(n_ops, offs, cfg, mask)

    cc_dev, cc_kernels = device_us(torch, cc)
    concurrency = {"us": time_us(torch, cc), "loop_us": loop_us(torch, cc),
                   "device_us": cc_dev,
                   "device_us_by_kernel": {k[:90]: v[0] for k, v in
                                           cc_kernels.items()}}
    args = (plan.batch, plan.values, slot, rows)
    entries = {}

    log_k, store_k = chain.log.clone(), chain.store.clone()
    log_p, store_p = chain.log.clone(), chain.store.clone()
    tc.commit_chain(log_k, store_k, *args)
    ref.tx_commit_chain(log_p, store_p, *args)
    entries["commit_chain"] = kernel_entry(
        torch, "commit_chain", (log_k, store_k), (log_p, store_p),
        lambda: tc.commit_chain(log_k, store_k, *args),
        lambda: ref.tx_commit_chain(log_p, store_p, *args),
        tx_commit_bytes(cfg, plan.batch, plan.values, slot, rows), BATCH)
    dead_kept = (torch.equal(store_k[1], chain.store[1])
                 and torch.equal(log_k[1], chain.log[1]))
    del log_k, store_k, log_p, store_p

    log_k, store_k = chain.log[0].clone(), chain.store[0].clone()
    log_p, store_p = chain.log[0].clone(), chain.store[0].clone()
    for name, a, b in (
            ("commit", (plan.batch, plan.values, slot[0].contiguous(),
                        rows[0].contiguous()), BATCH),
            ("commit_b1", (rplan.batch, rplan.values, rslot, rrows), 1)):
        for t in (log_k, log_p):
            t.copy_(chain.log[0])
        for t in (store_k, store_p):
            t.copy_(chain.store[0])
        tc.commit(log_k, store_k, *a)
        ref.tx_commit(log_p, store_p, *a)
        entries[name] = kernel_entry(
            torch, "commit", (log_k, store_k), (log_p, store_p),
            lambda a=a: tc.commit(log_k, store_k, *a),
            lambda a=a: ref.tx_commit(log_p, store_p, *a),
            tx_commit_bytes(cfg, *a), b)
    del log_k, store_k, log_p, store_p, chain
    torch.cuda.empty_cache()
    tw, vw = batch.shape[1], cfg.val_words
    dead_slots, dead_rows = int((slot == lc).sum()), int((rows == nk).sum())
    emit({"phase": "tx_kernels", "results": entry_summary(entries),
          "proceeding": int(plan.proceed.sum()), "deferred_or_masked":
          int((~plan.proceed).sum()), "live_log_slots": int((slot < lc).sum()),
          "live_store_rows": int((rows < nk).sum()),
          "sentinel_share": {"log": dead_slots / slot.numel(),
                             "store": dead_rows / rows.numel(),
                             "b1_store": int((rrows == nk).sum())
                             / rrows.numel()},
          # what one store per word of each sentinel target would write
          "sentinel_target_words": dead_slots * tw + dead_rows * vw,
          "dead_replica_untouched": dead_kept,
          "chain_gb": cfg.chain_len * ((nk + 1) * vw + (lc + 1) * tw) * 4
          / 1e9, "concurrency_control": concurrency})
    check_entries(entries, "tx_kernels")
    if not dead_kept:
        raise AssertionError("tx_kernels: the dead replica was written")
    del entries["commit_b1"]
    return entries


def tx_serve(torch, eng, tx, tx_app, cfg, stream, backend):
    """STEPS engine steps of 256 transactions each on a fresh chain: the
    clients' DEFERRED transactions first (retried), then new ones from
    ``stream``. Returns what :func:`serve` does, then per step the ids
    sent and their statuses (both in the engine's batch order), and
    replica 0 as it was before step TX_RESYNC_AT."""
    waves = BATCH // QUEUES
    box = {"retry": torch.zeros((0,), dtype=torch.int64, device="cuda"),
           "fresh": 0, "ids": None}
    sent, statuses, snap = [], [], []

    def payloads_for(s):
        n_new = BATCH - box["retry"].shape[0]
        fresh = box["fresh"]
        box["ids"] = torch.cat([box["retry"], torch.arange(
            fresh, fresh + n_new, device="cuda")])
        box["fresh"] = fresh + n_new
        return stream[box["ids"]]

    def on_step(s, es, stats, pay):
        # request v*Q + q went to queue q at position v; the engine's batch
        # is queue-major (gather_batch), so batch row q*waves + v holds it
        # and commits in that order
        ids = box["ids"].reshape(waves, QUEUES).t().reshape(-1)
        status = pay[:, :waves, 0].reshape(-1)
        box["retry"] = ids[status == tx_app.RESP_DEFERRED]
        sent.append(ids)
        statuses.append(status)
        if s == TX_RESYNC_AT - 1:
            snap.append(tx.ReplicaState(*(x[0].clone() for x in es.app)))

    out = serve(torch, eng, tx_app, cfg, tx.make_chain(cfg, device="cuda"),
                backend, payloads_for, on_step)
    return (*out, sent, statuses, snap[0])


def check_tx_log(torch, np, tx_app, cfg, es, stream, sent, statuses):
    """The committed transactions, in commit order, are exactly the log's
    records on every live replica, and replaying those records through a
    numpy model of the store gives the store."""
    chain = es.app
    tail = int(chain.log_tail[0])
    if tail > cfg.log_capacity:
        raise AssertionError(f"tx: the log lapped ({tail} commits)")
    for r in range(1, cfg.chain_len):
        for f in ("store", "log", "log_tail", "committed"):
            if not torch.equal(getattr(chain, f)[r], getattr(chain, f)[0]):
                raise AssertionError(f"tx: replica {r} {f} differs from 0")
    committed = torch.cat([ids[st == tx_app.RESP_COMMITTED]
                           for ids, st in zip(sent, statuses)])
    if committed.shape[0] != tail or not torch.equal(
            chain.log[0, :tail], stream[committed]):
        raise AssertionError("tx: the log is not the committed "
                             "transactions in commit order")
    records = chain.log[0, :tail].cpu().numpy()
    m, vw = cfg.max_ops, cfg.val_words
    ops = records[:, 1:].reshape(tail, m, 1 + vw)
    live = np.arange(m)[None, :] < records[:, :1]
    off = ops[..., 0][live]  # record-major, op order: the serial order
    vals = ops[..., 1:][live]
    # last writer wins: the first occurrence in the reversed order
    uniq, first = np.unique(off[::-1], return_index=True)
    want = vals[::-1][first]
    got = chain.store[0, torch.as_tensor(uniq, device="cuda")].cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError("tx: the store differs from the log's replay")
    touched = int(chain.store[0, :-1].ne(0).any(dim=1).sum())
    if touched != uniq.shape[0]:
        raise AssertionError(f"tx: {touched} store rows written, the log "
                             f"names {uniq.shape[0]}")
    return {"commits": tail, "rows_written": int(uniq.shape[0])}


def phase_tx_serve(torch, np, eng, tx, tx_app, tc, cfg, smi):
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n = STEPS * BATCH + 8 * BATCH  # the main run, and the profiled steps
    stream, bad = tx_stream(torch, cfg, n, g)
    runs = {}
    for backend in ("auto", "ref"):
        torch.cuda.synchronize()
        tc.reset_launches()
        runs[backend] = (*tx_serve(torch, eng, tx, tx_app, cfg, stream,
                                   backend), dict(tc.launches))
    (es_k, dr_k, step_k, loop_k, app_fn, ecfg, sent, st_k, snap,
     launches) = runs["auto"]
    es_p, dr_p, step_p, loop_p, _, _, _, _, _, launches_p = runs["ref"]
    same_responses(torch, dr_k, dr_p, "tx_serve")
    same_state(torch, es_k, es_p, "tx_serve: final state auto vs ref")
    del es_p, runs
    if launches["commit_chain"] == 0 or any(launches_p.values()):
        raise AssertionError(f"tx_serve launches: auto {launches}, "
                             f"ref {launches_p}")
    checked = check_tx_log(torch, np, tx_app, cfg, es_k, stream, sent, st_k)
    all_ids, all_st = torch.cat(sent), torch.cat(st_k)
    codes = {"committed": tx_app.RESP_COMMITTED,
             "deferred": tx_app.RESP_DEFERRED, "malformed": MALFORMED}
    if not torch.equal(all_st == MALFORMED, bad[all_ids]):
        raise AssertionError("tx: MALFORMED answers differ from the "
                             "malformed requests")
    counts = {k: int((all_st == c).sum()) for k, c in codes.items()}
    distinct = int(torch.unique(all_ids).shape[0])
    served = int(es_k.served)
    step_total = sum(step_k)
    out = {"phase": "tx_serve", "nvidia_smi": smi, "steps": STEPS,
           "budget": BATCH, "queues": QUEUES, "served": served, **counts,
           "commits_per_step": counts["committed"] / STEPS,
           "commits_per_s_steps": counts["committed"] / step_total,
           "distinct_transactions": distinct, **checked,
           "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()},
           "kernels": step_summary(step_k, loop_k, served),
           "plain": step_summary(step_p, loop_p, served)}
    return out, es_k, snap, stream, app_fn, ecfg


def phase_tx_resync(torch, tx, tc, cfg, es, snap):
    """Replay the records committed after the snapshot into the snapshot
    replica, one record per ``commit`` launch, and with the plain version:
    both rebuild the final replica."""
    final = tx.ReplicaState(*(x[0] for x in es.app))
    lo, hi = int(snap.log_tail), int(final.log_tail)
    records = final.log[lo:hi]
    out = {"phase": "tx_resync", "from_step": TX_RESYNC_AT,
           "records": hi - lo}
    launches = None
    for backend in ("cuda", "ref"):
        rep = tx.ReplicaState(*(x.clone() for x in snap))
        tc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = tx.replay_records(rep, records, cfg, kernel_backend=backend)
        torch.cuda.synchronize()
        out[f"{backend}_s"] = time.perf_counter() - t0
        for f in ("store", "log", "log_tail", "committed"):
            if not torch.equal(getattr(rep, f), getattr(final, f)):
                raise AssertionError(f"tx_resync ({backend}): {f} differs "
                                     "from the final replica")
        if backend == "cuda":
            launches = dict(tc.launches)
        elif any(tc.launches.values()):
            raise AssertionError(f"tx_resync ref launched {tc.launches}")
        del rep
    if launches["commit"] != hi - lo:
        raise AssertionError(f"tx_resync: {launches} for {hi - lo} records")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Fault tolerance and durability
# ---------------------------------------------------------------------------

def tree_bytes(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(tree_bytes(torch, x) for x in tree)


def check_room(what, need):
    """Raise unless the temporary directory has ``need`` bytes free: the
    phase's snapshots are written there, and it is not cut to fit."""
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < need:
        raise RuntimeError(f"{what}: needs {need} bytes free under {tmp}, "
                           f"has {free}")
    return {"tmp_free_bytes": free, "tmp_need_bytes": need}


def flush_summary(recs):
    """The flushes of a run: kinds, payload bytes, and the synchronous
    device-to-host copy each made (bytes, µs)."""
    copy_us = [r.copy_us for r in recs]
    return {
        "flushes": len(recs),
        "kinds": {k: sum(r.kind == k for r in recs)
                  for k in ("full", "delta", "skipped")},
        "payload_bytes": sum(r.bytes for r in recs),
        "host_copy_bytes_per_flush": recs[0].copy_bytes if recs else 0,
        "host_copy_us_median": statistics.median(copy_us) if recs else None,
        "host_copy_us_max": max(copy_us) if recs else None,
        "host_copy_gb_per_s": (sum(r.copy_bytes for r in recs)
                               / (sum(copy_us) * 1e-6) / 1e9
                               if recs else None),
        "wait_us_median": (statistics.median(r.wait_us for r in recs)
                           if recs else None),
    }


def phase_tx_soak(torch, tc, soak, smi):
    """run_soak at the TX serve shape: the faulted run (drop, duplicate,
    corrupt, delay, doorbell suppression, replica 1 killed at step 66 and
    revived by log replay at 133) and its never-failed twin, every check
    of run_soak (conservation, equal status counts, replicas bit for bit
    the twin's, the numpy oracle of the store). Each replayed record is
    one ``commit`` launch."""
    torch.cuda.synchronize()
    tc.reset_launches()
    t0 = time.perf_counter()
    r = soak.run_soak(seed=TX_SOAK_SEED, steps=TX_SOAK_STEPS, device="cuda",
                      **TX_SOAK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tc.launches)
    out = {"phase": "tx_soak", "nvidia_smi": smi, "seconds": secs,
           "seed": TX_SOAK_SEED, "steps": TX_SOAK_STEPS, **TX_SOAK,
           "engine": r["engine"], "counters": r["counters"],
           "status_counts": {str(k): v for k, v in
                             sorted(r["status_counts"].items())},
           "requests": r["requests"], "responses": r["responses"],
           "resubmits": r["resubmits"], "monitor_events": r["monitor_events"],
           "resync_records": r["resync_records"], "launches": launches}
    emit(out)
    if launches["commit"] != r["resync_records"] or not r["resync_records"] \
            or not launches["commit_chain"]:
        raise AssertionError(f"tx_soak: launches {launches} for "
                             f"{r['resync_records']} resync records")
    return out


def phase_tx_crash(torch, tx, tc, soak, smi):
    """run_crash_soak at the TX serve shape: flushes every 2 steps
    (adaptive, a full snapshot at most every TX_CRASH_SNAPSHOT_EVERY
    steps), a kill at wall step 21 leaving a torn snapshot, delta and
    segment tail, recovery
    (snapshot + WAL replay, one ``commit`` launch per redo record), and a
    never-crashed twin whose state at the covered step must equal the
    recovered one bit for bit."""
    chain_b = tree_bytes(torch, tx.make_chain(tx.TxConfig(**TX_SHAPE),
                                              "meta"))  # shapes only
    # two runs, each with up to two snapshots on disk while the newer one
    # commits, and the segments
    room = check_room("tx_crash", 5 * chain_b)
    torch.cuda.synchronize()
    tc.reset_launches()
    t0 = time.perf_counter()
    r = soak.run_crash_soak(seed=TX_CRASH_SEED, steps=TX_CRASH_STEPS,
                            every=TX_CRASH_EVERY,
                            snapshot_every=TX_CRASH_SNAPSHOT_EVERY,
                            mode="adaptive", segment_bytes=SEGMENT_BYTES,
                            device="cuda", **TX_SOAK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tc.launches)
    c = r["crash"]
    replayed = (c["tx_records_replayed"] + r["resync_records"]
                + r["control_resync_records"])
    out = {"phase": "tx_crash", "nvidia_smi": smi, "seconds": secs,
           "seed": TX_CRASH_SEED, "steps": TX_CRASH_STEPS,
           "every": TX_CRASH_EVERY,
           "snapshot_every": TX_CRASH_SNAPSHOT_EVERY, "mode": "adaptive",
           "segment_bytes": SEGMENT_BYTES,
           "chain_bytes": chain_b, **room,
           "crash": {k: v for k, v in c.items() if k != "recovered_state"},
           "covered": r["covered"], "engine": r["engine"],
           "counters": r["counters"],
           "status_counts": {str(k): v for k, v in
                             sorted(r["status_counts"].items())},
           "responses": r["responses"], "resubmits": r["resubmits"],
           "monitor_events": r["monitor_events"],
           "flushes_main": flush_summary(r["flush_records"]),
           "flushes_twin": flush_summary(r["control_flush_records"]),
           "mgr_stats_after_crash": r["durability_stats"],
           "mgr_stats_twin": r["control_durability_stats"],
           "resync_records": {"main": r["resync_records"],
                              "twin": r["control_resync_records"]},
           "records_replayed": replayed, "launches": launches}
    emit(out)
    if launches["commit"] != replayed or not c["tx_records_replayed"]:
        raise AssertionError(f"tx_crash: {launches['commit']} commit "
                             f"launches for {replayed} replayed records")
    return out


def kvs_stream(torch, kv, cfg, n, g):
    """``n`` KVS requests on the card: 70% PUT, 30% GET, keys over 2^20
    key indices (mixed as in the load phase), random values."""
    idx = torch.randint(0, 2**20, (n,), generator=g, device="cuda")
    is_put = torch.rand((n,), generator=g, device="cuda") < 0.7
    op = torch.where(is_put, kv.OP_PUT, kv.OP_GET).to(torch.int32)
    vals = torch.randint(-2**31, 2**31 - 1, (n, cfg.val_words), generator=g,
                         device="cuda", dtype=torch.int32)
    vals = torch.where(is_put[:, None], vals, 0)
    return torch.cat([op[:, None], key_words(idx, torch), vals], dim=1)


def phase_kvs_recover(torch, eng, kv, hp, soak, frec, smi):
    """The KVS durability path at the cut store: the overhead arm
    (``run_durability``), then a run that flushes every 2 steps (a full
    snapshot, then dirty-row deltas), a kill leaving a torn snapshot and
    segment tail, ``recover``, and engine steps from the recovered state
    through the hash kernels of the main path that must equal a twin's
    from the flushed state through the plain versions (a ``ref`` engine),
    at this store's shape."""
    cfg = kv.KVConfig(**KV_RECOVER_SHAPE)
    store_b = tree_bytes(torch, kv.make(cfg, "meta"))
    room = check_room("kvs_recover", 6 * store_b)
    root = tempfile.mkdtemp(prefix="orca-kvs-recover-")
    try:
        torch.cuda.synchronize()
        hp.reset_launches()
        t0 = time.perf_counter()
        arm = soak.run_durability(
            seed=SEED, steps=KV_DURABILITY_STEPS, app="kvs", app_cfg=cfg,
            num_queues=QUEUES, capacity=CAPACITY, budget=BATCH,
            durability=frec.DurabilityConfig(
                os.path.join(root, "arm"), every=2, mode="adaptive",
                segment_bytes=SEGMENT_BYTES),
            device="cuda")
        torch.cuda.synchronize()
        arm_s = time.perf_counter() - t0
        arm_launches = dict(hp.launches)
        arm_flushes = flush_summary(arm.pop("flush_records"))

        w = kv.request_words(cfg)
        ecfg = eng.EngineConfig(num_queues=QUEUES, capacity=CAPACITY,
                                req_words=w, resp_words=w, budget=BATCH)
        app_fn = eng.bind_app(kv.app_step, cfg, ecfg)
        ecfg_ref = ecfg._replace(kernel_backend="ref")
        app_ref = eng.bind_app(kv.app_step, cfg, ecfg_ref)
        g = torch.Generator(device="cuda").manual_seed(SEED + 40)
        stream = kvs_stream(torch, kv, cfg,
                            (KV_RECOVER_STEPS + KV_RECOVER_AFTER) * BATCH, g)
        qids = torch.arange(QUEUES, dtype=torch.int32, device="cuda")

        def step(es, s, fn=app_fn, c=ecfg):
            batch = stream[s * BATCH: (s + 1) * BATCH]
            for v in range(BATCH // QUEUES):
                es = eng.inject(es, qids, batch[v * QUEUES: (v + 1) * QUEUES])
            es, _ = eng.run_steps(es, fn, c, 1)
            return es

        d = os.path.join(root, "crash")
        mgr = frec.DurabilityManager(frec.DurabilityConfig(
            d, every=2, mode="adaptive", segment_bytes=SEGMENT_BYTES))
        es = eng.make(ecfg, kv.make(cfg, "cuda"))
        hp.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(KV_RECOVER_STEPS):
            es = step(es, s)
            if (s + 1) % 2 == 0:
                mgr.flush(es)
                flushed = clone_tree(torch, es)
            es = eng.drain_responses(es, CAPACITY)[2]
        mgr.wait()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = dict(hp.launches)
        del es
        # the kill: a torn snapshot attempt and a torn segment tail
        torn, seg, seg_size = soak.torn_artifacts(d, KV_RECOVER_STEPS + 1)
        like = eng.make(ecfg, kv.make(cfg, "cuda"))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, covered = frec.recover(d, like, stats=stats)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        if covered != int(flushed.steps) or any(map(os.path.exists, torn)) \
                or seg is None or os.path.getsize(seg) != seg_size:
            raise AssertionError(f"kvs_recover: covered {covered}, torn "
                                 f"artifacts left: {torn}, segment {seg}")
        same_state(torch, rec, flushed, "kvs_recover: recovered vs flushed")
        # after recovery: the kernel engine's steps, and the plain engine's
        # from the flushed state
        hp.reset_launches()
        for s in range(KV_RECOVER_STEPS, KV_RECOVER_STEPS + KV_RECOVER_AFTER):
            rec = step(eng.drain_responses(rec, CAPACITY)[2], s)
        torch.cuda.synchronize()
        after = dict(hp.launches)
        for s in range(KV_RECOVER_STEPS, KV_RECOVER_STEPS + KV_RECOVER_AFTER):
            flushed = step(eng.drain_responses(flushed, CAPACITY)[2], s,
                           app_ref, ecfg_ref)
        torch.cuda.synchronize()
        if dict(hp.launches) != after:
            raise AssertionError("kvs_recover: the ref engine launched "
                                 f"kernels: {hp.launches} after {after}")
        same_state(torch, rec, flushed, "kvs_recover: kernel steps after "
                   "recovery vs plain steps from the flush")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "kvs_recover", "nvidia_smi": smi, "shape":
           KV_RECOVER_SHAPE, "store_bytes": store_b, **room,
           "arm": {**arm, "seconds": arm_s, "flushes": arm_flushes,
                   "launches": arm_launches},
           "crash_run": {"steps": KV_RECOVER_STEPS, "seconds": run_s,
                         "flushes": flush_summary(mgr.records),
                         "mgr_stats": mgr.stats(),
                         "launches": run_launches},
           "covered": covered, "recover_s": recover_s, "recover": stats,
           "steps_after_recovery": KV_RECOVER_AFTER,
           "launches_after_recovery": after,
           "seconds": arm_s + run_s + recover_s}
    out["recover"]["truncated"] = [os.path.basename(p)
                                   for p in stats["truncated"]]
    emit(out)
    dead = [k for k in KVS_MAIN_PATH if not after[k]]
    stray = [k for k in CHECK_ONLY for d in (arm_launches, run_launches,
                                             after) if d[k]]
    if dead or stray:
        raise AssertionError(f"kvs_recover: not launched after recovery: "
                             f"{dead}; launched off the main path: {stray}")
    out["launches"] = {k: arm_launches[k] + run_launches[k] + after[k]
                       for k in after}
    return out


def phase_lm_crash(torch, eng, cfg_mod, model, pk, pa, fa, soak, ctx, smi):
    """run_lm_crash_soak through the paged engine with a host cold tier,
    on the 4-layer f32 Qwen2.5-14B cut: dirty-page deltas and cold slabs
    in the WAL, a kill mid-decode, recovery bit for bit the never-crashed
    twin's state at the covered step, token streams byte-identical to the
    twin's and to a third timeline through the plain engine (``ref``: the
    kernels held against their plain versions at these shapes), the torn
    segment tail truncated, fewer fsyncs than records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, _, nbytes = lm_setup(torch, cfg_mod, model, ctx,
                                      num_layers=LM_F32_LAYERS,
                                      dtype="float32")
    ecfg = eng.LMEngineConfig(**LM_CRASH_ENGINE)
    pool_b = tree_bytes(torch, pk.make(eng.lm_paged_kv_config(ecfg, cfg, ctx),
                                       ecfg.slots, torch.float32, "meta"))
    # three timelines, each with up to two snapshots of the pool on disk
    room = check_room("lm_crash", 6 * pool_b)
    torch.cuda.synchronize()
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    r = soak.run_lm_crash_soak(seed=LM_CRASH_SEED, steps=LM_CRASH_STEPS,
                               n_requests=LM_CRASH_REQUESTS, ecfg=ecfg,
                               segment_bytes=SEGMENT_BYTES,
                               model=(cfg, ctx, params), device="cuda",
                               twin_backend="ref")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**pa.launches, **fa.launches}
    main = r["main"]
    out = {"phase": "lm_crash", "nvidia_smi": smi, "arch": LM_ARCH,
           "layers": LM_F32_LAYERS, "dtype": "float32", "param_bytes": nbytes,
           "engine": LM_CRASH_ENGINE, "requests": LM_CRASH_REQUESTS,
           "pool_bytes": pool_b, **room, "seconds": secs,
           "seconds_per_timeline": r["seconds"],
           "plain_twin_streams_equal": True,
           "covered": r["covered"], "crash_at": r["crash_at"],
           "recover_s": main["crash"]["recover_s"],
           "wal_records_applied": main["crash"]["wal_records_applied"],
           "torn_segment_truncated": main["crash"]["torn_segment_truncated"],
           "delivered": {str(q): len(v) for q, v in
                         main["delivered"].items()},
           "tokens": sum(int(row[0]) for v in main["delivered"].values()
                         for row in v.values()),
           "evictions": main["evictions"], "restores": main["restores"],
           "budget_refusals": main["budget_refusals"],
           "wall_ticks": {"main": main["wall_ticks"],
                          "ctrl": r["ctrl"]["wall_ticks"],
                          "plain_twin": r["twin"]["wall_ticks"]},
           "durability": r["stats"],
           "flushes_main": flush_summary(main["flush_records"]),
           "launches": launches}
    emit(out)
    if not all(launches.values()):
        raise AssertionError(f"lm_crash: launches {launches}")
    del params, r, main
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# ORCA-DLRM
# ---------------------------------------------------------------------------

def phase_dlrm_kernels(torch, np, F, dlrm, er, ref, cfg, params):
    """embedding_reduce against its plain version on the engine's batch of
    256 queries, f32 tables and a bf16 copy, on the DLRM layout."""
    rng = np.random.default_rng(SEED + 5)
    _, idx = dlrm.gen_queries(cfg, BATCH, None, 0.0, rng)
    idx = torch.from_numpy(idx).cuda()
    t, r, d, l = cfg.num_tables, cfg.rows, cfg.dim, cfg.lookups
    flat = (idx + torch.arange(t, dtype=torch.int32,
                               device="cuda")[None, :, None] * r).reshape(-1)
    seg = torch.arange(BATCH * t, dtype=torch.int32,
                       device="cuda").repeat_interleave(l)
    n, s = flat.shape[0], BATCH * t
    flat64 = flat.long()
    offsets = torch.arange(0, n, l, device="cuda")
    out, entries = {"phase": "dlrm_kernels", "queries": BATCH,
                    "lookups": n, "segments": s}, {}
    for name, tables in (("f32", params["tables"]),
                         ("bf16", params["tables"].to(torch.bfloat16))):
        table = tables.reshape(t * r, d)
        lib = None
        if name == "f32":  # the yardstick: one PyTorch call, f32 sums
            def lib():
                return F.embedding_bag(flat64, table, offsets, mode="sum")
        got = er.embedding_reduce(table, flat, seg, s)
        want = ref.embedding_reduce(table, flat, seg, s)
        want_dlrm = ref.dlrm_embedding_reduce(tables, idx).reshape(s, d)
        nbytes = (n * d * table.element_size() + n * 4 * 2 + s * d * 4)
        e = kernel_entry(
            torch, "embedding_reduce", (got, got), (want, want_dlrm),
            lambda: er.embedding_reduce(table, flat, seg, s),
            lambda: ref.embedding_reduce(table, flat, seg, s), nbytes, BATCH,
            lib)
        out[name] = {k: e[k] for k in ("mismatches", "max_abs_err", "us",
                                       "plain_us", "library_us",
                                       "library_device_us",
                                       "library_device_cold_us", "bound_us",
                                       "device_us", "device_cold_us",
                                       "loop_us", "plain_device_us",
                                       "bytes")}
        check_entries({name: e}, "dlrm_kernels")
        if name == "f32":
            entries["embedding_reduce"] = e
        del table, tables
    out["lookup_sweep"] = lookup_sweep(torch, F, er, ref,
                                       params["tables"].reshape(t * r, d), n)
    torch.cuda.empty_cache()
    emit(out)
    return entries


def lookup_sweep(torch, F, er, ref, table, n, lookups=(1, 32, 128)):
    """embedding_reduce and embedding_bag at ``n`` lookups of uniform
    random rows of the f32 ``table``, in segments of each of ``lookups``:
    mismatches against the plain version, and device µs of both, L2-warm
    and cold. Raises on a mismatch."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows, d = table.shape
    res = {}
    for l in lookups:
        s = n // l
        idx = torch.randint(0, rows, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
        seg = torch.arange(s, dtype=torch.int32,
                           device="cuda").repeat_interleave(l)
        idx64 = idx.long()
        offsets = torch.arange(0, n, l, device="cuda")
        miss = mismatches(torch, er.embedding_reduce(table, idx, seg, s),
                          ref.embedding_reduce(table, idx, seg, s))
        if miss:
            raise AssertionError(f"dlrm_kernels: {miss} mismatches at {l} "
                                 "lookups a segment")

        def k_fn(idx=idx, seg=seg, s=s):
            return er.embedding_reduce(table, idx, seg, s)

        def lib(idx64=idx64, offsets=offsets):
            return F.embedding_bag(idx64, table, offsets, mode="sum")

        nbytes = n * d * 4 + n * 4 * 2 + s * d * 4
        res[l] = {"segments": s, "mismatches": miss,
                  "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
                  "device_us": device_us(torch, k_fn)[0],
                  "device_cold_us": cold_device_us(torch, k_fn),
                  "library_device_us": device_us(torch, lib)[0],
                  "library_device_cold_us": cold_device_us(torch, lib)}
    return res


def dlrm_stream(np, dlrm, cfg, n, rng):
    """``n`` DLRM request payloads: raw queries (hit rate 0), a share of
    NOPs and a share of INFERs with one index past the table. Returns the
    payloads and the ops, dense features, indices and bad-index mask."""
    dense, idx = dlrm.gen_queries(cfg, n, None, 0.0, rng)
    op = np.where(rng.random(n) < DLRM_NOP, dlrm.OP_NOP, dlrm.OP_INFER)
    bad = rng.random(n) < DLRM_BAD_INDEX
    flat = idx.reshape(n, -1).copy()
    pos = rng.integers(0, flat.shape[1], n)
    flat[bad, pos[bad]] = cfg.rows + rng.integers(0, 1000, int(bad.sum()))
    payloads = np.concatenate([op[:, None].astype(np.int32),
                               dense.view(np.int32), flat], axis=1)
    return payloads, op, dense, idx, bad


def phase_dlrm_serve(torch, np, eng, dlrm, er, cfg, params, smi):
    rng = np.random.default_rng(SEED + 6)
    n = (STEPS + 8) * BATCH
    payloads, op, dense, idx, bad = dlrm_stream(np, dlrm, cfg, n, rng)
    payloads_t = torch.from_numpy(payloads).cuda()
    runs = {}
    for backend in ("auto", "ref"):
        torch.cuda.synchronize()
        er.reset_launches()
        runs[backend] = (*serve(
            torch, eng, dlrm, cfg, params, backend,
            lambda s: payloads_t[s * BATCH: (s + 1) * BATCH]),
            dict(er.launches))
    es_k, dr_k, step_k, loop_k, app_fn, ecfg, launches = runs["auto"]
    es_p, dr_p, step_p, loop_p, _, _, launches_p = runs["ref"]
    same_responses(torch, dr_k, dr_p, "dlrm_serve")
    same_state(torch, es_k, es_p, "dlrm_serve: final state auto vs ref")
    if launches["embedding_reduce"] == 0 or any(launches_p.values()):
        raise AssertionError(f"dlrm_serve launches: auto {launches}, "
                             f"ref {launches_p}")
    # responses in request order: request v*Q + q of a step -> pay[q, v]
    waves = BATCH // QUEUES
    resp = torch.cat([p[:, :waves].transpose(0, 1).reshape(BATCH, -1)
                      for p, _ in dr_k]).cpu().numpy()
    m = STEPS * BATCH
    status, logit = resp[:, 0], resp[:, 1].view(np.float32)
    infer = op[:m] == dlrm.OP_INFER
    want_status = np.where(infer & bad[:m], MALFORMED,
                           infer.astype(np.int32))
    if not np.array_equal(status, want_status):
        raise AssertionError("dlrm: statuses differ from the requests'")
    if (resp[~infer | bad[:m], 1] != 0).any():
        raise AssertionError("dlrm: a NOP or NACK carries a logit")
    ok = infer & ~bad[:m]
    direct = []
    for lo in range(0, m, BATCH):
        direct.append(dlrm.forward(
            params, torch.from_numpy(dense[lo: lo + BATCH]).cuda(),
            torch.from_numpy(np.clip(idx[lo: lo + BATCH], 0, cfg.rows - 1))
            .cuda(), cfg, backend="auto"))
    direct = torch.cat(direct).cpu().numpy()
    np.testing.assert_allclose(logit[ok], direct[ok], rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    served = int(es_k.served)
    profile, _ = profile_steps(torch, eng, es_k, app_fn, ecfg,
                               payloads_t[m:])
    profile["idle_share"] = 1 - profile["device_us_per_step"] / (
        statistics.median(step_k) * 1e6)
    return {"phase": "dlrm_serve", "nvidia_smi": smi, "steps": STEPS,
            "budget": BATCH, "queues": QUEUES, "served": served,
            "infer_ok": int(ok.sum()), "nop": int((~infer).sum()),
            "malformed": int((infer & bad[:m]).sum()),
            "logits_bit_equal_direct": int((logit[ok] == direct[ok]).sum()),
            "logit_max_abs_diff_direct": float(np.abs(logit[ok]
                                                      - direct[ok]).max()),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "launches": launches,
            "launches_per_step": {k: v / STEPS for k, v in launches.items()},
            "kernels": step_summary(step_k, loop_k, served),
            "plain": step_summary(step_p, loop_p, served),
            "profile": profile}


def phase_merci(torch, np, dlrm):
    """MERCI: host-rewritten queries through the extended tables, with the
    kernel, equal the plain path bit for bit and the raw queries' logits
    within the JAX package's tolerance."""
    cfg = dlrm.DLRMConfig(**MERCI_SHAPE)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = dlrm.init_params(cfg, g, device="cuda")
    merci = dlrm.MerciIndex(cfg, seed=SEED)
    ext = merci.build_tables(params["tables"])
    rng = np.random.default_rng(SEED + 8)
    out = {"phase": "merci", "rows": cfg.rows, "memo_rows": merci.n_memo,
           "batches": MERCI_BATCHES, "queries": MERCI_QUERIES,
           "hit_rate": MERCI_HIT_RATE, "rewrite_s": [], "saved": 0,
           "lookups": 0, "max_abs_diff_raw": 0.0}
    for _ in range(MERCI_BATCHES):
        dense, idx = dlrm.gen_queries(cfg, MERCI_QUERIES, merci,
                                      MERCI_HIT_RATE, rng)
        t0 = time.perf_counter()
        new_idx, saved = merci.rewrite_query(idx)
        out["rewrite_s"].append(time.perf_counter() - t0)
        out["saved"] += saved
        out["lookups"] += idx.size
        d = torch.from_numpy(dense).cuda()
        raw = torch.from_numpy(idx).cuda()
        mem = torch.from_numpy(new_idx).cuda()
        k_sum = dlrm.embedding_reduce(ext, mem, backend="cuda")
        p_sum = dlrm.embedding_reduce(ext, mem, backend="ref")
        k = dlrm.forward(params, d, mem, cfg, tables_ext=ext, backend="cuda")
        p = dlrm.forward(params, d, mem, cfg, tables_ext=ext, backend="ref")
        if not (torch.equal(k_sum, p_sum) and torch.equal(k, p)):
            raise AssertionError("merci: kernel path differs from plain")
        r = dlrm.forward(params, d, raw, cfg, backend="cuda")
        torch.testing.assert_close(k, r, rtol=MERCI_RTOL, atol=MERCI_ATOL)
        out["max_abs_diff_raw"] = max(out["max_abs_diff_raw"],
                                      float((k - r).abs().max()))
    if out["saved"] == 0:
        raise AssertionError("merci: no pair was rewritten")
    out["gathers_saved_share"] = out["saved"] / out["lookups"]
    emit(out)


# ---------------------------------------------------------------------------
# LM serving: paged decode and flash prefill of Qwen2.5-14B
# ---------------------------------------------------------------------------

def float_entry(torch, name, outs_k, outs_p, k_fn, p_fn, tol, nbytes, flops,
                dtype, lib_fn=None):
    """One floating-point kernel against its plain version on the same
    inputs: elements outside ``tol`` (allclose, rtol = atol = tol), the
    largest |difference|, times (CUDA events, profiler device time, L2
    warm and cold), the plain version's and the library call's (CUDA
    events and profiler device time, L2 warm and cold), and the bound: the
    larger of the
    bytes over the memory rate and the flops over the peak rate of the
    input type."""
    miss, err = 0, 0.0
    for a, b in zip(outs_k, outs_p):
        a, b = a.float(), b.float()
        err = max(err, float((a - b).abs().max()))
        miss += int((~torch.isclose(a, b, rtol=tol, atol=tol)).sum())
    us = time_us(torch, k_fn)
    plain_us = time_us(torch, p_fn)
    lib_us = time_us(torch, lib_fn) if lib_fn is not None else None
    lib_dev = device_us(torch, lib_fn)[0] if lib_fn is not None else None
    lib_cold = cold_device_us(torch, lib_fn) if lib_fn is not None else None
    k_dev, _ = device_us(torch, k_fn)
    k_queued = queued_us(torch, k_fn)
    p_dev, _ = device_us(torch, p_fn)
    k_cold = cold_device_us(torch, k_fn)
    bytes_us = nbytes / HBM_BYTES_PER_S * 1e6
    flops_us = flops / PEAK_FLOPS[dtype] * 1e6
    bound_us = max(bytes_us, flops_us)
    src, jax_file, line = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": _CSRC + src,
        "replaces": f"{jax_file}:{line}",
        "jax_function": f"{jax_file}::{name}", "mismatches": miss,
        "tolerance": tol, "max_abs_err": err, "ms": us / 1e3,
        "plain_ms": plain_us / 1e3, "bound_ms": bound_us / 1e3,
        "bound_by": "bytes" if bytes_us >= flops_us else "operations",
        "library_ms": None if lib_us is None else lib_us / 1e3,
        "us": us, "plain_us": plain_us, "library_us": lib_us,
        "library_device_us": lib_dev, "library_device_cold_us": lib_cold,
        "bound_us": bound_us, "bytes": nbytes, "flops": flops,
        "device_us": k_dev, "device_cold_us": k_cold,
        "device_events_us": k_queued, "plain_device_us": p_dev,
        "tflops_per_s": flops / (k_dev * 1e-6) / 1e12 if k_dev else None,
    }


def lm_pool_inputs(torch, np, dtype, seed, seqs=None, tokens=None, kvh=8,
                   g=5):
    """A pool and page table as the serve engine's decode steps see them:
    32 sequences mid-generation (512-639 tokens) on random pages of a
    1,280-page pool (32 slots x 40 pages) plus the zero sentinel, the
    rest of each table row -1; q pre-scaled f32 (32, kvh, g, 128), by
    default Qwen2.5-14B's 8 kv heads of 5. With ``seqs`` and ``tokens``:
    that many sequences of exactly that many tokens."""
    b, hd = seqs or LM_ENGINE["slots"], 128
    ps = LM_ENGINE["page_size"]
    maxp = -(-(LM_ENGINE["prompt_len"] + LM_ENGINE["gen_len"] - 1) // ps)
    if tokens:
        maxp = -(-tokens // ps)
    n_pages = b * maxp
    rng = np.random.default_rng(seed)
    lengths = rng.integers(LM_ENGINE["prompt_len"], maxp * ps, b) \
        if not tokens else np.full(b, tokens)
    perm = rng.permutation(n_pages)
    table = np.full((b, maxp), -1, np.int32)
    used = 0
    for i, n in enumerate(-(-lengths // ps)):
        table[i, :n] = perm[used: used + n]
        used += n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n_pages + 1, ps, kvh, hd)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kp[-1] = 0
    vp[-1] = 0
    q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda") * hd ** -0.5
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths.astype(np.int32)).cuda())


def paged_split_sweep(torch, pa, args, counts=(1, 2, 4, 8)):
    """Device µs of the paged kernel on ``args`` with each split count in
    ``counts``, by lowering ``SPLIT_TOKENS`` for the call: the measure
    behind the wrapper's rule of one split per SPLIT_TOKENS table
    tokens."""
    table, kp = args[3], args[1]
    table_tokens = table.shape[1] * kp.shape[1]
    keep, res = pa.SPLIT_TOKENS, {}
    try:
        for n in counts:
            pa.SPLIT_TOKENS = -(-table_tokens // n)
            if pa.splits(table.shape[1], kp.shape[1]) == n:
                res[n] = device_us(torch,
                                   lambda: pa.paged_attention_stats(*args))[0]
    finally:
        pa.SPLIT_TOKENS = keep
    return res


def phase_lm_kernels(torch, np, F, pa, fa, ref, cfg_mod, smi):
    """Both LM kernels against their plain versions at the serve shapes:
    the paged stats walk on a bf16 and an f32 pool (and its split count),
    plus 4 sequences of 16,384 tokens on a bf16 pool, flash prefill
    attention (8 prompts of 512 tokens, 40 q / 8 kv heads) in bf16 and
    f32, and windowed (128); both in bf16 at the MoE model's heads (32 q /
    4 kv) and at the vlm model's (28 q / 4 kv: G 7); flash at the hybrid
    model's (25 q / 5 kv, hd 64, 2,048-token prompts, its window of
    1,024) in bf16 and f32, and at the audio model's (32 q / 32 kv, hd
    64); both at a tensor-parallel rank's heads of the dense and MoE
    models, the walk at a data rank's half of the slots, and flash at a
    tensor-parallel rank's heads of the vlm, hybrid and audio models.
    Returns the bf16 entries of the dense main path, each other shape
    under ``<family>_shape``."""
    from repro_torch.parallel.sharding import head_plan

    out, entries = {"phase": "lm_kernels", "nvidia_smi": smi}, {}
    h_moe, kvh_moe = LM_MOE_HEADS
    fam = {name: cfg_mod.get_config(arch) for name, arch in (
        ("vlm", LM_VLM_ARCH), ("hybrid", LM_HYBRID_ARCH),
        ("audio", LM_AUDIO_ARCH))}
    vlm = fam["vlm"]
    for key, dt, seqs, tokens, heads in (
            ("bfloat16", torch.bfloat16, None, None, (8, 5)),
            ("float32", torch.float32, None, None, (8, 5)),
            ("long_bfloat16", torch.bfloat16, *LM_LONG, (8, 5)),
            ("moe_bfloat16", torch.bfloat16, None, None,
             (kvh_moe, h_moe // kvh_moe)),
            ("vlm_bfloat16", torch.bfloat16, None, None,
             (vlm.num_kv_heads, vlm.num_heads // vlm.num_kv_heads)),
            # lm_tp_serve's paged ranks: each holds 1/LM_TP_RANKS of the
            # kv heads, every q head of its groups
            ("tp_dense_bfloat16", torch.bfloat16, None, None,
             (8 // LM_TP_RANKS, 5)),
            ("tp_moe_bfloat16", torch.bfloat16, None, None,
             (kvh_moe // LM_TP_RANKS, h_moe // kvh_moe)),
            # lm_dp_serve's paged ranks: each walks its half of the slots
            # at every kv head
            ("dp_dense_bfloat16", torch.bfloat16,
             LM_TP_ENGINE["slots"] // LM_DP_RANKS, None, (8, 5))):
        args = lm_pool_inputs(torch, np, dt, SEED + 20, seqs, tokens, *heads)
        q, kp, vp, table, lengths = args
        b, kvh, g, hd = q.shape
        dtype_name = str(dt).rsplit(".", 1)[-1]
        tokens = int(lengths.sum())
        nbytes = (q.numel() * 4 * 2 + 2 * tokens * kvh * hd * kp.element_size()
                  + table.numel() * 4 + lengths.numel() * 4
                  + 2 * b * kvh * g * 4)
        flops = 4 * g * hd * kvh * tokens
        e = float_entry(
            torch, "paged_attention_stats", pa.paged_attention_stats(*args),
            ref.paged_attention_stats(*args),
            lambda: pa.paged_attention_stats(*args),
            lambda: ref.paged_attention_stats(*args), LM_TOL[dtype_name],
            nbytes, flops, dtype_name)
        e["tokens"] = tokens
        e["kv_heads_group"] = (kvh, g)
        e["splits"] = pa.splits(table.shape[1], kp.shape[1])
        if dt == torch.bfloat16 and not key.startswith("tp_"):
            e["device_us_by_splits"] = paged_split_sweep(torch, pa, args)
        out[f"paged_{key}"] = e
        if key == "bfloat16":
            entries["paged_attention_stats"] = e
        del args, q, kp, vp
        torch.cuda.empty_cache()
    s = LM_ENGINE["prompt_len"]
    cases = [("bfloat16", torch.bfloat16, 40, 8, s, 128, (0, 128)),
             ("float32", torch.float32, 40, 8, s, 128, (0, 128)),
             ("moe_bfloat16", torch.bfloat16, h_moe, kvh_moe, s, 128, (0,)),
             # lm_tp_serve's ranks: each holds 1/LM_TP_RANKS of the heads
             ("tp_dense_bfloat16", torch.bfloat16, 40 // LM_TP_RANKS,
              8 // LM_TP_RANKS, s, 128, (0,)),
             ("tp_moe_bfloat16", torch.bfloat16, h_moe // LM_TP_RANKS,
              kvh_moe // LM_TP_RANKS, s, 128, (0,))]
    # lm_tp_families' ranks: a rank's heads of the vlm (28 / 4), the
    # hybrid (25 / 5 padded to 30 / 6: hd 64 with its window, the TMA
    # path) and the audio (32 / 32, hd 64)
    for name, arch, seq in (("vlm", LM_VLM_ARCH, s),
                            ("hybrid", LM_HYBRID_ARCH,
                             LM_HYBRID_ENGINE["prompt_len"]),
                            ("audio", LM_AUDIO_ARCH, LM_AUDIO_FRAMES[1])):
        c = fam[name]
        plan = head_plan(c.num_heads, c.num_kv_heads, LM_TP_RANKS)
        cases.append((f"tp_{name}_bfloat16", torch.bfloat16,
                      plan.hp // LM_TP_RANKS, plan.kv_phys // LM_TP_RANKS,
                      seq, c.resolved_head_dim, (c.sliding_window,)))
    for name, dts, seq in (
            ("vlm", (torch.bfloat16,), s),
            ("hybrid", (torch.bfloat16, torch.float32),
             LM_HYBRID_ENGINE["prompt_len"]),
            ("audio", (torch.bfloat16,), LM_AUDIO_FRAMES[1])):
        c = fam[name]
        cases += [(f"{name}_{str(dt).rsplit('.', 1)[-1]}", dt, c.num_heads,
                   c.num_kv_heads, seq, c.resolved_head_dim,
                   (c.sliding_window,)) for dt in dts]
    b = 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for key, dt, h, kvh, s, hd, windows in cases:
        q = torch.randn((b, h, s, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, kvh, s, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, kvh, s, hd), generator=gen, device="cuda").to(dt)
        for window in windows:
            pos = torch.arange(s, device="cuda")
            keys = torch.minimum(pos + 1, torch.full_like(pos, window)) \
                if window else pos + 1
            flops = 4 * hd * b * h * int(keys.sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            mask = (pos[:, None] >= pos[None, :]) & (
                (pos[:, None] - pos[None, :]) < (window or s))

            def lib(q=q, k=k, v=v, mask=mask, window=window):
                if window:
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)

            dtype_name = str(dt).rsplit(".", 1)[-1]
            tol = FLASH_F32_TOL if dt == torch.float32 \
                else LM_TOL["bfloat16"]
            e = float_entry(
                torch, "flash_attention",
                (fa.flash_attention(q, k, v, window=window),),
                (ref.flash_attention(q, k, v, window=window),),
                lambda: fa.flash_attention(q, k, v, window=window),
                lambda: ref.flash_attention(q, k, v, window=window), tol,
                nbytes, flops, dtype_name, lib)
            e["window"] = window
            e["heads"] = (h, kvh)
            e["shape"] = {"b": b, "s": s, "hd": hd}
            out[f"flash_{key}_window{window}"] = e
            if key == "bfloat16" and not window:
                entries["flash_attention"] = e
        del q, k, v
        torch.cuda.empty_cache()
    emit(out)
    bad = {k: v["mismatches"] for k, v in out.items()
           if isinstance(v, dict) and v["mismatches"]}
    if bad:
        raise AssertionError(f"lm_kernels: kernels outside tolerance: {bad}")
    entries["paged_attention_stats"]["moe_shape"] = out["paged_moe_bfloat16"]
    entries["paged_attention_stats"]["vlm_shape"] = out["paged_vlm_bfloat16"]
    for name in ("tp_dense", "tp_moe", "dp_dense"):
        entries["paged_attention_stats"][f"{name}_shape"] = out[
            f"paged_{name}_bfloat16"]
    entries["flash_attention"]["moe_shape"] = out[
        "flash_moe_bfloat16_window0"]
    for name in ("tp_dense", "tp_moe"):
        entries["flash_attention"][f"{name}_shape"] = out[
            f"flash_{name}_bfloat16_window0"]
    for name in ("vlm", "hybrid", "audio"):
        entries["flash_attention"][f"tp_{name}_shape"] = out[
            f"flash_tp_{name}_bfloat16_window{fam[name].sliding_window}"]
    for name, key in (("vlm_shape", "vlm_bfloat16"),
                      ("hybrid_shape", "hybrid_bfloat16"),
                      ("hybrid_f32_shape", "hybrid_float32"),
                      ("audio_shape", "audio_bfloat16")):
        window = fam[key.split("_")[0]].sliding_window
        entries["flash_attention"][name] = out[f"flash_{key}_window{window}"]
    return entries


def lm_requests(np, cfg, n, seed, prompt_len=None, gen_len=None):
    """``n`` prompts of random tokens and per-request generation caps in
    [1, gen_len] (LM_ENGINE's lengths unless given)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           (n, prompt_len or LM_ENGINE["prompt_len"]))
    caps = rng.integers(1, (gen_len or LM_ENGINE["gen_len"]) + 1, n)
    return prompts.astype(np.int32), caps.astype(np.int32)


def lm_serve_run(torch, eng, cfg, ctx, params, ecfg, prompts, caps,
                 on_step=None, device="cuda"):
    """Inject every request (a wave of one per queue at a time) into the
    engine the launcher builds (``launch.serve.build_engine``: paged or
    dense per ``ecfg``), then run engine steps until all have completed.
    ``on_step(step, state)`` may return a replacement state. Returns
    (state, host seconds per step)."""
    from repro_torch.launch.serve import build_engine

    step_fn, state = build_engine(cfg, ctx, ecfg, params, device)
    state = lm_inject_all(torch, eng, state, ecfg, prompts, caps)
    times = []
    for step in range(len(prompts) * ecfg.gen_len):
        _sync(torch, device)
        t0 = time.perf_counter()
        state = step_fn(state)
        _sync(torch, device)
        times.append(time.perf_counter() - t0)
        if on_step is not None:
            state = on_step(step, state) or state
        if int(state.completed) == len(prompts):
            return state, times
    raise AssertionError(f"lm: {int(state.completed)} of {len(prompts)} "
                         "requests completed")


def lm_inject_all(torch, eng, state, ecfg, prompts, caps):
    """Every request into the rings, a wave of one per queue at a time."""
    q = ecfg.num_queues
    qids = torch.arange(q, dtype=torch.int32)
    for lo in range(0, len(prompts), q):
        state = eng.lm_inject(state, qids[: len(prompts[lo: lo + q])],
                              prompts[lo: lo + q], gen_caps=caps[lo: lo + q])
    return state


def lm_responses(np, rb, state, caps, nq):
    """The response rings as (queue, position) -> tokens, after checking
    every response: its count is one of its queue's caps, its tokens lie
    in the vocab, and its padding is zero."""
    avail = rb.available(state.resp).cpu().numpy()
    ents = state.resp.entries.cpu().numpy()
    out = {}
    for qi in range(nq):
        want = sorted(caps[qi::nq].tolist())
        got = []
        for j in range(int(avail[qi])):
            ent = ents[qi, (int(state.resp.head[qi]) + j) % ents.shape[1]]
            n = int(ent[0])
            if ent[1 + n:].any():
                raise AssertionError("lm: response padding is not zero")
            out[(qi, j)] = ent[1: 1 + n]
            got.append(n)
        if sorted(got) != want:
            raise AssertionError(f"lm: queue {qi} counts {sorted(got)} != "
                                 f"caps {want}")
    return out


def lm_setup(torch, cfg_mod, model, ctx, arch=LM_ARCH, seed=SEED + 30,
             **kw):
    cfg = cfg_mod.get_config(arch).replace(use_pallas_flash=True, **kw)
    t0 = time.perf_counter()
    params = model.init_params(seed, cfg, ctx, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    return cfg, params, init_s, nbytes


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def phase_lm_serve_f32(torch, np, eng, rb, cfg_mod, model, pa, fa, ctx, smi):
    """Full width, 4 layers, f32 (TF32 off): the kernel engine and the
    plain engine give equal token streams and pools within 1e-5 of each
    layer's scale, other state equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, _, _ = lm_setup(torch, cfg_mod, model, ctx,
                                 num_layers=LM_F32_LAYERS, dtype="float32")
    prompts, caps = lm_requests(np, cfg, LM_F32_REQUESTS, SEED + 31)
    runs = {}
    for backend in ("auto", "ref"):
        ecfg = eng.LMEngineConfig(**LM_ENGINE, kernel_backend=backend)
        pa.reset_launches()
        fa.reset_launches()
        state, times = lm_serve_run(torch, eng, cfg, ctx, params, ecfg,
                                    prompts, caps)
        runs[backend] = (state, times, {**pa.launches, **fa.launches})
    (a, t_k, launches), (b, t_p, plain) = runs["auto"], runs["ref"]
    ra = lm_responses(np, rb, a, caps, LM_ENGINE["num_queues"])
    rp = lm_responses(np, rb, b, caps, LM_ENGINE["num_queues"])
    streams_equal = ra.keys() == rp.keys() and all(
        np.array_equal(ra[k], rp[k]) for k in ra)
    pools = {}
    for f in ("k_pages", "v_pages"):
        x, y = getattr(a.decode, f), getattr(b.decode, f)
        pools[f] = [{"max_abs_diff": float((x[i] - y[i]).abs().max()),
                     "max_abs": float(y[i].abs().max()),
                     "outside_allclose_1e-5": int((~torch.isclose(
                         x[i], y[i], rtol=1e-5, atol=1e-5)).sum())}
                    for i in range(x.shape[0])]
    pools_ok = all(r["max_abs_diff"] <= POOL_REL_TOL * r["max_abs"]
                   for v in pools.values() for r in v)
    meta_equal = all(torch.equal(getattr(a.decode, f), getattr(b.decode, f))
                     for f in ("page_table", "lengths", "free_stack",
                               "free_top", "residency"))
    out = {"phase": "lm_serve_f32", "nvidia_smi": smi, "arch": LM_ARCH,
           "layers": LM_F32_LAYERS, "dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "requests": LM_F32_REQUESTS,
           "generated_tokens": int(sum(len(v) for v in ra.values())),
           "steps": len(t_k), "streams_equal": streams_equal,
           "pools_within_tolerance": pools_ok, "pool_tolerance":
           "max|diff| <= 1e-5 x max|value| per layer",
           "pool_meta_equal": meta_equal, "pools": pools,
           "launches": launches,
           "kernels_step_us_median": statistics.median(t_k) * 1e6,
           "plain_step_us_median": statistics.median(t_p) * 1e6}
    emit(out)
    if not (streams_equal and pools_ok and meta_equal) or any(plain.values()):
        raise AssertionError("lm_serve_f32: the kernel and plain engines "
                             f"differ (streams {streams_equal}, pools "
                             f"{pools_ok}, meta {meta_equal}, plain "
                             f"launches {plain})")
    if not all(launches.values()):
        raise AssertionError(f"lm_serve_f32: launches {launches}")
    del params, a, b, runs
    torch.cuda.empty_cache()


def decode_routed(model, moe, box, *args, **kw):
    """``model.paged_decode_step(*args, **kw)``; with ``moe`` (the MoE
    module), each layer's routed expert ids are appended to ``box``."""
    if moe is None:
        return model.paged_decode_step(*args, **kw)
    route = moe._route

    def recording(params, x_flat, cfg, *ctx):
        out = route(params, x_flat, cfg, *ctx)
        box.append(out[1])
        return out

    moe._route = recording
    try:
        return model.paged_decode_step(*args, **kw)
    finally:
        moe._route = route


def lm_teacher_forced(torch, model, pk, params, cfg, ctx, pcfg, snap,
                      moe=None):
    """At each of LM_TF_STEPS decode steps, the kernel path and the plain
    path decode the same tokens from clones of the same pool; the kernel
    path's tokens feed the next step. A row is decided when the plain
    logits' top-2 margin exceeds twice that row's largest |Δlogit|; argmax
    must agree on every decided row, and enough rows must be decided.
    With ``moe`` (the MoE module), also the share of (row, layer) top-k
    expert sets that the two paths share (reported)."""
    kv, toks, active = snap
    v = cfg.vocab_size
    seen = decided = agree = agree_all = 0
    sets, sets_equal = 0, [0] * cfg.num_layers
    max_d, stds, ratios = 0.0, [], []
    for _ in range(LM_TF_STEPS):
        kv_ref = pk.clone(kv)
        routes = ([], [])
        kv, lk, ok = decode_routed(model, moe, routes[0], params, toks, kv,
                                   pcfg, cfg, ctx, active=active,
                                   kernel_backend="cuda")
        _, lp, _ = decode_routed(model, moe, routes[1], params, toks, kv_ref,
                                 pcfg, cfg, ctx, active=active,
                                 kernel_backend="ref")
        del kv_ref
        rows = active & ok
        for i, (ik, ip) in enumerate(zip(*routes)):
            same = (ik[rows].sort(dim=-1).values
                    == ip[rows].sort(dim=-1).values).all(dim=-1)
            sets += int(same.numel())
            sets_equal[i] += int(same.sum())
        a, b = lk[rows, :v], lp[rows, :v]
        d = (a - b).abs().amax(dim=-1)
        top2 = b.topk(2, dim=-1).values
        dec = (top2[:, 0] - top2[:, 1]) > 2 * d
        eq = a.argmax(dim=-1) == b.argmax(dim=-1)
        seen += int(rows.sum())
        decided += int(dec.sum())
        agree += int((eq & dec).sum())
        agree_all += int(eq.sum())
        max_d = max(max_d, float(d.max()))
        std = b.std(dim=-1)
        stds.append(float(std.mean()))
        ratios.append(float((d / std).max()))
        toks = torch.where(rows, lk.argmax(dim=-1).to(torch.int32), toks)
        active = rows
    out = {"steps": LM_TF_STEPS, "rows": seen, "rows_decided": decided,
           "decided_share": decided / max(seen, 1),
           "argmax_equal_where_decided": agree,
           "argmax_equal_all": agree_all, "max_logit_diff": max_d,
           "logit_std_mean": sum(stds) / len(stds),
           "max_logit_diff_over_std": max(ratios),
           "required": {"share": LM_DECIDED_SHARE, "rows": LM_DECIDED_MIN}}
    if moe is not None:
        out["expert_sets"] = sets
        out["expert_sets_equal_share"] = sum(sets_equal) / max(sets, 1)
        out["expert_sets_equal_share_by_layer"] = [
            n * cfg.num_layers / max(sets, 1) for n in sets_equal]
    return out, kv


def clone_tree(torch, x):
    """A deep copy of a state of nested NamedTuples and dicts of
    tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*(clone_tree(torch, y) for y in x))
    if isinstance(x, dict):
        return {k: clone_tree(torch, y) for k, y in x.items()}
    return x


def lm_profile(torch, pa, fa, step_fn, state, steps=None):
    """``steps`` (LM_PROFILE_STEPS) engine steps (``step_fn``) from
    ``state`` (a copy: the serve run goes on from its own) under
    torch.profiler: device µs and device launches per step and the
    costliest kernels. The launch counts are left as they were: these
    steps are not the main path's."""
    counts = ({**pa.launches}, {**fa.launches})
    box = [state]
    steps = steps or LM_PROFILE_STEPS

    def run():
        box[0] = step_fn(box[0])

    total, per = device_us(torch, run, reps=steps)
    pa.launches.update(counts[0])
    fa.launches.update(counts[1])
    top = sorted(per.items(), key=lambda kv_: -kv_[1][0])[:8]
    return {"first_step": LM_PROFILE_STEP + 1, "steps": steps,
            "device_us_per_step": total,
            "device_launches_per_step": sum(n for _, n in per.values()),
            "top_kernels_us_per_step": {k[:90]: us for k, (us, _) in top}}


def lm_walk_check(torch, pa, ref, kv, seed, g):
    """Every layer's page slice of a live pool through the stats kernel
    and its plain version on the same pre-scaled q of ``g`` rows a kv
    head: the normalised outputs within the bf16 tolerance."""
    b = kv.lengths.shape[0]
    kvh, hd = kv.k_pages.shape[3], kv.k_pages.shape[4]
    dev = kv.k_pages.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev) * hd ** -0.5
    worst = 0.0
    for i in range(kv.k_pages.shape[0]):
        args = (q, kv.k_pages[i], kv.v_pages[i], kv.page_table, kv.lengths)
        acc, _, l = pa.paged_attention_stats(*args)
        acc_p, _, l_p = ref.paged_attention_stats(*args)
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        o_p = acc_p / torch.clamp(l_p, min=1e-30)[..., None]
        worst = max(worst, float((o - o_p).abs().max()))
    if worst > LM_TOL["bfloat16"]:
        raise AssertionError(f"lm walk check: {worst} > tolerance")
    return {"walk_layers_checked": kv.k_pages.shape[0],
            "walk_tolerance": LM_TOL["bfloat16"], "walk_max_abs_diff": worst}


def phase_lm_serve(torch, np, eng, rb, cfg_mod, model, pk, pa, fa, ref, ctx,
                   smi, phase="lm_serve", arch=LM_ARCH, requests=LM_REQUESTS,
                   seed=SEED + 30, moe=None, extra=None, layers=None):
    """All layers of ``arch`` in bf16 with the flash prefill,
    ``requests`` requests through the kernel engine (the main path: its
    launch counts), then the plain engine for free-running agreement
    (reported, not asserted), the teacher-forced check from a snapshot of
    the kernel run's pool (with ``moe``, the MoE module, also the share of
    expert sets the two paths agree on), and the per-layer walk check.
    ``extra(cfg, params)`` adds a check of its own: it returns (key,
    result, failure message or None). ``layers`` cuts the depth (widths
    kept). Frees the weights and returns the kernel run's launch
    counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    cfg, params, init_s, pbytes = lm_setup(
        torch, cfg_mod, model, ctx, arch, seed,
        **({"num_layers": layers} if layers else {}))
    prompts, caps = lm_requests(np, cfg, requests, seed + 2)
    ecfg = eng.LMEngineConfig(**LM_ENGINE, kernel_backend="auto")
    pcfg = eng.lm_paged_kv_config(ecfg, cfg, ctx)
    snap, prof, flash_seen = {}, {}, []

    def on_step(step, state):
        flash_seen.append(sum(fa.launches.values()))
        if step == LM_SNAPSHOT_STEP:
            kv = state.decode
            active = state.slot_active & (state.slot_done < state.slot_cap)
            snap["v"] = (pk.clone(kv), state.slot_last.clone(), active)
        if step == LM_PROFILE_STEP:
            prof.update(lm_profile(
                torch, pa, fa,
                lambda s: eng.lm_engine_step(s, ecfg, cfg, ctx, params),
                clone_tree(torch, state)))
        return None

    pa.reset_launches()
    fa.reset_launches()
    state, t_k = lm_serve_run(torch, eng, cfg, ctx, params, ecfg, prompts,
                              caps, on_step)
    launches = {**pa.launches, **fa.launches}
    peak = torch.cuda.max_memory_allocated()
    resp_k = lm_responses(np, rb, state, caps, ecfg.num_queues)
    steps = len(t_k)
    del state
    torch.cuda.empty_cache()

    plain_cfg = ecfg._replace(kernel_backend="ref")
    pa.reset_launches()
    fa.reset_launches()
    state, t_p = lm_serve_run(torch, eng, cfg, ctx, params, plain_cfg,
                              prompts, caps)
    if any(pa.launches.values()) or any(fa.launches.values()):
        raise AssertionError(f"{phase}: the plain engine launched kernels")
    resp_p = lm_responses(np, rb, state, caps, ecfg.num_queues)
    del state
    torch.cuda.empty_cache()
    same = sum(int((resp_k[k] == resp_p[k]).sum()) for k in resp_k)
    total_tokens = sum(len(v) for v in resp_k.values())

    tf, kv = lm_teacher_forced(torch, model, pk, params, cfg, ctx, pcfg,
                               snap.pop("v"), moe)
    tf.update(lm_walk_check(torch, pa, ref, kv, seed + 3,
                            cfg.num_heads // cfg.num_kv_heads))
    del kv
    torch.cuda.empty_cache()
    step_us = statistics.median(t_k) * 1e6
    # the profiled steps on the clone are the main run's next ones: the
    # same work, timed there without the profiler
    win = t_k[LM_PROFILE_STEP + 1: LM_PROFILE_STEP + 1 + LM_PROFILE_STEPS]
    prof["wall_us_per_step"] = sum(win) / len(win) * 1e6
    prof["idle_share"] = (1 - prof["device_us_per_step"]
                          / prof["wall_us_per_step"])
    # admission steps: those that ran the flash prefill
    adm = [n > m for n, m in zip(flash_seen, [0] + flash_seen[:-1])]
    win_adm = adm[LM_PROFILE_STEP + 1: LM_PROFILE_STEP + 1 + LM_PROFILE_STEPS]
    prof["admission_steps"] = sum(win_adm)
    t_dec = [t for t, a in zip(t_k, adm) if not a]
    t_adm = [t for t, a in zip(t_k, adm) if a]
    out = {"phase": phase, "nvidia_smi": smi, "arch": arch,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": (cfg.num_heads, cfg.num_kv_heads),
           "experts": (cfg.num_experts, cfg.num_experts_per_tok,
                       cfg.capacity_factor),
           "dtype": cfg.dtype, "use_pallas_flash": cfg.use_pallas_flash,
           "allocated_gb_at_start": start_gb,
           "params_gb": pbytes / 1e9, "init_s": init_s,
           "pool_gb": 2 * pcfg.layers * (pcfg.num_pages + 1) * pcfg.page_size
           * pcfg.kv_heads * pcfg.head_dim * 2 / 1e9,
           "peak_gb": peak / 1e9, "engine": LM_ENGINE,
           "requests": requests, "generated_tokens": total_tokens,
           "steps": steps, "admission_steps": len(t_adm),
           "token_agreement_auto_vs_ref": same / max(total_tokens, 1),
           "teacher_forced": tf, "launches": launches,
           "launches_per_step": {k: n / steps for k, n in launches.items()},
           # both engines: tokens over their summed engine-step times
           "kernels": {"step_us_median": step_us,
                       "step_us_p90": sorted(t_k)[int(0.9 * len(t_k))] * 1e6,
                       "decode_step_us_median":
                       statistics.median(t_dec) * 1e6,
                       "admission_step_us_median":
                       statistics.median(t_adm) * 1e6,
                       "step_s_sum": sum(t_k),
                       "tokens_per_s": total_tokens / sum(t_k)},
           "plain": {"step_us_median": statistics.median(t_p) * 1e6,
                     "step_s_sum": sum(t_p),
                     "tokens_per_s": total_tokens / sum(t_p)},
           "profile": prof}
    failed = None
    if extra is not None:
        key, out[key], failed = extra(cfg, params)
    emit(out)
    if failed:
        raise AssertionError(f"{phase}: {failed}")
    need = max(LM_DECIDED_SHARE * tf["rows"], LM_DECIDED_MIN)
    if tf["rows_decided"] < need:
        raise AssertionError(f"{phase}: {tf['rows_decided']} of "
                             f"{tf['rows']} teacher-forced rows decided, "
                             f"fewer than {need}")
    if tf["argmax_equal_where_decided"] != tf["rows_decided"]:
        raise AssertionError(f"{phase}: argmax differs on a decided row")
    if not all(launches.values()):
        raise AssertionError(f"{phase}: kernels not launched: {launches}")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# LM serving: the vlm, hybrid, ssm and audio families
# ---------------------------------------------------------------------------

def row_stats(torch, a, b, v):
    """Teacher-forced rows, kernel logits ``a`` against plain ``b`` (rows
    x at least ``v``), over the first ``v`` columns: a row is decided when
    b's top-2 margin exceeds twice the row's largest |a - b|."""
    a, b = a[:, :v].float(), b[:, :v].float()
    d = (a - b).abs().amax(dim=-1)
    top2 = b.topk(2, dim=-1).values
    dec = (top2[:, 0] - top2[:, 1]) > 2 * d
    eq = a.argmax(dim=-1) == b.argmax(dim=-1)
    return {"rows": int(a.shape[0]), "rows_decided": int(dec.sum()),
            "argmax_equal_where_decided": int((eq & dec).sum()),
            "argmax_equal_all": int(eq.sum()),
            "max_logit_diff": float(d.max()),
            "max_logit_diff_over_std": float((d / b.std(dim=-1)).max())}


def merge_rows(parts):
    """row_stats parts summed (the largest differences kept), with the
    decided share."""
    out = {k: sum(p[k] for p in parts) for k in (
        "rows", "rows_decided", "argmax_equal_where_decided",
        "argmax_equal_all")}
    for k in ("max_logit_diff", "max_logit_diff_over_std"):
        out[k] = max(p[k] for p in parts)
    out["decided_share"] = out["rows_decided"] / max(out["rows"], 1)
    return out


def decided_failure(tf, share):
    """Why the teacher-forced rows ``tf`` fail: fewer decided than
    ``share`` of the rows (None: only LM_DECIDED_MIN) and LM_DECIDED_MIN,
    or an argmax that differs on a decided row; None when they pass."""
    need = max((share or 0) * tf["rows"], LM_DECIDED_MIN)
    if tf["rows_decided"] < need:
        return (f"{tf['rows_decided']} of {tf['rows']} teacher-forced rows "
                f"decided, fewer than {need}")
    if tf["argmax_equal_where_decided"] != tf["rows_decided"]:
        return "argmax differs on a decided row"
    return None


def flash_walk(torch, ops, ref, tol, fn):
    """``fn()`` with every ``ops.flash_attention`` call (one a layer of a
    prefill) also held against the plain version on the same inputs.
    Returns (fn's result, the walk: layers, elements outside ``tol``, the
    largest |difference|)."""
    orig = ops.flash_attention
    walk = {"layers_checked": 0, "outside_tolerance": 0,
            "max_abs_diff": 0.0, "tolerance": tol}

    def checked(q, k, v, *, window=0, backend="auto"):
        out = orig(q, k, v, window=window, backend=backend)
        a, b = out.float(), ref.flash_attention(q, k, v, window=window).float()
        walk["layers_checked"] += 1
        walk["outside_tolerance"] += int(
            (~torch.isclose(a, b, rtol=tol, atol=tol)).sum())
        walk["max_abs_diff"] = max(walk["max_abs_diff"],
                                   float((a - b).abs().max()))
        return out

    ops.flash_attention = checked
    try:
        return fn(), walk
    finally:
        ops.flash_attention = orig


def lm_prefill_rows(torch, model, params, toks, ctx, cache_len, arm_a, arm_b,
                    walk=None):
    """The teacher-forced rows of a prefill: ``toks`` through
    ``model.prefill`` on arm a and on arm b (each (cfg, backend)), the
    logits of every position held row by row, then LM_PREFILL_TF_STEPS
    dense decode steps from the two prefilled states, both fed arm a's greedy tokens.
    ``walk(fn)`` wraps arm a's prefill (flash_walk). Returns (the rows,
    with their "prefill" and "decode" parts; the walk or None)."""
    outs, walked = [], None
    for i, (cfg, backend) in enumerate((arm_a, arm_b)):
        st = model.make_decode_state(cfg, ctx, toks.shape[0], cache_len,
                                     "cuda")

        def run(cfg=cfg, backend=backend, st=st):
            return model.prefill(params, toks, st, cfg, ctx, backend=backend,
                                 all_logits=True)

        if i == 0 and walk is not None:
            res, walked = walk(run)
        else:
            res = run()
        outs.append(res)
        del st, run
    (sa, la), (sb, lb) = outs
    del outs
    v, vp = arm_a[0].vocab_size, la.shape[-1]
    pre = row_stats(torch, la.reshape(-1, vp), lb.reshape(-1, vp), v)
    nxt = la[:, -1].argmax(-1).to(torch.int32)
    del la, lb
    dec, steps = [], LM_PREFILL_TF_STEPS
    for _ in range(steps):
        sa, la = model.decode_step(params, nxt, sa, arm_a[0], ctx)
        sb, lb = model.decode_step(params, nxt, sb, arm_b[0], ctx)
        dec.append(row_stats(torch, la.reshape(-1, vp), lb.reshape(-1, vp),
                             v))
        nxt = la.argmax(-1).to(torch.int32)
    out = merge_rows([pre] + dec)
    out.update(prompts=list(toks.shape[:2]), prefill=merge_rows([pre]),
               decode_steps=steps)
    if dec:
        out["decode"] = merge_rows(dec)
    del sa, sb
    torch.cuda.empty_cache()
    return out, walked


def lm_media_check(torch, model, fa, params, cfg, ctx, seed):
    """A vlm prefill of LM_TF_PROMPTS prompts of media_tokens + prompt_len
    tokens with media embeddings (random, at the token embeddings' scale)
    at the first media_tokens positions: the kernel prefill against the
    plain one (argmax equal where decided), and against the kernel
    prefill without media, whose logits must differ. For phase_lm_serve's
    ``extra``."""
    b, m = LM_TF_PROMPTS, cfg.media_tokens
    s = m + LM_ENGINE["prompt_len"]
    v = cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(1, v, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)
    tok = params["embed"]["tok"]
    scale = float(tok[:4096].float().std())
    media = (torch.randn((b, m, cfg.d_model), generator=gen, device="cuda")
             * scale).to(tok.dtype)
    logits, secs, flash = {}, {}, {}
    for name, backend, med in (("kernel", "cuda", media),
                               ("plain", "ref", media),
                               ("kernel_no_media", "cuda", None)):
        st = model.make_decode_state(cfg, ctx, b, s, "cuda")
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits[name] = model.prefill(params, toks, st, cfg, ctx,
                                        media=med, backend=backend)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        flash[name] = fa.launches["flash_attention"]
        del st
    rows = merge_rows([row_stats(torch, logits["kernel"], logits["plain"],
                                 v)])
    with_m, without = logits["kernel"][:, :v], logits["kernel_no_media"][:, :v]
    change = float((with_m - without).abs().max())
    out = {"prompts": [b, s], "media_tokens": m, "media_scale": scale,
           "kernel_vs_plain": rows, "media_max_logit_change": change,
           "media_argmax_changed": int((with_m.argmax(-1)
                                        != without.argmax(-1)).sum()),
           "seconds": secs, "flash_launches": flash}
    failed = None
    if rows["argmax_equal_where_decided"] != rows["rows_decided"]:
        failed = "media prefill: argmax differs on a decided row"
    elif not change > 1e-3:
        failed = f"media prefill: the media moved the logits by {change}"
    elif flash != {"kernel": cfg.num_layers, "plain": 0,
                   "kernel_no_media": cfg.num_layers}:
        failed = f"media prefill: flash launches {flash}"
    torch.cuda.empty_cache()
    return "media_prefill", out, failed


def lm_dense_run(torch, eng, serve, pa, fa, cfg, ctx, params, ecfg, prompts,
                 caps, profile=True):
    """The requests through the dense engine (``launch.serve``), the
    launch counts set to 0 just before. Returns (state, step seconds,
    admission flags, launches, and with ``profile``
    LM_FAMILY_PROFILE_STEPS steps from a copy of the state after step
    LM_PROFILE_STEP under the profiler)."""
    step_fn = serve.engine_step(cfg, ctx, ecfg, params, "cuda")
    adm, prof = [], {}

    def on_step(step, state):
        # a request seated this step has emitted only its prefill token
        adm.append(bool((state.slot_active & (state.slot_done == 1)).any()))
        if profile and step == LM_PROFILE_STEP:
            prof.update(lm_profile(torch, pa, fa, step_fn,
                                   clone_tree(torch, state),
                                   LM_FAMILY_PROFILE_STEPS))

    pa.reset_launches()
    fa.reset_launches()
    state, times = lm_serve_run(torch, eng, cfg, ctx, params, ecfg, prompts,
                                caps, on_step)
    launches = {**pa.launches, **fa.launches}
    if profile:
        win = slice(LM_PROFILE_STEP + 1, LM_PROFILE_STEP + 1
                    + LM_FAMILY_PROFILE_STEPS)
        prof["wall_us_per_step"] = statistics.mean(times[win]) * 1e6
        prof["idle_share"] = (1 - prof["device_us_per_step"]
                              / prof["wall_us_per_step"])
        prof["admission_steps"] = sum(adm[win])
    return state, times, adm, launches, prof


def lm_recover_cycle(torch, np, eng, rb, serve, pa, fa, cfg, ctx, params,
                     ecfg, prompts, caps, twin, phase, smi):
    """The durability path of a dense-engine family: the requests through a
    fresh kernel engine, flushed through ``DurabilityManager`` every
    LM_RECOVER_EVERY steps (full snapshots: the recurrent state is opaque
    to the delta diff) and killed after step LM_RECOVER_KILL, mid-decode
    with two flushes committed; ``recover`` into a fresh state, then steps
    until every request is answered. The recovered state must equal the
    state flushed at the covered step, and the final state, responses
    included, the never-crashed ``twin``'s (the kernel run's final state),
    bit for bit; each request answered once. Emits the cycle's line and
    returns its launches (the admission prefills are all before the
    kill)."""
    from repro_torch.fault import recovery as frec

    step_fn, state = serve.build_engine(cfg, ctx, ecfg, params, "cuda")
    snap_b = tree_bytes(torch, state)
    # two committed snapshots and one being written, at most
    room = check_room(phase, 3 * snap_b)
    root = tempfile.mkdtemp(prefix=f"orca-{phase}-")
    n = len(prompts)
    try:
        pa.reset_launches()
        fa.reset_launches()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        state = lm_inject_all(torch, eng, state, ecfg, prompts, caps)
        mgr = frec.DurabilityManager(frec.DurabilityConfig(
            root, every=LM_RECOVER_EVERY, mode="adaptive"))
        flushed = {}
        for step in range(1, LM_RECOVER_KILL + 1):
            state = step_fn(state)
            if step % LM_RECOVER_EVERY == 0:
                mgr.flush(state)
                flushed = {step: clone_tree(torch, state)}
        mgr.wait()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_start
        mid_decode = (int(state.completed) < n and bool(
            (state.slot_active & (state.slot_done > 1)).any()))
        committed = [r.step for r in mgr.committed()]
        del state  # the kill: nothing of the live state survives
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fresh = serve.build_engine(cfg, ctx, ecfg, params, "cuda")[1]
        stats = {}
        state, covered = frec.recover(root, fresh, stats=stats)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        stats["truncated"] = [os.path.basename(p) for p in stats["truncated"]]
        del fresh
        if not mid_decode or len(committed) < 2 or covered != max(flushed):
            raise AssertionError(f"{phase}: mid-decode {mid_decode}, "
                                 f"committed {committed}, covered {covered}")
        same_state(torch, state, flushed.pop(covered),
                   f"{phase}: recovered vs flushed at step {covered}")
        t0 = time.perf_counter()
        steps = covered
        while int(state.completed) < n:
            if steps > n * ecfg.gen_len:
                raise AssertionError(f"{phase}: {int(state.completed)} of "
                                     f"{n} answered after recovery")
            state = step_fn(state)
            steps += 1
        torch.cuda.synchronize()
        after_s = time.perf_counter() - t0
        same_state(torch, state, twin,
                   f"{phase}: recovered run vs never-crashed twin")
        answered = len(lm_responses(np, rb, state, caps, ecfg.num_queues))
        launches = {**pa.launches, **fa.launches}
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    recs = mgr.records
    emit({"phase": phase, "nvidia_smi": smi, "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": cfg.dtype,
          "snapshot_bytes": snap_b, **room,
          "flush_every": LM_RECOVER_EVERY, "kill_after_step": LM_RECOVER_KILL,
          "committed_steps": committed, "covered": covered,
          "flushes": flush_summary(recs),
          "flush_bytes": [r.bytes for r in recs],
          "host_copy_us": [r.copy_us for r in recs],
          "mgr_stats": mgr.stats(), "recover": stats,
          "recover_s": recover_s, "steps_after_recovery": steps - covered,
          "requests": n, "answered": answered, "launches": launches,
          "recovered_equals_flushed": True, "final_equals_twin": True,
          "seconds": {"crash_run": run_s, "recover": recover_s,
                      "after_recovery": after_s,
                      "cycle": run_s + recover_s + after_s}})
    if answered != n:
        raise AssertionError(f"{phase}: {answered} answers to {n} requests")
    return launches


def step_summary_lm(times, adm, tokens):
    """Step medians (all, decode, admission) and tokens over the summed
    step times."""
    dec = [t for t, a in zip(times, adm) if not a]
    ad = [t for t, a in zip(times, adm) if a]
    return {"step_us_median": statistics.median(times) * 1e6,
            "decode_step_us_median": statistics.median(dec) * 1e6,
            "admission_step_us_median":
            statistics.median(ad) * 1e6 if ad else None,
            "steps": len(times), "admission_steps": len(ad),
            "step_s_sum": sum(times), "tokens_per_s": tokens / sum(times)}


def phase_lm_hybrid_serve(torch, np, eng, serve, rb, cfg_mod, model, ops, pa,
                          fa, ref, ctx, smi):
    """Hymba-1.5B, LM_HYBRID_LAYERS of its 32 in bf16: LM_DENSE_REQUESTS
    requests of
    2,048 tokens through the dense engine with the flash prefill (the main
    path: its launch counts), then the plain engine (free-running
    agreement, reported). Teacher-forced rows of LM_TF_PROMPTS prompts
    (every prompt position, then LM_PREFILL_TF_STEPS decode steps), the
    kernel prefill against the plain one: in bf16 every decided row
    argmax-equal and at least LM_DECIDED_MIN decided, beside the control
    of two plain versions (chunked attention against the plain flash); in
    f32 at full width and that depth the standard LM_DECIDED_SHARE. Each
    prefill's layers walked through flash against its plain version.
    Between the kernel and plain runs, the crash-and-recover cycle
    (``lm_recover_cycle``) against the kernel run. Returns (the main path's
    launches, the f32 check's flash launches, the cycle's launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    seed = SEED + 50
    cfg, params, init_s, pbytes = lm_setup(torch, cfg_mod, model, ctx,
                                           LM_HYBRID_ARCH, seed,
                                           num_layers=LM_HYBRID_LAYERS)
    ecfg = eng.LMEngineConfig(**LM_HYBRID_ENGINE, kernel_backend="auto")
    prompts, caps = lm_requests(np, cfg, LM_DENSE_REQUESTS, seed + 2,
                                ecfg.prompt_len)
    secs = {}
    t0 = time.perf_counter()
    state, t_k, adm, launches, prof = lm_dense_run(
        torch, eng, serve, pa, fa, cfg, ctx, params, ecfg, prompts, caps)
    secs["kernel_run"] = time.perf_counter() - t0
    resp_k = lm_responses(np, rb, state, caps, ecfg.num_queues)
    t0 = time.perf_counter()
    cycle = lm_recover_cycle(torch, np, eng, rb, serve, pa, fa, cfg, ctx,
                             params, ecfg, prompts, caps, state,
                             "lm_hybrid_recover", smi)
    secs["recover_cycle"] = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state, t_p, adm_p, plain, _ = lm_dense_run(
        torch, eng, serve, pa, fa, cfg, ctx, params,
        ecfg._replace(kernel_backend="ref"), prompts, caps, profile=False)
    secs["plain_run"] = time.perf_counter() - t0
    resp_p = lm_responses(np, rb, state, caps, ecfg.num_queues)
    del state
    torch.cuda.empty_cache()
    total = sum(len(r) for r in resp_k.values())
    same = sum(int((resp_k[k] == resp_p[k]).sum()) for k in resp_k)

    t0 = time.perf_counter()
    toks = torch.from_numpy(prompts[:LM_TF_PROMPTS]).cuda()
    tf_bf, walk_bf = lm_prefill_rows(
        torch, model, params, toks, ctx, ecfg.cache_len, (cfg, "cuda"),
        (cfg, "ref"), walk=lambda fn: flash_walk(
            torch, ops, ref, LM_TOL["bfloat16"], fn))
    control, _ = lm_prefill_rows(
        torch, model, params, toks, ctx, ecfg.cache_len,
        (cfg.replace(use_pallas_flash=False), "ref"), (cfg, "ref"))
    secs["teacher_forced_bf16"] = time.perf_counter() - t0
    peak_bf = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32, p32, _, pbytes32 = lm_setup(torch, cfg_mod, model, ctx,
                                       LM_HYBRID_ARCH, seed, dtype="float32",
                                       num_layers=LM_HYBRID_LAYERS)
    fa.reset_launches()
    tf_32, walk_32 = lm_prefill_rows(
        torch, model, p32, toks, ctx, ecfg.cache_len, (cfg32, "cuda"),
        (cfg32, "ref"), walk=lambda fn: flash_walk(
            torch, ops, ref, FLASH_F32_TOL, fn))
    f32_launches = fa.launches["flash_attention"]
    secs["teacher_forced_f32"] = time.perf_counter() - t0
    del p32, toks
    torch.cuda.empty_cache()

    out = {"phase": "lm_hybrid_serve", "nvidia_smi": smi,
           "arch": LM_HYBRID_ARCH, "family": cfg.family,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": (cfg.num_heads, cfg.num_kv_heads),
           "window": cfg.sliding_window,
           "ssm": {"state": cfg.ssm_state, "expand": cfg.ssm_expand},
           "dtype": cfg.dtype, "use_pallas_flash": cfg.use_pallas_flash,
           "allocated_gb_at_start": start_gb, "params_gb": pbytes / 1e9,
           "params_f32_gb": pbytes32 / 1e9, "init_s": init_s,
           "peak_gb": peak_bf / 1e9,
           "peak_gb_with_f32": torch.cuda.max_memory_allocated() / 1e9,
           "engine": LM_HYBRID_ENGINE, "requests": LM_DENSE_REQUESTS,
           "generated_tokens": total,
           "token_agreement_auto_vs_ref": same / max(total, 1),
           "launches": launches,
           "launches_per_step": {k: n / len(t_k)
                                 for k, n in launches.items()},
           "kernels": step_summary_lm(t_k, adm, total),
           "plain": step_summary_lm(t_p, adm_p, total),
           "profile": prof,
           "teacher_forced": {
               "bfloat16": {**tf_bf, "flash_layers": walk_bf,
                            "required": {"rows": LM_DECIDED_MIN,
                                         "share": None},
                            "control_chunked_vs_plain_flash": control},
               "float32": {**tf_32, "flash_layers": walk_32,
                           "flash_launches": f32_launches,
                           "required": {"rows": LM_DECIDED_MIN,
                                        "share": LM_DECIDED_SHARE}}},
           "seconds": secs}
    emit(out)
    failed = [f"{k}: {m}" for k, m in (
        ("bf16", decided_failure(tf_bf, None)),
        ("f32", decided_failure(tf_32, LM_DECIDED_SHARE))) if m]
    failed += [f"flash walk {k}: {w['outside_tolerance']} elements outside"
               for k, w in (("bf16", walk_bf), ("f32", walk_32))
               if w["outside_tolerance"] or
               w["layers_checked"] != cfg.num_layers]
    if not launches["flash_attention"] or any(plain.values()):
        failed.append(f"launches {launches}, plain engine {plain}")
    if not cycle["flash_attention"]:
        failed.append(f"recovery cycle launches {cycle}")
    if failed:
        raise AssertionError(f"lm_hybrid_serve: {failed}")
    return launches, f32_launches, cycle


def phase_lm_ssm_serve(torch, np, eng, serve, rb, cfg_mod, model, pa, fa,
                       ctx, smi):
    """RWKV6-1.6B, LM_SSM_LAYERS of its 24 layers in bf16,
    LM_DENSE_REQUESTS requests
    through the dense engine. No hand-written kernel lies on this path
    (the JAX package's ssm mixers have no Pallas kernel): the phase
    reports the engine and checks the card against the CPU in f32 at
    LM_SSM_CPU's layers and requests: equal token streams, each layer's
    state within 1e-5 of its largest |s|. Then the crash-and-recover cycle
    (``lm_recover_cycle``) against the kernel run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    seed = SEED + 60
    cfg, params, init_s, pbytes = lm_setup(torch, cfg_mod, model, ctx,
                                           LM_SSM_ARCH, seed,
                                           num_layers=LM_SSM_LAYERS)
    ecfg = eng.LMEngineConfig(**LM_SSM_ENGINE, kernel_backend="auto")
    prompts, caps = lm_requests(np, cfg, LM_DENSE_REQUESTS, seed + 2)
    secs = {}
    t0 = time.perf_counter()
    state, t_k, adm, launches, prof = lm_dense_run(
        torch, eng, serve, pa, fa, cfg, ctx, params, ecfg, prompts, caps)
    secs["run"] = time.perf_counter() - t0
    total = sum(len(r) for r in lm_responses(
        np, rb, state, caps, ecfg.num_queues).values())
    t0 = time.perf_counter()
    cycle = lm_recover_cycle(torch, np, eng, rb, serve, pa, fa, cfg, ctx,
                             params, ecfg, prompts, caps, state,
                             "lm_ssm_recover", smi)
    secs["recover_cycle"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del state, params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    layers, n = LM_SSM_CPU
    cfg32 = cfg_mod.get_config(LM_SSM_ARCH).replace(num_layers=layers,
                                                   dtype="float32")
    p_card = model.init_params(seed + 5, cfg32, ctx, "cuda")
    p_cpu = tree_to(p_card, "cpu")
    ecfg32 = eng.LMEngineConfig(**LM_SSM_CPU_ENGINE)
    pr, cp = lm_requests(np, cfg32, n, seed + 6, gen_len=ecfg32.gen_len)
    runs = {}
    for dev, p in (("cuda", p_card), ("cpu", p_cpu)):
        t1 = time.perf_counter()
        st, _ = lm_serve_run(torch, eng, cfg32, ctx, p, ecfg32, pr, cp,
                             device=dev)
        runs[dev] = (st, time.perf_counter() - t1)
    (a, ta), (b, tb) = runs["cuda"], runs["cpu"]
    ra = lm_responses(np, rb, a, cp, ecfg32.num_queues)
    rp = lm_responses(np, rb, b, cp, ecfg32.num_queues)
    streams_equal = ra.keys() == rp.keys() and all(
        np.array_equal(ra[k], rp[k]) for k in ra)
    sa, sb = a.decode.layers, b.decode.layers
    states = [{"max_abs_diff": float((sa["s"][i].cpu() - sb["s"][i]).abs()
                                     .max()),
               "max_abs": float(sb["s"][i].abs().max())}
              for i in range(layers)]
    states_ok = all(r["max_abs_diff"] <= POOL_REL_TOL * r["max_abs"]
                    for r in states)
    shifts = {k: float((sa[k].cpu() - sb[k]).abs().max())
              for k in ("tshift", "cshift")}
    secs["card_vs_cpu"] = time.perf_counter() - t0
    out = {"phase": "lm_ssm_serve", "nvidia_smi": smi, "arch": LM_SSM_ARCH,
           "family": cfg.family, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "allocated_gb_at_start": start_gb, "params_gb": pbytes / 1e9,
           "init_s": init_s, "peak_gb": peak / 1e9, "engine": LM_SSM_ENGINE,
           "requests": LM_DENSE_REQUESTS, "generated_tokens": total,
           "kernels_on_path": [], "launches": launches,
           "kernels": step_summary_lm(t_k, adm, total), "profile": prof,
           "card_vs_cpu": {
               "layers": layers, "dtype": "float32", "requests": n,
               "engine": LM_SSM_CPU_ENGINE,
               "generated_tokens": int(sum(len(r) for r in ra.values())),
               "cpu_threads": torch.get_num_threads(),
               "seconds": {"cuda": ta, "cpu": tb},
               "streams_equal": streams_equal,
               "states_within_tolerance": states_ok,
               "state_tolerance": "max|diff| <= 1e-5 x max|s| per layer",
               "s": states, "shift_max_abs_diff": shifts},
           "seconds": secs}
    emit(out)
    if not (streams_equal and states_ok) or any(launches.values()) \
            or any(cycle.values()):
        raise AssertionError(f"lm_ssm_serve: card against CPU: streams "
                             f"{streams_equal}, states {states_ok}; "
                             f"launches {launches}, recovery cycle {cycle}")
    del p_card, p_cpu, a, b, runs
    torch.cuda.empty_cache()


def tree_to(tree, device):
    """A nested dict of tensors copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_lm_audio(torch, np, cfg_mod, model, ops, pa, fa, ref, ctx, smi):
    """MusicGen-large, LM_AUDIO_LAYERS of its 48 layers in bf16:
    LM_AUDIO_FRAMES of 4
    codebook tokens through ``model.prefill`` with the flash kernel, then
    LM_AUDIO_STEPS greedy ``decode_step``s (the main path: its launch
    counts); the same with the plain version; the teacher-forced rows of
    the prefill (every position and codebook, then LM_PREFILL_TF_STEPS
    decode steps) with the standard share, its layers walked through
    flash against its plain version. Returns the main path's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    seed = SEED + 70
    cfg, params, init_s, pbytes = lm_setup(torch, cfg_mod, model, ctx,
                                           LM_AUDIO_ARCH, seed,
                                           num_layers=LM_AUDIO_LAYERS)
    b, s = LM_AUDIO_FRAMES
    k = cfg.num_codebooks
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, (b, s, k), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache_len = s + LM_AUDIO_STEPS

    def run(backend, keep=None):
        st = model.make_decode_state(cfg, ctx, b, cache_len, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, logits = model.prefill(params, toks, st, cfg, ctx,
                                   backend=backend)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        if keep is not None:
            keep.append(clone_tree(torch, st))
        frames, times = [], []
        nxt = logits.argmax(-1).to(torch.int32)
        for _ in range(LM_AUDIO_STEPS):
            frames.append(nxt)
            t0 = time.perf_counter()
            st, logits = model.decode_step(params, nxt, st, cfg, ctx)
            nxt = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return t_pre, times, torch.stack(frames, 1)

    kept = []
    pa.reset_launches()
    fa.reset_launches()
    pre_k, t_k, frames_k = run("cuda", kept)
    launches = {**pa.launches, **fa.launches}
    pa.reset_launches()
    fa.reset_launches()
    pre_p, t_p, frames_p = run("ref")
    plain = {**pa.launches, **fa.launches}
    box = [kept.pop()]

    def step():
        box[0], logits = model.decode_step(params, frames_k[:, 0], box[0],
                                           cfg, ctx)

    dev_us, per = device_us(torch, step, reps=LM_FAMILY_PROFILE_STEPS)
    del box
    wall = statistics.mean(t_k) * 1e6
    prof = {"steps": LM_FAMILY_PROFILE_STEPS, "device_us_per_step": dev_us,
            "device_launches_per_step": sum(n for _, n in per.values()),
            "wall_us_per_step": wall, "idle_share": 1 - dev_us / wall}
    t0 = time.perf_counter()
    tf, walk = lm_prefill_rows(
        torch, model, params, toks, ctx, cache_len, (cfg, "cuda"),
        (cfg, "ref"), walk=lambda fn: flash_walk(
            torch, ops, ref, LM_TOL["bfloat16"], fn))
    tf_s = time.perf_counter() - t0
    frames = b * LM_AUDIO_STEPS
    out = {"phase": "lm_audio", "nvidia_smi": smi, "arch": LM_AUDIO_ARCH,
           "family": cfg.family, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": (cfg.num_heads, cfg.num_kv_heads),
           "codebooks": k, "dtype": cfg.dtype,
           "allocated_gb_at_start": start_gb, "params_gb": pbytes / 1e9,
           "init_s": init_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefill": {"frames": [b, s], "kernel_s": pre_k, "plain_s": pre_p},
           "decode_steps": LM_AUDIO_STEPS, "launches": launches,
           "kernels": {"decode_step_us_median":
                       statistics.median(t_k) * 1e6,
                       "step_s_sum": sum(t_k),
                       "frames_per_s": frames / sum(t_k),
                       "tokens_per_s": frames * k / sum(t_k)},
           "plain": {"decode_step_us_median": statistics.median(t_p) * 1e6,
                     "step_s_sum": sum(t_p),
                     "frames_per_s": frames / sum(t_p)},
           "frame_agreement_auto_vs_ref": float(
               (frames_k == frames_p).float().mean()),
           "profile": prof,
           "teacher_forced": {**tf, "flash_layers": walk,
                              "required": {"rows": LM_DECIDED_MIN,
                                           "share": LM_DECIDED_SHARE}},
           "seconds": {"teacher_forced": tf_s}}
    emit(out)
    failed = decided_failure(tf, LM_DECIDED_SHARE)
    if walk["outside_tolerance"] or walk["layers_checked"] != cfg.num_layers:
        failed = f"flash walk {walk}"
    if launches["flash_attention"] != cfg.num_layers or any(plain.values()):
        failed = f"launches {launches}, plain {plain}"
    if failed:
        raise AssertionError(f"lm_audio: {failed}")
    del params, toks
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _ratio(torch, got, want):
    """max |got - want| over max |want| (0 where both are 0)."""
    d = float((got.float() - want.float()).abs().max())
    m = float(want.float().abs().max())
    return d / m if m else (0.0 if d == 0 else float("inf"))


def product_walk(torch, products, tol, fn):
    """``fn()`` with every backward of the f32-output products
    (``products``: pairs of the autograd Function and its plain product)
    also held against the plain upcast product under autograd on the
    call's own inputs and cotangent. Returns (fn's result, the walk: calls
    checked, calls outside ``tol``, the largest max|Δ| / max|plain| of
    grad_x and grad_w)."""
    walk = {"calls_checked": 0, "outside_tolerance": 0, "max_ratio": 0.0,
            "tolerance": tol}
    saved = {cls: vars(cls)["backward"] for cls, _ in products}

    def checked_for(cls, plain):
        def checked(ctx_, g):
            x, w = ctx_.saved_tensors  # unpacked once (remat recomputes)
            got = cls.grads(x, w, g, ctx_.needs_input_grad)
            with torch.enable_grad():
                xs = x.detach().requires_grad_()
                ws = w.detach().requires_grad_()
                want = torch.autograd.grad(plain(xs.float(), ws.float()),
                                           (xs, ws), g)
            r = max(_ratio(torch, a, b) for a, b in zip(got, want)
                    if a is not None)
            walk["calls_checked"] += 1
            walk["outside_tolerance"] += int(r > tol)
            walk["max_ratio"] = max(walk["max_ratio"], r)
            return got
        return staticmethod(checked)

    for cls, plain in products:
        cls.backward = checked_for(cls, plain)
    try:
        return fn(), walk
    finally:
        for cls, orig in saved.items():
            cls.backward = orig


def plain_products(torch, products, fn):
    """``fn()`` with the f32-output products replaced by their plain
    upcast products (autograd's own backward)."""
    for cls, plain in products:
        cls.apply = staticmethod(
            lambda x, w, plain=plain: plain(x.float(), w.float()))
    try:
        return fn()
    finally:
        for cls, _ in products:
            del cls.apply


def tree_diff(torch, leaves, a, b):
    """Largest |a - b| over the leaves of two trees (lists of them), in
    ``leaves``' (sorted key) order, in f32."""
    return max(float((x.float() - y.float()).abs().max())
               for ta, tb in zip(a, b)
               for x, y in zip(leaves(ta), leaves(tb)))


def phase_lm_train(torch, np, cfg_mod, model, libs, ctx, smi):
    """Qwen1.5-0.5B at full width and depth in bf16 (remat on), trained
    through the launcher's ``build_train_step`` on the data pipeline's
    batches (seed 0) at the warmup-cosine rate, LM_TRAIN_BATCH x 4,096
    tokens a step: LM_TRAIN_STEPS steps (every loss and grad norm finite;
    step times, tokens/s, peak memory and the bf16 share of peak) with an
    async checkpoint after step LM_TRAIN_SAVE_AT; that checkpoint restored
    into fresh params and state and the rest of the steps run again,
    equal bit for bit (else a second resume, and the difference held to
    the spread of the two); every bf16 product of one step walked against
    the plain upcast product (within LM_TRAIN_GRAD_TOL of its largest
    |grad|), and the whole grad tree's difference from a step through the
    plain products (reported: chaotic across 24 bf16 layers); the card
    against the CPU in f32 at LM_TRAIN_CPU. Launches no hand-written
    kernel: ``libs``' counters must not move."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.checkpoint import AsyncCheckpointer, restore
    from repro_torch.data import DataConfig, TokenPipeline, batch_for_step
    from repro_torch.launch import train
    from repro_torch.models import layers, moe
    from repro_torch.tree import leaves

    def counted():
        return {k: n for lib in libs for k, n in lib.launches.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    before = counted()
    cfg = cfg_mod.get_config(LM_TRAIN_ARCH)
    full_batch = cfg_mod.SHAPES["train_4k"].global_batch
    shape = dataclasses.replace(cfg_mod.SHAPES["train_4k"],
                                global_batch=LM_TRAIN_BATCH)
    ocfg = optim.AdamWConfig()
    step_fn = train.build_train_step(cfg, ctx, ocfg)
    products = ((layers.MatmulF32, torch.mm), (moe.BmmF32, torch.bmm))
    secs = {}
    t0 = time.perf_counter()
    params = model.init_params(SEED + 80, cfg, ctx, "cuda")
    opt = optim.init(params, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = tree_bytes(torch, leaves(params))
    state_b = pbytes + tree_bytes(torch, leaves(opt.m) + leaves(opt.v))
    room = check_room("lm_train", 2 * state_b)

    def to_card(host):
        return {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}

    def run(params, opt, start, n, ckpt=None):
        pipe = TokenPipeline(cfg, shape, DataConfig(seed=0),
                             start_step=start)
        losses, gnorms, times = [], [], []
        try:
            for _ in range(n):
                step, host = next(pipe)
                batch = to_card(host)
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt, _, m = step_fn(params, opt, None, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                if ckpt is not None and step + 1 == LM_TRAIN_SAVE_AT:
                    ckpt.save(step + 1, {"params": params, "opt": opt})
        finally:
            pipe.close()
        return params, opt, losses, gnorms, times

    root = tempfile.mkdtemp(prefix="orca-lm-train-")
    try:
        t0 = time.perf_counter()
        ckpt = AsyncCheckpointer(root)
        p_a, o_a, losses, gnorms, times = run(params, opt, 0,
                                              LM_TRAIN_STEPS, ckpt)
        secs["train"] = time.perf_counter() - t0
        peak_train = torch.cuda.max_memory_allocated()

        # every product of one step against its plain version, then the
        # grad tree against a step through the plain products
        t0 = time.perf_counter()
        batch0 = to_card(batch_for_step(cfg, shape, DataConfig(seed=0), 0))
        (_, _, g_fn), walk = product_walk(
            torch, products, LM_TRAIN_GRAD_TOL,
            lambda: train.grads_of(params, batch0, cfg, ctx))
        walk["calls_expected"] = 7 * cfg.num_layers + 1  # and the head
        _, _, g_plain = plain_products(
            torch, products, lambda: train.grads_of(params, batch0, cfg, ctx))
        num = sum(float(((a.float() - b.float()) ** 2).sum())
                  for a, b in zip(leaves(g_fn), leaves(g_plain)))
        den = sum(float((b.float() ** 2).sum()) for b in leaves(g_plain))
        walk["grad_tree_rel_diff_vs_plain_products"] = (num / den) ** 0.5
        secs["products"] = time.perf_counter() - t0
        del g_fn, g_plain, batch0
        ckpt.wait()
        del params, opt
        torch.cuda.empty_cache()

        def resume():
            fresh = model.init_params(SEED + 81, cfg, ctx, "cuda")
            tree, step = restore(root, LM_TRAIN_SAVE_AT, {
                "params": fresh, "opt": optim.init(fresh, ocfg)})
            del fresh
            return run(tree["params"], tree["opt"], step,
                       LM_TRAIN_STEPS - step)

        t0 = time.perf_counter()
        p_b, o_b, losses_b, _, times_b = resume()
        secs["resume"] = time.perf_counter() - t0
        tail = losses[LM_TRAIN_SAVE_AT:]
        first = max(tree_diff(torch, leaves, [p_a, o_a.m, o_a.v],
                              [p_b, o_b.m, o_b.v]),
                    max(abs(a - b) for a, b in zip(tail, losses_b)))
        resumed = {"steps": len(losses_b), "losses": losses_b,
                   "bit_equal": first == 0.0 and int(o_a.step) == int(
                       o_b.step), "max_abs_diff": first}
        if not resumed["bit_equal"]:
            p_c, o_c, losses_c, _, _ = resume()
            resumed["second_losses"] = losses_c
            resumed["spread_of_two_resumes"] = max(
                tree_diff(torch, leaves, [p_b, o_b.m, o_b.v],
                          [p_c, o_c.m, o_c.v]),
                max(abs(a - b) for a, b in zip(losses_b, losses_c)))
            del p_c, o_c
        del p_a, o_a, p_b, o_b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the card against the CPU in f32, full width, LM_TRAIN_CPU
    t0 = time.perf_counter()
    n_layers, b32, s32 = LM_TRAIN_CPU
    c32 = cfg.replace(num_layers=n_layers, dtype="float32")
    sh32 = dataclasses.replace(shape, seq_len=s32, global_batch=b32)
    step32 = train.build_train_step(c32, ctx, ocfg)
    host = batch_for_step(c32, sh32, DataConfig(seed=0), 0)
    p_card = model.init_params(SEED + 82, c32, ctx, "cuda")
    o32 = optim.init(p_card, ocfg)
    res = {}
    for dev in ("cuda", "cpu"):
        p = tree_to(p_card, dev)
        o = optim.OptState(tree_to(o32.m, dev), tree_to(o32.v, dev),
                           torch.ones((), dtype=torch.int32, device=dev))
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, _, grads = train.grads_of(p, b, c32, ctx)
        p2, _, _, m = step32(p, o, None, b)
        res[dev] = (float(loss), float(m["grad_norm"]), float(m["lr"]),
                    grads, p2)
    (l_g, n_g, lr, g_g, p_g), (l_c, n_c, _, g_c, p_c) = (res["cuda"],
                                                          res["cpu"])
    grad_ratio = max(_ratio(torch, a.cpu(), b) for a, b in zip(
        leaves(g_g), leaves(g_c)))
    param_excess = max(
        float((a.cpu() - b).abs().max())
        - (2 * lr + LM_TRAIN_F32_TOL * float(b.abs().max()))
        for a, b in zip(leaves(p_g), leaves(p_c)))
    cpu = {"layers": n_layers, "batch": [b32, s32], "lr": lr,
           "loss": [l_g, l_c], "grad_norm": [n_g, n_c],
           "loss_rel_diff": abs(l_g - l_c) / abs(l_c),
           "grad_norm_rel_diff": abs(n_g - n_c) / abs(n_c),
           "grad_leaf_max_ratio": grad_ratio,
           "param_excess_over_bound": param_excess,
           "tolerance": LM_TRAIN_F32_TOL}
    del res, g_g, g_c, p_g, p_c, p_card, o32
    torch.cuda.empty_cache()
    secs["cpu_f32"] = time.perf_counter() - t0

    after = counted()
    launched = {k: after[k] - before[k] for k in after}
    tokens = shape.tokens
    med = statistics.median(times[1:])
    flops = cfg_mod.model_flops(cfg, shape)
    out = {"phase": "lm_train", "nvidia_smi": smi, "arch": LM_TRAIN_ARCH,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": (cfg.num_heads, cfg.num_kv_heads), "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
           "param_count": cfg_mod.param_count(cfg),
           "params_gb": pbytes / 1e9, "state_gb": state_b / 1e9,
           "init_s": init_s, "allocated_gb_at_start": start_gb,
           "shape": {"seq_len": shape.seq_len,
                     "global_batch": shape.global_batch,
                     "global_batch_cut_from": full_batch},
           "tokens_per_step": tokens, "losses": losses,
           "grad_norms": gnorms, "step_s": times,
           "step_s_median_2_on": med, "tokens_per_s": tokens / med,
           "model_flops_per_step": flops,
           "bf16_share_of_peak": flops / med / PEAK_FLOPS["bfloat16"],
           "peak_gb_train": peak_train / 1e9,
           "peak_gb_phase": torch.cuda.max_memory_allocated() / 1e9,
           "resume": {**resumed, "step_s": times_b},
           "products": walk, "cpu_f32": cpu, "room": room,
           "hand_written_launches": launched, "seconds": secs}
    emit(out)
    failed = None
    if not np.isfinite(losses + gnorms + losses_b).all():
        failed = f"non-finite loss or grad norm: {losses}, {gnorms}"
    elif not resumed["bit_equal"] and not (
            first <= resumed["spread_of_two_resumes"]):
        failed = f"resume differs: {resumed}"
    elif walk["calls_checked"] != walk["calls_expected"] \
            or walk["outside_tolerance"]:
        failed = f"product walk {walk}"
    elif cpu["loss_rel_diff"] > LM_TRAIN_F32_TOL \
            or cpu["grad_norm_rel_diff"] > LM_TRAIN_F32_TOL \
            or grad_ratio > LM_TRAIN_F32_TOL or param_excess > 0:
        failed = f"card against CPU {cpu}"
    elif any(launched.values()):
        failed = f"hand-written kernels launched: {launched}"
    if failed:
        raise AssertionError(f"lm_train: {failed}")


# ---------------------------------------------------------------------------
# Multi-rank phases: ranks that share the one card, as spawned processes
# ---------------------------------------------------------------------------

def _digest(torch, tree):
    """A weighted int64 checksum a leaf of a tree of tensors (its bits read
    as int16 words): a cheap cross-rank equality check after each step;
    the final params are compared whole."""
    from repro_torch.tree import leaves

    out = []
    for x in leaves(tree):
        w = x.detach().reshape(-1).contiguous().view(torch.int16).to(
            torch.int64)
        k = torch.arange(w.numel(), device=w.device, dtype=torch.int64)
        out.append(int(((w + 40_000) * (k % 65_521 + 1)).sum()))
    return out


def _named_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict of tensors, in sorted key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def tx_spmd_rank(rank, world, spec):
    """One replica of the full-width chain on this rank: the tx_serve
    phase's stream of ``spec["steps"]`` commit batches at budget BATCH
    (clients retry DEFERRED, MALFORMED masked out) through
    ``chain_commit_spmd`` under ``auto`` (``commit``, one launch a batch),
    timed; then the same batches through ``chain_commit_local`` on a
    whole chain (the twin), and this rank's replica and every step's
    decision held against it bit for bit."""
    import torch

    from repro_torch.core import transaction as tx
    from repro_torch.kernels import tx_commit as tc
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import collectives as coll

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    mesh = lmesh.make_test_mesh((world,), ("data",))
    cfg = tx.TxConfig(**spec["shape"])
    steps, budget = spec["steps"], spec["budget"]
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    stream, bad = tx_stream(torch, cfg, steps * budget + 8 * budget, g,
                            device=dev)
    rep = tx.make_replica(cfg, dev)
    # each ppermute this rank receives, timed by its role in
    # chain_commit_spmd: a forward hop sends the batch (2-D) then its
    # proceed (1-D, down the chain), an ACK hop the ack (1-D, up it)
    hops = {"batch": [], "proceed": [], "ack": []}
    plain = coll.ppermute

    def timed(x, mesh_, axis, perm):
        sync()
        t = time.perf_counter()
        y = plain(x, mesh_, axis, perm)
        sync()
        me = mesh_.coord(axis)
        for s, d in perm:
            if d == me:
                role = "batch" if x.dim() == 2 else \
                    "proceed" if d > s else "ack"
                hops[role].append(time.perf_counter() - t)
        return y

    coll.ppermute = timed
    retry = torch.zeros((0,), dtype=torch.int64, device=dev)
    fresh, step_s, sent, acks, deferred = 0, [], [], [], []
    sync()
    tc.reset_launches()
    coll.reset_stats()
    try:
        for _ in range(steps):
            n_new = budget - retry.shape[0]
            ids = torch.cat([retry, torch.arange(fresh, fresh + n_new,
                                                 device=dev)])
            fresh += n_new
            sync()
            t = time.perf_counter()
            rep, ack, dfr = tx.chain_commit_spmd(
                rep, stream[ids], cfg, mesh, "data", ~bad[ids],
                kernel_backend="auto")
            sync()
            step_s.append(time.perf_counter() - t)
            retry = ids[dfr]
            sent.append(ids)
            acks.append(ack)
            deferred.append(dfr)
    finally:
        coll.ppermute = plain
    launches = dict(tc.launches)
    wire = dict(coll.stats)

    # the twin: the whole chain, one commit_chain launch a batch
    chain = tx.make_chain(cfg, dev)
    same_steps = True
    for ids, ack, dfr in zip(sent, acks, deferred):
        chain, p, d = tx.chain_commit_local(chain, stream[ids], cfg,
                                            ~bad[ids], kernel_backend="auto")
        same_steps &= torch.equal(d, dfr)
        if rank == 0:  # the ACK of the tail's proceed reaches the head
            same_steps &= torch.equal(p, ack)
        else:
            same_steps &= not bool(ack.any())
    sync()
    twin_launches = {k: v - launches.get(k, 0) for k, v in tc.launches.items()}
    fields = ("store", "log", "log_tail", "committed", "live")
    same = {f: bool(torch.equal(getattr(rep, f), getattr(chain, f)[rank]))
            for f in fields}
    all_ids = torch.cat(sent)
    committed = int(rep.committed)
    if len(hops["batch"]) != len(hops["proceed"]):
        raise AssertionError("tx_spmd: a forward hop without its proceed")
    out = {"rank": rank, "step_s": step_s, "hops": hops, "launches": launches,
           "twin_launches": twin_launches, "wire": wire,
           "same_as_twin": same, "same_decisions": bool(same_steps),
           "committed": committed,
           "deferred": int(sum(int(d.sum()) for d in deferred)),
           "malformed": int(bad[all_ids].sum()),
           "replica_bytes": sum(x.numel() * x.element_size() for x in rep),
           "backend": mesh.backend}
    if dev == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_tx_spmd(torch, coll, smi, spec=None):
    """The SPMD chain at TX_SHAPE on ranks that share the card: one
    replica (1.22 GB) a rank, 3 ranks for the chain of 3, the gloo backend
    (NCCL refuses two ranks on one device), CUDA tensors staged through
    page-locked host buffers by the collectives."""
    spec = spec or {"device": "cuda", "shape": TX_SHAPE, "steps": STEPS,
                    "budget": BATCH}
    world = spec["shape"]["chain_len"]
    t0 = time.perf_counter()
    ranks = coll.launch(tx_spmd_rank, world, backend=RANK_BACKEND,
                        args=(spec,), timeout=RANK_TIMEOUT)
    secs = time.perf_counter() - t0
    head = ranks[0]
    # a forward hop is its batch and its proceed, as the receiver waits
    # for them (the sender's work before the send included)
    role = {k: [h for r in ranks for h in r["hops"][k]]
            for k in ("batch", "proceed", "ack")}
    fwd = [b + p for r in ranks
           for b, p in zip(r["hops"]["batch"], r["hops"]["proceed"])]
    out = {"phase": "tx_spmd", "nvidia_smi": smi, "ranks": world,
           "backend": head["backend"],
           "transport": "gloo over loopback TCP; CUDA tensors staged "
                        "through page-locked host buffers (ranks share "
                        "one card)",
           "shape": spec["shape"], "steps": spec["steps"],
           "budget": spec["budget"], "seconds": secs,
           "step_ms_median": statistics.median(head["step_s"]) * 1e3,
           "step_ms_p99": sorted(head["step_s"])[
               int(0.99 * (len(head["step_s"]) - 1))] * 1e3,
           "forward_hop_ms_median": statistics.median(fwd) * 1e3,
           "hop_batch_ms_median": statistics.median(role["batch"]) * 1e3,
           "hop_proceed_ms_median":
               statistics.median(role["proceed"]) * 1e3,
           "ack_hop_ms_median": statistics.median(role["ack"]) * 1e3,
           "hops_timed": {k: len(v) for k, v in role.items()},
           "commits": head["committed"], "deferred": head["deferred"],
           "malformed": head["malformed"],
           "commits_per_s_steps": head["committed"] / sum(head["step_s"]),
           "wire_bytes_per_step": sum(r["wire"]["bytes"] for r in ranks)
           / spec["steps"],
           "collective_calls_per_step": sum(r["wire"]["calls"]
                                            for r in ranks) / spec["steps"],
           "replica_bytes": head["replica_bytes"],
           "launches_by_rank": [r["launches"] for r in ranks],
           "twin_launches_by_rank": [r["twin_launches"] for r in ranks],
           "same_as_twin": [r["same_as_twin"] for r in ranks],
           "same_decisions": [r["same_decisions"] for r in ranks],
           "peak_gb_by_rank": [r.get("peak_gb") for r in ranks]}
    emit(out)
    bad = [r["rank"] for r in ranks
           if r["launches"].get("commit") != spec["steps"]
           or r["launches"].get("commit_chain")
           or not all(r["same_as_twin"].values())
           or not r["same_decisions"]]
    if bad or not head["committed"]:
        raise AssertionError(f"tx_spmd: ranks {bad} differ from the twin "
                             "or launched other than one commit a batch")
    return out


def zero1_rank(rank, world, spec):
    """ZeRO-1 data-parallel training on this rank: the launcher's
    ``build_train_step`` under a (world, 1) ("data", "model") mesh, each
    rank its rows of the global batch, its block of (m, v); the params'
    checksums after each step, the final params against the other rank's
    whole and against the single-process step's (``spec["ref"]``); then
    the whole moments gathered, rank 0 saves, and a one-rank
    ``elastic.resume`` restores params and optimizer state bit-equal."""
    import torch

    from repro_torch import optim
    from repro_torch.checkpoint import checkpointer, elastic
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import Mesh, param_specs
    from repro_torch.tree import leaves, tree_map

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    cfg = spec["cfg"]
    shape = spec["shape"]
    mesh = lmesh.make_test_mesh((world, 1), ("data", "model"))
    ctx = lmesh.make_context(mesh, cfg)
    ocfg = optim.AdamWConfig()
    params = model.init_params(spec["seed"], cfg, ctx, dev)
    opt = optim.zero1_init(params, ocfg, ctx)
    step_fn = train.build_train_step(cfg, ctx, ocfg)
    losses, gnorms, lrs, step_s, wire, digests = [], [], [], [], [], []
    for s in range(spec["steps"]):
        host = batch_for_step(cfg, shape, DataConfig(seed=0), s)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        coll.reset_stats()
        sync()
        t = time.perf_counter()
        params, opt, _, m = step_fn(params, opt, None, batch)
        sync()
        step_s.append(time.perf_counter() - t)
        wire.append(dict(coll.stats))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        digests.append(_digest(torch, params))
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else None
    # the data-parallel MoE check on this launch's mesh
    dp_moe = dp_moe_rank(torch, mesh, spec["dp_moe"], dev)

    # the final params whole against rank 1's (rank 0 compares)
    equal_ranks = True
    for x in leaves(params):
        other = coll.ppermute(x, mesh, "data", [(1, 0)])
        if rank == 0:
            equal_ranks &= torch.equal(x, other)
    whole = optim.zero1_gather(opt, params, ctx)
    out = {"rank": rank, "losses": losses, "grad_norms": gnorms,
           "step_s": step_s, "wire": wire, "digests": digests,
           "peak_gb": peak, "backend": mesh.backend, "dp_moe": dp_moe,
           "params_equal_rank1": bool(equal_ranks) if rank == 0 else None}
    if rank != 0:
        return out

    # against the single-process step: the first moment's max |diff| over
    # each leaf's largest |value|; the params within ZERO1_TOL of scale
    # plus 2 x the summed rate (Adam moves an element by up to the rate,
    # in a direction that rounding decides where the gradient is near
    # zero: lm_train's bound); the cosine of the params' change from step
    # 0 with the single step's (a skipped update gives 0)
    ref = torch.load(spec["ref"], map_location="cpu")
    m_rel, excess = {}, -float("inf")
    for (name, a), b in zip(_named_leaves(whole.m), leaves(ref["m"])):
        b = b.to(dev).float()
        m_rel[name] = float((a.float() - b).abs().max()) / (
            float(b.abs().max()) or 1.0)
    dot = dict.fromkeys(("rs", "rr", "ss", "dd"), 0.0)
    for a, p0, b in zip(leaves(params), leaves(ref["p0"]),
                        leaves(ref["params"])):
        p0, b = p0.to(dev).float(), b.to(dev).float()
        excess = max(excess, float((a.float() - b).abs().max())
                     - (2 * sum(lrs) + ZERO1_TOL * float(b.abs().max())))
        dr, ds = a.float() - p0, b - p0
        dot["rs"] += float(torch.sum(dr * ds, dtype=torch.float64))
        dot["rr"] += float(torch.sum(dr * dr, dtype=torch.float64))
        dot["ss"] += float(torch.sum(ds * ds, dtype=torch.float64))
        dot["dd"] += float(torch.sum(torch.square(dr - ds),
                                     dtype=torch.float64))
    out["m_rel_diff_vs_single"] = dict(sorted(
        m_rel.items(), key=lambda kv: -kv[1])[:4])
    out["param_excess_over_bound"] = excess
    out["delta_cos_vs_single"] = dot["rs"] / (
        (dot["rr"] * dot["ss"]) ** 0.5) if dot["rr"] * dot["ss"] else 0.0
    # printed beside tp_train's: the distance of a change whose update
    # the half-batch reference holds, from the single run's
    out["delta_rel_diff_vs_single"] = (dot["dd"] / dot["ss"]) ** 0.5 \
        if dot["ss"] else float("inf")
    out["lrs"] = lrs
    del ref

    # rank 0 saves the full logical arrays; one rank resumes them
    t = time.perf_counter()
    state = {"params": params, "opt": whole}
    checkpointer.save(spec["ckpt"], spec["steps"], state)
    out["save_s"] = time.perf_counter() - t
    one = lmesh.make_context(Mesh((1, 1), ("data", "model")), cfg)
    abstract = model.abstract_params(cfg, one)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    like_opt = optim.OptState(tree_map(f32, abstract), tree_map(f32, abstract),
                              torch.empty((), dtype=torch.int32,
                                          device="meta"))
    pspecs = param_specs(abstract, one)
    t = time.perf_counter()
    back, step = elastic.resume(
        spec["ckpt"], {"params": abstract, "opt": like_opt}, one,
        specs={"params": pspecs,
               "opt": optim.state_specs(pspecs, abstract, one)},
        device=dev)
    sync()
    out["resume_s"] = time.perf_counter() - t
    pairs = list(zip(leaves(state["params"]), leaves(back["params"])))
    for a_t, b_t in ((whole.m, back["opt"].m), (whole.v, back["opt"].v)):
        pairs += list(zip(leaves(a_t), leaves(b_t)))
    out["resume_step"] = step
    out["resume_bit_equal"] = bool(
        all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        and int(back["opt"].step) == int(whole.step))
    out["checkpoint_bytes"] = sum(a.numel() * a.element_size()
                                  for a, _ in pairs)
    del back, state, whole
    return out


def dp_moe_rank(torch, mesh, spec, dev):
    """The data-parallel MoE check on this rank of a (dp, 1) mesh: the
    f32 gradient of ``spec["cfg"]``'s seeded params on this rank's rows
    of the global batch (GSPMD ``moe_apply``: the whole batch's
    capacity, dispatch positions and router statistics), weighted by the
    rows' share and summed over the data axis, this rank keeping its
    block of every leaf along dim 0 (a reduce-scatter); then the
    one-process gradient of the whole batch, against which that block is
    held (max |diff| over the leaf's largest |grad|). The routers' loads
    on both sides (``_recording_loads``) for the drop counts."""
    import gc

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import model, moe, postprocess_grads
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context

    def sync():
        _sync(torch, dev)

    t_all = time.perf_counter()
    cfg = spec["cfg"]
    ctx = lmesh.make_context(mesh, cfg)
    params = model.init_params(spec["seed"], cfg, ctx, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in spec["batch"].items()}
    local = train.local_batch(batch, ctx)
    share = local["labels"].numel() / batch["labels"].numel()
    rows = local["labels"].numel()
    out = {"loads": [], "one_process_loads": []}
    route = _recording_loads(moe, out["loads"], min_rows=rows)
    try:
        sync()
        t = time.perf_counter()
        loss, metrics, grads = train.grads_of(params, local, cfg, ctx)
        grads = postprocess_grads(grads, cfg, ctx)
        sync()
        out["grad_s"] = time.perf_counter() - t
    finally:
        moe._route_raw = route
    coll.reset_stats()
    t = time.perf_counter()
    blocks = [(name, coll.psum_scatter(g.float() * share, mesh, "data", 0))
              for name, g in _named_leaves(grads)]
    del grads
    sync()
    out["reduce_s"] = time.perf_counter() - t
    out["wire"] = dict(coll.stats)
    out["loss"] = float(coll.psum(loss.float() * share, mesh, "data"))
    out["aux"] = float(metrics["aux"])
    one = local_context()
    route = _recording_loads(moe, out["one_process_loads"], min_rows=rows)
    try:
        sync()
        t = time.perf_counter()
        loss, metrics, ref = train.grads_of(params, batch, cfg, one)
        ref = postprocess_grads(ref, cfg, one)
        sync()
        out["one_process_grad_s"] = time.perf_counter() - t
    finally:
        moe._route_raw = route
    del params
    out["one_process_loss"] = float(loss)
    out["one_process_aux"] = float(metrics["aux"])
    r = coll.data_rank(ctx)
    rel = {}
    for (name, blk), (_, w) in zip(blocks, _named_leaves(ref)):
        k = blk.shape[0]
        rel[name] = float((blk - w.narrow(0, r * k, k).float()).abs().max()
                          ) / (float(w.abs().max()) or 1.0)
    worst = max(rel, key=rel.get)
    out["leaves"] = len(rel)
    out["worst"] = {"leaf": worst, "rel": rel[worst]}
    del blocks, ref
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    return out


def dp_moe_summary(np, moe, spec, ranks, smi):
    """The line of the data-parallel MoE check (:func:`dp_moe_rank` on
    each rank) and why it fails (None: it passes). The ranks' drops are
    the whole batch's: each call's tokens and per-expert loads summed
    over the ranks, past ``moe._capacity`` of those tokens."""
    cfg = spec["cfg"]
    parts = [r["dp_moe"] for r in ranks]
    calls = [(sum(t for t, _ in c), sum(n for _, n in c))
             for c in zip(*(p["loads"] for p in parts))]
    drops = {"ranks": moe_drops(np, moe, cfg, calls),
             "one_process": moe_drops(np, moe, cfg,
                                      parts[0]["one_process_loads"])}
    one = parts[0]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    out = {"phase": "dp_moe_train", "nvidia_smi": smi, "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "capacity_factor": cfg.capacity_factor,
           "mesh": [len(ranks), 1], "dispatch": "GSPMD moe_apply",
           "global_batch": list(spec["batch"]["tokens"].shape),
           "in": "zero1_train's launch",
           "loss_by_rank": [p["loss"] for p in parts],
           "one_process_loss": one["one_process_loss"],
           "loss_rel_diff": max(rel(p["loss"], p["one_process_loss"])
                                for p in parts),
           "aux_rel_diff": max(rel(p["aux"], p["one_process_aux"])
                               for p in parts),
           "worst_by_rank": [p["worst"] for p in parts],
           "leaves": one["leaves"], "tolerance": DP_MOE_GRAD_TOL,
           "loss_tolerance": DP_MOE_LOSS_TOL,
           "grad_s_by_rank": [p["grad_s"] for p in parts],
           "reduce_s_by_rank": [p["reduce_s"] for p in parts],
           "one_process_grad_s_by_rank": [p["one_process_grad_s"]
                                          for p in parts],
           "wire_by_rank": [p["wire"] for p in parts], "drops": drops,
           "seconds_by_rank": [p["seconds"] for p in parts]}
    why = []
    if max(out["loss_rel_diff"], out["aux_rel_diff"]) > DP_MOE_LOSS_TOL:
        why.append("the loss or aux is not the one-process step's")
    if max(w["rel"] for w in out["worst_by_rank"]) > DP_MOE_GRAD_TOL:
        why.append("a gradient leaf is outside tolerance")
    if not (drops["ranks"]["dropped"] == drops["one_process"]["dropped"] > 0
            and drops["ranks"]["assignments"]
            == drops["one_process"]["assignments"]):
        why.append(f"the drops differ or are none ({drops})")
    return out, "; ".join(why) or None


def zero1_half_reference(torch, cfg, ocfg, spec, batches, p0, norms,
                         single_m):
    """The ranks' arithmetic in this process, from the step-0 params
    ``p0``: each rank's rows of the global batch (``local_batch`` under
    each rank's coordinate), their bf16 gradient scaled by the rows'
    share, the ranks' gradients summed in f32 in rank order, one
    single-device AdamW update of the sum, clipped by the ranks' global
    norm of the step (``norms``: their sum runs blocks first, then ranks;
    this process's own norm is reported beside them). Then the ranks'
    checkpoint (``spec["ckpt"]``: rank 0's params and whole moments after
    the last step) held against it. Returns the comparison."""
    from repro_torch import optim
    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch import train
    from repro_torch.models import postprocess_grads
    from repro_torch.optim import warmup_cosine
    from repro_torch.parallel.sharding import Mesh, ParallelContext, \
        local_context
    from repro_torch.tree import leaves, tree_map

    dev = spec["device"]
    ctx = local_context()
    rank_ctx = [ParallelContext(mesh=Mesh((ZERO1_RANKS, 1),
                                          ("data", "model"), rank=r))
                for r in range(ZERO1_RANKS)]
    params = tree_map(lambda x: x.to(dev, copy=True), p0)
    opt = optim.init(params, ocfg)
    losses, own = [], []
    for batch, norm in zip(batches, norms):
        total, loss = None, 0.0
        for rc in rank_ctx:
            local = train.local_batch(batch, rc)
            share = local["labels"].numel() / batch["labels"].numel()
            l_r, _, g = train.grads_of(params, local, cfg, ctx)
            g = tree_map(lambda x: x.float() * share,
                         postprocess_grads(g, cfg, ctx))
            total = g if total is None else tree_map(torch.add, total, g)
            loss = loss + l_r.float() * share
            del g
        own.append(float(optim.global_norm(total)))
        params, opt, _ = optim.update(
            total, opt, params, warmup_cosine(opt.step), ocfg,
            gnorm=torch.tensor(norm, dtype=torch.float32, device=dev))
        losses.append(float(loss))
        del total
    got, _ = checkpointer.restore(
        spec["ckpt"], spec["steps"], {"params": params, "opt": opt})
    rel = lambda a, b: float((a.float() - b.float()).abs().max()) / (  # noqa: E731
        float(b.float().abs().max()) or 1.0)
    out = {"losses": losses, "grad_norms_own": own,
           "m_rel_diff_vs_single": max(
               rel(a, b.to(dev)) for a, b in zip(leaves(opt.m),
                                                 leaves(single_m))),
           "m_rel_diff": max(rel(a, b) for a, b in
                             zip(leaves(got["opt"].m), leaves(opt.m))),
           "v_rel_diff": max(rel(a, b) for a, b in
                             zip(leaves(got["opt"].v), leaves(opt.v)))}
    num = den = 0.0
    moved = differ = 0
    for a, b, z in zip(leaves(got["params"]), leaves(params), leaves(p0)):
        z = z.to(dev).float()
        dr, dh = a.float() - z, b.float() - z
        num += float(torch.sum(torch.square(dr - dh), dtype=torch.float64))
        den += float(torch.sum(torch.square(dh), dtype=torch.float64))
        moved += int(torch.count_nonzero(dr))
        differ += int(torch.count_nonzero(a != b))
    out.update(
        delta_rel_diff=(num / den) ** 0.5 if den else float("inf"),
        moved_elements=moved, params_differing=differ,
        param_elements=sum(a.numel() for a in leaves(params)),
        bit_equal=bool(differ == 0 and all(
            torch.equal(a, b) for a, b in
            zip(leaves(got["opt"].m) + leaves(got["opt"].v),
                leaves(opt.m) + leaves(opt.v)))))
    return out


def phase_zero1_train(torch, np, cfg_mod, model, coll, smi, spec=None,
                      keep=None):
    """Qwen1.5-0.5B at full width and depth, bf16 with remat, train_4k's
    4,096 tokens, a global batch of ZERO1_BATCH over ZERO1_RANKS data
    ranks that share the card (gloo, host-staged): ZERO1_STEPS steps.
    First the single-process step on the same global batches (its params
    and first moment, and the step-0 params, kept on the host for the
    ranks), freed before the ranks start; after the ranks, the half-batch
    reference (:func:`zero1_half_reference`) against their checkpoint.
    With ``keep`` (a dict) the single-process run's files stay on disk
    and ``keep`` gets its spec, results and directory (``root``: the
    caller removes it): tp_train reuses them. The same ranks then run the
    data-parallel MoE check (``spec["dp_moe"]``, DP_MOE_TRAIN by
    default; :func:`dp_moe_rank`), printed as its own line,
    ``dp_moe_train``."""
    import dataclasses
    import gc

    from repro_torch import optim
    from repro_torch.models import moe
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train
    from repro_torch.parallel.sharding import local_context
    from repro_torch.tree import leaves, tree_map

    root = tempfile.mkdtemp(prefix="orca-zero1-")
    spec = dict(spec or {"device": "cuda", "steps": ZERO1_STEPS,
                         "cfg": cfg_mod.get_config(LM_TRAIN_ARCH)})
    dev = spec["device"]
    cfg = spec["cfg"]
    spec["shape"] = spec.get("shape") or dataclasses.replace(
        cfg_mod.SHAPES["train_4k"], global_batch=ZERO1_BATCH)
    spec.update(seed=SEED + 83, ref=os.path.join(root, "single.pt"),
                ckpt=os.path.join(root, "ckpt"))
    if "dp_moe" not in spec:
        layers, rows, tokens = DP_MOE_TRAIN
        mcfg = cfg_mod.get_config(LM_MOE_ARCH).replace(
            num_layers=layers, dtype="float32", remat=False)
        rng = np.random.default_rng(SEED + 101)
        toks = rng.integers(1, mcfg.vocab_size, (rows, tokens)).astype(
            np.int32)
        spec["dp_moe"] = {"cfg": mcfg, "seed": SEED + 100,
                          "batch": {"tokens": toks,
                                    "labels": np.roll(toks, -1, axis=1)}}
    try:
        if dev == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.cuda.reset_peak_memory_stats()
        ctx = local_context()
        ocfg = optim.AdamWConfig()
        params = model.init_params(spec["seed"], cfg, ctx, dev)
        pbytes = tree_bytes(torch, leaves(params))
        # on disk: the reference (bf16 params at step 0 and after the
        # single steps, f32 m: 4 x pbytes) and the checkpoint (params,
        # f32 m and v: 5 x pbytes)
        room = check_room("zero1_train", 9 * pbytes)
        host_copy = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
        p0 = tree_map(host_copy, params)
        opt = optim.init(params, ocfg)
        step_fn = train.build_train_step(cfg, ctx, ocfg)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    batch_for_step(cfg, spec["shape"], DataConfig(seed=0),
                                   s).items()}
                   for s in range(spec["steps"])]
        single = {"losses": [], "grad_norms": [], "step_s": []}
        for batch in batches:
            if dev == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, _, m = step_fn(params, opt, None, batch)
            single["losses"].append(float(m["loss"]))
            single["grad_norms"].append(float(m["grad_norm"]))
            single["step_s"].append(time.perf_counter() - t)
        if dev == "cuda":
            single["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        single_m = tree_map(host_copy, opt.m)
        torch.save({"p0": p0, "params": tree_map(host_copy, params),
                    "m": single_m}, spec["ref"])
        del params, opt, batch, m
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = coll.launch(zero1_rank, ZERO1_RANKS, backend=RANK_BACKEND,
                            args=(spec,), timeout=RANK_TIMEOUT)
        secs = time.perf_counter() - t0
        t = time.perf_counter()
        half = zero1_half_reference(torch, cfg, ocfg, spec, batches, p0,
                                    ranks[0]["grad_norms"], single_m)
        half["s"] = time.perf_counter() - t
        del batches, p0, single_m
        if keep is not None:
            keep.update(spec=spec, single=single, root=root)
    finally:
        if keep is None or "root" not in keep:
            shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    tokens = spec["shape"].tokens
    med = statistics.median(r0["step_s"][1:] or r0["step_s"])
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in
                   zip(r["losses"], single["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in
                    zip(r["grad_norms"], single["grad_norms"]))
    loss_half = max(abs(a - b) / abs(b) for r in ranks for a, b in
                    zip(r["losses"], half["losses"]))
    gnorm_half = max(abs(a - b) / abs(b) for r in ranks for a, b in
                     zip(r["grad_norms"], half["grad_norms_own"]))
    out = {"phase": "zero1_train", "nvidia_smi": smi, "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "remat": cfg.remat,
           "ranks": ZERO1_RANKS, "backend": r0["backend"],
           "transport": "gloo over loopback TCP; CUDA tensors staged "
                        "through page-locked host buffers (ranks share "
                        "one card)",
           "seq_len": spec["shape"].seq_len,
           "global_batch": spec["shape"].global_batch, "steps": spec["steps"],
           "room": room, "seconds_ranks": secs, "single": single,
           "losses_by_rank": [r["losses"] for r in ranks],
           "grad_norms_by_rank": [r["grad_norms"] for r in ranks],
           "loss_rel_diff_vs_single": loss_rel,
           "grad_norm_rel_diff_vs_single": gnorm_rel,
           "m_rel_diff_vs_single": r0["m_rel_diff_vs_single"],
           "param_excess_over_bound": r0["param_excess_over_bound"],
           "delta_cos_vs_single": r0["delta_cos_vs_single"],
           "delta_rel_diff_vs_single": r0["delta_rel_diff_vs_single"],
           "half": half,
           "loss_rel_diff_vs_half": loss_half,
           "grad_norm_rel_diff_vs_half": gnorm_half,
           "lrs": r0["lrs"], "tolerance": ZERO1_TOL,
           "m_tolerance": ZERO1_M_TOL, "half_tolerance": ZERO1_HALF_TOL,
           "delta_tolerance": ZERO1_DELTA_TOL,
           "delta_cos_min": ZERO1_DELTA_COS,
           "step_s_by_rank": [r["step_s"] for r in ranks],
           "step_s_median_2_on": med, "tokens_per_step": tokens,
           "tokens_per_s": tokens / med,
           "wire_bytes_per_step": [sum(r["wire"][s]["bytes"] for r in ranks)
                                   for s in range(spec["steps"])],
           "collective_calls_per_step": [
               sum(r["wire"][s]["calls"] for r in ranks)
               for s in range(spec["steps"])],
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
           "digests_equal_each_step": all(
               r["digests"] == r0["digests"] for r in ranks),
           "params_equal_across_ranks": r0["params_equal_rank1"],
           "checkpoint_bytes": r0["checkpoint_bytes"],
           "save_s": r0["save_s"], "resume_s": r0["resume_s"],
           "resume_step": r0["resume_step"],
           "resume_bit_equal": r0["resume_bit_equal"]}
    emit(out)
    failed = None
    if not np.isfinite([x for r in ranks for x in r["losses"]
                        + r["grad_norms"]]).all():
        failed = "non-finite losses or grad norms"
    elif not (out["digests_equal_each_step"]
              and out["params_equal_across_ranks"]):
        failed = "the ranks' params differ"
    elif max(loss_rel, gnorm_rel) > ZERO1_TOL \
            or max(r0["m_rel_diff_vs_single"].values()) > ZERO1_M_TOL \
            or r0["param_excess_over_bound"] > 0 \
            or not r0["delta_cos_vs_single"] >= ZERO1_DELTA_COS:
        failed = "outside the tolerance of the single-process step"
    elif not (max(loss_half, gnorm_half, half["m_rel_diff"],
                  half["v_rel_diff"]) <= ZERO1_HALF_TOL
              and half["delta_rel_diff"] <= ZERO1_DELTA_TOL
              and half["moved_elements"] > 0):
        failed = "outside the tolerance of the half-batch reference"
    elif not (r0["resume_bit_equal"] and r0["resume_step"] == spec["steps"]):
        failed = "the one-rank resume is not bit-equal"
    dp, dp_failed = dp_moe_summary(np, moe, spec["dp_moe"], ranks, smi)
    emit(dp)
    if failed or dp_failed:
        raise AssertionError("; ".join(
            f"{name}: {why}" for name, why in (("zero1_train", failed),
                                               ("dp_moe_train", dp_failed))
            if why))
    return out


# ---------------------------------------------------------------------------
# Training under Megatron tensor parallelism: model ranks sharing the card
# ---------------------------------------------------------------------------

def _model_blocks(tree, ctx):
    """This rank's model blocks of a whole params-shaped tree (views)."""
    from repro_torch.parallel.sharding import param_specs, shard_block
    from repro_torch.tree import tree_map

    return tree_map(lambda x, sp: shard_block(x, sp, ctx.mesh), tree,
                    param_specs(tree, ctx))


def _replicated(tree, ctx):
    """The leaves of a params-shaped tree that every model rank holds
    whole, by name."""
    from repro_torch.optim.adamw import model_split

    split = dict(_named_leaves(model_split(tree, ctx)))
    return [(k, x) for k, x in _named_leaves(tree) if not split[k]]


def tp_grad_check(torch, rank_grads, ref_path, scales, ctx):
    """Each leaf of this rank's gradient blocks against its block of the
    one-process gradient (``ref_path``, mapped: only the blocks are
    read): max |diff| over the whole leaf's largest |value| (``scales``,
    by leaf). Returns ({leaf: rel}, the worst leaf)."""
    ref = torch.load(ref_path, map_location="cpu", mmap=True)
    want = _model_blocks(ref, ctx)
    rel = {}
    for (k, g), (_, w) in zip(_named_leaves(rank_grads),
                              _named_leaves(want)):
        rel[k] = float((g.float() - w.to(g.device).float()).abs().max()) \
            / (scales[k] or 1.0)
    worst = max(rel, key=rel.get)
    return rel, {"leaf": worst, "rel": rel[worst]}


def tp_train_rank(rank, world, spec):
    """This rank of a (1, world) ("data", "model") mesh on the card: the
    launcher's ``build_train_step`` on its blocks of zero1_train's seeded
    params and global batches (bf16, remat), held against the
    single-process run's checkpoint (``spec["ref"]``: the step-0 params
    and the params after the steps) and against its own replay (one-device
    AdamW of its blocks on the gradients the steps took); then the f32
    gradient checks, each against a one-process gradient on the card
    (``spec["grads"]``)."""
    import gc

    import torch

    from repro_torch import optim
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import model, moe, postprocess_grads
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import param_blocks
    from repro_torch.tree import leaves, tree_map

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    mesh = lmesh.make_test_mesh((1, world), ("data", "model"))
    cfg, shape = spec["cfg"], spec["shape"]
    ctx = lmesh.make_context(mesh, cfg)
    out = {"rank": rank, "backend": mesh.backend}
    params = param_blocks(model.init_params(spec["seed"], cfg, ctx, dev),
                          ctx)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    p0 = tree_map(lambda x: x.detach().to("cpu", copy=True), params)
    ref = torch.load(spec["ref"], map_location="cpu", mmap=True)
    ocfg = optim.AdamWConfig()
    opt = optim.zero1_init(params, ocfg, ctx)
    step_fn = train.build_train_step(cfg, ctx, ocfg)
    # the replay: one-device AdamW (optim.update) of this rank's blocks,
    # from the step-0 blocks, on the gradient blocks each step took (read
    # off its zero1_update call), clipped by the ranks' norm; and that
    # norm summed afresh in f64 (a leaf whose block is smaller than the
    # single run's whole leaf is split: its squares summed over the ranks)
    seen, real_update = {}, train.zero1_update

    def recording(grads, *a, **k):
        res = real_update(grads, *a, **k)
        seen.update(grads=grads, norm=res[3]["grad_norm"])
        return res

    split = [tuple(x.shape) != tuple(w.shape)
             for x, w in zip(leaves(params), leaves(ref["p0"]))]
    rp = tree_map(lambda x: x.detach().clone(), params)
    ropt = optim.init(rp, ocfg)
    own_norms = []
    losses, gnorms, lrs, step_s, wire, digests = [], [], [], [], [], []
    train.zero1_update = recording
    try:
        for s in range(spec["steps"]):
            host = batch_for_step(cfg, shape, DataConfig(seed=0), s)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            coll.reset_stats()
            sync()
            t = time.perf_counter()
            params, opt, _, m = step_fn(params, opt, None, batch)
            sync()
            step_s.append(time.perf_counter() - t)
            wire.append(dict(coll.stats))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
            digests.append(_digest(torch, dict(_replicated(params, ctx))))
            g = seen.pop("grads")
            sq = [0.0, 0.0]
            for x, sp in zip(leaves(g), split):
                sq[sp] += float(torch.sum(torch.square(x.double())))
            sq[1] = float(coll.all_gather(torch.tensor(
                [sq[1]], dtype=torch.float64, device=dev), mesh,
                "model").sum())
            own_norms.append((sq[0] + sq[1]) ** 0.5)
            rp, ropt, _ = optim.update(g, ropt, rp, m["lr"], ocfg,
                                       gnorm=seen.pop("norm"))
            del g
    finally:
        train.zero1_update = real_update
    out.update(losses=losses, grad_norms=gnorms, lrs=lrs, step_s=step_s,
               wire=wire, digests=digests,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9
               if dev == "cuda" else None)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()) / (  # noqa: E731
        float(b.float().abs().max()) or 1.0)
    num = den = 0.0
    differ = 0
    for a, b, z in zip(leaves(params), leaves(rp), leaves(p0)):
        z = z.to(dev).float()
        num += float(torch.sum(torch.square(a.float() - b.float()),
                               dtype=torch.float64))
        den += float(torch.sum(torch.square(b.float() - z),
                               dtype=torch.float64))
        differ += int(torch.count_nonzero(a != b))
    out["replay"] = {
        "grad_norm_rel_diff": max(abs(a - b) / b for a, b in
                                  zip(gnorms, own_norms)),
        "m_rel_diff": max(rel(a, b) for a, b in
                          zip(leaves(opt.m), leaves(ropt.m))),
        "v_rel_diff": max(rel(a, b) for a, b in
                          zip(leaves(opt.v), leaves(ropt.v))),
        "delta_rel_diff": (num / den) ** 0.5 if den else float("inf"),
        "params_differing": differ,
        "bit_equal": bool(differ == 0 and all(
            torch.equal(a, b) for a, b in
            zip(leaves(opt.m) + leaves(opt.v),
                leaves(ropt.m) + leaves(ropt.v))))}
    del rp, ropt
    # the replicated leaves whole against the other ranks' (rank 0
    # compares), and this rank's blocks against the single run's
    equal = True
    for _, x in _replicated(params, ctx):
        for src in range(1, world):
            other = coll.ppermute(x, mesh, "model", [(src, 0)])
            if rank == 0:
                equal &= torch.equal(x, other)
    out["replicated_equal"] = bool(equal) if rank == 0 else None
    single = _model_blocks(ref["params"], ctx)
    out["same_init_as_single"] = all(
        torch.equal(a, b) for a, b in zip(
            leaves(p0), leaves(_model_blocks(ref["p0"], ctx))))
    dot = dict.fromkeys(("rs", "rr", "ss", "dd"), 0.0)
    for a, z, b in zip(leaves(params), leaves(p0), leaves(single)):
        z, b = z.to(dev).float(), b.to(dev).float()
        dr, ds = a.float() - z, b - z
        dot["rs"] += float(torch.sum(dr * ds, dtype=torch.float64))
        dot["rr"] += float(torch.sum(dr * dr, dtype=torch.float64))
        dot["ss"] += float(torch.sum(ds * ds, dtype=torch.float64))
        dot["dd"] += float(torch.sum(torch.square(dr - ds),
                                     dtype=torch.float64))
    out["delta_cos_vs_single"] = dot["rs"] / (
        (dot["rr"] * dot["ss"]) ** 0.5) if dot["rr"] * dot["ss"] else 0.0
    out["delta_rel_diff_vs_single"] = (dot["dd"] / dot["ss"]) ** 0.5 \
        if dot["ss"] else float("inf")
    out["moved_elements"] = sum(int(torch.count_nonzero(a.cpu() != z))
                                for a, z in zip(leaves(params), leaves(p0)))
    del params, opt, p0, single, ref, batch, m
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the f32 gradient checks: this rank's blocks of the same seeded params
    out["f32"] = {}
    for name, g in spec["grads"].items():
        gcfg = g["cfg"]
        gctx = lmesh.make_context(mesh, gcfg)._replace(
            ep_shardmap=gcfg.is_moe)
        loads = []
        route = _recording_loads(moe, loads, min_rows=g["route_rows"])
        try:
            gp = param_blocks(model.init_params(g["seed"], gcfg, gctx, dev),
                              gctx)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in g["batch"].items()}
            coll.reset_stats()
            sync()
            t = time.perf_counter()
            _, _, grads = train.grads_of(gp, batch, gcfg, gctx)
            grads = postprocess_grads(grads, gcfg, gctx)
            sync()
            secs = time.perf_counter() - t
        finally:
            moe._route_raw = route
        rel, worst = tp_grad_check(torch, grads, g["ref"], g["scales"],
                                   gctx)
        out["f32"][name] = {
            "worst": worst, "within_tolerance": worst["rel"]
            <= TP_TRAIN_GRAD_TOL, "grad_s": secs,
            "wire": dict(coll.stats), "loads": loads,
            "replicated_digest": _digest(torch, dict(
                _replicated(grads, gctx)))}
        del gp, grads, batch
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def tp_grad_reference(torch, np, model, moe, cfg, seed, batch, path, dev,
                      route_rows):
    """The one-process f32 gradient of ``cfg``'s seeded params on
    ``batch`` on the card, saved to ``path`` (the ranks map it); the
    prefill loads its router saw (``moe_drops``). Returns (seconds, each
    leaf's largest |grad| by name, the loads)."""
    import gc

    from repro_torch.launch import train
    from repro_torch.models import postprocess_grads
    from repro_torch.parallel.sharding import local_context
    from repro_torch.tree import tree_map

    ctx = local_context()
    loads = []
    route = _recording_loads(moe, loads, min_rows=route_rows)
    try:
        params = model.init_params(seed, cfg, ctx, dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _sync(torch, dev)
        t = time.perf_counter()
        _, _, grads = train.grads_of(params, tb, cfg, ctx)
        grads = postprocess_grads(grads, cfg, ctx)
        _sync(torch, dev)
        secs = time.perf_counter() - t
    finally:
        moe._route_raw = route
    del params
    scales = {k: float(x.abs().max()) for k, x in _named_leaves(grads)}
    torch.save(tree_map(lambda x: x.detach().to("cpu"), grads), path)
    del grads
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return secs, scales, loads


def phase_tp_train(torch, np, cfg_mod, model, moe, coll, smi, zero1,
                   device="cuda"):
    """Training under Megatron tensor parallelism, TP_TRAIN_RANKS model
    ranks sharing the card (gloo, host-staged). Part 1: zero1_train's
    Qwen1.5-0.5B run (bf16, remat, full depth, its global batches and
    seed) through ``build_train_step`` on a (1, 2) mesh, against the
    single-process steps zero1_train ran (``zero1``: its spec and
    results; their checkpoint is still on disk). Parts 2-3: f32 gradient
    checks at full width, Qwen1.5-0.5B (TP_TRAIN_DENSE_F32) and
    Qwen3-MoE-30B-A3B with the EP dispatch (TP_TRAIN_MOE_F32; dropless:
    the ranks at LM_TP_MOE_CF, the one process at E/k), each rank's
    blocks against the one-process gradient within TP_TRAIN_GRAD_TOL of
    each leaf's largest |grad|. No hand-written kernel is on this path.
    Fails unless the ranks' replicated leaves are bit-equal, losses and
    grad norms are within ZERO1_TOL of the single steps, the params'
    change meets ZERO1_DELTA_COS (its distance from the single run's
    change is printed), each rank's update is its replay's (norm, m and
    v within ZERO1_HALF_TOL, the change within ZERO1_DELTA_TOL), the
    gradients hold and neither MoE side drops an assignment."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    t_phase = time.perf_counter()
    spec0, single = zero1["spec"], zero1["single"]
    root = tempfile.mkdtemp(prefix="orca-tp-train-")
    rng = np.random.default_rng(SEED + 97)
    grads, refs_s, drops = {}, {}, {}
    try:
        for name, arch, (layers, b, s), seed in (
                ("dense", LM_TRAIN_ARCH, TP_TRAIN_DENSE_F32, SEED + 98),
                ("moe", LM_MOE_ARCH, TP_TRAIN_MOE_F32, SEED + 99)):
            cfg = cfg_mod.get_config(arch).replace(num_layers=layers,
                                                   dtype="float32")
            # no head padding at this tp: the one-process gradient's
            # layout is the ranks' blocks put together
            plan = tf_mod.plan_for(cfg, ParallelContext(
                mesh=Mesh((1, TP_TRAIN_RANKS), ("data", "model"))))
            assert (plan.hp, plan.kv_phys) == (cfg.num_heads,
                                               cfg.num_kv_heads), plan
            toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
            batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
            path = os.path.join(root, f"{name}.pt")
            ref_cfg = cfg
            if cfg.is_moe:
                ref_cfg = cfg.replace(capacity_factor=cfg.num_experts
                                      / cfg.num_experts_per_tok)
                cfg = cfg.replace(capacity_factor=LM_TP_MOE_CF)
            route_rows = b * s
            refs_s[name], scales, loads = tp_grad_reference(
                torch, np, model, moe, ref_cfg, seed, batch, path, device,
                route_rows)
            if cfg.is_moe:
                drops[name] = {"one_process": moe_drops(np, moe, ref_cfg,
                                                        loads)}
            grads[name] = {"cfg": cfg, "seed": seed, "batch": batch,
                           "ref": path, "scales": scales,
                           "route_rows": route_rows // TP_TRAIN_RANKS
                           if cfg.is_moe else route_rows}
        spec = {"device": device, "cfg": spec0["cfg"],
                "shape": spec0["shape"], "seed": spec0["seed"],
                "steps": spec0["steps"], "ref": spec0["ref"],
                "grads": grads}
        t = time.perf_counter()
        ranks = coll.launch(tp_train_rank, TP_TRAIN_RANKS,
                            backend=RANK_BACKEND, args=(spec,),
                            timeout=RANK_TIMEOUT)
        ranks_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    cfg = spec0["cfg"]
    tokens = spec0["shape"].tokens
    med = statistics.median(r0["step_s"][1:] or r0["step_s"])
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in
                   zip(r["losses"], single["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in
                    zip(r["grad_norms"], single["grad_norms"]))
    f32 = {}
    for name in grads:
        f32[name] = {
            "by_rank": [{k: v for k, v in r["f32"][name].items()
                         if k != "loads"} for r in ranks],
            "reference_s": refs_s[name],
            "tolerance": "max|diff| <= 1e-4 x the leaf's largest |grad|"}
        if name in drops:
            drops[name]["ranks"] = ep_drops(
                np, moe, grads[name]["cfg"],
                [r["f32"][name]["loads"] for r in ranks])
            f32[name]["drops"] = drops[name]
    out = {"phase": "tp_train", "nvidia_smi": smi, "arch": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "remat": cfg.remat,
           "ranks": TP_TRAIN_RANKS, "mesh": [1, TP_TRAIN_RANKS],
           "backend": r0["backend"],
           "transport": "gloo over loopback TCP; CUDA tensors staged "
                        "through page-locked host buffers (ranks share "
                        "one card)",
           "seq_len": spec0["shape"].seq_len,
           "global_batch": spec0["shape"].global_batch,
           "steps": spec0["steps"], "seconds_ranks": ranks_s,
           "single_losses": single["losses"],
           "single_grad_norms": single["grad_norms"],
           "losses_by_rank": [r["losses"] for r in ranks],
           "grad_norms_by_rank": [r["grad_norms"] for r in ranks],
           "loss_rel_diff_vs_single": loss_rel,
           "grad_norm_rel_diff_vs_single": gnorm_rel,
           "replay_by_rank": [r["replay"] for r in ranks],
           "replay_tolerance": ZERO1_HALF_TOL,
           "delta_cos_vs_single_by_rank": [r["delta_cos_vs_single"]
                                           for r in ranks],
           "delta_rel_diff_vs_single_by_rank": [
               r["delta_rel_diff_vs_single"] for r in ranks],
           "moved_elements_by_rank": [r["moved_elements"] for r in ranks],
           "same_init_as_single_by_rank": [r["same_init_as_single"]
                                           for r in ranks],
           "replicated_digests_equal_each_step": all(
               r["digests"] == r0["digests"] for r in ranks),
           "replicated_equal_across_ranks": r0["replicated_equal"],
           "lrs": r0["lrs"], "tolerance": ZERO1_TOL,
           "delta_tolerance": ZERO1_DELTA_TOL,
           "delta_cos_min": ZERO1_DELTA_COS,
           "step_s_by_rank": [r["step_s"] for r in ranks],
           "step_s_median_2_on": med, "tokens_per_step": tokens,
           "tokens_per_s": tokens / med,
           "single_step_s": single["step_s"],
           "collective_calls_per_step_by_rank": [
               [w["calls"] for w in r["wire"]] for r in ranks],
           "collective_bytes_per_step_by_rank": [
               [w["bytes"] for w in r["wire"]] for r in ranks],
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
           "f32": f32}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    failed = []
    if not np.isfinite([x for r in ranks for x in r["losses"]
                        + r["grad_norms"]]).all():
        failed.append("non-finite losses or grad norms")
    if not (out["replicated_digests_equal_each_step"]
            and out["replicated_equal_across_ranks"]):
        failed.append("the ranks' replicated leaves differ")
    if max(loss_rel, gnorm_rel) > ZERO1_TOL:
        failed.append("losses or grad norms outside ZERO1_TOL of the "
                      "single-process steps")
    if not all(r["same_init_as_single"] for r in ranks):
        failed.append("the ranks' step-0 params are not the single run's")
    if not min(out["delta_cos_vs_single_by_rank"]) >= ZERO1_DELTA_COS \
            or not min(out["moved_elements_by_rank"]):
        failed.append("the params' change is not the single run's")
    if not all(max(r["grad_norm_rel_diff"], r["m_rel_diff"],
                   r["v_rel_diff"]) <= ZERO1_HALF_TOL
               and r["delta_rel_diff"] <= ZERO1_DELTA_TOL
               for r in out["replay_by_rank"]):
        failed.append("the update is not the replay's")
    for name, res in f32.items():
        if not all(r["within_tolerance"] for r in res["by_rank"]):
            failed.append(f"{name}: f32 gradients outside tolerance")
        if len({str(r["replicated_digest"]) for r in res["by_rank"]}) != 1:
            failed.append(f"{name}: the replicated gradients differ")
        d = res.get("drops")
        if d and (d["one_process"]["dropped"] or d["ranks"][
                "dropped_sending"] or d["ranks"]["dropped_at_experts"]):
            failed.append(f"{name}: a side dropped assignments ({d})")
    if failed:
        raise AssertionError(f"tp_train: {'; '.join(failed)}")
    return out


# ---------------------------------------------------------------------------
# LM serving under Megatron tensor parallelism: ranks sharing the card
# ---------------------------------------------------------------------------

def _timed_collectives(coll, sync, box):
    """Wrap the collectives the model reaches so each call's host time
    (the stream synchronised on both sides: a staged call waits for its
    input anyway) is added to ``box["s"]``. Returns the originals."""
    names = ("psum", "pmax", "all_gather", "psum_scatter", "all_to_all")
    orig = {n: getattr(coll, n) for n in names}

    def wrap(fn):
        def timed(*a, **k):
            sync()
            t = time.perf_counter()
            y = fn(*a, **k)
            sync()
            box["s"] += time.perf_counter() - t
            return y
        return timed

    for n, fn in orig.items():
        setattr(coll, n, wrap(fn))
    return orig


def _recording_routes(moe, box):
    """Wrap ``moe._route_raw`` so each decode-sized call (``box["rows"]``
    tokens) appends its expert ids to ``box["ids"]``. Returns the
    original."""
    orig = moe._route_raw

    def recording(params, x_flat, cfg):
        out = orig(params, x_flat, cfg)
        if x_flat.shape[0] == box["rows"]:
            box["ids"].append(out[1].cpu())
        return out

    moe._route_raw = recording
    return orig


def _recording_loads(moe, loads, min_rows=LM_TP_ENGINE["prompt_len"]):
    """Wrap ``moe._route_raw`` so each prefill-sized call (``min_rows``
    tokens or more: a prompt's) appends (its tokens, each expert's
    assignments) to ``loads``. Returns the original."""
    orig = moe._route_raw

    def recording(params, x_flat, cfg):
        out = orig(params, x_flat, cfg)
        if x_flat.shape[0] >= min_rows:
            n = out[1].flatten().bincount(minlength=cfg.num_experts)
            loads.append((x_flat.shape[0], n.cpu().numpy()))
        return out

    moe._route_raw = recording
    return orig


def moe_drops(np, moe, cfg, loads):
    """The assignments the one-process prefills dropped, from their
    recorded ``loads``: past each expert's ``moe._capacity`` of the
    prefill's tokens, as ``moe.moe_apply`` sizes it."""
    cap = [moe._capacity(t, cfg, cfg.num_experts) for t, _ in loads]
    return {"prefills": len(loads), "capacity": min(cap),
            "max_expert_load": max(int(n.max()) for _, n in loads),
            "assignments": sum(int(n.sum()) for _, n in loads),
            "dropped": sum(int(np.clip(n - c, 0, None).sum())
                           for (_, n), c in zip(loads, cap))}


def ep_drops(np, moe, cfg, ranks_loads):
    """The assignments the ranks' EP shard_map prefills dropped, from each
    rank's recorded loads (the same prefills in the same order on every
    rank), with the capacities ``moe.moe_apply_ep_shardmap`` takes: a
    rank's assignments to each destination rank past its send capacity,
    and all ranks' assignments to an expert past its buffer's."""
    tp = len(ranks_loads)
    e_loc = cfg.num_experts // tp
    out = {"prefills": len(ranks_loads[0]), "dropped_sending": 0,
           "dropped_at_experts": 0, "max_expert_load": 0}
    for calls in zip(*ranks_loads):
        cap_s = moe._capacity(calls[0][0], cfg, tp)
        cap2 = moe._capacity(tp * cap_s, cfg.replace(num_experts_per_tok=1),
                             e_loc)
        for _, n in calls:
            out["dropped_sending"] += int(np.clip(
                n.reshape(tp, e_loc).sum(1) - cap_s, 0, None).sum())
        n = sum(n for _, n in calls)
        out["dropped_at_experts"] += int(np.clip(n - cap2, 0, None).sum())
        out["max_expert_load"] = max(out["max_expert_load"], int(n.max()))
        out.update(send_capacity=cap_s, expert_capacity=cap2)
    return out


def lm_tp_requests(np, cfg, seed):
    """The engine's LM_TP_REQUESTS prompts (caps all gen_len) and the
    teacher-forced prompts."""
    rng = np.random.default_rng(seed)
    n, s = LM_TP_REQUESTS, LM_TP_ENGINE["prompt_len"]
    prompts = rng.integers(1, cfg.vocab_size, (n, s)).astype(np.int32)
    caps = np.full(n, LM_TP_ENGINE["gen_len"], np.int32)
    tf = rng.integers(1, cfg.vocab_size, (LM_TP_TF_PROMPTS, s))
    return prompts, caps, tf.astype(np.int32)


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def lm_tp_tf_run(torch, model, moe, cfg, ctx, params, prompts, tokens,
                 steps=LM_TP_TF_STEPS, routes=None, dev="cuda", timing=None):
    """The teacher-forced rows: prefill ``prompts`` (flash), then one
    decode step a row of ``tokens`` (or, with ``tokens`` None, ``steps``
    steps each fed the previous logits' argmax). Returns (the logits of
    each step on the host, the tokens fed, the final decode state); with
    ``routes`` (a list) the decode steps' expert ids are appended to it,
    a list of steps for each layer; with ``timing`` (a dict) the prefill's
    and each decode step's host seconds and the decode steps' collective
    calls and bytes are put in it."""
    from repro_torch.parallel import collectives as coll

    b, s = prompts.shape[:2]  # (b, s) tokens or (b, s, K) codebook frames
    n = len(tokens) if tokens is not None else steps
    _sync(torch, dev)
    t_pre = time.perf_counter()
    st = model.make_decode_state(cfg, ctx, b, s + n, dev)
    st, lg = model.prefill(params, torch.from_numpy(prompts).to(dev), st, cfg,
                           ctx, backend="cuda" if dev == "cuda" else "ref")
    _sync(torch, dev)
    logits, fed = [lg.cpu()], []
    box = {"rows": b, "ids": []}
    orig = _recording_routes(moe, box) if routes is not None else None
    if timing is not None:
        timing.update(prefill_s=time.perf_counter() - t_pre, step_s=[])
        calls, nbytes = coll.stats["calls"], coll.stats["bytes"]
    try:
        for i in range(n):
            tok = lg.argmax(-1).to(torch.int32) if tokens is None \
                else tokens[i].to(dev)
            fed.append(tok.cpu())
            t = time.perf_counter()
            st, lg = model.decode_step(params, tok, st, cfg, ctx)
            logits.append(lg.cpu())
            if timing is not None:
                timing["step_s"].append(time.perf_counter() - t)
    finally:
        if orig is not None:
            moe._route_raw = orig
    if routes is not None:
        routes.extend(box["ids"][i::cfg.num_layers]
                      for i in range(cfg.num_layers))
    if timing is not None:
        timing.update(calls=(coll.stats["calls"] - calls) / max(n, 1),
                      bytes=(coll.stats["bytes"] - nbytes) / max(n, 1))
    return logits, fed, st


def lm_tp_paged_tf_run(torch, model, pk, cfg, ctx, params, prompts, tokens,
                       steps=LM_TP_TF_STEPS, dev="cuda"):
    """The teacher-forced rows through the paged path: ``prompts`` through
    ``model.prefill_kv`` (flash) straight into a pool of this rank's kv
    heads, then one ``paged_decode_step`` (paged_attention_stats) a row of
    ``tokens`` (or ``steps`` greedy steps). Returns (the logits of each
    step on the host, the tokens fed, the final pool)."""
    from repro_torch.models.layers import dtype_of

    b, s = prompts.shape
    n = len(tokens) if tokens is not None else steps
    ps = LM_TP_PAGED_ENGINE["page_size"]
    maxp = -(-(s + n) // ps)
    pcfg = model.make_paged_kv_config(cfg, ctx, num_pages=b * maxp,
                                      page_size=ps, max_pages_per_seq=maxp)
    kv = pk.make(pcfg, batch=b, dtype=dtype_of(cfg.dtype), device=dev)
    backend = "cuda" if dev == "cuda" else "ref"
    k, v, lg = model.prefill_kv(params, torch.from_numpy(prompts).to(dev),
                                cfg, ctx, kernel_backend=backend)
    every = torch.ones((b,), dtype=torch.bool, device=dev)
    kv, landed = pk.prefill_into_pages(
        kv, pcfg, torch.arange(b, dtype=torch.int32, device=dev), k, v,
        every)
    del k, v
    if not bool(landed.all()):
        raise AssertionError("lm_tp_serve: a paged prefill did not land")
    logits, fed = [lg.cpu()], []
    for i in range(n):
        tok = lg.argmax(-1).to(torch.int32) if tokens is None \
            else tokens[i].to(dev)
        fed.append(tok.cpu())
        kv, lg, ok = model.paged_decode_step(params, tok, kv, pcfg, cfg, ctx,
                                             kernel_backend=backend)
        if not bool(ok.all()):
            raise AssertionError("lm_tp_serve: the paged pool ran dry")
        logits.append(lg.cpu())
    return logits, fed, kv


def lm_tp_engine_run(torch, np, eng, rb, cfg, ctx, params, ecfg, prompts,
                     caps, box, dev):
    """``ecfg``'s engine (dense or paged) on this rank over the requests:
    each step's host seconds, collective seconds (``box``), calls and
    bytes, and the prompts it admitted; the responses and the kernels'
    launches in the run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.parallel import collectives as coll

    steps, popped = [], [0]

    def on_step(step, state):
        head = int(state.req.head.sum())
        steps.append({"coll_s": box["s"], "calls": coll.stats["calls"],
                      "bytes": coll.stats["bytes"],
                      "admitted": head - popped[0]})
        popped[0] = head
        coll.reset_stats()
        box["s"] = 0.0

    coll.reset_stats()
    box["s"] = 0.0
    fa.reset_launches()
    pa.reset_launches()
    state, times = lm_serve_run(torch, eng, cfg, ctx, params, ecfg, prompts,
                                caps, on_step, dev)
    launches = {**fa.launches, **pa.launches}
    for row, s in zip(steps, times):
        row["s"] = s
    resp = lm_responses(np, rb, state, caps, ecfg.num_queues)
    ints = int_leaves(torch, state)
    del state
    return {"steps": steps, "launches": launches, "responses": resp,
            "ints": ints}


def int_leaves(torch, state, prefix=""):
    """Every integer (and bool) leaf of an engine state, by path, as
    numpy on the host: the rings, scheduler, slots, responses, the pool's
    allocator and the decode state's positions."""
    out = {}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        state = state._asdict()
    if isinstance(state, dict):
        for k, v in state.items():
            out.update(int_leaves(torch, v, f"{prefix}/{k}"))
    elif not state.dtype.is_floating_point:
        out[prefix] = state.cpu().numpy()
    return out


def _row_leaf(path):
    """The slot-row axis of a dense engine's decode-state leaf (None: a
    leaf every data rank holds whole)."""
    if path == "/decode/pos":
        return 0
    return 1 if path.startswith("/decode/layers/") else None


def int_mismatches(np, got, want, rows):
    """Integer leaves of a rank's final engine state that differ from the
    one process's (``want``, whole): the decode state's rows against the
    rank's ``rows`` of them."""
    bad = []
    for path, w in want.items():
        ax = _row_leaf(path)
        if ax is not None and got[path].shape != w.shape:
            w = w[(slice(None),) * ax + (slice(*rows),)]
        if got[path].shape != w.shape or not np.array_equal(got[path], w):
            bad.append(path)
    return bad


def replicated_equal(np, ranks_ints):
    """Whether the ranks' integer leaves that every data rank holds whole
    are equal bit for bit."""
    first = ranks_ints[0]
    return all(np.array_equal(r[p], v) for r in ranks_ints[1:]
               for p, v in first.items() if _row_leaf(p) is None)


def _tf_digest(logits):
    import hashlib

    digest = hashlib.sha1()
    for a in logits:
        digest.update(a.numpy().tobytes())
    return digest.hexdigest()


def lm_tp_rank(rank, world, spec):
    """This rank of a (1, world) ("data", "model") mesh on the card: its
    blocks of the seeded params (``sharding.param_blocks``), the dense
    engine's run over the requests, the teacher-forced rows against the
    one-process reference (``spec["ref"]``), then the same through the
    paged engine (its pool this rank's kv heads) and the paged path, and
    the f32 pass. The kernels' launches of each part, step and collective
    times, peak memory."""
    import numpy as np
    import torch

    from repro_torch.core import engine as eng
    from repro_torch.core import ringbuf as rb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import model, moe
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import param_blocks
    from repro_torch.serving import kv_cache as pk

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    mesh = lmesh.make_test_mesh((1, world), ("data", "model"))
    cfg = spec["cfg"]
    ctx = lmesh.make_context(mesh, cfg)._replace(
        ep_shardmap=spec["ep_shardmap"])
    ref = torch.load(spec["ref"])
    box = {"s": 0.0}
    orig = _timed_collectives(coll, lambda: _sync(torch, dev), box)
    out = {"rank": rank, "backend": mesh.backend, "loads": []}
    route = _recording_loads(moe, out["loads"])
    try:
        t = time.perf_counter()
        params = param_blocks(model.init_params(spec["seed"], cfg, ctx,
                                                dev), ctx)
        _sync(torch, dev)
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out["init_s"] = time.perf_counter() - t
        out["params_gb"] = tree_bytes(torch, _leaves(params)) / 1e9
        prompts, caps, tf_prompts = lm_tp_requests(np, cfg, spec["seed"] + 2)
        # the engine over the requests; each step's collective time,
        # calls and bytes, and the prompts it admitted
        out.update(lm_tp_engine_run(
            torch, np, eng, rb, cfg, ctx, params,
            eng.LMEngineConfig(**LM_TP_ENGINE, kernel_backend="auto"),
            prompts, caps, box, dev))
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if dev == "cuda" else None

        fa.reset_launches()
        routes = [] if cfg.is_moe else None
        logits, _, _ = lm_tp_tf_run(torch, model, moe, cfg, ctx, params,
                                    tf_prompts, ref["tf_tokens"],
                                    routes=routes, dev=dev)
        out["tf_launches"] = dict(fa.launches)
        out["tf"] = merge_rows([row_stats(torch, a.to(dev), b.to(dev),
                                          cfg.vocab_size)
                                for a, b in zip(logits, ref["tf_logits"])])
        out["tf_digest"] = _tf_digest(logits)
        if routes is not None:
            same = [sum(int((a.sort(-1).values == b.sort(-1).values)
                            .all(-1).sum()) for a, b in zip(got, want))
                    for got, want in zip(routes, ref["routes"])]
            n = sum(int(a.shape[0]) for a in ref["routes"][0])
            out["tf"]["expert_sets"] = n * cfg.num_layers
            out["tf"]["expert_sets_equal_share"] = sum(same) / (
                n * cfg.num_layers)
            out["tf"]["expert_sets_equal_share_by_layer"] = [
                x / n for x in same]

        # the paged engine over the same requests, then the teacher-forced
        # rows through the paged path; the walk on the rank's live pool
        # against the plain version
        out["paged"] = lm_tp_engine_run(
            torch, np, eng, rb, cfg, ctx, params,
            eng.LMEngineConfig(**LM_TP_PAGED_ENGINE, kernel_backend="auto"),
            prompts, caps, box, dev)
        fa.reset_launches()
        pa.reset_launches()
        logits, _, kv = lm_tp_paged_tf_run(torch, model, pk, cfg, ctx,
                                           params, tf_prompts,
                                           ref["paged_tf_tokens"], dev=dev)
        out["paged"]["tf_launches"] = {**fa.launches, **pa.launches}
        out["paged"]["tf"] = merge_rows([
            row_stats(torch, a.to(dev), b.to(dev), cfg.vocab_size)
            for a, b in zip(logits, ref["paged_tf_logits"])])
        out["paged"]["tf_digest"] = _tf_digest(logits)
        out["paged"]["pool_kv_heads"] = int(kv.k_pages.shape[3])
        if dev == "cuda":
            g = cfg.num_heads // cfg.num_kv_heads
            out["paged"]["walk"] = lm_walk_check(torch, pa, kref, kv,
                                                 spec["seed"] + 3, g)
        del params, kv
        if dev == "cuda":
            torch.cuda.empty_cache()
        out["f32"] = lm_tp_f32_rank(torch, model, moe, fa, ctx, spec, ref,
                                    tf_prompts)
        if dev == "cuda":
            torch.cuda.empty_cache()
        # lm_dp_serve and lm_tp_families on the same ranks
        t = time.perf_counter()
        out["dp"] = lm_dp_rank(torch, np, eng, rb, model, pk, fa, pa, spec,
                               ref, box, dev)
        out["dp"]["seconds"] = time.perf_counter() - t
        if spec.get("families"):
            t = time.perf_counter()
            out["families"] = lm_fam_rank(torch, np, model, moe, fa, mesh,
                                          spec["families"], dev)
            out["families_seconds"] = time.perf_counter() - t
    finally:
        moe._route_raw = route
        for n, fn in orig.items():
            setattr(coll, n, fn)
    return out


def lm_tp_f32_rank(torch, model, moe, fa, ctx, spec, ref, prompts):
    """The f32 pass on this rank: its blocks of the f32 params, the
    prefill and LM_TP_F32_STEPS steps fed the reference's tokens; each
    step's logits and each layer's ring caches (its kv heads) against
    the one-process run's, max|diff| over max|value|."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import param_blocks

    cfg, dev = spec["cfg_f32"], spec["device"]
    params = param_blocks(model.init_params(spec["seed"] + 1, cfg, ctx,
                                            dev), ctx)
    fa.reset_launches()
    logits, _, st = lm_tp_tf_run(torch, model, moe, cfg, ctx, params,
                                 prompts, ref["f32_tokens"], dev=dev)
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(logits, ref["f32_logits"])]
    r, tp = coll.model_rank(ctx), ctx.tp
    caches = {}
    for f in ("k", "v"):
        got = st.layers[f].cpu()
        want = ref["f32_" + f]
        kv = want.shape[3] // tp
        want = want[:, :, :, r * kv:(r + 1) * kv]
        caches[f] = [float((got[i] - want[i]).abs().max()
                           / want[i].abs().max()) for i in range(len(want))]
    return {"logits_rel_diff": rel, "caches_rel_diff": caches,
            "launches": dict(fa.launches),
            "within_tolerance": max(rel + caches["k"] + caches["v"])
            <= POOL_REL_TOL}


# ---------------------------------------------------------------------------
# lm_dp_serve: the LM engine over data ranks, in lm_tp_serve's launches
# ---------------------------------------------------------------------------

def lm_blocked_dense_run(torch, eng, model, cfg, ctx, params, ecfg, prompts,
                         caps, dev):
    """The dense engine in one process with each decode step run in
    LM_DP_RANKS row blocks, the shapes a data rank's decode takes: a bf16
    ring decode of 16 rows and one of 8 take other batched-product
    algorithms and differ in their last bits, which flips near-tie tokens
    (the paged engine's walk is per row and does not). Returns the final
    integers."""
    from repro_torch.models.model import DecodeState
    from repro_torch.tree import tree_map

    def prefill_fn(p, rows):
        st = model.make_decode_state(cfg, ctx, ecfg.admit_per_step,
                                     ecfg.cache_len, dev)
        return model.prefill(p, rows, st, cfg, ctx, chunk=16,
                             backend=ecfg.kernel_backend)

    def decode_fn(p, toks, st):
        n = toks.shape[0] // LM_DP_RANKS
        outs = [model.decode_step(
            p, toks[b], DecodeState(tree_map(lambda t: t[:, b], st.layers),
                                    st.pos[b]), cfg, ctx)
            for b in (slice(i * n, (i + 1) * n) for i in range(LM_DP_RANKS))]
        return DecodeState(
            {k: torch.cat([o[0].layers[k] for o in outs], 1)
             for k in outs[0][0].layers},
            torch.cat([o[0].pos for o in outs])), torch.cat(
                [o[1] for o in outs])

    state = eng.lm_make(ecfg, model.make_decode_state(
        cfg, ctx, ecfg.slots, ecfg.cache_len, dev))
    state = lm_inject_all(torch, eng, state, ecfg, prompts, caps)
    for _ in range(len(prompts) * ecfg.gen_len):
        state = eng.lm_engine_step(state, ecfg, cfg, ctx, params, prefill_fn,
                                   decode_fn)
        if int(state.completed) == len(prompts):
            return int_leaves(torch, state)
    raise AssertionError("lm_dp_serve: the blocked one-process engine did "
                         "not complete its requests")


def lm_dp_tf_rows(torch, model, cfg, ctx, params, prompts, tokens, dev):
    """The teacher-forced rows through the ring path over data ranks:
    this rank's rows of ``prompts`` prefilled into its block of the decode
    state (``model.batch_rows``; an MoE block's capacity and dispatch
    positions the whole batch's), then a decode step a row of ``tokens``
    (its rows). Returns its rows' logits each step, on the host."""
    b, s = prompts.shape
    rows = model.batch_rows(b, ctx)
    st = model.make_decode_state(cfg, ctx, b, s + len(tokens), dev)
    st, lg = model.prefill(params, torch.from_numpy(prompts[rows]).to(dev),
                           st, cfg, ctx,
                           backend="cuda" if dev == "cuda" else "ref")
    out = [lg.cpu()]
    for tok in tokens:
        st, lg = model.decode_step(params, tok[rows].to(dev), st, cfg, ctx)
        out.append(lg.cpu())
    return out


def lm_dp_paged_tf_rows(torch, model, pk, cfg, ctx, params, prompts, tokens,
                        dev):
    """The teacher-forced rows through the paged path as the engine over
    data ranks runs it: every rank prefills the whole batch
    (``model.whole_batch``) into a pool whose allocator takes every row,
    writing its rows' pages; then one ``paged_decode_step`` a row of
    ``tokens`` (whole), the rank walking its rows. Returns its rows'
    logits each step, on the host."""
    from repro_torch.models.layers import dtype_of

    b, s = prompts.shape
    rows = model.batch_rows(b, ctx)
    ps = LM_TP_PAGED_ENGINE["page_size"]
    maxp = -(-(s + len(tokens)) // ps)
    pcfg = model.make_paged_kv_config(cfg, ctx, num_pages=b * maxp,
                                      page_size=ps, max_pages_per_seq=maxp)
    kv = pk.make(pcfg, batch=b, dtype=dtype_of(cfg.dtype), device=dev)
    backend = "cuda" if dev == "cuda" else "ref"
    k, v, lg = model.prefill_kv(params, torch.from_numpy(prompts).to(dev),
                                cfg, model.whole_batch(ctx),
                                kernel_backend=backend)
    ids = torch.arange(b, dtype=torch.int32, device=dev)
    kv, landed = pk.prefill_into_pages(
        kv, pcfg, ids, k, v, torch.ones((b,), dtype=torch.bool, device=dev),
        own=(ids >= rows.start) & (ids < rows.stop))
    del k, v
    if not bool(landed.all()):
        raise AssertionError("lm_dp_serve: a paged prefill did not land")
    out = [lg[rows].cpu()]
    for tok in tokens:
        kv, lg, ok = model.paged_decode_step(params, tok.to(dev), kv, pcfg,
                                             cfg, ctx, kernel_backend=backend)
        if not bool(ok.all()):
            raise AssertionError("lm_dp_serve: the paged pool ran dry")
        out.append(lg.cpu())
    return out


def lm_dp_swap_run(torch, np, eng, cfg, ctx, params, seed, dev):
    """LM_DP_SWAP_ENGINE's paged engine over LM_DP_SWAP_REQUESTS requests
    (caps all gen_len) with the swap service after every step. Returns
    the final integers, the tier's evictions and restores, the evictions
    of this rank's own slots and the steps."""
    ecfg = eng.LMEngineConfig(**LM_DP_SWAP_ENGINE, kernel_backend="auto")
    swap, cold, _ = eng.make_swap_service(ecfg, cfg, ctx)
    prompts, _ = lm_requests(np, cfg, LM_DP_SWAP_REQUESTS, seed,
                             prompt_len=ecfg.prompt_len)
    caps = np.full(LM_DP_SWAP_REQUESTS, ecfg.gen_len, np.int32)
    own = [0]

    def on_step(step, state):
        n = cold.evictions
        state = swap(state)
        if cold.evictions > n and cold.parks(cold.order[-1]):
            own[0] += 1
        return state

    state, times = lm_serve_run(torch, eng, cfg, ctx, params, ecfg, prompts,
                                caps, on_step, dev)
    return {"ints": int_leaves(torch, state), "evictions": cold.evictions,
            "restores": cold.restores, "own_evictions": own[0],
            "steps": len(times), "step_ms_median":
                statistics.median(times) * 1e3}


def _rows_stats(torch, got, want, rows, v, dev):
    """lm_serve's row statistics of a rank's ``rows`` of each step's
    logits against the one process's."""
    return merge_rows([row_stats(torch, a.to(dev), b[slice(*rows)].to(dev), v)
                       for a, b in zip(got, want)])


def lm_dp_rank(torch, np, eng, rb, model, pk, fa, pa, spec, ref, box, dev):
    """This rank of a (LM_DP_RANKS, 1) mesh: the whole seeded params (the
    model axis is 1), lm_tp_serve's requests through the dense (not for
    MoE) and the paged engine, each run's final integers; the
    teacher-forced rows of its slots through the ring and the paged
    path; with ``spec["swap"]`` the f32 swap pass. Launches, step and
    collective times of each."""
    from repro_torch.launch import mesh as lmesh

    mesh = lmesh.make_test_mesh((LM_DP_RANKS, 1), ("data", "model"))
    cfg = spec["dp_cfg"]
    ctx = lmesh.make_context(mesh, cfg)  # GSPMD moe_apply
    params = model.init_params(spec["seed"], cfg, ctx, dev)
    prompts, caps, tf_prompts = lm_tp_requests(np, cfg, spec["seed"] + 2)
    rows = model.batch_rows(LM_TP_ENGINE["slots"], ctx)
    out = {"rows": (rows.start, rows.stop), "runs": {}}
    engines = (("paged", LM_TP_PAGED_ENGINE),) if cfg.is_moe else (
        ("dense", LM_TP_ENGINE), ("paged", LM_TP_PAGED_ENGINE))
    for name, engine in engines:
        out["runs"][name] = lm_tp_engine_run(
            torch, np, eng, rb, cfg, ctx, params,
            eng.LMEngineConfig(**engine, kernel_backend="auto"), prompts,
            caps, box, dev)
    tf_rows = model.batch_rows(tf_prompts.shape[0], ctx)
    out["tf_rows"] = (tf_rows.start, tf_rows.stop)
    fa.reset_launches()
    logits = lm_dp_tf_rows(torch, model, cfg, ctx, params, tf_prompts,
                           ref["tf_tokens"], dev)
    out["tf_launches"] = dict(fa.launches)
    out["tf"] = _rows_stats(torch, logits, ref["tf_logits"], out["tf_rows"],
                            cfg.vocab_size, dev)
    fa.reset_launches()
    pa.reset_launches()
    logits = lm_dp_paged_tf_rows(torch, model, pk, cfg, ctx, params,
                                 tf_prompts, ref["paged_tf_tokens"], dev)
    out["paged_tf_launches"] = {**fa.launches, **pa.launches}
    out["paged_tf"] = _rows_stats(torch, logits, ref["paged_tf_logits"],
                                  out["tf_rows"], cfg.vocab_size, dev)
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    if spec.get("swap"):
        params = model.init_params(spec["seed"] + 1, spec["cfg_f32"], ctx,
                                   dev)
        out["swap"] = lm_dp_swap_run(torch, np, eng, spec["cfg_f32"], ctx,
                                     params, spec["seed"] + 4, dev)
        del params
    return out


def lm_dp_summary(np, cfg, ranks, one):
    """lm_dp_serve's line for one model from its ranks' ``dp`` parts and
    the one process's runs (``one``: each engine's responses, step times
    and final integers; the swap pass's): step times and collectives,
    integers against the one process and across the ranks, the
    teacher-forced rows merged over the ranks' rows, launches against
    layers x steps, and the swap pass."""
    dps = [r["dp"] for r in ranks]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "data_ranks": LM_DP_RANKS, "rows_by_rank": [d["rows"] for d in dps],
           "capacity_factor": cfg.capacity_factor if cfg.is_moe else None,
           "runs": {}}
    for name, run0 in dps[0]["runs"].items():
        resp_1, times_1, ints_1 = one[name]
        # the dense engine's integers are held to the one process decoding
        # in the ranks' row blocks (its whole-batch run is reported)
        gate = one.get(f"{name}_blocked", ints_1)
        steps = len(run0["steps"])
        admissions = sum(1 for r in run0["steps"] if r["admitted"])
        tokens = sum(len(v) for v in run0["responses"].values())
        run = {"steps": steps, "admission_steps": admissions,
               "generated_tokens": tokens, "dp": _tp_step_summary(
                   run0["steps"]),
               "dp_tokens_per_s": tokens / sum(r["s"] for r in run0["steps"]),
               "one_process": {
                   "step_ms_median": statistics.median(times_1) * 1e3,
                   "tokens_per_s": tokens / sum(times_1)},
               "integers_equal_across_ranks": replicated_equal(
                   np, [d["runs"][name]["ints"] for d in dps]),
               "integers_differing_from_one_process_by_rank": [
                   int_mismatches(np, d["runs"][name]["ints"], gate,
                                  d["rows"]) for d in dps],
               "one_process_decodes_in_rank_blocks": gate is not ints_1,
               "integers_differing_from_whole_batch_one_process_by_rank": [
                   int_mismatches(np, d["runs"][name]["ints"], ints_1,
                                  d["rows"]) for d in dps],
               "token_agreement_vs_one_process": sum(
                   int((run0["responses"][k] == v).sum())
                   for k, v in resp_1.items()) / max(tokens, 1),
               "flash_launches_by_rank": [
                   d["runs"][name]["launches"].get("flash_attention", 0)
                   for d in dps],
               "flash_launches_expected": cfg.num_layers * admissions}
        if name == "paged":
            run["paged_launches_by_rank"] = [
                d["runs"][name]["launches"].get("paged_attention_stats", 0)
                for d in dps]
            run["paged_launches_expected"] = cfg.num_layers * steps
        out["runs"][name] = run
    for key in ("tf", "paged_tf"):
        if key in dps[0]:
            out[key] = merge_rows([d[key] for d in dps])
            out[key + "_launches_by_rank"] = [d[key + "_launches"]
                                              for d in dps]
    if "swap" in dps[0]:
        sw1 = one["swap"]
        out["f32_swap"] = {
            "engine": LM_DP_SWAP_ENGINE, "requests": LM_DP_SWAP_REQUESTS,
            "layers": LM_TP_F32_LAYERS, "one_process": {
                k: sw1[k] for k in ("evictions", "restores", "steps",
                                    "step_ms_median")},
            "by_rank": [{k: d["swap"][k] for k in (
                "evictions", "restores", "own_evictions", "steps",
                "step_ms_median")} for d in dps],
            "integers_differing_from_one_process_by_rank": [
                int_mismatches(np, d["swap"]["ints"], sw1["ints"], d["rows"])
                for d in dps]}
    return out


def lm_dp_failures(run):
    """Why one model's lm_dp_serve run fails its gates (empty: it
    passes)."""
    out = []
    for name, r in run["runs"].items():
        if not r["integers_equal_across_ranks"]:
            out.append(f"{name}: the ranks' integers differ")
        bad = [b for b in r["integers_differing_from_one_process_by_rank"]
               if b]
        if bad:
            out.append(f"{name}: integers differ from the one process: "
                       f"{bad}")
        for k in ("flash", "paged"):
            if f"{k}_launches_expected" not in r:
                continue
            got, want = r[f"{k}_launches_by_rank"], r[f"{k}_launches_expected"]
            if not want or got != [want] * len(got):
                out.append(f"{name}: {k} launches {got} != {want}")
    for key in ("tf", "paged_tf"):
        why = decided_failure(run[key], LM_DECIDED_SHARE) \
            if key in run else None
        if why:
            out.append(f"{key}: {why}")
    sw = run.get("f32_swap")
    if sw is not None:
        if any(sw["integers_differing_from_one_process_by_rank"]):
            out.append("f32 swap: integers differ from the one process")
        for r in sw["by_rank"]:
            if (r["evictions"], r["restores"]) != (
                    sw["one_process"]["evictions"],
                    sw["one_process"]["restores"]) or not (
                    r["evictions"] and r["restores"]
                    and r["own_evictions"]):
                out.append(f"f32 swap: evictions/restores {r} against "
                           f"{sw['one_process']}")
    return out


# ---------------------------------------------------------------------------
# lm_tp_families: the vlm, hybrid, ssm and audio models on 2 model ranks
# ---------------------------------------------------------------------------

def lm_fam_prompts(np, cfg, b, s, seed):
    """``b`` prompts of ``s`` tokens, or (b, s, K) codebook frames."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    return rng.integers(1, cfg.vocab_size, shape).astype(np.int32)


def lm_fam_reference(torch, np, model, moe, cfg, cfg_f32, seed, prompts,
                     path, dev="cuda"):
    """A family's one-process run on the card for the ranks: the params of
    the plan at LM_TP_RANKS model ranks (for the hybrid padded, run at
    that plan: ``transformer.plan_for`` taken to it, its padded q heads
    masked by ``attention.q_head_mask``), the prefill and LM_FAM_TP_STEPS
    greedy steps; the f32 pass's logits and final decode state; saved to
    ``path``, the weights freed. Returns the bf16 run's step times."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.parallel.sharding import (
        Mesh, ParallelContext, head_plan, local_context,
    )

    tp_ctx = ParallelContext(mesh=Mesh((1, LM_TP_RANKS), ("data", "model")))
    plan = tf_mod.plan_for(cfg, tp_ctx)
    padded = (plan.hp, plan.kv_phys) != (cfg.num_heads, cfg.num_kv_heads)
    orig = tf_mod.plan_for
    if padded:
        tf_mod.plan_for = lambda c, ctx: head_plan(
            c.num_heads, c.num_kv_heads, LM_TP_RANKS)
    timing = {}
    try:
        ctx = local_context()
        params = model.init_params(seed, cfg, tp_ctx, dev)
        logits, fed, _ = lm_tp_tf_run(torch, model, moe, cfg, ctx, params,
                                      prompts, None, steps=LM_FAM_TP_STEPS,
                                      dev=dev, timing=timing)
        del params
        params = model.init_params(seed + 1, cfg_f32, tp_ctx, dev)
        l32, fed32, st = lm_tp_tf_run(torch, model, moe, cfg_f32, ctx, params,
                                      prompts, None, steps=LM_TP_F32_STEPS,
                                      dev=dev)
        state = {k: v.cpu() for k, v in st.layers.items()}
        del params, st
    finally:
        tf_mod.plan_for = orig
    torch.save({"logits": logits, "tokens": fed, "f32_logits": l32,
                "f32_tokens": fed32, "f32_state": state,
                "padded": padded}, path)
    return timing


def _model_block(want, got_shape, r):
    """Model rank ``r``'s block of a whole array along every axis it holds
    less of (kv heads, recurrent-state heads)."""
    return want[tuple(slice(None) if w == g else slice(r * g, (r + 1) * g)
                      for w, g in zip(want.shape, got_shape))]


def lm_fam_rank(torch, np, model, moe, fa, mesh, fams, dev):
    """Each family of ``fams`` on this rank of the (1, LM_TP_RANKS) mesh:
    its blocks of the seeded params, the prefill and the decode steps fed
    the one process's tokens (the rows' statistics, a digest of the
    logits, flash launches, step and collective times), then the f32
    pass against the one process (max |diff| over max |value| of the
    logits each step and of each layer's decode-state leaves, the rank's
    block)."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import param_blocks

    out = {}
    for name, f in fams.items():
        cfg = f["cfg"]
        ctx = lmesh.make_context(mesh, cfg)
        ref = torch.load(f["ref"])
        params = param_blocks(model.init_params(f["seed"], cfg, ctx, dev),
                              ctx)
        fa.reset_launches()
        timing = {}
        logits, _, _ = lm_tp_tf_run(torch, model, moe, cfg, ctx, params,
                                    f["prompts"], ref["tokens"], dev=dev,
                                    timing=timing)
        launches = dict(fa.launches)
        v = cfg.vocab_size
        r = {"launches": launches, "timing": timing,
             "tf": merge_rows([row_stats(
                 torch, a.reshape(-1, a.shape[-1]).to(dev),
                 b.reshape(-1, b.shape[-1]).to(dev), v)
                 for a, b in zip(logits, ref["logits"])]),
             "digest": _tf_digest(logits)}
        del params
        params = param_blocks(model.init_params(f["seed"] + 1, f["cfg_f32"],
                                                ctx, dev), ctx)
        fa.reset_launches()
        l32, _, st = lm_tp_tf_run(torch, model, moe, f["cfg_f32"], ctx,
                                  params, f["prompts"], ref["f32_tokens"],
                                  dev=dev)
        rank = coll.model_rank(ctx)
        rel = [float((a[..., :v] - b[..., :v]).abs().max()
                     / b[..., :v].abs().max())
               for a, b in zip(l32, ref["f32_logits"])]
        state, ints_equal = {}, True
        for k, g in st.layers.items():
            g = g.cpu()
            w = _model_block(ref["f32_state"][k], g.shape, rank)
            if g.dtype.is_floating_point:
                state[k] = [float((g[i] - w[i]).abs().max()
                                  / max(float(w[i].abs().max()), 1e-30))
                            for i in range(len(w))]
            else:
                ints_equal &= bool(torch.equal(g, w))
        r["f32"] = {"logits_rel_diff": rel, "state_rel_diff": state,
                    "positions_equal": ints_equal,
                    "launches": dict(fa.launches),
                    "within_tolerance": ints_equal and max(
                        rel + [x for xs in state.values() for x in xs])
                    <= POOL_REL_TOL}
        r["heads_per_rank"] = (params["layers"]["attn"]["wq"].shape[2],
                               params["layers"]["attn"]["wk"].shape[2]) \
            if "attn" in params["layers"] else None
        del params, st
        if dev == "cuda":
            torch.cuda.empty_cache()
        out[name] = r
    return out


def lm_tp_reference(torch, np, eng, rb, model, moe, fa, cfg, seed, path,
                    cfg_f32, dev="cuda", swap=False):
    """The one-process run on the card, for the ranks to be held against:
    the dense engine over the same requests (its responses, step times
    and final integers), the teacher-forced rows (greedy from its own
    logits; with MoE the decode steps' expert ids), the same two through
    the paged engine and the paged path, and the f32 pass at
    ``cfg_f32`` (with ``swap``, also lm_dp_serve's swap pass,
    :func:`lm_dp_swap_run`); saved to ``path`` on the host, the weights
    freed. Returns ({"dense", "paged": each (responses, step times,
    integers)[, "swap"]}, the prefills' drops)."""
    from repro_torch.parallel.sharding import local_context
    from repro_torch.serving import kv_cache as pk

    ctx = local_context()
    params = model.init_params(seed, cfg, ctx, dev)
    prompts, caps, tf_prompts = lm_tp_requests(np, cfg, seed + 2)
    loads = []
    route = _recording_loads(moe, loads)
    runs = {}
    try:
        for name, engine in (("dense", LM_TP_ENGINE),
                             ("paged", LM_TP_PAGED_ENGINE)):
            state, times = lm_serve_run(
                torch, eng, cfg, ctx, params,
                eng.LMEngineConfig(**engine, kernel_backend="auto"),
                prompts, caps, device=dev)
            runs[name] = (lm_responses(np, rb, state, caps,
                                       engine["num_queues"]), times,
                          int_leaves(torch, state))
            del state
        if swap:  # lm_dp_serve's dense engine at a data rank's shapes
            runs["dense_blocked"] = lm_blocked_dense_run(
                torch, eng, model, cfg, ctx, params,
                eng.LMEngineConfig(**LM_TP_ENGINE, kernel_backend="auto"),
                prompts, caps, dev)
        routes = [] if cfg.is_moe else None
        logits, fed, _ = lm_tp_tf_run(torch, model, moe, cfg, ctx, params,
                                      tf_prompts, None, routes=routes,
                                      dev=dev)
        paged_logits, paged_fed, _ = lm_tp_paged_tf_run(
            torch, model, pk, cfg, ctx, params, tf_prompts, None, dev=dev)
    finally:
        moe._route_raw = route
    ref = {"tf_logits": logits, "tf_tokens": fed, "routes": routes,
           "paged_tf_logits": paged_logits, "paged_tf_tokens": paged_fed}
    del params
    params = model.init_params(seed + 1, cfg_f32, ctx, dev)
    logits, fed, st = lm_tp_tf_run(torch, model, moe, cfg_f32, ctx, params,
                                   tf_prompts, None, steps=LM_TP_F32_STEPS,
                                   dev=dev)
    ref.update(f32_logits=logits, f32_tokens=fed,
               f32_k=st.layers["k"].cpu(), f32_v=st.layers["v"].cpu())
    del st
    if swap:
        runs["swap"] = lm_dp_swap_run(torch, np, eng, cfg_f32, ctx, params,
                                      seed + 4, dev)
    del params
    torch.save(ref, path)
    drops = moe_drops(np, moe, cfg, loads) if loads else None
    return runs, drops


def lm_tp_paged_summary(np, cfg, ranks, one):
    """The paged engine's run on the ranks beside the one-process paged
    engine's (``one``: its responses and step times): step times and
    collectives, the kernels' launches against layers x steps (decode)
    and layers x admission steps (flash), the teacher-forced rows, and
    whether the ranks agree."""
    resp_1, times_1 = one
    r0 = ranks[0]["paged"]
    steps = len(r0["steps"])
    admissions = sum(1 for r in r0["steps"] if r["admitted"])
    tokens = sum(len(v) for v in r0["responses"].values())
    return {
        "engine": LM_TP_PAGED_ENGINE, "steps": steps,
        "admission_steps": admissions, "generated_tokens": tokens,
        "tp": _tp_step_summary(r0["steps"]),
        "tp_tokens_per_s": tokens / sum(r["s"] for r in r0["steps"]),
        "one_process": {"step_ms_median": statistics.median(times_1) * 1e3,
                        "tokens_per_s": tokens / sum(times_1)},
        "responses_equal_across_ranks": all(
            r["paged"]["responses"].keys() == r0["responses"].keys()
            and all(np.array_equal(r["paged"]["responses"][k], v)
                    for k, v in r0["responses"].items()) for r in ranks),
        "token_agreement_vs_one_process": sum(
            int((r0["responses"][k] == v).sum())
            for k, v in resp_1.items()) / max(tokens, 1),
        "teacher_forced": r0["tf"],
        "tf_logits_equal_across_ranks": len(
            {r["paged"]["tf_digest"] for r in ranks}) == 1,
        "pool_kv_heads_by_rank": [r["paged"]["pool_kv_heads"]
                                  for r in ranks],
        "paged_launches_by_rank": [
            r["paged"]["launches"].get("paged_attention_stats", 0)
            for r in ranks],
        "paged_launches_expected": cfg.num_layers * steps,
        "flash_launches_by_rank": [
            r["paged"]["launches"].get("flash_attention", 0) for r in ranks],
        "flash_launches_expected": cfg.num_layers * admissions,
        "tf_launches_by_rank": [r["paged"]["tf_launches"] for r in ranks],
        "walk_by_rank": [r["paged"].get("walk") for r in ranks]}


def lm_tp_paged_failures(run):
    """Why the paged run fails its gates (an empty list when it passes):
    the ranks differ, the teacher-forced rows fail lm_serve's rule, or a
    kernel's launches on the ranks are not layers x steps."""
    out = []
    if not (run["responses_equal_across_ranks"]
            and run["tf_logits_equal_across_ranks"]):
        out.append("the ranks differ")
    why = decided_failure(run["teacher_forced"], LM_DECIDED_SHARE)
    if why:
        out.append(why)
    for k in ("paged", "flash"):
        got, want = run[f"{k}_launches_by_rank"], run[f"{k}_launches_expected"]
        if not want or got != [want] * len(got):
            out.append(f"{k} launches {got} != {want}")
    return out


def _tp_step_summary(steps):
    """Medians of the decode steps (no prompt admitted) and of the
    admission steps: host ms, collective ms, calls and bytes."""
    out = {}
    for kind, rows in (("decode", [r for r in steps if not r["admitted"]]),
                       ("admission", [r for r in steps if r["admitted"]])):
        out[kind] = {"steps": len(rows)}
        for k in ("s", "coll_s", "calls", "bytes"):
            vals = [r[k] for r in rows] or [0]
            scale = 1e3 if k in ("s", "coll_s") else 1
            name = {"s": "step_ms_median", "coll_s": "collective_ms_median",
                    "calls": "collective_calls_median",
                    "bytes": "collective_bytes_median"}[k]
            out[kind][name] = statistics.median(vals) * scale
    return out


def phase_lm_tp_serve(torch, np, eng, rb, cfg_mod, model, moe, fa, coll, smi,
                      device="cuda"):
    """Qwen2.5-14B (LM_TP_LAYERS layers) and Qwen3-MoE-30B-A3B
    (LM_TP_MOE_LAYERS) in bf16 over LM_TP_RANKS model ranks sharing the
    card (gloo, host-staged). For each: the one-process run first
    (:func:`lm_tp_reference`, its weights freed), then the ranks
    (:func:`lm_tp_rank`). Fails unless the ranks' responses and
    teacher-forced logits are equal, the teacher-forced rows pass
    lm_serve's rule, each rank's engine run launched flash
    layers x admission steps times, and the f32 pass holds.

    The same ranks then build a (LM_DP_RANKS, 1) mesh and run
    lm_dp_serve (:func:`lm_dp_rank`, held to the same one-process runs),
    and in the dense model's launch lm_tp_families (:func:`lm_fam_rank`,
    each family's one-process run first, :func:`lm_fam_reference`). Each
    phase prints its own line and fails on its own gates (all checked
    before any raises). Returns (the three lines, with each rank's
    kernel launches)."""
    import gc

    from repro_torch.models import transformer as tf_mod
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    root = tempfile.mkdtemp(prefix="orca-tp-")
    transport = ("gloo over loopback TCP; CUDA tensors staged through "
                 "page-locked host buffers (ranks share one card)")
    out = {"phase": "lm_tp_serve", "nvidia_smi": smi, "ranks": LM_TP_RANKS,
           "transport": transport, "engine": LM_TP_ENGINE,
           "requests": LM_TP_REQUESTS, "runs": {}}
    dp_out = {"phase": "lm_dp_serve", "nvidia_smi": smi,
              "data_ranks": LM_DP_RANKS, "transport": transport,
              "engine": LM_TP_ENGINE, "paged_engine": LM_TP_PAGED_ENGINE,
              "requests": LM_TP_REQUESTS,
              "admission": "every rank prefills the whole padded batch "
                           "and keeps its slots' rows", "runs": {}}
    fam_out = {"phase": "lm_tp_families", "nvidia_smi": smi,
               "ranks": LM_TP_RANKS, "transport": transport,
               "layers": LM_FAM_TP_LAYERS, "steps": LM_FAM_TP_STEPS,
               "runs": {}}
    failed, dp_failed, fam_failed = [], [], []
    t_phase = time.perf_counter()
    try:
        for name, arch, layers, seed in (
                ("dense", LM_ARCH, LM_TP_LAYERS, SEED + 90),
                ("moe", LM_MOE_ARCH, LM_TP_MOE_LAYERS, SEED + 95)):
            t0 = time.perf_counter()
            cfg = cfg_mod.get_config(arch).replace(
                use_pallas_flash=True, num_layers=layers)
            if cfg.is_moe:
                cfg = cfg.replace(capacity_factor=LM_TP_MOE_CF)
            tp_ctx = ParallelContext(
                mesh=Mesh((1, LM_TP_RANKS), ("data", "model")))
            plan = tf_mod.plan_for(cfg, tp_ctx)
            # no head padding at this tp: the one-process run draws the
            # same params
            assert (plan.hp, plan.kv_phys) == (cfg.num_heads,
                                               cfg.num_kv_heads), plan
            f32 = dict(num_layers=LM_TP_F32_LAYERS, dtype="float32")
            cfg_f32 = cfg.replace(**f32)
            # one process: dropless at E/k (an expert's buffer the
            # prefill's tokens); the same params at any factor
            ref_cfg = cfg.replace(capacity_factor=cfg.num_experts
                                  / cfg.num_experts_per_tok) \
                if cfg.is_moe else cfg
            path = os.path.join(root, f"{name}.pt")
            torch.backends.cuda.matmul.allow_tf32 = False
            one, drops = lm_tp_reference(
                torch, np, eng, rb, model, moe, fa, ref_cfg, seed, path,
                ref_cfg.replace(**f32), device, swap=not cfg.is_moe)
            (resp_1, times_1, _), paged_1 = one["dense"], one["paged"][:2]
            ref_s = time.perf_counter() - t0
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            # lm_dp_serve: the one-process config (dropless GSPMD
            # moe_apply), the swap pass with the dense model
            spec = {"cfg": cfg, "cfg_f32": cfg_f32, "seed": seed,
                    "ref": path, "ep_shardmap": cfg.is_moe,
                    "device": device, "dp_cfg": ref_cfg,
                    "swap": not cfg.is_moe}
            if not cfg.is_moe:
                t1 = time.perf_counter()
                spec["families"] = lm_fam_references(
                    torch, np, cfg_mod, model, moe, root, device,
                    fam_out["runs"])
                fam_out["reference_s"] = time.perf_counter() - t1
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ranks = coll.launch(lm_tp_rank, LM_TP_RANKS,
                                backend=RANK_BACKEND, args=(spec,),
                                timeout=RANK_TIMEOUT)
            ranks_s = time.perf_counter() - t1
            r0 = ranks[0]
            admissions = sum(1 for r in r0["steps"] if r["admitted"])
            want = cfg.num_layers * admissions
            tokens = sum(len(v) for v in r0["responses"].values())
            same_resp = all(
                r["responses"].keys() == r0["responses"].keys()
                and all(np.array_equal(r["responses"][k], v)
                        for k, v in r0["responses"].items()) for r in ranks)
            agree = sum(int((r0["responses"][k] == v).sum())
                        for k, v in resp_1.items())
            tp_sum = sum(r["s"] for r in r0["steps"])
            run = {"arch": arch, "layers": layers, "dtype": cfg.dtype,
                   "heads_per_rank": (plan.hp // LM_TP_RANKS,
                                      plan.kv_phys // LM_TP_RANKS),
                   "experts_per_rank": cfg.num_experts // LM_TP_RANKS
                   if cfg.is_moe else None,
                   "ep_shardmap": spec["ep_shardmap"],
                   "params_gb_per_rank": r0["params_gb"],
                   "init_s_by_rank": [r["init_s"] for r in ranks],
                   "reference_s": ref_s, "ranks_s": ranks_s,
                   "steps": len(r0["steps"]), "admission_steps": admissions,
                   "generated_tokens": tokens,
                   "tp": _tp_step_summary(r0["steps"]),
                   "tp_tokens_per_s": tokens / tp_sum,
                   "one_process": {
                       "step_ms_median": statistics.median(times_1) * 1e3,
                       "tokens_per_s": tokens / sum(times_1)},
                   "responses_equal_across_ranks": same_resp,
                   "token_agreement_vs_one_process": agree / max(tokens, 1),
                   "teacher_forced": r0["tf"],
                   "tf_logits_equal_across_ranks": len(
                       {r["tf_digest"] for r in ranks}) == 1,
                   "flash_launches_by_rank": [
                       r["launches"].get("flash_attention", 0)
                       for r in ranks],
                   "flash_launches_expected": want,
                   "tf_flash_launches_by_rank": [
                       r["tf_launches"].get("flash_attention", 0)
                       for r in ranks],
                   "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
                   "backend": r0["backend"]}
            run["paged"] = lm_tp_paged_summary(np, cfg, ranks, paged_1)
            if cfg.is_moe:
                run["capacity_factor"] = {
                    "ranks": cfg.capacity_factor,
                    "one_process": ref_cfg.capacity_factor}
                run["one_process_prefill_drops"] = drops
                run["ranks_prefill_drops"] = ep_drops(
                    np, moe, cfg, [r["loads"] for r in ranks])
            run["f32"] = {"layers": LM_TP_F32_LAYERS,
                          "steps": LM_TP_F32_STEPS,
                          "tolerance": "max|diff| <= 1e-5 x max|value| "
                                       "(logits a step, caches a layer)",
                          "by_rank": [r["f32"] for r in ranks]}
            run["seconds"] = time.perf_counter() - t0
            out["runs"][name] = run
            why = decided_failure(r0["tf"], LM_DECIDED_SHARE)
            if not (same_resp and run["tf_logits_equal_across_ranks"]):
                failed.append(f"{name}: the ranks differ")
            if why:
                failed.append(f"{name}: {why}")
            if cfg.is_moe and (drops["dropped"] or any(
                    run["ranks_prefill_drops"][k] for k in
                    ("dropped_sending", "dropped_at_experts"))):
                failed.append(f"{name}: a prefill dropped assignments "
                              f"(one process {drops['dropped']}, ranks "
                              f"{run['ranks_prefill_drops']})")
            if run["flash_launches_by_rank"] != [want] * LM_TP_RANKS:
                failed.append(f"{name}: flash launches "
                              f"{run['flash_launches_by_rank']} != {want}")
            if not all(r["f32"]["within_tolerance"] for r in ranks):
                failed.append(f"{name}: the f32 pass is outside tolerance")
            failed += [f"{name}: paged: {why}"
                       for why in lm_tp_paged_failures(run["paged"])]
            dp = lm_dp_summary(np, ref_cfg, ranks, one)
            dp["seconds_by_rank"] = [r["dp"]["seconds"] for r in ranks]
            dp_out["runs"][name] = dp
            dp_failed += [f"{name}: {why}" for why in lm_dp_failures(dp)]
            if "families" in spec:
                fam_out["seconds_by_rank"] = [r["families_seconds"]
                                              for r in ranks]
                fam_failed += lm_fam_summary(fam_out["runs"], ranks)
            del ranks
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    emit(dp_out)
    emit(fam_out)
    why = [f"{p}: {'; '.join(f)}" for p, f in (
        ("lm_tp_serve", failed), ("lm_dp_serve", dp_failed),
        ("lm_tp_families", fam_failed)) if f]
    if why:
        raise AssertionError(" | ".join(why))
    return out, dp_out, fam_out


def lm_fam_references(torch, np, cfg_mod, model, moe, root, device, runs):
    """Each LM_FAM_TP family's one-process run (:func:`lm_fam_reference`)
    before the ranks start; returns the ranks' specs, and puts each
    family's one-process step times and seconds in ``runs``."""
    fams = {}
    for i, (name, (arch, b, s)) in enumerate(LM_FAM_TP.items()):
        t0 = time.perf_counter()
        cfg = cfg_mod.get_config(arch).replace(
            use_pallas_flash=True, num_layers=LM_FAM_TP_LAYERS)
        cfg_f32 = cfg.replace(num_layers=LM_TP_F32_LAYERS, dtype="float32")
        seed = SEED + 100 + 2 * i
        prompts = lm_fam_prompts(np, cfg, b, s, seed + 3)
        path = os.path.join(root, f"family_{name}.pt")
        timing = lm_fam_reference(torch, np, model, moe, cfg, cfg_f32, seed,
                                  prompts, path, device)
        fams[name] = {"cfg": cfg, "cfg_f32": cfg_f32, "seed": seed,
                      "prompts": prompts, "ref": path}
        runs[name] = {"arch": arch, "prompts": b, "tokens": s,
                      "one_process": {
                          "prefill_ms": timing["prefill_s"] * 1e3,
                          "decode_step_ms_median": statistics.median(
                              timing["step_s"]) * 1e3},
                      "reference_s": time.perf_counter() - t0}
    return fams


def lm_fam_summary(runs, ranks):
    """lm_tp_families' per-family results from the ranks into ``runs``;
    returns the failures: ranks that differ, teacher-forced rows that
    fail lm_serve's rule, an f32 pass outside tolerance, or flash not
    launched once a layer of the prefill on a family that takes it."""
    failed = []
    for name, run in runs.items():
        rs = [r["families"][name] for r in ranks]
        cfg_layers = LM_FAM_TP_LAYERS
        run.update({
            "heads_per_rank": rs[0]["heads_per_rank"],
            "teacher_forced": rs[0]["tf"],
            "tf_logits_equal_across_ranks": len(
                {r["digest"] for r in rs}) == 1,
            "tp": {"prefill_ms_by_rank": [
                r["timing"]["prefill_s"] * 1e3 for r in rs],
                "decode_step_ms_median": statistics.median(
                    rs[0]["timing"]["step_s"]) * 1e3,
                "collective_calls_per_step": rs[0]["timing"]["calls"],
                "collective_bytes_per_step": rs[0]["timing"]["bytes"]},
            "flash_launches_by_rank": [
                r["launches"].get("flash_attention", 0) for r in rs],
            "f32": {"layers": LM_TP_F32_LAYERS, "steps": LM_TP_F32_STEPS,
                    "tolerance": "max|diff| <= 1e-5 x max|value| (logits "
                                 "a step, each decode-state leaf a layer)",
                    "by_rank": [r["f32"] for r in rs]}})
        if not run["tf_logits_equal_across_ranks"]:
            failed.append(f"{name}: the ranks differ")
        why = decided_failure(run["teacher_forced"], LM_DECIDED_SHARE)
        if why:
            failed.append(f"{name}: {why}")
        if not all(r["f32"]["within_tolerance"] for r in rs):
            failed.append(f"{name}: the f32 pass is outside tolerance")
        want = 0 if name == "ssm" else cfg_layers
        if run["flash_launches_by_rank"] != [want] * len(rs):
            failed.append(f"{name}: flash launches "
                          f"{run['flash_launches_by_rank']} != {want}")
    return failed


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import configs as lm_configs
    from repro_torch.core import dlrm
    from repro_torch.core import engine as eng
    from repro_torch.core import kvstore as kv
    from repro_torch.core import ringbuf as rb
    from repro_torch.core import transaction as tx
    from repro_torch.core import tx_app
    from repro_torch.fault import recovery as frec
    from repro_torch.fault import soak
    from repro_torch.launch import serve
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_reduce as er
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import tx_commit as tc
    from repro_torch.models import model, moe
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context
    from repro_torch.serving import kv_cache as pk

    torch.manual_seed(SEED)
    smi = phase_device(torch, _build)
    phase_launch_floor(torch, smi)

    # KVS: the store (10.2 GB) is freed before the next path
    cfg, state, stored, load_launches = phase_load(torch, kv, hp)
    entries = phase_kernels(torch, kv, hp, ref, cfg, state)
    launches = phase_serve(torch, np, eng, kv, hp, cfg, state, stored, smi)
    for name, e in entries.items():
        e["launches"] = launches[name] + load_launches[name]
    del state
    torch.cuda.empty_cache()

    # TX
    tcfg = tx.TxConfig(**TX_SHAPE)
    tx_entries = phase_tx_kernels(torch, tx, tc, ref, tcfg)
    out, es, snap, stream, app_fn, ecfg = phase_tx_serve(
        torch, np, eng, tx, tx_app, tc, tcfg, smi)
    resync = phase_tx_resync(torch, tx, tc, tcfg, es, snap)
    out["profile"], _ = profile_steps(torch, eng, es, app_fn, ecfg,
                                      stream[STEPS * BATCH:])
    out["profile"]["idle_share"] = 1 - out["profile"][
        "device_us_per_step"] / out["kernels"]["step_us_median"]
    emit(out)
    emit(resync)
    tx_entries["commit_chain"]["launches"] = out["launches"]["commit_chain"]
    tx_entries["commit"]["launches"] = resync["launches"]["commit"]
    entries.update(tx_entries)
    del es, snap, stream
    torch.cuda.empty_cache()

    # fault tolerance and durability: each phase's launches join the
    # kernels' counts of the main path
    for out in (phase_tx_soak(torch, tc, soak, smi),
                phase_tx_crash(torch, tx, tc, soak, smi)):
        for name in ("commit", "commit_chain"):
            entries[name]["launches"] += out["launches"][name]
        torch.cuda.empty_cache()
    # the SPMD chain: its ranks share the card, after the parent's tensors
    # are freed; each launches commit once a batch
    gc.collect()
    torch.cuda.empty_cache()
    out = phase_tx_spmd(torch, coll, smi)
    spmd = sum(r["commit"] for r in out["launches_by_rank"])
    entries["commit"]["launches"] += spmd
    entries["commit"]["tx_spmd_launches"] = spmd
    out = phase_kvs_recover(torch, eng, kv, hp, soak, frec, smi)
    for name, n in out["launches"].items():
        entries[name]["launches"] += n
    torch.cuda.empty_cache()

    # DLRM
    dcfg = dlrm.DLRMConfig(**DLRM_SHAPE)
    params = dlrm.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(SEED + 9),
        device="cuda")
    dl_entries = phase_dlrm_kernels(torch, np, F, dlrm, er, ref, dcfg, params)
    out = phase_dlrm_serve(torch, np, eng, dlrm, er, dcfg, params, smi)
    emit(out)
    dl_entries["embedding_reduce"]["launches"] = \
        out["launches"]["embedding_reduce"]
    entries.update(dl_entries)
    del params
    torch.cuda.empty_cache()
    phase_merci(torch, np, dlrm)
    torch.cuda.empty_cache()

    # LM serving: the kernels at the serve shapes, then the engine
    ctx = local_context()
    lm_entries = phase_lm_kernels(torch, np, F, pa, fa, ref, lm_configs, smi)
    phase_lm_serve_f32(torch, np, eng, rb, lm_configs, model, pa, fa, ctx,
                       smi)
    crash = phase_lm_crash(torch, eng, lm_configs, model, pk, pa, fa, soak,
                           ctx, smi)
    launches = phase_lm_serve(torch, np, eng, rb, lm_configs, model, pk, pa,
                              fa, ref, ctx, smi, layers=LM_LAYERS)
    # the dense weights are freed: the MoE model takes their place
    moe_launches = phase_lm_serve(
        torch, np, eng, rb, lm_configs, model, pk, pa, fa, ref, ctx, smi,
        phase="lm_moe_serve", arch=LM_MOE_ARCH, requests=LM_MOE_REQUESTS,
        seed=SEED + 35, moe=moe, layers=LM_MOE_LAYERS)
    # the other families, each after the previous model's weights are freed
    vlm_launches = phase_lm_serve(
        torch, np, eng, rb, lm_configs, model, pk, pa, fa, ref, ctx, smi,
        phase="lm_vlm_serve", arch=LM_VLM_ARCH, requests=LM_VLM_REQUESTS,
        layers=LM_VLM_LAYERS,
        seed=SEED + 40, extra=lambda cfg, params: lm_media_check(
            torch, model, fa, params, cfg, ctx, SEED + 44))
    hybrid_launches, hybrid_f32, hybrid_cycle = phase_lm_hybrid_serve(
        torch, np, eng, serve, rb, lm_configs, model, ops, pa, fa, ref, ctx,
        smi)
    phase_lm_ssm_serve(torch, np, eng, serve, rb, lm_configs, model, pa, fa,
                       ctx, smi)
    audio_launches = phase_lm_audio(torch, np, lm_configs, model, ops, pa,
                                    fa, ref, ctx, smi)
    # training, after the serving weights are freed: no hand-written
    # kernel on its path
    phase_lm_train(torch, np, lm_configs, model, (hp, tc, er, pa, fa), ctx,
                   smi)
    # ZeRO-1 data-parallel training: 2 ranks on the card; its
    # single-process steps are tp_train's reference too
    gc.collect()
    torch.cuda.empty_cache()
    zero1 = {}
    try:
        phase_zero1_train(torch, np, lm_configs, model, coll, smi,
                          keep=zero1)
        # training under tensor parallelism: 2 model ranks on the card
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp_train(torch, np, lm_configs, model, moe, coll, smi, zero1)
    finally:
        if "root" in zero1:
            shutil.rmtree(zero1["root"], ignore_errors=True)
    # tensor-parallel LM serving: 2 model ranks on the card
    gc.collect()
    torch.cuda.empty_cache()
    tp, dp, fam = phase_lm_tp_serve(torch, np, eng, rb, lm_configs, model,
                                    moe, fa, coll, smi)
    for name, e in lm_entries.items():
        e["launches"] = (launches[name] + crash["launches"][name]
                         + moe_launches[name] + vlm_launches[name]
                         + hybrid_launches[name] + hybrid_cycle[name]
                         + audio_launches[name])
        e["moe_shape"]["launches"] = moe_launches[name]
        e["vlm_shape"]["launches"] = vlm_launches[name]
    flash = lm_entries["flash_attention"]
    flash["hybrid_shape"]["launches"] = (hybrid_launches["flash_attention"]
                                         + hybrid_cycle["flash_attention"])
    # the f32 hybrid shape runs in a check, not on a main path
    flash["hybrid_f32_shape"]["launches"] = 0
    flash["hybrid_f32_shape"]["check_launches"] = hybrid_f32
    flash["audio_shape"]["launches"] = audio_launches["flash_attention"]
    # each tensor-parallel rank's engines run at its own head count: the
    # dense engine's admissions and the paged engine's admissions and
    # decode steps
    paged = lm_entries["paged_attention_stats"]
    for name in ("dense", "moe"):
        run = tp["runs"][name]
        n = sum(run["flash_launches_by_rank"]) + sum(
            run["paged"]["flash_launches_by_rank"])
        flash[f"tp_{name}_shape"]["launches"] = n
        flash["launches"] += n
        n = sum(run["paged"]["paged_launches_by_rank"])
        paged[f"tp_{name}_shape"]["launches"] = n
        paged["launches"] += n
    # each data rank's engines walk its half of the slots at every head
    # (the dense model: row 9e; the MoE model at its 4 kv heads of 8) and
    # prefill the whole admission batch at every head
    for name, shape in (("dense", None), ("moe", "moe_shape")):
        runs = dp["runs"][name]["runs"]
        n = sum(sum(r["flash_launches_by_rank"]) for r in runs.values())
        flash["launches"] += n
        if shape:
            flash[shape]["launches"] += n
        n = sum(runs["paged"]["paged_launches_by_rank"])
        paged["launches"] += n
        if shape:
            paged[shape]["launches"] += n
        else:
            paged["dp_dense_shape"]["launches"] = n
    # a tensor-parallel rank's heads of the vlm, hybrid and audio prefills
    for name in ("vlm", "hybrid", "audio"):
        n = sum(fam["runs"][name]["flash_launches_by_rank"])
        flash[f"tp_{name}_shape"]["launches"] = n
        flash["launches"] += n
    entries.update(lm_entries)

    dead = [k for k, e in entries.items()
            if not e["launches"] and k not in CHECK_ONLY]
    for k in CHECK_ONLY:
        entries[k]["main_path"] = False
    if dead or len(entries) != len(KERNELS):
        raise AssertionError(f"kernels not launched on their path: {dead}")
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
