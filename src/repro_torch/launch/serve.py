"""Serving launcher: the ORCA engine driving LM token generation.

Clients write prompts into request rings → the cpoll pointer-buffer scan
notices them → round-robin admission into continuous-batching slots
(prefill) → one decode step per engine tick → finished generations land
in response rings → clients poll and return credit.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged   # on a GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

It serves the reduced (tiny, f32) config of ``--arch`` with random
weights from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.core import ringbuf as rb
from repro_torch.models import (
    decode_step, init_params, make_decode_state, prefill,
)
from repro_torch.parallel.sharding import local_context


def build_engine(cfg, ctx, ecfg: eng.LMEngineConfig, params, device="cuda"):
    """(step, initial state) for either decode substrate; ``step(state)``
    returns the next state. The paged step updates the page pool in place,
    so a state passed to ``step`` must not be used again."""
    if ecfg.paged:
        def step(s):
            return eng.lm_engine_step(s, ecfg, cfg, ctx, params)

        return step, eng.lm_make_paged(ecfg, cfg, ctx, device)

    def prefill_fn(p, prompts):
        st = make_decode_state(cfg, ctx, ecfg.admit_per_step, ecfg.cache_len,
                               device)
        return prefill(p, prompts, st, cfg, ctx, chunk=16,
                       backend=ecfg.kernel_backend)

    def decode_fn(p, toks, st):
        return decode_step(p, toks, st, cfg, ctx)

    def step(s):
        return eng.lm_engine_step(s, ecfg, cfg, ctx, params, prefill_fn,
                                  decode_fn)

    state = eng.lm_make(
        ecfg, make_decode_state(cfg, ctx, ecfg.slots, ecfg.cache_len, device))
    return step, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--queues", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--paged", action="store_true",
                    help="decode through the shared KV page pool")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="device pool pages (0 = worst-case auto-size)")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host cold-tier pages (>0 oversubscribes the "
                         "device pool with evict/restore)")
    ap.add_argument("--eos-token", type=int, default=-1,
                    help="EOS token id for early termination (-1 = off)")
    ap.add_argument("--vary-caps", action="store_true",
                    help="draw per-request generation caps in [1, gen_len]")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "ref"),
                    help="kernel dispatch for the paged-attention walk")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = reduced(get_config(args.arch)).replace(dtype="float32")
    ctx = local_context()
    params = init_params(args.seed, cfg, ctx, device)
    ecfg = eng.LMEngineConfig(
        num_queues=args.queues, capacity=16,
        prompt_len=args.prompt_len, gen_len=args.gen_len,
        slots=8, admit_per_step=2,
        cache_len=args.prompt_len + args.gen_len + 4,
        eos_token=args.eos_token,
        paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages,
        host_pages=args.host_pages if args.paged else 0,
        expected_gen_len=max(args.gen_len // 2, 1) if args.host_pages else 0,
        kernel_backend=args.backend,
    )
    step, state = build_engine(cfg, ctx, ecfg, params, device)
    swap = cold = None
    if ecfg.paged and ecfg.host_pages:
        swap, cold, _ = eng.make_swap_service(ecfg, cfg, ctx)

    rng = np.random.default_rng(args.seed)
    clients = [rb.HostClient(i, ecfg.capacity, ecfg.prompt_len)
               for i in range(args.queues)]
    sent = recv = ticks = tokens_out = 0
    outputs = []
    t0 = time.time()
    while recv < args.requests and ticks < args.requests * (args.gen_len + 16):
        qids, pls, caps = [], [], []
        for c in clients:
            if sent < args.requests and c.can_send() and rng.random() < 0.7:
                prompt = rng.integers(1, cfg.vocab_size, args.prompt_len)
                caps.append(int(rng.integers(1, args.gen_len + 1))
                            if args.vary_caps else 0)
                qids.append(c.queue_id)
                pls.append(prompt.astype(np.int32))
                c.note_sent()
                sent += 1
        if qids:
            state = eng.lm_inject(state, qids, np.stack(pls), gen_caps=caps)
        state = step(state)
        if swap is not None:
            state = swap(state)
        ticks += 1
        # clients poll responses (entry = [count | tokens..., zero pad])
        avail = rb.available(state.resp).cpu().numpy()
        for qi in range(args.queues):
            n = int(avail[qi])
            if not n:
                continue
            ents = rb.peek(
                state.resp, torch.full((n,), qi, dtype=torch.int32,
                                       device=device),
                torch.arange(n, dtype=torch.int32, device=device)).cpu()
            for ent in ents.numpy():
                n_gen = int(ent[0])
                outputs.append((qi, ent[1:1 + n_gen].tolist()))
                tokens_out += n_gen
                clients[qi].note_received()
                recv += 1
        if avail.sum():
            state = state._replace(resp=rb.pop(
                state.resp,
                torch.arange(args.queues, dtype=torch.int32, device=device),
                torch.as_tensor(avail, dtype=torch.int32).to(device)))
    dt = time.time() - t0
    print(f"served {recv}/{sent} requests ({tokens_out} tokens) in {ticks} "
          f"engine ticks ({dt:.1f}s wall, {recv / max(dt, 1e-9):.1f} req/s "
          f"on {device.type})")
    if cold is not None:
        print(f"  cold tier: {cold.evictions} evictions, "
              f"{cold.restores} restores, {cold.pages_used} pages stranded")
    for qi, toks in outputs[:4]:
        print(f"  queue {qi}: generated {toks}")
    assert recv == args.requests, "all requests must complete"
    return recv


if __name__ == "__main__":
    main()
