"""Serving launcher: the ORCA engine driving LM token generation.

Clients write prompts into request rings → the cpoll pointer-buffer scan
notices them → round-robin admission into continuous-batching slots
(prefill) → one decode step per engine tick → finished generations land
in response rings → clients poll and return credit.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged   # on a GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

It serves the reduced (tiny, f32) config of ``--arch`` with random
weights from ``--seed``: a dense or MoE config (e.g. ``--arch
qwen3-moe-30b-a3b``), the vlm ``qwen2-vl-7b`` (M-RoPE positions, no
media: the engine's prompts are tokens), or the recurrent
``rwkv6-1.6b`` (ssm) and ``hymba-1.5b`` (hybrid), which decode on the
dense path only, so ``--paged`` refuses them as the JAX package does. The
audio family takes codebook frames, which the engine's rings do not
carry: ``musicgen-large`` runs through ``models.prefill`` and
``decode_step`` instead. The fault and durability flags are the JAX
launcher's: ``--inject-faults SEED`` drives the request path through a
seeded ``fault.FaultInjector``; ``--snapshot-dir`` / ``--snapshot-every``
/ ``--durability-mode`` flush the paged engine (and its host cold tier)
through ``fault.DurabilityManager``; ``--recover`` restores the latest
committed snapshot plus WAL before serving.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.core import placement
from repro_torch.core import ringbuf as rb
from repro_torch.fault import (
    DurabilityConfig, DurabilityManager, FaultConfig, FaultInjector,
    NackError, StragglerDetector, recover, request_with_retries,
)
from repro_torch.models import (
    DecodeState, decode_step, init_params, make_decode_state, prefill,
)
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import rows_context, whole_batch
from repro_torch.parallel.sharding import local_context


def engine_step(cfg, ctx, ecfg: eng.LMEngineConfig, params, device="cuda"):
    """``step(state) -> state`` of either decode substrate. The paged step
    updates the page pool in place, so a state passed to ``step`` must not
    be used again.

    Under a mesh (``params`` this rank's blocks) either step runs on
    every rank: each holds a replica of the engine's integers (rings,
    slots, positions; the paged step's page table, free list and
    lengths) and takes every decision, and its block of the decode state
    or the page pool: its kv heads under tensor parallelism, and over
    data ranks its rows of the slots (``models.model.batch_rows``; the
    paged pool's pages of its slots). A decode step runs on the rank's
    rows and gathers the greedy tokens over the data axes; an admission
    prefill runs the whole padded batch on every rank
    (``models.model.whole_batch``), which keeps its slots' rows. The
    logits a rank reads are whole, so every rank emits the same
    responses."""
    if ecfg.paged:
        def step(s):
            return eng.lm_engine_step(s, ecfg, cfg, ctx, params)

        return step
    pctx = whole_batch(ctx)
    dctx = rows_context(ecfg.slots, ctx)

    def prefill_fn(p, prompts):
        parts = []
        for b in eng.admission_blocks(prompts.shape[0], cfg, ctx):
            st = make_decode_state(cfg, pctx, b.stop - b.start,
                                   ecfg.cache_len, device)
            parts.append(prefill(p, prompts[b], st, cfg, pctx, chunk=16,
                                 backend=ecfg.kernel_backend))
        if len(parts) == 1:
            return parts[0]
        states, logits = zip(*parts)
        return DecodeState(
            {k: torch.cat([st.layers[k] for st in states], 1)
             for k in states[0].layers},
            torch.cat([st.pos for st in states])), torch.cat(logits)

    def decode_fn(p, toks, st):
        return decode_step(p, toks, st, cfg, dctx)

    def step(s):
        return eng.lm_engine_step(s, ecfg, cfg, ctx, params, prefill_fn,
                                  decode_fn)

    return step


def build_engine(cfg, ctx, ecfg: eng.LMEngineConfig, params, device="cuda"):
    """(step, initial state) for either decode substrate (see
    :func:`engine_step`)."""
    step = engine_step(cfg, ctx, ecfg, params, device)
    if ecfg.paged:
        return step, eng.lm_make_paged(ecfg, cfg, ctx, device)
    return step, eng.lm_make(
        ecfg, make_decode_state(cfg, ctx, ecfg.slots, ecfg.cache_len, device))


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
    ap.add_argument("--inject-faults", type=int, default=None, metavar="SEED",
                    help="drive the request path through a seeded "
                         "fault.FaultInjector (drop/dup/corrupt/delay/"
                         "doorbell-suppress); completion then counts "
                         "entries that actually landed")
    ap.add_argument("--snapshot-dir", default=None,
                    help="flush engine-state snapshots to this host "
                         "NVM-tier directory (fault.recovery: atomic "
                         ".tmp-rename commit on the checkpoint thread, "
                         "overlapping the engine step)")
    ap.add_argument("--snapshot-every", type=int, default=16,
                    help="engine ticks between snapshot flushes")
    ap.add_argument("--durability-mode", default="full",
                    choices=("full", "delta", "adaptive"),
                    help="flush policy: full snapshots, streaming WAL "
                         "deltas (group-fsynced segment log), or adaptive "
                         "(measured dirty fraction + MemoryBudget "
                         "pressure pick per flush)")
    ap.add_argument("--recover", action="store_true",
                    help="restore the latest committed snapshot from "
                         "--snapshot-dir before serving (crash-restart "
                         "path; torn .tmp leftovers are garbage-collected)")
    args = ap.parse_args(argv)

    if args.recover and args.snapshot_dir is None:
        ap.error("--recover requires --snapshot-dir")

    device = torch.device(args.device)
    cfg = reduced(get_config(args.arch)).replace(dtype="float32")
    if cfg.num_codebooks:
        ap.error(f"--arch {args.arch}: the engine serves token prompts, "
                 "not codebook frames")
    if args.paged and cfg.family in ("ssm", "hybrid"):
        ap.error(f"--paged: the {cfg.family} family decodes on the dense "
                 "path only")
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
    swap = cold = budget = None
    if ecfg.paged and ecfg.host_pages:
        # one ledger for both consumers of host memory: cold-tier slabs
        # reserve DRAM against it, and the durability tier reads its
        # pressure when splitting full-vs-delta flushes
        pcfg = eng.lm_paged_kv_config(ecfg, cfg, ctx)
        page_b = (2 * pcfg.layers * pcfg.page_size * pcfg.kv_heads
                  * pcfg.head_dim * dtype_of(cfg.dtype).itemsize)
        budget = placement.MemoryBudget(
            dram_bytes=2 * ecfg.host_pages * page_b, nvm_bytes=1 << 34)
        swap, cold, _ = eng.make_swap_service(ecfg, cfg, ctx, budget=budget)

    mgr = None
    if args.snapshot_dir is not None:
        mgr = DurabilityManager(DurabilityConfig(
            args.snapshot_dir, every=args.snapshot_every,
            mode=args.durability_mode,
        ), budget=budget, cold=cold)
    if args.recover:
        # the fresh state is the geometry template; recovered leaves are
        # built on its device and own their memory. With a cold tier the
        # parked slabs and residency maps restore into it from the same
        # stream.
        state, recovered_step = recover(args.snapshot_dir, state, cold=cold,
                                        kernel_backend=args.backend)
        print(f"recovered engine state at step {recovered_step} from "
              f"{args.snapshot_dir}")

    rng = np.random.default_rng(args.seed)
    clients = [rb.HostClient(i, ecfg.capacity, ecfg.prompt_len)
               for i in range(args.queues)]
    fi = None
    straggler = StragglerDetector()
    stragglers = 0
    if args.inject_faults is not None:
        fi = FaultInjector(FaultConfig(
            seed=args.inject_faults, p_drop=0.05, p_dup=0.05,
            p_corrupt=0.05, p_delay=0.08, p_suppress=0.05,
        ))

    def send_faulted(qi, entry):
        # ring-credit rejection raises so request_with_retries resubmits
        nonlocal state
        state, acc = fi.inject(state, qi, entry)
        if not acc:
            raise NackError(0, f"ring credit exhausted on queue {qi}")

    sent = recv = ticks = tokens_out = 0
    outputs = []

    def serving_done():
        if fi is None:
            return recv >= args.requests
        # drops/dups decouple recv from sent: completion = every entry
        # that actually landed in a ring answered, nothing still in flight
        return (sent >= args.requests and fi.in_flight == 0
                and recv >= fi.counters["landed"])

    t0 = time.time()
    while not serving_done() and ticks < args.requests * (args.gen_len + 16):
        qids, pls, caps = [], [], []
        for c in clients:
            if sent < args.requests and c.can_send() and rng.random() < 0.7:
                prompt = rng.integers(1, cfg.vocab_size, args.prompt_len)
                cap = (int(rng.integers(1, args.gen_len + 1))
                       if args.vary_caps else 0)
                if fi is not None:
                    entry = np.concatenate([prompt, [cap]]).astype(np.int32)
                    try:
                        request_with_retries(send_faulted, c.queue_id, entry,
                                             retries=2, backoff=0.001)
                    except NackError:
                        continue  # no credit this tick; try again later
                    sent += 1
                    continue
                qids.append(c.queue_id)
                pls.append(prompt.astype(np.int32))
                caps.append(cap)
                c.note_sent()
                sent += 1
        if qids:
            state = eng.lm_inject(state, qids, np.stack(pls), gen_caps=caps)
        if fi is not None:
            state, _ = fi.tick(state)
        t_step = time.time()
        state = step(state)
        if swap is not None:
            state = swap(state)
        # clients poll responses (entry = [count | tokens..., zero pad]);
        # reading the counts waits for the step
        avail = rb.available(state.resp).cpu().numpy()
        stragglers += int(straggler.observe(time.time() - t_step)["straggler"])
        ticks += 1
        if mgr is not None and ticks % args.snapshot_every == 0:
            # synchronous device->host copy, async file write: the next
            # step may write the pool in place while the NVM tier's
            # atomic .tmp-rename commit happens off-thread
            mgr.flush(state)
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
    if mgr is not None:
        mgr.flush(state)
        mgr.wait()
    dt = time.time() - t0
    print(f"served {recv}/{sent} requests ({tokens_out} tokens) in {ticks} "
          f"engine ticks ({dt:.1f}s wall, {recv / max(dt, 1e-9):.1f} req/s "
          f"on {device.type})")
    if mgr is not None:
        print(f"  snapshots: {len(mgr.committed())} committed to "
              f"{args.snapshot_dir} ({mgr.flush_bytes()} bytes flushed)")
        s = mgr.stats()
        print(f"  durability: {s['fsyncs']} fsyncs / {s['wal_records']} WAL "
              f"records, {s['disk_bytes']} bytes on disk, "
              f"{s['gc_removed']} artifacts GC'd, flush wait "
              f"{s['flush_wait_us']:.0f}us, {s['flushes_skipped']} skipped, "
              f"{s['host_copy_bytes']} bytes copied to the host in "
              f"{s['host_copy_us']:.0f}us")
        if budget is not None:
            print(f"  budget: dram {budget.used('dram')}/"
                  f"{budget.capacity['dram']}B used, "
                  f"{budget.bytes_written['nvm']}B written to the NVM tier")
    if cold is not None:
        print(f"  cold tier: {cold.evictions} evictions, "
              f"{cold.restores} restores, {cold.pages_used} pages stranded")
    if stragglers:
        print(f"  straggler ticks: {stragglers} "
              f"(EMA threshold x{straggler.threshold})")
    for qi, toks in outputs[:4]:
        print(f"  queue {qi}: generated {toks}")
    if fi is not None:
        c = fi.counters
        print(f"  faults: offered={c['offered']} landed={c['landed']} "
              f"dropped={c['dropped']} duplicated={c['duplicated']} "
              f"corrupted={c['corrupted']} delayed={c['delayed']} "
              f"suppressed={c['suppressed']} rejected={c['rejected']}")
        if recv != c["landed"]:
            raise AssertionError(
                "every landed entry must be answered exactly once")
    elif args.recover:
        # a recovered run inherits the crashed process's in-flight backlog
        # (restored ring/slot occupancy): this process's recv counts both
        # inherited and fresh completions, so only liveness is checked
        if recv <= 0:
            raise AssertionError("recovered engine must make progress")
    elif recv != args.requests:
        raise AssertionError("all requests must complete")
    return recv


if __name__ == "__main__":
    main()
