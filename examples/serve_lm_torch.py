"""LM serving through the PyTorch/CUDA port of the ORCA engine: continuous
batching, ring-buffer admission, cpoll notification. Clients inject
prompts, the engine prefills into free slots and decodes every active
slot each tick; with --paged, decode walks the shared KV page pool
through the CUDA paged-attention kernel.

    PYTHONPATH=src python examples/serve_lm_torch.py --paged     # one GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --paged \
        --arch qwen3-moe-30b-a3b                                  # MoE
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
        --arch hymba-1.5b                                         # hybrid

``--arch`` serves that config's reduced form: dense, MoE and vlm
(``qwen2-vl-7b``) on either path, ssm (``rwkv6-1.6b``) and hybrid
(``hymba-1.5b``) on the dense path only (``--paged`` refuses them).

The fault and durability flags pass through to ``repro_torch.launch.serve``:
``--inject-faults SEED``, ``--snapshot-dir DIR``, ``--snapshot-every N``,
``--durability-mode {full,delta,adaptive}`` and ``--recover``.
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import argparse

from repro_torch.launch import serve as serve_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--paged", action="store_true",
                    help="decode through the shared KV page pool")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "cuda", "ref"))
    # every other flag (the fault and durability ones) goes through as is
    args, rest = ap.parse_known_args()
    argv = [
        "--arch", args.arch,
        "--requests", str(args.requests),
        "--prompt-len", "12", "--gen-len", "8",
        "--device", args.device,
        "--backend", args.backend,
    ] + (["--paged"] if args.paged else []) + rest
    serve_mod.main(argv)


if __name__ == "__main__":
    main()
