"""End-to-end training driver on the PyTorch port: a small model of
qwen1.5-0.5b's family trained for a few hundred steps with the full
substrate — deterministic data pipeline, AdamW with the warmup-cosine
schedule, async checkpointing, the straggler watchdog, resume on
restart. On one GPU by default; ``--device cpu`` runs it here in minutes.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 300
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

import argparse
import os
import tempfile

from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    loss = train_mod.main([
        "--arch", "qwen1.5-0.5b",
        "--steps", str(args.steps),
        "--seq-len", "64", "--batch", "8",
        "--ckpt-every", "100",
        "--ckpt-dir", args.ckpt_dir,
        "--log-every", "20",
        "--device", args.device,
    ])
    print(f"example finished, final loss {loss:.4f}")


if __name__ == "__main__":
    main()
