"""Deterministic sharded data pipeline with background prefetch, the JAX
package's ``repro/data/pipeline.py`` (numpy only; kept as a copy so the
port imports nothing of the JAX package).

Synthetic token streams are drawn per ``(seed, step)`` from a counter-
based generator, so every host draws only its rows, a restart resumes
exactly (the checkpoint stores the step), and the global batch of a step
does not depend on the host count. A file-backed variant strides through
a memory-mapped flat token file the same way.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


def _batch_for_step(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
                    step: int, token_file: Optional[np.memmap] = None):
    """The full deterministic global batch of a step, then the host's
    slice: {"tokens", "labels"} int32 (B/hosts, S[, K]), and "media"
    f32 (B/hosts, M, D) for a vlm config."""
    b, s = shape.global_batch, shape.seq_len
    assert b % dcfg.num_hosts == 0, "global batch must divide host count"
    bl = b // dcfg.num_hosts
    lo = dcfg.host_id * bl
    rng = np.random.default_rng((dcfg.seed, step))
    if token_file is None:
        full_shape = (b, s + 1) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks else ())
        toks = rng.integers(0, cfg.vocab_size, size=full_shape,
                            dtype=np.int32)
        toks = toks[lo: lo + bl]
    else:
        n = token_file.shape[0]
        starts = rng.integers(0, n - (s + 1), size=b)
        rows = [np.asarray(token_file[st: st + s + 1])
                for st in starts[lo: lo + bl]]
        toks = np.stack(rows).astype(np.int32) % cfg.vocab_size
        if cfg.num_codebooks:
            toks = np.stack([np.roll(toks, k, axis=1)
                             for k in range(cfg.num_codebooks)], -1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.media_tokens:
        m = rng.standard_normal((bl, cfg.media_tokens, cfg.d_model)).astype(
            np.float32)
        batch["media"] = m * 0.02
    return batch


class TokenPipeline:
    """Background-prefetching iterator over deterministic step batches:
    ``next()`` gives (step, batch of numpy arrays)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 dcfg: DataConfig = DataConfig(), start_step: int = 0,
                 token_path: Optional[str] = None):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self._step = start_step
        self._mm = np.memmap(token_path, dtype=np.int32) if token_path \
            else None
        self._q: queue.Queue = queue.Queue(maxsize=dcfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = _batch_for_step(self.cfg, self.shape, self.dcfg, step,
                                    self._mm)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def batch_for_step(cfg, shape, dcfg, step):
    """The batch of ``step`` without the thread (tests, elastic checks)."""
    return _batch_for_step(cfg, shape, dcfg, step)
