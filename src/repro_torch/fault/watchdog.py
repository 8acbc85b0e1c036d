"""Fault tolerance driver utilities: straggler detection, retry, heartbeat.

A copy of the JAX package's ``fault/watchdog.py`` (plain Python; this
package imports nothing of ``repro``). Three things dominate downtime at
scale: slow hosts (stragglers), transient device/runtime errors, and
outright node loss.

* :class:`StragglerDetector` — EMA of step wall-time; a step slower than
  ``threshold × EMA`` flags the host, and ``patience`` consecutive flags
  request an eviction (``launch/serve.py`` counts the flagged ticks).
* :func:`with_retries` — exponential-backoff retry for transient errors;
  non-transient errors re-raise immediately.
* :class:`Heartbeat` — a mtime-touched file per host; a coordinator declares
  a host dead when the heartbeat is stale (tested via file mtimes).
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StragglerDetector:
    alpha: float = 0.2  # EMA coefficient
    threshold: float = 2.5  # x EMA -> straggler
    patience: int = 3  # consecutive flags before eviction request
    warmup: int = 3  # ignore the first steps (compile)
    ema: Optional[float] = None
    steps: int = 0
    consecutive: int = 0
    events: list = field(default_factory=list)

    def observe(self, step_time: float) -> dict:
        """Returns {'straggler': bool, 'evict': bool, 'ema': float}."""
        self.steps += 1
        if self.steps <= self.warmup:
            return {"straggler": False, "evict": False, "ema": step_time}
        if self.ema is None:
            self.ema = step_time
        straggler = step_time > self.threshold * self.ema
        if straggler:
            self.consecutive += 1
            self.events.append((self.steps, step_time, self.ema))
        else:
            self.consecutive = 0
            self.ema = (1 - self.alpha) * self.ema + self.alpha * step_time
        return {
            "straggler": straggler,
            "evict": self.consecutive >= self.patience,
            "ema": self.ema,
        }


TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                     "DataLoss", "connection", "heartbeat")


def is_transient(err: BaseException) -> bool:
    s = f"{type(err).__name__}: {err}"
    return any(m.lower() in s.lower() for m in TRANSIENT_MARKERS)


def with_retries(fn: Callable, *args, retries: int = 3, backoff: float = 0.1,
                 jitter: float = 0.0, on_retry: Optional[Callable] = None,
                 sleep: Callable = time.sleep, rng=None, **kwargs):
    """Run fn with exponential backoff on transient errors.

    The delay before retry ``k`` (1-based) is ``backoff * 2**(k-1)``,
    scaled by a uniform factor in ``[1-jitter, 1+jitter]`` when
    ``jitter > 0`` (decorrelates retry storms across hosts; ``rng`` is a
    ``random.Random``-like source, default the module ``random``).
    ``sleep`` is injectable so tests (and simulated drivers) can capture
    the schedule instead of waiting it out."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            attempt += 1
            if attempt > retries or not is_transient(e):
                raise
            if on_retry:
                on_retry(attempt, e)
            delay = backoff * (2 ** (attempt - 1))
            if jitter:
                src = rng if rng is not None else random
                delay *= 1 + jitter * (2 * src.random() - 1)
            sleep(delay)


class Heartbeat:
    """File-mtime heartbeat: hosts touch, the coordinator sweeps."""

    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"heartbeat_{host_id}")
        os.makedirs(directory, exist_ok=True)

    def beat(self):
        with open(self.path, "a"):
            os.utime(self.path, None)

    @staticmethod
    def dead_hosts(directory: str, timeout: float, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.time()
        dead = []
        if not os.path.isdir(directory):
            return dead
        for name in os.listdir(directory):
            if name.startswith("heartbeat_"):
                hid = int(name.split("_")[1])
                if now - os.path.getmtime(os.path.join(directory, name)) > timeout:
                    dead.append(hid)
        return sorted(dead)
