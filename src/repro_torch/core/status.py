"""Per-request status words: the engine's failure vocabulary.

Every response ring entry leads with one int32 status word. Application
success codes are non-negative and app-defined (KVS GET: 1 found / 0 miss;
KVS PUT: 1 ok / 0 structurally dropped; TX: 1 committed / 2 deferred;
DLRM: 1 ok); every *failure the engine or app detects* is a negative NACK
code from this module, so one sign test (:func:`is_nack`) classifies any
response regardless of the app:

* ``MALFORMED`` — payload validation failed inside the app step
  (bad opcode, op-count overflow, out-of-range offset): the request is
  rejected without touching state instead of scattering garbage.
* ``SHED`` — the scheduler predicted the entry's deadline cannot be met
  at its queue position and shed it before spending budget on it.
* ``TIMEOUT`` — the deadline had already expired when the scheduler saw
  the entry.

Deadline semantics (``EngineConfig.deadline_word``): a request payload may
carry an absolute engine-step deadline in one designated word. ``<= 0``
means "no deadline" — zero-padded payloads are backward compatible — and
a NACKed-for-deadline request is popped and answered (TIMEOUT/SHED), never
silently dropped, so clients can resubmit with backoff
(the fault layer's retry helper).
"""
from __future__ import annotations

OK = 1
MALFORMED = -1
SHED = -2
TIMEOUT = -3

NAMES = {OK: "OK", 0: "MISS", 2: "DEFERRED",
         MALFORMED: "MALFORMED", SHED: "SHED", TIMEOUT: "TIMEOUT"}


def is_nack(word0) -> bool:
    """True for any engine/app rejection code (works on ints, arrays and tensors)."""
    return word0 < 0
