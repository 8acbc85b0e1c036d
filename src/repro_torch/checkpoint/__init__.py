"""Persistence: atomic snapshots (``checkpointer``) and the streamed,
CRC-framed segment WAL (``wal``), both in the JAX package's on-disk format;
``elastic``, the resharding restore onto another mesh."""
from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    clean_stale,
    latest_step,
    list_deltas,
    load_delta,
    rebuild,
    restore,
    save,
    save_delta,
)
from repro_torch.checkpoint.wal import (
    SegmentWriter,
    gc_covered,
    list_segments,
    read_segments,
    scan_segment,
)
