"""Wrapper of the CUDA embedding reduction (``csrc/embedding_reduce.cu``).

ORCA-DLRM's device hot loop: gather table rows and sum each run of equal,
non-decreasing segment ids in lookup order into one f32 row per segment;
a segment with no entries is zero. Tables may be f32 or bf16. The wrapper
follows ``_launch`` (CUDA tensors only, checked, launched on the current
stream); ``launches`` counts launches since the last
:func:`reset_launches`. The kernel copies rows 16 bytes at a time where
the table allows it, else 4 or 2 (:func:`copy_bytes`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import LL, I, P, Library, check, same

KERNELS = ("embedding_reduce",)
_ENTRIES = {torch.float32: "orca_embedding_reduce_f32",
            torch.bfloat16: "orca_embedding_reduce_bf16"}
_lib = Library("embedding_reduce", KERNELS, {
    e: [P] * 4 + [LL, LL, I, LL, I] for e in _ENTRIES.values()
})
launches = _lib.launches
reset_launches = _lib.reset


def copy_bytes(table) -> int:
    """Width of the kernel's row copies for ``table``: 16 bytes where every
    row starts 16-byte aligned (its length a multiple of 16 bytes, the
    table 16-byte aligned), else 4, else 2 (bf16 rows of odd width)."""
    row = table.shape[1] * table.element_size()
    for width in (16, 4):
        if row % width == 0 and table.data_ptr() % width == 0:
            return width
    return 2


def embedding_reduce(table, idx, seg_ids, num_segments: int):
    """table: (R, D) f32 or bf16; idx: (N,) int32 rows; seg_ids: (N,)
    int32, non-decreasing. Returns (num_segments, D) f32 segment sums,
    each added in lookup order from its first row."""
    dev = idx.device
    check("table", table, 2, dev, dtype=tuple(_ENTRIES))
    check("idx", idx, 1, dev)
    check("seg_ids", seg_ids, 1, dev)
    same("seg_ids", seg_ids.shape, idx.shape)
    rows, d = table.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    _lib.launch("embedding_reduce", _ENTRIES[table.dtype], dev,
                table.data_ptr(), idx.data_ptr(), seg_ids.data_ptr(),
                out.data_ptr(), idx.shape[0], rows, d, num_segments,
                copy_bytes(table))
    return out
