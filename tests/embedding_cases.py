"""Inputs of the embedding-reduction walk tests, shared by the CPU model
test (``test_torch_embedding_walk.py``) and the card tests
(``test_torch_cuda.py``). Imports only numpy, torch and the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

# (dtype, D): widths off the 16-byte copy path (f32 D = 6 and 70, bf16 D =
# 100 take 4-byte copies, bf16 D = 33 2-byte ones) and on it; D = 70 and
# bf16 D = 200 span two 256-byte column tiles
WIDTHS = [(torch.float32, 6), (torch.float32, 8), (torch.float32, 64),
          (torch.float32, 70), (torch.bfloat16, 33), (torch.bfloat16, 64),
          (torch.bfloat16, 100), (torch.bfloat16, 200)]
# the copy width the wrapper picks for each of WIDTHS on an aligned table
COPY_BYTES = {(torch.float32, 6): 4, (torch.float32, 8): 16,
              (torch.float32, 64): 16, (torch.float32, 70): 4,
              (torch.bfloat16, 33): 2, (torch.bfloat16, 64): 16,
              (torch.bfloat16, 100): 4, (torch.bfloat16, 200): 16}
# lookups per segment: empty first, middle and last segments; chunks of
# 31, 32, 33, 100 and 1,000 lookups that cross the two 16-row stages
LENGTHS = [0, 1, 31, 32, 33, 0, 100, 1000, 3, 2, 5, 0]
ROWS = 50
NEG_ZERO_ROW = 7  # all -0.0: segment 8 sums it three times


def edge_case(seed: int, dtype, d: int):
    """(table (ROWS, d), idx, seg_ids, num_segments) on the CPU: segments
    of LENGTHS, seg_ids outside [0, S) before and after them, rows outside
    [0, ROWS) (negative and too large, one as a segment's first row), and
    an all-(-0.0) segment."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(ROWS, d)).astype(np.float32)
    table[NEG_ZERO_ROW] = -0.0
    s = len(LENGTHS)
    seg = np.concatenate([np.full(2, -2), [-1]]
                         + [np.full(n, i) for i, n in enumerate(LENGTHS)]
                         + [np.full(3, s), [s + 5]]).astype(np.int32)
    idx = rng.integers(0, ROWS, seg.shape[0]).astype(np.int32)
    first = {i: int(np.searchsorted(seg, i)) for i in range(s)}
    idx[first[8]: first[8] + 3] = NEG_ZERO_ROW
    idx[first[9]] = -3  # a segment's first row out of range
    idx[first[10] + 1] = ROWS  # one past the end
    idx[first[7] + 500] = -1
    idx[first[6] + 40] = ROWS + 7
    idx[first[2]: first[2] + 31] = np.arange(31)  # duplicates follow
    return (torch.from_numpy(table).to(dtype), torch.from_numpy(idx),
            torch.from_numpy(seg), s)


def plain_with_zero_rows(table, idx, seg_ids, num_segments):
    """``ref.embedding_reduce`` with a row outside [0, R) reading as zero,
    the kernel's rule: such lookups read an appended zero row."""
    rows = table.shape[0]
    padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    safe = torch.where((idx >= 0) & (idx < rows), idx, rows)
    return ref.embedding_reduce(padded, safe, seg_ids, num_segments)
