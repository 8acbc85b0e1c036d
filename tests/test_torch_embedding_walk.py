"""A plain numpy model of the CUDA embedding reduction's walk
(``src/repro_torch/kernels/csrc/embedding_reduce.cu``), held on the CPU
against ``np.searchsorted`` and the plain version, so that the kernel's
logic is checked before it runs on a card:

- the warp-cooperative segment search: 32 probes a round (16 for each
  bound), a ballot, the range narrowed to the gap between two probes;
- the row walk: 32-lookup chunks, two 16-row stages used as a ring, the
  lane-to-piece map of the row copies at 16-, 4- and 2-byte widths,
  256-byte column tiles, zero-filled copies of rows outside the table,
  and the sums in lookup order from each segment's first row.

The model follows the kernel lane by lane and fills the unwritten stage
bytes with noise, so a piece the copies miss shows up as a wrong sum.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from embedding_cases import COPY_BYTES, LENGTHS, WIDTHS, edge_case, \
    plain_with_zero_rows
from repro_torch.kernels import embedding_reduce as er

LANES, PROBES = 32, 16
STAGE_ROWS, CHUNK, TILE_BYTES = 16, 32, 256


def warp_bounds(seg: np.ndarray, s: int, num_segments: int):
    """(begin, end, rounds) of segment ``s`` as one warp finds them: lanes
    0-15 search for the first position with seg >= s, lanes 16-31 for the
    first with seg >= s + 1; each round is one load of 32 probes and one
    ballot. The first round reads the 16 positions around v N / S."""
    n = seg.shape[0]
    lo, hi = [0, 0], [n, n]
    value = (s, s + 1)
    rounds = 0
    if n:
        rounds += 1
        starts = [min(max(v * n // num_segments - 8, 0), max(n - 16, 0))
                  for v in value]
        ballot = 0
        for lane in range(LANES):
            h, k = divmod(lane, PROBES)
            q = starts[h] + k
            if q < n and seg[q] < value[h]:
                ballot |= 1 << lane
        for h in (0, 1):
            w = min(n - starts[h], PROBES)
            c = _count_prefix((ballot >> (PROBES * h)) & 0xFFFF)
            if c > 0:
                lo[h] = starts[h] + c
            if c < w:
                hi[h] = starts[h] + c
    while lo[0] < hi[0] or lo[1] < hi[1]:
        rounds += 1
        steps = [(hi[h] - lo[h] + PROBES - 1) // PROBES for h in (0, 1)]
        ballot = 0
        for lane in range(LANES):
            h, k = divmod(lane, PROBES)
            q = lo[h] + k * steps[h]
            if lo[h] < hi[h] and q < hi[h] and seg[q] < value[h]:
                ballot |= 1 << lane
        for h in (0, 1):
            c = _count_prefix((ballot >> (PROBES * h)) & 0xFFFF)
            if lo[h] < hi[h]:
                qc = lo[h] + c * steps[h]
                if c < PROBES and qc < hi[h]:
                    hi[h] = qc
                if c > 0:
                    lo[h] += (c - 1) * steps[h] + 1
    return lo[0], lo[1], rounds


def _count_prefix(mine: int) -> int:
    """popc of a half-warp's ballot, whose set bits must be a prefix."""
    c = bin(mine).count("1")
    assert mine == (1 << c) - 1, "the probes below are not a prefix"
    return c


def _unpack(stage_row: np.ndarray, esize: int) -> np.ndarray:
    """(32, 8 / esize) f32: the 8 bytes each lane owns of a staged row."""
    words = stage_row.view(np.uint32).reshape(LANES, 2)
    if esize == 4:
        return words.view(np.float32)
    lo = (words << 16).view(np.float32)
    hi = (words & 0xFFFF0000).view(np.float32)
    return np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], axis=1)


def model_reduce(table: torch.Tensor, idx, seg, num_segments: int,
                 width: int, rng):
    """The kernel's walk over every segment, in numpy: (S, D) f32."""
    rows_u8 = table.contiguous().view(torch.uint8).numpy()
    esize = table.element_size()
    dim = table.shape[1]
    tile_cols = TILE_BYTES // esize
    idx, seg = idx.numpy(), seg.numpy()
    out = np.zeros((num_segments, dim), np.float32)
    with np.errstate(all="ignore"):  # noise in the columns no lane keeps
        for s in range(num_segments):
            begin, end, _ = warp_bounds(seg, s, num_segments)
            # the first chunk's indices, read beside the search at the
            # guessed begin: used when the guess holds
            guess = s * idx.shape[0] // num_segments
            guessed = [int(idx[p]) if p < idx.shape[0] else 0
                       for p in range(guess, guess + CHUNK)]
            for c0 in range(0, dim, tile_cols):
                cols = min(tile_cols, dim - c0)
                out[s, c0: c0 + cols] = _model_tile(
                    rows_u8, esize, idx[begin:end], c0, cols, width, rng,
                    guessed if begin == guess else None)[:cols]
    return out


def _model_tile(rows_u8, esize, ids_of_segment, c0, cols, width, rng,
                first_chunk):
    """One warp's walk over one column tile of one segment: the 32 lanes'
    sums, lane-major. ``first_chunk``: the indices of chunk 0 if they
    were read ahead (lanes past the segment's end hold other rows)."""
    length = ids_of_segment.shape[0]
    nstage = -(-length // STAGE_ROWS)
    tile_bytes = cols * esize
    ppr = tile_bytes // width
    rpr = 1 if ppr >= LANES else LANES // ppr
    ring = rng.integers(0, 256, (2, STAGE_ROWS * TILE_BYTES),
                        dtype=np.uint8)  # noise
    holds = {}  # stage -> [stage index g it holds, summed?]

    def chunk(c):
        return [int(ids_of_segment[p]) if p < length else 0
                for p in range(c * CHUNK, (c + 1) * CHUNK)]

    def issue(g, ids):
        slot = g & 1
        assert slot not in holds or holds[slot][1], \
            "a stage refilled before it was summed"
        nr = min(STAGE_ROWS, length - g * STAGE_ROWS)
        for r0 in range(0, nr, rpr):
            for lane in range(LANES):
                sub = lane // ppr
                r = r0 + sub
                row = ids[(slot * STAGE_ROWS + r) & 31]
                if sub >= rpr or r >= nr:
                    continue
                ok = 0 <= row < rows_u8.shape[0]
                for q in range(lane - sub * ppr, ppr, LANES):
                    at = r * TILE_BYTES + q * width
                    src = c0 * esize + q * width
                    ring[slot, at: at + width] = (
                        rows_u8[row, src: src + width] if ok else 0)
        holds[slot] = [g, False]

    acc = np.zeros((LANES, 8 // esize), np.float32)  # an empty segment
    if nstage:
        ids = chunk(0) if first_chunk is None else first_chunk
        ids_next = None
        issue(0, ids)
        if nstage > 1:
            issue(1, ids)
        if nstage > 2:
            ids_next = chunk(1)
        for g in range(nstage):
            assert holds[g & 1] == [g, False], "stage not in flight"
            for r in range(min(STAGE_ROWS, length - g * STAGE_ROWS)):
                v = _unpack(ring[g & 1, r * TILE_BYTES: (r + 1) * TILE_BYTES],
                            esize)
                acc = v.copy() if g == 0 and r == 0 else acc + v
            holds[g & 1][1] = True
            h = g + 2
            if h < nstage:
                if h % 2 == 0:
                    ids = ids_next
                issue(h, ids)
                if h % 2 and h + 1 < nstage:
                    ids_next = chunk((h + 1) // 2)
    return acc.reshape(-1)


# ------------------------------ the search ----------------------------------

def _seg_layouts():
    rng = np.random.default_rng(5)
    edge = edge_case(0, torch.float32, 8)[2].numpy()
    dlrm = np.repeat(np.arange(2048), 32).astype(np.int32)
    skewed = np.sort(rng.zipf(1.5, 2**16) % 2048).astype(np.int32)
    ragged = np.sort(rng.integers(-3, 40, 3000)).astype(np.int32)
    runs = np.repeat([0, 9, 10, 31], [5, 1, 40, 3]).astype(np.int32)
    return {"edge": (edge, len(LENGTHS)),
            "dlrm_serve": (dlrm, 2048), "skewed_serve": (skewed, 2048),
            "ragged": (ragged, 37),
            "empty_runs": (runs, 35), "one_segment": (np.zeros(999, np.int32),
                                                      3),
            "single": (np.array([4], np.int32), 6),
            "none": (np.zeros(0, np.int32), 2)}


@pytest.mark.parametrize("layout", list(_seg_layouts()))
def test_warp_search_matches_searchsorted(layout):
    """Every segment's bounds equal np.searchsorted's (left of s and of
    s + 1): empty first, middle and last segments, runs of empty ones,
    seg_ids outside [0, S), N = 0 and 1, the uniform DLRM layout and a
    skewed one of the same size whose guesses miss."""
    seg, num_segments = _seg_layouts()[layout]
    for s in range(num_segments):
        begin, end, _ = warp_bounds(seg, s, num_segments)
        assert begin == np.searchsorted(seg, s, "left"), (layout, s)
        assert end == np.searchsorted(seg, s, "right"), (layout, s)


def test_warp_search_rounds_at_the_serve_shape():
    """65,536 lookups: the DLRM layout (32 lookups a segment) settles in
    the first round; the skewed layout takes at most 1 + ceil(log16 N) =
    5, against the 2 x 16 dependent loads of two binary searches."""
    layouts = _seg_layouts()
    seg, num_segments = layouts["dlrm_serve"]
    assert seg.shape[0] == PROBES ** 4
    assert {warp_bounds(seg, s, num_segments)[2]
            for s in range(num_segments)} == {1}
    seg, num_segments = layouts["skewed_serve"]
    assert seg.shape[0] == PROBES ** 4
    rounds = [warp_bounds(seg, s, num_segments)[2]
              for s in range(0, num_segments, 5)]
    assert max(rounds) == 5


# ------------------------------ the walk ------------------------------------

@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_model_walk_matches_plain_version(dtype, d):
    """The modelled walk at the copy width the wrapper picks equals the
    plain version bit for bit (rows outside the table read as zero, the
    all-(-0.0) segment keeps its sign)."""
    table, idx, seg, s = edge_case(d, dtype, d)
    width = er.copy_bytes(table)
    assert width == COPY_BYTES[(dtype, d)]
    got = model_reduce(table, idx, seg, s, width, np.random.default_rng(d))
    want = plain_with_zero_rows(table, idx, seg, s).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.signbit(got[8]).all() and not got[8].any()


@pytest.mark.parametrize("width", [16, 4])
def test_model_walk_at_every_width_the_rows_allow(width):
    """f32 rows of 64 columns summed through 16- and 4-byte copies alike
    (a table whose alignment forbids 16-byte copies takes 4)."""
    table, idx, seg, s = edge_case(3, torch.float32, 64)
    got = model_reduce(table, idx, seg, s, width,
                       np.random.default_rng(width))
    want = plain_with_zero_rows(table, idx, seg, s).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype,d,offset,width", [
    (torch.float32, 64, 0, 16), (torch.float32, 64, 1, 4),
    (torch.float32, 4, 0, 16), (torch.float32, 3, 0, 4),
    (torch.bfloat16, 8, 0, 16), (torch.bfloat16, 8, 2, 4),
    (torch.bfloat16, 8, 1, 2), (torch.bfloat16, 7, 0, 2),
])
def test_copy_bytes_follows_row_length_and_alignment(dtype, d, offset,
                                                     width):
    """16-byte copies only where every row starts 16-byte aligned; a table
    that starts ``offset`` elements into its storage may not."""
    flat = torch.zeros(10 * d + offset, dtype=dtype)
    table = flat[offset:].view(10, d)
    assert er.copy_bytes(table) == width
