// ORCA-DLRM embedding reduction for Hopper (sm_90a): gather table rows and
// sum each run of equal segment ids, in f32, into one output row per
// segment.
//
// Replaces repro/kernels/embedding_reduce.py::embedding_reduce together
// with the zeroing of empty segments that repro/kernels/ops.py adds to it.
// What it computes: out[s] = table[idx[n0]] + table[idx[n0+1]] + ... over
// the positions n0.. of segment s in the non-decreasing seg_ids, added in
// that order, each row converted to f32 first; a row outside [0, R) reads
// as zero, and a segment with no entries is zero. The sum starts from the
// segment's first row, never from +0.0, so it keeps the sign of a -0.0 sum
// and equals the plain version (repro_torch/kernels/ref.py::
// embedding_reduce, and dlrm_embedding_reduce on the DLRM layout) bit for
// bit. The North Star holds the DLRM sums bit for bit, so the order of the
// adds is fixed: each column is a sequential sum in lookup order, and only
// how many rows are in flight may change. There are only adds, so no FMA
// contraction can change the bits.
//
// Layout: table (R, D) row-major, f32 or bf16; idx and seg_ids (N,)
// int32; out (S, D) f32. Row offsets are 64-bit: the DLRM path flattens T
// tables of R rows into one (T*R, D) table.
//
// What bounds it on an H100: bytes. At the DLRM serve shape a call reads
// 65,536 rows of 256 B (f32, D = 64) at random places in 2.1 GB of tables,
// 16.8 MB in all, and adds once per element read. At 3.35 TB/s and about
// 1 µs of HBM latency the card needs several MB in flight to be busy.
//
// The design: one warp per segment, four warps a block.
// 1. Both bounds of the segment in a few dependent reads: lanes 0-15
//    search for the first position of s, lanes 16-31 for that of s + 1.
//    In each round every lane reads one seg_id (one load instruction for
//    the warp) and a ballot counts the probes below the value. The first
//    round reads the 16 positions around where the bound would be if all
//    segments were equally long (s N / S), which settles it on the DLRM
//    layout, where every segment has L lookups: one dependent read. Any
//    bound it does not settle is narrowed by rounds of 16 evenly spaced
//    probes to the gap between two of them: at most 1 + ceil(log16 N)
//    rounds, 5 at N = 65,536, against 2 x 16 for two binary searches.
//    The result is torch.searchsorted's on sorted seg_ids, for every s.
// 2. A chunk of 32 indices comes in one coalesced read (lane j holds the
//    index of lookup j of the chunk), issued beside the search at the
//    guessed begin and used when the guess holds; __shfl_sync hands each
//    row to the lanes that copy it.
// 3. Two shared-memory stages of 16 rows a warp (4 KB each). A chunk of
//    32 lookups fills both, and every row copy of the chunk is issued
//    before the first add: 16-byte cp.async.cg copies, a half-warp per
//    256-B row. A row outside [0, R) is copied with src-size 0, which
//    fills the stage with zeros. Longer segments (MERCI, other pooling
//    factors) run the two stages as a ring: the next 16 rows are in
//    flight while these are summed, and the next chunk's indices are read
//    ahead. Rows wider than 256 B are walked in 256-B column tiles.
// 4. The sum reads the stage in lookup order: lane l owns the 8 bytes at
//    8l of the tile (columns 2l, 2l+1 in f32; 4l..4l+3 in bf16), so each
//    column is added in the plain version's order, from its first row.
// At the serve shape 2,048 segments fill 2,048 warps; 32 KB of shared
// memory a block lets six blocks (24 warps) share an SM, so every segment
// runs in one wave with its 32 rows (8 KB) in flight: 16.8 MB across the
// card, the whole call's rows.
//
// Widths the 16-byte copies cannot take (a row length that is not a
// multiple of 16 bytes, or a table not 16-byte aligned) use 4-byte
// cp.async.ca copies, or for bf16 rows of odd width 2-byte loads and
// shared stores: the wrapper chooses the width from the shapes and passes
// it as copy_bytes, a template parameter here. The entry point refuses a
// width the table does not allow.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block, one segment each
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 256;  // bytes of a row per column tile: 8 a lane
constexpr int kStageRows = 16;   // rows per stage: a 32-lookup chunk fills 2
constexpr int kStageBytes = kStageRows * kTileBytes;
constexpr unsigned kFull = 0xffffffffu;

// Where segment v would begin if all segments were equally long: the
// search's first window, exact on the DLRM layout (L lookups each).
__device__ __forceinline__ int64_t guess_begin(int64_t v, int64_t n,
                                               int64_t segments) {
  return v * n / segments;
}

// Both bounds of segment s: begin = first position n with seg_ids[n] >= s,
// end = the first with seg_ids[n] >= s + 1 (N if none). Lanes 0-15 search
// for s and lanes 16-31 for s + 1, 16 probes a round each; the warp shares
// every round's load and ballot. The first round reads the 16 positions
// around guess_begin, which settles a bound that lies among them; then
// each round reads 16 evenly spaced positions of what is left.
__device__ __forceinline__ void segment_bounds(
    const int32_t* __restrict__ seg_ids, int64_t n, int64_t s,
    int64_t segments, int lane, int64_t& begin, int64_t& end) {
  const int half = lane >> 4;
  const int k = lane & 15;
  const int64_t v = s + half;
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  if (n > 0) {
    const int64_t top = n > 16 ? n - 16 : 0;  // the last window's start
    const int64_t g = guess_begin(v, n, segments) - 8;
    const int64_t a = g < 0 ? 0 : (g > top ? top : g);
    const int w = n - a < 16 ? int(n - a) : 16;  // probes inside [0, N)
    const bool below = k < w && seg_ids[a + k] < v;
    const int c = __popc((__ballot_sync(kFull, below) >> (16 * half)) &
                         0xffffu);
    // probe c - 1 is below v and probe c is not: the bound is a + c
    if (c > 0) lo = a + c;
    if (c < w) hi = a + c;
  }
  while (__any_sync(kFull, lo < hi)) {
    const int64_t step = (hi - lo + 15) >> 4;  // ceil(width / 16)
    const int64_t q = lo + k * step;
    const bool below = lo < hi && q < hi && seg_ids[q] < v;
    const unsigned mine =
        (__ballot_sync(kFull, below) >> (16 * half)) & 0xffffu;
    if (lo < hi) {
      // the probes below v are a prefix: probe c - 1 is below, probe c
      // (if it is inside the range) is not
      const int c = __popc(mine);
      const int64_t qc = lo + c * step;
      if (c < 16 && qc < hi) hi = qc;
      if (c > 0) lo += (c - 1) * step + 1;
    }
  }
  begin = __shfl_sync(kFull, lo, 0);
  end = __shfl_sync(kFull, lo, 16);
}

// One piece of V bytes of a row into the stage; ``valid`` false fills it
// with zeros.
template <int V>
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           bool valid) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  } else {
    // there is no 2-byte cp.async: a read-only load and a shared store
    const unsigned short x =
        valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
    *reinterpret_cast<unsigned short*>(dst) = x;
  }
}

template <int V>
__device__ __forceinline__ void copies_commit() {
  if constexpr (V >= 4) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one (``one_pending``) or none of this lane's copy
// groups is in flight
template <int V>
__device__ __forceinline__ void copies_wait(bool one_pending) {
  if constexpr (V >= 4) {
    if (one_pending)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// the 8 bytes a lane owns of one staged row, as f32
__device__ __forceinline__ void unpack(uint2 w, float (&v)[2], float) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
}
__device__ __forceinline__ void unpack(uint2 w, float (&v)[4],
                                       __nv_bfloat16) {
  // bf16 -> f32 is exact: the bf16 bits become the high half
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 6)
    embedding_reduce_kernel(const T* __restrict__ table,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ seg_ids,
                            float* __restrict__ out, int64_t n, int64_t rows,
                            int dim, int64_t segments) {
  constexpr int kLaneCols = 8 / sizeof(T);  // 2 f32 or 4 bf16 columns
  constexpr int kTileCols = kTileBytes / sizeof(T);
  __shared__ __align__(16) unsigned char stages[kWarps][2][kStageBytes];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t s = int64_t(blockIdx.x) * kWarps + warp;
  if (s >= segments) return;  // uniform across the warp
  // the first chunk's indices, read with the search where the segment
  // begins where guessed
  const int64_t guess = guess_begin(s, n, segments);
  const int32_t guessed_ids = guess + lane < n ? idx[guess + lane] : 0;
  int64_t begin, end;
  segment_bounds(seg_ids, n, s, segments, lane, begin, end);
  const int64_t len = end - begin;
  const int64_t nstage = (len + kStageRows - 1) / kStageRows;
  const int64_t row_bytes = int64_t(dim) * sizeof(T);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(table);
  unsigned char* ring = &stages[warp][0][0];
  float* dst = out + s * dim;

  // rows of stage g: 16, or what is left of the segment
  auto stage_rows = [&](int64_t g) -> int {
    const int64_t left = len - g * kStageRows;
    return left < kStageRows ? int(left) : kStageRows;
  };
  // the indices of chunk c (32 lookups): lane j holds lookup j's row
  auto chunk = [&](int64_t c) -> int32_t {
    const int64_t p = begin + c * 32 + lane;
    return p < end ? idx[p] : 0;
  };

  for (int c0 = 0; c0 < dim; c0 += kTileCols) {
    const int tile_bytes = min(kTileCols, dim - c0) * int(sizeof(T));
    const int64_t col_off = int64_t(c0) * sizeof(T);
    // a row of the tile is ``ppr`` pieces of V bytes; a round of copies
    // takes ``rpr`` rows, lane ``sub``-th of them from piece ``q0`` on
    const int ppr = tile_bytes / V;
    const int rpr = ppr >= 32 ? 1 : 32 / ppr;
    const int sub = lane / ppr;
    const int q0 = lane - sub * ppr;

    // issue every copy of stage g (16 lookups: half g & 1 of ``ids``)
    auto issue = [&](int64_t g, int32_t ids) {
      const int nr = stage_rows(g);
      unsigned char* st = ring + (g & 1) * kStageBytes;
      const int from = int(g & 1) * kStageRows;
      for (int r0 = 0; r0 < nr; r0 += rpr) {
        const int r = r0 + sub;
        const int32_t row = __shfl_sync(kFull, ids, (from + r) & 31);
        if (sub < rpr && r < nr) {
          const bool in_range = row >= 0 && row < rows;
          const unsigned char* src =
              base + (in_range ? int64_t(row) * row_bytes + col_off : 0);
#pragma unroll 4
          for (int q = q0; q < ppr; q += 32)
            copy_piece<V>(st + r * kTileBytes + q * V, src + q * V,
                          in_range);
        }
      }
      copies_commit<V>();
    };

    float acc[kLaneCols];
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) acc[k] = 0.0f;  // an empty segment
    if (nstage > 0) {
      int32_t ids = begin == guess ? guessed_ids : chunk(0), ids_next = 0;
      issue(0, ids);
      if (nstage > 1) issue(1, ids);
      if (nstage > 2) ids_next = chunk(1);
      const bool owns = lane * 8 < tile_bytes;
      for (int64_t g = 0; g < nstage; ++g) {
        copies_wait<V>(g + 1 < nstage);
        __syncwarp();
        if (owns) {
          const unsigned char* st = ring + (g & 1) * kStageBytes + lane * 8;
          const int nr = stage_rows(g);
          for (int r = 0; r < nr; ++r) {
            float v[kLaneCols];
            unpack(*reinterpret_cast<const uint2*>(st + r * kTileBytes), v,
                   T());
            const bool first = g == 0 && r == 0;
#pragma unroll
            for (int k = 0; k < kLaneCols; ++k)
              acc[k] = first ? v[k] : acc[k] + v[k];
          }
        }
        __syncwarp();  // the stage is read before it is refilled
        const int64_t h = g + 2;
        if (h < nstage) {
          if ((h & 1) == 0) ids = ids_next;
          issue(h, ids);
          if ((h & 1) && h + 1 < nstage) ids_next = chunk((h + 1) >> 1);
        }
      }
    }
    const int c = c0 + lane * kLaneCols;
    if (c + kLaneCols <= dim && (s * dim + c) % kLaneCols == 0) {
      if constexpr (kLaneCols == 2)
        *reinterpret_cast<float2*>(dst + c) = make_float2(acc[0], acc[1]);
      else
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k)
        if (c + k < dim) dst[c + k] = acc[k];
    }
  }
}

template <typename T, int V>
int launch_width(const void* table, const void* idx, const void* seg_ids,
                 void* out, long long n, long long rows, int dim,
                 long long segments, cudaStream_t stream) {
  const unsigned blocks = unsigned((segments + kWarps - 1) / kWarps);
  embedding_reduce_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(seg_ids), static_cast<float*>(out), n, rows,
      dim, segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* idx, const void* seg_ids, void* out,
           long long n, long long rows, int dim, long long segments,
           int copy_bytes, void* stream) {
  // a width the rows or the table's alignment do not allow is refused
  const long long row_bytes = static_cast<long long>(dim) * sizeof(T);
  if (copy_bytes < int(sizeof(T)) || row_bytes % copy_bytes != 0 ||
      reinterpret_cast<uintptr_t>(table) % copy_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (copy_bytes) {
    case 16:
      return launch_width<T, 16>(table, idx, seg_ids, out, n, rows, dim,
                                 segments, st);
    case 4:
      return launch_width<T, 4>(table, idx, seg_ids, out, n, rows, dim,
                                segments, st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_width<T, 2>(table, idx, seg_ids, out, n, rows, dim,
                                  segments, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_embedding_reduce_f32(const void* table, const void* idx,
                              const void* seg_ids, void* out, long long n,
                              long long rows, int dim, long long segments,
                              int copy_bytes, void* stream) {
  return launch<float>(table, idx, seg_ids, out, n, rows, dim, segments,
                       copy_bytes, stream);
}

int orca_embedding_reduce_bf16(const void* table, const void* idx,
                               const void* seg_ids, void* out, long long n,
                               long long rows, int dim, long long segments,
                               int copy_bytes, void* stream) {
  return launch<__nv_bfloat16>(table, idx, seg_ids, out, n, rows, dim,
                               segments, copy_bytes, stream);
}

}  // extern "C"
