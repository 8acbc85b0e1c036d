// Paged GQA decode attention for Hopper (sm_90a): the raw online-softmax
// stats (acc, m, l) of each query row over the tokens a sequence holds in
// a paged KV pool.
//
// Replaces repro/kernels/paged_attention.py::paged_attention_stats (and,
// with the divide the wrapper adds, ::paged_attention). What it computes,
// per sequence b, kv head h and query row r of the G rows sharing h:
//   s_t = q[b,h,r] . K[t]      over the first lengths[b] tokens t
//   m   = max_t s_t,  l = sum_t exp(s_t - m),  acc = sum_t exp(s_t - m) V[t]
// in f32 (q arrives f32 and pre-scaled; pages are f32 or bf16). Token t
// of sequence b lies in physical page page_table[b, t / PS] at row
// t % PS. A dead entry (-1) resolves to the last physical page, the
// pool's zero sentinel, and an entry past the pool clamps to it, so the
// walk never reads page -1 or NP; tokens at or past lengths[b] are
// masked. A zero-length sequence yields (0, -1e30, 0), the empty softmax,
// which the caller LSE-merges safely.
//
// Layout: q (B, KVH, G, hd) f32; pages (NP, PS, KVH, hd); page_table
// (B, MaxP) int32; lengths (B,) int32; acc (B, KVH, G, hd), m and l
// (B, KVH, G) f32.
//
// What bounds it on an H100: bytes. Each live token's K and V rows are
// read once (2 x hd x 2 B in bf16) and there are 4 x G x hd flops per
// token, about 5 flops a byte at G = 5, far below the card's ~295. The
// TPU kernel walked one page per grid step in order. Here each (b, h) is
// one thread-block cluster of S CTAs (S <= 8, the portable cluster size,
// chosen by the wrapper from MaxP, never from the lengths): CTA r walks
// the contiguous token range [r T, (r + 1) T), T = ceil(MaxP PS / S),
// clipped to the sequence's length, keeping its own (acc, m, l); a CTA
// whose range lies past the length keeps the empty state. The CTAs then
// write their partial states to their own shared memory, and after a
// cluster barrier each CTA LSE-merges a slice of the (G, hd) outputs
// from every CTA's partials through distributed shared memory
// (map_shared_rank) and writes it: one launch, no global scratch, no
// float atomics. The wrapper takes one split per 2,048 table tokens:
// on the card the serve shape (32 sequences of 512-639 tokens, 256
// clusters) runs fastest unsplit, while 4 sequences of 16,384 tokens (32
// clusters) need all 8 (chip_smoke.py's device_us_by_splits, PERF.md).
//
// Within a CTA the walk goes in 32-token chunks, their K and V rows
// landing in shared memory asynchronously, several chunks in flight,
// each stage signalled full by an mbarrier's transaction count. Two
// paths:
//
// - bf16 pages with hd 64 or 128 (the serve shape) and pages that tile
//   a chunk: the copies are TMA tensor loads over the pool viewed as a
//   (NP PS, KVH hd) matrix, one box per page of the chunk (or per
//   32-row piece of a larger page) and 64 columns, 128-byte swizzled:
//   a few copies a chunk issued by one thread, kStages chunks in flight.
//   Per-thread 16-byte cp.async copies, and one bulk copy per token row,
//   were tried first and ran slower: the copies' issue, not the bytes in
//   flight, bounded them. Both products run on the tensor cores, mma.sync
//   m16n8k16 with the G rows padded to 16: two warps, each owning 16
//   tokens of a chunk and its own online softmax. q and the
//   probabilities are each kept near f32 as a bf16 pair hi + lo (lo =
//   x - hi), so S = q_hi K^T + q_lo K^T and O += P_hi V + P_lo V: with P
//   rounded to bf16 alone, the error of a 16,384-token sum left the
//   bf16 tolerance. K's fragments come by ldmatrix, V's by
//   ldmatrix.trans, from the swizzled tiles, and the probabilities go
//   from the score accumulators to the A operand of P V in registers
//   (paged_mma_kernel).
// - f32 pages, or other head dims or page sizes: f32 FMAs on the CUDA
//   cores, one warp per query row (at least four warps), one lane per
//   token of a chunk, the row's running max and sum reduced by warp
//   shuffles, and the (hd,) accumulator in registers, lane l holding
//   d = l + 32 j. Warp 0 copies a chunk's rows, one bulk copy per token
//   row (a token past the range reads a row of the zero sentinel), into
//   K rows padded by 16 bytes so the lanes' row reads spread over the
//   banks (paged_stats_kernel). The f32 pool's tolerance, 1e-5, rules out
//   TF32 and bf16 products.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 4;     // chunks in flight, tensor-core path
constexpr int kFmaStages = 3;  // chunks in flight, CUDA-core path
constexpr int kBarBytes = 128;  // the stages' mbarriers, ahead of the data
constexpr int kMaxRows = 8;    // G
constexpr int kMaxSplits = 8;  // S: the portable cluster size
constexpr float kNegInf = -1e30f;

// ``bytes`` (a multiple of 16) global -> shared by the TMA engine,
// completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The token range of this CTA (rank r of the cluster): [t0, t1).
struct Range {
  int t0, t1;
};

__device__ __forceinline__ Range split_range(const int32_t* lengths, int b,
                                             int maxp, int ps,
                                             int split_len) {
  int len = lengths[b];
  len = len < 0 ? 0 : (len > maxp * ps ? maxp * ps : len);
  const int t0 = blockIdx.x * split_len;
  return Range{t0, min(t0 + split_len, len)};
}

// Element offset of row ``pos`` of sequence b's kv head h in the pool:
// dead (-1) entries read the last page, the zero sentinel; entries past
// the pool clamp to it.
__device__ __forceinline__ size_t row_offset(const int32_t* pt, int pos,
                                             int ps, int kvh, int h, int hd,
                                             int n_pages) {
  int page = __ldg(pt + pos / ps);
  page = page < 0 ? n_pages - 1 : (page >= n_pages ? n_pages - 1 : page);
  return ((size_t(page) * ps + pos % ps) * kvh + h) * size_t(hd);
}

// Warp 0 copies chunk c (the 32 tokens from t0 + 32 c) of K and V into
// shared memory rows of ``ks`` and ``vs`` elements, one bulk copy per
// row, lane i taking token i: its page is resolved by the rule above, and
// a token at or past t1 reads a row of the zero sentinel, so masked tokens
// meet finite zeros. ``bar`` completes when every byte has landed.
constexpr int kChunk = 32;  // tokens per chunk: one per lane of warp 0

template <typename T>
__device__ __forceinline__ void issue_chunk(
    T* k_s, int ks, T* v_s, int vs, uint64_t* bar,
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int32_t* pt, Range r, int c, int ps, int kvh, int h, int hd,
    int n_pages) {
  const int lane = threadIdx.x & 31;
  const int bytes = hd * int(sizeof(T));
  const int pos = r.t0 + c * kChunk + lane;
  const size_t off =
      pos < r.t1 ? row_offset(pt, pos, ps, kvh, h, hd, n_pages)
                 : (size_t(n_pages - 1) * ps * kvh + h) * size_t(hd);
  if (lane == 0) mbar_expect_tx(bar, 2 * kChunk * bytes);
  __syncwarp();
  bulk_copy(k_s + lane * ks, k_pages + off, bytes, bar);
  bulk_copy(v_s + lane * vs, v_pages + off, bytes, bar);
}

// Partial states in shared memory: [parts][g][hd + 2] f32, the row's acc
// then its m and l. Every CTA of the cluster holds PARTS of them; CTA
// rank r merges the outputs e = r * blockDim + tid, stepping by
// S * blockDim, over the (G, hd + 1) outputs (column hd is (m, l)). All
// of an output's remote loads are issued before any is used.
template <int PARTS>
__device__ __forceinline__ void cluster_merge(float* part, int g, int hd,
                                              float* acc_out, float* m_out,
                                              float* l_out, size_t row0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is written
  const int n = int(cluster.num_blocks());
  const int w = hd + 2;
  const float* rp[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    rp[r] = cluster.map_shared_rank(part, r < n ? r : 0);
  for (int e = int(cluster.block_rank()) * blockDim.x + threadIdx.x;
       e < g * (hd + 1); e += n * blockDim.x) {
    const int row = e / (hd + 1);
    const int d = e - row * (hd + 1);
    const int col = d < hd ? d : hd + 1;  // acc[d], or l
    float pm[kMaxSplits][PARTS], pv[kMaxSplits][PARTS];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
#pragma unroll
      for (int k = 0; k < PARTS; ++k) {
        const float* p = rp[r] + (k * g + row) * w;
        pm[r][k] = r < n ? p[hd] : kNegInf;
        pv[r][k] = r < n ? p[col] : 0.0f;
      }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
#pragma unroll
      for (int k = 0; k < PARTS; ++k) mx = fmaxf(mx, pm[r][k]);
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
#pragma unroll
      for (int k = 0; k < PARTS; ++k)
        sum += r < n ? expf(pm[r][k] - mx) * pv[r][k] : 0.0f;
    if (d < hd) {
      acc_out[(row0 + row) * hd + d] = sum;
    } else {
      m_out[row0 + row] = mx;
      l_out[row0 + row] = sum;
    }
  }
  cluster.sync();  // no CTA leaves while its partials are being read
}

// ---------------------------------------------------------------------------
// bf16 pages, hd % 16 == 0, hd <= 128: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = kChunk / 16;  // 16 tokens of a chunk each

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as a packed bf16 pair hi and the pair of what hi leaves, lo:
// hi + lo holds about 16 bits of each value's mantissa
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// A stage holds one chunk's K and V tiles, each HD / 64 column blocks of
// (32 rows, 64) bf16 in 128-byte swizzled rows, as the TMA writes them
template <int HD>
struct MmaSmem {
  static constexpr int kBlock = kChunk * 128;
  static constexpr int kTile = HD / 64 * kBlock;
  static constexpr int kData = kStages * 2 * kTile;
  static constexpr int kAlloc = kBarBytes + kData + 1024;  // + alignment
};

template <int HD>
size_t mma_smem_bytes(int g) {
  const size_t parts = size_t(kMmaWarps) * g * (HD + 2) * sizeof(float);
  const size_t data = MmaSmem<HD>::kData;
  return MmaSmem<HD>::kAlloc + (parts > data ? parts - data : 0);
}

// byte offset of element (row, col) in a swizzled tile
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * (kChunk * 128) + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// a (64, rows) box of a 2-d tensor map at (col, row)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// Thread 0 loads chunk c, the 32 tokens from tb (a multiple of 32), of K
// and V into a stage by TMA: pages of PS <= 32 tokens as one box each,
// or the chunk's 32 rows of a larger page; a page index past the table,
// or an entry < 0, reads the zero sentinel, an entry past the pool
// clamps to it.
template <int HD>
__device__ __forceinline__ void load_chunk(
    unsigned char* ks, unsigned char* vs, uint64_t* bar,
    const CUtensorMap* tk, const CUtensorMap* tv, const int32_t* pt, int tb,
    int ps, int h, int n_pages, int maxp) {
  mbar_expect_tx(bar, 2 * MmaSmem<HD>::kTile);
  const int rows = ps < kChunk ? ps : kChunk;
  for (int i = 0; i < kChunk / rows; ++i) {
    const int idx = (tb + i * rows) / ps;
    int page = idx < maxp ? __ldg(pt + idx) : -1;
    page = page < 0 ? n_pages - 1 : (page >= n_pages ? n_pages - 1 : page);
    const int row = page * ps + (tb + i * rows) % ps;
#pragma unroll
    for (int blk = 0; blk < HD / 64; ++blk) {
      const int off = blk * MmaSmem<HD>::kBlock + i * rows * 128;
      tma_load_2d(ks + off, tk, bar, h * HD + blk * 64, row);
      tma_load_2d(vs + off, tv, bar, h * HD + blk * 64, row);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps)
    paged_mma_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ q,
                     const int32_t* __restrict__ page_table,
                     const int32_t* __restrict__ lengths,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int kvh, int g, int n_pages,
                     int ps, int maxp, int split_len) {
  using L = MmaSmem<HD>;
  constexpr int kKS = HD / 16;  // k-steps over hd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* data = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kBarBytes + 1023) &
      ~uintptr_t(1023));
  unsigned char* k_s = data;
  unsigned char* v_s = data + kStages * L::kTile;

  const int b = blockIdx.y / kvh;
  const int h = blockIdx.y % kvh;
  const size_t row0 = size_t(blockIdx.y) * g;  // first (b, h, r) row
  const int32_t* pt = page_table + size_t(b) * maxp;
  const Range r = split_range(lengths, b, maxp, ps, split_len);
  const int tb0 = r.t0 / kChunk * kChunk;  // chunks are 32-aligned
  const int chunks = r.t1 > r.t0 ? (r.t1 - tb0 + kChunk - 1) / kChunk : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;        // fragment row group
  const int tq = lane & 3;         // thread in group
  const int mi = lane >> 3;        // ldmatrix: the matrix this lane points
  const int mr = lane & 7;         // into, and its row there

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages - 1 && c < chunks; ++c)
      load_chunk<HD>(k_s + c * L::kTile, v_s + c * L::kTile, &bars[c], &tk,
                     &tv, pt, tb0 + c * kChunk, ps, h, n_pages, maxp);
  }

  // q as bf16 hi + lo A fragments, rows >= G zero
  uint32_t qh[kKS][4], ql[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gq + 8 * (e & 1);
      const int col = ks * 16 + 2 * tq + 8 * (e >> 1);
      float2 v = make_float2(0.0f, 0.0f);
      if (row < g)
        v = *reinterpret_cast<const float2*>(q + (row0 + row) * HD + col);
      split_bf16(v.x, v.y, qh[ks][e], ql[ks][e]);
    }
  }
  __syncthreads();  // the barriers are initialised

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int c = 0; c < chunks; ++c) {
    // the stage chunk c - 1 used is free: every warp passed the barrier
    const int nc = c + kStages - 1;
    if (threadIdx.x == 0 && nc < chunks) {
      const int st = nc % kStages;
      load_chunk<HD>(k_s + st * L::kTile, v_s + st * L::kTile, &bars[st],
                     &tk, &tv, pt, tb0 + nc * kChunk, ps, h, n_pages, maxp);
    }
    const int st = c % kStages;
    mbar_wait(&bars[st], (c / kStages) & 1);

    // this warp's 16 tokens of the chunk
    const unsigned char* ks = k_s + st * L::kTile;
    const unsigned char* vs = v_s + st * L::kTile;
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t kb[4];  // (tokens 0-7 | 8-15) x (hd 0-7 | 8-15) of the step
      ldmatrix_x4(kb, ks + swz(warp * 16 + (mi >> 1) * 8 + mr,
                               kk * 16 + (mi & 1) * 8));
      mma_bf16(s[0], qh[kk], kb[0], kb[1]);
      mma_bf16(s[0], ql[kk], kb[0], kb[1]);
      mma_bf16(s[1], qh[kk], kb[2], kb[3]);
      mma_bf16(s[1], ql[kk], kb[2], kb[3]);
    }
    // mask (tokens outside [t0, t1)) and the online softmax of rows gq
    // (elements 0, 1) and gq + 8 (elements 2, 3); masked scores weigh 0
    const int tok0 = tb0 + c * kChunk + warp * 16 + 2 * tq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = tok0 + 8 * n + (e & 1);
        s[n][e] = tok >= r.t0 && tok < r.t1 ? s[n][e] : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int x = 1; x < 4; x <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], x));
      const float mn = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // o += P V: P's A fragments are the score accumulators, as a bf16
    // pair hi + lo like q
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(s[e >> 1][2 * (e & 1)], s[e >> 1][2 * (e & 1) + 1], ph[e],
                 pl[e]);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t vb[4];  // (tokens 0-7 | 8-15) x (hd 16j.. | 16j+8..)
      ldmatrix_x4_trans(vb, vs + swz(warp * 16 + (mi & 1) * 8 + mr,
                                     j * 16 + (mi >> 1) * 8));
      mma_bf16(o[2 * j], ph, vb[0], vb[1]);
      mma_bf16(o[2 * j], pl, vb[0], vb[1]);
      mma_bf16(o[2 * j + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * j + 1], pl, vb[2], vb[3]);
    }
    __syncthreads();  // the stage is rewritten by a later chunk
  }

  // this warp's partial state, over the stage memory
  float* part = reinterpret_cast<float*>(data);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    const int row = gq + 8 * i;
    if (row < g) {
      float* p = part + (warp * g + row) * (HD + 2);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        p[8 * j + 2 * tq] = o[j][2 * i];
        p[8 * j + 2 * tq + 1] = o[j][2 * i + 1];
      }
      if (tq == 0) {
        p[HD] = m[i];
        p[HD + 1] = l[i];
      }
    }
  }
  cluster_merge<kMmaWarps>(part, g, HD, acc_out, m_out, l_out, row0);
}

// ---------------------------------------------------------------------------
// everything else: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kMinWarps = 4;   // warps at least, for G < 4

// 4 page values from shared memory, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K rows are padded by 16 bytes so a warp's one-row-per-lane reads spread
// over the banks; V rows are read along hd and are not padded
template <typename T>
size_t smem_bytes(int g, int hd) {
  const int pad = 16 / sizeof(T);
  const size_t stages =
      size_t(kFmaStages) * kChunk * (2 * hd + pad) * sizeof(T);
  const size_t parts = size_t(g) * (hd + 2) * sizeof(float);
  return kBarBytes + sizeof(float) * size_t(g) * hd +
         (stages > parts ? stages : parts);
}

// ND = accumulator values per lane: hd <= 32 * ND
template <typename T, int ND>
__global__ void __launch_bounds__(32 * kMaxRows)
    paged_stats_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int kvh, int g, int hd,
                       int n_pages, int ps, int maxp, int split_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hdk = hd + 16 / int(sizeof(T));  // padded K row
  const int stage = kChunk * (hdk + hd);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + kBarBytes);
  T* kv_s = reinterpret_cast<T*>(q_s + g * hd);  // [stage]: K rows, V rows

  const int b = blockIdx.y / kvh;
  const int h = blockIdx.y % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 5;  // this warp's query row (warps >= G idle)
  const size_t row0 = size_t(blockIdx.y) * g;  // first (b, h, r) row
  const int32_t* pt = page_table + size_t(b) * maxp;
  const Range r = split_range(lengths, b, maxp, ps, split_len);
  const int chunks = r.t1 > r.t0 ? (r.t1 - r.t0 + kChunk - 1) / kChunk : 0;

  for (int e = tid; e < g * hd; e += blockDim.x) q_s[e] = q[row0 * hd + e];
  if (tid == 0) {
    for (int i = 0; i < kFmaStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (row == 0)
    for (int c = 0; c < kFmaStages - 1 && c < chunks; ++c) {
      T* k_s = kv_s + c * stage;
      issue_chunk(k_s, hdk, k_s + kChunk * hdk, hd, &bars[c], k_pages,
                  v_pages, pt, r, c, ps, kvh, h, hd, n_pages);
    }

  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.0f;
  float m = kNegInf, l = 0.0f;  // the row's running max and sum

  for (int c = 0; c < chunks; ++c) {
    // the stage chunk c - 1 used is free: every warp passed the barrier
    const int nc = c + kFmaStages - 1;
    if (row == 0 && nc < chunks) {
      T* k_s = kv_s + (nc % kFmaStages) * stage;
      issue_chunk(k_s, hdk, k_s + kChunk * hdk, hd, &bars[nc % kFmaStages],
                  k_pages, v_pages, pt, r, nc, ps, kvh, h, hd, n_pages);
    }
    mbar_wait(&bars[c % kFmaStages], (c / kFmaStages) & 1);

    const T* k_s = kv_s + (c % kFmaStages) * stage;
    const T* v_s = k_s + kChunk * hdk;
    if (row < g) {
      // score: one token per lane, four independent partial sums over hd
      const bool valid = r.t0 + c * kChunk + lane < r.t1;
      const float4* q4 = reinterpret_cast<const float4*>(q_s + row * hd);
      const T* kt = k_s + lane * hdk;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
      for (int d4 = 0; d4 < hd / 4; ++d4) {
        const float4 qv = q4[d4];
        const float4 kv = load4(kt + 4 * d4);
        a0 = fmaf(qv.x, kv.x, a0);
        a1 = fmaf(qv.y, kv.y, a1);
        a2 = fmaf(qv.z, kv.z, a2);
        a3 = fmaf(qv.w, kv.w, a3);
      }
      const float s = valid ? (a0 + a1) + (a2 + a3) : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p = valid ? expf(s - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      // acc[d] = acc[d] * corr + sum_t p_t V[t, d], lane holding
      // d = lane + 32 j; p_t comes from lane t by a shuffle
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] *= corr;
#pragma unroll 4
      for (int t = 0; t < kChunk; ++t) {
        const float pt_ = __shfl_sync(0xffffffffu, p, t);
        const T* vt = v_s + t * hd;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[j] = fmaf(pt_, to_f32(vt[d]), acc[j]);
        }
      }
    }
    __syncthreads();  // the stage is rewritten by a later chunk
  }
  __syncthreads();

  // this CTA's partial state, over the stage memory
  float* part = reinterpret_cast<float*>(kv_s);
  if (row < g) {
    float* p = part + row * (hd + 2);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) p[d] = acc[j];
    }
    if (lane == 0) {
      p[hd] = m;
      p[hd + 1] = l;
    }
  }
  cluster_merge<1>(part, g, hd, acc_out, m_out, l_out, row0);
}

// Launch ``kernel`` on a (splits, B * KVH) grid of clusters of ``splits``
// CTAs along x.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int splits, int bh,
                    int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(splits), unsigned(bh));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return int(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ND>
int launch_nd(const void* q, const void* k_pages, const void* v_pages,
              const void* page_table, const void* lengths, void* acc, void* m,
              void* l, int b, int kvh, int g, int hd, int n_pages, int ps,
              int maxp, int splits, int split_len, void* stream) {
  const int threads = 32 * (g > kMinWarps ? g : kMinWarps);
  return launch_clusters(
      paged_stats_kernel<T, ND>, splits, b * kvh, threads,
      smem_bytes<T>(g, hd), stream, static_cast<const float*>(q),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kvh, g, hd, n_pages,
      ps, maxp, split_len);
}

// the bf16 pool as a 2-d (NP * PS, KVH * hd) tensor with (64, rows)
// boxes, 128-byte swizzle
bool pool_map(CUtensorMap* map, const void* pages, int n_pages, int ps,
              int kvh, int hd, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(kvh) * hd,
                              cuuint64_t(n_pages) * ps};
  const cuuint64_t strides[1] = {cuuint64_t(kvh) * hd * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(pages), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const void* page_table, const void* lengths, void* acc,
               void* m, void* l, int b, int kvh, int g, int n_pages, int ps,
               int maxp, int splits, int split_len, void* stream) {
  CUtensorMap tk, tv;
  const int rows = ps < kChunk ? ps : kChunk;
  if (!pool_map(&tk, k_pages, n_pages, ps, kvh, HD, rows) ||
      !pool_map(&tv, v_pages, n_pages, ps, kvh, HD, rows))
    return int(cudaErrorInvalidValue);
  return launch_clusters(
      paged_mma_kernel<HD>, splits, b * kvh, 32 * kMmaWarps,
      mma_smem_bytes<HD>(g), stream, tk, tv, static_cast<const float*>(q),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kvh, g, n_pages, ps,
      maxp, split_len);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* acc, void* m,
           void* l, int b, int kvh, int g, int hd, int n_pages, int ps,
           int maxp, int splits, int split_len, void* stream) {
  if (b <= 0 || kvh <= 0 || g <= 0) return 0;
  if (g > kMaxRows || hd % 8 || hd > 256 || hd * int(sizeof(T)) > 512 ||
      splits < 1 || splits > kMaxSplits || split_len < 1 ||
      splits * split_len < maxp * ps)
    return int(cudaErrorInvalidValue);
  // the tensor-core path: TMA boxes of whole pages, or of 32-row pieces
  // of a page, that tile a 32-token chunk
  const bool boxes = (kChunk % ps == 0 && ps % 8 == 0) || ps % kChunk == 0;
  if (sizeof(T) == 2 && boxes && hd == 128)
    return launch_mma<128>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, n_pages, ps, maxp, splits, split_len,
                           stream);
  if (sizeof(T) == 2 && boxes && hd == 64)
    return launch_mma<64>(q, k_pages, v_pages, page_table, lengths, acc, m, l,
                          b, kvh, g, n_pages, ps, maxp, splits, split_len,
                          stream);
  if (hd <= 32)
    return launch_nd<T, 1>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, splits,
                           split_len, stream);
  if (hd <= 64)
    return launch_nd<T, 2>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, splits,
                           split_len, stream);
  if (hd <= 128)
    return launch_nd<T, 4>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, splits,
                           split_len, stream);
  return launch_nd<T, 8>(q, k_pages, v_pages, page_table, lengths, acc, m, l,
                         b, kvh, g, hd, n_pages, ps, maxp, splits, split_len,
                         stream);
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_paged_attention_stats_f32(const void* q, const void* k_pages,
                                   const void* v_pages, const void* page_table,
                                   const void* lengths, void* acc, void* m,
                                   void* l, int b, int kvh, int g, int hd,
                                   int n_pages, int ps, int maxp, int splits,
                                   int split_len, void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, lengths, acc, m, l, b,
                       kvh, g, hd, n_pages, ps, maxp, splits, split_len,
                       stream);
}

int orca_paged_attention_stats_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* page_table,
                                    const void* lengths, void* acc, void* m,
                                    void* l, int b, int kvh, int g, int hd,
                                    int n_pages, int ps, int maxp, int splits,
                                    int split_len, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, acc,
                               m, l, b, kvh, g, hd, n_pages, ps, maxp, splits,
                               split_len, stream);
}

}  // extern "C"
