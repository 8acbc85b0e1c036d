// Causal prefill flash attention for Hopper (sm_90a), GQA and an optional
// sliding window, forward only.
//
// Replaces repro/kernels/flash_attention.py::flash_attention. What it
// computes, for batch b, query head h and query position i:
//   out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
// over the keys j <= i (and i - j < window when window > 0), with
// scale = hd^-0.5, the online softmax kept in f32, and the output written
// in q's dtype (f32 or bf16). Query head h reads kv head h / G,
// G = H / KVH.
//
// Layout: q, out (B, H, S, hd); k, v (B, KVH, S, hd), each with its own
// strides (in elements) over B, H and S and a contiguous last dimension,
// so (B, S, H, hd) tensors are taken as their (B, H, S, hd) views without
// a copy.
//
// What bounds it on an H100: operations. At the serve shape (B 8, H 40,
// S 512, hd 128) the causal half of the score and value products is about
// 21 GFLOP over 100 MB moved, some 200 flops a byte.
//
// The TPU kernel ran a (b, h, q-block, k-block) grid in order, carrying
// (m, l, acc) in VMEM scratch across the k-blocks. Here the work item is
// one (b, h, 64-row q tile); its key tiles are walked in a loop, so the
// carry lives in registers. Key tiles wholly above the diagonal, or
// wholly before the window, are never visited, which is the TPU kernel's
// block skipping; heavy q tiles (late in the sequence) are scheduled
// first, and the G heads of a kv group side by side so they find its K/V
// tiles in L2. Two paths:
//
// - bf16 with hd 64 or 128 (the serve shape): flash_wgmma_kernel.
//   Persistent CTAs, two on each SM, walk the work items. A CTA is one
//   consumer warpgroup and one producer warp. The producer's lane 0
//   loads each item's Q tile and each 64-key K and V tile by TMA into
//   128-byte-swizzled shared memory, K and V each in a ring of two
//   stages; every stage is signalled full by the TMA's transaction count
//   on an mbarrier and handed back by the consumer on another, so loads
//   run ahead across tiles and items. Per key tile the consumer runs
//   S = Q K^T as wgmma m64n64k16 with both operands read from shared
//   memory (K's (keys, hd) rows are K-major already), keeps the f32
//   online softmax in registers in the log2 domain (exp2f, the scale
//   times log2(e) folded into one multiply), rounds the probabilities to
//   bf16 and feeds them from registers as the A operand of O += P V
//   (wgmma m64n{hd}k16, V read through the descriptor's transpose): the
//   accumulator layout of S is the A layout of P, so no shuffle. Masks
//   are computed only on tiles that cross the diagonal, the window's edge
//   or the sequence's end. The output tile is written to shared memory
//   and leaves by one TMA store, which overlaps the next item.
//   Tried on the card while designing it and not kept (slower at the
//   serve shape): one 128-row CTA of two consumer warpgroups, 128-key
//   tiles, a deeper ring (fewer CTAs fit an SM), and issuing the next
//   tile's S before this tile's softmax. Two 64-row CTAs per SM, the
//   persistent walk and the TMA store of the output were the changes
//   that counted.
// - everything else, f32 included (whose tolerance, 2e-5, a bf16 product
//   would not meet): f32 FMAs on the CUDA cores, 256 threads as a 16 x 16
//   grid, thread (ty, tx) holding query rows ty + 16i (i < 4), score
//   columns tx + 16j (j < 2) of a 32-key tile and output columns tx + 16j
//   (j < hd / 16); K and V tiles widened to f32 in shared memory, rows
//   padded by one float so the 16 rows a warp reads sit in distinct banks;
//   row max and row sum reduced over a row's 16 threads with shuffles
//   (flash_kernel).
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() (or the error of a refused setup) so the Python
// wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides of a (B, heads, S, hd) tensor; hd is contiguous
struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// everything but bf16 at hd 64/128: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 32;   // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int hd) {
  // Q tile (64, hd + 1) | K tile (32, hd + 1) | V tile (32, hd) |
  // P tile (64, 33)
  return sizeof(float) * (size_t(kBQ) * (hd + 1) + size_t(kBK) * (hd + 1) +
                          size_t(kBK) * hd + size_t(kBQ) * (kBK + 1));
}

// NJ = output columns per thread: hd <= 16 * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides qs,
                 Strides ks, Strides vs, Strides os, int heads, int kv_heads,
                 int s, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int hq = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + kBQ * hq;
  float* v_s = k_s + kBK * hq;
  float* p_s = v_s + kBK * hd;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy tiles first
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int qpos = q0 + r;
    q_s[r * hq + d] = qpos < s ? to_f32(qb[qpos * qs.s + d]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], o[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, s) - 1;
  const int kt_end = q_last / kBK;
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
#pragma unroll 4
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int t = e / hd;
      const int d = e - t * hd;
      const int kpos = k0 + t;
      const bool in = kpos < s;
      k_s[t * hq + d] = in ? to_f32(kb[kpos * ks.s + d]) : 0.0f;
      v_s[t * hd + d] = in ? to_f32(vb[kpos * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty + 16 * i) * hq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = k_s[(tx + 16 * j) * hq + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos <= qpos && kpos < s &&
                (window <= 0 || qpos - kpos < window);
        mx = ok[j] ? fmaxf(mx, sc[i][j]) : mx;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        p_s[r * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= corr;
    }
    __syncthreads();

    for (int t = 0; t < kBK; ++t) {
      float p[kRows], c[NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = p_s[(ty + 16 * i) * (kBK + 1) + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        c[j] = d < hd ? v_s[t * hd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(p[i], c[j], o[i][j]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[qpos * os.s + d] = from_f32<T>(o[i][j] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 with hd 64 or 128: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTileQ = 64;   // query rows per work item: one warpgroup
constexpr int kTileK = 64;   // keys per tile
constexpr int kStages = 2;   // depth of the K ring and of the V ring
constexpr int kCtasPerSm = 2;
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = kWgThreads + 32;  // + the producer warp
constexpr int kSwizzle = 128;          // bytes per swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// a (64-column, rows) box of a 4-d tensor map at (col, row, head, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 64) (+)= A(64 x 16, shared, K-major) * B(64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of one CTA: the Q tile, the output tile, the K ring and
// the V ring, each tile stored as HD / 64 column blocks of (rows, 64)
// bf16 in 128-byte swizzled rows (the TMA box and the wgmma layout), then
// the barriers.
template <int HD>
struct WgmmaSmem {
  static constexpr int kBlocks = HD / 64;
  static constexpr int kBlock = kTileQ * kSwizzle;  // = kTileK * kSwizzle
  static constexpr int kTile = kBlocks * kBlock;    // one (64, HD) tile
  static constexpr int kO = kTile;
  static constexpr int kK = kO + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + (4 * kStages + 2) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
};

// A ring of tiles: ``full[st]`` completes when a tile's TMA bytes have
// landed in stage st, ``empty[st]`` when the consumer's four warps have
// released it. Tile i (counted over the CTA's whole run) uses stage
// i % n in round i / n.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int n;
};

// producer: wait until tile ``i`` may be written into its stage
__device__ __forceinline__ int acquire(Ring r, int i) {
  const int st = i % r.n;
  mbar_wait(&r.empty[st], ((i / r.n) & 1) ^ 1);
  return st;
}

// consumer: wait for tile ``i`` to land; returns its stage
__device__ __forceinline__ int await_tile(Ring r, int i) {
  const int st = i % r.n;
  mbar_wait(&r.full[st], (i / r.n) & 1);
  return st;
}

// consumer: one arrival per warp hands tile ``i``'s stage back
__device__ __forceinline__ void release(Ring r, int i) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[i % r.n]);
}

// the consumer warpgroup's own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads) : "memory");
}

// a (64, 64) box of shared memory to a 4-d tensor map at (col, row, head,
// batch); rows past the map's S are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// issue S = Q K^T for one key tile (64 x 64, f32), not waiting for it
template <int HD>
__device__ __forceinline__ void issue_scores(float (&sc)[32],
                                             const unsigned char* qa,
                                             const unsigned char* ks) {
  using L = WgmmaSmem<HD>;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk % 4) * 32;  // 16 of a block's 64 columns
    wgmma_ss(sc, gmma_desc(qa + (kk / 4) * L::kBlock + off, 16, 1024),
             gmma_desc(ks + (kk / 4) * L::kBlock + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// The online softmax of one score tile in place, in the log2 domain:
// scores become probabilities, (m, l) move on (l per thread, summed over
// a row's four threads at the end), and corr is what the output rows must
// be rescaled by. Masks only a tile that crosses the diagonal, the
// window's edge or the end of the sequence. r0 is this thread's first
// row (the other is r0 + 8), cq its first column in an 8-column n-tile.
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&corr)[2], int k0,
    int row0, int r0, int cq, int s, int window, float scale_log2) {
  const int last = min(row0 + kTileQ, s) - 1;
  const bool masked = k0 + kTileK - 1 > row0 ||
                      (window > 0 && last - k0 >= window) || k0 + kTileK > s;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * scale_log2;
    if (masked) {
      const int row = r0 + 4 * (i & 2);
      const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
      const bool ok =
          col <= row && col < s && (window <= 0 || row - col < window);
      x = ok ? x : -CUDART_INF_F;
    }
    sc[i] = x;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], x));
    const float mn = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - mn);
    m[r] = mn;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += sc[i];
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// The work items: (b, h, 64-row q tile), heaviest q tiles first. Item w
// is q tile (tiles - 1 - w / bh) of (b, h) = w % bh.
struct Item {
  int b, h, kh, q0, kt_lo, n;  // n: key tiles, from tile kt_lo
};

__device__ __forceinline__ Item item_at(int w, int heads, int kv_heads,
                                        int bh, int tiles, int s,
                                        int window) {
  Item it;
  it.b = (w % bh) / heads;
  it.h = (w % bh) % heads;
  it.kh = it.h / (heads / kv_heads);
  it.q0 = (tiles - 1 - w / bh) * kTileQ;
  it.kt_lo = window > 0 ? max(it.q0 - window + 1, 0) / kTileK : 0;
  it.n = (min(it.q0 + kTileQ, s) - 1) / kTileK - it.kt_lo + 1;
  return it;
}

// Persistent CTAs, kCtasPerSm on each SM, each walking the work items
// w = blockIdx.x, blockIdx.x + gridDim.x, ...: one consumer warpgroup for
// the 64 query rows of an item and one producer warp whose lane 0 issues
// every TMA load. The producer runs ahead across items, so the next
// item's Q and first K/V tiles load while the current one finishes, and
// the output leaves through a TMA store from its own tile of shared
// memory. K and V have rings of their own: K is released as soon as its
// S is done, V once its P V is.
template <int HD>
__global__ void __launch_bounds__(kWgmmaThreads, kCtasPerSm)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int heads,
                       int kv_heads, int bh, int s, int window,
                       float scale_log2) {
  using L = WgmmaSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* o_s = base + L::kO;
  unsigned char* k_s = base + L::kK;
  unsigned char* v_s = base + L::kV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
  const Ring kr{bars, bars + kStages, kStages};
  const Ring vr{bars + 2 * kStages, bars + 3 * kStages, kStages};
  const Ring qr{bars + 4 * kStages, bars + 4 * kStages + 1, 1};

  const int tiles = (s + kTileQ - 1) / kTileQ;
  const int items = bh * tiles;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < 4 * kStages + 2; ++i)
      mbar_init(&bars[i], (i < 4 * kStages ? i % (2 * kStages) < kStages
                                           : i == 4 * kStages)
                              ? 1
                              : 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWgThreads) {
    // producer: one thread issues every load
    if (tid != kWgThreads) return;
    int t = 0, j = 0;  // tiles and items loaded so far
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++j) {
      const Item it = item_at(w, heads, kv_heads, bh, tiles, s, window);
      acquire(qr, j);
      mbar_expect_tx(qr.full, L::kTile);
      for (int c = 0; c < L::kBlocks; ++c)
        tma_load(q_s + c * L::kBlock, &tq, qr.full, c * 64, it.q0, it.h,
                 it.b);
      for (int i = 0; i < it.n; ++i, ++t) {
        const int key = (it.kt_lo + i) * kTileK;
        int st = acquire(kr, t);
        mbar_expect_tx(&kr.full[st], L::kTile);
        for (int c = 0; c < L::kBlocks; ++c)
          tma_load(k_s + st * L::kTile + c * L::kBlock, &tk, &kr.full[st],
                   c * 64, key, it.kh, it.b);
        st = acquire(vr, t);
        mbar_expect_tx(&vr.full[st], L::kTile);
        for (int c = 0; c < L::kBlocks; ++c)
          tma_load(v_s + st * L::kTile + c * L::kBlock, &tv, &vr.full[st],
                   c * 64, key, it.kh, it.b);
      }
    }
    // stay until the consumer has released every stage
    for (int i = 0; i < kStages; ++i, ++t) {
      acquire(kr, t);
      acquire(vr, t);
    }
    acquire(qr, j);
    return;
  }

  const int lane = tid & 31;
  const int rr = 16 * (tid >> 5) + (lane >> 2);  // rows rr, rr + 8 of a tile
  const int cq = 2 * (lane & 3);  // this thread's first column of an n-tile
  int t = 0, j = 0;               // tiles and items consumed so far
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++j) {
    const Item it = item_at(w, heads, kv_heads, bh, tiles, s, window);
    float o[HD / 2], sc[32];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];

    await_tile(qr, j);
    for (int i = 0; i < it.n; ++i, ++t) {
      issue_scores<HD>(sc, q_s, k_s + await_tile(kr, t) * L::kTile);
      wgmma_wait<0>();  // and P V of the tile before
      fence_regs(sc);
      fence_regs(o);
      release(kr, t);
      if (i > 0) release(vr, t - 1);
      if (i == it.n - 1) release(qr, j);  // the next item's Q may load
      online_softmax(sc, m, l, corr, (it.kt_lo + i) * kTileK, it.q0,
                     it.q0 + rr, cq, s, window, scale_log2);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        o[4 * c] *= corr[0];
        o[4 * c + 1] *= corr[0];
        o[4 * c + 2] *= corr[1];
        o[4 * c + 3] *= corr[1];
      }
      // O += P V: P's A fragments are the score accumulators, in bf16
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      const unsigned char* vs = v_s + await_tile(vr, t) * L::kTile;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, pa[kk],
                 gmma_desc(vs + kk * 16 * kSwizzle, L::kBlock, 1024));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
    release(vr, t - 1);

#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 1; x < 4; x <<= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], x);
    const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f),
                          1.0f / fmaxf(l[1], 1e-30f)};
    // the output tile into shared memory (swizzled as the TMA box wants
    // it, which also spreads a warp's stores over the banks) once the
    // previous item's store has read it, then out by one TMA store
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    consumer_sync();
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rr + 8 * half;
        unsigned char* dst = o_s + (c / 8) * L::kBlock + row * kSwizzle +
                             (((c % 8) ^ (row % 8)) * 16) + cq * 2;
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            o[4 * c + 2 * half] * inv[half],
            o[4 * c + 2 * half + 1] * inv[half]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (tid == 0) {
      for (int c = 0; c < L::kBlocks; ++c)
        tma_store(&to, o_s + c * L::kBlock, c * 64, it.q0, it.h, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 4-d bf16 map over (hd, S, heads, B) with (64, rows) boxes, 128-byte
// swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int hd, int s, int heads,
              int b, Strides st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(s),
                              cuuint64_t(heads), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const Strides* st, int b, int heads, int kv_heads, int s,
                 int window, float scale, void* stream) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, HD, s, heads, b, st[0], kTileQ) ||
      !make_map(&tk, k, HD, s, kv_heads, b, st[1], kTileK) ||
      !make_map(&tv, v, HD, s, kv_heads, b, st[2], kTileK) ||
      !make_map(&to, out, HD, s, heads, b, st[3], kTileQ))
    return int(cudaErrorInvalidValue);
  const int smem = WgmmaSmem<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const int items = b * heads * ((s + kTileQ - 1) / kTileQ);
  const int grid = min(items, kCtasPerSm * sms);
  flash_wgmma_kernel<HD><<<grid, kWgmmaThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, heads, kv_heads, b * heads, s, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out,
              const Strides* st, int b, int heads, int kv_heads, int s,
              int hd, int window, float scale, void* stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(b) * unsigned(heads),
                  unsigned((s + kBQ - 1) / kBQ));
  flash_kernel<T, NJ><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st[0], st[1], st[2],
      st[3], heads, kv_heads, s, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// strides: 12 element strides, (b, h, s) of q, k, v and out in turn
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* strides, int b, int heads, int kv_heads, int s,
           int hd, int window, float scale, void* stream) {
  if (b <= 0 || heads <= 0 || s <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (sizeof(T) == 2 && hd == 128)
    return launch_wgmma<128>(q, k, v, out, st, b, heads, kv_heads, s, window,
                             scale, stream);
  if (sizeof(T) == 2 && hd == 64)
    return launch_wgmma<64>(q, k, v, out, st, b, heads, kv_heads, s, window,
                            scale, stream);
  if (hd <= 16)
    return launch_nj<T, 1>(q, k, v, out, st, b, heads, kv_heads, s, hd,
                           window, scale, stream);
  if (hd <= 32)
    return launch_nj<T, 2>(q, k, v, out, st, b, heads, kv_heads, s, hd,
                           window, scale, stream);
  if (hd <= 64)
    return launch_nj<T, 4>(q, k, v, out, st, b, heads, kv_heads, s, hd,
                           window, scale, stream);
  if (hd <= 128)
    return launch_nj<T, 8>(q, k, v, out, st, b, heads, kv_heads, s, hd,
                           window, scale, stream);
  if (hd <= 256)
    return launch_nj<T, 16>(q, k, v, out, st, b, heads, kv_heads, s, hd,
                            window, scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_flash_attention_f32(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int b,
                             int heads, int kv_heads, int s, int hd,
                             int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, strides, b, heads, kv_heads, s, hd,
                       window, scale, stream);
}

int orca_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, const long long* strides, int b,
                              int heads, int kv_heads, int s, int hd,
                              int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, strides, b, heads, kv_heads, s,
                               hd, window, scale, stream);
}

}  // extern "C"
