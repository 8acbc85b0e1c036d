// Causal prefill flash attention for Hopper (sm_90a), GQA and an optional
// sliding window, forward only.
//
// Replaces repro/kernels/flash_attention.py::flash_attention. What it
// computes, for batch b, query head h and query position i:
//   out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
// over the keys j <= i (and i - j < window when window > 0), with
// scale = hd^-0.5 applied to q, the online softmax kept in f32, and the
// output written in q's dtype (f32 or bf16; inputs are widened to f32 on
// load). Query head h reads kv head h / G, G = H / KVH.
//
// Layout: q, out (B, H, S, hd); k, v (B, KVH, S, hd), all contiguous.
//
// What bounds it on an H100: operations. At the serve shape (B 8, H 40,
// S 512, hd 128) the causal half of the score and value products is about
// 21 GFLOP over 100 MB moved, some 200 flops a byte.
//
// The TPU kernel ran a (b, h, q-block, k-block) grid in order, carrying
// (m, l, acc) in VMEM scratch across the k-blocks. Here each CTA owns one
// (b, h, 64-row q tile) and loops over the key tiles itself, so the carry
// lives in registers. Key tiles wholly above the diagonal, or wholly
// before the window, are never visited, which is the TPU kernel's block
// skipping; heavy q tiles (late in the sequence) are scheduled first. Two
// paths:
//
// - bf16 with hd 64 or 128 (the serve shape): the products on the tensor
//   cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16
//   query rows over 64-key tiles staged in shared memory as bf16; the
//   probabilities are rounded to bf16 for the P x V product, the online
//   softmax stays in f32 (flash_mma_kernel). Not wgmma or TMA yet: those
//   are later work.
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
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 32;   // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr float kNegInf = -1e30f;

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
                 const T* __restrict__ v, T* __restrict__ out, int heads,
                 int kv_heads, int s, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int hq = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + kBQ * hq;
  float* v_s = k_s + kBK * hq;
  float* p_s = v_s + kBK * hd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int kh = (bh % heads) / (heads / kv_heads);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const T* qb = q + size_t(bh) * s * hd;
  const T* kb = k + (size_t(b) * kv_heads + kh) * s * hd;
  const T* vb = v + (size_t(b) * kv_heads + kh) * s * hd;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int qpos = q0 + r;
    q_s[r * hq + d] =
        qpos < s ? to_f32(qb[size_t(qpos) * hd + d]) * scale : 0.0f;
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
      k_s[t * hq + d] = in ? to_f32(kb[size_t(kpos) * hd + d]) : 0.0f;
      v_s[t * hd + d] = in ? to_f32(vb[size_t(kpos) * hd + d]) : 0.0f;
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

  T* ob = out + size_t(bh) * s * hd;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[size_t(qpos) * hd + d] = from_f32<T>(o[i][j] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 with hd 64 or 128: the products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;  // query rows per CTA: 16 per warp, 4 warps
constexpr int kMmaKeys = 64;  // keys per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

size_t mma_smem_bytes(int hd) {
  // K and V tiles, (64, hd + 8) bf16 each
  return 2 * sizeof(__nv_bfloat16) * size_t(kMmaKeys) * (hd + 8);
}

// Each warp owns 16 query rows: its Q fragments stay in registers for the
// whole walk, the 16 x 64 score tile of a key tile is 8 mma n-tiles of
// f32 accumulators, the online softmax runs on those registers (a row's
// 4 lanes reduce by shuffles), and the probabilities, rounded to bf16,
// are re-used in registers as the A operand of the P x V products (the
// score tile's accumulator layout is the A fragment layout). Scores are
// q . k accumulated in f32, then scaled.
template <int HD>
__global__ void __launch_bounds__(128)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int heads, int kv_heads,
                     int s, int window, float scale) {
  constexpr int kStride = HD + 8;  // smem row (bf16): 16-byte aligned rows
                                   // whose fragment reads hit distinct banks
  constexpr int kKS = HD / 16;     // k-steps over hd
  constexpr int kNT = kMmaKeys / 8;  // score n-tiles per key tile
  constexpr int kDT = HD / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kMmaKeys * kStride;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int kh = (bh % heads) / (heads / kv_heads);
  const int q0 = qt * kMmaRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in group
  const __nv_bfloat16* qb = q + size_t(bh) * s * HD;
  const __nv_bfloat16* kb = k + (size_t(b) * kv_heads + kh) * s * HD;
  const __nv_bfloat16* vb = v + (size_t(b) * kv_heads + kh) * s * HD;
  const int r0 = q0 + warp * 16 + gq;  // this thread's two query rows
  const int r1 = r0 + 8;

  uint32_t qa[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const int c = ks * 16 + tq * 2;
    auto ld = [&](int r, int col) -> uint32_t {
      return r < s ? *reinterpret_cast<const uint32_t*>(qb + size_t(r) * HD +
                                                         col)
                   : 0u;
    };
    qa[ks][0] = ld(r0, c);
    qa[ks][1] = ld(r1, c);
    qa[ks][2] = ld(r0, c + 8);
    qa[ks][3] = ld(r1, c + 8);
  }

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  const int q_last = min(q0 + kMmaRows, s) - 1;
  const int kt_end = q_last / kMmaKeys;
  const int kt_begin =
      window > 0 ? max(q0 - window + 1, 0) / kMmaKeys : 0;
  constexpr int kVecs = kMmaKeys * HD / 8;  // 16-byte pieces per tile

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kMmaKeys;
    __syncthreads();  // the previous tile's readers are done
#pragma unroll 4
    for (int e = tid; e < kVecs; e += 128) {
      const int row = e / (HD / 8);
      const int c = (e - row * (HD / 8)) * 8;
      const int kpos = k0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (kpos < s) {
        kv = __ldg(reinterpret_cast<const uint4*>(kb + size_t(kpos) * HD + c));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + size_t(kpos) * HD + c));
      }
      *reinterpret_cast<uint4*>(k_s + row * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + row * kStride + c) = vv;
    }
    __syncthreads();

    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const __nv_bfloat16* kr = k_s + (n * 8 + gq) * kStride + ks * 16 + tq * 2;
        mma_bf16(sc[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, scale and the online softmax of rows r0 (elements 0, 1) and
    // r1 (elements 2, 3); masked scores are -inf, so they weigh 0 even
    // while a row has seen no key
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + n * 8 + tq * 2 + (e & 1);
        const bool ok = col <= row && col < s &&
                        (window <= 0 || row - col < window);
        sc[n][e] = ok ? sc[n][e] * scale : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sc[n][0] = expf(sc[n][0] - mn0);
      sc[n][1] = expf(sc[n][1] - mn0);
      sc[n][2] = expf(sc[n][2] - mn1);
      sc[n][3] = expf(sc[n][3] - mn1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }

    // o += P V: P's A fragments are the score tile's accumulators
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = v_s + (kk * 16 + tq * 2) * kStride + gq;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        mma_bf16(o[j], pa, pack_raw(vc[0], vc[kStride]),
                 pack_raw(vc[8 * kStride], vc[9 * kStride]));
      }
    }
  }

  __nv_bfloat16* ob = out + size_t(bh) * s * HD;
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + tq * 2;
    if (r0 < s)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(r0) * HD + c) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < s)
      *reinterpret_cast<__nv_bfloat162*>(ob + size_t(r1) * HD + c) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int heads, int kv_heads, int s, int window, float scale,
               void* stream) {
  const size_t smem = mma_smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((s + kMmaRows - 1) / kMmaRows),
                  unsigned(b) * unsigned(heads));
  flash_mma_kernel<HD><<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      heads, kv_heads, s, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out, int b,
              int heads, int kv_heads, int s, int hd, int window, float scale,
              void* stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((s + kBQ - 1) / kBQ), unsigned(b) * unsigned(heads));
  flash_kernel<T, NJ><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads, kv_heads, s, hd,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int heads, int kv_heads, int s, int hd, int window, float scale,
           void* stream) {
  if (b <= 0 || heads <= 0 || s <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads) return int(cudaErrorInvalidValue);
  if (sizeof(T) == 2 && hd == 128)
    return launch_mma<128>(q, k, v, out, b, heads, kv_heads, s, window, scale,
                           stream);
  if (sizeof(T) == 2 && hd == 64)
    return launch_mma<64>(q, k, v, out, b, heads, kv_heads, s, window, scale,
                          stream);
  if (hd <= 16)
    return launch_nj<T, 1>(q, k, v, out, b, heads, kv_heads, s, hd, window,
                           scale, stream);
  if (hd <= 32)
    return launch_nj<T, 2>(q, k, v, out, b, heads, kv_heads, s, hd, window,
                           scale, stream);
  if (hd <= 64)
    return launch_nj<T, 4>(q, k, v, out, b, heads, kv_heads, s, hd, window,
                           scale, stream);
  if (hd <= 128)
    return launch_nj<T, 8>(q, k, v, out, b, heads, kv_heads, s, hd, window,
                           scale, stream);
  if (hd <= 256)
    return launch_nj<T, 16>(q, k, v, out, b, heads, kv_heads, s, hd, window,
                            scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_flash_attention_f32(const void* q, const void* k, const void* v,
                             void* out, int b, int heads, int kv_heads, int s,
                             int hd, int window, float scale, void* stream) {
  return launch<float>(q, k, v, out, b, heads, kv_heads, s, hd, window, scale,
                       stream);
}

int orca_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* out, int b, int heads, int kv_heads,
                              int s, int hd, int window, float scale,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, heads, kv_heads, s, hd,
                               window, scale, stream);
}

}  // extern "C"
