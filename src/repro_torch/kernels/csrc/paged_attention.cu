// Paged GQA decode attention for Hopper (sm_90a): the raw online-softmax
// stats (acc, m, l) of each query row over the tokens a sequence holds in
// a paged KV pool.
//
// Replaces repro/kernels/paged_attention.py::paged_attention_stats (and,
// with the divide the wrapper adds, ::paged_attention). What it computes,
// per sequence b, kv head h and query row r of the G rows sharing h:
//   s_t = q[b,h,r] . K[t]      over the first lengths[b] tokens t
//   m   = max_t s_t,  l = sum_t exp(s_t - m),  acc = sum_t exp(s_t - m) V[t]
// all in f32 (q arrives f32 and pre-scaled; pages are f32 or bf16 and
// are widened to f32 as they are read). Token t of sequence b lies in
// physical page page_table[b, t / PS] at row t % PS. A dead entry (-1)
// resolves to the last physical page, the pool's zero sentinel, and an
// entry past the pool clamps to it, so the walk never reads page -1 or
// NP; tokens at or past lengths[b] are masked. A zero-length sequence yields
// (0, -1e30, 0), the empty softmax, which the caller LSE-merges safely.
//
// Layout: q (B, KVH, G, hd) f32; pages (NP, PS, KVH, hd); page_table
// (B, MaxP) int32; lengths (B,) int32; acc (B, KVH, G, hd), m and l
// (B, KVH, G) f32.
//
// What bounds it on an H100: bytes. Each live token's K and V rows are
// read once (2 x hd x 2 B in bf16) and there are 4 x G x hd flops per
// token, about 5 flops a byte at G = 5, far below the card's ~295. The
// TPU kernel walked one page per grid step in order; here the grid is one
// CTA per (b, h) holding all G rows of the group, so K and V are read
// once for the group. One warp per query row (at least four warps, which
// share the loads when G < 4). The walk over a sequence goes in chunks of
// 32 tokens: all threads issue every 16-byte load of a chunk's K and V
// rows together (coalesced along hd) into registers, copy them as they
// are (bf16 stays bf16) into shared memory, and issue the next chunk's
// loads before reducing this one, so the memory latency overlaps the
// arithmetic. Each warp scores the chunk for its row with one token per
// lane (4-wide reads widened to f32, four independent partial sums),
// keeps the row's running max and sum in registers through warp-shuffle
// reductions, and updates its (hd,)
// accumulator in registers, lane l holding d = l + 32 j and taking each
// token's weight from the lane that scored it by a shuffle. hd must be a
// multiple of 8, at most 256, with a row of at most 512 bytes; G at most
// 8. The loop over chunks is sequential within a CTA; parallelism comes
// from the B x KVH CTAs (256 at the serve shape) resident together.
// Splitting a long sequence over several CTAs (flash-decoding) would add
// memory-level parallelism and is left to later work.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;     // tokens per step of the walk: one per lane
constexpr int kMaxVec = 8;     // 16-byte loads per thread per chunk
constexpr int kMaxRows = 8;    // G: one warp per query row
constexpr int kMinWarps = 4;   // warps that share the loads when G < 4
constexpr float kNegInf = -1e30f;

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

template <typename T>
size_t smem_bytes(int g, int hd) {
  // q (G, hd) f32 | K chunk (32, hd + 4) and V chunk (32, hd) in the
  // pages' own type
  return sizeof(float) * size_t(g) * hd +
         sizeof(T) * (size_t(kChunk) * (hd + 4) + size_t(kChunk) * hd);
}

// Issue every 16-byte K and V load of the chunk starting at token c0 into
// registers: piece i of this thread is token tt[i], element dd[i] of the
// row. Tokens at or past len (and their pages) are never read.
template <typename T>
__device__ __forceinline__ void load_chunk(
    uint4 (&rk)[kMaxVec], uint4 (&rv)[kMaxVec], const int (&tt)[kMaxVec],
    const int (&dd)[kMaxVec], const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ pt, int c0,
    int len, int ps, int kvh, int h, int hd, int n_pages) {
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    rk[i] = make_uint4(0, 0, 0, 0);
    rv[i] = rk[i];
    const int pos = c0 + tt[i];
    if (tt[i] < kChunk && pos < len) {
      int page = pt[pos / ps];
      page = page < 0 ? n_pages - 1 : (page >= n_pages ? n_pages - 1 : page);
      const size_t off =
          ((size_t(page) * ps + pos % ps) * kvh + h) * size_t(hd) + dd[i];
      rk[i] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
      rv[i] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
    }
  }
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
                       int n_pages, int ps, int maxp) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hdk = hd + 4;  // padded K row: the lanes' row reads hit
                           // distinct banks
  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* k_s = reinterpret_cast<T*>(q_s + g * hd);
  T* v_s = k_s + kChunk * hdk;

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 5;  // this warp's query row (warps >= G idle)
  const size_t row0 = (size_t(b) * kvh + h) * g;  // first (b, h, r) row

  for (int e = tid; e < g * hd; e += blockDim.x) q_s[e] = q[row0 * hd + e];
  int len = lengths[b];
  len = len < 0 ? 0 : (len > maxp * ps ? maxp * ps : len);
  const int32_t* pt = page_table + size_t(b) * maxp;
  int tt[kMaxVec], dd[kMaxVec];  // this thread's pieces of a chunk
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int e = tid + i * blockDim.x;
    const int vpr = hd / kVec;
    tt[i] = e / vpr;
    dd[i] = (e - tt[i] * vpr) * kVec;
  }

  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.0f;
  float m = kNegInf, l = 0.0f;  // the row's running max and sum

  uint4 rk[kMaxVec], rv[kMaxVec];
  if (len > 0)
    load_chunk(rk, rv, tt, dd, k_pages, v_pages, pt, 0, len, ps, kvh, h, hd,
               n_pages);

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    // this chunk's registers into shared memory, as they are
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      if (tt[i] < kChunk) {
        uint2* kd = reinterpret_cast<uint2*>(k_s + tt[i] * hdk + dd[i]);
        uint2* vd = reinterpret_cast<uint2*>(v_s + tt[i] * hd + dd[i]);
        kd[0] = make_uint2(rk[i].x, rk[i].y);
        kd[1] = make_uint2(rk[i].z, rk[i].w);
        vd[0] = make_uint2(rv[i].x, rv[i].y);
        vd[1] = make_uint2(rv[i].z, rv[i].w);
      }
    }
    __syncthreads();
    // the next chunk's loads fly while this one is reduced
    if (c0 + kChunk < len)
      load_chunk(rk, rv, tt, dd, k_pages, v_pages, pt, c0 + kChunk, len, ps,
                 kvh, h, hd, n_pages);

    if (row < g) {
      // score: one token per lane, four independent partial sums over hd
      const bool valid = c0 + lane < len;
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
    __syncthreads();  // shared memory is rewritten by the next chunk
  }

  if (row < g) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) acc_out[(row0 + row) * hd + d] = acc[j];
    }
    if (lane == 0) {
      m_out[row0 + row] = m;
      l_out[row0 + row] = l;
    }
  }
}

template <typename T, int ND>
int launch_nd(const void* q, const void* k_pages, const void* v_pages,
              const void* page_table, const void* lengths, void* acc, void* m,
              void* l, int b, int kvh, int g, int hd, int n_pages, int ps,
              int maxp, void* stream) {
  const int threads = 32 * (g > kMinWarps ? g : kMinWarps);
  const size_t smem = smem_bytes<T>(g, hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_stats_kernel<T, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  paged_stats_kernel<T, ND><<<unsigned(b) * unsigned(kvh), threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kvh, g, hd, n_pages, ps,
      maxp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* acc, void* m,
           void* l, int b, int kvh, int g, int hd, int n_pages, int ps,
           int maxp, void* stream) {
  if (b <= 0 || kvh <= 0 || g <= 0) return 0;
  if (g > kMaxRows || hd % 8 || hd > 256 ||
      kChunk * hd * int(sizeof(T)) > kMinWarps * 32 * kMaxVec * 16)
    return int(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_nd<T, 1>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, stream);
  if (hd <= 64)
    return launch_nd<T, 2>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, stream);
  if (hd <= 128)
    return launch_nd<T, 4>(q, k_pages, v_pages, page_table, lengths, acc, m,
                           l, b, kvh, g, hd, n_pages, ps, maxp, stream);
  return launch_nd<T, 8>(q, k_pages, v_pages, page_table, lengths, acc, m, l,
                         b, kvh, g, hd, n_pages, ps, maxp, stream);
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
                                   int n_pages, int ps, int maxp,
                                   void* stream) {
  return launch<float>(q, k_pages, v_pages, page_table, lengths, acc, m, l, b,
                       kvh, g, hd, n_pages, ps, maxp, stream);
}

int orca_paged_attention_stats_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* page_table,
                                    const void* lengths, void* acc, void* m,
                                    void* l, int b, int kvh, int g, int hd,
                                    int n_pages, int ps, int maxp,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, acc,
                               m, l, b, kvh, g, hd, n_pages, ps, maxp, stream);
}

}  // extern "C"
