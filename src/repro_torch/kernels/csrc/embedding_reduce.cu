// ORCA-DLRM embedding reduction for Hopper (sm_90a): gather table rows and
// sum each run of equal segment ids, in f32, into one output row per
// segment.
//
// Replaces repro/kernels/embedding_reduce.py::embedding_reduce together
// with the zeroing of empty segments that repro/kernels/ops.py adds to it.
// What it computes: out[s] = table[idx[n0]] + table[idx[n0+1]] + ... over
// the positions n0.. of segment s in the non-decreasing seg_ids, added in
// that order, each row converted to f32 first; a segment with no entries
// is zero. The sum starts from the segment's first row, never from +0.0,
// so it keeps the sign of a -0.0 sum and equals the plain version
// (repro_torch/kernels/ref.py::embedding_reduce, and dlrm_embedding_reduce
// on the DLRM layout) bit for bit. There are only adds, so no FMA
// contraction can change the bits.
//
// Layout: table (R, D) row-major, f32 or bf16; idx and seg_ids (N,)
// int32; out (S, D) f32. Row offsets idx * D are 64-bit: the DLRM path
// flattens T tables of R rows into one (T*R, D) table.
//
// What bounds it on an H100: bytes. Each lookup reads one D-wide row at a
// random place in a table far larger than the 50 MB L2 (2 GB at 8 tables
// of 2^20 rows of 64 f32), so the reads are HBM latency- and
// bandwidth-bound; there is one add per element read. The design: one
// warp per segment, the accumulator in registers across the whole
// segment (lane l holds columns l, l+32, ... of a 128-column chunk, two
// floats a lane at D = 64), each row read by the whole warp in coalesced
// 128-B pieces, one write per output element, no shared memory and no
// atomics. Segment bounds come from a binary search of seg_ids in the
// kernel. The loop over a segment's rows is sequential — the order the
// sums need — so the memory-level parallelism comes from the many warps
// (2,048 segments at the engine's batch) in flight across the SMs.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kCols = 4;  // columns per lane per chunk: 128-column chunks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// First position n in [0, N) with seg_ids[n] >= s (N if none).
__device__ __forceinline__ int64_t lower_bound(const int32_t* seg_ids,
                                               int64_t n, int64_t s) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (seg_ids[mid] < s)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void embedding_reduce_kernel(const T* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        const int32_t* __restrict__ seg_ids,
                                        float* __restrict__ out, int64_t n,
                                        int64_t rows, int dim,
                                        int64_t segments) {
  const int64_t s = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= segments) return;  // uniform across the warp
  const int64_t begin = lower_bound(seg_ids, n, s);
  const int64_t end = lower_bound(seg_ids, n, s + 1);
  float* dst = out + s * dim;
  for (int c0 = 0; c0 < dim; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;  // an empty segment
    for (int64_t p = begin; p < end; ++p) {
      const int64_t r = idx[p];
      const bool in_range = r >= 0 && r < rows;  // else the row reads as 0
      const T* src = table + r * dim;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int d = c0 + lane + 32 * k;
        if (d < dim) {
          const float v = in_range ? to_f32(src[d]) : 0.0f;
          acc[k] = (p == begin) ? v : acc[k] + v;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int d = c0 + lane + 32 * k;
      if (d < dim) dst[d] = acc[k];
    }
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* seg_ids, void* out,
           long long n, long long rows, int dim, long long segments,
           void* stream) {
  if (segments <= 0) return 0;
  const unsigned blocks =
      unsigned((segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  embedding_reduce_kernel<T><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(seg_ids), static_cast<float*>(out), n, rows,
      dim, segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_embedding_reduce_f32(const void* table, const void* idx,
                              const void* seg_ids, void* out, long long n,
                              long long rows, int dim, long long segments,
                              void* stream) {
  return launch<float>(table, idx, seg_ids, out, n, rows, dim, segments,
                       stream);
}

int orca_embedding_reduce_bf16(const void* table, const void* idx,
                               const void* seg_ids, void* out, long long n,
                               long long rows, int dim, long long segments,
                               void* stream) {
  return launch<__nv_bfloat16>(table, idx, seg_ids, out, n, rows, dim,
                               segments, stream);
}

}  // extern "C"
