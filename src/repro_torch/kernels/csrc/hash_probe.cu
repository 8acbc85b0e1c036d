// Hash-table kernels of ORCA-KV for Hopper (sm_90a): the GET walk (probe,
// fetch), the hot-set cache probe, and the two scatter passes of a PUT
// commit (commit_buckets, write_rows).
//
// Layout: every array is int32 and row-major, in the sentinel-resident
// KVState layout of repro_torch.core.kvstore — the last row of
// bucket_keys (NB+1, W, KW), bucket_ptr (NB+1, W), pool (NP+1, VW) and of
// the cache arrays is an all-zero pad row. Offsets into the state arrays
// are 64-bit: (NP+1)*VW exceeds INT32_MAX at the paper's store size
// (2^27 rows of 16 words). Ids and pointers stay int32.
//
// What bounds them on an H100 (3.35 TB/s): each request moves a few
// hundred bytes at random rows, and the engine's batch is 256 requests, so
// a launch moves ~100 KB — a few hundredths of a microsecond of bandwidth.
// At that batch every kernel is bound by launch latency, not by bytes; at
// the bulk-load batch (65,536) by the latency of dependent random reads.
// The design answer for now is to be simple and right: one warp or one
// thread per word, coalesced where the layout allows, no shared memory.
// Fusing the walk into fewer launches (or a CUDA graph over the step) is
// the lever a later change pulls.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ int64_t global_warp() {
  return (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t global_thread() {
  return int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---------------------------------------------------------------------------
// probe — replaces repro/kernels/hash_probe.py::probe.
// One warp per request; lane w compares way w (ways > 32 loop) of the
// primary bucket h1 and then of the overflow bucket h2. A way matches when
// its KW key words equal the query and its pointer is >= 0; the bucket's
// pointer is the max over matching ways, the primary bucket wins, and a
// miss reports found=0, ptr=0.
// Bytes per request: 2 * W * (KW + 1) * 4 of bucket rows + the query —
// 192 B at W=8, KW=2. The warp loads all ways of a bucket at once,
// so a request costs two dependent-free rounds of random reads.
// ---------------------------------------------------------------------------
__global__ void probe_kernel(const int32_t* __restrict__ bucket_keys,
                             const int32_t* __restrict__ bucket_ptr,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ h1,
                             const int32_t* __restrict__ h2,
                             bool* __restrict__ found,
                             int32_t* __restrict__ ptr,
                             int64_t batch, int64_t rows, int ways,
                             int key_words) {
  const int64_t i = global_warp();
  const int lane = threadIdx.x & 31;
  if (i >= batch) return;  // uniform across the warp
  const int32_t* q = keys + i * key_words;
  const int64_t bucket[2] = {h1[i], h2[i]};
  bool hit[2] = {false, false};
  int best[2] = {-1, -1};
  for (int s = 0; s < 2; ++s) {
    const int64_t b = bucket[s];
    if (b < 0 || b >= rows) continue;  // out-of-range id matches nothing
    for (int w = lane; w < ways; w += 32) {
      const int64_t slot = b * ways + w;
      const int32_t p = bucket_ptr[slot];
      const int32_t* k = bucket_keys + slot * key_words;
      bool eq = p >= 0;
      for (int j = 0; j < key_words; ++j) eq = eq && (k[j] == q[j]);
      if (eq) {
        hit[s] = true;
        best[s] = max(best[s], p);
      }
    }
    hit[s] = __any_sync(kFullMask, hit[s]);
    best[s] = warp_max(best[s]);
  }
  if (lane == 0) {
    const bool f = hit[0] || hit[1];
    found[i] = f;
    ptr[i] = f ? (hit[0] ? best[0] : best[1]) : 0;
  }
}

// ---------------------------------------------------------------------------
// fetch — replaces repro/kernels/hash_probe.py::fetch.
// One thread per output word: thread t copies word t % VW of pool row
// ptr[t / VW], so a warp reads two whole 64-B rows and writes 128
// contiguous bytes. Misses carry ptr = NP and read the zero sentinel row.
// Bytes per request: VW * 4 read + VW * 4 written + 4 (ptr).
// ---------------------------------------------------------------------------
__global__ void fetch_kernel(const int32_t* __restrict__ pool,
                             const int32_t* __restrict__ ptr,
                             int32_t* __restrict__ out, int64_t batch,
                             int64_t rows, int val_words) {
  const int64_t t = global_thread();
  if (t >= batch * val_words) return;
  const int64_t i = t / val_words;
  const int64_t j = t % val_words;
  const int64_t r = ptr[i];
  out[t] = (r >= 0 && r < rows) ? pool[r * val_words + j] : 0;
}

// ---------------------------------------------------------------------------
// cache_probe — replaces repro/kernels/hash_probe.py::cache_probe.
// One warp per request; lane w tests way w of set cset[i]: a hit needs the
// key words to match and meta > 0 (meta 0 = empty way, so the zero
// sentinel set never hits). The way is the max matching index; the warp
// then copies that way's VW-word value line (zeros on a miss).
// Bytes per request: CW * (KW + 1) * 4 of set keys and meta + VW * 4 of
// the value line, written back as VW * 4 + 5. The whole cache is sized to
// stay in L2 (core/placement.py), so these are L2 hits when it is warm.
// ---------------------------------------------------------------------------
__global__ void cache_probe_kernel(const int32_t* __restrict__ cache_keys,
                                   const int32_t* __restrict__ cache_vals,
                                   const int32_t* __restrict__ cache_meta,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ cset,
                                   bool* __restrict__ hit_out,
                                   int32_t* __restrict__ way_out,
                                   int32_t* __restrict__ vals_out,
                                   int64_t batch, int64_t sets, int ways,
                                   int key_words, int val_words) {
  const int64_t i = global_warp();
  const int lane = threadIdx.x & 31;
  if (i >= batch) return;  // uniform across the warp
  const int32_t* q = keys + i * key_words;
  const int64_t s = cset[i];
  int way = -1;
  if (s >= 0 && s < sets) {
    for (int w = lane; w < ways; w += 32) {
      const int64_t slot = s * ways + w;
      const int32_t* k = cache_keys + slot * key_words;
      bool eq = cache_meta[slot] > 0;
      for (int j = 0; j < key_words; ++j) eq = eq && (k[j] == q[j]);
      if (eq) way = max(way, w);
    }
  }
  way = warp_max(way);
  const bool hit = way >= 0;
  if (lane == 0) {
    hit_out[i] = hit;
    way_out[i] = hit ? way : 0;
  }
  const int32_t* line = cache_vals + (s * ways + (hit ? way : 0)) * val_words;
  for (int j = lane; j < val_words; j += 32)
    vals_out[i * val_words + j] = hit ? line[j] : 0;
}

// ---------------------------------------------------------------------------
// commit_buckets — replaces repro/kernels/hash_probe.py::commit_buckets.
// PUT scatter pass 1, in place: one thread per word of an entry (KW key
// words + the pointer). The TPU kernel rewrites whole bucket rows, safe
// only because its grid runs in order over bucket-sorted entries; blocks
// here run in parallel, so each entry stores ONLY its chosen way's words.
// That is race-free: the plan makes live (tb, tw) unique, and every entry
// aimed at the sentinel row NB writes identical zeros. The sort order the
// TPU kernel needs is not used.
// Bytes per entry: (KW + 1) * 4 read and written + 12 of plan.
// ---------------------------------------------------------------------------
__global__ void commit_buckets_kernel(int32_t* __restrict__ bucket_keys,
                                      int32_t* __restrict__ bucket_ptr,
                                      const int32_t* __restrict__ keys,
                                      const int32_t* __restrict__ tb,
                                      const int32_t* __restrict__ tw,
                                      const int32_t* __restrict__ bptr_val,
                                      int64_t batch, int64_t nb, int ways,
                                      int key_words) {
  const int64_t t = global_thread();
  const int per = key_words + 1;
  if (t >= batch * per) return;
  const int64_t i = t / per;
  const int j = int(t % per);
  const int64_t b = tb[i];
  const int w = tw[i];
  if (b < 0 || b > nb || w < 0 || w >= ways) return;  // outside the arrays
  const bool sentinel = b == nb;
  const int64_t slot = b * ways + w;
  if (j < key_words)
    bucket_keys[slot * key_words + j] = sentinel ? 0 : keys[i * key_words + j];
  else
    bucket_ptr[slot] = sentinel ? 0 : bptr_val[i];
}

// ---------------------------------------------------------------------------
// write_rows — replaces repro/kernels/hash_probe.py::write_rows.
// PUT scatter pass 2, in place: one thread per value word, row wp[i] <-
// vals[i]; entries aimed at the sentinel row NP write zeros (the payload
// zeroing the JAX wrapper does beforehand happens here). Live wp are
// unique by the plan's construction, so no two threads race on a live row.
// Bytes per entry: VW * 4 read and written + 4 of plan.
// ---------------------------------------------------------------------------
__global__ void write_rows_kernel(int32_t* __restrict__ pool,
                                  const int32_t* __restrict__ vals,
                                  const int32_t* __restrict__ wp,
                                  int64_t batch, int64_t np_rows,
                                  int val_words) {
  const int64_t t = global_thread();
  if (t >= batch * val_words) return;
  const int64_t i = t / val_words;
  const int64_t j = t % val_words;
  const int64_t r = wp[i];
  if (r < 0 || r > np_rows) return;  // outside the array
  pool[r * val_words + j] = (r == np_rows) ? 0 : vals[t];
}

unsigned blocks_for(int64_t threads) {
  return unsigned((threads + kThreads - 1) / kThreads);
}

unsigned blocks_for_warps(int64_t warps) {
  return unsigned((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int orca_probe(const void* bucket_keys, const void* bucket_ptr,
               const void* keys, const void* h1, const void* h2, void* found,
               void* ptr, long long batch, long long rows, int ways,
               int key_words, void* stream) {
  if (batch <= 0) return 0;
  probe_kernel<<<blocks_for_warps(batch), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket_keys),
      static_cast<const int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(h1),
      static_cast<const int32_t*>(h2), static_cast<bool*>(found),
      static_cast<int32_t*>(ptr), batch, rows, ways, key_words);
  return static_cast<int>(cudaGetLastError());
}

int orca_fetch(const void* pool, const void* ptr, void* out, long long batch,
               long long rows, int val_words, void* stream) {
  if (batch <= 0) return 0;
  fetch_kernel<<<blocks_for(batch * val_words), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pool), static_cast<const int32_t*>(ptr),
      static_cast<int32_t*>(out), batch, rows, val_words);
  return static_cast<int>(cudaGetLastError());
}

int orca_cache_probe(const void* cache_keys, const void* cache_vals,
                     const void* cache_meta, const void* keys,
                     const void* cset, void* hit, void* way, void* vals,
                     long long batch, long long sets, int ways, int key_words,
                     int val_words, void* stream) {
  if (batch <= 0) return 0;
  cache_probe_kernel<<<blocks_for_warps(batch), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cache_keys),
      static_cast<const int32_t*>(cache_vals),
      static_cast<const int32_t*>(cache_meta),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(cset),
      static_cast<bool*>(hit), static_cast<int32_t*>(way),
      static_cast<int32_t*>(vals), batch, sets, ways, key_words, val_words);
  return static_cast<int>(cudaGetLastError());
}

int orca_commit_buckets(void* bucket_keys, void* bucket_ptr, const void* keys,
                        const void* tb, const void* tw, const void* bptr_val,
                        long long batch, long long nb, int ways, int key_words,
                        void* stream) {
  if (batch <= 0) return 0;
  commit_buckets_kernel<<<blocks_for(batch * (key_words + 1)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(bucket_keys), static_cast<int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(tb),
      static_cast<const int32_t*>(tw), static_cast<const int32_t*>(bptr_val),
      batch, nb, ways, key_words);
  return static_cast<int>(cudaGetLastError());
}

int orca_write_rows(void* pool, const void* vals, const void* wp,
                    long long batch, long long np_rows, int val_words,
                    void* stream) {
  if (batch <= 0) return 0;
  write_rows_kernel<<<blocks_for(batch * val_words), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(pool), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(wp), batch, np_rows, val_words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
