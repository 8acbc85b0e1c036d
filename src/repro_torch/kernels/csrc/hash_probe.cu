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
// Bytes bound none of them. At the engine's batch the time is the launch
// plus the chain of DEPENDENT random reads a request waits on (an id, then
// the rows it names), each a round trip to L2 (about 0.12-0.15 µs warm)
// or, on the main path, where each KVS step streams far more than the
// 50 MB L2 between two probes, to DRAM. At the bulk-load batch (65,536)
// the same latency is spread over thousands of warps.
//
// So the two lookups (probe, cache_probe) issue every load a request
// could need in two rounds: (1) its ids and its query key; (2)
// unconditionally, everything those ids address — both buckets' key
// words and pointers, or the set's keys, meta and all of its value lines.
// Only then do they compare, on registers, with & and == (no short
// circuit, which would order each key word's load behind the previous
// word's), reduce over a lane group with shuffles, and store. One
// dependent round trip lies between the id loads and the stores. The
// arrays are read-only to them: loads go through the read-only path
// (__ldg, ld.global.nc). Lane-map arithmetic is 32-bit with shifts (a
// 64-bit division compiles to a called subroutine); element offsets into
// the state arrays are 64-bit.
//
// CTA size: 256 threads. Measured with scripts/hash_probe_ab.py on an
// H100 against 32, 64 and 128 (ORCA_PROBE_THREADS builds another size):
// at the engine's batch, 16 CTAs of 256 threads beat 128 CTAs of one
// warp by about 0.05 µs in both lookups, unlike the TX commit's
// scatter; at 65,536 requests 128 and 256 tie and smaller CTAs lose up
// to 2.5x: below 128 threads the time follows the count of CTAs (about
// 90 ns a CTA on each SM at 32 threads).
//
// fetch, commit_buckets and write_rows are still the first simple
// kernels: one thread per word, coalesced where the layout allows.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch
// (cudaErrorInvalidValue for a batch past the lookups' 32-bit lane index).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ORCA_PROBE_THREADS
#define ORCA_PROBE_THREADS 256  // threads a CTA of a lookup launch
#endif

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLookupThreads = ORCA_PROBE_THREADS;
constexpr long long kMaxLookups = 1LL << 26;  // lookup lanes fit in 32 bits

__device__ __forceinline__ int64_t global_thread() {
  return int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int2 ldg2(const int32_t* p) {
  return __ldg(reinterpret_cast<const int2*>(p));
}

__device__ __forceinline__ int4 ldg4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// max over aligned groups of 2 * half lanes (half a power of two, <= 16)
__device__ __forceinline__ int group_max(int v, int half) {
  for (int off = half; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// probe — replaces repro/kernels/hash_probe.py::probe.
// A way matches when its KW key words equal the query and its pointer is
// >= 0; a bucket's pointer is the max over its matching ways, the primary
// bucket h1 wins over the overflow bucket h2, a miss reports found=0,
// ptr=0, and an id outside [0, rows) matches nothing and reads nothing.
//
// Lane map: a request takes a group of 2L lanes, L = min(16, W rounded up
// to a power of two) a bucket: lane l of the group serves bucket l / L
// (h1 or h2) and ways l % L, l % L + L, ... (one way at W <= 16). Round 1:
// each lane loads its bucket's id and the query; round 2: its way's key
// words and pointer, both buckets' loads in flight together. Reduction:
// log2(L) xor-shuffles give each bucket's max matching pointer (-1 for
// none) in all of its lanes, one more (xor L) brings the other bucket's
// to lane 0 of the group, which stores found and ptr.
//
// At the serve shape (W = 8, KW = 2, the kWays/kKW instance) a group is
// 16 lanes, two requests a warp: lane l makes one 8-byte load of way
// l % 8's key words (8 lanes read one 64-byte bucket row) and one 4-byte
// load of its pointer (32 contiguous bytes). Other shapes run the
// run-time instance (kWays = 0): 4-byte key loads, a loop over ways when
// W > 16 and over key words. The entry point takes the serve instance
// only where bucket_keys and keys start 8-byte aligned.
// Bytes per request: 2 * W * (KW + 1) * 4 of bucket rows + the query and
// ids + 5 written — 213 B at W = 8, KW = 2.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n >> 1) : 0;
}

template <int kWays, int kKW>
__global__ void probe_kernel(const int32_t* __restrict__ bucket_keys,
                             const int32_t* __restrict__ bucket_ptr,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ h1,
                             const int32_t* __restrict__ h2,
                             bool* __restrict__ found,
                             int32_t* __restrict__ ptr, unsigned batch,
                             int64_t rows, int ways, int key_words,
                             int half_shift) {
  static_assert(kWays == 0 || (kKW == 2 && kWays <= 16 &&
                               (kWays & (kWays - 1)) == 0),
                "the serve lane map: a lane a way, 8-byte key loads");
  if constexpr (kWays > 0) half_shift = ilog2(kWays);
  const int half = 1 << half_shift;  // L
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned i = t >> (half_shift + 1);
  const int gl = int(threadIdx.x) & (2 * half - 1);
  const int w0 = gl & (half - 1);
  int best = -1;
  if (i < batch) {
    const int32_t b = __ldg((gl < half ? h1 : h2) + i);
    if constexpr (kWays > 0) {
      const int2 q = ldg2(keys + int64_t(i) * 2);
      if (b >= 0 && b < rows) {
        const int64_t slot = int64_t(b) * kWays + w0;
        const int2 k = ldg2(bucket_keys + slot * 2);
        const int32_t p = __ldg(bucket_ptr + slot);
        best = ((p >= 0) & (k.x == q.x) & (k.y == q.y)) ? p : -1;
      }
    } else {
      const int32_t* q = keys + int64_t(i) * key_words;
      if (b >= 0 && b < rows) {
        for (int w = w0; w < ways; w += half) {
          const int64_t slot = int64_t(b) * ways + w;
          const int32_t* k = bucket_keys + slot * key_words;
          const int32_t p = __ldg(bucket_ptr + slot);
          bool eq = p >= 0;
          for (int j = 0; j < key_words; ++j)
            eq = eq & (__ldg(k + j) == __ldg(q + j));
          best = max(best, eq ? p : -1);
        }
      }
    }
  }
  best = group_max(best, half >> 1);
  const int other = __shfl_xor_sync(kFullMask, best, half);
  if (gl == 0 && i < batch) {  // lane 0 holds h1's max, `other` h2's
    const int r = best >= 0 ? best : other;
    found[i] = r >= 0;
    ptr[i] = r >= 0 ? r : 0;
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
// A hit needs the way's key words to match and meta > 0 (meta 0 = empty
// way, so the zero sentinel set never hits); the way is the MAX matching
// way, and the output line is that way's VW words (zeros and way 0 on a
// miss). A set id outside [0, sets) hits nothing and reads nothing.
//
// Serve shape (CW = 4, KW = 2, VW = 16, the kCW/kKW/kVW instance): a
// request takes a group of 16 lanes, two requests a warp. A set's CW * VW
// value words are contiguous (256 bytes, two 128-byte lines), and round 2
// loads all of them speculatively beside the keys: lane l makes one
// 16-byte load of the set's value block (chunk l % 4 of way l / 4), and
// lanes 0-3 also load way l's key words (8 bytes) and meta. Two shuffles
// give the max matching way among lanes 0-3, one more broadcasts it, and
// the four lanes that hold the winner's line store it: 64 bytes,
// coalesced, no third round trip. The entry point takes this instance
// only where the arrays start aligned to their vector loads (cache_keys,
// keys 8 bytes; cache_vals, vals 16).
//
// Other shapes (the run-time instance): a warp a request, lane w loading
// way w's key words and meta (ways > 32 loop), a warp max, then the
// winner's line — a second dependent round, since an arbitrary CW * VW
// block does not fit a warp's registers.
// Bytes per request: CW * (KW + 1) * 4 of set keys and meta + VW * 4 of
// the line (CW * VW * 4 read at the serve shape) + the query and id,
// written back as VW * 4 + 5. The whole cache is sized to stay in L2
// (core/placement.py), but the main path's other traffic evicts it.
// ---------------------------------------------------------------------------
template <int kCW, int kKW, int kVW>
__global__ void cache_probe_kernel(const int32_t* __restrict__ cache_keys,
                                   const int32_t* __restrict__ cache_vals,
                                   const int32_t* __restrict__ cache_meta,
                                   const int32_t* __restrict__ keys,
                                   const int32_t* __restrict__ cset,
                                   bool* __restrict__ hit_out,
                                   int32_t* __restrict__ way_out,
                                   int32_t* __restrict__ vals_out,
                                   unsigned batch, int64_t sets, int ways,
                                   int key_words, int val_words) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = int(threadIdx.x) & 31;
  if constexpr (kCW > 0) {
    static_assert(kKW == 2 && kCW * kVW == 64, "the serve lane map");
    constexpr int kChunks = kVW / 4;  // 16-byte chunks a way
    const unsigned i = t >> 4;
    const int gl = lane & 15;
    int cand = -1;
    int4 v = make_int4(0, 0, 0, 0);
    if (i < batch) {
      const int32_t s = __ldg(cset + i);
      const int2 q = ldg2(keys + int64_t(i) * 2);
      if (s >= 0 && s < sets) {
        const int64_t set = int64_t(s) * kCW;
        v = ldg4(cache_vals + set * kVW + gl * 4);
        if (gl < kCW) {
          const int2 k = ldg2(cache_keys + (set + gl) * 2);
          const int32_t m = __ldg(cache_meta + set + gl);
          cand = ((m > 0) & (k.x == q.x) & (k.y == q.y)) ? gl : -1;
        }
      }
    }
    cand = group_max(cand, kCW >> 1);  // lanes 0..CW-1 of the group
    const int way = __shfl_sync(kFullMask, cand, lane & ~15);
    const bool hit = way >= 0;
    if (i < batch) {
      if (gl / kChunks == (hit ? way : 0)) {
        const int4 out = hit ? v : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(vals_out + int64_t(i) * kVW +
                                 (gl % kChunks) * 4) = out;
      }
      if (gl == 0) {
        hit_out[i] = hit;
        way_out[i] = hit ? way : 0;
      }
    }
  } else {
    const unsigned i = t >> 5;
    int way = -1;
    int32_t s = -1;
    if (i < batch) {
      s = __ldg(cset + i);
      const int32_t* q = keys + int64_t(i) * key_words;
      if (s >= 0 && s < sets) {
        for (int w = lane; w < ways; w += 32) {
          const int64_t slot = int64_t(s) * ways + w;
          const int32_t* k = cache_keys + slot * key_words;
          bool eq = __ldg(cache_meta + slot) > 0;
          for (int j = 0; j < key_words; ++j)
            eq = eq & (__ldg(k + j) == __ldg(q + j));
          if (eq) way = w;  // w rises: the last match is the max
        }
      }
    }
    way = group_max(way, 16);
    const bool hit = way >= 0;
    if (i < batch) {
      if (lane == 0) {
        hit_out[i] = hit;
        way_out[i] = hit ? way : 0;
      }
      const int32_t* line =
          cache_vals + (int64_t(s) * ways + (hit ? way : 0)) * val_words;
      for (int j = lane; j < val_words; j += 32)
        vals_out[int64_t(i) * val_words + j] = hit ? __ldg(line + j) : 0;
    }
  }
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

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  if (batch > kMaxLookups || ways <= 0 || key_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int half_shift = 0;  // L = 1 << half_shift lanes a bucket
  while ((1 << half_shift) < ways && half_shift < 4) ++half_shift;
  const long long lanes = batch << (half_shift + 1);
  const unsigned blocks =
      unsigned((lanes + kLookupThreads - 1) / kLookupThreads);
  const bool serve = ways == 8 && key_words == 2 &&
                     aligned(bucket_keys, 8) && aligned(keys, 8);
  auto kernel = serve ? probe_kernel<8, 2> : probe_kernel<0, 0>;
  kernel<<<blocks, kLookupThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket_keys),
      static_cast<const int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(h1),
      static_cast<const int32_t*>(h2), static_cast<bool*>(found),
      static_cast<int32_t*>(ptr), unsigned(batch), rows, ways, key_words,
      half_shift);
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
  if (batch > kMaxLookups || ways <= 0 || key_words <= 0 || val_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool serve = ways == 4 && key_words == 2 && val_words == 16 &&
                     aligned(cache_keys, 8) && aligned(keys, 8) &&
                     aligned(cache_vals, 16) && aligned(vals, 16);
  const long long lanes = batch << (serve ? 4 : 5);
  const unsigned blocks =
      unsigned((lanes + kLookupThreads - 1) / kLookupThreads);
  auto kernel = serve ? cache_probe_kernel<4, 2, 16>
                      : cache_probe_kernel<0, 0, 0>;
  kernel<<<blocks, kLookupThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cache_keys),
      static_cast<const int32_t*>(cache_vals),
      static_cast<const int32_t*>(cache_meta),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(cset),
      static_cast<bool*>(hit), static_cast<int32_t*>(way),
      static_cast<int32_t*>(vals), unsigned(batch), sets, ways, key_words,
      val_words);
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
