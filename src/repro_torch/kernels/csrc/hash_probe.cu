// Hash-table kernels of ORCA-KV for Hopper (sm_90a): the GET walk
// (get_walk, one launch; and its two halves, probe and fetch), the hot-set
// cache probe, and the two scatter passes of a PUT commit (commit_buckets,
// write_rows).
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
// The PUT commits (commit_buckets, write_rows) move less still and wait on
// one round trip: the targets and payload load together, then the
// stores. What the first port spent on top of the launch was index
// arithmetic (a thread a 4-byte word, its entry and word found by a
// 64-bit division: a called subroutine each) and sentinel traffic: every
// dead entry stored zeros word by word onto the one pad row, and on the
// serve path about 244 of 256 entries are dead (app_step passes the whole
// batch with only its 5% of PUTs live), about 730 stores onto 12 bytes
// and 3,900 onto one 64-byte row a launch. Accesses to a few lines from
// many warps queue in the L2 slices that hold them (csrc/tx_commit.cu).
// So here a lane takes an entry or a 16-byte chunk of a row, its indices
// come from shifts, and a dead entry stores nothing: each warp zeroes the
// sentinel ways its dead entries aim at once (commit_buckets), each CTA
// row NP once (write_rows). Measured with scripts/hash_probe_ab.py on an
// H100 against two CTA-wide ways. One more CTA that reads every target
// and zeroes once (as the TX commit does) lost or tied everywhere: 0.4
// µs behind in commit_buckets at the engine's batch, 7-26 µs behind at
// 65,536, where one SM reads the whole batch's targets. A mask of
// aimed-at ways in shared memory, read after a barrier, cost
// commit_buckets 0.1-0.2 µs at B <= 256 against the warps zeroing their
// own ways (at most 8 warps storing 12 bytes each onto one sector); at
// 65,536 the two lay within the measurement's spread, and the mask won
// only on a batch of 65,536 dead entries, which no caller plans.
// write_rows' CTA vote is a barrier reduction (__syncthreads_or), within
// 0.1 µs of the launch floor at the engine's batch.
//
// CTA sizes, measured the same way against 32-256 threads: 64 for
// commit_buckets (4 CTAs at the engine's batch spread a batch of live
// entries' scattered stores over 4 SMs: 1.3 µs against 1.7 at 256
// threads; level elsewhere), 256 for write_rows (best at 65,536 rows,
// where 32 threads take 2.3x as long; level at the engine's batch).
// ORCA_COMMIT_THREADS builds both at another size. At 65,536 entries
// commit_buckets takes 2.3-2.7x its byte bound counted in 32-byte
// sectors: what is left is its two random partial-sector stores an
// entry, which the parent makes too (an all-dead batch of that size
// takes 2.2 µs).
//
// fetch is still the first simple kernel: one thread per word, coalesced
// where the layout allows. The GET walk no longer launches it: get_walk
// fetches the row in probe's launch, from the lanes that resolved it.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch
// (cudaErrorInvalidValue for a batch past the 32-bit lane index of the
// lookups and commits).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef ORCA_PROBE_THREADS
#define ORCA_PROBE_THREADS 256  // threads a CTA of a lookup launch
#endif

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLookupThreads = ORCA_PROBE_THREADS;
#ifdef ORCA_COMMIT_THREADS  // one CTA size for both commits (A/B builds)
constexpr int kBucketThreads = ORCA_COMMIT_THREADS;
constexpr int kRowThreads = ORCA_COMMIT_THREADS;
#else
constexpr int kBucketThreads = 64;  // threads a CTA of commit_buckets
constexpr int kRowThreads = 256;    // threads a CTA of write_rows
#endif
// at most 32 lanes a request or entry, so a launch's lanes fit in 32 bits
constexpr long long kMaxBatch = 1LL << 26;

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
// none) in all of its lanes, one more (xor L) the other bucket's, so every
// lane of the group resolves the request's pointer with a select (h1's
// max if it matched, else h2's); lane 0 of the group stores found and ptr.
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

// A lane's request, its lane in the request's group, and the request's
// resolved pointer (-1 for a miss), the same in every lane of the group.
struct Resolved {
  unsigned i;
  int gl;
  int r;
};

// The lookup of probe and get_walk, lane map above. Every lane of the
// warp calls it: the reduction shuffles over the whole warp.
template <int kWays, int kKW>
__device__ __forceinline__ Resolved probe_group(
    const int32_t* __restrict__ bucket_keys,
    const int32_t* __restrict__ bucket_ptr, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ h1, const int32_t* __restrict__ h2,
    unsigned batch, int64_t rows, int ways, int key_words, int half_shift) {
  static_assert(kWays == 0 || (kKW == 2 && kWays <= 16 &&
                               (kWays & (kWays - 1)) == 0),
                "the serve lane map: a lane a way, 8-byte key loads");
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
  const int p1 = gl < half ? best : other;  // h1's max in every lane
  const int p2 = gl < half ? other : best;  // h2's
  return {i, gl, p1 >= 0 ? p1 : p2};
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
  if constexpr (kWays > 0) half_shift = ilog2(kWays);
  const Resolved g = probe_group<kWays, kKW>(
      bucket_keys, bucket_ptr, keys, h1, h2, batch, rows, ways, key_words,
      half_shift);
  if (g.gl == 0 && g.i < batch) {
    found[g.i] = g.r >= 0;
    ptr[g.i] = g.r >= 0 ? g.r : 0;
  }
}

// ---------------------------------------------------------------------------
// get_walk — replaces repro/kernels/hash_probe.py::get: probe, then fetch
// at the pointers clamped to [0, NP], misses zeroed; one launch a GET walk.
// What held the walk back was not its bytes but its launches: probe wrote
// found and ptr, two glue ops clamped and masked them, fetch read ptr
// back and gathered, a last op zeroed the misses: five calls, seven device
// operations by the profiler, each at least a launch floor. Here the
// group that resolved a request's pointer fetches its row: after probe's
// lane map (probe_group) every lane of the group holds the pointer, so
// lane l copies words l, l + 2L, ... of pool row min(r, NP) on a hit (a
// found pointer past NP reads row NP, as the clamp does) and stores zeros
// on a miss, reading nothing; lane 0 stores found. One dependent round
// trip more than probe, on hits only, and no pointer through global
// memory.
//
// At the serve shape (W = 8, KW = 2, VW = 16, the kWays/kKW/kVW
// instance; keys and bucket_keys 8-byte aligned) lane l of the 16-lane
// group reads word l: a 64-byte row, coalesced, in one load a lane. Other
// shapes run the run-time instance, whose lanes loop over the row in
// strides of 2L.
// Bytes per request: probe's reads, found and VW * 4 written, VW * 4 read
// where found — 337 B at the serve widths on a hit, 273 on a miss.
// ---------------------------------------------------------------------------
template <int kWays, int kKW, int kVW>
__global__ void get_walk_kernel(const int32_t* __restrict__ bucket_keys,
                                const int32_t* __restrict__ bucket_ptr,
                                const int32_t* __restrict__ pool,
                                const int32_t* __restrict__ keys,
                                const int32_t* __restrict__ h1,
                                const int32_t* __restrict__ h2,
                                int32_t* __restrict__ vals,
                                bool* __restrict__ found, unsigned batch,
                                int64_t rows, int64_t np_row, int ways,
                                int key_words, int val_words,
                                int half_shift) {
  static_assert(kVW == 0 || kVW == 2 * kWays,
                "the serve lane map: a lane a value word");
  if constexpr (kWays > 0) half_shift = ilog2(kWays);
  if constexpr (kVW > 0) val_words = kVW;
  const Resolved g = probe_group<kWays, kKW>(
      bucket_keys, bucket_ptr, keys, h1, h2, batch, rows, ways, key_words,
      half_shift);
  if (g.i >= batch) return;
  if (g.gl == 0) found[g.i] = g.r >= 0;
  const int group = 2 << half_shift;
  int32_t* out = vals + int64_t(g.i) * val_words;
  if (g.r >= 0) {
    const int64_t at = g.r < np_row ? g.r : np_row;  // the clamp to NP
    const int32_t* row = pool + at * val_words;
    for (int j = g.gl; j < val_words; j += group) out[j] = __ldg(row + j);
  } else {
    for (int j = g.gl; j < val_words; j += group) out[j] = 0;
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
// The PUT commit, in place: commit_buckets (pass 1) and write_rows (pass
// 2). They replace repro/kernels/hash_probe.py::commit_buckets and
// ::write_rows together with the payload zeroing its insert does first.
// The TPU kernels rewrite whole rows in a grid that runs in order over
// target-sorted entries; CTAs here run in parallel and in no order, which
// is race-free because the plan makes live targets unique
// (kernels/ref.py::hash_put). No sort is needed.
//
// An entry is LIVE when it aims below the sentinel row (0 <= tb < NB with
// 0 <= tw < W; 0 <= wp < NP), DEAD when it aims at the sentinel row (tb ==
// NB with 0 <= tw < W; wp == NP), and skipped otherwise. A live entry
// stores its payload; a dead one stores nothing. The sentinel pass keeps
// the Pallas kernels' rule (a dead entry's payload is zero, and it is
// written): every sentinel word some entry aims at is made zero — way tw
// of row NB (its key words and pointer), all of pool row NP — and no other
// sentinel word changes, non-zero ones included.
// ---------------------------------------------------------------------------

// commit_buckets: one lane an entry. Round 1 loads tb, tw, bptr_val and
// (serve instance: W 8, KW 2, bucket_keys and keys 8-byte aligned) the
// key as one 8-byte load; a live entry then stores the key as one 8-byte
// store and the pointer as one 4-byte store. The run-time instance (every
// other shape) loads and stores the key words 4 bytes at a time after the
// targets. A dead entry stores nothing: each warp zeroes each way of row
// NB that its dead entries aim at once, by lane w after an OR-reduction
// of the warp's way bits (W <= 32), else by the first of the lanes that
// aim at w (a match over the warp). No barrier and no shared memory.
// Bytes an entry: tb, tw, bptr_val and KW key words read; (KW + 1) * 4
// written where live, in one 32-byte sector of each array.
template <int kWays>
__device__ __forceinline__ void zero_way(int32_t* bucket_keys,
                                         int32_t* bucket_ptr, int64_t slot,
                                         int key_words) {
  if constexpr (kWays > 0) {
    *reinterpret_cast<int2*>(bucket_keys + slot * 2) = make_int2(0, 0);
  } else {
    for (int j = 0; j < key_words; ++j) bucket_keys[slot * key_words + j] = 0;
  }
  bucket_ptr[slot] = 0;
}

template <int kWays>
__global__ void commit_buckets_kernel(int32_t* __restrict__ bucket_keys,
                                      int32_t* __restrict__ bucket_ptr,
                                      const int32_t* __restrict__ keys,
                                      const int32_t* __restrict__ tb,
                                      const int32_t* __restrict__ tw,
                                      const int32_t* __restrict__ bptr_val,
                                      unsigned batch, int nb, int ways,
                                      int key_words) {
  static_assert(kWays == 0 || kWays == 8, "the serve instance: W 8, KW 2");
  if constexpr (kWays > 0) ways = kWays;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  int b = -1, w = -1, p = 0;
  int2 k2 = make_int2(0, 0);
  if (i < batch) {
    b = __ldg(tb + i);
    w = __ldg(tw + i);
    p = __ldg(bptr_val + i);
    if constexpr (kWays > 0) k2 = ldg2(keys + int64_t(i) * 2);
  }
  const bool way_ok = unsigned(w) < unsigned(ways);
  if (way_ok && unsigned(b) < unsigned(nb)) {
    const int64_t slot = int64_t(b) * ways + w;
    if constexpr (kWays > 0) {
      *reinterpret_cast<int2*>(bucket_keys + slot * 2) = k2;
    } else {
      const int32_t* src = keys + int64_t(i) * key_words;
      int32_t* dst = bucket_keys + slot * key_words;
      for (int j = 0; j < key_words; ++j) dst[j] = __ldg(src + j);
    }
    bucket_ptr[slot] = p;
  }
  const bool dead = way_ok && b == nb;
  const int lane = int(threadIdx.x) & 31;
  const int64_t row = int64_t(nb) * ways;
  if (ways <= 32) {  // block-uniform
    const unsigned bits = __reduce_or_sync(kFullMask, dead ? 1u << w : 0u);
    if (bits >> lane & 1u)
      zero_way<kWays>(bucket_keys, bucket_ptr, row + lane, key_words);
  } else {
    const unsigned peers = __match_any_sync(kFullMask, dead ? w : -1);
    if (dead && __ffs(peers) - 1 == lane)
      zero_way<kWays>(bucket_keys, bucket_ptr, row + w, key_words);
  }
}

// write_rows: a row takes L = 2^shift lanes (its chunks rounded up to a
// power of two, at most 32), 32 / L rows a warp; a chunk is 16 bytes
// (V = int4: VW % 4 == 0 and pool and vals 16-byte aligned, the engine's
// 64-byte rows taking 4 lanes, 8 rows a warp) or 4 (V = int, the run-time
// instance). The row's first lane loads its wp while every lane loads its
// chunk of vals (one round), the others take wp by a shuffle, and a live
// row's lanes store their chunks; rows past 32 chunks loop. A dead row
// stores nothing: a CTA-wide vote (__syncthreads_or) decides whether the
// CTA zeroes row NP, once, in chunks across its threads.
// Bytes an entry: wp and VW * 4 of vals read, VW * 4 written where live.
template <typename V>
__global__ void write_rows_kernel(int32_t* __restrict__ pool,
                                  const int32_t* __restrict__ vals,
                                  const int32_t* __restrict__ wp,
                                  unsigned batch, int np_rows, int val_words,
                                  int shift) {
  constexpr int kVec = sizeof(V) / sizeof(int32_t);
  const int chunks = val_words / kVec;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = (1 << shift) - 1;
  const int lane = int(threadIdx.x) & 31;
  const int c0 = lane & group;
  const unsigned row = t >> shift;
  const bool in = row < batch;
  int target = -1;
  if (in && c0 == 0) target = __ldg(wp + row);
  const V* src = reinterpret_cast<const V*>(vals + int64_t(row) * val_words);
  const V v = in && c0 < chunks ? __ldg(src + c0) : V{};
  target = __shfl_sync(kFullMask, target, lane & ~group);
  if (unsigned(target) < unsigned(np_rows)) {  // live
    V* dst = reinterpret_cast<V*>(pool + int64_t(target) * val_words);
    if (c0 < chunks) dst[c0] = v;
    for (int c = c0 + 32; c < chunks; c += 32) dst[c] = __ldg(src + c);
  }
  if (__syncthreads_or(target == np_rows)) {
    V* sentinel = reinterpret_cast<V*>(pool + int64_t(np_rows) * val_words);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) sentinel[c] = V{};
  }
}

unsigned blocks_for(int64_t threads) {
  return unsigned((threads + kThreads - 1) / kThreads);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// log2 of L, the lanes a bucket of a probe or get_walk request
int lookup_half_shift(int ways) {
  int half_shift = 0;
  while ((1 << half_shift) < ways && half_shift < 4) ++half_shift;
  return half_shift;
}

unsigned lookup_blocks(long long lanes) {
  return unsigned((lanes + kLookupThreads - 1) / kLookupThreads);
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
  if (batch > kMaxBatch || ways <= 0 || key_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half_shift = lookup_half_shift(ways);
  const bool serve = ways == 8 && key_words == 2 &&
                     aligned(bucket_keys, 8) && aligned(keys, 8);
  auto kernel = serve ? probe_kernel<8, 2> : probe_kernel<0, 0>;
  kernel<<<lookup_blocks(batch << (half_shift + 1)), kLookupThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket_keys),
      static_cast<const int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(h1),
      static_cast<const int32_t*>(h2), static_cast<bool*>(found),
      static_cast<int32_t*>(ptr), unsigned(batch), rows, ways, key_words,
      half_shift);
  return static_cast<int>(cudaGetLastError());
}

int orca_get(const void* bucket_keys, const void* bucket_ptr,
             const void* pool, const void* keys, const void* h1,
             const void* h2, void* vals, void* found, long long batch,
             long long rows, long long pool_rows, int ways, int key_words,
             int val_words, void* stream) {
  if (batch <= 0) return 0;
  if (batch > kMaxBatch || pool_rows <= 0 || ways <= 0 || key_words <= 0 ||
      val_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half_shift = lookup_half_shift(ways);
  const bool serve = ways == 8 && key_words == 2 && val_words == 16 &&
                     aligned(bucket_keys, 8) && aligned(keys, 8);
  auto kernel = serve ? get_walk_kernel<8, 2, 16> : get_walk_kernel<0, 0, 0>;
  kernel<<<lookup_blocks(batch << (half_shift + 1)), kLookupThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket_keys),
      static_cast<const int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(pool), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(h1), static_cast<const int32_t*>(h2),
      static_cast<int32_t*>(vals), static_cast<bool*>(found),
      unsigned(batch), rows, pool_rows - 1, ways, key_words, val_words,
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
  if (batch > kMaxBatch || ways <= 0 || key_words <= 0 || val_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool serve = ways == 4 && key_words == 2 && val_words == 16 &&
                     aligned(cache_keys, 8) && aligned(keys, 8) &&
                     aligned(cache_vals, 16) && aligned(vals, 16);
  auto kernel = serve ? cache_probe_kernel<4, 2, 16>
                      : cache_probe_kernel<0, 0, 0>;
  kernel<<<lookup_blocks(batch << (serve ? 4 : 5)), kLookupThreads, 0,
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
  if (batch > kMaxBatch || nb < 0 || nb > INT_MAX || ways <= 0 ||
      key_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool serve = ways == 8 && key_words == 2 &&
                     aligned(bucket_keys, 8) && aligned(keys, 8);
  const unsigned blocks =
      unsigned((batch + kBucketThreads - 1) / kBucketThreads);
  auto kernel = serve ? commit_buckets_kernel<8> : commit_buckets_kernel<0>;
  kernel<<<blocks, kBucketThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(bucket_keys), static_cast<int32_t*>(bucket_ptr),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(tb),
      static_cast<const int32_t*>(tw), static_cast<const int32_t*>(bptr_val),
      unsigned(batch), int(nb), ways, key_words);
  return static_cast<int>(cudaGetLastError());
}

int orca_write_rows(void* pool, const void* vals, const void* wp,
                    long long batch, long long np_rows, int val_words,
                    void* stream) {
  if (batch <= 0) return 0;
  if (batch > kMaxBatch || np_rows < 0 || np_rows > INT_MAX ||
      val_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide =
      val_words % 4 == 0 && aligned(pool, 16) && aligned(vals, 16);
  const int chunks = wide ? val_words / 4 : val_words;
  int shift = 0;  // L = 1 << shift lanes a row
  while ((1 << shift) < chunks && shift < 5) ++shift;
  const long long lanes = batch << shift;
  const unsigned blocks = unsigned((lanes + kRowThreads - 1) / kRowThreads);
  auto kernel = wide ? write_rows_kernel<int4> : write_rows_kernel<int>;
  kernel<<<blocks, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(pool), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(wp), unsigned(batch), int(np_rows),
      val_words, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
