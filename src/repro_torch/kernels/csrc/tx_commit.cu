// ORCA-TX commit kernels for Hopper (sm_90a): the fused write-ahead log
// append + store scatter of a planned transaction batch, on one replica
// (commit) or on every replica of a local chain in one launch
// (commit_chain).
//
// Replaces repro/kernels/tx_commit.py::commit and ::commit_chain. What
// they compute: for each replica r and transaction i, log row slot[r, i]
// <- batch[i] (TW words); for each op j of transaction i, store row
// rows[r, i*M + j] <- values[i, j] (VW words). A target outside [0, LC]
// or [0, NK] is skipped. A target equal to the sentinel row (slot == LC,
// row == NK) contributes no payload: the sentinel row ends all-zero if at
// least one target of that replica aims at it and is left as it was
// otherwise — what the Pallas kernels do, which zero the payload of every
// sentinel target and then write it. Every other row, and every row of a
// dead replica but its sentinel, is untouched.
//
// Layout: every array is int32 and row-major, in the sentinel-resident
// ReplicaState layout of repro_torch.core.transaction — log (R, LC+1, TW)
// and store (R, NK+1, VW), the last row of each replica the pad row.
//
// Why a parallel scatter is right: the TPU grid runs in order, the CTAs
// here in none. Every live target is unique: log slots per replica by the
// plan's survives mask (only the last LC ranks of a lapping batch keep a
// slot), store rows per replica by first-claimant concurrency control
// plus the intra-transaction dedupe. Live targets never name a sentinel,
// and only one CTA writes the sentinel rows, so no two stores race on a
// value.
//
// What bounds it on an H100. A launch moves little: at the engine's batch
// (256 transactions of 8 ops of 16 words, TW = 137) the payload is 0.27
// MB and the live rows of a chain of three about 0.14 MB, a tenth of a
// microsecond at 3.35 TB/s. The time is the launch, one memory round trip
// for the payload and the targets, and the stores. What the first port
// spent on top of that, and what this design does instead:
//
// - Traffic to the sentinel rows. Every dead target (a deferred or masked
//   transaction, an op past n_ops, a shadowed duplicate, every target of
//   a dead replica) stored its zeros word by word: at the engine's batch
//   about 168,000 stores on 459 words. Accesses to a few lines from every
//   SM queue in the L2 slices that hold them, so it is the bytes that
//   cost: zeroing the rows once per CTA, 52 CTAs, still took most of a
//   microsecond, and so did reading them once per CTA. Here a sentinel
//   target stores nothing, and one more CTA beside the scattering ones
//   owns the sentinel rows: it reads every target of the launch (a warp
//   a slice of a target vector, 16 loads in flight a lane, a vote and a
//   shared-memory bit a replica) and makes each aimed-at row zero once.
//   Where it has a thread for every sentinel word (R <= 32) it zeroes
//   them as it starts, keeping the old words, and puts back the words of
//   a row that no target aims at, so the zeros travel while it reads.
// - Index arithmetic: two 64-bit divisions per 4-byte word. Here a warp
//   task is a log row (a lane every 32nd word) or 8 whole store rows (a
//   lane a 16-byte chunk); a lane's row and chunk come from a multiply by
//   a reciprocal computed once per launch, the zeroing CTA divides once
//   per warp job, and 64-bit arithmetic is left to the final address
//   (R (NK+1) VW is 805 M words at 2^24 keys).
// - Redundant loads and narrow stores. A row's target is loaded once by
//   one lane and taken by the row's lanes with __shfl_sync; a lane loads
//   its payload once and writes it to every replica's target in a loop
//   over R. Store rows whose width and bases allow it (VW a multiple of 4,
//   16-byte aligned pointers: the engine's 64-byte rows) move as 16-byte
//   vectors; log rows (548 bytes, 4-byte aligned) as coalesced 4-byte
//   stores across a warp.
//
// A scattering CTA takes T consecutive transactions, T the largest number
// whose tasks fit in 4 warps, one warp a task; every CTA has the warps
// the zeroing CTA needs (up to 16). At the engine's shape T = 2: 128
// scattering CTAs and the zeroing CTA, of 15 warps; a replayed record
// (B = 1) is one scattering CTA and the zeroing CTA, of 5 warps.
//
// Not used, and why: TMA and wgmma have no work here. This is a scatter
// of rows to data-dependent addresses, a fraction of a megabyte, with no
// tile to stage and no product to compute.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), allocates nothing, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (cudaErrorInvalidValue for sizes past its 32-bit index
// range).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;    // scattering warps a CTA (T = 2 at the engine)
constexpr int kScanWarps = 16;  // warps a CTA at most (the zeroing CTA's)
constexpr int kHold = 8;        // chunks a lane holds: 256-chunk rows a pass
constexpr int kScan = 16;       // target loads in flight a lane, zeroing CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxIndex = 1LL << 30;  // 32-bit index arithmetic

// n / d for the small n of a lane index (n < 4096, d <= 1024): one
// multiply by magic = ceil(2^32 / d), computed once per launch (2^32 for
// d = 1, so 64 bits).
__device__ __forceinline__ int div_small(int n, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(n) * magic) >> 32);
}

// One of the two scatters: the log (a row is a transaction, its target a
// slot) or the store (a row is an op, its target a store row). A row is
// `chunks` chunks of V words, V = 1 (int) or 4 (int4).
struct Part {
  int32_t* dst;              // replica 0's log or store
  const int32_t* src;        // payload: batch (B, TW) or values (B*M, VW)
  const int32_t* tgt;        // slot (R, B); rows (B*M,) or (R, B*M)
  long long replica_words;   // words between two replicas' dst: (limit+1) W
  int tgt_stride;            // between two replicas' targets: B; 0 or B*M
  int limit;                 // the sentinel row: LC or NK
  int rows;                  // payload rows in all: B or B*M
  int cta_rows;              // payload rows a CTA takes: T or T*M
  int words;                 // W, a row's width in words: TW or VW
  int chunks;                // W / V
  int task_rows;             // rows a warp task covers: 32 / chunks, or 1
  int tasks;                 // warp tasks a CTA runs
  int rpl;                   // replicas whose targets one warp load holds
  unsigned long long chunks_magic;     // div_small by chunks
  unsigned long long task_rows_magic;  // div_small by task_rows
};

// One warp task of part p: task_rows whole rows (a lane a chunk) when a
// row is at most 32 chunks, else one row (a lane every 32nd chunk, kHold
// of them held at a time). The lane loads its payload chunks once; then
// for every replica it takes the row's target from the lane that loaded
// it and stores the chunks if the target is a live row. A sentinel
// target stores nothing here.
template <typename V>
__device__ __forceinline__ void scatter(const Part p, int task,
                                        int replicas) {
  const int lane = threadIdx.x & (kWarp - 1);
  const bool wide = p.chunks > kWarp;
  const int row = wide ? 0 : div_small(lane, p.chunks_magic);
  const int chunk0 = lane - row * (wide ? 0 : p.chunks);
  const int row0 = task * p.task_rows;       // the task's first row
  const int base = blockIdx.x * p.cta_rows;  // the CTA's first payload row
  const bool in_task = row < p.task_rows && row0 + row < p.cta_rows &&
                       base + row0 + row < p.rows;
  const V* src =
      reinterpret_cast<const V*>(p.src + (base + row0 + row) * p.words);
  // lane k loads the target of replica r0 + k / task_rows for row
  // row0 + k % task_rows; replica r's target of this lane's row is then
  // in lane (r - r0) task_rows + row
  const int t_rep = div_small(lane, p.task_rows_magic);
  const int t_row = row0 + lane - t_rep * p.task_rows;
  const bool t_valid =
      t_rep < p.rpl && t_row < p.cta_rows && base + t_row < p.rows;
#pragma unroll 1
  for (int c00 = 0; c00 < p.chunks; c00 += kHold * kWarp) {  // warp-uniform
    const int c0 = c00 + chunk0;
    V v[kHold];
#pragma unroll
    for (int h = 0; h < kHold; ++h) {
      const int c = c0 + h * kWarp;
      v[h] = in_task && c < p.chunks ? __ldg(src + c) : V{};
    }
#pragma unroll 1
    for (int r0 = 0; r0 < replicas; r0 += p.rpl) {
      int t = -1;
      if (t_valid && r0 + t_rep < replicas)
        t = __ldg(p.tgt + (r0 + t_rep) * p.tgt_stride + base + t_row);
      const int r_end = min(replicas, r0 + p.rpl);
#pragma unroll 1
      for (int r = r0; r < r_end; ++r) {
        const int target =
            __shfl_sync(kFull, t, (r - r0) * p.task_rows + row);
        if (!in_task || target < 0 || target >= p.limit) continue;
        V* dst = reinterpret_cast<V*>(p.dst + r * p.replica_words +
                                      (long long)target * p.words);
#pragma unroll
        for (int h = 0; h < kHold; ++h)
          if (c0 + h * kWarp < p.chunks) dst[c0 + h * kWarp] = v[h];
      }
    }
  }
}

// Warp jobs of the zeroing CTA's read of part p's targets: one slice of
// kScan * 32 targets of one target vector (a replica's, or the one every
// replica shares) a job.
__device__ __forceinline__ int scan_slices(const Part p) {
  return (p.rows + kScan * kWarp - 1) / (kScan * kWarp);
}

__device__ __forceinline__ int scan_vectors(const Part p, int r0, int r_end) {
  return p.tgt_stride ? r_end - r0 : 1;
}

// Job j of part p: set bit r - r0 of *aimed where a target of replica r
// in the job's slice aims at the sentinel row.
__device__ __forceinline__ void scan_job(const Part p, int j, int r0,
                                         int r_end, unsigned* aimed) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int slices = scan_slices(p);
  const int q = j / slices;
  const int lo = (j - q * slices) * kScan * kWarp;
  const int32_t* t = p.tgt + (r0 + q) * p.tgt_stride;
  int x[kScan];
#pragma unroll
  for (int u = 0; u < kScan; ++u) {
    const int k = lo + u * kWarp + lane;
    x[u] = k < p.rows ? __ldg(t + k) : -1;
  }
  bool any = false;
#pragma unroll
  for (int u = 0; u < kScan; ++u) any |= x[u] == p.limit;
  const unsigned all = r_end - r0 == kWarp ? ~0u : (1u << (r_end - r0)) - 1;
  if (__any_sync(kFull, any) && lane == 0)
    atomicOr(aimed, p.tgt_stride ? 1u << q : all);
}

__device__ __forceinline__ void zero_rows(const Part p, int r0, int r_end,
                                          unsigned hit) {
#pragma unroll 1
  for (int r = r0; r < r_end; ++r) {
    if (!(hit >> (r - r0) & 1u)) continue;
    int32_t* row = p.dst + r * p.replica_words + (long long)p.limit * p.words;
#pragma unroll 1
    for (int c = threadIdx.x; c < p.words; c += blockDim.x) row[c] = 0;
  }
}

// The zeroing CTA: which replicas' sentinel rows any target of the launch
// aims at (both parts' targets read in one pass, a warp a job), and each
// of those rows made all-zero once; replicas in groups of 32, one bit
// each. With `speculate` (R <= 32 and a thread for every sentinel word)
// thread k first saves word k of the sentinel rows (the log rows of
// replicas 0 .. R-1, then their store rows) and zeroes it, so the zeros
// are on their way while the targets are read; a word of a row that no
// target aims at is then put back. Otherwise the aimed-at rows are zeroed
// after the read, by 4-byte stores across the CTA.
__device__ __forceinline__ void zero_sentinels(const Part log,
                                               const Part store,
                                               int replicas, int speculate) {
  __shared__ unsigned aimed[2];
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  int32_t* word = nullptr;  // this thread's sentinel word, when speculating
  int old = 0, part = 0, rep = 0;
  const int log_words = replicas * log.words;
  if (speculate && threadIdx.x < log_words + replicas * store.words) {
    part = threadIdx.x >= log_words;
    const int words = part ? store.words : log.words;
    const int k = threadIdx.x - (part ? log_words : 0);
    rep = k / words;
    word = (part ? store.dst + store.limit * (long long)store.words
                 : log.dst + log.limit * (long long)log.words) +
           rep * (part ? store.replica_words : log.replica_words) +
           (k - rep * words);
    old = *word;
    *word = 0;
  }
#pragma unroll 1
  for (int r0 = 0; r0 < replicas; r0 += kWarp) {
    const int r_end = min(replicas, r0 + kWarp);
    if (threadIdx.x < 2) aimed[threadIdx.x] = 0;
    __syncthreads();
    const int log_jobs = scan_vectors(log, r0, r_end) * scan_slices(log);
    const int jobs =
        log_jobs + scan_vectors(store, r0, r_end) * scan_slices(store);
#pragma unroll 1
    for (int j = warp; j < jobs; j += warps) {
      if (j < log_jobs)
        scan_job(log, j, r0, r_end, &aimed[0]);
      else
        scan_job(store, j - log_jobs, r0, r_end, &aimed[1]);
    }
    __syncthreads();
    if (speculate) {
      if (word && !(aimed[part] >> rep & 1u)) *word = old;
      return;  // one group: replicas <= 32
    }
    zero_rows(log, r0, r_end, aimed[0]);
    zero_rows(store, r0, r_end, aimed[1]);
    __syncthreads();  // before the next group resets the words
  }
}

// CTAs 0 .. gridDim.x - 2 scatter T transactions each, warp w running
// task w of the log's tasks followed by the store's (warps past them
// leave); the last CTA only makes the aimed-at sentinel rows zero,
// beside them.
template <typename VL, typename VS>
__global__ void __launch_bounds__(kScanWarps * kWarp)
    commit_kernel(const Part log, const Part store, int replicas,
                  int speculate) {
  if (blockIdx.x == gridDim.x - 1) {
    zero_sentinels(log, store, replicas, speculate);
    return;
  }
  const int warps = blockDim.x / kWarp;
#pragma unroll 1
  for (int task = threadIdx.x / kWarp; task < log.tasks + store.tasks;
       task += warps) {
    if (task < log.tasks)
      scatter<VL>(log, task, replicas);
    else
      scatter<VS>(store, task - log.tasks, replicas);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned long long magic(int d) { return ((1ULL << 32) + d - 1) / d; }

// A part's geometry for rows of `words` words, `cta_rows` of them a CTA.
// vec: 4 if the rows move as int4, else 1. Empty parts run no task.
Part make_part(int32_t* dst, const int32_t* src, const int32_t* tgt,
               long long limit, int words, int vec, int rows, int cta_rows,
               int tgt_stride) {
  Part p;
  p.dst = dst;
  p.src = src;
  p.tgt = tgt;
  p.replica_words = (limit + 1) * words;
  p.tgt_stride = tgt_stride;
  p.limit = static_cast<int>(limit);
  p.rows = rows;
  p.cta_rows = cta_rows;
  p.words = words;
  p.chunks = words > 0 ? words / vec : 1;
  p.task_rows = p.chunks <= kWarp ? kWarp / p.chunks : 1;
  p.tasks = rows > 0 && words > 0
                ? (cta_rows + p.task_rows - 1) / p.task_rows
                : 0;
  p.rpl = kWarp / p.task_rows;
  p.chunks_magic = magic(p.chunks);
  p.task_rows_magic = magic(p.task_rows);
  return p;
}

int part_tasks(int words, int vec, int cta_rows) {
  return make_part(nullptr, nullptr, nullptr, 0, words, vec, 1, cta_rows, 0)
      .tasks;
}

int launch(void* log, void* store, const void* batch, const void* values,
           const void* slot, const void* rows, long long replicas,
           long long txs, int ops, int tx_words, int val_words, long long lc,
           long long nk, long long rows_stride, void* stream) {
  if (replicas <= 0 || txs <= 0) return 0;
  const long long ops_all = txs * ops;
  if (ops < 0 || tx_words < 0 || val_words < 0 || lc < 0 || nk < 0 ||
      txs * tx_words >= kMaxIndex || ops_all * val_words >= kMaxIndex ||
      replicas * txs >= kMaxIndex || replicas * ops_all >= kMaxIndex ||
      lc >= INT_MAX || nk >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int b = static_cast<int>(txs);
  const int vl =
      tx_words % 4 == 0 && aligned16(log) && aligned16(batch) ? 4 : 1;
  const int vs =
      val_words % 4 == 0 && aligned16(store) && aligned16(values) ? 4 : 1;
  if (part_tasks(tx_words, vl, 1) + part_tasks(val_words, vs, ops) == 0)
    return 0;  // rows of no words: nothing to write
  // T: the most transactions whose tasks fit in kMaxWarps warps (at least 1)
  int t = 1;
  while (t < b && part_tasks(tx_words, vl, t + 1) +
                          part_tasks(val_words, vs, (t + 1) * ops) <=
                      kMaxWarps)
    ++t;
  const Part lp = make_part(static_cast<int32_t*>(log),
                            static_cast<const int32_t*>(batch),
                            static_cast<const int32_t*>(slot), lc, tx_words,
                            vl, b, t, b);
  const Part sp = make_part(static_cast<int32_t*>(store),
                            static_cast<const int32_t*>(values),
                            static_cast<const int32_t*>(rows), nk, val_words,
                            vs, b * ops, t * ops,
                            static_cast<int>(rows_stride));
  // a warp per task, or more where the zeroing CTA has targets to read
  // (a warp job per kScan * 32 targets of one vector)
  const auto jobs = [&](int n, long long vectors) {
    return vectors * ((n + kScan * kWarp - 1) / (kScan * kWarp));
  };
  const long long scan_jobs =
      jobs(b, replicas) + jobs(b * ops, rows_stride ? replicas : 1);
  long long warps = lp.tasks + sp.tasks;
  if (warps < scan_jobs) warps = scan_jobs;
  // and a thread for every sentinel word where that fits: the zeroing CTA
  // then zeroes them as it starts (see zero_sentinels)
  const long long sentinel_words = replicas * (tx_words + val_words);
  const long long word_warps = (sentinel_words + kWarp - 1) / kWarp;
  const int speculate = replicas <= kWarp && word_warps <= kScanWarps;
  if (speculate && warps < word_warps) warps = word_warps;
  if (warps > kScanWarps) warps = kScanWarps;
  // the scattering CTAs, and the zeroing CTA
  const unsigned blocks = static_cast<unsigned>((b + t - 1) / t + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(replicas);
  const int th = static_cast<int>(warps) * kWarp;
  if (vl == 4 && vs == 4)
    commit_kernel<int4, int4><<<blocks, th, 0, s>>>(lp, sp, r, speculate);
  else if (vl == 4)
    commit_kernel<int4, int><<<blocks, th, 0, s>>>(lp, sp, r, speculate);
  else if (vs == 4)
    commit_kernel<int, int4><<<blocks, th, 0, s>>>(lp, sp, r, speculate);
  else
    commit_kernel<int, int><<<blocks, th, 0, s>>>(lp, sp, r, speculate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// commit — one replica: log (LC+1, TW), store (NK+1, VW), slot (B,),
// rows (B*M,). The chain kernel at R = 1.
int orca_tx_commit(void* log, void* store, const void* batch,
                   const void* values, const void* slot, const void* rows,
                   long long txs, int ops, int tx_words, int val_words,
                   long long lc, long long nk, void* stream) {
  return launch(log, store, batch, values, slot, rows, 1, txs, ops, tx_words,
                val_words, lc, nk, 0, stream);
}

// commit_chain — R replicas: log (R, LC+1, TW), store (R, NK+1, VW),
// slot (R, B), rows (B*M,) shared (rows_stride 0) or (R, B*M) per replica
// (rows_stride B*M).
int orca_tx_commit_chain(void* log, void* store, const void* batch,
                         const void* values, const void* slot,
                         const void* rows, long long replicas, long long txs,
                         int ops, int tx_words, int val_words, long long lc,
                         long long nk, long long rows_stride, void* stream) {
  return launch(log, store, batch, values, slot, rows, replicas, txs, ops,
                tx_words, val_words, lc, nk, rows_stride, stream);
}

}  // extern "C"
