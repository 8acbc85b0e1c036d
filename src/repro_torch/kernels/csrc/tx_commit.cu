// ORCA-TX commit kernels for Hopper (sm_90a): the fused write-ahead log
// append + store scatter of a planned transaction batch, on one replica
// (commit) or on every replica of a local chain in one launch
// (commit_chain).
//
// Replaces repro/kernels/tx_commit.py::commit and ::commit_chain. What
// they compute: for each replica r and transaction i, log row slot[r, i]
// <- batch[i] (TW words); for each op j of transaction i, store row
// rows[r, i*M + j] <- values[i, j] (VW words). A target equal to the
// sentinel row (slot == LC, row == NK) receives zeros instead of the
// payload — the zeroing the JAX wrapper does in (R, B, TW) and
// (R, B, M, VW) temporaries before its scatter happens here, in the store.
//
// Layout: every array is int32 and row-major, in the sentinel-resident
// ReplicaState layout of repro_torch.core.transaction — log (R, LC+1, TW)
// and store (R, NK+1, VW), the last row of each replica an all-zero pad
// row. Offsets into the state are 64-bit: R * (NK+1) * VW is 805 M words
// at 2^24 keys of 16 words on a chain of three, and larger stores pass
// INT32_MAX.
//
// Why a plain parallel scatter is right: the TPU grid runs in order, the
// blocks here in none. Every live target is unique: log slots per replica
// by the plan's survives mask (only the last LC ranks of a lapping batch
// keep a slot), store rows per replica by first-claimant concurrency
// control plus the intra-transaction dedupe. Every write aimed at a
// sentinel row writes the same zeros. So no two threads race on a value.
//
// What bounds them on an H100 (3.35 TB/s): at the engine's batch of 256
// transactions of 8 ops of 16 words, a launch moves about 1 MB per
// replica — a third of a microsecond of bandwidth — so the launch latency
// bounds them. The design: one thread per output word, so consecutive
// threads write consecutive words of one row (a warp stores two 64-B
// store rows, or 128 contiguous bytes of a log record), and a row's
// target is read once per word from L1. One launch covers the log and
// the store of every replica.
//
// Each C entry point launches one kernel on the caller's stream (a
// cudaStream_t passed as void*), does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Threads [0, R*B*TW) write log words, the rest store words.
// rows_stride is 0 when every replica shares one (B*M,) rows vector, and
// B*M when rows is (R, B*M).
__global__ void commit_chain_kernel(int32_t* __restrict__ log,
                                    int32_t* __restrict__ store,
                                    const int32_t* __restrict__ batch,
                                    const int32_t* __restrict__ values,
                                    const int32_t* __restrict__ slot,
                                    const int32_t* __restrict__ rows,
                                    int64_t replicas, int64_t txs, int ops,
                                    int tx_words, int val_words, int64_t lc,
                                    int64_t nk, int64_t rows_stride) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t log_words = replicas * txs * tx_words;
  if (t < log_words) {
    const int64_t per_replica = txs * tx_words;
    const int64_t r = t / per_replica;
    const int64_t rem = t - r * per_replica;
    const int64_t i = rem / tx_words;
    const int64_t j = rem - i * tx_words;
    const int64_t s = slot[r * txs + i];
    if (s < 0 || s > lc) return;  // outside the log
    log[(r * (lc + 1) + s) * tx_words + j] =
        (s == lc) ? 0 : batch[i * tx_words + j];
    return;
  }
  const int64_t u = t - log_words;
  const int64_t per_replica = txs * ops * val_words;
  if (u >= replicas * per_replica) return;
  const int64_t r = u / per_replica;
  const int64_t rem = u - r * per_replica;
  const int64_t op = rem / val_words;  // i * M + j
  const int64_t w = rem - op * val_words;
  const int64_t row = rows[r * rows_stride + op];
  if (row < 0 || row > nk) return;  // outside the store
  store[(r * (nk + 1) + row) * val_words + w] =
      (row == nk) ? 0 : values[op * val_words + w];
}

int launch(void* log, void* store, const void* batch, const void* values,
           const void* slot, const void* rows, long long replicas,
           long long txs, int ops, int tx_words, int val_words, long long lc,
           long long nk, long long rows_stride, void* stream) {
  const int64_t threads =
      int64_t(replicas) * txs * (tx_words + int64_t(ops) * val_words);
  if (threads <= 0) return 0;
  const unsigned blocks = unsigned((threads + kThreads - 1) / kThreads);
  commit_chain_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(log), static_cast<int32_t*>(store),
      static_cast<const int32_t*>(batch), static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(rows),
      replicas, txs, ops, tx_words, val_words, lc, nk, rows_stride);
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
