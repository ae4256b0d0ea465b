// K14: one shard's part of a cross-shard row gather, and the owned-row
// write-back, on the GPU, for rows of W = 1, 2 or 8 u64 words.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:94 (own_rows) and :107
// (gather_rows): a shard owns the rows [row0, row0 + local_rows) of an
// (A, W) u64 table.  The engine's row layer moves three tables with it:
// the balances (W = 8), the account meta seen as one u64 per row
// (W = 1: two u32 words) and the per-row commitment hashes (W = 2).
//
// tb_shard_gather: out[k] = the owned row of global slot slots[k], or
//   zeros where another shard owns it.  Summing the parts of every
//   shard recombines the rows exactly, since each row has one owner.
// tb_shard_scatter: table[slots[k] - row0] = rows[k] where the shard
//   owns slots[k]; the other entries are dropped.  Slots are distinct.
//   It writes the rows a sharded step changed back onto their owners
//   (the reference's writes land on owned rows only, waves.py
//   _ShardTableOps).
//
// What bounds them on the H100: bytes.  Each entry costs its 8-byte
// slot; the gather reads an owned row and writes 8W bytes per entry,
// the scatter reads 8W bytes per entry and writes the owned rows.  One
// thread per (entry, word): neighbouring threads move neighbouring
// words of a row.  Each width is compiled as a constant (the word index
// is a shift); any other width is refused with cudaErrorInvalidValue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

int grid_for(int64_t n) {
  int64_t g = (n + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // SMs x resident blocks; grid-stride past it
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

template <int W>
__global__ void shard_gather(const uint64_t* __restrict__ table, int64_t local_rows, int64_t row0,
                             const int64_t* __restrict__ slots, int64_t k,
                             uint64_t* __restrict__ out) {
  const int64_t total = k * W;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t entry = e / W;
    const int64_t rel = slots[entry] - row0;
    out[e] = (rel >= 0 && rel < local_rows) ? table[rel * W + (e - entry * W)] : 0ull;
  }
}

template <int W>
__global__ void shard_scatter(uint64_t* __restrict__ table, int64_t local_rows, int64_t row0,
                              const int64_t* __restrict__ slots, int64_t k,
                              const uint64_t* __restrict__ rows) {
  const int64_t total = k * W;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t entry = e / W;
    const int64_t rel = slots[entry] - row0;
    if (rel >= 0 && rel < local_rows) table[rel * W + (e - entry * W)] = rows[e];
  }
}

template <int W>
void launch_gather(const void* table, int64_t local_rows, int64_t row0, const void* slots,
                   int64_t k, void* out, cudaStream_t s) {
  shard_gather<W><<<grid_for(k * W), THREADS, 0, s>>>(
      static_cast<const uint64_t*>(table), local_rows, row0, static_cast<const int64_t*>(slots),
      k, static_cast<uint64_t*>(out));
}

template <int W>
void launch_scatter(void* table, int64_t local_rows, int64_t row0, const void* slots, int64_t k,
                    const void* rows, cudaStream_t s) {
  shard_scatter<W><<<grid_for(k * W), THREADS, 0, s>>>(
      static_cast<uint64_t*>(table), local_rows, row0, static_cast<const int64_t*>(slots), k,
      static_cast<const uint64_t*>(rows));
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table: (local_rows, w) u64; slots: (k,) i64 global rows; out: (k, w).
extern "C" int tb_shard_gather(const void* table, int64_t local_rows, int64_t row0,
                               const void* slots, int64_t k, int64_t w, void* out,
                               void* stream) {
  if (w != 1 && w != 2 && w != 8) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (w) {
      case 1: launch_gather<1>(table, local_rows, row0, slots, k, out, s); break;
      case 2: launch_gather<2>(table, local_rows, row0, slots, k, out, s); break;
      default: launch_gather<8>(table, local_rows, row0, slots, k, out, s); break;
    }
  }
  return (int)cudaGetLastError();
}

// table: (local_rows, w) u64; slots: (k,) i64 distinct global rows;
// rows: (k, w).
extern "C" int tb_shard_scatter(void* table, int64_t local_rows, int64_t row0,
                                const void* slots, int64_t k, int64_t w, const void* rows,
                                void* stream) {
  if (w != 1 && w != 2 && w != 8) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (w) {
      case 1: launch_scatter<1>(table, local_rows, row0, slots, k, rows, s); break;
      case 2: launch_scatter<2>(table, local_rows, row0, slots, k, rows, s); break;
      default: launch_scatter<8>(table, local_rows, row0, slots, k, rows, s); break;
    }
  }
  return (int)cudaGetLastError();
}
