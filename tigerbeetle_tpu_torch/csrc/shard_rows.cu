// K14: one shard's part of a cross-shard row gather, and the owned-row
// write-back, on the GPU.
//
// Replaces tigerbeetle_tpu/parallel/sharded.py:94 (own_rows) and :107
// (gather_rows): a shard owns the rows [row0, row0 + local_rows) of the
// (A, 8) u64 table.
//
// tb_shard_gather: out[k] = the owned row of global slot slots[k], or
//   zeros where another shard owns it.  Summing the parts of every
//   shard recombines the rows exactly, since each row has one owner.
// tb_shard_scatter: table[slots[k] - row0] = rows[k] where the shard
//   owns slots[k]; the other entries are dropped.  Slots are distinct.
//   It writes the rows a sharded wave step changed back onto their
//   owners (the reference's writes land on owned rows only, waves.py
//   _ShardTableOps).
//
// What bounds them on the H100: bytes.  Each entry costs its 8-byte
// slot; the gather reads an owned row and writes 64 bytes per entry,
// the scatter reads 64 bytes per entry and writes the owned rows.  One
// thread per (entry, word): neighbouring threads move neighbouring
// words of a row.

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

__global__ void shard_gather(const uint64_t* __restrict__ table, int64_t local_rows, int64_t row0,
                             const int64_t* __restrict__ slots, int64_t k,
                             uint64_t* __restrict__ out) {
  const int64_t total = k * 8;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t rel = slots[e >> 3] - row0;
    out[e] = (rel >= 0 && rel < local_rows) ? table[rel * 8 + (e & 7)] : 0ull;
  }
}

__global__ void shard_scatter(uint64_t* __restrict__ table, int64_t local_rows, int64_t row0,
                              const int64_t* __restrict__ slots, int64_t k,
                              const uint64_t* __restrict__ rows) {
  const int64_t total = k * 8;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t rel = slots[e >> 3] - row0;
    if (rel >= 0 && rel < local_rows) table[rel * 8 + (e & 7)] = rows[e];
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table: (local_rows, 8) u64; slots: (k,) i64 global rows; out: (k, 8).
extern "C" int tb_shard_gather(const void* table, int64_t local_rows, int64_t row0,
                               const void* slots, int64_t k, void* out, void* stream) {
  if (k > 0) {
    shard_gather<<<grid_for(k * 8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(table), local_rows, row0,
        static_cast<const int64_t*>(slots), k, static_cast<uint64_t*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" int tb_shard_scatter(void* table, int64_t local_rows, int64_t row0,
                                const void* slots, int64_t k, const void* rows, void* stream) {
  if (k > 0) {
    shard_scatter<<<grid_for(k * 8), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(table), local_rows, row0, static_cast<const int64_t*>(slots), k,
        static_cast<const uint64_t*>(rows));
  }
  return (int)cudaGetLastError();
}
