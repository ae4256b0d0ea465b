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
// the scatter reads 8W bytes per entry and writes the owned rows.  The
// gather: one thread per (entry, word), neighbouring threads on
// neighbouring words of a row, each width compiled as a constant.  The
// scatter: one thread per 16-byte piece (ulonglong2, the load width
// Hopper serves fastest) at W = 2 and 8, per word at W = 1 (or where a
// pointer is not 16-byte aligned), each (piece type, pieces per row)
// compiled as a constant, so a piece's entry is a shift.  Any other
// width is refused with cudaErrorInvalidValue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

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

// PER_ROW pieces of type V make one row of the table; PER_ROW is a
// power of two, so a piece's entry is a shift of the thread's index.
template <typename V, int PER_ROW>
__global__ void shard_scatter(V* __restrict__ table, int64_t local_rows, int64_t row0,
                              const int64_t* __restrict__ slots, int64_t k,
                              const V* __restrict__ rows) {
  constexpr int SHIFT = log2_of(PER_ROW);
  static_assert((1 << SHIFT) == PER_ROW, "PER_ROW must be a power of two");
  const uint64_t total = (uint64_t)k << SHIFT;
  for (uint64_t e = (uint64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (uint64_t)gridDim.x * THREADS) {
    const int64_t rel = slots[e >> SHIFT] - row0;
    if ((uint64_t)rel < (uint64_t)local_rows) {  // owned: 0 <= rel < local_rows
      table[((uint64_t)rel << SHIFT) | (e & (PER_ROW - 1))] = rows[e];
    }
  }
}

template <int W>
void launch_gather(const void* table, int64_t local_rows, int64_t row0, const void* slots,
                   int64_t k, void* out, cudaStream_t s) {
  shard_gather<W><<<grid_for(k * W), THREADS, 0, s>>>(
      static_cast<const uint64_t*>(table), local_rows, row0, static_cast<const int64_t*>(slots),
      k, static_cast<uint64_t*>(out));
}

template <typename V, int PER_ROW>
void launch_scatter(void* table, int64_t local_rows, int64_t row0, const void* slots, int64_t k,
                    const void* rows, cudaStream_t s) {
  shard_scatter<V, PER_ROW><<<grid_for(k * PER_ROW), THREADS, 0, s>>>(
      static_cast<V*>(table), local_rows, row0, static_cast<const int64_t*>(slots), k,
      static_cast<const V*>(rows));
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
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
    // 16-byte pieces (ulonglong2) where the row holds them and both
    // pointers are aligned to them; 8-byte words otherwise.
    const bool wide = aligned16(table, rows);
    if (w == 1) {
      launch_scatter<unsigned long long, 1>(table, local_rows, row0, slots, k, rows, s);
    } else if (w == 2) {
      if (wide) launch_scatter<ulonglong2, 1>(table, local_rows, row0, slots, k, rows, s);
      else launch_scatter<unsigned long long, 2>(table, local_rows, row0, slots, k, rows, s);
    } else {
      if (wide) launch_scatter<ulonglong2, 4>(table, local_rows, row0, slots, k, rows, s);
      else launch_scatter<unsigned long long, 8>(table, local_rows, row0, slots, k, rows, s);
    }
  }
  return (int)cudaGetLastError();
}
