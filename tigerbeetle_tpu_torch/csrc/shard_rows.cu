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
// the scatter reads 8W bytes per entry and writes the owned rows.  Both
// move 16-byte pieces (ulonglong2, the width Hopper serves best) at
// W = 2 and 8, 8-byte words at W = 1 (or where a pointer is not 16-byte
// aligned), each (piece type, pieces per row) compiled as a constant, so
// a piece's entry is a shift of its index.  Any other width is refused
// with cudaErrorInvalidValue.
//
// The gather writes every entry's row, three quarters of them zeros at
// the engine's shapes (a window unit: 50.7 MB out of 70 MB moved), so a
// non-owned entry stores its zeros without touching the table.  Its
// grid is sized from the card's SMs (GATHER_BLOCKS_PER_SM resident
// blocks each), and where the pieces outnumber its threads each thread
// keeps GATHER_UNROLL pieces in flight (their slots, then their rows,
// then their stores), so a small call is one piece a thread and a large
// one overlaps its dependent slot-then-row loads.  Piece indices are 32
// bits where the pieces fit.  From STREAM_FROM_BYTES of output up, the
// stores are streaming (st.global.cs): evicting such an output first
// keeps the slots and rows in the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GATHER_BLOCKS_PER_SM = 4;
constexpr int GATHER_UNROLL = 4;
// Pieces a thread takes before the grid grows (up to the card's fill).
constexpr int GATHER_MIN_PIECES = 1;
// Streaming stores from a 24 MiB output up (about half of L2), measured
// faster there: a window unit's W = 8 output (50.7 MB) 27.2 -> 24.8 us;
// no faster at a W = 2 one (12.7 MB), slower at W = 1 (6.3 MB) and no
// different at a wave batch (tools/serial_probes.py --parts k14).
constexpr int64_t STREAM_FROM_BYTES = int64_t{24} << 20;

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

template <typename V, bool STREAM>
__device__ __forceinline__ void store(V* p, const V& v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

// PER_ROW pieces of type V make one row; I is the piece index type.
template <typename V, int PER_ROW, typename I, bool STREAM>
__global__ void __launch_bounds__(THREADS, GATHER_BLOCKS_PER_SM)
shard_gather(const V* __restrict__ table, int64_t local_rows, int64_t row0,
             const int64_t* __restrict__ slots, I total, V* __restrict__ out) {
  constexpr int SHIFT = log2_of(PER_ROW);
  static_assert((1 << SHIFT) == PER_ROW, "PER_ROW must be a power of two");
  const I stride = (I)gridDim.x * THREADS;
  for (I e0 = (I)blockIdx.x * THREADS + threadIdx.x; e0 < total; e0 += GATHER_UNROLL * stride) {
    int64_t rel[GATHER_UNROLL];
#pragma unroll
    for (int j = 0; j < GATHER_UNROLL; ++j) {
      const I e = e0 + j * stride;
      rel[j] = e < total ? slots[e >> SHIFT] - row0 : -1;
    }
    V v[GATHER_UNROLL];
#pragma unroll
    for (int j = 0; j < GATHER_UNROLL; ++j) {
      const I e = e0 + j * stride;
      v[j] = V{};
      if ((uint64_t)rel[j] < (uint64_t)local_rows)  // owned: 0 <= rel < local_rows
        v[j] = table[((uint64_t)rel[j] << SHIFT) | (uint64_t)(e & (PER_ROW - 1))];
    }
#pragma unroll
    for (int j = 0; j < GATHER_UNROLL; ++j) {
      const I e = e0 + j * stride;
      if (e < total) store<V, STREAM>(out + e, v[j]);
    }
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

template <typename V, int PER_ROW>
int launch_gather(const void* table, int64_t local_rows, int64_t row0, const void* slots,
                  int64_t k, void* out, cudaStream_t s) {
  int sms = 0;
  const int err = tb::sm_count(sms);
  if (err) return err;
  const int64_t total = k * PER_ROW;
  int64_t blocks = (total + THREADS * GATHER_MIN_PIECES - 1) / (THREADS * GATHER_MIN_PIECES);
  if (blocks > (int64_t)sms * GATHER_BLOCKS_PER_SM) blocks = (int64_t)sms * GATHER_BLOCKS_PER_SM;
  // 32-bit piece indices while the last one, one unrolled stride past
  // the end included, stays below 2^31.
  const bool narrow = total + (int64_t)GATHER_UNROLL * blocks * THREADS < ((int64_t)1 << 31);
  const bool stream = total * (int64_t)sizeof(V) >= STREAM_FROM_BYTES;
  const V* t = static_cast<const V*>(table);
  const int64_t* sl = static_cast<const int64_t*>(slots);
  V* o = static_cast<V*>(out);
  const int g = (int)blocks;
  if (narrow && stream)
    shard_gather<V, PER_ROW, uint32_t, true><<<g, THREADS, 0, s>>>(t, local_rows, row0, sl,
                                                                   (uint32_t)total, o);
  else if (narrow)
    shard_gather<V, PER_ROW, uint32_t, false><<<g, THREADS, 0, s>>>(t, local_rows, row0, sl,
                                                                    (uint32_t)total, o);
  else if (stream)
    shard_gather<V, PER_ROW, uint64_t, true><<<g, THREADS, 0, s>>>(t, local_rows, row0, sl,
                                                                   (uint64_t)total, o);
  else
    shard_gather<V, PER_ROW, uint64_t, false><<<g, THREADS, 0, s>>>(t, local_rows, row0, sl,
                                                                    (uint64_t)total, o);
  return 0;
}

template <typename V, int PER_ROW>
int launch_scatter(void* table, int64_t local_rows, int64_t row0, const void* slots, int64_t k,
                   const void* rows, cudaStream_t s) {
  int grid;
  if (const int err = tb::grid_for(k * PER_ROW, THREADS, grid)) return err;
  shard_scatter<V, PER_ROW><<<grid, THREADS, 0, s>>>(
      static_cast<V*>(table), local_rows, row0, static_cast<const int64_t*>(slots), k,
      static_cast<const V*>(rows));
  return 0;
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
  int err = 0;
  if (k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    using U = unsigned long long;
    // 16-byte pieces where the row holds them and both pointers are
    // aligned to them; 8-byte words otherwise.
    const bool wide = aligned16(table, out);
    if (w == 1) {
      err = launch_gather<U, 1>(table, local_rows, row0, slots, k, out, s);
    } else if (w == 2) {
      err = wide ? launch_gather<ulonglong2, 1>(table, local_rows, row0, slots, k, out, s)
                 : launch_gather<U, 2>(table, local_rows, row0, slots, k, out, s);
    } else {
      err = wide ? launch_gather<ulonglong2, 4>(table, local_rows, row0, slots, k, out, s)
                 : launch_gather<U, 8>(table, local_rows, row0, slots, k, out, s);
    }
  }
  return err ? err : (int)cudaGetLastError();
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
    int err;
    if (w == 1) {
      err = launch_scatter<unsigned long long, 1>(table, local_rows, row0, slots, k, rows, s);
    } else if (w == 2) {
      err = wide ? launch_scatter<ulonglong2, 1>(table, local_rows, row0, slots, k, rows, s)
                 : launch_scatter<unsigned long long, 2>(table, local_rows, row0, slots, k, rows,
                                                         s);
    } else {
      err = wide ? launch_scatter<ulonglong2, 4>(table, local_rows, row0, slots, k, rows, s)
                 : launch_scatter<unsigned long long, 8>(table, local_rows, row0, slots, k, rows,
                                                         s);
    }
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
