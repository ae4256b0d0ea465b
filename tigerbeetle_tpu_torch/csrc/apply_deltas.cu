// K4: the write-behind delta apply, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:1003
// (_apply_deltas) and its twin kernel_fast.py:48 (_flush_impl), which
// compute the same function: table[slot, 2col:2col+2] += delta mod
// 2^128 for unique (slot, col) entries; an entry whose slot (or col) is
// out of range is dropped, as the reference's padding is.
//
// What bounds it on the H100: latency, not bytes.  Each entry costs 32
// bytes of input and one 16-byte limb pair read and written, so a full
// flush chunk moves ~1.8 MB: ~0.6 us at 3.35 TB/s, too little to fill
// HBM.  The reference scatters the entries into two dense (A, 4) arrays
// and rewrites the whole table; the sum is the same bits (absent entries
// add zero), so this kernel touches only the listed cells, and what is
// left is one chain of dependent trips: the entry, then its cell, then
// the store.  So a thread reads its entry's four packed words
// (neighbouring threads on neighbouring entries, streaming: __ldcs, read
// once), then its cell, then adds and stores; a cell (slot * 64 + col *
// 16 bytes in) moves as one 16-byte load and one 16-byte store when the
// table is 16-byte aligned, as two 8-byte words when it is not.  Entries
// are unique (compact_deltas), so no two threads touch one cell and
// nothing needs an atomic or an order.  The grid is taken from the
// card's SM count (tb::spread_geometry): 256-thread blocks, halved while
// the grid would fill at most half the SMs (a small flush spread over
// more SMs), grid-stride past full residency.  Measured (PERF.md, the K4
// row): one entry a thread beats two or four in flight, and halving the
// blocks until every SM has one (SPREAD_FILL 1) does not pay at 32,768
// entries.

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"

namespace {

// packed: (4, stride) u64 rows [slot, col, delta_lo, delta_hi]; the
// first k entries of each row are live.  WIDE: the table is 16-byte
// aligned (cells move as ulonglong2).
template <bool WIDE>
__global__ void __launch_bounds__(tb::SPREAD_THREADS)
    apply_deltas(uint64_t* __restrict__ table, uint64_t A, const uint64_t* __restrict__ packed,
                 int64_t k, int64_t stride) {
  const int64_t span = (int64_t)gridDim.x * blockDim.x;
  const unsigned long long* pk = reinterpret_cast<const unsigned long long*>(packed);
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < k; j += span) {
    const uint64_t slot = __ldcs(pk + j);
    const uint64_t col = __ldcs(pk + stride + j);
    const uint64_t d_lo = __ldcs(pk + 2 * stride + j);
    const uint64_t d_hi = __ldcs(pk + 3 * stride + j);
    if (slot >= A || col >= 4) continue;
    uint64_t* cell = table + slot * 8 + col * 2;
    uint64_t old_lo, old_hi;
    if (WIDE) {
      const ulonglong2 c = *reinterpret_cast<const ulonglong2*>(cell);
      old_lo = c.x;
      old_hi = c.y;
    } else {
      old_lo = cell[0];
      old_hi = cell[1];
    }
    const uint64_t lo = old_lo + d_lo;
    const uint64_t hi = old_hi + d_hi + (lo < old_lo ? 1ull : 0ull);
    if (WIDE) {
      *reinterpret_cast<ulonglong2*>(cell) = make_ulonglong2(lo, hi);
    } else {
      cell[0] = lo;
      cell[1] = hi;
    }
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch K4 makes for k entries on the current card: blocks and
// threads a block, into geom[0..1]; a CUDA status.
extern "C" int tb_apply_deltas_geometry(int k, int* geom) {
  int sms = 0;
  const int err = tb::sm_count(sms);
  if (err) return err;
  tb::spread_geometry(k, sms, geom[0], geom[1]);
  return 0;
}

extern "C" int tb_apply_deltas(void* table, int64_t A, const void* packed, int64_t k,
                               int64_t stride, void* stream) {
  if (k <= 0) return 0;
  int sms = 0, G, T;
  const int err = tb::sm_count(sms);
  if (err) return err;
  tb::spread_geometry(k, sms, G, T);
  uint64_t* t = static_cast<uint64_t*>(table);
  const uint64_t* p = static_cast<const uint64_t*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0)
    apply_deltas<true><<<G, T, 0, st>>>(t, (uint64_t)A, p, k, stride);
  else
    apply_deltas<false><<<G, T, 0, st>>>(t, (uint64_t)A, p, k, stride);
  return (int)cudaGetLastError();
}
