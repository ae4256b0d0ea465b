// K4: the write-behind delta apply, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:1003
// (_apply_deltas) and its twin kernel_fast.py:48 (_flush_impl), which
// compute the same function: table[slot, 2col:2col+2] += delta mod
// 2^128 for unique (slot, col) entries; an entry whose slot (or col) is
// out of range is dropped, as the reference's padding is.
//
// What bounds it on the H100: bytes.  Each entry costs 32 bytes of
// input and one 16-byte limb pair read and written; the two adds are
// nothing.  The reference scatters the entries into two dense (A, 4)
// arrays and rewrites the whole table; the sum is the same bits (absent
// entries add zero), so this kernel touches only the listed limbs: one
// thread per entry, neighbouring threads on neighbouring entries, no
// atomics (entries are unique after compact_deltas).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// packed: (4, stride) u64 rows [slot, col, delta_lo, delta_hi]; the
// first k entries of each row are live.
__global__ void apply_deltas(uint64_t* __restrict__ table, uint64_t A,
                             const uint64_t* __restrict__ packed, int64_t k,
                             int64_t stride) {
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < k;
       j += (int64_t)gridDim.x * THREADS) {
    const uint64_t slot = packed[j];
    const uint64_t col = packed[stride + j];
    if (slot >= A || col >= 4) continue;
    const uint64_t d_lo = packed[2 * stride + j];
    const uint64_t d_hi = packed[3 * stride + j];
    uint64_t* cell = table + slot * 8 + col * 2;
    const uint64_t old_lo = cell[0];
    const uint64_t new_lo = old_lo + d_lo;
    cell[0] = new_lo;
    cell[1] = cell[1] + d_hi + (new_lo < old_lo ? 1ull : 0ull);
  }
}

int grid_for(int64_t n) {
  int64_t g = (n + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // SMs x resident blocks; grid-stride past it
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int tb_apply_deltas(void* table, int64_t A, const void* packed,
                               int64_t k, int64_t stride, void* stream) {
  if (k > 0) {
    apply_deltas<<<grid_for(k), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(table), (uint64_t)A,
        static_cast<const uint64_t*>(packed), k, stride);
  }
  return (int)cudaGetLastError();
}
