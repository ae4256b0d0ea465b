// K10: the tiered admission's row scatter, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_engine.py:364
// (_tier_set_rows: table.at[idx].set(rows, mode="drop",
// unique_indices=True)) and the same scatter in the host engine's
// admission upload (kernel_fast.py:199-211): table[idx[j]] = src[j] for
// the admitted rows of a batch, an index outside [0, H) dropped.  The
// balance table is (H, 8) u64 (64-byte rows), the meta table (H, 2) u32
// (8-byte rows, moved as one u64).
//
// What bounds it on the H100: bytes.  Each entry costs its index and
// its row read once and the row written once (72 bytes for a balance
// row, 16 for a meta row); there is no arithmetic.  The reference pads
// to a power-of-two bucket of distinct out-of-range indices so one
// compiled shape serves many counts; here the wrapper launches with the
// live count.  The kernel is compiled for each row size: one thread per
// 16-byte piece of a balance row (ulonglong2, the load width Hopper
// serves fastest) and one per meta row (one u64), so the piece's row is
// a shift of the thread's index and each thread loads its row's index
// once (the row's four threads read one address: one transaction).
// Neighbouring threads move neighbouring pieces of a row, and the
// distinct indices (admitted hot slots are distinct) leave no two
// threads on one piece.  A table or source that is not aligned to the
// piece (a view at an odd offset) takes the same kernel with 8- or
// 4-byte pieces.

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"

namespace {

constexpr int THREADS = 256;

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// PER_ROW pieces of type V make one row; PER_ROW is a power of two.
template <typename V, int PER_ROW>
__global__ void set_rows(V* __restrict__ table, int64_t H, const int64_t* __restrict__ idx,
                         const V* __restrict__ src, int64_t k) {
  constexpr int SHIFT = log2_of(PER_ROW);
  static_assert((1 << SHIFT) == PER_ROW, "PER_ROW must be a power of two");
  const uint64_t total = (uint64_t)k << SHIFT;
  for (uint64_t e = (uint64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (uint64_t)gridDim.x * THREADS) {
    const int64_t row = idx[e >> SHIFT];
    if ((uint64_t)row >= (uint64_t)H) continue;  // padding, or < 0
    table[((uint64_t)row << SHIFT) | (e & (PER_ROW - 1))] = src[e];
  }
}

template <typename V, int PER_ROW>
int launch(void* table, int64_t H, const void* idx, const void* src, int64_t k,
           cudaStream_t s) {
  int grid;
  if (const int err = tb::grid_for(k * PER_ROW, THREADS, grid)) return err;
  set_rows<V, PER_ROW><<<grid, THREADS, 0, s>>>(
      static_cast<V*>(table), H, static_cast<const int64_t*>(idx), static_cast<const V*>(src),
      k);
  return 0;
}

bool aligned(const void* a, const void* b, uintptr_t to) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & (to - 1)) == 0;
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes: 64 (a balance row, 8 u64) or 8 (a meta row, 2 u32); any
// other row size is refused with cudaErrorInvalidValue.
extern "C" int tb_tier_set_rows(void* table, int64_t H, int row_bytes, const void* idx,
                                const void* src, int64_t k, void* stream) {
  if (row_bytes != 64 && row_bytes != 8) return (int)cudaErrorInvalidValue;
  if (k > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err;
    if (row_bytes == 64) {
      if (aligned(table, src, 16)) {
        err = launch<ulonglong2, 4>(table, H, idx, src, k, s);
      } else {
        err = launch<unsigned long long, 8>(table, H, idx, src, k, s);
      }
    } else if (aligned(table, src, 8)) {
      err = launch<unsigned long long, 1>(table, H, idx, src, k, s);
    } else {
      err = launch<unsigned int, 2>(table, H, idx, src, k, s);
    }
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
