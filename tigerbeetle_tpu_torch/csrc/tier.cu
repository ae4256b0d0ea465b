// K10: the tiered admission's row scatter, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_engine.py:364
// (_tier_set_rows: table.at[idx].set(rows, mode="drop",
// unique_indices=True)) and the same scatter in the host engine's
// admission upload (kernel_fast.py:199-211): table[idx[j]] = src[j] for
// the admitted rows of a batch, an index outside [0, H) dropped.  The
// balance table is (H, 8) u64, the meta table (H, 2) u32.
//
// What bounds it on the H100: bytes.  Each entry costs its index and
// its row read once and the row written once (72 bytes for a balance
// row, 16 for a meta row); there is no arithmetic.  The reference pads
// to a power-of-two bucket of distinct out-of-range indices so one
// compiled shape serves many counts; here the wrapper launches with the
// live count.  One thread per (entry, word): neighbouring threads write
// neighbouring words of a row, and the distinct indices (admitted hot
// slots are distinct) leave no two threads on one word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void set_rows(T* __restrict__ table, int64_t H, int width,
                         const int64_t* __restrict__ idx,
                         const T* __restrict__ src, int64_t k) {
  const int64_t total = k * width;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t j = e / width;
    const int w = (int)(e - j * width);
    const int64_t row = idx[j];
    if (row < 0 || row >= H) continue;
    table[row * width + w] = src[e];
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

// word_bytes: 8 (u64 balance words) or 4 (u32 meta words).
extern "C" int tb_tier_set_rows(void* table, int64_t H, int width,
                                int word_bytes, const void* idx,
                                const void* src, int64_t k, void* stream) {
  if (width < 1 || (word_bytes != 4 && word_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (k > 0) {
    const int grid = grid_for(k * width);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (word_bytes == 8) {
      set_rows<uint64_t><<<grid, THREADS, 0, s>>>(
          static_cast<uint64_t*>(table), H, width,
          static_cast<const int64_t*>(idx), static_cast<const uint64_t*>(src), k);
    } else {
      set_rows<uint32_t><<<grid, THREADS, 0, s>>>(
          static_cast<uint32_t*>(table), H, width,
          static_cast<const int64_t*>(idx), static_cast<const uint32_t*>(src), k);
    }
  }
  return (int)cudaGetLastError();
}
