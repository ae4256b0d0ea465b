// K11: the table checksum, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:1036
// (_checksum, jitted as checksum :1193) and the device side of
// mirror.digest_columns (mirror.py:49-70) on the meta table
// (device_engine.py:1756-1776): for an (R, C) table of u64 words (the
// balances) or u32 words (the account meta, zero-extended), the 2C u64
// words
//   out[j]     = sum_r v[r, j]                          (mod 2^64)
//   out[C + j] = sum_r v[r, j] * ((row0 + r) * GOLDEN + 1)  (mod 2^64)
// The checkpoint tripwire and the engines' health digests compare these
// words with the host's digest of the mirror.  `row0` is the global
// index of the table's first row: a row-sharded table's shards each
// mix their rows under their global indices, so the shards' words add
// up (mod 2^64) to the words of the joined table; row0 = 0 is the
// whole table.
//
// What bounds it on the H100: bytes.  Every word is read once (64 MiB
// for a 2^20-row balance table, ~20 us at 3.35 TB/s); per word one
// multiply-add and two adds.  Design: one thread per word, grid-stride,
// with a stride that is a multiple of C, so a thread always sums the
// same column and neighbouring threads read neighbouring words.  A
// warp's lanes of one column combine by shuffles, the warps of a block
// through shared memory, and each block adds its 2C partial sums with
// one 64-bit atomic per word: wrapping sums are associative, so the
// result is bit-exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 32;
constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;

template <typename T>
__global__ void checksum_kernel(const T* __restrict__ table, int64_t R, int64_t row0,
                                int C, int log2c,
                                unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_col[WARPS][MAX_C];
  __shared__ unsigned long long s_mix[WARPS][MAX_C];
  const int64_t total = R * C;
  unsigned long long col = 0, mix = 0;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const unsigned long long v = (unsigned long long)table[e];
    const unsigned long long row = (unsigned long long)(row0 + (e >> log2c));
    col += v;
    mix += v * (row * GOLDEN + 1ull);
  }
  // Lanes l and l ^ o hold the same column when o >= C (C | 32 | 256).
  for (int o = 16; o >= C; o >>= 1) {
    col += __shfl_xor_sync(0xFFFFFFFFu, col, o);
    mix += __shfl_xor_sync(0xFFFFFFFFu, mix, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < C) {
    s_col[warp][lane] = col;
    s_mix[warp][lane] = mix;
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int j = threadIdx.x < C ? threadIdx.x : threadIdx.x - C;
    unsigned long long sum = 0;
    for (int w = 0; w < WARPS; ++w) {
      sum += threadIdx.x < C ? s_col[w][j] : s_mix[w][j];
    }
    atomicAdd(&out[threadIdx.x], sum);
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

// out: 2C u64 words, zeroed by the caller.  C a power of two <= 32;
// word_bytes 8 (u64) or 4 (u32, zero-extended); row0 the first row's
// global index.
extern "C" int tb_checksum(const void* table, int64_t R, int64_t row0, int C,
                           int word_bytes, void* out, void* stream) {
  int log2c = 0;
  while ((1 << log2c) < C) ++log2c;
  if (C < 1 || C > MAX_C || (1 << log2c) != C ||
      (word_bytes != 4 && word_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R > 0) {
    const int grid = grid_for(R * C);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* o = static_cast<unsigned long long*>(out);
    if (word_bytes == 8) {
      checksum_kernel<uint64_t><<<grid, THREADS, 0, s>>>(
          static_cast<const uint64_t*>(table), R, row0, C, log2c, o);
    } else {
      checksum_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
          static_cast<const uint32_t*>(table), R, row0, C, log2c, o);
    }
  }
  return (int)cudaGetLastError();
}
