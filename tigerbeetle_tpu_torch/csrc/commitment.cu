// K2: the incremental state commitment, maintained on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/commitment.py:318 device_fns():
// _rebuild :335 and _probe :379 (tb_commit_hash_all: hash every row and
// fold) and _update :339 (tb_commit_update: re-hash the touched rows,
// move the digest by new - old, store the new row hashes), all through
// the row hash of rows_hash :94; and _admit :358 (tb_commit_admit: the
// tiered admission's hash swap at the admitted hot slots).
//
// Row hash: the row index and the 10 row columns (8 u64 balance limbs,
// 2 u32 meta columns) mixed lane-wise through a splitmix64 finalizer,
// xor-combined, finalized into two u64 lanes; an all-zero row hashes to
// (0, 0).  The fold is a per-lane sum mod 2^64 — associative, so each
// block sums its rows and adds the pair with one atomicAdd, and the
// result is bit-exact in any order.
//
// What bounds it on the H100: bytes.  A row costs 72 bytes of table and
// meta plus 8 of row binding read and 16 of hash written; the eleven
// 64-bit mixes per row (~150 integer operations) stay far below the
// card's integer rate.  The design reads each row once with
// neighbouring threads on neighbouring rows and keeps the fold in
// registers until one atomic per block.  Admit is bytes-bound too: per
// slot its index and new hash read, the old hash read and overwritten.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// PINNED hash-stream constants (commitment.py GAMMA .. C_HI): changing
// any of them is a state-root format change.
constexpr uint64_t GAMMA = 0x9E3779B97F4A7C15ull;
constexpr uint64_t K_COL = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t M1 = 0xFF51AFD7ED558CCDull;
constexpr uint64_t M2 = 0xC4CEB9FE1A85EC53ull;
constexpr uint64_t C_LO = 0x8BADF00D5CA1AB1Eull;
constexpr uint64_t C_HI = 0xFACEFEED0DDBA11Dull;

constexpr int THREADS = 256;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= M1;
  x ^= x >> 29;
  x *= M2;
  return x ^ (x >> 32);
}

__device__ __forceinline__ void hash_row(uint64_t r, const uint64_t* bal,
                                         const uint32_t* meta2,
                                         uint64_t& lo, uint64_t& hi) {
  const uint64_t rs = r * GAMMA;
  uint64_t acc = 0;
  bool nonzero = false;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const uint64_t v = j < 8 ? bal[j] : (uint64_t)meta2[j - 8];
    nonzero |= v != 0;
    acc ^= mix64(v ^ rs ^ ((uint64_t)(j + 1) * K_COL));
  }
  lo = nonzero ? mix64(acc ^ rs ^ C_LO) : 0ull;
  hi = nonzero ? mix64(acc ^ rs ^ C_HI) : 0ull;
}

// Sum (lo, hi) over the block and add it to out[0..1] with one atomic
// per lane.
__device__ __forceinline__ void block_fold(uint64_t lo, uint64_t hi,
                                           unsigned long long* out) {
  __shared__ unsigned long long s_lo[THREADS / 32], s_hi[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo += __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)lo, o);
    hi += __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)hi, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      a += s_lo[w];
      b += s_hi[w];
    }
    atomicAdd(&out[0], a);
    atomicAdd(&out[1], b);
  }
}

// Hash rows [0, A) under logical ids rows[i]; store the hashes when
// row_hash is non-null (rebuild), and fold them into fold_out.
__global__ void cm_hash_all(const uint64_t* bal, const uint32_t* meta,
                            const uint64_t* rows, int64_t A,
                            uint64_t* row_hash, unsigned long long* fold_out) {
  uint64_t sum_lo = 0, sum_hi = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < A;
       i += (int64_t)gridDim.x * THREADS) {
    uint64_t lo, hi;
    hash_row(rows[i], bal + i * 8, meta + i * 2, lo, hi);
    if (row_hash) {
      row_hash[i * 2] = lo;
      row_hash[i * 2 + 1] = hi;
    }
    sum_lo += lo;
    sum_hi += hi;
  }
  block_fold(sum_lo, sum_hi, fold_out);
}

// Deduplicated touched slots; -1 entries are padding and contribute
// nothing.  Each slot is owned by exactly one thread, so the gather of
// the old hash and the store of the new one cannot race.
__global__ void cm_update(const uint64_t* bal, const uint32_t* meta,
                          uint64_t* row_hash, unsigned long long* digest,
                          const int64_t* slots, const uint64_t* rows,
                          int64_t k) {
  uint64_t d_lo = 0, d_hi = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < k;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t s = slots[i];
    if (s < 0) continue;
    uint64_t lo, hi;
    hash_row(rows[i], bal + s * 8, meta + s * 2, lo, hi);
    d_lo += lo - row_hash[s * 2];
    d_hi += hi - row_hash[s * 2 + 1];
    row_hash[s * 2] = lo;
    row_hash[s * 2 + 1] = hi;
  }
  block_fold(d_lo, d_hi, digest);
}

// Tiered admission: at each hot slot (distinct; -1 or >= H is padding)
// the stored hash becomes (new_lo, new_hi), supplied by the host twin,
// and the digest moves by new - old.  A thread owns its slot, so the
// read of old and the store of new cannot race; the differences meet in
// the block fold (wrapping sums: any order gives the same digest).
__global__ void cm_admit(uint64_t* row_hash, int64_t H,
                         unsigned long long* digest, const int64_t* slots,
                         const uint64_t* new_lo, const uint64_t* new_hi,
                         int64_t k) {
  uint64_t d_lo = 0, d_hi = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < k;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t s = slots[i];
    if (s < 0 || s >= H) continue;
    d_lo += new_lo[i] - row_hash[s * 2];
    d_hi += new_hi[i] - row_hash[s * 2 + 1];
    row_hash[s * 2] = new_lo[i];
    row_hash[s * 2 + 1] = new_hi[i];
  }
  block_fold(d_lo, d_hi, digest);
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

extern "C" int tb_commit_hash_all(const void* balances, const void* meta,
                                  const void* rows, int64_t A,
                                  void* row_hash, void* fold_out,
                                  void* stream) {
  cm_hash_all<<<grid_for(A), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(balances),
      static_cast<const uint32_t*>(meta), static_cast<const uint64_t*>(rows),
      A, static_cast<uint64_t*>(row_hash),
      static_cast<unsigned long long*>(fold_out));
  return (int)cudaGetLastError();
}

extern "C" int tb_commit_update(const void* balances, const void* meta,
                                void* row_hash, void* digest,
                                const void* slots, const void* rows,
                                int64_t k, void* stream) {
  cm_update<<<grid_for(k), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(balances),
      static_cast<const uint32_t*>(meta), static_cast<uint64_t*>(row_hash),
      static_cast<unsigned long long*>(digest),
      static_cast<const int64_t*>(slots), static_cast<const uint64_t*>(rows),
      k);
  return (int)cudaGetLastError();
}

extern "C" int tb_commit_admit(void* row_hash, int64_t H, void* digest,
                               const void* slots, const void* new_lo,
                               const void* new_hi, int64_t k, void* stream) {
  cm_admit<<<grid_for(k), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(row_hash), H,
      static_cast<unsigned long long*>(digest),
      static_cast<const int64_t*>(slots), static_cast<const uint64_t*>(new_lo),
      static_cast<const uint64_t*>(new_hi), k);
  return (int)cudaGetLastError();
}
