// K12 and K13: the row-sharded apply step's kernels, on the GPU.
//
// Replace tigerbeetle_tpu/parallel/sharded.py:135 (_accumulate) and the
// local step of build_apply_step (:167-217).  A shard owns the rows
// [row0, row0 + local_rows) of the (A, 8) u64 balance table; an event
// slice names global rows by int32 slot.
//
// K12 tb_shard_accumulate: acc (local_rows, 4, 4) u64 = the 32-bit limb
//   sums of every unmasked event's (amount_lo, amount_hi) onto the
//   column (debits / credits, pending / posted) of its debit and credit
//   rows, where the shard owns them.  A limb sum stays below E * 2^32,
//   so 64-bit atomics keep it exact.  The reference's mask is all-ones
//   in the candidate call and the admitted mask in the apply call: a
//   null mask here is all-ones.
// K13 tb_shard_admit: per event, reject = for either slot owned here,
//   the row would overflow: some column's old value + its dp-combined
//   sum passes 2^128 (the carry of the u128 add, or the sum's own carry
//   past 2^128).  The reference computes row_over for every local row
//   and gathers it per event; each event thread here computes it for
//   its own two rows, the same bits from a read of only those rows.
// K13 tb_shard_apply: table[r] = old + admitted sums mod 2^128, every
//   local row, one thread per (row, column).
//
// What bounds them on the H100: bytes.  K12 writes the dense acc
// (128 bytes per local row) and reads 26 bytes per event; K13 admit
// reads two rows of table and acc per event; K13 apply reads and writes
// the whole local table and reads the whole acc (256 bytes per row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint64_t M32 = 0xFFFFFFFFull;

int grid_for(int64_t n) {
  int64_t g = (n + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // SMs x resident blocks; grid-stride past it
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

__global__ void shard_accumulate(unsigned long long* __restrict__ acc, int64_t local_rows,
                                 int64_t row0, const int32_t* __restrict__ dr,
                                 const int32_t* __restrict__ cr, const uint64_t* __restrict__ lo,
                                 const uint64_t* __restrict__ hi,
                                 const uint8_t* __restrict__ pending,
                                 const uint8_t* __restrict__ mask, int64_t E) {
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * THREADS) {
    if (mask != nullptr && mask[e] == 0) continue;
    const uint64_t a_lo = lo[e], a_hi = hi[e];
    const uint64_t limb[4] = {a_lo & M32, a_lo >> 32, a_hi & M32, a_hi >> 32};
    const bool pend = pending[e] != 0;
    for (int side = 0; side < 2; ++side) {
      const int64_t rel = (int64_t)(side ? cr[e] : dr[e]) - row0;
      if (rel < 0 || rel >= local_rows) continue;
      const int col = side ? (pend ? 2 : 3) : (pend ? 0 : 1);
      unsigned long long* cell = acc + (rel * 4 + col) * 4;
      for (int k = 0; k < 4; ++k) {
        if (limb[k] != 0) atomicAdd(cell + k, (unsigned long long)limb[k]);
      }
    }
  }
}

// ops/u128.from_limbs32 of one (row, column) limb-sum quadruple.
__device__ __forceinline__ void from_limbs(const uint64_t* a, uint64_t& d_lo, uint64_t& d_hi,
                                           uint64_t& d_carry) {
  const uint64_t c0 = a[0];
  const uint64_t c1 = a[1] + (c0 >> 32);
  const uint64_t c2 = a[2] + (c1 >> 32);
  const uint64_t c3 = a[3] + (c2 >> 32);
  d_lo = (c0 & M32) | ((c1 & M32) << 32);
  d_hi = (c2 & M32) | ((c3 & M32) << 32);
  d_carry = c3 >> 32;
}

__device__ bool row_over(const uint64_t* __restrict__ table, const uint64_t* __restrict__ acc,
                         int64_t rel) {
  bool over = false;
  for (int c = 0; c < 4; ++c) {
    uint64_t d_lo, d_hi, d_carry;
    from_limbs(acc + (rel * 4 + c) * 4, d_lo, d_hi, d_carry);
    const uint64_t o_lo = table[rel * 8 + 2 * c], o_hi = table[rel * 8 + 2 * c + 1];
    const uint64_t n_lo = o_lo + d_lo;
    const uint64_t hp = o_hi + d_hi;
    const uint64_t n_hi = hp + (n_lo < o_lo ? 1ull : 0ull);
    over |= (hp < o_hi) | (n_hi < hp) | (d_carry != 0);
  }
  return over;
}

__global__ void shard_admit(const uint64_t* __restrict__ table, const uint64_t* __restrict__ acc,
                            int64_t local_rows, int64_t row0, const int32_t* __restrict__ dr,
                            const int32_t* __restrict__ cr, int64_t E,
                            uint8_t* __restrict__ reject) {
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * THREADS) {
    bool r = false;
    for (int side = 0; side < 2; ++side) {
      const int64_t rel = (int64_t)(side ? cr[e] : dr[e]) - row0;
      if (rel >= 0 && rel < local_rows) r |= row_over(table, acc, rel);
    }
    reject[e] = r ? 1 : 0;
  }
}

__global__ void shard_apply(uint64_t* __restrict__ table, const uint64_t* __restrict__ acc,
                            int64_t local_rows) {
  const int64_t cells = local_rows * 4;
  for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < cells;
       j += (int64_t)gridDim.x * THREADS) {
    uint64_t d_lo, d_hi, d_carry;
    from_limbs(acc + j * 4, d_lo, d_hi, d_carry);
    uint64_t* cell = table + j * 2;  // row j / 4, column j % 4
    const uint64_t o_lo = cell[0];
    const uint64_t n_lo = o_lo + d_lo;
    cell[0] = n_lo;
    cell[1] = cell[1] + d_hi + (n_lo < o_lo ? 1ull : 0ull);
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// acc: (local_rows, 4, 4) u64, zeroed here; mask nullable (all-ones).
extern "C" int tb_shard_accumulate(void* acc, int64_t local_rows, int64_t row0, const void* dr,
                                   const void* cr, const void* lo, const void* hi,
                                   const void* pending, const void* mask, int64_t E,
                                   void* stream) {
  if (local_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(acc, 0, (size_t)local_rows * 16 * sizeof(uint64_t), s);
  if (rc != cudaSuccess) return (int)rc;
  if (E > 0) {
    shard_accumulate<<<grid_for(E), THREADS, 0, s>>>(
        static_cast<unsigned long long*>(acc), local_rows, row0,
        static_cast<const int32_t*>(dr), static_cast<const int32_t*>(cr),
        static_cast<const uint64_t*>(lo), static_cast<const uint64_t*>(hi),
        static_cast<const uint8_t*>(pending), static_cast<const uint8_t*>(mask), E);
  }
  return (int)cudaGetLastError();
}

// reject: (E,) u8, 1 where a slot this shard owns names an overflowing row.
extern "C" int tb_shard_admit(const void* table, const void* acc, int64_t local_rows,
                              int64_t row0, const void* dr, const void* cr, int64_t E,
                              void* reject, void* stream) {
  if (E > 0) {
    shard_admit<<<grid_for(E), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(table), static_cast<const uint64_t*>(acc), local_rows,
        row0, static_cast<const int32_t*>(dr), static_cast<const int32_t*>(cr), E,
        static_cast<uint8_t*>(reject));
  }
  return (int)cudaGetLastError();
}

extern "C" int tb_shard_apply(void* table, const void* acc, int64_t local_rows, void* stream) {
  if (local_rows > 0) {
    shard_apply<<<grid_for(local_rows * 4), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint64_t*>(table), static_cast<const uint64_t*>(acc), local_rows);
  }
  return (int)cudaGetLastError();
}
