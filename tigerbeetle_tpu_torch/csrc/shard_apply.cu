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
//   and gathers it per event; here eight lanes take one event, one a
//   (side, column), and compute it for the event's own two rows only:
//   the same bits (row_over of a row is the OR of its columns'), from a
//   read of only those rows.
// K13 tb_shard_apply: table[r] = old + admitted sums mod 2^128, every
//   local row, one thread per (row, column).
//
// What bounds them on the H100: bytes for K12 and K13 apply — K12
// writes the dense acc (128 bytes per local row) and reads 26 bytes per
// event; K13 apply reads and writes the whole local table and reads the
// whole acc (256 bytes per row).  K13 admit reads only the named rows'
// acc and table (192 bytes a row, ~0.25 us for an 8190-event slice), so
// latency bounds it: the launch and two dependent trips to memory (the
// slot, then the row).  Its lanes therefore test ownership first (a
// lane whose slot the shard does not own loads nothing more), load a
// column's 32-byte limb sums and 16-byte old value as 16-byte vectors
// (8-byte loads when a pointer is not 16-byte aligned), and spread over
// one 256-lane block per 32 events, enough to fill every SM; the event's
// eight verdicts meet in one warp ballot.

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

constexpr int ADMIT_LANES = 8;  // lanes an event: (debit, credit) x four columns

__device__ __forceinline__ void load2(const uint64_t* p, bool vec, uint64_t& x, uint64_t& y) {
  if (vec) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
    x = v.x;
    y = v.y;
  } else {
    x = p[0];
    y = p[1];
  }
}

// One lane per (event, side, column): does the column of the row its
// side names, if this shard owns it, overflow?  The event's eight
// lanes are eight neighbouring lanes of one warp, so one ballot ORs
// them; their lowest writes the event's reject byte.
__global__ void __launch_bounds__(THREADS)
    shard_admit(const uint64_t* __restrict__ table, const uint64_t* __restrict__ acc,
                int64_t local_rows, int64_t row0, const int32_t* __restrict__ dr,
                const int32_t* __restrict__ cr, int64_t E, uint8_t* __restrict__ reject,
                bool vec) {
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t e = j / ADMIT_LANES;
  const int side = (int)(j >> 2) & 1, c = (int)j & 3;
  bool over = false;
  if (e < E) {
    const int64_t rel = (int64_t)(side ? cr[e] : dr[e]) - row0;
    if (rel >= 0 && rel < local_rows) {
      uint64_t a[4], o_lo, o_hi, d_lo, d_hi, d_carry;
      const uint64_t* ap = acc + (rel * 4 + c) * 4;
      load2(ap, vec, a[0], a[1]);
      load2(ap + 2, vec, a[2], a[3]);
      load2(table + rel * 8 + 2 * c, vec, o_lo, o_hi);
      from_limbs(a, d_lo, d_hi, d_carry);
      const uint64_t n_lo = o_lo + d_lo;
      const uint64_t hp = o_hi + d_hi;
      const uint64_t n_hi = hp + (n_lo < o_lo ? 1ull : 0ull);
      over = (hp < o_hi) | (n_hi < hp) | (d_carry != 0);
    }
  }
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, over);
  const int lane = threadIdx.x & 31;
  if ((lane & (ADMIT_LANES - 1)) == 0 && e < E) reject[e] = (votes >> lane) & 0xFFu ? 1 : 0;
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
    const bool vec =
        ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(acc)) & 15) == 0;
    const int64_t blocks = (E * ADMIT_LANES + THREADS - 1) / THREADS;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    shard_admit<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(table), static_cast<const uint64_t*>(acc), local_rows,
        row0, static_cast<const int32_t*>(dr), static_cast<const int32_t*>(cr), E,
        static_cast<uint8_t*>(reject), vec);
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
