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
// Slots of update and admit: distinct; -1 is padding.  A slot past the
// table (s >= H, the table's rows) is live, as in the reference (its
// gather clamps, its scatter drops): it takes row H-1 as that row was
// before the call (its balances and meta for update, its stored hash as
// old), moves the digest by new - old and stores nothing.  A lane of the
// same call may own row H-1 and store its new hash there during the
// launch, so that lane first publishes the old pair in a record tagged
// with the call (g_last, a ring of RING records picked by the tag; the
// tag counts the library's calls), and a lane past the table reads the
// row, then the record (last_row):
//   owner:  record.old = old; fence; record.tag = tag; fence; row = new
//   past:   v = row; fence; t = record.tag; fence; old = t == tag ? record.old : v
// A past lane whose v holds any word of the new pair sees the tag (the
// owner wrote it before the row, both sides fence: message passing), so
// one that sees no tag read the old pair.  Only the owner of row H-1
// writes a record; a call with no slot past the table never reads one.
// The owner's two fences cost a call that admits row H-1 ~1.1 us of
// ~1.95 (PERF.md, K2 admit row); the rare lanes' code in update's loop
// costs every update ~6 us of ~37 at a window, even with none of them
// (PERF.md, K2 update row: no other placement measured faster).
//
// What bounds it on the H100: bytes.  A row costs 72 bytes of table and
// meta plus 8 of row binding read and 16 of hash written; the eleven
// 64-bit mixes per row (~150 integer operations) stay far below the
// card's integer rate.  The design reads each row once with
// neighbouring threads on neighbouring rows and keeps the fold in
// registers until one atomic per block.
//
// Admit is bytes-bound in name only: per slot 8 bytes of index and 16 of
// new hash read, the old hash read and overwritten (56 bytes), ~0.27 us
// of HBM at the 16,380 slots of a warm-up admission and ~0.001 us at the
// ~80 of a timed one, against ~0.87 us of an empty kernel's launch: a
// launch and one dependent trip (the slot, then its row) and the fold.
// So a thread takes one slot: the slot and its new pair by loads issued
// together, then the old pair as one 16-byte load and the new one as one
// 16-byte store when row_hash is 16-byte aligned (8-byte words when it
// is not).  The grid is K4's, from the card's SM count (tb::
// spread_geometry: 128 x 128 at 16,384 slots, 3 x 32 at 80); each
// block's sum meets the digest in one atomic a lane.  Measured (PERF.md, the K2 admit row):
// streaming loads, an atomic a lane a warp, one block with a plain add
// of the digest at small calls, one block of 256 and a grid that fills
// every SM were each as fast or slower.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"

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

// ---- Row H-1 for the slots past the table (see the top of the file).

struct LastRow {
  unsigned long long tag, lo, hi, pad;
};
constexpr int RING = 256;  // calls running at once on one card that never share a record
__device__ LastRow g_last[RING];

std::atomic<unsigned long long> g_calls{0};  // tags: this library's calls, from 1

__device__ __forceinline__ void fence() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

// A lane at row H-1 (`owner`) or past the table: row H-1's pair as it was
// before this call.  The owner publishes it for this call's tag and then
// stores its new pair (lo, hi); a lane past the table reads the row, then
// the record.  Update inlines it (a call in its loop spread the loop's
// loads: 97 us against 43 at a window); admit calls it out of line
// (inlined it cost admit 0.07-0.1 us).
__device__ __forceinline__ ulonglong2 last_row(uint64_t* last, uint64_t tag, bool owner,
                                              uint64_t lo, uint64_t hi) {
  volatile unsigned long long* row = reinterpret_cast<volatile unsigned long long*>(last);
  volatile LastRow* r = &g_last[tag % RING];
  ulonglong2 old = make_ulonglong2(row[0], row[1]);
  if (owner) {
    r->lo = old.x;
    r->hi = old.y;
    fence();
    r->tag = tag;
    fence();
    row[0] = lo;
    row[1] = hi;
  } else {
    fence();
    if (r->tag == tag) {
      fence();
      old = make_ulonglong2(r->lo, r->hi);
    }
  }
  return old;
}

// last_row out of line (K2 admit).
__device__ __noinline__ ulonglong2 last_row_call(uint64_t* last, uint64_t tag, bool owner,
                                                 uint64_t lo, uint64_t hi) {
  return last_row(last, tag, owner, lo, hi);
}

// Sum (lo, hi) over the block and add it to out[0..1] with one atomic
// per lane.  ANY_WIDTH: a block of any multiple of 32 threads up to
// THREADS (K2 admit), one of a single warp adding its sum without the
// shared stage (~0.15 us of a timed admission's ~1.5); else THREADS.
template <bool ANY_WIDTH = false>
__device__ __forceinline__ void block_fold(uint64_t lo, uint64_t hi, unsigned long long* out) {
  __shared__ unsigned long long s_lo[THREADS / 32], s_hi[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) {
    lo += __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)lo, o);
    hi += __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)hi, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (ANY_WIDTH && blockDim.x == 32) {
    if (lane == 0) {
      tb::red_add(&out[0], lo);
      tb::red_add(&out[1], hi);
    }
    return;
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    const int warps = ANY_WIDTH ? (int)(blockDim.x >> 5) : THREADS / 32;
    for (int w = 0; w < warps; ++w) {
      a += s_lo[w];
      b += s_hi[w];
    }
    tb::red_add(&out[0], a);
    tb::red_add(&out[1], b);
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

// Touched slots of a table of A rows; each in-range slot is owned by
// exactly one thread, so the gather of the old hash and the store of
// the new one cannot race.  A slot past the table hashes row A-1's
// columns under its own logical id against row A-1's old hash.
__global__ void cm_update(const uint64_t* bal, const uint32_t* meta, int64_t A,
                          uint64_t* row_hash, unsigned long long* digest,
                          const int64_t* slots, const uint64_t* rows,
                          int64_t k, uint64_t tag) {
  uint64_t d_lo = 0, d_hi = 0;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < k;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t s = slots[i];
    if (s < 0) continue;
    const int64_t at = s < A ? s : A - 1;
    uint64_t o_lo = row_hash[at * 2], o_hi = row_hash[at * 2 + 1];
    uint64_t lo, hi;
    hash_row(rows[i], bal + at * 8, meta + at * 2, lo, hi);
    if (s < A - 1) {
      row_hash[s * 2] = lo;
      row_hash[s * 2 + 1] = hi;
    } else {
      const ulonglong2 old = last_row(row_hash + at * 2, tag, s == A - 1, lo, hi);
      o_lo = old.x;
      o_hi = old.y;
    }
    d_lo += lo - o_lo;
    d_hi += hi - o_hi;
  }
  block_fold(d_lo, d_hi, digest);
}

// Tiered admission: at each hot slot the stored hash becomes (new_lo,
// new_hi), supplied by the host twin, and the digest moves by new - old.
// WIDE: row_hash is 16-byte aligned (a pair moves as one ulonglong2).
template <bool WIDE>
__global__ void __launch_bounds__(tb::SPREAD_THREADS)
    cm_admit(uint64_t* row_hash, int64_t H, unsigned long long* digest,
             const int64_t* slots, const uint64_t* new_lo, const uint64_t* new_hi, int64_t k,
             uint64_t tag) {
  const int64_t span = (int64_t)gridDim.x * blockDim.x;
  uint64_t d_lo = 0, d_hi = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += span) {
    const int64_t s = slots[i];
    const uint64_t n_lo = new_lo[i];
    const uint64_t n_hi = new_hi[i];
    if (s < 0) continue;
    uint64_t o_lo, o_hi;
    if (s < H - 1) {
      uint64_t* cell = row_hash + 2 * s;
      if (WIDE) {
        const ulonglong2 c = *reinterpret_cast<const ulonglong2*>(cell);
        *reinterpret_cast<ulonglong2*>(cell) = make_ulonglong2(n_lo, n_hi);
        o_lo = c.x;
        o_hi = c.y;
      } else {
        o_lo = cell[0];
        o_hi = cell[1];
        cell[0] = n_lo;
        cell[1] = n_hi;
      }
    } else {
      const ulonglong2 old = last_row_call(row_hash + 2 * (H - 1), tag, s == H - 1, n_lo, n_hi);
      o_lo = old.x;
      o_hi = old.y;
    }
    d_lo += n_lo - o_lo;
    d_hi += n_hi - o_hi;
  }
  block_fold<true>(d_lo, d_hi, digest);
}

__global__ void cm_empty() {}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int tb_commit_hash_all(const void* balances, const void* meta,
                                  const void* rows, int64_t A,
                                  void* row_hash, void* fold_out,
                                  void* stream) {
  int grid;
  if (const int err = tb::grid_for(A, THREADS, grid)) return err;
  cm_hash_all<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(balances),
      static_cast<const uint32_t*>(meta), static_cast<const uint64_t*>(rows),
      A, static_cast<uint64_t*>(row_hash),
      static_cast<unsigned long long*>(fold_out));
  return (int)cudaGetLastError();
}

// A: the table's rows (balances, meta and row_hash); at least 1 when k > 0.
extern "C" int tb_commit_update(const void* balances, const void* meta, int64_t A,
                                void* row_hash, void* digest,
                                const void* slots, const void* rows,
                                int64_t k, void* stream) {
  if (k > 0 && A < 1) return (int)cudaErrorInvalidValue;
  int grid;
  if (const int err = tb::grid_for(k, THREADS, grid)) return err;
  cm_update<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(balances), static_cast<const uint32_t*>(meta), A,
      static_cast<uint64_t*>(row_hash), static_cast<unsigned long long*>(digest),
      static_cast<const int64_t*>(slots), static_cast<const uint64_t*>(rows), k, ++g_calls);
  return (int)cudaGetLastError();
}

// The launch K2 admit makes for k slots on the current card: blocks and
// threads a block, into geom[0..1]; a CUDA status.
extern "C" int tb_commit_admit_geometry(int k, int* geom) {
  int sms = 0;
  const int err = tb::sm_count(sms);
  if (err) return err;
  tb::spread_geometry(k, sms, geom[0], geom[1]);
  return 0;
}

extern "C" int tb_commit_admit(void* row_hash, int64_t H, void* digest,
                               const void* slots, const void* new_lo,
                               const void* new_hi, int64_t k, void* stream) {
  if (k <= 0) return 0;
  if (H < 1) return (int)cudaErrorInvalidValue;
  int sms = 0, G, T;
  const int err = tb::sm_count(sms);
  if (err) return err;
  tb::spread_geometry(k, sms, G, T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* rh = static_cast<uint64_t*>(row_hash);
  auto* dg = static_cast<unsigned long long*>(digest);
  const auto* sl = static_cast<const int64_t*>(slots);
  const auto* lo = static_cast<const uint64_t*>(new_lo);
  const auto* hi = static_cast<const uint64_t*>(new_hi);
  if ((reinterpret_cast<uintptr_t>(row_hash) & 15) == 0)
    cm_admit<true><<<G, T, 0, st>>>(rh, H, dg, sl, lo, hi, k, ++g_calls);
  else
    cm_admit<false><<<G, T, 0, st>>>(rh, H, dg, sl, lo, hi, k, ++g_calls);
  return (int)cudaGetLastError();
}

// An empty kernel of `blocks` x `threads`: the floor a small launch
// stands on (a measurement; no wrapper of the port calls it).
extern "C" int tb_commit_empty(int blocks, int threads, void* stream) {
  cm_empty<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
