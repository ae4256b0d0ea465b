// K1: one order-free create_transfers batch, computed on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:436
// (_orderfree_core, reached through _orderfree :375 and
// _orderfree_tight :408, with _static_ladder_normal :180,
// _accum_cols_multi :226, _admit_apply :311 and _summary :344).  Same
// inputs and the same bits out: the updated balance rows and one
// 64-word failure-sparse summary row in the ring.
//
// What bounds it on the H100: the batch touches at most 2B rows of a
// table that may hold millions, so the least traffic is the packed
// batch (B x 20 or 48 bytes), the touched rows (64 bytes read, 64
// written, 8 bytes of meta) and one 512-byte ring row — well under a
// microsecond at 3.35 TB/s.  At that size the five launches and the
// atomics dominate, not bandwidth.  The design therefore never passes
// over the whole table: the reference's one-hot MXU matmul (whose
// (2B, A) one-hot was its dominant traffic) and its whole-table
// where() become per-touched-row work.
//
//   1. of_ladder    one thread per event: static ladder + timeout
//                   overflow -> code; an ok event claims its two rows
//                   (atomicCAS on a per-slot index that rests at -1)
//                   and the owner zeroes that row's accumulators.
//   2. of_accum     one thread per ok event: 32-bit limbs of the
//                   amount atomicAdd'ed as u64 into (row, col, limb)
//                   accumulators.  At most 2B = 16384 adds per
//                   accumulator keeps every sum below 2^46: exact.
//   3. of_admit     one thread per touched row: limbs recombined with
//                   carries into u128 deltas, the new row computed,
//                   any column or dp+dpo / cp+cpo overflow raises the
//                   batch's overflow flag.
//   4. of_apply     only after every row was admitted (a separate
//                   launch, so the flag is final): all-or-nothing
//                   write of the new rows, and the per-slot index is
//                   returned to -1.
//   5. of_summary   one block: block-wide prefix sum over the failure
//                   flags lists the first FAIL_CAP failures in event
//                   order; writes the ring row; resets the batch
//                   counters for the next launch.
//
// Admission looks at touched rows only.  That equals the reference's
// whole-table admission on every table whose untouched rows do not
// already overflow dp+dpo or cp+cpo — every reachable state, since
// the reference refuses such transfers (overflows_debits/credits) —
// and it equals the host mirror's admission exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SUMMARY_WORDS = 64;
constexpr int FAIL_CAP = SUMMARY_WORDS - 4;
constexpr uint64_t FLAG_OVERFLOW = 1ull << 0;
constexpr uint64_t FLAG_CAP = 1ull << 1;

constexpr uint64_t BIT_TS_NONZERO = 1ull << 0;
constexpr uint64_t BIT_ID_ZERO = 1ull << 1;
constexpr uint64_t BIT_ID_MAX = 1ull << 2;
constexpr uint64_t BIT_DR_ZERO = 1ull << 3;
constexpr uint64_t BIT_DR_MAX = 1ull << 4;
constexpr uint64_t BIT_CR_ZERO = 1ull << 5;
constexpr uint64_t BIT_CR_MAX = 1ull << 6;
constexpr uint64_t BIT_SAME_ACCT = 1ull << 7;
constexpr uint64_t BIT_PEND_NONZERO = 1ull << 8;

constexpr uint32_t F_PENDING = 1u << 1;
constexpr uint32_t F_BAL_DR = 1u << 4;
constexpr uint32_t F_BAL_CR = 1u << 5;

constexpr uint32_t TIGHT_FLAGS_SHIFT = 18;
constexpr uint32_t TIGHT_CODE_BIT = 1u << 24;
constexpr uint32_t TIGHT_RESERVED_BIT = 1u << 25;

constexpr uint64_t NS_PER_S = 1000000000ull;
constexpr uint64_t M32 = 0xFFFFFFFFull;

// CreateTransferResult codes (reference: src/tigerbeetle.zig:185-265).
enum : uint32_t {
  LINKED_EVENT_FAILED = 1,
  TIMESTAMP_MUST_BE_ZERO = 3,
  RESERVED_FLAG = 4,
  ID_MUST_NOT_BE_ZERO = 5,
  ID_MUST_NOT_BE_INT_MAX = 6,
  DEBIT_ID_MUST_NOT_BE_ZERO = 8,
  DEBIT_ID_MUST_NOT_BE_INT_MAX = 9,
  CREDIT_ID_MUST_NOT_BE_ZERO = 10,
  CREDIT_ID_MUST_NOT_BE_INT_MAX = 11,
  ACCOUNTS_MUST_BE_DIFFERENT = 12,
  PENDING_ID_MUST_BE_ZERO = 13,
  TIMEOUT_RESERVED_FOR_PENDING = 17,
  AMOUNT_MUST_NOT_BE_ZERO = 18,
  LEDGER_MUST_NOT_BE_ZERO = 19,
  CODE_MUST_NOT_BE_ZERO = 20,
  DEBIT_ACCOUNT_NOT_FOUND = 21,
  CREDIT_ACCOUNT_NOT_FOUND = 22,
  ACCOUNTS_SAME_LEDGER = 23,
  TRANSFER_SAME_LEDGER = 24,
  OVERFLOWS_TIMEOUT = 53,
};

enum Mode : int { MODE_FULL = 0, MODE_LO = 1, MODE_TIGHT = 2 };

struct Event {
  uint64_t bits, amt_lo, amt_hi, timeout;
  int64_t dr, cr;
  uint32_t flags, code, ledger;
};

// The three packed input formats (device_kernels.py _unpack and
// _orderfree_tight): (B, 6) u64 for full/lo, (B, 5) u32 for tight.
__device__ __forceinline__ Event decode(const void* pk, int mode, int e) {
  Event ev;
  if (mode == MODE_TIGHT) {
    const uint32_t* w = static_cast<const uint32_t*>(pk) + (size_t)e * 5;
    const uint32_t w0 = w[0];
    ev.bits = w0;
    ev.flags = ((w0 >> TIGHT_FLAGS_SHIFT) & 0x3Fu) |
               ((w0 & TIGHT_RESERVED_BIT) ? 0x40u : 0u);
    ev.code = (w0 & TIGHT_CODE_BIT) ? 1u : 0u;
    ev.dr = (int64_t)w[1] - 1;
    ev.cr = (int64_t)w[2] - 1;
    ev.amt_lo = w[3];
    ev.amt_hi = 0;
    ev.ledger = w[4];
    ev.timeout = 0;
  } else {
    const uint64_t* w = static_cast<const uint64_t*>(pk) + (size_t)e * 6;
    ev.bits = w[0];
    ev.dr = (int64_t)(w[1] & M32) - 1;
    ev.cr = (int64_t)(w[1] >> 32) - 1;
    ev.amt_lo = w[2];
    ev.amt_hi = w[3];
    const uint64_t misc = w[4];
    ev.flags = (uint32_t)(misc & 0xFFFFu);
    ev.code = (uint32_t)((misc >> 16) & 0xFFFFu);
    ev.ledger = (uint32_t)(misc >> 32);
    ev.timeout = w[5] & M32;
  }
  return ev;
}

__device__ __forceinline__ int64_t clamp_slot(int64_t s, int64_t A) {
  return s < 0 ? 0 : (s > A - 1 ? A - 1 : s);
}

// Static precedence ladder (reference: src/state_machine.zig:1465-1504)
// then overflows_timeout, per event.  Inactive (padding) rows take
// linked_event_failed and never apply.
__device__ __forceinline__ uint32_t ladder(const Event& ev,
                                           const uint32_t* meta, int64_t A,
                                           bool active, uint64_t ts_i) {
  if (!active) return LINKED_EVENT_FAILED;
  const bool dr_found = ev.dr >= 0;
  const bool cr_found = ev.cr >= 0;
  const uint32_t dr_ledger = dr_found ? meta[clamp_slot(ev.dr, A) * 2 + 1] : 0u;
  const uint32_t cr_ledger = cr_found ? meta[clamp_slot(ev.cr, A) * 2 + 1] : 0u;
  const bool not_pending = (ev.flags & F_PENDING) == 0;
  const bool not_balancing = (ev.flags & (F_BAL_DR | F_BAL_CR)) == 0;
  const bool amount_zero = ev.amt_lo == 0 && ev.amt_hi == 0;
  uint32_t r = 0;
  if (ev.bits & BIT_TS_NONZERO) r = TIMESTAMP_MUST_BE_ZERO;
  else if (ev.flags & ~0x3Fu) r = RESERVED_FLAG;
  else if (ev.bits & BIT_ID_ZERO) r = ID_MUST_NOT_BE_ZERO;
  else if (ev.bits & BIT_ID_MAX) r = ID_MUST_NOT_BE_INT_MAX;
  else if (ev.bits & BIT_DR_ZERO) r = DEBIT_ID_MUST_NOT_BE_ZERO;
  else if (ev.bits & BIT_DR_MAX) r = DEBIT_ID_MUST_NOT_BE_INT_MAX;
  else if (ev.bits & BIT_CR_ZERO) r = CREDIT_ID_MUST_NOT_BE_ZERO;
  else if (ev.bits & BIT_CR_MAX) r = CREDIT_ID_MUST_NOT_BE_INT_MAX;
  else if (ev.bits & BIT_SAME_ACCT) r = ACCOUNTS_MUST_BE_DIFFERENT;
  else if (ev.bits & BIT_PEND_NONZERO) r = PENDING_ID_MUST_BE_ZERO;
  else if (not_pending && ev.timeout != 0) r = TIMEOUT_RESERVED_FOR_PENDING;
  else if (not_balancing && amount_zero) r = AMOUNT_MUST_NOT_BE_ZERO;
  else if (ev.ledger == 0) r = LEDGER_MUST_NOT_BE_ZERO;
  else if (ev.code == 0) r = CODE_MUST_NOT_BE_ZERO;
  else if (!dr_found) r = DEBIT_ACCOUNT_NOT_FOUND;
  else if (!cr_found) r = CREDIT_ACCOUNT_NOT_FOUND;
  else if (dr_ledger != cr_ledger) r = ACCOUNTS_SAME_LEDGER;
  else if (ev.ledger != dr_ledger) r = TRANSFER_SAME_LEDGER;
  if (r == 0 && ev.timeout != 0) {
    const uint64_t expires = ts_i + ev.timeout * NS_PER_S;  // wraps mod 2^64
    if (expires < ts_i) r = OVERFLOWS_TIMEOUT;
  }
  return r;
}

__device__ __forceinline__ void claim(int64_t s, int32_t* slot_idx,
                                      int32_t* touched,
                                      unsigned long long* acc,
                                      int32_t* ctrl) {
  if (atomicCAS(&slot_idx[s], -1, -2) == -1) {
    const int k = atomicAdd(&ctrl[0], 1);
    touched[k] = (int32_t)s;
    slot_idx[s] = k;  // read by the next launch only
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[(size_t)k * 16 + j] = 0ull;
  }
}

__global__ void of_ladder(const void* pk, int mode, int n, int B,
                          uint64_t ts_base, const uint32_t* meta, int64_t A,
                          int32_t* codes, int32_t* slot_idx, int32_t* touched,
                          unsigned long long* acc, int32_t* ctrl) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const Event ev = decode(pk, mode, e);
  const bool active = e < n;
  const uint32_t r = ladder(ev, meta, A, active, ts_base + (uint64_t)e);
  codes[e] = (int32_t)r;
  if (!active || r != 0) return;
  claim(clamp_slot(ev.dr, A), slot_idx, touched, acc, ctrl);
  claim(clamp_slot(ev.cr, A), slot_idx, touched, acc, ctrl);
}

__device__ __forceinline__ void add_limbs(unsigned long long* a,
                                          const uint64_t limb[4], int nl) {
  for (int j = 0; j < nl; ++j)
    if (limb[j]) atomicAdd(&a[j], (unsigned long long)limb[j]);
}

__global__ void of_accum(const void* pk, int mode, int n, int64_t A,
                         const int32_t* codes, const int32_t* slot_idx,
                         unsigned long long* acc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n || codes[e] != 0) return;
  const Event ev = decode(pk, mode, e);
  const bool pending = (ev.flags & F_PENDING) != 0;
  const int dcol = pending ? 0 : 1;
  const int ccol = pending ? 2 : 3;
  const uint64_t limb[4] = {ev.amt_lo & M32, ev.amt_lo >> 32,
                            ev.amt_hi & M32, ev.amt_hi >> 32};
  // lo-only formats (tight, lo) sum the low limb pair only: the high
  // amount limb is ignored exactly as the reference's lo_only path.
  const int nl = mode == MODE_FULL ? 4 : 2;
  const int kd = slot_idx[clamp_slot(ev.dr, A)];
  const int kc = slot_idx[clamp_slot(ev.cr, A)];
  add_limbs(acc + (size_t)kd * 16 + dcol * 4, limb, nl);
  add_limbs(acc + (size_t)kc * 16 + ccol * 4, limb, nl);
}

// u128 (a + b) overflow flag.
__device__ __forceinline__ bool tot_ov(uint64_t lo_a, uint64_t hi_a,
                                       uint64_t lo_b, uint64_t hi_b) {
  const uint64_t lo = lo_a + lo_b;
  const uint64_t c = lo < lo_a ? 1ull : 0ull;
  const uint64_t hp = hi_a + hi_b;
  const uint64_t h = hp + c;
  return hp < hi_a || h < hp;
}

__global__ void of_admit(const uint64_t* table, const int32_t* touched,
                         const unsigned long long* acc, int mode,
                         uint64_t* newrows, int32_t* ctrl) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ctrl[0]) return;
  const uint64_t* old = table + (size_t)touched[k] * 8;
  const unsigned long long* a = acc + (size_t)k * 16;
  uint64_t nl[4], nh[4];
  bool ov = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t c0 = a[c * 4 + 0];
    const uint64_t c1 = a[c * 4 + 1] + (c0 >> 32);
    const uint64_t d_lo = (c0 & M32) | ((c1 & M32) << 32);
    uint64_t d_hi;
    if (mode == MODE_FULL) {
      const uint64_t c2 = a[c * 4 + 2] + (c1 >> 32);
      const uint64_t c3 = a[c * 4 + 3] + (c2 >> 32);
      d_hi = (c2 & M32) | ((c3 & M32) << 32);
      ov |= (c3 >> 32) != 0;  // the column sum alone exceeds u128
    } else {
      d_hi = c1 >> 32;  // carry out of the low limb pair
    }
    const uint64_t olo = old[2 * c], ohi = old[2 * c + 1];
    const uint64_t lo = olo + d_lo;
    const uint64_t cy = lo < olo ? 1ull : 0ull;
    const uint64_t hp = ohi + d_hi;
    const uint64_t hi = hp + cy;
    ov |= hp < ohi || hi < hp;
    nl[c] = lo;
    nh[c] = hi;
  }
  ov |= tot_ov(nl[0], nh[0], nl[1], nh[1]);  // debits_pending + posted
  ov |= tot_ov(nl[2], nh[2], nl[3], nh[3]);  // credits_pending + posted
  uint64_t* out = newrows + (size_t)k * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[2 * c] = nl[c];
    out[2 * c + 1] = nh[c];
  }
  if (ov) atomicOr(&ctrl[1], 1);
}

__global__ void of_apply(uint64_t* table, const int32_t* touched,
                         const uint64_t* newrows, int32_t* slot_idx,
                         const int32_t* ctrl) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ctrl[0]) return;
  const int64_t s = touched[k];
  if (!ctrl[1]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) table[s * 8 + j] = newrows[(size_t)k * 8 + j];
  }
  slot_idx[s] = -1;
}

constexpr int SUMMARY_THREADS = 1024;

__global__ void of_summary(const int32_t* codes, int n, int B,
                           int32_t* ctrl, uint64_t* ring_row) {
  __shared__ int warp_count[32];
  __shared__ long long warp_last[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (B + SUMMARY_THREADS - 1) / SUMMARY_THREADS;
  const int lo = t * per;
  const int hi = min(lo + per, B);
  int count = 0;
  long long last = -1;
  for (int e = lo; e < hi && e < n; ++e) {
    if (codes[e] != 0) ++count;
    else last = e;
  }
  if (t < FAIL_CAP) ring_row[4 + t] = 0ull;

  // Block-wide prefix sum of failure counts (event order) and the
  // block maximum of the last applied event.
  int incl = count;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  long long m = last;
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  if (lane == 31) warp_count[warp] = incl;
  if (lane == 0) warp_last[warp] = m;
  __syncthreads();
  if (warp == 0) {
    int w = warp_count[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    warp_count[lane] = w;
    long long wm = warp_last[lane];
    for (int o = 16; o > 0; o >>= 1)
      wm = max(wm, __shfl_xor_sync(0xFFFFFFFFu, wm, o));
    if (lane == 0) warp_last[0] = wm;
  }
  __syncthreads();
  int pos = incl - count + (warp > 0 ? warp_count[warp - 1] : 0);
  for (int e = lo; e < hi && e < n && pos < FAIL_CAP; ++e) {
    const int32_t r = codes[e];
    if (r != 0) {
      ring_row[4 + pos] = ((uint64_t)e << 32) | (uint32_t)r;
      ++pos;
    }
  }
  if (t == 0) {
    const uint64_t n_fail = (uint64_t)warp_count[31];
    uint64_t flags = ctrl[1] ? FLAG_OVERFLOW : 0ull;
    if (n_fail > (uint64_t)FAIL_CAP) flags |= FLAG_CAP;
    ring_row[0] = n_fail;
    ring_row[1] = flags;
    ring_row[2] = (uint64_t)(warp_last[0] + 1);
    ring_row[3] = (uint64_t)(n < 0 ? 0 : (n > B ? B : n));
    ctrl[0] = 0;  // batch counters rest at zero between launches
    ctrl[1] = 0;
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One batch: five launches on `stream`, no host synchronisation.
// Returns the first non-zero CUDA status, or 0.
extern "C" int tb_orderfree(void* table, const void* meta, int64_t A,
                            void* ring_row, const void* pk, int mode, int n,
                            int B, uint64_t ts_base, void* slot_idx,
                            void* codes, void* touched, void* acc,
                            void* newrows, void* ctrl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = 256;
  const int g_events = (B + tb - 1) / tb;
  const int g_rows = (2 * B + tb - 1) / tb;
  auto* codes_i = static_cast<int32_t*>(codes);
  auto* slot_i = static_cast<int32_t*>(slot_idx);
  auto* touched_i = static_cast<int32_t*>(touched);
  auto* acc_u = static_cast<unsigned long long*>(acc);
  auto* ctrl_i = static_cast<int32_t*>(ctrl);
  cudaError_t err;
  of_ladder<<<g_events, tb, 0, s>>>(pk, mode, n, B, ts_base,
                                    static_cast<const uint32_t*>(meta), A,
                                    codes_i, slot_i, touched_i, acc_u, ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_accum<<<g_events, tb, 0, s>>>(pk, mode, n, A, codes_i, slot_i, acc_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_admit<<<g_rows, tb, 0, s>>>(static_cast<const uint64_t*>(table),
                                 touched_i, acc_u, mode,
                                 static_cast<uint64_t*>(newrows), ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_apply<<<g_rows, tb, 0, s>>>(static_cast<uint64_t*>(table), touched_i,
                                 static_cast<const uint64_t*>(newrows),
                                 slot_i, ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_summary<<<1, SUMMARY_THREADS, 0, s>>>(codes_i, n, B, ctrl_i,
                                           static_cast<uint64_t*>(ring_row));
  return (int)cudaGetLastError();
}
