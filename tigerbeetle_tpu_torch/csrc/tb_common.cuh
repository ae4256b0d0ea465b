// Device code shared by the semantic kernels K1 (orderfree.cu), K5
// (linked.cu) and K6 (two_phase.cu): the packed input layout (K1's
// three formats), the static precedence ladder, the per-slot row claim
// (K5), the u128 limb sums and overflow tests and the summary row's
// constants (each kernel writes its summary from every block).
// Counterparts of tigerbeetle_tpu/state_machine/device_kernels.py
// _unpack :157, _static_ladder_normal :180, _admit_apply :311 and
// _summary :344.
//
// kernels/build.py hashes this header into every library's name, so a
// change here rebuilds all three.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tb {

constexpr int SUMMARY_WORDS = 64;
constexpr int FAIL_CAP = SUMMARY_WORDS - 4;
constexpr uint64_t FLAG_OVERFLOW = 1ull << 0;
constexpr uint64_t FLAG_CAP = 1ull << 1;
constexpr uint64_t FLAG_PRECOND = 1ull << 2;
constexpr int ITERS_SHIFT = 16;

// Packed input columns (u64 each).
constexpr int COL_BITS = 0, COL_SLOTS = 1, COL_AMT_LO = 2, COL_AMT_HI = 3,
              COL_MISC = 4, COL_TIMEOUT = 5, N_COLS = 6;
constexpr int COL_TP_JOIN = 6, COL_TP_SLOTS = 7, COL_TP_AMT_LO = 8,
              COL_TP_AMT_HI = 9, COL_TP_REF = 10, N_COLS_TP = 11;

constexpr uint64_t BIT_TS_NONZERO = 1ull << 0;
constexpr uint64_t BIT_ID_ZERO = 1ull << 1;
constexpr uint64_t BIT_ID_MAX = 1ull << 2;
constexpr uint64_t BIT_DR_ZERO = 1ull << 3;
constexpr uint64_t BIT_DR_MAX = 1ull << 4;
constexpr uint64_t BIT_CR_ZERO = 1ull << 5;
constexpr uint64_t BIT_CR_MAX = 1ull << 6;
constexpr uint64_t BIT_SAME_ACCT = 1ull << 7;
constexpr uint64_t BIT_PEND_NONZERO = 1ull << 8;
constexpr uint64_t BIT_PEND_MAX = 1ull << 9;
constexpr uint64_t BIT_PEND_SELF = 1ull << 10;
constexpr uint64_t BIT_P_FOUND = 1ull << 12;
constexpr uint64_t BIT_T_DR_SET = 1ull << 13;
constexpr uint64_t BIT_T_CR_SET = 1ull << 14;
constexpr uint64_t BIT_DR_EQ_P = 1ull << 15;
constexpr uint64_t BIT_CR_EQ_P = 1ull << 16;

// TransferFlags (reference: src/tigerbeetle.zig:127-140) and
// AccountFlags (:42-63).
constexpr uint32_t F_LINKED = 1u << 0;
constexpr uint32_t F_PENDING = 1u << 1;
constexpr uint32_t F_POST = 1u << 2;
constexpr uint32_t F_VOID = 1u << 3;
constexpr uint32_t F_BAL_DR = 1u << 4;
constexpr uint32_t F_BAL_CR = 1u << 5;
constexpr uint32_t AF_DR_LIMIT = 1u << 1;
constexpr uint32_t AF_CR_LIMIT = 1u << 2;

constexpr uint32_t S_PENDING = 1, S_POSTED = 2, S_VOIDED = 3, S_EXPIRED = 4;

constexpr uint64_t M32 = 0xFFFFFFFFull;

// CreateTransferResult codes (reference: src/tigerbeetle.zig:185-265).
enum : uint32_t {
  LINKED_EVENT_FAILED = 1,
  LINKED_EVENT_CHAIN_OPEN = 2,
  TIMESTAMP_MUST_BE_ZERO = 3,
  RESERVED_FLAG = 4,
  ID_MUST_NOT_BE_ZERO = 5,
  ID_MUST_NOT_BE_INT_MAX = 6,
  FLAGS_ARE_MUTUALLY_EXCLUSIVE = 7,
  DEBIT_ID_MUST_NOT_BE_ZERO = 8,
  DEBIT_ID_MUST_NOT_BE_INT_MAX = 9,
  CREDIT_ID_MUST_NOT_BE_ZERO = 10,
  CREDIT_ID_MUST_NOT_BE_INT_MAX = 11,
  ACCOUNTS_MUST_BE_DIFFERENT = 12,
  PENDING_ID_MUST_BE_ZERO = 13,
  PENDING_ID_MUST_NOT_BE_ZERO = 14,
  PENDING_ID_MUST_NOT_BE_INT_MAX = 15,
  PENDING_ID_MUST_BE_DIFFERENT = 16,
  TIMEOUT_RESERVED_FOR_PENDING = 17,
  AMOUNT_MUST_NOT_BE_ZERO = 18,
  LEDGER_MUST_NOT_BE_ZERO = 19,
  CODE_MUST_NOT_BE_ZERO = 20,
  DEBIT_ACCOUNT_NOT_FOUND = 21,
  CREDIT_ACCOUNT_NOT_FOUND = 22,
  ACCOUNTS_SAME_LEDGER = 23,
  TRANSFER_SAME_LEDGER = 24,
  PENDING_NOT_FOUND = 25,
  PENDING_NOT_PENDING = 26,
  PENDING_DIFF_DR = 27,
  PENDING_DIFF_CR = 28,
  PENDING_DIFF_LEDGER = 29,
  PENDING_DIFF_CODE = 30,
  EXCEEDS_PENDING_AMOUNT = 31,
  PENDING_DIFF_AMOUNT = 32,
  PENDING_ALREADY_POSTED = 33,
  PENDING_ALREADY_VOIDED = 34,
  PENDING_EXPIRED = 35,
  OVERFLOWS_TIMEOUT = 53,
  EXCEEDS_CREDITS = 54,
  EXCEEDS_DEBITS = 55,
};

struct Event {
  uint64_t bits, amt_lo, amt_hi, timeout;
  int64_t dr, cr;
  uint32_t flags, code, ledger;
};

// One row of the (B, ncols) u64 packed matrix (device_kernels.py
// _unpack).
__device__ __forceinline__ Event decode_wide(const uint64_t* pk, int ncols, int e) {
  const uint64_t* w = pk + (size_t)e * ncols;
  Event ev;
  ev.bits = w[COL_BITS];
  ev.dr = (int64_t)(w[COL_SLOTS] & M32) - 1;
  ev.cr = (int64_t)(w[COL_SLOTS] >> 32) - 1;
  ev.amt_lo = w[COL_AMT_LO];
  ev.amt_hi = w[COL_AMT_HI];
  const uint64_t misc = w[COL_MISC];
  ev.flags = (uint32_t)(misc & 0xFFFFu);
  ev.code = (uint32_t)((misc >> 16) & 0xFFFFu);
  ev.ledger = (uint32_t)(misc >> 32);
  ev.timeout = w[COL_TIMEOUT] & M32;
  return ev;
}

__device__ __forceinline__ int64_t clamp_slot(int64_t s, int64_t A) {
  return s < 0 ? 0 : (s > A - 1 ? A - 1 : s);
}

// Static precedence ladder for non-post/void transfers (reference:
// src/state_machine.zig:1465-1504).  Inactive (padding) rows take
// linked_event_failed and never apply.
__device__ __forceinline__ uint32_t ladder_normal(const Event& ev, const uint32_t* meta,
                                                  int64_t A, bool active) {
  if (!active) return LINKED_EVENT_FAILED;
  const bool dr_found = ev.dr >= 0;
  const bool cr_found = ev.cr >= 0;
  const uint32_t dr_ledger = dr_found ? meta[clamp_slot(ev.dr, A) * 2 + 1] : 0u;
  const uint32_t cr_ledger = cr_found ? meta[clamp_slot(ev.cr, A) * 2 + 1] : 0u;
  const bool not_pending = (ev.flags & F_PENDING) == 0;
  const bool not_balancing = (ev.flags & (F_BAL_DR | F_BAL_CR)) == 0;
  const bool amount_zero = ev.amt_lo == 0 && ev.amt_hi == 0;
  if (ev.bits & BIT_TS_NONZERO) return TIMESTAMP_MUST_BE_ZERO;
  if (ev.flags & ~0x3Fu) return RESERVED_FLAG;
  if (ev.bits & BIT_ID_ZERO) return ID_MUST_NOT_BE_ZERO;
  if (ev.bits & BIT_ID_MAX) return ID_MUST_NOT_BE_INT_MAX;
  if (ev.bits & BIT_DR_ZERO) return DEBIT_ID_MUST_NOT_BE_ZERO;
  if (ev.bits & BIT_DR_MAX) return DEBIT_ID_MUST_NOT_BE_INT_MAX;
  if (ev.bits & BIT_CR_ZERO) return CREDIT_ID_MUST_NOT_BE_ZERO;
  if (ev.bits & BIT_CR_MAX) return CREDIT_ID_MUST_NOT_BE_INT_MAX;
  if (ev.bits & BIT_SAME_ACCT) return ACCOUNTS_MUST_BE_DIFFERENT;
  if (ev.bits & BIT_PEND_NONZERO) return PENDING_ID_MUST_BE_ZERO;
  if (not_pending && ev.timeout != 0) return TIMEOUT_RESERVED_FOR_PENDING;
  if (not_balancing && amount_zero) return AMOUNT_MUST_NOT_BE_ZERO;
  if (ev.ledger == 0) return LEDGER_MUST_NOT_BE_ZERO;
  if (ev.code == 0) return CODE_MUST_NOT_BE_ZERO;
  if (!dr_found) return DEBIT_ACCOUNT_NOT_FOUND;
  if (!cr_found) return CREDIT_ACCOUNT_NOT_FOUND;
  if (dr_ledger != cr_ledger) return ACCOUNTS_SAME_LEDGER;
  if (ev.ledger != dr_ledger) return TRANSFER_SAME_LEDGER;
  return 0;
}

// K1's packed formats (the tight format's word 0 layout) and modes.
constexpr uint32_t TIGHT_FLAGS_SHIFT = 18;
constexpr uint32_t TIGHT_CODE_BIT = 1u << 24;
constexpr uint32_t TIGHT_RESERVED_BIT = 1u << 25;
constexpr uint64_t NS_PER_S = 1000000000ull;
enum Mode : int { MODE_FULL = 0, MODE_LO = 1, MODE_TIGHT = 2 };

// The three packed input formats (device_kernels.py _unpack and
// _orderfree_tight): (B, 6) u64 for full/lo, (B, 5) u32 for tight.
__device__ __forceinline__ Event decode_orderfree(const void* pk, int mode, int e) {
  if (mode != MODE_TIGHT) return decode_wide(static_cast<const uint64_t*>(pk), N_COLS, e);
  Event ev;
  const uint32_t* w = static_cast<const uint32_t*>(pk) + (size_t)e * 5;
  const uint32_t w0 = w[0];
  ev.bits = w0;
  ev.flags = ((w0 >> TIGHT_FLAGS_SHIFT) & 0x3Fu) | ((w0 & TIGHT_RESERVED_BIT) ? 0x40u : 0u);
  ev.code = (w0 & TIGHT_CODE_BIT) ? 1u : 0u;
  ev.dr = (int64_t)w[1] - 1;
  ev.cr = (int64_t)w[2] - 1;
  ev.amt_lo = w[3];
  ev.amt_hi = 0;
  ev.ledger = w[4];
  ev.timeout = 0;
  return ev;
}

// K1's ladder: the static precedence ladder then overflows_timeout.
__device__ __forceinline__ uint32_t ladder_orderfree(const Event& ev, const uint32_t* meta,
                                                     int64_t A, bool active, uint64_t ts_i) {
  uint32_t r = ladder_normal(ev, meta, A, active);
  if (r == 0 && ev.timeout != 0) {
    const uint64_t expires = ts_i + ev.timeout * NS_PER_S;  // wraps mod 2^64
    if (expires < ts_i) r = OVERFLOWS_TIMEOUT;
  }
  return r;
}

// Claim row `s` for this batch: the first claimer takes the next index
// k of the touched-row list (the per-slot index rests at -1 between
// launches, -2 while being claimed) and zeroes its `width` accumulator
// words.  The index is read by a later launch, or after a block
// barrier.
__device__ __forceinline__ void claim(int64_t s, int32_t* slot_idx, int32_t* touched,
                                      unsigned long long* acc, int width, int32_t* count) {
  if (atomicCAS(&slot_idx[s], -1, -2) == -1) {
    const int k = atomicAdd(count, 1);
    touched[k] = (int32_t)s;
    slot_idx[s] = k;
    for (int j = 0; j < width; ++j) acc[(size_t)k * width + j] = 0ull;
  }
}

// 32-bit limbs of a u128 amount atomically added into u64 accumulators
// (at most 4B adds per accumulator keeps every sum below 2^47: exact).
__device__ __forceinline__ void add_limbs(unsigned long long* a, uint64_t lo, uint64_t hi,
                                          int nl) {
  const uint64_t limb[4] = {lo & M32, lo >> 32, hi & M32, hi >> 32};
  for (int j = 0; j < nl; ++j)
    if (limb[j]) atomicAdd(&a[j], (unsigned long long)limb[j]);
}

// Four limb sums -> (lo, hi) of the u128 column delta; `wide` false is
// the reference's lo_only (the high delta is the carry out of the low
// pair); `limb_ov` is set when the sum alone exceeds u128.
__device__ __forceinline__ void limbs_to_u128(const unsigned long long* a, bool wide,
                                              uint64_t& lo, uint64_t& hi, bool& limb_ov) {
  const uint64_t c0 = a[0];
  const uint64_t c1 = a[1] + (c0 >> 32);
  lo = (c0 & M32) | ((c1 & M32) << 32);
  if (wide) {
    const uint64_t c2 = a[2] + (c1 >> 32);
    const uint64_t c3 = a[3] + (c2 >> 32);
    hi = (c2 & M32) | ((c3 & M32) << 32);
    limb_ov |= (c3 >> 32) != 0;
  } else {
    hi = c1 >> 32;
  }
}

// (a + b) mod 2^128 and its overflow.
__device__ __forceinline__ bool add128(uint64_t a_lo, uint64_t a_hi, uint64_t b_lo,
                                       uint64_t b_hi, uint64_t& lo, uint64_t& hi) {
  lo = a_lo + b_lo;
  const uint64_t cy = lo < a_lo ? 1ull : 0ull;
  const uint64_t hp = a_hi + b_hi;
  hi = hp + cy;
  return hp < a_hi || hi < hp;
}

// u128 (a + b) overflow flag.
__device__ __forceinline__ bool tot_ov(uint64_t lo_a, uint64_t hi_a, uint64_t lo_b,
                                       uint64_t hi_b) {
  uint64_t lo, hi;
  return add128(lo_a, hi_a, lo_b, hi_b, lo, hi);
}

}  // namespace tb

extern "C" const char* tb_error_string(int err);
