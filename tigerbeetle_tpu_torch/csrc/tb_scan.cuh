// Device code shared by the exact scan K3 (exact_scan.cu), the wave
// step K7 (wave_step.cu) and the chain wave K8 (chain_wave.cu): the
// packed event columns (kernel.EVENT_FIELDS), the created-record fields
// (kernel.CREATED_FIELDS), the carry's layout in K3's scratch buffer,
// u128 helpers, the exists ladders, the normal and post/void verdicts
// and the created record.  Counterparts of
// tigerbeetle_tpu/state_machine/kernel.py make_body :326 (the event
// body), _exists_ladder_normal and _exists_ladder_post_void, which the
// reference's wave step and chain wave (waves.py :1010, :1354) reuse.
//
// kernels/build.py hashes this header into every library's name.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tbs {

typedef unsigned __int128 u128;

constexpr int NEV = 52;   // packed event columns
constexpr int NOUT = 37;  // packed output columns
constexpr int NCR = 14;   // created-record fields

constexpr uint32_t F_LINKED = 1u << 0;
constexpr uint32_t F_PENDING = 1u << 1;
constexpr uint32_t F_POST = 1u << 2;
constexpr uint32_t F_VOID = 1u << 3;
constexpr uint32_t F_BAL_DR = 1u << 4;
constexpr uint32_t F_BAL_CR = 1u << 5;
constexpr uint32_t AF_DR_LIMIT = 1u << 1;
constexpr uint32_t AF_CR_LIMIT = 1u << 2;

constexpr uint64_t S_PENDING = 1, S_POSTED = 2, S_VOIDED = 3, S_EXPIRED = 4;
constexpr uint64_t NS_PER_S = 1000000000ull;
constexpr uint64_t U64_MAX = ~0ull;

// CreateTransferResult codes (reference: src/tigerbeetle.zig:185-265).
enum : uint32_t {
  LINKED_EVENT_FAILED = 1,
  LINKED_EVENT_CHAIN_OPEN = 2,
  TIMESTAMP_MUST_BE_ZERO = 3,
  PENDING_NOT_FOUND = 25,
  PENDING_NOT_PENDING = 26,
  PENDING_DIFF_DR = 27,
  PENDING_DIFF_CR = 28,
  PENDING_DIFF_LEDGER = 29,
  PENDING_DIFF_CODE = 30,
  EXCEEDS_PENDING_AMOUNT = 31,
  PENDING_DIFF_AMOUNT = 32,
  ALREADY_POSTED = 33,
  ALREADY_VOIDED = 34,
  PENDING_EXPIRED = 35,
  EXISTS_DIFF_FLAGS = 36,
  EXISTS_DIFF_DR = 37,
  EXISTS_DIFF_CR = 38,
  EXISTS_DIFF_AMOUNT = 39,
  EXISTS_DIFF_PENDING_ID = 40,
  EXISTS_DIFF_UD128 = 41,
  EXISTS_DIFF_UD64 = 42,
  EXISTS_DIFF_UD32 = 43,
  EXISTS_DIFF_TIMEOUT = 44,
  EXISTS_DIFF_CODE = 45,
  EXISTS = 46,
  OVERFLOWS_DP = 47,
  OVERFLOWS_CP = 48,
  OVERFLOWS_DPO = 49,
  OVERFLOWS_CPO = 50,
  OVERFLOWS_DEBITS = 51,
  OVERFLOWS_CREDITS = 52,
  OVERFLOWS_TIMEOUT = 53,
  EXCEEDS_CREDITS = 54,
  EXCEEDS_DEBITS = 55,
};

// Created-record field indices (kernel.CREATED_FIELDS).
enum {
  C_FLAGS, C_DR, C_CR, C_AMT_LO, C_AMT_HI, C_PEND_LO, C_PEND_HI,
  C_UD128_LO, C_UD128_HI, C_UD64, C_UD32, C_TIMEOUT, C_LEDGER, C_CODE,
};

// Event column indices (kernel.EVENT_FIELDS).
enum {
  E_I, E_FLAGS, E_TS_NONZERO, E_STATIC, E_AMT_LO, E_AMT_HI, E_PEND_LO,
  E_PEND_HI, E_UD128_LO, E_UD128_HI, E_UD64, E_UD32, E_TIMEOUT, E_LEDGER,
  E_CODE, E_DR, E_CR, E_DR_FLAGS, E_CR_FLAGS, E_DR_ID_ZERO, E_CR_ID_ZERO,
  E_ID_GROUP, E_P_GROUP, E_E_FOUND, E_E_FLAGS, E_E_DR, E_E_CR,
  E_E_AMT_LO, E_E_AMT_HI, E_E_PEND_LO, E_E_PEND_HI, E_E_UD128_LO,
  E_E_UD128_HI, E_E_UD64, E_E_UD32, E_E_TIMEOUT, E_E_CODE, E_P_FOUND,
  E_P_FLAGS, E_P_DR, E_P_CR, E_P_AMT_LO, E_P_AMT_HI, E_P_UD128_LO,
  E_P_UD128_HI, E_P_UD64, E_P_UD32, E_P_TIMEOUT, E_P_LEDGER, E_P_CODE,
  E_P_TIMESTAMP, E_P_TGT,
};

// The carry, as pointers into K3's scratch buffer (u64 words, B = the
// batch's rows; the layout exact_scan.cu documents).  The regions are
// disjoint and none overlaps the table or the events, so every pointer
// is __restrict__: the compiler may move a load above a store to
// another region.
struct Carry {
  uint64_t* __restrict__ created;  // [f * B + i]
  uint64_t* __restrict__ results;
  uint64_t* __restrict__ cmask;
  int64_t* __restrict__ gc;
  uint64_t* __restrict__ inb;
  uint64_t* __restrict__ dstat;
  int64_t* __restrict__ u_dr;
  int64_t* __restrict__ u_cr;
  uint64_t* __restrict__ u_kind;
  int64_t* __restrict__ u_sidx;
  uint64_t* __restrict__ pulse_c;
  uint64_t* __restrict__ pulse_r;
  uint64_t* __restrict__ u_dr_bal;  // [8 * i + c]
  uint64_t* __restrict__ u_cr_bal;
  uint64_t* __restrict__ hist_dr;
  uint64_t* __restrict__ hist_cr;
  uint64_t* __restrict__ scalars;  // chain_start, chain_broken, last_applied
};

constexpr int CARRY_REGIONS = 57;

__host__ __device__ inline Carry carry_of(uint64_t* s, int64_t B) {
  Carry c;
  c.created = s;
  c.results = s + 14 * B;
  c.cmask = s + 15 * B;
  c.gc = (int64_t*)(s + 16 * B);
  c.inb = s + 17 * B;
  c.dstat = s + 18 * B;
  c.u_dr = (int64_t*)(s + 19 * B);
  c.u_cr = (int64_t*)(s + 20 * B);
  c.u_kind = s + 21 * B;
  c.u_sidx = (int64_t*)(s + 22 * B);
  c.pulse_c = s + 23 * B;
  c.pulse_r = s + 24 * B;
  c.u_dr_bal = s + 25 * B;
  c.u_cr_bal = s + 33 * B;
  c.hist_dr = s + 41 * B;
  c.hist_cr = s + 49 * B;
  c.scalars = s + 57 * B;
  return c;
}

__device__ __forceinline__ u128 mk(uint64_t lo, uint64_t hi) {
  return ((u128)hi << 64) | lo;
}
__device__ __forceinline__ int64_t s32(uint64_t w) {
  return (int64_t)(int32_t)(uint32_t)w;
}
__device__ __forceinline__ int64_t clip(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}
__device__ __forceinline__ bool carry_out(u128 a, u128 b) {
  return (u128)(a + b) < a;
}
__device__ __forceinline__ u128 sub_sat(u128 a, u128 b) {
  return a >= b ? a - b : (u128)0;
}
__device__ __forceinline__ u128 umin(u128 a, u128 b) { return a > b ? b : a; }

// reference: src/state_machine.zig:1587-1606 (raw t.amount)
__device__ inline uint32_t exists_normal(const uint64_t* e, const uint64_t* er) {
  if ((uint32_t)e[E_FLAGS] != (uint32_t)er[C_FLAGS]) return EXISTS_DIFF_FLAGS;
  if (s32(e[E_DR]) != (int64_t)er[C_DR]) return EXISTS_DIFF_DR;
  if (s32(e[E_CR]) != (int64_t)er[C_CR]) return EXISTS_DIFF_CR;
  if (e[E_AMT_LO] != er[C_AMT_LO] || e[E_AMT_HI] != er[C_AMT_HI])
    return EXISTS_DIFF_AMOUNT;
  if (e[E_UD128_LO] != er[C_UD128_LO] || e[E_UD128_HI] != er[C_UD128_HI])
    return EXISTS_DIFF_UD128;
  if (e[E_UD64] != er[C_UD64]) return EXISTS_DIFF_UD64;
  if ((uint32_t)e[E_UD32] != (uint32_t)er[C_UD32]) return EXISTS_DIFF_UD32;
  if (e[E_TIMEOUT] != er[C_TIMEOUT]) return EXISTS_DIFF_TIMEOUT;
  if ((uint32_t)e[E_CODE] != (uint32_t)er[C_CODE]) return EXISTS_DIFF_CODE;
  return EXISTS;
}

// reference: src/state_machine.zig:1743-1804 (zero means inherit)
__device__ inline uint32_t exists_post_void(const uint64_t* e, const uint64_t* er,
                                            const uint64_t* pr) {
  if ((uint32_t)e[E_FLAGS] != (uint32_t)er[C_FLAGS]) return EXISTS_DIFF_FLAGS;
  const bool amt_zero = e[E_AMT_LO] == 0 && e[E_AMT_HI] == 0;
  const bool amount_diff =
      amt_zero ? (er[C_AMT_LO] != pr[C_AMT_LO] || er[C_AMT_HI] != pr[C_AMT_HI])
               : (e[E_AMT_LO] != er[C_AMT_LO] || e[E_AMT_HI] != er[C_AMT_HI]);
  if (amount_diff) return EXISTS_DIFF_AMOUNT;
  if (e[E_PEND_LO] != er[C_PEND_LO] || e[E_PEND_HI] != er[C_PEND_HI])
    return EXISTS_DIFF_PENDING_ID;
  const bool ud128_zero = e[E_UD128_LO] == 0 && e[E_UD128_HI] == 0;
  const bool ud128_diff =
      ud128_zero
          ? (er[C_UD128_LO] != pr[C_UD128_LO] || er[C_UD128_HI] != pr[C_UD128_HI])
          : (e[E_UD128_LO] != er[C_UD128_LO] || e[E_UD128_HI] != er[C_UD128_HI]);
  if (ud128_diff) return EXISTS_DIFF_UD128;
  const bool ud64_diff = e[E_UD64] == 0 ? er[C_UD64] != pr[C_UD64]
                                        : e[E_UD64] != er[C_UD64];
  if (ud64_diff) return EXISTS_DIFF_UD64;
  const uint32_t ud32 = (uint32_t)e[E_UD32];
  const bool ud32_diff = ud32 == 0 ? (uint32_t)er[C_UD32] != (uint32_t)pr[C_UD32]
                                   : ud32 != (uint32_t)er[C_UD32];
  if (ud32_diff) return EXISTS_DIFF_UD32;
  return EXISTS;
}

// The durable duplicate's record from the event's e_* columns.
__device__ inline void durable_e(const uint64_t* e, uint64_t* er) {
  er[C_FLAGS] = (uint32_t)e[E_E_FLAGS];
  er[C_DR] = (uint64_t)s32(e[E_E_DR]);
  er[C_CR] = (uint64_t)s32(e[E_E_CR]);
  er[C_AMT_LO] = e[E_E_AMT_LO];
  er[C_AMT_HI] = e[E_E_AMT_HI];
  er[C_PEND_LO] = e[E_E_PEND_LO];
  er[C_PEND_HI] = e[E_E_PEND_HI];
  er[C_UD128_LO] = e[E_E_UD128_LO];
  er[C_UD128_HI] = e[E_E_UD128_HI];
  er[C_UD64] = e[E_E_UD64];
  er[C_UD32] = (uint32_t)e[E_E_UD32];
  er[C_TIMEOUT] = e[E_E_TIMEOUT];
  er[C_LEDGER] = 0;  // not in the exists ladders
  er[C_CODE] = (uint32_t)e[E_E_CODE];
}

// The durable pending's record from the event's p_* columns.
__device__ inline void durable_p(const uint64_t* e, uint64_t* pr) {
  pr[C_FLAGS] = (uint32_t)e[E_P_FLAGS];
  pr[C_DR] = (uint64_t)s32(e[E_P_DR]);
  pr[C_CR] = (uint64_t)s32(e[E_P_CR]);
  pr[C_AMT_LO] = e[E_P_AMT_LO];
  pr[C_AMT_HI] = e[E_P_AMT_HI];
  pr[C_PEND_LO] = 0;  // not read
  pr[C_PEND_HI] = 0;
  pr[C_UD128_LO] = e[E_P_UD128_LO];
  pr[C_UD128_HI] = e[E_P_UD128_HI];
  pr[C_UD64] = e[E_P_UD64];
  pr[C_UD32] = (uint32_t)e[E_P_UD32];
  pr[C_TIMEOUT] = e[E_P_TIMEOUT];
  pr[C_LEDGER] = (uint32_t)e[E_P_LEDGER];
  pr[C_CODE] = (uint32_t)e[E_P_CODE];
}

// The normal create_transfer ladder (reference: src/state_machine.zig:
// 1506-1547) from its event-only inputs: `amount` (the raw amount,
// maxInt(u64) for a balancing zero, reference :1512), the exists code
// `ex` (returned when e_any), ts_overflow (ts_i + timeout wrapped) and
// the accounts' limit flags; the balancing clamps against the current
// debit and credit rows give amount_out.
__device__ inline uint32_t normal_ladder(u128 amount, uint32_t flags, const uint64_t* drr,
                                         const uint64_t* crr, bool e_any, uint32_t ex,
                                         bool ts_overflow, bool dr_limit, bool cr_limit,
                                         u128& amount_out) {
  const u128 dr_dp = mk(drr[0], drr[1]), dr_dpo = mk(drr[2], drr[3]);
  const u128 dr_cpo = mk(drr[6], drr[7]);
  const u128 cr_dpo = mk(crr[2], crr[3]);
  const u128 cr_cp = mk(crr[4], crr[5]), cr_cpo = mk(crr[6], crr[7]);
  bool bd_fail = false, bc_fail = false;
  if (flags & F_BAL_DR) {
    amount = umin(amount, sub_sat(dr_cpo, (u128)(dr_dpo + dr_dp)));
    bd_fail = amount == 0;
  }
  if ((flags & F_BAL_CR) && !bd_fail) {
    amount = umin(amount, sub_sat(cr_dpo, (u128)(cr_cpo + cr_cp)));
    bc_fail = amount == 0;
  }
  const bool is_pending = flags & F_PENDING;
  const u128 dr_total = dr_dp + dr_dpo;
  const u128 cr_total = cr_cp + cr_cpo;
  amount_out = amount;
  if (e_any) return ex;
  if (bd_fail) return EXCEEDS_CREDITS;
  if (bc_fail) return EXCEEDS_DEBITS;
  if (is_pending && carry_out(amount, dr_dp)) return OVERFLOWS_DP;
  if (is_pending && carry_out(amount, cr_cp)) return OVERFLOWS_CP;
  if (carry_out(amount, dr_dpo)) return OVERFLOWS_DPO;
  if (carry_out(amount, cr_cpo)) return OVERFLOWS_CPO;
  if (carry_out(amount, dr_total)) return OVERFLOWS_DEBITS;
  if (carry_out(amount, cr_total)) return OVERFLOWS_CREDITS;
  if (ts_overflow) return OVERFLOWS_TIMEOUT;
  if (dr_limit && (u128)(dr_total + amount) > dr_cpo) return EXCEEDS_CREDITS;
  if (cr_limit && (u128)(cr_total + amount) > cr_dpo) return EXCEEDS_DEBITS;
  return 0;
}

// The normal create_transfer verdict against the current debit and
// credit rows: the event-only inputs of normal_ladder from the event.
// ts_plus is ts_i + timeout in ns (wrapping).
__device__ inline uint32_t normal_verdict(const uint64_t* e, uint32_t flags,
                                          const uint64_t* drr, const uint64_t* crr,
                                          uint64_t ts_i, bool e_any, const uint64_t* er,
                                          u128& amount_out, uint64_t& ts_plus) {
  u128 amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
  if ((flags & (F_BAL_DR | F_BAL_CR)) && amount == 0) amount = U64_MAX;
  ts_plus = ts_i + e[E_TIMEOUT] * NS_PER_S;
  return normal_ladder(amount, flags, drr, crr, e_any, e_any ? exists_normal(e, er) : 0,
                       ts_plus < ts_i, ((uint32_t)e[E_DR_FLAGS] & AF_DR_LIMIT) != 0,
                       ((uint32_t)e[E_CR_FLAGS] & AF_CR_LIMIT) != 0, amount_out);
}

// The post/void checks that read only the event and the pending record
// (reference: src/state_machine.zig:1608-1660), 0 when all pass.
__device__ inline uint32_t pv_prefix(const uint64_t* e, uint32_t flags, const uint64_t* pr,
                                     u128 pv_amount, u128 p_amount) {
  const uint32_t ev_ledger = (uint32_t)e[E_LEDGER];
  const uint32_t ev_code = (uint32_t)e[E_CODE];
  if ((pr[C_FLAGS] & F_PENDING) == 0) return PENDING_NOT_PENDING;
  if (!e[E_DR_ID_ZERO] && s32(e[E_DR]) != (int64_t)pr[C_DR]) return PENDING_DIFF_DR;
  if (!e[E_CR_ID_ZERO] && s32(e[E_CR]) != (int64_t)pr[C_CR]) return PENDING_DIFF_CR;
  if (ev_ledger > 0 && ev_ledger != (uint32_t)pr[C_LEDGER]) return PENDING_DIFF_LEDGER;
  if (ev_code > 0 && ev_code != (uint32_t)pr[C_CODE]) return PENDING_DIFF_CODE;
  if (pv_amount > p_amount) return EXCEEDS_PENDING_AMOUNT;
  if ((flags & F_VOID) && pv_amount < p_amount) return PENDING_DIFF_AMOUNT;
  return 0;
}

// The pending target's status checks (reference: :1662-1686).
__device__ __forceinline__ uint32_t pv_status(uint64_t st) {
  if (st == S_POSTED) return ALREADY_POSTED;
  if (st == S_VOIDED) return ALREADY_VOIDED;
  if (st == S_EXPIRED) return PENDING_EXPIRED;
  return 0;
}

// The post/void verdict before the overdue check (reference:
// src/state_machine.zig:1608-1686); `st` is the target's status.
__device__ inline uint32_t pv_verdict(const uint64_t* e, uint32_t flags, bool p_any,
                                      const uint64_t* pr, u128 pv_amount, u128 p_amount,
                                      bool e_any, const uint64_t* er, uint64_t st) {
  if (!p_any) return PENDING_NOT_FOUND;
  const uint32_t pre = pv_prefix(e, flags, pr, pv_amount, p_amount);
  if (pre != 0) return pre;
  if (e_any) return exists_post_void(e, er, pr);
  return pv_status(st);
}

// The created-transfer record (reference t2 construction:
// src/state_machine.zig:1549-1551,1672-1687).
__device__ inline void build_record(const uint64_t* e, uint32_t flags, bool is_pv,
                                    int64_t up_dr, int64_t up_cr, u128 rec_amount,
                                    const uint64_t* pr, uint64_t* rec) {
  const bool ud128_inherit = is_pv && e[E_UD128_LO] == 0 && e[E_UD128_HI] == 0;
  rec[C_FLAGS] = flags;
  rec[C_DR] = (uint64_t)up_dr;
  rec[C_CR] = (uint64_t)up_cr;
  rec[C_AMT_LO] = (uint64_t)rec_amount;
  rec[C_AMT_HI] = (uint64_t)(rec_amount >> 64);
  rec[C_PEND_LO] = e[E_PEND_LO];
  rec[C_PEND_HI] = e[E_PEND_HI];
  rec[C_UD128_LO] = ud128_inherit ? pr[C_UD128_LO] : e[E_UD128_LO];
  rec[C_UD128_HI] = ud128_inherit ? pr[C_UD128_HI] : e[E_UD128_HI];
  rec[C_UD64] = (is_pv && e[E_UD64] == 0) ? pr[C_UD64] : e[E_UD64];
  rec[C_UD32] = (is_pv && (uint32_t)e[E_UD32] == 0) ? pr[C_UD32] : (uint32_t)e[E_UD32];
  rec[C_TIMEOUT] = is_pv ? 0 : e[E_TIMEOUT];
  rec[C_LEDGER] = is_pv ? pr[C_LEDGER] : (uint32_t)e[E_LEDGER];
  rec[C_CODE] = is_pv ? pr[C_CODE] : (uint32_t)e[E_CODE];
}

// Snapshots of the two rows after the event's own effect (the scan's
// history rows): the debit side moves dp/dpo, the credit side cp/cpo.
__device__ inline void snapshot_rows(const uint64_t* old_dr, const uint64_t* old_cr,
                                     bool is_pv, bool is_post, bool is_pending, u128 amount,
                                     u128 pv_amount, u128 p_amount, uint64_t* new_dr,
                                     uint64_t* new_cr) {
  const u128 o_dr_dp = mk(old_dr[0], old_dr[1]), o_dr_dpo = mk(old_dr[2], old_dr[3]);
  const u128 o_cr_cp = mk(old_cr[4], old_cr[5]), o_cr_cpo = mk(old_cr[6], old_cr[7]);
  u128 n_dr_dp, n_dr_dpo, n_cr_cp, n_cr_cpo;
  if (is_pv) {
    n_dr_dp = o_dr_dp - p_amount;
    n_cr_cp = o_cr_cp - p_amount;
    n_dr_dpo = is_post ? (u128)(o_dr_dpo + pv_amount) : o_dr_dpo;
    n_cr_cpo = is_post ? (u128)(o_cr_cpo + pv_amount) : o_cr_cpo;
  } else if (is_pending) {
    n_dr_dp = o_dr_dp + amount;
    n_dr_dpo = o_dr_dpo;
    n_cr_cp = o_cr_cp + amount;
    n_cr_cpo = o_cr_cpo;
  } else {
    n_dr_dp = o_dr_dp;
    n_dr_dpo = o_dr_dpo + amount;
    n_cr_cp = o_cr_cp;
    n_cr_cpo = o_cr_cpo + amount;
  }
  new_dr[0] = (uint64_t)n_dr_dp;
  new_dr[1] = (uint64_t)(n_dr_dp >> 64);
  new_dr[2] = (uint64_t)n_dr_dpo;
  new_dr[3] = (uint64_t)(n_dr_dpo >> 64);
  new_cr[4] = (uint64_t)n_cr_cp;
  new_cr[5] = (uint64_t)(n_cr_cp >> 64);
  new_cr[6] = (uint64_t)n_cr_cpo;
  new_cr[7] = (uint64_t)(n_cr_cpo >> 64);
  for (int c = 4; c < 8; ++c) new_dr[c] = old_dr[c];
  for (int c = 0; c < 4; ++c) new_cr[c] = old_cr[c];
}

// Exact u128 += and -= on one balance column (lo, hi) that other
// threads update concurrently: a 64-bit atomic add on the low word
// returns the word it saw, so the carry out of each addition is known
// and is added to the high word.  The carries of any order of additions
// sum to the carry out of their total, so the column ends at
// (old + sum) mod 2^128 exactly, in any order; a subtraction adds the
// two's complement.  Correct only while no thread READS the column
// between the first and the last update (the callers' phases).
__device__ __forceinline__ void atomic_add128(uint64_t* cell, u128 v) {
  const uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
  uint64_t up = hi;
  if (lo) {
    const uint64_t old = atomicAdd((unsigned long long*)&cell[0], (unsigned long long)lo);
    up += (old + lo < old) ? 1ull : 0ull;
  }
  if (up) atomicAdd((unsigned long long*)&cell[1], (unsigned long long)up);
}

__device__ __forceinline__ void atomic_sub128(uint64_t* cell, u128 v) {
  atomic_add128(cell, (u128)0 - v);
}

// A row read that bypasses L1 (the phases read what atomics wrote at L2).
__device__ __forceinline__ void load_row_cg(const uint64_t* table, int64_t s, uint64_t* row) {
  const ulonglong2* p = reinterpret_cast<const ulonglong2*>(table + s * 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const ulonglong2 v = __ldcg(p + j);
    row[2 * j] = v.x;
    row[2 * j + 1] = v.y;
  }
}

}  // namespace tbs
