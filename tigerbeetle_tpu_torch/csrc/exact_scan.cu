// K3: the exact sequential create_transfers scan, on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/kernel.py:738 (_run_impl, the
// lax.scan over B events; body make_body :326, carry make_carry :280,
// outputs finalize_outputs :720 and _pack_outputs :779).  Same inputs
// (the 52 EVENT_FIELDS columns, packed by the host as one (B, 52) u64
// matrix in kernel.EVENT_FIELDS order), the same bits out: the table
// updated in place and the (B, 37) u64 output matrix, padding lanes
// included.
//
// What bounds it on the H100: the dependence between events, not
// bandwidth.  Event i reads balance rows, the in-batch id directory and
// pending statuses that events < i wrote, so the walk is serial: n
// dependent steps, each a few loads that hit L2 (the batch's rows and
// its ~3.7 MB of carry fit the 50 MB cache).  The bytes (3.4 MB of
// events in, 2.4 MB of outputs, the touched rows) would take about 3 us
// at 3.35 TB/s.  The design keeps the serial part to one thread doing
// only the body's arithmetic and loads, and gives every parallel part
// (clearing the carry, packing the outputs) to the whole block:
//
//   1. all threads     initialise the carry in the scratch buffer
//   2. thread 0        walks i = 0 .. B-1 through the body; a failed
//                      linked chain is rolled back by the same thread,
//                      replaying [chain_start, i] newest first from the
//                      undo log, then its earlier results become 1
//   3. all threads     write the packed (B, 37) output
//
// u128 values are unsigned __int128; wrap and carry-out follow the
// reference's ops/u128.py helpers (add wraps mod 2^128, a carry out of
// 128 bits is the overflow flag; sub_sat saturates at zero).
//
// Scratch layout (u64 words, B = batch rows), so that a later segment
// launch (the reference's _scan_segment_impl) can resume from it:
//   [f*B + i]           f = 0..13: created record fields in
//                       kernel.CREATED_FIELDS order (slots sign-extended)
//   [14B + i]  results        [15B + i] created_mask
//   [16B + i]  group_creator (int64, -1 none)
//   [17B + i]  inb_status     [18B + i] dstat (durable statuses)
//   [19B + i]  u_dr_slot      [20B + i] u_cr_slot (int64, -1 none)
//   [21B + i]  u_status_kind  [22B + i] u_status_idx (int64)
//   [23B + i]  pulse_create   [24B + i] pulse_remove
//   [25B + 8i + c]  u_dr_bal  [33B + 8i + c] u_cr_bal (undo rows)
//   [41B + 8i + c]  hist_dr   [49B + 8i + c] hist_cr (snapshots)
//   [57B + 0..2]    chain_start, chain_broken, last_applied

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned __int128 u128;

constexpr int NEV = 52;      // packed event columns
constexpr int NOUT = 37;     // packed output columns
constexpr int NCR = 14;      // created-record fields
// 256 threads: the walking thread may use up to 255 registers (a 1024-
// thread bound caps it at 64 and spills the body's live state).
constexpr int THREADS = 256;

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
__device__ uint32_t exists_normal(const uint64_t* e, const uint64_t* er) {
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
__device__ uint32_t exists_post_void(const uint64_t* e, const uint64_t* er,
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

__global__ void __launch_bounds__(THREADS)
exact_scan(uint64_t* __restrict__ table, int64_t A,
           const uint64_t* __restrict__ ev, int B,
           const int32_t* __restrict__ dstat_init, int n, uint64_t ts_base,
           uint64_t* __restrict__ s, uint64_t* __restrict__ out) {
  const int64_t Bn = B;
  uint64_t* created = s;
  uint64_t* results = s + 14 * Bn;
  uint64_t* cmask = s + 15 * Bn;
  int64_t* gc = (int64_t*)(s + 16 * Bn);
  uint64_t* inb = s + 17 * Bn;
  uint64_t* dstat = s + 18 * Bn;
  int64_t* u_dr = (int64_t*)(s + 19 * Bn);
  int64_t* u_cr = (int64_t*)(s + 20 * Bn);
  uint64_t* u_kind = s + 21 * Bn;
  int64_t* u_sidx = (int64_t*)(s + 22 * Bn);
  uint64_t* pulse_c = s + 23 * Bn;
  uint64_t* pulse_r = s + 24 * Bn;
  uint64_t* u_dr_bal = s + 25 * Bn;
  uint64_t* u_cr_bal = s + 33 * Bn;
  uint64_t* hist_dr = s + 41 * Bn;
  uint64_t* hist_cr = s + 49 * Bn;
  uint64_t* scalars = s + 57 * Bn;

  // 1. The initial carry (make_carry).
  for (int region = 0; region < 57; ++region) {
    const uint64_t fill =
        (region == 16 || region == 19 || region == 20) ? U64_MAX : 0;  // -1
    uint64_t* dst = s + region * Bn;
    for (int64_t i = threadIdx.x; i < Bn; i += THREADS)
      dst[i] = region == 18 ? (uint64_t)(uint32_t)dstat_init[i] : fill;
  }
  __syncthreads();

  // 2. The serial walk.
  if (threadIdx.x == 0) {
    const int64_t Bm = Bn - 1, Am = A - 1;
    int64_t chain_start = -1;
    bool chain_broken = false;
    int64_t last_applied = -1;
    for (int64_t k = 0; k < Bn; ++k) {
      const uint64_t* e = ev + k * NEV;
      const int64_t i = s32(e[E_I]);
      const bool in_range = i >= 0 && i < Bn;  // writes at i drop otherwise
      const bool active = i < n;
      const uint32_t flags = (uint32_t)e[E_FLAGS];
      const bool linked = flags & F_LINKED;
      const bool is_pv = flags & (F_POST | F_VOID);
      const uint64_t ts_i = ts_base + (uint64_t)i;

      // Chain bookkeeping (reference: src/state_machine.zig:1240-1248).
      if (active && linked && chain_start < 0) chain_start = i;
      uint32_t pre;
      if (linked && i == n - 1) pre = LINKED_EVENT_CHAIN_OPEN;
      else if (chain_broken) pre = LINKED_EVENT_FAILED;
      else if (e[E_TS_NONZERO]) pre = TIMESTAMP_MUST_BE_ZERO;
      else pre = (uint32_t)e[E_STATIC];

      // Exists resolution via the in-batch id directory.
      const int64_t e_creator = gc[clip(s32(e[E_ID_GROUP]), Bm)];
      const bool e_inb = e_creator >= 0;
      const bool e_any = e_inb || e[E_E_FOUND] != 0;
      uint64_t er[NCR];
      if (e_inb) {
        for (int f = 0; f < NCR; ++f) er[f] = created[f * Bn + e_creator];
      } else {
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

      // ============ normal create_transfer ============
      // (reference: src/state_machine.zig:1506-1547)
      const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
      const uint64_t* drr = table + clip(ev_dr, Am) * 8;
      const uint64_t* crr = table + clip(ev_cr, Am) * 8;
      const u128 dr_dp = mk(drr[0], drr[1]), dr_dpo = mk(drr[2], drr[3]);
      const u128 dr_cpo = mk(drr[6], drr[7]);
      const u128 cr_dp = mk(crr[0], crr[1]), cr_dpo = mk(crr[2], crr[3]);
      const u128 cr_cp = mk(crr[4], crr[5]), cr_cpo = mk(crr[6], crr[7]);
      (void)cr_dp;

      u128 amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
      // amount == 0 with balancing means maxInt(u64)
      // (reference: src/state_machine.zig:1512).
      if ((flags & (F_BAL_DR | F_BAL_CR)) && amount == 0) amount = U64_MAX;
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
      const uint64_t timeout = e[E_TIMEOUT];
      const uint64_t ts_plus = ts_i + timeout * NS_PER_S;

      uint32_t rn;
      if (e_any) rn = exists_normal(e, er);
      else if (bd_fail) rn = EXCEEDS_CREDITS;
      else if (bc_fail) rn = EXCEEDS_DEBITS;
      else if (is_pending && carry_out(amount, dr_dp)) rn = OVERFLOWS_DP;
      else if (is_pending && carry_out(amount, cr_cp)) rn = OVERFLOWS_CP;
      else if (carry_out(amount, dr_dpo)) rn = OVERFLOWS_DPO;
      else if (carry_out(amount, cr_cpo)) rn = OVERFLOWS_CPO;
      else if (carry_out(amount, dr_total)) rn = OVERFLOWS_DEBITS;
      else if (carry_out(amount, cr_total)) rn = OVERFLOWS_CREDITS;
      else if (ts_plus < ts_i) rn = OVERFLOWS_TIMEOUT;
      else if (((uint32_t)e[E_DR_FLAGS] & AF_DR_LIMIT) &&
               (u128)(dr_total + amount) > dr_cpo)
        rn = EXCEEDS_CREDITS;
      else if (((uint32_t)e[E_CR_FLAGS] & AF_CR_LIMIT) &&
               (u128)(cr_total + amount) > cr_dpo)
        rn = EXCEEDS_DEBITS;
      else rn = 0;

      // ============ post/void pending transfer ============
      // (reference: src/state_machine.zig:1608-1741)
      const int64_t pg = s32(e[E_P_GROUP]);
      const int64_t p_creator = gc[clip(pg, Bm)];
      const bool p_dur = e[E_P_FOUND] != 0;
      const bool p_any = p_dur || (pg >= 0 && p_creator >= 0);
      const int64_t pcr = clip(p_creator, Bm);
      uint64_t pr[NCR];
      uint64_t p_timestamp;
      if (p_dur) {
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
        p_timestamp = e[E_P_TIMESTAMP];
      } else {
        for (int f = 0; f < NCR; ++f) pr[f] = created[f * Bn + pcr];
        p_timestamp = ts_base + (uint64_t)pcr;
      }
      const u128 p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
      const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
      const u128 pv_amount = raw_amount != 0 ? raw_amount : p_amount;
      const bool is_post = flags & F_POST;
      const int64_t p_tgt = s32(e[E_P_TGT]);
      const uint64_t st = p_dur ? dstat[clip(p_tgt, Bm)] : inb[pcr];
      const uint32_t ev_ledger = (uint32_t)e[E_LEDGER];
      const uint32_t ev_code = (uint32_t)e[E_CODE];

      uint32_t rp_pre;
      if (!p_any) rp_pre = PENDING_NOT_FOUND;
      else if ((pr[C_FLAGS] & F_PENDING) == 0) rp_pre = PENDING_NOT_PENDING;
      else if (!e[E_DR_ID_ZERO] && ev_dr != (int64_t)pr[C_DR]) rp_pre = PENDING_DIFF_DR;
      else if (!e[E_CR_ID_ZERO] && ev_cr != (int64_t)pr[C_CR]) rp_pre = PENDING_DIFF_CR;
      else if (ev_ledger > 0 && ev_ledger != (uint32_t)pr[C_LEDGER]) rp_pre = PENDING_DIFF_LEDGER;
      else if (ev_code > 0 && ev_code != (uint32_t)pr[C_CODE]) rp_pre = PENDING_DIFF_CODE;
      else if (pv_amount > p_amount) rp_pre = EXCEEDS_PENDING_AMOUNT;
      else if ((flags & F_VOID) && pv_amount < p_amount) rp_pre = PENDING_DIFF_AMOUNT;
      else if (e_any) rp_pre = exists_post_void(e, er, pr);
      else if (st == S_POSTED) rp_pre = ALREADY_POSTED;
      else if (st == S_VOIDED) rp_pre = ALREADY_VOIDED;
      else if (st == S_EXPIRED) rp_pre = PENDING_EXPIRED;
      else rp_pre = 0;
      // QUIRK (reference: src/state_machine.zig:1687-1696): the insert
      // lands before the overdue check, so an overdue post/void is
      // inserted while it returns pending_transfer_expired.
      const uint64_t p_expires = p_timestamp + pr[C_TIMEOUT] * NS_PER_S;
      const bool overdue = pr[C_TIMEOUT] > 0 && p_expires <= ts_i;
      const uint32_t rp = (rp_pre == 0 && overdue) ? PENDING_EXPIRED : rp_pre;

      // ============ merge & apply ============
      const bool gate = active && pre == 0;
      const uint32_t r = gate ? (is_pv ? rp : rn) : (active ? pre : 0);
      const bool pv_inserted = gate && is_pv && rp_pre == 0;
      const bool normal_applied = gate && !is_pv && rn == 0;
      const bool pv_applied = gate && is_pv && rp == 0;
      const bool inserted = pv_inserted || normal_applied;
      const bool applied = pv_applied || normal_applied;

      const int64_t up_dr = is_pv ? (int64_t)pr[C_DR] : ev_dr;
      const int64_t up_cr = is_pv ? (int64_t)pr[C_CR] : ev_cr;
      const int64_t safe_dr = clip(up_dr, Am), safe_cr = clip(up_cr, Am);
      uint64_t old_dr[8], old_cr[8];
      for (int c = 0; c < 8; ++c) {
        old_dr[c] = table[safe_dr * 8 + c];
        old_cr[c] = table[safe_cr * 8 + c];
      }
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
      uint64_t new_dr[8], new_cr[8];
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
      if (applied) {  // the dr row first, then the cr row
        for (int c = 0; c < 8; ++c) table[safe_dr * 8 + c] = new_dr[c];
        for (int c = 0; c < 8; ++c) table[safe_cr * 8 + c] = new_cr[c];
      }

      if (in_range) {
        // Created-transfer record (reference t2 construction:
        // src/state_machine.zig:1549-1551,1672-1687) + id directory.
        if (inserted) {
          const bool ud128_inherit = is_pv && e[E_UD128_LO] == 0 && e[E_UD128_HI] == 0;
          const u128 rec_amount = is_pv ? pv_amount : amount;
          uint64_t rec[NCR];
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
          rec[C_UD32] = (is_pv && (uint32_t)e[E_UD32] == 0) ? pr[C_UD32]
                                                            : (uint32_t)e[E_UD32];
          rec[C_TIMEOUT] = is_pv ? 0 : timeout;
          rec[C_LEDGER] = is_pv ? pr[C_LEDGER] : ev_ledger;
          rec[C_CODE] = is_pv ? pr[C_CODE] : ev_code;
          for (int f = 0; f < NCR; ++f) created[f * Bn + i] = rec[f];
          gc[clip(s32(e[E_ID_GROUP]), Bm)] = i;
        }
        cmask[i] = inserted;
        inb[i] = (normal_applied && is_pending) ? S_PENDING : 0;
      }
      const uint64_t new_status = is_post ? S_POSTED : S_VOIDED;
      if (pv_applied) {
        if (p_dur) dstat[clip(p_tgt, Bm)] = new_status;
        else inb[pcr] = new_status;
      }
      if (in_range) {
        // Undo log (balance restore, creation, status change).
        u_dr[i] = applied ? up_dr : -1;
        u_cr[i] = applied ? up_cr : -1;
        for (int c = 0; c < 8; ++c) {
          u_dr_bal[i * 8 + c] = old_dr[c];
          u_cr_bal[i * 8 + c] = old_cr[c];
          hist_dr[i * 8 + c] = new_dr[c];
          hist_cr[i * 8 + c] = new_cr[c];
        }
        u_kind[i] = pv_applied ? (p_dur ? 1 : 2) : 0;
        u_sidx[i] = p_dur ? p_tgt : p_creator;
        results[i] = r;
      }

      // Chain failure: roll back [chain_start, i] newest first
      // (reference: src/state_machine.zig:1269-1290).
      const bool chain_fail = active && r != 0 && chain_start >= 0 && !chain_broken;
      if (chain_fail) {
        for (int64_t idx = i; idx >= chain_start; --idx) {
          const int64_t ds = u_dr[idx];
          if (ds >= 0) {
            const int64_t scs = clip(u_cr[idx], Am), sds = clip(ds, Am);
            for (int c = 0; c < 8; ++c) table[scs * 8 + c] = u_cr_bal[idx * 8 + c];
            for (int c = 0; c < 8; ++c) table[sds * 8 + c] = u_dr_bal[idx * 8 + c];
          }
          const int64_t g = clip(s32(ev[idx * NEV + E_ID_GROUP]), Bm);
          if (gc[g] == idx) gc[g] = -1;
          cmask[idx] = 0;
          inb[idx] = 0;
          const uint64_t kind = u_kind[idx];
          const int64_t sidx = clip(u_sidx[idx], Bm);
          if (kind == 1) dstat[sidx] = S_PENDING;
          else if (kind == 2) inb[sidx] = S_PENDING;
        }
        for (int64_t j = chain_start; j < i; ++j) results[j] = LINKED_EVENT_FAILED;
        chain_broken = true;
      }

      // Chain close (reference: src/state_machine.zig:1292-1300).
      if (chain_start >= 0 && (!linked || r == LINKED_EVENT_CHAIN_OPEN)) {
        chain_start = -1;
        chain_broken = false;
      }
      if (applied) last_applied = i;
      if (in_range) {
        pulse_c[i] = (normal_applied && is_pending && timeout > 0) ? ts_plus : 0;
        pulse_r[i] = (pv_applied && pr[C_TIMEOUT] > 0) ? p_expires : 0;
      }
    }
    scalars[0] = (uint64_t)chain_start;
    scalars[1] = chain_broken;
    scalars[2] = (uint64_t)last_applied;
  }
  __syncthreads();

  // 3. The packed (B, 37) output (_pack_outputs): one row per thread.
  const uint64_t last_plus_one = scalars[2] + 1;
  for (int64_t i = threadIdx.x; i < Bn; i += THREADS) {
    uint64_t* row = out + i * NOUT;
    row[0] = results[i];
    row[1] = cmask[i];
    for (int f = 0; f < NCR; ++f) row[2 + f] = created[f * Bn + i];
    row[16] = inb[i];
    row[17] = dstat[i];
    row[18] = pulse_c[i];
    row[19] = pulse_r[i];
    row[20] = i == 0 ? last_plus_one : 0;
    for (int c = 0; c < 8; ++c) {
      row[21 + c] = hist_dr[i * 8 + c];
      row[29 + c] = hist_cr[i * 8 + c];
    }
  }
}

// K3's serial floor, measured: one thread follows a random single-cycle
// permutation of u32 indices (sized to sit in L2, not in L1), so every
// load depends on the one before: the time per step is one dependent L2
// hit, the latency each step of the scan walk pays at least once.
__global__ void l2_chase(const uint32_t* __restrict__ next, int64_t steps,
                         uint32_t* __restrict__ sink) {
  uint32_t i = 0;
  for (int64_t k = 0; k < steps; ++k) i = next[i];
  *sink = i;
}

}  // namespace

extern "C" int tb_l2_chase(const void* next, int64_t steps, void* sink,
                           void* stream) {
  l2_chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(next), steps, static_cast<uint32_t*>(sink));
  return (int)cudaGetLastError();
}

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One exact batch: table (A, 8) u64 in place, ev (B, 52) u64, dstat_init
// (B,) int32, scratch of 57 * B + 4 u64 words, out (B, 37) u64.
extern "C" int tb_exact_scan(void* table, int64_t A, const void* ev, int B,
                             const void* dstat_init, int n, uint64_t ts_base,
                             void* scratch, void* out, void* stream) {
  exact_scan<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(dstat_init), n, ts_base,
      static_cast<uint64_t*>(scratch), static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}
