// K7: one wave step — the scan body over K mutually independent events
// at once.
//
// Replaces tigerbeetle_tpu/state_machine/waves.py:1010 (_wave_step_impl,
// with _apply_add_sub :898 and _accum_u128 :983; the speculative
// commit_mask included).  Same inputs (the batch's (B, 52) packed event
// matrix, an int32 list of K global event indices, the carry in K3's
// scratch layout, the (A, 8) table) and the same bits out: the carry
// and the table updated in place.
//
// The lanes are independent by the plan's proof (or, under a commit
// mask, by the on-device validation K9): commuting writers may share a
// balance slot, but no lane reads a slot, an id-directory entry or a
// status that another lane of the wave writes.  So every lane computes
// its verdict against the PRE-WAVE table and carry, as the reference's
// vectorized step does, and then the wave's effects land:
//
//   1. wave_read    one thread per lane: the exists ladders, the
//                   normal and post/void ladders, the balancing clamps
//                   and limit reads, the record, the status change, the
//                   pulses and the lane's own snapshot (the pre-wave
//                   row plus its own effect, R :1301) — into a lane
//                   record; it writes nothing of the carry or the table
//   2. wave_apply   one thread per lane: the balance deltas, summed
//                   exactly mod 2^128 by 64-bit atomics that carry into
//                   the high word (tb_scan.cuh atomic_add128), and every
//                   carry scatter (record, id directory, statuses,
//                   results, snapshots, pulses, last_applied as a max)
//
// The split is the trap the design answers: a lane's snapshot is built
// from the pre-wave row, so no row may move before every lane has read
// it — two launches, the boundary a grid-wide barrier.  A lane that is
// inactive (index >= n, padding, or masked off) writes nothing at all,
// its result slot included, so a conflicted lane replays later against
// this carry exactly as "not yet executed".
//
// What bounds it: bytes.  Per lane the 416-byte event row, two or four
// 64-byte table rows and ~500 bytes of carry read and written, ~1 us at
// 3.35 TB/s for 8192 lanes; the two launches and the atomics' L2 round
// trips cost more than that at this size.

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace {

using namespace tbs;

constexpr int THREADS = 256;

// Lane record (u64 words), written by wave_read, read by wave_apply.
enum {
  L_I,       // global event index; U64_MAX: the lane writes nothing
  L_BITS,    // LB_* below
  L_R,
  L_AMT,     // 2 words: the normal path's (clamped) amount
  L_PV = 5,  // 2 words: the post/void amount
  L_PAMT = 7,  // 2 words: the pending's amount
  L_SDR = 9, L_SCR,  // clipped debit / credit slots of the effect
  L_REC = 11,  // NCR words: the created record
  L_NDR = 25,  // 8 words: debit snapshot
  L_NCR = 33,  // 8 words: credit snapshot
  L_PULSE_C = 41, L_PULSE_R, L_GIDX, L_TGT, L_PCR,
  LW = 48,
};
constexpr uint64_t LB_NORMAL_APPLIED = 1, LB_PV_APPLIED = 2, LB_INSERTED = 4,
                   LB_POST = 8, LB_PENDING = 16, LB_P_DUR = 32;

__global__ void __launch_bounds__(THREADS)
wave_read(const uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev,
          int B, const int32_t* __restrict__ idx, int K, const uint8_t* __restrict__ mask,
          int n, uint64_t ts_base, uint64_t* __restrict__ s, uint64_t* __restrict__ lanes) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  uint64_t* L = lanes + (size_t)k * LW;
  const int64_t Bn = B, Bm = Bn - 1, Am = A - 1;
  const int64_t row = idx[k];
  if (row < 0 || row >= Bn || (mask != nullptr && !mask[k])) {
    L[L_I] = U64_MAX;
    return;
  }
  const uint64_t* e = ev + row * NEV;
  const int64_t i = s32(e[E_I]);
  if (i >= n || i < 0) {  // inactive
    L[L_I] = U64_MAX;
    return;
  }
  const Carry cy = carry_of(s, Bn);
  const uint32_t flags = (uint32_t)e[E_FLAGS];
  const bool is_pv = flags & (F_POST | F_VOID);
  const uint64_t ts_i = ts_base + (uint64_t)i;
  // No chain terms: wave events are never chain members.
  const uint32_t pre = e[E_TS_NONZERO] ? TIMESTAMP_MUST_BE_ZERO : (uint32_t)e[E_STATIC];

  const int64_t e_creator = cy.gc[clip(s32(e[E_ID_GROUP]), Bm)];
  const bool e_inb = e_creator >= 0;
  const bool e_any = e_inb || e[E_E_FOUND] != 0;
  uint64_t er[NCR];
  if (e_inb) {
    for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
  } else {
    durable_e(e, er);
  }

  const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
  uint64_t drr[8], crr[8];
  load_row_cg(table, clip(ev_dr, Am), drr);
  load_row_cg(table, clip(ev_cr, Am), crr);
  u128 amount;
  uint64_t ts_plus;
  const uint32_t rn = normal_verdict(e, flags, drr, crr, ts_i, e_any, er, amount, ts_plus);
  const bool is_pending = flags & F_PENDING;

  const int64_t pg = s32(e[E_P_GROUP]);
  const int64_t p_creator = cy.gc[clip(pg, Bm)];
  const bool p_dur = e[E_P_FOUND] != 0;
  const bool p_any = p_dur || (pg >= 0 && p_creator >= 0);
  const int64_t pcr = clip(p_creator, Bm);
  uint64_t pr[NCR];
  uint64_t p_timestamp;
  if (p_dur) {
    durable_p(e, pr);
    p_timestamp = e[E_P_TIMESTAMP];
  } else {
    for (int f = 0; f < NCR; ++f) pr[f] = cy.created[f * Bn + pcr];
    p_timestamp = ts_base + (uint64_t)pcr;
  }
  const u128 p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
  const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
  const u128 pv_amount = raw_amount != 0 ? raw_amount : p_amount;
  const bool is_post = flags & F_POST;
  const int64_t tgt = clip(s32(e[E_P_TGT]), Bm);
  const uint64_t st = p_dur ? cy.dstat[tgt] : cy.inb[pcr];
  const uint32_t rp_pre = pv_verdict(e, flags, p_any, pr, pv_amount, p_amount, e_any, er, st);
  const uint64_t p_expires = p_timestamp + pr[C_TIMEOUT] * NS_PER_S;
  const bool overdue = pr[C_TIMEOUT] > 0 && p_expires <= ts_i;
  const uint32_t rp = (rp_pre == 0 && overdue) ? PENDING_EXPIRED : rp_pre;

  const bool gate = pre == 0;
  const uint32_t r = gate ? (is_pv ? rp : rn) : pre;
  const bool pv_inserted = gate && is_pv && rp_pre == 0;
  const bool normal_applied = gate && !is_pv && rn == 0;
  const bool pv_applied = gate && is_pv && rp == 0;
  const bool inserted = pv_inserted || normal_applied;

  const int64_t up_dr = is_pv ? (int64_t)pr[C_DR] : ev_dr;
  const int64_t up_cr = is_pv ? (int64_t)pr[C_CR] : ev_cr;
  const int64_t safe_dr = clip(up_dr, Am), safe_cr = clip(up_cr, Am);
  uint64_t old_dr[8], old_cr[8];
  load_row_cg(table, safe_dr, old_dr);
  load_row_cg(table, safe_cr, old_cr);

  L[L_I] = (uint64_t)i;
  L[L_BITS] = (normal_applied ? LB_NORMAL_APPLIED : 0) | (pv_applied ? LB_PV_APPLIED : 0) |
              (inserted ? LB_INSERTED : 0) | (is_post ? LB_POST : 0) |
              (is_pending ? LB_PENDING : 0) | (p_dur ? LB_P_DUR : 0);
  L[L_R] = r;
  L[L_AMT] = (uint64_t)amount;
  L[L_AMT + 1] = (uint64_t)(amount >> 64);
  L[L_PV] = (uint64_t)pv_amount;
  L[L_PV + 1] = (uint64_t)(pv_amount >> 64);
  L[L_PAMT] = (uint64_t)p_amount;
  L[L_PAMT + 1] = (uint64_t)(p_amount >> 64);
  L[L_SDR] = (uint64_t)safe_dr;
  L[L_SCR] = (uint64_t)safe_cr;
  build_record(e, flags, is_pv, up_dr, up_cr, is_pv ? pv_amount : amount, pr, L + L_REC);
  snapshot_rows(old_dr, old_cr, is_pv, is_post, is_pending, amount, pv_amount, p_amount,
                L + L_NDR, L + L_NCR);
  L[L_PULSE_C] = (normal_applied && is_pending && e[E_TIMEOUT] > 0) ? ts_plus : 0;
  L[L_PULSE_R] = (pv_applied && pr[C_TIMEOUT] > 0) ? p_expires : 0;
  L[L_GIDX] = (uint64_t)clip(s32(e[E_ID_GROUP]), Bm);
  L[L_TGT] = (uint64_t)tgt;
  L[L_PCR] = (uint64_t)pcr;
}

__global__ void __launch_bounds__(THREADS)
wave_apply(uint64_t* __restrict__ table, int B, int K, uint64_t* __restrict__ s,
           const uint64_t* __restrict__ lanes) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const uint64_t* L = lanes + (size_t)k * LW;
  if (L[L_I] == U64_MAX) return;
  const int64_t Bn = B;
  const Carry cy = carry_of(s, Bn);
  const int64_t i = (int64_t)L[L_I];
  const uint64_t bits = L[L_BITS];
  const bool normal_applied = bits & LB_NORMAL_APPLIED;
  const bool pv_applied = bits & LB_PV_APPLIED;
  const bool inserted = bits & LB_INSERTED;
  const bool is_post = bits & LB_POST;
  const bool is_pending = bits & LB_PENDING;
  uint64_t* drow = table + (int64_t)L[L_SDR] * 8;
  uint64_t* crow = table + (int64_t)L[L_SCR] * 8;

  // Balance effects (columns: 0 dp, 1 dpo, 2 cp, 3 cpo; two words each).
  if (normal_applied) {
    const u128 amount = mk(L[L_AMT], L[L_AMT + 1]);
    atomic_add128(drow + (is_pending ? 0 : 2), amount);
    atomic_add128(crow + (is_pending ? 4 : 6), amount);
  }
  if (pv_applied) {
    const u128 pv_amount = mk(L[L_PV], L[L_PV + 1]);
    const u128 p_amount = mk(L[L_PAMT], L[L_PAMT + 1]);
    if (is_post) {
      atomic_add128(drow + 2, pv_amount);
      atomic_add128(crow + 6, pv_amount);
    }
    atomic_sub128(drow + 0, p_amount);
    atomic_sub128(crow + 4, p_amount);
  }

  // Carry scatters at the lane's own index, then the cross-index ones.
  if (inserted) {
    for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = L[L_REC + f];
    cy.gc[L[L_GIDX]] = i;
  }
  cy.cmask[i] = inserted;
  cy.inb[i] = (normal_applied && is_pending) ? S_PENDING : 0;
  for (int c = 0; c < 8; ++c) {
    cy.hist_dr[i * 8 + c] = L[L_NDR + c];
    cy.hist_cr[i * 8 + c] = L[L_NCR + c];
  }
  cy.results[i] = L[L_R];
  cy.pulse_c[i] = L[L_PULSE_C];
  cy.pulse_r[i] = L[L_PULSE_R];
  if (pv_applied) {
    const uint64_t new_status = is_post ? S_POSTED : S_VOIDED;
    if (bits & LB_P_DUR) cy.dstat[L[L_TGT]] = new_status;
    else cy.inb[L[L_PCR]] = new_status;
  }
  if (normal_applied || pv_applied)
    atomicMax(reinterpret_cast<long long*>(cy.scalars + 2), (long long)i);
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lane-record words per lane (the caller's `lanes` holds K of them).
extern "C" int64_t tb_wave_step_lane_words() { return LW; }

// One wave: table (A, 8) u64 and the carry (57 * B + 4 u64 words) in
// place; ev (B, 52) u64; idx (K,) int32 global event indices; mask
// (K,) u8 or null (the speculative commit mask).
extern "C" int tb_wave_step(void* table, int64_t A, const void* ev, int B, const void* idx,
                            int K, const void* mask, int n, uint64_t ts_base, void* scratch,
                            void* lanes, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (K + THREADS - 1) / THREADS;
  wave_read<<<blocks, THREADS, 0, st>>>(
      static_cast<const uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(idx), K, static_cast<const uint8_t*>(mask), n, ts_base,
      static_cast<uint64_t*>(scratch), static_cast<uint64_t*>(lanes));
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wave_apply<<<blocks, THREADS, 0, st>>>(
      static_cast<uint64_t*>(table), B, K, static_cast<uint64_t*>(scratch),
      static_cast<const uint64_t*>(lanes));
  return (int)cudaGetLastError();
}
