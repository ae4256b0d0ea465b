// Probes of the two serial kernels' floors and time (measurements, not
// kernels of the port; tools/serial_probes.py builds and drives them).
//
//   tb_cluster_sync_probe  `iters` cluster.sync() in one cluster of
//                          `blocks` blocks: the barrier K8 runs between
//                          its read and apply phases
//   tb_grid_sync_probe     `iters` grid.sync() over `blocks` blocks of a
//                          cooperative launch: the alternative barrier
//   tb_max_active_clusters how many clusters of `blocks` blocks of
//                          `threads` threads the card can hold at once
//   tb_walk_split          K3's serial walk as it was before its redesign
//                          (one thread, both verdicts for every event, the
//                          table rows read twice, every event word loaded
//                          on demand), with clock64() stamps between its
//                          stages: cycles per stage summed over the walk
//   tb_walk_split_new      the walk of exact_scan.cu (a producer warp
//                          staging events, the walker fetching each
//                          event's state during the one before), stamped
//                          the same way: its walker's stages, and the
//                          events of each class
//
// A stage's stamp is ordered after the stage's loads by a volatile
// shared-memory store of a value that depends on them, so a stage
// holds the latency of its own loads; the stamps add their own cycles
// (a clock read and a shared store each), which the caller sees as the
// difference between the stamped total and the walk's plain time.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../csrc/tb_scan.cuh"
#include "../csrc/tb_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tbs;

__global__ void cluster_sync_loop(int iters, unsigned* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int k = 0; k < iters; ++k) cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = (unsigned)iters;
}

__global__ void grid_sync_loop(int iters, unsigned* sink) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < iters; ++k) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *sink = (unsigned)iters;
}

enum {
  ST_EVENT,      // the event words the body needs first
  ST_DIR,        // id directory + the exists record (created or durable)
  ST_ROWS,       // the debit and credit rows at the event's slots
  ST_NORMAL,     // normal_verdict
  ST_PV_LOOKUP,  // pending directory, its record and status
  ST_PV_VERDICT, // pv_verdict and the overdue check
  ST_REREAD,     // the rows at the update slots, read again
  ST_STORES,     // table, record, directory, undo, history, result, rollback, pulses
  NSTAGE,
};

__device__ __forceinline__ void order_after(volatile uint64_t* sink, uint64_t v) { *sink = v; }

#define STAMP(stage, dep)                   \
  do {                                      \
    order_after(stamp_sink, (dep));         \
    const long long t1 = clock64();         \
    cyc[stage] += (uint64_t)(t1 - t0);      \
    t0 = t1;                                \
  } while (0)

// The walk of exact_scan.cu before its redesign, stamped (one warp, as
// its segment entry launched it).
__global__ void __launch_bounds__(32) walk_split(uint64_t* __restrict__ table, int64_t A,
                           const uint64_t* __restrict__ ev, int64_t Bn,
                           const int32_t* __restrict__ rows, int64_t L, int n,
                           uint64_t ts_base, uint64_t* s, unsigned long long* out) {
  __shared__ uint64_t stamp_word;
  if (threadIdx.x != 0) return;
  volatile uint64_t* stamp_sink = &stamp_word;
  const Carry cy = carry_of(s, Bn);
  uint64_t cyc[NSTAGE] = {};
  const int64_t Bm = Bn - 1, Am = A - 1;
  int64_t chain_start = (int64_t)cy.scalars[0];
  bool chain_broken = cy.scalars[1] != 0;
  int64_t last_applied = (int64_t)cy.scalars[2];
  const long long start = clock64();
  long long t0 = start;
  for (int64_t k = 0; k < L; ++k) {
    int64_t row = rows[k];
    if (row < 0 || row >= Bn) continue;
    const uint64_t* e = ev + row * NEV;
    const int64_t i = s32(e[E_I]);
    const bool in_range = i >= 0 && i < Bn;
    const bool active = i < n;
    const uint32_t flags = (uint32_t)e[E_FLAGS];
    const bool linked = flags & F_LINKED;
    const bool is_pv = flags & (F_POST | F_VOID);
    const uint64_t ts_i = ts_base + (uint64_t)i;
    if (active && linked && chain_start < 0) chain_start = i;
    uint32_t pre;
    if (linked && i == n - 1) pre = LINKED_EVENT_CHAIN_OPEN;
    else if (chain_broken) pre = LINKED_EVENT_FAILED;
    else if (e[E_TS_NONZERO]) pre = TIMESTAMP_MUST_BE_ZERO;
    else pre = (uint32_t)e[E_STATIC];
    STAMP(ST_EVENT, pre + (uint64_t)i + e[E_ID_GROUP]);

    const int64_t e_creator = cy.gc[clip(s32(e[E_ID_GROUP]), Bm)];
    const bool e_inb = e_creator >= 0;
    const bool e_any = e_inb || e[E_E_FOUND] != 0;
    uint64_t er[NCR];
    if (e_inb) {
      for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
    } else {
      durable_e(e, er);
    }
    STAMP(ST_DIR, er[0] ^ er[NCR - 1] ^ (uint64_t)e_any);

    const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
    uint64_t drr[8], crr[8];
    for (int c = 0; c < 8; ++c) {
      drr[c] = table[clip(ev_dr, Am) * 8 + c];
      crr[c] = table[clip(ev_cr, Am) * 8 + c];
    }
    STAMP(ST_ROWS, drr[0] ^ drr[7] ^ crr[0] ^ crr[7]);

    u128 amount;
    uint64_t ts_plus;
    const uint32_t rn = normal_verdict(e, flags, drr, crr, ts_i, e_any, er, amount, ts_plus);
    const bool is_pending = flags & F_PENDING;
    const uint64_t timeout = e[E_TIMEOUT];
    STAMP(ST_NORMAL, rn + (uint64_t)amount + ts_plus);

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
    const int64_t p_tgt = s32(e[E_P_TGT]);
    const uint64_t st = p_dur ? cy.dstat[clip(p_tgt, Bm)] : cy.inb[pcr];
    STAMP(ST_PV_LOOKUP, pr[0] ^ pr[NCR - 1] ^ st ^ p_timestamp);

    const u128 p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
    const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
    const u128 pv_amount = raw_amount != 0 ? raw_amount : p_amount;
    const bool is_post = flags & F_POST;
    const uint32_t rp_pre = pv_verdict(e, flags, p_any, pr, pv_amount, p_amount, e_any, er, st);
    const uint64_t p_expires = p_timestamp + pr[C_TIMEOUT] * NS_PER_S;
    const bool overdue = pr[C_TIMEOUT] > 0 && p_expires <= ts_i;
    const uint32_t rp = (rp_pre == 0 && overdue) ? PENDING_EXPIRED : rp_pre;
    STAMP(ST_PV_VERDICT, rp + p_expires);

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
    STAMP(ST_REREAD, old_dr[0] ^ old_dr[7] ^ old_cr[0] ^ old_cr[7]);

    uint64_t new_dr[8], new_cr[8];
    snapshot_rows(old_dr, old_cr, is_pv, is_post, is_pending, amount, pv_amount, p_amount,
                  new_dr, new_cr);
    if (applied) {
      for (int c = 0; c < 8; ++c) table[safe_dr * 8 + c] = new_dr[c];
      for (int c = 0; c < 8; ++c) table[safe_cr * 8 + c] = new_cr[c];
    }
    if (in_range) {
      if (inserted) {
        uint64_t rec[NCR];
        build_record(e, flags, is_pv, up_dr, up_cr, is_pv ? pv_amount : amount, pr, rec);
        for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = rec[f];
        cy.gc[clip(s32(e[E_ID_GROUP]), Bm)] = i;
      }
      cy.cmask[i] = inserted;
      cy.inb[i] = (normal_applied && is_pending) ? S_PENDING : 0;
    }
    const uint64_t new_status = is_post ? S_POSTED : S_VOIDED;
    if (pv_applied) {
      if (p_dur) cy.dstat[clip(p_tgt, Bm)] = new_status;
      else cy.inb[pcr] = new_status;
    }
    if (in_range) {
      cy.u_dr[i] = applied ? up_dr : -1;
      cy.u_cr[i] = applied ? up_cr : -1;
      for (int c = 0; c < 8; ++c) {
        cy.u_dr_bal[i * 8 + c] = old_dr[c];
        cy.u_cr_bal[i * 8 + c] = old_cr[c];
        cy.hist_dr[i * 8 + c] = new_dr[c];
        cy.hist_cr[i * 8 + c] = new_cr[c];
      }
      cy.u_kind[i] = pv_applied ? (p_dur ? 1 : 2) : 0;
      cy.u_sidx[i] = p_dur ? p_tgt : p_creator;
      cy.results[i] = r;
    }
    const bool chain_fail = active && r != 0 && chain_start >= 0 && !chain_broken;
    if (chain_fail) {
      for (int64_t idx = i; idx >= chain_start; --idx) {
        const int64_t ds = cy.u_dr[idx];
        if (ds >= 0) {
          const int64_t scs = clip(cy.u_cr[idx], Am), sds = clip(ds, Am);
          for (int c = 0; c < 8; ++c) table[scs * 8 + c] = cy.u_cr_bal[idx * 8 + c];
          for (int c = 0; c < 8; ++c) table[sds * 8 + c] = cy.u_dr_bal[idx * 8 + c];
        }
        const int64_t g = clip(s32(ev[idx * NEV + E_ID_GROUP]), Bm);
        if (cy.gc[g] == idx) cy.gc[g] = -1;
        cy.cmask[idx] = 0;
        cy.inb[idx] = 0;
        const uint64_t kind = cy.u_kind[idx];
        const int64_t sidx = clip(cy.u_sidx[idx], Bm);
        if (kind == 1) cy.dstat[sidx] = S_PENDING;
        else if (kind == 2) cy.inb[sidx] = S_PENDING;
      }
      for (int64_t j = chain_start; j < i; ++j) cy.results[j] = LINKED_EVENT_FAILED;
      chain_broken = true;
    }
    if (chain_start >= 0 && (!linked || r == LINKED_EVENT_CHAIN_OPEN)) {
      chain_start = -1;
      chain_broken = false;
    }
    if (applied) last_applied = i;
    if (in_range) {
      cy.pulse_c[i] = (normal_applied && is_pending && timeout > 0) ? ts_plus : 0;
      cy.pulse_r[i] = (pv_applied && pr[C_TIMEOUT] > 0) ? p_expires : 0;
    }
    STAMP(ST_STORES, (uint64_t)chain_start + (uint64_t)last_applied);
  }
  cy.scalars[0] = (uint64_t)chain_start;
  cy.scalars[1] = chain_broken;
  cy.scalars[2] = (uint64_t)last_applied;
  for (int k = 0; k < NSTAGE; ++k) out[k] = cyc[k];
  out[NSTAGE] = (unsigned long long)(clock64() - start);
}

enum {
  S2_HEAD,     // the plan's first piece read (after the event before: its stores drained)
  S2_FETCH,    // this event's state fetched now (not during the event before)
  S2_AHEAD,    // the next event's fetch issued
  S2_PLAN,     // the rest of the plan read, this event's state at hand
  S2_VERDICT,  // the class's ladder (and an in-batch pending's lookups)
  S2_RECORD,   // the created record, the snapshots
  S2_STORES,   // table, directory, mask, status, undo and history rows, result
  S2_CHAIN,    // rollback, chain close, pulses
  S2_NEXT,     // the next event's state patched and at hand
  NSTAGE2,
};

// exact_scan.cu's walk_chunk, stamped.
__device__ void walk_chunk_split(uint64_t* __restrict__ table, int64_t A,
                                 const uint64_t* __restrict__ ev, int64_t Bn, int n,
                                 uint64_t ts_base, const Carry& cy, const Ring& ring, int slot,
                                 int cnt, WalkState& ws, uint64_t* cyc, long long& t0,
                                 volatile uint64_t* stamp_sink) {
  const int64_t Bm = Bn - 1, Am = A - 1;
  Ahead cur, nxt;
  bool have = false;  // cur holds this event's state, fetched ahead
  for (int j = 0; j < cnt; ++j) {
    const Plan& pl = ring.plan[slot][j];
    const int4 hdr = pl.hdr;
    const uint32_t bits = (uint32_t)hdr.z;
    if (!(bits & PL_OK)) {
      have = false;
      continue;
    }
    STAMP(S2_HEAD, (uint64_t)bits);
    if (!have) {
      fetch(pl, table, cy, Am, Bm, cur);
      STAMP(S2_FETCH, (uint64_t)cur.gce + (uint64_t)cur.gcp + cur.dst + cur.dr[0] + cur.cr[7]);
    }
    const bool ahead = j + 1 < cnt && ((uint32_t)ring.plan[slot][j + 1].hdr.z & PL_OK);
    if (ahead) fetch(ring.plan[slot][j + 1], table, cy, Am, Bm, nxt);
    STAMP(S2_AHEAD, (uint64_t)ahead);

    const int4 codes = pl.codes, slots = pl.slots;
    const uint64_t* e = ring.ev[slot][j];
    const int64_t i = hdr.x;
    const bool in_range = i >= 0 && i < Bn;  // writes at i drop otherwise
    const bool active = i < n;
    const uint32_t flags = (uint32_t)hdr.y;
    const bool linked = bits & PL_LINKED;
    const bool is_pending = bits & PL_PENDING;
    const bool p_dur = bits & PL_P_DUR;
    const int64_t p_tgt = slots.x;
    cyc[NSTAGE2 + (!(bits & PL_PV) ? 0 : p_dur ? 1 : 2)] += 1;

    // Chain bookkeeping (reference: src/state_machine.zig:1240-1248).
    if (active && linked && ws.chain_start < 0) ws.chain_start = i;
    const uint32_t pre = (bits & PL_OPEN) ? LINKED_EVENT_CHAIN_OPEN
                         : ws.chain_broken ? LINKED_EVENT_FAILED
                                           : (uint32_t)hdr.w;
    const bool gate = active && pre == 0;
    // Exists resolution via the in-batch id directory.
    const int64_t e_creator = cur.gce, p_creator = cur.gcp;
    const bool e_inb = e_creator >= 0;
    const bool e_any = e_inb || (bits & PL_E_FOUND);
    const int64_t pcr = clip(p_creator, Bm);
    STAMP(S2_PLAN, (uint64_t)e_creator + (uint64_t)p_creator + cur.dr[0] + cur.cr[7] + cur.dst + pre);

    uint32_t r;
    bool inserted, applied, normal_applied = false, pv_applied = false;
    int64_t up_dr, up_cr;
    uint64_t new_dr[8], new_cr[8];
    uint64_t pulse_c = 0, pulse_r = 0;
    if (!(bits & PL_PV)) {
      // ============ normal create_transfer ============
      uint32_t ex = (uint32_t)codes.x;
      if (e_inb) {
        uint64_t er[NCR];
        for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
        ex = exists_normal(e, er);
      }
      u128 amount;
      const uint32_t rn =
          normal_ladder(mk(pl.amt.x, pl.amt.y), flags, cur.dr, cur.cr, e_any, ex,
                        bits & PL_TS_OVF, bits & PL_DR_LIMIT, bits & PL_CR_LIMIT, amount);
      r = gate ? rn : (active ? pre : 0);
      STAMP(S2_VERDICT, r + (uint64_t)amount);
      normal_applied = gate && rn == 0;
      inserted = applied = normal_applied;
      up_dr = slots.y;
      up_cr = slots.z;
      snapshot_rows(cur.dr, cur.cr, false, false, is_pending, amount, 0, 0, new_dr, new_cr);
      if (in_range && inserted) {
        for (int f = 0; f < NCR; ++f)
          cy.created[f * Bn + i] = f == C_AMT_LO   ? (uint64_t)amount
                                   : f == C_AMT_HI ? (uint64_t)(amount >> 64)
                                                   : pl.rec[f];
      }
      pulse_c = (normal_applied && is_pending && (bits & PL_TIMEOUT)) ? pl.t.x : 0;
      STAMP(S2_RECORD, new_dr[0] ^ new_cr[7]);
    } else {
      // ============ post/void pending transfer ============
      // (reference: src/state_machine.zig:1608-1741)
      u128 pv_amount, p_amount;
      uint32_t rp_pre;
      uint64_t p_expires;
      bool overdue, p_timeout;
      if (p_dur) {
        pv_amount = mk(pl.amt.x, pl.amt.y);
        p_amount = mk(pl.pam.x, pl.pam.y);
        rp_pre = (uint32_t)codes.y;
        if (rp_pre == 0) {
          if (e_inb) {
            uint64_t er[NCR], pr[NCR];
            for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
            durable_p(e, pr);
            rp_pre = exists_post_void(e, er, pr);
          } else {
            rp_pre = e_any ? (uint32_t)codes.x : pv_status(cur.dst);
          }
        }
        p_expires = pl.t.x;
        p_timeout = bits & PL_TIMEOUT;
        overdue = bits & PL_OVERDUE;
        up_dr = slots.y;
        up_cr = slots.z;
        inserted = gate && rp_pre == 0;
        if (in_range && inserted)
          for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = pl.rec[f];
      } else {
        const bool p_any = (bits & PL_P_GROUP) && p_creator >= 0;
        uint64_t pr[NCR], er[NCR];
        for (int f = 0; f < NCR; ++f) pr[f] = cy.created[f * Bn + pcr];
        const uint64_t st = cy.inb[pcr];
        if (e_inb) {
          for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
        } else {
          durable_e(e, er);
        }
        p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
        const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
        pv_amount = raw_amount != 0 ? raw_amount : p_amount;
        rp_pre = pv_verdict(e, flags, p_any, pr, pv_amount, p_amount, e_any, er, st);
        p_timeout = pr[C_TIMEOUT] > 0;
        p_expires = ts_base + (uint64_t)pcr + pr[C_TIMEOUT] * NS_PER_S;
        overdue = p_timeout && p_expires <= ts_base + (uint64_t)i;
        up_dr = (int64_t)pr[C_DR];
        up_cr = (int64_t)pr[C_CR];
        load_row(table + clip(up_dr, Am) * 8, cur.dr);
        load_row(table + clip(up_cr, Am) * 8, cur.cr);
        inserted = gate && rp_pre == 0;
        if (in_range && inserted) {
          uint64_t rec[NCR];
          build_record(e, flags, true, up_dr, up_cr, pv_amount, pr, rec);
          for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = rec[f];
        }
      }
      const uint32_t rp = (rp_pre == 0 && overdue) ? PENDING_EXPIRED : rp_pre;
      r = gate ? rp : (active ? pre : 0);
      STAMP(S2_VERDICT, r + cur.dr[0] + cur.cr[7]);
      pv_applied = applied = gate && rp == 0;
      snapshot_rows(cur.dr, cur.cr, true, bits & PL_POST, is_pending, 0, pv_amount, p_amount,
                    new_dr, new_cr);
      pulse_r = (pv_applied && p_timeout) ? p_expires : 0;
      STAMP(S2_RECORD, new_dr[0] ^ new_cr[7]);
    }

    // ============ apply ============
    const int64_t safe_dr = clip(up_dr, Am), safe_cr = clip(up_cr, Am);
    if (applied) {  // the dr row first, then the cr row
      store_row(table + safe_dr * 8, new_dr);
      store_row(table + safe_cr * 8, new_cr);
    }
    if (in_range) {
      if (inserted) cy.gc[codes.z] = i;
      cy.cmask[i] = inserted;
      cy.inb[i] = (normal_applied && is_pending) ? S_PENDING : 0;
    }
    const uint64_t new_status = (bits & PL_POST) ? S_POSTED : S_VOIDED;
    if (pv_applied) {
      if (p_dur) cy.dstat[clip(p_tgt, Bm)] = new_status;
      else cy.inb[pcr] = new_status;
    }
    if (in_range) {
      // Undo log (balance restore, creation, status change).
      cy.u_dr[i] = applied ? up_dr : -1;
      cy.u_cr[i] = applied ? up_cr : -1;
      store_row(cy.u_dr_bal + i * 8, cur.dr);
      store_row(cy.u_cr_bal + i * 8, cur.cr);
      store_row(cy.hist_dr + i * 8, new_dr);
      store_row(cy.hist_cr + i * 8, new_cr);
      cy.u_kind[i] = pv_applied ? (p_dur ? 1 : 2) : 0;
      cy.u_sidx[i] = p_dur ? p_tgt : p_creator;
      cy.results[i] = r;
      cy.pulse_c[i] = pulse_c;
      cy.pulse_r[i] = pulse_r;
    }

    STAMP(S2_STORES, (uint64_t)r);
    // Chain failure: roll back [chain_start, i] newest first
    // (reference: src/state_machine.zig:1269-1290).
    const bool chain_fail = active && r != 0 && ws.chain_start >= 0 && !ws.chain_broken;
    if (chain_fail) {
      cyc[NSTAGE2 + 3] += 1;
      for (int64_t idx = i; idx >= ws.chain_start; --idx) {
        const int64_t ds = cy.u_dr[idx];
        if (ds >= 0) {
          uint64_t saved[8];
          load_row(cy.u_cr_bal + idx * 8, saved);
          store_row(table + clip(cy.u_cr[idx], Am) * 8, saved);
          load_row(cy.u_dr_bal + idx * 8, saved);
          store_row(table + clip(ds, Am) * 8, saved);
        }
        const int64_t g = clip(s32(ev[idx * NEV + E_ID_GROUP]), Bm);
        if (cy.gc[g] == idx) cy.gc[g] = -1;
        cy.cmask[idx] = 0;
        cy.inb[idx] = 0;
        const uint64_t kind = cy.u_kind[idx];
        const int64_t sidx = clip(cy.u_sidx[idx], Bm);
        if (kind == 1) cy.dstat[sidx] = S_PENDING;
        else if (kind == 2) cy.inb[sidx] = S_PENDING;
      }
      for (int64_t k = ws.chain_start; k < i; ++k) cy.results[k] = LINKED_EVENT_FAILED;
      ws.chain_broken = true;
    }

    // Chain close (reference: src/state_machine.zig:1292-1300).
    if (ws.chain_start >= 0 && (!linked || r == LINKED_EVENT_CHAIN_OPEN)) {
      ws.chain_start = -1;
      ws.chain_broken = false;
    }
    if (applied) ws.last_applied = i;

    STAMP(S2_CHAIN, (uint64_t)ws.chain_start + (uint64_t)ws.last_applied);
    // The next event's state, fetched above, patched with this event's
    // writes (a rollback rewrote too much: fetch again).
    have = ahead && !chain_fail;
    if (have) {
      const Plan& pn = ring.plan[slot][j + 1];
      const int4 ncodes = pn.codes, nslots = pn.slots;
      if (applied && ((uint32_t)pn.hdr.z & PL_ROWS)) {
        const int64_t nd = clip(nslots.y, Am), nc = clip(nslots.z, Am);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          nxt.dr[k] = nd == safe_cr ? new_cr[k] : nd == safe_dr ? new_dr[k] : nxt.dr[k];
          nxt.cr[k] = nc == safe_cr ? new_cr[k] : nc == safe_dr ? new_dr[k] : nxt.cr[k];
        }
      }
      if (in_range && inserted) {
        if (ncodes.z == codes.z) nxt.gce = i;
        if (ncodes.w == codes.z) nxt.gcp = i;
      }
      if (pv_applied && p_dur && clip(nslots.x, Bm) == clip(p_tgt, Bm)) nxt.dst = new_status;
      cur = nxt;
    }
    STAMP(S2_NEXT, (uint64_t)cur.gce + cur.dr[0] + cur.cr[7]);
  }
}

// exact_scan.cu's walk, with the stamped walker: out gets NSTAGE2
// stage cycles, the walker's whole cycles, the events of each class
// (normal, durable post/void, in-batch post/void) and the rollbacks.
__global__ void __launch_bounds__(64)
walk_split_new(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev,
               int64_t Bn, const int32_t* __restrict__ rows, int64_t L, int n, uint64_t ts_base,
               uint64_t* s, unsigned long long* out) {
  __shared__ Ring ring;
  __shared__ uint64_t stamp_word;
  const Carry cy = carry_of(s, Bn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunks = (L + CH - 1) / CH;
  WalkState ws{};
  uint64_t cyc[NSTAGE2 + 4] = {};
  long long walked = 0;
  if (threadIdx.x == 0) {
    ws.chain_start = (int64_t)cy.scalars[0];
    ws.chain_broken = cy.scalars[1] != 0;
    ws.last_applied = (int64_t)cy.scalars[2];
  }
  for (int64_t c = 0; c <= chunks; ++c) {
    if (warp == 1 && c < chunks) produce(ev, Bn, rows, L, n, ts_base, c, ring, lane);
    if (threadIdx.x == 0 && c > 0) {
      const int64_t k0 = (c - 1) * CH;
      long long t0 = clock64();
      const long long start = t0;
      walk_chunk_split(table, A, ev, Bn, n, ts_base, cy, ring, (int)((c - 1) & 1),
                       (int)(L - k0 < CH ? L - k0 : CH), ws, cyc, t0, &stamp_word);
      walked += clock64() - start;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    cy.scalars[0] = (uint64_t)ws.chain_start;
    cy.scalars[1] = ws.chain_broken;
    cy.scalars[2] = (uint64_t)ws.last_applied;
    for (int k = 0; k < NSTAGE2; ++k) out[k] = cyc[k];
    out[NSTAGE2] = (unsigned long long)walked;
    for (int k = 0; k < 4; ++k) out[NSTAGE2 + 1 + k] = cyc[NSTAGE2 + k];
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int tb_walk_split_stages() { return NSTAGE; }
extern "C" int tb_walk_split_new_stages() { return NSTAGE2; }

// The SM clock the stamps count (cudaDevAttrClockRate, kHz), of the
// current device.
extern "C" int tb_sm_clock_khz() {
  int dev = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) != cudaSuccess) return -1;
  return khz;
}

extern "C" int tb_cluster_sync_probe(int blocks, int threads, int iters, void* sink,
                                     void* stream) {
  if (blocks > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_sync_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sync_loop, iters,
                                             static_cast<unsigned*>(sink));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int tb_grid_sync_probe(int blocks, int threads, int iters, void* sink,
                                  void* stream) {
  unsigned* out = static_cast<unsigned*>(sink);
  void* args[] = {&iters, &out};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)grid_sync_loop, dim3(blocks), dim3(threads),
                                  args, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Clusters of `blocks` blocks of `threads` threads the card can hold at
// once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int tb_max_active_clusters(int blocks, int threads, void* count) {
  if (blocks > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_sync_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(static_cast<int*>(count),
                                             (const void*)cluster_sync_loop, &cfg);
}

// The stamped walk over the L int32 event indices `rows`, resuming from
// and returning to the carry (as tb_exact_segment did); out: NSTAGE + 1
// u64 (cycles per stage, then the walk's whole cycles).
extern "C" int tb_walk_split(void* table, int64_t A, const void* ev, int B, const void* rows,
                             int L, int n, uint64_t ts_base, void* scratch, void* out,
                             void* stream) {
  walk_split<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(rows), L, n, ts_base, static_cast<uint64_t*>(scratch),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// The stamped walk of exact_scan.cu over the L int32 event indices
// `rows`, as tb_exact_segment runs it; out: NSTAGE2 + 5 u64.
extern "C" int tb_walk_split_new(void* table, int64_t A, const void* ev, int B, const void* rows,
                                 int L, int n, uint64_t ts_base, void* scratch, void* out,
                                 void* stream) {
  walk_split_new<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(rows), L, n, ts_base, static_cast<uint64_t*>(scratch),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
