// The staging of K3's serial walk (exact_scan.cu): what a producer warp
// works out ahead of the walking thread, per event, from the event
// alone, and the state the walker fetches for an event in one batch of
// loads.  Shared with the walk's stamped probe build
// (tools/serial_probes.cu).
//
// kernels/build.py hashes this header into every library's name.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace tbs {

// Events per chunk of the producer's ring: one per producer lane.
constexpr int CH = 32;
constexpr unsigned FULL = 0xffffffffu;

// Plan bits.
enum : uint32_t {
  PL_OK = 1u << 0,        // an event row (else padding: skipped)
  PL_LINKED = 1u << 1,
  PL_OPEN = 1u << 2,      // linked and i == n - 1
  PL_PV = 1u << 3,        // post or void
  PL_POST = 1u << 4,
  PL_PENDING = 1u << 5,
  PL_E_FOUND = 1u << 6,   // a durable duplicate
  PL_P_DUR = 1u << 7,     // a durable pending
  PL_P_GROUP = 1u << 8,   // p_group >= 0
  PL_TS_OVF = 1u << 9,    // normal: ts_i + timeout x 10^9 wraps
  PL_TIMEOUT = 1u << 10,  // normal: timeout > 0; durable pv: the pending's
  PL_OVERDUE = 1u << 11,  // durable pv: p_expires <= ts_i
  PL_DR_LIMIT = 1u << 12,
  PL_CR_LIMIT = 1u << 13,
  PL_ROWS = 1u << 14,     // the update slots are known ahead (normal, durable pv)
};

// What one event of the walk needs that depends on the event alone, in
// 16-byte pieces (the walker reads each with one shared-memory load).
struct alignas(16) Plan {
  int4 hdr;         // i, flags, bits, pre_tail (the precedence after the chain terms)
  int4 codes;       // ex (exists code against the durable duplicate), pv_pre (durable
                    // pv: the post/void checks before exists), idg, pgc (id- and
                    // pending-directory slots, clipped)
  int4 slots;       // p_tgt (durable pending's status slot, raw), dr, cr (update
                    // slots, raw: normal, durable pv)
  ulonglong2 amt;   // normal: the amount before the clamps; durable pv: pv_amount
  ulonglong2 pam;   // durable pv: the pending's amount
  ulonglong2 t;     // x: normal: ts_i + timeout x 10^9; durable pv: p_expires
  uint64_t rec[NCR];  // created record (normal: amount before the clamps)
};

// The producer's ring: two chunks of event rows and their plans.
struct Ring {
  uint64_t ev[2][CH][NEV];
  Plan plan[2][CH];
};

__device__ inline void plan_event(const uint64_t* e, int64_t Bn, int n, uint64_t ts_base,
                                  Plan& pl) {
  const int64_t Bm = Bn - 1;
  const int64_t i = s32(e[E_I]);
  const uint32_t flags = (uint32_t)e[E_FLAGS];
  const bool is_pv = flags & (F_POST | F_VOID);
  const uint64_t ts_i = ts_base + (uint64_t)i;
  uint32_t bits = PL_OK;
  if (flags & F_LINKED) bits |= PL_LINKED | (i == n - 1 ? PL_OPEN : 0);
  if (is_pv) bits |= PL_PV;
  if (flags & F_POST) bits |= PL_POST;
  if (flags & F_PENDING) bits |= PL_PENDING;
  if (e[E_E_FOUND]) bits |= PL_E_FOUND;
  if (e[E_P_FOUND]) bits |= PL_P_DUR;
  const int64_t pg = s32(e[E_P_GROUP]);
  if (pg >= 0) bits |= PL_P_GROUP;
  uint32_t ex = 0, pv_pre = 0;
  int32_t dr = 0, cr = 0;
  uint64_t er[NCR];
  durable_e(e, er);
  if (!is_pv) {
    u128 amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
    // amount == 0 with balancing means maxInt(u64)
    // (reference: src/state_machine.zig:1512).
    if ((flags & (F_BAL_DR | F_BAL_CR)) && amount == 0) amount = U64_MAX;
    const uint64_t ts_plus = ts_i + e[E_TIMEOUT] * NS_PER_S;
    if (ts_plus < ts_i) bits |= PL_TS_OVF;
    if (e[E_TIMEOUT] > 0) bits |= PL_TIMEOUT;
    if ((uint32_t)e[E_DR_FLAGS] & AF_DR_LIMIT) bits |= PL_DR_LIMIT;
    if ((uint32_t)e[E_CR_FLAGS] & AF_CR_LIMIT) bits |= PL_CR_LIMIT;
    bits |= PL_ROWS;
    ex = exists_normal(e, er);
    dr = (int32_t)s32(e[E_DR]);
    cr = (int32_t)s32(e[E_CR]);
    build_record(e, flags, false, dr, cr, amount, er, pl.rec);
    pl.amt = make_ulonglong2((uint64_t)amount, (uint64_t)(amount >> 64));
    pl.t = make_ulonglong2(ts_plus, 0);
  } else if (bits & PL_P_DUR) {
    uint64_t pr[NCR];
    durable_p(e, pr);
    const u128 p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
    const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
    const u128 pv_amount = raw_amount != 0 ? raw_amount : p_amount;
    // QUIRK (reference: src/state_machine.zig:1687-1696): the insert
    // lands before the overdue check, so an overdue post/void is
    // inserted while it returns pending_transfer_expired.
    const uint64_t p_expires = e[E_P_TIMESTAMP] + pr[C_TIMEOUT] * NS_PER_S;
    if (pr[C_TIMEOUT] > 0) bits |= PL_TIMEOUT | (p_expires <= ts_i ? PL_OVERDUE : 0);
    bits |= PL_ROWS;
    pv_pre = pv_prefix(e, flags, pr, pv_amount, p_amount);
    ex = exists_post_void(e, er, pr);
    dr = (int32_t)(int64_t)pr[C_DR];
    cr = (int32_t)(int64_t)pr[C_CR];
    build_record(e, flags, true, dr, cr, pv_amount, pr, pl.rec);
    pl.amt = make_ulonglong2((uint64_t)pv_amount, (uint64_t)(pv_amount >> 64));
    pl.pam = make_ulonglong2(pr[C_AMT_LO], pr[C_AMT_HI]);
    pl.t = make_ulonglong2(p_expires, 0);
  }
  pl.codes = make_int4((int)ex, (int)pv_pre, (int)clip(s32(e[E_ID_GROUP]), Bm),
                       (int)clip(pg, Bm));
  pl.slots = make_int4((int)s32(e[E_P_TGT]), dr, cr, 0);
  pl.hdr = make_int4((int)i, (int)flags, (int)bits,
                     (int)(e[E_TS_NONZERO] ? TIMESTAMP_MUST_BE_ZERO : (uint32_t)e[E_STATIC]));
}

// The producer warp: chunk `c` of the walk (events c * CH ..) into ring
// slot c & 1, each event's row copied by the whole warp, then one lane
// per event works out its plan.  A row outside [0, B) is padding.
__device__ inline void produce(const uint64_t* __restrict__ ev, int64_t Bn,
                               const int32_t* __restrict__ rows, int64_t L, int n,
                               uint64_t ts_base, int64_t c, Ring& ring, int lane) {
  const int slot = (int)(c & 1);
  const int64_t k0 = c * CH;
  const int cnt = (int)(L - k0 < CH ? L - k0 : CH);
  int64_t my_row = -1;
  if (lane < cnt) my_row = rows != nullptr ? (int64_t)rows[k0 + lane] : k0 + lane;
  for (int j = 0; j < cnt; ++j) {
    const int64_t row = __shfl_sync(FULL, my_row, j);
    if (row < 0 || row >= Bn) continue;
    const uint64_t* src = ev + row * NEV;
    uint64_t* dst = ring.ev[slot][j];
    dst[lane] = src[lane];
    if (lane < NEV - 32) dst[32 + lane] = src[32 + lane];
  }
  __syncwarp();
  if (lane < cnt) {
    Plan& pl = ring.plan[slot][lane];
    if (my_row >= 0 && my_row < Bn) plan_event(ring.ev[slot][lane], Bn, n, ts_base, pl);
    else pl.hdr.z = 0;
  }
}

__device__ __forceinline__ void load_row(const uint64_t* __restrict__ p, uint64_t (&r)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = p[k];
}

__device__ __forceinline__ void store_row(uint64_t* __restrict__ p, const uint64_t (&r)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = r[k];
}

// The state an event reads first, in one batch of loads: its id- and
// pending-directory entries, a durable pending's status, and the rows
// at its update slots when the plan knows them.
struct Ahead {
  int64_t gce, gcp;
  uint64_t dst;
  uint64_t dr[8], cr[8];
};

__device__ __forceinline__ void fetch(const Plan& pl, const uint64_t* __restrict__ table,
                                      const Carry& cy, int64_t Am, int64_t Bm, Ahead& a) {
  const uint32_t bits = (uint32_t)pl.hdr.z;
  const int4 codes = pl.codes, slots = pl.slots;
  a.gce = cy.gc[codes.z];
  a.gcp = cy.gc[codes.w];
  a.dst = (bits & PL_PV) && (bits & PL_P_DUR) ? cy.dstat[clip(slots.x, Bm)] : 0;
  if (bits & PL_ROWS) {
    load_row(table + clip(slots.y, Am) * 8, a.dr);
    load_row(table + clip(slots.z, Am) * 8, a.cr);
  }
}

struct WalkState {
  int64_t chain_start;
  bool chain_broken;
  int64_t last_applied;
};

}  // namespace tbs
