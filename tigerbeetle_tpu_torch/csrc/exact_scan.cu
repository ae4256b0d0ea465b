// K3: the exact sequential create_transfers scan, on the GPU, whole or
// in resumable segments.
//
// Replaces tigerbeetle_tpu/state_machine/kernel.py:738 (_run_impl, the
// lax.scan over B events; body make_body :326, carry make_carry :280,
// outputs finalize_outputs :720 and _pack_outputs :779) and :748
// (_scan_segment_impl, the same body over a sub-range of the batch,
// resuming from a carry), with waves.py:1633 (_init_carry) and :1642
// (_finalize_body: the snapshot rewrite, then the pack).  Same inputs
// (the 52 EVENT_FIELDS columns, packed by the host as one (B, 52) u64
// matrix in kernel.EVENT_FIELDS order), the same bits out: the table
// updated in place and the (B, 37) u64 output matrix, padding lanes
// included.
//
// What bounds it on the H100: the dependence between events, not
// bandwidth.  Event i reads balance rows, the in-batch id directory and
// pending statuses that events < i wrote, so the walk is serial: n
// dependent steps, each at least one L2 round trip (the batch's rows
// and its ~3.7 MB of carry fit the 50 MB cache).  The bytes (3.4 MB of
// events in, 2.4 MB of outputs, the touched rows) would take about 3 us
// at 3.35 TB/s.  So one thread walks, and does only what depends on
// earlier events:
//
//   producer  a second warp stages the walk in chunks of 32 events in a
//             shared-memory ring of two, a chunk ahead of the walker:
//             each event's row copied, then one lane per event works
//             out everything that depends on the event alone (flags and
//             class, the precedence before the chain terms, the amount
//             before the clamps, timeout x 10^9 and its overflow, the
//             durable duplicate's and the durable pending's exists and
//             post/void ladders, p_expires, the created record)
//   walker    per event, the state it reads first in one batch of loads
//             (its id- and pending-directory entries, a durable
//             pending's status, the rows at its update slots), issued
//             while the event before it finishes and patched with what
//             that event wrote; then only its class's branch: a normal
//             event never looks up its pending, a post/void never runs
//             the balancing and overflow ladder; each row read once
//
// Every in-range event, failed, inactive and padding ones included,
// still writes its hist and undo rows, result, mask, status and pulse
// words, as the reference's body does.  What a walked event costs now is
// the walker's own chain of dependent instructions, ~1.6 us an event
// (tools/serial_probes.py splits it into stages).  The parallel parts
// (clearing the carry, packing the outputs) take every thread.  Four C
// entry points over ONE carry, the scratch buffer below:
//
//   tb_exact_init      the initial carry (make_carry, the durable
//                      statuses dstat_init): one flat pass of 16-byte
//                      stores over several blocks on every SM (below)
//   tb_exact_segment   the walk over a list of global event indices (a
//                      scan segment of a wave plan), resuming
//                      chain_start, chain_broken and last_applied from
//                      the carry; a failed linked chain is rolled back
//                      by the walker from the undo log
//   tb_exact_finalize  the packed (B, 37) output, a tile of FIN_ROWS
//                      consecutive rows a block (below): rows named by
//                      hist_fix whose result is 0 take the batch-final
//                      table rows of their created record's accounts as
//                      snapshots
//   tb_exact_scan      one batch whole, in one launch of one block:
//                      init, the walk over i = 0 .. B-1, the pack (no
//                      snapshot rewrite) — the host exact lane's K3
//
// u128 values are unsigned __int128; wrap and carry-out follow the
// reference's ops/u128.py helpers (add wraps mod 2^128, a carry out of
// 128 bits is the overflow flag; sub_sat saturates at zero).
//
// Scratch layout (u64 words, B = batch rows): the carry every segment
// kind of a wave plan threads (K3 segments, K7 wave steps, K8 chain
// waves, finalize; kernel.carry_from_dict / carry_to_dict map it to the
// reference's carry dict):
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
//   [57B + 0..2]    chain_start, chain_broken, last_applied (int64)

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"
#include "tb_scan.cuh"
#include "tb_walk.cuh"

namespace {

using namespace tbs;

// The whole-scan block: 256 threads share the carry's init and pack
// (the walking thread keeps up to 255 registers; a 1024-thread bound
// caps it at 64 and spills the body's live state).
constexpr int THREADS = 256;
// The segment block: the walking warp and the producer warp.
constexpr int SEG_THREADS = 64;
// The initial carry (kernel.make_carry): every one of its 57 B + 4 words
// is written, since finalize packs every row's hist and scalar words,
// padding rows included, and a rollback reads the undo rows.  Word w's
// fill follows from where w lies, by compares against region bounds
// (no loop over regions, no per-region branch chain): -1 in
// group_creator, u_dr_slot and u_cr_slot (regions 16, 19 and 20), the
// durable statuses widened from u32 in region 18, the scalars -1, 0,
// -1, 0, and 0 everywhere else.  The bytes (3.7 MB at B = 8192, 32 KB
// of statuses read) would take ~1.1 us at 3.35 TB/s, so what bounds the
// pass is how fast the SMs issue its stores: it is flat, a 16-byte
// piece a thread (ulonglong2, the store width Hopper serves best), and
// several blocks on every SM.  For an even B and a 16-byte aligned scratch a
// piece never straddles two regions (each starts at an even word); an
// odd B or an unaligned scratch takes 8-byte words.  Default stores:
// the next launch (a segment, a wave, finalize) reads the carry, and
// 3.7 MB sits in the 50 MB L2.
constexpr int INIT_THREADS = 256;
constexpr int INIT_BLOCKS_PER_SM = 8;  // 2048 threads: a full SM

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// -1 (all ones) where word w lies in regions 16, 19 or 20, else 0; w
// below the scalars and outside region 18.
__device__ __forceinline__ uint64_t carry_fill(int64_t w, int64_t Bn) {
  const bool minus1 = (uint64_t)(w - 16 * Bn) < (uint64_t)Bn ||
                      (uint64_t)(w - 19 * Bn) < (uint64_t)(2 * Bn);
  return minus1 ? U64_MAX : 0;
}

// Word w of the initial carry.
__device__ __forceinline__ uint64_t carry_word(int64_t w, int64_t Bn,
                                               const int32_t* __restrict__ dstat) {
  const int64_t sc = w - CARRY_REGIONS * Bn, d = w - 18 * Bn;
  if (sc >= 0) return (sc & 1) ? 0 : U64_MAX;  // chain_start, chain_broken, last_applied, 0
  if ((uint64_t)d < (uint64_t)Bn) return (uint64_t)(uint32_t)dstat[d];
  return carry_fill(w, Bn);
}

// Words w and w + 1 of the initial carry, w even and B even (both in
// one region).
__device__ __forceinline__ ulonglong2 carry_piece(int64_t w, int64_t Bn,
                                                  const int32_t* __restrict__ dstat) {
  const int64_t d = w - 18 * Bn;
  if (w >= CARRY_REGIONS * Bn) return make_ulonglong2(U64_MAX, 0);  // the scalars, twice
  if ((uint64_t)d < (uint64_t)Bn)
    return make_ulonglong2((uint32_t)dstat[d], (uint32_t)dstat[d + 1]);
  const uint64_t f = carry_fill(w, Bn);
  return make_ulonglong2(f, f);
}

// The initial carry's 16-byte pieces (WIDE: B even, scratch aligned) or
// 8-byte words, filled by `nthreads` threads starting at `t`.
template <bool WIDE>
__device__ __forceinline__ void fill_carry(uint64_t* __restrict__ s, int64_t Bn,
                                           const int32_t* __restrict__ dstat, int64_t t,
                                           int64_t nthreads) {
  const int64_t words = CARRY_REGIONS * Bn + 4;
  if constexpr (WIDE) {
    ulonglong2* p = reinterpret_cast<ulonglong2*>(s);
    for (int64_t i = t; i < words / 2; i += nthreads) p[i] = carry_piece(2 * i, Bn, dstat);
  } else {
    for (int64_t i = t; i < words; i += nthreads) s[i] = carry_word(i, Bn, dstat);
  }
}

__host__ __device__ __forceinline__ bool carry_wide(const void* s, int64_t Bn) {
  return !(Bn & 1) && aligned16(s);
}

// The walker over one chunk of `cnt` planned events in ring slot `slot`
// (reference body: kernel.make_body, src/state_machine.zig:1240-1741).
__device__ void walk_chunk(uint64_t* __restrict__ table, int64_t A,
                           const uint64_t* __restrict__ ev, int64_t Bn, int n,
                           uint64_t ts_base, const Carry& cy, const Ring& ring, int slot,
                           int cnt, WalkState& ws) {
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
    if (!have) fetch(pl, table, cy, Am, Bm, cur);
    const bool ahead = j + 1 < cnt && ((uint32_t)ring.plan[slot][j + 1].hdr.z & PL_OK);
    if (ahead) fetch(ring.plan[slot][j + 1], table, cy, Am, Bm, nxt);

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
      pv_applied = applied = gate && rp == 0;
      snapshot_rows(cur.dr, cur.cr, true, bits & PL_POST, is_pending, 0, pv_amount, p_amount,
                    new_dr, new_cr);
      pulse_r = (pv_applied && p_timeout) ? p_expires : 0;
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

    // Chain failure: roll back [chain_start, i] newest first
    // (reference: src/state_machine.zig:1269-1290).
    const bool chain_fail = active && r != 0 && ws.chain_start >= 0 && !ws.chain_broken;
    if (chain_fail) {
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
  }
}

// The walk over event rows rows[0 .. L-1] (rows null: 0 .. L-1),
// resuming from and returning to the carry, run by every thread of the
// block: warp 1 produces chunk c while thread 0 walks chunk c - 1, one
// block barrier between chunks.
__device__ void walk(uint64_t* __restrict__ table, int64_t A,
                     const uint64_t* __restrict__ ev, int64_t Bn,
                     const int32_t* __restrict__ rows, int64_t L, int n,
                     uint64_t ts_base, const Carry& cy, Ring& ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunks = (L + CH - 1) / CH;
  WalkState ws{};
  if (threadIdx.x == 0) {
    ws.chain_start = (int64_t)cy.scalars[0];
    ws.chain_broken = cy.scalars[1] != 0;
    ws.last_applied = (int64_t)cy.scalars[2];
  }
  for (int64_t c = 0; c <= chunks; ++c) {
    if (warp == 1 && c < chunks) produce(ev, Bn, rows, L, n, ts_base, c, ring, lane);
    if (threadIdx.x == 0 && c > 0) {
      const int64_t k0 = (c - 1) * CH;
      walk_chunk(table, A, ev, Bn, n, ts_base, cy, ring, (int)((c - 1) & 1),
                 (int)(L - k0 < CH ? L - k0 : CH), ws);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    cy.scalars[0] = (uint64_t)ws.chain_start;
    cy.scalars[1] = ws.chain_broken;
    cy.scalars[2] = (uint64_t)ws.last_applied;
  }
}

// One row of the packed (B, 37) output (_pack_outputs), for the whole
// scan's pack.
__device__ void pack_row(const Carry& cy, int64_t Bn, int64_t i, uint64_t* __restrict__ out) {
  uint64_t* row = out + i * NOUT;
  row[0] = cy.results[i];
  row[1] = cy.cmask[i];
  for (int f = 0; f < NCR; ++f) row[2 + f] = cy.created[f * Bn + i];
  row[16] = cy.inb[i];
  row[17] = cy.dstat[i];
  row[18] = cy.pulse_c[i];
  row[19] = cy.pulse_r[i];
  row[20] = i == 0 ? cy.scalars[2] + 1 : 0;
  for (int c = 0; c < 8; ++c) {
    row[21 + c] = cy.hist_dr[i * 8 + c];
    row[29 + c] = cy.hist_cr[i * 8 + c];
  }
}

__global__ void __launch_bounds__(THREADS)
exact_scan(uint64_t* __restrict__ table, int64_t A,
           const uint64_t* __restrict__ ev, int B,
           const int32_t* __restrict__ dstat_init, int n, uint64_t ts_base,
           uint64_t* __restrict__ s, uint64_t* __restrict__ out) {
  __shared__ Ring ring;
  const int64_t Bn = B;
  const Carry cy = carry_of(s, Bn);
  if (carry_wide(s, Bn)) fill_carry<true>(s, Bn, dstat_init, threadIdx.x, THREADS);
  else fill_carry<false>(s, Bn, dstat_init, threadIdx.x, THREADS);
  __syncthreads();
  walk(table, A, ev, Bn, nullptr, Bn, n, ts_base, cy, ring);
  __syncthreads();
  for (int64_t i = threadIdx.x; i < Bn; i += THREADS) pack_row(cy, Bn, i, out);
}

template <bool WIDE>
__global__ void __launch_bounds__(INIT_THREADS, INIT_BLOCKS_PER_SM)
init_kernel(uint64_t* __restrict__ s, int B, const int32_t* __restrict__ dstat_init) {
  fill_carry<WIDE>(s, B, dstat_init, (int64_t)blockIdx.x * INIT_THREADS + threadIdx.x,
                   (int64_t)gridDim.x * INIT_THREADS);
}

// The walking warp and the producer warp.
__global__ void __launch_bounds__(SEG_THREADS)
segment_kernel(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev,
               int B, const int32_t* __restrict__ rows, int L, int n, uint64_t ts_base,
               uint64_t* __restrict__ s) {
  __shared__ Ring ring;
  walk(table, A, ev, B, rows, L, n, ts_base, carry_of(s, B), ring);
}

// Finalize (waves.py _finalize_body) as a pack that fills the card and
// writes coalesced.  The work is ~4.8 MB at B = 8192 (the carry's 21
// scalar columns and two 64-byte snapshots a row read, 296 bytes a row
// written): ~1.5 us at 3.35 TB/s, so what bounds it is latency: a
// block's loads, then its stores, in as few dependent trips as the
// rewritten rows allow.  A block packs a tile of FIN_ROWS consecutive
// rows (256 blocks at B = 8192): its snapshots, two contiguous runs of
// FIN_ROWS x 64 bytes, copied to shared memory in 16-byte pieces
// (cp.async) while its scalar columns are read coalesced along i and
// each row whose hist_fix is set and whose result is 0 reads its two
// batch-final table rows at its created record's clipped slots (a quad
// of lanes a row and 16 bytes a lane, one dependent trip more), which
// then replace the copied snapshots; then the tile's output, one
// contiguous run of FIN_ROWS x 296 bytes (16-byte aligned: FIN_ROWS is
// even), leaves in 16-byte stores by consecutive lanes.  A carry, table or output that is not 16-byte aligned (an odd
// B puts the snapshot regions at 8 bytes) moves in 8-byte pieces.
constexpr int FIN_ROWS = 32;
constexpr int FIN_THREADS = 128;
constexpr int NSCAL = 21;  // output columns 0..20: the scalar ones
constexpr int FIX_PASSES = 2;  // a thread's (row, side, quarter) lanes of the rewrite

// The carry region of scalar output column c < 20 (column 20 is
// last_applied + 1 on row 0).
__device__ __forceinline__ int64_t scalar_region(int c) {
  return c == 0 ? 14 : c == 1 ? 15 : c < 16 ? c - 2 : c == 16 ? 17 : c == 17 ? 18 : c + 5;
}

__global__ void __launch_bounds__(FIN_THREADS)
finalize_kernel(const uint64_t* __restrict__ table, int64_t A, int B,
                uint64_t* __restrict__ s, const uint8_t* __restrict__ fix,
                uint64_t* __restrict__ out) {
  __shared__ uint64_t sc[FIN_ROWS * NSCAL];                 // [r][c]
  __shared__ __align__(16) uint64_t hist[2][FIN_ROWS * 8];  // snapshots, dr then cr
  const int64_t Bn = B, i0 = (int64_t)blockIdx.x * FIN_ROWS;
  const int rows = (int)(Bn - i0 < FIN_ROWS ? Bn - i0 : FIN_ROWS), t = threadIdx.x;
  const Carry cy = carry_of(s, Bn);
  const uint64_t* hsrc[2] = {cy.hist_dr + i0 * 8, cy.hist_cr + i0 * 8};
  if (aligned16(hsrc[0]) && aligned16(hsrc[1])) {
    for (int j = t; j < 8 * rows; j += FIN_THREADS) {
      const int side = j >= 4 * rows, q = j - side * 4 * rows;
      tb::copy16_async(&hist[side][2 * q], hsrc[side] + 2 * q);
    }
  } else {
    for (int j = t; j < 16 * rows; j += FIN_THREADS) {
      const int side = j >= 8 * rows, q = j - side * 8 * rows;
      hist[side][q] = hsrc[side][q];
    }
  }
  for (int j = t; j < NSCAL * rows; j += FIN_THREADS) {
    const int c = j / rows, r = j - c * rows;
    const int64_t i = i0 + r;
    sc[r * NSCAL + c] = c == NSCAL - 1 ? (i == 0 ? cy.scalars[2] + 1 : 0)
                                       : s[scalar_region(c) * Bn + i];
  }
  // A rewritten row's table rows, a quad of lanes a row and side: its
  // fix byte, result and created slot read in the same round as the
  // above, then the row, held in registers until the snapshots land.
  static_assert(8 * FIN_ROWS == FIX_PASSES * FIN_THREADS, "a lane per row, side and quarter");
  ulonglong2 row[FIX_PASSES];
  bool take[FIX_PASSES];
#pragma unroll
  for (int k = 0; k < FIX_PASSES; ++k) {
    const int j = t + k * FIN_THREADS, r = j >> 3, side = (j >> 2) & 1, q = j & 3;
    const int64_t i = i0 + r;
    take[k] = fix != nullptr && r < rows && fix[i] && cy.results[i] == 0;
    if (take[k]) {
      const int64_t slot = clip((int64_t)cy.created[(side ? C_CR : C_DR) * Bn + i], A - 1);
      const uint64_t* src = table + slot * 8 + 2 * q;
      row[k] = aligned16(table) ? __ldg(reinterpret_cast<const ulonglong2*>(src))
                                : make_ulonglong2(src[0], src[1]);
    }
  }
  tb::wait_async();
  __syncthreads();
  if (fix != nullptr) {
#pragma unroll
    for (int k = 0; k < FIX_PASSES; ++k) {
      const int j = t + k * FIN_THREADS, r = j >> 3, side = (j >> 2) & 1, q = j & 3;
      if (!take[k]) continue;
      hist[side][r * 8 + 2 * q] = row[k].x;
      hist[side][r * 8 + 2 * q + 1] = row[k].y;
    }
    __syncthreads();
  }
  uint64_t* dst = out + i0 * NOUT;
  const int words = rows * NOUT;
  auto word = [&](int w) -> uint64_t {
    const int r = w / NOUT, c = w - r * NOUT;
    return c < NSCAL ? sc[r * NSCAL + c] : hist[c >= 29][r * 8 + (c - (c >= 29 ? 29 : 21))];
  };
  if (aligned16(dst)) {
    for (int v = t; v < words / 2; v += FIN_THREADS)
      reinterpret_cast<ulonglong2*>(dst)[v] = make_ulonglong2(word(2 * v), word(2 * v + 1));
    if ((words & 1) && t == 0) dst[words - 1] = word(words - 1);
  } else {
    for (int w = t; w < words; w += FIN_THREADS) dst[w] = word(w);
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

// The initial carry of a B-row batch in the scratch (57 * B + 4 words):
// enough blocks for one piece (or word) a thread, at most
// INIT_BLOCKS_PER_SM on every SM of the card, grid-stride past that.
extern "C" int tb_exact_init(void* scratch, int B, const void* dstat_init, void* stream) {
  int sms = 0;
  const int err = tb::sm_count(sms);
  if (err) return err;
  const bool wide = carry_wide(scratch, B);
  const int64_t units = ((int64_t)CARRY_REGIONS * B + 4) / (wide ? 2 : 1);
  int64_t blocks = (units + INIT_THREADS - 1) / INIT_THREADS;
  if (blocks > (int64_t)sms * INIT_BLOCKS_PER_SM) blocks = (int64_t)sms * INIT_BLOCKS_PER_SM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* words = static_cast<uint64_t*>(scratch);
  const int32_t* dstat = static_cast<const int32_t*>(dstat_init);
  if (wide) init_kernel<true><<<(int)blocks, INIT_THREADS, 0, s>>>(words, B, dstat);
  else init_kernel<false><<<(int)blocks, INIT_THREADS, 0, s>>>(words, B, dstat);
  return (int)cudaGetLastError();
}

// A scan segment: the walk over the L global event indices `rows`
// (int32; an index outside [0, B) is padding), resuming from the carry.
extern "C" int tb_exact_segment(void* table, int64_t A, const void* ev, int B,
                                const void* rows, int L, int n, uint64_t ts_base,
                                void* scratch, void* stream) {
  segment_kernel<<<1, SEG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(rows), L, n, ts_base, static_cast<uint64_t*>(scratch));
  return (int)cudaGetLastError();
}

// Finalize's launch for a B-row batch: blocks and threads per block,
// into geom[0..1].
extern "C" int tb_exact_finalize_geometry(int B, int* geom) {
  geom[0] = (B + FIN_ROWS - 1) / FIN_ROWS;
  geom[1] = FIN_THREADS;
  return 0;
}

// The packed (B, 37) output of the carry; hist_fix (B,) u8 or null.
extern "C" int tb_exact_finalize(const void* table, int64_t A, int B, void* scratch,
                                 const void* hist_fix, void* out, void* stream) {
  const int blocks = (B + FIN_ROWS - 1) / FIN_ROWS;
  finalize_kernel<<<blocks, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(table), A, B, static_cast<uint64_t*>(scratch),
      static_cast<const uint8_t*>(hist_fix), static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}
