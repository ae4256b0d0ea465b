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
// dependent steps, each a few loads that hit L2 (the batch's rows and
// its ~3.7 MB of carry fit the 50 MB cache).  The bytes (3.4 MB of
// events in, 2.4 MB of outputs, the touched rows) would take about 3 us
// at 3.35 TB/s.  The design keeps the serial part to one thread doing
// only the body's arithmetic and loads, and gives every parallel part
// (clearing the carry, packing the outputs) to many threads.  Four C
// entry points over ONE carry, the scratch buffer below:
//
//   tb_exact_init      all threads: the initial carry (make_carry, the
//                      durable statuses dstat_init)
//   tb_exact_segment   thread 0 walks a list of global event indices
//                      (a scan segment of a wave plan), resuming
//                      chain_start, chain_broken and last_applied from
//                      the carry; a failed linked chain is rolled back
//                      by the same thread from the undo log
//   tb_exact_finalize  one thread per row: rows named by hist_fix whose
//                      result is 0 take the batch-final table rows of
//                      their created record's accounts as snapshots,
//                      then the packed (B, 37) output
//   tb_exact_scan      one batch whole, in one launch of one block:
//                      init, a walk over i = 0 .. B-1, the pack (no
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

#include "tb_scan.cuh"

namespace {

using namespace tbs;

// 256 threads: the walking thread may use up to 255 registers (a 1024-
// thread bound caps it at 64 and spills the body's live state).
constexpr int THREADS = 256;

// The initial carry, filled by `nthreads` threads starting at `t`.
__device__ void init_carry(uint64_t* s, int64_t Bn, const int32_t* dstat_init, int64_t t,
                           int64_t nthreads) {
  for (int region = 0; region < CARRY_REGIONS; ++region) {
    const uint64_t fill =
        (region == 16 || region == 19 || region == 20) ? U64_MAX : 0;  // -1
    uint64_t* dst = s + region * Bn;
    for (int64_t i = t; i < Bn; i += nthreads)
      dst[i] = region == 18 ? (uint64_t)(uint32_t)dstat_init[i] : fill;
  }
  if (t == 0) {
    uint64_t* scalars = s + CARRY_REGIONS * Bn;
    scalars[0] = U64_MAX;  // chain_start -1
    scalars[1] = 0;        // chain_broken
    scalars[2] = U64_MAX;  // last_applied -1
    scalars[3] = 0;
  }
}

// The serial walk over event rows rows[0 .. L-1] (rows null: 0 .. L-1),
// resuming from and returning to the carry.  A row outside [0, B) is a
// padding lane: inactive, it writes nothing.
__device__ void walk(uint64_t* __restrict__ table, int64_t A,
                     const uint64_t* __restrict__ ev, int64_t Bn,
                     const int32_t* __restrict__ rows, int64_t L, int n,
                     uint64_t ts_base, const Carry& cy) {
  const int64_t Bm = Bn - 1, Am = A - 1;
  int64_t chain_start = (int64_t)cy.scalars[0];
  bool chain_broken = cy.scalars[1] != 0;
  int64_t last_applied = (int64_t)cy.scalars[2];
  for (int64_t k = 0; k < L; ++k) {
    int64_t row = k;
    if (rows != nullptr) {
      row = rows[k];
      if (row < 0 || row >= Bn) continue;
    }
    const uint64_t* e = ev + row * NEV;
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
    const int64_t e_creator = cy.gc[clip(s32(e[E_ID_GROUP]), Bm)];
    const bool e_inb = e_creator >= 0;
    const bool e_any = e_inb || e[E_E_FOUND] != 0;
    uint64_t er[NCR];
    if (e_inb) {
      for (int f = 0; f < NCR; ++f) er[f] = cy.created[f * Bn + e_creator];
    } else {
      durable_e(e, er);
    }

    // ============ normal create_transfer ============
    const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
    uint64_t drr[8], crr[8];
    for (int c = 0; c < 8; ++c) {
      drr[c] = table[clip(ev_dr, Am) * 8 + c];
      crr[c] = table[clip(ev_cr, Am) * 8 + c];
    }
    u128 amount;
    uint64_t ts_plus;
    const uint32_t rn = normal_verdict(e, flags, drr, crr, ts_i, e_any, er, amount, ts_plus);
    const bool is_pending = flags & F_PENDING;
    const uint64_t timeout = e[E_TIMEOUT];

    // ============ post/void pending transfer ============
    // (reference: src/state_machine.zig:1608-1741)
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
    const int64_t p_tgt = s32(e[E_P_TGT]);
    const uint64_t st = p_dur ? cy.dstat[clip(p_tgt, Bm)] : cy.inb[pcr];
    const uint32_t rp_pre = pv_verdict(e, flags, p_any, pr, pv_amount, p_amount, e_any, er, st);
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
    uint64_t new_dr[8], new_cr[8];
    snapshot_rows(old_dr, old_cr, is_pv, is_post, is_pending, amount, pv_amount, p_amount,
                  new_dr, new_cr);
    if (applied) {  // the dr row first, then the cr row
      for (int c = 0; c < 8; ++c) table[safe_dr * 8 + c] = new_dr[c];
      for (int c = 0; c < 8; ++c) table[safe_cr * 8 + c] = new_cr[c];
    }

    if (in_range) {
      // Created-transfer record + id directory.
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
      // Undo log (balance restore, creation, status change).
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

    // Chain failure: roll back [chain_start, i] newest first
    // (reference: src/state_machine.zig:1269-1290).
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

    // Chain close (reference: src/state_machine.zig:1292-1300).
    if (chain_start >= 0 && (!linked || r == LINKED_EVENT_CHAIN_OPEN)) {
      chain_start = -1;
      chain_broken = false;
    }
    if (applied) last_applied = i;
    if (in_range) {
      cy.pulse_c[i] = (normal_applied && is_pending && timeout > 0) ? ts_plus : 0;
      cy.pulse_r[i] = (pv_applied && pr[C_TIMEOUT] > 0) ? p_expires : 0;
    }
  }
  cy.scalars[0] = (uint64_t)chain_start;
  cy.scalars[1] = chain_broken;
  cy.scalars[2] = (uint64_t)last_applied;
}

// One row of the packed (B, 37) output (_pack_outputs).  With `fix`
// (finalize's hist_fix), a row whose result is 0 takes the current
// table rows of its created record's accounts as its snapshots.
__device__ void pack_row(const uint64_t* __restrict__ table, int64_t A, int64_t Bn,
                         const Carry& cy, int64_t i, const uint8_t* __restrict__ fix,
                         uint64_t* __restrict__ out) {
  uint64_t* row = out + i * NOUT;
  row[0] = cy.results[i];
  row[1] = cy.cmask[i];
  for (int f = 0; f < NCR; ++f) row[2 + f] = cy.created[f * Bn + i];
  row[16] = cy.inb[i];
  row[17] = cy.dstat[i];
  row[18] = cy.pulse_c[i];
  row[19] = cy.pulse_r[i];
  row[20] = i == 0 ? cy.scalars[2] + 1 : 0;
  const uint64_t* hd = cy.hist_dr + i * 8;
  const uint64_t* hc = cy.hist_cr + i * 8;
  if (fix != nullptr && fix[i] && cy.results[i] == 0) {
    hd = table + clip((int64_t)cy.created[C_DR * Bn + i], A - 1) * 8;
    hc = table + clip((int64_t)cy.created[C_CR * Bn + i], A - 1) * 8;
  }
  for (int c = 0; c < 8; ++c) {
    row[21 + c] = hd[c];
    row[29 + c] = hc[c];
  }
}

__global__ void __launch_bounds__(THREADS)
exact_scan(uint64_t* __restrict__ table, int64_t A,
           const uint64_t* __restrict__ ev, int B,
           const int32_t* __restrict__ dstat_init, int n, uint64_t ts_base,
           uint64_t* __restrict__ s, uint64_t* __restrict__ out) {
  const int64_t Bn = B;
  const Carry cy = carry_of(s, Bn);
  init_carry(s, Bn, dstat_init, threadIdx.x, THREADS);
  __syncthreads();
  if (threadIdx.x == 0) walk(table, A, ev, Bn, nullptr, Bn, n, ts_base, cy);
  __syncthreads();
  for (int64_t i = threadIdx.x; i < Bn; i += THREADS) pack_row(table, A, Bn, cy, i, nullptr, out);
}

__global__ void init_kernel(uint64_t* __restrict__ s, int B,
                            const int32_t* __restrict__ dstat_init) {
  init_carry(s, B, dstat_init, (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
             (int64_t)gridDim.x * blockDim.x);
}

// One warp: the walking thread keeps the register budget of K3's.
__global__ void __launch_bounds__(32)
segment_kernel(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev,
               int B, const int32_t* __restrict__ rows, int L, int n, uint64_t ts_base,
               uint64_t* __restrict__ s) {
  if (threadIdx.x == 0) walk(table, A, ev, B, rows, L, n, ts_base, carry_of(s, B));
}

__global__ void finalize_kernel(const uint64_t* __restrict__ table, int64_t A, int B,
                                uint64_t* __restrict__ s, const uint8_t* __restrict__ fix,
                                uint64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) pack_row(table, A, B, carry_of(s, B), i, fix, out);
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

constexpr int FLAT_THREADS = 256;

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

// The initial carry of a B-row batch in the scratch (57 * B + 4 words).
extern "C" int tb_exact_init(void* scratch, int B, const void* dstat_init, void* stream) {
  const int blocks = (B + FLAT_THREADS - 1) / FLAT_THREADS;
  init_kernel<<<blocks, FLAT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(scratch), B, static_cast<const int32_t*>(dstat_init));
  return (int)cudaGetLastError();
}

// A scan segment: the walk over the L global event indices `rows`
// (int32; an index outside [0, B) is padding), resuming from the carry.
extern "C" int tb_exact_segment(void* table, int64_t A, const void* ev, int B,
                                const void* rows, int L, int n, uint64_t ts_base,
                                void* scratch, void* stream) {
  segment_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(rows), L, n, ts_base, static_cast<uint64_t*>(scratch));
  return (int)cudaGetLastError();
}

// The packed (B, 37) output of the carry; hist_fix (B,) u8 or null.
extern "C" int tb_exact_finalize(const void* table, int64_t A, int B, void* scratch,
                                 const void* hist_fix, void* out, void* stream) {
  const int blocks = (B + FLAT_THREADS - 1) / FLAT_THREADS;
  finalize_kernel<<<blocks, FLAT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(table), A, B, static_cast<uint64_t*>(scratch),
      static_cast<const uint8_t*>(hist_fix), static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}
