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
//   read    one thread per lane: the exists ladders, the normal and
//           post/void ladders, the balancing clamps and limit reads,
//           the record, the status change, the pulses and the lane's
//           own snapshot (the pre-wave row plus its own effect, R
//           :1301) — into a lane record in the block's shared memory;
//           it writes nothing of the carry or the table
//   apply   the same thread, after a barrier across every lane of the
//           wave: the balance deltas, summed exactly mod 2^128 by
//           64-bit atomics that carry into the high word (tb_scan.cuh
//           atomic_add128), and every carry scatter (record, id
//           directory, statuses, results, snapshots, pulses,
//           last_applied as a max)
//
// The order rule is the design's trap: a lane's snapshot is built from
// the pre-wave row, so no row may move before every lane has read it.
// One launch per wave: the read phase, then the barrier — the block's
// own when the wave fits one block, the cluster's hardware barrier for
// up to 16 blocks, a cooperative grid's barrier above — then the apply
// phase.  A lane that is inactive (index >= n, padding,
// or masked off) writes nothing at all, its result slot included, so a
// conflicted lane replays later against this carry exactly as "not yet
// executed".
//
// What bounds it: bytes.  Per lane the 416-byte event row, two or four
// 64-byte table rows and ~500 bytes of carry read and written, ~1 us at
// 3.35 TB/s for 8192 lanes.  Each lane reads scattered words of its own
// event row, so each warp first stages its 32 rows into shared memory
// in 16-byte pieces (26 neighbouring threads on one row), at an odd
// word stride that keeps the lanes' 8-byte reads free of bank
// conflicts; the lane record (48 words) stays in shared memory, word-
// major, and never goes to global memory (808 bytes a lane bound a
// block at 256).  The lanes' other loads are scattered (a line each),
// and an SM's L1 passes them one line at a time, so a wave spreads
// over many SMs: clusters of up to 16 blocks of 8 to 64 lanes, a
// cooperative grid of 32-lane blocks above 1024 lanes (geometry below).
// A normal lane reads no pending record and reuses its two rows as its
// snapshot's base.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tbs;

constexpr int MAX_LANES = 256;     // lanes (threads) per block
constexpr int MAX_CLUSTER = 16;    // blocks per cluster (above 8: non-portable)
constexpr int SPREAD_LANES = 8;    // lanes per cluster block before the cluster grows
constexpr int CLUSTER_LANES = 64;  // lanes per cluster block at most
constexpr int GRID_LANES = 32;     // lanes per block of a cooperative grid
constexpr int ROW = NEV + 1;     // staged row stride in words (odd: no bank conflicts)
constexpr int PIECES = NEV / 2;  // 16-byte pieces of an event row

enum Mode { ONE_BLOCK, CLUSTER, GRID };

// Lane record words (word-major in shared memory: word w of lane t at
// rec[w * T + t]).
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

size_t smem_bytes(int T) { return (size_t)T * (ROW + LW) * sizeof(uint64_t); }

__device__ __forceinline__ void wave_barrier(int mode) {
  if (mode == ONE_BLOCK) __syncthreads();
  else if (mode == CLUSTER) cg::this_cluster().sync();
  else cg::this_grid().sync();
}

__global__ void __launch_bounds__(MAX_LANES)
wave_step(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev, int B,
          const int32_t* __restrict__ idx, int K, const uint8_t* __restrict__ mask, int n,
          uint64_t ts_base, uint64_t* __restrict__ s, int lanes, int mode) {
  extern __shared__ __align__(16) uint64_t sm[];
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31;
  uint64_t* rows = sm;                     // (T, ROW): the lanes' event rows
  uint64_t* rec = sm + (size_t)T * ROW;    // (LW, T): the lane records
  auto L = [&](int w) -> uint64_t& { return rec[w * T + t]; };
  const int64_t Bn = B, Bm = Bn - 1, Am = A - 1;
  const int k = blockIdx.x * lanes + t;  // threads past `lanes` idle
  int64_t row = -1;
  if (t < lanes && k < K) {
    row = idx[k];
    if (row < 0 || row >= Bn || (mask != nullptr && !mask[k])) row = -1;
  }

  // Stage the warp's event rows: 16-byte pieces, 26 threads on a row.
  {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(ev);
    uint64_t* wrows = rows + (size_t)(t - lane) * ROW;
    for (int p = lane; p < 32 * PIECES; p += 32) {
      const int r = p / PIECES, c = p - r * PIECES;
      const int64_t rr = __shfl_sync(0xFFFFFFFFu, row, r);
      if (rr >= 0) {
        const ulonglong2 v = __ldg(src + rr * PIECES + c);
        wrows[r * ROW + 2 * c] = v.x;
        wrows[r * ROW + 2 * c + 1] = v.y;
      }
    }
    __syncwarp();
  }

  // Read phase.
  L(L_I) = U64_MAX;
  const uint64_t* e = rows + (size_t)t * ROW;
  const int64_t i = row >= 0 ? s32(e[E_I]) : -1;
  const Carry cy = carry_of(s, Bn);
  if (i >= 0 && i < n) {
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

    // The pending target: read for a post/void only (a normal lane's
    // record, snapshot and effects never read it).
    const bool p_dur = e[E_P_FOUND] != 0;
    const int64_t tgt = clip(s32(e[E_P_TGT]), Bm);
    int64_t pcr = 0;
    uint64_t pr[NCR] = {};
    uint64_t p_timestamp = 0;
    uint32_t rp_pre = 0;
    if (is_pv) {
      const int64_t pg = s32(e[E_P_GROUP]);
      const int64_t p_creator = cy.gc[clip(pg, Bm)];
      const bool p_any = p_dur || (pg >= 0 && p_creator >= 0);
      pcr = clip(p_creator, Bm);
      if (p_dur) {
        durable_p(e, pr);
        p_timestamp = e[E_P_TIMESTAMP];
      } else {
        for (int f = 0; f < NCR; ++f) pr[f] = cy.created[f * Bn + pcr];
        p_timestamp = ts_base + (uint64_t)pcr;
      }
      const uint64_t st = p_dur ? cy.dstat[tgt] : cy.inb[pcr];
      const u128 p_amt = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
      const u128 raw = mk(e[E_AMT_LO], e[E_AMT_HI]);
      rp_pre = pv_verdict(e, flags, p_any, pr, raw != 0 ? raw : p_amt, p_amt, e_any, er, st);
    }
    const u128 p_amount = mk(pr[C_AMT_LO], pr[C_AMT_HI]);
    const u128 raw_amount = mk(e[E_AMT_LO], e[E_AMT_HI]);
    const u128 pv_amount = raw_amount != 0 ? raw_amount : p_amount;
    const bool is_post = flags & F_POST;
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
    if (is_pv) {  // the pending's accounts; a normal lane's are the rows read above
      load_row_cg(table, safe_dr, old_dr);
      load_row_cg(table, safe_cr, old_cr);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        old_dr[c] = drr[c];
        old_cr[c] = crr[c];
      }
    }

    L(L_I) = (uint64_t)i;
    L(L_BITS) = (normal_applied ? LB_NORMAL_APPLIED : 0) | (pv_applied ? LB_PV_APPLIED : 0) |
                (inserted ? LB_INSERTED : 0) | (is_post ? LB_POST : 0) |
                (is_pending ? LB_PENDING : 0) | (p_dur ? LB_P_DUR : 0);
    L(L_R) = r;
    L(L_AMT) = (uint64_t)amount;
    L(L_AMT + 1) = (uint64_t)(amount >> 64);
    L(L_PV) = (uint64_t)pv_amount;
    L(L_PV + 1) = (uint64_t)(pv_amount >> 64);
    L(L_PAMT) = (uint64_t)p_amount;
    L(L_PAMT + 1) = (uint64_t)(p_amount >> 64);
    L(L_SDR) = (uint64_t)safe_dr;
    L(L_SCR) = (uint64_t)safe_cr;
    uint64_t rc[NCR], ndr[8], ncr[8];
    build_record(e, flags, is_pv, up_dr, up_cr, is_pv ? pv_amount : amount, pr, rc);
    snapshot_rows(old_dr, old_cr, is_pv, is_post, is_pending, amount, pv_amount, p_amount, ndr,
                  ncr);
#pragma unroll
    for (int f = 0; f < NCR; ++f) L(L_REC + f) = rc[f];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      L(L_NDR + c) = ndr[c];
      L(L_NCR + c) = ncr[c];
    }
    L(L_PULSE_C) = (normal_applied && is_pending && e[E_TIMEOUT] > 0) ? ts_plus : 0;
    L(L_PULSE_R) = (pv_applied && pr[C_TIMEOUT] > 0) ? p_expires : 0;
    L(L_GIDX) = (uint64_t)clip(s32(e[E_ID_GROUP]), Bm);
    L(L_TGT) = (uint64_t)tgt;
    L(L_PCR) = (uint64_t)pcr;
  }

  // Every lane of the wave has read the pre-wave rows and carry.
  wave_barrier(mode);

  // Apply phase.
  if (L(L_I) == U64_MAX) return;
  const int64_t ii = (int64_t)L(L_I);
  const uint64_t bits = L(L_BITS);
  const bool normal_applied = bits & LB_NORMAL_APPLIED;
  const bool pv_applied = bits & LB_PV_APPLIED;
  const bool inserted = bits & LB_INSERTED;
  const bool is_post = bits & LB_POST;
  const bool is_pending = bits & LB_PENDING;
  uint64_t* drow = table + (int64_t)L(L_SDR) * 8;
  uint64_t* crow = table + (int64_t)L(L_SCR) * 8;

  // Balance effects (columns: 0 dp, 1 dpo, 2 cp, 3 cpo; two words each).
  if (normal_applied) {
    const u128 amount = mk(L(L_AMT), L(L_AMT + 1));
    atomic_add128(drow + (is_pending ? 0 : 2), amount);
    atomic_add128(crow + (is_pending ? 4 : 6), amount);
  }
  if (pv_applied) {
    const u128 pv_amount = mk(L(L_PV), L(L_PV + 1));
    const u128 p_amount = mk(L(L_PAMT), L(L_PAMT + 1));
    if (is_post) {
      atomic_add128(drow + 2, pv_amount);
      atomic_add128(crow + 6, pv_amount);
    }
    atomic_sub128(drow + 0, p_amount);
    atomic_sub128(crow + 4, p_amount);
  }

  // Carry scatters at the lane's own index, then the cross-index ones.
  if (inserted) {
    for (int f = 0; f < NCR; ++f) cy.created[f * Bn + ii] = L(L_REC + f);
    cy.gc[L(L_GIDX)] = ii;
  }
  cy.cmask[ii] = inserted;
  cy.inb[ii] = (normal_applied && is_pending) ? S_PENDING : 0;
  for (int c = 0; c < 8; ++c) {
    cy.hist_dr[ii * 8 + c] = L(L_NDR + c);
    cy.hist_cr[ii * 8 + c] = L(L_NCR + c);
  }
  cy.results[ii] = L(L_R);
  cy.pulse_c[ii] = L(L_PULSE_C);
  cy.pulse_r[ii] = L(L_PULSE_R);
  if (pv_applied) {
    const uint64_t new_status = is_post ? S_POSTED : S_VOIDED;
    if (bits & LB_P_DUR) cy.dstat[L(L_TGT)] = new_status;
    else cy.inb[L(L_PCR)] = new_status;
  }
  if (normal_applied || pv_applied)
    atomicMax(reinterpret_cast<long long*>(cy.scalars + 2), (long long)ii);
}

// The default launch of a K-lane wave (lanes per block, blocks, threads
// per block, barrier), from the shapes timed by tools/serial_probes.py:
// each lane's scattered loads cost its SM one L1 pass per line, so a
// wave spreads wide.  Up to SPREAD_LANES lanes: one block.  Up to 16 x
// CLUSTER_LANES: one cluster of the fewest blocks (a power of two, at
// most 16) that keep a block at SPREAD_LANES lanes or fewer where it
// can.  Beyond: a cooperative grid of GRID_LANES-lane blocks.
void geometry(int K, int& lanes, int& G, int& T, int& mode) {
  if (K <= MAX_CLUSTER * CLUSTER_LANES) {
    G = 1;
    while (G < MAX_CLUSTER && G * SPREAD_LANES < K) G *= 2;
    lanes = (K + G - 1) / G;
    mode = G == 1 ? ONE_BLOCK : CLUSTER;
  } else {
    lanes = GRID_LANES;
    G = (K + lanes - 1) / lanes;
    mode = GRID;
  }
  T = (lanes + 31) / 32 * 32;
}

int launch(uint64_t* table, int64_t A, const uint64_t* ev, int B, const int32_t* idx, int K,
           const uint8_t* mask, int n, uint64_t ts_base, uint64_t* scratch, int lanes, int G,
           int T, int mode, cudaStream_t stream) {
  // Per device: the attributes are set on the current device's context.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(wave_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_LANES));
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(wave_step, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem_bytes(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (mode == CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = mode == GRID ? 1 : 0;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wave_step, table, A, ev, B, idx, K, mask, n, ts_base, scratch,
                           lanes, mode);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The default launch of a K-lane wave: blocks, threads per block,
// barrier mode (0 one block, 1 cluster, 2 cooperative grid) and lanes
// per block into geom[0..3].
extern "C" int tb_wave_step_geometry(int K, int* geom) {
  geometry(K, geom[3], geom[0], geom[1], geom[2]);
  return 0;
}

// One wave: table (A, 8) u64 and the carry (57 * B + 4 u64 words) in
// place; ev (B, 52) u64, 16-byte aligned; idx (K,) int32 global event
// indices; mask (K,) u8 or null (the speculative commit mask).  One
// launch; a launch the card refuses returns its error.
extern "C" int tb_wave_step(void* table, int64_t A, const void* ev, int B, const void* idx,
                            int K, const void* mask, int n, uint64_t ts_base, void* scratch,
                            void* stream) {
  if (K <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(ev) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  int lanes, G, T, mode;
  geometry(K, lanes, G, T, mode);
  return launch(static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
                static_cast<const int32_t*>(idx), K, static_cast<const uint8_t*>(mask), n,
                ts_base, static_cast<uint64_t*>(scratch), lanes, G, T, mode,
                static_cast<cudaStream_t>(stream));
}

// The same wave at a launch shape the caller picks (the measurement
// probes' comparison of shapes): `lanes` lanes per block (1 to 256, in
// threads rounded up to 32), one block or one cluster (at most 16
// blocks) or, with `grid`, a cooperative grid.
extern "C" int tb_wave_step_shaped(void* table, int64_t A, const void* ev, int B,
                                   const void* idx, int K, const void* mask, int n,
                                   uint64_t ts_base, void* scratch, int lanes, int grid,
                                   void* stream) {
  if (K <= 0) return 0;
  if (lanes < 1 || lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(ev) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int G = (K + lanes - 1) / lanes;
  const int mode = grid ? GRID : (G == 1 ? ONE_BLOCK : CLUSTER);
  if (mode == CLUSTER && G > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  return launch(static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
                static_cast<const int32_t*>(idx), K, static_cast<const uint8_t*>(mask), n,
                ts_base, static_cast<uint64_t*>(scratch), lanes, G, (lanes + 31) / 32 * 32,
                mode, static_cast<cudaStream_t>(stream));
}
