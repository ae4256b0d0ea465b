// K8: one chain wave — a contiguous run of mutually independent linked
// chains, executed one chain POSITION at a time.
//
// Replaces tigerbeetle_tpu/state_machine/waves.py:1354 (_chain_wave_impl:
// a lax.scan over chain positions of the wave step's normal-create path
// plus the scan's chain machinery, then the dead-chain repair
// :1587-1626).  Input: a (P, C) int32 plane of global event indices,
// position-major, one lane per chain (an index outside [0, n) is a
// padding cell), the batch's (B, 52) packed events, the carry in K3's
// scratch layout and the (A, 8) table, updated in place.
//
// Order is part of the result.  Chains may both write one balance slot
// when nobody reads it (the admission, waves._chain_wave_steps); the
// snapshot a member takes at position p is the whole row — every
// chain's adds from positions < p plus its own, nothing of another
// chain's position p — and a member of a chain that dies keeps that
// snapshot (its result becomes 1, so finalize leaves it).  One thread
// walking its chain to the end would put other chains' later adds into
// it.  So each position has a read phase and an apply phase with a
// barrier between them: one block of 1024 threads, each lane's chain
// state (alive) kept across positions, __syncthreads as the barrier.
//
//   read   per lane: chain_open / alive / static precedence, the
//          durable exists ladder, the balancing clamps, the overflow and
//          limit ladder against the rows as of positions < p (read
//          around L1: the apply phase's atomics land in L2); the
//          record, id directory, inb_status, snapshot, result and pulse
//          at the member's own index; the amount into a per-cell log
//   apply  per lane: the member's adds, exact u128 by 64-bit atomics
//          carrying into the high word (commuting across chains)
//   repair after the last position, per dead chain: every applied
//          member's adds subtracted again, its result set to 1 and its
//          created_mask, inb_status and id-directory entry cleared; the
//          records and the pulses stay, as in the reference
//
// What bounds it: the 2P dependent phases, each at least one L2 round
// trip for the rows it reads (~1 us per position at this size); the
// bytes (events, rows, carry) are ~2 us at 3.35 TB/s for 8 x 4096 cells.
// One block keeps the barrier cheap; it uses one SM of 132.

#include <cstdint>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace {

using namespace tbs;

constexpr int THREADS = 1024;
// Per-cell log words: amount lo, amount hi, bits (1 applied, 2 pending).
constexpr int YW = 3;

__global__ void __launch_bounds__(THREADS)
chain_wave(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev, int B,
           const int32_t* __restrict__ plane, int P, int C, int n, uint64_t ts_base,
           uint64_t* __restrict__ s, uint64_t* __restrict__ ys, uint8_t* __restrict__ alive) {
  const int64_t Bn = B, Bm = Bn - 1, Am = A - 1;
  const Carry cy = carry_of(s, Bn);
  for (int c = threadIdx.x; c < C; c += THREADS) alive[c] = 1;
  for (int p = 0; p < P; ++p) {
    // Read phase.
    for (int c = threadIdx.x; c < C; c += THREADS) {
      uint64_t* y = ys + ((size_t)p * C + c) * YW;
      y[2] = 0;
      const int64_t row = plane[(size_t)p * C + c];
      if (row < 0 || row >= Bn) continue;
      const uint64_t* e = ev + row * NEV;
      const int64_t i = s32(e[E_I]);
      if (i < 0 || i >= n) continue;  // inactive: writes nothing
      const uint32_t flags = (uint32_t)e[E_FLAGS];
      const bool chain_open = (flags & F_LINKED) && i == n - 1;
      uint32_t pre;
      if (chain_open) pre = LINKED_EVENT_CHAIN_OPEN;
      else if (!alive[c]) pre = LINKED_EVENT_FAILED;
      else if (e[E_TS_NONZERO]) pre = TIMESTAMP_MUST_BE_ZERO;
      else pre = (uint32_t)e[E_STATIC];
      // Exists: ids are claimed once batch-wide, so only a durable
      // duplicate can exist.
      const bool e_any = e[E_E_FOUND] != 0;
      uint64_t er[NCR];
      durable_e(e, er);
      const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
      const int64_t safe_dr = clip(ev_dr, Am), safe_cr = clip(ev_cr, Am);
      uint64_t drr[8], crr[8];
      load_row_cg(table, safe_dr, drr);
      load_row_cg(table, safe_cr, crr);
      u128 amount;
      uint64_t ts_plus;
      const uint32_t rn =
          normal_verdict(e, flags, drr, crr, ts_base + (uint64_t)i, e_any, er, amount, ts_plus);
      const bool gate = pre == 0;
      const uint32_t r = gate ? rn : pre;
      const bool applied = gate && rn == 0;
      if (alive[c] && r != 0) alive[c] = 0;
      const bool is_pending = flags & F_PENDING;
      uint64_t new_dr[8], new_cr[8];
      snapshot_rows(drr, crr, false, false, is_pending, amount, 0, 0, new_dr, new_cr);
      if (applied) {
        uint64_t rec[NCR];
        build_record(e, flags, false, ev_dr, ev_cr, amount, er, rec);
        for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = rec[f];
        cy.gc[clip(s32(e[E_ID_GROUP]), Bm)] = i;
        atomicMax(reinterpret_cast<long long*>(cy.scalars + 2), (long long)i);
      }
      cy.cmask[i] = applied;
      cy.inb[i] = (applied && is_pending) ? S_PENDING : 0;
      for (int k = 0; k < 8; ++k) {
        cy.hist_dr[i * 8 + k] = new_dr[k];
        cy.hist_cr[i * 8 + k] = new_cr[k];
      }
      cy.results[i] = r;
      cy.pulse_c[i] = (applied && is_pending && e[E_TIMEOUT] > 0) ? ts_plus : 0;
      y[0] = (uint64_t)amount;
      y[1] = (uint64_t)(amount >> 64);
      y[2] = (applied ? 1 : 0) | (is_pending ? 2 : 0);
    }
    __syncthreads();
    // Apply phase.
    for (int c = threadIdx.x; c < C; c += THREADS) {
      const uint64_t* y = ys + ((size_t)p * C + c) * YW;
      if (!(y[2] & 1)) continue;
      const uint64_t* e = ev + (int64_t)plane[(size_t)p * C + c] * NEV;
      const bool is_pending = y[2] & 2;
      const u128 amount = mk(y[0], y[1]);
      atomic_add128(table + clip(s32(e[E_DR]), Am) * 8 + (is_pending ? 0 : 2), amount);
      atomic_add128(table + clip(s32(e[E_CR]), Am) * 8 + (is_pending ? 4 : 6), amount);
    }
    __syncthreads();
  }
  // Dead-chain repair.
  for (int c = threadIdx.x; c < C; c += THREADS) {
    if (alive[c]) continue;
    for (int p = 0; p < P; ++p) {
      const uint64_t* y = ys + ((size_t)p * C + c) * YW;
      if (!(y[2] & 1)) continue;
      const int64_t row = plane[(size_t)p * C + c];
      const uint64_t* e = ev + row * NEV;
      const int64_t i = s32(e[E_I]);
      const bool is_pending = y[2] & 2;
      const u128 amount = mk(y[0], y[1]);
      atomic_sub128(table + clip(s32(e[E_DR]), Am) * 8 + (is_pending ? 0 : 2), amount);
      atomic_sub128(table + clip(s32(e[E_CR]), Am) * 8 + (is_pending ? 4 : 6), amount);
      cy.results[i] = LINKED_EVENT_FAILED;
      cy.cmask[i] = 0;
      cy.inb[i] = 0;
      cy.gc[clip(s32(e[E_ID_GROUP]), Bm)] = -1;
    }
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Log words per (position, chain) cell.
extern "C" int64_t tb_chain_wave_cell_words() { return YW; }

// One chain wave: table (A, 8) u64 and the carry (57 * B + 4 u64 words)
// in place; ev (B, 52) u64; plane (P, C) int32; ys P * C * 3 u64 words
// and alive C bytes of scratch.
extern "C" int tb_chain_wave(void* table, int64_t A, const void* ev, int B, const void* plane,
                             int P, int C, int n, uint64_t ts_base, void* scratch, void* ys,
                             void* alive, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  chain_wave<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(plane), P, C, n, ts_base, static_cast<uint64_t*>(scratch),
      static_cast<uint64_t*>(ys), static_cast<uint8_t*>(alive));
  return (int)cudaGetLastError();
}
