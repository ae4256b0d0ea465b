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
// barrier between them, 2P - 1 barriers in all (the last apply and the
// repair are commuting atomics that nobody reads).
//
//   read   per chain: chain_open / alive / static precedence, the
//          durable exists ladder, the balancing clamps, the overflow and
//          limit ladder against the rows as of positions < p (read
//          around L1: the apply phase's atomics land in L2); the
//          record, id directory, inb_status, snapshot, result and pulse
//          at the member's own index
//   apply  per chain: the member's adds, exact u128 by 64-bit atomics
//          carrying into the high word (commuting across chains)
//   repair after the last position, per dead chain: every applied
//          member's adds subtracted again (the amount from its created
//          record, which stays), its result set to 1 and its
//          created_mask, inb_status and id-directory entry cleared; the
//          records and the pulses stay, as in the reference
//
// What bounds it: each position moves ~0.9 KB per chain through L2 (the
// event row, two table rows in; the record, two snapshots and the
// carry words out: ~3.7 MB for 4096 chains) and takes a few dependent
// L2 round trips, then two barriers.  Through one SM's path to L2 the
// bytes alone take ~40 us a position.  So the chains are spread over a
// thread-block cluster of up to 16 blocks on 16 SMs (a cooperative grid
// over every SM has a barrier twice as slow), one chain per thread for
// the whole wave (C <= n <= 8190 <= 16 x 512): its alive flag and last
// applied index stay in registers, and the log the repair needs is the
// carry itself (created_mask and the created record's amount).  The
// barrier is the cluster's hardware barrier (barrier.cluster
// arrive.release / wait.acquire; __syncthreads for a one-block wave): an
// apply phase's atomics, made at L2, are visible to every block's reads
// of the next position.  One launch per chain wave; blocks of at most
// 512 threads leave the body 128 registers.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tbs;

constexpr int MAX_THREADS = 512;  // threads per block, one chain each
constexpr int MAX_CLUSTER = 16;   // blocks per cluster (above 8: non-portable)
constexpr int MIN_THREADS = 64;   // a block's fewest threads before the cluster grows

// The barrier between phases: the block's own when the wave is one
// block (cheaper than the cluster's), else the cluster's.
__device__ __forceinline__ void phase_barrier(cg::cluster_group& cluster) {
  if (gridDim.x == 1) __syncthreads();
  else cluster.sync();
}

__global__ void __launch_bounds__(MAX_THREADS)
chain_wave(uint64_t* __restrict__ table, int64_t A, const uint64_t* __restrict__ ev, int B,
           const int32_t* __restrict__ plane, int P, int C, int n, uint64_t ts_base,
           uint64_t* __restrict__ s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t Bn = B, Bm = Bn - 1, Am = A - 1;
  const Carry cy = carry_of(s, Bn);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = c < C;
  bool alive = true;
  int last = -1;  // largest applied index
  for (int p = 0; p < P; ++p) {
    // Read phase.
    bool applied = false, is_pending = false;
    u128 amount = 0;
    int64_t safe_dr = 0, safe_cr = 0;
    const int64_t row = mine ? plane[(size_t)p * C + c] : -1;
    if (row >= 0 && row < Bn) {
      const uint64_t* e = ev + row * NEV;
      const int64_t i = s32(e[E_I]);
      if (i >= 0 && i < n) {  // else inactive: writes nothing
        const uint32_t flags = (uint32_t)e[E_FLAGS];
        const bool chain_open = (flags & F_LINKED) && i == n - 1;
        uint32_t pre;
        if (chain_open) pre = LINKED_EVENT_CHAIN_OPEN;
        else if (!alive) pre = LINKED_EVENT_FAILED;
        else if (e[E_TS_NONZERO]) pre = TIMESTAMP_MUST_BE_ZERO;
        else pre = (uint32_t)e[E_STATIC];
        // Exists: ids are claimed once batch-wide, so only a durable
        // duplicate can exist.
        const bool e_any = e[E_E_FOUND] != 0;
        uint64_t er[NCR];
        durable_e(e, er);
        const int64_t ev_dr = s32(e[E_DR]), ev_cr = s32(e[E_CR]);
        safe_dr = clip(ev_dr, Am);
        safe_cr = clip(ev_cr, Am);
        uint64_t drr[8], crr[8];
        load_row_cg(table, safe_dr, drr);
        load_row_cg(table, safe_cr, crr);
        uint64_t ts_plus;
        const uint32_t rn =
            normal_verdict(e, flags, drr, crr, ts_base + (uint64_t)i, e_any, er, amount, ts_plus);
        const bool gate = pre == 0;
        const uint32_t r = gate ? rn : pre;
        applied = gate && rn == 0;
        if (r != 0) alive = false;
        is_pending = flags & F_PENDING;
        uint64_t new_dr[8], new_cr[8];
        snapshot_rows(drr, crr, false, false, is_pending, amount, 0, 0, new_dr, new_cr);
        if (applied) {
          uint64_t rec[NCR];
          build_record(e, flags, false, ev_dr, ev_cr, amount, er, rec);
          for (int f = 0; f < NCR; ++f) cy.created[f * Bn + i] = rec[f];
          cy.gc[clip(s32(e[E_ID_GROUP]), Bm)] = i;
          last = (int)i;
        }
        cy.cmask[i] = applied;
        cy.inb[i] = (applied && is_pending) ? S_PENDING : 0;
        for (int k = 0; k < 8; ++k) {
          cy.hist_dr[i * 8 + k] = new_dr[k];
          cy.hist_cr[i * 8 + k] = new_cr[k];
        }
        cy.results[i] = r;
        cy.pulse_c[i] = (applied && is_pending && e[E_TIMEOUT] > 0) ? ts_plus : 0;
      }
    }
    phase_barrier(cluster);
    // Apply phase.
    if (applied) {
      atomic_add128(table + safe_dr * 8 + (is_pending ? 0 : 2), amount);
      atomic_add128(table + safe_cr * 8 + (is_pending ? 4 : 6), amount);
    }
    if (p + 1 < P) phase_barrier(cluster);
  }
  // Dead-chain repair: this thread's own chain, from what it wrote.
  if (mine && !alive) {
    for (int p = 0; p < P; ++p) {
      const int64_t row = plane[(size_t)p * C + c];
      if (row < 0 || row >= Bn) continue;
      const uint64_t* e = ev + row * NEV;
      const int64_t i = s32(e[E_I]);
      if (i < 0 || i >= n || !cy.cmask[i]) continue;
      const bool is_pending = (uint32_t)e[E_FLAGS] & F_PENDING;
      const u128 amount = mk(cy.created[C_AMT_LO * Bn + i], cy.created[C_AMT_HI * Bn + i]);
      atomic_sub128(table + clip(s32(e[E_DR]), Am) * 8 + (is_pending ? 0 : 2), amount);
      atomic_sub128(table + clip(s32(e[E_CR]), Am) * 8 + (is_pending ? 4 : 6), amount);
      cy.results[i] = LINKED_EVENT_FAILED;
      cy.cmask[i] = 0;
      cy.inb[i] = 0;
      cy.gc[clip(s32(e[E_ID_GROUP]), Bm)] = -1;
    }
  }
  // last_applied: the largest applied index, one atomic per warp.
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0 && last >= 0)
    atomicMax(reinterpret_cast<long long*>(cy.scalars + 2), (long long)last);
}

// Blocks per cluster for C chains: the fewest (a power of two, at most
// MAX_CLUSTER) that keep a block at MIN_THREADS chains or fewer, so the
// chains spread over as many SMs as there are warps of them to give.
int cluster_blocks(int C) {
  int g = 1;
  while (g < MAX_CLUSTER && g * MIN_THREADS < C) g *= 2;
  return g;
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch geometry of a C-chain wave: blocks (one cluster) and
// threads per block, into geom[0], geom[1].
extern "C" int tb_chain_wave_geometry(int C, int* geom) {
  const int g = cluster_blocks(C);
  geom[0] = g;
  geom[1] = ((C + g - 1) / g + 31) / 32 * 32;
  return 0;
}

// One chain wave: table (A, 8) u64 and the carry (57 * B + 4 u64 words)
// in place; ev (B, 52) u64; plane (P, C) int32, C <= 16 x 512.  One
// cluster of up to 16 blocks; a launch the card refuses returns its
// error.
extern "C" int tb_chain_wave(void* table, int64_t A, const void* ev, int B, const void* plane,
                             int P, int C, int n, uint64_t ts_base, void* scratch,
                             void* stream) {
  if (P <= 0 || C <= 0) return 0;
  if (C > MAX_CLUSTER * MAX_THREADS) return (int)cudaErrorInvalidValue;
  int geom[2];
  tb_chain_wave_geometry(C, geom);
  if (geom[0] > 8) {
    // Per device: the attribute is set on the current device's context.
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(chain_wave, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geom[0]);
  cfg.blockDim = dim3(geom[1]);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geom[0];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chain_wave, static_cast<uint64_t*>(table), A, static_cast<const uint64_t*>(ev), B,
      static_cast<const int32_t*>(plane), P, C, n, ts_base, static_cast<uint64_t*>(scratch));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
