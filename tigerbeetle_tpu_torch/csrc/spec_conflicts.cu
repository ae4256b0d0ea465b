// K9: speculative conflict validation — per-lane blocked flags for one
// speculative wave step.
//
// Replaces tigerbeetle_tpu/state_machine/waves.py:1971 (_spec_conflicts:
// the wavefront's round-0 blocked test, computed on the device from the
// event columns alone).  An event is committable when no EARLIER event
// of the batch conflicts with it:
//
//   - serial tokens: only the smallest-index claimant of an id/pending
//     group (id_group and p_group share one space) or of a durable
//     first-wins target (p_tgt) is unblocked;
//   - balance slots: a reader (balancing clamp, limit check) is
//     unblocked only as the smallest-index toucher of its slot, a writer
//     only when no earlier reader touches it (commuting writers share);
//   - spec_serial force-blocks what the wave step does not model (chain
//     members, history events, serialized post/voids).
//
// Segmented minima by atomicMin into four int32 arrays — tokens (B),
// targets (B), all touchers (A) and readers (A) — that REST at INT_MAX
// between calls, then a read pass, then a reset pass that returns every
// entry this batch touched to INT_MAX (as K6's first-wins array is
// reset).  Clearing the two 2^20-entry slot arrays per batch would move
// 8 MiB (~2.5 us at 3.35 TB/s plus a launch); the reset touches at most
// 6 entries per lane.  Three launches: the minima must be complete
// before any lane reads them, and read before any is reset.
//
// What bounds it: bytes — each lane reads ~10 of its event's 52 columns
// and does up to 9 atomics and 9 reads on the arrays; ~0.2 us at
// 3.35 TB/s for 8192 lanes, well under the launches' own cost.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tb_scan.cuh"

namespace {

using namespace tbs;

constexpr int THREADS = 256;
constexpr int32_t REST = INT_MAX;

// One lane's conflict entries.
struct Entries {
  int32_t i;
  int64_t idg, pgc, ptc;      // clipped token / target indices
  bool pgm, ptm;
  bool read_dr, read_cr, wm0, wm1;
  int64_t dr_c, cr_c, w0_c, w1_c;
};

// False for a padding or inactive lane.
__device__ inline bool entries(const uint64_t* __restrict__ ev, int64_t Bn,
                               const int32_t* __restrict__ idx, int k, int n, int64_t A,
                               Entries& x) {
  const int64_t row = idx[k];
  if (row < 0 || row >= Bn) return false;
  const uint64_t* e = ev + row * NEV;
  const int64_t i = s32(e[E_I]);
  if (i < 0 || i >= n) return false;
  x.i = (int32_t)i;
  const int64_t Bm = Bn - 1, Am = A - 1;
  const uint32_t flags = (uint32_t)e[E_FLAGS];
  const bool is_pv = flags & (F_POST | F_VOID);
  x.idg = clip(s32(e[E_ID_GROUP]), Bm);
  const int64_t pg = s32(e[E_P_GROUP]);
  x.pgm = pg >= 0;
  x.pgc = clip(pg, Bm);
  const int64_t pt = s32(e[E_P_TGT]);
  x.ptm = pt >= 0;
  x.ptc = clip(pt, Bm);
  const int64_t dr = s32(e[E_DR]), cr = s32(e[E_CR]);
  x.read_dr = !is_pv && dr >= 0 &&
              ((flags & F_BAL_DR) || ((uint32_t)e[E_DR_FLAGS] & AF_DR_LIMIT));
  x.read_cr = !is_pv && cr >= 0 &&
              ((flags & F_BAL_CR) || ((uint32_t)e[E_CR_FLAGS] & AF_CR_LIMIT));
  const bool pf = e[E_P_FOUND] != 0;
  const int64_t w0 = is_pv ? (pf ? s32(e[E_P_DR]) : -1) : dr;
  const int64_t w1 = is_pv ? (pf ? s32(e[E_P_CR]) : -1) : cr;
  x.wm0 = w0 >= 0;
  x.wm1 = w1 >= 0;
  x.dr_c = clip(dr, Am);
  x.cr_c = clip(cr, Am);
  x.w0_c = clip(w0, Am);
  x.w1_c = clip(w1, Am);
  return true;
}

__global__ void spec_min(const uint64_t* __restrict__ ev, int B, const int32_t* __restrict__ idx,
                         int K, int n, int64_t A, int32_t* tok, int32_t* tgt, int32_t* a_min,
                         int32_t* r_min) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  Entries x;
  if (k >= K || !entries(ev, B, idx, k, n, A, x)) return;
  atomicMin(&tok[x.idg], x.i);
  if (x.pgm) atomicMin(&tok[x.pgc], x.i);
  if (x.ptm) atomicMin(&tgt[x.ptc], x.i);
  if (x.read_dr) {
    atomicMin(&a_min[x.dr_c], x.i);
    atomicMin(&r_min[x.dr_c], x.i);
  }
  if (x.read_cr) {
    atomicMin(&a_min[x.cr_c], x.i);
    atomicMin(&r_min[x.cr_c], x.i);
  }
  if (x.wm0) atomicMin(&a_min[x.w0_c], x.i);
  if (x.wm1) atomicMin(&a_min[x.w1_c], x.i);
}

__global__ void spec_read(const uint64_t* __restrict__ ev, int B, const int32_t* __restrict__ idx,
                          int K, int n, int64_t A, const int32_t* __restrict__ tok,
                          const int32_t* __restrict__ tgt, const int32_t* __restrict__ a_min,
                          const int32_t* __restrict__ r_min, const uint8_t* __restrict__ serial,
                          uint8_t* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  Entries x;
  if (!entries(ev, B, idx, k, n, A, x)) {
    out[k] = 0;
    return;
  }
  bool blk = x.i > tok[x.idg];
  blk |= x.pgm && x.i > tok[x.pgc];
  blk |= x.ptm && x.i > tgt[x.ptc];
  blk |= x.read_dr && x.i > a_min[x.dr_c];
  blk |= x.read_cr && x.i > a_min[x.cr_c];
  blk |= x.wm0 && x.i > r_min[x.w0_c];
  blk |= x.wm1 && x.i > r_min[x.w1_c];
  blk |= serial != nullptr && serial[k] != 0;
  out[k] = blk;
}

__global__ void spec_reset(const uint64_t* __restrict__ ev, int B, const int32_t* __restrict__ idx,
                           int K, int n, int64_t A, int32_t* tok, int32_t* tgt, int32_t* a_min,
                           int32_t* r_min) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  Entries x;
  if (k >= K || !entries(ev, B, idx, k, n, A, x)) return;
  tok[x.idg] = REST;
  if (x.pgm) tok[x.pgc] = REST;
  if (x.ptm) tgt[x.ptc] = REST;
  if (x.read_dr) {
    a_min[x.dr_c] = REST;
    r_min[x.dr_c] = REST;
  }
  if (x.read_cr) {
    a_min[x.cr_c] = REST;
    r_min[x.cr_c] = REST;
  }
  if (x.wm0) a_min[x.w0_c] = REST;
  if (x.wm1) a_min[x.w1_c] = REST;
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Conflict flags of K lanes (global event indices idx, int32) into out
// (K,) u8; serial (K,) u8 or null.  tok and tgt hold B int32, a_min and
// r_min A int32, all at INT_MAX on entry and on return.
extern "C" int tb_spec_conflicts(const void* ev, int B, const void* idx, int K,
                                 const void* serial, int n, int64_t A, void* tok, void* tgt,
                                 void* a_min, void* r_min, void* out, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (K + THREADS - 1) / THREADS;
  const uint64_t* e = static_cast<const uint64_t*>(ev);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* t = static_cast<int32_t*>(tok);
  int32_t* g = static_cast<int32_t*>(tgt);
  int32_t* a = static_cast<int32_t*>(a_min);
  int32_t* r = static_cast<int32_t*>(r_min);
  spec_min<<<blocks, THREADS, 0, st>>>(e, B, ix, K, n, A, t, g, a, r);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  spec_read<<<blocks, THREADS, 0, st>>>(e, B, ix, K, n, A, t, g, a, r,
                                        static_cast<const uint8_t*>(serial),
                                        static_cast<uint8_t*>(out));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  spec_reset<<<blocks, THREADS, 0, st>>>(e, B, ix, K, n, A, t, g, a, r);
  return (int)cudaGetLastError();
}
