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
// What bounds it: latency.  Each lane reads 12 of its event's 52
// columns and makes up to 7 atomics and 7 reads on the minima arrays:
// ~0.25 us of bytes at 3.35 TB/s for 8192 lanes, far under the chain of
// dependent steps that every lane must pass (its index, its event row,
// the minima, a barrier where every lane's minima are complete, its
// reads, its flag).  So the batch runs as ONE cooperative launch (grid
// from the SM count, one lane a thread; K1's and K6's geometry): each
// lane decodes its entries once and keeps them in registers, takes its
// minima by atomicMin, meets every other lane at one grid barrier, reads
// and stores its flag.  A touch of a slot the lane also writes is the
// same address and value as the write's own (a reader writes its slot),
// so the touchers' minima take only the two writes.
//
// No reset pass.  Segmented minima live in four u32 arrays — tokens and
// targets (one per batch row), touchers and readers (one per table row)
// — whose entries carry the call's tag: an entry is ((TAG_TOP - tag) <<
// LANE_BITS) | i, and a lane's test is one unsigned compare against its
// own encoding.  The caller counts the calls made on the arrays; call c
// takes tag c % TAG_TOP + 1, so the tag rises once a call from 1 to
// TAG_TOP.  An entry of an earlier call is larger than any of this
// call's, so it loses every atomicMin and reads as absent, as the
// resting value (all ones) does; the reads that can meet one are the
// readers' minima at the lane's written slots (the other reads see the
// lane's own atomics).  A call that takes tag 1, and the first call on
// arrays just made, fills every entry at rest first, then meets the
// other lanes at one more grid barrier, in the same launch.  Clearing
// the two 2^20-entry slot arrays every call would move 8 MiB.  This file
// alone knows the encoding: the caller passes the call count.
//
// Measured the other ways (PERF.md, the K9 row): an in-launch reset
// behind a second grid barrier, warp-combined atomics, event rows staged
// through shared memory, the columns loaded as 16-byte pieces, and 128-
// or 256-lane blocks were each slower on the main path's batches or no
// faster.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "tb_hash.cuh"
#include "tb_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tbs;

constexpr uint32_t REST = 0xFFFFFFFFu;
constexpr int LANE_BITS = 13;  // an event index below 8192
constexpr int MAX_LANES = 1 << LANE_BITS;
constexpr uint32_t TAG_TOP = (1u << (32 - LANE_BITS)) - 1;
constexpr int THREADS = 64;  // a block's lanes, more only past one block an SM
constexpr int MAX_THREADS = 256;

// One lane's conflict entries.
struct Entries {
  uint32_t enc;                // ((TAG_TOP - tag) << LANE_BITS) | i
  int32_t idg, pgc, ptc;       // clipped token / target indices
  int32_t dr_c, cr_c, w0_c, w1_c;
  bool pgm, ptm, read_dr, read_cr, wm0, wm1, serial;
};

// Lane k's entries from its event row (columns by index); `have` false
// for a padding or inactive lane.
__device__ __forceinline__ void decode(const uint64_t* __restrict__ ev, int64_t Bn,
                                       const int32_t* __restrict__ idx, int64_t k, int n,
                                       int64_t A, const uint8_t* __restrict__ serial,
                                       uint32_t hi, Entries& x, bool& have) {
  x = Entries{};
  x.serial = serial != nullptr && serial[k] != 0;
  have = false;
  const int64_t row = idx[k];
  if (row < 0 || row >= Bn) return;
  const unsigned long long* e = reinterpret_cast<const unsigned long long*>(ev + row * NEV);
  const int64_t i = s32(__ldg(e + E_I));
  if (i < 0 || i >= n) return;
  have = true;
  x.enc = hi | (uint32_t)i;
  const int64_t Bm = Bn - 1, Am = A - 1;
  const uint32_t flags = (uint32_t)__ldg(e + E_FLAGS);
  const bool is_pv = flags & (F_POST | F_VOID);
  x.idg = (int32_t)clip(s32(__ldg(e + E_ID_GROUP)), Bm);
  const int64_t pg = s32(__ldg(e + E_P_GROUP));
  x.pgm = pg >= 0;
  x.pgc = (int32_t)clip(pg, Bm);
  const int64_t pt = s32(__ldg(e + E_P_TGT));
  x.ptm = pt >= 0;
  x.ptc = (int32_t)clip(pt, Bm);
  const int64_t dr = s32(__ldg(e + E_DR)), cr = s32(__ldg(e + E_CR));
  x.read_dr = !is_pv && dr >= 0 &&
              ((flags & F_BAL_DR) || ((uint32_t)__ldg(e + E_DR_FLAGS) & AF_DR_LIMIT));
  x.read_cr = !is_pv && cr >= 0 &&
              ((flags & F_BAL_CR) || ((uint32_t)__ldg(e + E_CR_FLAGS) & AF_CR_LIMIT));
  const bool pf = __ldg(e + E_P_FOUND) != 0;
  const int64_t w0 = is_pv ? (pf ? s32(__ldg(e + E_P_DR)) : -1) : dr;
  const int64_t w1 = is_pv ? (pf ? s32(__ldg(e + E_P_CR)) : -1) : cr;
  x.wm0 = w0 >= 0;
  x.wm1 = w1 >= 0;
  x.dr_c = (int32_t)clip(dr, Am);
  x.cr_c = (int32_t)clip(cr, Am);
  x.w0_c = (int32_t)clip(w0, Am);
  x.w1_c = (int32_t)clip(w1, Am);
}

struct Arrays {
  uint32_t* tok;
  uint32_t* tgt;
  uint32_t* a_min;
  uint32_t* r_min;
  int64_t tok_n, a_n;  // entries of tok / tgt and of a_min / r_min
};

// The cooperative launch: the thread's lanes are its index in the grid,
// + the grid's threads, ...
__global__ void spec_kernel(const uint64_t* __restrict__ ev, int Bn,
                            const int32_t* __restrict__ idx, int K, int n, int64_t A,
                            const uint8_t* __restrict__ serial, Arrays X, uint32_t tag,
                            bool fill, uint8_t* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (fill) {
    for (int64_t j = t; j < X.tok_n; j += stride) X.tok[j] = X.tgt[j] = REST;
    for (int64_t j = t; j < X.a_n; j += stride) X.a_min[j] = X.r_min[j] = REST;
    grid.sync();
  }
  const uint32_t hi = (TAG_TOP - tag) << LANE_BITS;
  // The thread's first lane keeps its entries across the barrier; any
  // later lane (K above the grid's threads) decodes them again.
  Entries x0{};
  bool have0 = false;
  for (int64_t k = t; k < K; k += stride) {
    Entries x;
    bool have;
    decode(ev, Bn, idx, k, n, A, serial, hi, x, have);
    if (have) {
      atomicMin(X.tok + x.idg, x.enc);
      if (x.pgm) atomicMin(X.tok + x.pgc, x.enc);
      if (x.ptm) atomicMin(X.tgt + x.ptc, x.enc);
      if (x.wm0) atomicMin(X.a_min + x.w0_c, x.enc);
      if (x.wm1) atomicMin(X.a_min + x.w1_c, x.enc);
      if (x.read_dr) atomicMin(X.r_min + x.dr_c, x.enc);
      if (x.read_cr) atomicMin(X.r_min + x.cr_c, x.enc);
    }
    if (k == t) {
      x0 = x;
      have0 = have;
    }
  }
  grid.sync();
  for (int64_t k = t; k < K; k += stride) {
    Entries x = x0;
    bool have = have0;
    if (k != t) decode(ev, Bn, idx, k, n, A, serial, hi, x, have);
    bool blk = false;
    if (have) {
      const uint32_t v = x.enc;
      blk = x.serial || __ldcg(X.tok + x.idg) < v;
      blk |= x.pgm && __ldcg(X.tok + x.pgc) < v;
      blk |= x.ptm && __ldcg(X.tgt + x.ptc) < v;
      blk |= x.read_dr && __ldcg(X.a_min + x.dr_c) < v;
      blk |= x.read_cr && __ldcg(X.a_min + x.cr_c) < v;
      blk |= x.wm0 && __ldcg(X.r_min + x.w0_c) < v;
      blk |= x.wm1 && __ldcg(X.r_min + x.w1_c) < v;
    }
    out[k] = blk;
  }
}

// The cooperative grid of a K-lane call: THREADS-lane blocks, more
// threads (up to MAX_THREADS) only past one block an SM, at most one
// block an SM; lanes past the grid's threads loop.
void geometry(int K, int sms, int& G, int& T) {
  T = THREADS;
  while ((K + T - 1) / T > sms && T < MAX_THREADS) T *= 2;
  G = (K + T - 1) / T;
  G = G < 1 ? 1 : (G > sms ? sms : G);
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K9's launch for K lanes on the current card: blocks of its cooperative
// grid and threads a block, into geom[0..1]; a CUDA status.
extern "C" int tb_spec_conflicts_geometry(int K, int* geom) {
  int sms = 0;
  const int err = tb::sm_count(sms);
  if (err) return err;
  geometry(K, sms, geom[0], geom[1]);
  return 0;
}

// The calls a tag cycle lasts: call c on the arrays takes tag c % this
// + 1, and the call that takes tag 1 fills them at rest first.
extern "C" int tb_spec_conflicts_cycle() { return (int)TAG_TOP; }

// Conflict flags of K lanes (global event indices idx, int32) into out
// (K,) u8; serial (K,) u8 or null.  tok and tgt hold tok_n u32 entries
// (tok_n >= B), a_min and r_min a_n (>= A).  `calls` counts the calls
// made on these arrays before this one; `fresh` says they hold nothing
// of this kernel's (just made), so this call fills them at rest first,
// as the call that takes tag 1 does.  B <= 8192 and n <= 8192.  One
// cooperative launch on `stream` (none for K = 0 unless it fills); a
// CUDA status.
extern "C" int tb_spec_conflicts(const void* ev, int B, const void* idx, int K,
                                 const void* serial, int n, int64_t A, void* tok, void* tgt,
                                 int64_t tok_n, void* a_min, void* r_min, int64_t a_n,
                                 int64_t calls, int fresh, void* out, void* stream) {
  if (B < 1 || B > MAX_LANES || n > MAX_LANES || tok_n < B || a_n < A || A < 1 || K < 0 ||
      calls < 0)
    return (int)cudaErrorInvalidValue;
  uint32_t tag = (uint32_t)(calls % TAG_TOP) + 1;
  bool fill = fresh || tag == 1;
  if (K == 0 && !fill) return 0;
  int sms = 0, G, T;
  const int err = tb::sm_count(sms);
  if (err) return err;
  // A fill spreads over the whole grid, whatever the lanes.
  geometry(fill && K < MAX_LANES ? MAX_LANES : K, sms, G, T);
  const uint64_t* e = static_cast<const uint64_t*>(ev);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const uint8_t* s = static_cast<const uint8_t*>(serial);
  Arrays X{static_cast<uint32_t*>(tok), static_cast<uint32_t*>(tgt),
           static_cast<uint32_t*>(a_min), static_cast<uint32_t*>(r_min), tok_n, a_n};
  uint8_t* o = static_cast<uint8_t*>(out);
  void* args[] = {&e, &B, &ix, &K, &n, &A, &s, &X, &tag, &fill, &o};
  const cudaError_t rc = cudaLaunchCooperativeKernel((const void*)spec_kernel, dim3(G), dim3(T),
                                                     args, 0, static_cast<cudaStream_t>(stream));
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}
