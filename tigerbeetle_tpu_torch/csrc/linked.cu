// K5: one linked-chain create_transfers batch, computed on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:473
// (_linked; jitted as linked and linked_small at :1052-1053).  Same
// inputs and the same bits out: the updated balance rows and the whole
// 64-word summary row, the fixpoint's iteration count included.
//
// The batch: chains (maximal runs of linked events plus the event after
// them) of plain posted transfers, limit accounts allowed.  A chain
// applies iff every member passes; a member on a limit account passes
// iff its account's balance after the applied events before it stays
// within the limit.  The reference resolves that in parallel by a
// Jacobi fixpoint over per-account segmented prefix sums of the limit
// entries sorted by (slot, event) — one unconditional iteration, then
// until the verdicts stop changing or 64 iterations (then
// FLAG_PRECOND) — and K5 runs the SAME iteration, so its verdicts,
// iteration count and fallback flags are the reference's on every
// batch, pathological ones included.
//
// What bounds it on the H100: the bytes are small (the packed batch,
// B x 48 bytes; the touched rows; one ring row: ~2 us at 3.35 TB/s).
// The fixpoint is a chain of dependent prefix sums over the events and
// the entries, so latency bounds it: barriers and shared-memory round
// trips.  The batch therefore runs in ONE thread-block cluster of G
// blocks (G = B / 512, at most 16; one block below B = 1024), with no
// host synchronisation and no trip to global memory inside the
// fixpoint: block b owns events [bT, bT + T) (T = B / G, one per
// thread) and a contiguous share of the sorted entries, and every
// per-event and per-entry array lives in its owner's shared memory.
// Another block's entries and events are read through distributed
// shared memory (cluster.map_shared_rank); each prefix sum is a
// block-local scan plus the block totals before it, which every block
// pushes into every block's shared memory before the barrier after
// which they are read, so an iteration pays four cluster barriers and
// no round trip for a total:
//
//   0. per event (coalesced: thread t of block b holds event bT + t):
//      static ladder, chain_open, limit flags, the preconditions (a
//      high amount limb; an entered limit row with a high limb or a low
//      limb >= 2^61; the contribution sum: exact against 2^31 - 1
//      (small), else each amount rounded to float64 (__ull2double_rn)
//      and summed in float64 in a pairwise tree of adjacent events —
//      warp, block, then cluster — against 2^61, the reference's test
//      in a fixed order), the packed entry keys slot << 14 | event << 1
//      | side of each limit side, and the chain bounds' local scans.
//   1. sort: each block sorts its own 2T keys (bitonic in shared
//      memory; passes whose pairs lie within a warp's 64 keys take no
//      block barrier); after a cluster barrier every block copies the
//      G sorted runs of valid keys (V in all) into its shared memory,
//      ranks its own keys among them (a sum of binary searches) and
//      writes each to the block that owns that position (entries are
//      spread evenly: ceil(V / G) a block).  The keys are unique, so
//      this is the reference's order.
//   2. per entry: event, slot and side back from the key, the amount,
//      the row's initial balances, the segment's first position (a max
//      scan, finished with the earlier blocks' after the first
//      barrier); in the first iteration, the chain-start boundary (the
//      reference's searchsorted) by a galloping search back from the
//      entry, where a chain's members of one account sit.
//   3. the fixpoint, per iteration: (a) per event the local prefix
//      count of failures — barrier — (b) per event its chain state
//      (no failure before it in its chain; none in its chain: the
//      prefix counts at its chain's ends, in its own block unless the
//      chain crosses one), pushed to the owners of its entries —
//      barrier — (c) per entry the four masked amount lanes' local
//      prefix sums (small: one wrapping 32-bit sum, sign-extended, as
//      the reference's astype) — barrier — (d) per limit entry the
//      verdict from the lanes' exclusive prefixes at its position, its
//      chain-start boundary and its segment's first entry, written to
//      the event's owner — barrier — (e) per event the new pass bit and
//      whether it changed (read by every block after the next barrier).
//   4. result codes (the first failure of a failing chain by binary
//      search over the failure prefix), superset admission over
//      claimed rows, apply, and the summary row: each block writes its
//      own failures at their places in event order.
//
// Global memory holds only the admission's rows: a per-slot index
// resting at -1, the touched-row list and limb accumulators.

#include <cooperative_groups.h>

#include "tb_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tb;

constexpr int MAX_T = 512;  // events per block, one per thread
constexpr int MAX_G = 16;   // blocks per cluster (above 8: non-portable)
constexpr uint64_t SENTINEL = ~0ull;
constexpr uint64_t U64_SAFE = 1ull << 61;
constexpr int MAX_ITERS = 64;
constexpr int ACC_WIDTH = 8;  // per row: superset then apply, cols 1 and 3, two limbs

// Stage stamps when the caller passes a zeroed buffer (the measurement
// of tools/serial_probes.py): clock64 of block 0's thread 0 at the end
// of each stage (ST_*) and of the merge's parts (MG_*), and the cycles
// of each part of the fixpoint summed over its iterations (IT_*; IT_SEG
// runs in the first only).
enum { ST_START, ST_EVENTS, ST_SORT, ST_MERGE, ST_ENTRIES, ST_FIXPOINT, ST_RESULTS,
       ST_ADMIT, MG_TOTALS, MG_COPY, MG_RANK, IT_SCAN, IT_BARRIER_A, IT_TOTALS_A, IT_SEG,
       IT_CHAIN, IT_BARRIER_CHAIN, IT_LANES, IT_BARRIER_B, IT_TOTALS_B, IT_VERDICT,
       IT_BARRIER_C, IT_UPDATE, N_STAMPS };

// Per-event flag bits.
constexpr uint8_t FL_OK = 1, FL_PASS = 2, FL_LINKED = 4, FL_DFAIL = 8;

// Global scratch: the admission's claimed rows.
struct Scratch {
  unsigned long long* acc;  // (2B, ACC_WIDTH)
  int32_t* touched;         // (2B,)
};

size_t words_for(int B) {
  const size_t M = 2 * (size_t)B;
  return M * ACC_WIDTH + (M + 1) / 2;
}

Scratch scratch_of(void* words, int B) {
  const size_t M = 2 * (size_t)B;
  Scratch S;
  auto* w = static_cast<uint64_t*>(words);
  S.acc = reinterpret_cast<unsigned long long*>(w);
  S.touched = reinterpret_cast<int32_t*>(w + M * ACC_WIDTH);
  return S;
}

// The launch: G blocks of T threads (T a power of two, >= 32).
void geometry(int B, int& G, int& T) {
  G = B / MAX_T;
  G = G < 1 ? 1 : (G > MAX_G ? MAX_G : G);
  T = B / G < 32 ? 32 : B / G;
}

// Shared memory of one block: E = 2T entry slots.
struct Smem {
  uint64_t* key;     // (E,) sorted keys this block owns
  uint64_t* lkeys;   // (E,) this block's own keys, sorted in place
  uint64_t* runs;    // (V,) every block's sorted run (step 1 only; overlaid below)
  uint64_t *amt, *need, *have;
  uint64_t* P[4];    // (E,) the lanes' local inclusive sums
  int32_t* ev;
  uint8_t *eflag, *bits;  // bit 0 debit side, bit 1 its limit applies; bit 0 chain ok, bit 1 applied prefix
  int32_t *sf, *bpos, *efirst;  // efirst: written by the key's ranking block
  int32_t *Fl, *first, *last;           // per event
  int32_t* eloc;                        // (2, T) each event's entries' positions, or -1
  uint8_t *code0, *fl, *dfail, *cfail;  // per event; dfail / cfail written by entries' owners
};

size_t smem_bytes(int G, int T) {
  const size_t E = 2 * (size_t)T;
  const size_t runs = 8 * (size_t)G * E, ent = 62 * E;
  return 16 * E + (runs > ent ? runs : ent) + 12 * E + 20 * (size_t)T + 4 * (size_t)T;
}

__device__ Smem smem_of(uint8_t* base, int G, int T) {
  const size_t E = 2 * (size_t)T;
  Smem s;
  s.key = reinterpret_cast<uint64_t*>(base);
  s.lkeys = s.key + E;
  uint8_t* over = reinterpret_cast<uint8_t*>(s.lkeys + E);
  s.runs = reinterpret_cast<uint64_t*>(over);
  s.amt = s.runs;
  s.need = s.amt + E;
  s.have = s.need + E;
  for (int k = 0; k < 4; ++k) s.P[k] = s.have + E + k * E;
  s.ev = reinterpret_cast<int32_t*>(s.P[3] + E);
  s.eflag = reinterpret_cast<uint8_t*>(s.ev + E);
  s.bits = s.eflag + E;
  const size_t runs = 8 * (size_t)G * E, ent = 62 * E;
  s.sf = reinterpret_cast<int32_t*>(over + (runs > ent ? runs : ent));
  s.bpos = s.sf + E;
  s.efirst = s.bpos + E;
  s.Fl = s.efirst + E;
  s.first = s.Fl + T;
  s.last = s.first + T;
  s.eloc = s.last + T;
  s.code0 = reinterpret_cast<uint8_t*>(s.eloc + 2 * T);
  s.fl = s.code0 + T;
  s.dfail = s.fl + T;
  s.cfail = s.dfail + T;
  return s;
}

struct U4 {
  uint64_t a[4];
};

template <bool kSmall>
__device__ __forceinline__ U4 add4(const U4& x, const U4& y) {
  U4 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.a[k] = kSmall ? (x.a[k] + y.a[k]) & M32 : x.a[k] + y.a[k];
  return r;
}

template <bool kSmall>
__device__ __forceinline__ U4 warp_scan4(U4 x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    U4 y;
#pragma unroll
    for (int k = 0; k < 4; ++k) y.a[k] = __shfl_up_sync(0xFFFFFFFFu, x.a[k], o);
    if (lane >= o) x = add4<kSmall>(y, x);
  }
  return x;
}

__device__ __forceinline__ U4 shfl4(const U4& x, int src) {
  U4 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.a[k] = __shfl_sync(0xFFFFFFFFu, x.a[k], src);
  return r;
}

// The barrier between phases: the block's own for a one-block cluster,
// else the cluster's (its release / acquire also orders the global
// writes of one block before another block's reads).
__device__ __forceinline__ void phase_barrier(cg::cluster_group& cluster) {
  if (gridDim.x == 1) __syncthreads();
  else cluster.sync();
}

template <bool kSmall>
__global__ void __launch_bounds__(MAX_T)
    linked_kernel(uint64_t* table, const uint32_t* meta, int64_t A, uint64_t* ring_row,
                  const uint64_t* pk, int n, int B, int32_t* slot_idx, Scratch S,
                  unsigned long long* stamps) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // Per-warp partials, and the blocks' totals: each block pushes its
  // own into slot b of every block's array (static: the same offset in
  // every block, so map_shared_rank finds another block's) before the
  // barrier after which they are read, so they are read locally.
  __shared__ double w_f[32];
  __shared__ unsigned long long w_lo[32], w_hi[32];
  __shared__ int w_cnt[32], w_first[32], w_last[32];
  __shared__ U4 w_p[32];
  __shared__ double tot_f[MAX_G];
  __shared__ unsigned long long tot_lo[MAX_G], tot_hi[MAX_G];
  __shared__ int tot_bad[MAX_G], tot_nv[MAX_G], tot_first[MAX_G], tot_last[MAX_G];
  __shared__ int tot_seg[MAX_G], tot_F[MAX_G], tot_chg[MAX_G], tot_fail[MAX_G], tot_app[MAX_G],
      tot_ovf[MAX_G];
  __shared__ U4 tot_P[MAX_G];
  __shared__ int n_touched;
  // What every block derives from the totals.
  __shared__ int V, chunk, roff[MAX_G + 1], first_carry, last_carry, seg_carry, any_chg,
      precond_s, fail_off, n_fail, last_app;
  __shared__ int Foff[MAX_G];
  __shared__ U4 Poff[MAX_G];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = gridDim.x, T = blockDim.x, E = 2 * T;
  const int b = (int)cluster.block_rank(), t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = T >> 5;
  const int tshift = __ffs(T) - 1;
  const int e = b * T + t;
  const bool real = e < B;
  const Smem s = smem_of(smem_raw, G, T);
  const bool stamp = stamps != nullptr && b == 0 && t == 0;
  if (stamp) stamps[ST_START] = clock64();
  if (t == 0) n_touched = 0;

  // ---- 0. Per event.
  bool bad = false, linked = false, ok = false;
  double fc = 0.0;
  unsigned long long lo = 0, hi = 0;
  uint32_t c = LINKED_EVENT_FAILED;
  uint64_t kd = SENTINEL, kc = SENTINEL;
  int first_in = 0, last_in = B - 1;
  if (real) {
    const Event ev = decode_wide(pk, N_COLS, e);
    const bool active = e < n;
    linked = active && (ev.flags & F_LINKED);
    c = ladder_normal(ev, meta, A, active);
    if (e == n - 1 && linked) c = LINKED_EVENT_CHAIN_OPEN;
    ok = active && c == 0;
    const uint32_t df = ev.dr >= 0 ? meta[clamp_slot(ev.dr, A) * 2] : 0u;
    const uint32_t cf = ev.cr >= 0 ? meta[clamp_slot(ev.cr, A) * 2] : 0u;
    const uint32_t LIM = AF_DR_LIMIT | AF_CR_LIMIT;
    const bool ent_d = ok && (df & LIM), ent_c = ok && (cf & LIM);
    if (ent_d) kd = ((uint64_t)ev.dr << 14) | ((uint64_t)e << 1);
    if (ent_c) kc = ((uint64_t)ev.cr << 14) | ((uint64_t)e << 1) | 1ull;
    if (ok) {
      bad |= ev.amt_hi != 0;
      if (kSmall) {
        lo = ev.amt_lo & M32;
        hi = ev.amt_lo >> 32;
      } else {
        fc = __ull2double_rn(ev.amt_lo);
      }
    }
    for (int side = 0; side < 2; ++side) {
      if (!(side ? ent_c : ent_d)) continue;
      const uint64_t* row = table + clamp_slot(side ? ev.cr : ev.dr, A) * 8;
      for (int col = 0; col < 4; ++col) bad |= row[2 * col + 1] != 0 || row[2 * col] >= U64_SAFE;
    }
    // A chain starts at event 0 or after an unlinked event; it ends at
    // the last event or at an unlinked one.
    const bool prev_linked =
        e > 0 && e - 1 < n && (pk[(size_t)(e - 1) * N_COLS + COL_MISC] & F_LINKED);
    first_in = prev_linked ? 0 : e;
    last_in = (e == B - 1 || !linked) ? e : B - 1;
  }
  s.code0[t] = (uint8_t)c;
  s.fl[t] = (ok ? FL_OK | FL_PASS : 0) | (linked ? FL_LINKED : 0);
  s.dfail[t] = s.cfail[t] = 0;
  s.eloc[t] = s.eloc[T + t] = -1;
  s.lkeys[2 * t] = kd;  // the warp's 64 keys in its own 64 slots
  s.lkeys[2 * t + 1] = kc;
  // Warp level: the float sum as a pairwise tree of adjacent lanes (xor
  // shuffles), the exact sums, the key count, the chain scans.
  int cnt = (kd != SENTINEL) + (kc != SENTINEL);
  int fsc = first_in, lsc = last_in;
  for (int o = 1; o < 32; o <<= 1) {
    fc += __shfl_xor_sync(0xFFFFFFFFu, fc, o);
    lo += __shfl_xor_sync(0xFFFFFFFFu, lo, o);
    hi += __shfl_xor_sync(0xFFFFFFFFu, hi, o);
    cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, o);
    const int f = __shfl_up_sync(0xFFFFFFFFu, fsc, o);
    if (lane >= o) fsc = max(fsc, f);
    const int l = __shfl_down_sync(0xFFFFFFFFu, lsc, o);
    if (lane + o < 32) lsc = min(lsc, l);
  }
  const bool wbad = __any_sync(0xFFFFFFFFu, bad);
  if (lane == 0) {
    w_f[warp] = fc;
    w_lo[warp] = lo;
    w_hi[warp] = hi;
    w_cnt[warp] = cnt + (wbad ? 1 << 30 : 0);
    w_last[warp] = lsc;
  }
  if (lane == 31) w_first[warp] = fsc;
  __syncthreads();
  {
    int fcar = 0, lcar = B - 1;
    for (int w = 0; w < warp; ++w) fcar = max(fcar, w_first[w]);
    for (int w = warp + 1; w < nw; ++w) lcar = min(lcar, w_last[w]);
    fsc = max(fsc, fcar);
    lsc = min(lsc, lcar);
  }
  if (warp == 0) {
    double f = lane < nw ? w_f[lane] : 0.0;
    unsigned long long l = lane < nw ? w_lo[lane] : 0, h = lane < nw ? w_hi[lane] : 0;
    int k = lane < nw ? (w_cnt[lane] & ((1 << 30) - 1)) : 0;
    const bool anybad = __any_sync(0xFFFFFFFFu, lane < nw && (w_cnt[lane] >> 30));
    for (int o = 1; o < 32; o <<= 1) {
      f += __shfl_xor_sync(0xFFFFFFFFu, f, o);
      l += __shfl_xor_sync(0xFFFFFFFFu, l, o);
      h += __shfl_xor_sync(0xFFFFFFFFu, h, o);
      k += __shfl_xor_sync(0xFFFFFFFFu, k, o);
    }
    const int fm = lane < nw ? w_first[lane] : 0, lm = lane < nw ? w_last[lane] : B - 1;
    const int fmax = __reduce_max_sync(0xFFFFFFFFu, fm);
    const int lmin = __reduce_min_sync(0xFFFFFFFFu, lm);
    if (lane < G) {
      *cluster.map_shared_rank(tot_f + b, lane) = f;
      *cluster.map_shared_rank(tot_lo + b, lane) = l;
      *cluster.map_shared_rank(tot_hi + b, lane) = h;
      *cluster.map_shared_rank(tot_nv + b, lane) = k;
      *cluster.map_shared_rank(tot_bad + b, lane) = anybad;
      *cluster.map_shared_rank(tot_first + b, lane) = fmax;
      *cluster.map_shared_rank(tot_last + b, lane) = lmin;
    }
  }
  // Each block sorts its own 2T keys (ascending, unsigned: the sentinel
  // sorts last).  A pass whose pairs lie 32 or more apart crosses warps
  // and needs the block's barrier; the others stay in each warp's 64
  // keys.
  if (stamp) stamps[ST_EVENTS] = clock64();
  int j_prev = 1;
  for (int k = 2; k <= E; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32 || j_prev >= 32) __syncthreads();
      else __syncwarp();
      j_prev = j;
      const int i = 2 * j * (t / j) + (t % j);
      const int ixj = i + j;
      const uint64_t x = s.lkeys[i], y = s.lkeys[ixj];
      if ((x > y) == ((i & k) == 0)) {
        s.lkeys[i] = y;
        s.lkeys[ixj] = x;
      }
    }
  }
  phase_barrier(cluster);
  if (stamp) stamps[ST_SORT] = clock64();

  // ---- 1. The cluster's totals, in every block alike.
  if (warp == 0) {
    double f = lane < G ? tot_f[lane] : 0.0;
    unsigned long long l = lane < G ? tot_lo[lane] : 0, h = lane < G ? tot_hi[lane] : 0;
    const int nv = lane < G ? (tot_nv[lane] + 1) & ~1 : 0;  // runs at even offsets
    int keys = lane < G ? tot_nv[lane] : 0;
    const bool bd = __any_sync(0xFFFFFFFFu, lane < G && tot_bad[lane]);
    const int bf = lane < b ? tot_first[lane] : 0;
    const int bl = lane > b && lane < G ? tot_last[lane] : B - 1;
    int incl = nv;
    for (int o = 1; o < 32; o <<= 1) {
      f += __shfl_xor_sync(0xFFFFFFFFu, f, o);
      l += __shfl_xor_sync(0xFFFFFFFFu, l, o);
      h += __shfl_xor_sync(0xFFFFFFFFu, h, o);
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
      keys += __shfl_xor_sync(0xFFFFFFFFu, keys, o);
    }
    const int fmax = __reduce_max_sync(0xFFFFFFFFu, bf);
    const int lmin = __reduce_min_sync(0xFFFFFFFFu, bl);
    const int total = keys;
    if (lane <= G) roff[lane] = incl - nv;
    if (lane == 0) {
      V = total;
      chunk = (total + G - 1) / G;
      first_carry = fmax;
      last_carry = lmin;
      bool p = bd;
      if (kSmall) p |= h > 0 || l >= (1ull << 31) - 1;
      else p |= f >= (double)U64_SAFE;
      precond_s = p;
    }
  }
  __syncthreads();
  if (stamp) stamps[MG_TOTALS] = clock64();
  if (real) {
    s.first[t] = max(fsc, first_carry);
    s.last[t] = min(lsc, last_carry);
  }
  // Every block's sorted run of valid keys, side by side at even
  // offsets: 16-byte pieces, eight in flight per thread (a piece past an
  // odd run's end carries a sentinel no search reads).
  const int pieces = roff[G] / 2;
  for (int base = t; base < pieces; base += 8 * T) {
    ulonglong2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = 2 * (base + u * T);
      if (i >= 2 * pieces) break;
      int cb = 0;
      while (roff[cb + 1] <= i) ++cb;
      v[u] = *reinterpret_cast<const ulonglong2*>(
          cluster.map_shared_rank(s.lkeys + (i - roff[cb]), cb));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (base + u * T < pieces) reinterpret_cast<ulonglong2*>(s.runs)[base + u * T] = v[u];
  }
  __syncthreads();
  if (stamp) stamps[MG_COPY] = clock64();
  // Rank this block's keys, two consecutive ones a thread: the first a
  // sum of binary searches over the runs (all G a step at a time), the
  // second galloping on from the first's bounds; then hand each key to
  // its position's owner with its chain's start, and keep where it went.
  const int my_nv = tot_nv[b];
  for (int q = 2 * t; q < my_nv; q += 2 * T) {
    const uint64_t x0 = s.lkeys[q];
    const bool two = q + 1 < my_nv;
    const uint64_t x1 = two ? s.lkeys[q + 1] : x0;
    int px[MAX_G] = {}, ro[MAX_G], rl[MAX_G];
#pragma unroll
    for (int cb = 0; cb < MAX_G; ++cb) {
      ro[cb] = cb < G ? roff[cb] : 0;
      rl[cb] = cb < G ? tot_nv[cb] : 0;
    }
    for (int step = E; step > 0; step >>= 1) {
#pragma unroll
      for (int cb = 0; cb < MAX_G; ++cb) {
        const int p = px[cb] + step;
        if (p <= rl[cb] && s.runs[ro[cb] + p - 1] < x0) px[cb] = p;
      }
    }
    int r0 = q, r1 = q + 1;
#pragma unroll
    for (int cb = 0; cb < MAX_G; ++cb) {
      if (cb >= G) break;
      if (cb == b) continue;
      const uint64_t* run = s.runs + ro[cb];
      const int len = rl[cb];
      int p = px[cb], step = 1;  // run[p - 1] < x0 < x1
      while (p + step <= len && run[p + step - 1] < x1) {
        p += step;
        step <<= 1;
      }
      for (step >>= 1; step > 0; step >>= 1)
        if (p + step <= len && run[p + step - 1] < x1) p += step;
      r0 += px[cb];
      r1 += p;
    }
    for (int k = 0; k < (two ? 2 : 1); ++k) {
      const uint64_t x = k ? x1 : x0;
      const int r = k ? r1 : r0;
      const int ev_ = (int)((x >> 1) & (uint64_t)(B - 1)) - b * T;
      const int o = r / chunk, p = r - o * chunk;
      *cluster.map_shared_rank(s.key + p, o) = x;
      *cluster.map_shared_rank(s.efirst + p, o) = s.first[ev_];
      s.eloc[(int)(x & 1) * T + ev_] = r;
    }
  }
  if (stamp) stamps[MG_RANK] = clock64();
  phase_barrier(cluster);
  if (stamp) stamps[ST_MERGE] = clock64();

  // ---- 2. Per entry: two per thread, warp-strided (entry q = 64w +
  // 32h + lane), as the lane scans take them; and the segments' first
  // positions within the block (-1: the segment began in an earlier
  // block).
  const int V_all = V, ch = chunk;
  const int j0 = b * ch;
  const int Vb = max(0, min(ch, V_all - j0));
  const bool precond = precond_s != 0;
  int seg_in[2];
  for (int h = 0; h < 2; ++h) {
    const int q = 64 * warp + 32 * h + lane;
    seg_in[h] = -1;
    if (q >= Vb) continue;
    const uint64_t key = s.key[q];
    const int ev_ = (int)((key >> 1) & (uint64_t)(B - 1));
    const int64_t slot = (int64_t)(key >> 14);
    const bool deb = (key & 1) == 0;
    const uint64_t* row = table + slot * 8;
    s.ev[q] = ev_;
    s.amt[q] = pk[(size_t)ev_ * N_COLS + COL_AMT_LO];
    s.need[q] = deb ? row[0] + row[2] : row[4] + row[6];
    s.have[q] = deb ? row[6] : row[2];
    const bool view = meta[slot * 2] & (deb ? AF_DR_LIMIT : AF_CR_LIMIT);
    s.eflag[q] = (deb ? 1 : 0) | (view ? 2 : 0);
    const uint64_t prev = q > 0 ? s.key[q - 1]
                        : (b > 0 ? *cluster.map_shared_rank(s.key + (ch - 1), b - 1) : SENTINEL);
    if (j0 + q == 0 || (prev >> 14) != (key >> 14)) seg_in[h] = j0 + q;
  }
  {
    int m0 = seg_in[0], m1 = seg_in[1];
    for (int o = 1; o < 32; o <<= 1) {
      const int y0 = __shfl_up_sync(0xFFFFFFFFu, m0, o), y1 = __shfl_up_sync(0xFFFFFFFFu, m1, o);
      if (lane >= o) {
        m0 = max(m0, y0);
        m1 = max(m1, y1);
      }
    }
    m1 = max(m1, __shfl_sync(0xFFFFFFFFu, m0, 31));
    if (lane == 31) w_last[warp] = m1;
    __syncthreads();
    int carry = -1;
    for (int w = 0; w < warp; ++w) carry = max(carry, w_last[w]);
    seg_in[0] = max(m0, carry);
    seg_in[1] = max(m1, carry);
    if (t == T - 1 && lane == 31) {
      const int blk = max(m1, carry);
      for (int cb = 0; cb < G; ++cb) *cluster.map_shared_rank(tot_seg + b, cb) = blk;
    }
  }
  if (stamp) stamps[ST_ENTRIES] = clock64();

  // Reads of another block's events and entries.
  auto F_at = [&](int x) {  // the global inclusive failure count at event x
    const int o = x >> tshift, i = x - (o << tshift);
    return (o == b ? s.Fl[i] : *cluster.map_shared_rank(s.Fl + i, o)) + Foff[o];
  };
  auto pass_at = [&](int x) {
    const int o = x >> tshift, i = x - (o << tshift);
    return ((o == b ? s.fl[i] : *cluster.map_shared_rank(s.fl + i, o)) & FL_PASS) != 0;
  };
  auto key_at = [&](int x) {
    const int o = x / ch;
    return *cluster.map_shared_rank(s.key + (x - o * ch), o);
  };
  // The exclusive prefixes of the lanes in `mask` (3: 0 and 1; 12: 2
  // and 3; 15: all) at entry position x (small: the wrapped 32-bit
  // inclusive sum sign-extended, minus the full u64 lane value, as the
  // reference's excl_prefix).
  auto P_at = [&](int x, int mask, uint64_t* out) {
    const int o = x / ch, i = x - o * ch;
    const uint8_t fb = *cluster.map_shared_rank(s.eflag + i, o);
    const uint8_t bb = *cluster.map_shared_rank(s.bits + i, o);
    const uint64_t a = *cluster.map_shared_rank(s.amt + i, o);
    const bool deb = fb & 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(mask >> k & 1)) continue;
      uint64_t incl = *cluster.map_shared_rank(s.P[k] + i, o) + Poff[o].a[k];
      if (kSmall) incl = (uint64_t)(int64_t)(int32_t)(uint32_t)incl;
      const bool on = (k < 2 ? bb & 1 : bb & 2) && (deb == ((k & 1) == 0));
      out[k] = incl - (on ? a : 0ull);
    }
  };

  // ---- 3. The fixpoint: one unconditional iteration, then while
  // changing and below 64 (:698-704).
  int iters = 0;
  bool fix_failed = false, changed = false;
  long long lap = clock64();
  auto tick = [&](int slot) {  // the cycles since the last tick into `slot`
    if (stamp) {
      const long long now = clock64();
      stamps[slot] += now - lap;
      lap = now;
    }
  };
  for (;;) {
    // (a) Per event: the local inclusive prefix count of failures; the
    // block's count and whether a verdict changed, pushed to every
    // block.
    {
      const bool fail = real && e < n && !(s.fl[t] & FL_PASS);
      const unsigned m = __ballot_sync(0xFFFFFFFFu, fail);
      const int incl = __popc(m & (0xFFFFFFFFu >> (31 - lane)));
      if (lane == 31) w_cnt[warp] = incl;
      const bool bch = __syncthreads_or(changed);
      int carry = 0;
      for (int w = 0; w < warp; ++w) carry += w_cnt[w];
      s.Fl[t] = incl + carry;
      if (warp == nw - 1) {
        const int F = __shfl_sync(0xFFFFFFFFu, incl + carry, 31);
        if (lane < G) {
          *cluster.map_shared_rank(tot_F + b, lane) = F;
          *cluster.map_shared_rank(tot_chg + b, lane) = bch;
        }
      }
    }
    tick(IT_SCAN);
    phase_barrier(cluster);
    tick(IT_BARRIER_A);
    if (warp == 0) {
      const int F = lane < G ? tot_F[lane] : 0;
      const bool ch_any = __any_sync(0xFFFFFFFFu, lane < G && tot_chg[lane]);
      int incl = F;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane < G) Foff[lane] = incl - F;
      if (lane == 0) any_chg = ch_any;
      const int sc = __reduce_max_sync(0xFFFFFFFFu, lane < b ? tot_seg[lane] : -1);
      if (lane == 0) seg_carry = sc;
    }
    __syncthreads();
    tick(IT_TOTALS_A);
    if (iters > 0 && (!any_chg || iters == MAX_ITERS)) {
      fix_failed = any_chg;
      break;
    }
    if (iters == 0) {
      // Each entry's segment start (reference seg_first) and chain-start
      // boundary bpos: the first position in [sf, j] whose key is at
      // least slot << 14 | first << 1 (searchsorted), galloping back
      // from j (a chain's members of one slot sit just before it).
      for (int h = 0; h < 2; ++h) {
        const int q = 64 * warp + 32 * h + lane;
        if (q >= Vb) continue;
        const int j = j0 + q;
        const int sf = seg_in[h] >= 0 ? seg_in[h] : seg_carry;
        const uint64_t bkey = ((s.key[q] >> 14) << 14) | ((uint64_t)s.efirst[q] << 1);
        int hi_ = j, step = 1;
        while (hi_ - step >= sf && key_at(hi_ - step) >= bkey) {
          hi_ -= step;
          step <<= 1;
        }
        int lo_ = max(hi_ - step, sf - 1);  // key < bkey there, or before the segment
        while (hi_ - lo_ > 1) {
          const int mid = (lo_ + hi_) >> 1;
          if (key_at(mid) >= bkey) hi_ = mid;
          else lo_ = mid;
        }
        s.sf[q] = sf;
        s.bpos[q] = hi_;
      }
      tick(IT_SEG);
    }
    // (b) Per event: its chain state (no failure before it in its
    // chain; none in its chain), from the failure prefix at its chain's
    // ends (in this block but for chains that cross one), pushed to its
    // entries' owners.
    if (real) {
      const int f = s.first[t];
      const int base = F_at(f) - (int)(f < n && !pass_at(f));
      const uint8_t bits = (F_at(s.last[t]) == base ? 1 : 0) |
                           (s.Fl[t] + Foff[b] == base ? 2 : 0);
      for (int side = 0; side < 2; ++side) {
        const int r = s.eloc[side * T + t];
        if (r < 0) continue;
        const int o = r / ch;
        *cluster.map_shared_rank(s.bits + (r - o * ch), o) = bits;
      }
    }
    tick(IT_CHAIN);
    phase_barrier(cluster);
    tick(IT_BARRIER_CHAIN);
    // (c) Per entry: the masked lanes and their local scan.
    U4 x[2];
    for (int h = 0; h < 2; ++h) {
      const int q = 64 * warp + 32 * h + lane;
      x[h] = U4{{0, 0, 0, 0}};
      if (q >= Vb) continue;
      const bool cok = s.bits[q] & 1, ap = s.bits[q] & 2;
      const bool deb = s.eflag[q] & 1;
      const uint64_t a = kSmall ? (s.amt[q] & M32) : s.amt[q];
      const uint64_t wce = cok ? a : 0, wie = ap ? a : 0;
      x[h] = U4{{deb ? wce : 0, deb ? 0 : wce, deb ? wie : 0, deb ? 0 : wie}};
    }
    {
      const U4 s0 = warp_scan4<kSmall>(x[0]);
      const U4 s1 = add4<kSmall>(warp_scan4<kSmall>(x[1]), shfl4(s0, 31));
      if (lane == 31) w_p[warp] = s1;
      __syncthreads();
      U4 carry{{0, 0, 0, 0}};
      for (int w = 0; w < warp; ++w) carry = add4<kSmall>(carry, w_p[w]);
      const U4 r0 = add4<kSmall>(carry, s0), r1 = add4<kSmall>(carry, s1);
      const int q0 = 64 * warp + lane, q1 = q0 + 32;
      for (int k = 0; k < 4; ++k) {
        if (q0 < Vb) s.P[k][q0] = r0.a[k];
        if (q1 < Vb) s.P[k][q1] = r1.a[k];
      }
      if (warp == nw - 1) {
        const U4 tot = shfl4(r1, 31);
        if (lane < G) *cluster.map_shared_rank(tot_P + b, lane) = tot;
      }
    }
    tick(IT_LANES);
    phase_barrier(cluster);
    tick(IT_BARRIER_B);
    if (warp == 0) {
      U4 p = lane < G ? tot_P[lane] : U4{{0, 0, 0, 0}};
      U4 incl = p;
      for (int o = 1; o < 32; o <<= 1) {
        U4 y;
        for (int k = 0; k < 4; ++k) y.a[k] = __shfl_up_sync(0xFFFFFFFFu, incl.a[k], o);
        if (lane >= o) incl = add4<kSmall>(y, incl);
      }
      if (lane < G)
        for (int k = 0; k < 4; ++k)
          Poff[lane].a[k] = kSmall ? (incl.a[k] - p.a[k]) & M32 : incl.a[k] - p.a[k];
    }
    __syncthreads();
    tick(IT_TOTALS_B);
    // (d) Per limit entry: the verdict against the balances before it;
    // the failures are written to their events' owners (one entry per
    // event and side) after both entries' reads.
    bool fail[2] = {};
    for (int h = 0; h < 2; ++h) {
      const int q = 64 * warp + 32 * h + lane;
      if (q >= Vb || !(s.eflag[q] & 2)) continue;
      uint64_t pb[4], ps[4], pj[4];
      P_at(s.bpos[q], 15, pb);
      P_at(s.sf[q], 3, ps);
      P_at(j0 + q, 12, pj);
      const uint64_t deb = (pb[0] - ps[0]) + (pj[2] - pb[2]);
      const uint64_t cred = (pb[1] - ps[1]) + (pj[3] - pb[3]);
      const uint64_t a = s.amt[q];
      fail[h] = (s.eflag[q] & 1) ? s.need[q] + deb + a > s.have[q] + cred
                                 : s.need[q] + cred + a > s.have[q] + deb;
    }
    for (int h = 0; h < 2; ++h) {
      if (!fail[h]) continue;
      const int q = 64 * warp + 32 * h + lane;
      const int ev_ = s.ev[q], o = ev_ >> tshift;
      *cluster.map_shared_rank(((s.eflag[q] & 1) ? s.dfail : s.cfail) + (ev_ - (o << tshift)),
                               o) = 1;
    }
    tick(IT_VERDICT);
    phase_barrier(cluster);
    tick(IT_BARRIER_C);
    // (e) Per event: the new verdict.
    {
      const uint8_t f = s.fl[t];
      const bool df = s.dfail[t], p = (f & FL_OK) && !df && !s.cfail[t];
      changed = p != ((f & FL_PASS) != 0);
      s.fl[t] = (f & (FL_OK | FL_LINKED)) | (p ? FL_PASS : 0) | (df ? FL_DFAIL : 0);
      s.dfail[t] = s.cfail[t] = 0;
    }
    ++iters;
    tick(IT_UPDATE);
  }
  if (stamp) stamps[ST_FIXPOINT] = clock64();

  // ---- 4. Result codes; the block's failure count and last applied
  // event, pushed to every block; the claim of every static_ok event's
  // rows.
  int32_t r = 0;
  bool applied = false;
  const uint8_t f_me = s.fl[t];
  if (real) {
    const bool active = e < n;
    const int f = s.first[t], l = s.last[t];
    const int base = F_at(f) - (int)(f < n && !pass_at(f));
    const bool cok = F_at(l) == base;
    applied = active && s.Fl[t] + Foff[b] == base;
    if (active && !cok) {
      int lo_ = f, hi_ = l;  // the chain's first failure
      while (lo_ < hi_) {
        const int mid = (lo_ + hi_) >> 1;
        if (F_at(mid) > base) hi_ = mid;
        else lo_ = mid + 1;
      }
      r = LINKED_EVENT_FAILED;
      if (e == lo_) {
        const int32_t c0 = s.code0[t];
        r = c0 != 0 ? c0 : ((f_me & FL_DFAIL) ? EXCEEDS_CREDITS : EXCEEDS_DEBITS);
      }
      if (e == n - 1 && (f_me & FL_LINKED)) r = LINKED_EVENT_CHAIN_OPEN;
    }
  }
  const unsigned fails = __ballot_sync(0xFFFFFFFFu, real && e < n && r != 0);
  const int fail_before = __popc(fails & ((1u << lane) - 1));
  const int last_w = __reduce_max_sync(0xFFFFFFFFu, applied ? e : -1);
  if (lane == 0) {
    w_cnt[warp] = __popc(fails);
    w_first[warp] = last_w;
  }
  __syncthreads();
  int fail_pos = fail_before;
  for (int w = 0; w < warp; ++w) fail_pos += w_cnt[w];
  if (warp == 0) {
    int k = lane < nw ? w_cnt[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) k += __shfl_xor_sync(0xFFFFFFFFu, k, o);
    const int la = __reduce_max_sync(0xFFFFFFFFu, lane < nw ? w_first[lane] : -1);
    if (lane < G) {
      *cluster.map_shared_rank(tot_fail + b, lane) = k;
      *cluster.map_shared_rank(tot_app + b, lane) = la;
    }
  }
  int32_t* count0 = cluster.map_shared_rank(&n_touched, 0);
  int64_t sd = 0, sc = 0;
  uint64_t amt_lo = 0;
  if (f_me & FL_OK) {
    const Event ev = decode_wide(pk, N_COLS, e);
    sd = clamp_slot(ev.dr, A);
    sc = clamp_slot(ev.cr, A);
    amt_lo = ev.amt_lo;
    claim(sd, slot_idx, S.touched, S.acc, ACC_WIDTH, count0);
    claim(sc, slot_idx, S.touched, S.acc, ACC_WIDTH, count0);
  }
  phase_barrier(cluster);
  if (stamp) stamps[ST_RESULTS] = clock64();

  // The summary's failure list (reference _summary): each block writes
  // its own failures at their places in event order; block 0 zeroes the
  // slots past the last one.
  if (warp == 0) {
    const int k = lane < G ? tot_fail[lane] : 0;
    int incl = k;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    const int off = __shfl_sync(0xFFFFFFFFu, incl - k, b);
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    const int la = __reduce_max_sync(0xFFFFFFFFu, lane < G ? tot_app[lane] : -1);
    if (lane == 0) {
      fail_off = off;
      n_fail = total;
      last_app = la;
    }
  }
  // Low-limb sums: superset (static_ok) and apply (results == 0).
  if (f_me & FL_OK) {
    unsigned long long* ad = S.acc + (size_t)__ldcg(slot_idx + sd) * ACC_WIDTH;
    unsigned long long* ac = S.acc + (size_t)__ldcg(slot_idx + sc) * ACC_WIDTH;
    add_limbs(ad + 0, amt_lo, 0, 2);
    add_limbs(ac + 2, amt_lo, 0, 2);
    if (r == 0) {
      add_limbs(ad + 4, amt_lo, 0, 2);
      add_limbs(ac + 6, amt_lo, 0, 2);
    }
  }
  __syncthreads();
  {
    const int pos = fail_off + fail_pos;
    if (real && e < n && r != 0 && pos < FAIL_CAP)
      ring_row[4 + pos] = ((uint64_t)e << 32) | (uint32_t)r;
    if (b == 0)
      for (int i = min(n_fail, FAIL_CAP) + t; i < FAIL_CAP; i += T) ring_row[4 + i] = 0ull;
  }
  phase_barrier(cluster);

  // Admission: the superset's overflow decides FLAG_OVERFLOW; the apply
  // writes only when nothing flagged (and its own sums, a subset,
  // cannot overflow then).
  const int U = *count0;
  bool sup_ov = false, app_ov = false;
  for (int k = e; k < U; k += G * T) {
    const uint64_t* old = table + (size_t)__ldcg(S.touched + k) * 8;
    const unsigned long long* a = S.acc + (size_t)k * ACC_WIDTH;
    for (int pass = 0; pass < 2; ++pass) {
      const unsigned long long l1[4] = {__ldcg(a + 4 * pass), __ldcg(a + 4 * pass + 1), 0, 0};
      const unsigned long long l3[4] = {__ldcg(a + 4 * pass + 2), __ldcg(a + 4 * pass + 3), 0, 0};
      uint64_t d1, h1, d3, h3, r1l, r1h, r3l, r3h;
      bool ov = false;
      limbs_to_u128(l1, false, d1, h1, ov);
      limbs_to_u128(l3, false, d3, h3, ov);
      ov |= add128(old[2], old[3], d1, h1, r1l, r1h);
      ov |= add128(old[6], old[7], d3, h3, r3l, r3h);
      ov |= tot_ov(old[0], old[1], r1l, r1h);
      ov |= tot_ov(old[4], old[5], r3l, r3h);
      (pass ? app_ov : sup_ov) |= ov;
    }
  }
  sup_ov = __syncthreads_or(sup_ov) != 0;
  app_ov = __syncthreads_or(app_ov) != 0;
  if (t < G) *cluster.map_shared_rank(tot_ovf + b, t) = (sup_ov ? 1 : 0) | (app_ov ? 2 : 0);
  phase_barrier(cluster);
  int ov_all = 0;
  for (int cb = 0; cb < G; ++cb) ov_all |= tot_ovf[cb];
  const bool write = !(ov_all || precond || fix_failed);
  for (int k = e; k < U; k += G * T) {
    const int64_t sl = __ldcg(S.touched + k);
    if (write) {
      uint64_t* row = table + sl * 8;
      const unsigned long long* a = S.acc + (size_t)k * ACC_WIDTH + 4;
      const unsigned long long l1[4] = {__ldcg(a), __ldcg(a + 1), 0, 0};
      const unsigned long long l3[4] = {__ldcg(a + 2), __ldcg(a + 3), 0, 0};
      uint64_t d1, h1, d3, h3;
      bool ov = false;
      limbs_to_u128(l1, false, d1, h1, ov);
      limbs_to_u128(l3, false, d3, h3, ov);
      add128(row[2], row[3], d1, h1, row[2], row[3]);
      add128(row[6], row[7], d3, h3, row[6], row[7]);
    }
    slot_idx[sl] = -1;
  }
  // ---- 5. The summary row's head.
  if (b == 0 && t == 0) {
    uint64_t flags = (uint64_t)iters << ITERS_SHIFT;
    if (ov_all & 1) flags |= FLAG_OVERFLOW;
    if (precond || fix_failed) flags |= FLAG_PRECOND;
    if (n_fail > FAIL_CAP) flags |= FLAG_CAP;
    ring_row[0] = (uint64_t)n_fail;
    ring_row[1] = flags;
    ring_row[2] = (uint64_t)(last_app + 1);
    ring_row[3] = (uint64_t)(n < 0 ? 0 : (n > B ? B : n));
  }
  if (stamp) stamps[ST_ADMIT] = clock64();
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u64 words of the scratch buffer for a B-event batch.
extern "C" int64_t tb_linked_scratch_words(int B) { return (int64_t)words_for(B); }

// The launch of a B-event batch: blocks (one cluster), threads per
// block and dynamic shared-memory bytes, into geom[0..2].
extern "C" int tb_linked_geometry(int B, int* geom) {
  int G, T;
  geometry(B, G, T);
  geom[0] = G;
  geom[1] = T;
  geom[2] = (int)smem_bytes(G, T);
  return 0;
}

// The stage stamps a stamped launch writes (u64 each).
extern "C" int tb_linked_stamps() { return N_STAMPS; }

// One batch: one launch of one thread-block cluster on `stream`, no
// host synchronisation.  B must be a power of two <= 8192 (the key
// packs the event into 13 bits).  `stamps` is null, or N_STAMPS u64
// words for clock64 stage stamps.  Returns the first non-zero CUDA
// status, or 0.
extern "C" int tb_linked(void* table, const void* meta, int64_t A, void* ring_row,
                         const void* pk, int n, int B, int small, void* slot_idx, void* words,
                         void* stamps, void* stream) {
  if (B < 1 || B > 8192 || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  int G, T;
  geometry(B, G, T);
  const size_t smem = smem_bytes(G, T);
  const Scratch S = scratch_of(words, B);
  // Per device: the attributes are set on the current device's context,
  // for both variants at once.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    for (auto kernel : {linked_kernel<true>, linked_kernel<false>}) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes(MAX_G, MAX_T));
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    if (dev < 64) ready[dev] = true;
  }
  auto launch = [&](auto kernel) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<uint64_t*>(table), static_cast<const uint32_t*>(meta), A,
        static_cast<uint64_t*>(ring_row), static_cast<const uint64_t*>(pk), n, B,
        static_cast<int32_t*>(slot_idx), S, static_cast<unsigned long long*>(stamps));
    return e != cudaSuccess ? e : cudaGetLastError();
  };
  return (int)(small ? launch(linked_kernel<true>) : launch(linked_kernel<false>));
}
