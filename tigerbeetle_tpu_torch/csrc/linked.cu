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
// The fixpoint is a chain of dependent block-wide passes — per
// iteration a prefix sum over the events, a four-lane prefix sum over
// the entries and two elementwise passes — so latency bounds it: the
// number of dependent passes times one barrier plus an L2 round trip.
// The design therefore keeps the whole batch in ONE thread block (no
// host synchronisation, no launch per iteration): per-event and
// per-entry arrays live in a global scratch buffer (~2.5 MB at
// B = 8192, resident in the 50 MB L2), the entry keys in shared memory
// (128 KB), and every step is a strided loop or a block-wide scan
// between __syncthreads().
//
//   0. per event: static ladder, chain_open, limit flags, the
//      preconditions (a high amount limb; an entered limit row with a
//      high limb or a low limb >= 2^61; the exact contribution sum
//      against 2^31 - 1 (small) or 2^61), and the packed entry key
//      slot << 14 | event << 1 | side of each limit side (else the
//      u64 sentinel, which sorts last as an unsigned key).
//   1. chain bounds: a max-scan of chain starts, a reverse min-scan of
//      chain ends.
//   2. a bitonic sort of the 2B keys in shared memory.
//   3. per entry: the event, slot and side back from the key, its
//      segment's first position (max-scan), the position of its chain
//      start within the segment (binary search: the reference's
//      searchsorted), its row's initial balances.
//   4. the fixpoint: chain state (a prefix sum of failures), the four
//      masked amount lanes' prefix sums (small: one wrapping int32 sum,
//      sign-extended, as the reference's astype does), the verdicts,
//      and a block-wide OR of the changes.
//   5. result codes: rollback, the first failure's own code
//      (binary search over the failure prefix), chain_open.
//   6. superset admission (every static_ok event) and apply (members
//      of passing chains) over claimed rows, posted columns, low limbs.
//   7. the summary row (tb_common.cuh), last_applied from the applied
//      prefix.

#include "tb_common.cuh"

namespace {

using namespace tb;

constexpr int THREADS = 1024;
constexpr uint64_t SENTINEL = ~0ull;
constexpr uint64_t U64_SAFE = 1ull << 61;
constexpr int MAX_ITERS = 64;
constexpr int ACC_WIDTH = 8;  // per row: superset then apply, cols 1 and 3, two limbs

struct Layout {
  // Per entry (M = 2B), u64.
  uint64_t *amt, *need, *have, *P0, *P1, *P2, *P3;
  unsigned long long* acc;  // (2B, 8)
  // Per event (B), int32.
  int32_t *code0, *results, *first, *last, *F;
  // Per entry, int32.
  int32_t *ev, *sf, *bpos;
  int32_t* touched;  // (2B,)
  // Per event, u8.
  uint8_t *st_ok, *lim, *pass, *dfail, *cfail, *ap, *cok, *applied;
  uint8_t* eflag;  // per entry: bit 0 debit side, bit 1 the side's limit applies
};

size_t words_for(int B) {
  const size_t M = 2 * (size_t)B;
  const size_t u64s = 7 * M + 2 * (size_t)B * ACC_WIDTH;
  const size_t i32s = 5 * (size_t)B + 3 * M + 2 * (size_t)B;
  const size_t u8s = 8 * (size_t)B + M;
  return u64s + (i32s + 1) / 2 + (u8s + 7) / 8;
}

Layout layout(void* words, int B) {
  const size_t M = 2 * (size_t)B;
  Layout L;
  auto* w = static_cast<uint64_t*>(words);
  L.amt = w;
  L.need = w + M;
  L.have = w + 2 * M;
  L.P0 = w + 3 * M;
  L.P1 = w + 4 * M;
  L.P2 = w + 5 * M;
  L.P3 = w + 6 * M;
  L.acc = reinterpret_cast<unsigned long long*>(w + 7 * M);
  auto* i = reinterpret_cast<int32_t*>(w + 7 * M + 2 * (size_t)B * ACC_WIDTH);
  L.code0 = i;
  L.results = i + B;
  L.first = i + 2 * B;
  L.last = i + 3 * B;
  L.F = i + 4 * B;
  L.ev = i + 5 * B;
  L.sf = L.ev + M;
  L.bpos = L.sf + M;
  L.touched = L.bpos + M;
  auto* b = reinterpret_cast<uint8_t*>(L.touched + 2 * B);
  L.st_ok = b;
  L.lim = b + B;  // bit 0 debit-side limit, bit 1 credit-side limit
  L.pass = b + 2 * B;
  L.dfail = b + 3 * B;
  L.cfail = b + 4 * B;
  L.ap = b + 5 * B;
  L.cok = b + 6 * B;
  L.applied = b + 7 * B;
  L.eflag = b + 8 * B;
  return L;
}

// ---- block-wide scans (one thread block, a contiguous chunk per thread).

struct U4 {
  uint64_t a, b, c, d;
};

__device__ __forceinline__ int shfl_up(int x, int o) { return __shfl_up_sync(0xFFFFFFFFu, x, o); }
__device__ __forceinline__ U4 shfl_up(U4 x, int o) {
  U4 r;
  r.a = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)x.a, o);
  r.b = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)x.b, o);
  r.c = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)x.c, o);
  r.d = __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)x.d, o);
  return r;
}

struct MaxOp {
  __device__ int operator()(int x, int y) const { return x > y ? x : y; }
};
struct MinOp {
  __device__ int operator()(int x, int y) const { return x < y ? x : y; }
};
struct AddOp {
  __device__ int operator()(int x, int y) const { return x + y; }
};
// The four amount lanes: u64 sums mod 2^64, or (small) sums of the low
// 32 bits mod 2^32 — the reference's wrapping int32 cumsum.
template <bool kSmall>
struct Add4 {
  __device__ U4 operator()(const U4& x, const U4& y) const {
    U4 r{x.a + y.a, x.b + y.b, x.c + y.c, x.d + y.d};
    if (kSmall) {
      r.a &= M32;
      r.b &= M32;
      r.c &= M32;
      r.d &= M32;
    }
    return r;
  }
};

// Inclusive scan of get(i) for i in [0, L) (reverse: from L - 1 down),
// put(i, value) with the running result; ends with a barrier.
template <typename T, typename Op, typename Get, typename Put>
__device__ void block_scan(int L, Op op, T ident, bool reverse, Get get, Put put) {
  __shared__ T warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, L), hi = min(lo + per, L);
  T agg = ident;
  for (int i = lo; i < hi; ++i) agg = op(agg, get(reverse ? L - 1 - i : i));
  T x = agg;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(x, o);
    if (lane >= o) x = op(y, x);
  }
  T lane_excl = shfl_up(x, 1);
  if (lane == 0) lane_excl = ident;
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? warp_tot[lane] : ident;
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up(w, o);
      if (lane >= o) w = op(y, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  T run = op(warp > 0 ? warp_tot[warp - 1] : ident, lane_excl);
  for (int i = lo; i < hi; ++i) {
    const int idx = reverse ? L - 1 - i : i;
    run = op(run, get(idx));
    put(idx, run);
  }
  __syncthreads();
}

// Chain state for the current pass vector (reference chain_state,
// :622): F = inclusive prefix count of failed active events; an event
// is in its chain's applied prefix iff no failure lies between the
// chain start and it, and its chain is ok iff none lies in the chain.
__device__ void chain_state(const Layout& L, int n, int B) {
  block_scan<int>(
      B, AddOp{}, 0, false, [&](int i) { return (int)(!L.pass[i] && i < n); },
      [&](int i, int v) { L.F[i] = v; });
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    const int f = L.first[e];
    const int base = L.F[f] - (int)(!L.pass[f] && f < n);
    L.ap[e] = L.F[e] == base;
    L.cok[e] = L.F[L.last[e]] == base;
  }
  __syncthreads();
}

// One Jacobi iteration (reference body, :648): new verdicts from the
// previous pass vector; returns whether any verdict changed.
template <bool kSmall>
__device__ bool iterate(const Layout& L, int n, int B, int V) {
  chain_state(L, n, B);
  // Masked amount lanes: debit/credit side x whole-chain-ok / in the
  // applied prefix; their inclusive prefix sums, then the exclusive
  // prefix P = inclusive - v (small: the int32 inclusive sum
  // sign-extended, minus the full u64 v).
  auto lanes = [&](int j) {
    const int e = L.ev[j];
    const bool deb = L.eflag[j] & 1;
    const uint64_t a = kSmall ? (L.amt[j] & M32) : L.amt[j];
    const uint64_t wce = L.cok[e] ? a : 0, wie = L.ap[e] ? a : 0;
    return U4{deb ? wce : 0, deb ? 0 : wce, deb ? wie : 0, deb ? 0 : wie};
  };
  block_scan<U4>(V, Add4<kSmall>{}, U4{0, 0, 0, 0}, false, lanes, [&](int j, const U4& v) {
    L.P0[j] = v.a;
    L.P1[j] = v.b;
    L.P2[j] = v.c;
    L.P3[j] = v.d;
  });
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    const int e = L.ev[j];
    const bool deb = L.eflag[j] & 1;
    const uint64_t a = L.amt[j];
    const uint64_t wce = L.cok[e] ? a : 0, wie = L.ap[e] ? a : 0;
    auto ext = [](uint64_t x) { return kSmall ? (uint64_t)(int64_t)(int32_t)(uint32_t)x : x; };
    L.P0[j] = ext(L.P0[j]) - (deb ? wce : 0);
    L.P1[j] = ext(L.P1[j]) - (deb ? 0 : wce);
    L.P2[j] = ext(L.P2[j]) - (deb ? wie : 0);
    L.P3[j] = ext(L.P3[j]) - (deb ? 0 : wie);
  }
  for (int e = threadIdx.x; e < B; e += blockDim.x) L.dfail[e] = L.cfail[e] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    if (!(L.eflag[j] & 2)) continue;
    const int b = L.bpos[j], s = L.sf[j];
    const uint64_t deb = (L.P0[b] - L.P0[s]) + (L.P2[j] - L.P2[b]);
    const uint64_t cred = (L.P1[b] - L.P1[s]) + (L.P3[j] - L.P3[b]);
    const bool is_deb = L.eflag[j] & 1;
    const bool bad = is_deb ? L.need[j] + deb + L.amt[j] > L.have[j] + cred
                            : L.need[j] + cred + L.amt[j] > L.have[j] + deb;
    if (bad) (is_deb ? L.dfail : L.cfail)[L.ev[j]] = 1;  // one entry per (event, side)
  }
  __syncthreads();
  bool changed = false;
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
    const uint8_t p = L.st_ok[e] && !L.dfail[e] && !L.cfail[e];
    changed |= p != L.pass[e];
    L.pass[e] = p;
  }
  return __syncthreads_or(changed) != 0;
}

template <bool kSmall>
__global__ void __launch_bounds__(THREADS)
    linked_kernel(uint64_t* table, const uint32_t* meta, int64_t A, uint64_t* ring_row,
                  const uint64_t* pk, int n, int B, int32_t* slot_idx, Layout L) {
  extern __shared__ uint64_t keys[];  // (2B,)
  __shared__ unsigned long long sum_lo, sum_hi;
  __shared__ int n_valid, n_touched;
  const int t = threadIdx.x;
  const int M = 2 * B;
  if (t == 0) {
    sum_lo = sum_hi = 0;
    n_valid = n_touched = 0;
  }
  __syncthreads();

  // 0. Per event.  The contribution sums and the entry count are
  // per-thread partials, summed per warp, one shared atomic per warp.
  bool bad = false;
  unsigned long long my_lo = 0, my_hi = 0;
  int my_valid = 0;
  for (int e = t; e < B; e += blockDim.x) {
    const Event ev = decode_wide(pk, N_COLS, e);
    const bool active = e < n;
    const bool linked = active && (ev.flags & F_LINKED);
    uint32_t c = ladder_normal(ev, meta, A, active);
    if (e == n - 1 && linked) c = LINKED_EVENT_CHAIN_OPEN;
    const bool ok = active && c == 0;
    const uint32_t df = ev.dr >= 0 ? meta[clamp_slot(ev.dr, A) * 2] : 0u;
    const uint32_t cf = ev.cr >= 0 ? meta[clamp_slot(ev.cr, A) * 2] : 0u;
    const uint32_t LIM = AF_DR_LIMIT | AF_CR_LIMIT;
    const bool ent_d = ok && (df & LIM), ent_c = ok && (cf & LIM);
    L.code0[e] = (int32_t)c;
    L.st_ok[e] = ok;
    L.lim[e] = ((df & AF_DR_LIMIT) ? 1 : 0) | ((cf & AF_CR_LIMIT) ? 2 : 0);
    L.pass[e] = ok;
    // Chain bounds inputs: start (first event, or after an unlinked one).
    const bool prev_linked =
        e > 0 && e - 1 < n && (decode_wide(pk, N_COLS, e - 1).flags & F_LINKED);
    L.first[e] = prev_linked ? 0 : e;
    keys[e] = ent_d ? ((uint64_t)ev.dr << 14) | ((uint64_t)e << 1) : SENTINEL;
    keys[B + e] = ent_c ? ((uint64_t)ev.cr << 14) | ((uint64_t)e << 1) | 1ull : SENTINEL;
    my_valid += (int)ent_d + (int)ent_c;
    if (ok) {
      bad |= ev.amt_hi != 0;
      my_lo += ev.amt_lo & M32;
      my_hi += ev.amt_lo >> 32;
    }
    for (int side = 0; side < 2; ++side) {
      if (!(side ? ent_c : ent_d)) continue;
      const uint64_t* row = table + clamp_slot(side ? ev.cr : ev.dr, A) * 8;
      for (int col = 0; col < 4; ++col) bad |= row[2 * col + 1] != 0 || row[2 * col] >= U64_SAFE;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    my_lo += __shfl_xor_sync(0xFFFFFFFFu, my_lo, o);
    my_hi += __shfl_xor_sync(0xFFFFFFFFu, my_hi, o);
    my_valid += __shfl_xor_sync(0xFFFFFFFFu, my_valid, o);
  }
  if ((t & 31) == 0) {
    atomicAdd(&sum_lo, my_lo);
    atomicAdd(&sum_hi, my_hi);
    atomicAdd(&n_valid, my_valid);
  }
  __syncthreads();
  // The reference sums the contributions in float64 (:535-539); this is
  // the exact sum.  They can differ only when the exact total lies
  // within rounding (~2^25) of 2^61; below 2^31 every float partial sum
  // is exact, so the small bound's bit is always the reference's.
  if (kSmall) bad |= sum_hi > 0 || sum_lo >= (1ull << 31) - 1;
  else bad |= sum_hi + (sum_lo >> 32) >= (U64_SAFE >> 32);
  const bool precond = __syncthreads_or(bad) != 0;

  // 1. Chain bounds: the last chain start at or before each event; the
  // first chain end at or after it (an end: the last event, or the
  // event before a start).
  block_scan<int>(
      B, MaxOp{}, 0, false, [&](int i) { return L.first[i]; },
      [&](int i, int v) { L.first[i] = v; });
  block_scan<int>(
      B, MinOp{}, B - 1, true,
      [&](int i) { return (i == B - 1 || L.first[i + 1] == i + 1) ? i : B - 1; },
      [&](int i, int v) { L.last[i] = v; });

  // 2. Sort the entry keys (bitonic, ascending, unsigned: the sentinel
  // sorts last).
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = t; p < M / 2; p += blockDim.x) {
        const int i = 2 * j * (p / j) + (p % j);
        const int ixj = i + j;
        const uint64_t a = keys[i], b = keys[ixj];
        const bool up = (i & k) == 0;
        if ((a > b) == up) {
          keys[i] = b;
          keys[ixj] = a;
        }
      }
      __syncthreads();
    }
  }
  const int V = n_valid;

  // 3. Per entry.
  for (int j = t; j < V; j += blockDim.x) {
    const uint64_t key = keys[j];
    const int e = (int)((key >> 1) & (uint64_t)(B - 1));
    const int64_t slot = (int64_t)(key >> 14);
    const bool deb = (key & 1) == 0;
    const uint64_t* row = table + slot * 8;
    L.ev[j] = e;
    L.amt[j] = pk[(size_t)e * N_COLS + COL_AMT_LO];
    L.need[j] = deb ? row[0] + row[2] : row[4] + row[6];
    L.have[j] = deb ? row[6] : row[2];
    L.eflag[j] = (deb ? 1 : 0) | ((L.lim[e] & (deb ? 1 : 2)) ? 2 : 0);
    L.sf[j] = (j == 0 || (keys[j - 1] >> 14) != (key >> 14)) ? j : 0;
  }
  __syncthreads();
  block_scan<int>(
      V, MaxOp{}, 0, false, [&](int j) { return L.sf[j]; }, [&](int j, int v) { L.sf[j] = v; });
  for (int j = t; j < V; j += blockDim.x) {
    const uint64_t key = keys[j];
    const uint64_t bkey = ((key >> 14) << 14) | ((uint64_t)L.first[L.ev[j]] << 1);
    int lo = L.sf[j], hi = j;  // the first position in [sf, j] with key >= bkey
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < bkey) lo = mid + 1;
      else hi = mid;
    }
    L.bpos[j] = lo;
  }
  __syncthreads();

  // 4. The fixpoint: one unconditional iteration, then while changing
  // and below 64 (:698-704).
  int iters = 0;
  bool changed;
  do {
    changed = iterate<kSmall>(L, n, B, V);
    ++iters;
  } while (changed && iters < MAX_ITERS);
  const bool fix_failed = changed;
  chain_state(L, n, B);

  // 5. Result codes.
  for (int e = t; e < B; e += blockDim.x) {
    const bool active = e < n;
    int32_t r = 0;
    if (active && !L.cok[e]) {
      const int f = L.first[e];
      const int base = L.F[f] - (int)(!L.pass[f]);
      int lo = f, hi = L.last[e];  // the chain's first failure
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (L.F[mid] > base) hi = mid;
        else lo = mid + 1;
      }
      r = LINKED_EVENT_FAILED;
      if (e == lo) {
        const int32_t c0 = L.code0[e];
        r = c0 != 0 ? c0 : (L.dfail[e] ? EXCEEDS_CREDITS : EXCEEDS_DEBITS);
      }
      const bool linked = decode_wide(pk, N_COLS, e).flags & F_LINKED;
      if (e == n - 1 && linked) r = LINKED_EVENT_CHAIN_OPEN;
    }
    L.results[e] = r;
    L.applied[e] = active && L.ap[e];
    // 6a. Claim the rows of every static_ok event (the superset).
    if (L.st_ok[e]) {
      const Event ev = decode_wide(pk, N_COLS, e);
      claim(clamp_slot(ev.dr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &n_touched);
      claim(clamp_slot(ev.cr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &n_touched);
    }
  }
  __syncthreads();

  // 6b. Low-limb sums: superset (static_ok) and apply (results == 0).
  for (int e = t; e < n; e += blockDim.x) {
    if (!L.st_ok[e]) continue;
    const Event ev = decode_wide(pk, N_COLS, e);
    unsigned long long* ad = L.acc + (size_t)slot_idx[clamp_slot(ev.dr, A)] * ACC_WIDTH;
    unsigned long long* ac = L.acc + (size_t)slot_idx[clamp_slot(ev.cr, A)] * ACC_WIDTH;
    add_limbs(ad + 0, ev.amt_lo, 0, 2);
    add_limbs(ac + 2, ev.amt_lo, 0, 2);
    if (L.results[e] == 0) {
      add_limbs(ad + 4, ev.amt_lo, 0, 2);
      add_limbs(ac + 6, ev.amt_lo, 0, 2);
    }
  }
  __syncthreads();

  // 6c. Admission: the superset's overflow decides FLAG_OVERFLOW; the
  // apply writes only when nothing flagged (and its own sums, a subset,
  // cannot overflow then).
  const int U = n_touched;
  bool sup_ov = false, app_ov = false;
  for (int k = t; k < U; k += blockDim.x) {
    const uint64_t* old = table + (size_t)L.touched[k] * 8;
    const unsigned long long* a = L.acc + (size_t)k * ACC_WIDTH;
    for (int pass = 0; pass < 2; ++pass) {
      const unsigned long long* s = a + 4 * pass;
      const unsigned long long l1[4] = {s[0], s[1], 0, 0}, l3[4] = {s[2], s[3], 0, 0};
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
  const bool write = !(sup_ov || precond || fix_failed || app_ov);
  for (int k = t; k < U; k += blockDim.x) {
    const int64_t s = L.touched[k];
    if (write) {
      uint64_t* row = table + s * 8;
      const unsigned long long* a = L.acc + (size_t)k * ACC_WIDTH + 4;
      const unsigned long long l1[4] = {a[0], a[1], 0, 0}, l3[4] = {a[2], a[3], 0, 0};
      uint64_t d1, h1, d3, h3;
      bool ov = false;
      limbs_to_u128(l1, false, d1, h1, ov);
      limbs_to_u128(l3, false, d3, h3, ov);
      add128(row[2], row[3], d1, h1, row[2], row[3]);
      add128(row[6], row[7], d3, h3, row[6], row[7]);
    }
    slot_idx[s] = -1;
  }
  __syncthreads();

  // 7. The summary row.
  uint64_t flags = (uint64_t)iters << ITERS_SHIFT;
  if (sup_ov) flags |= FLAG_OVERFLOW;
  if (precond || fix_failed) flags |= FLAG_PRECOND;
  write_summary(L.results, L.applied, n, B, flags, ring_row);
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u64 words of the scratch buffer for a B-event batch.
extern "C" int64_t tb_linked_scratch_words(int B) { return (int64_t)words_for(B); }

// One batch: one launch of one thread block on `stream`, no host
// synchronisation.  B must be a power of two <= 8192 (the key packs
// the event into 13 bits; the bitonic sort wants 2B a power of two).
// Returns the first non-zero CUDA status, or 0.
extern "C" int tb_linked(void* table, const void* meta, int64_t A, void* ring_row,
                         const void* pk, int n, int B, int small, void* slot_idx, void* words,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 8192 || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  const Layout L = layout(words, B);
  const size_t smem = 2 * (size_t)B * sizeof(uint64_t);
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, THREADS, smem, s>>>(static_cast<uint64_t*>(table),
                                    static_cast<const uint32_t*>(meta), A,
                                    static_cast<uint64_t*>(ring_row),
                                    static_cast<const uint64_t*>(pk), n, B,
                                    static_cast<int32_t*>(slot_idx), L);
    return cudaGetLastError();
  };
  return (int)(small ? launch(linked_kernel<true>) : launch(linked_kernel<false>));
}
