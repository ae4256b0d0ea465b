// K6: one pending-create + post/void batch, computed on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:770
// (_two_phase; jitted as two_phase and two_phase_lo at :1054-1055).
// Same inputs — the (B, 11) u64 packed batch with the two-phase join
// columns — and the same bits out: the updated balance rows and one
// 64-word summary row in the ring.
//
// What bounds it on the H100: as K1 (orderfree.cu), a batch touches at
// most 2B rows — each event names two, its own or its target's — so the
// least traffic is the packed batch (B x 88 bytes), the touched rows
// and one ring row: well under a microsecond at 3.35 TB/s.  What is
// left is latency, the rate of scattered atomics and the barriers
// between the steps that must see the whole batch: the winner of a
// target is the first of its candidates, the admission sees every sum,
// the apply every row's verdict.  So the batch runs as ONE cooperative
// launch of one small block per SM (64 threads, one event a thread; 128
// blocks at B = 8192), its rows in K1's global hash table (tb_hash.cuh),
// three grid barriers:
//
//   0. per event: decode, the static ladder (the normal one for creates,
//      the pv prefix for post/void; padding: linked_event_failed), then
//      for a post/void the pv ladder against its target — the in-batch
//      creator (an earlier event, decoded here with its own static code:
//      it depends on nothing else, so no barrier is spent on it) or the
//      durable join columns — rung by rung.  A candidate (a pv with code
//      0) does its atomicMin into its target's segment (the target event
//      for an in-batch target, B + the durable index otherwise; the
//      segment array rests at 0, which stands for B) and claims its
//      target's two rows; a create with code 0 claims its own two rows
//      and adds its amount (pending -> dp/cp, plain -> dpo/cpo) as 32-bit
//      limbs into u64 sums (red.global).  A claimer lists the row in its
//      block's shared memory and copies the old row there (cp.async), in
//      flight across the barrier.  Grid barrier.
//   1. the segment minimum is the winner: it adds a post's amount into
//      the target's dpo/cpo and the release (the target's pending
//      amount) from dp/cp into separate sums; a loser takes
//      already_posted or already_voided by the WINNER's flag.  Each
//      block's failure count and last applied event.  Grid barrier.
//   2. per block: its failures into the summary at their places in
//      event order (the earlier blocks' counts); the segments back at
//      rest (each winner its own); admission of the rows it claimed, a
//      quad of lanes a row and a column a lane: the adds as K1 admits
//      them (column add, the dp+dpo / cp+cpo totals through the
//      neighbouring lane, a column sum past 2^128), then the releases
//      taken from the added row; any overflow or underflow flags the
//      block (the reference's fallback, which reports FLAG_OVERFLOW
//      only).  Grid barrier.
//   3. all or nothing: each quad stores its rows' 64 bytes; sums, keys
//      and marks back at rest; block 0 writes the summary's head.
//
// Only rows that take a sum are admitted and written: a create's and a
// winner's target rows, as the reference's touched set.  (A loser's
// target rows are the winner's whenever the host packed the batch; a
// row claimed only by losers carries no mark and is left alone.)
// lo_only (two_phase_lo) sums the low limb pair only: the high delta is
// the carry out of the low sums, exactly the reference's lo_only.
// Admission looks at touched rows only, as K1's does; a row's sums do
// not depend on which thread claims it or in what order adds land.

#include <cooperative_groups.h>

#include "tb_common.cuh"
#include "tb_hash.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tb;

constexpr int MAX_THREADS = COOP_MAX_THREADS;
constexpr int MAX_B = 8192;
constexpr int MAX_BLOCKS = 1024;
constexpr int ACC = 32;       // sums a row: adds, then releases, 4 columns x NL limbs each
constexpr int ROW_BATCH = 4;  // rows a lane quad loads before it computes
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// The global scratch: the hash table (tb_hash.cuh) with its per-key
// sums and marks, and the target segments, all at rest (zero) between
// launches; the blocks' totals, written anew.
struct Scratch {
  unsigned long long* acc;  // (SP, ACC): adds at [c NL + j], releases at [4 NL + c NL + j]
  uint32_t* keys;           // (SP,) slot + 1, 0 = empty
  uint32_t* live;           // (SP,) 1 = the row takes a sum
  int32_t* seg;             // (2 cap + 2,) first candidate - B of each target key
  int32_t* tot;             // (3, MAX_BLOCKS): failures, last applied, overflow
  uint32_t mask;            // SP - 1
  int shift;                // 64 - log2(SP)
};

size_t int_words(int cap) {
  return (2 * table_slots(cap) + 2 * (size_t)cap + 2 + 3 * MAX_BLOCKS + 1) / 2;
}

size_t words_for(int cap) { return table_slots(cap) * ACC + int_words(cap); }

Scratch scratch_of(void* words, int cap) {
  const size_t sp = table_slots(cap);
  auto* w = static_cast<uint64_t*>(words);
  Scratch X;
  X.acc = reinterpret_cast<unsigned long long*>(w);
  X.keys = reinterpret_cast<uint32_t*>(w + sp * ACC);
  X.live = X.keys + sp;
  X.seg = reinterpret_cast<int32_t*>(X.live + sp);
  X.tot = X.seg + 2 * (size_t)cap + 2;
  X.mask = (uint32_t)(sp - 1);
  X.shift = 64 - __builtin_ctzll(sp);
  return X;
}

// Shared memory of a T-thread block: the hash positions and the table
// slots of the rows it claimed (at most two a thread) and their rows
// (old, then the new columns in place).
size_t smem_bytes(int T) { return (size_t)2 * T * 8 + (size_t)2 * T * 64; }

__device__ __forceinline__ bool is_pv(uint32_t flags) { return (flags & (F_POST | F_VOID)) != 0; }

// The pv prefix ladder (reference :796-806).
__device__ __forceinline__ uint32_t ladder_pv(const Event& ev) {
  const bool post = ev.flags & F_POST, vd = ev.flags & F_VOID;
  const bool excl = (post && vd) || (ev.flags & (F_PENDING | F_BAL_DR | F_BAL_CR));
  if (ev.bits & BIT_TS_NONZERO) return TIMESTAMP_MUST_BE_ZERO;
  if (ev.flags & ~0x3Fu) return RESERVED_FLAG;
  if (ev.bits & BIT_ID_ZERO) return ID_MUST_NOT_BE_ZERO;
  if (ev.bits & BIT_ID_MAX) return ID_MUST_NOT_BE_INT_MAX;
  if (excl) return FLAGS_ARE_MUTUALLY_EXCLUSIVE;
  if (!(ev.bits & BIT_PEND_NONZERO)) return PENDING_ID_MUST_NOT_BE_ZERO;
  if (ev.bits & BIT_PEND_MAX) return PENDING_ID_MUST_NOT_BE_INT_MAX;
  if (ev.bits & BIT_PEND_SELF) return PENDING_ID_MUST_BE_DIFFERENT;
  if (ev.timeout != 0) return TIMEOUT_RESERVED_FOR_PENDING;
  return 0;
}

// The static code of event e: the normal ladder for creates, the pv
// prefix for post/void, linked_event_failed for a padding post/void.
__device__ __forceinline__ uint32_t static_code(const Event& ev, const uint32_t* meta, int64_t A,
                                                bool active) {
  if (is_pv(ev.flags)) return active ? ladder_pv(ev) : LINKED_EVENT_FAILED;
  return ladder_normal(ev, meta, A, active);
}

__device__ __forceinline__ bool gt128(uint64_t a_lo, uint64_t a_hi, uint64_t b_lo,
                                      uint64_t b_hi) {
  return a_hi > b_hi || (a_hi == b_hi && a_lo > b_lo);
}

// A post/void's target: the in-batch creator (an earlier event, with
// whether its static code is 0) or the durable join columns.
struct Target {
  bool in_batch, created;
  int64_t dr, cr;
  uint32_t flags, code, ledger;
  uint64_t amt_lo, amt_hi;
};

__device__ __forceinline__ Target target_of(const uint64_t* pk, const uint32_t* meta, int64_t A,
                                            int n, int B, int e, int& tgt_c) {
  const uint64_t* w = pk + (size_t)e * N_COLS_TP;
  const int64_t tgt_ev = (int64_t)(w[COL_TP_REF] & M32) - 1;
  tgt_c = (int)(tgt_ev < 0 ? 0 : (tgt_ev > B - 1 ? B - 1 : tgt_ev));
  Target t;
  t.in_batch = tgt_ev >= 0 && tgt_ev < e;
  t.created = false;
  if (t.in_batch) {
    const Event c = decode_wide(pk, N_COLS_TP, tgt_c);
    t.created = static_code(c, meta, A, tgt_c < n) == 0;
    t.dr = c.dr;
    t.cr = c.cr;
    t.flags = c.flags;
    t.code = c.code;
    t.ledger = c.ledger;
    t.amt_lo = c.amt_lo;
    t.amt_hi = c.amt_hi;
  } else {
    const uint64_t j = w[COL_TP_JOIN], s = w[COL_TP_SLOTS];
    t.dr = (int64_t)(s & M32) - 1;
    t.cr = (int64_t)(s >> 32) - 1;
    t.flags = (uint32_t)(j & 0xFFFFu);
    t.code = (uint32_t)((j >> 16) & 0xFFFFu);
    t.ledger = (uint32_t)(j >> 32);
    t.amt_lo = w[COL_TP_AMT_LO];
    t.amt_hi = w[COL_TP_AMT_HI];
  }
  return t;
}

// The pv ladder of a post/void whose static code is 0 (reference
// :808-846), rung by rung; for a candidate (code 0), its segment key.
__device__ __forceinline__ uint32_t pv_ladder(const uint64_t* pk, int B, int e, const Event& ev,
                                              const Target& t, int tgt_c, int& key) {
  const uint64_t* w = pk + (size_t)e * N_COLS_TP;
  const bool durable = (ev.bits & BIT_P_FOUND) && !t.in_batch;
  const bool t_amt_set = ev.amt_lo != 0 || ev.amt_hi != 0;
  const uint64_t res_lo = t_amt_set ? ev.amt_lo : t.amt_lo;
  const uint64_t res_hi = t_amt_set ? ev.amt_hi : t.amt_hi;
  const uint32_t dstat = durable ? (uint32_t)(w[COL_TP_REF] >> 32) : S_PENDING;
  uint32_t code = 0;
  if (!(t.created || durable)) code = PENDING_NOT_FOUND;
  else if (!(t.flags & F_PENDING)) code = PENDING_NOT_PENDING;
  else if ((ev.bits & BIT_T_DR_SET) && !(ev.bits & BIT_DR_EQ_P)) code = PENDING_DIFF_DR;
  else if ((ev.bits & BIT_T_CR_SET) && !(ev.bits & BIT_CR_EQ_P)) code = PENDING_DIFF_CR;
  else if (ev.ledger > 0 && ev.ledger != t.ledger) code = PENDING_DIFF_LEDGER;
  else if (ev.code > 0 && ev.code != t.code) code = PENDING_DIFF_CODE;
  else if (gt128(res_lo, res_hi, t.amt_lo, t.amt_hi)) code = EXCEEDS_PENDING_AMOUNT;
  else if ((ev.flags & F_VOID) && gt128(t.amt_lo, t.amt_hi, res_lo, res_hi))
    code = PENDING_DIFF_AMOUNT;
  else if (durable && dstat == S_POSTED) code = PENDING_ALREADY_POSTED;
  else if (durable && dstat == S_VOIDED) code = PENDING_ALREADY_VOIDED;
  else if (durable && dstat == S_EXPIRED) code = PENDING_EXPIRED;
  const int64_t p_tgt = (int64_t)(w[COL_TIMEOUT] >> 32) - 1;
  key = t.in_batch ? tgt_c : B + (int)(p_tgt < 0 ? 0 : (p_tgt > B - 1 ? B - 1 : p_tgt));
  return code;
}

// Both rows' claims at once: both home buckets read, then both CASes in
// flight; a lost CAS or a full bucket (rare) searches on (claim).
__device__ __forceinline__ void claim_both(const Scratch& X, const uint64_t* table,
                                           const int64_t slot[2], uint32_t pos[2], bool won[2]) {
  uint32_t key[2], p[2], old[2] = {0u, 0u};
  unsigned o[2];
  uint4 ka[2], kb[2];
  int j[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    key[side] = (uint32_t)slot[side] + 1u;
    home_of(X, key[side], p[side], o[side]);
    load_bucket(X, p[side], ka[side], kb[side]);
  }
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    bool is_key = false;
    j[side] = scan_bucket(key[side], o[side], ka[side], kb[side], is_key);
    if (j[side] < 0) continue;
    pos[side] = p[side] + j[side];
    old[side] = is_key ? key[side] : atomicCAS(X.keys + pos[side], 0u, key[side]);
    if (!is_key) prefetch_l2(table + slot[side] * 8);  // likely this row's claimer
  }
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (j[side] >= 0 && (old[side] == 0u || old[side] == key[side])) won[side] = old[side] == 0u;
    else pos[side] = claim(X, key[side], won[side]);
  }
}

// The 32-bit limbs of a u128 amount added into the NL sums at `a`.
template <int NL>
__device__ __forceinline__ void add_amount(unsigned long long* a, uint64_t lo, uint64_t hi) {
  const uint64_t limb[4] = {lo & M32, lo >> 32, hi & M32, hi >> 32};
#pragma unroll
  for (int j = 0; j < NL; ++j)
    if (limb[j]) red_add(a + j, (unsigned long long)limb[j]);
}

template <int NL>
__global__ void __launch_bounds__(MAX_THREADS)
    two_phase_kernel(uint64_t* __restrict__ table, const uint32_t* __restrict__ meta, int64_t A,
                     uint64_t* __restrict__ ring_row, const uint64_t* __restrict__ pk, int n,
                     int B, Scratch X) {
  constexpr int REL = 4 * NL;  // the releases' offset in a row's sums
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int n_mine, w_fail[MAX_THREADS / 32], w_last[MAX_THREADS / 32], s_off, s_total,
      s_last, s_ov;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, T = blockDim.x, b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = T >> 5;
  int32_t* mine = reinterpret_cast<int32_t*>(smem_raw);                // (2T,) positions
  int32_t* mine_slot = mine + 2 * T;                                   // (2T,) table slots
  uint64_t* rows = reinterpret_cast<uint64_t*>(smem_raw + 2 * T * 8);  // (2T, 8)
  const int e = b * T + t;
  const bool real = e < B, active = e < n;
  if (t == 0) n_mine = 0;

  // ---- 0. Ladders, segments, claims, the creates' sums.
  Event ev{};
  Target tg{};
  uint32_t code = 0;
  int key = 0;
  bool cand = false, create = false;
  if (real) {
    ev = decode_wide(pk, N_COLS_TP, e);
    if (!is_pv(ev.flags) && ev.dr >= 0 && ev.cr >= 0) {
      uint32_t p;
      unsigned o;
      home_of(X, (uint32_t)clamp_slot(ev.dr, A) + 1u, p, o);
      prefetch_l2(X.keys + p);
      home_of(X, (uint32_t)clamp_slot(ev.cr, A) + 1u, p, o);
      prefetch_l2(X.keys + p);
    }
    code = static_code(ev, meta, A, active);
    if (is_pv(ev.flags) && code == 0) {
      int tgt_c;
      tg = target_of(pk, meta, A, n, B, e, tgt_c);
      code = pv_ladder(pk, B, e, ev, tg, tgt_c, key);
      cand = code == 0;
    }
    create = !is_pv(ev.flags) && code == 0;
  }
  if (cand) atomicMin(&X.seg[key], e - B);
  __syncthreads();  // n_mine
  uint32_t pos[2] = {0u, 0u};
  if (cand || create) {
    const int64_t slot[2] = {clamp_slot(cand ? tg.dr : ev.dr, A),
                             clamp_slot(cand ? tg.cr : ev.cr, A)};
    bool won[2] = {false, false};
    claim_both(X, table, slot, pos, won);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (!won[side]) continue;
      const int k = atomicAdd(&n_mine, 1);
      mine[k] = (int32_t)pos[side];
      mine_slot[k] = (int32_t)slot[side];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        copy16_async(rows + (size_t)k * 8 + 2 * q, table + slot[side] * 8 + 2 * q);
    }
    if (create) {
      const bool pending = (ev.flags & F_PENDING) != 0;
      add_amount<NL>(X.acc + (size_t)pos[0] * ACC + (pending ? 0 : 1) * NL, ev.amt_lo, ev.amt_hi);
      add_amount<NL>(X.acc + (size_t)pos[1] * ACC + (pending ? 2 : 3) * NL, ev.amt_lo, ev.amt_hi);
      X.live[pos[0]] = 1u;
      X.live[pos[1]] = 1u;
    }
  }
  grid.sync();

  // ---- 1. Winners and losers; the blocks' totals.
  bool winner = false;
  if (cand) {
    const int first = __ldcg(X.seg + key) + B;
    winner = first == e;
    if (winner) {
      if (ev.flags & F_POST) {
        const bool set = ev.amt_lo != 0 || ev.amt_hi != 0;
        const uint64_t lo = set ? ev.amt_lo : tg.amt_lo, hi = set ? ev.amt_hi : tg.amt_hi;
        add_amount<NL>(X.acc + (size_t)pos[0] * ACC + 1 * NL, lo, hi);
        add_amount<NL>(X.acc + (size_t)pos[1] * ACC + 3 * NL, lo, hi);
      }
      add_amount<NL>(X.acc + (size_t)pos[0] * ACC + REL + 0 * NL, tg.amt_lo, tg.amt_hi);
      add_amount<NL>(X.acc + (size_t)pos[1] * ACC + REL + 2 * NL, tg.amt_lo, tg.amt_hi);
      X.live[pos[0]] = 1u;
      X.live[pos[1]] = 1u;
    } else {
      const int win_ev = first < 0 ? 0 : (first > B - 1 ? B - 1 : first);
      const uint32_t wflags = (uint32_t)(pk[(size_t)win_ev * N_COLS_TP + COL_MISC] & 0xFFFFu);
      code = (wflags & F_POST) ? PENDING_ALREADY_POSTED : PENDING_ALREADY_VOIDED;
    }
  }
  const bool ok = active && code == 0, fail = active && code != 0;
  const unsigned fails = __ballot_sync(FULL_MASK, fail);
  const int fail_before = __popc(fails & ((1u << lane) - 1));
  const int last_w = __reduce_max_sync(FULL_MASK, ok ? e : -1);
  if (lane == 0) {
    w_fail[warp] = __popc(fails);
    w_last[warp] = last_w;
  }
  __syncthreads();
  if (t == 0) {
    int f = 0, l = -1;
    for (int w = 0; w < nw; ++w) {
      f += w_fail[w];
      l = max(l, w_last[w]);
    }
    X.tot[b] = f;
    X.tot[MAX_BLOCKS + b] = l;
  }
  grid.sync();

  // ---- 2. The failure list; the segments at rest; admission of the
  // block's rows, four lanes (a quad) a row, ROW_BATCH rows' sums loaded
  // before any is computed.
  if (winner) X.seg[key] = 0;
  if (warp == 0) {
    int off = 0, all = 0, last = -1;
    for (int g = lane; g < G; g += 32) {
      const int f = __ldcg(X.tot + g);
      all += f;
      off += g < b ? f : 0;
      last = max(last, __ldcg(X.tot + MAX_BLOCKS + g));
    }
    off = __reduce_add_sync(FULL_MASK, off);
    all = __reduce_add_sync(FULL_MASK, all);
    last = __reduce_max_sync(FULL_MASK, last);
    if (lane == 0) {
      s_off = off;
      s_total = all;
      s_last = last;
    }
  }
  wait_async();
  __syncthreads();
  if (fail) {
    int p = s_off + fail_before;
    for (int w = 0; w < warp; ++w) p += w_fail[w];
    if (p < FAIL_CAP) ring_row[4 + p] = ((uint64_t)e << 32) | code;
  }
  if (b == 0)
    for (int i = min(s_total, FAIL_CAP) + t; i < FAIL_CAP; i += T) ring_row[4 + i] = 0ull;
  const int nm = n_mine, quad = t >> 2, quads = T >> 2, c = t & 3;
  bool ov = false;
  for (int base = 0; base < nm; base += ROW_BATCH * quads) {
    unsigned long long la[ROW_BATCH][4], lr[ROW_BATCH][4];
    bool lv[ROW_BATCH];
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) {
      const int j = base + u * quads + quad;
      lv[u] = false;
      la[u][0] = la[u][1] = la[u][2] = la[u][3] = 0ull;
      lr[u][0] = lr[u][1] = lr[u][2] = lr[u][3] = 0ull;
      if (j < nm) {
        const size_t p = (size_t)mine[j];
        lv[u] = __ldcg(X.live + p) != 0u;
        const unsigned long long* a = X.acc + p * ACC + c * NL;
#pragma unroll
        for (int q = 0; q < NL; ++q) {
          la[u][q] = __ldcg(a + q);
          lr[u][q] = __ldcg(a + REL + q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) {
      const int j = base + u * quads + quad;
      const bool mine_live = j < nm && lv[u];
      uint64_t n_lo = 0, n_hi = 0;
      bool bad = false;
      uint64_t* col = rows + (size_t)(j < nm ? j : 0) * 8 + 2 * c;
      if (mine_live) {
        uint64_t d_lo, d_hi;
        limbs_to_u128(la[u], NL == 4, d_lo, d_hi, bad);
        bad |= add128(col[0], col[1], d_lo, d_hi, n_lo, n_hi);
      }
      // dp + dpo (columns 0, 1) and cp + cpo (2, 3): the neighbour's.
      const uint64_t p_lo = __shfl_xor_sync(FULL_MASK, n_lo, 1);
      const uint64_t p_hi = __shfl_xor_sync(FULL_MASK, n_hi, 1);
      if (mine_live) {
        bad |= tot_ov(n_lo, n_hi, p_lo, p_hi);
        uint64_t s_lo, s_hi;
        limbs_to_u128(lr[u], NL == 4, s_lo, s_hi, bad);
        const uint64_t borrow = n_lo < s_lo ? 1ull : 0ull;
        bad |= n_hi < s_hi || (n_hi == s_hi && borrow);
        col[0] = n_lo - s_lo;
        col[1] = n_hi - s_hi - borrow;
      } else if (j < nm && c == 0) {
        mine_slot[j] = -1;  // claimed by losers only: neither admitted nor written
      }
      ov |= bad;
    }
  }
  ov = __syncthreads_or(ov) != 0;
  if (t == 0) X.tot[2 * MAX_BLOCKS + b] = ov;
  grid.sync();

  // ---- 3. All or nothing; the hash table back at rest; the head.
  if (warp == 0) {
    int o = 0;
    for (int g = lane; g < G; g += 32) o |= __ldcg(X.tot + 2 * MAX_BLOCKS + g);
    o = __reduce_or_sync(FULL_MASK, o);
    if (lane == 0) s_ov = o;
  }
  __syncthreads();
  for (int j = quad; j < nm; j += quads) {
    const int p = mine[j];
    if (!s_ov && mine_slot[j] >= 0) {
      const uint64_t* col = rows + (size_t)j * 8 + 2 * c;
      reinterpret_cast<ulonglong2*>(table + (int64_t)mine_slot[j] * 8)[c] =
          make_ulonglong2(col[0], col[1]);
    }
    unsigned long long* a = X.acc + (size_t)p * ACC + c * NL;
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      a[q] = 0ull;
      a[REL + q] = 0ull;
    }
    if (c == 0) {
      X.keys[p] = 0u;
      X.live[p] = 0u;
    }
  }
  if (b == 0 && t == 0) {
    uint64_t flags = s_ov ? FLAG_OVERFLOW : 0ull;
    if (s_total > FAIL_CAP) flags |= FLAG_CAP;
    ring_row[0] = (uint64_t)s_total;
    ring_row[1] = flags;
    ring_row[2] = (uint64_t)(s_last + 1);
    ring_row[3] = (uint64_t)(n < 0 ? 0 : (n > B ? B : n));
  }
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u64 words of the scratch buffer for batches of up to `cap` events;
// the caller zeroes it once, and every launch leaves it at rest.
extern "C" int64_t tb_two_phase_scratch_words(int cap) { return (int64_t)words_for(cap); }

// The launch of a B-event batch on the current card: blocks (the
// cooperative grid), threads per block and dynamic shared-memory
// bytes, into geom[0..2].
extern "C" int tb_two_phase_geometry(int B, int* geom) {
  int sms = 0, G, T;
  const int err = sm_count(sms);
  if (err) return err;
  coop_geometry(B, sms, G, T);
  geom[0] = G;
  geom[1] = T;
  geom[2] = (int)smem_bytes(T);
  return 0;
}

// One batch: one cooperative launch on `stream`, no host
// synchronisation.  B <= 8192 and <= `cap`, the batch the scratch
// `words` was made for; the table 16-byte aligned.  Returns the first
// non-zero CUDA status (a grid the card cannot hold at once included),
// or 0.
extern "C" int tb_two_phase(void* table, const void* meta, int64_t A, void* ring_row,
                            const void* pk, int n, int B, int lo_only, void* words, int cap,
                            void* stream) {
  if (B < 0 || B > MAX_B || B > cap || (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0, G, T;
  const int err = sm_count(sms);
  if (err) return err;
  coop_geometry(B, sms, G, T);
  Scratch X = scratch_of(words, cap);
  uint64_t* tab = static_cast<uint64_t*>(table);
  const uint32_t* met = static_cast<const uint32_t*>(meta);
  uint64_t* ring = static_cast<uint64_t*>(ring_row);
  const uint64_t* p = static_cast<const uint64_t*>(pk);
  void* args[] = {&tab, &met, &A, &ring, &p, &n, &B, &X};
  const void* kernel = lo_only ? (const void*)two_phase_kernel<2> : (const void*)two_phase_kernel<4>;
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(T), args, smem_bytes(T),
                                                    static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
