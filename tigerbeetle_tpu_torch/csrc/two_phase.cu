// K6: one pending-create + post/void batch, computed on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:770
// (_two_phase; jitted as two_phase and two_phase_lo at :1054-1055).
// Same inputs — the (B, 11) u64 packed batch with the two-phase join
// columns — and the same bits out: the updated balance rows and one
// 64-word summary row in the ring.
//
// What bounds it on the H100: as K1 (orderfree.cu), a batch touches at
// most 4B rows — the events' own accounts and their targets' — so the
// least traffic is the packed batch (B x 88 bytes), the touched rows
// and one ring row: a few microseconds at 3.35 TB/s.  Launch overhead
// and atomics dominate.  Every step is parallel over events or over
// touched rows, in seven dependent launches on one stream:
//
//   1. tp_static   one thread per event: the normal static ladder for
//                  creates, the pv prefix ladder for post/void.
//   2. tp_ladder   one thread per post/void: the target (the in-batch
//                  creator, read after launch 1 so its static code is
//                  final, or the durable join), the pv ladder rung by
//                  rung (u128 amount compares), and for a candidate an
//                  atomicMin of its index into its target's segment:
//                  the target event for an in-batch target, B + the
//                  durable target index otherwise (the reference's
//                  segment_min over 2B + 1 segments).  The segment
//                  array rests at 0, which stands for B (entries are
//                  stored as index - B).
//   3. tp_winner   one thread per event: a candidate that is not its
//                  segment's minimum loses, with already_posted or
//                  already_voided by the WINNER's flag; an ok event
//                  claims its rows (K1's per-slot index): the creates'
//                  own rows, a winner's target rows.
//   4. tp_accum    one thread per ok event: 32-bit limbs atomically
//                  summed per (row, column) — adds (pending -> dp/cp,
//                  plain -> dpo/cpo, a winning post -> the target's
//                  dpo/cpo) and releases (a winner's pending amount
//                  from the target's dp/cp) in separate accumulators;
//                  the segments return to 0.
//   5. tp_admit    one thread per touched row: the adds admitted as K1
//                  admits them (column add, dp+dpo / cp+cpo totals,
//                  a column sum past 2^128), then the releases taken
//                  from the added row; any overflow or underflow sets
//                  the batch's flag (the reference's fallback, which
//                  reports FLAG_OVERFLOW only).
//   6. apply       all-or-nothing write (tb_common.cuh).
//   7. summary     the ring row (tb_common.cuh).
//
// lo_only (two_phase_lo) sums the low limb pair only: the high delta
// is the carry out of the low sums, exactly the reference's lo_only.
// Admission looks at touched rows only, as K1's does.

#include "tb_common.cuh"

namespace {

using namespace tb;

constexpr int ACC_WIDTH = 32;  // per row: 4 columns x 4 limbs, adds then releases

struct Layout {
  unsigned long long* acc;  // (4B, 32)
  uint64_t* newrows;        // (4B, 8)
  int32_t* codes_s;         // (B,) static codes
  int32_t* codes;           // (B,) final codes
  int32_t* tkey;            // (B,) segment key, 2B for non-candidates
  int32_t* win;             // (B,) winner flag
  int32_t* seg;             // (2B + 1,) first candidate - B, rests at 0
  int32_t* touched;         // (4B,)
  int32_t* ctrl;            // [touched rows, overflow flag], rest at 0
};

size_t int_words(int B) { return ((size_t)4 * B + 2 * B + 1 + 4 * B + 2 + 1) / 2; }

size_t words_for(int B) {
  return (size_t)4 * B * ACC_WIDTH + (size_t)4 * B * 8 + int_words(B);
}

Layout layout(void* words, int B) {
  Layout L;
  auto* w = static_cast<uint64_t*>(words);
  L.acc = reinterpret_cast<unsigned long long*>(w);
  L.newrows = w + (size_t)4 * B * ACC_WIDTH;
  auto* i = reinterpret_cast<int32_t*>(L.newrows + (size_t)4 * B * 8);
  L.codes_s = i;
  L.codes = i + B;
  L.tkey = i + 2 * B;
  L.win = i + 3 * B;
  L.seg = i + 4 * B;
  L.touched = i + 6 * B + 1;
  L.ctrl = i + 10 * B + 1;
  return L;
}

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

__device__ __forceinline__ bool gt128(uint64_t a_lo, uint64_t a_hi, uint64_t b_lo,
                                      uint64_t b_hi) {
  return a_hi > b_hi || (a_hi == b_hi && a_lo > b_lo);
}

// A post/void's target as the kernel sees it: the in-batch creator
// (an earlier event) or the durable join columns.
struct Target {
  bool in_batch;
  int64_t dr, cr;
  uint32_t flags, code, ledger;
  uint64_t amt_lo, amt_hi;
};

__device__ __forceinline__ Target target_of(const uint64_t* pk, int B, int e) {
  const uint64_t* w = pk + (size_t)e * N_COLS_TP;
  const int64_t tgt_ev = (int64_t)(w[COL_TP_REF] & M32) - 1;
  Target t;
  t.in_batch = tgt_ev >= 0 && tgt_ev < e;
  if (t.in_batch) {
    const Event c = decode_wide(pk, N_COLS_TP, (int)(tgt_ev < B ? tgt_ev : B - 1));
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

__global__ void tp_static(const uint64_t* pk, int n, int B, const uint32_t* meta, int64_t A,
                          Layout L) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const Event ev = decode_wide(pk, N_COLS_TP, e);
  const bool active = e < n;
  uint32_t r;
  if (is_pv(ev.flags)) r = active ? ladder_pv(ev) : LINKED_EVENT_FAILED;
  else r = ladder_normal(ev, meta, A, active);
  L.codes_s[e] = (int32_t)r;
}

__global__ void tp_ladder(const uint64_t* pk, int B, Layout L) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const Event ev = decode_wide(pk, N_COLS_TP, e);
  uint32_t code = (uint32_t)L.codes_s[e];
  L.tkey[e] = 2 * B;
  if (!is_pv(ev.flags) || code != 0) {
    L.codes[e] = (int32_t)code;
    return;
  }
  const uint64_t* w = pk + (size_t)e * N_COLS_TP;
  const int64_t tgt_ev = (int64_t)(w[COL_TP_REF] & M32) - 1;
  const int tgt_c = (int)(tgt_ev < 0 ? 0 : (tgt_ev > B - 1 ? B - 1 : tgt_ev));
  const Target t = target_of(pk, B, e);
  const bool created = t.in_batch && L.codes_s[tgt_c] == 0;
  const bool durable = (ev.bits & BIT_P_FOUND) && !t.in_batch;
  const bool t_amt_set = ev.amt_lo != 0 || ev.amt_hi != 0;
  const uint64_t res_lo = t_amt_set ? ev.amt_lo : t.amt_lo;
  const uint64_t res_hi = t_amt_set ? ev.amt_hi : t.amt_hi;
  const uint32_t dstat = durable ? (uint32_t)(w[COL_TP_REF] >> 32) : S_PENDING;
  if (!(created || durable)) code = PENDING_NOT_FOUND;
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
  L.codes[e] = (int32_t)code;
  if (code != 0) return;
  const int64_t p_tgt = (int64_t)(w[COL_TIMEOUT] >> 32) - 1;
  const int key = t.in_batch ? tgt_c : B + (int)(p_tgt < 0 ? 0 : (p_tgt > B - 1 ? B - 1 : p_tgt));
  L.tkey[e] = key;
  atomicMin(&L.seg[key], e - B);
}

__global__ void tp_winner(const uint64_t* pk, int n, int B, int64_t A, int32_t* slot_idx,
                          Layout L) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int key = L.tkey[e];
  int32_t code = L.codes[e];
  bool winner = false;
  if (key < 2 * B) {
    const int first = L.seg[key] + B;
    winner = first == e;
    if (!winner) {
      const int win_ev = first < 0 ? 0 : (first > B - 1 ? B - 1 : first);
      const Event w = decode_wide(pk, N_COLS_TP, win_ev);
      code = (w.flags & F_POST) ? PENDING_ALREADY_POSTED : PENDING_ALREADY_VOIDED;
      L.codes[e] = code;
    }
  }
  L.win[e] = winner;
  if (e >= n || code != 0) return;
  const Event ev = decode_wide(pk, N_COLS_TP, e);
  if ((ev.flags & F_PENDING) || !is_pv(ev.flags)) {
    claim(clamp_slot(ev.dr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &L.ctrl[0]);
    claim(clamp_slot(ev.cr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &L.ctrl[0]);
  }
  if (winner) {
    const Target t = target_of(pk, B, e);
    claim(clamp_slot(t.dr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &L.ctrl[0]);
    claim(clamp_slot(t.cr, A), slot_idx, L.touched, L.acc, ACC_WIDTH, &L.ctrl[0]);
  }
}

__global__ void tp_accum(const uint64_t* pk, int n, int B, int64_t A, bool lo_only,
                         const int32_t* slot_idx, Layout L) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  if (L.tkey[e] < 2 * B) L.seg[L.tkey[e]] = 0;  // every read was in tp_winner
  if (e >= n || L.codes[e] != 0) return;
  const Event ev = decode_wide(pk, N_COLS_TP, e);
  const int nl = lo_only ? 2 : 4;
  const bool pending = (ev.flags & F_PENDING) != 0;
  if (pending || !is_pv(ev.flags)) {
    const int kd = slot_idx[clamp_slot(ev.dr, A)];
    const int kc = slot_idx[clamp_slot(ev.cr, A)];
    add_limbs(L.acc + (size_t)kd * ACC_WIDTH + (pending ? 0 : 1) * 4, ev.amt_lo, ev.amt_hi, nl);
    add_limbs(L.acc + (size_t)kc * ACC_WIDTH + (pending ? 2 : 3) * 4, ev.amt_lo, ev.amt_hi, nl);
  }
  if (L.win[e]) {
    const Target t = target_of(pk, B, e);
    const int kd = slot_idx[clamp_slot(t.dr, A)];
    const int kc = slot_idx[clamp_slot(t.cr, A)];
    if (ev.flags & F_POST) {
      const bool set = ev.amt_lo != 0 || ev.amt_hi != 0;
      const uint64_t lo = set ? ev.amt_lo : t.amt_lo, hi = set ? ev.amt_hi : t.amt_hi;
      add_limbs(L.acc + (size_t)kd * ACC_WIDTH + 1 * 4, lo, hi, nl);
      add_limbs(L.acc + (size_t)kc * ACC_WIDTH + 3 * 4, lo, hi, nl);
    }
    add_limbs(L.acc + (size_t)kd * ACC_WIDTH + 16 + 0 * 4, t.amt_lo, t.amt_hi, nl);
    add_limbs(L.acc + (size_t)kc * ACC_WIDTH + 16 + 2 * 4, t.amt_lo, t.amt_hi, nl);
  }
}

__global__ void tp_admit(const uint64_t* table, bool lo_only, Layout L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L.ctrl[0]) return;
  const uint64_t* old = table + (size_t)L.touched[k] * 8;
  const unsigned long long* a = L.acc + (size_t)k * ACC_WIDTH;
  uint64_t nl[4], nh[4];
  bool bad = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint64_t d_lo, d_hi;
    limbs_to_u128(a + c * 4, !lo_only, d_lo, d_hi, bad);
    bad |= add128(old[2 * c], old[2 * c + 1], d_lo, d_hi, nl[c], nh[c]);
  }
  bad |= tot_ov(nl[0], nh[0], nl[1], nh[1]);
  bad |= tot_ov(nl[2], nh[2], nl[3], nh[3]);
  uint64_t* out = L.newrows + (size_t)k * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint64_t s_lo, s_hi;
    limbs_to_u128(a + 16 + c * 4, !lo_only, s_lo, s_hi, bad);
    const uint64_t borrow = nl[c] < s_lo ? 1ull : 0ull;
    bad |= nh[c] < s_hi || (nh[c] == s_hi && borrow);
    out[2 * c] = nl[c] - s_lo;
    out[2 * c + 1] = nh[c] - s_hi - borrow;
  }
  if (bad) atomicOr(&L.ctrl[1], 1);
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u64 words of the scratch buffer for a B-event batch (zeroed once by
// the caller: the segment array and the counters rest at zero).
extern "C" int64_t tb_two_phase_scratch_words(int B) { return (int64_t)words_for(B); }

// One batch: seven launches on `stream`, no host synchronisation.
// Returns the first non-zero CUDA status, or 0.
extern "C" int tb_two_phase(void* table, const void* meta, int64_t A, void* ring_row,
                            const void* pk, int n, int B, int lo_only, void* slot_idx,
                            void* words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = layout(words, B);
  const auto* pk_u = static_cast<const uint64_t*>(pk);
  auto* slot_i = static_cast<int32_t*>(slot_idx);
  const int tb = 256;
  const int g_events = (B + tb - 1) / tb;
  const int g_rows = (4 * B + tb - 1) / tb;
  cudaError_t err;
  tp_static<<<g_events, tb, 0, s>>>(pk_u, n, B, static_cast<const uint32_t*>(meta), A, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tp_ladder<<<g_events, tb, 0, s>>>(pk_u, B, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tp_winner<<<g_events, tb, 0, s>>>(pk_u, n, B, A, slot_i, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tp_accum<<<g_events, tb, 0, s>>>(pk_u, n, B, A, lo_only != 0, slot_i, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tp_admit<<<g_rows, tb, 0, s>>>(static_cast<const uint64_t*>(table), lo_only != 0, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tb::apply_rows_kernel<<<g_rows, tb, 0, s>>>(static_cast<uint64_t*>(table), L.touched,
                                              L.newrows, slot_i, L.ctrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tb::summary_kernel<<<1, tb::SUMMARY_THREADS, 0, s>>>(L.codes, n, B, L.ctrl,
                                                       static_cast<uint64_t*>(ring_row));
  return (int)cudaGetLastError();
}
