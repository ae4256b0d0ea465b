// K1: one order-free create_transfers batch, computed on the GPU.
//
// Replaces tigerbeetle_tpu/state_machine/device_kernels.py:436
// (_orderfree_core, reached through _orderfree :375 and
// _orderfree_tight :408, with _static_ladder_normal :180,
// _accum_cols_multi :226, _admit_apply :311 and _summary :344).  Same
// inputs and the same bits out: the updated balance rows and one
// 64-word failure-sparse summary row in the ring.
//
// What bounds it on the H100: the batch touches at most 2B rows of a
// table that may hold millions, so the least traffic is the packed
// batch (B x 20 or 48 bytes), the touched rows (64 bytes read, 64
// written, 8 bytes of meta) and one 512-byte ring row — well under a
// microsecond at 3.35 TB/s.  At that size the five launches and the
// atomics dominate, not bandwidth.  The design therefore never passes
// over the whole table: the reference's one-hot MXU matmul (whose
// (2B, A) one-hot was its dominant traffic) and its whole-table
// where() become per-touched-row work.
//
//   1. of_ladder    one thread per event: static ladder + timeout
//                   overflow -> code; an ok event claims its two rows
//                   (atomicCAS on a per-slot index that rests at -1)
//                   and the owner zeroes that row's accumulators.
//   2. of_accum     one thread per ok event: 32-bit limbs of the
//                   amount atomicAdd'ed as u64 into (row, col, limb)
//                   accumulators.  At most 2B = 16384 adds per
//                   accumulator keeps every sum below 2^46: exact.
//   3. of_admit     one thread per touched row: limbs recombined with
//                   carries into u128 deltas, the new row computed,
//                   any column or dp+dpo / cp+cpo overflow raises the
//                   batch's overflow flag.
//   4. apply        (tb_common.cuh apply_rows_kernel) only after every
//                   row was admitted (a separate launch, so the flag is
//                   final): all-or-nothing write of the new rows, and
//                   the per-slot index is returned to -1.
//   5. summary      one block (tb_common.cuh summary_kernel):
//                   block-wide prefix sum over the failure flags lists
//                   the first FAIL_CAP failures in event order; writes
//                   the ring row; resets the batch counters for the
//                   next launch.
//
// Admission looks at touched rows only.  That equals the reference's
// whole-table admission on every table whose untouched rows do not
// already overflow dp+dpo or cp+cpo — every reachable state, since
// the reference refuses such transfers (overflows_debits/credits) —
// and it equals the host mirror's admission exactly.

#include "tb_common.cuh"

namespace {

using namespace tb;

constexpr uint32_t TIGHT_FLAGS_SHIFT = 18;
constexpr uint32_t TIGHT_CODE_BIT = 1u << 24;
constexpr uint32_t TIGHT_RESERVED_BIT = 1u << 25;

constexpr uint64_t NS_PER_S = 1000000000ull;

enum Mode : int { MODE_FULL = 0, MODE_LO = 1, MODE_TIGHT = 2 };

// The three packed input formats (device_kernels.py _unpack and
// _orderfree_tight): (B, 6) u64 for full/lo, (B, 5) u32 for tight.
__device__ __forceinline__ Event decode(const void* pk, int mode, int e) {
  if (mode != MODE_TIGHT) return decode_wide(static_cast<const uint64_t*>(pk), N_COLS, e);
  Event ev;
  const uint32_t* w = static_cast<const uint32_t*>(pk) + (size_t)e * 5;
  const uint32_t w0 = w[0];
  ev.bits = w0;
  ev.flags = ((w0 >> TIGHT_FLAGS_SHIFT) & 0x3Fu) | ((w0 & TIGHT_RESERVED_BIT) ? 0x40u : 0u);
  ev.code = (w0 & TIGHT_CODE_BIT) ? 1u : 0u;
  ev.dr = (int64_t)w[1] - 1;
  ev.cr = (int64_t)w[2] - 1;
  ev.amt_lo = w[3];
  ev.amt_hi = 0;
  ev.ledger = w[4];
  ev.timeout = 0;
  return ev;
}

// Static precedence ladder then overflows_timeout, per event.
__device__ __forceinline__ uint32_t ladder(const Event& ev, const uint32_t* meta, int64_t A,
                                           bool active, uint64_t ts_i) {
  uint32_t r = ladder_normal(ev, meta, A, active);
  if (r == 0 && ev.timeout != 0) {
    const uint64_t expires = ts_i + ev.timeout * NS_PER_S;  // wraps mod 2^64
    if (expires < ts_i) r = OVERFLOWS_TIMEOUT;
  }
  return r;
}

__global__ void of_ladder(const void* pk, int mode, int n, int B,
                          uint64_t ts_base, const uint32_t* meta, int64_t A,
                          int32_t* codes, int32_t* slot_idx, int32_t* touched,
                          unsigned long long* acc, int32_t* ctrl) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const Event ev = decode(pk, mode, e);
  const bool active = e < n;
  const uint32_t r = ladder(ev, meta, A, active, ts_base + (uint64_t)e);
  codes[e] = (int32_t)r;
  if (!active || r != 0) return;
  claim(clamp_slot(ev.dr, A), slot_idx, touched, acc, 16, &ctrl[0]);
  claim(clamp_slot(ev.cr, A), slot_idx, touched, acc, 16, &ctrl[0]);
}

__global__ void of_accum(const void* pk, int mode, int n, int64_t A,
                         const int32_t* codes, const int32_t* slot_idx,
                         unsigned long long* acc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n || codes[e] != 0) return;
  const Event ev = decode(pk, mode, e);
  const bool pending = (ev.flags & F_PENDING) != 0;
  const int dcol = pending ? 0 : 1;
  const int ccol = pending ? 2 : 3;
  // lo-only formats (tight, lo) sum the low limb pair only: the high
  // amount limb is ignored exactly as the reference's lo_only path.
  const int nl = mode == MODE_FULL ? 4 : 2;
  const int kd = slot_idx[clamp_slot(ev.dr, A)];
  const int kc = slot_idx[clamp_slot(ev.cr, A)];
  add_limbs(acc + (size_t)kd * 16 + dcol * 4, ev.amt_lo, ev.amt_hi, nl);
  add_limbs(acc + (size_t)kc * 16 + ccol * 4, ev.amt_lo, ev.amt_hi, nl);
}

__global__ void of_admit(const uint64_t* table, const int32_t* touched,
                         const unsigned long long* acc, int mode,
                         uint64_t* newrows, int32_t* ctrl) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ctrl[0]) return;
  const uint64_t* old = table + (size_t)touched[k] * 8;
  const unsigned long long* a = acc + (size_t)k * 16;
  uint64_t nl[4], nh[4];
  bool ov = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint64_t d_lo, d_hi;
    limbs_to_u128(a + c * 4, mode == MODE_FULL, d_lo, d_hi, ov);
    ov |= add128(old[2 * c], old[2 * c + 1], d_lo, d_hi, nl[c], nh[c]);
  }
  ov |= tot_ov(nl[0], nh[0], nl[1], nh[1]);  // debits_pending + posted
  ov |= tot_ov(nl[2], nh[2], nl[3], nh[3]);  // credits_pending + posted
  uint64_t* out = newrows + (size_t)k * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[2 * c] = nl[c];
    out[2 * c + 1] = nh[c];
  }
  if (ov) atomicOr(&ctrl[1], 1);
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One batch: five launches on `stream`, no host synchronisation.
// Returns the first non-zero CUDA status, or 0.
extern "C" int tb_orderfree(void* table, const void* meta, int64_t A,
                            void* ring_row, const void* pk, int mode, int n,
                            int B, uint64_t ts_base, void* slot_idx,
                            void* codes, void* touched, void* acc,
                            void* newrows, void* ctrl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = 256;
  const int g_events = (B + tb - 1) / tb;
  const int g_rows = (2 * B + tb - 1) / tb;
  auto* codes_i = static_cast<int32_t*>(codes);
  auto* slot_i = static_cast<int32_t*>(slot_idx);
  auto* touched_i = static_cast<int32_t*>(touched);
  auto* acc_u = static_cast<unsigned long long*>(acc);
  auto* ctrl_i = static_cast<int32_t*>(ctrl);
  cudaError_t err;
  of_ladder<<<g_events, tb, 0, s>>>(pk, mode, n, B, ts_base,
                                    static_cast<const uint32_t*>(meta), A,
                                    codes_i, slot_i, touched_i, acc_u, ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_accum<<<g_events, tb, 0, s>>>(pk, mode, n, A, codes_i, slot_i, acc_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  of_admit<<<g_rows, tb, 0, s>>>(static_cast<const uint64_t*>(table),
                                 touched_i, acc_u, mode,
                                 static_cast<uint64_t*>(newrows), ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tb::apply_rows_kernel<<<g_rows, tb, 0, s>>>(static_cast<uint64_t*>(table), touched_i,
                                               static_cast<const uint64_t*>(newrows),
                                               slot_i, ctrl_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tb::summary_kernel<<<1, tb::SUMMARY_THREADS, 0, s>>>(codes_i, n, B, ctrl_i,
                                                       static_cast<uint64_t*>(ring_row));
  return (int)cudaGetLastError();
}
