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
// written, 8 bytes of meta) and one 512-byte ring row: under a
// microsecond at 3.35 TB/s.  What is left is latency and the rate of
// scattered operations: three dependent trips to memory (the packed
// event, its two meta words, the touched rows), a claim and a sum per
// row, and the barriers between the phases that must see the whole
// batch (the admission sees every sum, the apply every row's verdict).
// Claims and sums are atomics.  An SM's shared-memory atomics are slow
// at 64 bits (a CAS loop), so a cluster of 16 SMs that owns the rows in
// shared memory spent ~10 us on them when it was measured beside this
// one (PERF.md, the K1 design notes), while L2's
// atomic units take them from every SM at once; what bounds this design
// is their rate (a claim's CAS waits ~3 us in a uniform batch of 16k
// rows) and the two grid barriers, each waiting for the slowest block.
// So the batch runs as ONE cooperative launch of one small block per SM
// (64 threads, one event a thread; 128 blocks at B = 8192), its rows in
// a global hash table, two grid barriers:
//
//   0. per event: decode; the rows' hash buckets fetched into L2
//      (prefetch) while the static ladder and overflows_timeout wait on
//      the meta loads -> code.  A warp's records of one (row, column)
//      are combined (__match_any_sync; the group's leader sums its
//      members' limbs from shared memory), so a hot row under skew
//      takes one claim and one add a warp.  Per group and side: the
//      row's claim in the global hash table (slot + 1 as its key; its
//      32-byte bucket of eight keys read first, then atomicCAS only on
//      an empty slot, from the key's own offset in the bucket; both
//      sides' reads, then both CASes, in flight at once; a load of a
//      quarter at most), then the 32-bit limbs of the amount added as
//      u64 into the row's column sums there (red.global: nothing waits
//      on them; at most 2B adds per sum keeps it below 2^46: exact).  A
//      claimer lists the row in its block's shared memory and copies
//      the old row there (cp.async), in flight across the barrier.  Each
//      block's failure count and last applied event.  Grid barrier.
//   1. per block: its failures into the summary at their places in
//      event order (the earlier blocks' counts); admission of the rows
//      it claimed, four lanes (a quad) a row and a column a lane, each
//      quad loading all its rows' sums before it computes any: limbs
//      recombined with carries into the u128 delta, the new column over
//      the old in shared memory, any column or dp+dpo / cp+cpo overflow
//      (a shuffle with the neighbouring lane) flags the block.  Grid
//      barrier.
//   2. all or nothing: each quad stores its rows' new columns (64
//      coalesced bytes a row: a scattered row costs its SM one pass,
//      not four); the sums and keys back at rest; block 0 writes the
//      summary's head.
//
// Global scratch holds only the hash table (keys and sums, at rest at
// zero between launches) and the blocks' totals (written anew).
//
// Admission looks at touched rows only.  That equals the reference's
// whole-table admission on every table whose untouched rows do not
// already overflow dp+dpo or cp+cpo — every reachable state, since
// the reference refuses such transfers (overflows_debits/credits) —
// and it equals the host mirror's admission exactly.  A row's sums are
// the same whichever thread claims it and in whatever order its adds
// land (integer adds commute), so the bits out do not depend on the
// hash or the schedule.

#include <cooperative_groups.h>

#include "tb_common.cuh"
#include "tb_hash.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tb;

constexpr int MAX_THREADS = COOP_MAX_THREADS;
constexpr int MAX_B = 8192;
constexpr int MAX_BLOCKS = 1024;
constexpr int ROW_BATCH = 8;  // rows a lane quad admits: 2T rows, T / 4 quads
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// Stage stamps when the caller passes a zeroed buffer (the measurement
// of tools/serial_probes.py): clock64 of each block's thread 0 at the
// end of each stage, N_STAMPS words a block.
enum { ST_START, ST_LADDER, ST_COMBINE, ST_PROBE, ST_CLAIM, ST_SYNC_CLAIM, ST_TOTALS,
       ST_ADMIT, ST_SYNC_ADMIT, ST_APPLY, N_STAMPS };

// The global scratch: the hash table (tb_hash.cuh), at rest (zero)
// between launches, and the blocks' totals, written anew.
struct Scratch {
  unsigned long long* acc;  // (SP, 16) column sums: 4 x NL limbs used
  uint32_t* keys;           // (SP,) slot + 1, 0 = empty
  int32_t* tot;             // (3, MAX_BLOCKS): failures, last applied, overflow
  uint32_t mask;            // SP - 1
  int shift;                // 64 - log2(SP): a key's home is the top bits of its hash
};

size_t words_for(int cap) {
  const size_t sp = table_slots(cap);
  return sp * 16 + sp / 2 + 3 * MAX_BLOCKS / 2;
}

Scratch scratch_of(void* words, int cap) {
  const size_t sp = table_slots(cap);
  auto* w = static_cast<uint64_t*>(words);
  Scratch X;
  X.acc = reinterpret_cast<unsigned long long*>(w);
  X.keys = reinterpret_cast<uint32_t*>(w + sp * 16);
  X.tot = reinterpret_cast<int32_t*>(w + sp * 16 + sp / 2);
  X.mask = (uint32_t)(sp - 1);
  X.shift = 64 - __builtin_ctzll(sp);
  return X;
}

// Shared memory of a T-thread block: the hash positions and the table
// slots of the rows it claimed, their rows (old, then the new columns
// in place), and each thread's limbs for its warp's combining.
size_t smem_bytes(int T) { return (size_t)2 * T * 8 + (size_t)2 * T * 64 + (size_t)T * 32; }

template <int W>
__global__ void __launch_bounds__(MAX_THREADS)
    orderfree_kernel(uint64_t* __restrict__ table, const uint32_t* __restrict__ meta, int64_t A,
                     uint64_t* __restrict__ ring_row, const void* pk, int mode, int n, int B,
                     uint64_t ts_base, Scratch X, unsigned long long* stamps) {
  constexpr int NL = W / 4;  // 32-bit limbs a column: 4 full, 2 lo and tight
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int n_mine, w_fail[MAX_THREADS / 32], w_last[MAX_THREADS / 32], s_off, s_total,
      s_last, s_ov;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, T = blockDim.x, b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = T >> 5;
  int32_t* mine = reinterpret_cast<int32_t*>(smem_raw);                // (2T,) positions
  int32_t* mine_slot = mine + 2 * T;                                   // (2T,) table slots
  uint64_t* rows = reinterpret_cast<uint64_t*>(smem_raw + 2 * T * 8);  // (2T, 8)
  uint64_t* lanes = rows + (size_t)2 * T * 8;                          // (T, NL) limbs
  const int e = b * T + t;
  const bool real = e < B;
  const bool stamp = stamps != nullptr && t == 0;
  if (stamp) stamps += (size_t)b * N_STAMPS;
  if (stamp) stamps[ST_START] = clock64();
  if (t == 0) n_mine = 0;

  // ---- 0. Ladder, claims and sums.  The rows' hash buckets are
  // fetched into L2 while the meta loads fly.
  const Event ev = real ? decode_orderfree(pk, mode, e) : Event{};
  const int64_t sd = clamp_slot(ev.dr, A), sc = clamp_slot(ev.cr, A);
  if (real && ev.dr >= 0 && ev.cr >= 0) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int64_t slot = side ? sc : sd;
      uint32_t p;
      unsigned o;
      home_of(X, (uint32_t)slot + 1u, p, o);
      prefetch_l2(X.keys + p);
    }
  }
  const bool active = e < n;
  const uint32_t r = real ? ladder_orderfree(ev, meta, A, active, ts_base + (uint64_t)e) : 0u;
  const bool ok = active && r == 0, fail = active && r != 0;
  const unsigned fails = __ballot_sync(FULL_MASK, fail);
  const int fail_before = __popc(fails & ((1u << lane) - 1));
  const int last_w = __reduce_max_sync(FULL_MASK, ok ? e : -1);
  if (lane == 0) {
    w_fail[warp] = __popc(fails);
    w_last[warp] = last_w;
  }
  __syncthreads();  // n_mine
  if (stamp) stamps[ST_LADDER] = clock64();
  {
    const bool pending = (ev.flags & F_PENDING) != 0;
    const uint64_t limb[4] = {ev.amt_lo & M32, ev.amt_lo >> 32, ev.amt_hi & M32,
                              ev.amt_hi >> 32};
    // A warp's records of one (row, column): the group's leader sums
    // its members' limbs from the warp's shared-memory slots.
    unsigned grp[2];
    uint64_t sum[2][NL];
    uint64_t* my = lanes + (size_t)t * NL;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int64_t slot = side ? sc : sd;
      const int col = side ? (pending ? 2 : 3) : (pending ? 0 : 1);
      grp[side] = __match_any_sync(
          FULL_MASK, ok ? ((unsigned long long)slot << 2 | (unsigned)col) : ~0ull - lane);
#pragma unroll
      for (int j = 0; j < NL; ++j) sum[side][j] = limb[j];
      if (__any_sync(FULL_MASK, grp[side] != (1u << lane))) {
#pragma unroll
        for (int j = 0; j < NL; ++j) my[j] = limb[j];
        __syncwarp();
        if (lane == __ffs(grp[side]) - 1) {
          for (unsigned m = grp[side] & (grp[side] - 1); m; m &= m - 1) {
            const uint64_t* other = lanes + (size_t)(warp * 32 + __ffs(m) - 1) * NL;
#pragma unroll
            for (int j = 0; j < NL; ++j) sum[side][j] += other[j];
          }
        }
        __syncwarp();
      }
    }
    if (stamp) stamps[ST_COMBINE] = clock64();
    // Both sides' claims at once: both home buckets read, then both
    // CASes in flight; a lost CAS or a full bucket (rare) searches on.
    bool lead[2], won[2] = {false, false}, found[2] = {false, false};
    uint32_t key[2], p[2], pos[2] = {0u, 0u}, old[2] = {0u, 0u};
    unsigned o[2];
    uint4 ka[2], kb[2];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      lead[side] = ok && lane == __ffs(grp[side]) - 1;
      key[side] = (uint32_t)(side ? sc : sd) + 1u;
      if (lead[side]) {
        home_of(X, key[side], p[side], o[side]);
        load_bucket(X, p[side], ka[side], kb[side]);
      }
    }
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (!lead[side]) continue;
      bool is_key = false;
      const int j = scan_bucket(key[side], o[side], ka[side], kb[side], is_key);
      if (j < 0) continue;
      pos[side] = p[side] + j;
      found[side] = true;
      old[side] = is_key ? key[side] : atomicCAS(X.keys + pos[side], 0u, key[side]);
      if (!is_key) prefetch_l2(table + (side ? sc : sd) * 8);  // likely this row's claimer
    }
    if (stamp) stamps[ST_PROBE] = clock64();
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (!lead[side]) continue;
      if (found[side] && (old[side] == 0u || old[side] == key[side])) won[side] = old[side] == 0u;
      else pos[side] = claim(X, key[side], won[side]);
      const int64_t slot = side ? sc : sd;
      if (won[side]) {
        const int k = atomicAdd(&n_mine, 1);
        mine[k] = (int32_t)pos[side];
        mine_slot[k] = (int32_t)slot;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          copy16_async(rows + (size_t)k * 8 + 2 * q, table + slot * 8 + 2 * q);
      }
      const int col = side ? (pending ? 2 : 3) : (pending ? 0 : 1);
      unsigned long long* a = X.acc + (size_t)pos[side] * 16 + col * NL;
#pragma unroll
      for (int j = 0; j < NL; ++j)
        if (sum[side][j]) red_add(a + j, (unsigned long long)sum[side][j]);
    }
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
  if (stamp) stamps[ST_CLAIM] = clock64();
  grid.sync();
  if (stamp) stamps[ST_SYNC_CLAIM] = clock64();

  // ---- 1. The failure list; admission of the block's rows, four
  // lanes (a quad) a row: a block claims at most 2T = ROW_BATCH x T / 4
  // rows, so each quad loads its rows' sums at once, before the totals
  // and the old rows are waited on.
  const int nm = n_mine, quad = t >> 2, quads = T >> 2, c = t & 3;
  unsigned long long l[ROW_BATCH][4];
#pragma unroll
  for (int u = 0; u < ROW_BATCH; ++u) {
    const int j = u * quads + quad;
    l[u][0] = l[u][1] = l[u][2] = l[u][3] = 0ull;
    if (j < nm) {
      const unsigned long long* a = X.acc + (size_t)mine[j] * 16 + c * NL;
#pragma unroll
      for (int q = 0; q < NL; ++q) l[u][q] = __ldcg(a + q);
    }
  }
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
  if (stamp) stamps[ST_TOTALS] = clock64();
  wait_async();
  __syncthreads();
  if (fail) {
    int p = s_off + fail_before;
    for (int w = 0; w < warp; ++w) p += w_fail[w];
    if (p < FAIL_CAP) ring_row[4 + p] = ((uint64_t)e << 32) | r;
  }
  if (b == 0)
    for (int i = min(s_total, FAIL_CAP) + t; i < FAIL_CAP; i += T) ring_row[4 + i] = 0ull;
  bool ov = false;
#pragma unroll
  for (int u = 0; u < ROW_BATCH; ++u) {
    const int j = u * quads + quad;
    uint64_t n_lo = 0, n_hi = 0;
    bool cov = false;
    if (j < nm) {
      uint64_t* col = rows + (size_t)j * 8 + 2 * c;
      uint64_t d_lo, d_hi;
      limbs_to_u128(l[u], NL == 4, d_lo, d_hi, cov);
      cov |= add128(col[0], col[1], d_lo, d_hi, n_lo, n_hi);
      col[0] = n_lo;
      col[1] = n_hi;
    }
    // dp + dpo (columns 0, 1) and cp + cpo (2, 3): the neighbour's.
    const uint64_t p_lo = __shfl_xor_sync(FULL_MASK, n_lo, 1);
    const uint64_t p_hi = __shfl_xor_sync(FULL_MASK, n_hi, 1);
    ov |= cov || (j < nm && tot_ov(n_lo, n_hi, p_lo, p_hi));
  }
  ov = __syncthreads_or(ov) != 0;
  if (t == 0) X.tot[2 * MAX_BLOCKS + b] = ov;
  if (stamp) stamps[ST_ADMIT] = clock64();
  grid.sync();
  if (stamp) stamps[ST_SYNC_ADMIT] = clock64();

  // ---- 2. All or nothing; the hash table back at rest; the head.
  if (warp == 0) {
    int o = 0;
    for (int g = lane; g < G; g += 32) o |= __ldcg(X.tot + 2 * MAX_BLOCKS + g);
    o = __reduce_or_sync(FULL_MASK, o);
    if (lane == 0) s_ov = o;
  }
  __syncthreads();
  for (int j = quad; j < nm; j += quads) {
    const int p = mine[j];
    if (!s_ov) {
      const uint64_t* col = rows + (size_t)j * 8 + 2 * c;
      reinterpret_cast<ulonglong2*>(table + (int64_t)mine_slot[j] * 8)[c] =
          make_ulonglong2(col[0], col[1]);
    }
    unsigned long long* a = X.acc + (size_t)p * 16 + c * NL;
#pragma unroll
    for (int q = 0; q < NL; ++q) a[q] = 0ull;
    if (c == 0) X.keys[p] = 0u;
  }
  if (b == 0 && t == 0) {
    uint64_t flags = s_ov ? FLAG_OVERFLOW : 0ull;
    if (s_total > FAIL_CAP) flags |= FLAG_CAP;
    ring_row[0] = (uint64_t)s_total;
    ring_row[1] = flags;
    ring_row[2] = (uint64_t)(s_last + 1);
    ring_row[3] = (uint64_t)(n < 0 ? 0 : (n > B ? B : n));
  }
  if (stamp) stamps[ST_APPLY] = clock64();
}

}  // namespace

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// u64 words of the scratch buffer for batches of up to `cap` events;
// the caller zeroes it once, and every launch leaves its hash table at
// zero.
extern "C" int64_t tb_orderfree_scratch_words(int cap) { return (int64_t)words_for(cap); }

// The launch of a B-event batch on the current card: blocks (the
// cooperative grid), threads per block and dynamic shared-memory
// bytes, into geom[0..2].
extern "C" int tb_orderfree_geometry(int B, int* geom) {
  int sms = 0, G, T;
  const int err = sm_count(sms);
  if (err) return err;
  coop_geometry(B, sms, G, T);
  geom[0] = G;
  geom[1] = T;
  geom[2] = (int)smem_bytes(T);
  return 0;
}

// The stage stamps a stamped launch writes (u64 each): N_STAMPS for
// each block.
extern "C" int tb_orderfree_stamps() { return N_STAMPS * MAX_BLOCKS; }

// One batch: one cooperative launch on `stream`, no host
// synchronisation.  B <= 8192 and <= `cap`, the batch the scratch
// `words` was made for; the table 16-byte aligned.  `stamps` is null,
// or N_STAMPS x blocks u64 words for clock64 stage stamps.  Returns the
// first non-zero CUDA status (a grid the card cannot hold at once
// included), or 0.
extern "C" int tb_orderfree(void* table, const void* meta, int64_t A, void* ring_row,
                            const void* pk, int mode, int n, int B, uint64_t ts_base, void* words,
                            int cap, void* stamps, void* stream) {
  if (B < 0 || B > MAX_B || B > cap || mode < MODE_FULL || mode > MODE_TIGHT ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0, G, T;
  const int err = sm_count(sms);
  if (err) return err;
  coop_geometry(B, sms, G, T);
  Scratch X = scratch_of(words, cap);
  // Per device: the dynamic shared-memory limit a 256-thread block
  // needs (the geometry takes one on a card of fewer than 64 SMs).
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64 || !ready[dev]) {
    for (const void* k : {(const void*)orderfree_kernel<8>, (const void*)orderfree_kernel<16>}) {
      rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes(MAX_THREADS));
      if (rc != cudaSuccess) return (int)rc;
    }
    if (dev < 64) ready[dev] = true;
  }
  uint64_t* tab = static_cast<uint64_t*>(table);
  const uint32_t* met = static_cast<const uint32_t*>(meta);
  uint64_t* ring = static_cast<uint64_t*>(ring_row);
  auto* st = static_cast<unsigned long long*>(stamps);
  void* args[] = {&tab, &met, &A, &ring, &pk, &mode, &n, &B, &ts_base, &X, &st};
  const void* kernel = mode == MODE_FULL ? (const void*)orderfree_kernel<16>
                                         : (const void*)orderfree_kernel<8>;
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(G), dim3(T), args,
                                                    smem_bytes(T),
                                                    static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
