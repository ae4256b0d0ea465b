// Code shared by the kernels that run a batch as one cooperative launch
// and sum its rows in a global hash table — K1 (orderfree.cu) and K6
// (two_phase.cu): their launch geometry, the hash table, and the
// asynchronous copies and prefetches they and K3's finalize
// (exact_scan.cu) use.
//
// The hash table: a power-of-two array of u32 keys (a row's slot + 1, 0
// = empty) beside each kernel's own per-key sums, at rest (zero)
// between launches.  Its capacity, table_slots(cap) for batches of up to
// `cap` events, is at least 8x the batch: at most 2B keys (two rows an
// event) keep its load at or below a quarter.  Keys are read eight at a
// time (a 32-byte bucket).  The helpers take any scratch type with
// `keys`, `mask` (capacity - 1) and `shift` (64 - log2(capacity)).
//
// kernels/build.py hashes this header into every library's name.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tb {

constexpr uint64_t HASH_MUL = 0x9E3779B97F4A7C15ull;
constexpr int BUCKET = 8;  // keys a 32-byte read

inline size_t table_slots(int cap) {
  size_t sp = 64;
  while (sp < 8 * (size_t)cap) sp <<= 1;
  return sp;
}

// The cooperative launch of a B-event batch: G blocks of T threads,
// one event a thread, G at most the card's SMs (a cooperative launch
// must fit the card at once): COOP_THREADS a block, more only on a card
// of too few SMs.
constexpr int COOP_THREADS = 64;
constexpr int COOP_MAX_THREADS = 256;

inline void coop_geometry(int B, int sms, int& G, int& T) {
  T = COOP_THREADS;
  while ((B + T - 1) / T > sms && T < COOP_MAX_THREADS) T *= 2;
  G = (B + T - 1) / T;
  G = G < 1 ? 1 : G;
}

// The current card's SMs; a CUDA status.
inline int sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An add into global memory whose result nobody waits for.
__device__ __forceinline__ void red_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// A key's home bucket (the top bits of key x HASH_MUL) and its offset
// in it (the next three bits).
template <class Table>
__device__ __forceinline__ void home_of(const Table& X, uint32_t key, uint32_t& p,
                                        unsigned& o) {
  const uint64_t h = (uint64_t)key * HASH_MUL;
  p = (uint32_t)(h >> X.shift) & ~(uint32_t)(BUCKET - 1);
  o = (unsigned)(h >> (X.shift - 3)) & (BUCKET - 1);
}

// One bucket snapshot of `key`'s sequence (offset o): the first slot
// that holds the key or is empty, or -1 when the bucket is full of
// other keys; `is_key` says which.
__device__ __forceinline__ int scan_bucket(uint32_t key, unsigned o, uint4 a, uint4 b,
                                           bool& is_key) {
  const uint32_t k[BUCKET] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned m_key = 0, m_end = 0;  // slots holding the key; holding it or empty
#pragma unroll
  for (int j = 0; j < BUCKET; ++j) {
    m_key |= (k[j] == key ? 1u : 0u) << j;
    m_end |= (k[j] == key || k[j] == 0u ? 1u : 0u) << j;
  }
  if (m_end == 0u) return -1;
  const unsigned rot = ((m_end >> o) | (m_end << (BUCKET - o))) & 0xFFu;
  const int j = (int)(((unsigned)__ffs(rot) - 1 + o) & (BUCKET - 1));
  is_key = (m_key >> j & 1u) != 0;
  return j;
}

template <class Table>
__device__ __forceinline__ void load_bucket(const Table& X, uint32_t p, uint4& a, uint4& b) {
  a = __ldcg(reinterpret_cast<const uint4*>(X.keys + p));
  b = __ldcg(reinterpret_cast<const uint4*>(X.keys + p + 4));
}

// The row of `key` (slot + 1) in the hash table: found, or claimed
// (`won`) by a CAS on an empty slot.  Open addressing, a 32-byte bucket
// of eight keys read at a time: the key's own sequence runs through its
// home bucket from its own offset, wrapping within the bucket, then
// through the next buckets alike.  A key sits at the first slot of its
// sequence that was empty when it came, and slots only fill, so the
// first slot of its sequence that holds it or is empty ends the search;
// a row already claimed costs no atomic, and keys of one bucket start
// at different slots, so their CASes seldom collide.  At most 2B keys
// in >= 8B slots: it ends.
template <class Table>
__device__ uint32_t claim(const Table& X, uint32_t key, bool& won) {
  uint32_t p;
  unsigned o;
  home_of(X, key, p, o);
  for (;;) {
    uint4 a, b;
    load_bucket(X, p, a, b);
    bool is_key;
    const int j = scan_bucket(key, o, a, b, is_key);
    if (j < 0) {
      p = (p + BUCKET) & X.mask;
      continue;
    }
    const uint32_t old = is_key ? key : atomicCAS(X.keys + p + j, 0u, key);
    if (old == 0u || old == key) {
      won = old == 0u;
      return p + j;
    }
    // Another key took the slot: read the bucket again.
  }
}

}  // namespace tb
