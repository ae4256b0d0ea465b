// tb_fastpath: the host engine's native commit path for create_transfers.
//
// The port's own copy of the state-machine part of the reference's
// native/tb_fastpath.cpp (the Fastpath struct and tb_fp_create ...
// tb_fp_commit_transfers), with tb_fp_decode_store from its
// tb_lsm.inc and the serial engines tb_exact.inc, tb_linked.inc and
// tb_two_phase.inc beside it, and the LSM's k-way merge in this
// directory's tb_lsm.inc, and the server drain's frame verify / reply
// finalize and the hash pool's controls.  The algorithms are the
// reference's.  Built with tb_pipeline.cpp (the VSR commit pipeline)
// by tigerbeetle_tpu_torch/kernels/host_build.py with g++ into
// build/native/, loaded by runtime/fastpath.py.
//
// The device balance table is authoritative and fed by write-behind
// deltas (kernel K4); the HOST decodes the 8190 x 128-byte wire batch,
// runs the static validation ladder, resolves accounts, detects
// duplicates and admits balance deltas (monotone u128 overflow checks)
// without waiting on the device (reference: src/state_machine.zig:
// 1220-1306 execute loop, :1465-1547 create_transfer ladder + overflow
// checks).
//
// Ownership contract with Python (runtime/fastpath.py):
// - The balance mirror (lo/hi, A x 4 u64 each) lives HERE; Python wraps
//   the same memory as numpy arrays, so exact-path commits and expiry
//   mutations are visible to this code with zero copies.
// - Account metadata and the id directories are maintained via explicit
//   add/remove calls from Python on every commit path.
// - tb_fp_commit_transfers applies a batch ONLY when it is order-free
//   (no linked/post/void/balancing flags), duplicate-free, and touches
//   no limit/history accounts, and no overflow is possible — the exact
//   conditions of the Python fast path.  Otherwise it returns FALLBACK
//   having mutated nothing, and Python takes another lane.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "hash_pool.h"
#include "sha256.h"

typedef unsigned __int128 u128;

namespace {

// Wire offsets within the 128-byte Transfer
// (tigerbeetle_tpu/types.py TRANSFER_DTYPE; reference:
// src/tigerbeetle.zig:80-111).
constexpr int OFF_ID_LO = 0;
constexpr int OFF_DR_LO = 16;
constexpr int OFF_CR_LO = 32;
constexpr int OFF_AMOUNT_LO = 48;
constexpr int OFF_PENDING_LO = 64;
constexpr int OFF_UD128_LO = 80;
constexpr int OFF_UD64 = 96;
constexpr int OFF_UD32 = 104;
constexpr int OFF_TIMEOUT = 108;
constexpr int OFF_LEDGER = 112;
constexpr int OFF_CODE = 116;
constexpr int OFF_FLAGS = 118;
constexpr int OFF_TIMESTAMP = 120;

// TransferFlags (types.py).
constexpr uint32_t F_LINKED = 1, F_PENDING = 2, F_POST = 4, F_VOID = 8;
constexpr uint32_t F_BAL_DR = 16, F_BAL_CR = 32;
constexpr uint32_t F_ORDER_DEP = F_LINKED | F_POST | F_VOID | F_BAL_DR | F_BAL_CR;
// AccountFlags.
constexpr uint32_t A_LIMIT_DR = 2, A_LIMIT_CR = 4, A_HISTORY = 8;

// CreateTransferResult codes used by the static ladder (types.py).
enum Code : uint32_t {
    OK = 0,
    TIMESTAMP_MUST_BE_ZERO = 3,
    RESERVED_FLAG = 4,
    ID_ZERO = 5,
    ID_MAX = 6,
    DR_ZERO = 8,
    DR_MAX = 9,
    CR_ZERO = 10,
    CR_MAX = 11,
    ACCOUNTS_SAME = 12,
    PENDING_ID_MUST_BE_ZERO = 13,
    TIMEOUT_RESERVED = 17,
    AMOUNT_ZERO = 18,
    LEDGER_ZERO = 19,
    CODE_ZERO = 20,
    DR_NOT_FOUND = 21,
    CR_NOT_FOUND = 22,
    LEDGERS_DIFFER = 23,
    TRANSFER_LEDGER_DIFFERS = 24,
};

constexpr uint64_t U64_MAX = ~0ull;
constexpr uint64_t NS_PER_S = 1000000000ull;

struct U128Hash {
    size_t operator()(u128 v) const {
        uint64_t lo = (uint64_t)v, hi = (uint64_t)(v >> 64);
        uint64_t h = lo * 0x9E3779B97F4A7C15ull ^ (hi + 0xC2B2AE3D27D4EB4Full);
        h ^= h >> 29;
        return (size_t)h;
    }
};

// Id directory: run-length ranges over sequential hi==0 ids (the
// recommended/benchmark id scheme) + hash fallback for everything else
// (mirrors tigerbeetle_tpu/utils/hashindex.py RunIndex).
struct IdDir {
    // Sorted, disjoint: ids [start, start+len) -> values [val0, ...).
    std::vector<uint64_t> starts, lens, vals;
    std::unordered_map<u128, uint64_t, U128Hash> map;

    size_t range_index(uint64_t lo) const {
        // Last range with start <= lo (or SIZE_MAX).
        size_t n = starts.size();
        size_t left = 0, right = n;
        while (left < right) {
            size_t mid = (left + right) / 2;
            if (starts[mid] <= lo) left = mid + 1; else right = mid;
        }
        return left == 0 ? SIZE_MAX : left - 1;
    }

    bool lookup(uint64_t lo, uint64_t hi, uint64_t* val) const {
        if (hi == 0 && !starts.empty()) {
            size_t i = range_index(lo);
            if (i != SIZE_MAX && lo - starts[i] < lens[i]) {
                *val = vals[i] + (lo - starts[i]);
                return true;
            }
        }
        auto it = map.find(((u128)hi << 64) | lo);
        if (it == map.end()) return false;
        *val = it->second;
        return true;
    }

    bool contains(uint64_t lo, uint64_t hi) const {
        uint64_t v;
        return lookup(lo, hi, &v);
    }

    // Batch insert; detects contiguous runs (ids and values both +1
    // steps, hi all zero, no u64 wrap).
    void insert(const uint64_t* lo, const uint64_t* hi, uint64_t val0,
                uint32_t n) {
        bool run = n >= 2 && hi[0] == 0 && lo[n - 1] >= lo[0];
        if (run) {
            for (uint32_t i = 1; i < n; i++) {
                if (hi[i] != 0 || lo[i] != lo[i - 1] + 1) { run = false; break; }
            }
        }
        if (run) {
            insert_range(lo[0], n, val0);
        } else {
            for (uint32_t i = 0; i < n; i++) {
                map.emplace(((u128)hi[i] << 64) | lo[i], val0 + i);
            }
        }
    }

    void insert_range(uint64_t start, uint64_t len, uint64_t val0) {
        size_t i = range_index(start);
        // Merge with predecessor when both ids and values abut.
        if (i != SIZE_MAX && starts[i] + lens[i] == start &&
            vals[i] + lens[i] == val0) {
            lens[i] += len;
            // May now abut the successor.
            size_t j = i + 1;
            if (j < starts.size() && starts[i] + lens[i] == starts[j] &&
                vals[i] + lens[i] == vals[j]) {
                lens[i] += lens[j];
                starts.erase(starts.begin() + j);
                lens.erase(lens.begin() + j);
                vals.erase(vals.begin() + j);
            }
            return;
        }
        size_t at = (i == SIZE_MAX) ? 0 : i + 1;
        // Merge with successor.
        if (at < starts.size() && start + len == starts[at] &&
            val0 + len == vals[at]) {
            starts[at] = start;
            lens[at] += len;
            vals[at] = val0;
            return;
        }
        starts.insert(starts.begin() + at, start);
        lens.insert(lens.begin() + at, len);
        vals.insert(vals.begin() + at, val0);
    }

    void remove(uint64_t lo, uint64_t hi) {
        // Remove from BOTH structures: defensive against an id that
        // was ever double-registered (map + range).
        u128 key = ((u128)hi << 64) | lo;
        map.erase(key);
        if (hi != 0) return;
        size_t i = range_index(lo);
        if (i == SIZE_MAX || lo - starts[i] >= lens[i]) return;
        uint64_t off = lo - starts[i];
        uint64_t tail = lens[i] - off - 1;
        if (off == 0 && tail == 0) {
            starts.erase(starts.begin() + i);
            lens.erase(lens.begin() + i);
            vals.erase(vals.begin() + i);
        } else if (off == 0) {
            starts[i] += 1; vals[i] += 1; lens[i] = tail;
        } else if (tail == 0) {
            lens[i] = off;
        } else {
            uint64_t ns = lo + 1, nv = vals[i] + off + 1;
            lens[i] = off;
            starts.insert(starts.begin() + i + 1, ns);
            lens.insert(lens.begin() + i + 1, tail);
            vals.insert(vals.begin() + i + 1, nv);
        }
    }
};

struct Fastpath {
    uint64_t capacity;
    // Balance mirror, SHARED with Python (numpy wraps these buffers).
    // Layout matches mirror.py: lo[A][4], hi[A][4]; cols dp,dpo,cp,cpo.
    std::vector<uint64_t> bal_lo, bal_hi;
    // Immutable account attributes.
    std::vector<uint32_t> acct_flags, acct_ledger;
    IdDir accounts;
    IdDir transfers;  // values unused (duplicate-id set)

    // Per-batch scratch (avoids reallocation).  Deltas use epoch-tagged
    // flat arrays over slot*4+col — O(1) accumulate with no hashing and
    // no per-batch clearing.
    std::unordered_set<u128, U128Hash> batch_ids;
    std::unordered_map<u128, uint32_t, U128Hash> batch_map;  // id -> index
    std::unordered_map<int64_t, uint32_t> dur_map;  // store row -> status
    std::vector<uint8_t> st_scratch;   // in-batch pending statuses
    std::vector<u128> delta_sum;       // capacity*4
    std::vector<uint32_t> delta_epoch; // capacity*4
    std::vector<uint64_t> delta_keys;  // touched keys, insertion order
    uint32_t epoch = 0;

    explicit Fastpath(uint64_t cap) : capacity(cap) {
        bal_lo.assign(cap * 4, 0);
        bal_hi.assign(cap * 4, 0);
        acct_flags.assign(cap, 0);
        acct_ledger.assign(cap, 0);
        delta_sum.assign(cap * 4, 0);
        delta_epoch.assign(cap * 4, 0);
        delta_keys.reserve(1 << 14);
    }

    // Accumulate `amount` into the per-batch delta for key; returns
    // false on u128 wrap.
    bool delta_add(uint64_t key, u128 amount) {
        if (delta_epoch[key] != epoch) {
            delta_epoch[key] = epoch;
            delta_sum[key] = 0;
            delta_keys.push_back(key);
        }
        u128& d = delta_sum[key];
        if (d + amount < d) return false;
        d += amount;
        return true;
    }

    u128 bal(uint64_t slot, int col) const {
        return ((u128)bal_hi[slot * 4 + col] << 64) | bal_lo[slot * 4 + col];
    }
    void set_bal(uint64_t slot, int col, u128 v) {
        bal_lo[slot * 4 + col] = (uint64_t)v;
        bal_hi[slot * 4 + col] = (uint64_t)(v >> 64);
    }
};

inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }

}  // namespace

extern "C" {

Fastpath* tb_fp_create(uint64_t account_capacity) {
    return new Fastpath(account_capacity);
}

void tb_fp_destroy(Fastpath* fp) { delete fp; }

// Shared-memory views for Python's BalanceMirror.
uint64_t* tb_fp_balances_lo(Fastpath* fp) { return fp->bal_lo.data(); }
uint64_t* tb_fp_balances_hi(Fastpath* fp) { return fp->bal_hi.data(); }

void tb_fp_add_accounts(Fastpath* fp, const uint64_t* id_lo,
                        const uint64_t* id_hi, const uint32_t* flags,
                        const uint32_t* ledger, uint32_t n,
                        uint64_t base_slot) {
    for (uint32_t i = 0; i < n; i++) {
        fp->acct_flags[base_slot + i] = flags[i];
        fp->acct_ledger[base_slot + i] = ledger[i];
    }
    fp->accounts.insert(id_lo, id_hi, base_slot, n);
}

void tb_fp_remove_accounts(Fastpath* fp, const uint64_t* id_lo,
                           const uint64_t* id_hi, uint32_t n) {
    for (uint32_t i = 0; i < n; i++) fp->accounts.remove(id_lo[i], id_hi[i]);
}

void tb_fp_add_transfer_ids(Fastpath* fp, const uint64_t* id_lo,
                            const uint64_t* id_hi, uint64_t base_row,
                            uint32_t n) {
    fp->transfers.insert(id_lo, id_hi, base_row, n);
}

void tb_fp_remove_transfer_ids(Fastpath* fp, const uint64_t* id_lo,
                               const uint64_t* id_hi, uint32_t n) {
    for (uint32_t i = 0; i < n; i++) fp->transfers.remove(id_lo[i], id_hi[i]);
}

// Returns 0 = applied (results/slots/deltas valid, balances updated);
//         1 = fallback required (NOTHING mutated).
int tb_fp_commit_transfers(
    Fastpath* fp, const uint8_t* body, uint32_t n, uint64_t ts_base,
    uint32_t* out_results, int32_t* out_dr_slot, int32_t* out_cr_slot,
    int64_t* out_dslot, int64_t* out_dcol, uint64_t* out_dlo,
    uint64_t* out_dhi, uint32_t* out_ndeltas) {
    // Pass 0: order-dependence scan + in-batch duplicate detection.
    bool seq = true;  // strictly-increasing hi==0 ids
    for (uint32_t i = 0; i < n; i++) {
        const uint8_t* e = body + (size_t)i * 128;
        uint32_t flags = rd16(e + OFF_FLAGS);
        if (flags & F_ORDER_DEP) return 1;
        if (rd64(e + OFF_ID_LO + 8) != 0 ||
            (i > 0 && rd64(e + OFF_ID_LO) <= rd64(e + OFF_ID_LO - 128)))
            seq = false;
    }
    if (!seq) {
        fp->batch_ids.clear();
        fp->batch_ids.reserve(n * 2);
        for (uint32_t i = 0; i < n; i++) {
            const uint8_t* e = body + (size_t)i * 128;
            u128 id = ((u128)rd64(e + OFF_ID_LO + 8) << 64) | rd64(e + OFF_ID_LO);
            if (!fp->batch_ids.insert(id).second) return 1;  // in-batch dup
        }
    }

    // Pass 1: ladder + admission accumulation (no mutation yet).
    if (++fp->epoch == 0) {  // epoch wrap: invalidate all tags
        std::fill(fp->delta_epoch.begin(), fp->delta_epoch.end(), 0);
        fp->epoch = 1;
    }
    fp->delta_keys.clear();
    for (uint32_t i = 0; i < n; i++) {
        const uint8_t* e = body + (size_t)i * 128;
        uint64_t id_lo = rd64(e + OFF_ID_LO), id_hi = rd64(e + OFF_ID_LO + 8);
        uint64_t dr_lo = rd64(e + OFF_DR_LO), dr_hi = rd64(e + OFF_DR_LO + 8);
        uint64_t cr_lo = rd64(e + OFF_CR_LO), cr_hi = rd64(e + OFF_CR_LO + 8);
        uint64_t amt_lo = rd64(e + OFF_AMOUNT_LO);
        uint64_t amt_hi = rd64(e + OFF_AMOUNT_LO + 8);
        uint64_t pend_lo = rd64(e + OFF_PENDING_LO);
        uint64_t pend_hi = rd64(e + OFF_PENDING_LO + 8);
        uint32_t timeout = rd32(e + OFF_TIMEOUT);
        uint32_t ledger = rd32(e + OFF_LEDGER);
        uint32_t code = rd16(e + OFF_CODE);
        uint32_t flags = rd16(e + OFF_FLAGS);
        uint64_t timestamp = rd64(e + OFF_TIMESTAMP);

        // Durable duplicate id -> exists-ladder territory: fallback.
        if (fp->transfers.contains(id_lo, id_hi)) return 1;

        uint64_t dr_slot_u = 0, cr_slot_u = 0;
        bool dr_found = fp->accounts.lookup(dr_lo, dr_hi, &dr_slot_u);
        bool cr_found = fp->accounts.lookup(cr_lo, cr_hi, &cr_slot_u);
        out_dr_slot[i] = dr_found ? (int32_t)dr_slot_u : -1;
        out_cr_slot[i] = cr_found ? (int32_t)cr_slot_u : -1;

        // Limit/history accounts need the exact kernel's bookkeeping.
        if (dr_found &&
            (fp->acct_flags[dr_slot_u] & (A_LIMIT_DR | A_LIMIT_CR | A_HISTORY)))
            return 1;
        if (cr_found &&
            (fp->acct_flags[cr_slot_u] & (A_LIMIT_DR | A_LIMIT_CR | A_HISTORY)))
            return 1;

        // Static ladder, precedence-exact
        // (reference: src/state_machine.zig:1465-1504; the timestamp
        // check precedes everything, :1251-1256).
        uint32_t c = OK;
        uint32_t dr_ledger = dr_found ? fp->acct_ledger[dr_slot_u] : 0;
        uint32_t cr_ledger = cr_found ? fp->acct_ledger[cr_slot_u] : 0;
        if (timestamp != 0) c = TIMESTAMP_MUST_BE_ZERO;
        else if (flags & ~0x3Fu) c = RESERVED_FLAG;
        else if (id_lo == 0 && id_hi == 0) c = ID_ZERO;
        else if (id_lo == U64_MAX && id_hi == U64_MAX) c = ID_MAX;
        else if (dr_lo == 0 && dr_hi == 0) c = DR_ZERO;
        else if (dr_lo == U64_MAX && dr_hi == U64_MAX) c = DR_MAX;
        else if (cr_lo == 0 && cr_hi == 0) c = CR_ZERO;
        else if (cr_lo == U64_MAX && cr_hi == U64_MAX) c = CR_MAX;
        else if (dr_lo == cr_lo && dr_hi == cr_hi) c = ACCOUNTS_SAME;
        else if (pend_lo != 0 || pend_hi != 0) c = PENDING_ID_MUST_BE_ZERO;
        else if (!(flags & F_PENDING) && timeout != 0) c = TIMEOUT_RESERVED;
        else if (amt_lo == 0 && amt_hi == 0) c = AMOUNT_ZERO;
        else if (ledger == 0) c = LEDGER_ZERO;
        else if (code == 0) c = CODE_ZERO;
        else if (!dr_found) c = DR_NOT_FOUND;
        else if (!cr_found) c = CR_NOT_FOUND;
        else if (dr_ledger != cr_ledger) c = LEDGERS_DIFFER;
        else if (ledger != dr_ledger) c = TRANSFER_LEDGER_DIFFERS;
        out_results[i] = c;
        if (c != OK) continue;

        if (flags & F_PENDING) {
            // Timeout expiry arithmetic must not overflow (the exact
            // path ranks overflows_timeout correctly).
            uint64_t ts_i = ts_base + i;
            uint64_t expires = ts_i + (uint64_t)timeout * NS_PER_S;
            if (timeout != 0 && expires < ts_i) return 1;
        }

        u128 amount = ((u128)amt_hi << 64) | amt_lo;
        int dr_col = (flags & F_PENDING) ? 0 : 1;  // dp : dpo
        int cr_col = (flags & F_PENDING) ? 2 : 3;  // cp : cpo
        // Accumulate with wrap detection: a wrapped u128 sum would
        // corrupt the admission check below.
        if (!fp->delta_add(dr_slot_u * 4 + (uint64_t)dr_col, amount)) return 1;
        if (!fp->delta_add(cr_slot_u * 4 + (uint64_t)cr_col, amount)) return 1;
    }

    // Pass 2: admission — every touched column and combined total must
    // stay within u128 (reference: src/state_machine.zig:1531-1547).
    for (uint64_t key : fp->delta_keys) {
        u128 old_v = fp->bal(key / 4, (int)(key % 4));
        if (old_v + fp->delta_sum[key] < old_v) return 1;  // column overflow
    }
    // Combined totals per touched slot (dp+dpo, cp+cpo): a slot may
    // appear under several keys; checking it per key is idempotent.
    for (uint64_t key : fp->delta_keys) {
        uint64_t slot = key / 4;
        u128 cols[4];
        for (int c2 = 0; c2 < 4; c2++) {
            cols[c2] = fp->bal(slot, c2);
            uint64_t k2 = slot * 4 + (uint64_t)c2;
            if (fp->delta_epoch[k2] == fp->epoch) cols[c2] += fp->delta_sum[k2];
        }
        u128 dr_tot = cols[0] + cols[1];
        if (dr_tot < cols[0]) return 1;
        u128 cr_tot = cols[2] + cols[3];
        if (cr_tot < cols[2]) return 1;
    }

    // Pass 3: apply + emit compacted deltas for the device queue.
    uint32_t k = 0;
    for (uint64_t key : fp->delta_keys) {
        uint64_t slot = key / 4;
        int col = (int)(key % 4);
        u128 d = fp->delta_sum[key];
        fp->set_bal(slot, col, fp->bal(slot, col) + d);
        out_dslot[k] = (int64_t)slot;
        out_dcol[k] = col;
        out_dlo[k] = (uint64_t)d;
        out_dhi[k] = (uint64_t)(d >> 64);
        k++;
    }
    *out_ndeltas = k;
    return 0;
}

// ----------------------------------------------------------------------
// Columnar ingest fast path: batch wire verification + batch reply
// finalize for a whole server drain (runtime/server.py poll_once).
// Frame layout per tigerbeetle_tpu_torch/vsr/wire.py HEADER_DTYPE.

static constexpr uint32_t WIRE_HEADER_SIZE = 256;
static constexpr uint32_t WIRE_OFF_CHECKSUM = 0;
static constexpr uint32_t WIRE_OFF_CHECKSUM_BODY = 16;
static constexpr uint32_t WIRE_OFF_SIZE = 144;
static constexpr uint32_t WIRE_OFF_VERSION = 155;
static constexpr uint8_t WIRE_VERSION = 1;

// Verify one frame — exactly wire.verify_header(header, body).
// Returns the count of BODY bytes hashed (0 when the frame fails a
// structural check before the body pass) and, on a fully-verified
// frame, records the body digest in the drain-scoped digest table so
// the build seams can reuse it without rehashing.
static uint64_t fp_verify_one(const uint8_t* frame, uint32_t len,
                              uint8_t* ok) {
    *ok = 0;
    if (len < WIRE_HEADER_SIZE) return 0;
    uint32_t size;
    memcpy(&size, frame + WIRE_OFF_SIZE, 4);
    if (size != len || size < WIRE_HEADER_SIZE) return 0;
    if (frame[WIRE_OFF_VERSION] != WIRE_VERSION) return 0;
    uint64_t cs[2];
    tb::checksum128(frame + 16, WIRE_HEADER_SIZE - 16, cs);
    if (memcmp(frame + WIRE_OFF_CHECKSUM, cs, 16) != 0) return 0;
    uint64_t body_len = size - WIRE_HEADER_SIZE;
    tb::checksum128(frame + WIRE_HEADER_SIZE, body_len, cs);
    if (memcmp(frame + WIRE_OFF_CHECKSUM_BODY, cs, 16) != 0)
        return body_len;
    tb::digest_table().put(frame + WIRE_HEADER_SIZE, body_len, cs[0],
                           cs[1]);
    *ok = 1;
    return body_len;
}

// One pass over a drain's frames packed in `arena`: per frame, verify
// the header checksum (bytes [16, 256)), the version byte, the size
// field against the framed length, and the body checksum.  ok[i] = 1
// when frame i is valid.  (The uncounted entry point; the drain path
// calls tb_fp_verify_frames2 below.)
void tb_fp_verify_frames(const uint8_t* arena, const uint64_t* offsets,
                         const uint32_t* lens, uint32_t n, uint8_t* ok) {
    for (uint32_t i = 0; i < n; i++)
        fp_verify_one(arena + offsets[i], lens[i], &ok[i]);
}

// The counted verify: same contract plus (a) a new digest-table crossing —
// the previous drain's cached digests die here, this drain's verified
// body digests are recorded for the build seams to reuse; (b) frames
// fan out across the hash pool lanes (each lane verifies whole frames
// — header hash, body hash, memcmps all off the drain thread); and
// (c) the return value is the total BODY bytes this crossing hashed,
// feeding the hash.bytes_hashed counter.
uint64_t tb_fp_verify_frames2(const uint8_t* arena, const uint64_t* offsets,
                              const uint32_t* lens, uint32_t n,
                              uint8_t* ok) {
    tb::digest_table().invalidate();
    std::atomic<uint64_t> bytes{0};
    tb::hash_parallel_for(n, [&](uint32_t i) {
        uint64_t b = fp_verify_one(arena + offsets[i], lens[i], &ok[i]);
        if (b) bytes.fetch_add(b, std::memory_order_relaxed);
    });
    return bytes.load(std::memory_order_relaxed);
}

// Batch reply finalize: `headers` is n contiguous 256-byte records
// with every field but the checksums already set; bodies[i]/body_lens
// [i] is reply i's body.  Sets size, checksum_body, checksum — one C
// call replaces 2n hashlib calls + per-reply numpy churn (the "one
// encode pass + scatter" half of the columnar ingest path).  Replies
// are independent of each other, so the per-reply finalize (body hash
// + header hash) fans out across the hash pool — no signature change,
// the binding gets the lanes for free.
void tb_fp_finalize_headers(uint8_t* headers, uint32_t n,
                            const uint8_t* const* bodies,
                            const uint32_t* body_lens) {
    tb::hash_parallel_for(n, [&](uint32_t i) {
        uint8_t* h = headers + uint64_t(i) * WIRE_HEADER_SIZE;
        uint32_t blen = body_lens[i];
        uint32_t size = WIRE_HEADER_SIZE + blen;
        memcpy(h + WIRE_OFF_SIZE, &size, 4);
        uint64_t cb[2];
        tb::checksum128(bodies[i], blen, cb);
        memcpy(h + WIRE_OFF_CHECKSUM_BODY, cb, 16);
        uint64_t cs[2];
        tb::checksum128(h + 16, WIRE_HEADER_SIZE - 16, cs);
        memcpy(h + WIRE_OFF_CHECKSUM, cs, 16);
    });
}

// ---- Hash pool + engine control (envcheck-validated knobs are
// read in Python and pushed down here; C never reads the env) ----

// threads: worker lanes beside the calling thread (0 = inline, the
// 1-core default); clamped to [0, HASH_THREADS_MAX].  force_engine:
// 0 = auto-resolve, else a Sha256Engine value for the --hash-only
// bench grid (forcing an unresolved tier degrades down, same as auto).
void tb_hash_configure(int32_t threads, int32_t force_engine) {
    if (threads < 0) threads = 0;
    if (threads > tb::HASH_THREADS_MAX) threads = tb::HASH_THREADS_MAX;
    tb::hash_threads_cfg().store(threads, std::memory_order_relaxed);
    tb::sha256_force() = (int)force_engine;
}

// Which SHA-256 tier actually resolved (Sha256Engine: 1 = EVP one-shot
// / SHA-NI dispatch, 2 = legacy SHA256(), 3 = the 225 MB/s scalar
// core).  The Python side names these in bench rows and raises the
// one-time scalar-fallback warning.
int32_t tb_hash_engine(void) { return (int32_t)tb::sha256_engine(); }

// out[0] = jobs executed on pool lanes (lanes_busy numerator);
// out[1] = digest-table hits; out[2] = configured lane count.
void tb_hash_stats(uint64_t out[3]) {
    out[0] = tb::hash_lane_jobs().load(std::memory_order_relaxed);
    out[1] = tb::hash_table_hits().load(std::memory_order_relaxed);
    out[2] =
        (uint64_t)tb::hash_threads_cfg().load(std::memory_order_relaxed);
}

// ----------------------------------------------------------------------
// Wire -> store-column decode (the commit hot path's bookkeeping).
//
// One pass over the 128-byte Transfer records writes every store
// column contiguously (tpu.py _STORE_FIELDS) — replacing ~17 strided
// numpy gathers per batch.  dr/cr slots arrive separately (account
// resolution output); timestamps are ts_base + i; status is
// S_PENDING (1) for applied pending creates, else 0.
// PRECONDITION: every event applied (the caller's hot-tail gate) —
// failed events must never reach the store, so partial batches take
// the shared slow path instead of this decode.
void tb_fp_decode_store(
    const uint8_t* wire, uint32_t n, uint64_t ts_base,
    uint64_t* id_lo, uint64_t* id_hi,
    uint64_t* amount_lo, uint64_t* amount_hi,
    uint64_t* pending_lo, uint64_t* pending_hi,
    uint64_t* ud128_lo, uint64_t* ud128_hi, uint64_t* ud64,
    uint32_t* ud32, uint32_t* timeout_, uint32_t* ledger,
    uint32_t* code, uint32_t* flags, uint64_t* timestamp,
    uint8_t* status) {
    for (uint32_t i = 0; i < n; i++) {
        const uint8_t* r = wire + size_t(i) * 128;
        id_lo[i] = rd64(r + 0);
        id_hi[i] = rd64(r + 8);
        amount_lo[i] = rd64(r + 48);
        amount_hi[i] = rd64(r + 56);
        pending_lo[i] = rd64(r + 64);
        pending_hi[i] = rd64(r + 72);
        ud128_lo[i] = rd64(r + 80);
        ud128_hi[i] = rd64(r + 88);
        ud64[i] = rd64(r + 96);
        ud32[i] = rd32(r + 104);
        timeout_[i] = rd32(r + 108);
        ledger[i] = rd32(r + 112);
        code[i] = rd16(r + 116);
        uint16_t f = rd16(r + 118);
        flags[i] = f;
        timestamp[i] = ts_base + i;
        status[i] = (f & 0x2) ? 1 : 0;  // S_PENDING (TF.pending applied)
    }
}

}  // extern "C"

#include "tb_exact.inc"
#include "tb_linked.inc"
#include "tb_two_phase.inc"
#include "tb_lsm.inc"
