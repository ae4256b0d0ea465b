// tb_pipeline: the per-prepare native commit pipeline.
//
// Moves the VSR steady-state per-prepare hot loop below Python
// (vsr/multi.py keeps view changes, checkpoints, and recovery):
//
// - Header construction + checksum stamping for prepares and
//   prepare_oks, bit-identical to wire.make_header + wire.copy_trace +
//   wire.finalize_header (tigerbeetle_tpu_torch/vsr/wire.py HEADER_DTYPE —
//   the offsets below are asserted against it by the Python binding's
//   ABI version check and the differential tests).
// - Journal append framing: the sector-padded prepare buffer and the
//   redundant-header sector are built here and handed to
//   vsr/journal.py as ready-to-write buffers; the in-memory redundant
//   header ring (journal.headers, a contiguous numpy HEADER_DTYPE
//   array) is written in place.
// - Pipeline bookkeeping: the primary's in-flight slot table (op,
//   canonical checksum, ack bitset, synced flag) and the group-commit
//   gate query (quorum AND synced AND contiguous) — one C call per
//   gate decision instead of per-entry Python set/flag churn.
//
// Differential contract (the TB_FASTPATH_DECODE pattern one layer
// higher): with TB_NATIVE_PIPELINE=0/1 every reply frame, WAL byte,
// and commit decision must be identical.  Nothing here may consult
// any state Python does not also hold.
//
// Compiled into libtb_fastpath.so (Makefile adds this file to both
// the release and asan FASTPATH rules).  tb_pl_abi_version() is the
// stale-.so tripwire: the Python loader refuses a library whose
// version disagrees instead of AttributeError-ing mid-drain.

#include <array>
#include <cstdint>
#include <cstring>
#include <vector>

#include "hash_pool.h"
#include "sha256.h"

namespace {

// HEADER_DTYPE field offsets (tigerbeetle_tpu_torch/vsr/wire.py).
constexpr uint32_t PL_HEADER_SIZE = 256;
constexpr uint32_t OFF_CHECKSUM = 0;        // u128
constexpr uint32_t OFF_CHECKSUM_BODY = 16;  // u128
constexpr uint32_t OFF_PARENT = 32;         // u128
constexpr uint32_t OFF_CLIENT = 48;         // u128
constexpr uint32_t OFF_CLUSTER = 64;        // u128
constexpr uint32_t OFF_CONTEXT = 80;        // u128
constexpr uint32_t OFF_REQUEST = 112;       // u32
constexpr uint32_t OFF_VIEW = 116;          // u32
constexpr uint32_t OFF_OP = 120;            // u64
constexpr uint32_t OFF_COMMIT = 128;        // u64
constexpr uint32_t OFF_TIMESTAMP = 136;     // u64
constexpr uint32_t OFF_HDRSIZE = 144;       // u32
constexpr uint32_t OFF_RELEASE = 148;       // u32
constexpr uint32_t OFF_REPLICA = 152;       // u8
constexpr uint32_t OFF_COMMAND = 153;       // u8
constexpr uint32_t OFF_OPERATION = 154;     // u8
constexpr uint32_t OFF_HDRVERSION = 155;    // u8
constexpr uint32_t OFF_TRACE = 156;         // trace_id u64 + trace_ts u64
constexpr uint32_t TRACE_BYTES = 17;        // ... + trace_flags u8

constexpr uint8_t CMD_PREPARE = 6;
constexpr uint8_t CMD_PREPARE_OK = 7;
constexpr uint8_t PL_WIRE_VERSION = 1;

inline void wr32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
inline void wr64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
inline uint64_t pl_rd64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

// Stamp size + a KNOWN checksum_body + checksum: the header hash can
// never be skipped (it covers fresh fields), but the body hash can
// when an earlier stage already proved the digest — that split is the
// whole reuse seam.
void pl_stamp(uint8_t* h, uint64_t body_len, const uint64_t cb[2]) {
    wr32(h + OFF_HDRSIZE, PL_HEADER_SIZE + (uint32_t)body_len);
    memcpy(h + OFF_CHECKSUM_BODY, cb, 16);
    uint64_t cs[2];
    tb::checksum128(h + 16, PL_HEADER_SIZE - 16, cs);
    memcpy(h + OFF_CHECKSUM, cs, 16);
}

// Stamp size + checksum_body + checksum — wire.finalize_header.
void pl_finalize(uint8_t* h, const uint8_t* body, uint64_t body_len) {
    uint64_t cb[2];
    tb::checksum128(body, body_len, cb);
    pl_stamp(h, body_len, cb);
}

// Resolve a prepare body's digest without hashing, under the reuse
// invariant: every body reaching a build seam arrived under a header
// whose checksum_body was verified (ingress frames) or freshly
// computed over these exact bytes (_build_batch_request's coalesce
// finalize) — so req_hdr[OFF_CHECKSUM_BODY] IS SHA-256(body)[:16].
// The drain-scoped digest table is consulted first (zero-copy bodies
// still in the arena); the header carry covers everything else.
void pl_reuse_digest(const uint8_t* req_hdr, const uint8_t* body,
                     uint64_t body_len, uint64_t cb[2]) {
    if (!tb::digest_table().get(body, body_len, cb))
        memcpy(cb, req_hdr + OFF_CHECKSUM_BODY, 16);
}

// Journal append framing body, shared by the per-prepare entry point
// (tb_pl_frame_prepare) and the per-drain batch calls:
// out_prepare := header || body zero-padded to a sector multiple
// (returned); headers_ring[slot] := header (in-memory redundant ring,
// written in place); out_sector := the slot's redundant-header sector.
uint64_t pl_frame(const uint8_t* hdr, const uint8_t* body, uint64_t body_len,
                  uint8_t* headers_ring, uint64_t slot,
                  uint32_t headers_per_sector, uint32_t sector_size,
                  uint8_t* out_prepare, uint8_t* out_sector) {
    uint64_t msg = PL_HEADER_SIZE + body_len;
    uint64_t padded = (msg + sector_size - 1) / sector_size * sector_size;
    memcpy(out_prepare, hdr, PL_HEADER_SIZE);
    if (body_len) memcpy(out_prepare + PL_HEADER_SIZE, body, body_len);
    memset(out_prepare + msg, 0, padded - msg);
    memcpy(headers_ring + slot * PL_HEADER_SIZE, hdr, PL_HEADER_SIZE);
    uint64_t first = slot / headers_per_sector * headers_per_sector;
    uint64_t used = (uint64_t)headers_per_sector * PL_HEADER_SIZE;
    memcpy(out_sector, headers_ring + first * PL_HEADER_SIZE, used);
    memset(out_sector + used, 0, sector_size - used);
    return padded;
}

// The primary's in-flight slot table.  Pipelines are shallow
// (pipeline_prepare_queue_max, single digits), so a linear-scan
// vector beats any hashing; entries are appended in op order and
// erased on commit/reset.
struct PlEntry {
    uint64_t op;
    uint8_t checksum[16];  // the prepare's canonical checksum
    uint64_t votes;        // ack bitset by replica index (< 64)
    uint8_t synced;        // own WAL copy covered by a sync
};

struct Pipeline {
    std::vector<PlEntry> entries;
};

PlEntry* pl_find(Pipeline* pl, uint64_t op) {
    for (auto& e : pl->entries) {
        if (e.op == op) return &e;
    }
    return nullptr;
}

}  // namespace

extern "C" {

// Bumped whenever any tb_pl_* signature or semantic changes; the
// Python binding refuses to use a library reporting a different
// version (stale prebuilt .so whose rebuild failed).
uint32_t tb_pl_abi_version(void) { return 3; }

Pipeline* tb_pl_create(void) { return new Pipeline(); }

void tb_pl_destroy(Pipeline* pl) { delete pl; }

void tb_pl_reset(Pipeline* pl) { pl->entries.clear(); }

uint32_t tb_pl_size(Pipeline* pl) {
    return (uint32_t)pl->entries.size();
}

// Build + finalize a prepare header into out[256] — bit-identical to
// _primary_prepare's make_header(command=prepare, ...) + copy_trace
// (request -> prepare) + finalize_header(body).  client / request /
// operation / trace context are read from the triggering request's
// header; everything else arrives as scalars.  `context` is the
// logical-batch sub-request count (u128 low limb; high limb zero).
// flags bit 0 (TB_HASH_REUSE): take checksum_body from the
// digest table / the request header instead of rehashing the body —
// bit-identical by the reuse invariant (see pl_reuse_digest).
static void pl_prepare_fields(
    const uint8_t* req_hdr, uint64_t cluster_lo, uint64_t cluster_hi,
    uint32_t view, uint64_t op, uint64_t commit, uint64_t timestamp,
    uint64_t parent_lo, uint64_t parent_hi, uint32_t replica,
    uint64_t context, uint32_t release, uint8_t* out) {
    memset(out, 0, PL_HEADER_SIZE);
    memcpy(out + OFF_CLIENT, req_hdr + OFF_CLIENT, 16);
    memcpy(out + OFF_REQUEST, req_hdr + OFF_REQUEST, 4);
    out[OFF_OPERATION] = req_hdr[OFF_OPERATION];
    memcpy(out + OFF_TRACE, req_hdr + OFF_TRACE, TRACE_BYTES);
    wr64(out + OFF_CLUSTER, cluster_lo);
    wr64(out + OFF_CLUSTER + 8, cluster_hi);
    wr64(out + OFF_PARENT, parent_lo);
    wr64(out + OFF_PARENT + 8, parent_hi);
    wr64(out + OFF_CONTEXT, context);
    wr32(out + OFF_VIEW, view);
    wr64(out + OFF_OP, op);
    wr64(out + OFF_COMMIT, commit);
    wr64(out + OFF_TIMESTAMP, timestamp);
    wr32(out + OFF_RELEASE, release);
    out[OFF_REPLICA] = (uint8_t)replica;
    out[OFF_COMMAND] = CMD_PREPARE;
    out[OFF_HDRVERSION] = PL_WIRE_VERSION;
}

void tb_pl_build_prepare(
    const uint8_t* req_hdr, const uint8_t* body, uint64_t body_len,
    uint64_t cluster_lo, uint64_t cluster_hi, uint32_t view, uint64_t op,
    uint64_t commit, uint64_t timestamp, uint64_t parent_lo,
    uint64_t parent_hi, uint32_t replica, uint64_t context,
    uint32_t release, uint32_t flags, uint8_t* out) {
    pl_prepare_fields(req_hdr, cluster_lo, cluster_hi, view, op, commit,
                      timestamp, parent_lo, parent_hi, replica, context,
                      release, out);
    if (flags & 1u) {
        uint64_t cb[2];
        pl_reuse_digest(req_hdr, body, body_len, cb);
        pl_stamp(out, body_len, cb);
    } else {
        pl_finalize(out, body, body_len);
    }
}

// Build + finalize a prepare_ok header into out[256] — bit-identical
// to _send_prepare_ok's make_header(command=prepare_ok, ...) +
// copy_trace(prepare -> ok) + finalize_header(b"").  `context` is the
// prepare's own checksum (the vote names exact content).
void tb_pl_build_prepare_ok(const uint8_t* prepare_hdr, uint32_t view,
                            uint32_t replica, uint8_t* out) {
    memset(out, 0, PL_HEADER_SIZE);
    memcpy(out + OFF_CLUSTER, prepare_hdr + OFF_CLUSTER, 16);
    memcpy(out + OFF_CONTEXT, prepare_hdr + OFF_CHECKSUM, 16);
    memcpy(out + OFF_CLIENT, prepare_hdr + OFF_CLIENT, 16);
    memcpy(out + OFF_OP, prepare_hdr + OFF_OP, 8);
    memcpy(out + OFF_TRACE, prepare_hdr + OFF_TRACE, TRACE_BYTES);
    wr32(out + OFF_VIEW, view);
    out[OFF_REPLICA] = (uint8_t)replica;
    out[OFF_COMMAND] = CMD_PREPARE_OK;
    out[OFF_HDRVERSION] = PL_WIRE_VERSION;
    pl_finalize(out, nullptr, 0);
}

// Journal append framing (journal.write_prepare's byte layout):
// out_prepare := header || body, zero-padded to a sector multiple
// (returned); headers_ring[slot] := header (the in-memory redundant
// ring, written in place); out_sector := the slot's redundant-header
// sector (headers_per_sector ring entries, zero-padded to
// sector_size).  The caller issues the two storage writes at offsets
// it computes from the zone layout.
uint64_t tb_pl_frame_prepare(
    const uint8_t* hdr, const uint8_t* body, uint64_t body_len,
    uint8_t* headers_ring, uint64_t slot, uint32_t headers_per_sector,
    uint32_t sector_size, uint8_t* out_prepare, uint8_t* out_sector) {
    return pl_frame(hdr, body, body_len, headers_ring, slot,
                    headers_per_sector, sector_size, out_prepare, out_sector);
}

// Register an in-flight prepare (op + canonical checksum from its
// header) with the primary's self-vote.  An existing entry for the op
// is overwritten (view-change requeue re-registers the adopted tail).
void tb_pl_note_prepare(Pipeline* pl, const uint8_t* hdr, int synced,
                        uint32_t self_replica) {
    uint64_t op = pl_rd64(hdr + OFF_OP);
    PlEntry* e = pl_find(pl, op);
    if (e == nullptr) {
        pl->entries.push_back(PlEntry{});
        e = &pl->entries.back();
    }
    e->op = op;
    memcpy(e->checksum, hdr + OFF_CHECKSUM, 16);
    e->votes = 1ull << (self_replica & 63u);
    e->synced = (uint8_t)(synced != 0);
}

// Record a prepare_ok vote.  Returns the entry's vote count, or
// -1 when the op has no in-flight entry (already committed/dropped),
// -2 when the ack's context does not name the entry's exact checksum
// (a stale sibling's vote) — both mirror _on_prepare_ok's early
// returns exactly.
int tb_pl_on_ack(Pipeline* pl, const uint8_t* ok_hdr) {
    uint64_t op = pl_rd64(ok_hdr + OFF_OP);
    PlEntry* e = pl_find(pl, op);
    if (e == nullptr) return -1;
    if (memcmp(e->checksum, ok_hdr + OFF_CONTEXT, 16) != 0) return -2;
    e->votes |= 1ull << (ok_hdr[OFF_REPLICA] & 63u);
    return __builtin_popcountll(e->votes);
}

void tb_pl_mark_all_synced(Pipeline* pl) {
    for (auto& e : pl->entries) e.synced = 1;
}

int tb_pl_set_synced(Pipeline* pl, uint64_t op, int synced) {
    PlEntry* e = pl_find(pl, op);
    if (e == nullptr) return -1;
    e->synced = (uint8_t)(synced != 0);
    return 0;
}

void tb_pl_drop(Pipeline* pl, uint64_t op) {
    for (size_t i = 0; i < pl->entries.size(); i++) {
        if (pl->entries[i].op == op) {
            pl->entries.erase(pl->entries.begin() + (ptrdiff_t)i);
            return;
        }
    }
}

// The group-commit gate: 1 when the NEXT op (commit_min + 1) is
// in-flight with a replication quorum of exact-checksum votes AND its
// own WAL copy is sync-covered — _maybe_commit_pipeline's quorum /
// synced / contiguity checks in one call.
int tb_pl_commit_ready(Pipeline* pl, uint64_t commit_min,
                       uint32_t quorum) {
    PlEntry* e = pl_find(pl, commit_min + 1);
    if (e == nullptr || !e->synced) return 0;
    return __builtin_popcountll(e->votes) >= (int)quorum ? 1 : 0;
}

uint32_t tb_pl_votes(Pipeline* pl, uint64_t op) {
    PlEntry* e = pl_find(pl, op);
    return e == nullptr ? 0 : (uint32_t)__builtin_popcountll(e->votes);
}

// ---- The C-resident drain loop (one call per drain batch) ----
//
// The per-item calls above stay for K=1 callers and the differential
// arm; the three batch entry points below run a whole drain's worth
// of builds/framings/votes in one Python->C crossing each.  Every
// byte they produce must match a loop over the per-item calls — the
// TB_NATIVE_DRAIN=0/1 differential suite holds them to it.

// Primary drain: build + finalize K prepares chained
// parent->checksum (parent_lo/hi seeds op0's parent), register each
// in the slot table with the self-vote, and frame each for the
// journal into caller arenas:
//   wal_arena[out_wal_off[i] .. +out_wal_len[i]]  — sector-padded
//     prepare for slot out_slot[i] (= (op0+i) % slot_count);
//   sector_arena[i*sector_size ..]                — redundant-header
//     sector out_sector_index[i].
// Capacity is checked up front: on overflow returns -1 with NOTHING
// mutated (the caller falls back to the per-item path).  Returns k.
// flags bit 0: digest reuse — see tb_pl_build_prepare.  With
// reuse OFF the body digests (the only order-independent hash work;
// the header pass is strictly sequential through the parent chain)
// are computed up front across the hash pool lanes.
int64_t tb_pl_build_prepares(
    Pipeline* pl, const uint8_t* req_hdrs, const uint8_t* const* bodies,
    const uint64_t* body_lens, const uint64_t* timestamps,
    const uint64_t* contexts, uint64_t k, uint64_t cluster_lo,
    uint64_t cluster_hi, uint32_t view, uint64_t op0, uint64_t commit,
    uint64_t parent_lo, uint64_t parent_hi, uint32_t replica,
    uint32_t release, int synced, uint32_t flags, uint8_t* out_hdrs,
    uint8_t* headers_ring,
    uint64_t slot_count, uint32_t headers_per_sector, uint32_t sector_size,
    uint8_t* wal_arena, uint64_t wal_cap, uint64_t* out_wal_off,
    uint64_t* out_wal_len, uint64_t* out_slot, uint8_t* sector_arena,
    uint64_t* out_sector_index) {
    uint64_t need = 0;
    for (uint64_t i = 0; i < k; i++) {
        uint64_t msg = PL_HEADER_SIZE + body_lens[i];
        need += (msg + sector_size - 1) / sector_size * sector_size;
    }
    if (need > wal_cap) return -1;
    std::vector<std::array<uint64_t, 2>> cbs(k);
    if (flags & 1u) {
        for (uint64_t i = 0; i < k; i++)
            pl_reuse_digest(req_hdrs + i * PL_HEADER_SIZE, bodies[i],
                            body_lens[i], cbs[i].data());
    } else {
        tb::hash_parallel_for((uint32_t)k, [&](uint32_t i) {
            tb::checksum128(bodies[i], body_lens[i], cbs[i].data());
        });
    }
    uint64_t wal_at = 0;
    uint64_t plo = parent_lo;
    uint64_t phi = parent_hi;
    for (uint64_t i = 0; i < k; i++) {
        uint8_t* out = out_hdrs + i * PL_HEADER_SIZE;
        pl_prepare_fields(req_hdrs + i * PL_HEADER_SIZE, cluster_lo,
                          cluster_hi, view, op0 + i, commit, timestamps[i],
                          plo, phi, replica, contexts[i], release, out);
        pl_stamp(out, body_lens[i], cbs[i].data());
        plo = pl_rd64(out + OFF_CHECKSUM);
        phi = pl_rd64(out + OFF_CHECKSUM + 8);
        tb_pl_note_prepare(pl, out, synced, replica);
        uint64_t slot = (op0 + i) % slot_count;
        uint64_t padded =
            pl_frame(out, bodies[i], body_lens[i], headers_ring, slot,
                     headers_per_sector, sector_size, wal_arena + wal_at,
                     sector_arena + i * sector_size);
        out_wal_off[i] = wal_at;
        out_wal_len[i] = padded;
        out_slot[i] = slot;
        out_sector_index[i] = slot / headers_per_sector;
        wal_at += padded;
    }
    return (int64_t)k;
}

// Backup drain: frame K accepted prepares for the journal (same
// descriptor layout as tb_pl_build_prepares) and, unless the caller
// is a standby (build_oks=0), build the K prepare_ok headers in one
// pass.  No slot-table involvement — backups hold no vote state.
// Returns k, or -1 on arena overflow with nothing mutated.
int64_t tb_pl_accept_prepares(
    const uint8_t* hdrs, const uint8_t* const* bodies,
    const uint64_t* body_lens, uint64_t k, uint32_t view, uint32_t replica,
    int build_oks, uint8_t* out_oks, uint8_t* headers_ring,
    uint64_t slot_count, uint32_t headers_per_sector, uint32_t sector_size,
    uint8_t* wal_arena, uint64_t wal_cap, uint64_t* out_wal_off,
    uint64_t* out_wal_len, uint64_t* out_slot, uint8_t* sector_arena,
    uint64_t* out_sector_index) {
    uint64_t need = 0;
    for (uint64_t i = 0; i < k; i++) {
        uint64_t msg = PL_HEADER_SIZE + body_lens[i];
        need += (msg + sector_size - 1) / sector_size * sector_size;
    }
    if (need > wal_cap) return -1;
    uint64_t wal_at = 0;
    for (uint64_t i = 0; i < k; i++) {
        const uint8_t* h = hdrs + i * PL_HEADER_SIZE;
        uint64_t slot = pl_rd64(h + OFF_OP) % slot_count;
        uint64_t padded =
            pl_frame(h, bodies[i], body_lens[i], headers_ring, slot,
                     headers_per_sector, sector_size, wal_arena + wal_at,
                     sector_arena + i * sector_size);
        out_wal_off[i] = wal_at;
        out_wal_len[i] = padded;
        out_slot[i] = slot;
        out_sector_index[i] = slot / headers_per_sector;
        wal_at += padded;
        if (build_oks) {
            tb_pl_build_prepare_ok(h, view, replica,
                                   out_oks + i * PL_HEADER_SIZE);
        }
    }
    return (int64_t)k;
}

// Vote a whole run of prepare_ok headers in one call.  Per-ack
// verdict in out_votes[i]: -4 foreign cluster, -3 stale/future view,
// -1 unknown op, -2 stale-sibling checksum (tb_pl_on_ack's codes),
// else the entry's vote count after this ack.  Returns the number of
// acks that landed a vote.
int64_t tb_pl_on_acks(Pipeline* pl, const uint8_t* ok_hdrs, uint64_t k,
                      uint64_t cluster_lo, uint64_t cluster_hi,
                      uint32_t view, int64_t* out_votes) {
    int64_t accepted = 0;
    for (uint64_t i = 0; i < k; i++) {
        const uint8_t* h = ok_hdrs + i * PL_HEADER_SIZE;
        if (pl_rd64(h + OFF_CLUSTER) != cluster_lo ||
            pl_rd64(h + OFF_CLUSTER + 8) != cluster_hi) {
            out_votes[i] = -4;
            continue;
        }
        uint32_t hv;
        memcpy(&hv, h + OFF_VIEW, 4);
        if (hv != view) {
            out_votes[i] = -3;
            continue;
        }
        int r = tb_pl_on_ack(pl, h);
        out_votes[i] = r;
        if (r >= 0) accepted++;
    }
    return accepted;
}

// The contiguous run of commit-ready ops: the largest n such that
// every op in (commit_min, commit_min + n] is in-flight, synced, and
// holds a replication quorum — tb_pl_commit_ready extended from one
// gate decision to the whole drain's worth.
uint64_t tb_pl_commit_ready_run(Pipeline* pl, uint64_t commit_min,
                                uint32_t quorum) {
    uint64_t n = 0;
    for (;;) {
        PlEntry* e = pl_find(pl, commit_min + 1 + n);
        if (e == nullptr || !e->synced) break;
        if (__builtin_popcountll(e->votes) < (int)quorum) break;
        n++;
    }
    return n;
}

}  // extern "C"
