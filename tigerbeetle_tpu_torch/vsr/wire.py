"""VSR wire protocol: the 256-byte message header and checksums.

This package's own copy of ``tigerbeetle_tpu/vsr/wire.py``.

Re-designs the reference's `vsr.Header` (reference:
src/vsr/message_header.zig:17-103) as one flat little-endian layout
instead of per-command comptime unions: every command uses the same
field offsets, unused fields must be zero.  The 256-byte size, the
checksum/checksum_body/parent chaining discipline, and the command
vocabulary (reference: src/vsr.zig:273-311) are preserved.

Checksums: the reference uses AEGIS-128L MAC-as-checksum (reference:
src/vsr/checksum.zig:1-60, hardware AES).  This build is a standalone
framework — clients and replicas are ours — so we use SHA-256
truncated to 128 bits: available at C speed in both Python (hashlib)
and the C++ runtime, no key management, collision-resistant.  The
discipline is identical: `checksum` covers header bytes [16..256),
`checksum_body` covers the body, every header/body/disk block is
verified before any cast.
"""

from __future__ import annotations

import enum
import hashlib

import numpy as np

from tigerbeetle_tpu_torch.constants import HEADER_SIZE

# reference: src/vsr.zig:273-311 (Command, 23 kinds)
class Command(enum.IntEnum):
    reserved = 0
    ping = 1
    pong = 2
    ping_client = 3
    pong_client = 4
    request = 5
    prepare = 6
    prepare_ok = 7
    reply = 8
    commit = 9
    start_view_change = 10
    do_view_change = 11
    start_view = 12
    request_start_view = 13
    request_headers = 14
    request_prepare = 15
    request_reply = 16
    headers = 17
    eviction = 18
    request_blocks = 19
    block = 20
    request_sync_checkpoint = 21
    sync_checkpoint = 22
    # Ours: typed admission-control shed (runtime/server.py).  Unlike
    # `eviction` it is NOT fatal to the session — the request was never
    # admitted, so the client may back off and retry under the same
    # request number.  Legacy clients that predate the command ignore
    # it and recover through their normal retransmission cadence.
    client_busy = 23


# reference: src/vsr.zig:318-411 — operations 0-127 are VSR-reserved;
# >=128 belong to the state machine (tigerbeetle_tpu_torch.types.Operation).
class VsrOperation(enum.IntEnum):
    reserved = 0
    root = 1
    register = 2
    reconfigure = 3
    pulse = 4
    upgrade = 5
    # Admin scrape (ours): answered by the server loop directly from
    # its obs registry snapshot — read-only, sessionless, never enters
    # the consensus pipeline (obs/scrape.py).
    stats = 6
    # Proof-of-state query (ours): the 16-byte incremental state
    # commitment + commit_min, answered by the server loop from the
    # state machine's host twin — same sessionless, never-prepared
    # shape as `stats` (state_machine/commitment.py; the router folds
    # per-shard roots into one cluster commitment).
    state_root = 7


HEADER_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),          # [0, 16)
        ("checksum_body_lo", "<u8"), ("checksum_body_hi", "<u8"),  # [16, 32)
        ("parent_lo", "<u8"), ("parent_hi", "<u8"),              # [32, 48)
        ("client_lo", "<u8"), ("client_hi", "<u8"),              # [48, 64)
        ("cluster_lo", "<u8"), ("cluster_hi", "<u8"),            # [64, 80)
        ("context_lo", "<u8"), ("context_hi", "<u8"),            # [80, 96)
        ("checkpoint_id_lo", "<u8"), ("checkpoint_id_hi", "<u8"),  # [96, 112)
        ("request", "<u4"), ("view", "<u4"),                     # [112, 120)
        ("op", "<u8"),                                           # [120, 128)
        ("commit", "<u8"),                                       # [128, 136)
        ("timestamp", "<u8"),                                    # [136, 144)
        ("size", "<u4"),                                         # [144, 148)
        ("release", "<u4"),                                      # [148, 152)
        ("replica", "u1"), ("command", "u1"),                    # [152, 154)
        ("operation", "u1"), ("version", "u1"),                  # [154, 156)
        # Trace context (ours): carved from the reserved region so
        # every hop of a sampled request carries its identity — the
        # request id, the origin CLOCK_MONOTONIC timestamp stamped at
        # client submit, and the sampled flag.  Zero everywhere for
        # untraced messages (the old all-reserved layout), so legacy
        # headers stay bit-identical.
        ("trace_id", "<u8"),                                     # [156, 164)
        ("trace_ts", "<u8"),                                     # [164, 172)
        ("trace_flags", "u1"),                                   # [172, 173)
        # Tenant key (ours): the LEDGER this request's
        # events belong to, stamped by tenant-aware clients so
        # admission/scheduling can key on it without touching the
        # body.  Zero (legacy clients, VSR-internal messages) means
        # "derive from the body's leading event" (tenant_of below) —
        # so legacy headers stay bit-identical, exactly like the
        # trace-context carve-out above.
        ("tenant", "<u4"),                                       # [173, 177)
        # Read attestation (ours): follower-served read
        # replies carry the 16-byte state commitment of the state they
        # were answered from plus the op it covers (`root_op` = the
        # follower's commit_min), so a client can verify integrity AND
        # staleness against the cluster commitment (the primary's
        # root-at-op ring).  Zero everywhere else — primary replies
        # and every legacy message stay bit-identical, exactly like
        # the trace/tenant carve-outs above.
        ("state_root_lo", "<u8"), ("state_root_hi", "<u8"),      # [177, 193)
        ("root_op", "<u8"),                                      # [193, 201)
        ("reserved", "V55"),                                     # [201, 256)
    ]
)
assert HEADER_DTYPE.itemsize == HEADER_SIZE, HEADER_DTYPE.itemsize

# trace_flags bits.
TRACE_SAMPLED = 1

# ----------------------------------------------------------------------
# Multi-tenant QoS: the tenant key is the LEDGER.

# Typed busy payload: a QoS shed carries WHO was shed and the rate the
# server observed for that tenant, so a client can size its backoff.
# Legacy (QoS-off) busy replies keep an empty body — bit-identical to
# the older wire contract; clients must treat both shapes as busy.
BUSY_BODY_DTYPE = np.dtype(
    [
        ("tenant", "<u4"),        # ledger the shed request belonged to
        ("queue_depth", "<u4"),   # tenant's queued requests at shed time
        ("observed_rps", "<u8"),  # tenant's arrival rate, requests/sec
    ]
)

# `ledger` offset inside the 128-byte Account AND Transfer wire rows
# (both place it at the same offset; asserted against types.py on
# first use so a layout change cannot silently break derivation).
_LEDGER_OFFSET: int | None = None
_LEDGER_OPS: tuple[int, int] = ()  # (create_accounts, create_transfers)


def _ledger_layout() -> tuple[int, tuple[int, int]]:
    global _LEDGER_OFFSET, _LEDGER_OPS
    if _LEDGER_OFFSET is None:
        from tigerbeetle_tpu_torch import types

        off_a = types.ACCOUNT_DTYPE.fields["ledger"][1]
        off_t = types.TRANSFER_DTYPE.fields["ledger"][1]
        assert off_a == off_t, (off_a, off_t)
        _LEDGER_OFFSET = off_a
        _LEDGER_OPS = (
            int(types.Operation.create_accounts),
            int(types.Operation.create_transfers),
        )
    return _LEDGER_OFFSET, _LEDGER_OPS


def tenant_of(header: np.ndarray, body: bytes | memoryview | None = None,
              ) -> int:
    """The tenant (ledger) a client request belongs to.

    Precedence: the header's explicit `tenant` stamp (tenant-aware
    clients), else the `ledger` field of the body's first event for
    the create operations (legacy clients grouped by their actual
    ledger), else 0 — the shared best-effort class (lookups/filters
    carry no ledger on the wire)."""
    t = int(header["tenant"])
    if t:
        return t
    if body is None or len(body) == 0:
        return 0
    offset, ledger_ops = _ledger_layout()
    if int(header["operation"]) not in ledger_ops:
        return 0
    if len(body) < offset + 4:
        return 0
    return int.from_bytes(bytes(body[offset : offset + 4]), "little")


# ----------------------------------------------------------------------
# Root-attested follower serving (runtime/follower.py).


class FollowerRefuse(enum.IntEnum):
    """Typed reasons a follower declines a read (client_busy body).
    The split matters to routers: `lagging`/`overload` are transient
    (redirect to the primary, retry the follower later with backoff);
    `unattested`/`poisoned`/`corrupt`/`gap` mean the follower cannot
    currently PROVE its state and refuses rather than lie."""

    lagging = 1      # behind the staleness bound; primary has fresher
    unattested = 2   # no successful root cross-check yet
    poisoned = 3     # replayed root MISMATCHED the primary's — fatal
    overload = 4     # read admission (QoS) shed
    not_readable = 5  # write/unknown op sent to a read-only follower
    corrupt = 6      # tailed log failed checksum mid-file
    gap = 7          # op discontinuity in the tailed log
    incompatible = 8  # replayed record rejected by the state machine


# Typed follower refusal payload: WHY plus how far behind, so a
# client/router can decide between redirecting and backing off.
# Length-distinct from the 16-byte tenant BUSY_BODY_DTYPE, so
# parse_busy_body / parse_follower_busy disambiguate structurally.
FOLLOWER_BUSY_DTYPE = np.dtype(
    [
        ("reason", "<u4"),      # FollowerRefuse
        ("follower", "<u4"),    # follower id (operator-assigned)
        ("lag_ops", "<u8"),     # primary op estimate - follower commit_min
        ("commit_min", "<u8"),  # the follower's replayed-to op
    ]
)
assert FOLLOWER_BUSY_DTYPE.itemsize != BUSY_BODY_DTYPE.itemsize


def follower_busy_body(reason: int, follower: int, lag_ops: int,
                       commit_min: int) -> bytes:
    row = np.zeros(1, FOLLOWER_BUSY_DTYPE)[0]
    row["reason"] = int(reason)
    row["follower"] = follower & 0xFFFFFFFF
    row["lag_ops"] = max(0, lag_ops)
    row["commit_min"] = commit_min
    return row.tobytes()


def parse_follower_busy(body: bytes) -> tuple[int, int, int, int] | None:
    """(reason, follower, lag_ops, commit_min), or None for any other
    busy-body shape."""
    if len(body) != FOLLOWER_BUSY_DTYPE.itemsize:
        return None
    row = np.frombuffer(body, FOLLOWER_BUSY_DTYPE)[0]
    return (int(row["reason"]), int(row["follower"]),
            int(row["lag_ops"]), int(row["commit_min"]))


def stamp_attestation(h: np.ndarray, root: bytes, op: int) -> np.ndarray:
    """Stamp a follower reply's attestation fields.  Must run BEFORE
    finalize_header — the checksum covers them."""
    assert len(root) == 16, len(root)
    h["state_root_lo"] = int.from_bytes(root[:8], "little")
    h["state_root_hi"] = int.from_bytes(root[8:], "little")
    h["root_op"] = op
    return h


def attestation_of(h: np.ndarray) -> tuple[bytes, int] | None:
    """(root, op) when the reply carries an attestation, else None
    (primary-served / legacy replies are all-zero here; op 0 is the
    empty root prepare, never a servable state)."""
    op = int(h["root_op"])
    if not op:
        return None
    root = (
        int(h["state_root_lo"]).to_bytes(8, "little")
        + int(h["state_root_hi"]).to_bytes(8, "little")
    )
    return root, op


def busy_body(tenant: int, queue_depth: int, observed_rps: int) -> bytes:
    row = np.zeros(1, BUSY_BODY_DTYPE)[0]
    row["tenant"] = tenant & 0xFFFFFFFF
    row["queue_depth"] = min(queue_depth, 0xFFFFFFFF)
    row["observed_rps"] = observed_rps
    return row.tobytes()


def parse_busy_body(body: bytes) -> tuple[int, int, int] | None:
    """(tenant, queue_depth, observed_rps), or None for a legacy
    (empty / unknown-shape) busy body."""
    if len(body) != BUSY_BODY_DTYPE.itemsize:
        return None
    row = np.frombuffer(body, BUSY_BODY_DTYPE)[0]
    return int(row["tenant"]), int(row["queue_depth"]), int(row["observed_rps"])

# Wire-protocol version (ours, not the reference's).
VERSION = 1

_CHECKSUM_BODY_EMPTY = None  # computed lazily below


def checksum(data: bytes | memoryview | np.ndarray) -> int:
    """128-bit truncated SHA-256 (little-endian int)."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return int.from_bytes(hashlib.sha256(data).digest()[:16], "little")


def checksum_pair(data) -> tuple[int, int]:
    c = checksum(data)
    return c & 0xFFFFFFFFFFFFFFFF, c >> 64


def make_header(**fields) -> np.ndarray:
    """A zeroed header record with the given fields set.

    u128-valued logical fields (parent, client, cluster, context,
    checkpoint_id) may be passed as plain ints and are split into
    limbs.
    """
    h = np.zeros(1, HEADER_DTYPE)[0]
    h["version"] = VERSION
    h["size"] = HEADER_SIZE
    for name, value in fields.items():
        if f"{name}_lo" in HEADER_DTYPE.names:
            h[f"{name}_lo"] = value & 0xFFFFFFFFFFFFFFFF
            h[f"{name}_hi"] = value >> 64
        else:
            h[name] = value
    return h


def u128(h: np.ndarray, name: str) -> int:
    return int(h[f"{name}_lo"]) | (int(h[f"{name}_hi"]) << 64)


def copy_trace(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Propagate the trace context from `src` into `dst` (request ->
    prepare -> prepare_ok / reply).  Must run BEFORE finalize_header:
    the checksum covers the trace fields."""
    dst["trace_id"] = src["trace_id"]
    dst["trace_ts"] = src["trace_ts"]
    dst["trace_flags"] = src["trace_flags"]
    return dst


def trace_sampled(h: np.ndarray) -> int:
    """The header's trace id when it is sampled, else 0 — one check
    for every stage-recording call site."""
    if int(h["trace_flags"]) & TRACE_SAMPLED:
        return int(h["trace_id"])
    return 0


def finalize_header(
    h: np.ndarray, body: bytes = b"",
    checksum_body: tuple[int, int] | None = None,
) -> np.ndarray:
    """Set size + checksum_body + checksum.  Returns `h` for chaining.

    `checksum_body` is the hash-once reuse seam: a caller
    that already holds `body`'s digest — e.g. from a verified request
    header, whose checksum_body field the ingress verify pass proved
    equals SHA-256(body)[:16] — passes the (lo, hi) limb pair and the
    body pass is skipped.  The caller owns the invariant that the pair
    IS this body's digest; a wrong pair produces a frame that every
    verifier rejects (fail-closed, not silent corruption)."""
    h["size"] = HEADER_SIZE + len(body)
    cb_lo, cb_hi = (
        checksum_pair(body) if checksum_body is None else checksum_body
    )
    h["checksum_body_lo"] = cb_lo
    h["checksum_body_hi"] = cb_hi
    raw = bytearray(h.tobytes())
    c_lo, c_hi = checksum_pair(bytes(raw[16:]))
    h["checksum_lo"] = c_lo
    h["checksum_hi"] = c_hi
    return h


def header_from_bytes(raw: bytes) -> np.ndarray:
    assert len(raw) == HEADER_SIZE, len(raw)
    return np.frombuffer(raw, HEADER_DTYPE)[0].copy()


def headers_from_arena(arena: np.ndarray, offsets: np.ndarray,
                       n: int) -> np.ndarray:
    """Gather the leading 256 header bytes of `n` frames packed in a
    drain arena into one (n,) HEADER_DTYPE record array — a single
    vectorized fancy-index instead of n frombuffer/copy round trips.
    The result is a standalone copy (safe to retain past arena reuse).
    Frames shorter than a header must be excluded by the caller (the
    bus's size-field framing already guarantees >= HEADER_SIZE)."""
    if n == 0:
        return np.empty(0, HEADER_DTYPE)
    if n <= 4:
        # Small drains: direct per-frame casts beat building the
        # (n, 256) gather index (the fixed cost that showed up as a
        # fake per-event decode number on idle protocol rounds).
        out = np.empty(n, HEADER_DTYPE)
        for i in range(n):
            off = int(offsets[i])
            out[i] = np.frombuffer(
                arena, HEADER_DTYPE, count=1, offset=off
            )[0]
        return out
    idx = (
        offsets[:n, None].astype(np.int64)
        + np.arange(HEADER_SIZE, dtype=np.int64)[None, :]
    )
    flat = np.ascontiguousarray(arena[idx]).reshape(n * HEADER_SIZE)
    return flat.view(HEADER_DTYPE)


def finalize_headers_py(headers: np.ndarray, bodies: list) -> None:
    """Fallback batch reply finalize (hashlib per header) — same
    result bytes as the native tb_fp_finalize_headers pass."""
    for i, body in enumerate(bodies):
        finalize_header(headers[i], body)


def verify_header(h: np.ndarray, body: bytes | None = None) -> bool:
    """Checksum + structural validity; body checked when provided."""
    raw = h.tobytes()
    c_lo, c_hi = checksum_pair(raw[16:])
    if int(h["checksum_lo"]) != c_lo or int(h["checksum_hi"]) != c_hi:
        return False
    if int(h["version"]) != VERSION:
        return False
    if int(h["size"]) < HEADER_SIZE:
        return False
    if body is not None:
        if int(h["size"]) != HEADER_SIZE + len(body):
            return False
        cb_lo, cb_hi = checksum_pair(body)
        if int(h["checksum_body_lo"]) != cb_lo or int(h["checksum_body_hi"]) != cb_hi:
            return False
    return True


def root_prepare(cluster: int) -> np.ndarray:
    """The deterministic op=0 root prepare every data file starts with
    (reference: src/vsr/message_header.zig Header.Prepare.root)."""
    h = make_header(
        cluster=cluster,
        command=Command.prepare,
        operation=VsrOperation.root,
        op=0,
        commit=0,
        view=0,
        timestamp=0,
    )
    return finalize_header(h, b"")
