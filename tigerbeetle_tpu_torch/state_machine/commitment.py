"""Incremental state commitments over the account table.

Counterpart of ``tigerbeetle_tpu/state_machine/commitment.py``: the
same construction bit for bit (the golden digest in
``tests/test_torch_commitment.py`` pins it).

- Per-row hash ``h(i, row)``: row index + 8 u64 balance limbs + 2 u32
  meta columns (flags, ledger) mixed lane-wise through a splitmix64
  finalizer, xor-combined, finalized into two u64 lanes; an all-zero
  row hashes to (0, 0), so the digest does not depend on capacity.
- Fold: per-lane sum mod 2^64; the 16-byte fold is the state root.
- Incremental update: re-hash just the touched rows, subtract their
  stored hashes, add the new ones.

Host side (numpy): ``rows_hash``, ``fold``, ``table_digest``,
``root_bytes``, ``HostCommitment`` (the twin on the BalanceMirror) and
``pad_slots``.  Device side: ``rebuild``, ``update``, ``admit`` (the
tiered admission's hash swap) and ``probe`` — each a wrapper that
launches kernel K2 (``csrc/commitment.cu``) on a CUDA tensor and runs
its plain PyTorch version (``*_plain``) on a CPU tensor.  Tensors hold
u64 lanes as int64 and u32 meta as int32.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.ops.u128 import MASK32, s64, shr

# PINNED hash-stream constants (format of the state root).
GAMMA = 0x9E3779B97F4A7C15
K_COL = 0xC2B2AE3D27D4EB4F
M1 = 0xFF51AFD7ED558CCD
M2 = 0xC4CEB9FE1A85EC53
C_LO = 0x8BADF00D5CA1AB1E
C_HI = 0xFACEFEED0DDBA11D

ROOT_BYTES = 16  # (2,) u64 little-endian

_MASK64 = (1 << 64) - 1


# ----------------------------------------------------------------------
# Host side (numpy u64).


def _mix64(x):
    """splitmix64-style finalizer on u64 numpy arrays (wrapping)."""
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(M1)
    x = x ^ (x >> np.uint64(29))
    x = x * np.uint64(M2)
    return x ^ (x >> np.uint64(32))


def rows_hash(rows, bal8, meta2):
    """(k,) lo and (k,) hi u64 hash lanes for global row indices `rows`
    with (k, 8) u64 balances and (k, 2) meta columns."""
    r = np.asarray(rows).astype(np.uint64)
    rstream = r * np.uint64(GAMMA)
    acc = np.zeros(r.shape, np.uint64)
    nonzero = np.zeros(r.shape, bool)
    cols = [bal8[:, j] for j in range(8)] + [meta2[:, j] for j in range(2)]
    for j, col in enumerate(cols):
        v = col.astype(np.uint64)
        nonzero |= v != 0
        acc ^= _mix64(v ^ rstream ^ np.uint64(((j + 1) * K_COL) & _MASK64))
    lo = _mix64(acc ^ rstream ^ np.uint64(C_LO))
    hi = _mix64(acc ^ rstream ^ np.uint64(C_HI))
    zero = np.uint64(0)
    return np.where(nonzero, lo, zero), np.where(nonzero, hi, zero)


def fold(lo, hi) -> np.ndarray:
    """(2,) u64 order-independent fold (per-lane sum mod 2^64)."""
    return np.array(
        [np.add.reduce(lo, dtype=np.uint64), np.add.reduce(hi, dtype=np.uint64)],
        np.uint64,
    )


def table_digest(bal8, meta2, start_row: int = 0) -> np.ndarray:
    """From-scratch digest of (n, 8) balances + (n, 2) meta whose first
    row has global index `start_row` — the oracle every incremental
    path must match."""
    n = bal8.shape[0]
    rows = np.arange(n, dtype=np.uint64) + np.uint64(start_row)
    return fold(*rows_hash(rows, bal8, meta2))


def root_bytes(digest) -> bytes:
    """16-byte little-endian state root of a (2,) u64 digest."""
    return np.asarray(digest, dtype="<u8").tobytes()


def digest_of_root(root: bytes) -> np.ndarray:
    assert len(root) == ROOT_BYTES, len(root)
    return np.frombuffer(root, "<u8").copy()


# ----------------------------------------------------------------------
# Cluster commitment: fold per-shard roots into one deterministic
# 16-byte value.  The shard INDEX is mixed into each shard's
# contribution (shards own disjoint account ranges, so two shards
# swapping state must move the cluster root), then lanes sum — the
# same fold algebra as rows, one level up.


def fold_cluster(roots: list[bytes]) -> bytes:
    acc = np.zeros(2, np.uint64)
    lane_c = np.array([C_LO, C_HI], np.uint64)
    for index, root in enumerate(roots):
        d = digest_of_root(root)
        stream = np.uint64((((index + 1) * GAMMA) & _MASK64))
        acc = acc + _mix64(d ^ stream ^ lane_c)
    return root_bytes(acc)


# ----------------------------------------------------------------------
# Wire codec for the read-only `state_root` query (rides the
# sessionless stats-op shape; obs/scrape.py is the client; the
# reference's copy is tigerbeetle_tpu/state_machine/commitment.py).  Fixed
# little-endian layout, safe to decode from untrusted bytes:
#   shard reply:   root[16] + commit_min u64          (24 bytes)
#   cluster reply: root[16] + n_shards u64            (24 bytes)

_ROOT_BODY = np.dtype([("root", "V16"), ("aux", "<u8")])


def root_body(root: bytes, aux: int) -> bytes:
    row = np.zeros(1, _ROOT_BODY)[0]
    row["root"] = root
    row["aux"] = aux
    return row.tobytes()


def parse_root_body(body: bytes) -> tuple[bytes, int]:
    if len(body) != _ROOT_BODY.itemsize:
        raise ValueError(f"state_root body: {len(body)} bytes")
    row = np.frombuffer(body, _ROOT_BODY)[0]
    return bytes(row["root"]), int(row["aux"])


# At-op query: a `state_root` REQUEST may carry an 8-byte
# little-endian op — "give me your root as of op N" — answered from
# the replica's root ring (vsr/replica.py enable_root_ring).  An empty
# request body keeps the legacy meaning (current root + commit_min);
# a server without the requested op in its ring answers current too,
# and the caller detects the op mismatch (unverifiable-at-N, not an
# error).  The follower attestation loop is the primary client.


def root_query_body(op: int) -> bytes:
    return int(op).to_bytes(8, "little")


def parse_root_query(body: bytes) -> int | None:
    """Requested op of a state_root query body, or None for the
    legacy empty (current-root) shape / any unknown shape."""
    if len(body) != 8:
        return None
    return int.from_bytes(body, "little")


class HostCommitment:
    """Per-row hashes + running fold over the host mirror.

    `meta_fn(slots) -> (k, 2) uint32` supplies the meta columns (flags,
    ledger); balances are read live from the mirror passed in.
    """

    def __init__(self, capacity: int, meta_fn) -> None:
        self.row_lo = np.zeros(capacity, np.uint64)
        self.row_hi = np.zeros(capacity, np.uint64)
        self.digest = np.zeros(2, np.uint64)
        self.meta_fn = meta_fn

    def _ensure(self, capacity: int) -> None:
        if capacity <= len(self.row_lo):
            return
        for name in ("row_lo", "row_hi"):
            old = getattr(self, name)
            new = np.zeros(capacity, np.uint64)
            new[: len(old)] = old
            setattr(self, name, new)

    def refresh(self, slots, mirror) -> None:
        """Re-hash `slots` (any order, duplicates fine) from the current
        mirror + meta and roll the fold forward; idempotent."""
        slots = np.unique(np.asarray(slots, np.int64))
        slots = slots[slots >= 0]
        if len(slots) == 0:
            return
        self._ensure(len(mirror.lo))
        slots = slots[slots < len(self.row_lo)]
        if len(slots) == 0:
            return
        bal8 = np.empty((len(slots), 8), np.uint64)
        bal8[:, 0::2] = mirror.lo[slots]
        bal8[:, 1::2] = mirror.hi[slots]
        lo, hi = rows_hash(slots, bal8, self.meta_fn(slots))
        delta = np.array(
            [
                np.add.reduce(lo - self.row_lo[slots], dtype=np.uint64),
                np.add.reduce(hi - self.row_hi[slots], dtype=np.uint64),
            ],
            np.uint64,
        )
        self.digest = self.digest + delta
        self.row_lo[slots] = lo
        self.row_hi[slots] = hi

    def rebuild(self, mirror) -> None:
        """From-scratch recompute."""
        cap = len(mirror.lo)
        self.row_lo = np.zeros(cap, np.uint64)
        self.row_hi = np.zeros(cap, np.uint64)
        self.digest = np.zeros(2, np.uint64)
        self.refresh(np.arange(cap, dtype=np.int64), mirror)

    def partial(self, rows) -> np.ndarray:
        """(2,) u64 fold of the stored hashes of `rows` (any order,
        duplicates collapsed): the host's view of a tiered device
        engine's hot partial.  The fold is a per-lane sum, so
        ``digest == partial(hot) + partial(cold)`` for any split."""
        rows = np.unique(np.asarray(rows, np.int64))
        rows = rows[(rows >= 0) & (rows < len(self.row_lo))]
        return np.array(
            [
                np.add.reduce(self.row_lo[rows], dtype=np.uint64),
                np.add.reduce(self.row_hi[rows], dtype=np.uint64),
            ],
            np.uint64,
        )

    def root_bytes(self) -> bytes:
        return root_bytes(self.digest)


def pad_slots(slots: np.ndarray, minimum: int = 256) -> np.ndarray:
    """Pad a deduplicated slot array to a power-of-two bucket (-1 fill),
    the reference's update-kernel shape contract."""
    n = max(int(len(slots)), 1)
    bucket = minimum
    while bucket < n:
        bucket <<= 1
    out = np.full(bucket, -1, np.int64)
    out[: len(slots)] = slots
    return out


# ----------------------------------------------------------------------
# Device side: plain PyTorch versions (int64 lanes) and the wrappers.


def _mix64_t(x):
    x = x ^ shr(x, 33)
    x = x * s64(M1)
    x = x ^ shr(x, 29)
    x = x * s64(M2)
    return x ^ shr(x, 32)


def rows_hash_plain(rows, bal8, meta2):
    """Tensor twin of rows_hash: int64 (k,) rows, (k, 8) int64 balances,
    (k, 2) int32 meta -> (lo, hi) int64 lanes."""
    rstream = rows * s64(GAMMA)
    acc = torch.zeros_like(rows)
    nonzero = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    cols = [bal8[:, j] for j in range(8)] + [
        meta2[:, j].to(torch.int64) & MASK32 for j in range(2)
    ]
    for j, v in enumerate(cols):
        nonzero |= v != 0
        acc = acc ^ _mix64_t(v ^ rstream ^ s64((j + 1) * K_COL))
    lo = _mix64_t(acc ^ rstream ^ s64(C_LO))
    hi = _mix64_t(acc ^ rstream ^ s64(C_HI))
    zero = torch.zeros_like(lo)
    return torch.where(nonzero, lo, zero), torch.where(nonzero, hi, zero)


def rebuild_plain(balances, meta, rows):
    lo, hi = rows_hash_plain(rows, balances, meta)
    return torch.stack([lo, hi], dim=-1), torch.stack([lo.sum(), hi.sum()])


def update_plain(balances, meta, row_hash, digest, slots, rows):
    """Plain version of K2 update, the reference's ``_update``: -1 is
    padding; a slot past the table (s >= A) is read as row A-1 was
    before the call (its balances, meta and stored hash: the reference's
    clamped gather), moves the digest by new - old and stores nothing.
    Slots are distinct.  In place."""
    A = balances.shape[0]
    valid = slots >= 0
    idx = torch.where(valid, slots, 0).clamp(max=A - 1)
    r = torch.where(valid, rows, 0)
    lo, hi = rows_hash_plain(r, balances[idx], meta[idx])
    new = torch.stack([lo, hi], dim=-1)
    new = torch.where(valid[:, None], new, 0)
    old = torch.where(valid[:, None], row_hash[idx], 0)
    digest += (new - old).sum(dim=0)
    keep = valid & (slots < A)
    row_hash[slots[keep]] = new[keep]
    return row_hash, digest


def admit_plain(row_hash, digest, slots, new_lo, new_hi):
    """Plain version of K2 admit, the reference's ``_admit``: at each hot
    slot replace the stored row hash with (new_lo, new_hi) and move the
    digest by new - old.  -1 is padding; a slot past the table (s >= H)
    takes as old row H-1's hash as it was before the call (the
    reference's clamped gather) and stores nothing.  Slots are distinct.
    In place."""
    H = row_hash.shape[0]
    valid = slots >= 0
    idx = torch.where(valid, slots, 0).clamp(max=H - 1)
    new = torch.where(valid[:, None], torch.stack([new_lo, new_hi], dim=-1), 0)
    old = torch.where(valid[:, None], row_hash[idx], 0)
    digest += (new - old).sum(dim=0)
    keep = valid & (slots < H)
    row_hash[slots[keep]] = new[keep]
    return row_hash, digest


def probe_plain(balances, meta, digest, rows):
    lo, hi = rows_hash_plain(rows, balances, meta)
    return torch.stack([digest, torch.stack([lo.sum(), hi.sum()])])


def _check_tables(balances, meta, rows, k=None):
    A = balances.shape[0]
    if balances.dtype != torch.int64 or balances.shape != (A, 8):
        raise ValueError(f"balances must be (A, 8) int64, got {balances.shape} {balances.dtype}")
    if meta.dtype != torch.int32 or meta.shape != (A, 2):
        raise ValueError(f"meta must be (A, 2) int32, got {meta.shape} {meta.dtype}")
    want = A if k is None else k
    if rows.dtype != torch.int64 or rows.shape != (want,):
        raise ValueError(f"rows must be ({want},) int64, got {rows.shape} {rows.dtype}")
    for t in (balances, meta, rows):
        if t.device != balances.device or not t.is_contiguous():
            raise ValueError("tensors must be contiguous and on one device")


def _check_digest(balances, digest):
    if digest.shape != (2,) or digest.dtype != torch.int64:
        raise ValueError(f"digest must be (2,) int64, got {digest.shape} {digest.dtype}")
    if digest.device != balances.device or not digest.is_contiguous():
        raise ValueError("digest must be contiguous on the tables' device")


def rebuild(balances, meta, rows):
    """(row_hash (A, 2), digest (2,)) from scratch.  K2 on CUDA."""
    _check_tables(balances, meta, rows)
    if balances.device.type == "cpu":
        return rebuild_plain(balances, meta, rows)
    A = balances.shape[0]
    row_hash = torch.empty((A, 2), dtype=torch.int64, device=balances.device)
    digest = torch.zeros(2, dtype=torch.int64, device=balances.device)
    kernels.commit_hash_all(balances, meta, rows, row_hash, digest, "commit_rebuild")
    return row_hash, digest


def update(balances, meta, row_hash, digest, slots, rows):
    """Absorb deduplicated touched `slots` (-1 = padding; a slot past the
    table reads row A-1 and stores nothing, as in the reference) hashed
    under logical ids `rows`.  Updates `row_hash` and `digest` IN PLACE
    (the reference returns new arrays) and returns them.  K2 on CUDA."""
    _check_tables(balances, meta, rows, k=slots.shape[0])
    A = balances.shape[0]
    _check_digest(balances, digest)
    if row_hash.shape != (A, 2) or row_hash.dtype != torch.int64:
        raise ValueError("row_hash must be (A, 2) int64")
    if row_hash.device != balances.device or not row_hash.is_contiguous():
        raise ValueError("row_hash must be contiguous on the tables' device")
    if slots.dtype != torch.int64 or slots.device != balances.device or not slots.is_contiguous():
        raise ValueError("slots must be contiguous int64 on the tables' device")
    if A == 0 and slots.shape[0]:
        raise ValueError("the tables have no rows")
    if balances.device.type == "cpu":
        return update_plain(balances, meta, row_hash, digest, slots, rows)
    kernels.commit_update(balances, meta, row_hash, digest, slots, rows)
    return row_hash, digest


def admit(row_hash, digest, slots, new_lo, new_hi):
    """Tiered admission in one step: the row hashes at hot `slots` (the
    victims', or (0, 0) for a free slot) become the admitted rows' host
    twin hashes (new_lo, new_hi), and the hot-partial digest moves by
    new - old.  Exact because the admitted device rows are uploaded from
    the very mirror rows the twin hashed.  `slots` are distinct; -1 is
    padding; a slot past the table takes row H-1's hash as old and
    stores nothing, as in the reference.  Updates `row_hash` and
    `digest` IN PLACE and returns them.  K2 admit on CUDA."""
    H = row_hash.shape[0]
    if row_hash.dtype != torch.int64 or row_hash.shape != (H, 2):
        raise ValueError(f"row_hash must be (H, 2) int64, got {tuple(row_hash.shape)}")
    _check_digest(row_hash, digest)
    k = slots.shape[0]
    for name, t in (("slots", slots), ("new_lo", new_lo), ("new_hi", new_hi)):
        if t.dtype != torch.int64 or t.shape != (k,):
            raise ValueError(f"{name} must be ({k},) int64, got {tuple(t.shape)} {t.dtype}")
    for t in (row_hash, slots, new_lo, new_hi):
        if t.device != row_hash.device or not t.is_contiguous():
            raise ValueError("tensors must be contiguous and on one device")
    if H == 0 and k:
        raise ValueError("row_hash has no rows")
    if row_hash.device.type == "cpu":
        return admit_plain(row_hash, digest, slots, new_lo, new_hi)
    if k:
        kernels.commit_admit(row_hash, digest, slots, new_lo, new_hi)
    return row_hash, digest


def probe(balances, meta, digest, rows):
    """(2, 2): [maintained digest, from-scratch digest].  K2 on CUDA."""
    _check_tables(balances, meta, rows)
    _check_digest(balances, digest)
    if balances.device.type == "cpu":
        return probe_plain(balances, meta, digest, rows)
    out = torch.zeros((2, 2), dtype=torch.int64, device=balances.device)
    out[0] = digest
    kernels.commit_hash_all(balances, meta, rows, None, out[1], "commit_probe")
    return out


PLAIN_FNS = {
    "rebuild": rebuild_plain, "update": update_plain, "admit": admit_plain,
    "probe": probe_plain,
}


def device_fns() -> dict:
    """The reference's device_fns() names: rebuild / update / admit /
    probe."""
    return {"rebuild": rebuild, "update": update, "admit": admit, "probe": probe}
