"""LSM spill tier for TorchStateMachine's transfer + history state.

This package's own copy of ``tigerbeetle_tpu/state_machine/spill.py``.

The commit hot path appends to RAM columnar stores (gpu.py `Columns`) —
the memtable of this design.  At checkpoint, rows that can no longer
change (everything except live pendings, which post/void/expiry still
mutate) spill into LSM grooves on the grid, so durable state scales
past host RAM while the hot path never touches the LSM
(reference: src/lsm/groove.zig:136-176 — grooves feed the state
machine; src/state_machine.zig:178-324).

Key scheme (vs the reference's IdTree/ObjectTree pair,
src/lsm/groove.zig):
- object tree: key = GLOBAL ROW NUMBER (commit order).  Rows are
  assigned monotonically and timestamps rise with rows, so row order ==
  timestamp order.  The id -> row map stays in the RAM run-compressed
  id directories (utils/hashindex.py RunIndex + the native IdDir) —
  sequential-id workloads compress to O(1) ranges; the object tree
  rebuilds them after restore.
- dr/cr index trees: key = (account slot, timestamp), value = row —
  timestamp-ordered range scans per account for get_account_transfers
  (reference: src/state_machine.zig:931-996).
- history tree: key = transfer timestamp (unique), value = packed
  dr/cr balance snapshots for get_account_balances.

Spilled objects are immutable; `gather` serves reads for exists-ladder
joins, lookup_transfers, and query materialization.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.lsm.runs import pack_u128

# Spilled transfer object layout (little-endian), 144 bytes:
#   0..128  wire Transfer image (types.py TRANSFER_DTYPE, incl.
#           timestamp at 120)
# 128..132  dr_slot  i32
# 132..136  cr_slot  i32
# 136..137  status   u8 (TransferPendingStatus; final by spill time)
# 137..144  pad
TRANSFER_OBJECT_SIZE = 144

# Spilled history object layout, 160 bytes total:
#   0..16   dr account id (lo, hi)
#  16..32   cr account id (lo, hi)
#  32..96   dr balances (dp, dpo, cp, cpo as u128 lo/hi pairs, 64B)
#  96..160  cr balances (same packing, 64B)
HISTORY_OBJECT_SIZE = 160

# Store-column -> byte offset within the 128B wire image.
_WIRE_FIELDS = (
    ("id_lo", 0, np.uint64), ("id_hi", 8, np.uint64),
    # debit/credit account ids are not store columns (slots are); they
    # are written from the attrs table at spill time.
    ("amount_lo", 48, np.uint64), ("amount_hi", 56, np.uint64),
    ("pending_lo", 64, np.uint64), ("pending_hi", 72, np.uint64),
    ("ud128_lo", 80, np.uint64), ("ud128_hi", 88, np.uint64),
    ("ud64", 96, np.uint64), ("ud32", 104, np.uint32),
    ("timeout", 108, np.uint32),
    ("ledger", 112, np.uint32), ("code", 116, np.uint16),
    ("flags", 118, np.uint16), ("timestamp", 120, np.uint64),
)


def _row_keys(rows: np.ndarray) -> np.ndarray:
    return pack_u128(
        np.asarray(rows, np.uint64), np.zeros(len(rows), np.uint64)
    )


class TransferSpill:
    """Spilled (immutable) transfer rows in a groove; `base` rows
    [0, base) live here, the store's RAM tail holds [base, count)."""

    def __init__(self, groove, attrs_fn=None) -> None:
        self.groove = groove
        self.base = 0
        # Account attrs accessor for id reconstruction at gather:
        # dr/cr ACCOUNT IDS are derivable from the stored slots (slots
        # are append-only and an account's id is immutable), so the
        # spilled image zeroes those 32 bytes — the sparse block codec
        # then writes nothing for them (a write-amplification lever).
        # Falls back to storing the ids when no accessor is
        # wired (standalone groove tests).
        self._attrs_fn = attrs_fn

    # -- write (checkpoint path) ---------------------------------------

    def spill(self, rows: np.ndarray, cols: dict, attrs) -> None:
        """Append objects for global rows (ascending, == arange from
        self.base) built from store columns + account attrs."""
        n = len(rows)
        if n == 0:
            return
        assert int(rows[0]) == self.base and int(rows[-1]) == self.base + n - 1
        obj = np.zeros((n, TRANSFER_OBJECT_SIZE), np.uint8)
        for name, off, dt in _WIRE_FIELDS:
            width = np.dtype(dt).itemsize
            obj[:, off : off + width] = (
                np.ascontiguousarray(cols[name].astype(dt, copy=False))
                .view(np.uint8)
                .reshape(n, width)
            )
        dr = cols["dr_slot"].astype(np.int64)
        cr = cols["cr_slot"].astype(np.int64)
        if self._attrs_fn is None:
            obj[:, 16:24] = attrs["id_lo"][dr].view(np.uint8).reshape(n, 8)
            obj[:, 24:32] = attrs["id_hi"][dr].view(np.uint8).reshape(n, 8)
            obj[:, 32:40] = attrs["id_lo"][cr].view(np.uint8).reshape(n, 8)
            obj[:, 40:48] = attrs["id_hi"][cr].view(np.uint8).reshape(n, 8)
        # else: bytes 16..48 stay zero on disk; gather() reconstructs
        # them from the slots + account attrs.
        obj[:, 128:132] = (
            cols["dr_slot"].astype(np.int32).view(np.uint8).reshape(n, 4)
        )
        obj[:, 132:136] = (
            cols["cr_slot"].astype(np.int32).view(np.uint8).reshape(n, 4)
        )
        obj[:, 136] = cols["status"].astype(np.uint8)

        ts = cols["timestamp"].astype(np.uint64)
        self.groove.object_tree.put_batch(_row_keys(rows), obj)
        rows_v = np.asarray(rows, np.uint64).astype("<u8").view("V8")
        # Pre-sort index entries by (slot, ts): a stable u64 argsort on
        # the slot (ts ascends within the batch already) hands
        # put_batch strictly-increasing V16 keys, skipping its far
        # slower void-dtype argsort on the ingest hot path.
        do = np.argsort(dr, kind="stable")
        self.groove.indexes["dr_slot"].put_batch(
            pack_u128(ts[do], dr[do].astype(np.uint64)), rows_v[do]
        )
        co = np.argsort(cr, kind="stable")
        self.groove.indexes["cr_slot"].put_batch(
            pack_u128(ts[co], cr[co].astype(np.uint64)), rows_v[co]
        )
        # Seal overflowing memtables NOW: paced spill beats must turn
        # into bounded level-0 runs per beat, not one giant run at the
        # checkpoint (which would re-create the latency cliff the
        # beats exist to remove).
        self.groove.maybe_seal()
        self.base += n

    # -- read ----------------------------------------------------------

    def _lookup_raw(self, rows: np.ndarray) -> np.ndarray:
        """Raw on-disk objects (ids NOT reconstructed) for rows < base."""
        found, vals = self.groove.object_tree.lookup_batch(_row_keys(rows))
        assert found.all(), "spilled row missing from object tree"
        return np.ascontiguousarray(vals)

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Global rows (< base) -> (n, TRANSFER_OBJECT_SIZE) u8."""
        vals = self._lookup_raw(rows)
        if self._attrs_fn is not None:
            vals = self._reconstruct_ids(vals)
        return vals

    def _reconstruct_ids(self, obj: np.ndarray) -> np.ndarray:
        n = len(obj)
        attrs = self._attrs_fn()
        dr = np.ascontiguousarray(obj[:, 128:132]).view(np.int32).reshape(n)
        cr = np.ascontiguousarray(obj[:, 132:136]).view(np.int32).reshape(n)
        dr = dr.astype(np.int64)
        cr = cr.astype(np.int64)
        obj[:, 16:24] = attrs["id_lo"][dr].view(np.uint8).reshape(n, 8)
        obj[:, 24:32] = attrs["id_hi"][dr].view(np.uint8).reshape(n, 8)
        obj[:, 32:40] = attrs["id_lo"][cr].view(np.uint8).reshape(n, 8)
        obj[:, 40:48] = attrs["id_hi"][cr].view(np.uint8).reshape(n, 8)
        return obj

    def update_status(self, rows: np.ndarray, statuses: np.ndarray) -> None:
        """Finalize spilled pendings: rewrite their objects with the
        new status (LSM overwrite; newest version wins on read).  The
        only mutable byte of a spilled object — everything else is
        immutable after spill."""
        obj = self._lookup_raw(rows)
        obj[:, 136] = np.asarray(statuses, np.uint8)
        self.groove.object_tree.put_batch(_row_keys(rows), obj)


    def iter_objects(self, batch: int = 8192):
        """Yield (rows, objects) over all spilled rows ascending —
        restore uses this to rebuild the RAM id directories, which
        read only the transfer id (bytes 0..16), so the account-id
        reconstruction is skipped (it would be pure per-row waste on
        every crash recovery / state sync)."""
        at = 0
        while at < self.base:
            n = min(batch, self.base - at)
            rows = np.arange(at, at + n, dtype=np.int64)
            yield rows, self._lookup_raw(rows)
            at += n


def unpack_objects(obj: np.ndarray) -> dict:
    """(n, 144) u8 -> store-column dict (the inverse of spill)."""
    n = len(obj)
    out = {}
    for name, off, dt in _WIRE_FIELDS:
        width = np.dtype(dt).itemsize
        out[name] = (
            np.ascontiguousarray(obj[:, off : off + width])
            .view(dt)
            .reshape(n)
        )
    out["dr_slot"] = (
        np.ascontiguousarray(obj[:, 128:132]).view(np.int32).reshape(n)
    )
    out["cr_slot"] = (
        np.ascontiguousarray(obj[:, 132:136]).view(np.int32).reshape(n)
    )
    out["status"] = obj[:, 136].copy()
    out["dr_id_lo"] = np.ascontiguousarray(obj[:, 16:24]).view(np.uint64).reshape(n)
    out["dr_id_hi"] = np.ascontiguousarray(obj[:, 24:32]).view(np.uint64).reshape(n)
    out["cr_id_lo"] = np.ascontiguousarray(obj[:, 32:40]).view(np.uint64).reshape(n)
    out["cr_id_hi"] = np.ascontiguousarray(obj[:, 40:48]).view(np.uint64).reshape(n)
    return out


class HistorySpill:
    """Spilled historical-balance rows keyed by transfer timestamp."""

    def __init__(self, groove) -> None:
        self.groove = groove
        self.base = 0  # history rows [0, base) spilled

    def spill(self, cols: dict) -> None:
        n = len(cols["timestamp"])
        if n == 0:
            return
        obj = np.zeros((n, HISTORY_OBJECT_SIZE), np.uint8)
        obj[:, 0:8] = cols["dr_id_lo"].view(np.uint8).reshape(n, 8)
        obj[:, 8:16] = cols["dr_id_hi"].view(np.uint8).reshape(n, 8)
        obj[:, 16:24] = cols["cr_id_lo"].view(np.uint8).reshape(n, 8)
        obj[:, 24:32] = cols["cr_id_hi"].view(np.uint8).reshape(n, 8)
        obj[:, 32:96] = (
            np.ascontiguousarray(cols["dr_bal"]).view(np.uint8).reshape(n, 64)
        )
        obj[:, 96:160] = (
            np.ascontiguousarray(cols["cr_bal"]).view(np.uint8).reshape(n, 64)
        )
        ts = cols["timestamp"].astype(np.uint64)
        self.groove.object_tree.put_batch(
            pack_u128(ts, np.zeros(n, np.uint64)), obj
        )
        self.base += n

    def gather_by_ts(self, ts: np.ndarray) -> tuple[np.ndarray, dict]:
        found, obj = self.groove.object_tree.lookup_batch(
            pack_u128(np.asarray(ts, np.uint64), np.zeros(len(ts), np.uint64))
        )
        n = len(obj)
        return found, {
            "dr_id_lo": np.ascontiguousarray(obj[:, 0:8]).view(np.uint64).reshape(n),
            "dr_id_hi": np.ascontiguousarray(obj[:, 8:16]).view(np.uint64).reshape(n),
            "dr_bal": np.ascontiguousarray(obj[:, 32:96]).view(np.uint64).reshape(n, 8),
            "cr_bal": np.ascontiguousarray(obj[:, 96:160]).view(np.uint64).reshape(n, 8),
        }
