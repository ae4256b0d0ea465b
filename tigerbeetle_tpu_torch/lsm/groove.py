"""Groove: the tree bundle for one object type.

This package's own copy of ``tigerbeetle_tpu/lsm/groove.py``.

reference: src/lsm/groove.zig:136-176 — IdTree (id -> timestamp),
ObjectTree (timestamp -> object), and one secondary index tree per
indexed field, keyed (field_value, timestamp) so a prefix range scan
yields the timestamps of matching objects in time order.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.lsm.runs import KEY_DTYPE, pack_u128
from tigerbeetle_tpu_torch.lsm.tree import Tree, zig_zag_intersect
from tigerbeetle_tpu_torch.vsr.grid import Grid


def _ts_keys(timestamps: np.ndarray) -> np.ndarray:
    return pack_u128(
        np.asarray(timestamps, np.uint64),
        np.zeros(len(timestamps), np.uint64),
    )


class Groove:
    def __init__(self, grid: Grid, name: str, *, object_size: int,
                 index_fields: list[str], memtable_max: int = 8192,
                 index_value_size: int = 1) -> None:
        self.name = name
        self.object_size = object_size
        self.id_tree = Tree(
            grid, f"{name}.id", value_size=8, memtable_max=memtable_max
        )
        # Objects are mostly-zero wire images (reserved user_data,
        # zeroed reconstructible fields, high u128 limbs): sparse-value
        # blocks halve the dominant seal/merge write volume.
        self.object_tree = Tree(
            grid, f"{name}.object", value_size=object_size,
            memtable_max=memtable_max, sparse_values=object_size % 8 == 0,
        )
        # index_value_size=8 stores a row/object pointer per index entry
        # (the state machine's spill tier scans indexes straight to
        # object-tree keys); the default 1-byte value is presence-only.
        self.indexes = {
            field: Tree(
                grid, f"{name}.{field}", value_size=index_value_size,
                memtable_max=memtable_max,
            )
            for field in index_fields
        }

    # ------------------------------------------------------------------

    def insert_batch(self, id_lo, id_hi, timestamps, objects: np.ndarray,
                     index_values: dict[str, np.ndarray]) -> None:
        """`objects`: (n, object_size) uint8; `index_values`: field ->
        uint64 array (the indexed field per object)."""
        n = len(timestamps)
        ts = np.asarray(timestamps, np.uint64)
        self.id_tree.put_batch(
            pack_u128(np.asarray(id_lo, np.uint64), np.asarray(id_hi, np.uint64)),
            ts.astype("<u8").view("V8"),
        )
        self.object_tree.put_batch(_ts_keys(ts), objects)
        for field, values in index_values.items():
            keys = pack_u128(ts, np.asarray(values, np.uint64))
            tree = self.indexes[field]
            # Entry payload sized to the tree (presence-only by
            # default; 8-byte row pointers for the spill tier).
            tree.put_batch(keys, np.zeros((n, tree.value_size), np.uint8))
        self.maybe_seal()

    def remove_index_batch(self, field: str, values, timestamps) -> None:
        keys = pack_u128(
            np.asarray(timestamps, np.uint64), np.asarray(values, np.uint64)
        )
        self.indexes[field].remove_batch(keys)

    def lookup_ids(self, id_lo, id_hi) -> tuple[np.ndarray, np.ndarray]:
        """ids -> (found, timestamps)."""
        keys = pack_u128(
            np.asarray(id_lo, np.uint64), np.asarray(id_hi, np.uint64)
        )
        found, values = self.id_tree.lookup_batch(keys)
        return found, values.view("<u8").reshape(-1)

    def get_objects(self, timestamps) -> tuple[np.ndarray, np.ndarray]:
        found, values = self.object_tree.lookup_batch(
            _ts_keys(np.asarray(timestamps, np.uint64))
        )
        return found, values

    def index_scan(self, field: str, value: int, *, ts_min: int = 0,
                   ts_max: int = (1 << 64) - 1,
                   return_values: bool = False) -> np.ndarray:
        """-> matching timestamps, ascending — or, with return_values,
        the index entries' 8-byte payloads (e.g. the spill grooves'
        row pointers, which ascend with timestamp) in the same order."""
        lo = pack_u128(
            np.array([ts_min], np.uint64), np.array([value], np.uint64)
        ).tobytes()
        hi = pack_u128(
            np.array([ts_max], np.uint64), np.array([value], np.uint64)
        ).tobytes()
        keys, vals = self.indexes[field].scan_range(lo, hi)
        if return_values:
            return vals.view("<u8").reshape(-1).astype(np.uint64)
        # Key layout is (hi=value, lo=timestamp) big-endian packed:
        # the low 8 bytes are the big-endian timestamp.
        raw = keys.tobytes()
        ts = np.frombuffer(raw, ">u8").reshape(-1, 2)[:, 1]
        return ts.astype(np.uint64)

    def index_intersect(self, scans: list[np.ndarray]) -> np.ndarray:
        """Zig-zag AND of several index_scan timestamp sets."""
        out = scans[0]
        for s in scans[1:]:
            out = np.intersect1d(out, s)
        return out

    def maybe_seal(self) -> None:
        self.id_tree.maybe_seal()
        self.object_tree.maybe_seal()
        for tree in self.indexes.values():
            tree.maybe_seal()

    # Run/block persistence lives in the forest's manifest log
    # (lsm/manifest_log.py); memtables ride the checkpoint blob via
    # Tree.memtable_manifest/restore_memtable.
