"""Scan expressions over groove secondary indexes.

This package's own copy of ``tigerbeetle_tpu/lsm/scan_builder.py``.

The reference's query engine composes per-index range scans into
condition trees — union (OR) via k-way merge, intersection (AND) via
zig-zag merge — then materializes matching objects in timestamp order
with an optional direction and limit (reference: src/lsm/
scan_builder.zig:1-40 condition trees, scan_merge.zig merge_union/
merge_intersection, scan_lookup.zig object materialization,
src/direction.zig).

Host-idiomatic re-design: scans produce sorted uint64 timestamp sets
(the index trees key on (field_value, timestamp), so a prefix range
scan is exactly "timestamps where field == value"); union/intersection
are vectorized set merges instead of iterator trees.  `ScanLookup`
gathers the objects for the final timestamp set from the object tree
in one batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

U64_MAX = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Scan:
    """A node in a condition tree.  Build with ScanBuilder."""

    kind: str  # "eq" | "union" | "intersect"
    field: str | None = None
    value: int = 0
    children: tuple["Scan", ...] = ()


class ScanBuilder:
    """Builds and evaluates condition trees over one groove
    (reference: src/lsm/scan_builder.zig — scans_max/merge nodes are
    bounded there; here the tree is evaluated recursively with
    whole-set vector merges)."""

    def __init__(self, groove) -> None:
        self.groove = groove

    # -- construction --------------------------------------------------

    def eq(self, field: str, value: int) -> Scan:
        assert field in self.groove.indexes, field
        return Scan("eq", field=field, value=value)

    def union(self, *scans: Scan) -> Scan:
        assert scans
        return scans[0] if len(scans) == 1 else Scan("union", children=scans)

    def intersect(self, *scans: Scan) -> Scan:
        assert scans
        return (
            scans[0] if len(scans) == 1 else Scan("intersect", children=scans)
        )

    # -- evaluation ----------------------------------------------------

    def evaluate(
        self,
        scan: Scan,
        *,
        ts_min: int = 0,
        ts_max: int = U64_MAX,
        reversed: bool = False,
        limit: int | None = None,
        return_values: bool = False,
    ) -> np.ndarray:
        """-> matching timestamps in scan direction, limited.  With
        return_values, the index entries' 8-byte payloads instead (the
        spill grooves' row pointers — monotone with timestamp, so the
        set algebra is identical)."""
        ts = self._eval(scan, ts_min, ts_max, return_values)
        if reversed:
            ts = ts[::-1]
        if limit is not None:
            ts = ts[:limit]
        return np.ascontiguousarray(ts)

    def _eval(
        self, scan: Scan, ts_min: int, ts_max: int, return_values: bool
    ) -> np.ndarray:
        if scan.kind == "eq":
            return self.groove.index_scan(
                scan.field, scan.value, ts_min=ts_min, ts_max=ts_max,
                return_values=return_values,
            )
        parts = [
            self._eval(c, ts_min, ts_max, return_values)
            for c in scan.children
        ]
        if scan.kind == "union":
            out = parts[0]
            for p in parts[1:]:
                out = np.union1d(out, p)
            return out
        if scan.kind == "intersect":
            return self.groove.index_intersect(parts)
        raise AssertionError(scan.kind)  # pragma: no cover


class ScanLookup:
    """Materialize scan results as objects (reference:
    src/lsm/scan_lookup.zig — buffers rows for the state machine's
    reply)."""

    def __init__(self, groove) -> None:
        self.groove = groove

    def fetch(self, timestamps: np.ndarray) -> np.ndarray:
        """-> (n, object_size) uint8 rows, in `timestamps` order.
        Scanned timestamps always resolve (indexes only reference live
        objects after compaction drops tombstoned pairs)."""
        if len(timestamps) == 0:
            return np.zeros((0, self.groove.object_size), np.uint8)
        found, rows = self.groove.get_objects(timestamps)
        assert found.all(), "index referenced a missing object"
        return rows
