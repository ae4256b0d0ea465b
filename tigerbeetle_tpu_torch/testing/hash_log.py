"""Commit hash log: pinpoint the first divergent op between replicas.

This package's own copy of ``tigerbeetle_tpu/testing/hash_log.py``.

The reference's hash_log records a running hash of consensus-critical
values during a VOPR run so that two runs (or two replicas) that
should be identical can be diffed to the exact divergence point
instead of a failed end-state assertion (reference:
src/testing/hash_log.zig:1-5).

Each replica records, per committed op, a chained digest of
(previous digest, prepare checksum, reply bytes).  Comparing two logs
yields the first op where they differ — the op whose execution
diverged — independent of how much later state drifted.
"""

from __future__ import annotations

import hashlib


class HashLog:
    def __init__(self) -> None:
        self._digests: dict[int, bytes] = {}

    def record(self, op: int, *values: bytes) -> None:
        """Per-op digest (deliberately un-chained: logs legitimately
        have gaps — state sync skips ops, replay is not recorded — and
        chaining would turn a gap into a false divergence)."""
        h = hashlib.sha256(op.to_bytes(8, "little"))
        for v in values:
            h.update(len(v).to_bytes(4, "little"))
            h.update(v)
        self._digests[op] = h.digest()[:16]

    def digest(self, op: int) -> bytes | None:
        return self._digests.get(op)

    def prune_above(self, op: int) -> None:
        """Drop digests > op.  A crash can lose the WAL tail: ops the
        dead process committed beyond the recovered commit point were
        never durable and may be superseded after recovery, so their
        recordings are no longer vouched for."""
        for k in [k for k in self._digests if k > op]:
            del self._digests[k]

    @property
    def max_op(self) -> int:
        return max(self._digests, default=0)

    def first_divergence(self, other: "HashLog") -> int | None:
        """The lowest op both logs recorded with different digests."""
        common = sorted(set(self._digests) & set(other._digests))
        for op in common:
            if self._digests[op] != other._digests[op]:
                return op
        return None
