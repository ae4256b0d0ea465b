"""Vectorized open-addressing hash index: u128 key -> u64 value.

This package's own copy of ``tigerbeetle_tpu/utils/hashindex.py``
(numpy only, unchanged semantics).

The host-side id directories (account id -> slot, transfer id -> row;
the reference's IdTree role, src/lsm/groove.zig:136-176) sit on the
commit hot path with 3 batch lookups + 1 batch insert per commit.
Sorted-run searches over 16-byte void keys are memcmp-bound; this
table keeps keys as native uint64 limb pairs and does linear probing
with whole-batch numpy steps — each probe round is a handful of SIMD
ops over the still-unresolved lanes, and rounds shrink geometrically
(load factor is capped at ~0.5).

Deletions (create_accounts chain rollback only) leave tombstones:
lookups probe through them, inserts do not reuse them (rare enough
that reclaiming happens on the next growth rehash).
"""

from __future__ import annotations

import numpy as np

_M1 = np.uint64(0x9E3779B97F4A7C15)
_M2 = np.uint64(0xC2B2AE3D27D4EB4F)
_M3 = np.uint64(0xFF51AFD7ED558CCD)


class HashIndex:
    def __init__(self, capacity: int = 1 << 16) -> None:
        assert capacity & (capacity - 1) == 0
        self._cap = capacity
        self._mask = np.uint64(capacity - 1)
        self.k_lo = np.zeros(capacity, np.uint64)
        self.k_hi = np.zeros(capacity, np.uint64)
        self.val = np.zeros(capacity, np.uint64)
        self.used = np.zeros(capacity, bool)
        self.dead = np.zeros(capacity, bool)
        self.count = 0
        self._tombstones = 0

    def _hash(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        h = lo * _M1 + hi * _M2
        h ^= h >> np.uint64(33)
        h *= _M3
        h ^= h >> np.uint64(29)
        return h & self._mask

    def _grow(self, need: int) -> None:
        # Grow 4x: rehash work is the dominant insert cost, and quadrupling
        # keeps total rehash work ~1.33N instead of ~2N.
        while (self.count + self._tombstones + need) * 2 >= self._cap:
            self._cap *= 4
        live = np.flatnonzero(self.used & ~self.dead)
        k_lo, k_hi, val = self.k_lo[live], self.k_hi[live], self.val[live]
        self._mask = np.uint64(self._cap - 1)
        self.k_lo = np.zeros(self._cap, np.uint64)
        self.k_hi = np.zeros(self._cap, np.uint64)
        self.val = np.zeros(self._cap, np.uint64)
        self.used = np.zeros(self._cap, bool)
        self.dead = np.zeros(self._cap, bool)
        self.count = 0
        self._tombstones = 0
        self.insert(k_lo, k_hi, val)

    def insert(self, lo: np.ndarray, hi: np.ndarray, values: np.ndarray) -> None:
        """Batch insert; keys must be unique and not already present."""
        n = len(lo)
        if n == 0:
            return
        if (self.count + self._tombstones + n) * 2 >= self._cap:
            self._grow(n)
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        values = np.asarray(values, np.uint64)
        pos = self._hash(lo, hi)
        pending = np.arange(n)
        one = np.uint64(1)
        while len(pending):
            p = pos[pending]
            occ = self.used[p]
            free = pending[~occ]
            if len(free):
                # Scatter all candidates; colliding writes resolve
                # last-writer-wins, and a read-back identifies the one
                # winner per bucket (keys are unique) — no sort needed.
                fp = pos[free]
                self.used[fp] = True
                self.k_lo[fp] = lo[free]
                self.k_hi[fp] = hi[free]
                self.val[fp] = values[free]
                placed = (self.k_lo[fp] == lo[free]) & (self.k_hi[fp] == hi[free])
                losers = free[~placed]
            else:
                losers = free
            stepped = np.concatenate([pending[occ], losers])
            pos[stepped] = (pos[stepped] + one) & self._mask
            pending = stepped
        self.count += n

    def lookup(self, lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batch get -> (found bool array, values uint64)."""
        n = len(lo)
        found = np.zeros(n, bool)
        values = np.zeros(n, np.uint64)
        if n == 0 or self.count == 0:
            return found, values
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        pos = self._hash(lo, hi)
        active = np.arange(n)
        one = np.uint64(1)
        while len(active):
            p = pos[active]
            occ = self.used[p]
            match = (
                occ
                & ~self.dead[p]
                & (self.k_lo[p] == lo[active])
                & (self.k_hi[p] == hi[active])
            )
            hit = active[match]
            found[hit] = True
            values[hit] = self.val[p[match]]
            cont = occ & ~match
            active = active[cont]
            pos[active] = (pos[active] + one) & self._mask
        return found, values

    def remove(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Tombstone existing keys (chain-rollback un-create)."""
        n = len(lo)
        if n == 0:
            return
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        pos = self._hash(lo, hi)
        active = np.arange(n)
        one = np.uint64(1)
        removed = 0
        while len(active):
            p = pos[active]
            occ = self.used[p]
            match = (
                occ
                & ~self.dead[p]
                & (self.k_lo[p] == lo[active])
                & (self.k_hi[p] == hi[active])
            )
            mp = p[match]
            self.dead[mp] = True
            removed += len(mp)
            cont = occ & ~match
            active = active[cont]
            pos[active] = (pos[active] + one) & self._mask
        self.count -= removed
        self._tombstones += removed


class RunIndex:
    """Id directory with run-length compression over sequential ids.

    TigerBeetle recommends (and its benchmark default generates)
    sequential ids (reference: src/tigerbeetle/cli.zig:80-101
    `id_order=sequential`; docs/coding/data-modeling.md time-based ids).
    Rows in the columnar stores are assigned in insert order, so a batch
    of contiguous ids maps to a contiguous row range — representable as
    one (start_id, len, start_val) run instead of 8190 hash entries.

    Same contract as HashIndex (insert keys unique & absent; remove keys
    present). Non-contiguous batches fall back to the hash; lookups
    consult both. Runs are grouped by the high limb (virtually always a
    single group, id_hi == 0 or a fixed template prefix) and kept sorted
    by start for a vectorized searchsorted probe.
    """

    def __init__(self, capacity: int = 1 << 16) -> None:
        self._hash = HashIndex(capacity)
        # hi (int) -> [starts u64 sorted, lens u64, vals u64]
        self._runs: dict[int, list[np.ndarray]] = {}
        self._run_count = 0

    @property
    def count(self) -> int:
        return self._hash.count + self._run_count

    def _try_run(self, lo, hi, values) -> bool:
        n = len(lo)
        if n < 2 or hi[0] != hi[-1] or (hi != hi[0]).any():
            return False
        # lo[-1] >= lo[0] rejects uint64 wraparound, which the modular
        # diff check alone would mistake for contiguity.
        if lo[-1] < lo[0] or values[-1] < values[0]:
            return False
        one = np.uint64(1)
        if ((lo[1:] - lo[:-1]) != one).any():
            return False
        if ((values[1:] - values[:-1]) != one).any():
            return False
        h = int(hi[0])
        start, val = lo[0], values[0]
        g = self._runs.get(h)
        if g is None:
            self._runs[h] = [
                np.array([start], np.uint64),
                np.array([n], np.uint64),
                np.array([val], np.uint64),
            ]
            self._run_count += n
            return True
        starts, lens, vals = g
        i = int(np.searchsorted(starts, start))
        # Merge with predecessor when ids AND rows are both contiguous.
        if (
            i > 0
            and starts[i - 1] + lens[i - 1] == start
            and vals[i - 1] + lens[i - 1] == val
        ):
            lens[i - 1] += np.uint64(n)
            # May now abut the successor too.
            if (
                i < len(starts)
                and starts[i - 1] + lens[i - 1] == starts[i]
                and vals[i - 1] + lens[i - 1] == vals[i]
            ):
                lens[i - 1] += lens[i]
                g[0] = np.delete(starts, i)
                g[1] = np.delete(lens, i)
                g[2] = np.delete(vals, i)
        elif (
            i < len(starts)
            and start + np.uint64(n) == starts[i]
            and val + np.uint64(n) == vals[i]
        ):
            starts[i] = start
            lens[i] += np.uint64(n)
            vals[i] = val
        else:
            g[0] = np.insert(starts, i, start)
            g[1] = np.insert(lens, i, np.uint64(n))
            g[2] = np.insert(vals, i, val)
        self._run_count += n
        return True

    def insert(self, lo: np.ndarray, hi: np.ndarray, values: np.ndarray) -> None:
        if len(lo) == 0:
            return
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        values = np.asarray(values, np.uint64)
        if not self._try_run(lo, hi, values):
            self._hash.insert(lo, hi, values)

    def lookup(self, lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        found, values = self._hash.lookup(lo, hi)
        if not self._runs:
            return found, values
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        for h, (starts, lens, vals) in self._runs.items():
            if not len(starts):
                continue
            lane = ~found & (hi == np.uint64(h))
            if not lane.any():
                continue
            ls = lo[lane]
            idx = np.searchsorted(starts, ls, side="right") - 1
            ic = np.maximum(idx, 0)
            hit = (idx >= 0) & (ls - starts[ic] < lens[ic])
            if not hit.any():
                continue
            li = np.flatnonzero(lane)[hit]
            off = lo[li] - starts[ic[hit]]
            found[li] = True
            values[li] = vals[ic[hit]] + off
        return found, values

    def remove(self, lo: np.ndarray, hi: np.ndarray) -> None:
        n = len(lo)
        if n == 0:
            return
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        in_hash, _ = self._hash.lookup(lo, hi)
        if in_hash.any():
            self._hash.remove(lo[in_hash], hi[in_hash])
        # Run splitting: rare (create_accounts chain rollback only).
        for k in np.flatnonzero(~in_hash):
            g = self._runs.get(int(hi[k]))
            assert g is not None, "remove of absent key"
            starts, lens, vals = g
            i = int(np.searchsorted(starts, lo[k], side="right")) - 1
            off = lo[k] - starts[i]
            assert 0 <= off < lens[i], "remove of absent key"
            tail = lens[i] - off - np.uint64(1)
            if off == 0 and tail == 0:
                if len(starts) == 1:
                    del self._runs[int(hi[k])]
                else:
                    g[0] = np.delete(starts, i)
                    g[1] = np.delete(lens, i)
                    g[2] = np.delete(vals, i)
            elif off == 0:
                starts[i] += np.uint64(1)
                vals[i] += np.uint64(1)
                lens[i] = tail
            elif tail == 0:
                lens[i] = off
            else:
                new_val = vals[i] + off + np.uint64(1)
                lens[i] = off
                g[0] = np.insert(starts, i + 1, lo[k] + np.uint64(1))
                g[1] = np.insert(lens, i + 1, tail)
                g[2] = np.insert(vals, i + 1, new_val)
            self._run_count -= 1
