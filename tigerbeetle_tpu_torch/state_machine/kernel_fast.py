"""The host engine's device table: a write-behind replica on the GPU.

Counterpart of ``tigerbeetle_tpu/state_machine/kernel_fast.py``
(``DeviceTable``).  With ``engine="host"`` the host resolves every
create_transfers batch (order-free batches through the mirror's
admission, the rest through the exact scan K3 against this table), and
the order-free batches' balance updates reach the device as compact
(slot, column, u128 delta) entries queued here and flushed by kernel K4
(``device_kernels.apply_deltas``): modular adds, so pending expiry's
releases ride the same lane as two's-complement deltas.  No host-device
synchronisation on the commit path.

The exact scan reads the table through ``read()``, a flush barrier, so
order-dependent batches always see current state.

Hot/cold tiering (``hot_tier.py``, TB_HOT_CAPACITY): the table on the
card then holds only the hot rows.  The mirror leads in this engine, so
a cold row needs no device delta at all; a batch's cold rows are
admitted (partially, when the hot set cannot take them all) with their
current mirror bytes uploaded by kernel K10, and ``read()`` serves the
whole logical table from the mirror.  Not ported (ROADMAP): the sharded
placement.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops.u128 import from_u64
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import hot_tier
from tigerbeetle_tpu_torch.state_machine.mirror import compact_deltas

# Entries per K4 launch (the reference's one compiled flush shape).  The
# port launches with the live count; chunking bounds one upload.
FLUSH_CHUNK = 32_768
# Queue high-water mark: flush once this many entries queue up.
FLUSH_THRESHOLD = 65_536


def flush_entries(table: torch.Tensor, slots, cols, a_lo, a_hi,
                  apply=dk.apply_deltas, hot=None) -> np.ndarray:
    """Compact queued (slot, col, delta) entries to one exact sum per
    (slot, col) and apply them in chunks of FLUSH_CHUNK (K4, or `apply`:
    its plain version in a reference run).  With a HotTier `hot` the
    entries carry logical slots: they are translated to hot slots and
    cold ones dropped (the mirror holds their effect; admission uploads
    the whole row).  Returns the table slots written."""
    chunk = (1 << 21) - 1  # compact_deltas' exactness limit
    if len(slots) > chunk:
        parts = [
            compact_deltas(slots[i : i + chunk], cols[i : i + chunk],
                           a_lo[i : i + chunk], a_hi[i : i + chunk])
            for i in range(0, len(slots), chunk)
        ]
        slots, cols, a_lo, a_hi = (np.concatenate([p[k] for p in parts]) for k in range(4))
    u_slot, u_col, d_lo, d_hi, _ = compact_deltas(slots, cols, a_lo, a_hi)
    if hot is not None:
        h = hot.hot_of[u_slot]
        keep = h >= 0
        u_slot, u_col, d_lo, d_hi = h[keep], u_col[keep], d_lo[keep], d_hi[keep]
    for at in range(0, len(u_slot), FLUSH_CHUNK):
        sl = slice(at, at + FLUSH_CHUNK)
        packed = np.stack([
            u_slot[sl].astype(np.uint64), u_col[sl].astype(np.uint64),
            d_lo[sl], d_hi[sl],
        ])
        apply(table, from_u64(packed, table.device))
    return u_slot


class DeviceTable:
    """The balance table on the device + its write-behind queue: (A, 8)
    all-resident, (hot_rows, 8) under tiering."""

    def __init__(self, capacity: int, device, mirror, plain: bool = False) -> None:
        """`mirror`: the host BalanceMirror this table shadows (the cold
        tier under tiering).  `plain=True` applies with K4's and K10's
        plain versions on `device` (the reference run the chip smoke
        test compares against)."""
        self.capacity = capacity
        self.device = device
        self.mirror = mirror
        self._apply = dk.apply_deltas_plain if plain else dk.apply_deltas
        self._set_rows = dk.tier_set_rows_plain if plain else dk.tier_set_rows
        # None = all-resident (TB_HOT_CAPACITY unset, 0 or >= capacity).
        self.hot = hot_tier.from_env(capacity)
        rows = capacity if self.hot is None else self.hot.hot_rows
        self.balances = torch.zeros((rows, 8), dtype=torch.int64, device=device)
        self._q: list[tuple] = []
        self._queued = 0
        self.stat_flushes = 0
        # Tiered: the logical table built from the mirror, keyed by its
        # mutation stamp (read() serves it; the exact scan writes it in
        # place, so write_back drops it).
        self._full_cache = None

    def grow(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        if self.hot is not None:
            # The hot-row budget is fixed: logical growth widens only the
            # maps (new rows are cold; the mirror grows on its own).
            self.hot.grow_logical(capacity)
            self.capacity = capacity
            return
        self.flush()
        self.balances = hot_tier.grow_zero_device(self.balances, capacity)
        self.capacity = capacity

    def write_back(self, value: torch.Tensor) -> None:
        """Replace the table from a full logical table image (the exact
        path's result): a handle swap all-resident; tiered, the hot rows
        gathered out of the image (the mirror stays the authority for
        cold rows)."""
        self._full_cache = None
        if self.hot is None:
            self.balances = value
            return
        self.balances = hot_tier.gather_hot(value, self.hot.logical_of)

    def enqueue(self, slots, cols, add_lo, add_hi) -> None:
        """Queue compact (slot, col, delta) modular adds.  The deltas
        come from the mirror's own methods, which already refreshed the
        commitment twin."""
        if len(slots) == 0:
            return
        if self.hot is not None:
            self._tier_enqueue(slots, cols, add_lo, add_hi)
            return
        self._push(np.asarray(slots, np.int64), np.asarray(cols, np.int64),
                   np.asarray(add_lo, np.uint64), np.asarray(add_hi, np.uint64))

    def _push(self, slots, cols, add_lo, add_hi) -> None:
        self._q.append((slots, cols, add_lo, add_hi))
        self._queued += len(slots)
        if self._queued >= FLUSH_THRESHOLD:
            self.flush()

    def _tier_enqueue(self, slots, cols, add_lo, add_hi) -> None:
        """Tiered write-behind: admit the batch's cold rows, queue only
        hot deltas.  The mirror leads (it was mutated before this call),
        so cold rows need no delta, and rows admitted now are uploaded
        with this batch's effects already in: their entries drop too."""
        hot = self.hot
        self._full_cache = None
        sl = np.asarray(slots, np.int64)
        uniq, missing = hot.plan(sl)
        admitted = np.zeros(0, np.int64)
        if len(missing):
            # Quiesce the lane before the map moves: queued deltas flush
            # under the map they were queued with, and a victim slot's
            # deltas land before the slot is reused.
            t0 = _time.perf_counter()
            self.flush()
            admitted, hot_slots, _evicted = hot.admit(missing, protect=uniq, partial=True)
            if len(admitted):
                self._set_rows(
                    self.balances, torch.from_numpy(hot_slots).to(self.device),
                    from_u64(self.mirror.rows8(admitted), self.device),
                )
            hot.note_stall(_time.perf_counter() - t0)
        hot.record_use(uniq, len(uniq) - len(missing), len(missing))
        keep = hot.hot_of[sl] >= 0
        if len(admitted):
            keep &= ~np.isin(sl, admitted)
        if not keep.any():
            return
        self._push(sl[keep], np.asarray(cols, np.int64)[keep],
                   np.asarray(add_lo, np.uint64)[keep], np.asarray(add_hi, np.uint64)[keep])

    def flush(self) -> None:
        """Apply every queued delta (asynchronously: no sync).  The queue
        is compacted across batches first, so each (slot, col) appears
        once: K4's uniqueness contract."""
        if not self._queued:
            return
        slots, cols, a_lo, a_hi = (np.concatenate([e[k] for e in self._q]) for k in range(4))
        self._q.clear()
        self._queued = 0
        self.stat_flushes += 1
        flush_entries(self.balances, slots, cols, a_lo, a_hi, self._apply, self.hot)

    def read(self) -> torch.Tensor:
        """Flush barrier + the current logical table: the device table
        all-resident; tiered, a card tensor built from the mirror (which
        leads in this engine), cached against the mirror's stamp."""
        self.flush()
        if self.hot is None:
            return self.balances
        key = self.mirror.version
        if self._full_cache is None or self._full_cache[0] != key:
            self._full_cache = (key, from_u64(self.mirror.table8(self.capacity), self.device))
        return self._full_cache[1]
