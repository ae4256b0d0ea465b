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
order-dependent batches always see current state.  Not ported
(ROADMAP): hot/cold tiering and the sharded placement.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops.u128 import from_u64
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine.mirror import compact_deltas

# Entries per K4 launch (the reference's one compiled flush shape).  The
# port launches with the live count; chunking bounds one upload.
FLUSH_CHUNK = 32_768
# Queue high-water mark: flush once this many entries queue up.
FLUSH_THRESHOLD = 65_536


def flush_entries(table: torch.Tensor, slots, cols, a_lo, a_hi,
                  apply=dk.apply_deltas) -> np.ndarray:
    """Compact queued (slot, col, delta) entries to one exact sum per
    (slot, col) and apply them in chunks of FLUSH_CHUNK (K4, or `apply`:
    its plain version in a reference run).  Returns the slots written."""
    chunk = (1 << 21) - 1  # compact_deltas' exactness limit
    if len(slots) > chunk:
        parts = [
            compact_deltas(slots[i : i + chunk], cols[i : i + chunk],
                           a_lo[i : i + chunk], a_hi[i : i + chunk])
            for i in range(0, len(slots), chunk)
        ]
        slots, cols, a_lo, a_hi = (np.concatenate([p[k] for p in parts]) for k in range(4))
    u_slot, u_col, d_lo, d_hi, _ = compact_deltas(slots, cols, a_lo, a_hi)
    for at in range(0, len(u_slot), FLUSH_CHUNK):
        sl = slice(at, at + FLUSH_CHUNK)
        packed = np.stack([
            u_slot[sl].astype(np.uint64), u_col[sl].astype(np.uint64),
            d_lo[sl], d_hi[sl],
        ])
        apply(table, from_u64(packed, table.device))
    return u_slot


class DeviceTable:
    """The (A, 8) balance table on the device + its write-behind queue."""

    def __init__(self, capacity: int, device, plain: bool = False) -> None:
        """`plain=True` applies with K4's plain version on `device` (the
        reference run the chip smoke test compares against)."""
        self.capacity = capacity
        self.device = device
        self._apply = dk.apply_deltas_plain if plain else dk.apply_deltas
        self.balances = torch.zeros((capacity, 8), dtype=torch.int64, device=device)
        self._q: list[tuple] = []
        self._queued = 0
        self.stat_flushes = 0

    def grow(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        self.flush()
        self.balances = torch.cat(
            [self.balances, self.balances.new_zeros((capacity - self.capacity, 8))]
        )
        self.capacity = capacity

    def write_back(self, value: torch.Tensor) -> None:
        """Replace the table (the exact path's result): a handle swap."""
        self.balances = value

    def enqueue(self, slots, cols, add_lo, add_hi) -> None:
        """Queue compact (slot, col, delta) modular adds.  The deltas
        come from the mirror's own methods, which already refreshed the
        commitment twin."""
        if len(slots) == 0:
            return
        self._q.append((
            np.asarray(slots, np.int64), np.asarray(cols, np.int64),
            np.asarray(add_lo, np.uint64), np.asarray(add_hi, np.uint64),
        ))
        self._queued += len(slots)
        if self._queued >= FLUSH_THRESHOLD:
            self.flush()

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
        flush_entries(self.balances, slots, cols, a_lo, a_hi, self._apply)

    def read(self) -> torch.Tensor:
        """Flush barrier + the current table."""
        self.flush()
        return self.balances
