"""Grid scrubber: background read-verify of allocated grid blocks.

This package's own copy of ``tigerbeetle_tpu/vsr/scrubber.py``.

reference: src/vsr/grid_scrubber.zig — cycles ("tours") through every
allocated block proactively so latent sector errors are found (and
repaired from peers) before the data is needed.  Design carried over
from the reference's tour machinery:

- A tour SNAPSHOTS the allocated set once per cycle and walks that
  snapshot to completion; blocks allocated mid-cycle are picked up by
  the next tour (a moving target would skip or double-scrub blocks as
  the free set churns — the old per-tick re-listing did exactly that,
  and cost O(grid) work per tick).
- Blocks freed after the snapshot are skipped at probe time: a
  released block's frame legitimately goes stale the moment the free
  set forfeits it (reference: grid_scrubber cancels reads for freed
  blocks at checkpoint).
- Pacing targets a TOUR DURATION rather than a fixed per-tick count:
  each tick probes just enough blocks to finish the snapshot within
  ``cycle_ticks``, bounded by ``blocks_per_tick_max`` so a huge grid
  never turns one tick into an I/O storm (reference:
  grid_scrubber.zig cycle pacing against constants.grid_scrubber_*).
- Stats (`blocks_verified`, `faults_found`, `cycles`, `progress`)
  feed the replica's StatsD/tracer surfacing.

Corrupt addresses route into the replica's block-repair machinery
(`request_blocks`/`block`, vsr/multi.py) one block at a time.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.vsr.grid import Grid


class GridScrubber:
    def __init__(self, grid: Grid, *, cycle_ticks: int = 1024,
                 blocks_per_tick_max: int = 32) -> None:
        self.grid = grid
        self.cycle_ticks = max(1, cycle_ticks)
        self.blocks_per_tick_max = max(1, blocks_per_tick_max)
        # Current tour: a stable snapshot of allocated addresses and a
        # cursor into it; ticks remaining drive the pacing.
        self._tour: np.ndarray = np.zeros(0, np.int64)
        self._cursor = 0
        self._ticks_left = 0
        # Known-corrupt addresses (a set: a block that stays corrupt
        # across tours is ONE fault, reported once until repaired).
        self.corrupt: set[int] = set()
        self.cycles = 0
        self.blocks_verified = 0
        self.faults_found = 0

    @property
    def progress(self) -> float:
        """Fraction of the current tour completed (0..1)."""
        if len(self._tour) == 0:
            return 1.0
        return self._cursor / len(self._tour)

    # Empty-grid snapshot retry cadence: bounded O(grid) rescans while
    # still picking up the first allocations promptly.
    EMPTY_RETRY_TICKS = 16

    def _begin_tour(self) -> None:
        self._tour = np.flatnonzero(~self.grid.free_set.free) + 1
        self._cursor = 0
        self._ticks_left = (
            self.cycle_ticks
            if len(self._tour)
            else min(self.EMPTY_RETRY_TICKS, self.cycle_ticks)
        )

    def repaired(self, address: int) -> None:
        """Forget a healed block so a relapse counts as a new fault."""
        self.corrupt.discard(address)

    def tick(self) -> list[int]:
        """Verify the next paced chunk of the tour; returns newly-found
        corrupt addresses."""
        if self._cursor >= len(self._tour):
            if len(self._tour):
                self.cycles += 1
            elif self._ticks_left > 1:
                # Empty grid: retry the snapshot on the tour cadence,
                # not every tick (the snapshot scan is O(grid)).
                self._ticks_left -= 1
                return []
            self._begin_tour()
            if len(self._tour) == 0:
                return []
        remaining = len(self._tour) - self._cursor
        quota = -(-remaining // max(1, self._ticks_left))  # ceil
        quota = min(quota, self.blocks_per_tick_max, remaining)
        self._ticks_left = max(1, self._ticks_left - 1)
        found: list[int] = []
        chunk = self._tour[self._cursor : self._cursor + quota]
        # Blocks leaving the live set since the snapshot are skipped
        # rather than flagged (their frames may legitimately go stale,
        # and peers that checkpointed no longer serve them — the same
        # predicate the repair filter uses).  Indexed per chunk, not a
        # full-grid mask.
        dead = self.grid.free_set.leaving_live_set(chunk)
        for address, is_dead in zip(chunk, dead):
            if is_dead:
                continue
            address = int(address)
            self.blocks_verified += 1
            if not self.grid.verify_block(address) and (
                address not in self.corrupt
            ):
                found.append(address)
        self._cursor += quota
        self.faults_found += len(found)
        self.corrupt.update(found)
        return found
