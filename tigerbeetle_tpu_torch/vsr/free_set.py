"""FreeSet: deterministic grid-block allocator.

This package's own copy of ``tigerbeetle_tpu/vsr/free_set.py``.

reference: src/vsr/free_set.zig:16-45 — the reserve -> acquire ->
forfeit protocol makes allocation deterministic even when multiple
logical workers (compactions) allocate concurrently: each worker
reserves a contiguous window up front, acquires from its own window,
and forfeits the remainder in a fixed order.  EWAH-compressed at
checkpoint (reference: :27-41).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tigerbeetle_tpu_torch.lsm import ewah


@dataclasses.dataclass
class Reservation:
    blocks: np.ndarray  # window of block indices, fixed at reserve time
    acquired: int = 0

    @property
    def size(self) -> int:
        return len(self.blocks)


class FreeSet:
    def __init__(self, block_count: int) -> None:
        self.block_count = block_count
        self.free = np.ones(block_count, bool)
        # Blocks released this checkpoint stay unavailable until the
        # checkpoint durably commits (reference: staging set).
        self.staging = np.zeros(block_count, bool)
        # Released-this-checkpoint blocks that became free at the
        # FREEZE but whose flip is not yet the durable recovery root
        # (async checkpoints): the PREVIOUS superblock's manifest may
        # still reference them, so reuse is quarantined until
        # release_quarantine() after the flip lands.  Empty whenever
        # checkpoints are synchronous (freeze and flip are adjacent).
        self.quarantine = np.zeros(block_count, bool)
        # Blocks inside outstanding reservations (not yet acquired).
        self._reserved_mask = np.zeros(block_count, bool)
        self._reservations = 0

    def count_free(self) -> int:
        return int(self.free.sum())

    # -- reserve/acquire/forfeit (reference: src/vsr/free_set.zig) --

    def reserve(self, blocks_needed: int) -> Reservation:
        """Reserve a window of exactly `blocks_needed` free blocks —
        the window is fixed now, so concurrent reservations allocate
        deterministically regardless of acquire interleaving.
        Quarantined blocks (freed by a checkpoint whose flip is still
        in flight) are excluded: the previous superblock — the durable
        recovery root until the flip lands — may reference them."""
        candidates = np.flatnonzero(
            self.free & ~self._reserved_mask & ~self.quarantine
        )
        assert blocks_needed <= len(candidates), "grid full"
        window = candidates[:blocks_needed].copy()
        self._reserved_mask[window] = True
        self._reservations += 1
        return Reservation(blocks=window)

    def acquire(self, reservation: Reservation) -> int:
        """-> block address (1-based, 0 is the null address)."""
        assert reservation.acquired < reservation.size, "reservation exhausted"
        block = int(reservation.blocks[reservation.acquired])
        reservation.acquired += 1
        self.free[block] = False
        self._reserved_mask[block] = False
        return block + 1

    def forfeit(self, reservation: Reservation) -> None:
        remainder = reservation.blocks[reservation.acquired :]
        self._reserved_mask[remainder] = False
        self._reservations -= 1

    def is_free(self, address: int) -> bool:
        return bool(self.free[address - 1])

    def release(self, address: int) -> None:
        """Stage a block for release at the next checkpoint."""
        assert not self.free[address - 1]
        self.staging[address - 1] = True

    def leaving_live_set(self, addresses):
        """Free OR staged-for-release, vectorized over addresses: such
        blocks' frames may legitimately go stale and peers that
        already checkpointed no longer serve them — the shared
        predicate behind the scrubber's skip and the repair filter."""
        import numpy as np

        idx = np.asarray(addresses, np.int64) - 1
        return self.free[idx] | self.staging[idx]

    def checkpoint(self) -> None:
        """Freeze point: staged releases become free (the checkpoint
        blob encodes them free — it is only ever read once its flip is
        durable) but quarantined from REUSE until the NEXT freeze.
        The next-freeze boundary (rather than "when the flip lands")
        keeps allocation a pure function of the commit stream: flip
        wall time varies per replica, and the replica's checkpoint
        join guarantees freeze N+1 runs after flip N is durable, so
        the quarantine always covers the vulnerable window."""
        assert self._reservations == 0, "checkpoint with open reservations"
        # Replacing the mask IS the release of the previous freeze's
        # quarantine.
        self.quarantine = self.staging.copy()
        self.free |= self.staging
        self.staging[:] = False

    def release_quarantine(self) -> None:
        """Explicit early release — for harnesses that know no older
        superblock can reference the blocks (standalone forests,
        fuzzers modeling a landed flip).  The replica itself never
        calls this: reuse timing must not depend on flip wall time."""
        self.quarantine[:] = False

    def count_reservable(self) -> int:
        return int((self.free & ~self.quarantine).sum())

    # -- persistence --

    def encode(self) -> bytes:
        bits = np.packbits(self.free.view(np.uint8), bitorder="little")
        words = np.zeros((self.block_count + 63) // 64, np.uint64)
        words.view(np.uint8)[: len(bits)] = bits
        return ewah.encode(words)

    @classmethod
    def decode(cls, data: bytes, block_count: int) -> "FreeSet":
        fs = cls(block_count)
        words = ewah.decode(data, (block_count + 63) // 64)
        bits = np.unpackbits(
            words.view(np.uint8), count=block_count, bitorder="little"
        )
        fs.free = bits.astype(bool)
        return fs
