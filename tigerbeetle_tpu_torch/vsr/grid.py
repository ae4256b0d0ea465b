"""Grid: checksummed block store over the data file's grid zone.

This package's own copy of ``tigerbeetle_tpu/vsr/grid.py``.

reference: src/vsr/grid.zig:34-60 — fixed-size blocks addressed
1..block_count, allocated by the FreeSet, verified on every read, with
a set-associative block cache (utils/cache.py; reference:
src/lsm/set_associative_cache.zig — the policy is host-side and not
consensus-critical).

Block layout: [64B header][payload], header =
checksum u128 | address u64 | length u32 | block_type u8 | pad.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.utils.cache import SetAssociativeCache
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.free_set import FreeSet
from tigerbeetle_tpu_torch.vsr.storage import Storage

BLOCK_HEADER_SIZE = 64

BLOCK_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("address", "<u8"),
        ("length", "<u4"),
        ("block_type", "u1"),
        ("reserved", "V35"),
    ]
)
assert BLOCK_DTYPE.itemsize == BLOCK_HEADER_SIZE


class Grid:
    # Audited write-write sharing with the grid-write SerialWorker
    # (tbcheck worker-shared): _write_one (worker) and write_block /
    # _join_pending (callers) both mutate the _pending_writes
    # refcounts — every access holds _pending_lock.
    _WORKER_SHARED = frozenset({"_pending_writes"})

    def __init__(self, storage: Storage, *, block_size: int = 1 << 16,
                 block_count: int = 1 << 12, base_offset: int | None = None,
                 cache_blocks: int = 256) -> None:
        self.storage = storage
        self.block_size = block_size
        assert block_size % 4096 == 0
        self.block_count = block_count
        self.base = (
            storage.layout.grid_offset if base_offset is None else base_offset
        )
        self.free_set = FreeSet(block_count)
        # Round the operator-facing block budget up to a whole number
        # of 4-way sets (0 still means "smallest cache", not cache-off:
        # reads are checksum-verified either way).
        ways = 4
        capacity = max(ways, (cache_blocks + ways - 1) // ways * ways)
        self._cache = SetAssociativeCache(capacity=capacity, ways=ways)
        # Async block writeback: spill/compaction block writes queue to
        # one writer thread (the GIL drops during pwrite, so disk wall
        # time overlaps the merge CPU).  Reads hit the cache, which is
        # populated synchronously at write time; a cache miss on a
        # still-pending address joins the queue first.  Checkpoints
        # barrier via flush_writes() before any fsync.  Only enabled on
        # backends that declare it safe (FileStorage; the fault-
        # injecting MemoryStorage stays synchronous for determinism).
        self._writer = None
        self._pending_writes: dict[int, int] = {}  # address -> refcount
        if getattr(storage, "supports_async_writeback", False):
            import threading
            import weakref

            from tigerbeetle_tpu_torch.utils.worker import SerialWorker

            self._writer = SerialWorker("grid-write")
            self._write_futures: list = []
            self._write_error: BaseException | None = None
            self._pending_lock = threading.Lock()
            # Discarded grids (crash-recovery loops) reclaim their
            # worker thread instead of leaking it.
            weakref.finalize(self, self._writer.close)

    @property
    def payload_size(self) -> int:
        return self.block_size - BLOCK_HEADER_SIZE

    def _offset(self, address: int) -> int:
        assert 1 <= address <= self.block_count
        return self.base + (address - 1) * self.block_size

    def write_block(self, address: int, payload: bytes,
                    block_type: int = 1) -> None:
        assert len(payload) <= self.payload_size
        self._cache.put(address, payload)
        if self._writer is not None:
            # Frame construction (header + checksum + padding) and the
            # pwrite both happen on the writer thread — the checksum is
            # ~1/3 of the main-thread block cost and overlaps cleanly.
            with self._pending_lock:
                self._pending_writes[address] = (
                    self._pending_writes.get(address, 0) + 1
                )
            self._write_futures.append(
                self._writer.submit(
                    self._write_one, address, payload, block_type
                )
            )
            if len(self._write_futures) > 512:  # bound queue memory
                self.flush_writes()
            return
        self._write_one(address, payload, block_type)

    def _write_one(self, address: int, payload: bytes,
                   block_type: int) -> None:
        try:
            h = np.zeros(1, BLOCK_DTYPE)[0]
            h["address"] = address
            h["length"] = len(payload)
            h["block_type"] = block_type
            c = wire.checksum(payload)
            h["checksum_lo"] = c & 0xFFFFFFFFFFFFFFFF
            h["checksum_hi"] = c >> 64
            # Trim the physical write to the sector-rounded frame: the
            # reader takes the payload length from the header and
            # checksums only that, so stale bytes from a previous
            # tenant of this address past the frame are never
            # interpreted (write-amplification lever — a half-full
            # block costs half the disk bandwidth).
            frame = h.tobytes() + payload
            size = (len(frame) + 4095) & ~4095
            block = frame.ljust(size, b"\x00")
            self.storage.write(self._offset(address), block)
            # Kick async writeback now so the next checkpoint's full
            # sync finds these pages already clean.
            self.storage.writeback_hint(self._offset(address), size)
        finally:
            if self._writer is not None:
                with self._pending_lock:
                    n = self._pending_writes.get(address, 0) - 1
                    if n <= 0:
                        self._pending_writes.pop(address, None)
                    else:
                        self._pending_writes[address] = n

    def flush_writes(self) -> None:
        """Join every queued block write (checkpoint/read barrier).

        A write failure is STICKY: once any queued write errors, every
        later flush re-raises — a checkpoint must never advance past a
        block the disk refused (storage failure is fatal here, as in
        the reference's storage fault model)."""
        if self._writer is None:
            return
        if self._write_error is not None:
            raise self._write_error
        futures, self._write_futures = self._write_futures, []
        first_exc = None
        for f in futures:
            try:
                f.result()
            # tbcheck: allow(broad-except): join EVERY queued write
            # before raising — the first error is sticky and re-raised
            # below; skipping the rest would leak unjoined futures.
            except BaseException as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            self._write_error = first_exc
            raise first_exc

    def _join_pending(self, address: int) -> None:
        """Barrier for ONE address: flush_writes alone is not enough
        when another thread (the async-checkpoint finalize) already
        swapped the futures list — its batch may still be mid-write.
        The pending refcount is decremented only after the pwrite, so
        spin on it (the writer thread is making progress)."""
        import time

        self.flush_writes()
        while address in self._pending_writes:
            time.sleep(0.0002)
            self.flush_writes()

    def read_block(self, address: int) -> bytes:
        cached = self._cache.get(address)
        if cached is not None:
            return cached
        if self._writer is not None and address in self._pending_writes:
            self._join_pending(address)
        raw = self.storage.read(self._offset(address), self.block_size)
        h = np.frombuffer(raw[:BLOCK_HEADER_SIZE], BLOCK_DTYPE)[0]
        length = int(h["length"])
        if int(h["address"]) != address or length > self.payload_size:
            raise RuntimeError(f"grid block {address} corrupt header")
        payload = raw[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + length]
        want = int(h["checksum_lo"]) | (int(h["checksum_hi"]) << 64)
        if wire.checksum(payload) != want:
            raise RuntimeError(f"grid block {address} corrupt payload")
        self._cache.put(address, payload)
        return payload

    def verify_block(self, address: int) -> bool:
        """Scrubber probe: is the on-disk block intact?  Reads the disk
        directly and leaves the cache alone — steady-state scrubbing
        must not churn hot entries (reference:
        src/vsr/grid_scrubber.zig)."""
        if self._writer is not None and address in self._pending_writes:
            self._join_pending(address)
        raw = self.storage.read(self._offset(address), self.block_size)
        return block_frame_valid(raw, address, self.payload_size)



def block_frame_valid(frame: bytes, address: int, payload_size: int) -> bool:
    """Self-consistency of a raw block frame (header address, length
    bound, payload checksum) — shared by the scrubber probe and the
    peer-repair serve/install paths, without touching any cache."""
    h = np.frombuffer(frame[:BLOCK_HEADER_SIZE], BLOCK_DTYPE)[0]
    length = int(h["length"])
    if int(h["address"]) != address or length > payload_size:
        return False
    payload = frame[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + length]
    want = int(h["checksum_lo"]) | (int(h["checksum_hi"]) << 64)
    return wire.checksum(payload) == want
