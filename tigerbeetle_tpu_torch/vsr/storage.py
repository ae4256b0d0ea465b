"""Storage: zoned, sector-aligned data-file I/O.

This package's own copy of ``tigerbeetle_tpu/vsr/storage.py``.

Re-designs the reference's storage stack (reference: src/storage.zig:
14-110 sector I/O; src/vsr/superblock.zig + journal.zig zone layout)
as one flat zone map over a single data file:

    [superblock x4][wal headers][wal prepares][client replies][grid]

Two interchangeable backends:
- `FileStorage`: a real file (pwrite/pread + fdatasync).  The C++
  runtime's io layer slots in underneath without changing callers.
- `MemoryStorage`: in-memory with seeded fault injection — the
  VOPR-style fake (reference: src/testing/storage.zig:1-25), used by
  the deterministic cluster tests.

All reads/writes are whole-sector (4096) multiples at sector-aligned
offsets, matching the reference's Direct-I/O discipline so the layout
is torn-write-aware by construction.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tigerbeetle_tpu_torch.constants import Config, HEADER_SIZE, SECTOR_SIZE


def _sectors(n: int) -> int:
    """Round up to a sector multiple."""
    return (n + SECTOR_SIZE - 1) // SECTOR_SIZE * SECTOR_SIZE


SUPERBLOCK_COPIES = 4  # reference: src/vsr/superblock.zig (4-copy quorum)
SUPERBLOCK_COPY_SIZE = SECTOR_SIZE  # one sector per copy: atomic-ish write


@dataclasses.dataclass(frozen=True)
class ZoneLayout:
    """Byte offsets of every zone, derived from the cluster config."""

    config: Config
    grid_size: int

    @property
    def superblock_offset(self) -> int:
        return 0

    @property
    def superblock_size(self) -> int:
        return SUPERBLOCK_COPIES * SUPERBLOCK_COPY_SIZE

    @property
    def wal_headers_offset(self) -> int:
        return self.superblock_offset + self.superblock_size

    @property
    def wal_headers_size(self) -> int:
        return _sectors(self.config.journal_slot_count * HEADER_SIZE)

    @property
    def wal_prepares_offset(self) -> int:
        return self.wal_headers_offset + self.wal_headers_size

    @property
    def wal_prepares_size(self) -> int:
        return self.config.journal_slot_count * _sectors(self.config.message_size_max)

    @property
    def client_replies_offset(self) -> int:
        return self.wal_prepares_offset + self.wal_prepares_size

    @property
    def client_replies_size(self) -> int:
        return self.config.clients_max * _sectors(self.config.message_size_max)

    @property
    def grid_offset(self) -> int:
        return self.client_replies_offset + self.client_replies_size

    @property
    def total_size(self) -> int:
        return self.grid_offset + self.grid_size

    def prepare_slot_offset(self, slot: int) -> int:
        assert 0 <= slot < self.config.journal_slot_count
        return self.wal_prepares_offset + slot * _sectors(self.config.message_size_max)

    def header_slot_offset(self, slot: int) -> int:
        """Sector-aligned offset of the header-ring sector holding `slot`."""
        return self.wal_headers_offset + slot * HEADER_SIZE

    def reply_slot_offset(self, slot: int) -> int:
        assert 0 <= slot < self.config.clients_max
        return self.client_replies_offset + slot * _sectors(self.config.message_size_max)


class FsyncCrash(RuntimeError):
    """Seeded fault point: the process dies INSIDE an fsync — the sync
    never completes, so nothing it would have covered may be acked
    (MemoryStorage.crash_at_fsync; the VOPR group-commit contract
    tests drive this)."""


class Storage:
    """Backend interface: aligned read/write/sync."""

    layout: ZoneLayout
    # Actual durability syscalls issued (one per fdatasync; the group
    # -commit and async-checkpoint benches grade against this).
    stat_fsyncs = 0
    # True when write_prepare(sync=False) + a later covering
    # sync_wal() is crash-equivalent to per-op syncs (FileStorage).
    # The fault-injecting MemoryStorage keeps it False so seeded
    # crash tests stay deterministic; tests opt in per-instance.
    supports_deferred_sync = False

    def read(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def write(self, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def writeback_hint(self, offset: int, size: int) -> None:
        """START async writeback of a range without waiting (grid
        block writes: the next checkpoint's full sync then finds most
        pages already clean instead of stalling on an interval's worth
        of dirty data).  Purely advisory — default no-op."""

    def sync_wal(self) -> None:
        """Durably flush the control/WAL zones only (ack path).
        Backends without zone isolation flush everything."""
        self.sync()

    def close(self) -> None:
        pass

    def _check(self, offset: int, size: int) -> None:
        # The grid zone (last) may grow past the formatted size as
        # checkpoint snapshots grow; fixed zones are bounds-checked by
        # their own offset arithmetic.
        assert offset % SECTOR_SIZE == 0, offset
        assert size % SECTOR_SIZE == 0, size
        assert offset >= 0


# Linux sync_file_range(2) via libc (no Python binding exists).
_SFR_WAIT_BEFORE, _SFR_WRITE, _SFR_WAIT_AFTER = 1, 2, 4
_sync_file_range = None
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None, use_errno=True)
    _raw_sfr = _libc.sync_file_range
    _raw_sfr.restype = _ctypes.c_int
    _raw_sfr.argtypes = [
        _ctypes.c_int, _ctypes.c_long, _ctypes.c_long, _ctypes.c_uint,
    ]
    _sync_file_range = _raw_sfr
except (OSError, AttributeError):
    _sync_file_range = None


class FileStorage(Storage):
    """Two files: `path` holds the control zones (superblock, WAL
    rings, client replies) and `path`.grid holds the grid zone.  The
    commit path's per-op fdatasync then flushes ONLY the WAL file —
    LSM spill/compaction writeback in the grid file never rides the
    ack latency (the isolation the reference gets from O_DIRECT; a
    fdatasync on a shared inode would flush everything).  sync()
    flushes both (checkpoint ordering barrier)."""

    supports_async_writeback = True  # grid writer thread (vsr/grid.py)
    supports_deferred_sync = True    # WAL group commit (vsr/journal.py)

    def __init__(self, path: str, layout: ZoneLayout, create: bool = False) -> None:
        self.layout = layout
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        try:
            self._fd_grid = os.open(path + ".grid", flags, 0o644)
        except FileNotFoundError:
            os.close(self._fd)
            raise RuntimeError(
                f"{path}.grid is missing: the data file's grid zone "
                "lives in a sibling .grid file (keep them together; "
                "re-run `format` to create a fresh pair)"
            ) from None
        if create:
            os.ftruncate(self._fd, layout.grid_offset)
        self._grid_off = layout.grid_offset
        self._grid_dirty = False
        self._wal_dirty = False
        # Dirty extent of the grid file since the last paced walk:
        # sync_grid_paced must scale with bytes WRITTEN, not file size
        # (a 32 GB mostly-clean grid must not cost 2k chunk-sleeps per
        # checkpoint).  Plain attributes: a racing write during the
        # walk at worst rides the next walk — durability always comes
        # from the fdatasync that follows.
        self._grid_ext_lo = None
        self._grid_ext_hi = 0
        # Write-amplification accounting (bench durable config reports
        # bytes/event; reference analog: devhub's datafile-size metric,
        # src/scripts/devhub.zig:36-41).  WAL counts only the journal
        # rings; superblock/client-reply traffic is "control" —
        # lumping checkpoint control writes into WAL framing would
        # misdirect the exact investigation this counter serves.
        self.stat_bytes_wal = 0
        self.stat_bytes_grid = 0
        self.stat_bytes_control = 0
        self.stat_fsyncs = 0
        self._wal_lo = layout.wal_headers_offset
        self._wal_hi = layout.wal_prepares_offset + layout.wal_prepares_size

    def _at(self, offset: int) -> tuple[int, int]:
        if offset >= self._grid_off:
            return self._fd_grid, offset - self._grid_off
        return self._fd, offset

    def read(self, offset: int, size: int) -> bytes:
        self._check(offset, size)
        fd, off = self._at(offset)
        data = os.pread(fd, size, off)
        if len(data) < size:  # reading past EOF in the grid zone
            data = data.ljust(size, b"\x00")
        return data

    def write(self, offset: int, data: bytes) -> None:
        self._check(offset, len(data))
        fd, off = self._at(offset)
        written = os.pwrite(fd, data, off)
        assert written == len(data)
        if fd == self._fd_grid:
            self._grid_dirty = True
            self.stat_bytes_grid += written
            if self._grid_ext_lo is None or off < self._grid_ext_lo:
                self._grid_ext_lo = off
            if off + written > self._grid_ext_hi:
                self._grid_ext_hi = off + written
        else:
            self._wal_dirty = True
            if self._wal_lo <= offset < self._wal_hi:
                self.stat_bytes_wal += written
            else:
                self.stat_bytes_control += written

    def sync(self) -> None:
        # Clear-then-sync ordering: a concurrent write landing after
        # the clear re-marks the file dirty, so the NEXT sync covers
        # it even if this fdatasync raced past it (sync_wal runs on
        # the replica's WAL worker thread).  On failure the flag is
        # restored — an error must not launder unsynced data as clean.
        if self._wal_dirty:
            self._wal_dirty = False
            try:
                self.stat_fsyncs += 1
                os.fdatasync(self._fd)
            except OSError:
                self._wal_dirty = True
                raise
        if self._grid_dirty:
            self._grid_dirty = False
            try:
                self.stat_fsyncs += 1
                os.fdatasync(self._fd_grid)
            except OSError:
                self._grid_dirty = True
                raise

    def sync_wal(self) -> None:
        """Flush the control/WAL file only (per-op ack durability)."""
        self._wal_dirty = False
        try:
            self.stat_fsyncs += 1
            os.fdatasync(self._fd)
        except OSError:
            self._wal_dirty = True
            raise

    def writeback_hint(self, offset: int, size: int) -> None:
        if _sync_file_range is not None:
            fd, off = self._at(offset)
            _sync_file_range(fd, off, size, _SFR_WRITE)

    def sync_grid_paced(self, chunk: int = 16 << 20,
                        pause_s: float = 0.001) -> None:
        """Push the grid file's dirty EXTENT to the device in bounded
        chunks with yields in between, so a concurrent WAL fdatasync
        (the ack path's per-op/per-drain sync) never queues behind one
        monolithic grid flush — the async-checkpoint finalize calls
        this BEFORE its covering storage.sync(), which is then left
        with little more than metadata.  Only the range written since
        the last walk is paced (cost scales with dirty bytes, not
        file size).  Purely a pacing optimization: sync_file_range
        does NOT flush the drive cache, so durability still comes
        from the fdatasync that follows.  No-op where sync_file_range
        is unavailable or nothing was written."""
        lo, hi = self._grid_ext_lo, self._grid_ext_hi
        self._grid_ext_lo, self._grid_ext_hi = None, 0
        if _sync_file_range is None or lo is None or hi <= lo:
            return
        import time as _time

        flags = _SFR_WAIT_BEFORE | _SFR_WRITE | _SFR_WAIT_AFTER
        for off in range(lo, hi, chunk):
            _sync_file_range(
                self._fd_grid, off, min(chunk, hi - off), flags
            )
            _time.sleep(pause_s)

    def close(self) -> None:
        os.close(self._fd)
        os.close(self._fd_grid)


class MemoryStorage(Storage):
    """Seeded fault-injecting in-memory backend.

    Faults (reference: src/testing/storage.zig:58-95):
    - `crash()` drops writes that were never `sync()`ed (with
      per-sector probability `p_lose_unsynced`), modeling torn writes
      and lost buffers on power failure.
    - `corrupt_sector(offset)` flips bytes to model latent sector
      errors.
    """

    _PAGE = 1 << 16

    def __init__(self, layout: ZoneLayout, seed: int = 0,
                 p_lose_unsynced: float = 1.0) -> None:
        self.layout = layout
        # Page-sparse images: only written pages materialize, so large
        # reserved regions (snapshot spans, the forest block zone) cost
        # nothing — mirroring a sparse file on a real filesystem.
        self._pages: dict[int, bytearray] = {}      # current contents
        self._spages: dict[int, bytearray] = {}     # last-synced contents
        self._dirty: set[int] = set()  # dirty sector indices
        self._rng = np.random.default_rng(seed)
        self._p_lose = p_lose_unsynced
        self.reads = 0
        self.writes = 0
        self.stat_fsyncs = 0
        # Fault point: the Nth sync() from now RAISES FsyncCrash
        # without persisting anything — the crash-at-fsync model the
        # group-commit contract seeds drive (None = disabled).
        self.crash_at_fsync: int | None = None

    def _read_range(self, pages: dict, offset: int, size: int) -> bytes:
        out = bytearray(size)
        at = 0
        while at < size:
            pi, po = divmod(offset + at, self._PAGE)
            n = min(self._PAGE - po, size - at)
            page = pages.get(pi)
            if page is not None:
                out[at : at + n] = page[po : po + n]
            at += n
        return bytes(out)

    def _write_range(self, pages: dict, offset: int, data) -> None:
        at = 0
        size = len(data)
        while at < size:
            pi, po = divmod(offset + at, self._PAGE)
            n = min(self._PAGE - po, size - at)
            page = pages.get(pi)
            if page is None:
                page = pages.setdefault(pi, bytearray(self._PAGE))
            page[po : po + n] = data[at : at + n]
            at += n

    def read(self, offset: int, size: int) -> bytes:
        self._check(offset, size)
        self.reads += 1
        return self._read_range(self._pages, offset, size)

    def write(self, offset: int, data: bytes) -> None:
        self._check(offset, len(data))
        self.writes += 1
        self._write_range(self._pages, offset, data)
        for s in range(offset // SECTOR_SIZE, (offset + len(data)) // SECTOR_SIZE):
            self._dirty.add(s)

    def sync(self) -> None:
        if self.crash_at_fsync is not None:
            self.crash_at_fsync -= 1
            if self.crash_at_fsync <= 0:
                self.crash_at_fsync = None
                # The sync never completed: nothing moves to the
                # synced image, and the caller must treat the process
                # as dead (crash() then models the power loss).
                raise FsyncCrash("seeded crash inside fsync")
        self.stat_fsyncs += 1
        for s in self._dirty:
            off = s * SECTOR_SIZE
            self._write_range(
                self._spages, off, self._read_range(self._pages, off, SECTOR_SIZE)
            )
        self._dirty.clear()

    def crash(self) -> None:
        """Simulate power loss: unsynced sectors independently either
        reach disk or revert to their last synced contents."""
        for s in self._dirty:
            off = s * SECTOR_SIZE
            if self._rng.random() < self._p_lose:
                self._write_range(
                    self._pages, off,
                    self._read_range(self._spages, off, SECTOR_SIZE),
                )
            else:
                self._write_range(
                    self._spages, off,
                    self._read_range(self._pages, off, SECTOR_SIZE),
                )
        self._dirty.clear()

    def corrupt_sector(self, offset: int) -> None:
        off = offset // SECTOR_SIZE * SECTOR_SIZE
        noise = self._rng.integers(0, 256, SECTOR_SIZE, np.uint8).tobytes()
        self._write_range(self._pages, off, noise)
        self._write_range(self._spages, off, noise)
