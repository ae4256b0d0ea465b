"""AOF: append-only file of committed prepares.

This package's own copy of ``tigerbeetle_tpu/vsr/aof.py``.

reference: src/aof.zig — an optional sequential log of every committed
prepare (header + body), written at commit time before the state
machine executes (reference: src/vsr/replica.zig:4136-4141).  Used for
external audit/replay pipelines AND as the tail stream
read-only followers replay: entries are self-framing (the header
carries the size) and checksum-verified on read.

Tailing semantics (AofTail)
---------------------------
The writer appends each record with ONE os.write, so a crashed writer
leaves a *prefix* of its last record — never interior garbage of its
own making.  That gives the reader a clean decision rule at a record
that fails verification at absolute offset `at`:

- the bad record extends to end-of-file  -> TORN: a crash (or a still
  -in-flight append racing the reader) cut the record short.  The
  reader parks at `at` (the resume offset) and retries when the file
  grows — a completed append heals it in place.
- bytes exist BEYOND the bad record      -> CORRUPT: the writer only
  appends after complete records, so a bad record followed by more
  data is bit rot / a torn-then-appended-over tail, not a crash
  artifact.  The reader stops permanently and flags it; a follower
  must refuse to advance (refuse-not-lie), never skip ahead.

Reads are chunked (`chunk_bytes`), never one whole-file read — the AOF
of a long-lived primary outgrows memory.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.vsr import wire

# Upper bound on one framed record (header + body).  The header's size
# field is checksum-protected, so this only guards against reading a
# pathological frame into memory when the CHECKSUM itself is what the
# caller is about to discover is broken.
RECORD_SIZE_MAX = HEADER_SIZE + (1 << 24)


class _FileSource:
    """Byte source over a real file: the production tail target.  The
    file may not exist yet (follower started before the primary's
    first append) — treated as size 0."""

    def __init__(self, path: str) -> None:
        self.path = path

    def size(self) -> int:
        try:
            return os.stat(self.path).st_size
        except OSError:
            return 0

    def read_at(self, offset: int, n: int) -> bytes:
        try:
            with open(self.path, "rb") as f:
                f.seek(offset)
                return f.read(n)
        except OSError:
            return b""


class BytesSource:
    """Byte source over a caller-owned mutable buffer — the simulator
    /test seam (testing/cluster.py SimAof): torn tails are modeled by
    truncating the buffer, corruption by flipping bytes in place."""

    def __init__(self, buffer: bytearray) -> None:
        self.buffer = buffer

    def size(self) -> int:
        return len(self.buffer)

    def read_at(self, offset: int, n: int) -> bytes:
        return bytes(self.buffer[offset : offset + n])


class AofTail:
    """Offset-resumable, memory-bounded AOF reader.

    `poll()` returns every newly verified (header, body) entry since
    the last call and advances `offset` past them; a torn trailing
    record leaves `offset` AT the record (the resume point) and sets
    `torn` until the writer completes it; interior corruption sets
    `corrupt` permanently (`offset` parks at the first bad byte).
    Construction with a saved `offset` resumes an earlier tail — the
    caller owns checkpointing it.
    """

    def __init__(self, path_or_source, *, offset: int = 0,
                 chunk_bytes: int = 1 << 20) -> None:
        if isinstance(path_or_source, str):
            self.source = _FileSource(path_or_source)
        else:
            self.source = path_or_source
        assert chunk_bytes >= HEADER_SIZE, chunk_bytes
        self.offset = int(offset)
        self.chunk_bytes = int(chunk_bytes)
        self.torn = False
        self.corrupt = False
        self.corrupt_reason: str | None = None
        # Chunk cache, persisted ACROSS poll() calls: a driver that
        # consumes a few records per poll (the follower server bounds
        # its replay burst) must not re-read the same chunk from disk
        # every call — memory stays bounded by one chunk + one record.
        self._buf = b""
        self._buf_at = 0

    def _fail(self, reason: str) -> None:
        self.corrupt = True
        self.corrupt_reason = reason

    def poll(self, limit: int | None = None) -> list[tuple[np.ndarray, bytes]]:
        """Verified entries appended since the last poll (up to
        `limit`).  Never raises on bad bytes — see the class
        docstring for the torn/corrupt contract."""
        if self.corrupt:
            return []
        out: list[tuple[np.ndarray, bytes]] = []
        size = self.source.size()
        self.torn = False
        if size < self.offset:
            # The file shrank below our resume point: the writer
            # crashed and its repair truncated a torn tail we had
            # already read past.  Recovery gap-fill re-appends the
            # SAME committed records byte-for-byte (prepare headers
            # and bodies are deterministic), so the resume offset
            # becomes a valid record boundary again once the writer
            # catches up — wait, exactly like a torn tail.  The cached
            # chunk may hold pre-truncation bytes: drop it.
            self._buf = b""
            self.torn = True
            return out
        buf = self._buf
        buf_at = self._buf_at  # absolute offset of buf[0]
        while limit is None or len(out) < limit:
            at = self.offset
            avail = size - at
            if avail < HEADER_SIZE:
                self.torn = avail > 0
                break
            # Refill the chunk buffer so the header (and, usually, the
            # whole record) is in memory exactly once.
            rel = at - buf_at
            if rel < 0 or rel + HEADER_SIZE > len(buf):
                buf = self.source.read_at(
                    at, min(self.chunk_bytes, avail)
                )
                buf_at = at
                rel = 0
                if len(buf) < HEADER_SIZE:
                    self.torn = True  # raced a concurrent truncate
                    break
            header = wire.header_from_bytes(
                buf[rel : rel + HEADER_SIZE]
            )
            if not wire.verify_header(header):
                # Full header bytes present but invalid: torn only if
                # nothing follows this (partial) record — a complete
                # header always precedes any later append.
                if at + HEADER_SIZE >= size:
                    self.torn = True
                else:
                    self._fail(f"bad header at offset {at}")
                break
            rec_size = int(header["size"])
            if rec_size < HEADER_SIZE or rec_size > RECORD_SIZE_MAX:
                self._fail(f"implausible record size {rec_size} at {at}")
                break
            if avail < rec_size:
                self.torn = True
                break
            if rel + rec_size > len(buf):
                # Record crosses the chunk boundary: refill from `at`
                # (one record is bounded by RECORD_SIZE_MAX).
                buf = self.source.read_at(at, max(rec_size, min(
                    self.chunk_bytes, avail
                )))
                buf_at = at
                rel = 0
                if len(buf) < rec_size:
                    self.torn = True
                    break
            body = buf[rel + HEADER_SIZE : rel + rec_size]
            if not wire.verify_header(header, body):
                if at + rec_size >= size:
                    self.torn = True
                else:
                    self._fail(f"bad body checksum at offset {at}")
                break
            out.append((header, body))
            self.offset = at + rec_size
        self._buf = buf
        self._buf_at = buf_at
        return out


class AOF:
    """Append-only writer.  `repair=True` (the default for reopened
    files) scans the existing file on open, truncates a torn trailing
    record, and records `last_op` — the highest prepare op already on
    disk — so recovery replay (vsr/replica.py) can re-append exactly
    the committed ops a crash erased from the unsynced tail, keeping
    the op stream gap-free for followers."""

    def __init__(self, path: str, *, repair: bool = True) -> None:
        self.path = path
        self.last_op = 0
        if repair and os.path.exists(path):
            self._repair()
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    def _repair(self) -> None:
        tail = AofTail(self.path)
        while True:
            entries = tail.poll(limit=4096)
            if not entries:
                break
            for header, _body in entries:
                if int(header["command"]) == int(wire.Command.prepare):
                    self.last_op = max(self.last_op, int(header["op"]))
        size = os.stat(self.path).st_size
        if tail.offset < size:
            # Torn (or corrupt) tail from a previous incarnation:
            # truncate to the verified prefix so the next append
            # starts a clean record — appending after garbage would
            # permanently corrupt the stream for every tailer.
            fd = os.open(self.path, os.O_WRONLY)
            try:
                os.ftruncate(fd, tail.offset)
            finally:
                os.close(fd)

    def write(self, header: np.ndarray, body: bytes) -> None:
        # Hash-once invariant: the append reuses the
        # committed prepare's already-stamped header verbatim — no
        # body hash here, ever.  Tailers re-verify on read (AofTail),
        # which is where rehashing belongs.
        os.write(self._fd, header.tobytes() + body)
        if int(header["command"]) == int(wire.Command.prepare):
            self.last_op = max(self.last_op, int(header["op"]))

    def sync(self) -> None:
        os.fdatasync(self._fd)

    def close(self) -> None:
        os.close(self._fd)


def iterate(path: str) -> Iterator[tuple[np.ndarray, bytes]]:
    """Yield verified (header, body) entries; stops at the first torn
    or corrupt entry (a crash mid-append truncates the log there).
    Chunked via AofTail — never loads the whole file."""
    tail = AofTail(path)
    while True:
        entries = tail.poll(limit=4096)
        if not entries:
            return
        yield from entries


def replay(path: str, state_machine, *, cluster: int | None = None) -> int:
    """Re-execute an AOF through a fresh state machine; returns the
    number of ops applied (deterministic replay — same guarantee as
    WAL recovery)."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.vsr.wire import Command

    applied = 0
    last_op = 0
    for header, body in iterate(path):
        if int(header["command"]) != Command.prepare:
            continue
        if cluster is not None and wire.u128(header, "cluster") != cluster:
            continue
        # A crash-recovered writer's protocol catch-up re-appends ops
        # whose earlier records the repair scan kept (the AOF is
        # gap-free, not duplicate-free) — replay them once.
        if int(header["op"]) <= last_op:
            continue
        last_op = int(header["op"])
        operation = int(header["operation"])
        if operation < types.Operation.pulse:
            continue  # VSR-internal ops (register, ...)
        timestamp = int(header["timestamp"])
        state_machine.prepare_timestamp = timestamp
        sm_op = types.Operation(operation)
        # Logically-batched prepare (vsr/multi.py): context carries
        # the sub count, the body ends in a demux trailer — commit the
        # event bytes, like the replica commit path does.
        n_subs = wire.u128(header, "context")
        if n_subs:
            from tigerbeetle_tpu_torch.state_machine import demuxer

            if demuxer.batch_logical_allowed(sm_op):
                body, _subs = demuxer.decode_trailer(body, n_subs)
        state_machine.prefetch(sm_op, body, prefetch_timestamp=timestamp)
        state_machine.commit(
            0, int(header["op"]), timestamp, sm_op, body
        )
        applied += 1
    return applied
