"""Journal: the write-ahead log, two on-disk rings.

This package's own copy of ``tigerbeetle_tpu/vsr/journal.py``.

Keeps the reference's core design (reference: src/vsr/journal.zig:
17-67): a prepares ring (full messages, slot = op % slot_count) plus a
redundant headers ring (256-byte headers, 16 per sector).  The
redundant ring is what makes torn prepare writes detectable: a prepare
whose own header is corrupt but whose redundant header is intact was
torn mid-write (and vice versa).

Recovery decision table per slot (simplification of the reference's
case matrix, same outcomes):

    prepare   redundant   =>
    valid     matching    ok
    valid     missing     ok (torn header write; header repaired)
    valid     different   the ring wrapped mid-update: trust the
                          higher op (both checksums are valid)
    torn      valid       faulty (data loss unless head: see below)
    torn      torn        unwritten (fresh slot)

After slot scan, the hash chain (prepare.parent == previous prepare's
checksum) is walked from the checkpoint op; the head is the last chain
-connected op.  A faulty slot above the checkpoint either truncates
the head (if nothing valid follows it) or is reported for repair
(multi-replica) / fatal (single replica).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tigerbeetle_tpu_torch.constants import HEADER_SIZE, SECTOR_SIZE
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.storage import Storage, _sectors
from tigerbeetle_tpu_torch.vsr.wire import Command, HEADER_DTYPE

HEADERS_PER_SECTOR = SECTOR_SIZE // HEADER_SIZE


@dataclasses.dataclass
class Recovery:
    op_head: int                 # highest chain-connected op
    headers: dict[int, np.ndarray]   # op -> prepare header (valid ops only)
    faulty_ops: list[int]        # ops lost to torn/corrupt slots (below head)
    truncated_ops: list[int]     # ops discarded as uncommitted head


class Journal:
    def __init__(self, storage: Storage, cluster: int) -> None:
        self.storage = storage
        self.layout = storage.layout
        self.config = storage.layout.config
        self.cluster = cluster
        self.slot_count = self.config.journal_slot_count
        # In-memory redundant header ring (mirrors the disk ring).
        self.headers = np.zeros(self.slot_count, HEADER_DTYPE)
        # Deferred-sync bookkeeping (group commit): WAL writes issued
        # with sync=False since the last covering sync_batch().
        self.unsynced_writes = 0
        from tigerbeetle_tpu_torch.obs import anatomy as anatomy_mod
        from tigerbeetle_tpu_torch.utils import tracer as tracer_mod

        self.tracer = tracer_mod.NULL
        # Per-request anatomy (obs/anatomy.py): the journal_write
        # stage timestamp is taken HERE, next to the WAL append, so a
        # sampled request's timeline shows exactly when its durability
        # write landed (the owning replica shares its recorder).
        self.anatomy = anatomy_mod.NULL
        # Private default registry until the owning replica shares its
        # own via set_metrics (standalone journals stay observable).
        from tigerbeetle_tpu_torch import obs

        self.set_metrics(obs.Registry())

        # Native append framing: sector padding + redundant
        # ring update + redundant-sector build in one C call, handed
        # back as ready-to-write scratch buffers.  Byte-identical to
        # the Python framing below (differential-tested); requires the
        # ring to be sector-aligned (the C pass reads a whole sector's
        # worth of ring entries).
        from tigerbeetle_tpu_torch import envcheck
        from tigerbeetle_tpu_torch.runtime import fastpath

        self._native_frame = (
            envcheck.native_pipeline() == 1
            and fastpath.pipeline_available()
            and self.slot_count % HEADERS_PER_SECTOR == 0
        )
        if self._native_frame:
            self._scratch_prepare = np.zeros(self._prepare_size(), np.uint8)
            self._scratch_sector = np.zeros(SECTOR_SIZE, np.uint8)

    def set_metrics(self, registry) -> None:
        """Create this journal's handles on `registry` (the owning
        replica's, so one snapshot covers WAL write/sync latency)."""
        self.metrics = registry
        self._c_writes = registry.counter("journal.writes")
        self._c_sync_batches = registry.counter("journal.sync_batches")
        self._h_write = registry.histogram("journal.write_us")
        self._h_sync = registry.histogram("journal.sync_us")

    # ------------------------------------------------------------------

    def slot_for_op(self, op: int) -> int:
        return op % self.slot_count

    def _prepare_size(self) -> int:
        return _sectors(self.config.message_size_max)

    def write_prepare(self, header: np.ndarray, body: bytes, sync: bool = True) -> None:
        """Append one prepare: prepares ring first, then the redundant
        header sector (reference ordering — so a crash between the two
        writes is the 'valid prepare / missing redundant' case).

        Hash-once invariant: this path must NEVER hash the
        body — the header arrives finalized (checksum_body stamped by
        the build seam), and the size assertions below are the only
        integrity checks the write needs.  Disk bytes are re-verified
        on READ (read_prepare), where rehashing is the point."""
        assert int(header["command"]) == Command.prepare
        assert int(header["size"]) == HEADER_SIZE + len(body)
        op = int(header["op"])
        slot = self.slot_for_op(op)

        self._c_writes.inc()
        with self.tracer.span(
            "journal_write", op=op, bytes=len(body)
        ), self._h_write.time():
            if self._native_frame:
                # C builds the padded prepare, updates headers[slot]
                # in place, and builds the redundant sector — Python
                # only issues the two storage writes.
                from tigerbeetle_tpu_torch.runtime import fastpath

                padded_len = fastpath.frame_prepare(
                    header, body, self.headers, slot,
                    HEADERS_PER_SECTOR, SECTOR_SIZE,
                    self._scratch_prepare, self._scratch_sector,
                )
                self.storage.write(
                    self.layout.prepare_slot_offset(slot),
                    memoryview(self._scratch_prepare)[:padded_len],
                )
                sector_index = slot // HEADERS_PER_SECTOR
                self.storage.write(
                    self.layout.wal_headers_offset
                    + sector_index * SECTOR_SIZE,
                    memoryview(self._scratch_sector),
                )
            else:
                msg = header.tobytes() + body
                padded = msg.ljust(_sectors(len(msg)), b"\x00")
                self.storage.write(self.layout.prepare_slot_offset(slot), padded)
                self.headers[slot] = header
                self._write_header_sector(slot)
            if sync:
                # ONE fdatasync of the WAL FILE covers both rings
                # (device cache flush included — scoped alternatives
                # like sync_file_range do NOT flush the drive cache).
                # Safe: the op is only acked after this returns; a
                # crash beforehand leaves torn states recovery already
                # classifies.  The grid lives in its own file
                # (storage.py FileStorage), so LSM spill/compaction
                # writeback never rides the ack latency.
                self.storage.sync_wal()
            else:
                # Deferred (group commit): the caller owns the covering
                # sync_batch() and must not ack this op before it.
                self.unsynced_writes += 1
        self.anatomy.stage_h(header, "journal_write")

    def write_prepare_framed(self, header: np.ndarray, body_len: int,
                             wal_view, slot: int, sector_view,
                             sector_index: int) -> None:
        """Append one ALREADY-FRAMED prepare (the native drain loop): the
        sector-padded prepare buffer and redundant-header sector were
        built by the batch C call (which also wrote headers[slot] in
        place) — this issues the same two storage writes, counters,
        and spans as write_prepare(sync=False), per prepare, so the
        storage-visible sequence is identical to the per-item path."""
        assert int(header["command"]) == Command.prepare
        assert int(header["size"]) == HEADER_SIZE + body_len
        op = int(header["op"])
        self._c_writes.inc()
        with self.tracer.span(
            "journal_write", op=op, bytes=body_len
        ), self._h_write.time():
            self.storage.write(self.layout.prepare_slot_offset(slot), wal_view)
            self.storage.write(
                self.layout.wal_headers_offset + sector_index * SECTOR_SIZE,
                sector_view,
            )
            self.unsynced_writes += 1
        self.anatomy.stage_h(header, "journal_write")

    def sync_batch(self) -> bool:
        """One covering fdatasync for every deferred WAL write since
        the last batch — the group-commit seam: a whole poll-drain's
        prepares (and their redundant sectors, and any scrub heals)
        share one durability syscall.  No-op when nothing is deferred,
        so idle flush points cost nothing.  Returns True when a sync
        was actually issued."""
        if self.unsynced_writes == 0:
            return False
        self.unsynced_writes = 0
        self._c_sync_batches.inc()
        try:
            with self._h_sync.time():
                self.storage.sync_wal()
        except BaseException:
            # The covering sync did not complete: everything it would
            # have covered is still unsynced (acks must stay held).
            self.unsynced_writes += 1
            raise
        return True

    def header_sector_intact(self, slot: int) -> bool:
        """Does the DISK redundant-header sector for `slot` match the
        in-memory ring?  (Scrubber probe for latent sector errors.)"""
        sector_index = slot // HEADERS_PER_SECTOR
        first = sector_index * HEADERS_PER_SECTOR
        want = self.headers[first : first + HEADERS_PER_SECTOR].tobytes()
        want = want.ljust(SECTOR_SIZE, b"\x00")
        disk = self.storage.read(
            self.layout.wal_headers_offset + sector_index * SECTOR_SIZE,
            SECTOR_SIZE,
        )
        return disk == want

    def rewrite_header_sector(self, slot: int, sync: bool = True) -> None:
        """Self-heal a latent error in the redundant ring from the
        in-memory copy (authoritative while the process lives).  Only
        the WAL file is flushed (the grid has its own barriers); with
        sync=False the heal rides the caller's covering sync_batch()
        instead of paying its own fdatasync."""
        self._write_header_sector(slot)
        if sync:
            self.storage.sync_wal()
        else:
            self.unsynced_writes += 1

    def _write_header_sector(self, slot: int) -> None:
        sector_index = slot // HEADERS_PER_SECTOR
        first = sector_index * HEADERS_PER_SECTOR
        data = self.headers[first : first + HEADERS_PER_SECTOR].tobytes()
        data = data.ljust(SECTOR_SIZE, b"\x00")
        offset = self.layout.wal_headers_offset + sector_index * SECTOR_SIZE
        self.storage.write(offset, data)

    def read_prepare(self, op: int) -> tuple[np.ndarray, bytes] | None:
        """Read+verify the prepare for `op`; None if torn/overwritten."""
        slot = self.slot_for_op(op)
        raw = self.storage.read(
            self.layout.prepare_slot_offset(slot), self._prepare_size()
        )
        header = wire.header_from_bytes(raw[:HEADER_SIZE])
        if not wire.verify_header(header):
            return None
        if int(header["op"]) != op or int(header["command"]) != Command.prepare:
            return None
        if wire.u128(header, "cluster") != self.cluster:
            return None
        size = int(header["size"])
        body = raw[HEADER_SIZE:size]
        if not wire.verify_header(header, body):
            return None
        return header, bytes(body)

    # ------------------------------------------------------------------

    # Only ops this close to the newest redundant-ring op can have a
    # prepare newer than (or present without) their redundant header:
    # write_prepare issues prepare -> redundant -> fdatasync in order
    # and an op is acked only after the sync joins, so un-persisted
    # redundant headers are confined to the in-flight tail (pipeline
    # <= 8 prepares; 64 is a generous margin for crash-reordering of
    # unsynced sectors).
    RECOVER_HEAD_WINDOW = 64
    # Test hook: force the full prepares-ring scan so differential
    # tests can check the windowed scan classifies identically.
    RECOVER_PROBE_ALL = False

    def recover(self, commit_min: int) -> Recovery:
        """Scan both rings and reconstruct the log above `commit_min`
        (the checkpoint op).

        The prepares ring is NOT read in full: a slot whose redundant
        header is intact with op < commit_min is settled (its op was
        fdatasynced before the checkpoint and recovery skips it), and
        an all-zero redundant sector outside the head window means the
        slot was never written (prepares persist in issue order).
        Only slots that can still influence the result — op >=
        commit_min, op == 0, garbage redundant bytes, or within
        RECOVER_HEAD_WINDOW of the newest op — pay a prepare read.
        On a disk that takes ~5 ms an IO, that turns a 1024-slot x 1 MiB
        ring scan (seconds) into a few dozen reads.
        """
        # Load the redundant ring (one sequential read).
        raw = self.storage.read(
            self.layout.wal_headers_offset, self.layout.wal_headers_size
        )
        disk_headers = np.frombuffer(
            raw[: self.slot_count * HEADER_SIZE], HEADER_DTYPE
        ).copy()

        zero_header = bytes(HEADER_SIZE)
        r_valid_all: list[bool] = []
        settled: list[bool] = []  # classified from the redundant ring alone
        max_op = 0
        for slot in range(self.slot_count):
            redundant = disk_headers[slot]
            r_valid = wire.verify_header(redundant) and int(
                redundant["command"]
            ) == Command.prepare and wire.u128(redundant, "cluster") == self.cluster
            r_valid_all.append(r_valid)
            if r_valid:
                op = int(redundant["op"])
                max_op = max(max_op, op)
                settled.append(
                    op < commit_min
                    and op != 0
                    and self.slot_for_op(op) == slot
                )
            else:
                virgin = (
                    raw[slot * HEADER_SIZE : (slot + 1) * HEADER_SIZE]
                    == zero_header
                )
                settled.append(virgin)
        # Slots that may hold an op newer than their redundant header.
        # Both directions around max_op: un-fdatasynced sectors persist
        # in arbitrary order across a crash, so a slot in the in-flight
        # tail can expose a stale WRAPPED redundant (old op, valid
        # checksum) while its prepare already holds the new op — such a
        # slot sits below max_op, not above it.
        for op in range(
            max(0, max_op - self.RECOVER_HEAD_WINDOW),
            max_op + 1 + self.RECOVER_HEAD_WINDOW,
        ):
            settled[self.slot_for_op(op)] = False
        if self.RECOVER_PROBE_ALL:
            settled = [False] * self.slot_count

        slot_header: dict[int, np.ndarray] = {}
        slot_state: dict[int, str] = {}
        for slot in range(self.slot_count):
            redundant = disk_headers[slot]
            r_valid = r_valid_all[slot]
            if settled[slot]:
                if r_valid:
                    # Redundant header is byte-identical to the intact
                    # prepare's own header; recovery skips the op
                    # either way (op < commit_min).
                    slot_state[slot] = "ok"
                    slot_header[slot] = redundant
                    self.headers[slot] = redundant
                else:
                    slot_state[slot] = "unwritten"
                continue

            p = self._read_slot_prepare(slot)
            if p is not None:
                header, _ = p
                if r_valid and int(redundant["op"]) > int(header["op"]):
                    # Ring wrapped mid-update: redundant is newer but its
                    # prepare was torn — the slot's newest op is lost.
                    slot_state[slot] = "faulty"
                    slot_header[slot] = redundant
                else:
                    slot_state[slot] = "ok"
                    slot_header[slot] = header
                    self.headers[slot] = header
            elif r_valid:
                slot_state[slot] = "faulty"  # prepare torn, redundant intact
                slot_header[slot] = redundant
                self.headers[slot] = redundant
            else:
                slot_state[slot] = "unwritten"

        # Collect valid ops above the checkpoint.
        headers: dict[int, np.ndarray] = {}
        faulty_headers: dict[int, np.ndarray] = {}
        for slot, state in slot_state.items():
            h = slot_header.get(slot)
            if h is None:
                continue
            op = int(h["op"])
            if op < commit_min and op != 0:
                continue
            if state == "ok":
                headers[op] = h
            else:
                faulty_headers[op] = h

        # Walk the hash chain upward from the checkpoint.  When the
        # checkpoint op's own slot is gone (overwritten/faulty), its
        # state lives in the checkpoint snapshot; the chain then
        # starts unanchored just above it (parent None).
        op_head = commit_min
        chain_parent = (
            wire.u128(headers[commit_min], "checksum") if commit_min in headers else None
        )
        op = commit_min + 1
        faulty_ops: list[int] = []
        while True:
            if op in headers:
                h = headers[op]
                if chain_parent is not None and wire.u128(h, "parent") != chain_parent:
                    above = [o for o in headers if o > op]
                    if above:
                        # Chain break BELOW valid ops: one side of the
                        # break is a superseded sibling from an older
                        # view, and recovery alone cannot tell which.
                        # Keep everything and report the break op
                        # faulty — the VSR layer rejoins through a
                        # view change and resolves the true sibling by
                        # vouched checksum.  Truncating here erased
                        # COMMITTED durable ops whose headers then
                        # vanished from the DVC merge (VOPR seeds
                        # 170611267, 1064614514).
                        faulty_ops.append(op)
                        chain_parent = None
                        op += 1
                        continue
                    break  # chain break at the top: stale head, truncated
                chain_parent = wire.u128(h, "checksum")
                op_head = op
                op += 1
            elif op in faulty_headers:
                # A hole below newer valid ops = data loss; a hole at the
                # top = torn head, truncated.
                above = [o for o in headers if o > op]
                if above:
                    faulty_ops.append(op)
                    chain_parent = None  # chain unverifiable across hole
                    op_head = max(above)
                    op += 1
                else:
                    break
            else:
                break

        truncated = sorted(
            o for o in set(headers) | set(faulty_headers) if o > op_head
        )
        headers = {o: h for o, h in headers.items() if o <= op_head}
        return Recovery(
            op_head=op_head,
            headers=headers,
            faulty_ops=faulty_ops,
            truncated_ops=truncated,
        )

    def _read_slot_prepare(self, slot: int) -> tuple[np.ndarray, bytes] | None:
        raw = self.storage.read(
            self.layout.prepare_slot_offset(slot), self._prepare_size()
        )
        header = wire.header_from_bytes(raw[:HEADER_SIZE])
        if not wire.verify_header(header):
            return None
        if int(header["command"]) != Command.prepare:
            return None
        if wire.u128(header, "cluster") != self.cluster:
            return None
        if self.slot_for_op(int(header["op"])) != slot:
            return None
        size = int(header["size"])
        if size > len(raw):
            return None
        body = raw[HEADER_SIZE:size]
        if not wire.verify_header(header, body):
            return None
        return header, bytes(body)
