"""Replica: the durable commit pipeline around a state machine.

This package's own copy of ``tigerbeetle_tpu/vsr/replica.py``; the
multi-replica layer above it is ``vsr/multi.py``.

This module carries the single-replica slice of the reference's
`ReplicaType` (reference: src/vsr/replica.zig): format, crash
recovery (superblock quorum -> snapshot restore -> WAL replay),
timestamp assignment, the prepare -> journal -> commit -> reply chain,
pulse injection, client sessions with at-most-once dedupe, and
checkpointing every `vsr_checkpoint_interval` ops (reference:
src/vsr/replica.zig:3886-4039).  Multi-replica consensus (prepare_ok
quorums, view change, repair) layers on top in vsr/multi.py via the
message bus — the commit pipeline here is shared by both.

Recovery = re-execution: timestamps are assigned at prepare time and
stored in the prepare header, so replaying the WAL through the state
machine is bit-deterministic (reference: deterministic state machine
requirement, docs/about/vopr.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.obs import stat_property
from tigerbeetle_tpu_torch.state_machine import demuxer
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.journal import Journal
from tigerbeetle_tpu_torch.vsr.storage import Storage, _sectors
from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock
from tigerbeetle_tpu_torch.vsr.wire import Command, VsrOperation


def format(storage: Storage, cluster: int, replica: int = 0,
           replica_count: int = 1) -> None:
    """Initialize a data file (reference: src/vsr/replica_format.zig):
    superblock (sequence 1) + the root prepare in WAL slot 0."""
    sb = SuperBlock(storage, cluster)
    sb.format(replica, replica_count)
    journal = Journal(storage, cluster)
    journal.write_prepare(wire.root_prepare(cluster), b"")


# Fixed A/B checkpoint-snapshot reservation when an LSM forest shares
# the grid zone (spilling bounds the blob well below this; asserted at
# checkpoint).  Without a forest the regions size dynamically as before.
SNAPSHOT_SPAN = 1 << 28
FOREST_BLOCK_COUNT = 1 << 12


@dataclasses.dataclass
class Session:
    """Client session entry (reference: src/vsr/client_sessions.zig)."""

    session: int            # op of the register prepare
    request: int            # latest request number seen
    reply_header: bytes     # serialized header of the latest reply
    slot: int               # client_replies zone slot


class Replica:
    # Audited write-write sharing with the ckpt SerialWorker (tbcheck
    # worker-shared): the async checkpoint flip publishes checkpoint_op
    # from the worker thread, while open()/recovery set it on the
    # foreground thread — serialized by the _ckpt_join barrier, which
    # runs before any foreground read or write of checkpoint state.
    _WORKER_SHARED = frozenset({"checkpoint_op"})

    def __init__(self, storage: Storage, cluster: int, state_machine,
                 replica: int = 0, replica_count: int = 1, aof=None,
                 forest_block_count: int = FOREST_BLOCK_COUNT) -> None:
        self.storage = storage
        self.cluster = cluster
        self.sm = state_machine
        self.aof = aof  # optional vsr.aof.AOF (reference: src/aof.zig)
        # One daemon worker overlaps each op's WAL fdatasync (disk
        # wait) with its commit-stage CPU work; _prepare_and_commit
        # joins before replying, preserving the durability-before-ack
        # contract.  Only on backends whose sync is thread-safe
        # against concurrent writes (FileStorage); the fault-injecting
        # MemoryStorage keeps the synchronous path so its seeded crash
        # model stays deterministic.
        self._wal_sync_worker = None
        self._wal_sync_inflight = None
        # Asynchronous checkpoints (TB_CKPT_ASYNC, default on): the
        # commit-visible part of checkpoint() is only the freeze
        # (spill residue + snapshot encode + buffered blob write); the
        # disk barriers (grid writeback join, fdatasync, superblock
        # flip) run on a background worker and the NEXT checkpoint (or
        # close()) joins them.  Only on FileStorage — MemoryStorage
        # keeps the synchronous path so seeded crash tests stay
        # deterministic.
        self._ckpt_worker = None
        self._ckpt_job = None         # non-None while a flip is in flight
        self._ckpt_last_op = 0        # commit_min of the latest freeze
        # Metrics registry (obs/registry.py): every stat_* counter on
        # this replica is a registry handle behind a compatibility
        # property; latency histograms ride the same registry and the
        # whole tree is scrapeable via the `stats` wire op.
        from tigerbeetle_tpu_torch import obs

        self.metrics = obs.Registry()
        self._stats = {
            "stat_ckpt_async": self.metrics.counter("ckpt.async"),
            "stat_ckpt_sync": self.metrics.counter("ckpt.sync"),
        }
        self._c_commits = self.metrics.counter("commits")
        self._h_commit = self.metrics.histogram("commit_us")
        self._h_request = self.metrics.histogram("request_us")
        # Hash-once commit path.  hash.bytes_hashed counts BODY bytes
        # actually SHA-256'd on this replica (ingress verify, build
        # rehashes under TB_HASH_REUSE=0, and the coalesce finalize —
        # header hashes are fixed 240-byte costs and excluded by
        # definition); hash.reuse_hits counts build seams that consumed
        # a cached digest instead of rehashing; hash.committed_body_bytes
        # is the ratio's denominator.  hash.dup_body_bytes charges
        # duplicate DELIVERIES — a retransmitted prepare or request must
        # be verified before it can be recognized as a duplicate, so its
        # ingress pass is unavoidable and the exact bound is
        # bytes_hashed <= committed + dup.  Created here so the
        # single-replica server scrapes the same vsr.hash.* names the
        # VSR subclass feeds.
        from tigerbeetle_tpu_torch import envcheck as _envcheck

        self._hash_reuse = _envcheck.hash_reuse() == 1
        self._c_hash_bytes = self.metrics.counter("hash.bytes_hashed")
        self._c_hash_reuse = self.metrics.counter("hash.reuse_hits")
        self._c_hash_commit = self.metrics.counter(
            "hash.committed_body_bytes"
        )
        self._c_hash_dup = self.metrics.counter("hash.dup_body_bytes")
        # Batched-reply encode pass (one vectorized header build + one
        # batch checksum finalize per committed batch).  The owning
        # server re-points this at its own `server.reply_encode_us`
        # histogram so the drain-loop instruments sit together.
        self.h_reply_encode = self.metrics.histogram("reply_encode_us")
        self._h_ckpt_freeze = self.metrics.histogram("ckpt.freeze_us")
        self._h_ckpt_finalize = self.metrics.histogram("ckpt.finalize_us")
        self.metrics.gauge_fn("commit_min", lambda: self.commit_min)
        # Per-request anatomy (obs/anatomy.py): stage timelines for
        # sampled requests, keyed by the wire trace context.  Enabled
        # iff metrics are; the owning server attaches the flight ring.
        from tigerbeetle_tpu_torch.obs.anatomy import AnatomyRecorder

        self.anatomy = AnatomyRecorder(self.metrics.scope("anatomy"))
        if hasattr(state_machine, "anatomy"):
            state_machine.anatomy = self.anatomy
        if getattr(storage, "supports_async_writeback", False):
            import weakref

            from tigerbeetle_tpu_torch import envcheck
            from tigerbeetle_tpu_torch.utils.worker import SerialWorker

            self._wal_sync_worker = SerialWorker("wal-sync")
            weakref.finalize(self, self._wal_sync_worker.close)
            if envcheck.ckpt_async():
                self._ckpt_worker = SerialWorker("ckpt")
                weakref.finalize(self, self._ckpt_worker.close)
        # Optional testing.hash_log.HashLog: per-commit chained digests
        # for determinism-divergence pinpointing (reference:
        # src/testing/hash_log.zig).
        self.hash_log = None
        # Root ring: op -> 16-byte state root recorded after
        # each commit, serving the `state_root` at-op query followers
        # attest against (runtime/follower.py).  None = off (zero
        # cost); the owning server/harness enables it by assigning a
        # size via enable_root_ring().  Requires a state machine with
        # state_root().
        self.root_ring: dict[int, bytes] | None = None
        self.root_ring_max = 0
        # Span tracer (utils/tracer.py; reference: src/tracer.zig
        # hooked in the commit path) — NULL until set_tracer().
        from tigerbeetle_tpu_torch.utils import tracer as tracer_mod

        self.tracer = tracer_mod.NULL
        self.config = storage.layout.config
        self.replica = replica
        self.replica_count = replica_count
        # Reconfiguration (reference: src/vsr.zig:273-311): the FIXED
        # process identity (index into the operator's address list) vs
        # the protocol slot (`self.replica`) the process currently
        # fills.  `members[slot] = process`; epoch bumps per change.
        self.process_index = replica
        # COMMITTED epoch/membership: advanced only by executing the
        # replicated reconfigure op (or restoring a checkpoint), so
        # reconfigure replies are a pure function of the op stream.
        self.epoch = 0
        self.members: list[int] | None = None
        # ADOPTED epoch/roles: may run AHEAD of committed via the
        # heartbeat advertisement (a crashed process must re-learn the
        # slot it fills to be reachable at all), but never influences
        # the committed validation — conflating them made a replica
        # that heartbeat-adopted epoch N reply "stale" to the
        # intermediate epochs it later replayed, while live replicas
        # had replied "ok": reply divergence (VOPR reconfigure
        # nemesis, seed 44).
        self.epoch_adopted = 0
        self.members_adopted: list[int] | None = None
        # epoch -> members actually applied (replay idempotency).
        self._reconfig_history: dict[int, list[int]] = {}

        self.superblock = SuperBlock(storage, cluster)
        self.journal = Journal(storage, cluster)
        self.journal.set_metrics(self.metrics)
        self.journal.anatomy = self.anatomy

        # LSM forest over the grid zone's block region (state machines
        # that support it spill frozen state there, so checkpoints stay
        # O(RAM tail) and durable state scales past host RAM —
        # reference: src/lsm/forest.zig:31).  The A/B snapshot regions
        # get a fixed reservation ahead of the block region; nothing
        # preallocates it, so on a file system that keeps holes the
        # unused reservation costs no disk.
        self.forest = None
        if hasattr(state_machine, "attach_forest"):
            from tigerbeetle_tpu_torch.lsm.forest import Forest

            self.forest = Forest(
                storage,
                base_offset=storage.layout.grid_offset + 2 * SNAPSHOT_SPAN,
                block_count=forest_block_count,
            )
            state_machine.attach_forest(self.forest)

        self.op = 0                  # highest prepared op
        self._ckpt_interval_observed = 0  # ops between checkpoints
        self.commit_min = 0          # highest committed op
        self.commit_parent = None    # checksum of last committed prepare
        self.view = 0
        self.parent_checksum = 0     # checksum of prepare at self.op
        self.checkpoint_op = 0
        self.sessions: dict[int, Session] = {}
        # (client, reply_header_bytes, reply_body) per sub-request of
        # the most recently committed batched prepare (see
        # _commit_prepare_impl; the primary pipeline drains it).
        self._batch_replies: list[tuple[int, bytes, bytes]] = []
        self._next_reply_slot = 0
        self.realtime = 0
        # Multiversion upgrades (multi.py drives these; the base
        # pipeline honors Operation.upgrade commits).
        self.release = 1
        self.upgrade_target: int | None = None

    # Compatibility: migrated stat_* counters live in the metrics
    # registry (obs/registry.py); reads and writes route to handles.
    stat_ckpt_async = stat_property("stat_ckpt_async")
    stat_ckpt_sync = stat_property("stat_ckpt_sync")

    # ------------------------------------------------------------------
    # Open / recovery.

    def open(self, *, replay_tail: bool | None = None) -> None:
        """Recover: superblock quorum -> checkpoint snapshot -> WAL.

        `replay_tail` controls whether the WAL above the checkpoint is
        EXECUTED during recovery.  Single-replica: yes — every recorded
        prepare was committed.  Multi-replica: no — the tail may hold
        speculative prepares that never reached quorum and were
        superseded after a view change; executing them would diverge
        this replica's state from the cluster permanently.  The tail
        stays in the journal as candidates, and the consensus layer
        re-commits it through the parent-checksum-verified chain as
        commit_max is learned from the cluster (the reference keeps
        recovering replicas from committing ahead of the cluster the
        same way — src/vsr/replica.zig:44-49 .recovering_head)."""
        if replay_tail is None:
            replay_tail = self.replica_count == 1
        sb = self.superblock.open()
        if self.cluster is None:
            # cluster=None = adopt the id `format` recorded (see
            # SuperBlock.open); the journal shares it for prepare
            # checksum verification.
            self.cluster = self.superblock.cluster
            self.journal.cluster = self.cluster
        if int(sb["member_count"]):
            members = list(
                bytes(sb["members"])[: int(sb["member_count"])]
            )
            self._install_committed(int(sb["epoch"]), members)
        self.view = int(sb["view"])
        self.checkpoint_op = int(sb["commit_min"])

        # Restore the checkpoint snapshot (if one was ever taken).
        size = int(sb["checkpoint_size"])
        if size:
            blob = self._read_grid(int(sb["checkpoint_offset"]), size)
            want = (
                int(sb["checkpoint_checksum_lo"])
                | (int(sb["checkpoint_checksum_hi"]) << 64)
            )
            if wire.checksum(blob) != want:
                raise RuntimeError("checkpoint snapshot corrupt")
            self._restore_snapshot(blob)
            # State-root recompute-and-assert: the restored state
            # machine re-derives its incremental commitment from
            # scratch; it must match the root the checkpoint recorded
            # — a blob that passes its checksum but decodes to
            # different table content (codec drift, partial restore)
            # dies HERE, not at the next cross-replica divergence.
            root_stored = int(sb["state_root_lo"]) | (
                int(sb["state_root_hi"]) << 64
            )
            if root_stored and hasattr(self.sm, "state_root"):
                root_now = int.from_bytes(self.sm.state_root(), "little")
                if root_now != root_stored:
                    raise RuntimeError(
                        "checkpoint state root mismatch after restore: "
                        f"recorded {root_stored:#034x}, recomputed "
                        f"{root_now:#034x}"
                    )

        recovery = self.journal.recover(self.checkpoint_op)
        if recovery.faulty_ops and self.replica_count == 1:
            raise RuntimeError(f"WAL data loss at ops {recovery.faulty_ops}")

        # Walk the readable prefix above the checkpoint.  When a tail
        # replay is requested (single-replica recovery, restart-replay
        # checkers) a gap truncates the head there — execution needs
        # the bodies.  A multi-replica open PRESERVES the full
        # recovered head instead: the ops above a damaged slot are
        # still vouched by the redundant ring, and the VSR repair
        # protocol refetches the missing prepares from peers —
        # truncating here made a damaged replica understate its DVC
        # and let a view-change quorum of damaged replicas discard
        # committed ops (VOPR corruption nemesis, seed 8006).
        op_head = recovery.op_head
        for op in range(self.checkpoint_op + 1, recovery.op_head + 1):
            read = self.journal.read_prepare(op)
            if read is None:
                assert self.replica_count > 1
                if replay_tail:
                    op_head = op - 1
                break
            if replay_tail:
                header, body = read
                self._commit_prepare(header, body, replay=True)
        self.op = op_head
        self.commit_min = op_head if replay_tail else self.checkpoint_op
        # Commit-chain anchor: checksum of the last committed prepare
        # (consensus verifies each next commit links to it).
        anchor = recovery.headers.get(self.commit_min)
        if anchor is not None:
            self.commit_parent = wire.u128(anchor, "checksum")
        elif self.commit_min == 0:
            self.commit_parent = wire.u128(
                wire.root_prepare(self.cluster), "checksum"
            )
        else:
            self.commit_parent = None  # unknown; verified from repair
        head = recovery.headers.get(op_head)
        self.parent_checksum = (
            wire.u128(head, "checksum") if head is not None
            else wire.u128(wire.root_prepare(self.cluster), "checksum")
        )

    # ------------------------------------------------------------------
    # The request path (single-replica: prepare+commit are synchronous).

    def on_request(self, operation: int, body: bytes, *, client: int = 0,
                   request: int = 0, realtime: int | None = None) -> bytes:
        """Execute one client request end-to-end; returns the reply body.

        Handles dedupe: a repeat of the client's latest request returns
        the stored reply without re-executing (reference:
        src/vsr/replica.zig:5035-5100)."""
        if realtime is not None:
            self.realtime = realtime
        if client:
            entry = self.sessions.get(client)
            if entry is not None and request == entry.request and request > 0:
                return self._read_reply(entry)

        if operation != types.Operation.pulse:
            self._tick_pulses()
        # request_us covers the whole prepare -> WAL -> commit chain
        # (what a single-replica client waits for); commit_us inside
        # it isolates the state-machine commit stage.
        with self._h_request.time():
            reply = self._prepare_and_commit(operation, body, client, request)
        return reply

    def register_client(self, client: int) -> None:
        """Session registration (reference: Operation.register)."""
        self._prepare_and_commit(
            VsrOperation.register, b"", client, 0, vsr_operation=True
        )

    def _tick_pulses(self) -> None:
        while True:
            self._advance_prepare_timestamp()
            if not self.sm.pulse_needed():
                return
            before = self.sm.pulse_next_timestamp
            self._prepare_and_commit(types.Operation.pulse, b"", 0, 0)
            if self.sm.pulse_next_timestamp == before:
                return

    def _advance_prepare_timestamp(self) -> None:
        # reference: src/vsr/replica.zig:5762-5772
        self.sm.prepare_timestamp = max(
            max(self.sm.prepare_timestamp, self.sm.commit_timestamp) + 1,
            self.realtime,
        )

    def _prepare_and_commit(self, operation: int, body: bytes, client: int,
                            request: int, vsr_operation: bool = False) -> bytes:
        assert len(body) <= self.config.message_body_size_max
        self._advance_prepare_timestamp()
        if not vsr_operation:
            self.sm.prepare(types.Operation(operation), body)
        timestamp = self.sm.prepare_timestamp

        op = self.op + 1
        header = wire.make_header(
            command=Command.prepare,
            operation=operation,
            cluster=self.cluster,
            client=client,
            request=request,
            view=self.view,
            op=op,
            commit=self.commit_min,
            timestamp=timestamp,
            parent=self.parent_checksum,
        )
        wire.finalize_header(header, body)
        # Single-replica role: bodies originate at the caller (no
        # ingress frame, no prior digest), so this finalize is the one
        # hash pass the hash-once contract budgets for the role.
        self._c_hash_bytes.inc(len(body))

        # WAL append is THE durability point — but the fdatasync (a
        # disk wait of milliseconds) overlaps the commit stage's CPU
        # work: the reply is only returned after the sync JOINS, so the
        # contract (no ack before WAL durability) is unchanged
        # (reference: the prepare pipeline overlaps journal writes with
        # commit execution the same way, src/vsr/replica.zig pipeline).
        if self._wal_sync_worker is not None:
            self.journal.write_prepare(header, body, sync=False)
            self.op = op
            self.parent_checksum = wire.u128(header, "checksum")
            self._wal_sync_inflight = self._wal_sync_worker.submit(
                self.storage.sync_wal
            )
            try:
                reply = self._commit_prepare(header, body)
            finally:
                self._join_wal_sync()
        else:
            self.journal.write_prepare(header, body)
            self.op = op
            self.parent_checksum = wire.u128(header, "checksum")
            reply = self._commit_prepare(header, body)

        # Checkpoint cadence (reference: src/constants.zig:55-81) — must
        # run before the WAL ring wraps over the previous checkpoint.
        if self._checkpoint_due():
            self.checkpoint()
        return reply

    def _checkpoint_due(self) -> bool:
        """Interval crossed since the latest FREEZE (an async flip
        still in flight counts — re-freezing against it would just
        serialize every commit on the join)."""
        return (
            self.commit_min - max(self.checkpoint_op, self._ckpt_last_op)
            >= self.config.vsr_checkpoint_interval
        )

    def _join_wal_sync(self) -> None:
        if self._wal_sync_inflight is not None:
            self._wal_sync_inflight.result()
            self._wal_sync_inflight = None

    def _aof_barrier(self) -> None:
        """WAL durability barrier before an AOF append (VsrReplica
        extends this to force the group-commit covering sync)."""
        self._join_wal_sync()

    def set_tracer(self, tracer) -> None:
        """Attach a utils.tracer.Tracer to this replica's hot paths
        (commit stages, checkpoint, journal writes, device engine
        lifecycle)."""
        self.tracer = tracer
        self.journal.tracer = tracer
        dev = getattr(self.sm, "_dev", None)
        if dev is not None and hasattr(dev, "tracer"):
            dev.tracer = tracer

    def _commit_prepare(self, header: np.ndarray, body: bytes,
                        replay: bool = False) -> bytes:
        """The commit stage chain (reference: src/vsr/replica.zig:
        3456-3535): prefetch -> commit -> reply store.  Wrapped whole
        in the `commit` span + commit_us histogram so per-op commit
        latency is scrapeable (bench sources its commit percentiles
        from this, not from re-derived timings)."""
        with self.tracer.span(
            "commit", op=int(header["op"])
        ), self._h_commit.time():
            reply = self._commit_prepare_impl(header, body, replay)
        self._c_commits.inc()
        # Ratio denominator for the hash-once contract: every body
        # byte this replica commits.  The TCP smoke asserts
        # bytes_hashed / committed_body_bytes <= 1.0 per role with
        # reuse on (coalescing excluded).
        self._c_hash_commit.inc(len(body))
        if self.root_ring is not None:
            self._record_root(int(header["op"]))
        self.anatomy.stage_h(header, "commit")
        return reply

    def enable_root_ring(self, size: int) -> None:
        """Keep the state root of the last `size` committed ops so the
        `state_root` query can answer AT a requested op — the follower
        attestation primitive.  Backfills the current commit point so
        a follower already caught up can attest immediately."""
        assert size > 0 and hasattr(self.sm, "state_root")
        self.root_ring = {}
        self.root_ring_max = int(size)
        if self.commit_min > 0:
            self._record_root(self.commit_min)

    def _record_root(self, op: int) -> None:
        ring = self.root_ring
        ring[op] = self.sm.state_root()
        while len(ring) > self.root_ring_max:
            ring.pop(next(iter(ring)))

    def root_at(self, op: int) -> bytes | None:
        """Ring lookup: the state root AFTER committing `op`, if still
        retained."""
        return None if self.root_ring is None else self.root_ring.get(op)

    def _commit_prepare_impl(self, header: np.ndarray, body: bytes,
                             replay: bool = False) -> bytes:
        op = int(header["op"])
        operation = int(header["operation"])
        timestamp = int(header["timestamp"])
        client = wire.u128(header, "client")
        if hasattr(self.sm, "anatomy_trace"):
            # Stamp the current prepare's trace id so the state
            # machine can attribute its device-window hop.
            self.sm.anatomy_trace = wire.trace_sampled(header)

        if replay:
            # Timestamps replay from the header, not the clock
            # (prepare() only assigns timestamps, so setting the stored
            # value reproduces the live prepare exactly).
            self.sm.prepare_timestamp = timestamp
            if self.aof is not None and op > self.aof.last_op:
                # Gap fill: a crash can erase the AOF's
                # unsynced tail while the ops it held stay committed
                # cluster-wide (WAL recovery replays them with
                # replay=True, which historically skipped the AOF
                # entirely).  Re-appending exactly the missing ops
                # keeps the AOF's op stream gap-free — the contract
                # followers tail under.  No durability barrier needed:
                # a replayed op is already covered by the WAL.
                self.aof.write(header, body)
        elif self.aof is not None:
            # reference: src/vsr/replica.zig:4136-4141 — AOF before
            # apply, and never ahead of the WAL's durability: the AOF
            # must not record an op a crash could erase from the WAL.
            self._aof_barrier()
            self.aof.write(header, body)

        if operation == int(VsrOperation.register):
            reply = b""
            self.sessions[client] = Session(
                session=op, request=0, reply_header=b"",
                slot=self._alloc_reply_slot(),
            )
            assert len(self.sessions) <= self.config.clients_max
        elif operation == int(VsrOperation.reconfigure):
            # Replicated membership change (reference:
            # src/vsr.zig:273-311): epoch bump + slot->process
            # permutation; reply is a 4-byte result code.  The
            # prepare's view rides along so the primary-displacement
            # check is deterministic across replicas (the header is
            # replicated bit-exact; live view state is not).
            reply = self._commit_reconfigure(body, int(header["view"]))
        elif operation == int(VsrOperation.upgrade):
            # Cluster-coordinated release switch (reference:
            # src/vsr/replica.zig:4298 replica_release_execute): the
            # committed target release takes effect when the process
            # re-executes into the new binary (harness restart).
            reply = b""
            target = int.from_bytes(body[:8], "little")
            # Replay of an old upgrade op (already running >= target)
            # must not latch a stale target and block future upgrades.
            if target > self.release:
                self.upgrade_target = target
        else:
            sm_op = types.Operation(operation)
            n_subs = wire.u128(header, "context")
            if n_subs:
                # Logically-batched prepare: commit the combined event
                # batch once, then demux + store each sub-request's
                # reply slice (state_machine/demuxer.py).
                events, subs = demuxer.decode_trailer(body, n_subs)
                with self.tracer.span("state_machine_prefetch"):
                    self.sm.prefetch(
                        sm_op, events, prefetch_timestamp=timestamp
                    )
                with self.tracer.span(
                    "state_machine_commit", op=op, bytes=len(events)
                ):
                    reply = self.sm.commit(
                        client, op, timestamp, sm_op, events
                    )
                dm = demuxer.Demuxer(sm_op, reply)
                offset = 0
                pieces = []
                for _sub_client, _sub_request, count in subs:
                    pieces.append(dm.decode(offset, count))
                    offset += count
                # Per-sub replies captured AT commit: a session stores
                # only its LATEST reply, so when one batch multiplexes
                # several requests of the SAME client (open-loop
                # sessions keep many in flight), sending the stored
                # reply N times would answer every sub with the last
                # request's bytes — earlier subs would never resolve.
                # The pipeline sends these captured pairs instead.
                #
                # Coalesced encode (columnar ingest): ALL sub
                # reply headers are built in one vectorized pass and
                # checksummed in one batch finalize — replacing per-sub
                # make_header + 2 hashlib calls — then scattered to
                # sessions in sub order (bit-identical bytes to the
                # old per-sub path).
                with self.h_reply_encode.time():
                    rhdrs = self._encode_sub_replies(header, subs, pieces)
                self._batch_replies = []
                for i, (sub_client, sub_request, _count) in enumerate(subs):
                    if not sub_client:
                        continue
                    entry = self.sessions.get(sub_client)
                    if entry is None:  # un-registered (tests drive raw)
                        continue
                    piece = pieces[i]
                    entry.request = sub_request
                    entry.reply_header = rhdrs[i].tobytes()
                    msg = entry.reply_header + piece
                    self.storage.write(
                        self.storage.layout.reply_slot_offset(entry.slot),
                        msg.ljust(_sectors(len(msg)), b"\x00"),
                    )
                    self._batch_replies.append(
                        (sub_client, entry.reply_header, piece)
                    )
                self._compact_beat()
                self.commit_min = op
                if self.hash_log is not None and not replay:
                    self.hash_log.record(op, header.tobytes(), reply)
                return reply
            with self.tracer.span("state_machine_prefetch"):
                self.sm.prefetch(sm_op, body, prefetch_timestamp=timestamp)
            with self.tracer.span(
                "state_machine_commit", op=op, bytes=len(body)
            ):
                reply = self.sm.commit(client, op, timestamp, sm_op, body)

        self._compact_beat()
        self.commit_min = op
        # Replayed commits are not recorded: a recovered WAL tail may
        # include speculative ops that never reached quorum and are
        # later superseded (two-step repair corrects the state).
        if self.hash_log is not None and not replay:
            self.hash_log.record(op, header.tobytes(), reply)
        if client and operation != int(VsrOperation.register):
            self._store_reply(header, reply)
        return reply

    # ------------------------------------------------------------------
    # Reconfiguration (reference: src/vsr.zig:273-311).

    @staticmethod
    def decode_reconfigure(body: bytes) -> tuple[int, list[int]] | None:
        """None = malformed (a poison body must fail with a result
        code, never crash the commit path of every replica)."""
        if len(body) < 9:
            return None
        epoch = int.from_bytes(body[:8], "little")
        count = body[8]
        if count == 0 or count > 64 or len(body) < 9 + count:
            return None
        return epoch, list(body[9 : 9 + count])

    @staticmethod
    def encode_reconfigure(epoch: int, members: list[int]) -> bytes:
        return (
            epoch.to_bytes(8, "little")
            + bytes([len(members)])
            + bytes(members)
        )

    def validate_reconfigure(
        self, epoch: int, members: list[int], view: int = 0
    ) -> int:
        """-> 0 ok; 1 stale/skipped epoch; 2 malformed membership;
        3 would displace the primary that committed it (an accepted
        self-demotion would orphan the in-flight pipeline — the slot
        of `view`'s primary must keep its process)."""
        if epoch != self.epoch + 1:
            return 1
        if sorted(members) != list(range(self._member_total())):
            return 2
        current = self.members or list(range(self._member_total()))
        primary_slot = view % self.replica_count
        if members[primary_slot] != current[primary_slot]:
            return 3
        return 0

    def _member_total(self) -> int:
        return self.replica_count  # multi.py adds standbys

    def _commit_reconfigure(self, body: bytes, view: int = 0) -> bytes:
        decoded = self.decode_reconfigure(body)
        if decoded is None:
            return (2).to_bytes(4, "little")
        epoch, members = decoded
        if self._reconfig_history.get(epoch) == members:
            # Idempotent replay: a replica whose committed install of
            # this epoch came from a checkpoint (open/state sync)
            # rather than live execution replays the op with the same
            # success code every live replica recorded.  (History
            # covers only the restored epoch, not intermediates — an
            # acceptable residual: clients retry reconfigure against
            # the session reply only within one epoch.)
            return (0).to_bytes(4, "little")
        code = self.validate_reconfigure(epoch, members, view)
        if code == 0:
            self._install_committed(epoch, members)
        return code.to_bytes(4, "little")

    def _install_committed(self, epoch: int, members: list[int]) -> None:
        """Install a committed membership: the single sequence the
        op-stream execution, superblock restore, and state-sync
        restore must all share — divergence between these paths is
        exactly the reply-nondeterminism class of seeds 44 and
        300661417."""
        self.epoch = epoch
        self.members = list(members)
        self._reconfig_history[epoch] = list(members)
        self._adopt_roles(epoch, members)

    def _adopt_roles(self, epoch: int, members: list[int]) -> None:
        """Adopt the runtime identity for `members` unless a NEWER
        membership was already adopted out-of-band (heartbeat): roles
        follow the freshest known epoch, while self.epoch/self.members
        stay the committed-prefix state that deterministic reconfigure
        replies validate against."""
        if epoch < self.epoch_adopted:
            return
        self.epoch_adopted = epoch
        self.members_adopted = list(members)
        self._apply_membership(members)

    def _apply_membership(self, members: list[int]) -> None:
        """Adopt the slot this process fills under `members`
        (single-replica base: bookkeeping only; multi.py re-derives
        roles, ring, and clock)."""
        self.replica = members.index(self.process_index)

    def _compact_beat(self) -> None:
        """One beat of paced LSM work per commit (reference:
        src/vsr/replica.zig:3847 .compact_state_machine stage,
        src/lsm/compaction.zig beats): spill a bounded chunk of frozen
        state into the LSM and advance a bounded slice of merge debt,
        so checkpoints only settle a small residue instead of stalling
        on a whole interval's worth."""
        if self.forest is None:
            return
        # Spill/compaction beats keep running through an async flip
        # window: allocation is safe because the FreeSet quarantines
        # the frozen checkpoint's released blocks from reuse until the
        # flip lands (the previous superblock — still the durable
        # recovery root — may reference them), and beats stay a pure
        # function of commit count either way (cluster-deterministic).
        spilled = 0
        if hasattr(self.sm, "spill_beat"):
            spilled = self.sm.spill_beat()
        if spilled or self.forest.compaction_pending():
            # Escalate the budget as the next checkpoint nears so
            # in-flight merges land BEFORE the barrier instead of
            # draining inside it as one latency spike (the p100 tail).
            # The cadence is learned from the PREVIOUS interval
            # (operators may checkpoint more often than
            # vsr_checkpoint_interval — the durable benchmark does);
            # op-count-driven, so replicas stay deterministic.
            interval = min(
                self.config.vsr_checkpoint_interval,
                self._ckpt_interval_observed or (1 << 30),
            )
            left = self.checkpoint_op + interval - self.op
            budget = 64 if left > 8 else 64 * (10 - max(left, 0))
            with self.tracer.span("lsm_compact_beat", rows=spilled):
                self.forest.compact_beat(budget)

    # ------------------------------------------------------------------
    # Client replies (reference: src/vsr/client_replies.zig).

    def _alloc_reply_slot(self) -> int:
        """A free reply slot — evicting the oldest session when the
        table is full (reference: src/vsr/client_sessions.zig evict +
        Command.eviction, src/vsr.zig:301).  The eviction choice (the
        lowest register op) is deterministic, so every replica evicts
        the same client at the same commit."""
        if self._next_reply_slot < self.config.clients_max:
            slot = self._next_reply_slot
            self._next_reply_slot += 1
            return slot
        victim = min(self.sessions, key=lambda c: self.sessions[c].session)
        slot = self.sessions.pop(victim).slot
        self._notify_eviction(victim)
        return slot

    def _notify_eviction(self, client: int) -> None:
        """Hook: networked replicas send Command.eviction (multi.py)."""

    def _store_reply(self, prepare: np.ndarray, reply_body: bytes) -> None:
        client = wire.u128(prepare, "client")
        entry = self.sessions.get(client)
        if entry is None:  # un-registered client (tests drive directly)
            return
        reply = wire.make_header(
            command=Command.reply,
            operation=int(prepare["operation"]),
            cluster=self.cluster,
            client=client,
            request=int(prepare["request"]),
            view=self.view,
            op=int(prepare["op"]),
            commit=int(prepare["op"]),
            timestamp=int(prepare["timestamp"]),
            context=wire.u128(prepare, "checksum"),
        )
        # The reply carries the request's trace context back to the
        # client (origin timestamp included), closing the loop: the
        # client can compute wire-to-wire latency from its own clock.
        wire.copy_trace(reply, prepare)
        wire.finalize_header(reply, reply_body)
        entry.request = int(prepare["request"])
        entry.reply_header = reply.tobytes()
        msg = reply.tobytes() + reply_body
        self.storage.write(
            self.storage.layout.reply_slot_offset(entry.slot),
            msg.ljust(_sectors(len(msg)), b"\x00"),
        )

    def _encode_sub_replies(self, prepare: np.ndarray, subs, pieces):
        """One encode pass for a batched prepare's sub replies: an
        (n,) HEADER_DTYPE array built vectorized (shared fields
        broadcast from the prepare, per-sub client/request scattered
        in) and finalized in one native batch checksum call
        (runtime/fastpath.py; wire.finalize_headers_py under
        TB_FASTPATH_DISABLE).  Field-for-field the same header
        _store_reply builds per sub."""
        from tigerbeetle_tpu_torch.runtime import fastpath

        n = len(subs)
        rh = np.zeros(n, wire.HEADER_DTYPE)
        rh["version"] = wire.VERSION
        rh["command"] = int(Command.reply)
        rh["operation"] = int(prepare["operation"])
        rh["cluster_lo"] = self.cluster & 0xFFFFFFFFFFFFFFFF
        rh["cluster_hi"] = self.cluster >> 64
        rh["view"] = self.view
        rh["op"] = prepare["op"]
        rh["commit"] = prepare["op"]
        rh["timestamp"] = prepare["timestamp"]
        # context = the prepare's checksum (reply provenance).
        rh["context_lo"] = prepare["checksum_lo"]
        rh["context_hi"] = prepare["checksum_hi"]
        # The reply carries the request's trace context back to the
        # client (copy_trace semantics — the batch shares the
        # prepare's context, exactly as the per-sub header.copy() did).
        rh["trace_id"] = prepare["trace_id"]
        rh["trace_ts"] = prepare["trace_ts"]
        rh["trace_flags"] = prepare["trace_flags"]
        rh["client_lo"] = np.array(
            [c & 0xFFFFFFFFFFFFFFFF for c, _r, _n in subs], np.uint64
        )
        rh["client_hi"] = np.array(
            [c >> 64 for c, _r, _n in subs], np.uint64
        )
        rh["request"] = np.array([r for _c, r, _n in subs], np.uint32)
        if not fastpath.finalize_headers(rh, pieces):
            wire.finalize_headers_py(rh, pieces)
        return rh

    def _read_reply(self, entry: Session) -> bytes:
        header = wire.header_from_bytes(entry.reply_header)
        size = int(header["size"])
        raw = self.storage.read(
            self.storage.layout.reply_slot_offset(entry.slot), _sectors(size)
        )
        body = raw[HEADER_SIZE:size]
        stored = wire.header_from_bytes(raw[:HEADER_SIZE])
        if stored.tobytes() != entry.reply_header or not wire.verify_header(
            stored, body
        ):
            raise RuntimeError("stored reply corrupt")
        return bytes(body)

    # ------------------------------------------------------------------
    # Checkpointing.

    def checkpoint(self) -> None:
        """Freeze a snapshot of the committed state, then make it the
        durable recovery root.  The freeze (spill residue into LSM
        memtables, snapshot encode, buffered blob write) runs inline;
        the disk barriers + superblock flip run on the checkpoint
        worker when async checkpointing is on — commits keep flowing
        while they land, and the next checkpoint (or close()) joins.
        Write ordering guarantees the previous checkpoint survives a
        torn snapshot write either way."""
        self._ckpt_join()
        # Learn the operator's checkpoint cadence for compaction
        # pacing (_compact_beat escalates toward the next barrier).
        base = max(self.checkpoint_op, self._ckpt_last_op)
        if self.op > base:
            self._ckpt_interval_observed = self.op - base
        with self.tracer.span("checkpoint", op=self.commit_min):
            with self.tracer.span(
                "ckpt_freeze", op=self.commit_min
            ), self._h_ckpt_freeze.time():
                args = self._checkpoint_freeze()
            self._ckpt_last_op = self.commit_min
            if self._ckpt_worker is not None:
                self._stats["stat_ckpt_async"].inc()
                self._ckpt_job = self._ckpt_worker.submit(
                    self._checkpoint_finalize, *args
                )
            else:
                self._stats["stat_ckpt_sync"].inc()
                self._checkpoint_finalize(*args)

    def _ckpt_join(self) -> None:
        """Barrier: wait for the in-flight async flip (if any).  Must
        run before anything that reads or writes the superblock, and
        before the next freeze."""
        job, self._ckpt_job = self._ckpt_job, None
        if job is not None:
            job.result()

    def close(self) -> None:
        """Join in-flight background work (async checkpoint flip, WAL
        sync, queued grid block writes) and stop the workers.
        Idempotent."""
        self._ckpt_join()
        self._join_wal_sync()
        if self.forest is not None:
            # Spill and merge beats since the last checkpoint queue block
            # writes on the grid's writer thread; they land before the
            # caller closes the storage under them (the reference leaves
            # them queued).
            self.forest.grid.flush_writes()
        if self._ckpt_worker is not None:
            self._ckpt_worker.close()
        if self._wal_sync_worker is not None:
            self._wal_sync_worker.close()

    def _checkpoint_freeze(self):
        """Foreground half: bring the LSM tier + snapshot blob to a
        consistent image of commit_min and stage it in the grid zone
        (buffered writes).  Returns the finalize args — everything the
        background flip needs, captured now so later commits cannot
        skew it."""
        head = self.journal.read_prepare(self.commit_min)
        if head is not None:
            head_checksum = wire.u128(head[0], "checksum")
        else:
            # Latent sector error on the checkpoint-head slot, found
            # before the paced scrubber reached it: the in-memory
            # redundant ring still holds the committed header — use
            # its checksum (peer repair heals the slot asynchronously).
            slot = self.journal.slot_for_op(self.commit_min)
            mem = self.journal.headers[slot]
            assert int(mem["op"]) == self.commit_min and int(
                mem["command"]
            ) == wire.Command.prepare, "checkpoint head unrecoverable"
            head_checksum = wire.u128(mem, "checksum")

        if self.forest is not None:
            # Spill frozen state into LSM grid blocks first so the
            # snapshot blob covers only the RAM tail (O(delta)).
            with self.tracer.span("lsm_spill"):
                self.sm.checkpoint_spill()

        blob = self._take_snapshot()
        # The state root is part of the frozen image: captured here —
        # the snapshot encode drained the state machine, so the
        # incremental commitment is exactly commit_min's — and flipped
        # into the superblock with the rest of the checkpoint
        # references (recovery recomputes-and-asserts it; the VOPR
        # compares it cross-replica).
        state_root = (
            int.from_bytes(self.sm.state_root(), "little")
            if hasattr(self.sm, "state_root")
            else 0
        )
        region = int(self.superblock.working["sequence"]) % 2
        offset = self._grid_region_offset(region, len(blob))
        self._write_grid(offset, blob)
        return (
            self.commit_min, head_checksum, offset, len(blob),
            wire.checksum(blob), self.view, self.epoch,
            list(self.members) if self.members is not None else None,
            state_root,
        )

    def _checkpoint_finalize(self, commit_min, head_checksum, offset,
                             size, blob_checksum, view, epoch,
                             members, state_root) -> None:
        """Disk half (checkpoint worker in async mode): everything the
        new superblock references must be durable before the flip."""
        with self._h_ckpt_finalize.time():
            self._checkpoint_finalize_impl(
                commit_min, head_checksum, offset, size, blob_checksum,
                view, epoch, members, state_root,
            )

    def _checkpoint_finalize_impl(self, commit_min, head_checksum, offset,
                                  size, blob_checksum, view, epoch,
                                  members, state_root) -> None:
        if self.aof is not None:
            # The AOF is a recovery stream: make it durable at least as
            # often as checkpoints (reference: src/aof.zig fsyncs).
            self.aof.sync()
        if self.forest is not None:
            # Outstanding async block writes must be on disk before
            # the sync that the new superblock's references rely on.
            self.forest.grid.flush_writes()
            # Paced chunked writeback first — ASYNC MODE ONLY: one
            # monolithic grid fdatasync monopolizes the device and the
            # ack path's WAL fsyncs queue behind it for its whole
            # duration (the commit-p99 spike this worker exists to
            # remove).  Inline (TB_CKPT_ASYNC=0) there is no
            # concurrent WAL fsync to protect, and the chunk pauses
            # would just lengthen the commit-loop stall.  Durability
            # still comes from sync().
            paced = getattr(self.storage, "sync_grid_paced", None)
            if paced is not None and self._ckpt_worker is not None:
                paced()
        self.storage.sync()

        self.superblock.checkpoint(
            commit_min=commit_min,
            commit_min_checksum=head_checksum,
            commit_max=commit_min,
            checkpoint_offset=offset,
            checkpoint_size=size,
            checkpoint_checksum=blob_checksum,
            view=view,
            epoch=epoch,
            members=members,
            state_root=state_root,
        )
        self.checkpoint_op = commit_min
        # Deliberately NOT releasing the free-set quarantine here: the
        # flip lands at a nondeterministic WALL time, and letting it
        # steer allocation would diverge grid layouts across replicas
        # (beat allocation must stay a pure function of the commit
        # stream — block-level peer repair relies on byte-identical
        # grids).  The quarantine clears at the NEXT freeze instead
        # (FreeSet.checkpoint replaces it), which the _ckpt_join
        # barrier guarantees is after this flip is durable.

    def _grid_region_offset(self, region: int, blob_len: int) -> int:
        if self.forest is not None:
            # Fixed reservation: the forest's block region starts at
            # 2 * SNAPSHOT_SPAN (spilling keeps blobs bounded).
            assert blob_len <= SNAPSHOT_SPAN, "snapshot exceeds reservation"
            return self.storage.layout.grid_offset + region * SNAPSHOT_SPAN
        # Region B starts past the largest blob either region has held;
        # sized live from the current blob and the previous checkpoint.
        prev = int(self.superblock.working["checkpoint_size"])
        span = _sectors(max(blob_len, prev, 1 << 20))
        return self.storage.layout.grid_offset + region * span

    def _take_snapshot(self) -> bytes:
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        sessions = self.sessions
        cl = np.zeros((len(sessions), 2), np.uint64)  # u128 client ids
        meta = np.zeros((len(sessions), 4), np.uint64)
        headers = []
        for i, (client, s) in enumerate(sessions.items()):
            cl[i, 0] = client & ((1 << 64) - 1)
            cl[i, 1] = client >> 64
            # meta[3]: registered-but-unreplied sessions carry an empty
            # reply_header; encode presence explicitly.
            meta[i] = (s.session, s.request, s.slot, 1 if s.reply_header else 0)
            assert len(s.reply_header) in (0, HEADER_SIZE)
            headers.append(
                s.reply_header if s.reply_header else bytes(HEADER_SIZE)
            )
        return snapcodec.encode(
            {
                "sm": self.sm.snapshot(),
                "clients": cl,
                "session_meta": meta,
                "reply_headers": b"".join(headers),
                "next_reply_slot": self._next_reply_slot,
                # Committed membership is part of the checkpoint state:
                # a state-synced replica jumps commit_min past the
                # reconfigure ops themselves, and without the epoch it
                # would reject every later epoch as stale — diverging
                # reconfigure replies cluster-wide (VOPR reconfigure
                # nemesis, seed 300661417).
                "epoch": self.epoch,
                "members": bytes(self.members or []),
            }
        )

    def _restore_snapshot(self, blob: bytes) -> None:
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        state = snapcodec.decode(blob)
        self.sm.restore(state["sm"])
        self.sessions = {}
        headers = state["reply_headers"]
        for i in range(len(state["clients"])):
            client = int(state["clients"][i, 0]) | (
                int(state["clients"][i, 1]) << 64
            )
            self.sessions[client] = Session(
                session=int(state["session_meta"][i, 0]),
                request=int(state["session_meta"][i, 1]),
                reply_header=(
                    headers[i * HEADER_SIZE : (i + 1) * HEADER_SIZE]
                    if int(state["session_meta"][i, 3])
                    else b""
                ),
                slot=int(state["session_meta"][i, 2]),
            )
        self._next_reply_slot = state["next_reply_slot"]
        epoch = int(state.get("epoch", 0))
        members = list(state.get("members", b""))
        if epoch and members:
            self._install_committed(epoch, members)

    def _write_grid(self, offset: int, blob: bytes) -> None:
        self.storage.write(offset, blob.ljust(_sectors(len(blob)), b"\x00"))

    def _read_grid(self, offset: int, size: int) -> bytes:
        return self.storage.read(offset, _sectors(size))[:size]
