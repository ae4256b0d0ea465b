"""Multi-replica VSR consensus (Viewstamped Replication Revisited).

This package's own copy of ``tigerbeetle_tpu/vsr/multi.py``.

Message-driven port of the reference's replica protocol (reference:
src/vsr/replica.zig — on_request :1494, on_prepare :1557, on_prepare_ok
:1670, commit piggybacking :1792, DVC quorum :9779) on top of the
single-replica commit pipeline in replica.py.  Protocol facts kept:

- Ring replication: the primary sends each prepare to its successor
  only; every backup forwards to the next while journaling in parallel
  (reference: src/vsr/replica.zig:1532-1556).
- Replication quorum: majority of replicas, capped by
  `quorum_replication_max` (reference: src/config.zig:151,
  docs/about/performance.md:48-53).
- Pipeline: up to `pipeline_prepare_queue_max` prepares in flight
  (reference: src/config.zig:149).
- Backups learn commits from the `commit` number piggybacked on later
  prepares plus a periodic commit heartbeat.
- View change: start_view_change broadcast -> do_view_change quorum at
  the new primary (which adopts the longest log of the highest
  log_view) -> start_view installs the canonical tail everywhere.
  View/log_view are persisted to the superblock before participating
  in the new view.
- Repair: `request_prepare(op, checksum)` fetches missing/corrupt
  prepares from peers (reference: src/vsr/replica.zig:2259-2497).

Everything is deterministic: no threads, no wall clock — `tick()`
advances timeouts and the bus delivers messages, so the in-process
cluster (testing/cluster.py) reproduces any seed exactly, the same way
the reference's VOPR does (reference: src/testing/cluster.zig:56-70).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from tigerbeetle_tpu_torch import constants, envcheck, types
from tigerbeetle_tpu_torch.obs import stat_property as obs_stat_property
from tigerbeetle_tpu_torch.state_machine import demuxer
from tigerbeetle_tpu_torch.vsr import superblock as superblock_mod
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.clock import Clock
from tigerbeetle_tpu_torch.vsr.replica import Replica, Session
from tigerbeetle_tpu_torch.vsr.wire import Command, VsrOperation

# Timeout cadences, in ticks (reference tunes these in src/constants.zig;
# ratios preserved: heartbeat << view-change timeout).
PING_TICKS = 2
# Election timeout: ~5s of primary silence (TICK_NS = 10ms).  This must
# comfortably exceed the primary's worst-case scheduling + commit stall
# — an 8190-event durable commit beat runs ~60-100ms, a checkpoint
# several hundred, and on a single-core host
# co-located replicas legitimately starve each other for over a second
# — or loaded clusters thrash through spurious view changes (observed:
# the replicated benchmark stalling seconds per false election at the
# original 100ms setting).  Deterministic simulation tests drive ticks
# directly, so this only prices real-time failover.
VIEW_CHANGE_TICKS = 500
VIEW_CHANGE_RESEND_TICKS = 4
REPAIR_RETRY_TICKS = 3
# Scrub one block probe per interval: a full cycle over a 4k-block
# grid takes ~minutes at 10ms ticks, matching the reference's
# hours-per-cycle pacing philosophy scaled to test horizons.
SCRUB_INTERVAL_TICKS = 8



# Sentinel: the in-flight request set cannot be determined yet.
UNDECIDABLE = object()

# Virtual tick length for the per-replica monotonic clock; shared with
# the simulator's wall-clock step and the server's tick cadence so
# clock-sync RTT math stays consistent.
TICK_NS = constants.TICK_NS


@dataclasses.dataclass
class PipelineEntry:
    header: np.ndarray
    body: bytes
    ok_replicas: set[int]
    # Logical batch sub-requests [(client, request, event_count)] when
    # this prepare multiplexes several client requests (see
    # state_machine/demuxer.py); None for plain prepares.
    subs: list[tuple[int, int, int]] | None = None
    # False while the PRIMARY's own WAL write for this op is not yet
    # covered by a sync (group commit): the self-vote in ok_replicas
    # must not count toward a commit until then — committing earlier
    # would let commit_min (which rides UNGATED heartbeats and prepare
    # headers) advertise an op with one durable copy fewer than the
    # quorum promises.  flush_group_commit marks entries synced.
    synced: bool = True


class VsrReplica(Replica):
    """A replica wired to a message bus.

    `bus.send(dst_replica, header, body)` / `bus.send_client(client_id,
    header, body)` deliver messages; the harness calls `on_message` and
    `tick`.
    """

    def __init__(self, storage, cluster, state_machine, bus, *,
                 replica: int, replica_count: int,
                 standby_count: int = 0,
                 release: int = 1,
                 releases_available: tuple[int, ...] = (1,),
                 aof=None) -> None:
        super().__init__(storage, cluster, state_machine,
                         replica=replica, replica_count=replica_count,
                         aof=aof)
        self.bus = bus
        # Standbys (reference: replicas beyond replica_count in the
        # cluster topology): journal prepares, commit, repair, and
        # state-sync like backups, but never ack (prepare_ok), never
        # vote in view changes, and never become primary — hot spares
        # that don't count toward (or endanger) any quorum.
        self.standby_count = standby_count
        self.standby = replica >= replica_count
        self.status = "recovering"
        self.log_view = 0
        # Identity membership until a reconfigure op (or a restored
        # superblock) says otherwise: slot k is process k.
        self.members = list(range(replica_count + standby_count))

        # Multiversion upgrades (reference: src/vsr/replica.zig:4298
        # replica_release_execute, Operation.upgrade, `release` in every
        # header).  `release` is what we RUN; `releases_available` is
        # what the installed binary bundle COULD run.  Peers advertise
        # their max available release on pings; when every replica can
        # run something newer, the primary replicates an upgrade op,
        # and committing it sets upgrade_target — the process then
        # re-executes into the new release (the harness/operator
        # restarts it with release=target).
        assert release in releases_available
        self.release = release
        self.releases_available = tuple(sorted(releases_available))
        self.peer_release: dict[int, int] = {
            replica: max(self.releases_available)
        }
        self.upgrade_target: int | None = None
        self._upgrade_proposed = False

        majority = replica_count // 2 + 1
        self.quorum_replication = min(
            majority, self.config.quorum_replication_max
        )
        self.quorum_view_change = majority

        self.pipeline: dict[int, PipelineEntry] = {}
        self.request_queue: list[tuple[np.ndarray, bytes]] = []
        self._queued_keys: set[tuple[int, int]] = set()
        # Admission control (runtime/server.py sets both): bound on
        # the request queue — None = unbounded (sim clusters) — and
        # an owner callback fired per shed (counters, flight ring).
        self.admit_queue: int | None = None
        self.on_shed = None
        # Multi-tenant QoS (qos.TenantQos): tenant-keyed
        # admission + weighted-fair drain.  None (the TB_TENANT_QOS=0
        # path) keeps every queue operation on the legacy single-FIFO
        # code exactly.  When set, `_queue_tenants` mirrors
        # request_queue entry-for-entry with each request's tenant
        # (ledger), so per-tenant depths and the WFQ pick index are
        # one list scan over small ints, bounded by admit_queue.
        self.qos = None
        self._queue_tenants: list[int] = []
        # tenant -> queued-request count, maintained incrementally on
        # enqueue/pop/clear: admission and the busy payload read a
        # tenant's depth per fresh request, and a list .count() there
        # would put an O(admit_queue) scan on the ingest hot path.
        self._tenant_depth: dict[int, int] = {}
        self._last_pop_tenant: int | None = None
        # Weighted-fair drain engages only inside an OVERLOAD EPISODE:
        # the first shed opens it, the queue running empty closes it.
        # Outside an episode the queue is strict FIFO and batch
        # lookahead reads the global head — bit-identical to the
        # TB_TENANT_QOS=0 path (the differential contract: QoS on
        # under non-overload load must not reorder anything).
        self._qos_episode = False

        # Cluster clock synchronization (reference: src/vsr/clock.zig).
        self.clock = Clock(replica, replica_count)
        # Local monotonic ns: tick-advanced in the simulator; a real
        # runtime sets monotonic_external and feeds time.monotonic_ns()
        # so RTT error bounds reflect real elapsed time.
        self.monotonic = 0
        self.monotonic_external = False

        # Timers.
        self._ticks = 0
        self._last_primary_seen = 0
        self._last_ping_sent = 0
        self._last_clock_ping = 0
        self._vc_last_sent = 0
        self._repair_last_sent = 0
        self._sync_last_requested = -10**9

        # Grid scrubber + automated peer block repair (reference:
        # src/vsr/grid_scrubber.zig, src/vsr/grid_blocks_missing.zig).
        # The forest writes grid blocks only at checkpoint and
        # checkpoints are byte-identical cluster-wide, so any peer at
        # the same checkpoint_op holds an intact copy of every live
        # block.
        self.scrubber = None
        if self.forest is not None:
            from tigerbeetle_tpu_torch.vsr.scrubber import GridScrubber

            # Pace a full tour across ~4096 scrub ticks, one small
            # read burst each (reference cycle pacing).
            self.scrubber = GridScrubber(
                self.forest.grid, cycle_ticks=4096, blocks_per_tick_max=8
            )
            # Scrub progress rides the registry as pull gauges: the
            # scrubber owns its tour counters; snapshots read them.
            scrubber = self.scrubber
            self.metrics.gauge_fn(
                "scrub.blocks_verified", lambda: scrubber.blocks_verified
            )
            self.metrics.gauge_fn("scrub.cycles", lambda: scrubber.cycles)
            self.metrics.gauge_fn(
                "scrub.faults_found", lambda: scrubber.faults_found
            )
        self._blocks_missing: set[int] = set()
        self._block_repair_last = -10**9
        self._block_repair_attempt = 0
        self._stats["stat_blocks_repaired"] = self.metrics.counter(
            "blocks_repaired"
        )
        # WAL scrubber: probes committed journal slots for latent
        # sector errors, self-healing the redundant header ring from
        # memory and fetching corrupt prepares from peers pinned by
        # their canonical checksum.
        self._wal_scrub_cursor = 0
        self._wal_scrub_attempt = 0
        self._wal_scrub_wanted: dict[int, int] = {}
        self._stats["stat_wal_scrub_repaired"] = self.metrics.counter(
            "wal_scrub_repaired"
        )
        # Canonical vouches: op -> checksum of the prepare the current
        # view's history assigns to that op.  The commit path executes
        # an op ONLY with a matching vouch — the parent-linkage check
        # alone cannot reject a stale SIBLING (same parent, different
        # content, e.g. an old primary's pulse superseded by a view
        # change: VOPR seed 8005).  Vouch sources: own prepares
        # (primary), accepted current-view prepares (self + their
        # parent), heartbeat commit checksums, start_view / DVC
        # canonical headers, checksum-pinned repairs.  View transitions
        # clear vouches above commit_min.
        self._vouched: dict[int, int] = {}
        self._installed_canonical: list[np.ndarray] = []
        # The superblock's persisted canonical suffix covers the
        # pipeline-deep HEAD of the uncommitted range, not all of it:
        # under stalled commits (commit_min, op] can grow to
        # journal_slot_count >> the suffix, and overflow truncation
        # then drops coverage of the deeper ops — those are protected
        # by the DVC merge sanitize + canonical-vouch chain walk, as
        # in the reference.  Mirror the reference's invariant family
        # (constants.zig: view_change_headers_max >= pipeline + 3 and
        # <= journal_slot_count) so a config change can't silently
        # shrink the suffix below what the head-anchoring needs.
        assert (
            superblock_mod.VIEW_HEADERS_MAX
            >= self.config.pipeline_prepare_queue_max + 3
        ), "view_headers suffix must cover the pipeline-deep head (+3)"
        assert (
            superblock_mod.VIEW_HEADERS_MAX
            <= self.config.journal_slot_count
        ), "view_headers suffix cannot exceed the journal"
        self._last_retransmit = 0
        self._repair_round = 0

        # Pending canonical-log install after passively entering a view
        # (commits gated until start_view arrives).
        self._canon_pending = False
        # True when we are primary but the canonical head's checksum is
        # unknown (the DVC merge proved ops through op_head committed
        # yet no header for op_head survived into it): preparing new
        # ops against a stale parent_checksum would bake a chain break
        # into the committed log (VOPR seed 170611267), so every
        # prepare path holds until the head is resolved + repaired.
        self._anchor_pending = False
        # View of the header that currently resolves the anchor pin:
        # replies are collected from ALL peers and a higher-view
        # header re-pins, so a single stale peer cannot fix the anchor
        # to a superseded sibling.
        self._anchor_pin_view = -1
        # True while the journal chain between commit_min and the head
        # is not fully verified (stale siblings possible): commits wait.
        self._chain_suspect = False
        # View-change state.
        self._svc_votes: dict[int, set[int]] = {}   # view -> replicas
        self._dvc: dict[int, dict] = {}             # replica -> dvc payload
        # Repair state: op -> checksum we want.
        self._repair_wanted: dict[int, int] = {}
        # Stashed out-of-order prepares: op -> (header, body).
        self._stash: dict[int, tuple[np.ndarray, bytes]] = {}
        # State-sync chunk assembly: blob checksum -> {index: bytes}.
        self._sync_chunks: dict[int, dict[int, bytes]] = {}
        # Throttle: dst replica -> tick of last sync blob sent.
        self._sync_sent: dict[int, int] = {}

        # WAL group commit (deferred-sync): prepares append to the WAL
        # unsynced; ONE covering fdatasync per poll-drain (or per
        # TB_GROUP_COMMIT_MAX_US deadline) is issued by
        # flush_group_commit() BEFORE any prepare_ok / client reply it
        # covers leaves the process — up to a pipeline's worth of
        # prepares share a single durability syscall instead of paying
        # one each.  Only on backends whose deferred sync is crash
        # -equivalent (FileStorage); the deterministic MemoryStorage
        # clusters keep the synchronous path (tests opt in per
        # -instance via storage.supports_deferred_sync).
        self.group_commit_max_us = envcheck.group_commit_max_us()
        self._gc_enabled = (
            bool(getattr(storage, "supports_deferred_sync", False))
            and self.group_commit_max_us > 0
        )
        # Deferred outbound acks: (kind, dst, header, body) released in
        # order by flush_group_commit() after the covering sync.
        self._gc_pending: list[tuple[str, object, np.ndarray, bytes]] = []
        # Leading-edge covering sync riding the WAL worker (disk wait
        # overlaps the drain's commit CPU work) + how many deferred
        # writes it covers.
        self._gc_sync_job = None
        self._gc_sync_cover = 0
        # Sampled trace ids whose WAL writes await the covering sync
        # (drained and stage-stamped by _gc_covering_sync).
        self._gc_trace_ids: list[int] = []
        self._stats["stat_prepares_written"] = self.metrics.counter(
            "prepares_written"
        )
        self._stats["stat_gc_flushes"] = self.metrics.counter("gc_flushes")
        self._h_gc_sync = self.metrics.histogram("gc.sync_us")
        self._c_gc_deferred_acks = self.metrics.counter("gc.deferred_acks")

        # Native commit pipeline: per-prepare header
        # construction, journal append framing, the in-flight slot
        # table, and the group-commit gate run in
        # native/tb_pipeline.cpp when available; this replica keeps
        # orchestration (view changes, checkpoints, recovery) and the
        # Python pipeline dict stays authoritative for everything the
        # slow paths scan (retransmit, eviction, view-change DVC).
        # The C table mirrors the dict by pairing every mutation site;
        # TB_NATIVE_PIPELINE=0 pins the pure-Python arm bit-identically.
        from tigerbeetle_tpu_torch.runtime import fastpath as _fastpath

        self._np = (
            _fastpath.create_pipeline()
            if envcheck.native_pipeline() == 1
            else None
        )
        # Per-prepare Python wall time (µs) on the primary's hot path —
        # the `decode_us_per_event`-style instrument the native arm is
        # graded against.  The replica registry grafts into the server
        # snapshot under "vsr.", so these scrape as vsr.prepare_us /
        # vsr.prepare_ok_us.  prepare_us times the primary's header
        # build + pipeline bookkeeping; prepare_ok_us times the
        # backup's ack build (body-independent, so the native-vs-
        # Python delta stays visible under group-commit coalescing).
        # unit_scale=16 widens the sub-µs floor (1/16-µs buckets below
        # 1 µs) so the native drain's amortized per-prepare cost stays
        # resolvable instead of collapsing into bucket 0.
        self._h_prepare_us = self.metrics.histogram("prepare_us",
                                                    unit_scale=16)
        self._h_prepare_ok_us = self.metrics.histogram("prepare_ok_us",
                                                       unit_scale=16)

        # C-resident drain loop: whole prepare/ack runs
        # cross into native/tb_pipeline.cpp as ONE call per batch seam
        # (tb_pl_build_prepares / tb_pl_accept_prepares / tb_pl_on_acks
        # / tb_pl_commit_ready_run) — Python keeps the per-BATCH
        # orchestration plus every slow path (dedupe misses, QoS
        # shedding, view change, checkpoint, recovery, commit
        # execution).  TB_NATIVE_DRAIN=0 pins the per-item loop over
        # the SAME batch seams, so the 0/1 frames are structurally
        # bit-identical.  native_calls counts batch C crossings;
        # py_fallbacks counts items that took a per-item arm while the
        # drain loop was on (ineligible run, non-gc mode, arena
        # overflow) — the "one call per drain" scrape assertion.
        self._c_drain_native = self.metrics.counter("drain.native_calls")
        self._c_drain_fallback = self.metrics.counter("drain.py_fallbacks")
        # Hash-once counters (_c_hash_bytes / _c_hash_reuse /
        # _c_hash_commit, _hash_reuse) are inherited from the base
        # Replica __init__ — see vsr/replica.py for the counting
        # contract.
        self._drain_native = False
        if envcheck.native_drain() == 1:
            err = _fastpath.drain_error()
            if err is not None and envcheck.env_is_set("TB_NATIVE_DRAIN"):
                # Explicit TB_NATIVE_DRAIN=1 against a loaded-but-
                # stale library: fail fast with the rebuild hint (the
                # forensics extended to the batch symbols).
                raise RuntimeError(err)
            self._drain_native = (
                err is None
                and self._np is not None
                and _fastpath.drain_available()
            )

    # Compatibility properties over the registry handles (obs).
    stat_blocks_repaired = obs_stat_property("stat_blocks_repaired")
    stat_wal_scrub_repaired = obs_stat_property("stat_wal_scrub_repaired")
    stat_prepares_written = obs_stat_property("stat_prepares_written")
    stat_gc_flushes = obs_stat_property("stat_gc_flushes")

    # ------------------------------------------------------------------

    def primary_index(self, view: int | None = None) -> int:
        return (self.view if view is None else view) % self.replica_count

    # ------------------------------------------------------------------
    # Reconfiguration (reference: src/vsr.zig:273-311): protocol slots
    # are stable; a committed epoch bump re-assigns which PROCESS fills
    # each slot (standby promotion: swap a dead active's slot with a
    # standby's — the standby has been replicating all along, so it
    # carries the state its new active role needs).

    def _member_total(self) -> int:
        return self.total_count

    def _apply_membership(self, members: list[int]) -> None:
        members = list(members)
        slot = members.index(self.process_index)
        self.replica = slot
        self.standby = slot >= self.replica_count
        if hasattr(self.bus, "set_slot_map"):
            self.bus.set_slot_map(members)
        # Clock samples are slot-keyed; restart sampling under the new
        # identity (commits gate on resynchronization, briefly).
        self.clock = Clock(slot, self.replica_count)
        self.peer_release = {slot: max(self.releases_available)}

    @property
    def is_primary(self) -> bool:
        return self.status == "normal" and self.primary_index() == self.replica

    def open(self, *, replay_tail: bool | None = None) -> None:
        super().open(replay_tail=replay_tail)
        self.log_view = int(self.superblock.working["log_view"])
        self.status = "normal"
        self.commit_max = self.commit_min
        # Restore the durable canonical-log claim: journal recovery
        # can understate it (prepares never fetched before the crash),
        # and an understating DVC let a view-change quorum truncate
        # committed ops (VOPR seed 1064614514).  Missing bodies repair
        # through the rejoin below.
        recovered_head = self.op
        self.op = max(self.op, int(self.superblock.working["op_claimed"]))
        if self.op > recovered_head:
            # The claimed head's prepare is not in our journal: the
            # anchor is unknown, and a chain walk from the recovered
            # head's checksum would derive garbage pins.  Hold until
            # the head resolves (pin 0 -> request_headers -> repair).
            self._anchor_pending = True
            self._repair_wanted[self.op] = 0
            self._anchor_pin_view = -1
        # An unexecuted journal tail above the checkpoint must be
        # confirmed by the cluster before this replica may commit or
        # serve: rejoin through a view change, whose DVC quorum
        # establishes the canonical log (VSR recovery — the reference's
        # .recovering_head rejoins the same way).
        self._recovering_tail = (
            self.replica_count > 1 and self.op > self.commit_min
        )

    # ------------------------------------------------------------------
    # Tick: timeouts.

    def tick(self) -> None:
        self._ticks += 1
        if self._recovering_tail:
            self._recovering_tail = False
            if self.primary_index() == self.replica:
                # We'd be the primary: only a DVC round can establish
                # the canonical log.
                self._start_view_change(self.view + 1)
            else:
                # Non-disruptive rejoin: gate commits and ask the live
                # primary for the canonical view state; the normal
                # heartbeat timeout escalates to a view change if the
                # primary is gone.
                self._canon_pending = True
                self._request_start_view()
        if not self.monotonic_external:
            self.monotonic += TICK_NS
        if self.total_count > 1 and not self.standby:
            # Pings double as release advertisement, so a solo active
            # with standbys still pings (upgrades gate on EVERY
            # process's release, standbys included).
            if self._ticks - self._last_clock_ping >= PING_TICKS:
                self._send_clock_pings()
            self.clock.expire(self.monotonic)
        if self.status == "normal":
            if self.is_primary:
                if self._ticks - self._last_ping_sent >= PING_TICKS:
                    self._send_heartbeat()
                self._drain_request_queue()
                self._maybe_pulse()
                self._maybe_propose_upgrade()
                if self.pipeline and (
                    self._ticks - self._last_retransmit >= REPAIR_RETRY_TICKS
                ):
                    self._retransmit_pipeline()
            else:
                if self._ticks - self._last_primary_seen >= VIEW_CHANGE_TICKS:
                    if self.standby:
                        # Cannot vote a new view in: poll the actives
                        # for the canonical state instead.
                        self._last_primary_seen = self._ticks
                        self._request_start_view()
                    else:
                        self._start_view_change(self.view + 1)
        elif self.status == "view_change":
            if self._ticks - self._vc_last_sent >= VIEW_CHANGE_RESEND_TICKS:
                self._broadcast_svc()
        if self._repair_wanted and (
            self._ticks - self._repair_last_sent >= REPAIR_RETRY_TICKS
        ):
            self._send_repair_requests(force=True)
        if self.status == "normal" and self._ticks % SCRUB_INTERVAL_TICKS == 0:
            self._wal_scrub_tick()
        if self.scrubber is not None and self.status == "normal":
            if self._ticks % SCRUB_INTERVAL_TICKS == 0:
                self._blocks_missing.update(self.scrubber.tick())
            if self._blocks_missing and self.replica_count > 1 and (
                self._ticks - self._block_repair_last >= REPAIR_RETRY_TICKS
            ):
                self._send_request_blocks()
        if (
            self._canon_pending
            and self.status == "normal"
            and self._ticks % VIEW_CHANGE_RESEND_TICKS == 0
        ):
            self._request_start_view()

    def _retransmit_pipeline(self) -> None:
        """Re-send the lowest non-quorate prepare directly to every
        backup: recovers lost prepares and routes around a broken ring
        (reference repairs these via request_prepare timeouts)."""
        self._last_retransmit = self._ticks
        op = min(self.pipeline)
        entry = self.pipeline[op]
        for r in range(self.replica_count):
            if r != self.replica and r not in entry.ok_replicas:
                self.bus.send(r, entry.header, entry.body)

    def _prepare_headroom(self, pending: int = 0) -> bool:
        """True while the NEXT prepare's ring slot would not overwrite
        an op above the checkpoint.  Replay and repair need every op in
        (checkpoint_op, op]; without this bound a commit stall plus
        repeated view changes (each clears the pipeline, letting a new
        primary accept another pipeline's worth of requests) pushed op
        67 past the stuck commit point and the ring wrap destroyed the
        only copies of two uncommitted ops cluster-wide (VOPR seed
        202019721).  `pending` counts plan-deferred prepares that have
        not advanced self.op yet (the drain plan)."""
        return (
            self.op + pending + 1
            <= self.checkpoint_op + self.config.journal_slot_count
        )

    def _maybe_propose_upgrade(self) -> None:
        """Replicate Operation.upgrade once EVERY replica advertises a
        release newer than the one we run (reference: the primary
        coordinates the upgrade so the cluster switches atomically at
        one op)."""
        if self._upgrade_proposed or self.upgrade_target is not None:
            return
        if self.replica_count > 1 and not self.clock.synchronized:
            return  # same clock gate as every other prepare path
        if len(self.peer_release) < self.total_count:
            return
        target = min(self.peer_release.values())
        if target <= self.release:
            return
        if len(self.pipeline) >= self.config.pipeline_prepare_queue_max:
            return
        if self._anchor_pending:
            return  # canonical head checksum still being repaired
        if not self._prepare_headroom():
            return
        self._upgrade_proposed = True
        req = wire.make_header(
            command=Command.request, operation=VsrOperation.upgrade,
            cluster=self.cluster, view=self.view,
        )
        body = int(target).to_bytes(8, "little")
        wire.finalize_header(req, body)
        self._primary_prepare(req, body)

    def _maybe_pulse(self) -> None:
        """Self-clocked expiry (reference: src/vsr/replica.zig:3126-3143):
        the primary turns due timeouts into a replicated pulse op."""
        if len(self.pipeline) >= self.config.pipeline_prepare_queue_max:
            return
        if self.replica_count > 1 and not self.clock.synchronized:
            return  # same clock gate as client requests
        if self._anchor_pending:
            return  # canonical head checksum still being repaired
        if not self._prepare_headroom():
            return
        self._advance_prepare_timestamp()
        if not self.sm.pulse_needed():
            return
        req = wire.make_header(
            command=Command.request, operation=types.Operation.pulse,
            cluster=self.cluster, view=self.view,
        )
        wire.finalize_header(req, b"")
        self._primary_prepare(req, b"")

    @property
    def total_count(self) -> int:
        """Actives + standbys."""
        return self.replica_count + self.standby_count

    def _send_heartbeat(self) -> None:
        self._last_ping_sent = self._ticks
        # Body: freshest ADOPTED membership advertisement (see
        # _on_commit — committed epoch moves only via the op stream).
        body = self._membership_advert()
        h = wire.make_header(
            command=Command.commit, cluster=self.cluster, view=self.view,
            replica=self.replica, commit=self.commit_min,
            # Canonical checksum of the prepare at commit_min, so
            # backups vouch their local copy before executing
            # (reference: Command.commit carries commit_checksum).
            context=self.commit_parent or 0,
        )
        wire.finalize_header(h, body)
        for r in range(self.total_count):
            if r != self.replica:
                self.bus.send(r, h, body)

    # ------------------------------------------------------------------
    # Message dispatch.

    def on_message(self, header: np.ndarray, body: bytes,
                   verified: bool = False) -> None:
        # `verified=True`: the server's drain already ran the checksum
        # verification (columnar batch pass) — re-hashing every body
        # here doubled the per-message decode cost for years.
        if not verified and not wire.verify_header(header, body):
            return
        if wire.u128(header, "cluster") != self.cluster:
            return
        try:
            cmd = Command(int(header["command"]))
        except ValueError:
            # Unknown command byte (e.g. a client_busy shed bounced
            # off a forwarded request, or a newer peer): drop, never
            # crash the protocol loop.
            return
        handler = {
            Command.request: self._on_request_msg,
            Command.prepare: self._on_prepare,
            Command.prepare_ok: self._on_prepare_ok,
            Command.commit: self._on_commit,
            Command.start_view_change: self._on_start_view_change,
            Command.do_view_change: self._on_do_view_change,
            Command.start_view: self._on_start_view,
            Command.request_prepare: self._on_request_prepare,
            Command.request_headers: self._on_request_headers,
            Command.headers: self._on_headers,
            Command.request_start_view: self._on_request_start_view,
            Command.request_sync_checkpoint: self._on_request_sync,
            Command.sync_checkpoint: self._on_sync_checkpoint,
            Command.request_blocks: self._on_request_blocks,
            Command.block: self._on_block,
            Command.ping: self._on_ping,
            Command.pong: self._on_pong,
        }.get(cmd)
        if handler is not None:
            handler(header, body)

    # ------------------------------------------------------------------
    # Normal operation: primary.

    def _on_request_msg(self, header: np.ndarray, body: bytes) -> None:
        if self.status != "normal":
            return
        if not self.is_primary:
            # Forward to the primary (clients may have a stale view).
            self.bus.send(self.primary_index(), header, body)
            return
        operation = int(header["operation"])
        if operation in (
            int(VsrOperation.stats), int(VsrOperation.state_root)
        ):
            # Admin scrape / proof-of-state query: answered by the
            # server loop (obs/scrape.py), never prepared — such a
            # request reaching the pipeline would hit the asserting
            # state-machine dispatch at commit.
            return
        if operation >= constants.VSR_OPERATIONS_RESERVED:
            # Malformed client input (unknown op byte, wrong event
            # size, over batch_max) must not reach the state machine's
            # asserting prepare path: drop it here.  Well-behaved
            # clients validate before sending; only a buggy or
            # malicious client hits this.
            try:
                op_enum = types.Operation(operation)
            except ValueError:
                return
            if not self.sm.input_valid(op_enum, body):
                return
        verdict = self._request_dedupe(header)
        if verdict is not None:
            if verdict == "queue":
                self._enqueue_request(header, body)
            else:
                # Duplicate delivery (retransmit / stale number): the
                # ingress verify already hashed this body, and that
                # pass can never be elided — charge it to the dup
                # counter so the reuse ratio stays exact.
                self._c_hash_dup.inc(len(body))
            return
        if (
            len(self.pipeline) >= self.config.pipeline_prepare_queue_max
            or (self.replica_count > 1 and not self.clock.synchronized)
            or self._anchor_pending
            or not self._prepare_headroom()
        ):
            # Pipeline full, no timestamps yet because the cluster
            # clock window doesn't exist (reference: src/vsr/replica.zig
            # on_request gates on realtime_synchronized), or the
            # canonical head checksum is still being repaired: queue
            # and drain from tick()/commit.
            self._enqueue_request(header, body)
            return
        self._primary_prepare(header, body)

    def on_requests_batch(self, headers, bodies) -> None:
        """Columnar request intake (runtime/server.py fast drain): one
        drain's worth of client requests, headers pre-verified and
        decoded in a single batch pass.  Request-level semantics are
        identical to per-message _on_request_msg — at-most-once
        dedupe, admission shed, eviction deferral — but the in-flight
        scan runs ONCE per drain (it walks the pipeline + journal
        tail, and running it per request was O(drain x pipeline)), and
        fresh requests funnel through the queue so one drain drains
        into few multiplexed prepares instead of re-entering the
        prepare path per message."""
        if self.status != "normal":
            return
        # The drain verified checksums, not addressing: a frame for a
        # DIFFERENT cluster must be dropped exactly as on_message
        # drops it (cross-cluster isolation; the legacy arm's behavior).
        keep = [
            i for i, h in enumerate(headers)
            if wire.u128(h, "cluster") == self.cluster
        ]
        if len(keep) != len(headers):
            headers = [headers[i] for i in keep]
            bodies = [bodies[i] for i in keep]
        if not self.is_primary:
            for i, h in enumerate(headers):
                self.bus.send(self.primary_index(), h, bytes(bodies[i]))
            return
        inflight = self._inflight_requests()
        undecidable = inflight is UNDECIDABLE
        # Per-drain dedupe pre-pass: classify the common case —
        # fresh, registered, in-order, not in flight — in one
        # vectorized pass so only exceptions (retransmits, registers,
        # catch-up) walk _request_dedupe's branch ladder.  A True
        # entry is PROVEN to be exactly what _request_dedupe returns
        # None for, with zero side effects skipped; everything else
        # (including a retransmit-of-committed, which must get its
        # stored reply mid-drain, never a busy) drops to the per-
        # request slow path unchanged.
        fast = (
            None if undecidable or not headers
            else self._admit_prepass(headers, inflight)
        )
        for i, h in enumerate(headers):
            operation = int(h["operation"])
            if operation in (
                int(VsrOperation.stats), int(VsrOperation.state_root)
            ):
                continue  # answered by the server loop, never prepared
            body = bytes(bodies[i])
            if operation >= constants.VSR_OPERATIONS_RESERVED:
                try:
                    op_enum = types.Operation(operation)
                except ValueError:
                    continue
                if not self.sm.input_valid(op_enum, body):
                    continue
            if fast is not None and fast[i]:
                verdict = None
            else:
                verdict = self._request_dedupe(h, inflight=inflight)
            if verdict == "drop":
                # Duplicate delivery: its ingress verify pass was
                # unavoidable — charge hash.dup_body_bytes (the reuse
                # ratio's retransmission term), not a reuse miss.
                self._c_hash_dup.inc(len(body))
                continue
            if (
                self.admit_queue is not None
                and len(self.request_queue) >= self.admit_queue
                and len(self.pipeline)
                < self.config.pipeline_prepare_queue_max
                and self._prepare_headroom()
            ):
                # Queue at the admission bound with pipeline room:
                # move what the pipeline can take BEFORE deciding to
                # shed — the per-message path used free pipeline slots
                # directly (they never counted against the queue), so
                # shedding here without draining first would refuse
                # requests the pipeline could hold and diverge the
                # TB_FASTPATH_DECODE arms under overload.  The
                # queue-depth bound itself stays intact (the overload
                # smoke asserts the gauge), and a full pipeline skips
                # the call entirely — draining would no-op after an
                # O(pipeline + tail) in-flight rescan per shed.
                self._drain_request_queue()
            self._enqueue_request(h, body)
            if not undecidable and verdict is None:
                key = (wire.u128(h, "client"), int(h["request"]))
                # Only if actually queued (not shed): a shed duplicate
                # later in the batch must shed again, not "drop".
                if key[0] and key in self._queued_keys:
                    inflight.add(key)
        self._drain_request_queue()

    def _admit_prepass(self, headers, inflight) -> list[bool]:
        """Vectorized fast/slow classification for one drain's request
        batch.  out[i] is True only when request i is
        PROVABLY what _request_dedupe returns None for with no side
        effects: a non-reserved client op from a registered session,
        request number strictly advancing, no catch-up in progress,
        not in flight, and not a duplicate of any earlier request in
        this same batch.  Everything else — registers, retransmits
        (committed → stored reply), stale numbers, eviction candidates
        — stays on the per-request slow path."""
        arr = np.array(headers)
        ok = (
            ((arr["client_lo"] != 0) | (arr["client_hi"] != 0))
            & (arr["operation"] >= constants.VSR_OPERATIONS_RESERVED)
        )
        if self.commit_min != self.commit_max:
            # Catching up: session entries may predate the
            # re-committing suffix — everything goes slow.
            ok[:] = False
        out: list[bool] = []
        seen: set[tuple[int, int]] = set()
        sessions = self.sessions
        lo, hi, req = arr["client_lo"], arr["client_hi"], arr["request"]
        for i in range(len(headers)):
            client = int(lo[i]) | (int(hi[i]) << 64)
            key = (client, int(req[i]))
            fast = bool(ok[i])
            if fast:
                entry = sessions.get(client)
                fast = (
                    entry is not None
                    and key[1] > entry.request
                    and key not in inflight
                    and key not in seen
                )
            # EVERY key joins `seen`: a later copy of any earlier
            # batch item must take the slow path, where the
            # incrementally-updated inflight set (or the shed state)
            # decides — exactly as the per-item arm does.
            if key[0]:
                seen.add(key)
            out.append(fast)
        return out

    def on_prepare_oks_batch(self, headers: list[np.ndarray]) -> None:
        """A contiguous drain run of prepare_ok frames (runtime/
        server.py): vote the whole run through the slot table in ONE C
        call, then run the commit gate once.  Decision-equivalent to
        per-message _on_prepare_ok: acks emit no frames, and
        _maybe_commit_pipeline commits the ready run in op order with
        the same commit->drain interleaving whether entered after each
        vote or after all of them.  TB_NATIVE_DRAIN=0 pins the
        per-message loop over the same seam (bit-identical frames)."""
        if not self.is_primary:
            return  # per-message arm drops each ack identically
        if not (self._drain_native and self._np is not None):
            for h in headers:
                # on_message's cluster gate, then the per-ack handler.
                if wire.u128(h, "cluster") == self.cluster:
                    self._on_prepare_ok(h, b"")
            return
        arr = np.array(headers)
        _accepted, verdicts = self._np.on_acks(arr, self.cluster, self.view)
        self._c_drain_native.inc()
        voted = False
        for i, h in enumerate(headers):
            if int(verdicts[i]) < 0:
                # -4 cluster / -3 view / -1 unknown op / -2 stale
                # sibling: exactly the per-ack drops (on_message's
                # cluster gate + _on_prepare_ok's early returns).
                continue
            entry = self.pipeline.get(int(h["op"]))
            if entry is None:
                continue  # C table ahead of a just-dropped entry
            entry.ok_replicas.add(int(h["replica"]))
            self.anatomy.stage_h(h, "prepare_ok")
            voted = True
        if voted:
            self._maybe_commit_pipeline()

    def on_prepares_batch(self, headers: list[np.ndarray],
                          bodies: list) -> None:
        """A contiguous drain run of prepare frames (runtime/
        server.py): when the WHOLE run is the steady-state shape — our
        view, normal status, sequential ops extending our head with an
        intact parent chain, no stash/anchor interference — frame
        every WAL write and build every prepare_ok in ONE C call, then
        replay the per-item side effects (journal descriptors,
        replicate, ack routing, commit advance) in legacy order.  The
        run splits at the FIRST deviating frame: the eligible prefix
        still takes the one C call, only the suffix (typically a
        stale duplicate from primary retransmission under load) walks
        per-message _on_prepare — a retransmitted copy must not
        demote the fresh frames ahead of it.  TB_NATIVE_DRAIN=0 pins
        the per-message loop over the same seam (bit-identical
        frames)."""
        split = 0
        if (
            self._drain_native
            and self._np is not None
            and self._gc_enabled  # framed writes are unsynced-only
            and self.journal._native_frame
            and self.status == "normal"
            and not self.is_primary
            and not self._anchor_pending
            # A stashed successor could double-accept the run's next
            # op via _drain_stash; per-message handles that ordering.
            and not self._stash
        ):
            op0 = self.op + 1
            parent = self.parent_checksum
            split = len(headers)
            for i, h in enumerate(headers):
                if (
                    wire.u128(h, "cluster") != self.cluster
                    or int(h["view"]) != self.view
                    or int(h["op"]) != op0 + i
                    or wire.u128(h, "parent") != parent
                ):
                    split = i
                    break
                parent = wire.u128(h, "checksum")
        rest_h, rest_b = headers[split:], bodies[split:]
        if rest_h and self._drain_native:
            self._c_drain_fallback.inc(len(rest_h))
        if split == 0:
            for i, h in enumerate(rest_h):
                # on_message's cluster gate, then the per-msg handler.
                if wire.u128(h, "cluster") == self.cluster:
                    self._on_prepare(h, bytes(rest_b[i]))
            return
        headers, bodies = headers[:split], bodies[:split]

        from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
        from tigerbeetle_tpu_torch.runtime import fastpath as _fastpath
        from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR

        self._last_primary_seen = self._ticks
        k = len(headers)
        bodies = [bytes(b) for b in bodies]
        arr = np.array(headers)
        build_oks = not self.standby
        t0 = time.perf_counter_ns()
        accepted = _fastpath.accept_prepares(
            arr, bodies, view=self.view, replica=self.replica,
            build_oks=build_oks,
            headers_ring=self.journal.headers,
            slot_count=self.journal.slot_count,
            headers_per_sector=HEADERS_PER_SECTOR,
            sector_size=SECTOR_SIZE,
        )
        batch_ns = time.perf_counter_ns() - t0
        if accepted is None:
            raise RuntimeError(
                "native drain: accept arena refused exact-sized run"
            )
        self._c_drain_native.inc()
        oks, frames = accepted
        wal_arena, wal_off, wal_len, slots, sector_arena, sector_index = (
            frames
        )
        per_item_us = batch_ns / k / 1000.0
        wal_mv = memoryview(wal_arena)
        sector_mv = memoryview(sector_arena)
        for i, h in enumerate(headers):
            op = int(h["op"])
            off = int(wal_off[i])
            length = int(wal_len[i])
            self._journal_write_framed(
                h, len(bodies[i]), wal_mv[off:off + length],
                int(slots[i]),
                sector_mv[i * SECTOR_SIZE:(i + 1) * SECTOR_SIZE],
                int(sector_index[i]),
            )
            self.op = op
            self.parent_checksum = wire.u128(h, "checksum")
            self._vouched[op] = self.parent_checksum
            if op - 1 > self.commit_min:
                self._vouched.setdefault(op - 1, wire.u128(h, "parent"))
            self._repair_wanted.pop(op, None)
            self._replicate(h, bodies[i])
            if build_oks:
                self.tracer.instant("prepare_ok", op=op)
                self._gc_send(self.primary_index(), oks[i], b"")
            self._h_prepare_ok_us.observe(per_item_us)
            # Legacy order: each message's commit field advances the
            # backup commit point before the next message is handled.
            self._advance_commit(int(h["commit"]))
        # The deviating suffix (if any) runs per-message AFTER the
        # prefix — exactly the order the per-item arm would process
        # the run in.
        for i, h in enumerate(rest_h):
            if wire.u128(h, "cluster") == self.cluster:
                self._on_prepare(h, bytes(rest_b[i]))

    def _enqueue_request(self, header: np.ndarray, body: bytes,
                         readmit: bool = False) -> None:
        """Queue a request exactly once: broadcast retransmissions of
        the same (client, request) must not pile up (a batched drain
        would execute every copy).

        Admission control lives HERE, after the at-most-once gate —
        a retransmission of an already-committed request must get its
        stored reply even under overload, never a busy (shedding at
        the server's raw-message layer had exactly that bug).  A
        fresh request past the `admit_queue` bound — or, with QoS on,
        past its TENANT's token bucket / queue bound — is shed with a
        typed Command.client_busy: session intact, client may retry.
        `readmit` (a "queue"-verdict request cycling back from the
        drain) skips the token bucket: its arrival was already
        charged once."""
        key = (wire.u128(header, "client"), int(header["request"]))
        if key in self._queued_keys:
            return
        tenant = None
        if self.qos is not None:
            tenant = wire.tenant_of(header, body)
            if not readmit:
                self.qos.observe(tenant, self.monotonic)
        # Global bound FIRST: a request the full queue sheds anyway
        # must not consume one of its tenant's tokens (an unrefunded
        # charge here would let a flood that fills the global queue
        # drain a victim tenant's bucket, throttling the victim below
        # its configured rate after the queue clears).
        if self.admit_queue is not None and (
            len(self.request_queue) >= self.admit_queue
        ):
            self._shed_request(header, tenant)
            return
        if self.qos is not None and not readmit:
            if not self.qos.admit(
                tenant, self.monotonic,
                self._tenant_depth.get(tenant, 0),
                body_bytes=len(body),
            ):
                self._shed_request(header, tenant)
                return
        self._queued_keys.add(key)
        self.anatomy.stage_h(header, "queued")
        self.request_queue.append((header, body))
        if self.qos is not None:
            self._queue_tenants.append(tenant)
            self._tenant_depth[tenant] = (
                self._tenant_depth.get(tenant, 0) + 1
            )
            if not readmit:
                self.qos.on_admit(tenant)

    def _shed_request(self, header: np.ndarray,
                      tenant: int | None = None) -> None:
        """Typed load shed: the queue (global or the tenant's) is
        full.  The busy reply rides the client's registered connection
        (a request forwarded from a backup has none here — its client
        recovers by retransmit timeout, which is the legacy-client
        path anyway).  With QoS on the body carries WHO was shed and
        the rate the server observed for that tenant (wire.busy_body)
        so the client can size its backoff; QoS off keeps the legacy
        empty body bit-identically."""
        client = wire.u128(header, "client")
        payload = b""
        if self.qos is not None and tenant is not None:
            payload = wire.busy_body(
                tenant, self._tenant_depth.get(tenant, 0),
                self.qos.rate_of(tenant),
            )
            self.qos.on_shed(tenant)
            # First shed opens an overload episode: weighted-fair
            # drain engages until the queue next runs empty.
            self._qos_episode = True
        busy = wire.make_header(
            command=Command.client_busy, cluster=self.cluster,
            client=client, request=int(header["request"]),
            replica=self.replica, view=self.view,
        )
        wire.copy_trace(busy, header)
        wire.finalize_header(busy, payload)
        if client:
            self.bus.send_client(client, busy, payload)
        if self.on_shed is not None:
            self.on_shed(header, tenant)

    def _pop_request(self, tenant: int | None = None,
                     ) -> tuple[np.ndarray, bytes]:
        """FIFO head when QoS is off or no overload episode is open;
        weighted-fair across tenant FIFOs inside an episode (`tenant`
        pins the pick — logical-batch continuation stays within one
        tenant, so inside an episode a prepare's multiplexed requests
        share one tenant and reply attribution is exact; outside one,
        FIFO batches may mix tenants and attribution is head-of-batch
        approximate — mixed batches only form under non-overload,
        where the per-tenant histograms are not the diagnostic).

        The episode gate is the differential contract: outside an
        episode (no shed since the queue last ran empty) the drain is
        strict FIFO — bit-identical to TB_TENANT_QOS=0 — because a
        weighted-fair pick depends on queue CONTENT at pop time, and
        content varies with ingest drain cadence (per-message vs
        columnar batch) even when arrivals are identical."""
        idx = 0
        if self.qos is not None:
            if self._qos_episode:
                if tenant is None:
                    tenant = self.qos.pick(self._queue_tenants)
                idx = self._queue_tenants.index(tenant)
            self._last_pop_tenant = self._queue_tenants.pop(idx)
            depth = self._tenant_depth.get(self._last_pop_tenant, 0) - 1
            if depth > 0:
                self._tenant_depth[self._last_pop_tenant] = depth
            else:
                self._tenant_depth.pop(self._last_pop_tenant, None)
        h, b = self.request_queue.pop(idx)
        self._queued_keys.discard(
            (wire.u128(h, "client"), int(h["request"]))
        )
        if self.qos is not None and not self.request_queue:
            # Queue drained: the overload episode (if any) is over;
            # the next pops are FIFO again until the next shed.
            self._qos_episode = False
        return h, b

    def _queue_peek(self, tenant: int | None,
                    ) -> tuple[np.ndarray, bytes] | None:
        """The next request a `_pop_request(tenant)` would return —
        the queue head (legacy / outside an episode), or the tenant's
        FIFO head (weighted-fair episode)."""
        if self.qos is None or not self._qos_episode:
            return self.request_queue[0] if self.request_queue else None
        try:
            return self.request_queue[self._queue_tenants.index(tenant)]
        except ValueError:
            return None

    def _request_dedupe(
        self, header: np.ndarray, in_queue: bool = False,
        peek: bool = False, inflight=None,
    ) -> str | None:
        """At-most-once gate, shared by request arrival and queue drain.

        -> None ("fresh: prepare it"), "drop" (duplicate/stale/handled),
        or "queue" (cannot decide yet: catching up or tail not yet
        materialized — retry once current).  `peek` suppresses the
        reply/eviction side effects (batch lookahead must not send
        twice)."""
        client = wire.u128(header, "client")
        request = int(header["request"])
        operation = int(header["operation"])

        if not client:
            return None
        is_register = operation == int(VsrOperation.register)
        entry = self.sessions.get(client)

        if is_register:
            if entry is not None:
                # Re-sent register whose reply was lost: replay it
                # instead of re-committing (a fresh commit would leak a
                # reply slot and evict an innocent session — reference:
                # src/vsr/replica.zig:5035-5100).
                if not peek:
                    # The resume hint must also cover the session's
                    # IN-FLIGHT requests (pipeline/queue/tail): a
                    # failed-over session owner resuming from the
                    # committed number alone collided with its dead
                    # predecessor's uncommitted ops and adopted their
                    # replies (sharded-VOPR seed 2046).  While the
                    # tail is not materialized the bound is unknowable
                    # — defer the replay instead of guessing.
                    inflight_now = self._inflight_requests()
                    if inflight_now is UNDECIDABLE:
                        return "queue"
                    self._send_register_reply(
                        client, entry, inflight_now
                    )
                return "drop"
            # No session yet: fall through to the in-flight scans — a
            # retransmitted register whose original is still in flight
            # must not be prepared twice.
        elif entry is None:
            if (
                self.commit_min < self.commit_max
                or self._canon_pending
                or self._anchor_pending
                or self._chain_suspect
                or self._repair_wanted
                or self._recovering_tail
                # A requeued-uncommitted register can sit in the
                # pipeline awaiting quorum (new primary re-replicating
                # an adopted tail, acks lost — VOPR seed 653186412);
                # bounded scan of <= pipeline_max entries, so no
                # eviction starvation under steady load.
                or any(
                    int(e.header["operation"]) == int(VsrOperation.register)
                    and wire.u128(e.header, "client") == client
                    for e in self.pipeline.values()
                )
                # An adopted-but-unapplied tail not yet covered by the
                # pipeline: a fresh primary with commit_max still 0
                # and repairs pending requeued only the prepares it
                # HELD — the register can sit in the holes (VOPR
                # reconfigure seed 460103075).  Exact membership, not
                # a count: committed entries linger in the pipeline
                # until lazily purged and would mask a hole.  Under
                # steady load the range is <= pipeline depth and fully
                # covered, so this defers nothing then.
                or any(
                    o not in self.pipeline
                    for o in range(self.commit_min + 1, self.op + 1)
                )
            ):
                # Still re-committing, or holding a recovered/claimed
                # journal suffix not yet re-applied: the session may
                # live in that suffix — evicting here killed a
                # registered client whose register op sat in the
                # unapplied tail (VOPR seed 666677761).  Gated on the
                # recovery/repair states (all bounded), NOT on
                # commit_min < self.op, which is true under steady
                # load and would defer legitimate evictions forever.
                return "queue"
            if not peek:
                self._send_eviction(client)
            return "drop"
        else:
            if request == entry.request and request > 0:
                if not peek:
                    self._send_stored_reply(client, entry)
                return "drop"
            if request < entry.request:
                return "drop"  # stale duplicate
            if self.commit_min < self.commit_max:
                # Catching up: the re-committing suffix may already
                # contain this request (our session entry is from an
                # older checkpoint) — preparing it now would execute it
                # twice.
                return "queue"

        # In-flight dedupe: pipeline, queued requests, and the
        # uncommitted journal tail (a prepare adopted via repair never
        # enters OUR pipeline) — a retransmission must not be prepared
        # a second time anywhere (reference: primary pipeline
        # message_by_client lookup).
        if inflight is None:
            inflight = self._inflight_requests(include_queue=not in_queue)
        if inflight is UNDECIDABLE:
            return "queue"
        return "drop" if (client, request) in inflight else None

    def _inflight_requests(self, include_queue: bool = True):
        """(client, request) pairs currently in the pipeline, queue,
        and uncommitted journal tail — or UNDECIDABLE while the tail is
        not fully materialized (repair in flight)."""
        pairs: set[tuple[int, int]] = set()
        for pe in self.pipeline.values():
            c = wire.u128(pe.header, "client")
            if c:
                pairs.add((c, int(pe.header["request"])))
            if pe.subs:
                pairs.update((sc, sr) for sc, sr, _ in pe.subs if sc)
        if include_queue:
            for qh, _ in self.request_queue:
                c = wire.u128(qh, "client")
                if c:
                    pairs.add((c, int(qh["request"])))
        for tail_op in range(self.commit_min + 1, self.op + 1):
            if tail_op in self.pipeline:
                continue  # scanned above
            read = self.journal.read_prepare(tail_op)
            if read is None:
                return UNDECIDABLE
            th, tb = read
            c = wire.u128(th, "client")
            if c:
                pairs.add((c, int(th["request"])))
            t_subs = wire.u128(th, "context")
            if t_subs and (
                int(th["operation"]) >= constants.VSR_OPERATIONS_RESERVED
            ):
                _ev, subs2 = demuxer.decode_trailer(tb, t_subs)
                pairs.update((sc, sr) for sc, sr, _ in subs2 if sc)
        return pairs

    def _advance_prepare_timestamp(self) -> None:
        """Primary timestamping through the synchronized cluster clock:
        the local wall clock is clamped into the Marzullo window before
        it feeds the strictly-monotonic prepare timestamp (reference:
        src/vsr/replica.zig:5762-5772).  Falls back to the raw wall
        clock while unsynchronized (e.g. before the first ping round)."""
        rt = self.clock.realtime_synchronized(self.realtime)
        if rt is None:
            rt = self.realtime
        self.sm.prepare_timestamp = max(
            max(self.sm.prepare_timestamp, self.sm.commit_timestamp) + 1, rt
        )

    def _primary_prepare(
        self, request: np.ndarray, body: bytes,
        subs: list[tuple[int, int, int]] | None = None,
    ) -> None:
        operation = int(request["operation"])
        self._advance_prepare_timestamp()
        if operation >= constants.VSR_OPERATIONS_RESERVED:
            events = demuxer.strip_trailer(body, subs) if subs else body
            self.sm.prepare(types.Operation(operation), events)
        timestamp = self.sm.prepare_timestamp

        op = self.op + 1
        # The instrument times exactly the spans the native pipeline
        # replaces — header build + checksum stamping here, pipeline
        # bookkeeping below — NOT sm.prepare / WAL write / replicate
        # (body-proportional or I/O work both arms share; including it
        # buried the arm delta under disk + scheduler noise).
        t0 = time.perf_counter_ns()
        if self._np is not None:
            # Native arm: one C call builds + checksums the prepare
            # header (client/request/operation/trace copied from the
            # request in C) — bit-identical to the make_header +
            # copy_trace + finalize_header sequence below.
            prepare = self._np.build_prepare(
                request, body, cluster=self.cluster, view=self.view,
                op=op, commit=self.commit_min, timestamp=timestamp,
                parent=self.parent_checksum, replica=self.replica,
                context=len(subs) if subs else 0, release=self.release,
                reuse=self._hash_reuse,
            )
            if self._hash_reuse:
                self._c_hash_reuse.inc()
            else:
                self._c_hash_bytes.inc(len(body))
        else:
            prepare = wire.make_header(
                command=Command.prepare, operation=operation,
                cluster=self.cluster, client=wire.u128(request, "client"),
                request=int(request["request"]), view=self.view,
                op=op, commit=self.commit_min, timestamp=timestamp,
                parent=self.parent_checksum, replica=self.replica,
                context=len(subs) if subs else 0,
                release=self.release,
            )
            # Trace context rides the prepare so every replica's hops
            # key off the same request id (backups record
            # journal_write / prepare_ok against it without any side
            # channel).
            wire.copy_trace(prepare, request)
            if self._hash_reuse:
                # Header-carry reuse: the request header's
                # checksum_body field IS this body's digest — proven by
                # the ingress verify pass (unit requests) or stamped by
                # _build_batch_request's finalize (coalesced bodies).
                wire.finalize_header(prepare, body, checksum_body=(
                    int(request["checksum_body_lo"]),
                    int(request["checksum_body_hi"]),
                ))
                self._c_hash_reuse.inc()
            else:
                wire.finalize_header(prepare, body)
                self._c_hash_bytes.inc(len(body))
        build_ns = time.perf_counter_ns() - t0
        self.anatomy.stage_h(prepare, "prepare")

        self._journal_write(prepare, body)
        self.op = op
        self.parent_checksum = wire.u128(prepare, "checksum")
        self._vouched[op] = self.parent_checksum  # we ARE the canon
        # A leftover pin for this op named dead-view content; the new
        # prepare supersedes it (a matching stale fill would otherwise
        # overwrite this slot — seed 460991023).
        self._repair_wanted.pop(op, None)
        t1 = time.perf_counter_ns()
        synced = not self._gc_enabled
        self.pipeline[op] = PipelineEntry(
            prepare, body, {self.replica}, subs, synced=synced,
        )
        if self._np is not None:
            self._np.note_prepare(prepare, synced, self.replica)
        build_ns += time.perf_counter_ns() - t1
        self._h_prepare_us.observe(build_ns / 1000.0)
        self._replicate(prepare, body)
        self._maybe_commit_pipeline()

    def _primary_prepare_plan(
        self,
        plan: list[tuple[np.ndarray, bytes, list | None]],
    ) -> None:
        """Materialize a drain plan: the whole run of collected
        (request, body, subs) triples becomes prepares in ONE native
        call (build + checksum + self-vote + WAL framing below Python),
        or — on the TB_NATIVE_DRAIN=0 arm / non-sector-aligned
        journal — the per-item _primary_prepare loop over the same
        plan.  Only reachable with group commit on (see
        _drain_request_queue), so no plan entry can commit before the
        run is fully materialized: both arms emit bit-identical frames
        in identical order."""
        if not plan:
            return
        use_native = (
            self._drain_native
            and self._np is not None
            and self.journal._native_frame
        )
        if not use_native:
            if self._drain_native:
                self._c_drain_fallback.inc(len(plan))
            for head, pbody, subs in plan:
                if subs is not None:
                    self._primary_prepare(head, pbody, subs=subs)
                else:
                    self._primary_prepare(head, pbody)
            return

        from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
        from tigerbeetle_tpu_torch.runtime import fastpath as _fastpath
        from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR

        k = len(plan)
        req_hdrs = np.empty(k, dtype=wire.HEADER_DTYPE)
        timestamps = np.empty(k, dtype=np.uint64)
        contexts = np.empty(k, dtype=np.uint64)
        bodies: list[bytes] = []
        # Pre-work (state-machine prepare + timestamp advance) runs in
        # plan order, exactly as the per-item arm interleaves it with
        # header builds — sm.prepare side effects are order-sensitive.
        for i, (head, pbody, subs) in enumerate(plan):
            operation = int(head["operation"])
            self._advance_prepare_timestamp()
            if operation >= constants.VSR_OPERATIONS_RESERVED:
                events = (
                    demuxer.strip_trailer(pbody, subs) if subs else pbody
                )
                self.sm.prepare(types.Operation(operation), events)
            req_hdrs[i] = head
            timestamps[i] = self.sm.prepare_timestamp
            contexts[i] = len(subs) if subs else 0
            bodies.append(pbody)

        op0 = self.op + 1
        t0 = time.perf_counter_ns()
        built = _fastpath.build_prepares(
            self._np, req_hdrs, bodies, timestamps, contexts,
            cluster=self.cluster, view=self.view, op0=op0,
            commit=self.commit_min, parent=self.parent_checksum,
            replica=self.replica, release=self.release, synced=False,
            headers_ring=self.journal.headers,
            slot_count=self.journal.slot_count,
            headers_per_sector=HEADERS_PER_SECTOR,
            sector_size=SECTOR_SIZE,
            reuse=self._hash_reuse,
        )
        build_ns = time.perf_counter_ns() - t0
        if self._hash_reuse:
            self._c_hash_reuse.inc(k)
        else:
            self._c_hash_bytes.inc(sum(len(b) for b in bodies))
        if built is None:
            # Arena capacity refused (cannot happen with the exact
            # allocation above — belt and braces): nothing was mutated,
            # the per-item arm redoes the run.  sm.prepare already ran,
            # and _primary_prepare re-runs it — sm.prepare is
            # idempotent per (op, events) only at execute time, so
            # instead re-enter via the loop WITHOUT re-prepare by
            # failing hard: this is a programming error.
            raise RuntimeError(
                "native drain: prepare arena refused exact-sized run"
            )
        self._c_drain_native.inc()
        prepares, frames = built
        wal_arena, wal_off, wal_len, slots, sector_arena, sector_index = (
            frames
        )
        per_prepare_us = build_ns / k / 1000.0
        wal_mv = memoryview(wal_arena)
        sector_mv = memoryview(sector_arena)
        for i in range(k):
            prepare = prepares[i]
            op = op0 + i
            self.anatomy.stage_h(prepare, "prepare")
            off = int(wal_off[i])
            length = int(wal_len[i])
            self._journal_write_framed(
                prepare, len(bodies[i]),
                wal_mv[off:off + length], int(slots[i]),
                sector_mv[i * SECTOR_SIZE:(i + 1) * SECTOR_SIZE],
                int(sector_index[i]),
            )
            self.op = op
            self.parent_checksum = wire.u128(prepare, "checksum")
            self._vouched[op] = self.parent_checksum
            self._repair_wanted.pop(op, None)
            # C already registered the slot entry + our self-vote
            # (tb_pl_build_prepares calls note_prepare per item): only
            # the Python-side mirror is created here.
            self.pipeline[op] = PipelineEntry(
                prepare, bodies[i], {self.replica}, plan[i][2],
                synced=False,
            )
            self._h_prepare_us.observe(per_prepare_us)
            self._replicate(prepare, bodies[i])
        self._maybe_commit_pipeline()

    def _replicate(self, prepare: np.ndarray, body: bytes) -> None:
        """Ring forwarding: send to successor only (reference:
        src/vsr/replica.zig:1532-1556).  The primary additionally
        feeds each standby directly; standbys never forward."""
        if self.is_primary:
            for s in range(self.replica_count, self.total_count):
                self.bus.send(s, prepare, body)
        if self.standby or self.replica_count == 1:
            return
        succ = (self.replica + 1) % self.replica_count
        if succ != self.primary_index(int(prepare["view"])):
            self.bus.send(succ, prepare, body)

    def _on_prepare_ok(self, header: np.ndarray, body: bytes) -> None:
        if not self.is_primary or int(header["view"]) != self.view:
            return
        op = int(header["op"])
        entry = self.pipeline.get(op)
        if entry is None:
            return
        if self._np is not None:
            # Native vote record: the C table checks op + exact
            # checksum and updates the ack bitset; a None mirrors the
            # Python early returns (unknown op / stale sibling).
            if self._np.on_ack(header) is None:
                return
        elif wire.u128(header, "context") != wire.u128(entry.header, "checksum"):
            return
        # The Python set stays maintained either way — retransmit,
        # eviction, and view-change scans read it.
        entry.ok_replicas.add(int(header["replica"]))
        self.anatomy.stage_h(header, "prepare_ok")
        self._maybe_commit_pipeline()

    def _primary_requeue_uncommitted(self) -> None:
        """After a view change, the adopted-but-uncommitted tail must be
        re-committed under the new view: enqueue every tail op we hold
        and re-replicate it so backups ack into this view."""
        for op in range(self.commit_min + 1, self.op + 1):
            if op in self.pipeline:
                continue
            read = self.journal.read_prepare(op)
            if read is None:
                continue  # still repairing; retried on fill
            header, body = read
            # Reconstruct logical-batch sub-requests from the body
            # trailer: the retransmission dedupe scans them, and a
            # requeued batch without its subs would let a client's
            # retransmit be prepared (and executed) a second time.
            subs = None
            n_subs = wire.u128(header, "context")
            if n_subs and (
                int(header["operation"]) >= constants.VSR_OPERATIONS_RESERVED
            ):
                _events, subs = demuxer.decode_trailer(body, n_subs)
            synced = not self._gc_defer()
            self.pipeline[op] = PipelineEntry(
                header, body, {self.replica}, subs,
                # Journaled earlier, but possibly within the current
                # unsynced window — conservative.
                synced=synced,
            )
            if self._np is not None:
                self._np.note_prepare(header, synced, self.replica)
            self._replicate(header, body)
        self._maybe_commit_pipeline()

    def _maybe_commit_pipeline(self) -> None:
        # Native-drain ready-run cache: ONE C walk answers how many
        # contiguous ops past commit_min are commit-ready, then each
        # loop iteration decrements instead of re-walking.  The cache
        # is keyed to the commit_min it was computed at — any foreign
        # commit_min movement (recursive drains on non-gc clusters,
        # _advance_commit) forces a re-walk, so staleness cannot
        # commit an unready op.
        ready_run = 0
        ready_from = -1
        while self.pipeline:
            op = min(self.pipeline)
            if op <= self.commit_min:  # committed via _advance_commit
                del self.pipeline[op]
                if self._np is not None:
                    self._np.drop(op)
                continue
            entry = self.pipeline[op]
            if self._np is not None:
                # Native group-commit gate: quorum of exact-checksum
                # votes AND sync-covered AND contiguous (commit_min+1)
                # answered by one C call over the slot table — the
                # same three gates the Python arm below walks.
                if self._drain_native:
                    if ready_from != self.commit_min:
                        ready_run = self._np.commit_ready_run(
                            self.commit_min, self.quorum_replication
                        )
                        ready_from = self.commit_min
                    if ready_run <= 0:
                        return
                elif not self._np.commit_ready(
                    self.commit_min, self.quorum_replication
                ):
                    return
                if op != self.commit_min + 1:
                    return  # waiting on repair of earlier ops
            else:
                if len(entry.ok_replicas) < self.quorum_replication:
                    return
                if not entry.synced:
                    # Our own WAL copy is not yet covered: backup acks
                    # alone must not commit (the quorum's durable-copy
                    # count includes our self-vote), and the committed
                    # commit_min would leak pre-sync through heartbeats
                    # and the next prepare's header.  flush_group_commit
                    # re-enters after the covering sync.
                    return
                if op != self.commit_min + 1:
                    return  # waiting on repair of earlier ops
            if int(entry.header["release"]) > self.release:
                return  # prepared by a newer release; upgrade first
            reply_body = self._commit_prepare(entry.header, entry.body)
            self.commit_parent = wire.u128(entry.header, "checksum")
            self.commit_max = max(self.commit_max, op)
            client = wire.u128(entry.header, "client")
            if entry.subs:
                # Batched prepare: forward each sub-request's OWN
                # reply, captured at commit — re-reading the session's
                # stored reply here would send the batch's LAST reply
                # to every sub when one client multiplexed several
                # requests into the batch (open-loop sessions).
                batch_replies, self._batch_replies = (
                    self._batch_replies, []
                )
                for sub_client, rh_bytes, piece in batch_replies:
                    self._gc_send_client(
                        sub_client,
                        wire.header_from_bytes(rh_bytes), piece,
                    )
            elif client:
                self._send_reply(entry.header, reply_body)
            # The request's timeline closes at reply: e2e into the
            # anatomy histogram, tail exemplars retained.
            self.anatomy.finish_h(entry.header, "reply")
            if self.qos is not None and client:
                # Per-tenant reply latency, attributed to the batch
                # head's tenant: exact inside an overload episode
                # (WFQ keeps logical batches within one tenant),
                # head-of-batch approximate for FIFO batches outside
                # one (see _pop_request).
                self.qos.on_reply(
                    wire.tenant_of(entry.header, entry.body), entry.header
                )
            del self.pipeline[op]
            if self._np is not None:
                self._np.drop(op)
            if ready_from >= 0:
                # Our own commit advanced commit_min to `op`: keep the
                # cached run valid without a re-walk.
                ready_run -= 1
                ready_from = op
            if self._checkpoint_due():
                # Deterministic checkpoint point: commit_min crosses the
                # interval boundary at the same op on every replica, so
                # spill bases and manifests are byte-identical cluster-wide
                # (the convergence checkers compare snapshot bytes).
                self.checkpoint()
            self._drain_request_queue()

    def _drain_request_queue(self) -> None:
        """Prepare queued requests while pipeline slots are free — only
        under a synchronized clock (every prepare path shares this
        gate; see _on_request_msg).  Consecutive queued requests for
        the same batchable operation are multiplexed into one prepare
        (logical batching — reference: src/state_machine.zig:122-131),
        cutting per-request consensus overhead under load."""
        if self.replica_count > 1 and not self.clock.synchronized:
            return
        if self._anchor_pending:
            return  # canonical head checksum still being repaired
        requeue: list[tuple[np.ndarray, bytes]] = []
        # ONE in-flight scan per drain, updated incrementally as
        # prepares land (the scan walks the pipeline + uncommitted
        # journal tail; per-pop recomputation made queue drains
        # O(queue x pipeline) — the per-request Python the columnar
        # ingest path is built to avoid).  Committed-then-stale keys
        # are harmless: the session-table check runs first in
        # _request_dedupe and already answers for them.
        inflight = (
            self._inflight_requests(include_queue=False)
            if self.request_queue
            else None
        )
        # Drain plan: with group commit on, a new prepare CANNOT
        # commit mid-drain (entries start unsynced until the covering
        # flush), so the drain first COLLECTS the whole run and then
        # materializes it in _primary_prepare_plan — one native call
        # for the run, or the per-prepare loop on the TB_NATIVE_DRAIN=0
        # arm (same seam, bit-identical frames).  Without group commit
        # (sim clusters), prepares may commit inline per item, so the
        # legacy immediate path stays untouched.
        plan: list | None = [] if self._gc_enabled else None
        pending = 0
        while self.request_queue and (
            len(self.pipeline) + pending
            < self.config.pipeline_prepare_queue_max
            and self._prepare_headroom(pending)
        ):
            h, b = self._pop_request()
            cur_tenant = self._last_pop_tenant
            if plan:
                client = wire.u128(h, "client")
                if client and client not in self.sessions:
                    # The dedupe ladder scans the PIPELINE for this
                    # client's pending register — flush so planned
                    # prepares are visible to it exactly where the
                    # per-item arm would already have them (rare:
                    # only unregistered clients flush).
                    self._primary_prepare_plan(plan)
                    plan = []
                    pending = 0
            # Queued requests re-run the at-most-once gate: their
            # duplicate may have committed (or become decidable) while
            # they waited.
            verdict = self._request_dedupe(
                h, in_queue=True, inflight=inflight
            )
            if verdict == "drop":
                # Its twin committed while this copy waited: the
                # ingress pass that verified this body joins the dup
                # term of the reuse ratio (see vsr/replica.py).
                self._c_hash_dup.inc(len(b))
                continue
            if verdict == "queue":
                requeue.append((h, b))
                continue
            operation = int(h["operation"])
            batch = []
            if (
                operation >= constants.VSR_OPERATIONS_RESERVED
                and demuxer.batch_logical_allowed(types.Operation(operation))
            ):
                # Budget in BODY BYTES: events plus the per-sub demux
                # trailer must fit the message body (and therefore the
                # fixed-size WAL slot).
                sub_size = demuxer.TRAILER_DTYPE.itemsize
                total = len(b) + sub_size
                limit = self.config.message_body_size_max
                while self.request_queue:
                    nxt = self._queue_peek(cur_tenant)
                    if nxt is None:
                        break
                    h2, b2 = nxt
                    if int(h2["operation"]) != operation:
                        break
                    if total + len(b2) + sub_size > limit:
                        break
                    if (
                        self._request_dedupe(
                            h2, in_queue=True, peek=True, inflight=inflight
                        )
                        is not None
                    ):
                        break  # handled/undecidable: not batchable now
                    batch.append(self._pop_request(cur_tenant))
                    total += len(b2) + sub_size
            prepared = [(h, b)] + batch
            if batch:
                head, pbody, subs = self._build_batch_request(prepared)
            else:
                head, pbody, subs = h, b, None
            if plan is not None:
                plan.append((head, pbody, subs))
                pending += 1
            elif subs is not None:
                self._primary_prepare(head, pbody, subs=subs)
            else:
                self._primary_prepare(head, pbody)
            if inflight is not UNDECIDABLE and inflight is not None:
                for ph, _pb in prepared:
                    c = wire.u128(ph, "client")
                    if c:
                        inflight.add((c, int(ph["request"])))
        if plan:
            self._primary_prepare_plan(plan)
        for rh, rb in requeue:
            self._enqueue_request(rh, rb, readmit=True)

    def _build_batch_request(
        self, requests: list[tuple[np.ndarray, bytes]]
    ) -> tuple[np.ndarray, bytes, list]:
        """Multiplex several client requests into one request frame:
        the body is events || trailer, the header's `context` carries
        the sub-request count so every replica demuxes identically."""
        subs = [
            (wire.u128(h, "client"), int(h["request"]),
             len(b) // demuxer.EVENT_SIZE)
            for h, b in requests
        ]
        body = b"".join(b for _, b in requests) + demuxer.encode_trailer(subs)
        head = wire.make_header(
            command=Command.request,
            operation=int(requests[0][0]["operation"]),
            cluster=self.cluster, view=self.view,
            client=0, request=0, context=len(subs),
        )
        # A multiplexed prepare carries ONE trace context: the first
        # sampled sub-request's (the batch executes as one unit, so
        # one timeline describes them all).
        for rh, _ in requests:
            if wire.trace_sampled(rh):
                wire.copy_trace(head, rh)
                break
        # Coalescing concatenates bodies into NEW bytes, so this is a
        # legitimate extra hash pass in BOTH reuse arms (the table keys
        # on (ptr,len) of ingress frames; concatenation has no cached
        # digest).  It stamps head.checksum_body = digest(body), which
        # the prepare-build seam then reuses — the pass happens once,
        # here, not again at build.
        wire.finalize_header(head, body)
        self._c_hash_bytes.inc(len(body))
        return head, body, subs

    def _primary_prepare_batch(
        self, requests: list[tuple[np.ndarray, bytes]]
    ) -> None:
        """One prepare multiplexing several client requests (the
        immediate form; the drain plan uses _build_batch_request +
        _primary_prepare_plan instead)."""
        head, body, subs = self._build_batch_request(requests)
        self._primary_prepare(head, body, subs=subs)

    def _send_register_reply(self, client: int, entry: Session,
                             inflight=None) -> None:
        # Session-resume hint: the highest request number this session
        # has committed OR still has in flight (pipeline, queue,
        # journal tail — anything that could yet commit is visible to
        # a normal-status primary).  A failed-over session owner (the
        # sharded router's coordinator identity) resumes its numbering
        # safely above it — re-registering under a fresh id instead
        # would grow the session table until an eviction hit an
        # innocent live session (found by the sharded VOPR at 18
        # coordinator kills).  Plain clients ignore the field.
        bound = entry.request
        if inflight:
            bound = max(
                [bound] + [r for (c, r) in inflight if c == client]
            )
        reply = wire.make_header(
            command=Command.reply, operation=VsrOperation.register,
            cluster=self.cluster, client=client,
            request=0, view=self.view,
            op=entry.session, commit=entry.session,
            context=bound,
        )
        wire.finalize_header(reply, b"")
        self._gc_send_client(client, reply, b"")

    def _send_reply(self, prepare: np.ndarray, reply_body: bytes) -> None:
        self.tracer.instant("reply", op=int(prepare["op"]))
        client = wire.u128(prepare, "client")
        operation = int(prepare["operation"])
        if operation == int(VsrOperation.register):
            self._send_register_reply(client, self.sessions[client])
            return
        entry = self.sessions.get(client)
        if entry is not None and entry.reply_header:
            header = wire.header_from_bytes(entry.reply_header)
            self._gc_send_client(client, header, reply_body)

    def _send_stored_reply(self, client: int, entry: Session) -> None:
        body = self._read_reply(entry)
        self._gc_send_client(
            client, wire.header_from_bytes(entry.reply_header), body
        )

    def _notify_eviction(self, client: int) -> None:
        if self.is_primary:
            self._send_eviction(client)

    def _send_eviction(self, client: int) -> None:
        h = wire.make_header(
            command=Command.eviction, cluster=self.cluster, view=self.view,
            client=client, replica=self.replica,
        )
        wire.finalize_header(h, b"")
        self._gc_send_client(client, h, b"")

    # ------------------------------------------------------------------
    # WAL group commit (deferred-sync mode).

    def _journal_write(self, header: np.ndarray, body: bytes) -> None:
        """WAL append on the group-commit plan when enabled: written
        unsynced, covered by flush_group_commit()'s one fdatasync per
        drain; a leading-edge sync is kicked onto the WAL worker so
        the disk wait overlaps the rest of the drain's commit CPU."""
        self._stats["stat_prepares_written"].inc()
        self.tracer.instant("prepare", op=int(header["op"]))
        if not self._gc_enabled:
            self.journal.write_prepare(header, body)
            return
        # Sampled requests deferred behind this drain's covering sync
        # get a gc_covering_sync stage stamped when it lands — the
        # group-commit gate's contribution to THIS request's latency.
        tid = wire.trace_sampled(header)
        if tid:
            self._gc_trace_ids.append(tid)
        self.journal.write_prepare(header, body, sync=False)
        if self._wal_sync_worker is not None and self._gc_sync_job is None:
            self._gc_sync_cover = self.journal.unsynced_writes
            self._gc_sync_job = self._wal_sync_worker.submit(
                self.storage.sync_wal
            )

    def _journal_write_framed(
        self, header: np.ndarray, body_len: int, wal_view, slot: int,
        sector_view, sector_index: int,
    ) -> None:
        """_journal_write for a drain-plan prepare whose WAL frame the
        native batch call already laid out (padded slot image + header
        sector image): write the pre-framed views, skip Python-side
        framing entirely.  Only reachable with group commit on, so
        writes are always unsynced + covered like _journal_write's gc
        branch — including the leading-edge sync kick on the first
        write of the drain."""
        self._stats["stat_prepares_written"].inc()
        self.tracer.instant("prepare", op=int(header["op"]))
        tid = wire.trace_sampled(header)
        if tid:
            self._gc_trace_ids.append(tid)
        self.journal.write_prepare_framed(
            header, body_len, wal_view, slot, sector_view, sector_index
        )
        if self._wal_sync_worker is not None and self._gc_sync_job is None:
            self._gc_sync_cover = self.journal.unsynced_writes
            self._gc_sync_job = self._wal_sync_worker.submit(
                self.storage.sync_wal
            )

    def _gc_defer(self) -> bool:
        """True while an ack sent NOW could precede its covering sync."""
        return self._gc_enabled and (
            self.journal.unsynced_writes > 0 or self._gc_sync_job is not None
        )

    def _gc_send(self, dst: int, header: np.ndarray, body: bytes) -> None:
        if self._gc_defer():
            self._c_gc_deferred_acks.inc()
            self._gc_pending.append(("replica", dst, header, body))
        else:
            self.bus.send(dst, header, body)

    def _gc_send_client(self, client: int, header: np.ndarray,
                        body: bytes) -> None:
        if self._gc_defer():
            self._c_gc_deferred_acks.inc()
            self._gc_pending.append(("client", client, header, body))
        else:
            self.bus.send_client(client, header, body)

    def _gc_covering_sync(self) -> None:
        """Make every deferred WAL write durable NOW (acks stay
        buffered — flush_group_commit releases them)."""
        with self.tracer.span(
            "gc_covering_sync", deferred=self.journal.unsynced_writes
        ), self._h_gc_sync.time():
            job, self._gc_sync_job = self._gc_sync_job, None
            if job is not None:
                job.result()
                # Writes that landed after the leading-edge sync was
                # submitted may have raced past its fdatasync: only the
                # covered prefix is settled, the rest re-syncs below.
                self.journal.unsynced_writes = max(
                    0, self.journal.unsynced_writes - self._gc_sync_cover
                )
                self._gc_sync_cover = 0
            self.journal.sync_batch()
        if self._gc_trace_ids:
            # One covering sync settled every deferred write in this
            # batch: stamp the shared stage timestamp on each sampled
            # request that waited for it.
            ids, self._gc_trace_ids = self._gc_trace_ids, []
            self.anatomy.stage_many(ids, "gc_covering_sync")

    def flush_group_commit(self) -> None:
        """Group-commit flush point (end of a server poll drain, or
        the TB_GROUP_COMMIT_MAX_US deadline): one covering sync for
        the drain's deferred WAL writes, THEN the acks it gates
        (prepare_ok, client replies, evictions) go out in order.  No
        ack ever precedes its covering sync."""
        if not self._gc_enabled:
            return
        if self.journal.unsynced_writes or self._gc_sync_job is not None:
            self._gc_covering_sync()
            self.stat_gc_flushes += 1
        if self._gc_pending:
            pending, self._gc_pending = self._gc_pending, []
            # Scatter-gather release: a backup drain typically
            # defers a whole run of prepare_oks to ONE destination (the
            # primary) — batch those into a single vectored bus call
            # when the transport supports it.  Mixed destinations or
            # client replies keep the in-order per-frame loop.
            send_frames = getattr(self.bus, "send_frames", None)
            if (
                self._drain_native
                and send_frames is not None
                and len(pending) > 1
                and all(
                    kind == "replica" and dst == pending[0][1]
                    for kind, dst, _h, _b in pending
                )
            ):
                send_frames(
                    pending[0][1],
                    [(header, body) for _k, _d, header, body in pending],
                )
            else:
                for kind, dst, header, body in pending:
                    if kind == "client":
                        self.bus.send_client(dst, header, body)
                    else:
                        self.bus.send(dst, header, body)
        # The covering sync makes our self-votes count: commit any
        # pipeline entries that were waiting on it (their replies go
        # out directly — nothing is deferred any more).
        if self.is_primary and any(
            not e.synced for e in self.pipeline.values()
        ):
            for e in self.pipeline.values():
                e.synced = True
            if self._np is not None:
                self._np.mark_all_synced()
            self._maybe_commit_pipeline()

    def _aof_barrier(self) -> None:
        # The AOF must never record an op a crash could erase from the
        # WAL: in group-commit mode the covering sync is forced before
        # the AOF append (per-op syncs return — AOF trades the group
        # -commit batching for its stream guarantee).
        super()._aof_barrier()
        if self._gc_enabled:
            self._gc_covering_sync()

    # ------------------------------------------------------------------
    # Normal operation: backup.

    def _on_prepare(self, header: np.ndarray, body: bytes) -> None:
        view = int(header["view"])
        op = int(header["op"])
        if view < self.view:
            # Stale-view prepares arrive as repair responses and as the
            # new primary's re-replication of an adopted tail; the fill
            # path accepts them only when requested/matching.
            self._repair_fill(header, body)
            return
        if view > self.view:
            # We missed a view change: catch up passively (the new
            # primary's start_view was lost; prepares prove the view).
            self._enter_view(view)
        self._last_primary_seen = self._ticks
        if self.status != "normal":
            return
        if self.is_primary:
            # Ring wrapped all the way around — EXCEPT a repair reply
            # for a slot we pinned: the PRIMARY's scrubber must be able
            # to heal its own WAL from a backup, and those replies
            # carry the current view (found by VOPR seed 99911308: the
            # primary dropped every scrub-repair reply for a
            # current-view op, leaving the corrupt slot unhealable).
            self._try_wal_scrub_repair(header, body)
            return

        if op <= self.op:
            # Retransmitted (or repair-overlap) prepare: the journal
            # already holds this op, so the ingress verify that proved
            # this copy was a duplicate-delivery pass — charged to
            # hash.dup_body_bytes, the retransmission term of the
            # reuse ratio (see vsr/replica.py).
            self._c_hash_dup.inc(len(body))
            self._repair_fill(header, body)
            return
        if op > self.op + 1:
            # Gap: stash and repair the missing range; for a big gap
            # additionally request a state-sync jump (see
            # _repair_gap_forward).
            window = 4 * self.config.pipeline_prepare_queue_max
            if len(self._stash) < 2 * window:
                self._stash[op] = (header, body)
            self._repair_gap_forward(op - 1)
            return

        if wire.u128(header, "parent") != self.parent_checksum:
            # Chain mismatch: OUR head is a stale sibling (uncommitted
            # garbage from an old view).  Accept anyway ONLY if this
            # prepare is the exact one we pinned (checksum vouched
            # canonical) — _flag_stale_predecessor then pins the stale
            # head for repair and the commit gate keeps it from
            # executing.  Otherwise pin it and wait.
            checksum = wire.u128(header, "checksum")
            if self._repair_wanted.get(op) != checksum:
                self._repair_wanted[op] = checksum
                self._send_repair_requests()
                return
            self._accept_prepare(header, body)
            self._flag_stale_predecessor(header)
            self._drain_stash()
            self._advance_commit(int(header["commit"]))
            return

        self._accept_prepare(header, body)
        self._drain_stash()
        self._advance_commit(int(header["commit"]))

    def _drain_stash(self) -> None:
        """Extend the head with stashed successors that POSITIVELY
        link to the verified head anchor.  The check must be against
        parent_checksum, not a journal read-back — the read is
        transiently None while the head's WAL write is in flight, and
        failing open let a delayed prior-view prepare extend a
        just-prepared head with stale content (seed 460991023).  No
        draining while the anchor itself is unresolved:
        parent_checksum is stale then."""
        while not self._anchor_pending and self.op + 1 in self._stash:
            h, b = self._stash.pop(self.op + 1)
            if int(h["view"]) != self.view:
                # Stashed before a view change: a later view may have
                # replaced this op with a sibling CHAINING FROM THE
                # SAME PARENT, which the linkage check cannot tell
                # apart — draining one committed a dead view-2 copy
                # where peers committed its view-3 replacement (soak
                # seed 323928758).  Superseded candidates re-enter
                # only via checksum-pinned repair.
                continue
            if wire.u128(h, "parent") != self.parent_checksum:
                break
            self._accept_prepare(h, b)

    def _accept_prepare(self, header: np.ndarray, body: bytes) -> None:
        op = int(header["op"])
        self._journal_write(header, body)
        self.op = op
        self.parent_checksum = wire.u128(header, "checksum")
        # A current-view prepare is canonical for its op, and its
        # parent field vouches its predecessor.
        self._vouched[op] = self.parent_checksum
        if op - 1 > self.commit_min:
            self._vouched.setdefault(op - 1, wire.u128(header, "parent"))
        self._repair_wanted.pop(op, None)
        self._replicate(header, body)
        # Backup-side instrument: just the prepare_ok build span (the
        # work the native pipeline replaces here) — body-independent,
        # so the arm delta survives heavy group-commit coalescing.
        t0 = time.perf_counter_ns()
        self._send_prepare_ok(header)
        self._h_prepare_ok_us.observe((time.perf_counter_ns() - t0) / 1000.0)

    def _flag_stale_predecessor(self, header: np.ndarray) -> None:
        """Chain continuity at journal-write time: the accepted prepare
        vouches (via `parent`) for exactly one predecessor checksum.  A
        mismatched local predecessor is a superseded SIBLING from an
        older view (same parent, different content — the parent check
        alone cannot catch it); pin it for exact-checksum repair so the
        commit path never executes it.  (_verify_chain_down subsumes
        this during suspect phases.)"""
        op = int(header["op"])
        if op - 1 <= self.commit_min:
            return
        prev = self.journal.read_prepare(op - 1)
        want = wire.u128(header, "parent")
        if prev is None or wire.u128(prev[0], "checksum") != want:
            self._repair_wanted[op - 1] = want
            self._chain_suspect = True
            self._send_repair_requests()

    def _send_prepare_ok(self, prepare: np.ndarray) -> None:
        if self.status != "normal" or self.is_primary or self.standby:
            return  # standbys replicate without acking: no quorum role
        if self._np is not None:
            # Native arm: header build + checksum stamping in one C
            # call (cluster/context/client/op/trace copied from the
            # prepare in C) — bit-identical to the sequence below.
            ok = self._np.build_prepare_ok(prepare, self.view, self.replica)
        else:
            ok = wire.make_header(
                command=Command.prepare_ok, cluster=self.cluster,
                view=self.view,
                op=int(prepare["op"]), replica=self.replica,
                context=wire.u128(prepare, "checksum"),
                client=wire.u128(prepare, "client"),
            )
            # The ack echoes the prepare's trace context so the
            # PRIMARY can stamp a prepare_ok stage (per acking backup)
            # onto the request's timeline.
            wire.copy_trace(ok, prepare)
            wire.finalize_header(ok, b"")
        self.tracer.instant("prepare_ok", op=int(prepare["op"]))
        # Routed through the group-commit gate: a prepare_ok for an op
        # whose WAL write is not yet covered by a sync must wait for
        # the flush (the durability-before-ack contract).
        self._gc_send(self.primary_index(), ok, b"")

    def _on_commit(self, header: np.ndarray, body: bytes) -> None:
        # Heartbeats advertise the freshest adopted membership: a
        # process that crashed before a reconfigure committed
        # re-learns the ROLE it fills here (without this it is
        # unreachable — its repair requests carry the old slot, so
        # responses route to whoever fills that slot now).  Adoption
        # runs BEFORE the status/view gate: a restarted process stuck
        # in view_change under a superseded identity would otherwise
        # drop the very advertisement it needs — its DVCs then came
        # from a slot someone else fills, replies routed to the new
        # holder, and it never rejoined (soak seed 420704875).  Only
        # the adopted identity moves; the committed epoch/members
        # advance exclusively through the replicated op so
        # reconfigure replies stay deterministic across replicas.
        self._maybe_adopt_advert(body)
        if int(header["view"]) < self.view or self.status != "normal":
            return
        if int(header["view"]) > self.view:
            self._enter_view(int(header["view"]))
        self._last_primary_seen = self._ticks
        commit = int(header["commit"])
        vouch = wire.u128(header, "context")
        if vouch and commit > self.commit_min:
            self._vouched[commit] = vouch
        self._advance_commit(commit)

    def _extend_vouches_down(self) -> None:
        """Derive vouches downward: if op K's canonical content is
        vouched and our journal's K matches it, K's parent field
        vouches K-1 — repeat to the commit frontier."""
        for k in sorted(self._vouched, reverse=True):
            while k - 1 > self.commit_min and k - 1 not in self._vouched:
                # The in-memory redundant header ring supplies the
                # checksum/parent fields without re-reading (and
                # re-hashing) the full 1 MiB prepare slot.
                mem = self.journal.headers[self.journal.slot_for_op(k)]
                if (
                    int(mem["op"]) != k
                    or int(mem["command"]) != int(Command.prepare)
                    or wire.u128(mem, "checksum") != self._vouched[k]
                ):
                    # Cannot derive through a missing/divergent slot —
                    # and nothing else repairs it when commits are
                    # already gated BELOW the hole (_advance_commit
                    # never reaches it): a standby with a mid-suffix
                    # hole wedged at the vouch gate forever (soak seed
                    # 157503236).  Pin the exact canonical checksum.
                    self._repair_wanted.setdefault(k, self._vouched[k])
                    self._send_repair_requests()
                    break
                self._vouched[k - 1] = wire.u128(mem, "parent")
                k -= 1

    def _maybe_resolve_anchor(self) -> None:
        """Re-anchor parent_checksum once the pinned canonical head
        prepare has been repaired into our journal."""
        if not self._anchor_pending:
            return
        read = self.journal.read_prepare(self.op)
        if read is None:
            return
        pin = self._repair_wanted.get(self.op)
        if pin == 0:
            return  # canonical checksum not yet resolved: a local
            # prepare could be the stale sibling — keep waiting
        h = read[0]
        want = pin or self._vouched.get(self.op)
        if want and wire.u128(h, "checksum") != want:
            return
        self.parent_checksum = wire.u128(h, "checksum")
        self._anchor_pending = False
        self._verify_chain_down()

    def _advance_commit(self, commit_max: int) -> None:
        self.commit_max = max(self.commit_max, commit_max)
        self._maybe_resolve_anchor()
        if self._canon_pending:
            return  # tail not yet confirmed canonical (start_view pending)
        if self._chain_suspect:
            self._verify_chain_down()
            if self._chain_suspect:
                return  # stale siblings may lurk; repairs in flight
        while self.commit_min < min(self.commit_max, self.op):
            op = self.commit_min + 1
            read = self.journal.read_prepare(op)
            if op in self._repair_wanted:
                want = self._repair_wanted[op]
                if (
                    want
                    and read is not None
                    and wire.u128(read[0], "checksum") == want
                ):
                    # The pin is already satisfied locally.
                    del self._repair_wanted[op]
                else:
                    # Flagged as superseded/missing: wait for the
                    # canonical prepare instead of executing the local
                    # candidate.
                    self._send_repair_requests()
                    return
            if read is None:
                self._repair_wanted.setdefault(op, 0)
                self._send_repair_requests()
                return
            header, body = read
            if int(header["release"]) > self.release:
                return  # prepared by a newer release; upgrade first
            if (
                self.commit_parent is not None
                and wire.u128(header, "parent") != self.commit_parent
            ):
                # Local candidate diverges from the committed chain
                # (e.g. a speculative pre-crash prepare superseded by a
                # view change): fetch the canonical prepare instead of
                # executing the stale one.
                self._repair_wanted.setdefault(op, 0)
                self._send_repair_requests()
                return
            # Canonical vouch gate: parent linkage alone cannot reject
            # a stale SIBLING (same parent, different content).  Only
            # execute content the current history vouches for; without
            # a vouch, wait (the next heartbeat / prepare / start_view
            # supplies one within ticks).
            self._extend_vouches_down()
            want = self._vouched.get(op)
            if want is None:
                return
            if wire.u128(header, "checksum") != want:
                self._repair_wanted[op] = want
                self._send_repair_requests()
                return
            self._commit_prepare(header, body)
            # Backups (and a catching-up primary) close the record at
            # commit — there is no reply hop on this replica; the
            # partial timeline still feeds exemplars/e2e.
            self.anatomy.finish_h(header)
            self.commit_parent = wire.u128(header, "checksum")
            self._vouched.pop(op, None)
            if self._checkpoint_due():
                # Deterministic checkpoint point: commit_min crosses the
                # interval boundary at the same op on every replica, so
                # spill bases and manifests are byte-identical cluster-wide
                # (the convergence checkers compare snapshot bytes).
                self.checkpoint()
        if self.op < self.commit_max and not self.is_primary:
            # Our log ends below the commit frontier (e.g. we rejoined
            # after the pipeline drained).
            self._repair_gap_forward(self.commit_max)

    def _repair_gap_forward(self, target_op: int) -> None:
        """Catch the log up toward `target_op`: windowed WAL repair
        always; for a big gap also request a state-sync jump.  Both
        stay in flight on separate throttles — the remote checkpoint
        may be OLDER than our commit frontier (sync would install
        nothing), so whichever lands first advances us."""
        window = 4 * self.config.pipeline_prepare_queue_max
        if target_op - self.op > window:
            self._request_sync()
        for op in range(self.op + 1, min(self.op + window, target_op) + 1):
            self._repair_wanted.setdefault(op, 0)
        self._send_repair_requests()

    def _membership_advert(self) -> bytes:
        return (
            self.encode_reconfigure(self.epoch_adopted, self.members_adopted)
            if self.epoch_adopted
            else b""
        )

    def _maybe_adopt_advert(self, body: bytes) -> None:
        if not body:
            return
        decoded = self.decode_reconfigure(body)
        if decoded is None:
            return
        epoch, members = decoded
        if epoch > self.epoch_adopted and sorted(members) == list(
            range(self.total_count)
        ):
            self._adopt_roles(epoch, members)

    def _send_clock_pings(self) -> None:
        """Sample every peer's wall clock: ping carries our monotonic
        send time m0; the pong echoes it alongside the peer's wall
        clock t1 (reference: src/vsr/replica.zig on_ping/on_pong)."""
        self._last_clock_ping = self._ticks
        ping = wire.make_header(
            command=Command.ping, cluster=self.cluster, view=self.view,
            replica=self.replica, timestamp=self.monotonic,
            release=max(self.releases_available),
        )
        # Pings gossip the freshest adopted membership: heartbeats
        # only flow primary->normal-status peers, so a process whose
        # adopted epoch ran ahead and then got isolated in
        # view_change-as-standby could be the ONLY holder of a
        # committed membership the rest of the cluster needs to even
        # agree who the next primary is (soak seed 421977104 wedged
        # exactly so).  Pings flow between ALL processes in ANY
        # status.
        adv = self._membership_advert()
        wire.finalize_header(ping, adv)
        # Standbys are pinged too: their pong advertises their release,
        # so an upgrade never commits while the hot spare would be left
        # behind unable to execute the new release's prepares.
        for r in range(self.total_count):
            if r != self.replica:
                self.bus.send(r, ping, adv)

    def _on_ping(self, header: np.ndarray, body: bytes) -> None:
        # Echo m0 in `timestamp`; our wall clock rides in `op` (clamped
        # at 0 — the wire field is u64 and a skewed simulated clock can
        # sit before the epoch at startup).
        # Adopt BEFORE learning the release: adoption resets the
        # slot-keyed peer_release map, which would wipe the sample
        # this same message carries.
        self._maybe_adopt_advert(body)
        self._learn_peer_release(header)
        pong = wire.make_header(
            command=Command.pong, cluster=self.cluster, view=self.view,
            replica=self.replica, timestamp=int(header["timestamp"]),
            op=max(0, self.realtime),
            release=max(self.releases_available),
        )
        adv = self._membership_advert()
        wire.finalize_header(pong, adv)
        self.bus.send(int(header["replica"]), pong, adv)

    def _learn_peer_release(self, header: np.ndarray) -> None:
        rel = int(header["release"])
        if rel:
            peer = int(header["replica"])
            self.peer_release[peer] = max(self.peer_release.get(peer, 0), rel)

    def _on_pong(self, header: np.ndarray, body: bytes) -> None:
        self._maybe_adopt_advert(body)
        self._learn_peer_release(header)
        if int(header["replica"]) >= self.replica_count:
            return  # standby pongs advertise releases, not clock samples
        self.clock.learn(
            int(header["replica"]),
            m0=int(header["timestamp"]),
            t1=int(header["op"]),
            m2=self.monotonic,
            realtime_now=self.realtime,
        )

    # ------------------------------------------------------------------
    # Repair.

    def _repair_fill(self, header: np.ndarray, body: bytes) -> None:
        """A prepare at or below our op: overwrite if we wanted it or
        our copy is missing/diverged; ack matching content into the
        current view so a new primary can re-commit an adopted tail."""
        op = int(header["op"])
        checksum_pinned = self._repair_wanted.get(op)
        if op > self.op:
            # Log extension via pinned repair (op prepared in an older
            # view, checksum vouched for by the current primary's
            # headers response).
            if (
                op == self.op + 1
                and checksum_pinned
                and checksum_pinned == wire.u128(header, "checksum")
                and self.status == "normal"
            ):
                self._accept_prepare(header, body)
                self._flag_stale_predecessor(header)
                self._drain_stash()
                self._advance_commit(self.commit_max)
            return
        if self._try_wal_scrub_repair(header, body):
            return
        want = self._repair_wanted.get(op)
        have = self.journal.read_prepare(op)
        checksum = wire.u128(header, "checksum")
        if have is not None and wire.u128(have[0], "checksum") == checksum:
            if want == checksum:
                # The local copy already IS the pinned canonical one:
                # unpin, keep cascading the chain check, unblock commit.
                del self._repair_wanted[op]
                self._flag_stale_predecessor(have[0])
                self._advance_commit(self.commit_max)
            self._send_prepare_ok(header)  # already hold it: just ack
            return
        # Accept ONLY checksum-pinned repairs: a stale prepare from a
        # dead view could otherwise overwrite the committed one (want=0
        # entries first resolve to a checksum via request_headers).
        if want != checksum or want == 0:
            return
        self._journal_write(header, body)
        self._repair_wanted.pop(op, None)
        self._vouched[op] = checksum  # pinned fill == canonical content
        if op == self.op:
            self.parent_checksum = checksum
        # Re-verify: the canonical fill vouches for its predecessor,
        # exposing the next stale sibling (if any).
        if self._chain_suspect:
            self._verify_chain_down()
        else:
            self._flag_stale_predecessor(header)
        self._send_prepare_ok(header)
        if self.is_primary:
            self._primary_requeue_uncommitted()
        # Try draining stash / committing past the filled hole.
        self._drain_stash()
        self._advance_commit(self.commit_max)

    def _send_repair_requests(self, force: bool = False) -> None:
        """Rate-limited: message handlers may call this on every packet,
        and un-throttled request bursts amplify exponentially (each
        response can trigger another burst)."""
        if not force and (
            self._ticks - self._repair_last_sent < REPAIR_RETRY_TICKS
        ):
            return
        self._repair_last_sent = self._ticks
        # Drop pins the commit frontier has passed (already executed
        # canonically; their journal slots may even be recycled).
        for op in [o for o in self._repair_wanted if o <= self.commit_min]:
            del self._repair_wanted[op]
        if not self._repair_wanted:
            return
        # Ask the primary (authoritative for the committed prefix);
        # ourselves-as-primary asks the successor.
        target = self.primary_index()
        if target == self.replica:
            target = (self.replica + 1) % self.replica_count

        # Two-step repair (reference: src/vsr/replica.zig:2259-2497):
        # unpinned ops first learn their canonical checksum via
        # request_headers, pinned ops fetch the prepare by checksum.
        unpinned = [op for op, cs in self._repair_wanted.items() if cs == 0]
        if unpinned or (self._anchor_pending and self.op in self._repair_wanted):
            lo = min(unpinned) if unpinned else self.op
            hi = max(unpinned) if unpinned else self.op
            h = wire.make_header(
                command=Command.request_headers, cluster=self.cluster,
                view=self.view, replica=self.replica,
                op=lo, commit=hi,
            )
            wire.finalize_header(h, b"")
            if self._anchor_pending:
                # Anchor resolution must see every peer's sibling for
                # the head op, not one possibly-stale target's.
                for r in range(self.replica_count):
                    if r != self.replica:
                        self.bus.send(r, h, b"")
            else:
                self.bus.send(target, h, b"")
        pinned = [
            (op, cs) for op, cs in self._repair_wanted.items() if cs != 0
        ]
        if pinned:
            # The primary is the preferred source but not guaranteed
            # to HOLD every pinned body: with the primary and one
            # backup both missing an op, primary-asks-successor and
            # successor-asks-primary never reaches the lone holder
            # (VOPR seed 803272239 wedged exactly so).  Checksum-
            # addressed fetches are safe from ANY peer — including
            # standbys, which replicate the log and can be the lone
            # surviving holder after actives corrupt — so retries
            # rotate across the full membership.
            peers = [
                r for r in range(self.total_count) if r != self.replica
            ]
            if peers:
                base = peers.index(target) if target in peers else 0
                target = peers[(base + self._repair_round) % len(peers)]
                self._repair_round += 1
        for op, checksum in pinned[:8]:
            h = wire.make_header(
                command=Command.request_prepare, cluster=self.cluster,
                view=self.view, op=op, replica=self.replica, context=checksum,
            )
            wire.finalize_header(h, b"")
            self.bus.send(target, h, b"")

    def _on_request_headers(self, header: np.ndarray, body: bytes) -> None:
        lo, hi = int(header["op"]), int(header["commit"])
        out = []
        for op in range(lo, min(hi, lo + 64) + 1):
            read = self.journal.read_prepare(op)
            if read is not None:
                out.append(read[0].tobytes())
        if not out:
            if hi <= self.checkpoint_op:
                self._send_sync_checkpoint(int(header["replica"]))
            return
        reply = wire.make_header(
            command=Command.headers, cluster=self.cluster, view=self.view,
            replica=self.replica, commit=self.commit_min,
        )
        payload = b"".join(out)
        wire.finalize_header(reply, payload)
        self.bus.send(int(header["replica"]), reply, payload)

    def _on_headers(self, header: np.ndarray, body: bytes) -> None:
        from tigerbeetle_tpu_torch.constants import HEADER_SIZE

        pinned_any = False
        for at in range(0, len(body), HEADER_SIZE):
            h = wire.header_from_bytes(body[at : at + HEADER_SIZE])
            if not wire.verify_header(h):
                continue
            op = int(h["op"])
            if (
                self._anchor_pending
                and op == self.op
                and op in self._repair_wanted
                and int(h["view"]) > self._anchor_pin_view
            ):
                # Anchor resolution collects from every peer and keeps
                # the highest-view sibling: the committed content for
                # an op is the one prepared in the latest view, and a
                # single partitioned peer's stale header must not win.
                self._repair_wanted[op] = wire.u128(h, "checksum")
                self._anchor_pin_view = int(h["view"])
                pinned_any = True
            elif self._repair_wanted.get(op) == 0:
                self._repair_wanted[op] = wire.u128(h, "checksum")
                pinned_any = True
            if self._wal_scrub_wanted.get(op) == 0 and op <= self.commit_min:
                # Scrub pin resolved: fetch the prepare by checksum.
                checksum = wire.u128(h, "checksum")
                self._wal_scrub_wanted[op] = checksum
                req = wire.make_header(
                    command=Command.request_prepare, cluster=self.cluster,
                    view=self.view, op=op, replica=self.replica,
                    context=checksum,
                )
                wire.finalize_header(req, b"")
                self.bus.send(int(header["replica"]), req, b"")
        if pinned_any:
            self._send_repair_requests(force=True)

    def _request_sync(self) -> None:
        # Own throttle: repair requests share the network but must not
        # starve sync retries (and vice versa).
        if self._ticks - self._sync_last_requested < REPAIR_RETRY_TICKS:
            return
        self._sync_last_requested = self._ticks
        h = wire.make_header(
            command=Command.request_sync_checkpoint, cluster=self.cluster,
            view=self.view, replica=self.replica,
        )
        wire.finalize_header(h, b"")
        target = self.primary_index()
        if target == self.replica:
            target = (self.replica + 1) % self.replica_count
        self.bus.send(target, h, b"")

    def _try_wal_scrub_repair(self, header: np.ndarray, body: bytes) -> bool:
        """WAL-scrub repair of a committed slot: the pin came from OUR
        in-memory redundant header, so a checksum-matching prepare is
        the committed canonical content — rewrite both rings."""
        op = int(header["op"])
        checksum = wire.u128(header, "checksum")
        slot = self.journal.slot_for_op(op)
        if (
            checksum != 0
            and self._wal_scrub_wanted.get(op) == checksum
            # Slot-recycle guard: a checkpoint may have advanced past
            # the pinned op and the ring wrapped — a late repair reply
            # must not clobber the NEWER prepare now in the slot.  The
            # in-memory ring is authoritative for what the slot holds;
            # <= (not ==) so a pin resolved via request_headers after
            # DOUBLE corruption (in-memory header lost, slot shows op
            # 0) still repairs.
            and int(self.journal.headers[slot]["op"]) <= op
            and self.journal.read_prepare(op) is None
        ):
            # Deferred-sync mode folds the prepare-ring write and any
            # header-sector heal into ONE covering sync at the next
            # flush — a repaired prepare no longer fsyncs twice.
            self._journal_write(header, body)
            del self._wal_scrub_wanted[op]
            self.stat_wal_scrub_repaired += 1
            self.tracer.instant("wal_scrub", op=op)
            return True
        return False

    def _on_request_prepare(self, header: np.ndarray, body: bytes) -> None:
        op = int(header["op"])
        want = wire.u128(header, "context")
        read = self.journal.read_prepare(op)
        if read is None:
            # The WAL ring wrapped past this op: repair is impossible,
            # the peer must state-sync to our checkpoint instead
            # (reference: src/vsr/sync.zig — sync supersedes WAL repair).
            if op <= self.checkpoint_op:
                self._send_sync_checkpoint(int(header["replica"]))
            return
        prepare, pbody = read
        if want and wire.u128(prepare, "checksum") != want:
            return
        self.bus.send(int(header["replica"]), prepare, pbody)

    # ------------------------------------------------------------------
    # State sync: ship the checkpoint snapshot in body-sized chunks
    # (reference: src/vsr/sync.zig stage machine; Command
    # .request_sync_checkpoint/.sync_checkpoint).

    def _sync_wrap(self, blob: bytes) -> bytes:
        """With a forest attached, the snapshot's manifest references
        grid blocks that exist only in OUR grid zone — ship them with
        the blob so the syncing replica can install a working LSM tier
        (reference: the sync target fetches missing grid blocks,
        src/vsr/grid_blocks_missing.zig)."""
        if self.forest is None:
            return blob
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        grid = self.forest.grid
        grid.flush_writes()  # queued async block writes must be on disk
        live = (np.flatnonzero(~grid.free_set.free) + 1).astype(np.uint64)
        raw = bytearray()
        for addr in live:
            raw += self.storage.read(grid._offset(int(addr)), grid.block_size)
        return snapcodec.encode(
            {
                "snapshot": blob,
                "addrs": live,
                "blocks": bytes(raw),
                "block_size": grid.block_size,
            }
        )

    def _sync_unwrap(self, payload: bytes) -> bytes:
        """Install shipped grid blocks (verified by address + length)
        and return the inner snapshot blob."""
        if self.forest is None:
            return payload
        from tigerbeetle_tpu_torch.utils import snapshot as snapcodec

        state = snapcodec.decode(payload)
        grid = self.forest.grid
        # Drain OUR stale queued writes first — a pre-sync write
        # landing after the install would silently overwrite a shipped
        # block with old-lineage (checksum-valid) content.
        grid.flush_writes()
        addrs = state["addrs"]
        blocks = state["blocks"]
        bs = int(state["block_size"])
        if bs != grid.block_size or len(blocks) != len(addrs) * bs:
            raise ValueError("sync payload block geometry mismatch")
        for i, addr in enumerate(addrs):
            addr = int(addr)
            if not 1 <= addr <= grid.block_count:
                raise ValueError("sync payload block address out of range")
            self.storage.write(
                grid._offset(addr), blocks[i * bs : (i + 1) * bs]
            )
        # Invalidate the block cache: shipped blocks replace anything
        # read before the sync.
        from tigerbeetle_tpu_torch.utils.cache import SetAssociativeCache

        grid._cache = SetAssociativeCache(capacity=256, ways=4)
        return state["snapshot"]

    # ------------------------------------------------------------------
    # Single-block peer repair: scrubber findings heal from any peer at
    # the same checkpoint without re-shipping the whole snapshot
    # (reference: src/vsr/grid_blocks_missing.zig:1-30,
    # Command.request_blocks / Command.block, src/vsr/grid.zig:34-60).
    # Scrub pacing: one probe every SCRUB_INTERVAL_TICKS, cycling the
    # whole grid over many seconds (reference: grid_scrubber paces on a
    # slow timer) — steady-state cost stays negligible.

    def _wal_scrub_tick(self) -> None:
        """Probe one committed journal slot above the checkpoint for
        latent sector errors (reference's scrubbing philosophy applied
        to the WAL; the uncommitted window is covered by the normal
        repair protocol)."""
        lo, hi = self.checkpoint_op + 1, self.commit_min
        if hi < lo:
            return
        op = lo + self._wal_scrub_cursor % (hi - lo + 1)
        self._wal_scrub_cursor += 1
        self._wal_scrub_probe(op)

    def wal_scrub_window(self) -> None:
        """Probe the ENTIRE committed window at once — used by test
        harnesses before journal-reading checkers, and usable by an
        operator hook; production pacing uses the per-tick probe."""
        for op in range(self.checkpoint_op + 1, self.commit_min + 1):
            self._wal_scrub_probe(op)

    def _wal_scrub_probe(self, op: int) -> None:
        """Header-ring damage self-heals from the in-memory ring;
        prepare-sector damage repairs from a peer, pinned by the
        canonical checksum from memory — or, when that was lost too
        (restart after double corruption), resolved via a targeted
        request_headers round first."""
        slot = self.journal.slot_for_op(op)
        have = self.journal.read_prepare(op)
        if have is not None:
            self._wal_scrub_wanted.pop(op, None)
            if not self.journal.header_sector_intact(slot):
                # Deferred-sync mode: the heal rides the next covering
                # flush instead of paying its own fdatasync.
                self.journal.rewrite_header_sector(
                    slot, sync=not self._gc_enabled
                )
                self.stat_wal_scrub_repaired += 1
            return
        if self.replica_count <= 1:
            return
        # Rotate targets across probes: the preferred peer may hold
        # the same latent damage (block repair round-robins the same
        # way).
        peers = [r for r in range(self.replica_count) if r != self.replica]
        target = peers[self._wal_scrub_attempt % len(peers)]
        self._wal_scrub_attempt += 1
        mem = self.journal.headers[slot]
        if int(mem["op"]) == op and int(mem["command"]) == Command.prepare:
            checksum = wire.u128(mem, "checksum")
        else:
            checksum = 0
        self._wal_scrub_wanted[op] = checksum
        if checksum:
            h = wire.make_header(
                command=Command.request_prepare, cluster=self.cluster,
                view=self.view, op=op, replica=self.replica,
                context=checksum,
            )
        else:
            # Canonical checksum unknown locally: learn it from a peer
            # (ops <= commit_min are committed, hence unique per op).
            h = wire.make_header(
                command=Command.request_headers, cluster=self.cluster,
                view=self.view, replica=self.replica, op=op, commit=op,
            )
        wire.finalize_header(h, b"")
        self.bus.send(target, h, b"")

    def _send_request_blocks(self) -> None:
        """Ask a peer for our corrupt blocks (round-robin over peers,
        bounded batch per request)."""
        self._block_repair_last = self._ticks
        # Blocks freed — or staged for release — since they were
        # flagged no longer need repair (a peer that already
        # checkpointed holds them free and would silently drop the
        # request; same invariant as the scrubber's skip).
        fs = self.forest.grid.free_set
        self._blocks_missing = {
            a for a in self._blocks_missing
            if not fs.leaving_live_set([a])[0]
        }
        if not self._blocks_missing:
            return
        peers = [r for r in range(self.replica_count) if r != self.replica]
        dst = peers[self._block_repair_attempt % len(peers)]
        self._block_repair_attempt += 1
        addrs = np.asarray(sorted(self._blocks_missing)[:64], np.uint64)
        h = wire.make_header(
            command=Command.request_blocks, cluster=self.cluster,
            replica=self.replica, op=self.checkpoint_op,
        )
        body = addrs.tobytes()
        wire.finalize_header(h, body)
        self.bus.send(dst, h, body)

    def _on_request_blocks(self, header: np.ndarray, body: bytes) -> None:
        """Serve raw block frames — only when our grid is guaranteed
        identical to the requester's (same checkpoint; the forest
        writes blocks only at checkpoint)."""
        if self.forest is None or self.status != "normal":
            return
        if int(header["op"]) != self.checkpoint_op:
            return
        if len(body) % 8 != 0:
            return  # malformed (this handler takes untrusted input)
        dst = int(header["replica"])
        if not 0 <= dst < self.replica_count or dst == self.replica:
            return
        from tigerbeetle_tpu_torch.vsr.grid import block_frame_valid

        grid = self.forest.grid
        # Serve at most the sender's cap regardless of what the body
        # claims — one message must not trigger unbounded disk reads.
        for addr in np.frombuffer(body, np.uint64)[:64]:
            addr = int(addr)
            if not 1 <= addr <= grid.block_count:
                continue
            if grid.free_set.free[addr - 1]:
                continue  # not live here (diverged free set: stale req)
            # One raw read serves both the intactness check and the
            # reply payload.
            frame = self.storage.read(grid._offset(addr), grid.block_size)
            if not block_frame_valid(frame, addr, grid.payload_size):
                continue  # our copy is corrupt too; another peer's turn
            bh = wire.make_header(
                command=Command.block, cluster=self.cluster,
                replica=self.replica, op=self.checkpoint_op,
            )
            wire.finalize_header(bh, frame)
            self.bus.send(dst, bh, frame)

    def _on_block(self, header: np.ndarray, body: bytes) -> None:
        """Install a repaired block after verifying its self-described
        address + payload checksum against what we asked for."""
        from tigerbeetle_tpu_torch.vsr.grid import BLOCK_DTYPE, BLOCK_HEADER_SIZE

        if self.forest is None or int(header["op"]) != self.checkpoint_op:
            return
        grid = self.forest.grid
        if len(body) != grid.block_size:
            return
        bh = np.frombuffer(body[:BLOCK_HEADER_SIZE], BLOCK_DTYPE)[0]
        addr = int(bh["address"])
        if addr not in self._blocks_missing:
            return
        length = int(bh["length"])
        if length > grid.payload_size:
            return
        payload = body[BLOCK_HEADER_SIZE : BLOCK_HEADER_SIZE + length]
        want = int(bh["checksum_lo"]) | (int(bh["checksum_hi"]) << 64)
        if wire.checksum(payload) != want:
            return
        grid.flush_writes()  # stale queued write must not overwrite us
        self.storage.write(grid._offset(addr), body)
        grid._cache.remove(addr)
        self._blocks_missing.discard(addr)
        if self.scrubber is not None:
            self.scrubber.repaired(addr)  # a relapse is a new fault
        self._block_repair_attempt = 0
        self.stat_blocks_repaired += 1
        self.tracer.instant("block_repair", address=addr)

    def _send_sync_checkpoint(self, dst: int) -> None:
        # The shipped blob is read via the WORKING superblock's
        # references: an in-flight async flip must land first.
        self._ckpt_join()
        sb = self.superblock.working
        size = int(sb["checkpoint_size"])
        if size == 0:
            return
        # A full blob is many chunks; don't resend on every repair retry.
        last = self._sync_sent.get(dst, -(10**9))
        if self._ticks - last < 4 * REPAIR_RETRY_TICKS:
            return
        self._sync_sent[dst] = self._ticks
        blob = self._sync_wrap(self._read_grid(int(sb["checkpoint_offset"]), size))
        blob_checksum = wire.checksum(blob)
        commit_min_checksum = (
            int(sb["commit_min_checksum_lo"])
            | (int(sb["commit_min_checksum_hi"]) << 64)
        )
        chunk_size = self.config.message_body_size_max
        n_chunks = (len(blob) + chunk_size - 1) // chunk_size
        for i in range(n_chunks):
            chunk = blob[i * chunk_size : (i + 1) * chunk_size]
            h = wire.make_header(
                command=Command.sync_checkpoint, cluster=self.cluster,
                view=self.view, replica=self.replica,
                op=int(sb["commit_min"]), commit=self.commit_min,
                context=blob_checksum, checkpoint_id=commit_min_checksum,
                request=i, timestamp=len(blob),
            )
            wire.finalize_header(h, chunk)
            self.bus.send(dst, h, chunk)

    def _on_request_sync(self, header: np.ndarray, body: bytes) -> None:
        self._send_sync_checkpoint(int(header["replica"]))

    def _on_sync_checkpoint(self, header: np.ndarray, body: bytes) -> None:
        checkpoint_op = int(header["op"])
        if checkpoint_op <= self.commit_min:
            # Already past it; drop any partial chunk assembly for this
            # obsolete checkpoint.
            self._sync_chunks.pop(wire.u128(header, "context"), None)
            return
        blob_checksum = wire.u128(header, "context")
        total = int(header["timestamp"])
        chunk_size = self.config.message_body_size_max
        state = self._sync_chunks.setdefault(blob_checksum, {})
        state[int(header["request"])] = body
        assembled = b"".join(
            state.get(i, b"")
            for i in range((total + chunk_size - 1) // chunk_size)
        )
        if len(assembled) != total:
            return  # still incomplete
        if wire.checksum(assembled) != blob_checksum:
            del self._sync_chunks[blob_checksum]
            return
        self._install_sync_checkpoint(
            assembled, checkpoint_op, wire.u128(header, "checkpoint_id"),
            blob_checksum, int(header["commit"]),
        )

    def _install_sync_checkpoint(self, payload: bytes, checkpoint_op: int,
                                 commit_min_checksum: int, blob_checksum: int,
                                 remote_commit: int) -> None:
        assert checkpoint_op > self.commit_min  # guarded at receive
        self._ckpt_join()  # superblock writes serialize with async flips
        # Shipped grid blocks must land BEFORE restore: restoring a
        # spilled snapshot reads the LSM tier to rebuild directories.
        try:
            blob = self._sync_unwrap(payload)
        except (ValueError, KeyError, TypeError):
            # Malformed sync payload from a peer (SnapshotError is a
            # ValueError; geometry checks raise ValueError; missing
            # state keys raise KeyError; type-confused entries — e.g.
            # `blocks` encoded as an int — raise TypeError in the
            # len()/int() geometry code): drop it and retry later —
            # a buggy peer must not crash this replica.
            return
        self._restore_snapshot(blob)
        self.sm.prepare_timestamp = self.sm.commit_timestamp

        region = int(self.superblock.working["sequence"]) % 2
        offset = self._grid_region_offset(region, len(blob))
        self._write_grid(offset, blob)
        if self.forest is not None:
            self.forest.grid.flush_writes()
        self.storage.sync()
        self.superblock.checkpoint(
            commit_min=checkpoint_op,
            commit_min_checksum=commit_min_checksum,
            commit_max=max(self.commit_max, remote_commit),
            checkpoint_offset=offset,
            checkpoint_size=len(blob),
            checkpoint_checksum=wire.checksum(blob),
            view=self.view,
            # The shipped blob restored the source's committed
            # membership (_restore_snapshot); carrying the OLD fields
            # forward here would resurrect the pre-sync epoch on
            # restart.
            epoch=self.epoch,
            members=self.members,
            # Recomputed from the state the blob restored, so a
            # restart's recompute-and-assert covers synced
            # checkpoints too.
            state_root=(
                int.from_bytes(self.sm.state_root(), "little")
                if hasattr(self.sm, "state_root")
                else 0
            ),
        )
        self.checkpoint_op = checkpoint_op
        self.commit_min = checkpoint_op
        self.commit_max = max(self.commit_max, remote_commit)
        self.commit_parent = commit_min_checksum
        # State sync supersedes WAL repair only BELOW the new
        # checkpoint (reference: src/vsr/sync.zig).  A journal tail
        # above it — e.g. the canonical tail a new primary adopted via
        # DVC before syncing its lagging prefix — holds committed ops
        # that MUST survive: truncating to checkpoint_op here would
        # make the primary's start_view advertise the shorter log and
        # wipe the committed suffix cluster-wide (found by the VOPR
        # corruption nemesis, seed 8006).
        if self.op <= checkpoint_op:
            self.op = checkpoint_op
            self.parent_checksum = commit_min_checksum
            # The checkpoint's commit_min_checksum IS the authoritative
            # head anchor now — without this, a sync during anchor
            # resolution leaves every prepare path gated forever (the
            # pin it was waiting on is cleared below).
            self._anchor_pending = False
            self._repair_wanted.clear()
            self._stash.clear()
        else:
            for o in [o for o in self._repair_wanted if o <= checkpoint_op]:
                del self._repair_wanted[o]
            for o in [o for o in self._stash if o <= checkpoint_op]:
                del self._stash[o]
        self._canon_pending = False
        self._sync_chunks.clear()
        self._advance_commit(self.commit_max)
        if self._repair_wanted:
            self._send_repair_requests(force=True)

    # ------------------------------------------------------------------
    # View change.

    def _enter_view(self, view: int) -> None:
        """Adopt a higher view as a backup in normal status.

        Entering PASSIVELY (we missed the view change) means our
        uncommitted journal tail may hold superseded siblings of the
        canonical ops (same parent, different content) — commits are
        gated until the new primary's start_view installs the canonical
        tail (reference: Command.request_start_view)."""
        assert view > self.view
        self.view = view
        self.status = "normal"
        self.log_view = view
        # Passive entry: the new view's canonical is NOT installed, so
        # our tail above commit_min is unconfirmed — persisting it as
        # this log_view's claim would make a superseded-sibling tail
        # durable and top-cohort.  Claim only the committed prefix
        # (always within the recovered journal, so restart-neutral).
        self._ckpt_join()  # superblock writes serialize with async flips
        self.superblock.view_change(
            self.view, self.log_view, self.commit_max,
            op_claimed=self.commit_min,
            # The previously-installed canonical suffix is KEPT (not
            # cleared): it is still our best durable knowledge of the
            # uncommitted range, and clearing it would reopen the
            # stale-carrier crash window right here (crash after
            # passive entry, before this view's start_view arrives,
            # restarts vouching raw ring siblings at the freshest
            # log_view).  If this view's canonical replaced any of
            # those ops, its copies carry a higher prepare-view and
            # win the merge tie-break; ring entries prepared in this
            # view likewise outrank the kept suffix in _tail_headers.
        )
        self.pipeline.clear()
        if self._np is not None:
            self._np.reset()
        self.request_queue.clear()
        self._queue_tenants.clear()
        self._tenant_depth.clear()
        # The queue is empty: any open overload episode closes with it
        # (left latched, the new view's first drain would run WFQ
        # order with no shed since — breaking the differential
        # contract's strict-FIFO-outside-an-episode guarantee).
        self._qos_episode = False
        self._queued_keys.clear()
        self._svc_votes.clear()
        self._dvc.clear()
        # Old-view vouches above the commit frontier are void: the new
        # view may have chosen different siblings there.
        for k in [k for k in self._vouched if k > self.commit_min]:
            del self._vouched[k]
        self._last_primary_seen = self._ticks
        if self.op > self.commit_min and not self.is_primary:
            self._canon_pending = True
            self._request_start_view()

    def _request_start_view(self) -> None:
        h = wire.make_header(
            command=Command.request_start_view, cluster=self.cluster,
            view=self.view, replica=self.replica,
        )
        wire.finalize_header(h, b"")
        self.bus.send(self.primary_index(), h, b"")

    def _on_request_start_view(self, header: np.ndarray, body: bytes) -> None:
        if (
            int(header["view"]) == self.view
            and self.status == "normal"
            and self.is_primary
        ):
            self._send_start_view(dst=int(header["replica"]))

    def _start_view_change(self, view: int) -> None:
        for k in [k for k in self._vouched if k > self.commit_min]:
            del self._vouched[k]
        self._canon_pending = False  # the DVC/start_view round re-canonizes
        self.status = "view_change"
        self.view = view
        self._svc_votes.setdefault(view, set()).add(self.replica)
        self._broadcast_svc()

    def _broadcast_svc(self) -> None:
        self._vc_last_sent = self._ticks
        h = wire.make_header(
            command=Command.start_view_change, cluster=self.cluster,
            view=self.view, replica=self.replica,
        )
        wire.finalize_header(h, b"")
        for r in range(self.replica_count):
            if r != self.replica:
                self.bus.send(r, h, b"")

    def _on_start_view_change(self, header: np.ndarray, body: bytes) -> None:
        if self.standby:
            return  # non-voting; the start_view brings the outcome
        view = int(header["view"])
        if view < self.view:
            return
        if view > self.view or self.status == "normal":
            if view == self.view and self.status == "normal":
                # A replica re-running view change for OUR live view
                # (e.g. rejoining after a crash with an unconfirmed
                # tail): the primary hands it the canonical view state
                # (reference: request_start_view).
                if self.is_primary:
                    self._send_start_view(dst=int(header["replica"]))
                return
            self._start_view_change(max(view, self.view))
        self._svc_votes.setdefault(self.view, set()).add(int(header["replica"]))
        votes = self._svc_votes.get(self.view, set())
        if len(votes) >= self.quorum_view_change:
            self._send_do_view_change()

    def _send_do_view_change(self) -> None:
        if self.standby:
            return
        # Persist before participating (reference: superblock view_change).
        self._ckpt_join()  # superblock writes serialize with async flips
        self.superblock.view_change(
            self.view, self.log_view, self.commit_max,
            op_claimed=self.op,
        )
        payload = {
            "log_view": self.log_view,
            "op": self.op,
            "commit_min": self.commit_min,
            "headers": self._tail_headers(),
        }
        body = _encode_dvc(payload)
        h = wire.make_header(
            command=Command.do_view_change, cluster=self.cluster,
            view=self.view, replica=self.replica, op=self.op,
            commit=self.commit_min,
        )
        wire.finalize_header(h, body)
        target = self.primary_index()
        if target == self.replica:
            self._on_do_view_change(h, body)
        else:
            self.bus.send(target, h, body)

    def _tail_headers(self) -> list[bytes]:
        """Headers of EVERY op we know above commit_min — from the
        in-memory redundant ring, which recovery populates even for
        slots whose prepares are torn or corrupt.  A damaged replica
        thus still VOUCHES for committed ops it can no longer read:
        the new primary pins their checksums and repairs the bodies
        from peers instead of silently truncating them (the reference
        gets the same property from DVC headers + nacks; understating
        DVCs lost committed ops — VOPR seed 8018).

        The superblock's persisted canonical suffix overrides ring
        entries prepared BEFORE the log_view that installed it
        (vh_log_view): those are pre-merge siblings the install
        superseded (durable in our ring only because the crash beat
        the repair).  Ring entries prepared at the install point or
        later postdate it (that view's — or, after passive entries, a
        newer view's — own prepares) and win."""
        by_op: dict[int, np.ndarray] = {}
        for slot in range(self.journal.slot_count):
            h = self.journal.headers[slot]
            if int(h["command"]) != int(Command.prepare):
                continue
            op = int(h["op"])
            # Bounded by our head claim: ring leftovers ABOVE the
            # recovered head are stale garbage from older generations
            # and must not ride into the canonical merge (VOPR seed
            # 8005); everything within (commit_min, op] is our
            # knowledge of the current history — including ops whose
            # prepares are damaged, which the redundant header still
            # vouches (VOPR seeds 8006/8018).  Sub-commit_min ops are
            # deliberately absent: for them "later view wins" is
            # unsound (a dead-view sibling can outrank the committed
            # one — widening this bound to the checkpoint broke
            # deep-slice seeds 8000/8003); their immutability is
            # enforced receiver-side in _install_log instead.
            if not self.commit_min < op <= self.op:
                continue
            if not wire.verify_header(h):
                continue
            by_op[op] = h
        vh_log_view = int(self.superblock.working["vh_log_view"])
        vh_top = 0
        for raw in self.superblock.view_headers():
            h = wire.header_from_bytes(raw)
            if not wire.verify_header(h):
                continue
            op = int(h["op"])
            if not self.commit_min < op <= self.op:
                continue
            cur = by_op.get(op)
            if cur is None or int(cur["view"]) < vh_log_view:
                by_op[op] = h
            vh_top = max(vh_top, op)
        # Chain-consistency above the vouched canonical suffix: an
        # install truncates the old tail only IN MEMORY — the ring
        # still physically holds it, and a crash-restart resurrects it
        # into the recovered head.  A dead leftover both PREDATING the
        # install (view < vh_log_view) and NOT chaining from the
        # canonical would ship a MIXED chain; the receiving merge's
        # sanitize resolves the contradiction by dropping the TRUE
        # canonical op below it, and the dead suffix gets installed
        # and committed — replica divergence (soak seed 323928758).
        if vh_top and vh_top in by_op:
            expect = wire.u128(by_op[vh_top], "checksum")
            prev = vh_top
            for o in sorted(k for k in by_op if k > vh_top):
                h = by_op[o]
                if o != prev + 1:
                    expect = None  # gap: linkage unverifiable above it
                prev = o
                verified = expect is not None and (
                    wire.u128(h, "parent") == expect
                )
                if verified or int(h["view"]) >= vh_log_view:
                    # Chains from the canonical, or postdates the
                    # install (the new view's own prepare): keep, and
                    # it defines the verified frontier upward.
                    expect = wire.u128(h, "checksum")
                    continue
                # Predates the install and cannot be positively linked
                # (contradicts the frontier, or sits above a gap that
                # makes linkage unverifiable): dead leftover — do NOT
                # stop at the first one, later ring entries above a
                # gap are equally suspect.
                del by_op[o]
                expect = None
        return [by_op[op].tobytes() for op in sorted(by_op)]

    def _on_do_view_change(self, header: np.ndarray, body: bytes) -> None:
        view = int(header["view"])
        if view < self.view:
            return
        if view > self.view:
            self._start_view_change(view)
        if self.primary_index(view) != self.replica:
            return
        self._dvc[int(header["replica"])] = _decode_dvc(body)
        if self.replica not in self._dvc:
            self._ckpt_join()
            self.superblock.view_change(
                self.view, self.log_view, self.commit_max,
                op_claimed=self.op,
            )
            self._dvc[self.replica] = {
                "log_view": self.log_view, "op": self.op,
                "commit_min": self.commit_min, "headers": self._tail_headers(),
            }
        if len(self._dvc) < self.quorum_view_change:
            return
        if self.status != "view_change":
            return

        # Adopt the longest log of the highest log_view (VRR rule),
        # MERGING headers across the highest-log_view cohort: each DVC
        # vouches for every op its redundant ring knows, so the union
        # covers committed ops even when every cohort member's
        # chain-verified head understates (recovery truncation).
        # Same-op conflicts (a stale sibling surviving in one ring)
        # resolve to the header prepared in the later view.
        best_log_view = max(d["log_view"] for d in self._dvc.values())
        cohort = [
            d for d in self._dvc.values()
            if d["log_view"] == best_log_view
        ]
        op_claimed = max(d["op"] for d in cohort)
        commit_floor = max(d["commit_min"] for d in self._dvc.values())
        # Merge headers from EVERY DVC (not only the top cohort: a
        # cohort member can claim a canonical tail whose prepares it
        # never finished repairing, while an older-view replica still
        # holds the committed headers — truncating at the hole
        # re-prepared NEW ops at committed numbers, VOPR seed
        # 1064614514).  Same-op conflicts resolve by the CARRIER's
        # log_view (VRR): the copy carried by the DVC with the
        # freshest installed canonical wins; the header's own
        # prepare-view only tie-breaks equal carriers.  Resolving by
        # prepare-view alone let a dead higher-view sibling held by a
        # stale replica beat the committed lower-view copy, rewriting
        # committed slots and chain-breaking every journal (VOPR seed
        # 925761995).  A stale carrier additionally cannot nominate
        # content at or below the quorum's commit floor.  (The
        # reference closes the residual uncertainty with its DVC nack
        # quorum, src/vsr/replica.zig.)
        best: dict[int, tuple[int, np.ndarray]] = {}
        for d in self._dvc.values():
            for raw in d["headers"]:
                h = wire.header_from_bytes(raw)
                if not wire.verify_header(h):
                    continue
                op = int(h["op"])
                if op > op_claimed:
                    continue  # beyond the canonical claim: stale tail
                if d["log_view"] < best_log_view and op <= commit_floor:
                    continue
                cur = best.get(op)
                if cur is None or d["log_view"] > cur[0] or (
                    d["log_view"] == cur[0]
                    and int(h["view"]) > int(cur[1]["view"])
                ):
                    best[op] = (d["log_view"], h)
        canonical = [best[op][1] for op in sorted(best)]
        self._install_log(canonical, op_claimed, commit_floor)

        self.status = "normal"
        self.log_view = self.view
        self._ckpt_join()
        self.superblock.view_change(
            self.view, self.log_view, self.commit_max,
            op_claimed=self.op,
            view_headers=[
                h.tobytes() for h in self._installed_canonical
                if int(h["op"]) > self.commit_min
            ],
        )
        self._svc_votes.clear()
        self._dvc.clear()
        self._send_start_view()
        self._advance_commit(self.commit_max)
        self._primary_requeue_uncommitted()

    def _install_log(self, canonical: list[np.ndarray], op_claimed: int,
                     commit_floor: int,
                     head_checksum: int | None = None,
                     min_head: int = 0) -> None:
        """Make our journal match the canonical tail, requesting any
        prepares we don't hold.

        `op_claimed` is the sender's op; its header tail may stop short
        of it (journal holes skip headers), in which case only the ops
        we have headers for are adopted — anything above is uncommitted
        (committed ops always reach a quorum's journals) and truncates.

        `min_head` (same-view reinstalls): a delayed duplicate
        start_view must still install its canonical headers (repair
        pins for stale siblings) but must NOT regress our head below
        the same-view tail we already hold — our vouches and anchor
        above its coverage stand.
        """
        self._canon_pending = False  # the canonical tail is now known
        was_anchor_pending = self._anchor_pending
        # Sanitize: within a canonical chain the highest header is
        # authoritative downward via parent links.  An entry whose
        # checksum contradicts the entry above it is a provably stale
        # sibling that leaked into a merge (a committed op can be
        # invisible to every DVC, bounded by commit_min, while an old
        # sibling in someone's ring is not).  Adopting such an entry
        # rewrote the committed slot while KEEPING the op above that
        # vouches its replacement — permanently chain-breaking every
        # journal in the cluster (VOPR seed 925761995).  Dropping it
        # leaves a hole; receivers pin the true checksum from the op
        # above via the chain walk and repair from whoever holds it.
        by_op = {int(h["op"]): h for h in canonical}
        for op in sorted(by_op, reverse=True):
            above = by_op.get(op + 1)
            if above is not None and wire.u128(above, "parent") != wire.u128(
                by_op[op], "checksum"
            ):
                del by_op[op]
        canonical = [by_op[op] for op in sorted(by_op)]
        # Stash the sanitized canonical for durable persistence: the
        # caller records its suffix in the superblock atomically with
        # log_view (see superblock.view_headers) so a crash between
        # install and journal repair cannot resurrect pre-merge
        # siblings into our next DVC.
        self._installed_canonical = list(canonical)
        covered = max([int(h["op"]) for h in canonical] + [op_claimed])
        # The canonical headers vouch their checksums for the commit
        # gate; anything above commit_min not re-vouched here is stale
        # — except same-view tail ops beyond a duplicate's coverage.
        for k in [
            k for k in self._vouched
            if k > self.commit_min and (not min_head or k <= covered)
        ]:
            del self._vouched[k]
        # Checksum pins from the previous view are equally stale in
        # the covered range: a surviving pin is a standing order to
        # OVERWRITE its slot the moment a matching (dead-view) prepare
        # arrives — which clobbered a newly-prepared canonical op and
        # hijacked the head anchor (seed 460991023).  The install
        # re-pins below exactly what it still wants; the same-view-
        # reinstall branch below re-arms the pending-anchor pin it
        # depends on (the pin must not simply be EXEMPTED here — a
        # resolved-but-stale anchor pin surviving into a head-found
        # install would recreate the standing-overwrite hazard).
        for k in [
            k for k in self._repair_wanted
            if k > self.commit_min and (not min_head or k <= covered)
        ]:
            del self._repair_wanted[k]
        for h in canonical:
            if int(h["op"]) > self.commit_min:
                self._vouched[int(h["op"])] = wire.u128(h, "checksum")
        have_ops = [int(h["op"]) for h in canonical]
        # Never regress below our own commit frontier: committed ops
        # are immutable.
        op_head = max(
            max(have_ops) if have_ops else 0, commit_floor,
            self.commit_min, min_head,
        )
        for h in canonical:
            op = int(h["op"])
            if op > op_head:
                continue
            if op <= self.commit_min:
                # WE committed this op: its journal slot is immutable.
                # A canonical header that disagrees is a stale sibling
                # that leaked into the merge (a committed op can fall
                # out of its holder's DVC, bounded by commit_min) —
                # adopting it rewrote committed slots and left an
                # unserviceable chain break (VOPR seed 925761995).
                # Peers missing the op repair by the exact checksum
                # the op above vouches.
                continue
            checksum = wire.u128(h, "checksum")
            have = self.journal.read_prepare(op)
            if have is not None and wire.u128(have[0], "checksum") == checksum:
                continue
            self._repair_wanted[op] = checksum
        self.op = op_head
        self.commit_max = max(self.commit_max, commit_floor)
        head = next(
            (h for h in canonical if int(h["op"]) == op_head), None
        )
        self._anchor_pending = False
        if head is not None:
            self.parent_checksum = wire.u128(head, "checksum")
        elif min_head and op_head == min_head:
            # Same-view reinstall kept our head: the current anchor
            # (and its pending-resolution state, if any) stands.
            # Deliberately NOT adopting a sender-supplied checksum for
            # this op even when op_claimed matches: a delayed
            # duplicate's head claim can name a superseded sibling of
            # the tail we already vouch (empirically diverges state —
            # VOPR deep-slice seed 8000); the pin-resolution round
            # trip is the safe path for a genuinely pending anchor.
            self._anchor_pending = was_anchor_pending
            if was_anchor_pending and op_head not in self._repair_wanted:
                # The pin sweep above dropped the pending anchor's
                # pin; without it nothing requests anything and the
                # resolution round trip dies (the deep-lag state-sync
                # wedge).  Re-arm from 0 (re-resolve).
                self._repair_wanted[op_head] = 0
                self._anchor_pin_view = -1
        elif head_checksum is not None and op_head == op_claimed:
            # No header covers op_head (e.g. the sender state-synced and
            # its checkpoint op is not journaled): anchor on the
            # sender's explicit head checksum instead of a stale local
            # one — a wrong anchor would poison the chain-repair pins.
            self.parent_checksum = head_checksum
        else:
            # Unknown anchor: do not run the chain walk against a
            # possibly-stale parent_checksum — and do NOT prepare new
            # ops on it either.  Pin the head for header resolution
            # (want=0 resolves to a checksum via request_headers, then
            # the prepare repairs by checksum); _maybe_resolve_anchor
            # re-anchors once the head prepare is local.
            if op_head > 0:
                self._anchor_pending = True
                # Force 0 (re-resolve): a leftover nonzero pin from an
                # older view could name a superseded sibling.
                self._repair_wanted[op_head] = 0
                self._anchor_pin_view = -1
            if self._repair_wanted:
                self._send_repair_requests(force=True)
            return
        self._verify_chain_down()
        if self._repair_wanted:
            self._send_repair_requests(force=True)

    def _verify_chain_down(self) -> None:
        """Walk the journal from the canonical head toward commit_min,
        verifying each prepare's checksum against its successor's
        `parent`.  The first missing/mismatched op (a superseded
        sibling from an older view) is pinned for exact-checksum
        repair.  While the walk cannot reach commit_min, the whole
        uncommitted range is SUSPECT (deeper siblings may hide below
        the unverified op) and commits are gated (_advance_commit)."""
        if self._anchor_pending:
            # parent_checksum is stale while the canonical head is
            # unresolved: a walk from it derives GARBAGE pins (seed
            # 377174739: a pin for op N naming another op's checksum
            # gated commits forever).  Stay suspect; the walk re-runs
            # from the true anchor once it resolves.
            self._chain_suspect = True
            return
        expect = self.parent_checksum
        for op in range(self.op, self.commit_min, -1):
            read = self.journal.read_prepare(op)
            if read is None or wire.u128(read[0], "checksum") != expect:
                self._repair_wanted[op] = expect
                self._chain_suspect = True
                self._send_repair_requests()
                return
            # Verified against the canonical chain: any pin for this
            # op is obsolete (a different-sibling pin is stale garbage
            # that would gate commits forever; a matching pin is
            # simply satisfied) — drop it.
            self._repair_wanted.pop(op, None)
            expect = wire.u128(read[0], "parent")
        self._chain_suspect = False

    def _send_start_view(self, dst: int | None = None) -> None:
        body = _encode_dvc({
            "log_view": self.log_view, "op": self.op,
            "commit_min": self.commit_min, "headers": self._tail_headers(),
            # While the canonical head is unresolved, parent_checksum
            # is a stale pre-install value: advertising it would make
            # backups adopt it as their anchor (head_checksum=0
            # decodes to None — receivers run their own unknown-anchor
            # resolution instead).
            "head_checksum": 0 if self._anchor_pending
            else self.parent_checksum,
        })
        h = wire.make_header(
            command=Command.start_view, cluster=self.cluster, view=self.view,
            replica=self.replica, op=self.op, commit=self.commit_min,
        )
        wire.finalize_header(h, body)
        targets = (
            [dst] if dst is not None
            else [r for r in range(self.total_count) if r != self.replica]
        )
        for r in targets:
            self.bus.send(r, h, body)

    def _on_start_view(self, header: np.ndarray, body: bytes) -> None:
        view = int(header["view"])
        if view < self.view:
            return
        if view == self.view and int(header["op"]) < self.commit_min:
            # Stale/delayed start_view for the current view (e.g. a
            # rejoin-help reply that raced past newer commits): adopting
            # it would regress op below our commit frontier.
            return
        payload = _decode_dvc(body)
        # Within an installed view the primary's log only grows, so a
        # same-view start_view claiming less than our op is a delayed
        # duplicate (lossy-network reordering).  Its HEADERS still
        # carry canonical knowledge worth installing (pins for stale
        # siblings below the claim — dropping the message outright
        # regressed repairs, seed 8000), but our head must not regress
        # to its stale claim (a regressed head with a stale anchor
        # derived garbage pins, seed 377174739).
        same_view_reinstall = view == self.view and self.log_view == view
        self.view = view
        self.status = "normal"
        self.log_view = view
        canonical = [wire.header_from_bytes(raw) for raw in payload["headers"]]
        self._install_log(
            canonical, payload["op"], int(header["commit"]),
            head_checksum=payload.get("head_checksum"),
            min_head=self.op if same_view_reinstall else 0,
        )
        # Persist the installed canonical suffix with log_view.  A
        # same-view reinstall merges with the already-persisted set:
        # a delayed duplicate's shorter coverage must not shed the
        # durable vouch for tail ops we already installed.  Merge ONLY
        # when the persisted suffix was installed at THIS log_view —
        # after a passive entry (which keeps the older suffix) the
        # first start_view also matches same_view_reinstall, and
        # merging would re-stamp the older view's headers at the
        # current vh_log_view, elevating them above intermediate-view
        # ring entries in _tail_headers.
        vh: dict[int, bytes] = {}
        if same_view_reinstall and (
            int(self.superblock.working["vh_log_view"]) == self.log_view
        ):
            for raw in self.superblock.view_headers():
                prev = wire.header_from_bytes(raw)
                if wire.verify_header(prev):
                    vh[int(prev["op"])] = raw
        for ch in self._installed_canonical:
            vh[int(ch["op"])] = ch.tobytes()
        self._ckpt_join()
        self.superblock.view_change(
            self.view, self.log_view, self.commit_max,
            op_claimed=self.op,
            view_headers=[
                vh[op] for op in sorted(vh) if op > self.commit_min
            ],
        )
        self._svc_votes.clear()
        self._dvc.clear()
        self._last_primary_seen = self._ticks
        self._advance_commit(self.commit_max)


# ----------------------------------------------------------------------
# DVC/SV body codec: length-prefixed header list + scalars.


def _encode_dvc(payload: dict) -> bytes:
    import struct

    head = payload.get("head_checksum") or 0
    parts = [
        struct.pack(
            "<QQQQQI",
            payload["log_view"], payload["op"], payload["commit_min"],
            head & 0xFFFFFFFFFFFFFFFF, head >> 64,
            len(payload["headers"]),
        )
    ]
    parts.extend(payload["headers"])
    return b"".join(parts)


def _decode_dvc(body: bytes) -> dict:
    import struct

    log_view, op, commit_min, head_lo, head_hi, n = struct.unpack_from(
        "<QQQQQI", body, 0
    )
    off = 44
    headers = []
    from tigerbeetle_tpu_torch.constants import HEADER_SIZE

    for _ in range(n):
        headers.append(body[off : off + HEADER_SIZE])
        off += HEADER_SIZE
    return {
        "log_view": log_view, "op": op, "commit_min": commit_min,
        "headers": headers,
        "head_checksum": (head_lo | (head_hi << 64)) or None,
    }
