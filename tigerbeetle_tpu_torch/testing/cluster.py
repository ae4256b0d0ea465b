"""Deterministic in-process cluster: N replicas + clients, one thread.

The reference tests multi-node behavior without a real cluster by
instantiating every replica and client in one process over a simulated
network/storage/time (reference: src/testing/cluster.zig:56-70,
packet_simulator.zig:10-40).  Same pattern here: a seeded
`PacketSimulator` delivers bus messages with delay/loss/partitions,
`Cluster.step()` advances one tick, and identical seeds give identical
runs — which is also how card-vs-CPU state parity is checked
reproducibly.

This package's own copy of ``tigerbeetle_tpu/testing/cluster.py``
(``PacketSimulator``, ``SimClient``, ``SimAof``, ``Cluster``,
``SimFollower``, the router's sharded harness ``SimRouter`` /
``RoutedClient`` / ``ShardedCluster``, and the trace tools
``merge_traces`` and ``trace_demo``); the default state machine is the
port's oracle ``state_machine/cpu.py``.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import qos as qos_mod
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import CpuStateMachine
from tigerbeetle_tpu_torch.testing.hash_log import HashLog
from tigerbeetle_tpu_torch.vsr import replica as vsr_format
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.multi import VsrReplica
from tigerbeetle_tpu_torch.vsr.storage import MemoryStorage, ZoneLayout
from tigerbeetle_tpu_torch.vsr.wire import Command, VsrOperation


@dataclasses.dataclass
class PacketOptions:
    """reference: src/testing/packet_simulator.zig:10-40."""

    one_way_delay_min: int = 1
    one_way_delay_max: int = 3
    packet_loss_probability: float = 0.0
    packet_replay_probability: float = 0.0


class PacketSimulator:
    """Seeded delay/loss/replay/partition between endpoints.

    Endpoints: replicas are ints 0..n-1; clients are u128 client ids.
    """

    def __init__(self, options: PacketOptions, seed: int = 0) -> None:
        self.options = options
        self.rng = np.random.default_rng(seed)
        self.now = 0
        self._queue: list[tuple[int, int, object]] = []  # (tick, seq, packet)
        self._seq = 0
        self.partitioned: set = set()  # endpoints cut off from everyone

    def partition(self, *endpoints) -> None:
        self.partitioned.update(endpoints)

    def heal(self, *endpoints) -> None:
        if endpoints:
            self.partitioned.difference_update(endpoints)
        else:
            self.partitioned.clear()

    def submit(self, src, dst, header: np.ndarray, body: bytes) -> None:
        if src in self.partitioned or dst in self.partitioned:
            return
        if self.rng.random() < self.options.packet_loss_probability:
            return
        copies = 1
        if self.rng.random() < self.options.packet_replay_probability:
            copies = 2
        for _ in range(copies):
            delay = int(
                self.rng.integers(
                    self.options.one_way_delay_min,
                    self.options.one_way_delay_max + 1,
                )
            )
            heapq.heappush(
                self._queue,
                (self.now + delay, self._seq, (src, dst, header.copy(), body)),
            )
            self._seq += 1

    def advance(self, deliver) -> None:
        """One tick: pop every packet due now and hand to `deliver`."""
        self.now += 1
        while self._queue and self._queue[0][0] <= self.now:
            _, _, (src, dst, header, body) = heapq.heappop(self._queue)
            if src in self.partitioned or dst in self.partitioned:
                continue
            deliver(dst, header, body)


class _Bus:
    """Per-replica bus endpoint feeding the packet simulator.  `src`
    is the PROCESS index; protocol messages address SLOTS, which the
    slot map (reconfiguration) translates back to processes."""

    def __init__(self, cluster: "Cluster", src) -> None:
        self.cluster = cluster
        self.src = src
        self._slot_map: list[int] | None = None

    def set_slot_map(self, members) -> None:
        self._slot_map = list(members)

    def send(self, dst: int, header: np.ndarray, body: bytes) -> None:
        if self._slot_map is not None and dst < len(self._slot_map):
            dst = self._slot_map[dst]
        self.cluster.network.submit(self.src, dst, header, body)

    def send_client(self, client: int, header: np.ndarray, body: bytes) -> None:
        self.cluster.network.submit(self.src, client, header, body)


class SimClient:
    """Driver-side client session: register, pipelined-one request,
    retransmit on timeout (reference: src/vsr/client.zig:18-120).

    A typed client_busy backs the retransmit cadence off with capped
    exponential delay + deterministic jitter (TB_BUSY_BACKOFF_MS):
    a shed storm answered by immediate retransmits
    re-offers the same overload and self-amplifies.  One sim tick is
    10 ms (constants.TICK_NS), so the ms knob converts directly; 0
    disables (the legacy immediate-cadence behavior)."""

    RETRY_TICKS = 8

    def __init__(self, cluster: "Cluster", client_id: int) -> None:
        from tigerbeetle_tpu_torch import envcheck

        self.cluster = cluster
        self.id = client_id
        self.request_number = 0
        self.view_guess = 0
        self.reply: bytes | None = None
        self.registered = False
        self.evicted = False
        self.busy_replies = 0  # typed admission sheds received
        self.busy_backoffs = 0  # retransmits delayed by busy backoff
        self._backoff_base_ticks = int(
            round(envcheck.busy_backoff_ms() * 1e6 / cfg.TICK_NS)
        )
        self._busy_streak = 0
        self._backoff_until = -(10**9)
        self._inflight: tuple[np.ndarray, bytes] | None = None
        self._last_sent = -(10**9)
        self.replies: list[bytes] = []
        # Serving-tier attribution: which tier answered the
        # latest reply — ("primary"|"follower", server id, claimed
        # commit_min).  Primary replies carry no attestation carve-out
        # and report commit_min 0 here.
        self.reply_tier: tuple | None = None
        self.reply_tiers: list[tuple] = []

    # -- wire --

    def on_message(self, header: np.ndarray, body: bytes) -> None:
        if not wire.verify_header(header, body):
            return
        cmd = Command(int(header["command"]))
        if cmd == Command.client_busy:
            # Typed admission shed: NOT fatal — the request was never
            # admitted; the retransmission cadence retries it, backed
            # off exponentially per CONSECUTIVE busy (reset on reply)
            # with deterministic jitter so a fleet of shed clients
            # doesn't re-converge on one retry instant.
            self.busy_replies += 1
            if (
                self._backoff_base_ticks > 0
                and self._inflight is not None
                # A stale busy for an ALREADY-COMPLETED request (one
                # retransmit copy shed, another committed and replied)
                # must not inflate the streak or delay the CURRENT
                # request's cadence.
                and int(header["request"])
                == int(self._inflight[0]["request"])
            ):
                self._busy_streak += 1
                self._backoff_until = (
                    self.cluster.network.now + qos_mod.backoff_delay(
                        self.id, self.request_number, self._busy_streak,
                        self._backoff_base_ticks,
                    )
                )
                self.busy_backoffs += 1
            return
        if cmd == Command.eviction:
            # Fatal for the session (reference clients surface this as
            # a terminal error); recorded, not raised, so a multi-client
            # harness keeps stepping.
            self.evicted = True
            self._inflight = None
            return
        if cmd != Command.reply:
            return
        if self._inflight is None:
            return
        want_request = int(self._inflight[0]["request"])
        if int(header["request"]) != want_request:
            return
        self.view_guess = max(self.view_guess, int(header["view"]))
        if int(self._inflight[0]["operation"]) == int(VsrOperation.register):
            self.registered = True
        self._inflight = None
        self._busy_streak = 0
        self._backoff_until = -(10**9)
        self.reply = body
        self.replies.append(body)
        att = wire.attestation_of(header)
        self.reply_tier = (
            ("primary", int(header["replica"]), 0) if att is None
            else ("follower", int(header["replica"]), att[1])
        )
        self.reply_tiers.append(self.reply_tier)

    def tick(self) -> None:
        if self._inflight is None:
            return
        if self.cluster.network.now < self._backoff_until:
            return  # busy backoff window: hold the retransmit cadence
        if self.cluster.network.now - self._last_sent >= self.RETRY_TICKS:
            self._send(broadcast=True)

    # -- api --

    def busy(self) -> bool:
        return self._inflight is not None

    def register(self) -> None:
        assert not self.busy()
        h = wire.make_header(
            command=Command.request, operation=VsrOperation.register,
            cluster=self.cluster.cluster_id, client=self.id, request=0,
        )
        wire.finalize_header(h, b"")
        self._inflight = (h, b"")
        self._send()

    def request(self, operation: types.Operation, body: bytes, *,
                tenant: int = 0) -> None:
        assert self.registered and not self.busy()
        self.request_number += 1
        import time as _time

        h = wire.make_header(
            command=Command.request, operation=operation,
            cluster=self.cluster.cluster_id, client=self.id,
            request=self.request_number,
            # Explicit tenant stamp: 0 = derive from the
            # body's leading event (the legacy-client path).
            tenant=tenant,
            # Wire trace context from client submit: the id is a
            # deterministic function of (client, request) so seeded
            # runs stay reproducible; the origin timestamp is real
            # CLOCK_MONOTONIC — observability only, never state.
            trace_id=((self.id << 20) ^ self.request_number)
            & 0xFFFFFFFFFFFFFFFF,
            trace_ts=_time.perf_counter_ns(),
            trace_flags=wire.TRACE_SAMPLED,
        )
        wire.finalize_header(h, body)
        self.reply = None
        self._inflight = (h, body)
        self._send()

    def _send(self, broadcast: bool = False) -> None:
        assert self._inflight is not None
        self._last_sent = self.cluster.network.now
        header, body = self._inflight
        targets = (
            range(self.cluster.replica_count)
            if broadcast
            else [self.view_guess % self.cluster.replica_count]
        )
        for r in targets:
            self.cluster.network.submit(
                self.id, self.cluster.process_of_slot(r), header, body
            )


class SimAof:
    """In-memory twin of vsr.aof.AOF for the deterministic cluster:
    same write/sync surface, bytes visible to tailers the moment they
    are written (page-cache semantics — a real tailer reads unsynced
    appends too), crash() loses a seeded cut of the unsynced suffix
    (possibly mid-record: the torn tail), reopen() models the
    repair-on-open scan (truncate the torn tail, recover last_op) so a
    restarted replica's recovery gap-fill re-appends exactly the
    committed records the crash erased."""

    def __init__(self) -> None:
        self.buffer = bytearray()
        self.synced_len = 0
        self.last_op = 0

    def write(self, header: np.ndarray, body: bytes) -> None:
        self.buffer += header.tobytes() + body
        if int(header["command"]) == int(Command.prepare):
            self.last_op = max(self.last_op, int(header["op"]))

    def sync(self) -> None:
        self.synced_len = len(self.buffer)

    def close(self) -> None:
        pass

    def source(self):
        from tigerbeetle_tpu_torch.vsr.aof import BytesSource

        return BytesSource(self.buffer)

    def crash(self, rng) -> None:
        """Power loss: keep everything synced plus a seeded prefix of
        the unsynced suffix (a torn trailing record when the cut lands
        mid-record)."""
        keep = int(rng.integers(self.synced_len, len(self.buffer) + 1))
        del self.buffer[keep:]

    def reopen(self) -> "SimAof":
        """The AOF(path, repair=True) scan: truncate a torn tail to
        the verified record boundary and recompute last_op, so
        recovery replay knows which committed ops to re-append."""
        from tigerbeetle_tpu_torch.vsr.aof import AofTail

        tail = AofTail(self.source())
        self.last_op = 0
        while True:
            entries = tail.poll(limit=1024)
            if not entries:
                break
            for header, _body in entries:
                if int(header["command"]) == int(Command.prepare):
                    self.last_op = max(self.last_op, int(header["op"]))
        del self.buffer[tail.offset:]
        self.synced_len = min(self.synced_len, len(self.buffer))
        return self

    def corrupt(self, rng) -> int | None:
        """Flip one byte of a seeded already-written sector (the
        latent-corruption nemesis for tailed logs).  Returns the
        offset, or None when the log is empty."""
        if not self.buffer:
            return None
        at = int(rng.integers(len(self.buffer)))
        self.buffer[at] ^= 0xFF
        return at


class Cluster:
    def __init__(self, replica_count: int = 3, *, seed: int = 0,
                 standby_count: int = 0,
                 config: cfg.Config = cfg.TEST_MIN,
                 options: PacketOptions | None = None,
                 state_machine_factory=None,
                 tenant_qos: dict | None = None,
                 aof_replicas: tuple = (),
                 root_ring: int = 0) -> None:
        self.cluster_id = 0xC1
        self.replica_count = replica_count
        self.standby_count = standby_count
        self.config = config
        self.network = PacketSimulator(options or PacketOptions(), seed)
        factory = state_machine_factory or (lambda: CpuStateMachine(config))
        self._factory = factory
        # Multi-tenant QoS: TenantQos kwargs applied to
        # every replica — including restarts, which build a fresh
        # VsrReplica (a restarted replica silently losing its
        # admission policy would fake isolation coverage in VOPR).
        self.tenant_qos = tenant_qos
        # Follower serving: replicas in `aof_replicas` keep
        # a SimAof a SimFollower can tail; `root_ring` > 0 enables the
        # per-commit root ring on every replica (the at-op attestation
        # source) and the cluster-owned root history — the ground
        # truth the refuse-not-lie audit compares follower replies
        # against.
        self.aofs: dict[int, SimAof] = {
            i: SimAof() for i in aof_replicas
        }
        self.root_ring_size = root_ring
        self.root_history: dict[int, bytes] = {}
        self.followers: list = []

        self.replicas: list[VsrReplica] = []
        self.storages: list[MemoryStorage] = []
        for i in range(replica_count + standby_count):
            storage = MemoryStorage(
                ZoneLayout(config=config, grid_size=1 << 20), seed=seed + i
            )
            vsr_format.format(storage, self.cluster_id, i, replica_count)
            r = VsrReplica(
                storage, self.cluster_id, factory(), _Bus(self, i),
                replica=i, replica_count=replica_count,
                standby_count=standby_count, aof=self.aofs.get(i),
            )
            self._apply_tenant_qos(r)
            r.hash_log = HashLog()
            r.open()
            if self.root_ring_size:
                r.enable_root_ring(self.root_ring_size)
            self.storages.append(storage)
            self.replicas.append(r)
        # Cluster-owned so logs survive replica restarts.
        self.hash_logs = [r.hash_log for r in self.replicas]
        self.clients: dict[int, SimClient] = {}
        self.realtime = 0
        # Per-replica wall-clock skew in ns (nemesis knob): replica i
        # observes realtime + clock_skew[i].  The synchronized clock
        # (vsr/clock.py) must keep primary timestamps near true time
        # despite this.
        self.clock_skew = [0] * (replica_count + standby_count)

    def _apply_tenant_qos(self, r) -> None:
        if self.tenant_qos is None:
            return
        from tigerbeetle_tpu_torch.qos import TenantQos

        kw = dict(self.tenant_qos)
        r.admit_queue = kw.pop("admit_queue", r.admit_queue)
        r.qos = TenantQos(**kw)

    def process_of_slot(self, slot: int) -> int:
        """Current process filling a protocol slot (reconfiguration
        moves slots between processes).  Routing follows the freshest
        ADOPTED membership — which process answers for a slot NOW —
        not the committed one: a replica that heartbeat-adopted a
        newer epoch but hasn't replayed its ops yet would otherwise
        steer requests at the stale mapping."""
        best_epoch, best = -1, None
        for i, r in enumerate(self.replicas):
            if r.status != "normal":
                continue
            # A nemesis-partitioned replica may hold the freshest
            # adopted membership, but no client can reach it (or any
            # process its mapping names through it): routing by its
            # view would steer requests at a mapping no reachable
            # replica answers.  Skip it; heal/failover restores it.
            if i in self.network.partitioned:
                continue
            members = r.members_adopted or r.members
            epoch = max(r.epoch_adopted, r.epoch)
            if members is not None and epoch > best_epoch:
                best_epoch, best = epoch, members
        if best is not None and slot < len(best):
            return best[slot]
        return slot

    def client(self, client_id: int) -> SimClient:
        # Replica addresses (actives then standbys) occupy
        # [0, replica_count + standby_count) in the packet simulator's
        # flat namespace.
        assert client_id >= len(self.replicas), "client id collides with replica"
        c = SimClient(self, client_id)
        self.clients[client_id] = c
        return c

    def register_endpoint(self, client_id: int, endpoint) -> None:
        """Attach a non-SimClient wire endpoint (anything with
        on_message/tick) under a client id — the sharded router's
        per-shard sessions plug in here.  Replaces any previous holder
        of the id (a new router incarnation re-claims its impersonated
        session ids)."""
        assert client_id >= len(self.replicas)
        self.clients[client_id] = endpoint

    def remove_endpoint(self, client_id: int, endpoint) -> None:
        if self.clients.get(client_id) is endpoint:
            del self.clients[client_id]

    # ------------------------------------------------------------------
    # Nemesis (reference: src/simulator.zig:194-204 crash/restart).

    def crash_replica(self, index: int) -> None:
        """Power-loss crash: unsynced sectors are lost (seeded), the
        process is gone until restart_replica."""
        self.storages[index].crash()
        aof = self.aofs.get(index)
        if aof is not None:
            # The AOF loses a seeded cut of its unsynced suffix with
            # the process — the torn-tail nemesis for tailers.
            aof.crash(self.storages[index]._rng)
        self.network.partition(index)
        self.replicas[index].status = "crashed"

    def restart_replica(self, index: int, state_machine=None, *,
                        release: int | None = None,
                        releases_available: tuple[int, ...] | None = None,
                        ) -> None:
        """Restart; optionally with a different installed binary bundle
        (releases_available) and/or running release — the harness-side
        half of the multiversion upgrade (reference:
        src/vsr/replica.zig:4298 replica_release_execute)."""
        storage = self.storages[index]
        self.network.heal(index)
        old = self.replicas[index]
        avail = releases_available or old.releases_available
        aof = self.aofs.get(index)
        if aof is not None:
            # Repair-on-open: truncate the torn tail, recover last_op
            # — recovery replay gap-fills the committed records the
            # crash erased (vsr/replica.py replay path).
            aof.reopen()
        r = VsrReplica(
            storage, self.cluster_id,
            state_machine or self._factory(), _Bus(self, index),
            replica=index, replica_count=self.replica_count,
            standby_count=self.standby_count, aof=aof,
            release=release if release is not None else old.release,
            releases_available=avail,
        )
        self._apply_tenant_qos(r)
        r.hash_log = self.hash_logs[index]
        r.open()
        if self.root_ring_size:
            r.enable_root_ring(self.root_ring_size)
        # Pre-crash commits beyond the durable checkpoint floor may
        # have been lost with the process and superseded — drop them.
        r.hash_log.prune_above(int(r.superblock.working["commit_min"]))
        self.replicas[index] = r

    # ------------------------------------------------------------------

    def step(self) -> None:
        """One tick: advance time, tick everyone, deliver due packets."""
        self.realtime += cfg.TICK_NS
        for i, r in enumerate(self.replicas):
            if r.status == "crashed":
                continue
            r.realtime = self.realtime + self.clock_skew[i]
            r.tick()
        for c in self.clients.values():
            c.tick()
        for f in self.followers:
            f.tick()
        self.network.advance(self._deliver)
        # Group-commit flush point (deterministic: once per step, in
        # replica order).  A no-op unless a test opted the replica's
        # MemoryStorage into deferred sync.
        for r in self.replicas:
            if r.status != "crashed":
                r.flush_group_commit()
        if self.root_ring_size:
            self._merge_root_history()

    def _merge_root_history(self) -> None:
        """Fold every live replica's root ring into the cluster-owned
        op -> root truth map, asserting cross-replica agreement — the
        ground truth the follower refuse-not-lie audit (and any
        client-side verification) compares attested replies against."""
        merged = getattr(self, "_root_merged", None)
        if merged is None:
            merged = self._root_merged = {}
        for i, r in enumerate(self.replicas):
            if r.root_ring is None or r.status == "crashed":
                continue
            mark = merged.get(i, 0)
            new_mark = mark
            # Ring insertion order is ascending op; walk the fresh
            # suffix only.
            for op in reversed(r.root_ring):
                if op <= mark:
                    break
                root = r.root_ring[op]
                prev = self.root_history.get(op)
                if prev is None:
                    self.root_history[op] = root
                else:
                    assert prev == root, (
                        f"replica {i} state root diverged at op {op}"
                    )
                new_mark = max(new_mark, op)
            merged[i] = new_mark

    def _deliver(self, dst, header: np.ndarray, body: bytes) -> None:
        if isinstance(dst, int) and dst < len(self.replicas):
            # A crashed process receives nothing: in-flight packets to
            # it die with it (processing them would let a zombie
            # journal prepares and send acks from beyond the grave).
            if self.replicas[dst].status == "crashed":
                return
            self.replicas[dst].on_message(header, body)
        else:
            client = self.clients.get(dst)
            if client is not None:
                client.on_message(header, body)

    def run_until(self, cond, max_steps: int = 2000) -> None:
        for _ in range(max_steps):
            if cond():
                return
            self.step()
        raise AssertionError(f"condition not reached in {max_steps} steps")

    def run_request(self, client: SimClient, operation: types.Operation,
                    body: bytes, max_steps: int = 2000) -> bytes:
        client.request(operation, body)
        self.run_until(lambda: not client.busy(), max_steps)
        assert client.reply is not None or client.reply == b""
        return client.reply

    # ------------------------------------------------------------------
    # Checkers (reference: src/testing/cluster/state_checker.zig:27-45).

    def check_linearized(self) -> None:
        """Every pair of replicas agrees on the prepare at every op
        both have committed."""
        for a in range(len(self.replicas)):
            for b in range(a + 1, len(self.replicas)):
                ra, rb = self.replicas[a], self.replicas[b]
                # The checkpoint op itself may never have been
                # journaled (state sync installs state, not prepares):
                # compare strictly above it.
                lo = max(
                    1,
                    max(ra.checkpoint_op, rb.checkpoint_op) + 1,
                    min(ra.commit_min, rb.commit_min)
                    - self.config.journal_slot_count + 1,
                )
                for op in range(lo, min(ra.commit_min, rb.commit_min) + 1):
                    pa = ra.journal.read_prepare(op)
                    pb = rb.journal.read_prepare(op)
                    assert pa is not None and pb is not None, (a, b, op)
                    assert pa[0].tobytes() == pb[0].tobytes(), (a, b, op)

    def check_convergence(self) -> None:
        """All replicas at the same commit must hold identical state.
        On divergence the hash logs name the exact first divergent op
        (reference: src/testing/hash_log.zig)."""
        commits = {r.commit_min for r in self.replicas}
        assert len(commits) == 1, commits
        snaps = {r.sm.snapshot() for r in self.replicas}
        # The commit streams must agree op-for-op (even when the end
        # states happen to match).
        for i, a in enumerate(self.hash_logs):
            for j, b in enumerate(self.hash_logs[i + 1 :], i + 1):
                op = a.first_divergence(b)
                suffix = "" if len(snaps) == 1 else " (states diverged)"
                assert op is None, (
                    f"replicas {i}/{j} diverged first at op {op}{suffix}"
                )
        assert len(snaps) == 1, (
            "state machines diverged after identical commit hashes "
            "(non-deterministic state outside the commit path)"
        )
        # State roots are the cheap always-on rendering of the same
        # convergence claim (commitment.py): every replica at the same
        # commit must report one 16-byte root.  Snapshot equality
        # above makes this mostly redundant — it is asserted anyway so
        # a root computation that diverges between replicas (e.g. an
        # incremental-twin drift on one) fails HERE with the roots in
        # hand, not later at a checkpoint assert.
        roots = {
            r.sm.state_root()
            for r in self.replicas
            if hasattr(r.sm, "state_root")
        }
        assert len(roots) <= 1, (
            f"state roots diverged: {sorted(x.hex() for x in roots)}"
        )

    def settle(self, max_steps: int = 3000) -> None:
        """Run until all replicas have converged on the same commit."""
        def converged():
            if any(c.busy() for c in self.clients.values()):
                return False
            commits = {r.commit_min for r in self.replicas}
            ops = {r.op for r in self.replicas}
            return len(commits) == 1 and len(ops) == 1 and all(
                r.status == "normal" for r in self.replicas
            )

        self.run_until(converged, max_steps)


class SimFollower:
    """Deterministic follower harness: the EXACT FollowerCore the TCP
    FollowerServer runs, driven tick-by-tick over a SimAof's buffer,
    with attestation modeled as direct state_root at-op queries
    against the cluster's replicas (the wire transport is covered by
    the tier-1 TCP smoke; the sim covers the state machine).

    Nemesis surface: `partitioned` stops attestations (the follower
    cannot reach the upstream), `paused` stops replay (lag injection),
    `crash_restart()` rebuilds the core from a fresh state machine and
    offset 0 (crash mid-tail: everything re-derives from the log).
    Every serve() goes through `read()`, which appends the attested
    (root, commit_min) of successful replies to `served` — the
    refuse-not-lie audit replays that list against
    cluster.root_history.
    """

    def __init__(self, cluster: Cluster, upstream: int, *,
                 follower_id: int = 1, staleness_ops: int = 64,
                 attest_every: int = 4,
                 state_machine_factory=None) -> None:
        assert upstream in cluster.aofs, "upstream replica keeps no AOF"
        assert cluster.root_ring_size, "attestation needs the root ring"
        self.cluster = cluster
        self.upstream = upstream
        self.follower_id = follower_id
        self.staleness_ops = staleness_ops
        self.attest_every = attest_every
        self._factory = (
            state_machine_factory
            or (lambda: CpuStateMachine(cluster.config))
        )
        self.partitioned = False
        self.paused = False
        self._ticks = 0
        self._attest_current = False
        self.served: list[tuple[bytes, int]] = []  # (root, commit_min)
        self.refusals: list[int] = []              # FollowerRefuse codes
        self.crashes = 0
        self._new_core()
        cluster.followers.append(self)

    def _new_core(self) -> None:
        from tigerbeetle_tpu_torch.runtime.follower import FollowerCore

        self.core = FollowerCore(
            self.cluster.aofs[self.upstream].source(),
            cluster=self.cluster.cluster_id,
            state_machine=self._factory(),
            follower_id=self.follower_id,
            staleness_ops=self.staleness_ops,
        )

    # -- nemesis --------------------------------------------------------

    def crash_restart(self) -> None:
        """kill -9 mid-tail: all volatile state (replayed state
        machine, attestation progress, resume offset) dies; the
        restarted follower re-derives everything from the log and must
        refuse (unattested) until it re-verifies."""
        self.crashes += 1
        self._new_core()

    # -- drive ----------------------------------------------------------

    def tick(self) -> None:
        if self.paused:
            return
        self._ticks += 1
        self.core.pump()
        if self._ticks % self.attest_every == 0:
            self._attest()

    def _attest(self) -> None:
        """One sessionless state_root query against the upstream
        replica, alternating at-op (verification) with current (lag
        estimate) — the transport-free model of the FollowerServer
        attestation loop."""
        if self.partitioned:
            return
        r = self.cluster.replicas[self.upstream]
        if r.status != "normal":
            return
        self._attest_current = not self._attest_current
        core = self.core
        now_ns = self.cluster.network.now * 10**6  # tick clock
        if self._attest_current or core.commit_min == 0:
            root = r.root_at(r.commit_min)
            if root is None and hasattr(r.sm, "state_root"):
                root = r.sm.state_root()
            if root is not None:
                core.on_attestation(root, r.commit_min, now_ns=now_ns)
        else:
            root = r.root_at(core.commit_min)
            if root is not None:
                core.on_attestation(root, core.commit_min, now_ns=now_ns)
            # Ring miss (op no longer retained): the server answers
            # current instead.
            elif r.commit_min and r.root_at(r.commit_min) is not None:
                core.on_attestation(r.root_at(r.commit_min),
                                    r.commit_min, now_ns=now_ns)

    def read(self, operation, body: bytes):
        """One read attempt; successful replies record their attested
        (root, commit_min) for the audit.  Returns FollowerReply or
        FollowerRefusal."""
        from tigerbeetle_tpu_torch.runtime.follower import FollowerReply

        result = self.core.serve(
            int(operation), body, now_ns=self.cluster.network.now * 10**6
        )
        if isinstance(result, FollowerReply):
            self.served.append((result.root, result.commit_min))
        else:
            self.refusals.append(int(result.reason))
        return result

    # -- audit ----------------------------------------------------------

    def check_never_lied(self) -> None:
        """THE invariant: every (root, commit_min) a reply carried
        matches the cluster's root history at that op — a follower
        under any nemesis may refuse or lag, never attest a state no
        replica committed."""
        for root, op in self.served:
            truth = self.cluster.root_history.get(op)
            assert truth is not None, (
                f"follower served op {op} the cluster never recorded"
            )
            assert truth == root, (
                f"follower LIED at op {op}: served {root.hex()}, "
                f"cluster committed {truth.hex()}"
            )


# ----------------------------------------------------------------------
# Account-sharded multi-cluster harness: N deterministic shard clusters
# behind the sans-IO router core (runtime/router.py), with a
# coordinator-kill nemesis surface and cross-shard money checkers.


class _RouterEndpoint:
    """One wire session (client id) into one shard cluster, driven by
    the sim router transport: explicit request numbers, one op in
    flight at a time (FIFO queue — keeps retransmissions matching the
    shard's single stored reply per session), broadcast retransmission
    on the SimClient cadence."""

    RETRY_TICKS = 8

    def __init__(self, cluster: Cluster, client_id: int) -> None:
        self.cluster = cluster
        self.id = client_id
        self.registered = False
        self.evicted = False
        self._queue: list[dict] = []
        self._current: dict | None = None
        self._last_sent = -(10**9)
        # Coordinator auto-numbering: resumed from the register reply's
        # session-resume hint (+gap), so a new incarnation's numbers
        # land above everything the dead one committed or had in
        # flight.
        self.next_request = 1
        cluster.register_endpoint(client_id, self)
        # Sessions must exist shard-side before any request; queue the
        # (idempotent) register first thing.
        self.send(0, VsrOperation.register, b"",
                  lambda _body: setattr(self, "registered", True))

    def detach(self) -> None:
        self.cluster.remove_endpoint(self.id, self)

    def send(self, request: int, operation, body: bytes, callback,
             trace: tuple[int, int, int] = (0, 0, 0)) -> None:
        self._queue.append({
            "request": request, "operation": operation, "body": body,
            "callback": callback, "trace": trace,
        })
        self._pump()

    def _pump(self) -> None:
        if self._current is not None or not self._queue:
            return
        self._current = self._queue.pop(0)
        if self._current["request"] is None:
            # Coordinator numbering assigned at DEQUEUE time, after
            # the register reply's resume hint has been applied.
            self._current["request"] = self.next_request
            self.next_request += 1
        self._send()

    def _send(self) -> None:
        op = self._current
        self._last_sent = self.cluster.network.now
        h = wire.make_header(
            command=Command.request, operation=int(op["operation"]),
            cluster=self.cluster.cluster_id, client=self.id,
            request=op["request"], trace_id=op["trace"][0],
            trace_ts=op["trace"][1], trace_flags=op["trace"][2],
        )
        wire.finalize_header(h, op["body"])
        for r in range(self.cluster.replica_count):
            self.cluster.network.submit(
                self.id, self.cluster.process_of_slot(r), h, op["body"]
            )

    def on_message(self, header: np.ndarray, body: bytes) -> None:
        if not wire.verify_header(header, body):
            return
        cmd = Command(int(header["command"]))
        if cmd == Command.eviction:
            self.evicted = True
            return
        if cmd != Command.reply or self._current is None:
            return  # client_busy: the retransmit cadence retries
        if int(header["request"]) != self._current["request"]:
            return
        if self._current["request"] == 0 and int(
            self._current["operation"]
        ) == int(VsrOperation.register):
            from tigerbeetle_tpu_torch.runtime.router import COORD_RESUME_GAP

            resume = wire.u128(header, "context")
            if resume:
                # Same fencing gap production uses — the sim must
                # validate the real protocol parameter.
                self.next_request = max(
                    self.next_request, resume + COORD_RESUME_GAP
                )
        cb = self._current["callback"]
        self._current = None
        cb(bytes(body))
        self._pump()

    def tick(self) -> None:
        if self._current is None:
            return
        if self.cluster.network.now - self._last_sent >= self.RETRY_TICKS:
            self._send()


class SimRouter:
    """Deterministic transport for RouterCore over in-process shard
    clusters.  Volatile by construction — kill_router() in the harness
    models a coordinator crash; a new incarnation recovers in-doubt
    transfers purely from shard state."""

    COORD_BASE = 7_000_000

    def __init__(self, sharded: "ShardedCluster", *, incarnation: int = 0,
                 recover: bool = False) -> None:
        from tigerbeetle_tpu_torch import obs
        from tigerbeetle_tpu_torch.obs.flight import FlightRecorder
        from tigerbeetle_tpu_torch.runtime.router import RouterCore

        self.sharded = sharded
        self.incarnation = incarnation
        self.registry = obs.Registry()
        self.core = RouterCore(
            sharded.n_shards, coord_timeout_s=sharded.coord_timeout_s,
            registry=self.registry,
        )
        self.flight = FlightRecorder(process_id=100 + incarnation)
        self.core.flight = self.flight
        self.endpoints: list[_RouterEndpoint] = []
        self._coord: dict[int, _RouterEndpoint] = {}
        self._fwd: dict[tuple[int, int], _RouterEndpoint] = {}
        self._tasks: list[tuple[object, object]] = []
        self._open: set[tuple[int, int]] = set()
        self._register_watch: list[tuple[int, object]] = []
        self.recovery_result: dict | None = None
        self._recovery = None
        if recover:
            self._recovery = self.core.recover()
            self._issue(self._recovery.subops)
            self._tasks.append((self._recovery, None))

    def _endpoint(self, cluster_index: int, client_id: int,
                  cache: dict, key) -> _RouterEndpoint:
        ep = cache.get(key)
        if ep is None:
            ep = _RouterEndpoint(self.sharded.shards[cluster_index],
                                 client_id)
            cache[key] = ep
            self.endpoints.append(ep)
        return ep

    def _issue(self, subops) -> None:
        for sub in subops:
            if sub.kind == "root":
                # Sessionless proof-of-state query: in production the
                # shard's server loop answers it outside consensus
                # (runtime/server.py _send_state_root_reply); the sim
                # transport models that by reading the live state
                # machine directly.
                from tigerbeetle_tpu_torch.state_machine import commitment

                shard = self.sharded.shards[sub.shard]
                sm = self.sharded._live_sm(sub.shard)
                root = (
                    sm.state_root()
                    if hasattr(sm, "state_root")
                    else bytes(16)
                )
                commit_min = max(r.commit_min for r in shard.replicas)
                sub.complete(commitment.root_body(root, commit_min))
                continue
            if sub.kind == "fwd":
                ep = self._endpoint(sub.shard, sub.client, self._fwd,
                                    (sub.client, sub.shard))
                request = sub.request
            else:
                # One STABLE coordinator identity across incarnations
                # (request numbers resume via the register reply's
                # hint); request=None → assigned at dequeue.
                ep = self._endpoint(sub.shard, self.COORD_BASE,
                                    self._coord, sub.shard)
                request = None
            ep.send(request, sub.operation, sub.body,
                    (lambda body, s=sub: s.complete(body)), sub.trace)

    def register_client(self, client_id: int, callback) -> None:
        """Ensure the client's impersonated session exists on every
        shard, then call back (the router-side register handshake)."""
        for shard in range(self.sharded.n_shards):
            self._endpoint(shard, client_id, self._fwd,
                           (client_id, shard))
        self._register_watch.append((client_id, callback))

    def submit(self, client_id: int, request: int, operation,
               body: bytes, trace, on_reply) -> None:
        if (client_id, request) in self._open:
            return  # duplicate resubmission to the same incarnation
        self._open.add((client_id, request))
        task = self.core.open_request(client_id, request, operation,
                                      body, trace)
        self._issue(task.subops)
        self._tasks.append((task, (client_id, request, on_reply)))

    @property
    def idle(self) -> bool:
        return not self._tasks and not any(
            ep._current or ep._queue for ep in self.endpoints
        )

    def query_cluster_root(self) -> bytes:
        """The client-facing `state_root` query through the router
        core: per-shard roots fetched via "root" subops (synchronous
        in the sim transport) and folded deterministically.  Returns
        the 24-byte root_body(folded_root, n_shards)."""
        task = self.core.state_root()
        self._issue(task.subops)
        task.pump()
        assert task.done, "sim root subops must complete synchronously"
        return task.result

    def pump(self) -> None:
        done = []
        for entry in self._tasks:
            task, ctx = entry
            issued = task.pump()
            if issued:
                self._issue(issued)
            if task.done:
                done.append(entry)
        for entry in done:
            self._tasks.remove(entry)
            task, ctx = entry
            if ctx is None:
                self.recovery_result = task.result
            else:
                client_id, request, on_reply = ctx
                self._open.discard((client_id, request))
                on_reply(request, task.result)
        if self._register_watch:
            still = []
            for client_id, callback in self._register_watch:
                eps = [self._fwd[(client_id, s)]
                       for s in range(self.sharded.n_shards)]
                if all(ep.registered for ep in eps):
                    callback()
                else:
                    still.append((client_id, callback))
            self._register_watch = still

    def detach(self) -> None:
        for ep in self.endpoints:
            ep.detach()


class RoutedClient:
    """SimClient-compatible facade over the sharded router.  Survives
    coordinator kills: when the harness starts a new router
    incarnation, the in-flight request is resubmitted to it — the
    client-retransmission analog — and the shards' session dedupe plus
    the 2PC's derived-id idempotency make the replay safe."""

    def __init__(self, sharded: "ShardedCluster", client_id: int) -> None:
        self.sharded = sharded
        self.id = client_id
        self.request_number = 0
        self.registered = False
        self.reply: bytes | None = None
        self.replies: list[bytes] = []
        self._register_wanted = False
        self._inflight: tuple | None = None
        sharded.clients.append(self)

    def register(self) -> None:
        self._register_wanted = True
        self.attach()

    def attach(self) -> None:
        """(Re)connect to the current router incarnation."""
        router = self.sharded.router
        if router is None:
            return
        if self._register_wanted and not self.registered:
            router.register_client(self.id, self._on_registered)
        if self._inflight is not None:
            request, operation, body, trace = self._inflight
            router.submit(self.id, request, operation, body, trace,
                          self._on_reply)

    def _on_registered(self) -> None:
        self.registered = True

    def busy(self) -> bool:
        return (self._register_wanted and not self.registered) or (
            self._inflight is not None
        )

    def request(self, operation, body: bytes) -> None:
        assert self.registered and self._inflight is None
        import time as _time

        self.request_number += 1
        trace = (
            ((self.id << 20) ^ self.request_number) & 0xFFFFFFFFFFFFFFFF,
            _time.perf_counter_ns(),
            wire.TRACE_SAMPLED,
        )
        self.reply = None
        self._inflight = (self.request_number, operation, body, trace)
        router = self.sharded.router
        if router is not None:
            router.submit(self.id, self.request_number, operation, body,
                          trace, self._on_reply)

    def _on_reply(self, request: int, body: bytes) -> None:
        if self._inflight is not None and self._inflight[0] == request:
            self._inflight = None
            self.reply = body
            self.replies.append(body)


class ShardedCluster:
    """N deterministic shard clusters + the router, stepped together.

    Every per-shard nemesis of the single-cluster harness applies (via
    `.shards[i]`), plus the coordinator-kill nemesis: kill_router()
    forgets ALL router state mid-protocol; start_router() brings up a
    fresh incarnation that must recover in-doubt cross-shard transfers
    from shard state alone.
    """

    def __init__(self, n_shards: int = 2, *, replica_count: int = 2,
                 seed: int = 0, config: cfg.Config | None = None,
                 options: PacketOptions | None = None,
                 state_machine_factories=None,
                 coord_timeout_s: int = 8,
                 tenant_qos: dict | None = None) -> None:
        import dataclasses as _dc

        self.n_shards = n_shards
        # More session slots than TEST_MIN: each router incarnation
        # registers a coordinator session per shard on top of the
        # impersonated client sessions.
        self.config = config or _dc.replace(cfg.TEST_MIN, clients_max=16)
        self.coord_timeout_s = coord_timeout_s
        self.shards = [
            Cluster(
                replica_count, seed=seed + 7919 * s, config=self.config,
                options=options or PacketOptions(),
                state_machine_factory=(
                    state_machine_factories[s]
                    if state_machine_factories else None
                ),
                tenant_qos=tenant_qos,
            )
            for s in range(n_shards)
        ]
        self.clients: list[RoutedClient] = []
        self.router: SimRouter | None = None
        self.router_kills = 0
        self.start_router(recover=False)

    # -- coordinator lifecycle (the kill nemesis) ----------------------

    def start_router(self, recover: bool | None = None) -> SimRouter:
        assert self.router is None
        if recover is None:
            recover = self.router_kills > 0
        self.router = SimRouter(
            self, incarnation=self.router_kills, recover=recover,
        )
        for c in self.clients:
            c.attach()
        return self.router

    def kill_router(self) -> None:
        """Coordinator crash: every endpoint detaches, all volatile
        2PC state (open requests, stage progress, ensured-ledger cache)
        is gone."""
        assert self.router is not None
        self.router.detach()
        self.router = None
        self.router_kills += 1

    def client(self, client_id: int) -> RoutedClient:
        return RoutedClient(self, client_id)

    # -- stepping ------------------------------------------------------

    def step(self) -> None:
        for shard in self.shards:
            shard.step()
        if self.router is not None:
            self.router.pump()

    def run_until(self, cond, max_steps: int = 4000) -> None:
        for _ in range(max_steps):
            if cond():
                return
            self.step()
        raise AssertionError(f"condition not reached in {max_steps} steps")

    def run_request(self, client: RoutedClient, operation, body: bytes,
                    max_steps: int = 4000) -> bytes:
        client.request(operation, body)
        self.run_until(lambda: not client.busy(), max_steps)
        assert client.reply is not None or client.reply == b""
        return client.reply

    def settle(self, max_steps: int = 8000) -> None:
        def quiet() -> bool:
            if any(c.busy() for c in self.clients):
                return False
            if self.router is not None and not self.router.idle:
                return False
            return all(
                len({r.commit_min for r in s.replicas}) == 1
                and len({r.op for r in s.replicas}) == 1
                and all(r.status == "normal" for r in s.replicas)
                for s in self.shards
            )

        self.run_until(quiet, max_steps)

    # -- checkers ------------------------------------------------------

    def _live_sm(self, shard: int):
        c = self.shards[shard]
        for r in c.replicas:
            if r.status == "normal":
                return r.sm
        return c.replicas[0].sm

    def check_shards(self) -> None:
        """Per-shard hash-log convergence + linearized commit history
        (the single-cluster checkers, per consensus group)."""
        for shard in self.shards:
            shard.check_linearized()
            shard.check_convergence()

    def _balance_sums(self, sm) -> tuple[int, int, int, int]:
        """(debits_pending, credits_pending, debits_posted,
        credits_posted) summed over every account of a state machine
        (CPU or TPU-backed)."""
        from tigerbeetle_tpu_torch.state_machine import CpuStateMachine

        if isinstance(sm, CpuStateMachine):
            dp = sum(a.debits_pending for a in sm.accounts.values())
            cp = sum(a.credits_pending for a in sm.accounts.values())
            dpo = sum(a.debits_posted for a in sm.accounts.values())
            cpo = sum(a.credits_posted for a in sm.accounts.values())
            return dp, cp, dpo, cpo
        n = sm._attrs.count
        lo = sm._mirror.lo[:n].astype(object)
        hi = sm._mirror.hi[:n].astype(object)
        totals = [
            int((lo[:, c] + (hi[:, c] * (1 << 64))).sum()) for c in range(4)
        ]
        return totals[0], totals[2], totals[1], totals[3]

    def cluster_commitment(self) -> bytes:
        """The folded cluster state commitment: per-shard 16-byte
        roots combined with the router's deterministic fold
        (commitment.fold_cluster) — shard index bound into each
        contribution, so shards swapping state moves the root."""
        from tigerbeetle_tpu_torch.state_machine import commitment

        return commitment.fold_cluster(
            [self._live_sm(s).state_root() for s in range(self.n_shards)]
        )

    def check_cluster_commitment(self) -> bytes:
        """Audit point: every replica of every shard agrees on its
        shard root, and the folded cluster commitment is well-defined
        (returned so callers can compare it against the router's
        query-path fold)."""
        for s, shard in enumerate(self.shards):
            roots = {
                r.sm.state_root()
                for r in shard.replicas
                if hasattr(r.sm, "state_root")
            }
            assert len(roots) <= 1, (
                f"shard {s} replicas disagree on state root: "
                f"{sorted(x.hex() for x in roots)}"
            )
        return self.cluster_commitment()

    def check_conservation(self) -> None:
        """Double-entry conservation PER SHARD, at any audit point:
        each shard's state machine is internally double-entry, holds
        included, so total debits == total credits in both columns —
        the 2PC never mints or destroys money inside a shard."""
        for s in range(self.n_shards):
            dp, cp, dpo, cpo = self._balance_sums(self._live_sm(s))
            assert dp == cp, (s, dp, cp)
            assert dpo == cpo, (s, dpo, cpo)

    def cross_status(self, tid: int, dshard: int, cshard: int):
        """(debit_hold_status, credit_hold_status, compensated) for one
        cross-shard transfer, read from live shard state.  Status is a
        TransferPendingStatus or None (hold never created)."""
        ids = types.XShardIds(tid)
        sm_d = self._live_sm(dshard)
        sm_c = self._live_sm(cshard)
        sd = sm_d.pending_status(ids.hold_debit)
        sc = sm_c.pending_status(ids.hold_credit)
        comp = sm_d.transfer_timestamp(ids.comp) is not None
        return sd, sc, comp

    def check_atomicity(self, xfers, final: bool = False,
                        ledgers=(1,)) -> None:
        """Cross-shard conservation of money over the attempted
        cross-shard transfers `xfers` = [(tid, dshard, cshard), ...].

        At EVERY audit point (terminal states are monotone, so this is
        lag-safe even though the two shards are read at different
        commit points): a posted side never coexists with a
        voided/expired other side — no lost money, no double-post.
        The transient posted/pending combination is legal only until
        the coordinator (or its successor) finishes the credit side.

        At quiescence (`final=True`): every transfer is terminal —
        committed on both sides or aborted on both — and the
        settlement accounts net to zero across the cluster."""
        from tigerbeetle_tpu_torch.types import TransferPendingStatus as TPS

        dead = (TPS.voided, TPS.expired)
        for tid, dshard, cshard in xfers:
            sd, sc, comp = self.cross_status(tid, dshard, cshard)
            if comp:
                # Compensated: decided-commit whose credit hold died
                # under it (budget violation, loudly flagged) — money
                # returned to the debitor.
                assert sd == TPS.posted and sc != TPS.posted, (tid, sd, sc)
                continue
            # The credit side can never be posted against a dead
            # debit-side decision: post_credit strictly follows a
            # committed post_debit, and a voided/expired debit hold
            # excludes one.  (Terminal-vs-terminal only — the two
            # shards are read at different commit points, so a
            # transiently lagging non-terminal read is not evidence.
            # The opposite direction — debit posted, credit hold
            # expired — is a legal transient awaiting compensation;
            # `final` requires it resolved.)
            assert not (sc == TPS.posted and sd in dead), (tid, sd, sc)
            assert not (sd == TPS.posted and sc == TPS.voided and final), (
                tid, sd, sc,
            )
            if final:
                assert sd != TPS.pending and sc != TPS.pending, (
                    tid, sd, sc,
                )
                committed = sd == TPS.posted
                assert committed == (sc == TPS.posted), (tid, sd, sc)
        if final:
            # Settlement accounts net to ZERO across the cluster: every
            # committed transfer credits the debit shard's settlement
            # account and debits the credit shard's by the same amount;
            # aborts touch only pending columns, and those are empty at
            # quiescence.
            imbalance = 0
            coord_ids = [types.coord_account_id(lg) for lg in ledgers]
            for s in range(self.n_shards):
                sm = self._live_sm(s)
                for aid in coord_ids:
                    bal = sm.account_balances_raw(aid)
                    if bal is None:
                        continue  # shard never saw a cross-shard leg
                    dp, dpo, cp, cpo = bal
                    assert dp == 0 and cp == 0, (s, aid, dp, cp)
                    imbalance += cpo - dpo
            assert imbalance == 0, imbalance


# ----------------------------------------------------------------------
# Cross-replica trace merging (observability spine, utils/tracer.py).


def merge_traces(trace_paths, out_path: str | None = None,
                 labels=None) -> dict:
    """Stitch per-replica Chrome-trace JSON files (utils/tracer.py
    dumps) into ONE Perfetto-loadable timeline: each input file
    becomes a named process track (`replica<i>`), so a replicated
    drain reads left-to-right across replicas — prepare on the
    primary, journal_write + covering gc sync on every replica,
    prepare_ok on the backups, commit + reply back on the primary.

    Timestamps are comparable because every tracer samples
    CLOCK_MONOTONIC (time.perf_counter_ns), whose epoch is shared by
    all processes on one host — merging traces from different hosts
    would need an offset pass (the vsr/clock.py sync could provide
    one; not needed for single-box clusters).

    Robustness: a missing, empty, truncated, or otherwise unparseable
    per-replica file (a replica killed mid-dump is the common case) is
    SKIPPED with a warning and listed under otherData.skipped — one
    bad file must not void a postmortem merge of the survivors.  Any
    number of inputs merges (>2-replica clusters, flight dumps mixed
    with live tracer dumps).
    """
    import json as _json
    import warnings

    merged_events: list[dict] = []
    dropped_total = 0
    skipped: list[dict] = []
    for i, path in enumerate(trace_paths):
        label = labels[i] if labels else f"replica{i}"
        try:
            with open(path) as f:
                data = _json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"expected a trace object, got "
                                 f"{type(data).__name__}")
            events = data.get("traceEvents", ())
            if not isinstance(events, list):
                raise ValueError("traceEvents is not a list")
        except (OSError, ValueError) as exc:
            # ValueError covers json.JSONDecodeError (its subclass):
            # empty and truncated files land here too.
            warnings.warn(
                f"merge_traces: skipping {label} ({path}): {exc}",
                stacklevel=2,
            )
            skipped.append({"label": label, "path": str(path),
                            "error": str(exc)})
            continue
        # Re-key pid per input file: every tracer defaults its own
        # process_id, and two replicas that both said pid=0 would
        # otherwise collapse onto one track.
        for ev in events:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["pid"] = i
            merged_events.append(ev)
        merged_events.append(
            {
                "name": "process_name", "ph": "M", "pid": i, "tid": 0,
                "args": {"name": label},
            }
        )
        other = data.get("otherData", {})
        if isinstance(other, dict):
            try:
                dropped_total += int(other.get("dropped_events", 0))
            except (TypeError, ValueError):
                pass
    merged = {
        "traceEvents": merged_events,
        "otherData": {"dropped_events": dropped_total},
    }
    if skipped:
        merged["otherData"]["skipped"] = skipped
    if out_path:
        with open(out_path, "w") as f:
            _json.dump(merged, f)
    return merged


def trace_demo(out_path: str, *, n_replicas: int = 2, batches: int = 8,
               transfers_per_batch: int = 16, seed: int = 7) -> dict:
    """One-command Perfetto demo (`tigerbeetle-tpu trace-demo`): drive
    a replicated drain through a deterministic n-replica cluster with
    per-replica JSON tracers and group commit live, then merge the
    traces into `out_path` (load it at https://ui.perfetto.dev).  The
    timeline shows prepare -> journal_write -> gc_covering_sync ->
    prepare_ok -> commit -> reply across all replica tracks.

    Returns {"replicas", "ops_committed", "events", "trace_path"}.
    """
    import os
    import tempfile

    from tigerbeetle_tpu_torch.testing.harness import account, pack, transfer
    from tigerbeetle_tpu_torch.utils.tracer import Tracer
    from tigerbeetle_tpu_torch.vsr.storage import MemoryStorage

    # Group commit needs a deferred-sync-capable storage; the sim
    # cluster's MemoryStorage opts in per-class for the demo's scope
    # (the same opt-in tests/test_multi.py uses).
    had = MemoryStorage.supports_deferred_sync
    MemoryStorage.supports_deferred_sync = True
    try:
        cluster = Cluster(replica_count=n_replicas, seed=seed)
        for i, r in enumerate(cluster.replicas):
            r.set_tracer(Tracer("json", process_id=i))
        client = cluster.client(1000)
        client.register()
        cluster.run_until(lambda: client.registered)
        accounts = [account(1), account(2)]
        assert cluster.run_request(
            client, types.Operation.create_accounts, pack(accounts)
        ) == b""
        tid = 100
        for _ in range(batches):
            rows = []
            for _ in range(transfers_per_batch):
                rows.append(
                    transfer(
                        tid, debit_account_id=1, credit_account_id=2,
                        amount=1,
                    )
                )
                tid += 1
            assert cluster.run_request(
                client, types.Operation.create_transfers, pack(rows)
            ) == b""
        cluster.settle()
        tmp = tempfile.mkdtemp(prefix="tb_trace_demo_")
        paths = []
        for i, r in enumerate(cluster.replicas):
            p = os.path.join(tmp, f"replica{i}.json")
            r.tracer.write(p)
            paths.append(p)
        merge_traces(paths, out_path)
        return {
            "replicas": n_replicas,
            "ops_committed": cluster.replicas[0].commit_min,
            "events": batches * transfers_per_batch,
            "per_replica_traces": paths,
            "trace_path": out_path,
        }
    finally:
        MemoryStorage.supports_deferred_sync = had
