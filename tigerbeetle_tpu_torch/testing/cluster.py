"""Deterministic in-process cluster: N replicas + clients, one thread.

The reference tests multi-node behavior without a real cluster by
instantiating every replica and client in one process over a simulated
network/storage/time (reference: src/testing/cluster.zig:56-70,
packet_simulator.zig:10-40).  Same pattern here: a seeded
`PacketSimulator` delivers bus messages with delay/loss/partitions,
`Cluster.step()` advances one tick, and identical seeds give identical
runs — which is also how card-vs-CPU state parity is checked
reproducibly.

This package's own copy of the unsharded part of
``tigerbeetle_tpu/testing/cluster.py`` (``PacketSimulator``, ``SimClient``,
``SimAof``, ``Cluster``) and its trace tools (``merge_traces``,
``trace_demo``); the default state machine is the port's oracle
``state_machine/cpu.py``.  The follower, router and sharded classes come
with the port's router and follower.
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
