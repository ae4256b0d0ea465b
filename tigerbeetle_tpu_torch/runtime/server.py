"""TCP replica server: the `tigerbeetle start` process loop.

This package's own copy of ``tigerbeetle_tpu/runtime/server.py``.

Bridges the native message bus (runtime/native.py) to a VsrReplica:
peers handshake with a `ping` carrying their replica index, clients
are identified by the `client` field of their requests, and the loop
alternates bus polling with replica ticks (reference:
src/tigerbeetle/main.zig:382-384 `replica.tick(); io.run_for_ns(...)`).

Peer connection rule: replica i initiates connections to every j < i
(one TCP connection per replica pair); reconnects are retried each
tick (reference: src/message_bus.zig reconnect w/ backoff).
"""
# tbcheck: allow-file(determinism, no-print): ReplicaServer is the
# real-TCP process loop — realtime stamps (replica.realtime),
# drain deadlines, and TB_STATS lines are wall-clock/stdout by
# design.  The deterministic sim drives VsrReplica through SimBus
# (testing/cluster.py), never through this module.

from __future__ import annotations

import os
import time

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.vsr import replica as vsr_format
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.multi import VsrReplica
from tigerbeetle_tpu_torch.vsr.storage import FileStorage, ZoneLayout
from tigerbeetle_tpu_torch.vsr.wire import Command
from tigerbeetle_tpu_torch.runtime.native import (
    EV_CLOSED,
    EV_MESSAGE,
    NativeBus,
)

TICK_NS = cfg.TICK_NS


def parse_address(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class TcpBus:
    """VsrReplica-facing bus adapter over the native TCP bus."""

    def __init__(self, addresses: list[str], replica_index: int,
                 message_size_max: int) -> None:
        self.addresses = addresses
        self.index = replica_index
        self.native = NativeBus(message_size_max)
        host, port = parse_address(addresses[replica_index])
        self.port = self.native.listen(host, port)
        self.replica_conns: dict[int, int] = {}  # keyed by PROCESS index
        self.client_conns: dict[int, int] = {}
        self._conn_peer: dict[int, tuple[str, object]] = {}
        self._pending_connects: dict[int, int] = {}  # conn -> replica
        # Protocol slot -> process index (reconfiguration re-points
        # slots at different processes; connections stay per-process).
        self._slot_map: list[int] | None = None

    def set_slot_map(self, members: list[int]) -> None:
        self._slot_map = list(members)

    # -- VsrReplica interface --

    def send(self, dst_replica: int, header: np.ndarray, body: bytes) -> None:
        conn = self.replica_conns.get(self._to_process(dst_replica))
        if conn is None:
            return  # not connected yet; protocol retransmits
        self.native.send2(conn, header.tobytes(), body)

    def send_client(self, client: int, header: np.ndarray, body: bytes) -> None:
        conn = self.client_conns.get(client)
        if conn is None:
            return
        self.native.send2(conn, header.tobytes(), body)

    def send_frames(self, dst_replica: int,
                    frames: list[tuple[np.ndarray, bytes]]) -> None:
        """Vectored send of a whole run of frames to one replica (the
        drain loop: a drain's deferred prepare_oks release in ONE native call —
        same frames, same order as the per-frame loop)."""
        conn = self.replica_conns.get(self._to_process(dst_replica))
        if conn is None:
            return  # not connected yet; protocol retransmits
        self.native.sendv(
            conn, [h.tobytes() + body for h, body in frames]
        )

    # -- connection management --

    def connect_peers(self, cluster: int, view: int) -> None:
        """(Re)connect to every lower-indexed peer we're missing."""
        for j in range(self.index):
            if j in self.replica_conns:
                continue
            if j in self._pending_connects.values():
                continue
            host, port = parse_address(self.addresses[j])
            try:
                conn = self.native.connect(host, port)
            except OSError:
                continue
            self._pending_connects[conn] = j
            self._announce(conn, cluster, view)

    # Transport-handshake marker: announce pings identify the sender
    # by PROCESS index (the stable address-list position), while
    # protocol pings carry the sender's SLOT — the request field
    # disambiguates so registration never mixes the two spaces.
    ANNOUNCE_REQUEST = 0xB0B0_B0B0

    def _announce(self, conn: int, cluster: int, view: int,
                  pong: bool = False) -> None:
        h = wire.make_header(
            command=Command.pong if pong else Command.ping,
            cluster=cluster, view=view,
            replica=self.index, request=self.ANNOUNCE_REQUEST,
        )
        wire.finalize_header(h, b"")
        self.native.send(conn, h.tobytes())

    def _to_process(self, slot: int) -> int:
        """Protocol SLOT -> process index (identity until reconfigured)."""
        if self._slot_map is not None and slot < len(self._slot_map):
            return self._slot_map[slot]
        return slot

    def register_peer(self, conn: int, replica_index: int,
                      is_process: bool = False) -> None:
        """Connections are keyed by PROCESS.  Announce handshakes carry
        the process index directly (is_process); protocol messages
        carry the sender's SLOT, translated through the slot map —
        otherwise a reconfigured peer's pings would overwrite another
        process's connection entry."""
        self._pending_connects.pop(conn, None)
        process = replica_index if is_process else self._to_process(
            replica_index
        )
        self.replica_conns[process] = conn
        self._conn_peer[conn] = ("replica", process)

    def register_client(self, conn: int, client: int) -> None:
        self.client_conns[client] = conn
        self._conn_peer[conn] = ("client", client)

    def drop_conn(self, conn: int) -> None:
        self._pending_connects.pop(conn, None)
        kind_id = self._conn_peer.pop(conn, None)
        if kind_id is None:
            return
        kind, peer = kind_id
        if kind == "replica":
            self.replica_conns.pop(peer, None)
        else:
            self.client_conns.pop(peer, None)


class ReplicaServer:
    def __init__(self, data_path: str, *, cluster: int | None = None,
                 addresses: list[str], replica_index: int,
                 state_machine_factory, config: cfg.Config = cfg.PRODUCTION,
                 grid_size: int = 1 << 20, aof_path: str | None = None,
                 trace_path: str | None = None,
                 standby_count: int = 0) -> None:
        layout = ZoneLayout(config=config, grid_size=grid_size)
        self.storage = FileStorage(data_path, layout)
        self.bus = TcpBus(addresses, replica_index, config.message_size_max)
        aof = None
        if aof_path:
            # Append-only file of every committed prepare (reference:
            # src/aof.zig, --aof flag): an independent audit/recovery
            # stream replayable via vsr.aof.replay.
            from tigerbeetle_tpu_torch.vsr.aof import AOF

            aof = AOF(aof_path)
        # The address list covers actives THEN standbys; the last
        # `standby_count` processes replicate without voting.
        if not 0 <= standby_count < len(addresses):
            raise ValueError(
                f"standby_count {standby_count} must leave at least one "
                f"active replica among {len(addresses)} addresses"
            )
        self.replica = VsrReplica(
            self.storage, cluster, state_machine_factory(), self.bus,
            replica=replica_index,
            replica_count=len(addresses) - standby_count,
            standby_count=standby_count, aof=aof,
        )
        # Knob-controlled tracing (TB_TRACE=json): processes started
        # without an explicit --trace path still record the span
        # timeline, written to TB_TRACE_PATH (or tb_trace_r<i>.json)
        # at close — per-replica files merge into one Perfetto
        # timeline via testing/cluster.merge_traces.
        from tigerbeetle_tpu_torch import envcheck

        if not trace_path and envcheck.trace_backend() == "json":
            trace_path = envcheck.env_str(
                "TB_TRACE_PATH", f"tb_trace_r{replica_index}.json"
            )
            if "{replica}" in trace_path:
                trace_path = trace_path.format(replica=replica_index)
            elif replica_index and envcheck.env_is_set("TB_TRACE_PATH"):
                # One exported TB_TRACE_PATH shared by a whole cluster
                # must not let replicas clobber each other's trace at
                # close: non-zero indices get a suffix.
                root, ext = os.path.splitext(trace_path)
                trace_path = f"{root}.r{replica_index}{ext}"
        self._trace_path = trace_path
        # Flight recorder (obs/flight.py): always-on bounded ring of
        # recent trace events, dumped on demotion / assertion failure /
        # SIGTERM for postmortems — no file I/O until then.
        from tigerbeetle_tpu_torch.obs.flight import FlightRecorder

        flight_path = envcheck.env_str(
            "TB_FLIGHT_PATH", f"tb_flight_r{replica_index}.json"
        )
        if "{replica}" in flight_path:
            flight_path = flight_path.format(replica=replica_index)
        elif replica_index and envcheck.env_is_set("TB_FLIGHT_PATH"):
            root, ext = os.path.splitext(flight_path)
            flight_path = f"{root}.r{replica_index}{ext}"
        self._flight_path = flight_path
        self.flight = FlightRecorder(
            process_id=replica_index, dump_path=flight_path,
            # Late-bound: every flight dump embeds the full registry
            # snapshot (dev_wave.spec.*, link forensics, QoS counters)
            # next to the event ring — the postmortem carries the
            # numbers that explain it.
            stats_fn=lambda: self.registry.snapshot(),
        )
        # The tracer now exists unconditionally: backend "json" only
        # when a trace path is configured (spans cost nothing on
        # "none"), but its instants ALWAYS mirror into the flight ring
        # — so demotions/view changes are in the postmortem dump even
        # with full tracing off (utils/tracer.py).
        from tigerbeetle_tpu_torch.utils.tracer import Tracer

        tracer = Tracer(
            "json" if trace_path else "none", process_id=replica_index
        )
        tracer.flight = self.flight
        self.replica.set_tracer(tracer)
        self.replica.anatomy.flight = self.flight
        # Unified registry tree (obs/registry.py): the replica's and
        # state machine's registries graft in under "vsr."/"sm.", the
        # storage's fsync/byte counters ride as pull gauges, and the
        # server's own drain-loop instruments live at the top.  ONE
        # source of truth rendered three ways: TB_STATS lines
        # (_print_stats), the `stats` wire scrape, bench JSON.
        from tigerbeetle_tpu_torch import obs

        self.registry = obs.Registry()
        self.registry.attach("vsr", self.replica.metrics)
        sm_metrics = getattr(self.replica.sm, "metrics", None)
        if sm_metrics is not None:
            self.registry.attach("sm", sm_metrics)
        storage = self.storage
        self.registry.gauge_fn("replica", lambda: replica_index)
        self.registry.gauge_fn(
            "storage.fsyncs", lambda: storage.stat_fsyncs
        )
        self.registry.gauge_fn(
            "storage.bytes_wal", lambda: storage.stat_bytes_wal
        )
        self.registry.gauge_fn(
            "storage.bytes_grid", lambda: storage.stat_bytes_grid
        )
        self.registry.gauge_fn(
            "server.queue_depth", lambda: len(self.replica.request_queue)
        )
        # Drain-loop instruments: messages per drain, wire decode time
        # per message, drains that hit the round bound.
        self._h_drain = self.registry.histogram("server.drain_msgs")
        self._h_decode = self.registry.histogram("server.decode_us")
        self._c_drains = self.registry.counter("server.drains")
        self._c_drain_rounds = self.registry.counter("server.drain_rounds")
        # Columnar ingest fast path: TB_FASTPATH_DECODE=1
        # drains the bus through one arena copy + one batch checksum
        # pass per poll (native tb_fp_verify_frames, vectorized Python
        # fallback), and client requests enter the replica as one
        # columnar batch.  TB_FASTPATH_DECODE=0 forces the legacy
        # per-message path end to end for differential runs.
        self._fastpath_decode = (
            envcheck.fastpath_decode() == 1
            and self.bus.native.supports_drain
        )
        self._drain_batch_max = envcheck.drain_batch_max()
        # decode µs per EVENT (128-byte wire records in the drain's
        # bodies) — the honest amortized unit the bench grades.
        self._h_decode_ev = self.registry.histogram(
            "server.decode_us_per_event"
        )
        self._c_fp_hits = self.registry.counter("fastpath.batch_decode_hits")
        self._c_fp_fallbacks = self.registry.counter(
            "fastpath.batch_decode_fallbacks"
        )
        # Raw ingress-verify hash total (every frame body, protocol
        # included) — the engine-load view; the commit-path subset
        # feeds vsr.hash.bytes_hashed in _dispatch_drain.
        self._c_verify_bytes = self.registry.counter(
            "server.verify_body_bytes"
        )
        # Native availability is pinned at startup: the port's library
        # is built from its own sources and a failed build raises, so
        # this gauge reads 1 only under TB_FASTPATH_DISABLE.
        from tigerbeetle_tpu_torch.runtime import fastpath as fastpath_mod

        self._fastpath = fastpath_mod
        fp_unavailable = 0 if fastpath_mod.batch_verify_available() else 1
        self.registry.gauge_fn(
            "fastpath.native_unavailable", lambda: fp_unavailable
        )
        # Hash-once commit path: which SHA-256 engine serves
        # the hot path (scalar fallback warned once + gauged so no
        # bench can mistake a 225 MB/s run for a SHA-NI run), plus the
        # process-global pool stats.  hash.lanes_busy counts jobs that
        # actually ran on worker lanes — 0 under TB_HASH_THREADS=0 by
        # definition.
        self.registry.gauge_fn(
            "hash.engine_code",
            lambda: {"evp": 1, "sha256-legacy": 2, "scalar": 3}.get(
                fastpath_mod.hash_engine_name(), 0
            ),
        )
        self.registry.gauge_fn(
            "hash.scalar_fallback", fastpath_mod.hash_scalar_fallback
        )
        self.registry.gauge_fn(
            "hash.lanes_busy",
            lambda: fastpath_mod.hash_stats()["lane_jobs"],
        )
        self.registry.gauge_fn(
            "hash.table_hits",
            lambda: fastpath_mod.hash_stats()["table_hits"],
        )
        self.registry.gauge_fn(
            "hash.threads",
            lambda: fastpath_mod.hash_stats()["threads"],
        )
        if fastpath_mod.batch_verify_available():
            fastpath_mod.hash_scalar_fallback()  # one-time warning
        # Coalesced reply encode (vsr/replica.py _encode_sub_replies)
        # reports into the server's instrument tree.
        self._h_reply_encode = self.registry.histogram(
            "server.reply_encode_us"
        )
        self.replica.h_reply_encode = self._h_reply_encode
        # Admission control: fresh requests beyond TB_ADMIT_QUEUE
        # queued requests are shed with a typed Command.client_busy —
        # overload degrades visibly (shed counter, bounded queue)
        # instead of growing the tail unboundedly.  The bound lives in
        # the REPLICA's enqueue path, below the at-most-once gate, so
        # a retransmission of a committed request still gets its
        # stored reply under overload (never a busy).
        self.admit_queue = envcheck.admit_queue(
            config.pipeline_prepare_queue_max
        )
        self.registry.gauge_fn("server.admit_queue", lambda: self.admit_queue)
        self._c_shed = self.registry.counter("server.shed")
        self.replica.admit_queue = self.admit_queue
        self.replica.on_shed = self._on_shed
        # Multi-tenant QoS: admission, drain order, and
        # shedding keyed by tenant (ledger).  TB_TENANT_QOS=0 pins the
        # legacy single-queue path exactly (replica.qos stays None);
        # on, the per-tenant admit/shed/lat_us instruments land under
        # vsr.qos.t<ledger>.* in the registry tree, so the stats wire
        # op scrapes them like everything else.
        if envcheck.tenant_qos():
            from tigerbeetle_tpu_torch.qos import TenantQos

            self.replica.qos = TenantQos(
                rate=envcheck.tenant_rate(),
                rate_bytes=envcheck.tenant_rate_bytes(),
                queue_bound=envcheck.tenant_queue(self.admit_queue),
                weights=envcheck.tenant_weights(),
                registry=self.replica.metrics.scope("qos"),
            )
            qos = self.replica.qos
            self.registry.gauge_fn("server.tenant_rate", lambda: qos.rate)
            self.registry.gauge_fn(
                "server.tenant_queue", lambda: qos.queue_bound
            )
        self.replica.open()
        # Root ring: retain the state root of recent
        # commits so the `state_root` at-op query can attest follower
        # replays.  TB_ROOT_RING=0 disables; costs one state_root()
        # read per commit (a 16-byte digest copy on the incremental-
        # commitment state machines).
        ring = envcheck.root_ring()
        if ring and hasattr(self.replica.sm, "state_root"):
            self.replica.enable_root_ring(ring)
        self._last_tick = 0
        self._last_stats = 0
        self._stats_snapshot: tuple | None = None

    @property
    def port(self) -> int:
        return self.bus.port

    # Bound on drain rounds per poll_once: each extra round is a
    # zero-timeout poll, so a chattering peer cannot starve ticks.
    DRAIN_ROUNDS_MAX = 16

    def poll_once(self, timeout_ms: int = 10) -> None:
        """One loop iteration: drain ALL ready bus events (so one
        group-commit sync covers a whole pipeline's worth of prepares
        and replies coalesce per drain), then tick on cadence, then
        flush the group commit — no ack leaves before its covering
        sync.  TB_GROUP_COMMIT_MAX_US bounds deferral inside a long
        drain.

        With TB_FASTPATH_DECODE=1 (default) each round is columnar:
        one C call copies every ready event into a contiguous arena,
        one batch pass verifies every frame's checksums, headers are
        gathered in one vectorized pass, and the round's client
        requests enter the replica as one batch
        (vsr/multi.py on_requests_batch) — no per-message Python on
        the hot path."""
        deadline_ns = self.replica.group_commit_max_us * 1_000
        drain_t0 = None
        rounds = 0
        drained = 0
        while True:
            t_poll = timeout_ms if rounds == 0 else 0
            rounds += 1
            if self._fastpath_decode:
                batch = self.bus.native.poll_drain(
                    t_poll, self._drain_batch_max
                )
                got = batch[0] > 0
                if got:
                    drained += self._dispatch_drain(*batch)
            else:
                events = self.bus.native.poll(t_poll)
                got = bool(events)
                for ev_type, conn, payload in events:
                    if ev_type == EV_CLOSED:
                        self.bus.drop_conn(conn)
                    elif ev_type == EV_MESSAGE:
                        drained += 1
                        self._on_raw_message(conn, payload)
            if self.replica._gc_pending and drain_t0 is None:
                drain_t0 = time.monotonic_ns()
            if drain_t0 is not None and (
                time.monotonic_ns() - drain_t0 >= deadline_ns
            ):
                # Deferral deadline inside a busy drain: sync + release
                # now; later messages start a fresh batch.
                self.replica.flush_group_commit()
                drain_t0 = None
            if not got or rounds >= self.DRAIN_ROUNDS_MAX:
                break
        if drained:
            # Drain-size distribution: how many messages one covering
            # sync amortizes over (the group-commit win, measured).
            self._c_drains.inc()
            self._c_drain_rounds.inc(rounds)
            self._h_drain.observe(drained)
        now = time.monotonic_ns()
        if now - self._last_tick >= TICK_NS:
            self._last_tick = now
            self.replica.realtime = time.time_ns()
            # Real elapsed time, not tick counts, so clock-sync RTT
            # error bounds reflect event-loop stalls.
            self.replica.monotonic_external = True
            self.replica.monotonic = now
            self.replica.tick()
            self.bus.connect_peers(self.replica.cluster, self.replica.view)
            if now - self._last_stats >= 100 * TICK_NS:  # ~1s cadence
                self._last_stats = now
                self._print_stats()
        self.replica.flush_group_commit()

    # TB_STATS line schema: legacy key -> registry snapshot key.  The
    # line is a RENDERING of the registry (one source of truth with
    # the `stats` scrape); it survives kill -9 in the log tail, which
    # is why bench keeps a log-tail parser as fallback.
    STATS_LINE_KEYS = (
        ("fsyncs", "storage.fsyncs"),
        ("prepares", "vsr.prepares_written"),
        ("gc_flushes", "vsr.gc_flushes"),
        ("commit_min", "vsr.commit_min"),
        ("ckpt_async", "vsr.ckpt.async"),
        ("commits", "vsr.commits"),
    )

    def _print_stats(self) -> None:
        """One greppable counters line per second of activity on
        stdout (the replica log), rendered from the registry snapshot.
        Idle-dedup compares the RENDERED values — derived from the
        same STATS_LINE_KEYS map that prints, so a key added to the
        line is automatically in the comparison (the old hand-picked
        tuple silently went stale instead).  The raw snapshot version
        deliberately stays out of the line: heartbeat decode samples
        bump it every tick, and keying the dedup on it would grow an
        idle cluster's log ~1 line/s forever."""
        snap = self.registry.snapshot()
        rendered = tuple(
            int(snap.get(key, 0)) for _legacy, key in self.STATS_LINE_KEYS
        )
        if rendered == self._stats_snapshot:
            return  # idle: don't grow the log
        self._stats_snapshot = rendered
        print(
            "TB_STATS " + " ".join(
                f"{legacy}={value}"
                for (legacy, _key), value in zip(
                    self.STATS_LINE_KEYS, rendered
                )
            ),
            flush=True,
        )

    def _dispatch_drain(self, n, ev_types, conns, offsets, lens,
                        arena) -> int:
        """Columnar round: verify every framed message in ONE batch
        checksum pass (native, or the vectorized Python fallback),
        gather all headers in one vectorized cast, then walk the
        events in arrival order — protocol messages dispatch inline
        (pre-verified), client requests collect into one columnar
        batch handed to the replica at the end of the round.  Bodies
        stay zero-copy views of the drain arena until a retention
        point (queue/prepare) forces the single necessary copy."""
        import numpy as np

        is_msg = (ev_types[:n] == EV_MESSAGE) & (lens[:n] > 0)
        midx = np.nonzero(is_msg)[0]
        hdrs = ok = None
        if len(midx):
            t0 = time.perf_counter_ns()
            moffs = offsets[midx]
            mlens = lens[midx]
            ok, hdrs, native, bytes_hashed = self._fastpath.verify_and_gather(
                arena, moffs, mlens
            )
            (self._c_fp_hits if native else self._c_fp_fallbacks).inc()
            # The verify pass is the ingress hash tier.  The replica's
            # hash.bytes_hashed tracks COMMIT-PATH body bytes only
            # (request + prepare frames that verified — the bodies
            # whose digests the reuse seams may consume), so the smoke
            # ratio against committed_body_bytes is exact; protocol
            # bodies (ping clock advertisements etc.) are control-plane
            # noise and land in server.verify_body_bytes, the raw
            # engine total.  bytes_hashed is None only on the
            # stale-.so corner — skip, never guess.
            if bytes_hashed is not None:
                self._c_verify_bytes.inc(bytes_hashed)
                cmds = hdrs["command"]
                ops = hdrs["operation"]
                # Sessionless admin queries (stats / state_root) are
                # request frames that never commit — excluded, or a
                # scrape-polling client would inflate the numerator.
                rel = np.asarray(ok, bool) & (
                    (
                        (cmds == int(Command.request))
                        & (ops != int(wire.VsrOperation.stats))
                        & (ops != int(wire.VsrOperation.state_root))
                    )
                    | (cmds == int(Command.prepare))
                )
                rel_bytes = (
                    int(mlens[rel].sum()) - HEADER_SIZE * int(rel.sum())
                )
                if rel_bytes > 0:
                    self.replica._c_hash_bytes.inc(rel_bytes)
            # Amortized decode cost per 128-byte event record, sampled
            # only for rounds that actually carry event bodies —
            # protocol-only rounds (heartbeats, prepare_oks) would
            # otherwise report the fixed per-drain setup cost as a
            # bogus "per event" number.
            n_events = (int(mlens.sum()) - HEADER_SIZE * len(midx)) // 128
            if n_events > 0:
                self._h_decode_ev.observe(
                    (time.perf_counter_ns() - t0) / 1e3 / n_events
                )
        mv = memoryview(arena)
        msgs = 0
        pos = 0
        req_hdrs: list = []
        req_bodies: list = []
        # Contiguous same-command runs of prepare / prepare_ok frames
        # collect here and hand off as ONE batch call (vsr/multi.py
        # on_prepares_batch / on_prepare_oks_batch) — the
        # C-resident drain seam.  Any other event flushes the pending
        # run first, so relative order against non-run messages is
        # exactly the per-message walk's; requests still defer to the
        # end of the round, AFTER the final flush.
        run_kind = 0
        run_hdrs: list = []
        run_bodies: list = []

        def flush_run() -> None:
            nonlocal run_kind, run_hdrs, run_bodies
            if not run_hdrs:
                return
            if run_kind == int(Command.prepare):
                self.replica.on_prepares_batch(run_hdrs, run_bodies)
            else:
                self.replica.on_prepare_oks_batch(run_hdrs)
            run_kind = 0
            run_hdrs = []
            run_bodies = []

        for j in range(n):
            et = int(ev_types[j])
            conn = int(conns[j])
            if et == EV_CLOSED:
                flush_run()
                self.bus.drop_conn(conn)
                continue
            if et != EV_MESSAGE or not lens[j]:
                continue
            i = pos
            pos += 1
            if not ok[i]:
                continue
            msgs += 1
            header = hdrs[i]
            off = int(offsets[j])
            end = off + int(lens[j])
            cmd = int(header["command"])
            if cmd == int(Command.request):
                if int(header["operation"]) == int(wire.VsrOperation.stats):
                    # Scrapes answer from live state: flush so they
                    # observe everything that arrived before them.
                    flush_run()
                    self._send_stats_reply(conn, header)
                    continue
                if int(header["operation"]) == int(
                    wire.VsrOperation.state_root
                ):
                    flush_run()
                    self._send_state_root_reply(
                        conn, header, mv[off + HEADER_SIZE : end]
                    )
                    continue
                self.replica.anatomy.stage_h(header, "ingress")
                self.bus.register_client(conn, wire.u128(header, "client"))
                req_hdrs.append(header)
                req_bodies.append(mv[off + HEADER_SIZE : end])
            elif cmd in (int(Command.prepare), int(Command.prepare_ok)):
                # Learn peer identity at collection time, exactly as
                # _dispatch_message would per message (ack routing in
                # the batch path needs the conn registered).
                if int(header["replica"]) != self.replica.replica:
                    if self.bus._conn_peer.get(conn) is None:
                        self.bus.register_peer(conn, int(header["replica"]))
                if run_kind != cmd:
                    flush_run()
                    run_kind = cmd
                run_hdrs.append(header)
                if cmd == int(Command.prepare):
                    run_bodies.append(mv[off + HEADER_SIZE : end])
            else:
                flush_run()
                self._dispatch_message(
                    conn, header, bytes(mv[off + HEADER_SIZE : end]),
                    verified=True,
                )
        flush_run()
        if req_hdrs:
            self.replica.on_requests_batch(req_hdrs, req_bodies)
        return msgs

    def _send_stats_reply(self, conn: int, header) -> None:
        # Admin scrape (obs/scrape.py): answered from the registry
        # snapshot right here — read-only, sessionless, and never
        # enters the consensus pipeline.  Tail exemplars (the slow
        # requests' stage timelines) ride along as a structured key
        # next to the flat counters.
        from tigerbeetle_tpu_torch.obs.scrape import stats_reply

        snap = self.registry.snapshot()
        snap["anatomy.exemplars"] = (
            self.replica.anatomy.exemplar_snapshot()
        )
        reply, body = stats_reply(snap, header)
        self.bus.native.send(conn, reply.tobytes() + body)

    def _send_state_root_reply(self, conn: int, header,
                               query: bytes = b"") -> None:
        # Proof-of-state hook (state_machine/commitment.py): the
        # 16-byte incremental state commitment + the commit_min it is
        # current to — read-only, sessionless, answered here so it can
        # never enter consensus.  Replicas without a commitment-aware
        # state machine answer zeros (the client treats an all-zero
        # root as "not supported / empty").  A query body naming an op
        # answers from the root ring (the follower attestation
        # primitive) when that op is still retained; otherwise the
        # current root goes out and the caller sees the op mismatch.
        from tigerbeetle_tpu_torch.obs.scrape import state_root_reply
        from tigerbeetle_tpu_torch.state_machine import commitment

        sm = self.replica.sm
        at_op = commitment.parse_root_query(bytes(query))
        root = at_op_root = None
        if at_op is not None:
            at_op_root = self.replica.root_at(at_op)
        if at_op_root is not None:
            root, commit_min = at_op_root, at_op
        else:
            root = sm.state_root() if hasattr(sm, "state_root") else bytes(16)
            commit_min = self.replica.commit_min
        reply, body = state_root_reply(root, commit_min, header)
        self.bus.native.send(conn, reply.tobytes() + body)

    def _on_raw_message(self, conn: int, payload: bytes) -> None:
        if len(payload) < HEADER_SIZE:
            return
        # Wire decode cost (header cast + checksum verify) — the
        # per-message cost the columnar ingest path replaces; measured
        # here so the legacy arm reports its µs honestly, including
        # the SAME per-event amortized instrument the columnar drain
        # feeds (the TB_FASTPATH_DECODE=0/1 bench arms compare it).
        t0 = time.perf_counter_ns()
        header = wire.header_from_bytes(payload[:HEADER_SIZE])
        body = payload[HEADER_SIZE:]
        ok = wire.verify_header(header, body)
        decode_us = (time.perf_counter_ns() - t0) / 1e3
        self._h_decode.observe(decode_us)
        n_events = len(body) // 128
        if n_events > 0:
            self._h_decode_ev.observe(decode_us / n_events)
        if not ok:
            return
        self._dispatch_message(conn, header, body, verified=True)

    def _dispatch_message(self, conn: int, header, body: bytes,
                          verified: bool = False) -> None:
        cmd = int(header["command"])
        if cmd == int(Command.request) and (
            int(header["operation"]) == int(wire.VsrOperation.stats)
        ):
            self._send_stats_reply(conn, header)
            return
        if cmd == int(Command.request) and (
            int(header["operation"]) == int(wire.VsrOperation.state_root)
        ):
            self._send_state_root_reply(conn, header, body)
            return
        if cmd in (Command.ping, Command.pong):
            announce = int(header["request"]) == TcpBus.ANNOUNCE_REQUEST
            self.bus.register_peer(
                conn, int(header["replica"]), is_process=announce
            )
            if announce:
                # Transport-only handshake: the replica field is a
                # PROCESS index, which the protocol layer would misread
                # as a slot (polluting slot-keyed release/clock maps) —
                # answer with a reciprocal announce so the connector
                # registers this side too, and stop here.
                if cmd == int(Command.ping):
                    # Pong-flavored so the reciprocal doesn't echo.
                    self.bus._announce(
                        conn, self.replica.cluster, self.replica.view,
                        pong=True,
                    )
                return
            # Protocol ping/pong: carries clock-sync samples
            # (vsr/clock.py); the reply rides the registered conn.
            self.replica.on_message(header, body, verified=verified)
            return
        if cmd == Command.request:
            # Ingress stage for sampled requests (trace context is
            # CLIENT-owned: the server never mints one — a minted id
            # would alter prepare checksums and break the recorded
            # wire contract for legacy clients; unsampled requests
            # stay byte-identical end to end).  Admission shedding
            # happens in the replica's enqueue path, AFTER dedupe.
            self.replica.anatomy.stage_h(header, "ingress")
            self.bus.register_client(conn, wire.u128(header, "client"))
        elif int(header["replica"]) != self.replica.replica:
            # Learn peer identity from any replica-sourced message.
            kind = self.bus._conn_peer.get(conn)
            if kind is None and cmd not in (
                int(Command.reply), int(Command.eviction),
            ):
                self.bus.register_peer(conn, int(header["replica"]))
        self.replica.on_message(header, body, verified=verified)

    def _on_shed(self, header, tenant=None) -> None:
        """Replica shed callback: count + flight-note (the replica
        already sent the typed busy on the client's connection).  The
        tenant rides the note so a postmortem flight dump shows WHO
        was shed during an overload window — and a per-tenant shed
        instant (`shed.t<ledger>`) makes the per-tenant timeline
        greppable without parsing note args."""
        self._c_shed.inc()
        self.flight.note(
            "shed", client=wire.u128(header, "client"),
            request=int(header["request"]),
            queue=len(self.replica.request_queue),
            tenant=-1 if tenant is None else tenant,
        )
        if tenant is not None:
            self.flight.note(f"shed.t{tenant}")

    def install_flight_handlers(self) -> None:
        """Dump the flight ring on SIGTERM, then hand the signal on: to
        the Python handler installed before (the CLI's, which asks
        serve_forever to return so the server closes and exits 0), else
        to the default disposition (exit code intact for supervisors).
        The reference always takes the default disposition, so its
        `start` never reaches its own close() on SIGTERM.  Main-thread
        only — in-process test servers (threaded loops) skip it."""
        import signal

        try:
            previous = signal.getsignal(signal.SIGTERM)
        except ValueError:
            return

        def on_sigterm(signum, frame):
            try:
                self.flight.write(self._flight_path, reason="sigterm")
            finally:
                if callable(previous):
                    signal.signal(signum, previous)
                    previous(signum, frame)
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not the main thread: no signal-based dump

    def request_stop(self) -> None:
        """Make serve_forever return after the poll in progress (safe
        from a signal handler: it only sets a flag, so no exception
        lands inside the replica's code)."""
        self._stop_requested = True

    def serve_forever(self) -> None:
        self.install_flight_handlers()
        self._stop_requested = False
        while not self._stop_requested:
            try:
                self.poll_once()
            except AssertionError as exc:
                # Invariant violation: capture the last moments before
                # the crash.  The `assertion_failure` event is a flight
                # trigger, so note() flushes the ring to disk.
                self.flight.note("assertion_failure", error=repr(exc)[:500])
                raise

    def close(self) -> None:
        # Device-engine end-of-life barrier first: every outstanding
        # reply future must resolve (host replay if the link is gone)
        # or fail typed before the process tears down its I/O.
        sm = getattr(self.replica, "sm", None)
        dev = getattr(sm, "_dev", None)
        if dev is not None and hasattr(dev, "close"):
            dev.close()
        # Release any held acks, then join background durability work
        # (in-flight async checkpoint flip, WAL sync) BEFORE any fd
        # closes — the checkpoint worker's finalize calls aof.sync()
        # and storage.sync(), and closing those fds first would turn
        # the join into an EBADF (or worse, an fdatasync on a reused
        # fd number).
        self.replica.flush_group_commit()
        self.replica.close()
        if self.replica.aof is not None:
            self.replica.aof.close()
        if self._trace_path:
            self.replica.tracer.write(self._trace_path)
        self.bus.native.close()
        self.storage.close()


def format_data_file(path: str, *, cluster: int, replica_index: int = 0,
                     replica_count: int = 1,
                     config: cfg.Config = cfg.PRODUCTION,
                     grid_size: int = 1 << 20) -> None:
    layout = ZoneLayout(config=config, grid_size=grid_size)
    storage = FileStorage(path, layout, create=True)
    vsr_format.format(storage, cluster, replica_index, replica_count)
    storage.close()
