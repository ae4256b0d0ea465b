"""Root-attested follower serving: read scale-out that can never lie
about staleness.

Production read traffic (balance lookups, history/filter queries)
dwarfs writes, yet a read through the consensus pipeline consumes
primary capacity.  A follower tails the primary's durable AOF
(vsr/aof.py — self-framing, checksum-verified, offset-resumable),
replays it deterministically into its own state machine, and serves
the read-only operations at a stated `commit_min`.  The r15 state
commitment turns that from "trust me" into an attestation (the
AlDBaran light-client angle, arXiv:2508.10493):

- every follower reply carries (state_root, commit_min) in the
  reserved-byte attestation carve-out (vsr/wire.py), so a client can
  verify integrity AND staleness against the cluster commitment;
- the follower itself continuously cross-checks its replayed roots
  against the upstream replica's root ring (the `state_root` at-op
  query) and REFUSES to serve the moment it cannot prove its state.

The robustness contract — refuse, never lie
-------------------------------------------
A follower under crash / lag / partition / log corruption degrades to
a typed refusal (`wire.FollowerRefuse`), never to a wrong answer:

- torn tailed log (crashed writer)  -> replay parks at the resume
  offset and heals when bytes land; meanwhile the follower lags and
  the staleness bound redirects reads.
- corrupt tailed log / op gap       -> replay refuses to advance
  (`corrupt`/`gap`); state stays at the last verified point.
- replay divergence (the follower's root at op N differs from the
  primary's root at op N)           -> `poisoned`, a terminal refusal:
  the follower's state machine can no longer be trusted at ANY op.
- partition from the upstream       -> attestations stop, the lag
  estimate ages, and the staleness bound eventually refuses.

What this does and does not guarantee: replies at ops the attestation
loop has already verified are proven; replies in the (bounded) window
between `attested_op` and `commit_min` rest on the AOF's checksums +
deterministic replay, and the carried root lets the CLIENT close that
window by verifying against the primary's root ring — which is why
the attestation rides every reply instead of being an internal check.

Determinism: this module runs inside the seeded simulators
(testing/cluster.py drives FollowerCore tick-by-tick), so it reads no
wall clocks and draws no entropy — FollowerServer takes an injected
`clock_ns` from its process entry point (cli.py).

This package's own copy of ``tigerbeetle_tpu/runtime/follower.py``; it
replays on the port's CPU oracle, as the reference replays on its own.
"""

from __future__ import annotations

import dataclasses

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.state_machine.demuxer import batch_logical_allowed
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.aof import AofTail
from tigerbeetle_tpu_torch.vsr.wire import Command, FollowerRefuse, VsrOperation

# Operations a follower may answer (int view of the one shared
# definition, types.READ_OPERATIONS — the state machine's executors
# and the router's steering key on the same set).
READ_OPERATIONS = frozenset(int(op) for op in types.READ_OPERATIONS)


class _StopReplay(Exception):
    """Internal: abort the current pump() batch after a latch."""


@dataclasses.dataclass
class FollowerReply:
    """A served read: the reply body plus the attestation the wire
    reply will carry."""

    body: bytes
    commit_min: int
    root: bytes


@dataclasses.dataclass
class FollowerRefusal:
    """A typed decline (refuse-not-lie): WHY plus how far behind."""

    reason: FollowerRefuse
    lag_ops: int
    commit_min: int


class FollowerCore:
    """Sans-IO follower: AOF tail replay + attestation + serving gate.

    Callers own all I/O and time: `pump()` advances replay from the
    tail source, `on_attestation()` feeds upstream (root, op) answers,
    `serve()` answers one read or returns a typed refusal.  All state
    transitions are pure functions of those calls — the deterministic
    simulators (testing/cluster.py SimFollower, the VOPR follower
    nemesis) drive the exact code the TCP server runs.
    """

    def __init__(self, source_or_path, *, cluster: int,
                 state_machine, follower_id: int = 0,
                 offset: int = 0,
                 staleness_ops: int | None = None,
                 attest_max_age_ns: int | None = None,
                 root_ring: int | None = None,
                 registry=None, qos=None) -> None:
        from tigerbeetle_tpu_torch import envcheck, obs

        self.cluster = cluster
        self.follower_id = follower_id
        self.sm = state_machine
        assert hasattr(self.sm, "execute_read"), (
            "follower state machine must expose execute_read()"
        )
        self.tail = AofTail(source_or_path, offset=offset)
        self.qos = qos
        self.staleness_ops = (
            envcheck.read_staleness_ops()
            if staleness_ops is None else int(staleness_ops)
        )
        # Attestation-age bound: lag_ops is a high-water-mark estimate
        # that a FULL partition freezes at 0 — the age of the last
        # successful attestation is what actually keeps the staleness
        # bound honest there.  The clock is the same caller-supplied
        # now_ns that serve() takes (ticks in sims, injected wall
        # clock in the server); 0 disables the bound.
        self.attest_max_age_ns = (
            envcheck.follower_attest_max_ms() * 1_000_000
            if attest_max_age_ns is None else int(attest_max_age_ns)
        )
        self.last_attest_ns = 0
        self.ring_max = (
            envcheck.follower_ring() if root_ring is None
            else int(root_ring)
        )
        # Replay state.
        self.commit_min = 0
        self.gapped = False          # op discontinuity in the tail
        self.incompatible = False    # state machine rejected a record
        # Own per-op roots (bounded ring) — what attestations verify
        # against and what replies carry.
        self._roots: dict[int, bytes] = {}
        # Attestation state.
        self.attested_op = 0         # highest op verified upstream
        self.last_primary_op = 0     # freshest upstream commit point
        self.poisoned = False        # verified MISMATCH — terminal
        self._pending_attest: dict[int, bytes] = {}
        # Instruments (the contract: lag_ops / redirects / refused).
        self.registry = registry if registry is not None else obs.Registry()
        self._c_applied = self.registry.counter("follower.applied")
        self._c_served = self.registry.counter("follower.served")
        # redirects: transient declines (lagging / overload) — the
        # client's next stop is the primary, the follower stays in
        # rotation.  refused: integrity declines (unattested /
        # poisoned / corrupt / gap / non-read op) — the follower
        # cannot prove its state.
        self._c_redirects = self.registry.counter("follower.redirects")
        self._c_refused = self.registry.counter("follower.refused")
        self._c_attest_ok = self.registry.counter("follower.attest_ok")
        self._c_attest_mismatch = self.registry.counter(
            "follower.attest_mismatch"
        )
        self._c_attest_missed = self.registry.counter(
            "follower.attest_missed"
        )
        self._c_gap = self.registry.counter("follower.tail_gap")
        self._c_corrupt = self.registry.counter("follower.tail_corrupt")
        self._c_incompatible = self.registry.counter(
            "follower.incompatible"
        )
        self.registry.gauge_fn("follower.id", lambda: self.follower_id)
        self.registry.gauge_fn("follower.commit_min",
                               lambda: self.commit_min)
        self.registry.gauge_fn("follower.lag_ops", lambda: self.lag_ops())
        self.registry.gauge_fn("follower.attested_op",
                               lambda: self.attested_op)
        self.registry.gauge_fn("follower.poisoned",
                               lambda: int(self.poisoned))
        # Optional flight hook (FollowerServer attaches its recorder);
        # None in the sim unless a test wires one.
        self.flight = None

    # -- replay --------------------------------------------------------

    def lag_ops(self) -> int:
        return max(0, self.last_primary_op - self.commit_min)

    def pump(self, max_records: int = 512) -> int:
        """Advance replay from the tail; returns ops applied.  Never
        raises on bad log bytes — torn tails park (resume offset
        retained), corruption and op gaps latch a refusal state."""
        if self.gapped or self.poisoned or self.incompatible:
            return 0
        was_corrupt = self.tail.corrupt
        entries = self.tail.poll(limit=max_records)
        if self.tail.corrupt and not was_corrupt:
            self._c_corrupt.inc()
            self._note("follower_tail_corrupt",
                       reason=self.tail.corrupt_reason or "")
        applied = 0
        for header, body in entries:
            if int(header["command"]) != int(Command.prepare):
                continue
            if wire.u128(header, "cluster") != self.cluster:
                continue
            op = int(header["op"])
            if op <= self.commit_min:
                continue  # duplicate (re-tail after restart)
            if op != self.commit_min + 1:
                # Discontinuity: ops the log lost (a crash that beat
                # the writer's gap-fill) — replaying past it would
                # fabricate a state no replica ever held.  Latch and
                # refuse; the operator re-seeds the follower.
                self.gapped = True
                self._c_gap.inc()
                self._note("follower_tail_gap", at=op,
                           commit_min=self.commit_min)
                break
            try:
                self._apply(header, body)
            except _StopReplay:
                break
            applied += 1
        return applied

    def _apply(self, header, body: bytes) -> None:
        op = int(header["op"])
        operation = int(header["operation"])
        if operation in READ_OPERATIONS:
            # Committed READS change no state: skip execution and
            # carry the previous root forward.  This keeps follower
            # replay cost proportional to WRITE volume — otherwise a
            # read-heavy cluster (the exact workload followers exist
            # to absorb, including the reads the router redirects on
            # refusal) commits read ops faster than a follower can
            # re-execute them, and the lag feedback loop never
            # converges.
            self._advance(op, self._roots.get(op - 1))
            return
        if operation >= int(types.Operation.pulse):
            timestamp = int(header["timestamp"])
            sm_op = types.Operation(operation)
            # Logically-batched prepare (vsr/multi.py): context = sub
            # count, body = concatenated event bytes + demux trailer.
            # The follower commits the EVENT bytes exactly like the
            # replica commit path (per-client reply slicing is the
            # primary's job, not replay's).
            n_subs = wire.u128(header, "context")
            if n_subs and batch_logical_allowed(sm_op):
                from tigerbeetle_tpu_torch.state_machine import demuxer

                try:
                    body, _subs = demuxer.decode_trailer(body, n_subs)
                except (AssertionError, ValueError):
                    self.incompatible = True
                    self._c_incompatible.inc()
                    self._note("follower_incompatible", at=op,
                               operation=operation, body_len=len(body))
                    raise _StopReplay()
            if not self.sm.input_valid(sm_op, body):
                # A checksum-valid committed record the follower's
                # state machine rejects = config/software mismatch
                # (e.g. the upstream accepts larger batches).  Latch
                # and refuse — applying a guess would serve fabricated
                # state; crashing would take the redirect path down
                # with it.
                self.incompatible = True
                self._c_incompatible.inc()
                self._note("follower_incompatible", at=op,
                           operation=operation, body_len=len(body))
                raise _StopReplay()
            self.sm.prepare_timestamp = timestamp
            self.sm.prefetch(sm_op, body, prefetch_timestamp=timestamp)
            self.sm.commit(0, op, timestamp, sm_op, body)
        # VSR-internal ops (register, reconfigure) advance the op
        # stream without touching ledger state — the root is carried
        # forward so every op has a recorded root.
        self._advance(op, None)

    def _advance(self, op: int, carried_root: bytes | None) -> None:
        """Record `op` replayed: advance commit_min, ring the root
        (carried forward for state-neutral ops, recomputed/read from
        the state machine otherwise), verify any parked attestation."""
        self.commit_min = op
        self._c_applied.inc()
        root = carried_root
        if root is None:
            root = self.sm.state_root()
        self._roots[op] = root
        while len(self._roots) > self.ring_max:
            self._roots.pop(next(iter(self._roots)))
        claim = self._pending_attest.pop(op, None)
        if claim is not None:
            self._verify(op, claim, root)

    # -- attestation ---------------------------------------------------

    def on_attestation(self, root: bytes, op: int,
                       now_ns: int = 0) -> None:
        """Feed one upstream `state_root` answer (at-op or current).
        Matching roots raise `attested_op`; a mismatch at an op both
        sides committed is proof of divergence and poisons the
        follower.  `now_ns` (same clock as serve()) feeds the
        attestation-age bound."""
        if self.poisoned:
            return
        self.last_attest_ns = max(self.last_attest_ns, now_ns)
        self.last_primary_op = max(self.last_primary_op, op)
        own = self._roots.get(op)
        if own is not None:
            self._verify(op, root, own)
        elif op > self.commit_min:
            # Ahead of our replay: park the claim, verified the moment
            # replay reaches it (bounded — keep the freshest few).
            self._pending_attest[op] = root
            while len(self._pending_attest) > 8:
                self._pending_attest.pop(
                    min(self._pending_attest)
                )
        else:
            # Behind our ring floor (extreme lag of the QUERY, not the
            # follower) — can neither confirm nor deny.
            self._c_attest_missed.inc()

    def _verify(self, op: int, claimed: bytes, own: bytes) -> None:
        if claimed == own:
            self.attested_op = max(self.attested_op, op)
            self._c_attest_ok.inc()
        else:
            self.poisoned = True
            self._c_attest_mismatch.inc()
            self._note("follower_poisoned", op=op,
                       own=own.hex(), claimed=claimed.hex())

    def _note(self, name: str, **args) -> None:
        if self.flight is not None:
            self.flight.note(name, **args)

    # -- serving -------------------------------------------------------

    def refuse_reason(self, now_ns: int = 0) -> FollowerRefuse | None:
        """The gate, in precedence order: integrity refusals first
        (they say "do not trust me"), staleness last (it says "the
        primary is fresher").  Staleness is TWO checks: the op-lag
        estimate, and the AGE of the last attestation — a full
        partition freezes the former at 0, so only the latter refuses
        there (the contract: degrade to redirect, never serve
        unboundedly frozen state as fresh)."""
        if self.poisoned:
            return FollowerRefuse.poisoned
        if self.tail.corrupt:
            return FollowerRefuse.corrupt
        if self.gapped:
            return FollowerRefuse.gap
        if self.incompatible:
            return FollowerRefuse.incompatible
        if self.attested_op == 0:
            return FollowerRefuse.unattested
        if self.lag_ops() > self.staleness_ops:
            return FollowerRefuse.lagging
        if (
            self.attest_max_age_ns > 0
            and now_ns > self.last_attest_ns + self.attest_max_age_ns
        ):
            return FollowerRefuse.lagging
        return None

    def refusal(self, reason: FollowerRefuse) -> FollowerRefusal:
        (self._c_redirects if reason in (
            FollowerRefuse.lagging, FollowerRefuse.overload
        ) else self._c_refused).inc()
        return FollowerRefusal(reason, self.lag_ops(), self.commit_min)

    def serve(self, operation: int, body: bytes, *, now_ns: int = 0,
              tenant: int = 0):
        """Answer one read, or refuse typed.  `now_ns` feeds the QoS
        bucket clock (tick-derived in sims, injected wall clock in the
        server)."""
        if int(operation) not in READ_OPERATIONS:
            return self.refusal(FollowerRefuse.not_readable)
        reason = self.refuse_reason(now_ns)
        if reason is not None:
            return self.refusal(reason)
        if self.qos is not None:
            self.qos.observe(tenant, now_ns)
            if not self.qos.admit(tenant, now_ns, 0,
                                  body_bytes=len(body)):
                self.qos.on_shed(tenant)
                return self.refusal(FollowerRefuse.overload)
            self.qos.on_admit(tenant)
        reply = self.sm.execute_read(types.Operation(operation), body)
        root = self._roots.get(self.commit_min)
        if root is None:
            root = self.sm.state_root()
        self._c_served.inc()
        return FollowerReply(reply, self.commit_min, root)


class FollowerServer:
    """TCP read-only follower: the `tigerbeetle follower` process.

    Joins the server family next to ReplicaServer/RouterServer:
    clients speak the normal wire protocol (register is answered
    sessionless — reads are idempotent, at-most-once state would be
    dead weight), read operations are served with the attestation
    stamped into the reply header, everything else gets the typed
    follower busy.  The upstream replica is polled for attestations on
    the TB_FOLLOWER_ATTEST_MS cadence, alternating "root at MY
    commit_min" (verification) with "current root" (lag estimate).

    `clock_ns` is injected (time.monotonic_ns at the process entry
    point) — this module stays wall-clock-free for the simulators.
    """

    def __init__(self, listen_address: str, *, aof_path: str,
                 upstream_address: str, cluster: int,
                 state_machine, clock_ns, follower_id: int = 0,
                 staleness_ops: int | None = None,
                 message_size_max: int | None = None) -> None:
        from tigerbeetle_tpu_torch import envcheck, obs
        from tigerbeetle_tpu_torch.obs.flight import FlightRecorder
        from tigerbeetle_tpu_torch.runtime.native import (
            EV_CLOSED, EV_MESSAGE, NativeBus,
        )
        from tigerbeetle_tpu_torch.runtime.server import parse_address

        self._ev_message = EV_MESSAGE
        self._ev_closed = EV_CLOSED
        self.cluster = cluster
        self.clock_ns = clock_ns
        self.registry = obs.Registry()
        qos = None
        if envcheck.tenant_qos():
            from tigerbeetle_tpu_torch.qos import TenantQos

            qos = TenantQos(
                rate=envcheck.tenant_rate(),
                rate_bytes=envcheck.tenant_rate_bytes(),
                weights=envcheck.tenant_weights(),
                registry=self.registry.scope("follower.qos"),
            )
        self.core = FollowerCore(
            aof_path, cluster=cluster, state_machine=state_machine,
            follower_id=follower_id, staleness_ops=staleness_ops,
            registry=self.registry, qos=qos,
        )
        flight_path = envcheck.env_str(
            "TB_FLIGHT_PATH", f"tb_flight_f{follower_id}.json"
        )
        self._flight_path = flight_path
        self.flight = FlightRecorder(
            process_id=1000 + follower_id, dump_path=flight_path,
            stats_fn=lambda: self.registry.snapshot(),
        )
        self.core.flight = self.flight
        self.bus = NativeBus(
            message_size_max or cfg.PRODUCTION.message_size_max
        )
        host, port = parse_address(listen_address)
        self.port = self.bus.listen(host, port)
        self.upstream = parse_address(upstream_address)
        self._up_conn: int | None = None
        self._attest_ns = envcheck.follower_attest_ms() * 1_000_000
        # Anchor at NOW: the first query fires one full cadence in —
        # the clock is an arbitrary monotonic epoch, and `0` would
        # read as "due since boot".
        self._last_attest = clock_ns()
        self._attest_request = 0x0F0110000
        self._attest_current = False  # alternate at-op / current

    # -- upstream attestation ------------------------------------------

    def _upstream_conn(self) -> int | None:
        if self._up_conn is not None:
            return self._up_conn
        try:
            self._up_conn = self.bus.connect(*self.upstream)
        except OSError:
            return None
        return self._up_conn

    def _send_attest_query(self) -> None:
        from tigerbeetle_tpu_torch.state_machine import commitment

        conn = self._upstream_conn()
        if conn is None:
            return
        self._attest_request += 1
        self._attest_current = not self._attest_current
        if self._attest_current or self.core.commit_min == 0:
            qbody = b""  # current root: refreshes the lag estimate
        else:
            qbody = commitment.root_query_body(self.core.commit_min)
        h = wire.make_header(
            command=Command.request, operation=VsrOperation.state_root,
            cluster=self.cluster, client=0,
            request=self._attest_request & 0xFFFFFFFF,
        )
        wire.finalize_header(h, qbody)
        self.bus.send(conn, h.tobytes() + qbody)

    def _on_upstream(self, header, body: bytes) -> None:
        from tigerbeetle_tpu_torch.state_machine import commitment

        if int(header["command"]) != int(Command.reply):
            return
        if int(header["operation"]) != int(VsrOperation.state_root):
            return
        try:
            root, op = commitment.parse_root_body(bytes(body))
        except ValueError:
            return
        if root != bytes(16):  # all-zero = upstream has no commitment
            self.core.on_attestation(root, op, now_ns=self.clock_ns())

    # -- client serving ------------------------------------------------

    def _reply(self, conn: int, req_header, operation: int,
               body: bytes, attest: tuple | None) -> None:
        h = wire.make_header(
            command=Command.reply, cluster=self.cluster,
            client=wire.u128(req_header, "client"),
            request=int(req_header["request"]),
            operation=operation,
            replica=self.core.follower_id & 0xFF,
        )
        wire.copy_trace(h, req_header)
        if attest is not None:
            wire.stamp_attestation(h, attest[0], attest[1])
        wire.finalize_header(h, body)
        self.bus.send(conn, h.tobytes() + body)

    def _refuse(self, conn: int, req_header,
                refusal: FollowerRefusal) -> None:
        payload = wire.follower_busy_body(
            int(refusal.reason), self.core.follower_id,
            refusal.lag_ops, refusal.commit_min,
        )
        h = wire.make_header(
            command=Command.client_busy, cluster=self.cluster,
            client=wire.u128(req_header, "client"),
            request=int(req_header["request"]),
            replica=self.core.follower_id & 0xFF,
        )
        wire.copy_trace(h, req_header)
        wire.finalize_header(h, payload)
        self.bus.send(conn, h.tobytes() + payload)
        self.flight.note(
            "follower_refuse", reason=int(refusal.reason),
            lag=refusal.lag_ops, commit_min=refusal.commit_min,
        )

    def _on_request(self, conn: int, header, body: bytes) -> None:
        operation = int(header["operation"])
        if operation == int(VsrOperation.stats):
            from tigerbeetle_tpu_torch.obs.scrape import stats_reply

            reply, rbody = stats_reply(self.registry.snapshot(), header)
            self.bus.send(conn, reply.tobytes() + rbody)
            return
        if operation == int(VsrOperation.state_root):
            from tigerbeetle_tpu_torch.obs.scrape import state_root_reply
            from tigerbeetle_tpu_torch.state_machine import commitment

            core = self.core
            at_op = commitment.parse_root_query(bytes(body))
            root = None if at_op is None else core._roots.get(at_op)
            if root is not None:
                commit_min = at_op
            else:
                root = core._roots.get(core.commit_min)
                if root is None:
                    root = core.sm.state_root()
                commit_min = core.commit_min
            reply, rbody = state_root_reply(root, commit_min, header)
            self.bus.send(conn, reply.tobytes() + rbody)
            return
        if operation == int(VsrOperation.register):
            # Sessionless register: reads are idempotent, so the
            # follower keeps no session table — but answering lets
            # unmodified clients (OpenLoopSession, the C client)
            # connect without a special mode.
            self._reply(conn, header, operation, b"", None)
            return
        tenant = wire.tenant_of(header, body)
        result = self.core.serve(
            operation, bytes(body), now_ns=self.clock_ns(),
            tenant=tenant,
        )
        if isinstance(result, FollowerRefusal):
            self._refuse(conn, header, result)
            return
        self._reply(conn, header, operation, result.body,
                    (result.root, result.commit_min))

    # -- loop ----------------------------------------------------------

    def poll_once(self, timeout_ms: int = 10) -> None:
        for ev_type, conn, payload in self.bus.poll(timeout_ms):
            if ev_type == self._ev_closed:
                if conn == self._up_conn:
                    self._up_conn = None
                continue
            if ev_type != self._ev_message or len(payload) < HEADER_SIZE:
                continue
            header = wire.header_from_bytes(payload[:HEADER_SIZE])
            body = payload[HEADER_SIZE:]
            if not wire.verify_header(header, body):
                continue
            if conn == self._up_conn:
                self._on_upstream(header, body)
            elif int(header["command"]) == int(Command.request):
                self._on_request(conn, header, body)
        # Bounded replay burst per poll: a RECORD is a whole client
        # batch (up to 8k events of host state-machine CPU), so even a
        # few per poll keep replay throughput high while reads,
        # scrapes, and attestation replies stay responsive during a
        # deep catch-up — an unbounded pump starved them for the
        # whole backlog.
        self.core.pump(max_records=4)
        now = self.clock_ns()
        if now - self._last_attest >= self._attest_ns:
            self._last_attest = now
            self._send_attest_query()

    def serve_forever(self) -> None:
        while True:
            self.poll_once()

    def close(self) -> None:
        self.bus.close()
