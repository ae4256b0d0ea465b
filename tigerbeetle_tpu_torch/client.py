"""Python client: typed API over the native C-ABI session.

This package's own copy of ``tigerbeetle_tpu/client.py``.

The role of the reference's language clients (reference:
src/clients/python would be the analog; all funnel through the
tb_client C ABI — src/clients/c/tb_client.zig:1-142).  Batches are
encoded straight into the 128-byte wire layouts (numpy structured
arrays), so the bytes this client sends are exactly what the state
machine kernel consumes — the zero-copy "batch encoder feeds the
device" path.
"""

from __future__ import annotations

import time

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.runtime.native import NativeClient
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_BALANCE_DTYPE,
    ACCOUNT_DTYPE,
    ACCOUNT_FILTER_DTYPE,
    CREATE_RESULT_DTYPE,
    TRANSFER_DTYPE,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
)


class Client:
    """Synchronous client for one cluster address.

    >>> c = Client("127.0.0.1:3001", cluster_id=0)
    >>> c.create_accounts([{"id": 1, "ledger": 1, "code": 1}])
    []
    """

    def __init__(self, address: str, cluster_id: int = 0, *,
                 client_id: int | None = None, timeout_ms: int = 10_000) -> None:
        # `address` may be a comma-separated cluster list: the first is
        # the initial target; retransmissions rotate through the rest
        # so view changes recover (reference: src/vsr/client.zig).
        addrs = address.split(",")
        host, _, port = addrs[0].rpartition(":")
        if client_id is None:
            client_id = int.from_bytes(__import__("os").urandom(8), "little") | 1
        self._native = NativeClient(
            host or "127.0.0.1", int(port), cluster_id, client_id
        )
        for extra in addrs[1:]:
            h, _, p = extra.rpartition(":")
            self._native.add_address(h or "127.0.0.1", int(p))
        self.timeout_ms = timeout_ms

    def close(self) -> None:
        self._native.close()

    # ------------------------------------------------------------------

    def _rows(self, dtype: np.dtype, events, u128_fields) -> bytes:
        arr = np.zeros(len(events), dtype=dtype)
        for i, ev in enumerate(events):
            if isinstance(ev, np.void):
                arr[i] = ev
                continue
            for key, value in ev.items():
                if key in u128_fields:
                    types.u128_set(arr[i], key, value)
                else:
                    arr[i][key] = value
        return arr.tobytes()

    def create_accounts(self, accounts) -> list[tuple[int, CreateAccountResult]]:
        body = self._rows(
            ACCOUNT_DTYPE, accounts,
            {"id", "debits_pending", "debits_posted", "credits_pending",
             "credits_posted", "user_data_128"},
        )
        reply = self._native.request(
            Operation.create_accounts, body, self.timeout_ms
        )
        out = np.frombuffer(reply, CREATE_RESULT_DTYPE)
        return [
            (int(r["index"]), CreateAccountResult(int(r["result"]))) for r in out
        ]

    def create_transfers(self, transfers) -> list[tuple[int, CreateTransferResult]]:
        body = self._rows(
            TRANSFER_DTYPE, transfers,
            {"id", "debit_account_id", "credit_account_id", "amount",
             "pending_id", "user_data_128"},
        )
        reply = self._native.request(
            Operation.create_transfers, body, self.timeout_ms
        )
        out = np.frombuffer(reply, CREATE_RESULT_DTYPE)
        return [
            (int(r["index"]), CreateTransferResult(int(r["result"]))) for r in out
        ]

    def _ids(self, ids) -> bytes:
        arr = np.zeros(len(ids), types.U128_PAIR_DTYPE)
        for i, v in enumerate(ids):
            arr[i]["lo"] = v & types.U64_MAX
            arr[i]["hi"] = v >> 64
        return arr.tobytes()

    def lookup_accounts(self, ids) -> np.ndarray:
        reply = self._native.request(
            Operation.lookup_accounts, self._ids(ids), self.timeout_ms
        )
        return np.frombuffer(reply, ACCOUNT_DTYPE)

    def lookup_transfers(self, ids) -> np.ndarray:
        reply = self._native.request(
            Operation.lookup_transfers, self._ids(ids), self.timeout_ms
        )
        return np.frombuffer(reply, TRANSFER_DTYPE)

    def _filter(self, account_id: int, *, timestamp_min=0, timestamp_max=0,
                limit=8190, flags=types.AccountFilterFlags.debits
                | types.AccountFilterFlags.credits) -> bytes:
        row = np.zeros(1, ACCOUNT_FILTER_DTYPE)[0]
        types.u128_set(row, "account_id", account_id)
        row["timestamp_min"] = timestamp_min
        row["timestamp_max"] = timestamp_max
        row["limit"] = limit
        row["flags"] = flags
        return row.tobytes()

    def get_account_transfers(self, account_id: int, **kw) -> np.ndarray:
        reply = self._native.request(
            Operation.get_account_transfers, self._filter(account_id, **kw),
            self.timeout_ms,
        )
        return np.frombuffer(reply, TRANSFER_DTYPE)

    def get_account_balances(self, account_id: int, **kw) -> np.ndarray:
        reply = self._native.request(
            Operation.get_account_balances, self._filter(account_id, **kw),
            self.timeout_ms,
        )
        return np.frombuffer(reply, ACCOUNT_BALANCE_DTYPE)


class OpenLoopSession:
    """Open-loop wire client: MANY requests in flight on one session.

    The synchronous `Client` is closed-loop (one request blocks until
    its reply) — it cannot generate the arrival pressure production
    traffic has.  This client submits without waiting: `submit()`
    stamps a wire trace context (trace_id + origin CLOCK_MONOTONIC ns
    + sampled flag, vsr/wire.py) and returns immediately; `poll()`
    drains completions — `reply` (committed) or `busy` (typed
    admission shed, Command.client_busy) — each with client-measured
    latency.  bench.py's --open-loop mode and the overload smoke test
    drive it.
    """

    BUSY_RETRIES_MAX = 6  # then the busy surfaces as a completion

    def __init__(self, address: str, cluster: int, client_id: int, *,
                 register_timeout_ms: int = 30_000) -> None:
        from tigerbeetle_tpu_torch import envcheck
        from tigerbeetle_tpu_torch.constants import HEADER_SIZE
        from tigerbeetle_tpu_torch.runtime.native import EV_MESSAGE, NativeBus
        from tigerbeetle_tpu_torch.vsr import wire

        self._wire = wire
        self._hs = HEADER_SIZE
        self._ev_message = EV_MESSAGE
        self.cluster = cluster
        self.id = client_id
        self.request_number = 0
        # request number -> (submit perf_counter_ns, operation, frame
        # bytes) — the frame is kept so a typed busy can be
        # retransmitted verbatim after backoff (same request number:
        # it is a RETRANSMIT, so the at-most-once gate still applies).
        self.inflight: dict[int, tuple[int, int, bytes]] = {}
        # (request_number, kind "reply"|"busy", latency_s, reply_body,
        #  operation, tier) — the operation rides along so a mixed-op
        # driver (the read-heavy open-loop bench) can grade reads and
        # writes separately; `tier` records WHO served the completion
        #: ("primary"|"follower", server id, claimed
        # commit_min, attested root bytes) — zero/empty for primary
        # replies, so the bench's write-p99-flat grade can attribute
        # interference and a client can verify follower attestations.
        self.completed: list[tuple[int, str, float, bytes, int, tuple]] = []
        self.busy_replies = 0
        # Busy backoff (TB_BUSY_BACKOFF_MS): a shed request
        # retransmits after base * 2^(streak-1) ms (capped 16x) plus
        # deterministic seeded jitter instead of completing
        # immediately — immediate retransmit re-offers the overload
        # that shed it and self-amplifies the storm.  0 disables
        # (busy surfaces as a completion at once, the legacy shape).
        self.busy_backoffs = 0
        self._backoff_base_ns = int(envcheck.busy_backoff_ms() * 1e6)
        self._busy_streak: dict[int, int] = {}   # request -> streak
        self._retry_at: dict[int, int] = {}      # request -> due ns
        host, _, port = address.rpartition(":")
        self.bus = NativeBus()
        self.conn = self.bus.connect(host or "127.0.0.1", int(port))
        self._register(register_timeout_ms)

    def _register(self, timeout_ms: int) -> None:
        wire = self._wire
        h = wire.make_header(
            command=wire.Command.request,
            operation=wire.VsrOperation.register,
            cluster=self.cluster, client=self.id, request=0,
        )
        wire.finalize_header(h, b"")
        deadline = time.monotonic() + timeout_ms / 1e3
        last_sent = 0.0
        while time.monotonic() < deadline:
            if time.monotonic() - last_sent >= 1.0:
                last_sent = time.monotonic()
                self.bus.send(self.conn, h.tobytes())
            for ev_type, _conn, payload in self.bus.poll(50):
                if ev_type != self._ev_message or len(payload) < self._hs:
                    continue
                rh = wire.header_from_bytes(payload[: self._hs])
                if not wire.verify_header(rh, payload[self._hs:]):
                    continue
                if int(rh["command"]) == int(wire.Command.reply) and (
                    int(rh["operation"]) == int(wire.VsrOperation.register)
                ):
                    return
        raise TimeoutError(f"open-loop register of client {self.id:#x}")

    def submit(self, operation, body: bytes, *, tenant: int = 0) -> int:
        """Fire one request (no waiting).  Returns its request number;
        the completion arrives via poll().  `tenant` stamps the wire
        tenant key (0 = legacy: the server derives it from the body's
        leading event)."""
        wire = self._wire
        self.request_number += 1
        now = time.perf_counter_ns()
        h = wire.make_header(
            command=wire.Command.request, operation=operation,
            cluster=self.cluster, client=self.id,
            request=self.request_number,
            tenant=tenant,
            trace_id=((self.id << 20) ^ self.request_number)
            & 0xFFFFFFFFFFFFFFFF,
            trace_ts=now,
            trace_flags=wire.TRACE_SAMPLED,
        )
        wire.finalize_header(h, body)
        frame = h.tobytes() + body
        self.inflight[self.request_number] = (now, int(operation), frame)
        self.bus.send(self.conn, frame)
        return self.request_number

    def poll(self, timeout_ms: int = 0) -> None:
        """Drain completions into `self.completed` — through the same
        columnar batch verify/decode the server drain uses (one arena
        copy + one checksum pass per poll) when the native bus
        supports it; per-frame otherwise."""
        wire = self._wire
        batch = self.bus.poll_drain(timeout_ms)
        if batch is None:
            for ev_type, _conn, payload in self.bus.poll(timeout_ms):
                if ev_type != self._ev_message or len(payload) < self._hs:
                    continue
                h = wire.header_from_bytes(payload[: self._hs])
                body = payload[self._hs:]
                if not wire.verify_header(h, body):
                    continue
                self._complete(h, bytes(body))
            self._flush_backoff(time.perf_counter_ns())
            return
        import numpy as np

        from tigerbeetle_tpu_torch.runtime import fastpath

        n, ev_types, _conns, offsets, lens, arena = batch
        if not n:
            self._flush_backoff(time.perf_counter_ns())
            return
        is_msg = (ev_types[:n] == self._ev_message) & (lens[:n] > 0)
        midx = np.nonzero(is_msg)[0]
        if len(midx):
            moffs = offsets[midx]
            mlens = lens[midx]
            ok, hdrs, _native, _bytes = fastpath.verify_and_gather(
                arena, moffs, mlens
            )
            mv = memoryview(arena)
            for i in range(len(midx)):
                if not ok[i]:
                    continue
                off = int(moffs[i])
                self._complete(
                    hdrs[i],
                    bytes(mv[off + self._hs : off + int(mlens[i])]),
                )
        self._flush_backoff(time.perf_counter_ns())

    def _flush_backoff(self, now_ns: int) -> None:
        """Retransmit busy-shed requests whose backoff expired."""
        if not self._retry_at:
            return
        for req in [r for r, due in self._retry_at.items() if due <= now_ns]:
            del self._retry_at[req]
            entry = self.inflight.get(req)
            if entry is None:
                self._busy_streak.pop(req, None)
                continue
            self.bus.send(self.conn, entry[2])

    def _complete(self, h, body: bytes) -> None:
        wire = self._wire
        cmd = int(h["command"])
        req = int(h["request"])
        entry = self.inflight.get(req)
        if cmd == int(wire.Command.client_busy):
            if entry is not None:
                self.busy_replies += 1
                streak = self._busy_streak.get(req, 0) + 1
                if (
                    self._backoff_base_ns > 0
                    and streak <= self.BUSY_RETRIES_MAX
                    # A FOLLOWER refusal is a redirect, not overload:
                    # retransmitting at the same follower would just
                    # collect the same typed refusal — surface it so
                    # the driver re-routes to the primary.
                    and wire.parse_follower_busy(body) is None
                ):
                    # Hold the request in flight and retransmit after
                    # capped exponential backoff (qos.backoff_delay:
                    # deterministic seeded jitter, shared with
                    # SimClient).
                    from tigerbeetle_tpu_torch import qos

                    self._busy_streak[req] = streak
                    self._retry_at[req] = (
                        time.perf_counter_ns() + qos.backoff_delay(
                            self.id, req, streak, self._backoff_base_ns,
                        )
                    )
                    self.busy_backoffs += 1
                    return
                del self.inflight[req]
                self._busy_streak.pop(req, None)
                self._retry_at.pop(req, None)
                t0, op, _frame = entry
                lat = (time.perf_counter_ns() - t0) / 1e9
                self.completed.append(
                    (req, "busy", lat, b"", op, self._tier_of(h, body))
                )
        elif cmd == int(wire.Command.reply):
            if entry is not None:
                del self.inflight[req]
                self._busy_streak.pop(req, None)
                self._retry_at.pop(req, None)
                t0, op, _frame = entry
                lat = (time.perf_counter_ns() - t0) / 1e9
                self.completed.append(
                    (req, "reply", lat, body, op, self._tier_of(h, b""))
                )
        elif cmd == int(wire.Command.eviction):
            raise RuntimeError(f"open-loop client {self.id:#x} evicted")

    def _tier_of(self, h, busy_body: bytes) -> tuple:
        """Serving-tier attribution of one completion: a reply with an
        attestation carve-out (or a typed follower busy) was follower-
        served; everything else is the primary path."""
        wire = self._wire
        att = wire.attestation_of(h)
        if att is not None:
            return ("follower", int(h["replica"]), att[1], att[0])
        fb = wire.parse_follower_busy(busy_body) if busy_body else None
        if fb is not None:
            return ("follower", fb[1], fb[3], b"")
        return ("primary", int(h["replica"]), 0, b"")

    def close(self) -> None:
        self.bus.close()
