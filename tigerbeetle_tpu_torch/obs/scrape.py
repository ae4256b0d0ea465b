"""Live counter scrape over the wire: the `stats` admin operation.

This package's own copy of ``tigerbeetle_tpu/obs/scrape.py``.

A running ReplicaServer answers `Command.request` +
`VsrOperation.stats` directly from its registry snapshot — read-only,
no session, no consensus (each replica reports its OWN counters, which
is exactly what fsyncs-per-prepare accounting needs).  The reply is a
`Command.reply` whose body is the JSON-encoded snapshot dict.

bench.py's replicated config and the tier-1 TCP smoke test use this
instead of regex-parsing TB_STATS log tails; the log-tail parser
survives only as the counter-verified fallback for kill -9'd replicas
(which can't answer a scrape but did leave their last line behind).
"""
# tbcheck: allow-file(determinism): scrape clients poll a live TCP
# server with wall-clock deadlines; the sim never executes them.

from __future__ import annotations

import json
import time

from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.wire import Command, VsrOperation

# Fixed request id for scrape matching: scrapes are sessionless
# (client=0), so the request field is free for correlation.
SCRAPE_REQUEST = 0x57A7


def scrape_stats(address: str, cluster: int, timeout_ms: int = 10_000) -> dict:
    """One registry snapshot from the replica at `address`
    ("host:port").  Raises TimeoutError when the server never answers
    (dead replica — callers fall back to its log tail)."""
    from tigerbeetle_tpu_torch.runtime.native import EV_MESSAGE, NativeBus

    host, _, port = address.rpartition(":")
    bus = NativeBus()
    try:
        conn = bus.connect(host or "127.0.0.1", int(port))
        h = wire.make_header(
            command=Command.request, operation=VsrOperation.stats,
            cluster=cluster, request=SCRAPE_REQUEST,
        )
        wire.finalize_header(h, b"")
        bus.send(conn, h.tobytes())
        deadline = time.monotonic() + timeout_ms / 1e3
        while time.monotonic() < deadline:
            for ev_type, _conn, payload in bus.poll(50):
                if ev_type != EV_MESSAGE or len(payload) < HEADER_SIZE:
                    continue
                header = wire.header_from_bytes(payload[:HEADER_SIZE])
                body = payload[HEADER_SIZE:]
                if not wire.verify_header(header, body):
                    continue
                if (
                    int(header["command"]) == int(Command.reply)
                    and int(header["operation"]) == int(VsrOperation.stats)
                    and int(header["request"]) == SCRAPE_REQUEST
                ):
                    return json.loads(body.decode())
    finally:
        bus.close()
    raise TimeoutError(f"stats scrape of {address} timed out")


def scrape_state_root(
    address: str, cluster: int, timeout_ms: int = 10_000,
    at_op: int | None = None,
) -> tuple[bytes, int]:
    """Proof-of-state query: the replica's 16-byte state commitment
    (state_machine/commitment.py) + the commit_min it covers.  Same
    sessionless shape as the stats scrape — read-only, answered by the
    server loop, never enters consensus.  `at_op` asks for the root AS
    OF a specific op (answered from the replica's root ring when
    retained — the follower attestation query); callers must check the
    returned op, since a server without that op answers current."""
    from tigerbeetle_tpu_torch.runtime.native import EV_MESSAGE, NativeBus
    from tigerbeetle_tpu_torch.state_machine import commitment

    host, _, port = address.rpartition(":")
    bus = NativeBus()
    try:
        conn = bus.connect(host or "127.0.0.1", int(port))
        h = wire.make_header(
            command=Command.request, operation=VsrOperation.state_root,
            cluster=cluster, request=SCRAPE_REQUEST,
        )
        qbody = b"" if at_op is None else commitment.root_query_body(at_op)
        wire.finalize_header(h, qbody)
        bus.send(conn, h.tobytes() + qbody)
        deadline = time.monotonic() + timeout_ms / 1e3
        while time.monotonic() < deadline:
            for ev_type, _conn, payload in bus.poll(50):
                if ev_type != EV_MESSAGE or len(payload) < HEADER_SIZE:
                    continue
                header = wire.header_from_bytes(payload[:HEADER_SIZE])
                body = payload[HEADER_SIZE:]
                if not wire.verify_header(header, body):
                    continue
                if (
                    int(header["command"]) == int(Command.client_busy)
                    and int(header["request"]) == SCRAPE_REQUEST
                ):
                    # The router runs this query through its admission
                    # bound (unlike stats, answered pre-admission): a
                    # shed under load replies client_busy.  Resend
                    # instead of burning the rest of the deadline.
                    bus.send(conn, h.tobytes() + qbody)
                    continue
                if (
                    int(header["command"]) == int(Command.reply)
                    and int(header["operation"])
                    == int(VsrOperation.state_root)
                    and int(header["request"]) == SCRAPE_REQUEST
                ):
                    return commitment.parse_root_body(bytes(body))
    finally:
        bus.close()
    raise TimeoutError(f"state_root scrape of {address} timed out")


def state_root_reply(root: bytes, commit_min: int, request_header) -> tuple:
    """Server side: (reply_header, body) answering a `state_root`
    request with the 24-byte root+commit_min body."""
    from tigerbeetle_tpu_torch.state_machine import commitment

    body = commitment.root_body(root, commit_min)
    reply = wire.make_header(
        command=Command.reply, operation=VsrOperation.state_root,
        cluster=wire.u128(request_header, "cluster"),
        client=wire.u128(request_header, "client"),
        request=int(request_header["request"]),
    )
    wire.finalize_header(reply, body)
    return reply, body


def stats_reply(snapshot: dict, request_header) -> tuple:
    """Server side: (reply_header, body) answering `request_header`
    with `snapshot` (runtime/server.py sends it on the raw conn)."""
    body = json.dumps(snapshot, sort_keys=True).encode()
    reply = wire.make_header(
        command=Command.reply, operation=VsrOperation.stats,
        cluster=wire.u128(request_header, "cluster"),
        client=wire.u128(request_header, "client"),
        request=int(request_header["request"]),
    )
    wire.finalize_header(reply, body)
    return reply, body
