"""StatsD UDP metrics emitter.

This package's own copy of ``tigerbeetle_tpu/utils/statsd.py``.

reference: src/statsd.zig:12-46 — fire-and-forget UDP datagrams in
StatsD line format, used by the benchmark load generator
(reference: src/tigerbeetle/benchmark_load.zig:360-364).
"""

from __future__ import annotations

import socket


class StatsD:
    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "tigerbeetle") -> None:
        self.address = (host, port)
        self.prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode(), self.address)
        except OSError:
            pass  # fire-and-forget

    def gauge(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}.{name}:{value}|g")

    def count(self, name: str, value: int = 1) -> None:
        self._send(f"{self.prefix}.{name}:{value}|c")

    def timing(self, name: str, ms: float) -> None:
        self._send(f"{self.prefix}.{name}:{ms}|ms")

    def close(self) -> None:
        self._sock.close()
