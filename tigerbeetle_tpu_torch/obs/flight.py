"""Flight recorder: a fixed-size in-memory ring of recent trace events.

This package's own copy of ``tigerbeetle_tpu/obs/flight.py``.

The reference leaves tracing on in production because its backend is
cheap; this build's always-on equivalent is a bounded ring
(TB_FLIGHT_RING events) that costs a deque append per event and ZERO
file I/O — until something goes wrong.  The ring is dumped to disk:

- on demotion (the device engine's `device_demoted` instant is a
  trigger event — the dump captures the requests in flight when the
  link died),
- on assertion failure in the server loop (runtime/server.py wraps
  serve_forever),
- on SIGTERM (runtime/server.py installs the handler),
- on demand (`dump()` / `write()`).

The dump is a Chrome-trace JSON (instant events on one process track),
so `testing/cluster.merge_traces` stitches per-replica flight dumps —
or a flight dump plus live tracer dumps — into one Perfetto timeline
for the postmortem.
"""

from __future__ import annotations

import collections
import json
import time

# Event names that trigger an automatic dump when a dump_path is set.
TRIGGER_EVENTS = frozenset({"device_demoted", "assertion_failure"})


class FlightRecorder:
    def __init__(self, capacity: int | None = None, *, process_id: int = 0,
                 dump_path: str | None = None,
                 clock=time.perf_counter_ns, stats_fn=None) -> None:
        if capacity is None:
            from tigerbeetle_tpu_torch import envcheck

            capacity = envcheck.flight_ring()
        assert capacity > 0
        self.capacity = capacity
        self.process_id = process_id
        self.dump_path = dump_path
        self.clock = clock
        # Registry-snapshot provider (owner-wired, e.g. the server's
        # `lambda: registry.snapshot()`): every dump then embeds the
        # counters alongside the event ring, so a demotion postmortem
        # carries the dev_wave.spec.* / link forensics that explain it.
        self.stats_fn = stats_fn
        self._ring: collections.deque[tuple] = collections.deque(
            maxlen=capacity
        )
        self.dropped = 0
        self.dumps = 0

    # -- hot path ------------------------------------------------------

    def note(self, name: str, ts: int | None = None, **args) -> None:
        """Record one event.  Names in TRIGGER_EVENTS flush the ring
        to dump_path immediately (demotion postmortem)."""
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append((ts if ts is not None else self.clock(),
                           name, args or None))
        if self.dump_path and name in TRIGGER_EVENTS:
            self.write(self.dump_path, reason=name)

    # -- output --------------------------------------------------------

    def events(self) -> list[dict]:
        out = []
        for ts, name, args in self._ring:
            ev = {
                "name": name, "ph": "i", "s": "p",
                "pid": self.process_id, "tid": 0, "ts": ts / 1e3,
            }
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def dump(self, reason: str = "on_demand") -> dict:
        other = {
            "flight_recorder": True,
            "reason": reason,
            "dropped_events": self.dropped,
            "capacity": self.capacity,
        }
        if self.stats_fn is not None:
            try:
                other["stats"] = self.stats_fn()
            # tbcheck: allow(broad-except): the dump may run inside a
            # signal handler — a stats-provider failure records its
            # error in place of the snapshot, never voids the
            # postmortem.
            except Exception as exc:
                other["stats_error"] = repr(exc)[:200]
        return {
            "traceEvents": self.events(),
            "otherData": other,
        }

    def write(self, path: str, reason: str = "on_demand") -> None:
        """Atomic-enough dump: write then rename, so a reader never
        sees a half-written file even when the dump runs inside a
        signal handler."""
        self.dumps += 1
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.dump(reason), f)
        import os

        os.replace(tmp, path)
