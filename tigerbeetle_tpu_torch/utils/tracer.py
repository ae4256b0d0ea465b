"""Tracer: span tree with slot-based start/end discipline.

This package's own copy of ``tigerbeetle_tpu/utils/tracer.py``.

reference: src/tracer.zig:1-70 — events are started/ended on fixed
slots (so nesting bugs assert immediately), and emitted to a backend
selected at init: `none` (no-op, zero overhead) or `json` (Chrome
trace-event format, loadable in chrome://tracing / Perfetto — the
tracy backend analog for this build).

Hooked in the hot paths (the reference hooks tracer.zig directly in
src/state_machine.zig:610-614,1124-1143 and src/io/linux.zig:31-33):
replica commit stages, checkpoint, journal writes, LSM spill/seal, and
the device flush — see Replica.tracer.  Backend "none" costs one
attribute check per site.

Beyond spans, the tracer carries counter series (`count()`, Chrome
"C" events: queue depths, batch sizes, repair counts) and instant
markers (`instant()`).  The buffer is bounded: oldest spans drop first
and the drop total is reported in the dump, so a long-running server
can leave tracing on.
"""

from __future__ import annotations

import collections
import json
import time


# Event vocabulary (reference: src/tracer.zig:48-70), extended with
# the cross-replica drain timeline (prepare -> covering fsync ->
# prepare_ok -> commit -> reply) and the server/device seams.  The
# list is documentation — spans are keyed by name, not index.
EVENTS = (
    "commit", "checkpoint",
    "state_machine_prefetch", "state_machine_commit", "state_machine_compact",
    "tree_compaction", "lsm_spill", "grid_read", "grid_write",
    "io_read", "io_write", "replica_on_message", "journal_write",
    "device_flush", "wal_scrub", "block_repair",
    "prepare", "prepare_ok", "gc_covering_sync", "reply",
    "ckpt_freeze", "ckpt_finalize", "poll_drain", "device_link",
    "wave_dispatch",
)

BUFFER_MAX = 200_000  # events kept before oldest-first dropping


class Tracer:
    def __init__(self, backend: str = "none", process_id: int = 0,
                 clock=time.perf_counter_ns,
                 buffer_max: int = BUFFER_MAX) -> None:
        assert backend in ("none", "json")
        self.backend = backend
        self.enabled = backend != "none"
        self.process_id = process_id
        self.clock = clock
        self.buffer_max = buffer_max
        # Optional obs.flight.FlightRecorder sink: instants (and span
        # ends) are mirrored into its bounded ring EVEN when the
        # backend is "none" — the flight recorder is the always-on
        # postmortem buffer, the backend the opt-in full trace.
        self.flight = None
        self._open: dict[tuple[str, int], tuple[int, dict | None]] = {}
        # deque(maxlen) drops oldest in O(1); a list shift per event
        # would make every traced hot-path op O(buffer_max) once full.
        self._spans: collections.deque[dict] = collections.deque(
            maxlen=buffer_max
        )
        self.dropped = 0

    # -- spans ---------------------------------------------------------

    def start(self, event: str, slot: int = 0, **args) -> None:
        """Open span `event` on `slot`.  One slot holds one open span
        of a given name — double-start asserts immediately (the
        reference's slot discipline); concurrent same-name spans use
        distinct slots (e.g. op number % k)."""
        if not self.enabled:
            return
        key = (event, slot)
        assert key not in self._open, f"span {event}[{slot}] already open"
        self._open[key] = (self.clock(), args or None)

    def stop(self, event: str, slot: int = 0) -> None:
        if not self.enabled:
            return
        key = (event, slot)
        # Unbalanced end asserts immediately (the reference's slot
        # discipline), instead of surfacing as a bare KeyError.
        assert key in self._open, f"span {event}[{slot}] not open"
        begin, args = self._open.pop(key)
        now = self.clock()
        span = {
            "name": event, "ph": "X", "pid": self.process_id, "tid": slot,
            "ts": begin / 1e3, "dur": (now - begin) / 1e3,
        }
        if args:
            span["args"] = args
        self._push(span)

    def span(self, event: str, slot: int = 0, **args):
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, event, slot, args)

    # -- counters + instants -------------------------------------------

    def count(self, series: str, value: float, **extra) -> None:
        """Counter sample (Chrome 'C' event): queue depth, batch size,
        repair totals — graphed as a time series by the viewer."""
        if not self.enabled:
            return
        values = {"value": value}
        values.update(extra)
        self._push(
            {
                "name": series, "ph": "C", "pid": self.process_id,
                "tid": 0, "ts": self.clock() / 1e3, "args": values,
            }
        )

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (view change, crash recovery, …).
        Mirrored into the flight ring even with backend "none" — the
        postmortem buffer must not depend on full tracing being on."""
        if self.flight is not None:
            self.flight.note(name, **args)
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "i", "s": "p", "pid": self.process_id,
            "tid": 0, "ts": self.clock() / 1e3,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    # -- output --------------------------------------------------------

    def _push(self, event: dict) -> None:
        if len(self._spans) == self.buffer_max:
            self.dropped += 1
        self._spans.append(event)

    def dump(self) -> str:
        assert not self._open, f"open spans at dump: {list(self._open)}"
        return json.dumps(
            {
                "traceEvents": list(self._spans),
                "otherData": {"dropped_events": self.dropped},
            }
        )

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump())

    @classmethod
    def from_env(cls, process_id: int = 0) -> "Tracer":
        """Backend from the TB_TRACE knob (envcheck-validated)."""
        from tigerbeetle_tpu_torch import envcheck

        return cls(envcheck.trace_backend(), process_id=process_id)


class _Span:
    __slots__ = ("_tracer", "_event", "_slot", "_args")

    def __init__(self, tracer: Tracer, event: str, slot: int, args: dict):
        self._tracer = tracer
        self._event = event
        self._slot = slot
        self._args = args

    def __enter__(self):
        self._tracer.start(self._event, self._slot, **self._args)

    def __exit__(self, *exc):
        self._tracer.stop(self._event, self._slot)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# One shared no-op context manager: disabled-tracer spans on the hot
# path cost an attribute check and this constant return.
_NOOP_SPAN = _NoopSpan()

# Shared no-op instance for call sites whose owner never enabled
# tracing (enabled=False short-circuits every method).
NULL = Tracer("none")
