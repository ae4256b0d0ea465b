"""Per-request anatomy: wire-propagated stage timelines + tail exemplars.

This package's own copy of ``tigerbeetle_tpu/obs/anatomy.py``.

The aggregate spine (obs/registry.py) answers "what are the commit
percentiles"; this module answers the question a p999 outlier raises:
*where did THIS request spend its time*.  A compact trace context
(trace_id + origin timestamp + sampled flag, vsr/wire.py) rides the
wire header from client submit through primary prepare, journal write,
group-commit covering sync, backup prepare_ok, commit, and reply; each
hop appends a (stage, CLOCK_MONOTONIC ns) pair to the per-request
record kept here.  Blockchain Machine (arXiv:2104.06968) attributes
its wins by decomposing the sequential commit path stage-by-stage —
this is the per-request instrument that makes that decomposition
possible on live traffic.

Tail exemplars: when a request finishes, its end-to-end latency feeds
the `anatomy.e2e_us` histogram; a request landing in the histogram's
TOP buckets (>= the current p99 bucket, or during warmup) retains its
full stage timeline in a bounded ring (TB_TRACE_EXEMPLARS), scrapeable
via the `stats` wire op and renderable as Perfetto spans
(exemplar_trace_events) — a p999 outlier comes with its own anatomy
attached instead of a number in a bucket.

Costs: disabled (TB_METRICS=0) every method is one attribute check;
enabled, a stage is a list append + dict lookup.  Unsampled requests
(trace_id 0 / flag clear) never reach the recorder — call sites gate
on wire.trace_sampled().
"""

from __future__ import annotations

import collections
import time

from tigerbeetle_tpu_torch.vsr import wire

# Canonical stage vocabulary (documentation — records are keyed by
# name, and hops may repeat: one prepare_ok per backup).
STAGES = (
    "client_submit", "ingress", "queued", "prepare", "journal_write",
    "gc_covering_sync", "prepare_ok", "commit", "reply", "busy",
)

# Bound on concurrently-open (unfinished) records: requests that never
# finish on this replica (dropped duplicates, superseded prepares)
# must not leak — oldest evicts first, counted.
OPEN_MAX = 1024


class AnatomyRecorder:
    """Bounded per-request stage-timeline recorder for one replica.

    `registry` is an obs.Registry (or Scope); the recorder is enabled
    iff the registry is (TB_METRICS=0 disables both).  `flight` is an
    optional obs.flight.FlightRecorder: every stage recorded here also
    lands in the flight ring, so the postmortem dump carries the most
    recent per-request events.
    """

    def __init__(self, registry, *, exemplar_ring: int | None = None,
                 open_max: int = OPEN_MAX,
                 clock=time.perf_counter_ns, flight=None) -> None:
        if exemplar_ring is None:
            from tigerbeetle_tpu_torch import envcheck

            exemplar_ring = envcheck.trace_exemplars()
        assert exemplar_ring > 0
        self.enabled = bool(getattr(registry, "enabled", True))
        self.clock = clock
        self.flight = flight
        self.open_max = open_max
        self.exemplar_ring = exemplar_ring
        # trace_id -> {"origin": ns, "stages": [[name, ns], ...]}.
        # Ordered so overflow evicts the oldest open record.
        self._open: collections.OrderedDict[int, dict] = (
            collections.OrderedDict()
        )
        self.exemplars: collections.deque[dict] = collections.deque(
            maxlen=exemplar_ring
        )
        self._h_e2e = registry.histogram("e2e_us")
        self._c_finished = registry.counter("finished")
        self._c_exemplars = registry.counter("exemplars_kept")
        self._c_evicted = registry.counter("open_evicted")
        registry.gauge_fn("open", lambda: len(self._open))
        registry.gauge_fn("exemplar_ring", lambda: self.exemplar_ring)

    # -- hot path ------------------------------------------------------

    def stage(self, trace_id: int, stage: str, origin_ts: int = 0,
              ts: int | None = None) -> None:
        """Append one stage timestamp to `trace_id`'s record, opening
        it if needed (`origin_ts` = the wire header's client-submit
        timestamp, kept from the first opening hop)."""
        if not self.enabled or not trace_id:
            return
        if ts is None:
            ts = self.clock()
        rec = self._open.get(trace_id)
        if rec is None:
            if len(self._open) >= self.open_max:
                self._open.popitem(last=False)
                self._c_evicted.inc()
            rec = {"origin": origin_ts, "stages": []}
            self._open[trace_id] = rec
        rec["stages"].append([stage, ts])
        if self.flight is not None:
            self.flight.note(stage, ts=ts, trace_id=trace_id)

    def stage_h(self, header, stage: str) -> None:
        """Record a stage straight off a wire header (no-op unless the
        header carries a sampled trace context)."""
        if not self.enabled:
            return
        tid = wire.trace_sampled(header)
        if tid:
            self.stage(tid, stage, origin_ts=int(header["trace_ts"]))

    def stage_many(self, trace_ids, stage: str) -> None:
        """One stage timestamp shared by many requests (the covering
        group-commit sync lands for a whole drain at once)."""
        if not self.enabled or not trace_ids:
            return
        ts = self.clock()
        for tid in trace_ids:
            self.stage(tid, stage, ts=ts)

    def finish(self, trace_id: int, stage: str | None = None) -> None:
        """Close `trace_id`'s record: optional final stage, end-to-end
        latency into the histogram, tail-exemplar retention."""
        if not self.enabled or not trace_id:
            return
        rec = self._open.pop(trace_id, None)
        if rec is None:
            return
        now = self.clock()
        if stage is not None:
            rec["stages"].append([stage, now])
            if self.flight is not None:
                self.flight.note(stage, ts=now, trace_id=trace_id)
        origin = rec["origin"] or (
            rec["stages"][0][1] if rec["stages"] else now
        )
        e2e_us = max(0.0, (now - origin) / 1e3)
        self._c_finished.inc()
        if self._keep_exemplar(e2e_us):
            self._c_exemplars.inc()
            self.exemplars.append(
                {
                    "trace_id": trace_id,
                    "origin_ns": origin,
                    "e2e_us": round(e2e_us, 3),
                    "stages": rec["stages"],
                }
            )
        self._h_e2e.observe(e2e_us)

    def finish_h(self, header, stage: str | None = None) -> None:
        if not self.enabled:
            return
        tid = wire.trace_sampled(header)
        if tid:
            self.finish(tid, stage)

    def _keep_exemplar(self, e2e_us: float) -> bool:
        """Tail criterion: the value's bucket is at (or above) the
        current p99 bucket — i.e. the request landed in the
        histogram's top buckets.  Early requests (warmup, count < 16)
        are kept so the ring is never empty on short runs.  Evaluated
        BEFORE this request's own observation so one slow request
        cannot raise the bar for itself."""
        h = self._h_e2e
        if h.count < 16:
            return True
        from tigerbeetle_tpu_torch.obs.registry import Histogram

        return Histogram.quantize(e2e_us) >= h.percentile(0.99)

    # -- extraction ----------------------------------------------------

    def exemplar_snapshot(self) -> list[dict]:
        """JSON-ready copy of the exemplar ring (newest last) for the
        `stats` wire scrape."""
        return [dict(ex, stages=[list(s) for s in ex["stages"]])
                for ex in self.exemplars]


def exemplar_trace_events(exemplars, pid: int = 0) -> list[dict]:
    """Render scraped exemplars as Chrome-trace events (one track per
    process): per exemplar, one enclosing `request` span plus one span
    per stage GAP named after the stage that closed it — so the
    Perfetto row reads prepare | journal_write | gc_covering_sync |
    commit | reply left to right, each span's width the time that hop
    took.  Output merges with per-replica tracer dumps via
    testing/cluster.merge_traces."""
    events: list[dict] = []
    for slot, ex in enumerate(exemplars):
        stages = ex.get("stages", [])
        if not stages:
            continue
        tid = slot % 32
        t0 = ex.get("origin_ns") or stages[0][1]
        events.append(
            {
                "name": f"request {ex.get('trace_id', 0):#x}",
                "ph": "X", "pid": pid, "tid": tid,
                "ts": t0 / 1e3,
                "dur": max(stages[-1][1] - t0, 1) / 1e3,
                "args": {"e2e_us": ex.get("e2e_us", 0.0)},
            }
        )
        prev = t0
        for name, ts in stages:
            events.append(
                {
                    "name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": prev / 1e3, "dur": max(ts - prev, 1) / 1e3,
                }
            )
            prev = ts
    return events


class _NoopRecorder:
    """Shared disabled instance for components built without a
    registry: every method is one attribute check."""

    enabled = False
    flight = None
    exemplars: collections.deque = collections.deque()

    def stage(self, *a, **k) -> None:
        pass

    def stage_h(self, *a, **k) -> None:
        pass

    def stage_many(self, *a, **k) -> None:
        pass

    def finish(self, *a, **k) -> None:
        pass

    def finish_h(self, *a, **k) -> None:
        pass

    def exemplar_snapshot(self) -> list:
        return []


NULL = _NoopRecorder()
