"""Cluster clock synchronization: Marzullo interval intersection.

This package's own copy of ``tigerbeetle_tpu/vsr/clock.py``.

Re-expresses the reference's clock stack (reference: src/vsr/clock.zig,
src/vsr/marzullo.zig) for this runtime: each replica samples every
peer's wall clock over ping/pong round trips, turns each sample into an
offset interval [offset - error, offset + error] (error = half the
round-trip time plus tolerance), and intersects the intervals with
Marzullo's algorithm to find the smallest window agreed on by a
majority of the cluster.  The primary then assigns prepare timestamps
from `realtime_synchronized()` — its own wall clock clamped into the
agreed window — so a primary with a skewed clock cannot poison the
cluster's strictly-monotonic timestamp stream (reference:
src/vsr/replica.zig:5762-5772 uses clock.realtime_synchronized()).

Time bases follow the reference: sample round trips are measured on the
local MONOTONIC clock (immune to wall-clock steps), while offsets
relate wall clocks (reference: src/vsr/clock.zig Epoch
monotonic/realtime capture).
"""

from __future__ import annotations

from dataclasses import dataclass

# reference: src/config.zig clock_offset_tolerance_max (10ms) and
# clock_epoch_max (60s) — the tolerance pads each sample's error bound;
# the epoch bound expires stale samples.
OFFSET_TOLERANCE_NS = 10_000_000
EPOCH_MAX_NS = 60_000_000_000
# reference: src/config.zig clock_synchronization_window_min/max — a
# sample's round trip must be sane before it is admitted.
RTT_MAX_NS = 2_000_000_000


def marzullo_smallest_interval(
    tuples: list[tuple[int, int]],
) -> tuple[int, int, int]:
    """Smallest interval consistent with the largest number of sources.

    `tuples` is [(offset, error), ...]; each source asserts the true
    offset lies in [offset - error, offset + error].  Returns
    (lo, hi, sources_true) — the reference's Marzullo.Interval
    (reference: src/vsr/marzullo.zig:12-60).  Touching endpoints count
    as overlapping, matching the reference's edge ordering (a lower
    edge sorts before an equal upper edge).
    """
    if not tuples:
        return (0, 0, 0)
    edges: list[tuple[int, int]] = []
    for offset, error in tuples:
        assert error >= 0, error
        edges.append((offset - error, 0))  # 0 = lower edge
        edges.append((offset + error, 1))  # 1 = upper edge
    edges.sort()
    best = 0
    count = 0
    lo = hi = edges[0][0]
    for i, (value, kind) in enumerate(edges):
        if kind == 0:
            count += 1
            if count > best:
                best = count
                lo = value
                hi = edges[i + 1][0]
        else:
            count -= 1
    return (lo, hi, best)


@dataclass
class _Sample:
    offset: int
    error: int
    learned_at: int  # local monotonic ns


class Clock:
    """Per-replica clock synchronizer.

    All methods take explicit (monotonic_ns, realtime_ns) "now" values
    so the deterministic simulator can drive virtual time (reference
    clock.zig is parameterized over Time for the same reason).
    """

    def __init__(self, replica: int, replica_count: int) -> None:
        self.replica = replica
        self.replica_count = replica_count
        # Best (lowest-error) sample per peer in the current epoch.
        self._samples: dict[int, _Sample] = {}
        self.window_lo = 0
        self.window_hi = 0
        self.synchronized = replica_count == 1
        self.sources_true = 1

    # -- sampling ------------------------------------------------------

    def learn(
        self,
        peer: int,
        m0: int,
        t1: int,
        m2: int,
        *,
        realtime_now: int,
    ) -> None:
        """Admit one ping/pong sample: ping sent at local monotonic
        `m0`, peer's wall clock read `t1`, pong received at local
        monotonic `m2` with local wall clock `realtime_now`
        (reference: src/vsr/clock.zig Clock.learn)."""
        if peer == self.replica:
            return
        if m2 < m0:
            return  # monotonic went backwards across a restart
        rtt = m2 - m0
        if rtt > RTT_MAX_NS:
            return  # saturated link; sample error too large to help
        # The peer read t1 somewhere inside [m0, m2]; assume the
        # midpoint and bound the error by half the round trip.
        error = rtt // 2 + OFFSET_TOLERANCE_NS
        offset = t1 + rtt // 2 - realtime_now
        best = self._samples.get(peer)
        # `<=` so a steady-RTT stream keeps refreshing learned_at —
        # otherwise every sample would age out together at EPOCH_MAX
        # and the cluster clock would flap unsynchronized periodically.
        if best is None or error <= best.error:
            self._samples[peer] = _Sample(offset, error, m2)
        self._synchronize(m2)

    def expire(self, monotonic_now: int) -> None:
        """Drop samples older than the epoch bound (reference:
        src/vsr/clock.zig epoch expiry)."""
        stale = [
            p
            for p, s in self._samples.items()
            if monotonic_now - s.learned_at > EPOCH_MAX_NS
        ]
        for p in stale:
            del self._samples[p]
        if stale:
            self._synchronize(monotonic_now)

    # -- synchronization ----------------------------------------------

    def _synchronize(self, monotonic_now: int) -> None:
        # Our own clock is a source with zero offset and zero error.
        tuples = [(0, 0)]
        tuples += [(s.offset, s.error) for s in self._samples.values()]
        lo, hi, sources = marzullo_smallest_interval(tuples)
        quorum = self.replica_count // 2 + 1
        if sources >= quorum:
            self.window_lo = lo
            self.window_hi = hi
            self.synchronized = True
            self.sources_true = sources
        elif self.replica_count > 1:
            self.synchronized = False

    def realtime_synchronized(self, realtime_now: int) -> int | None:
        """The local wall clock clamped into the cluster-agreed offset
        window, or None when unsynchronized (the caller falls back or
        defers — reference: src/vsr/replica.zig on_request's
        realtime_synchronized gate)."""
        if not self.synchronized:
            return None
        # True time ~ realtime_now + offset for offset in [lo, hi];
        # our own reading (offset 0) is clamped into the window.
        if 0 < self.window_lo:
            return realtime_now + self.window_lo
        if 0 > self.window_hi:
            return realtime_now + self.window_hi
        return realtime_now
