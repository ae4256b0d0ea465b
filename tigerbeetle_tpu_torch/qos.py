"""Multi-tenant QoS primitives: token buckets, weighted-fair pick,
observed-rate windows.

This package's own copy of ``tigerbeetle_tpu/qos.py``.

The tenant key is the LEDGER (types.py `ledger` field): production
overload is never uniform, and the reference bounds every resource per
client session (reference: src/vsr/replica.zig client_sessions /
client_busy).  This build keys admission, scheduling, and shedding one
level up — per tenant — so one hot ledger cannot starve the rest.

Three primitives, shared by the replica's request queue
(vsr/multi.py), the router's admission + retry sweep
(runtime/router.py), and the bench graders:

- `TokenBucket`: classic rate limiter, refilled from a monotonic
  clock the CALLER supplies (deterministic in simulators, wall-clock
  in servers).
- `WeightedFair`: smooth weighted round-robin (the nginx algorithm):
  each pick raises every active tenant's credit by its weight, the
  richest tenant wins and pays the total back.  Starvation-free by
  construction — a tenant with weight w among total weight W is
  picked at least once every ceil(W/w) picks (its credit grows by w
  per pick and only the winner ever pays) — and deterministic: ties
  break on the lowest tenant id.
- `RateWindow`: per-tenant arrivals-per-second observation, carried
  back to the shed tenant inside the typed `client_busy` payload so a
  well-behaved client can see WHY it was shed.

Admission and scheduling state is plain Python with no RNG and no
wall-clock reads of its own: the deterministic simulators drive them
with tick-derived clocks and stay byte-reproducible.  (The one
exception is TenantQos.on_reply, which reads the real clock — it
feeds only the observability histograms, never admission or
scheduling decisions, so sim state stays byte-reproducible.)
"""

from __future__ import annotations


class TokenBucket:
    """Token bucket: `rate` tokens/second, capacity `burst` tokens.

    rate <= 0 disables the bucket (admit always) — the default, so
    QoS-on under non-overload stays bit-identical to QoS-off.
    """

    __slots__ = ("rate", "burst", "tokens", "last_ns")

    def __init__(self, rate: float, burst: float | None = None) -> None:
        self.rate = float(rate)
        # Default burst: one second's worth (and never < 1 token, or a
        # positive rate could never admit anything).
        self.burst = max(1.0, float(burst if burst is not None else rate))
        self.tokens = self.burst
        self.last_ns = 0

    def admit(self, now_ns: int, cost: float = 1.0) -> bool:
        """Take `cost` tokens if available.  `now_ns` must be
        monotonic non-decreasing (caller-supplied clock)."""
        if self.peek(now_ns, cost):
            self.take(cost)
            return True
        return False

    def peek(self, now_ns: int, cost: float = 1.0) -> bool:
        """Refill, then check WITHOUT consuming — the two-bucket
        admission (request count AND body bytes) must be atomic: a
        request one bucket refuses must not drain the other (the same
        no-unrefunded-charge rule as the global-bound-first check in
        VsrReplica._enqueue_request)."""
        if self.rate <= 0.0:
            return True
        if now_ns > self.last_ns:
            self.tokens = min(
                self.burst,
                self.tokens + (now_ns - self.last_ns) * 1e-9 * self.rate,
            )
            self.last_ns = now_ns
        return self.tokens >= cost

    def take(self, cost: float = 1.0) -> None:
        """Consume after a successful peek (no refill: peek just
        refilled at the same clock reading)."""
        if self.rate > 0.0:
            self.tokens -= cost


class WeightedFair:
    """Smooth weighted round-robin over a dynamic tenant set.

    `pick(active)` returns the next tenant to serve from `active` (an
    iterable of tenant ids with queued work).  Credit of tenants that
    leave the active set is dropped IMMEDIATELY (see _prune: an idle
    tenant must not hoard credit toward a post-idle burst), so the
    credit map never outgrows the set of tenants concurrently active
    — the proportional-share guarantee holds among continuously
    backlogged tenants; a tenant whose queue empties re-enters at
    zero credit.
    """

    __slots__ = ("weights", "_credit")

    def __init__(self, weights: dict[int, float] | None = None) -> None:
        self.weights = dict(weights or {})
        self._credit: dict[int, float] = {}

    def weight_of(self, tenant: int) -> float:
        w = self.weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def pick(self, active) -> int | None:
        tenants = sorted(set(active))
        if not tenants:
            return None
        if len(tenants) == 1:
            self._prune(active={tenants[0]})
            return tenants[0]
        total = 0.0
        best = None
        # tbcheck: allow(money): WRR scheduling credits are weights,
        # not balances — float by design, never touch u128 amounts.
        best_credit = 0.0
        for t in tenants:
            w = self.weight_of(t)
            total += w
            # tbcheck: allow(money): same scheduler credit accumulator.
            c = self._credit.get(t, 0.0) + w
            self._credit[t] = c
            # Deterministic tie-break: sorted iteration + strict `>`
            # keeps the lowest tenant id when credits tie.
            if best is None or c > best_credit:
                best, best_credit = t, c
        self._credit[best] = best_credit - total
        self._prune(active=set(tenants))
        return best

    def _prune(self, active: set[int]) -> None:
        """Drop credit for tenants with no queued work: an idle
        tenant must not hoard credit (a burst after a long absence
        would then monopolize the drain), and the credit map must
        never outgrow the set of tenants concurrently active."""
        dead = [t for t in self._credit if t not in active]
        for t in dead:
            del self._credit[t]


class RateWindow:
    """Arrivals/second over a rolling one-second window, per tenant.

    `observe(tenant, now_ns)` counts one arrival; `rate(tenant)`
    returns the last COMPLETED window's count (the current partial
    window would under-report early in a second).  Bounded: windows
    are two integers per tenant, pruned with the tenant map.
    """

    WINDOW_NS = 1_000_000_000

    __slots__ = ("_win", "cap")

    def __init__(self, cap: int | None = None) -> None:
        # tenant -> [window_start_ns, count_in_window, last_full_count]
        self._win: dict[int, list] = {}
        # Distinct-tenant bound: observe() runs for EVERY arrival —
        # including in the default rate=0 config, where the bucket
        # eviction path (the only other pruner) never fires — so an
        # uncapped map would let a tenant-id sweep grow server memory
        # without bound.
        self.cap = cap

    def observe(self, tenant: int, now_ns: int) -> None:
        w = self._win.get(tenant)
        if w is None:
            if self.cap is not None and len(self._win) >= self.cap:
                # Evict the stalest window (the tenant least recently
                # re-anchored — its rate figure is the most stale).
                del self._win[min(self._win, key=lambda t: self._win[t][0])]
            self._win[tenant] = [now_ns, 1, 0]
            return
        elapsed = now_ns - w[0]
        if elapsed >= self.WINDOW_NS:
            # Scale the finished window to a per-second figure when it
            # ran long (idle gaps must not inflate the rate).
            w[2] = int(w[1] * self.WINDOW_NS / max(elapsed, 1))
            w[0] = now_ns
            w[1] = 1
        else:
            w[1] += 1

    def rate(self, tenant: int) -> int:
        w = self._win.get(tenant)
        return 0 if w is None else int(w[2])

    def drop(self, tenant: int) -> None:
        self._win.pop(tenant, None)


class TenantQos:
    """Per-tenant admission + scheduling + accounting for one process
    (a replica's request queue or the router's open-request table).

    Bundles the three primitives and the per-tenant obs counters:

    - `admit(tenant, now_ns, queued)`: token bucket + per-tenant queue
      bound; False = shed (the caller sends the typed busy carrying
      `rate_of(tenant)`).
    - `pick(active)`: weighted-fair choice of the next tenant to
      drain.
    - per-tenant counters/histograms under `t<tenant>.` in the given
      registry scope (admit / shed / lat_us with p50/p99 extracted at
      snapshot) — scraped by the stats wire op like every other
      instrument.  Distinct tracked tenants are bounded
      (TENANTS_MAX); overflow tenants share the `tother.` scope so a
      tenant-id sweep cannot grow the registry without bound.
    """

    TENANTS_MAX = 64

    def __init__(self, *, rate: float = 0.0, rate_bytes: float = 0.0,
                 queue_bound: int = 0,
                 weights: dict[int, float] | None = None,
                 registry=None) -> None:
        self.rate = float(rate)
        # Byte accounting (TB_TENANT_RATE_BYTES): a second
        # bucket charged by request BODY BYTES, so mixed-size batches
        # cannot cheat the request-count bucket (one 8k-event batch
        # and one single-event request cost the same count token but
        # ~8000x the decode/replay work).  0 = off.
        self.rate_bytes = float(rate_bytes)
        self.queue_bound = int(queue_bound)
        self.wfq = WeightedFair(weights)
        self.window = RateWindow(cap=self.TENANTS_MAX)
        self._buckets: dict[int, TokenBucket] = {}
        self._byte_buckets: dict[int, TokenBucket] = {}
        self._registry = registry
        self._metrics: dict[int, tuple] = {}
        self.sheds = 0
        self.admits = 0

    # -- admission -----------------------------------------------------

    def observe(self, tenant: int, now_ns: int) -> None:
        """Count one arrival toward the tenant's observed rate —
        BEFORE admission, so the rate in the busy payload reflects the
        tenant's offered load, not just what survived the bucket."""
        self.window.observe(tenant, now_ns)

    def _bucket(self, store: dict, rate: float, tenant: int,
                now_ns: int) -> TokenBucket:
        bucket = store.get(tenant)
        if bucket is None:
            if len(store) >= self.TENANTS_MAX:
                # Bounded state WITHOUT eviction: tenants beyond
                # the cap share ONE overflow bucket (key -1, the
                # `tother` pattern).  Evicting + re-creating
                # instead would hand every returning tenant a
                # fresh full burst — the tenant key is
                # client-controlled (header stamp / body ledger),
                # so an id sweep could cycle a hot tenant through
                # eviction and sustain far above its configured
                # rate.  Sharing under-admits the sweep: the safe
                # direction for overload protection.
                bucket = store.get(-1)
                if bucket is not None:
                    return bucket
                tenant = -1
            bucket = TokenBucket(rate)
            bucket.last_ns = now_ns
            store[tenant] = bucket
        return bucket

    def admit(self, tenant: int, now_ns: int, queued: int,
              body_bytes: int = 0) -> bool:
        """True = enqueue; False = shed.  `queued` is the tenant's
        current queue depth (owned by the caller's queue);
        `body_bytes` charges the byte bucket when TB_TENANT_RATE_BYTES
        is configured.  Charging is ATOMIC across the two buckets:
        both are checked before either is drained, so a shed never
        leaves a half-charge behind."""
        if self.queue_bound > 0 and queued >= self.queue_bound:
            return False
        count_bucket = byte_bucket = None
        if self.rate > 0.0:
            count_bucket = self._bucket(
                self._buckets, self.rate, tenant, now_ns
            )
            if not count_bucket.peek(now_ns):
                return False
        if self.rate_bytes > 0.0:
            byte_bucket = self._bucket(
                self._byte_buckets, self.rate_bytes, tenant, now_ns
            )
            if not byte_bucket.peek(now_ns, float(body_bytes)):
                return False
        if count_bucket is not None:
            count_bucket.take()
        if byte_bucket is not None:
            byte_bucket.take(float(body_bytes))
        return True

    def rate_of(self, tenant: int) -> int:
        return self.window.rate(tenant)

    # -- scheduling ----------------------------------------------------

    def pick(self, active) -> int | None:
        return self.wfq.pick(active)

    # -- accounting ----------------------------------------------------

    def _m(self, tenant: int):
        m = self._metrics.get(tenant)
        if m is None:
            if self._registry is None:
                return None
            if len(self._metrics) >= self.TENANTS_MAX:
                tenant = -1  # shared overflow scope ("tother.")
                m = self._metrics.get(tenant)
                if m is not None:
                    return m
            name = "tother" if tenant == -1 else f"t{tenant}"
            m = (
                self._registry.counter(f"{name}.admit"),
                self._registry.counter(f"{name}.shed"),
                self._registry.histogram(f"{name}.lat_us"),
            )
            self._metrics[tenant] = m
        return m

    def on_admit(self, tenant: int) -> None:
        self.admits += 1
        m = self._m(tenant)
        if m is not None:
            m[0].inc()

    def on_shed(self, tenant: int) -> None:
        self.sheds += 1
        m = self._m(tenant)
        if m is not None:
            m[1].inc()

    def on_reply(self, tenant: int, header) -> None:
        """Per-tenant reply latency, measured from the wire trace
        context's client-submit timestamp (sampled requests only —
        the same origin the anatomy recorder uses)."""
        m = self._m(tenant)
        if m is None:
            return
        import time

        from tigerbeetle_tpu_torch.vsr import wire

        if wire.trace_sampled(header):
            origin = int(header["trace_ts"])
            if origin:
                m[2].observe(
                    max(0.0, (time.perf_counter_ns() - origin) / 1e3)
                )


BUSY_BACKOFF_CAP = 16  # max multiple of the base backoff


def backoff_delay(client_id: int, request: int, streak: int,
                  base: int, cap: int = BUSY_BACKOFF_CAP) -> int:
    """Busy-backoff delay in units of `base` (ns for the TCP client,
    sim ticks for SimClient): base * 2^(streak-1) capped at `cap`
    multiples, plus jitter that is a pure function of
    (client, request, streak) — deterministic under seeded drivers,
    yet de-synchronized across a fleet of shed clients so their
    retransmits don't re-converge on one instant.  ONE formula shared
    by both clients: the sim client exists to model the production
    one, and two hand-maintained copies would drift."""
    mult = min(1 << (streak - 1), cap)
    jitter = (client_id * 1000003 + request * 10007 + streak * 101) % base
    return base * mult + jitter


def parse_weights(raw: str) -> dict[int, float]:
    """TB_TENANT_WEIGHTS syntax: "ledger:weight,ledger:weight"
    (e.g. "1:4,7:2").  Unlisted tenants weigh 1.  Raises ValueError on
    malformed entries — envcheck wraps this into its fail-fast error.
    """
    out: dict[int, float] = {}
    raw = raw.strip()
    if not raw:
        return out
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        tenant_s, _, weight_s = entry.partition(":")
        tenant = int(tenant_s)
        weight = float(weight_s) if weight_s else 1.0
        if tenant < 0:
            raise ValueError(f"tenant {tenant} must be >= 0")
        if not weight > 0:
            raise ValueError(f"weight for tenant {tenant} must be > 0")
        out[tenant] = weight
    return out
