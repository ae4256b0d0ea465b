"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

This package's own copy of ``tigerbeetle_tpu/obs/registry.py``.

Design rules (the Blockchain Machine lesson, arXiv:2104.06968: hot-path
accounting lives NEXT to the hot path, not in post-hoc log scraping):

- Handles are plain objects with one hot method (`inc`/`set`/`observe`)
  — a traced site costs one attribute access and one add.
- Every mutation bumps a shared version cell, so idle-dedup (TB_STATS
  printing) and scrape clients compare ONE integer instead of a
  hand-picked tuple that silently goes stale when counters are added.
- Histograms are HDR-style fixed buckets (16 linear sub-buckets per
  power of two, <=12.5% relative width) with EXACT nearest-rank bucket
  selection: `percentile(q)` returns the upper edge of the bucket that
  contains the q-quantile sample, bit-for-bit reproducible against a
  sorted-list oracle quantized by the same `quantize()` (fuzzed in
  tests/test_obs.py).
- Registries compose: `attach(prefix, child)` grafts a component's
  registry into the owner's snapshot under a dotted prefix;
  `gauge_fn(name, fn)` pulls values owned elsewhere (storage fsync
  counts, queue depths) at snapshot time.
- Snapshots are flat `{dotted.name: number}` dicts (histograms expand
  to `.count/.sum/.max/.p50/.p99/.p999`) — JSON-ready for the `stats`
  wire operation, greppable when rendered as a TB_STATS line.
"""

from __future__ import annotations

import math
import time


class Counter:
    """Monotonic counter (floats allowed: wall-time accumulators).

    `inc` is the hot-path method; `set` exists for the compatibility
    properties (benches reset forensics counters between timed arms).
    """

    __slots__ = ("name", "value", "_v")

    def __init__(self, name: str, vcell: list) -> None:
        self.name = name
        self.value = 0
        self._v = vcell

    def inc(self, n=1) -> None:
        self.value += n
        self._v[0] += 1

    def set(self, value) -> None:
        self.value = value
        self._v[0] += 1


class Gauge:
    """Last-write-wins sample (queue depth, window occupancy)."""

    __slots__ = ("name", "value", "_v")

    def __init__(self, name: str, vcell: list) -> None:
        self.name = name
        self.value = 0
        self._v = vcell

    def set(self, value) -> None:
        self.value = value
        self._v[0] += 1


class Histogram:
    """Fixed-bucket latency histogram (HDR layout, sparse storage).

    Values are non-negative numbers; by convention sites record
    MICROSECONDS (names end in `_us`).  Buckets: unit-width below 16,
    then 8 buckets per power of two (width 2^e), so relative bucket
    width is <=12.5% — plenty for latency percentiles — while any
    value up to ~17 minutes in µs needs <260 bucket slots.
    """

    SUB_BITS = 4
    SUBS = 1 << SUB_BITS  # 16

    __slots__ = ("name", "_v", "counts", "count", "total", "max",
                 "unit_scale")

    def __init__(self, name: str, vcell: list, unit_scale: int = 1) -> None:
        self.name = name
        self._v = vcell
        self.counts: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        # Sub-unit floor widening: values are bucketed at
        # value*unit_scale resolution and percentiles divide back, so
        # a `_us` histogram with unit_scale=16 resolves 1/16-µs steps
        # below 1 µs (sub-µs p50s stop collapsing into bucket 0).
        # count/sum/max stay in raw units.
        self.unit_scale = unit_scale

    # -- bucket arithmetic (static: the oracle test uses these too) ----

    @classmethod
    def bucket_of(cls, value) -> int:
        n = int(value)
        if n < cls.SUBS:
            return n if n > 0 else 0
        e = n.bit_length() - cls.SUB_BITS
        return ((e - 1) << (cls.SUB_BITS - 1)) + (n >> e) + (cls.SUBS >> 1)

    @classmethod
    def upper_of(cls, index: int) -> int:
        """Exclusive upper edge of bucket `index` (the percentile
        representative: every sample in the bucket is < this)."""
        if index < cls.SUBS:
            return index + 1
        half = cls.SUBS >> 1
        e = (index - cls.SUBS) // half + 1
        m = (index - cls.SUBS) % half + half
        return (m + 1) << e

    @classmethod
    def quantize(cls, value) -> int:
        """The bucket representative `value` falls into — what
        `percentile` returns when `value` is the rank sample."""
        return cls.upper_of(cls.bucket_of(value))

    # -- hot path ------------------------------------------------------

    def observe(self, value) -> None:
        idx = self.bucket_of(value * self.unit_scale)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value
        self._v[0] += 1

    def time(self) -> "_Timer":
        """Context manager: observe the elapsed µs of the with-block."""
        return _Timer(self)

    # -- extraction ----------------------------------------------------

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, exact at bucket resolution: the
        upper edge of the bucket holding sample #ceil(q*count),
        descaled back to raw units."""
        return percentile_of_counts(self.counts, q) / self.unit_scale


def percentile_of_counts(counts: dict, q: float) -> float:
    """Nearest-rank percentile over a raw bucket-count dict (the same
    arithmetic as Histogram.percentile).  Lets callers window a
    monotonic histogram: snapshot `dict(h.counts)` before a timed
    region, subtract after, and extract percentiles of just the
    window — histograms themselves are never reset."""
    total = sum(counts.values())
    if not total:
        return 0.0
    rank = min(total, max(1, math.ceil(q * total)))
    acc = 0
    for idx in sorted(counts):
        acc += counts[idx]
        if acc >= rank:
            return float(Histogram.upper_of(idx))
    raise AssertionError("bucket counts disagree with total")


def counts_delta(after: dict, before: dict) -> dict:
    """Bucket counts accumulated between two `dict(h.counts)` copies."""
    return {
        idx: n - before.get(idx, 0)
        for idx, n in after.items()
        if n - before.get(idx, 0) > 0
    }


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram) -> None:
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.perf_counter_ns() - self._t0) / 1e3)
        return False


class _NoopTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


class _NoopHistogram:
    """TB_METRICS=0 stand-in: a timed hot-path site costs one attribute
    check and a constant return — no clock read, no dict write."""

    __slots__ = ()
    name = "<noop>"
    count = 0
    total = 0.0
    max = 0.0
    counts: dict = {}
    unit_scale = 1

    def observe(self, value) -> None:
        pass

    def time(self) -> _NoopTimer:
        return _NOOP_TIMER

    def percentile(self, q: float) -> float:
        return 0.0


_NOOP_HIST = _NoopHistogram()


class Registry:
    """A component's named instruments + composition into one tree."""

    def __init__(self, enabled: bool | None = None) -> None:
        if enabled is None:
            from tigerbeetle_tpu_torch import envcheck

            enabled = envcheck.metrics_enabled() == 1
        self.enabled = enabled
        self._v = [0]
        self._items: dict[str, object] = {}
        self._pulls: dict[str, object] = {}
        self._children: list[tuple[str, Registry]] = []

    # -- handle creation (idempotent per name) -------------------------

    def _make(self, name: str, cls):
        item = self._items.get(name)
        if item is None:
            item = cls(name, self._v)
            self._items[name] = item
        assert isinstance(item, cls), (
            f"{name} already registered as {type(item).__name__}"
        )
        return item

    def counter(self, name: str) -> Counter:
        return self._make(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._make(name, Gauge)

    def histogram(self, name: str, unit_scale: int = 1):
        """Latency histogram — the no-op instance when TB_METRICS=0
        (its sites then skip the clock reads entirely).  `unit_scale`
        widens the sub-unit floor (see Histogram.unit_scale); every
        registration of a name must agree on it."""
        if not self.enabled:
            return _NOOP_HIST
        item = self._items.get(name)
        if item is None:
            item = Histogram(name, self._v, unit_scale)
            self._items[name] = item
        assert isinstance(item, Histogram), (
            f"{name} already registered as {type(item).__name__}"
        )
        assert item.unit_scale == unit_scale, (
            f"{name} registered with unit_scale {item.unit_scale}, "
            f"re-requested with {unit_scale}"
        )
        return item

    def gauge_fn(self, name: str, fn) -> None:
        """Pull gauge: `fn()` evaluated at snapshot time — for values
        owned elsewhere (storage fsync counts, queue depths)."""
        self._pulls[name] = fn

    def attach(self, prefix: str, child: "Registry") -> None:
        """Graft `child`'s instruments under `prefix.` in snapshots."""
        assert child is not self
        self._children.append((prefix, child))

    def scope(self, prefix: str) -> "Scope":
        """A view that prefixes every name — one shared store, so the
        owner's snapshot covers the scoped component's counters."""
        return Scope(self, prefix)

    # -- reads ---------------------------------------------------------

    def value(self, name: str):
        return self._items[name].value

    def version(self) -> int:
        """Total mutation count (self + attached children): bumps on
        every inc/set/observe, so `snapshot()['version']` equality
        means NOTHING changed — no hand-picked tuples."""
        return self._v[0] + sum(c.version() for _, c in self._children)

    def snapshot(self) -> dict:
        out: dict = {}
        self._collect(out, "")
        out["version"] = self.version()
        return out

    def _collect(self, out: dict, prefix: str) -> None:
        for name, item in self._items.items():
            if isinstance(item, Histogram):
                base = prefix + name
                out[base + ".count"] = item.count
                out[base + ".sum"] = round(item.total, 3)
                out[base + ".max"] = round(item.max, 3)
                out[base + ".p50"] = item.percentile(0.50)
                out[base + ".p99"] = item.percentile(0.99)
                out[base + ".p999"] = item.percentile(0.999)
            else:
                v = item.value
                out[prefix + name] = round(v, 6) if isinstance(v, float) else v
        for name, fn in self._pulls.items():
            out[prefix + name] = fn()
        for cprefix, child in self._children:
            child._collect(out, prefix + cprefix + ".")


class Scope:
    """Prefix view over a Registry (shared store + version cell)."""

    __slots__ = ("_reg", "_prefix")

    def __init__(self, registry: Registry, prefix: str) -> None:
        self._reg = registry
        self._prefix = prefix + "."

    @property
    def enabled(self) -> bool:
        return self._reg.enabled

    def counter(self, name: str) -> Counter:
        return self._reg.counter(self._prefix + name)

    def gauge(self, name: str) -> Gauge:
        return self._reg.gauge(self._prefix + name)

    def histogram(self, name: str, unit_scale: int = 1):
        return self._reg.histogram(self._prefix + name, unit_scale)

    def gauge_fn(self, name: str, fn) -> None:
        self._reg.gauge_fn(self._prefix + name, fn)

    def scope(self, prefix: str) -> "Scope":
        return Scope(self._reg, self._prefix + prefix)


def stat_property(key: str) -> property:
    """Compatibility shim for migrated `stat_*` attributes: reads and
    writes route to the registry handle in `self._stats[key]`, so
    existing `sm.stat_x += n` sites (and bench resets) keep working
    while the canonical value lives in the registry."""

    def fget(self):
        return self._stats[key].value

    def fset(self, value):
        self._stats[key].set(value)

    return property(fget, fset)
