"""Observability spine: typed metrics registry and request anatomy.

This package's own copy of ``tigerbeetle_tpu/obs/__init__.py``.

One `Registry` per component (replica, state machine, device engine),
composed into a single tree by the owning process (ReplicaServer) and
rendered three ways from the SAME counters:

- `TB_STATS` log lines (runtime/server.py _print_stats),
- the `stats` wire operation (scrapeable over the TCP bus, obs.scrape),
- bench JSON sections (bench.py reads the scrape, not log tails).

Knobs (validated in envcheck.py):

- ``TB_METRICS=0|1`` — 1 (default) records latency histograms; 0 skips
  the clock reads (counters stay live: logic and bench depend on them).
- ``TB_TRACE=none|json`` — promotes the utils/tracer.py span tracer to
  a first-class backend choice; ``json`` writes a Chrome-trace file per
  process (``TB_TRACE_PATH`` or ``tb_trace_r<i>.json``).
"""

from tigerbeetle_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    counts_delta,
    percentile_of_counts,
    stat_property,
)
