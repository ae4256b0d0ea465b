"""Replica core pinning (TB_CPU_AFFINITY).

This package's own copy of ``tigerbeetle_tpu/runtime/affinity.py``.

Multi-process configs (replicated bench, sharded clusters, the
server/router/follower CLIs) used to leave every Python VSR loop on
the scheduler's default mask — on a small box three replicas fight
over the same cores and the consensus pipeline serializes.  This
module turns the validated TB_CPU_AFFINITY knob (envcheck.py) into
actual ``os.sched_setaffinity`` calls, keyed by a process SLOT (the
replica index, the shard*replicas+replica index, or 0 for routers):

- "none"  -> no pinning (inherit the parent mask).
- "auto"  -> slot i pins to core (i mod cpu_count).
- "0,1,2" -> slot i pins to the (i mod len)'th listed core.

``plan`` is pure (the bench calls it to RECORD ``pinned_cores`` per
subprocess without being the subprocess); ``apply`` performs the
pinning in the target process and degrades to None on platforms
without sched_setaffinity rather than failing the spawn.
"""

from __future__ import annotations

import os

from tigerbeetle_tpu_torch import envcheck


def plan(slot: int, spec: str | None = None) -> tuple[int, ...] | None:
    """The core set slot `slot` would pin to under `spec` (default:
    the TB_CPU_AFFINITY environment), or None for no pinning."""
    if spec is None:
        spec = envcheck.cpu_affinity()
    if spec == "none":
        return None
    if spec == "auto":
        count = os.cpu_count() or 1
        return (slot % count,)
    cores = [int(p) for p in spec.split(",")]
    return (cores[slot % len(cores)],)


def apply(slot: int = 0, spec: str | None = None) -> tuple[int, ...] | None:
    """Pin the CURRENT process per plan(slot, spec).  Returns the
    pinned core set, or None when pinning is off / unsupported / the
    planned core does not exist on this box (a 4-core list on a
    2-core host must not kill the replica — it just runs
    unpinned and the bench's pinned_cores record says so)."""
    cores = plan(slot, spec)
    if cores is None:
        return None
    if not hasattr(os, "sched_setaffinity"):
        return None
    try:
        os.sched_setaffinity(0, cores)
    except OSError:
        return None
    return cores
