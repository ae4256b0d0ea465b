"""Seeded simulator runs under pinned trace timestamps, and what they
are compared by: shared by `chip_smoke.py` and the card tests.

A request's trace_ts is the client's monotonic clock (observability
only). Pinned to (client, request), two runs of one seed frame
byte-equal prepares, so their HashLog digests can be compared.
"""

from __future__ import annotations

import contextlib
import time

# tests/test_follower.py's pinned FollowerVopr seeds that end serving,
# with what each one must have run into.
FOLLOWER_VOPR_CASES = (
    (0, {"upstream_crashes": 1, "corruptions": 1}),
    (2, {"follower_crashes": 6}),
)
# FollowerVopr's coverage and read counters.
FOLLOWER_VOPR_COUNTERS = (
    "follower_crashes", "upstream_crashes", "fsync_crashes", "corruptions", "partitions",
    "pauses", "reads_attempted", "reads_served", "reads_fallback",
)

# tests/test_vopr_sharded.py's no-nemesis and coordinator-kill cases.
SHARDED_VOPR_CASES = (
    (11, dict(requests=25, coordinator_kill_probability=0.0)),
    (23, dict(requests=30, coordinator_kill_probability=0.02)),
)


@contextlib.contextmanager
def pinned_trace_ts():
    """Inside, SimClient and RoutedClient requests read
    `time.perf_counter_ns` as (client id << 32) | (request number + 1)."""
    from tigerbeetle_tpu_torch.testing import cluster as cl

    requests = {kind: kind.request for kind in (cl.SimClient, cl.RoutedClient)}

    def pinning(request):
        def pinned(self, *args, **kwargs):
            real = time.perf_counter_ns
            time.perf_counter_ns = lambda: (self.id << 32) | (self.request_number + 1)
            try:
                return request(self, *args, **kwargs)
            finally:
                time.perf_counter_ns = real

        return pinned

    for kind, request in requests.items():
        kind.request = pinning(request)
    try:
        yield
    finally:
        for kind, request in requests.items():
            kind.request = request


def sharded_vopr_run(seed: int, params: dict, factory=None):
    """ShardedVopr(seed), 2 shards x 2 replicas, with
    tests/test_vopr_sharded.py's nemesis settings and `params`, every
    shard replica built by `factory` (None: the oracle), under pinned
    trace timestamps.  The machines get into the copy as its device-loss
    nemesis gets its own: through ShardedCluster's
    state_machine_factories.  -> (the ShardedVopr, its observations:
    every routed client's replies and each shard's HashLog digests,
    roots and commit points)."""
    from tigerbeetle_tpu_torch.testing import vopr

    sharded_cluster = vopr.ShardedCluster

    def with_factories(n_shards, **kwargs):
        if factory is not None:
            kwargs["state_machine_factories"] = [factory] * n_shards
        return sharded_cluster(n_shards, **kwargs)

    vopr.ShardedCluster = with_factories
    try:
        with pinned_trace_ts():
            v = vopr.ShardedVopr(seed, n_shards=2, replica_count=2, packet_loss=0.0,
                                 crash_probability=0.0, fsync_crash_probability=0.0,
                                 partition_probability=0.0, **params)
            v.run()
    finally:
        vopr.ShardedCluster = sharded_cluster
    c = v.cluster
    return v, {
        "replies": [(cl.id, list(cl.replies)) for cl in c.clients],
        "hash_logs": [[sorted(h._digests.items()) for h in s.hash_logs] for s in c.shards],
        "roots": [[r.sm.state_root() for r in s.replicas] for s in c.shards],
        "commit_min": [[r.commit_min for r in s.replicas] for s in c.shards],
    }


def follower_vopr_run(seed: int, factory=None):
    """FollowerVopr(seed) at its defaults (a 2-replica cluster, replica
    0's AOF tailed by a SimFollower that replays on the oracle), every
    upstream replica built by `factory` (None: the oracle), under pinned
    trace timestamps.  -> (the FollowerVopr, its observations: the
    counters, what the follower served and refused, its commit point and
    registry, and each replica's HashLog digests, root and commit
    point)."""
    from tigerbeetle_tpu_torch.testing import vopr

    cluster = vopr.Cluster

    def with_factory(**kwargs):
        if factory is not None:
            kwargs["state_machine_factory"] = factory
        return cluster(**kwargs)

    vopr.Cluster = with_factory
    try:
        with pinned_trace_ts():
            v = vopr.FollowerVopr(seed)
            v.run()
    finally:
        vopr.Cluster = cluster
    c, f = v.cluster, v.follower
    return v, {
        "counters": {k: getattr(v, k) for k in FOLLOWER_VOPR_COUNTERS},
        "served": list(f.served),
        "refusals": list(f.refusals),
        "follower": (f.core.commit_min, f.core.attested_op, f.core.poisoned,
                     sorted(f.core.registry.snapshot().items())),
        "hash_logs": [sorted(h._digests.items()) for h in c.hash_logs],
        "roots": [r.sm.state_root() for r in c.replicas],
        "commit_min": [r.commit_min for r in c.replicas],
    }
