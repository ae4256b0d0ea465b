"""Validated environment-variable parsing (the knobs this port reads).

A bad value fails fast with an error naming the variable, the value
and the constraint — the same contract as the reference package's
``envcheck.py``.
"""

from __future__ import annotations

import contextlib
import os


class EnvVarError(ValueError):
    """An environment variable holds an unusable value."""


def _fail(name: str, raw: str, why: str):
    raise EnvVarError(f"{name}={raw!r} invalid: {why}")


def env_int(
    name: str,
    default: int,
    *,
    minimum: int | None = None,
    maximum: int | None = None,
) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        _fail(name, raw, "expected an integer")
    if minimum is not None and value < minimum:
        _fail(name, raw, f"must be >= {minimum}")
    if maximum is not None and value > maximum:
        _fail(name, raw, f"must be <= {maximum}")
    return value


def env_str(name: str, default: str | None = None) -> str | None:
    """String-valued knob; empty counts as unset."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw


def env_choice(name: str, default: str, choices: tuple[str, ...]) -> str:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if raw not in choices:
        _fail(name, raw, "expected one of " + "/".join(choices))
    return raw


def env_is_set(name: str) -> bool:
    """True when the variable is present and non-empty (toggles whose
    value is not read)."""
    return bool(os.environ.get(name))


@contextlib.contextmanager
def env_pinned(name: str, value: str):
    """Set the knob `name` to `value` for the body of a with-block,
    then restore its earlier value, or its absence.  For a process-edge
    entry point that runs one step under a setting (graft_entry.py's dry
    run); the readers below still validate what that step reads."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def fastpath_disabled() -> bool:
    """TB_FASTPATH_DISABLE: any non-empty value runs the host engine
    without its native library (runtime/fastpath.py): every host-path
    batch then takes the Python lanes (mirror admission, the numpy
    linked / two-phase resolvers, the exact path on the device).  Unset,
    the library is built at first use and a failed build raises."""
    return env_is_set("TB_FASTPATH_DISABLE")


def engine() -> str:
    """TB_ENGINE: the create_transfers execution authority, "host"
    (default: host resolvers compute the codes, the device table is a
    write-behind replica) or "device" (the device engine's kernels
    compute them)."""
    return env_choice("TB_ENGINE", "host", ("host", "device"))


def dev_b() -> int:
    """TB_DEV_B: the device batch bucket (events per kernel launch), a
    power of two <= 8192 (8190 is the wire batch maximum)."""
    b = env_int("TB_DEV_B", 8192, minimum=1, maximum=8192)
    if b & (b - 1) != 0:
        raise EnvVarError(f"TB_DEV_B={b} invalid: must be a power of 2 <= 8192")
    return b


def dev_window() -> int:
    """TB_DEV_WINDOW: batches per execution window (one ring fetch)."""
    return env_int("TB_DEV_WINDOW", 96, minimum=1)


def dev_ring() -> int:
    """TB_DEV_RING: rows of the device summary ring."""
    return env_int("TB_DEV_RING", 256, minimum=2)


def validate_window_ring(window: int, ring: int) -> None:
    if 2 * window > ring:
        raise EnvVarError(
            f"TB_DEV_WINDOW={window} / TB_DEV_RING={ring} invalid: the "
            "summary ring must hold two windows (2*TB_DEV_WINDOW <= "
            "TB_DEV_RING)"
        )


def state_commit() -> int:
    """TB_STATE_COMMIT: 1 (default) maintains the incremental state
    commitment on the host mirror and on the device; 0 disables it
    (roots are then computed from scratch on demand)."""
    return env_int("TB_STATE_COMMIT", 1, minimum=0, maximum=1)


def env_float(name: str, default: float, *, minimum: float | None = None) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = float(raw)
    except ValueError:
        _fail(name, raw, "expected a number")
    if minimum is not None and value < minimum:
        _fail(name, raw, f"must be >= {minimum}")
    return value


# ----------------------------------------------------------------------
# Device-link robustness (state_machine/device_engine.py): bounded retry
# with exponential backoff on every crossing, the health-probe cadence
# of re-promotion out of degraded mode, and the healthy-mode scrub
# cadence (0 disables the scrub).


def dev_retries() -> int:
    """TB_DEV_RETRIES: retries of a transiently failed crossing."""
    return env_int("TB_DEV_RETRIES", 3, minimum=0)


def dev_backoff_ms() -> float:
    """TB_DEV_BACKOFF_MS: the first retry's backoff (doubling)."""
    return env_float("TB_DEV_BACKOFF_MS", 5.0, minimum=0.0)


def dev_backoff_cap_ms() -> float:
    """TB_DEV_BACKOFF_CAP_MS: the longest backoff between retries."""
    return env_float("TB_DEV_BACKOFF_CAP_MS", 200.0, minimum=0.0)


def dev_probe_every() -> int:
    """TB_DEV_PROBE_EVERY: committed operations between re-promotion
    attempts (health probe + re-upload + handshake) while degraded."""
    return env_int("TB_DEV_PROBE_EVERY", 8, minimum=1)


def dev_scrub_every_set() -> bool:
    """Whether the operator set TB_DEV_SCRUB_EVERY explicitly."""
    return env_is_set("TB_DEV_SCRUB_EVERY")


def dev_scrub_every() -> int:
    """TB_DEV_SCRUB_EVERY: ring fetches between healthy-mode scrubs
    (default: TB_DEV_PROBE_EVERY, the cheap 16-byte digest compare; an
    engine without the commitment keeps the legacy 256 unless this is
    set); 0 disables the scrub."""
    return env_int("TB_DEV_SCRUB_EVERY", dev_probe_every(), minimum=0)


def dev_scrub_jitter() -> int:
    """TB_DEV_SCRUB_JITTER: the largest deterministic per-engine offset
    of the first scrub, so engines sharing a host do not scrub on the
    same fetch ordinal; -1 (default) = an eighth of the cadence."""
    return env_int("TB_DEV_SCRUB_JITTER", -1, minimum=-1)


def validate_scrub_jitter(every: int, jitter: int) -> None:
    if every and jitter >= every:
        raise EnvVarError(
            f"TB_DEV_SCRUB_JITTER={jitter} / TB_DEV_SCRUB_EVERY={every} "
            "invalid: the jitter offset must stay below the scrub "
            "cadence (TB_DEV_SCRUB_JITTER < TB_DEV_SCRUB_EVERY)"
        )


def scrub_jitter_cap(every: int, jitter: int) -> int:
    """Effective jitter bound: the explicit knob, or auto = every//8."""
    if jitter >= 0:
        return jitter
    return every // 8 if every else 0


def scrub_fallback_every() -> int:
    """TB_DEV_SCRUB_FALLBACK: run the full-fetch divergence localization
    every Nth healthy-mode scrub even when the cheap 16-byte digest
    compare matched (a deep scrub); 0 (default) = only on a mismatch."""
    return env_int("TB_DEV_SCRUB_FALLBACK", 0, minimum=0, maximum=1 << 20)


def waves_speculate() -> str:
    """TB_WAVES_SPECULATE: speculative execution mode of the device
    wave dispatcher (gpu._try_submit_device_waves): "auto" (default)
    and "1" run an off-kernel window batch as ONE speculative wave
    step validated on the device and replay only the conflicted
    residue, unless more than TB_WAVES_SPEC_RESIDUE_CAP of the batch
    is already known to need the replay; "0" plans waves up front;
    "force" routes every window batch through speculation, whatever
    the residue gate says."""
    return env_choice("TB_WAVES_SPECULATE", "auto", ("auto", "0", "1", "force"))


def spec_residue_cap() -> float:
    """TB_WAVES_SPEC_RESIDUE_CAP: the fraction of a batch that may be
    known host-side to need residue replay (chain members, history
    events, serialized post/voids) before speculation is skipped.  A
    fraction, so it must be <= 1: a larger value could never bind."""
    value = env_float("TB_WAVES_SPEC_RESIDUE_CAP", 0.25, minimum=0.0)
    if value > 1.0:
        _fail(
            "TB_WAVES_SPEC_RESIDUE_CAP", str(value),
            "must be <= 1 — the cap is a fraction of the batch and a "
            "larger value can never bind",
        )
    return value


def hot_capacity() -> int:
    """TB_HOT_CAPACITY: device-resident hot-set rows of the tiered
    account table (state_machine/hot_tier.py).  0 (default) keeps the
    whole logical table on the card.  A value below the logical
    capacity caps the device tables at that many rows: each batch's
    cold rows are admitted from the host mirror (the cold tier) before
    its device step, and the state root keeps covering the whole
    logical table as fold(hot_partial, cold_partial).  Values >= the
    logical capacity leave the table all-resident.  Read when an engine
    is constructed."""
    return env_int("TB_HOT_CAPACITY", 0, minimum=0, maximum=1 << 31)


def ckpt_verify() -> bool:
    """TB_CKPT_VERIFY=1: the host engine's checkpoint snapshot runs the
    device/mirror tripwire too (the device engine always does)."""
    return env_str("TB_CKPT_VERIFY") == "1"


# ----------------------------------------------------------------------
# The durable replica (vsr/replica.py) and its observability (obs/).


def ckpt_async() -> int:
    """TB_CKPT_ASYNC: 1 (default) runs the checkpoint's disk half
    (grid writeback join, fdatasync, superblock flip) on a background
    worker; 0 keeps the whole checkpoint on the commit path."""
    return env_int("TB_CKPT_ASYNC", 1, minimum=0, maximum=1)


def metrics_enabled() -> int:
    """TB_METRICS: 1 (default) records latency histograms in the obs
    registry; 0 skips the clock reads (counters stay live: logic and
    accounting depend on them)."""
    return env_int("TB_METRICS", 1, minimum=0, maximum=1)


def trace_exemplars() -> int:
    """TB_TRACE_EXEMPLARS: tail-exemplar ring size (obs/anatomy.py):
    how many slow-request stage timelines each replica retains.  Must
    be > 0 (the recorder is disabled through TB_METRICS=0, not by an
    empty ring)."""
    return env_int("TB_TRACE_EXEMPLARS", 32, minimum=1, maximum=1 << 16)


# ----------------------------------------------------------------------
# Consensus, server, client and tenant QoS (vsr/multi.py, runtime/,
# client.py, qos.py).


def group_commit_max_us() -> int:
    """TB_GROUP_COMMIT_MAX_US: longest a replicated ack may wait for
    its covering WAL fdatasync, in microseconds.  0 disables group
    commit (one fsync per prepare)."""
    return env_int(
        "TB_GROUP_COMMIT_MAX_US", 2000, minimum=0, maximum=10_000_000
    )


def native_sanitize() -> str:
    """TB_NATIVE_SANITIZE: native-library build flavor.  "" (default)
    loads the plain optimized libraries; "asan" loads the
    address+undefined-sanitized builds from build/native/asan/ (built by
    kernels/host_build.py) — the slow-tier replay test drives the
    fastpath fixture differential and torn-frame fuzz through them
    with the asan runtime LD_PRELOADed.  The flavor is recorded in the
    build-failure forensics (kernels/host_build.py), so a failing
    sanitizer build is never mistaken for a failing release build."""
    return env_choice("TB_NATIVE_SANITIZE", "", ("", "asan"))


def fastpath_decode() -> int:
    """TB_FASTPATH_DECODE: 1 (default) drains the server bus through
    the columnar ingest fast path — one arena drain + one batch
    checksum-verify pass per poll (native tb_fp_verify_frames, or the
    vectorized Python fallback), headers gathered in one vectorized
    pass, replies coalesced per drain.  0 forces the legacy per-message
    decode path end to end, for differential runs (replies must stay
    bit-identical either way)."""
    return env_int("TB_FASTPATH_DECODE", 1, minimum=0, maximum=1)


def native_pipeline() -> int:
    """TB_NATIVE_PIPELINE: 1 (default) runs the per-prepare hot loop
    through csrc/host/tb_pipeline.cpp — prepare/prepare_ok header
    construction + checksum stamping, journal append framing (sector
    padding, redundant-ring sector build), the primary's in-flight
    slot table, and the group-commit gate — falling back to Python
    when libtb_fastpath is unavailable.  0 forces the pure-Python
    per-prepare path for differential runs: reply frames, WAL bytes,
    and commit decisions must be bit-identical either way (the
    TB_FASTPATH_DECODE contract one layer higher).  The library is
    built from the package's own sources; a failed build raises."""
    return env_int("TB_NATIVE_PIPELINE", 1, minimum=0, maximum=1)


def native_drain() -> int:
    """TB_NATIVE_DRAIN: 1 (default) runs a whole poll drain's
    prepare→ack→commit-decision work through ONE native call per
    batch seam (csrc/host/tb_pipeline.cpp tb_pl_build_prepares /
    tb_pl_accept_prepares / tb_pl_on_acks / tb_pl_commit_ready_run,
    ABI 3) — Python demoted to a per-BATCH orchestrator.  Requires
    the native pipeline (TB_NATIVE_PIPELINE=1); falls back to the
    per-item loop otherwise.  0 pins the per-item Python loop over the
    SAME batch seams for differential runs: consensus and reply frames
    must be bit-identical either way (the TB_NATIVE_PIPELINE contract
    extended from per-call to per-drain)."""
    return env_int("TB_NATIVE_DRAIN", 1, minimum=0, maximum=1)


def hash_reuse() -> int:
    """TB_HASH_REUSE: 1 (default) makes the commit path hash each
    prepare body at most ONCE per replica role — the ingress verify
    pass already proved SHA-256(body), so the build seams
    (tb_pl_build_prepares and the Python mirror in _primary_prepare /
    finalize_header) consume that digest (the drain-scoped C digest
    table, falling back to the verified request header's own
    checksum_body field) instead of rehashing.  0 rehashes everywhere
    for differential runs: every consensus/reply frame must be
    bit-identical either way, only hash.bytes_hashed may differ."""
    return env_int("TB_HASH_REUSE", 1, minimum=0, maximum=1)


def hash_threads() -> int:
    """TB_HASH_THREADS: native hash-pool worker lanes that fan a
    drain's independent SHA-256 jobs (frame verifies, body digests,
    reply finalizes) out of the drain thread, inside the existing
    GIL-released crossings.  0 (default) runs every hash inline on the calling thread; the named
    constraint is threads <= 16 (lanes beyond the physical cores of
    any target box only add contention on the submit path)."""
    value = env_int("TB_HASH_THREADS", 0, minimum=0)
    if value > 16:
        _fail(
            "TB_HASH_THREADS", str(value),
            "must be <= 16 — hash lanes beyond any target box's "
            "cores only add submit-path contention",
        )
    return value


def cpu_affinity() -> str:
    """TB_CPU_AFFINITY: replica/router/follower core pinning for the
    multi-process spawn paths (the server CLI):

    - "none" (default): inherit the parent's affinity mask unchanged.
    - "auto": pin process slot i to core (i mod cpu_count) — spreads a
      cluster's replicas across cores so their Python VSR loops stop
      serializing on a shared core.
    - "0,1,2": explicit core list; slot i takes the (i mod len)'th
      core of the list.

    Validated here so a typo fails at spawn, not as a bare OSError
    inside sched_setaffinity; runtime/affinity.py applies it."""
    raw = env_str("TB_CPU_AFFINITY", "none")
    if raw in ("none", "auto"):
        return raw
    parts = raw.split(",")
    try:
        cores = [int(p) for p in parts]
    except ValueError:
        _fail("TB_CPU_AFFINITY", raw,
              'expected "none", "auto", or a comma-separated core '
              'list like "0,1,2"')
    if not cores or any(c < 0 for c in cores):
        _fail("TB_CPU_AFFINITY", raw, "core ids must be >= 0")
    return raw


def drain_batch_max() -> int:
    """TB_DRAIN_BATCH: cap on events pulled per columnar drain call —
    bounds the arena scan and the latency of one decode pass under a
    flood (excess events stay queued in the native bus and drain on
    the next zero-timeout round).  Must cover at least one pipeline's
    worth of messages or the drain loop degenerates to per-message
    rounds."""
    value = env_int("TB_DRAIN_BATCH", 4096, maximum=1 << 16)
    if value < 16:
        _fail(
            "TB_DRAIN_BATCH", str(value),
            "must be >= 16 — smaller drain batches degenerate the "
            "columnar decode into per-message rounds",
        )
    return value


def trace_backend() -> str:
    """TB_TRACE: span-tracer backend (utils/tracer.py) for processes
    that don't pass an explicit --trace path.  `json` writes a Chrome
    -trace file per process (TB_TRACE_PATH or tb_trace_r<i>.json)."""
    return env_choice("TB_TRACE", "none", ("none", "json"))


def flight_ring() -> int:
    """TB_FLIGHT_RING: flight-recorder ring capacity (obs/flight.py) —
    recent trace events kept in memory per replica for the postmortem
    dump.  Must be > 0."""
    return env_int("TB_FLIGHT_RING", 4096, minimum=1, maximum=1 << 22)


def root_ring() -> int:
    """TB_ROOT_RING: how many recent commits' state roots a replica
    retains for the `state_root` at-op query (the follower attestation
    primitive; 16 bytes + dict entry per op).  0 disables — at-op
    queries then answer the current root and followers can only attest
    when exactly caught up."""
    return env_int("TB_ROOT_RING", 4096, minimum=0, maximum=1 << 20)


def read_policy() -> str:
    """TB_READ_POLICY: where the router steers read operations
    (lookup/filter queries):

    - "primary" pins the legacy path end to end — every read rides
      consensus exactly as before followers existed.
    - "follower" prefers a configured follower whenever the read is
      follower-servable (single-shard), falling back to the primary on
      refusal/timeout.
    - "auto" (default): like "follower" when followers are configured,
      "primary" otherwise.
    """
    return env_choice(
        "TB_READ_POLICY", "auto", ("auto", "primary", "follower")
    )


def read_staleness_ops() -> int:
    """TB_READ_STALENESS_OPS: bounded-staleness policy — the most ops
    a serving follower may lag the primary's attested commit point
    before it refuses reads with a typed `lagging` busy (clients /
    the router then redirect to the primary).  0 = the follower only
    serves when fully caught up to the last attestation."""
    return env_int("TB_READ_STALENESS_OPS", 512, minimum=0,
                   maximum=1 << 30)


def follower_attest_ms() -> int:
    """TB_FOLLOWER_ATTEST_MS: cadence of the follower's attestation
    query (state_root at-op against the upstream replica).  Lower =
    fresher lag estimate + tighter divergence detection window, more
    query traffic."""
    return env_int("TB_FOLLOWER_ATTEST_MS", 100, minimum=1,
                   maximum=60_000)


def follower_attest_max_ms() -> int:
    """TB_FOLLOWER_ATTEST_MAX_MS: maximum age of the last successful
    attestation before a follower refuses reads as `lagging`.  The
    lag estimate (last_primary_op) is a high-water mark fed by
    attestation replies — under a FULL partition (upstream AND log
    unreachable) nothing moves it, so without an age bound a follower
    that attested once would serve frozen state forever while
    claiming lag 0.  Must exceed the attestation cadence
    (TB_FOLLOWER_ATTEST_MS) with room for a few lost replies; the
    default (2000 ms) is 20 cadences of the default 100 ms."""
    return env_int("TB_FOLLOWER_ATTEST_MAX_MS", 2000, minimum=1,
                   maximum=24 * 3600 * 1000)


def follower_ring() -> int:
    """TB_FOLLOWER_ROOT_RING: per-op state roots the FOLLOWER retains
    while replaying, for verifying primary attestations that answer a
    few ops behind its replay head.  Named constraint: must be >= 16 —
    a ring smaller than one attestation round trip's worth of commits
    discards the root every verification needs and the follower can
    never attest under write load."""
    return env_int("TB_FOLLOWER_ROOT_RING", 4096, minimum=16,
                   maximum=1 << 20)


def read_fallback_ms() -> int:
    """TB_READ_FALLBACK_MS: how long the router waits for a follower's
    read reply before re-driving the read through the primary path.
    Bounds the worst case a dead follower can add to one read; the
    per-follower backoff (qos.backoff_delay) keeps later reads from
    re-paying it every time."""
    return env_int("TB_READ_FALLBACK_MS", 250, minimum=10,
                   maximum=60_000)


def busy_backoff_ms() -> float:
    """TB_BUSY_BACKOFF_MS: client-side base backoff after a typed
    client_busy — capped exponential (x2 per consecutive busy, 16x
    cap) plus deterministic seeded jitter, so shed storms don't
    self-amplify into retransmit storms.  0 disables (the legacy
    immediate-retransmit-cadence behavior)."""
    return env_float("TB_BUSY_BACKOFF_MS", 20.0, minimum=0.0)


def admit_queue(pipeline_depth: int) -> int:
    """TB_ADMIT_QUEUE: bound on the primary's client-request queue
    (runtime/server.py admission control).  Requests beyond it are
    shed with a typed Command.client_busy instead of growing the tail
    unboundedly.  Must be >= the prepare pipeline depth — a smaller
    bound would shed requests the pipeline could already hold."""
    value = env_int("TB_ADMIT_QUEUE", 1024, minimum=1)
    if value < pipeline_depth:
        _fail(
            "TB_ADMIT_QUEUE", str(value),
            f"must be >= pipeline depth ({pipeline_depth}) — a smaller "
            "queue sheds requests the prepare pipeline could hold",
        )
    return value


def tenant_qos() -> int:
    """TB_TENANT_QOS: 1 (default) keys admission, scheduling, and
    shedding by tenant (ledger) — per-tenant token buckets, bounded
    per-tenant queues, weighted-fair drain, typed busy payloads.
    0 pins today's single-queue path exactly (bit-identical
    differential runs)."""
    return env_int("TB_TENANT_QOS", 1, minimum=0, maximum=1)


def tenant_queue(admit_queue: int) -> int:
    """TB_TENANT_QUEUE: bound on one tenant's queued requests.  0
    (default) = the global TB_ADMIT_QUEUE bound (no extra per-tenant
    bound).  Must not exceed the global bound — a per-tenant bound
    above it could never bind and would silently misrepresent the
    isolation the operator configured."""
    value = env_int("TB_TENANT_QUEUE", 0, minimum=0)
    if value > admit_queue:
        _fail(
            "TB_TENANT_QUEUE", str(value),
            f"must be <= TB_ADMIT_QUEUE ({admit_queue}) — a per-tenant "
            "bound above the global queue bound can never bind",
        )
    return value if value else admit_queue


def tenant_rate() -> float:
    """TB_TENANT_RATE: per-tenant admission rate, requests/second
    (token bucket, burst = one second's worth).  0 (default) disables
    rate limiting — QoS-on under non-overload stays bit-identical to
    QoS-off; the queue bounds still apply."""
    return env_float("TB_TENANT_RATE", 0.0, minimum=0.0)


def tenant_rate_bytes() -> float:
    """TB_TENANT_RATE_BYTES: per-tenant admission rate in BODY BYTES
    per second (a second token bucket next to the request-count one).
    Mixed-size batches cheat a request-count bucket — one tenant's
    8k-event batches cost the same token as another's single event —
    so overload protection for byte-bound resources (decode, WAL
    bandwidth, follower replay) charges by size.  0 (default)
    disables; both buckets must admit when both are configured."""
    return env_float("TB_TENANT_RATE_BYTES", 0.0, minimum=0.0)


def tenant_weights() -> dict:
    """TB_TENANT_WEIGHTS: weighted-fair drain shares, e.g. "1:4,7:2"
    (ledger:weight; unlisted tenants weigh 1)."""
    from tigerbeetle_tpu_torch import qos

    raw = env_str("TB_TENANT_WEIGHTS", "")
    try:
        return qos.parse_weights(raw)
    except ValueError as exc:
        _fail("TB_TENANT_WEIGHTS", raw, str(exc))


# ----------------------------------------------------------------------
# Sharded multi-cluster (runtime/router.py).


def router_queue() -> int:
    """TB_ROUTER_QUEUE: bound on concurrently open client requests in
    the router; fresh requests beyond it are shed with a typed
    Command.client_busy (the same admission contract the replicas
    use)."""
    return env_int("TB_ROUTER_QUEUE", 256, minimum=1)


def coord_retry_ms() -> int:
    """TB_COORD_RETRY_MS: coordinator sub-operation retry cadence —
    how long the router waits for a shard's reply to a 2PC leg before
    re-issuing it (idempotent: derived ids dedupe re-drives)."""
    return env_int("TB_COORD_RETRY_MS", 1000, minimum=10,
                   maximum=60_000)


def view_change_budget_s() -> float:
    """Worst-case time for one shard to elect a new primary: the
    backup's view-change timeout in wall-clock terms (vsr/multi.py
    VIEW_CHANGE_TICKS at the shared TICK_NS cadence)."""
    from tigerbeetle_tpu_torch.constants import TICK_NS
    from tigerbeetle_tpu_torch.vsr.multi import VIEW_CHANGE_TICKS

    return VIEW_CHANGE_TICKS * TICK_NS / 1e9


def coord_timeout_s() -> int:
    """TB_COORD_TIMEOUT_S: cross-shard hold timeout (seconds) — the
    pending-transfer timeout stamped on both 2PC holds, bounding how
    long an orphaned hold (coordinator lost before its decision) can
    reserve balances before the shard's own expiry pulse voids it.

    Named constraint: must EXCEED a shard's view-change budget.  The
    commit decision is durable the moment the debit-side hold posts;
    the credit-side post may then have to wait out a full primary
    failover on the credit shard, and a hold that can expire inside
    that window would turn a decided commit into a half-applied
    transfer (the compensation path — flagged, never silent — exists
    for exactly the case this constraint rules out)."""
    value = env_int("TB_COORD_TIMEOUT_S", 30, minimum=1,
                    maximum=24 * 3600)
    budget = view_change_budget_s()
    if value <= budget:
        _fail(
            "TB_COORD_TIMEOUT_S", str(value),
            f"must exceed the view-change budget ({budget:g}s) — a "
            "decided cross-shard commit must survive one primary "
            "failover on the credit shard without its hold expiring",
        )
    return value
