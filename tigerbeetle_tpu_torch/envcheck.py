"""Validated environment-variable parsing (the knobs this port reads).

A bad value fails fast with an error naming the variable, the value
and the constraint — the same contract as the reference package's
``envcheck.py``.
"""

from __future__ import annotations

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
