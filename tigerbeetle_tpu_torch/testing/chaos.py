"""Deterministic device-link chaos injection.

This package's own copy of ``tigerbeetle_tpu/testing/chaos.py``.  The
device-authoritative engine funnels every host<->device crossing
through one seam (device_engine.DeviceLink: "h2d" uploads and stream
synchronisations, "dispatch" kernel launches, "fetch" d2h reads,
"probe" health checks).  ChaosLink interposes on that seam with a
SEEDED fault plan, so CPU-only tests can drive the whole degraded-mode
lifecycle — transient retry, fatal loss, demote, serve degraded,
re-promote + checksum handshake — with no card and byte-reproducible
schedules.  Every fault is raised before the crossing calls through, so
no kernel of a failed crossing runs (the engine's retry rule).

Fault kinds per crossing:
- transient: raises TransientLinkError once (a retry succeeds);
- fatal: raises FatalLinkError (classification skips the retry budget);
- down: every crossing fails fatally until heal()/auto-heal — a lost
  link;
- delay: sleeps a bounded jittered time first (pacing, not failure).
"""

from __future__ import annotations

import time

import numpy as np

from tigerbeetle_tpu_torch.state_machine.device_engine import (
    DeviceLink,
    FatalLinkError,
    TransientLinkError,
)

STAGES = ("h2d", "dispatch", "fetch", "probe")


class ChaosLink(DeviceLink):
    """Fault-injecting DeviceLink shim, seeded and deterministic.

    Probabilistic faults (per crossing, only on stages in `stages`):
    `p_transient`, `p_fatal`, `p_kill` (goes down for `down_for`
    crossings, then auto-heals), `p_delay`/`delay_s`.  Scripted faults:
    `fail_next(stage=..., kind=..., count=...)` queues exact faults for
    the next matching crossings, and `kill()`/`heal()` toggle hard
    loss — both for tests that target one pipeline stage precisely.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        p_transient: float = 0.0,
        p_fatal: float = 0.0,
        p_kill: float = 0.0,
        down_for: int = 4,
        p_delay: float = 0.0,
        delay_s: float = 0.0,
        stages: tuple[str, ...] = STAGES,
    ) -> None:
        self.rng = np.random.default_rng(seed)
        self.p_transient = p_transient
        self.p_fatal = p_fatal
        self.p_kill = p_kill
        self.down_for = down_for
        self.p_delay = p_delay
        self.delay_s = delay_s
        self.stages = tuple(stages)
        self.down = False
        self._down_left = 0  # crossings left before auto-heal (0: manual)
        self._scripted: list[tuple[str | None, str]] = []
        # Forensics the tests assert on.
        self.crossings = 0
        self.stat_transient = 0
        self.stat_fatal = 0
        self.stat_kills = 0
        self.stat_delays = 0

    # -- fault controls -------------------------------------------------

    def kill(self, *, down_for: int = 0) -> None:
        """Hard link loss; heals after `down_for` crossings (0: only an
        explicit heal() brings it back)."""
        self.down = True
        self._down_left = down_for
        self.stat_kills += 1

    def heal(self) -> None:
        self.down = False
        self._down_left = 0

    def fail_next(
        self,
        stage: str | None = None,
        kind: str = "fatal",
        count: int = 1,
    ) -> None:
        """Queue `count` scripted faults for the next crossings that
        match `stage` (None: any stage).  kind: "transient"/"fatal"."""
        assert kind in ("transient", "fatal"), kind
        assert stage is None or stage in STAGES, stage
        self._scripted.extend([(stage, kind)] * count)

    # -- injection core -------------------------------------------------

    def _raise(self, kind: str, stage: str, why: str) -> None:
        message = f"chaos: {why} ({stage} crossing {self.crossings})"
        if kind == "transient":
            self.stat_transient += 1
            raise TransientLinkError(message)
        self.stat_fatal += 1
        raise FatalLinkError(message)

    def _cross(self, stage: str) -> None:
        self.crossings += 1
        if self.down:
            if self._down_left:
                self._down_left -= 1
                if self._down_left == 0:
                    self.down = False
            self._raise("fatal", stage, "link down")
        for i, (want_stage, kind) in enumerate(self._scripted):
            if want_stage is None or want_stage == stage:
                del self._scripted[i]
                self._raise(kind, stage, f"scripted {kind}")
        if stage not in self.stages:
            return
        # One rng draw per armed fault class, in a FIXED order, so a
        # schedule replays identically for a given seed regardless of
        # which faults fire.
        if self.p_kill and self.rng.random() < self.p_kill:
            self.kill(down_for=self.down_for)
            self._raise("fatal", stage, "link down")
        if self.p_fatal and self.rng.random() < self.p_fatal:
            self._raise("fatal", stage, "injected fatal")
        if self.p_transient and self.rng.random() < self.p_transient:
            self._raise("transient", stage, "injected transient")
        if self.p_delay and self.rng.random() < self.p_delay:
            self.stat_delays += 1
            if self.delay_s > 0:
                time.sleep(self.delay_s * float(self.rng.random()))

    # -- DeviceLink surface ---------------------------------------------

    def device_put(self, array, device):
        self._cross("h2d")
        return super().device_put(array, device)

    def block_until_ready(self, device):
        self._cross("h2d")
        return super().block_until_ready(device)

    def fetch(self, tensor) -> np.ndarray:
        self._cross("fetch")
        return super().fetch(tensor)

    def dispatch(self, fn, *args):
        self._cross("dispatch")
        return super().dispatch(fn, *args)

    def probe(self, device) -> None:
        self._cross("probe")
        super().probe(device)


def device_chaos_factory(
    seed: int,
    *,
    account_capacity: int = 1 << 12,
    device=None,
    plain: bool = False,
    **chaos_kw,
):
    """-> (state_machine_factory, links) for a cluster harness.

    Each machine the factory builds (initial replicas, restarts,
    restart-replay copies) gets its own deterministically seeded
    ChaosLink, collected in `links` so a nemesis can kill/heal them
    mid-run.  Faults hit replicas at different times, yet the
    degraded-mode lifecycle keeps every reply bit-identical.  `device`:
    the machines' device (None: the first CUDA card; "cpu" in tests);
    `plain`: the kernels' plain versions on that device (a reference
    run)."""
    links: list[ChaosLink] = []

    def factory():
        from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine

        link = ChaosLink(seed=seed + 101 * len(links), **chaos_kw)
        links.append(link)
        return TorchStateMachine(
            engine="device", account_capacity=account_capacity, device=device,
            plain=plain, device_link=link,
        )

    return factory, links
