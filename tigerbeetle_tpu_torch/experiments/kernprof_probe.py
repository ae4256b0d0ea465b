"""Kernel compute alone, pipelined, and a host-to-device copy while the
card is busy.

    python -m tigerbeetle_tpu_torch.experiments.kernprof_probe [--device D] [--quick]

Counterpart of the reference's experiments/kernprof_probe.py (the
kernel's own time with device-resident inputs, 1.6-2 ms pipelined on the
TPU; an h2d while busy ~26 ms).  ``k1_device_us``: K1 back to back on
resident batches, device µs a launch; ``h2d_idle_ms``: a pageable
upload of one batch on an idle card, host ms; ``h2d_busy_ms``: the same
upload issued right after 32 K1 launches were queued, host ms until it
returns, beside ``queued_ms``, the queued launches' own device time (an
upload that waited for the queue would take about that long).
"""

from __future__ import annotations

import sys
import time

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("k1_device_us", "h2d_idle_ms", "h2d_busy_ms", "queued_ms")
QUEUED = 32


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev)
    reps = 20 if quick else 200
    k1_us = common.device_ms(dev, k1, reps) * 1e3
    idle = common.host_ms(dev, lambda: common.upload(k1.host[0], dev), 5 if quick else 20)
    busy = []
    for _ in range(3 if quick else 10):
        common.sync(dev)
        for _ in range(QUEUED):
            k1()
        t0 = time.perf_counter()
        common.upload(k1.host[1], dev)
        busy.append((time.perf_counter() - t0) * 1e3)
    common.sync(dev)
    return common.record("kernprof", dev, k1_device_us=k1_us, h2d_idle_ms=idle,
                         h2d_busy_ms=min(busy), queued_ms=QUEUED * k1_us / 1e3)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
