"""``Event.synchronize`` after a trivial operation, against after K1.

    python -m tigerbeetle_tpu_torch.experiments.notify_probe [--device D] [--quick]

Counterpart of the reference's experiments/notify_probe.py (whether the
link's completion notice costs a fixed round trip or scales with the
work).  On an idle card: the host µs of launch + record + synchronize
for a one-element add (``trivial_sync_us``) and for one K1 batch
(``k1_sync_us``), and K1's own device µs between events
(``k1_device_us``): the notice's cost is the sync's excess over the
device time.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("trivial_sync_us", "k1_sync_us", "k1_device_us", "notice_us")


def sync_us(dev, fn, reps: int) -> float:
    """Median host µs of fn(); record; synchronize, from an idle card."""
    out = []
    for _ in range(reps + 1):
        common.sync(dev)
        t0 = time.perf_counter()
        fn()
        common.Marker(dev).record().synchronize()
        out.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(out[1:]))


def run(dev, quick: bool = False) -> dict:
    reps = 20 if quick else 200
    x = torch.zeros(1, dtype=torch.int64, device=dev)
    k1 = common.K1Batch(dev)
    trivial = sync_us(dev, lambda: x.add_(1), reps)
    k1_sync = sync_us(dev, k1, reps)
    k1_dev = common.device_ms(dev, k1, reps) * 1e3
    return common.record("notify", dev, trivial_sync_us=trivial, k1_sync_us=k1_sync,
                         k1_device_us=k1_dev, notice_us=k1_sync - k1_dev)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
