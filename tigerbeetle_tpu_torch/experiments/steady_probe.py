"""A fresh host-to-device copy each batch plus a chained kernel, by
fetch window.

    python -m tigerbeetle_tpu_torch.experiments.steady_probe [--device D] [--quick]

Counterpart of the reference's experiments/steady_probe.py (fresh h2d
per batch, rolling result fetch W batches behind).  Each batch uploads
its own 8190-event batch from pageable host memory (as the device
engine's records do), launches K1 on the resident table (each batch
chained on the last's table), and every W batches the host fetches the
W ring rows written since: ms a batch and events/s by W.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("by_window", "events_per_s")
WINDOWS = (1, 4, 16, common.ENGINE_R)


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev)
    by_w, rates = {}, {}
    for W in WINDOWS:
        batches = max(W, 16 if quick else 192)
        window = torch.arange(W, device=dev)

        def batch():
            g = k1.k % k1.host.shape[0]
            k1(common.upload(k1.host[g], dev))
            if k1.k % W == 0:
                rows = (window + (k1.k - W)) % common.RING_ROWS
                k1.ring.index_select(0, rows).cpu()

        ms = common.host_ms(dev, batch, batches, warm=W)
        by_w[str(W)] = ms
        rates[str(W)] = common.N / (ms * 1e-3) if ms > 0 else None
    return common.record("steady", dev, by_window=by_w, events_per_s=rates)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
