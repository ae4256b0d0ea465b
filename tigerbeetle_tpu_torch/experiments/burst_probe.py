"""R launches, then one ring fetch.

    python -m tigerbeetle_tpu_torch.experiments.burst_probe [--device D] [--quick]

Counterpart of the reference's experiments/burst_probe.py (R
dispatches with no downlink traffic, then one ring fetch: best 14 ms a
batch over the TPU link).  K1 batches (tight, 8190 events, resident
inputs) R at a time, then one fetch of the R ring rows they wrote: ms a
batch and events/s by R, R up to the engine's 96.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("by_R", "events_per_s")
BURSTS = (1, 8, 32, common.ENGINE_R)


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev)
    by_r, rates = {}, {}
    for R in BURSTS:
        window = torch.arange(R, device=dev)

        def burst():
            for _ in range(R):
                k1()
            k1.ring.index_select(0, (window + (k1.k - R)) % common.RING_ROWS).cpu()

        ms = common.host_ms(dev, burst, 1 if quick else 4) / R
        by_r[str(R)] = ms
        rates[str(R)] = common.N / (ms * 1e-3) if ms > 0 else None
    return common.record("burst", dev, by_R=by_r, events_per_s=rates)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
