"""Per-batch latency of a K1 batch with a synchronous result fetch,
against pipelined dispatch with one event a batch.

    python -m tigerbeetle_tpu_torch.experiments.lat_probe [--device D] [--quick]

Counterpart of the reference's experiments/lat_probe.py (the order-free
kernel's dispatch latency over the TPU link, which sized the device
engine's window).  On the card: K1 (tight format, 8190 events, a
2^20-row table) launched per batch and its ring row fetched to the host
before the next launch (``sync_fetch_ms``), against the same launches
back to back with one event recorded after each and only the last one
waited on (``pipelined_ms``); ``fetch_share`` is the fraction of a
synchronous batch the fetch and its wait add.
"""

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("sync_fetch_ms", "pipelined_ms", "fetch_share", "batches")


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev)
    batches = 16 if quick else 128

    def synchronous():
        k1()
        k1.ring_row(k1.k - 1).cpu()

    sync_ms = common.host_ms(dev, synchronous, batches)
    markers = []

    def pipelined():
        k1()
        markers.append(common.Marker(dev).record())

    pipe_ms = common.host_ms(dev, pipelined, batches)
    markers[-1].synchronize()
    return common.record("lat", dev, sync_fetch_ms=sync_ms, pipelined_ms=pipe_ms,
                         fetch_share=1.0 - pipe_ms / sync_ms if sync_ms else 0.0,
                         batches=batches)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
