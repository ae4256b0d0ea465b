"""The chained kernel plus a host-to-device copy, with no fetch against
with a device-to-host copy each batch: does a d2h hold up the stream?

    python -m tigerbeetle_tpu_torch.experiments.variant_probe [--device D] [--quick]

Counterpart of the reference's experiments/variant_probe.py (on the TPU
link any d2h fetch took a chained+h2d loop from ~1 ms to 200-300 ms a
batch).  Each batch uploads its batch (pageable) and launches K1 on the
resident table; the arms add nothing (``no_fetch_ms``), a blocking
fetch of its ring row (``fetch_ms``), or a non-blocking copy of it into
pinned memory that the host never waits on until the end
(``async_fetch_ms``): ms a batch; ``fetch_cost_ms`` is the blocking
arm's excess.
"""

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("no_fetch_ms", "fetch_ms", "async_fetch_ms", "fetch_cost_ms")


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev)
    batches = 16 if quick else 128
    pinned = common.host_buffer(k1.ring.shape[1] * 8, dev, pinned=True)

    def batch(fetch: str):
        g = k1.k % k1.host.shape[0]
        k1(common.upload(k1.host[g], dev))
        row = k1.ring_row(k1.k - 1)
        if fetch == "blocking":
            row.cpu()
        elif fetch == "async":
            pinned.copy_(row.view(pinned.dtype), non_blocking=True)

    out = {arm: common.host_ms(dev, lambda arm=arm: batch(arm), batches)
           for arm in ("none", "blocking", "async")}
    return common.record("variant", dev, no_fetch_ms=out["none"], fetch_ms=out["blocking"],
                         async_fetch_ms=out["async"],
                         fetch_cost_ms=out["blocking"] - out["none"])


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
