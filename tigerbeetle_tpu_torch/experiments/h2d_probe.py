"""A host-to-device copy alone, beside independent compute on a second
stream (copy-engine overlap), and chained into the kernel that reads it.

    python -m tigerbeetle_tpu_torch.experiments.h2d_probe [--device D] [--quick]

Counterpart of the reference's experiments/h2d_probe.py (why h2d slowed
inside a dispatch loop: transfer alone, beside compute, chained).  The
copy is one superbatch of 8 probe batches (~1.3 MiB, the engine's
staging size); the overlap arm copies 32 MiB beside enough K1 batches
to take about as long:

- ``alone_ms``: the copy on an idle card, pinned and pageable;
- ``compute_ms``: K1 batches alone on the compute stream;
- ``beside_ms``: the 32 MiB pinned copy on a second stream while the K1
  batches run on the first, device ms from before both to after both
  (``copy_ms`` the copy alone); ``overlap`` is how much of the shorter
  one the pair hid (1: fully, 0: serialised);
- ``chained_ms``: a batch uploaded and K1 launched on it, each batch
  waiting on its own copy, ms a batch.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("alone_ms", "compute_ms", "copy_ms", "beside_ms", "overlap", "chained_ms", "bytes")
BIG = 32 * common.MiB
G = 8


def run(dev, quick: bool = False) -> dict:
    k1 = common.K1Batch(dev, G=G)
    sup = k1.host.reshape(-1, k1.host.shape[-1])
    nbytes = sup.nbytes
    pinned = common.host_buffer(nbytes, dev, pinned=True)
    pinned.copy_(torch.from_numpy(sup.view("uint8").reshape(-1)))
    pageable = torch.from_numpy(sup.view("uint8").reshape(-1).copy())
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    reps = 10 if quick else 50
    alone = {"pinned": common.device_ms(dev, lambda: dst.copy_(pinned, non_blocking=True), reps),
             "pageable": common.device_ms(dev, lambda: dst.copy_(pageable), reps)}
    big = common.host_buffer(BIG if dev.type == "cuda" else common.MiB, dev, pinned=True)
    big_dst = torch.empty(big.numel(), dtype=torch.uint8, device=dev)
    copy_ms = common.device_ms(dev, lambda: big_dst.copy_(big, non_blocking=True), 3)
    k1_ms = common.device_ms(dev, k1, 8)
    launches = max(1, round(copy_ms / k1_ms)) if k1_ms > 0 else 1

    def compute():
        for _ in range(launches):
            k1()

    compute_ms = common.device_ms(dev, compute, 3)
    side = common.side_stream(dev)

    def beside():
        start = common.Marker(dev).record()
        with common.on_stream(side):
            if side is not None:
                side.wait_event(start.event)
            big_dst.copy_(big, non_blocking=True)
            copied = common.Marker(dev).record(side)
        compute()
        if side is not None:
            torch.cuda.current_stream(dev).wait_event(copied.event)
        end = common.Marker(dev).record()
        end.synchronize()
        return start.ms_to(end)

    beside()  # warm
    beside_ms = min(beside() for _ in range(3))
    hidden = compute_ms + copy_ms - beside_ms
    overlap = hidden / min(compute_ms, copy_ms) if min(compute_ms, copy_ms) > 0 else 0.0

    def chained():
        g = k1.k % G
        k1(common.upload(k1.host[g], dev))

    chained_ms = common.host_ms(dev, chained, reps)
    return common.record("h2d", dev, alone_ms=alone, compute_ms=compute_ms, copy_ms=copy_ms,
                         beside_ms=beside_ms, overlap=max(0.0, min(1.0, overlap)),
                         chained_ms=chained_ms, bytes=nbytes)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
