"""Sixteen concurrent 4 KiB device-to-host copies: serialised or
overlapped?  And a continuous-pull ring.

    python -m tigerbeetle_tpu_torch.experiments.pull_probe [--device D] [--quick]

Counterpart of the reference's experiments/pull_probe.py (16 x 4 KiB
d2h fetches serialised at 56 ms each over the TPU link, and a summary
ring with one fetch always in flight).  ``one_4k_us``: one 4 KiB copy
into pinned memory, host µs to completion; ``sixteen_4k_us``: sixteen
issued at once, each on its own stream, device µs from an event before
them to one after all (``one_4k_device_us`` the same for one copy);
``overlap`` = 16 x one / sixteen on the device (1: serialised, 16:
fully overlapped).
The ring: K1 a batch, and each batch a non-blocking copy of its ring
row into pinned memory, the host waiting only on the copy before
(one in flight): ms a batch.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("one_4k_us", "one_4k_device_us", "sixteen_4k_us", "overlap", "pull_ring_ms")
COPIES = 16


def run(dev, quick: bool = False) -> dict:
    srcs = [torch.full((512,), k, dtype=torch.int64, device=dev) for k in range(COPIES)]
    dsts = [common.host_buffer(4 * common.KiB, dev, pinned=True).view(torch.int64)
            for _ in range(COPIES)]
    streams = [common.side_stream(dev) for _ in range(COPIES)]
    reps = 10 if quick else 100

    def one():
        dsts[0].copy_(srcs[0], non_blocking=True)
        common.Marker(dev).record().synchronize()

    def copies(k: int) -> float:
        """Device µs from an event before `k` copies, each on its own
        stream, to one after all of them."""
        start = common.Marker(dev).record()
        done = []
        for src, dst, stream in zip(srcs[:k], dsts[:k], streams[:k]):
            with common.on_stream(stream):
                if stream is not None:
                    stream.wait_event(start.event)
                dst.copy_(src, non_blocking=True)
                done.append(common.Marker(dev).record(stream))
        for m in done:
            if m.event is not None:
                torch.cuda.current_stream(dev).wait_event(m.event)
        end = common.Marker(dev).record()
        end.synchronize()
        return start.ms_to(end) * 1e3

    one_us = common.host_ms(dev, one, reps) * 1e3
    copies(COPIES)  # warm
    one_dev = min(copies(1) for _ in range(reps))
    all_us = min(copies(COPIES) for _ in range(reps))
    k1 = common.K1Batch(dev)
    pinned = common.host_buffer(k1.ring.shape[1] * 8, dev, pinned=True).view(torch.int64)
    inflight = []

    def pull():
        k1()
        if inflight:
            inflight.pop().synchronize()
        pinned.copy_(k1.ring_row(k1.k - 1), non_blocking=True)
        inflight.append(common.Marker(dev).record())

    ring_ms = common.host_ms(dev, pull, 16 if quick else 128)
    return common.record("pull", dev, one_4k_us=one_us, one_4k_device_us=one_dev,
                         sixteen_4k_us=all_us,
                         overlap=COPIES * one_dev / all_us if all_us else None,
                         pull_ring_ms=ring_ms)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
