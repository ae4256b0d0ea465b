"""Device-to-host copies of computed arrays: fixed cost and cost per MB,
pinned against pageable; and ring collection.

    python -m tigerbeetle_tpu_torch.experiments.d2h_probe [--device D] [--quick]

Counterpart of the reference's experiments/d2h_probe.py (~105 ms fixed
+ ~15 MB/s over the TPU link).  Each size from 4 KiB to 16 MiB is
computed on the card (an add over a fresh buffer), then copied to a
pinned and to a pageable host buffer, the copy timed by CUDA events; a
least-squares line over the sizes gives the fixed µs and the µs per MB.
Ring collection: K1 batches back to back, the host fetching the ring
rows of the last R batches every R batches (R = 96, the engine's
window), ms a batch.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("d2h", "pinned_fixed_us", "pinned_us_per_mb", "pageable_fixed_us",
        "pageable_us_per_mb", "ring_ms_per_batch")
SIZES = (4 * common.KiB, 64 * common.KiB, common.MiB, 4 * common.MiB, 16 * common.MiB)


def run(dev, quick: bool = False) -> dict:
    sizes = SIZES if dev.type == "cuda" else SIZES[:2]
    rows = []
    for nbytes in sizes:
        src = torch.zeros(nbytes // 8, dtype=torch.int64, device=dev)
        reps = 5 if quick else 20
        row = {"bytes": nbytes}
        for pinned in (True, False):
            dst = common.host_buffer(nbytes, dev, pinned).view(torch.int64)

            def fetch():
                src.add_(1)  # computed on the card, then fetched
                dst.copy_(src, non_blocking=pinned)

            compute = common.device_ms(dev, lambda: src.add_(1), reps)
            row["pinned_us" if pinned else "pageable_us"] = (
                common.device_ms(dev, fetch, reps) - compute) * 1e3
        rows.append(row)
    mb = [r["bytes"] / common.MiB for r in rows]
    p0, p1 = common.fit_line(mb, [r["pinned_us"] for r in rows])
    q0, q1 = common.fit_line(mb, [r["pageable_us"] for r in rows])
    k1 = common.K1Batch(dev)
    R = common.ENGINE_R if not quick else 16

    window = torch.arange(R, device=dev)

    def burst():
        for _ in range(R):
            k1()
        k1.ring.index_select(0, (window + (k1.k - R)) % common.RING_ROWS).cpu()

    ring_ms = common.host_ms(dev, burst, 1 if quick else 4) / R
    return common.record("d2h", dev, d2h=rows, pinned_fixed_us=p0, pinned_us_per_mb=p1,
                         pageable_fixed_us=q0, pageable_us_per_mb=q1,
                         ring_ms_per_batch=ring_ms)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
