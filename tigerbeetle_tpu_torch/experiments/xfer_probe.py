"""Host-to-device copy time from 4 KiB to 64 MiB, pinned against
pageable host memory.

    python -m tigerbeetle_tpu_torch.experiments.xfer_probe [--device D] [--quick]

Counterpart of the reference's experiments/xfer_probe.py (h2d and d2h
latency by size over the TPU link).  Each size is copied from a pinned
and from a pageable host buffer into a device buffer, the copy timed by
CUDA events around ``reps`` copies back to back on an idle card: ms a
copy and GB/s.  A pageable copy stages through a pinned bounce buffer of
the driver's, so it is synchronous with the host.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common

KEYS = ("h2d", "sizes")
SIZES = (4 * common.KiB, 64 * common.KiB, common.MiB, 16 * common.MiB, 64 * common.MiB)


def h2d_ms(dev, nbytes: int, pinned: bool, reps: int) -> float:
    src = common.host_buffer(nbytes, dev, pinned)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return common.device_ms(dev, lambda: dst.copy_(src, non_blocking=pinned), reps)


def run(dev, quick: bool = False) -> dict:
    sizes = SIZES if dev.type == "cuda" else SIZES[:2]
    rows = []
    for nbytes in sizes:
        reps = max(2, min(50, (256 * common.MiB) // nbytes // (4 if quick else 1)))
        row = {"bytes": nbytes}
        for pinned in (True, False):
            ms = h2d_ms(dev, nbytes, pinned, reps)
            key = "pinned" if pinned else "pageable"
            row[f"{key}_ms"] = ms
            row[f"{key}_gbps"] = nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None
        rows.append(row)
    return common.record("xfer", dev, h2d=rows, sizes=list(sizes))


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
