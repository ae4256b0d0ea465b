"""Sustained launch rate of a scatter kernel, the time from a launch
until ``Event.query()`` reports it done, and deferred drains.

    python -m tigerbeetle_tpu_torch.experiments.pipe_probe [--device D] [--quick]

Counterpart of the reference's experiments/pipe_probe.py (sustained
async dispatch, is-ready latency, latency hiding by deferred fetches).
The scatter kernel is K4 (``apply_deltas``: 16,384 deltas into the
2^20-row table, the write-behind flush's shape):

- ``launch_host_us`` / ``launch_device_us``: host and device µs a launch
  over back-to-back launches;
- ``query_done_us``: host µs from the launch call until an event
  recorded after it queries done (the host spinning on ``query()``);
- ``deferred_drain_ms``: by drain depth D, ms a batch when each batch
  uploads its deltas (pageable), launches K4 and copies a 64-byte
  summary to pinned host memory, and the host waits only on the event
  of the batch D behind.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KEYS = ("launch_host_us", "launch_device_us", "query_done_us", "deferred_drain_ms", "entries")
ENTRIES = 16_384
DEPTHS = (1, 4, 16)


def deltas(rows: int, k: int, seed: int) -> np.ndarray:
    """(4, k) int64 K4 entries: distinct (row, column) cells, small
    deltas."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(rows * 4, size=min(k, rows * 4), replace=False)
    packed = np.zeros((4, len(keys)), np.int64)
    packed[0], packed[1] = keys // 4, keys % 4
    packed[2] = rng.integers(1, 100, len(keys))
    return packed


def run(dev, quick: bool = False) -> dict:
    rows = common.link_rows(dev)
    table = torch.zeros((rows, 8), dtype=torch.int64, device=dev)
    host = deltas(rows, ENTRIES, 0)
    packed = torch.from_numpy(host).to(dev)
    reps = 50 if quick else 500
    launch = lambda: dk.apply_deltas(table, packed)  # noqa: E731
    host_us = common.host_ms(dev, launch, reps) * 1e3
    device_us = common.device_ms(dev, launch, reps) * 1e3
    waits = []
    for _ in range(10 if quick else 50):
        common.sync(dev)
        t0 = time.perf_counter()
        launch()
        done = common.Marker(dev).record()
        while not done.query():
            pass
        waits.append((time.perf_counter() - t0) * 1e6)
    summary = common.host_buffer(64, dev, pinned=True)
    drains = {}
    batches = 16 if quick else 96
    for depth in DEPTHS:
        pending = []

        def batch():
            up = torch.from_numpy(host).to(dev)
            dk.apply_deltas(table, up)
            summary.copy_(table[0].view(torch.uint8), non_blocking=True)
            pending.append(common.Marker(dev).record())
            if len(pending) > depth:
                pending.pop(0).synchronize()

        drains[str(depth)] = common.host_ms(dev, batch, batches)
    return common.record("pipe", dev, launch_host_us=host_us, launch_device_us=device_us,
                         query_done_us=float(np.median(waits)), deferred_drain_ms=drains,
                         entries=int(packed.shape[1]))


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
