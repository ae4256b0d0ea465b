"""Host time of the mirror's limb accumulation, dense against sparse.

    python -m tigerbeetle_tpu_torch.tools.mirror_accum [--batches N]

``BalanceMirror.try_apply_adds`` sums each batch's amounts per (slot,
col) key either densely over every key below the batch's highest slot
or sparsely over the batch's distinct keys (``mirror.limb_sums``), and
picks sparse once the dense range exceeds ``mirror.SPARSE_RATIO`` times
the batch's contributions.  This script times both arms on the same
8190-event batches: the zipf stream's draw (100 accounts, p ~ 1/rank)
and uniform draws over tables from 100 rows to 2^20, and prints one
JSON line per table with the median milliseconds per batch of each arm
and the ratio of dense keys to contributions, so the crossover can be
read off.  numpy only; no card needed.
"""
# tbcheck: allow-file(no-print): a command-line tool — the lines it
# prints on stdout are its output.

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from tigerbeetle_tpu_torch.state_machine.mirror import SPARSE_RATIO, limb_sums

BATCH = 8190
TABLES = (100, 1_000, 4_096, 8_192, 16_384, 32_768, 65_536, 262_144, 1 << 20)


def _batch(rng, n_accounts, zipf):
    if zipf:
        ranks = np.arange(1, n_accounts + 1, dtype=np.float64)
        p = (1.0 / ranks) / (1.0 / ranks).sum()
        dr = rng.choice(n_accounts, size=BATCH, p=p)
        cr = rng.choice(n_accounts, size=BATCH, p=p)
    else:
        dr = rng.integers(0, n_accounts, BATCH)
        cr = (dr + 1) % n_accounts
    pending = np.zeros(BATCH, bool)
    idx_dr = dr * 4 + np.where(pending, 0, 1)
    idx_cr = cr * 4 + np.where(pending, 2, 3)
    amt_lo = rng.integers(1, 100, BATCH).astype(np.uint64)
    top = int(max(dr.max(), cr.max())) + 1
    return idx_dr, idx_cr, amt_lo, np.zeros(BATCH, np.uint64), top * 4


def _median_ms(batches, sparse, reps):
    times = []
    for _ in range(reps):
        for args in batches:
            t0 = time.perf_counter()
            limb_sums(*args, sparse)
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(2026)
    cases = [("zipf", 100, True)] + [("uniform", n, False) for n in TABLES]
    for name, n_accounts, zipf in cases:
        batches = [_batch(rng, n_accounts, zipf) for _ in range(args.batches)]
        for sparse in (False, True):  # warm both arms
            limb_sums(*batches[0], sparse)
        dense_ms = _median_ms(batches, False, args.reps)
        sparse_ms = _median_ms(batches, True, args.reps)
        K = batches[0][4]
        print(json.dumps({
            "draw": name, "accounts": n_accounts,
            "dense_keys_per_contribution": K / (2 * BATCH),
            "picks": "sparse" if K > SPARSE_RATIO * 2 * BATCH else "dense",
            "dense_ms": dense_ms, "sparse_ms": sparse_ms,
        }))


if __name__ == "__main__":
    main()
