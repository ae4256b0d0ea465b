"""Superbatch host-to-device staging at the engine's G and R
(``device_kernels.staged``).

    python -m tigerbeetle_tpu_torch.experiments.staged_probe [--device D] [--quick]

Counterpart of the reference's experiments/staged_probe.py (one
transfer per G batches and one ring fetch per R batches: G = 8, R = 64
gave 10 ms a batch over the TPU link).  Each G batches upload one (G x
8192, 6) superbatch (pageable, as the engine stages), each batch runs
``staged("orderfree_tight")`` (K1 on its view of the superbatch), and
every R batches the host fetches the R ring rows: ms a batch and
events/s for G in 1, 8, 16 and R in 16, 96, beside per-batch uploads
(G = 1).
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KEYS = ("by_G_R",)
SHAPES = ((1, 16), (8, 16), (8, common.ENGINE_R), (16, common.ENGINE_R))
KIND = "orderfree_tight"


def run(dev, quick: bool = False) -> dict:
    rows = common.link_rows(dev)
    table, meta, ring = common.tables(rows, dev)
    scratch = common.scratch_for(KIND, rows, dev)
    launch = dk.staged(KIND)
    out = []
    for G, R in SHAPES:
        host = common.superbatch(KIND, rows, G)
        window = torch.arange(R, device=dev)
        state = {"k": 0, "sup": None}

        def batch():
            k = state["k"]
            if k % G == 0:
                state["sup"] = common.upload(host, dev)
            launch(table, meta, ring, k % common.RING_ROWS, state["sup"], k % G, common.N,
                   1 << 40, scratch=scratch)
            state["k"] = k + 1
            if state["k"] % R == 0:
                ring.index_select(0, (window + (state["k"] - R)) % common.RING_ROWS).cpu()

        batches = R * (1 if quick else 3)
        ms = common.host_ms(dev, batch, batches, warm=0)
        out.append({"G": G, "R": R, "ms_per_batch": ms,
                    "events_per_s": common.N / (ms * 1e-3) if ms > 0 else None})
    return common.record("staged", dev, by_G_R=out)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
