"""In-place against out-of-place kernels under a host-to-device copy and
a fetch each batch.

    python -m tigerbeetle_tpu_torch.experiments.nodonate_probe [--device D] [--quick]

Counterpart of the reference's experiments/nodonate_probe.py, which
asked whether JAX's buffer donation caused the link's slow batches.
PyTorch has no donation: a kernel of the port writes its table in place
by default, and the nearest thing to a JAX function that does not
donate is one that writes a fresh table.  So each batch uploads 16,384
K4 deltas (pageable), applies them and fetches a 64-byte summary; the
in-place arm applies them to the resident table, the out-of-place arm
to a fresh copy of it (``torch.empty_like`` + ``copy_``, then K4 on the
copy), which becomes the table: ms a batch each.
"""

from __future__ import annotations

import sys

import torch

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.experiments.pipe_probe import ENTRIES, deltas
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

KEYS = ("in_place_ms", "out_of_place_ms", "donation")
DONATION = ("none in torch: in place is the default; the out-of-place arm allocates and "
            "copies the table each batch")


def run(dev, quick: bool = False) -> dict:
    rows = common.link_rows(dev)
    host = deltas(rows, ENTRIES, 1)
    state = {"table": torch.zeros((rows, 8), dtype=torch.int64, device=dev)}
    batches = 16 if quick else 96

    def batch(in_place: bool):
        up = torch.from_numpy(host).to(dev)
        table = state["table"]
        if not in_place:
            table = torch.empty_like(table).copy_(table)
        dk.apply_deltas(table, up)
        state["table"] = table
        table[0].cpu()

    in_place = common.host_ms(dev, lambda: batch(True), batches)
    out_of_place = common.host_ms(dev, lambda: batch(False), batches)
    return common.record("nodonate", dev, in_place_ms=in_place, out_of_place_ms=out_of_place,
                         donation=DONATION)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
