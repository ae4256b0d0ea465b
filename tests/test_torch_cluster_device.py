"""The port's VSR cluster against the reference's, device engine.

tests/test_torch_cluster.py's re-pointed cases (tests/torch_repoint.py)
whose clusters run state machines, with every replica on
TorchStateMachine(device="cpu", engine="device") in the port's run and
TpuStateMachine(engine="device") in the reference's, at a capacity that
does not divide by 8.  Also tests/test_block_repair.py and
test_lsm_spill.py::test_state_sync_ships_spilled_blocks, whose replicas
spill to their LSM grid.  Equal replies, HashLog digests op by op,
commit points, state roots and byte-equal MemoryStorage images.
"""

import pytest

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

FILES = (
    "test_cluster.py", "test_multi.py", "test_clock.py", "test_reconfigure.py",
    "test_standby.py", "test_upgrade.py", "test_block_repair.py",
)
CASES = [
    (f, c) for f in FILES for c in rp.case_names(f)
    if not c.startswith("test_marzullo")
    and not c.startswith("test_clock_")
] + [
    ("test_demuxer.py", "test_cluster_batched_prepare_demuxes_per_client"),
    ("test_lsm_spill.py", "test_state_sync_ships_spilled_blocks"),
]


@pytest.mark.parametrize("test_file,case", CASES, ids=[f"{f[5:-3]}-{c[5:]}" for f, c in CASES])
def test_repointed_case_matches_reference(test_file, case, tmp_path):
    rp.run_both(test_file, case, "device", tmp_path)
