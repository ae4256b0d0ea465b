"""The router's sharded clusters on TorchStateMachine(device="cpu",
engine="device") against the reference's on TpuStateMachine(
engine="device"): tests/test_router.py's ten sim-cluster cases on the
device arm of tests/torch_repoint.py (the host arm and the list of cases
are in test_torch_router_host.py).  Each run passes the case's own
checks, and the two packages record equal client replies, HashLog
digests, commit points, state roots and storage images for every shard.
"""

import pytest

import torch_repoint as rp
from test_torch_router_host import SIM_CASES
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)


@pytest.mark.parametrize("case", SIM_CASES, ids=[c[5:] for c in SIM_CASES])
def test_repointed_router_case_on_engine_matches_reference(case, tmp_path):
    rp.run_both("test_router.py", case, "device", tmp_path)
