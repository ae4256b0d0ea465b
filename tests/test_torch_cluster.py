"""The port's VSR cluster against the reference's, on the CPU oracle.

The cases of tests/test_cluster.py, test_multi.py, test_clock.py,
test_reconfigure.py, test_standby.py, test_upgrade.py and
test_cluster_liveness.py, plus test_demuxer.py's cluster case,
re-pointed at the port (tests/torch_repoint.py): each case runs on the
port's vsr/multi.py, testing/cluster.py, runtime/server.py and client.py
over the port's oracle state_machine/cpu.py, and again on the
reference's modules over its CpuStateMachine.  Both runs pass the case's
own assertions and record equal client replies, HashLog digests op by
op, commit points, state roots and byte-equal MemoryStorage images.
tests/test_torch_cluster_host.py and _device.py run the same cases on
TorchStateMachine(device="cpu") against TpuStateMachine.
"""

import pytest

import torch_repoint as rp

FILES = (
    "test_cluster.py", "test_multi.py", "test_clock.py", "test_reconfigure.py",
    "test_standby.py", "test_upgrade.py", "test_cluster_liveness.py",
)
CASES = [
    (f, c) for f in FILES for c in rp.case_names(f)
] + [("test_demuxer.py", "test_cluster_batched_prepare_demuxes_per_client")]


@pytest.mark.parametrize("test_file,case", CASES, ids=[f"{f[5:-3]}-{c[5:]}" for f, c in CASES])
def test_repointed_case_matches_reference(test_file, case, tmp_path):
    rp.run_both(test_file, case, "oracle", tmp_path)
