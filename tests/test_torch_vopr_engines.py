"""The port's VOPR over TorchStateMachine(device="cpu") on each engine,
and the device-loss nemesis, against the reference's.

- tests/test_vopr.py's test_vopr_tpu_state_machine and
  test_vopr_tpu_state_machine_with_faults (seeds 17 and 21, 40 requests,
  the second under packet loss and crashes) on the host and device arms
  of tests/torch_repoint.py: every replica on TorchStateMachine(device=
  "cpu", engine=<arm>) in the port's run and on TpuStateMachine(engine=
  <arm>) in the reference's.
- tests/test_chaos.py::test_vopr_device_loss_nemesis: seed 21, 18
  requests, device-loss probability 0.04, with the case's fixture (window
  4, no backoff, probe every 2).  The port's chaos factory builds its
  machines on the CPU (tests/torch_repoint.py); the case asserts at least
  one kill and one demotion on each package.
- tests/test_obs.py::test_registry_snapshot_monotonic_under_chaos: the
  VOPR workload through a device engine behind a chaos link.

Each run passes the case's own checks, and the two packages record equal
client replies, HashLog digests op by op, commit points, state roots and
storage images.
"""

import pytest

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

ARMS = [
    (case, arm)
    for case in ("test_vopr_tpu_state_machine", "test_vopr_tpu_state_machine_with_faults")
    for arm in ("host", "device")
]


@pytest.mark.parametrize("case,arm", ARMS, ids=[f"{c[5:]}-{a}" for c, a in ARMS])
def test_repointed_vopr_on_engine_matches_reference(case, arm, tmp_path):
    rp.run_both("test_vopr.py", case, arm, tmp_path)


def test_repointed_device_loss_nemesis_matches_reference(tmp_path):
    rp.run_both(
        "test_chaos.py", "test_vopr_device_loss_nemesis", "oracle", tmp_path,
        autouse=("_fast_lifecycle",),
    )


def test_repointed_registry_monotonic_under_chaos_matches_reference(tmp_path):
    rp.run_both(
        "test_obs.py", "test_registry_snapshot_monotonic_under_chaos", "oracle", tmp_path,
    )
