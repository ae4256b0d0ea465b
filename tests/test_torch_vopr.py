"""The port's VOPR against the reference's, on the CPU oracle (part 1).

tests/test_vopr.py's cases re-pointed at the port (tests/torch_repoint.py):
each runs on the port's testing/vopr.py, testing/cluster.py, vsr/ and
state_machine/cpu.py, and again on the reference's modules.  Both runs
pass the case's own checks (linearization, convergence, conservation,
restart-replay equivalence, the audits) and record equal client
replies, HashLog digests op by op, commit points, state roots and
byte-equal MemoryStorage images.  The cases named "tpu_state_machine"
run TorchStateMachine(device="cpu") against TpuStateMachine.

This file keeps test_vopr_seed before test_vopr_restart_check_exercised:
the second reads what the first appended to the loaded module's
_RESTART_CHECKS.  The soak-found seeds are in test_torch_vopr_seeds.py,
the deep slice in test_torch_vopr_deep_*.py, the engine arms in
test_torch_vopr_engines.py.  Not re-pointed: test_vopr_deep_matrix (it
skips unless VOPR_DEEP=1) and test_vopr_partition_open_finds (xfail on
the reference, ~51 s a case).
"""

import pytest

import torch_repoint as rp

CASES = [
    *[("test_vopr_seed", {"seed": s}) for s in (1, 7, 42, 1234)],
    ("test_vopr_restart_check_exercised", {}),
    ("test_vopr_no_faults_longer", {}),
    *[("test_vopr_reconfigure_nemesis", {"seed": s}) for s in (44, 71)],
    *[("test_vopr_query_workload", {"seed": s}) for s in (5, 812)],
    ("test_vopr_heavy_faults", {}),
    ("test_vopr_tpu_state_machine", {}),
    ("test_workload_deterministic", {}),
    ("test_hash_log_divergence_pinpointing", {}),
    ("test_vopr_tpu_state_machine_with_faults", {}),
    *[("test_vopr_fault_atlas_seed", {"seed": s}) for s in (101, 202, 303, 404)],
    *[("test_vopr_multi_tenant_flood", {"seed": s}) for s in (6, 23)],
    ("test_vopr_multi_tenant_weighted", {}),
]


def case_id(case, params):
    return case[5:] + "".join(f"-{v}" for v in params.values())


@pytest.mark.parametrize("case,params", CASES, ids=[case_id(*c) for c in CASES])
def test_repointed_case_matches_reference(case, params, tmp_path):
    rp.run_both("test_vopr.py", case, "oracle", tmp_path, dict(params))
