"""The port's ShardedVopr against the reference's, on the CPU oracle.

tests/test_vopr_sharded.py's cases re-pointed (tests/torch_repoint.py):
the multi-cluster router under the per-shard nemeses and the
coordinator-kill nemesis, with 2PC atomicity and conservation audited
mid-run and the oracle replay at the end.  Each run passes the case's
own checks, and the two packages record equal client replies, HashLog
digests op by op, commit points, state roots and storage images for
every shard.  The device-loss case and the engine arms of the baseline
are in test_torch_router_vopr_device.py and test_torch_router_host.py.
"""

import pytest

import torch_repoint as rp

CASES = [
    ("test_sharded_vopr_baseline_no_nemesis", {}),
    ("test_sharded_vopr_coordinator_kill_only", {}),
    *[("test_sharded_vopr_full_mix", {"seed": s}) for s in (1, 55, 616, 2046, 3013, 4242)],
    ("test_sharded_vopr_three_shards", {}),
    ("test_sharded_vopr_multi_tenant_flood", {}),
]


def case_id(case, params):
    return case[5:] + "".join(f"-{v}" for v in params.values())


def test_cases_cover_the_reference_file():
    names = {c for c, _ in CASES} | {"test_sharded_vopr_device_loss"}
    assert names == set(rp.case_names("test_vopr_sharded.py"))


@pytest.mark.parametrize("case,params", CASES, ids=[case_id(*c) for c in CASES])
def test_repointed_case_matches_reference(case, params, tmp_path):
    rp.run_both("test_vopr_sharded.py", case, "oracle", tmp_path, dict(params))
