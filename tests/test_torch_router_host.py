"""The router's sharded clusters on TorchStateMachine(device="cpu",
engine="host") against the reference's on TpuStateMachine(engine="host").

- tests/test_router.py's ten sim-cluster cases (the ``sharded`` fixture:
  2 shards x 2 replicas) on the host arm of tests/torch_repoint.py;
- tests/test_vopr_sharded.py's ``test_sharded_vopr_baseline_no_nemesis``
  (seed 11, 25 requests, no nemesis: every cross-shard transfer commits)
  on the same arm;
- testing/seeded.py's ShardedVopr runs (chip_smoke.py's router phase)
  on the same machines against the port's oracle.

Each run passes the case's own checks (2PC atomicity, conservation, the
oracle replay), and the two packages record equal client replies,
HashLog digests op by op, commit points, state roots and storage images
for every shard.
"""

import re

import pytest

import torch_repoint as rp
from tigerbeetle_tpu_torch.testing import seeded
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

SIM_CASES = re.findall(r"^def (test_\w+)\(sharded\b", (rp.TESTS / "test_router.py").read_text(),
                       flags=re.M)
ARM = "host"


def test_sim_cases_are_the_ten_fixture_cases():
    assert len(SIM_CASES) == 10, SIM_CASES


@pytest.mark.parametrize("case", SIM_CASES, ids=[c[5:] for c in SIM_CASES])
def test_repointed_router_case_on_engine_matches_reference(case, tmp_path):
    rp.run_both("test_router.py", case, ARM, tmp_path)


def test_repointed_sharded_vopr_baseline_on_engine_matches_reference(tmp_path):
    rp.run_both("test_vopr_sharded.py", "test_sharded_vopr_baseline_no_nemesis", ARM, tmp_path)


@pytest.mark.parametrize("seed,params", seeded.SHARDED_VOPR_CASES,
                         ids=[str(s) for s, _ in seeded.SHARDED_VOPR_CASES])
def test_seeded_sharded_vopr_on_engine_matches_the_oracle(seed, params):
    """chip_smoke.py's router phase, part (a), with the machines on the
    CPU: testing/seeded.py's run of each ShardedVopr case, every shard
    replica on TorchStateMachine(device="cpu", engine="host"), records
    what the same seed records on the port's oracle; the patched
    ShardedCluster and client requests are put back after."""
    import dataclasses

    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
    from tigerbeetle_tpu_torch.testing import cluster as cl
    from tigerbeetle_tpu_torch.testing import vopr

    before = (vopr.ShardedCluster, cl.SimClient.request, cl.RoutedClient.request)
    config = dataclasses.replace(cfg.TEST_MIN, clients_max=16)  # ShardedCluster's
    _, want = seeded.sharded_vopr_run(seed, params)
    v, got = seeded.sharded_vopr_run(
        seed, params, lambda: TorchStateMachine(config, engine=ARM, device="cpu"))
    assert all(r.sm.engine == ARM for s in v.cluster.shards for r in s.replicas)
    assert got == want
    assert (vopr.ShardedCluster, cl.SimClient.request, cl.RoutedClient.request) == before
