"""The port's VOPR against the reference's, on the CPU oracle (part 2):
tests/test_vopr.py's pinned soak finds, re-pointed as in
tests/test_torch_vopr.py (equal replies, HashLog digests, commit points,
state roots and storage images on both packages)."""

import pytest

import torch_repoint as rp
from test_torch_vopr import case_id

STALE_CARRIER = [
    (925761995, 0.039035675104828776, 0.02793538190863725, 0.0, False),
    (941686528, 0.03065367688868138, 0.010939315579479669, 0.005, True),
    (199800160, 0.04844306222485367, 0.026223549036723696, 0.001, True),
]
SYNC_MEMBERSHIP = [
    (300661417, 0.07704366683116852, 0.00454365485120272, 0.005, False, False, 120),
    (399484635, 0.04704768808915133, 0.034975506481705096, 0.005, True, True, 60),
]
CASES = [
    *[("test_vopr_sync_membership_seed", dict(zip(("seed", "pl", "cp", "co", "up", "q", "req"), p)))
      for p in SYNC_MEMBERSHIP],
    ("test_vopr_reconfigure_superseded_identity_seed", {}),
    ("test_vopr_membership_gossip_seed", {}),
    ("test_vopr_uncovered_tail_eviction_seed", {}),
    ("test_vopr_ring_wrap_headroom_seed", {}),
    ("test_vopr_vouch_chain_hole_seed", {}),
    ("test_vopr_mixed_chain_dvc_seed", {}),
    *[("test_vopr_partition_nemesis", {"seed": s}) for s in (9, 310)],
    ("test_vopr_primary_scrub_repair_seed", {}),
    *[("test_vopr_stale_carrier_merge_seed", dict(zip(("seed", "pl", "cp", "co", "up"), p)))
      for p in STALE_CARRIER],
    ("test_vopr_repair_target_rotation_seed", {}),
    ("test_vopr_stale_pin_overwrite_seed", {}),
    ("test_vopr_pipelined_register_eviction_seed", {}),
    ("test_vopr_unapplied_suffix_eviction_seed", {}),
    ("test_vopr_understating_dvc_seed", {}),
    ("test_vopr_duplicate_start_view_seed", {}),
    ("test_vopr_unknown_anchor_seed", {}),
]


@pytest.mark.parametrize("case,params", CASES, ids=[case_id(c, {"seed": p["seed"]} if p else {}) for c, p in CASES])
def test_repointed_case_matches_reference(case, params, tmp_path):
    rp.run_both("test_vopr.py", case, "oracle", tmp_path, dict(params))
