"""The port's follower against the reference's, on the CPU oracle.

tests/test_follower.py's cases re-pointed (tests/torch_repoint.py): the
AOF tail (resume, torn-then-heal, corrupt against torn, chunked reads),
the AOF writer's repair-on-open and recovery gap-fill, FollowerCore's
serving gate (unattested, lagging, poisoned, gap, corrupt, not readable,
byte-charged admission, the attestation-age bound, logically batched
prepares), SimFollower's crash and re-attestation, and the pinned
FollowerVopr seeds.  Each run passes the case's own checks, and the two
packages record equal client replies, HashLog digests, commit points,
state roots, storage images, follower serves and refusals, and
FollowerVopr counters.  The engine arms are in
test_torch_follower_host.py and test_torch_follower_device.py; the
sweep of seeds 8-23 stays slow, as in the reference.
"""

import pytest

import torch_follower as tf
import torch_repoint as rp

PINNED = tf.pinned_seeds()
SLOW = {"test_follower_vopr_pinned", "test_follower_vopr_sweep"}
CASES = [c for c in rp.case_names(tf.FILE) if c not in SLOW]


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path, monkeypatch):
    tf.run_both(case, "oracle", tmp_path, monkeypatch)


@pytest.mark.parametrize("seed,expect", PINNED, ids=[str(s) for s, _ in PINNED])
def test_repointed_pinned_vopr_seed_matches_reference(seed, expect, tmp_path, monkeypatch):
    tf.run_both("test_follower_vopr_pinned", "oracle", tmp_path, monkeypatch,
                {"seed": seed, "expect": expect})


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8, 24))
def test_repointed_vopr_sweep_matches_reference(seed, tmp_path, monkeypatch):
    tf.run_both("test_follower_vopr_sweep", "oracle", tmp_path, monkeypatch, {"seed": seed})


def test_cases_cover_the_reference_file():
    assert set(CASES) | SLOW == set(rp.case_names(tf.FILE))
    assert [s for s, _ in PINNED] == [0, 1, 2, 4]
