"""The port's follower over a TorchStateMachine upstream on the device
engine, against the reference's over TpuStateMachine.

tests/test_follower.py's pinned FollowerVopr seeds and
test_sim_follower_crash_restart_reattests on the device arm of
tests/torch_repoint.py: every upstream replica runs
TorchStateMachine(device="cpu", engine="device") in the port's run and
TpuStateMachine(engine="device") in the reference's, while the follower
replays on each package's oracle.  Each run passes the case's own
checks (check_never_lied among them, and the follower's read equal to
the upstream's), and the two packages record equal client replies,
HashLog digests, commit points, state roots, storage images, follower
serves and refusals, and FollowerVopr counters.
"""

import pytest

import torch_follower as tf
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

ARM = "device"
PINNED = tf.pinned_seeds()


@pytest.mark.parametrize("seed,expect", PINNED, ids=[str(s) for s, _ in PINNED])
def test_repointed_pinned_vopr_seed_matches_reference(seed, expect, tmp_path, monkeypatch):
    tf.run_both("test_follower_vopr_pinned", ARM, tmp_path, monkeypatch,
                {"seed": seed, "expect": expect})


def test_repointed_sim_follower_crash_restart_matches_reference(tmp_path, monkeypatch):
    tf.run_both("test_sim_follower_crash_restart_reattests", ARM, tmp_path, monkeypatch)
