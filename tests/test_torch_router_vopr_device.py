"""The port's ShardedVopr on the device engine against the reference's.

- tests/test_vopr_sharded.py's ``test_sharded_vopr_device_loss`` (seed
  31): every shard replica runs the device engine behind a seeded chaos
  link that the nemesis kills and heals.  Its own machines are already
  the device engine on both packages (the port's chaos factory builds
  TorchStateMachine(device="cpu", engine="device"), the reference's
  TpuStateMachine(engine="device")), so it runs on the recorder's
  "oracle" arm, which keeps a case's own machines; the host and device
  arms would replace them and drop the chaos links the case asserts.
- ``test_sharded_vopr_baseline_no_nemesis`` on the device arm.

Each run passes the case's own checks, and the two packages record equal
client replies, HashLog digests, commit points, state roots and storage
images for every shard.
"""

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no plain-link engine lost its link)


def test_repointed_sharded_vopr_device_loss_matches_reference(tmp_path):
    got = rp.run_both("test_vopr_sharded.py", "test_sharded_vopr_device_loss", "oracle", tmp_path)
    assert len(got) == 3  # the recording + two shard clusters


def test_repointed_sharded_vopr_baseline_on_device_engine_matches_reference(tmp_path):
    rp.run_both("test_vopr_sharded.py", "test_sharded_vopr_baseline_no_nemesis", "device",
                tmp_path)
