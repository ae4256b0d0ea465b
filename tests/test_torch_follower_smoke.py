"""The port's follower over TCP against the reference's.

- tests/test_follower_smoke.py re-pointed (tests/torch_repoint.py): two
  in-process ReplicaServers (replica 0 writing an AOF), a FollowerServer
  tailing it and a RouterServer steering reads to it, over the native
  bus.  The unattested follower refuses and the router re-drives the
  read on the primary; once attested, the follower serves a reply
  byte-equal to the primary's whose (root, commit_min) equals the
  primary's root ring at that op; after the follower dies reads ride the
  primary; TB_READ_POLICY=primary pins the primary path.  The case runs
  on the port's server, follower, router, client and bus, and again on
  the reference's.
- The same case on the port alone with its replicas on the device
  engine: both ReplicaServers run TorchStateMachine(device="cpu",
  engine="device"), the follower still replays on the oracle, so every
  attested root is the device engine's root checked against the
  oracle's replay.
"""

import types as pytypes

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

FILE = "test_follower_smoke.py"
REPLICA_FACTORY = "state_machine_factory=lambda: CpuStateMachine(cfg.TEST_MIN),"


def test_repointed_follower_smoke_matches_reference(tmp_path):
    rp.run_both(FILE, "test_follower_smoke", "oracle", tmp_path)


def _device_engine_module() -> pytypes.ModuleType:
    """The case's module for the port, its replicas' factory swapped
    for the port's device engine (the follower's machine unchanged)."""
    text = rp._port_source((rp.TESTS / FILE).read_text())
    assert text.count(REPLICA_FACTORY) == 1
    text = text.replace(
        REPLICA_FACTORY,
        "state_machine_factory=lambda: _TorchStateMachine(cfg.TEST_MIN, "
        f"account_capacity={rp.CAPACITY}, device='cpu', engine='device'),",
    )
    text += (
        "\nfrom tigerbeetle_tpu_torch.state_machine.gpu import "
        "TorchStateMachine as _TorchStateMachine\n"
    )
    return rp.exec_source(FILE, "_repoint_device_engine_follower_smoke", text)


def test_follower_smoke_over_device_engine_replicas(tmp_path, monkeypatch, link_quiet):
    from tigerbeetle_tpu_torch.runtime.server import ReplicaServer

    servers = []
    init = ReplicaServer.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        servers.append(self)

    monkeypatch.setattr(ReplicaServer, "__init__", recording_init)
    _device_engine_module().test_follower_smoke(tmp_path, monkeypatch)
    assert [type(s.replica.sm).__name__ for s in servers] == ["TorchStateMachine"] * 2
    assert [s.replica.sm.engine for s in servers] == ["device"] * 2
    assert len(link_quiet) == 2
