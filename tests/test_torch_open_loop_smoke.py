"""The port's admission control under open-loop overload against the
reference's.

tests/test_open_loop_smoke.py re-pointed (tests/torch_repoint.py): a
real two-replica TCP cluster of subprocess ``ReplicaServer``s (in the
port's run the port's servers, each on the port's CPU oracle, importing
nothing of the reference), driven open loop at ~120 % of a measured
closed-loop capacity: the primary's queue stays bounded at
TB_ADMIT_QUEUE, a typed ``client_busy`` reaches the client, the scraped
tail exemplars carry the whole stage timeline into a merged Perfetto
view, and SIGTERM leaves a parseable flight dump.  The case runs on the
port and on the reference; its recording holds no reply (the load's
timing decides them), so each run is held to its own assertions.
"""

import torch_repoint as rp

FILE = "test_open_loop_smoke.py"


def test_cases_cover_the_reference_file():
    assert rp.case_names(FILE) == ["test_open_loop_overload_sheds_and_dumps"]


def test_port_replicas_run_the_port():
    text = rp._port_source((rp.TESTS / FILE).read_text())
    runner = text[text.index("_RUNNER = "):text.index('"""\n', text.index("_RUNNER = ") + 14)]
    assert "from tigerbeetle_tpu_torch.runtime.server import ReplicaServer" in runner
    assert "from tigerbeetle_tpu_torch.state_machine import CpuStateMachine" in runner
    assert "tigerbeetle_tpu." not in runner and "tigerbeetle_tpu " not in runner


def test_repointed_open_loop_smoke_matches_reference(tmp_path):
    rp.run_both(FILE, "test_open_loop_overload_sheds_and_dumps", "oracle", tmp_path)
