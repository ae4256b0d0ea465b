"""The port's speculative wave execution against the reference's.

tests/test_speculate.py re-pointed (tests/torch_repoint.py), on the
unsharded device engine of ``TorchStateMachine(device="cpu")`` against
``TpuStateMachine`` (table sizes 65, 2^12 + 1 and 2^10 + 1: none divides
by the suite's eight virtual devices): K9's plain version held to the
reference's ``waves._spec_conflicts`` (the recordings keep every call's
flags) and to the partitioner's round 0,
the prefix-commit rule, the speculative record codec, the acceptance
shapes (fresh batches in one step, finalizer residue, the residue-cap
gate, forced chain residue), the forced-optimistic differential against
the oracle, and the chaos smoke with speculation forced on.  Each case
runs on the port and on the reference, and the two recordings (every
harness op with its reply, each machine's state root, the K9 flags) are
equal.

The port's step writes the table in place, so a transient fault after it
must not run it again (the chaos smoke found this; ROADMAP queue 3):
pinned on the port alone, with one fault on the flags' fetch and one on
the finish.
"""

import pytest

import torch_repoint as rp
from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch.state_machine import device_engine as de
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.state_machine.cpu import CpuStateMachine
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import harness as hz
from tigerbeetle_tpu_torch.testing.chaos import ChaosLink
from tigerbeetle_tpu_torch.types import Operation
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

FILE = "test_speculate.py"
CASES = rp.case_names(FILE)
SEEDED = {"test_spec_conflicts_match_partitioner_round0": range(8),
          "test_forced_optimistic_differential": (21, 22)}
PARAMS = [(c, s) for c in CASES for s in SEEDED.get(c, (None,))]


def test_cases_cover_the_reference_file():
    assert len(CASES) == 9


def test_port_run_hands_the_port_numpy():
    text = rp._port_source((rp.TESTS / FILE).read_text())
    assert "import jax" not in text
    assert "waves._spec_conflicts(" not in text
    assert f"_torch_repoint.spec_conflicts({rp.PORT!r}, " in text


@pytest.mark.parametrize("case,seed", PARAMS,
                         ids=[c[5:] + ("" if s is None else f"-{s}") for c, s in PARAMS])
def test_repointed_case_matches_reference(case, seed, tmp_path):
    got = rp.run_both(FILE, case, "oracle", tmp_path, None if seed is None else {"seed": seed})
    if case == "test_spec_conflicts_match_partitioner_round0":
        # Six batches, each one's flags equal to the reference's K9.
        assert len(got[0]["spec_flags"]) == 6


class _FaultAfterStep(ChaosLink):
    """A link that raises one transient fault on the crossing right
    after a speculative step: the flags' fetch, or the finish's
    dispatch."""

    def __init__(self, target: str) -> None:
        super().__init__(seed=0)
        self.target = target
        self.armed = False

    def stepped(self) -> None:
        if self.armed:
            self.armed = False
            self.fail_next("fetch" if self.target == "fetch" else "dispatch", "transient")


@pytest.mark.parametrize("target", ["fetch", "finish"])
def test_transient_fault_after_the_step_does_not_rerun_it(target, monkeypatch):
    """The port's speculative step writes the table in place: a
    transient fault on the flags' fetch or on the finish is reissued
    alone, and the step runs once (ROADMAP queue 3, PR 24)."""
    monkeypatch.setattr(de, "_WINDOW", 1)
    monkeypatch.setattr(de, "_BACKOFF_MS", 0.0)
    monkeypatch.setenv("TB_WAVES_SPECULATE", "force")
    link = _FaultAfterStep(target)
    step = waves.run_speculative_engine

    def counted_step(*args, **kwargs):
        out = step(*args, **kwargs)
        link.stepped()
        return out

    monkeypatch.setattr(waves, "run_speculative_engine", counted_step)
    sm = TorchStateMachine(cfg.TEST_MIN, account_capacity=(1 << 10) + 1, device="cpu",
                           engine="device", device_link=link)
    pair = (hz.SingleNodeHarness(sm), hz.SingleNodeHarness(CpuStateMachine()))
    accounts = hz.pack([hz.account(i) for i in range(1, 9)])
    rows = [hz.transfer(100 + k, debit_account_id=1 + k % 4, credit_account_id=5 + k % 4,
                        amount=3 + k) for k in range(12)]
    ops = [(Operation.create_accounts, accounts)]
    for _ in range(2):
        ops.append((Operation.create_transfers, hz.pack(rows)))
        rows = [hz.transfer(200 + k, debit_account_id=5 + k % 4, credit_account_id=1 + k % 4,
                            amount=1 + k) for k in range(12)]
    ops.append((Operation.lookup_accounts, hz.ids_bytes(list(range(1, 9)))))
    link.armed = True
    for op, body in ops:
        assert pair[0].submit(op, body) == pair[1].submit(op, body), op.name
    assert sm._dev.spec_stats["attempts"] == 2
    assert (link.stat_transient, sm._dev.stat_retries, sm._dev.stat_demotions) == (1, 1, 0)
    assert sm.state_root() == pair[1].sm.state_root()
    sm.verify_device_mirror()
