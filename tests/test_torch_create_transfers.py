"""The port's create_transfers precedence ladders against the reference's.

tests/test_create_transfers.py re-pointed (tests/torch_repoint.py): every
case over an ``sm`` of the port (its CPU oracle, ``state_machine/cpu.py``,
and ``TorchStateMachine(device="cpu")`` on the host and on the device
engine) and over the reference's on the same arm (``CpuStateMachine``,
``TpuStateMachine`` on that engine), at 2^10 + 3 account rows (not a
multiple of the suite's eight virtual devices).  Each case passes its
own assertions in both packages, and every harness op's reply and each
machine's state root are equal.  tests/conftest.py's ``sm`` fixture is
not used.

``test_overflow_beats_overflows_timeout`` on the device engine is held
to the reference's by its failure: the reference's own device engine
answers ``overflows_timeout`` there, where its oracle answers
``overflows_debits_pending`` (its suite runs the case on the host engine
only).  Both packages must fail the same assertion with equal
recordings, so the port's device engine answers as the reference's
does (ROADMAP queue 3).
"""

import struct

import pytest

import torch_repoint as rp
from tigerbeetle_tpu_torch.types import CreateTransferResult
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

FILE = "test_create_transfers.py"
CASES = rp.case_names(FILE)
ARMS = ("oracle", "host", "device")
# (case, arm) the reference's own machine fails: ROADMAP queue 3.
NOT_PORTED = {("test_overflow_beats_overflows_timeout", "device")}
PARAMS = [(c, a) for c in CASES for a in ARMS if (c, a) not in NOT_PORTED]


def test_cases_cover_the_reference_file():
    assert len(CASES) == 16


def test_the_left_out_case_still_fails_on_the_reference(tmp_path):
    """The reference's device engine ranks overflows_timeout first, and
    the port's does the same: both fail the case's last assertion, with
    the same replies and state roots.  Once the reference passes, the
    case joins the matrix."""
    case = "test_overflow_beats_overflows_timeout"
    got = rp.run_both(FILE, case, "oracle", tmp_path, fails=True,
                      per_package={"sm": lambda package: rp.machine(package, "device")})
    text = (rp.TESTS / FILE).read_text().splitlines()
    line = got[0]["failure"][0]
    statement = "\n".join(text[line - 1:line + 2])
    assert statement.lstrip().startswith("assert h.create_transfers(")
    assert "CTR.overflows_debits_pending" in statement, statement
    reply = got[0]["harnesses"][0][0][-1][2]  # the last op's: (index, result) u32 pairs
    assert reply == struct.pack("<II", 0, CreateTransferResult.overflows_timeout)


@pytest.mark.parametrize("case,arm", PARAMS, ids=[f"{c[5:]}-{a}" for c, a in PARAMS])
def test_repointed_case_matches_reference(case, arm, tmp_path):
    rp.run_both(FILE, case, "oracle", tmp_path,
                per_package={"sm": lambda package: rp.machine(package, arm)})
