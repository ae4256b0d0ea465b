"""The port's create_accounts precedence ladders against the reference's.

tests/test_create_accounts.py re-pointed (tests/torch_repoint.py): every
case over an ``sm`` of the port (its CPU oracle, ``state_machine/cpu.py``,
and ``TorchStateMachine(device="cpu")`` on the host and on the device
engine) and over the reference's on the same arm (``CpuStateMachine``,
``TpuStateMachine`` on that engine), at 2^10 + 3 account rows (not a
multiple of the suite's eight virtual devices).  Each case passes its
own assertions in both packages, and every harness op's reply and each
machine's state root are equal.  tests/conftest.py's ``sm`` fixture is
not used.
"""

import pytest

import torch_repoint as rp
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

FILE = "test_create_accounts.py"
CASES = rp.case_names(FILE)
ARMS = ("oracle", "host", "device")


def test_cases_cover_the_reference_file():
    assert len(CASES) == 12


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, arm, tmp_path):
    rp.run_both(FILE, case, "oracle", tmp_path,
                per_package={"sm": lambda package: rp.machine(package, arm)})
