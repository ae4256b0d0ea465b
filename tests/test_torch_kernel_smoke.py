"""experiments/kernel_smoke.py's hand-computed cases (the reference's
experiments/kernel_smoke.py, re-cast for the port) on the CPU: the
plain versions of K1, K5 and K6 give the table, the ring summary and
the result codes worked out by hand.  On a card the same cases run
through the kernels (``python -m
tigerbeetle_tpu_torch.experiments.kernel_smoke``, chip_smoke.py's link
phase)."""

import pytest
import torch

from tigerbeetle_tpu_torch.experiments import kernel_smoke


@pytest.mark.parametrize("case", kernel_smoke.CASES, ids=[c.__name__ for c in kernel_smoke.CASES])
def test_hand_computed_case_on_the_plain_versions(case):
    case(torch.device("cpu"))


def test_a_wrong_expectation_fails(monkeypatch):
    monkeypatch.setattr(kernel_smoke, "A", 64)
    real = kernel_smoke.base_pack

    def off_by_one(n, dr, cr, amt, **kw):
        return real(n, dr, cr, [a + 1 for a in amt], **kw)

    monkeypatch.setattr(kernel_smoke, "base_pack", off_by_one)
    with pytest.raises(AssertionError):
        kernel_smoke.orderfree_ok(torch.device("cpu"))
