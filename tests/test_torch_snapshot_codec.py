"""The port's checkpoint codec against the reference's.

tests/test_snapshot_codec.py re-pointed (tests/torch_repoint.py):
``utils/snapshot.py``'s round trip of every type, its canonical bytes,
its checksum, truncation, magic, dtype, duplicate-key and size checks;
``test_no_pickle_in_durable_paths`` over the port's ``vsr/``,
``state_machine/`` and ``lsm/``; and both machines' snapshots decoded
and restored (in the port's run the oracle and
``TorchStateMachine(device="cpu")``).  Each case runs on the port and on
the reference, and the two recordings are equal.
"""

import pytest

import torch_repoint as rp

FILE = "test_snapshot_codec.py"
CASES = rp.case_names(FILE)


def test_cases_cover_the_reference_file():
    assert len(CASES) == 11


def test_pickle_scan_reads_the_port():
    text = rp._port_source((rp.TESTS / FILE).read_text())
    assert '/ "tigerbeetle_tpu_torch"' in text


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path):
    rp.run_both(FILE, case, "oracle", tmp_path)
