"""The port's follower knobs and its envcheck audit against the reference's.

tests/test_envcheck.py's follower reader cases re-pointed
(tests/torch_repoint.py): TB_ROOT_RING, TB_READ_POLICY,
TB_READ_STALENESS_OPS, TB_FOLLOWER_ATTEST_MS, TB_FOLLOWER_ROOT_RING,
TB_READ_FALLBACK_MS, TB_TENANT_RATE_BYTES and TB_FOLLOWER_ATTEST_MAX_MS,
each with its bounds and its named errors; and
test_no_tb_knob_bypasses_envcheck, the tbcheck envcheck rule run over
each package (the port's: no TB_* or BENCH_* knob is read past
envcheck.py).
"""

import pytest

import torch_repoint as rp

FILE = "test_envcheck.py"
# The reference file's "Root-attested follower serving" section, in order.
FOLLOWER_CASES = [
    "test_tb_root_ring_validated", "test_tb_read_policy_validated",
    "test_tb_read_staleness_ops_validated", "test_tb_follower_attest_ms_validated",
    "test_tb_follower_root_ring_named_constraint", "test_tb_read_fallback_ms_validated",
    "test_tb_tenant_rate_bytes_validated", "test_tb_follower_attest_max_ms_validated",
]
CASES = [*FOLLOWER_CASES, "test_no_tb_knob_bypasses_envcheck"]


def test_follower_section_names_the_readers():
    names = rp.case_names(FILE)
    start = names.index(FOLLOWER_CASES[0])
    assert names[start:start + len(FOLLOWER_CASES)] == FOLLOWER_CASES
    assert "test_no_tb_knob_bypasses_envcheck" in names


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path):
    rp.run_both(FILE, case, "oracle", tmp_path)
