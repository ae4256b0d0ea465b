"""tests/test_vopr.py::test_vopr_deep_slice[8002, 8003] re-pointed at the port
(800 requests with sector corruption, the upgrade nemesis on even
seeds), as in tests/test_torch_vopr.py.  The six seeds of the slice are
spread over test_torch_vopr_deep_a.py, _b.py and _c.py (~35 s a seed
on both packages)."""

import pytest

import torch_repoint as rp


@pytest.mark.parametrize("seed", [8002, 8003])
def test_repointed_deep_slice_matches_reference(seed, tmp_path):
    rp.run_both("test_vopr.py", "test_vopr_deep_slice", "oracle", tmp_path, {"seed": seed})
