"""The port's source hygiene against the reference's.

tests/test_tidy.py re-pointed (tests/torch_repoint.py): no line of a
``.py`` file under ``tigerbeetle_tpu_torch/`` is over 100 columns (the
reference's tidy.zig limit), run over the port's package and over the
reference's.
"""

import torch_repoint as rp

FILE = "test_tidy.py"


def test_cases_cover_the_reference_file():
    assert rp.case_names(FILE) == ["test_line_length_limit"]


def test_repointed_line_length_limit_matches_reference(tmp_path):
    port = rp.load(FILE, rp.PORT)
    assert port.ROOT.endswith("tigerbeetle_tpu_torch")
    rp.run_both(FILE, "test_line_length_limit", "oracle", tmp_path)
