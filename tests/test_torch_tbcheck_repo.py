"""tbcheck over the port's whole package, against the reference's over its own.

tests/test_tbcheck.py's whole-package cases re-pointed
(tests/torch_repoint.py, tests/torch_tbcheck.py): the port's package
lints clean with every suppression reasoned and used, a one-file run
(runtime/router.py) and a directory run (vsr/) keep the full run's
import-graph position, the sim-reachable set holds the consensus, state
machine and storage modules (runtime.follower and vsr.aof among them)
and leaves the CLI tools out, and `python -m tigerbeetle_tpu_torch lint
--json` exits 0 with no findings.
"""

import pytest

import torch_tbcheck as tt


@pytest.mark.parametrize("case", tt.WHOLE_PACKAGE, ids=[c[5:] for c in tt.WHOLE_PACKAGE])
def test_repointed_case_matches_reference(case, tmp_path, monkeypatch):
    tt.run_both(case, tmp_path, monkeypatch)


def test_port_lint_covers_the_whole_package():
    """The port's lint checks at least the 104 files it checked when it
    was first run over the package, and sees the follower inside the
    determinism scope."""
    result = tt._repo_result(tt.rp.PORT)
    assert result.findings == []
    assert result.checked_files >= 104
    assert {"tigerbeetle_tpu_torch.runtime.follower",
            "tigerbeetle_tpu_torch.vsr.aof"} <= result.sim_modules
