"""What the port's tbcheck tests share: the reference's cases, run on
each package against a private copy of the fixtures directory.

tests/test_tbcheck.py writes and deletes fixed names under
tests/tbcheck_fixtures/ (``_tmp_snippet.py``, ``_tmp_broken.py``, ...).
A re-pointed copy running in another xdist worker at the same time as
the reference file would write and delete the same files, so each
re-pointed case runs with the loaded module's ``FIXTURES`` pointed at a
copy of that directory under the case's own tmp_path.  The reference
file itself is left as it is.
"""

import functools
import shutil

import torch_repoint as rp

FILE = "test_tbcheck.py"
NOT_PORTED: set = set()
# Cases that lint the whole package (several seconds each).
WHOLE_PACKAGE = (
    "test_repo_is_clean", "test_repo_suppressions_all_carry_reasons",
    "test_single_file_run_matches_full_run", "test_directory_argument_expands",
    "test_import_graph_sim_reachable_set", "test_cli_end_to_end_json_schema",
)

_REPO_RESULTS: dict = {}


def _repo_result(package: str):
    """What the module-scoped `repo_result` fixture gives: one full
    run_lint of `package`, shared by the cases of this process."""
    if package not in _REPO_RESULTS:
        _REPO_RESULTS[package] = rp.load(FILE, package).run_lint()
    return _REPO_RESULTS[package]


def run_both(case: str, tmp_path, monkeypatch, extra=None) -> None:
    """`case` on the port and on the reference (tests/torch_repoint.py),
    both against one copy of the fixtures under tmp_path, each with its
    own package's `repo_result`."""
    fixtures = tmp_path / "tbcheck_fixtures"
    shutil.copytree(rp.TESTS / "tbcheck_fixtures", fixtures)
    for package in (rp.PORT, rp.REF):
        mod = rp.load(FILE, package)
        monkeypatch.setattr(mod, "FIXTURES", str(fixtures))
        monkeypatch.setattr(mod, "repo_result", functools.partial(_repo_result, package))
    (tmp_path / "runs").mkdir()
    rp.run_both(FILE, case, "oracle", tmp_path / "runs", extra)
