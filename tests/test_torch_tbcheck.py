"""tbcheck over the port against the reference's: the rules and their units.

tests/test_tbcheck.py's cases re-pointed (tests/torch_repoint.py), each
run with the port's analysis/ over the port's package and with the
reference's over its own, against a private copy of the fixtures
(tests/torch_tbcheck.py): every rule's known-bad fixture flags on its
lines and its good twin is clean, the old tidy patterns and the hash
knobs' aliases are caught, suppressions need a reason and a use, the
import graph's name and relative-import resolution, the wire layout
derived from vsr/wire.py, and the CLI's exit codes and JSON schema on
findings, and TB_NATIVE_SANITIZE=msan surfacing as its EnvVarError
through the machine (in the port's run ``TorchStateMachine(cfg.TEST_MIN,
device="cpu")`` in a subprocess).  The cases that lint the whole package
are in test_torch_tbcheck_repo.py.
"""

import pytest

import torch_repoint as rp
import torch_tbcheck as tt

CASES = [
    c for c in rp.case_names(tt.FILE)
    if c not in tt.NOT_PORTED and c not in tt.WHOLE_PACKAGE
    and c not in ("test_known_bad_fixture_flags", "test_known_good_twin_is_clean")
]
_PARAMS = {
    case: next(m for m in getattr(rp.load(tt.FILE, rp.REF), case).pytestmark
               if m.name == "parametrize").args[1]
    for case in ("test_known_bad_fixture_flags", "test_known_good_twin_is_clean")
}
FIXTURE_CASES = [(case, name) for case, names in _PARAMS.items() for name in names]


def test_cases_cover_the_reference_file():
    names = set(CASES) | set(_PARAMS) | tt.NOT_PORTED | set(tt.WHOLE_PACKAGE)
    assert names == set(rp.case_names(tt.FILE))
    assert len(FIXTURE_CASES) == 15


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path, monkeypatch):
    tt.run_both(case, tmp_path, monkeypatch)


@pytest.mark.parametrize("case,name", FIXTURE_CASES,
                         ids=[f"{c[5:]}-{n[:-3]}" for c, n in FIXTURE_CASES])
def test_repointed_fixture_case_matches_reference(case, name, tmp_path, monkeypatch):
    tt.run_both(case, tmp_path, monkeypatch, {"name": name})
