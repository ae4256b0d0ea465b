"""The port's component fuzzers and soak orchestrator against the
reference's.

tests/test_fuzzers.py re-pointed at the port (tests/torch_repoint.py):
every fuzzer of the port's testing/fuzz.py FUZZERS (ewah, snapshot,
free_set, journal, superblock, tree, manifest_log) at SMOKE_ROUNDS on
seeds 1 and 77, `python -m tigerbeetle_tpu_torch.testing.fuzz ewah`, and
`python -m tigerbeetle_tpu_torch.testing.soak all --n 2` (one VOPR case
and one fuzzer case, JSONL records, no failure).  Each case runs on the
port and again on the reference, and both pass its checks.  Plus: the
two registries name the same fuzzers, and the soak draws the same cases
from the same seed.
"""

import random

import pytest

import torch_repoint as rp
from tigerbeetle_tpu.testing import fuzz as ref_fuzz
from tigerbeetle_tpu.testing import soak as ref_soak
from tigerbeetle_tpu_torch.testing import fuzz, soak

SMOKE = [(name, seed) for seed in (1, 77) for name in sorted(fuzz.FUZZERS)]


@pytest.mark.parametrize("name,seed", SMOKE, ids=[f"{n}-{s}" for n, s in SMOKE])
def test_repointed_fuzz_smoke_matches_reference(name, seed, tmp_path):
    rp.run_both("test_fuzzers.py", "test_fuzz_smoke", "oracle", tmp_path,
                {"name": name, "seed": seed})


@pytest.mark.parametrize("case", ["test_fuzz_cli_entry_point", "test_soak_cli_entry_point"])
def test_repointed_entry_point_matches_reference(case, tmp_path):
    rp.run_both("test_fuzzers.py", case, "oracle", tmp_path)


def test_registries_and_soak_cases_match_reference():
    assert sorted(fuzz.FUZZERS) == sorted(ref_fuzz.FUZZERS)
    assert fuzz.SMOKE_ROUNDS == ref_fuzz.SMOKE_ROUNDS
    for make, ref_make in ((soak._vopr_case, ref_soak._vopr_case),
                           (soak._fuzz_case, ref_soak._fuzz_case)):
        a, b = random.Random(5), random.Random(5)
        assert [make(a) for _ in range(20)] == [ref_make(b) for _ in range(20)]
