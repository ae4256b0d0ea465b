"""The port's request anatomy and flight recorder against the reference's.

tests/test_anatomy.py re-pointed (tests/torch_repoint.py): the wire's
trace context (header round trip, copy into a prepare, untraced headers
bit-identical to the legacy layout), ``obs/anatomy.py``'s
``AnatomyRecorder`` (stage timelines, tail exemplars, bounded rings,
the disabled registry), ``obs/flight.py``'s ``FlightRecorder`` (bounded
ring, trigger dumps, the tracer's instants, the Perfetto merge), and the
trace context carried end to end through a ``Cluster`` with its shed
and dedupe gates.  Each case runs on the port and on the reference, and
the two recordings are equal.
"""

import pytest

import torch_repoint as rp

FILE = "test_anatomy.py"
CASES = rp.case_names(FILE)


def test_cases_cover_the_reference_file():
    assert len(CASES) == 18


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path):
    rp.run_both(FILE, case, "oracle", tmp_path)
