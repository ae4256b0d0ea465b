"""The port's tenant QoS (qos.py) against the reference's.

Every case of tests/test_qos.py, re-pointed at the port
(tests/torch_repoint.py): token buckets, weighted-fair drain, rate
windows, the busy payload, tenant derivation, and the cluster cases
(TB_TENANT_QOS on and off bit-identical under non-overload, sheds and
retransmits, the drain's interleave, the client's busy backoff).  Each
runs on the port and on the reference; their clusters must record equal
replies, HashLog digests and storage images.
"""

import pytest

import torch_repoint as rp

PARAMS = {"test_tenant_qos_bounded_tenant_state": [{"rate": 1.0}, {"rate": 0.0}]}
CASES = [
    (c, p) for c in rp.case_names("test_qos.py") for p in PARAMS.get(c, [{}])
]


@pytest.mark.parametrize(
    "case,params", CASES,
    ids=[c[5:] + "".join(f"-{k}{v}" for k, v in p.items()) for c, p in CASES],
)
def test_repointed_case_matches_reference(case, params, tmp_path):
    rp.run_both("test_qos.py", case, "oracle", tmp_path, dict(params))
