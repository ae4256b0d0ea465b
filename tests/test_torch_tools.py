"""The port's tools against the reference's: StatsD, the tracer, AOF and
grid scrubber, the REPL, the in-process benchmark, the bindings, the
foreign clients' fixtures, and the trace merge and demo.

Re-pointed at the port (tests/torch_repoint.py), each case on the port
and again on the reference:
- tests/test_aux.py, every case;
- tests/test_runtime.py's test_repl_statements, test_repl_run_stream and
  test_benchmark_smoke (the in-process replica on the oracle, --cpu);
- tests/test_foreign_clients.py, every case: the frame and demux
  fixtures, the generated types against the committed clients/, the
  server's handling of a malformed request and the conversation replay;
  the Go, Node, Java and .NET runs skip without their toolchains, as
  they do on the reference;
- tests/test_obs.py's trace-merge and trace-demo cases.
"""

import pytest

import torch_repoint as rp

CASES = (
    [("test_aux.py", c) for c in rp.case_names("test_aux.py")]
    + [("test_runtime.py", c) for c in (
        "test_repl_statements", "test_repl_run_stream", "test_benchmark_smoke")]
    + [("test_foreign_clients.py", c) for c in rp.case_names("test_foreign_clients.py")]
    + [("test_obs.py", c) for c in (
        "test_merge_traces_builds_one_perfetto_timeline",
        "test_trace_demo_produces_cross_replica_drain",
        "test_merge_traces_skips_bad_files_and_warns",
        "test_merge_traces_many_replicas")]
)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native libraries loaded (tests/torch_repoint.py)."""
    rp.reference_native_loaded()


@pytest.mark.parametrize("test_file,case", CASES, ids=[f"{f[5:-3]}-{c[5:]}" for f, c in CASES])
def test_repointed_case_matches_reference(test_file, case, tmp_path, capsys):
    rp.run_both(test_file, case, "oracle", tmp_path, {"capsys": capsys})
