"""The launcher probes (tigerbeetle_tpu_torch/experiments/) run on the CPU
at a small table: each main() prints the device line, its per-batch
lines and the line of its final check (the table and ring equal a
batch-by-batch run of the same launches), and returns 0.  The final
check is shown to fail on a run that read another batch than it
recorded."""

import importlib

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

PROBES = ("scan_kinds_probe", "scan_resident_probe", "scan_probe", "stage_sweep",
          "staged_prod_probe", "kernel_time_probe", "kernel_time_probe2")


@pytest.mark.parametrize("name", PROBES)
def test_probe_runs_and_its_check_holds(name, capsys):
    mod = importlib.import_module(f"tigerbeetle_tpu_torch.experiments.{name}")
    assert mod.main(["--device", "cpu", "--rows", "4096", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device cpu (no card)"
    assert lines[-1].startswith("check: ") and "bit for bit" in lines[-1]
    assert sum("us/batch" in line and "events/s" in line for line in lines) >= 2


def test_verify_refuses_a_run_that_read_another_batch():
    dev = torch.device("cpu")
    kind, G = "orderfree_lo", 2
    table, meta, ring = common.tables(64, dev)
    sup = common.upload(common.superbatch(kind, 64, G), dev)
    tape = common.Tape("wrong batch", table, meta, ring)
    dk.orderfree_lo_staged(table, meta, ring, 0, sup, 1, common.N, 1)
    tape.staged(kind, 0, sup, 0, common.N, 1)  # records batch 0, ran batch 1
    tape.close(table, ring)
    with pytest.raises(AssertionError, match="differs from a batch-by-batch run"):
        common.verify([tape])


def test_probe_batches_differ_and_fit_the_table():
    for kind, (cols, dtype) in dk.PK_SPEC.items():
        stack = common.probe_stack(kind, 4096, 2)
        assert stack.shape == (2, dk.B, cols) and stack.dtype == dtype
        assert not np.array_equal(stack[0], stack[1])
