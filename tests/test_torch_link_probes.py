"""The H100 link probes (tigerbeetle_tpu_torch/experiments/, one for each
of the reference's TPU-link probes) run on the CPU at their quick size:
each main prints the device line and one JSON record holding its probe's
name, the device and every key of the probe's KEYS.  Structure only: a
CPU run says nothing of a card, and no time is checked here."""

import importlib
import json

import pytest

PROBES = ("lat_probe", "xfer_probe", "pipe_probe", "notify_probe", "steady_probe",
          "h2d_probe", "nodonate_probe", "variant_probe", "d2h_probe", "pull_probe",
          "burst_probe", "kernprof_probe", "staged_probe", "ablate_probe", "xprof_probe",
          "tpu_compile_check", "kernel_smoke")


def test_every_reference_link_probe_has_a_counterpart():
    from pathlib import Path

    ref = Path(__file__).resolve().parent.parent / "experiments"
    # The bench-twin probes wait for the port's benchmark; the rest of
    # the reference's experiments/ were ported earlier (test_torch_experiments.py).
    later = {"engine_diff.py", "engine_perf.py", "writeamp_probe.py"}
    earlier = {"kernel_time_probe.py", "kernel_time_probe2.py", "scan_kinds_probe.py",
               "scan_probe.py", "scan_resident_probe.py", "stage_sweep.py",
               "staged_prod_probe.py"}
    names = {p.name for p in ref.glob("*.py")} - later - earlier
    assert names == {f"{p}.py" for p in PROBES}


@pytest.mark.parametrize("name", PROBES)
def test_probe_record_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"tigerbeetle_tpu_torch.experiments.{name}")
    assert mod.main(["--device", "cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device cpu (no card)"
    rec = json.loads(lines[-1])
    assert rec["device"] == "cpu"
    assert rec["probe"] == name.removesuffix("_probe")
    missing = set(mod.KEYS) - rec.keys()
    assert not missing, missing
