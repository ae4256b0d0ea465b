"""nvcc build seconds and the first launch of every kernel.

    python -m tigerbeetle_tpu_torch.experiments.tpu_compile_check [--device D] [--quick]

Counterpart of the reference's experiments/tpu_compile_check.py (the
XLA compile and first-call time of the device kernels on the TPU).  On
the card: every source of ``kernels/build.py`` compiled at once, one
``nvcc`` each with the build's own flags, into a fresh directory under
``build/`` (the build's libraries are left alone): each source's
seconds until its nvcc exited, and the wall time of all.  Then, with the
fresh libraries loaded, each kernel's first call (the library's load,
its module's load and the launch) and second call, host ms to a
synchronize, on tools/memsafe.py's first case of the kernel's row.  On
the CPU there is no nvcc: the record holds the plain versions' first
and second calls.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.experiments import common
from tigerbeetle_tpu_torch.kernels import build
from tigerbeetle_tpu_torch.tools import memsafe

KEYS = ("build_s", "build_wall_s", "first_call_ms", "second_call_ms")
# The launchers share K1's, K5's and K6's libraries.
LAUNCHERS = ("scan_of", "staged")


def compile_all(out_dir: Path) -> tuple[dict, float]:
    """Every kernel source compiled at once into `out_dir`: (seconds
    each until its nvcc exited, the wall seconds of all)."""
    procs = {}
    t0 = time.perf_counter()
    for name in build.SOURCES:
        out = out_dir / build.library_path(name).name
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(build.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    seconds = {}
    while len(seconds) < len(procs):
        for name, proc in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
                log = proc.stdout.read().decode()
                common.check(proc.returncode == 0, f"nvcc {name}.cu failed:\n{log}")
        time.sleep(0.01)
    return seconds, time.perf_counter() - t0


def _put(dev):
    return lambda name, t, offset=None: torch.as_tensor(t).to(dev)


def call_times(dev) -> tuple[dict, dict]:
    """Host ms of each kernel row's first and second call."""
    first, second = {}, {}
    for row in memsafe.rows():
        if row.name in LAUNCHERS:
            continue
        case = next(iter(row.cases.values()))
        for out in (first, second):
            common.sync(dev)
            t0 = time.perf_counter()
            case(_put(dev))
            common.sync(dev)
            out[row.name] = (time.perf_counter() - t0) * 1e3
    return first, second


def run(dev, quick: bool = False) -> dict:
    if dev.type != "cuda":
        first, second = call_times(dev)
        return common.record("tpu_compile_check", dev, build_s=None, build_wall_s=None,
                             first_call_ms=first, second_call_ms=second)
    saved = build.BUILD_DIR, dict(build._LOADED), dict(kernels._FNS)
    parent = build.BUILD_DIR.parent
    parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=parent, prefix="compile_check-") as tmp:
        seconds, wall = compile_all(Path(tmp))
        try:
            build.BUILD_DIR = Path(tmp)
            build._LOADED.clear()
            kernels._FNS.clear()
            first, second = call_times(dev)
        finally:
            build.BUILD_DIR = saved[0]
            build._LOADED.clear()
            build._LOADED.update(saved[1])
            kernels._FNS.clear()
            kernels._FNS.update(saved[2])
    return common.record("tpu_compile_check", dev, build_s=seconds, build_wall_s=wall,
                         first_call_ms=first, second_call_ms=second)


main = common.link_main(__doc__, run)

if __name__ == "__main__":
    sys.exit(main())
