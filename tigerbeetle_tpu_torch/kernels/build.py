"""Build the hand-written CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes).  Libraries
land in ``build/kernels/`` at the repository root, named by a hash of
their source and of the shared headers (``csrc/*.cuh``), so an edited
source or header is rebuilt and a stale library is never loaded.  All
missing libraries are compiled in parallel, one ``nvcc`` process per
source, under a file lock in ``build/kernels/``:
processes that start together on a cold tree (the replicas of a
cluster, pytest-xdist workers) build each library once, the later ones
waiting for the first and finding its libraries.  Each ``nvcc`` writes
a temporary file that is renamed into place.  The measurement probes
under ``tools/`` (``src=TOOLS``) build the same way; they are not
kernels of the port.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
TOOLS = _PKG / "tools"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("orderfree", "commitment", "exact_scan", "apply_deltas", "linked", "two_phase",
           "wave_step", "chain_wave", "spec_conflicts", "tier", "checksum", "shard_apply",
           "shard_rows")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--ptxas-options=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str, src: Path = CSRC) -> Path:
    digest = hashlib.sha256((src / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a shared header rebuilds its includers
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtb_{name}-{digest.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def build_all(names=SOURCES, src: Path = CSRC) -> dict[str, float]:
    """Compile every named source whose library is missing, all nvcc
    processes started together.  Returns seconds per compiled source
    (empty when everything was already built); raises KernelBuildError
    with nvcc's output on the first failure."""
    if all(library_path(n, src).is_file() for n in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # Another process may have built them while this one waited.
        todo = [n for n in names if not library_path(n, src).is_file()]
        return _compile(todo, src) if todo else {}


def _compile(todo, src: Path) -> dict[str, float]:
    compiler = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name, src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    seconds = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return seconds


def load(name: str, src: Path = CSRC) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,), src)
        lib = ctypes.CDLL(str(library_path(name, src)))
        _LOADED[name] = lib
    return lib
