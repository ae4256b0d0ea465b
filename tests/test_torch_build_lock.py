"""kernels/build.py builds each CUDA library once when processes race.

The replicas of a cluster start together on a cold build/: each imports
the port and builds the kernel libraries it needs.  Here a stub compiler
stands in for nvcc (CUDA_HOME points at it): it logs each library it is
asked to build, sleeps so the builds overlap, and writes the output.
Four processes build the same three sources at once; each library must
be compiled exactly once, and every process must find all three.  A
failing compile raises with the compiler's output and leaves the lock
free for the next build.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tigerbeetle_tpu_torch.kernels import build

REPO = Path(__file__).resolve().parent.parent
NAMES = ("alpha", "beta", "gamma")

STUB = """#!/bin/sh
out=""
src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *.cu) src="$1"; shift ;;
    *) shift ;;
  esac
done
if grep -q FAIL "$src"; then echo "stub: refusing $src"; exit 3; fi
echo "$(basename "$src")" >> "$STUB_LOG"
sleep 0.4
echo built > "$out"
"""


@pytest.fixture()
def stub(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STUB)
    nvcc.chmod(0o755)
    src = tmp_path / "src"
    src.mkdir()
    for name in NAMES:
        (src / f"{name}.cu").write_text(f"// {name}\n")
    log = tmp_path / "compiled.log"
    log.touch()
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("STUB_LOG", str(log))
    return src, tmp_path / "out", log


def _child(src: Path, out: Path) -> str:
    return (
        "import sys\n"
        "from pathlib import Path\n"
        "from tigerbeetle_tpu_torch.kernels import build\n"
        f"build.BUILD_DIR = Path({str(out)!r})\n"
        f"built = build.build_all({NAMES!r}, src=Path({str(src)!r}))\n"
        f"assert all(build.library_path(n, Path({str(src)!r})).is_file() for n in {NAMES!r})\n"
        "print(sorted(built))\n"
    )


def test_racing_processes_build_each_library_once(stub):
    src, out, log = stub
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen([sys.executable, "-c", _child(src, out)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    results = [p.communicate(timeout=120) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
    assert sorted(log.read_text().split()) == sorted(f"{n}.cu" for n in NAMES)
    # One process compiled all three (one nvcc each, started together);
    # the others found them built.
    built = sorted(stdout.strip() for stdout, _ in results)
    assert built == sorted(["[]"] * 3 + [str(sorted(NAMES))])
    assert not list(out.glob("*.tmp"))


def test_failed_compile_raises_with_output_and_frees_the_lock(stub, monkeypatch):
    src, out, log = stub
    monkeypatch.setattr(build, "BUILD_DIR", out)
    (src / "beta.cu").write_text("// FAIL\n")
    with pytest.raises(build.KernelBuildError, match="stub: refusing"):
        build.build_all(NAMES, src=src)
    assert not build.library_path("beta", src).is_file()
    (src / "beta.cu").write_text("// beta, repaired\n")
    assert sorted(build.build_all(NAMES, src=src)) == ["beta"]
    assert all(build.library_path(n, src).is_file() for n in NAMES)
