"""Build the host engine's native library at first use.

``csrc/host/tb_fastpath.cpp`` (with the ``.inc`` files it includes) is
compiled by ``g++`` into ``build/native/libtb_fastpath-<digest>.so`` at
the repository root, where the digest covers every file of
``csrc/host/`` and the flags: an edited source gets a library of its
own and a stale one is never loaded.  The compiler writes a temporary
file that is renamed into place under a file lock, so processes that
race for the library (pytest-xdist workers) build it once.  The flags
are the reference Makefile's, warnings of shadowing and narrowing
promoted to errors.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG.parent / "build" / "native"
MAIN = "tb_fastpath.cpp"

CXX_FLAGS = (
    "-O3", "-fPIC", "-std=c++17", "-shared", "-pthread",
    "-Wall", "-Wextra", "-Wshadow", "-Wconversion",
    "-Werror=shadow", "-Werror=conversion",
)


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the host library's sources."""


def sources(src: Path = HOST_SRC) -> list[Path]:
    return sorted(p for p in src.iterdir() if p.suffix in (".cpp", ".inc"))


def digest(src: Path = HOST_SRC) -> str:
    h = hashlib.sha256()
    for path in sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(src: Path = HOST_SRC, out_dir: Path = BUILD_DIR) -> Path:
    return out_dir / f"libtb_fastpath-{digest(src)}.so"


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("no C++ compiler: g++ not found (set CXX)")
    return cxx


def command(out: Path, src: Path = HOST_SRC) -> list[str]:
    """The compile command: the sources of `src` only (the includes are
    resolved beside the main file), into `out`."""
    return [compiler(), *CXX_FLAGS, "-o", str(out), str(src / MAIN)]


def build(src: Path = HOST_SRC, out_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """The library for the sources of `src`, compiled when missing.
    Returns (path, seconds spent compiling: 0.0 when it was there);
    raises NativeBuildError with the compiler's output when the build
    fails."""
    out = library_path(src, out_dir)
    if out.is_file():
        return out, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # another process built it while we waited
            return out, 0.0
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(command(tmp, src), capture_output=True, text=True)
        except OSError as exc:
            raise NativeBuildError(f"cannot run the compiler: {exc}") from exc
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        (out_dir / f"{out.stem}.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ {src / MAIN} (rc {proc.returncode}):\n{log}"
            )
        os.replace(tmp, out)
    return out, seconds
