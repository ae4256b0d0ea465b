"""Build the port's native host libraries at first use.

Two libraries come from ``csrc/host/``, each compiled by ``g++`` into
``build/native/libtb_<name>-<digest>.so`` at the repository root:

- ``fastpath``: ``tb_fastpath.cpp`` (with the ``.inc`` files it
  includes: the host engine's commit path, the LSM merge, the server
  drain's frame verify and reply finalize) and ``tb_pipeline.cpp`` (the
  VSR commit pipeline), with the hash pool of ``hash_pool.h`` /
  ``sha256.h``;
- ``runtime``: ``tb_runtime.cpp`` and ``tb_async.cpp`` (the epoll loop,
  the header-framed TCP bus and the C-ABI client of ``tb_client.h``).

The digest covers every file of ``csrc/host/``, the library's name and
the flags: an edited source gets a library of its own and a stale one is
never loaded.  The sanitizer flavour (``sanitize="asan"``, which the
loaders take from TB_NATIVE_SANITIZE) adds the reference Makefile's
``SANFLAGS`` and builds into ``build/native/asan/``, so a sanitized and
a plain library never share a path; a failed build names the flavour.
The compiler writes a temporary file that is renamed into place under a
file lock, so processes that race for a library (pytest-xdist workers,
replicas started together) build it once.  The flags are
the reference Makefile's, warnings of shadowing and narrowing promoted
to errors.
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
# Library name -> its translation units (the includes are resolved
# beside them).
LIBRARIES = {
    "fastpath": (MAIN, "tb_pipeline.cpp"),
    "runtime": ("tb_runtime.cpp", "tb_async.cpp"),
}

CXX_FLAGS = (
    "-O3", "-fPIC", "-std=c++17", "-shared", "-pthread",
    "-Wall", "-Wextra", "-Wshadow", "-Wconversion",
    "-Werror=shadow", "-Werror=conversion",
)
LINK_FLAGS = ("-ldl",)
# The reference Makefile's SANFLAGS: address + undefined behaviour,
# frame pointers kept for readable reports, -g for symbolized stacks.
SANFLAGS = ("-fsanitize=address,undefined", "-fno-omit-frame-pointer", "-g")
FLAVOURS = ("", "asan")


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the host library's sources."""


def sources(src: Path = HOST_SRC) -> list[Path]:
    return sorted(p for p in src.iterdir() if p.suffix in (".cpp", ".inc", ".h"))


def flags(sanitize: str = "") -> tuple[str, ...]:
    """The compile flags of flavour `sanitize` ("" or "asan")."""
    if sanitize not in FLAVOURS:
        raise ValueError(f"unknown sanitizer flavour {sanitize!r}")
    return (*CXX_FLAGS, *SANFLAGS) if sanitize else CXX_FLAGS


def digest(src: Path = HOST_SRC, name: str = "fastpath", sanitize: str = "") -> str:
    h = hashlib.sha256()
    for path in sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join((name, *flags(sanitize), *LINK_FLAGS)).encode())
    return h.hexdigest()[:12]


def library_path(src: Path = HOST_SRC, out_dir: Path = BUILD_DIR,
                 name: str = "fastpath", sanitize: str = "") -> Path:
    flavour_dir = out_dir / sanitize if sanitize else out_dir
    return flavour_dir / f"libtb_{name}-{digest(src, name, sanitize)}.so"


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("no C++ compiler: g++ not found (set CXX)")
    return cxx


def command(out: Path, src: Path = HOST_SRC, name: str = "fastpath",
            sanitize: str = "") -> list[str]:
    """The compile command of library `name`: its translation units in
    `src` only (the includes are resolved beside them), into `out`."""
    units = [str(src / unit) for unit in LIBRARIES[name]]
    return [compiler(), *flags(sanitize), "-o", str(out), *units, *LINK_FLAGS]


def build(src: Path = HOST_SRC, out_dir: Path = BUILD_DIR,
          name: str = "fastpath", sanitize: str = "") -> tuple[Path, float]:
    """Library `name` of flavour `sanitize` for the sources of `src`,
    compiled when missing.  Returns (path, seconds spent compiling: 0.0
    when it was there); raises NativeBuildError with the compiler's
    output, naming the flavour, when the build fails."""
    out = library_path(src, out_dir, name, sanitize)
    if out.is_file():
        return out, 0.0
    out_dir = out.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    flavour = f"sanitizer={sanitize or 'none'}"
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():  # another process built it while we waited
            return out, 0.0
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(command(tmp, src, name, sanitize), capture_output=True,
                                  text=True)
        except OSError as exc:
            raise NativeBuildError(f"cannot run the compiler ({flavour}): {exc}") from exc
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        (out_dir / f"{out.stem}.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ {' '.join(LIBRARIES[name])} in {src} failed ({flavour}, "
                f"rc {proc.returncode}):\n{log}"
            )
        os.replace(tmp, out)
    return out, seconds
