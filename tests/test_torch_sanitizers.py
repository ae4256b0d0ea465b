"""The port's native sanitizer wiring (tests/test_sanitizers.py re-pointed).

- The replay (slow, as the reference's): both host libraries built in
  their asan flavour (``kernels/host_build.py``, the reference
  Makefile's SANFLAGS, into ``build/native/asan/``), then
  tests/torch_asan_replay.py in a subprocess with the ASan runtime
  LD_PRELOADed and the reference's ASAN_OPTIONS / UBSAN_OPTIONS: every
  reference stage's marker, the port's own commit-lanes stage, the
  sanitized libraries loaded, and no sanitizer report in the output.
- The build forensics (fast): with CXX pointing at a compiler that
  exits 3, the build error names ``sanitizer=asan``.  The reference
  stubs ``make``; the port builds with g++ directly, so the stub is the
  compiler (ROADMAP queue 3).
- The knob's reader is validated (tests/test_envcheck.py's case, on
  both packages); TB_NATIVE_SANITIZE=msan surfacing through
  ``TorchStateMachine(cfg.TEST_MIN, device="cpu")`` is
  tests/test_tbcheck.py's case, re-pointed in test_torch_tbcheck.py.
"""

import os
import shutil
import subprocess
import sys

import pytest

import torch_repoint as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_STAGES = ("fixture differential ok", "finalize parity ok", "torn-frame fuzz ok",
                    "pipeline fuzz ok", "drain fuzz ok", "sendv fuzz ok",
                    "oversize-frame fuzz ok", "hash pool + digest table fuzz ok")


def _asan_runtime() -> str | None:
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        return None
    try:
        path = subprocess.run(
            [gcc, "-print-file-name=libasan.so"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return path if path and os.path.exists(path) else None


def _sanitizer_report(text: str) -> bool:
    return ("AddressSanitizer" in text
            or "runtime error:" in text          # UBSan
            or "LeakSanitizer" in text)


@pytest.mark.slow
def test_fastpath_replay_under_asan():
    from tigerbeetle_tpu_torch.kernels import host_build

    runtime = _asan_runtime()
    if runtime is None:
        pytest.skip("no asan runtime")
    paths = [host_build.build(name=name, sanitize="asan")[0]
             for name in ("fastpath", "runtime")]
    for path in paths:
        assert path.parent == host_build.BUILD_DIR / "asan" and path.is_file()
    env = dict(os.environ)
    env.update(
        LD_PRELOAD=runtime,
        # Python leaks by design; the replay hunts heap/stack/UB bugs
        # in OUR libraries, not CPython allocator noise.
        ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
        UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
        TB_NATIVE_SANITIZE="asan",
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_asan_replay.py")],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    combined = proc.stdout + "\n" + proc.stderr
    assert proc.returncode == 0, combined[-4000:]
    assert "ASAN-REPLAY-OK" in proc.stdout, combined[-4000:]
    for marker in (*REFERENCE_STAGES, "asan-replay: commit lanes ok"):
        assert marker in proc.stdout, combined[-4000:]
    loaded = next(line for line in proc.stdout.splitlines() if "libraries" in line)
    assert all(str(path) in loaded for path in paths), loaded
    assert not _sanitizer_report(combined), combined[-4000:]


def test_asan_build_failure_names_flavor(tmp_path):
    """A failed build names the sanitizer flavour attempted: a broken
    asan build must never read as a broken release build (fast: no real
    build, the compiler is a stub that fails)."""
    fake_cxx = tmp_path / "cxx"
    fake_cxx.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    fake_cxx.chmod(0o755)
    code = (
        "from pathlib import Path;"
        "from tigerbeetle_tpu_torch.runtime import fastpath;"
        f"fastpath.load(out_dir=Path({str(tmp_path / 'build')!r}))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, CXX=str(fake_cxx), TB_NATIVE_SANITIZE="asan"),
    )
    assert proc.returncode != 0
    err = proc.stderr
    assert "NativeFastpathError" in err and "sanitizer=asan" in err, err[-2000:]
    assert "rc 3" in err and "boom" in err, err[-2000:]


def test_asan_flavour_builds_apart():
    """The asan flavour's flags are the reference Makefile's SANFLAGS on
    top of the release flags; its libraries live under asan/ under
    other digests than the release ones."""
    from tigerbeetle_tpu_torch.kernels import host_build

    assert host_build.SANFLAGS == ("-fsanitize=address,undefined",
                                   "-fno-omit-frame-pointer", "-g")
    for name in ("fastpath", "runtime"):
        plain = host_build.library_path(name=name)
        asan = host_build.library_path(name=name, sanitize="asan")
        assert plain.parent == host_build.BUILD_DIR
        assert asan.parent == host_build.BUILD_DIR / "asan"
        assert plain.name != asan.name
        cmd = host_build.command(asan, name=name, sanitize="asan")
        assert cmd[1:1 + len(host_build.CXX_FLAGS)] == list(host_build.CXX_FLAGS)
        assert all(flag in cmd for flag in host_build.SANFLAGS)
    with pytest.raises(ValueError):
        host_build.flags("msan")


def test_repointed_native_sanitize_reader_matches_reference(tmp_path):
    rp.run_both("test_envcheck.py", "test_tb_native_sanitize_validated", "oracle", tmp_path)
