"""The port's native pipeline, drain loop, frame verify and hash pool.

Two holds:

- The reference's tests of these routes, re-pointed at the port
  (tests/torch_repoint.py): tests/test_native_pipeline.py,
  test_native_drain.py, test_fastpath_decode.py and test_hash_reuse.py.
  Each holds the native route against its Python route under
  TB_NATIVE_PIPELINE, TB_NATIVE_DRAIN, TB_FASTPATH_DECODE and
  TB_HASH_REUSE at 0 and 1; each case runs on the port and on the
  reference, whose clusters must record equal replies, HashLog digests
  and storage images.  Not re-pointed: the reference's stale-library
  cases (the port builds its library from its own sources and never
  loads a stale one; the ABI check below replaces them) and
  test_build_prepares_multilane_bit_identical_fuzz, whose assertion that
  a worker lane took a job races (its bit-identity check is ported
  below).
- The port's library against the reference's on the same fuzzed inputs:
  byte-equal prepares, prepare_oks, journal frames, drain batches,
  verify verdicts and finalized headers, and the same SHA-256 engines.
"""

import numpy as np
import pytest

import torch_repoint as rp
from tigerbeetle_tpu.runtime import fastpath as ref_fp
from tigerbeetle_tpu.vsr import wire as ref_wire
from tigerbeetle_tpu_torch.constants import SECTOR_SIZE
from tigerbeetle_tpu_torch.runtime import fastpath as fp
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR
from tigerbeetle_tpu_torch.vsr.wire import HEADER_DTYPE
from test_native_drain import _fuzz_requests
from test_native_pipeline import _fuzz_request, _r64, _r128

NOT_PORTED = {
    "test_stale_library_fails_fast_on_explicit_opt_in",
    "test_abi_version_mismatch_detected",
    "test_stale_library_fails_fast_on_explicit_drain_opt_in",
    "test_stale_library_degrades_when_drain_knob_defaulted",
    "test_build_prepares_multilane_bit_identical_fuzz",
}
PARAMS = {
    "test_conversation_frames_bit_identical_on_off": [{"gc": False}, {"gc": True}],
    "test_crash_at_fsync_failover_fuzz_native": [{"seed": s} for s in (3, 19, 47)],
    "test_crash_at_fsync_failover_fuzz_drained": [{"seed": s} for s in (3, 19, 47)],
}
FILES = ("test_native_pipeline.py", "test_native_drain.py", "test_fastpath_decode.py",
         "test_hash_reuse.py")
CASES = [
    (f, c, p) for f in FILES for c in rp.case_names(f) if c not in NOT_PORTED
    for p in PARAMS.get(c, [{}])
]


def _id(f, c, p):
    return f"{f[5:-3]}-{c[5:]}" + "".join(f"-{k}{v}" for k, v in p.items())



@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native libraries loaded (tests/torch_repoint.py)."""
    rp.reference_native_loaded()

@pytest.mark.parametrize("test_file,case,params", CASES, ids=[_id(*x) for x in CASES])
def test_repointed_case_matches_reference(test_file, case, params, tmp_path):
    rp.run_both(test_file, case, "oracle", tmp_path, dict(params))


def _ref_header(h):
    return np.frombuffer(h.tobytes(), ref_wire.HEADER_DTYPE)[0]


def _prepare_kwargs(rng):
    return dict(
        cluster=_r128(rng) >> 1, view=int(rng.integers(0, 1 << 31)),
        op=int(rng.integers(1, 1 << 32)), commit=int(rng.integers(0, 1 << 32)),
        timestamp=int(rng.integers(1, 1 << 62)), parent=_r128(rng) >> 1,
        replica=int(rng.integers(0, 6)), context=int(rng.integers(0, 64)),
        release=int(rng.integers(0, 1 << 31)),
    )


@pytest.mark.parametrize("reuse", [False, True])
def test_build_prepare_and_ok_equal_reference_library(reuse):
    rng = np.random.default_rng(20_11)
    mine, theirs = fp.create_pipeline(), ref_fp.create_pipeline()
    for _ in range(150):
        req, body = _fuzz_request(rng)
        kw = _prepare_kwargs(rng)
        a = mine.build_prepare(req, body, reuse=reuse, **kw)
        b = theirs.build_prepare(_ref_header(req), body, reuse=reuse, **kw)
        assert a.tobytes() == b.tobytes()
        view, replica = int(rng.integers(0, 1 << 31)), int(rng.integers(0, 6))
        assert (mine.build_prepare_ok(a, view, replica).tobytes()
                == theirs.build_prepare_ok(b, view, replica).tobytes())


def test_frame_prepare_equals_reference_library():
    rng = np.random.default_rng(20_12)
    slot_count = 64
    rings = [np.zeros(slot_count, HEADER_DTYPE), np.zeros(slot_count, ref_wire.HEADER_DTYPE)]
    scratch = [(np.zeros(8192, np.uint8), np.zeros(SECTOR_SIZE, np.uint8)) for _ in range(2)]
    for _ in range(100):
        body = rng.bytes(int(rng.integers(0, 4096)))
        op = int(rng.integers(1, 1 << 32))
        h = wire.make_header(
            command=wire.Command.prepare, operation=int(rng.integers(0, 200)), cluster=7,
            client=9, view=1, op=op, commit=0, timestamp=_r64(rng) >> 2, parent=1,
            replica=0, release=1,
        )
        wire.finalize_header(h, body)
        lens = [
            lib.frame_prepare(hh, body, ring, op % slot_count, HEADERS_PER_SECTOR, SECTOR_SIZE,
                              *sc)
            for lib, hh, ring, sc in zip((fp, ref_fp), (h, _ref_header(h)), rings, scratch)
        ]
        assert lens[0] == lens[1]
        assert scratch[0][0].tobytes()[:lens[0]] == scratch[1][0].tobytes()[:lens[1]]
        assert scratch[0][1].tobytes() == scratch[1][1].tobytes()
    assert rings[0].tobytes() == rings[1].tobytes()


@pytest.mark.parametrize("reuse", [False, True])
def test_build_and_accept_prepares_equal_reference_library(reuse):
    """The drain loop's two batch calls: every output surface (headers,
    WAL arena, descriptors, redundant sectors, the headers ring)."""
    rng = np.random.default_rng(22_11)
    slot_count = 64
    for _ in range(30):
        k = int(rng.integers(1, 9))
        req_hdrs, bodies = _fuzz_requests(rng, k)
        timestamps = rng.integers(1, 1 << 62, k, dtype=np.uint64)
        contexts = rng.integers(0, 64, k, dtype=np.uint64)
        kw = dict(
            cluster=_r128(rng) >> 1, view=int(rng.integers(0, 1 << 30)),
            op0=int(rng.integers(1, 1 << 32)), commit=int(rng.integers(0, 1 << 32)),
            parent=_r128(rng) >> 1, replica=int(rng.integers(0, 6)),
            release=int(rng.integers(0, 1 << 31)),
        )
        outs = []
        for lib, dtype in ((fp, HEADER_DTYPE), (ref_fp, ref_wire.HEADER_DTYPE)):
            ring = np.zeros(slot_count, dtype)
            hdrs = np.frombuffer(req_hdrs.tobytes(), dtype).copy()
            prepares, frames = lib.build_prepares(
                lib.create_pipeline(), hdrs, bodies, timestamps, contexts, synced=False,
                headers_ring=ring, slot_count=slot_count, headers_per_sector=HEADERS_PER_SECTOR,
                sector_size=SECTOR_SIZE, reuse=reuse, **kw,
            )
            accept_ring = np.zeros(slot_count, dtype)
            oks, accepted = lib.accept_prepares(
                prepares, bodies, view=kw["view"], replica=(kw["replica"] + 1) % 6,
                build_oks=True, headers_ring=accept_ring, slot_count=slot_count,
                headers_per_sector=HEADERS_PER_SECTOR, sector_size=SECTOR_SIZE,
            )
            outs.append([prepares.tobytes(), ring.tobytes(), oks.tobytes(),
                         accept_ring.tobytes()]
                        + [a.tobytes() for a in frames] + [a.tobytes() for a in accepted])
        assert outs[0] == outs[1]


def _arena(rng, n):
    """n request frames packed in one arena, some corrupted (header,
    body, size or version byte)."""
    frames = []
    for i in range(n):
        h, body = _fuzz_request(rng)
        f = bytearray(h.tobytes() + body)
        kind = i % 5
        if kind == 1:
            f[20] ^= 1
        elif kind == 2 and body:
            f[-1] ^= 1
        elif kind == 3:
            f[155] ^= 2
        frames.append(bytes(f))
    offsets = np.cumsum([0] + [len(f) for f in frames[:-1]]).astype(np.uint64)
    lens = np.array([len(f) for f in frames], np.uint32)
    return np.frombuffer(b"".join(frames), np.uint8).copy(), offsets, lens


def test_verify_and_finalize_equal_reference_library():
    rng = np.random.default_rng(23_11)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        arena, offsets, lens = _arena(rng, n)
        ok, hashed = fp.verify_frames2(arena, offsets, lens, n)
        ref_ok, ref_hashed = ref_fp.verify_frames2(arena, offsets, lens, n)
        assert ok.tobytes() == ref_ok.tobytes() and hashed == ref_hashed
        py_ok, py_hashed = fp.verify_frames_py2(arena, offsets, lens, n)
        assert ok.tobytes() == py_ok.tobytes() and hashed == py_hashed
        bodies = [rng.bytes(int(rng.integers(0, 600))) for _ in range(n)]
        hdrs = wire.headers_from_arena(arena, offsets, n).copy()
        ref_hdrs = np.frombuffer(hdrs.tobytes(), ref_wire.HEADER_DTYPE).copy()
        py_hdrs = hdrs.copy()
        assert fp.finalize_headers(hdrs, bodies) and ref_fp.finalize_headers(ref_hdrs, bodies)
        wire.finalize_headers_py(py_hdrs, bodies)
        assert hdrs.tobytes() == ref_hdrs.tobytes() == py_hdrs.tobytes()


def test_build_prepares_multilane_bit_identical_fuzz():
    """0 vs 3 hash-pool lanes at the drain's build seam, both reuse
    arms: the pool changes who hashes, never what lands in a frame, and
    the frames equal the reference library's (which runs inline)."""
    rng = np.random.default_rng(23_05)
    slot_count = 64
    try:
        for _ in range(10):
            k = int(rng.integers(2, 9))
            req_hdrs, bodies = _fuzz_requests(rng, k)
            timestamps = rng.integers(1, 1 << 62, k, dtype=np.uint64)
            contexts = rng.integers(0, 64, k, dtype=np.uint64)
            kw = dict(
                cluster=_r128(rng) >> 1, view=3, op0=int(rng.integers(1, 1 << 32)),
                commit=int(rng.integers(0, 1 << 32)), parent=_r128(rng) >> 1, replica=0,
                release=1, synced=False, slot_count=slot_count,
                headers_per_sector=HEADERS_PER_SECTOR, sector_size=SECTOR_SIZE,
            )
            for reuse in (False, True):
                outs = []
                for lib, lanes in ((fp, 0), (fp, 3), (ref_fp, 0)):
                    assert lib.configure_hash(lanes)
                    dtype = HEADER_DTYPE if lib is fp else ref_wire.HEADER_DTYPE
                    hdrs = np.frombuffer(req_hdrs.tobytes(), dtype).copy()
                    built = lib.build_prepares(
                        lib.create_pipeline(), hdrs, bodies, timestamps, contexts,
                        headers_ring=np.zeros(slot_count, dtype), reuse=reuse, **kw,
                    )
                    prepares, (wal, *_rest) = built
                    outs.append((prepares.tobytes(), wal.tobytes()))
                assert outs[0] == outs[1] == outs[2]
    finally:
        assert fp.configure_hash(0)


def test_hash_engines_match_reference():
    """The same SHA-256 engines on offer, and the same one resolved on
    this machine."""
    assert fp.HASH_ENGINE_NAMES == ref_fp.HASH_ENGINE_NAMES
    assert fp.hash_engine_name() == ref_fp.hash_engine_name()
    assert fp.hash_engine_name() in fp.HASH_ENGINE_NAMES.values()
    assert set(fp.hash_stats()) == {"lane_jobs", "table_hits", "threads"}


def test_abi_mismatch_raises(monkeypatch):
    """A library whose pipeline ABI disagrees with the bindings is
    refused, named, whatever TB_NATIVE_PIPELINE says."""
    lib = fp.load()
    monkeypatch.setattr(lib, "tb_pl_abi_version", lambda: fp.PIPELINE_ABI - 1)
    err = fp.pipeline_error()
    assert err is not None and "ABI" in err
    assert not fp.pipeline_available() and not fp.drain_available()
    with pytest.raises(RuntimeError, match="ABI"):
        fp.create_pipeline()


def test_fastpath_disable_takes_python_routes(monkeypatch, tmp_path):
    """TB_FASTPATH_DISABLE: no pipeline, Python verify and finalize,
    hashlib engine, and the journal frames in Python — the same bytes."""
    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch.vsr.journal import Journal
    from tigerbeetle_tpu_torch.vsr.storage import MemoryStorage, ZoneLayout

    rng = np.random.default_rng(20_13)
    images = []
    for disable in (False, True):
        if disable:
            monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
        assert (fp.create_pipeline() is None) is disable
        assert fp.batch_verify_available() is not disable
        storage = MemoryStorage(ZoneLayout(config=cfg.TEST_MIN, grid_size=1 << 20), seed=1)
        j = Journal(storage, 7)
        assert j._native_frame is not disable
        rng = np.random.default_rng(20_13)
        for op in range(1, 40):
            body = rng.bytes(int(rng.integers(0, 2048)))
            h = wire.make_header(command=wire.Command.prepare, operation=129, cluster=7,
                                 client=9, view=1, op=op, commit=op - 1, timestamp=op,
                                 parent=op, replica=0, release=1)
            wire.finalize_header(h, body)
            j.write_prepare(h, body)
        images.append(sorted((k, bytes(v)) for k, v in storage._pages.items()))
    assert fp.hash_engine_name() == "hashlib"
    assert images[0] == images[1]


def test_loaded_library_is_reached_without_the_lock():
    """Once loaded, the bindings reach the library without rehashing the
    sources or taking the loader's lock: a flight dump in a SIGTERM
    handler (hash_engine_name in the stats) that lands while the drain
    thread is inside load() must not wait on it."""
    import threading

    fp.load()
    held = threading.Event()
    release = threading.Event()

    def hold():
        with fp._lock:
            held.set()
            release.wait(30)

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    assert held.wait(10)
    names = []
    caller = threading.Thread(target=lambda: names.append(fp.hash_engine_name()), daemon=True)
    caller.start()
    caller.join(10)
    release.set()
    holder.join(10)
    assert names == [ref_fp.hash_engine_name()]
