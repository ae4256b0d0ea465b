"""Sanitizer replay driver of the port (run by
tests/test_torch_sanitizers.py, or by hand):

    TB_NATIVE_SANITIZE=asan python -c \
        "from tigerbeetle_tpu_torch.runtime import fastpath, native; \
         fastpath.load(); native._load()"   # builds; the load then aborts
    LD_PRELOAD="$(gcc -print-file-name=libasan.so)" \
    ASAN_OPTIONS=detect_leaks=0 TB_NATIVE_SANITIZE=asan \
    python tests/torch_asan_replay.py

The port's copy of tests/asan_replay.py, every stage kept, driving the
port's ``runtime.fastpath`` and ``runtime.native`` over their
SANITIZED builds (``build/native/asan/``, built by
``kernels/host_build.py``): batch frame verification vs the Python
oracle over the checked-in frames and their corrupt mutations, batch
reply finalize parity, seeded random tearing of the fixture stream
through the native bus framing, the pipeline entry points (fuzzed
prepare/ack sequences incl. torn WAL framing, oversize ops, and
out-of-order prepare_oks), the batch drain entry points (multi-frame
drains with chained parents and packed WAL arenas, shuffled ack runs
laced with duplicates / stale siblings / foreign clusters / wrong
views / unknown ops, commit-ready runs, message_size_max bodies, and
the scatter-gather sendv path torn across socket reads), oversize
size-field frames that must drop the connection without touching
out-of-bounds memory, and the hash pool.  One stage is the port's own:
the host engine's native commit lanes (``tb_fp_commit_transfers``,
``commit_linked``, ``commit_two_phase``, ``commit_exact``,
``decode_store``) under ``TorchStateMachine(device="cpu",
engine="host")``, held to the port's oracle.
Exits 0 with the final OK marker only if every differential holds;
address/UB findings abort the process with a sanitizer report the
caller parses.
"""

import collections
import json
import os
import socket
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tigerbeetle_tpu_torch.runtime import fastpath  # noqa: E402
from tigerbeetle_tpu_torch.runtime.native import (  # noqa: E402
    EV_CLOSED,
    EV_MESSAGE,
    NativeBus,
    native_available,
)
from tigerbeetle_tpu_torch.vsr import wire  # noqa: E402

HEADER_SIZE = 256
FIXTURES = os.path.join(REPO, "clients", "fixtures")


def fixture_frames() -> list:
    with open(os.path.join(FIXTURES, "frames.json")) as fh:
        return [bytes.fromhex(c["frame_hex"]) for c in json.load(fh)]


def mutations(frames: list) -> list:
    """Same corrupt variants the tier-1 differential uses (flipped
    body/header bytes, wrong version, lying size field)."""
    out = list(frames)
    body_frame = next(f for f in frames if len(f) > HEADER_SIZE)
    flipped_body = bytearray(body_frame)
    flipped_body[HEADER_SIZE + 3] ^= 0xFF
    out.append(bytes(flipped_body))
    flipped_header = bytearray(frames[0])
    flipped_header[40] ^= 0x01
    out.append(bytes(flipped_header))
    bad_version = bytearray(frames[0])
    bad_version[155] = 99
    out.append(bytes(bad_version))
    lying_size = bytearray(body_frame)
    lying_size[144:148] = (len(body_frame) + 128).to_bytes(4, "little")
    out.append(bytes(lying_size))
    return out


def arena_of(frames: list):
    blob = b"".join(frames)
    arena = np.frombuffer(blob, np.uint8)
    offsets = np.zeros(len(frames), np.uint64)
    lens = np.zeros(len(frames), np.uint32)
    at = 0
    for i, f in enumerate(frames):
        offsets[i] = at
        lens[i] = len(f)
        at += len(f)
    return arena, offsets, lens


def check_fixture_differential() -> None:
    frames = mutations(fixture_frames())
    arena, offsets, lens = arena_of(frames)
    legacy = []
    for f in frames:
        h = wire.header_from_bytes(f[:HEADER_SIZE])
        legacy.append(int(wire.verify_header(h, f[HEADER_SIZE:])))
    ok_native = fastpath.verify_frames(arena, offsets, lens, len(frames))
    assert ok_native is not None, "sanitized fastpath lacks verify"
    assert [int(v) for v in ok_native] == legacy, "verify differential"
    ok_py = fastpath.verify_frames_py(arena, offsets, lens, len(frames))
    assert [int(v) for v in ok_py] == legacy, "python oracle drifted"
    print("asan-replay: fixture differential ok "
          f"({len(frames)} frames incl. corrupt mutations)")


def check_finalize_parity() -> None:
    bodies = [b"", b"r" * 333, bytes(range(128)) * 5, b"x" * 8190]
    hdrs = np.zeros(len(bodies), wire.HEADER_DTYPE)
    hdrs["version"] = wire.VERSION
    hdrs["command"] = int(wire.Command.reply)
    hdrs["request"] = np.arange(len(bodies))
    oracle = hdrs.copy()
    wire.finalize_headers_py(oracle, bodies)
    assert fastpath.finalize_headers(hdrs, bodies), "native finalize"
    assert hdrs.tobytes() == oracle.tobytes(), "finalize parity"
    print("asan-replay: batch finalize parity ok")


def check_torn_frames(seed: int = 4242, rounds: int = 8) -> None:
    """The fixture stream torn at seeded-random boundaries through the
    native bus framing: every frame must reassemble byte-identically,
    every round, with the sanitizer watching the C framing buffers."""
    frames = fixture_frames()
    stream = b"".join(frames)
    rng = np.random.default_rng(seed)
    for _round in range(rounds):
        bus = NativeBus(1 << 20)
        port = bus.listen("127.0.0.1", 0)
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        got: list = []

        def drain(timeout_ms: int) -> None:
            r = bus.poll_drain(timeout_ms)
            if r is None:
                raise AssertionError("sanitized bus lacks poll_drain")
            n, types, _conns, offs, lens, arena = r
            for i in range(n):
                if types[i] == EV_MESSAGE:
                    lo = int(offs[i])
                    got.append(bytes(arena[lo : lo + int(lens[i])]))

        at = 0
        while at < len(stream):
            n = int(rng.integers(1, 512))
            sock.sendall(stream[at : at + n])
            at += n
            drain(0)
        deadline = time.time() + 30
        while len(got) < len(frames) and time.time() < deadline:
            drain(10)
        assert got == frames, (
            f"torn round {_round}: {len(got)}/{len(frames)} frames"
        )
        sock.close()
        bus.close()
    print(f"asan-replay: torn-frame fuzz ok ({rounds} rounds)")


def _r64(rng) -> int:
    return int(rng.integers(0, 1 << 64, dtype=np.uint64))


def _r128(rng) -> int:
    return _r64(rng) | (_r64(rng) << 64)


def check_pipeline_fuzz(seed: int = 2020, rounds: int = 60) -> None:
    """Round-20 pipeline entry points under the sanitizer: fuzzed
    prepare/ack sequences (out-of-order and stale prepare_oks, dup
    acks, unknown ops), torn WAL framing (slots re-framed mid-ring
    with different prepares), and oversize ops (message_size_max
    bodies) — every byte differential against the wire.py/journal.py
    Python oracles while asan watches the C builders and slot table."""
    from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR
    from tigerbeetle_tpu_torch.vsr.storage import _sectors

    assert fastpath.pipeline_available(), (
        f"sanitized fastpath lacks pipeline: {fastpath.pipeline_error()}"
    )
    sector_size = 4096
    slot_count = 32
    assert slot_count % HEADERS_PER_SECTOR == 0
    rng = np.random.default_rng(seed)
    pl = fastpath.create_pipeline()
    ring_c = np.zeros(slot_count, wire.HEADER_DTYPE)
    ring_py = np.zeros(slot_count, wire.HEADER_DTYPE)
    max_body = 1 << 20  # message_size_max: the oversize-op bound
    scratch_prepare = np.zeros(_sectors(HEADER_SIZE + max_body), np.uint8)
    scratch_sector = np.zeros(sector_size, np.uint8)
    for i in range(rounds):
        # Oversize op every 8th round, torn re-frames from slot reuse
        # (op % slot_count collides across rounds by construction).
        body_len = max_body if i % 8 == 7 else int(rng.integers(0, 8192))
        body = rng.bytes(body_len)
        req = wire.make_header(
            command=wire.Command.request,
            operation=int(rng.integers(0, 200)),
            cluster=_r64(rng), client=_r128(rng) or 1,
            request=int(rng.integers(0, 1 << 32)),
            timestamp=_r64(rng) >> 1,
            trace_id=_r64(rng), trace_ts=_r64(rng),
            trace_flags=int(rng.integers(0, 2)),
        )
        wire.finalize_header(req, body)
        op = int(rng.integers(1, 4 * slot_count))
        kw = dict(
            cluster=_r128(rng) >> 1, view=int(rng.integers(0, 1 << 31)),
            op=op, commit=_r64(rng) >> 2, timestamp=_r64(rng) >> 1,
            parent=_r128(rng) >> 1, replica=int(rng.integers(0, 6)),
            context=int(rng.integers(0, 64)),
            release=int(rng.integers(0, 1 << 31)),
        )
        prepare = pl.build_prepare(req, body, **kw)
        oracle = wire.make_header(
            command=wire.Command.prepare, operation=int(req["operation"]),
            client=wire.u128(req, "client"), request=int(req["request"]),
            **kw,
        )
        wire.copy_trace(oracle, req)
        wire.finalize_header(oracle, body)
        assert prepare.tobytes() == oracle.tobytes(), "prepare differential"
        # Torn WAL framing: the slot may already hold an older prepare.
        slot = op % slot_count
        padded_len = fastpath.frame_prepare(
            prepare, body, ring_c, slot, HEADERS_PER_SECTOR, sector_size,
            scratch_prepare, scratch_sector,
        )
        msg = prepare.tobytes() + body
        padded_py = msg.ljust(_sectors(len(msg)), b"\x00")
        ring_py[slot] = prepare
        first = slot // HEADERS_PER_SECTOR * HEADERS_PER_SECTOR
        sector_py = ring_py[
            first : first + HEADERS_PER_SECTOR
        ].tobytes().ljust(sector_size, b"\x00")
        assert padded_len == len(padded_py), "framing length differential"
        assert scratch_prepare.tobytes()[:padded_len] == padded_py
        assert scratch_sector.tobytes() == sector_py, "sector differential"
        # Fuzzed ack sequence: out-of-order replicas, duplicates, a
        # stale-sibling checksum, and an unknown op — vote counts must
        # stay exact-checksum popcounts, never a stray read or write.
        pl.note_prepare(prepare, bool(rng.integers(0, 2)), kw["replica"])
        replicas = rng.permutation(6)
        votes = {kw["replica"]}
        for rep in replicas:
            ok = pl.build_prepare_ok(prepare, kw["view"], int(rep))
            n = pl.on_ack(ok)
            votes.add(int(rep))
            assert n == len(votes), "vote differential"
            if rng.integers(0, 3) == 0:
                assert pl.on_ack(ok) == len(votes)  # dup ack: no-op
        stale = wire.make_header(
            command=wire.Command.prepare_ok, op=op, replica=1,
            context=123456789,
        )
        wire.finalize_header(stale, b"")
        assert pl.on_ack(stale) is None, "stale ack must not vote"
        unknown = pl.build_prepare_ok(prepare, kw["view"], 1)
        unknown["op"] = op + (1 << 40)
        wire.finalize_header(unknown, b"")
        assert pl.on_ack(unknown) is None, "unknown op must not vote"
        pl.mark_all_synced()
        assert pl.commit_ready(op - 1, 2), "gate differential"
        if rng.integers(0, 2):
            pl.drop(op)
        else:
            pl.reset()
        assert pl.size() == 0
    assert ring_c.tobytes() == ring_py.tobytes(), "ring differential"
    print(f"asan-replay: pipeline fuzz ok ({rounds} rounds)")


def check_drain_fuzz(seed: int = 2222, rounds: int = 40) -> None:
    """Round-22 batch drain entry points under the sanitizer: whole
    multi-frame drains through tb_pl_build_prepares (chained parents,
    WAL arena packing, slot re-frames torn across rounds) and
    tb_pl_accept_prepares (backup framing + prepare_ok builds), acks
    voted through tb_pl_on_acks in shuffled runs laced with
    duplicates, stale siblings, foreign clusters, wrong views and
    unknown ops, and the commit gate answered by
    tb_pl_commit_ready_run — every byte and verdict differential
    against the r20 scalar entry points (themselves oracle-checked
    above), including message_size_max bodies."""
    from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR
    from tigerbeetle_tpu_torch.vsr.storage import _sectors

    assert fastpath.drain_available(), (
        f"sanitized fastpath lacks drain symbols: {fastpath.drain_error()}"
    )
    sector_size = 4096
    slot_count = 32
    max_body = 1 << 20
    rng = np.random.default_rng(seed)
    pl_c = fastpath.create_pipeline()
    pl_py = fastpath.create_pipeline()
    backup = fastpath.create_pipeline()
    ring_primary = np.zeros(slot_count, wire.HEADER_DTYPE)
    ring_oracle = np.zeros(slot_count, wire.HEADER_DTYPE)
    ring_backup = np.zeros(slot_count, wire.HEADER_DTYPE)
    cluster = 7_000_000_000_000_000_001
    view = 9
    op_next = 1
    for i in range(rounds):
        k = int(rng.integers(1, 7))
        bodies = []
        reqs = np.zeros(k, wire.HEADER_DTYPE)
        for j in range(k):
            body_len = (
                max_body if (i % 6 == 5 and j == 0)
                else int(rng.integers(0, 4096))
            )
            body = rng.bytes(body_len)
            req = wire.make_header(
                command=wire.Command.request,
                operation=int(rng.integers(0, 200)),
                cluster=cluster, client=_r128(rng) or 1,
                request=int(rng.integers(0, 1 << 32)),
                timestamp=_r64(rng) >> 1,
                trace_id=_r64(rng), trace_ts=_r64(rng),
                trace_flags=int(rng.integers(0, 2)),
            )
            wire.finalize_header(req, body)
            reqs[j] = req
            bodies.append(body)
        op0 = op_next
        op_next += k
        timestamps = rng.integers(1, 1 << 62, k, dtype=np.uint64)
        contexts = rng.integers(0, 64, k, dtype=np.uint64)
        parent = _r128(rng) >> 1
        kw = dict(
            cluster=cluster, view=view, commit=op0 - 1, replica=0,
            release=1,
        )
        built = fastpath.build_prepares(
            pl_c, reqs, bodies, timestamps, contexts, op0=op0,
            parent=parent, synced=bool(rng.integers(0, 2)),
            headers_ring=ring_primary, slot_count=slot_count,
            headers_per_sector=HEADERS_PER_SECTOR,
            sector_size=sector_size, **kw,
        )
        assert built is not None, "exact-sized drain refused"
        prepares, (wal, wal_off, wal_len, slots, sectors, sec_idx) = built
        # Oracle: the scalar builder, chained by hand, framed by hand.
        chain = parent
        expect_off = 0
        for j in range(k):
            oracle = pl_py.build_prepare(
                reqs[j], bodies[j], op=op0 + j,
                timestamp=int(timestamps[j]), parent=chain,
                context=int(contexts[j]), **kw,
            )
            chain = wire.u128(oracle, "checksum")
            assert prepares[j].tobytes() == oracle.tobytes(), (
                "drain prepare differential"
            )
            msg = oracle.tobytes() + bodies[j]
            padded = msg.ljust(_sectors(len(msg)), b"\x00")
            assert int(wal_off[j]) == expect_off
            assert int(wal_len[j]) == len(padded)
            assert wal[
                expect_off : expect_off + len(padded)
            ].tobytes() == padded, "drain WAL arena differential"
            expect_off += len(padded)
            ring_oracle[(op0 + j) % slot_count] = oracle
        # Backup arm: accept the same run, oks vs the scalar builder.
        accepted = fastpath.accept_prepares(
            prepares, bodies, view=view, replica=2, build_oks=True,
            headers_ring=ring_backup, slot_count=slot_count,
            headers_per_sector=HEADERS_PER_SECTOR,
            sector_size=sector_size,
        )
        assert accepted is not None
        oks, _frames_b = accepted
        for j in range(k):
            oracle_ok = pl_py.build_prepare_ok(prepares[j], view, 2)
            assert oks[j].tobytes() == oracle_ok.tobytes(), (
                "drain prepare_ok differential"
            )
        # Ack runs: shuffled voters + poisoned frames, one C call.
        acks = []
        for j in rng.permutation(k):
            for rep in rng.permutation(3):
                ok = pl_py.build_prepare_ok(prepares[j], view, int(rep) + 1)
                acks.append(ok)
                if rng.integers(0, 4) == 0:
                    acks.append(ok)  # duplicate
        poison = pl_py.build_prepare_ok(prepares[0], view, 1)
        poison["op"] = op0 + (1 << 40)  # unknown op
        wire.finalize_header(poison, b"")
        acks.append(poison)
        stale = wire.make_header(
            command=wire.Command.prepare_ok, cluster=cluster, view=view,
            op=op0, replica=1, context=123456789,
        )
        wire.finalize_header(stale, b"")
        acks.append(stale)
        foreign = pl_py.build_prepare_ok(prepares[0], view, 1)
        foreign["cluster_lo"] = 42
        wire.finalize_header(foreign, b"")
        acks.append(foreign)
        wrong_view = pl_py.build_prepare_ok(prepares[0], view + 7, 1)
        acks.append(wrong_view)
        order = rng.permutation(len(acks))
        run = np.array([acks[x] for x in order])
        mirror = fastpath.create_pipeline()
        for j in range(k):  # same registration build_prepares made
            mirror.note_prepare(prepares[j], True, 0)
        _n, verdicts = pl_c.on_acks(run, cluster, view)
        for x, v in zip(order, (int(t) for t in verdicts)):
            h = acks[x]
            if wire.u128(h, "cluster") != cluster:
                assert v == -4, "foreign cluster verdict"
                continue
            if int(h["view"]) != view:
                assert v == -3, "view verdict"
                continue
            got = mirror.on_ack(h)
            assert got == (None if v < 0 else v), "drain ack differential"
        # Commit gate: the run answer vs the scalar walk.
        pl_c.mark_all_synced()
        ready = pl_c.commit_ready_run(op0 - 1, 2)
        walk = 0
        while pl_c.commit_ready(op0 - 1 + walk, 2):
            walk += 1
        assert ready == walk, "ready-run differential"
        for j in range(k):
            pl_c.drop(op0 + j)
        assert pl_c.size() == 0
    assert ring_primary.tobytes() == ring_oracle.tobytes(), (
        "drain ring differential"
    )
    print(f"asan-replay: drain fuzz ok ({rounds} rounds)")


def check_sendv_torn(seed: int = 777) -> None:
    """tb_bus_sendv (the drain's scatter-gather send list) under the
    sanitizer: multi-frame vectors — including a message_size_max body
    — must arrive byte-identical over a real socket, with the receiver
    reading across arbitrary boundaries."""
    rng = np.random.default_rng(seed)
    frames = list(fixture_frames())
    big_body = rng.bytes(1 << 20)
    h = wire.make_header(command=wire.Command.prepare, cluster=1, op=1)
    wire.finalize_header(h, big_body)
    frames.append(h.tobytes() + big_body)
    bus = NativeBus(1 << 20)
    port = bus.listen("127.0.0.1", 0)
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    # Handshake: one inbound frame surfaces the conn id to sendv on.
    sock.sendall(frames[0])
    conn = None
    deadline = time.time() + 30
    while conn is None and time.time() < deadline:
        r = bus.poll_drain(10)
        assert r is not None
        n, types, conns, _offs, _lens, _arena = r
        for i in range(n):
            if types[i] == EV_MESSAGE:
                conn = int(conns[i])
    assert conn is not None, "handshake frame never surfaced"
    bus.sendv(conn, frames)
    want = b"".join(frames)
    got = bytearray()
    sock.settimeout(30)
    while len(got) < len(want):
        bus.poll(0)  # keep the writer side pumping
        chunk = sock.recv(min(1 << 16, len(want) - len(got)))
        assert chunk, "socket closed mid-vector"
        got.extend(chunk)
    assert bytes(got) == want, "sendv byte differential"
    sock.close()
    bus.close()
    print(f"asan-replay: sendv fuzz ok ({len(frames)} frames)")


def check_oversize_frames() -> None:
    """Size fields past the frame bound (message_size_max bodies +
    the 256-byte header) must drop the connection — never index the
    framing buffer out of bounds.  Probed at bound+1, bound+4096, and
    a u32 in the sign-bit range."""
    max_size = 1 << 20
    bound = max_size + HEADER_SIZE
    for oversize in (bound + 1, bound + 4096, (1 << 31) + 7):
        bus = NativeBus(max_size)
        port = bus.listen("127.0.0.1", 0)
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        h = wire.make_header(command=wire.Command.request, cluster=1)
        h["size"] = oversize & 0xFFFFFFFF
        sock.sendall(h.tobytes())
        closed = False
        deadline = time.time() + 30
        while not closed and time.time() < deadline:
            for t, _c, _p in bus.poll(10):
                if t == EV_CLOSED:
                    closed = True
        assert closed, f"oversize {oversize} did not drop the conn"
        sock.close()
        bus.close()
    print("asan-replay: oversize-frame fuzz ok")


def check_hash_pool(seed: int = 2323, rounds: int = 4) -> None:
    """Round-23 multi-lane hash pool + drain-scoped digest table under
    the sanitizer: counted batch verifies (tb_fp_verify_frames2)
    fanned across worker lanes over the fixture stream laced with
    corrupt mutations, a torn-body frame, and a message_size_max (1MB)
    body; lane counts resized mid-stream (0 -> 2 -> 5 -> 1 -> 0, the
    respawn/join path); then reuse-flagged batch builds racing three
    threads of concurrent verify crossings that each invalidate and
    repopulate the SHARED digest table — results must stay
    bit-identical to the inline no-reuse arm while asan watches the
    pool threads and table slots."""
    import threading

    from tigerbeetle_tpu_torch.vsr.journal import HEADERS_PER_SECTOR

    assert fastpath.drain_available(), (
        f"sanitized fastpath lacks drain symbols: {fastpath.drain_error()}"
    )
    rng = np.random.default_rng(seed)
    frames = mutations(fixture_frames())
    big_body = rng.bytes(1 << 20)
    h = wire.make_header(command=wire.Command.prepare, cluster=1, op=1)
    wire.finalize_header(h, big_body)
    frames.append(h.tobytes() + big_body)
    body_frame = next(f for f in frames if len(f) > HEADER_SIZE)
    frames.append(body_frame[:-7])  # torn body: structural fail, 0 hashed
    arena, offsets, lens = arena_of(frames)
    try:
        expect = None
        for lanes in (0, 2, 5, 1, 0):
            assert fastpath.configure_hash(lanes)
            got = fastpath.verify_frames2(arena, offsets, lens, len(frames))
            assert got is not None, "sanitized fastpath lacks verify2"
            ok, bytes_hashed = got
            this = ([int(v) for v in ok], bytes_hashed)
            if expect is None:
                expect = this
            assert this == expect, f"lane differential at {lanes} lanes"
        # Epoch races: concurrent crossings invalidate + repopulate the
        # shared table while reuse-flagged builds consume digests.
        assert fastpath.configure_hash(3)
        stop = threading.Event()

        def hammer():
            a, o, ln = arena_of(frames)
            while not stop.is_set():
                fastpath.verify_frames2(a, o, ln, len(frames))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for _round in range(rounds):
                k = 5
                reqs = np.zeros(k, wire.HEADER_DTYPE)
                bodies = []
                for j in range(k):
                    body = (
                        big_body if j == 0
                        else rng.bytes(int(rng.integers(0, 8192)))
                    )
                    req = wire.make_header(
                        command=wire.Command.request, operation=3,
                        cluster=9, client=j + 1, request=j,
                    )
                    wire.finalize_header(req, body)
                    reqs[j] = req
                    bodies.append(body)
                timestamps = np.arange(1, k + 1, dtype=np.uint64)
                contexts = np.zeros(k, np.uint64)
                outs = []
                for reuse in (False, True):
                    ring = np.zeros(32, wire.HEADER_DTYPE)
                    built = fastpath.build_prepares(
                        fastpath.create_pipeline(), reqs, bodies,
                        timestamps, contexts, cluster=9, view=1, op0=1,
                        commit=0, parent=1, replica=0, release=1,
                        synced=True, headers_ring=ring, slot_count=32,
                        headers_per_sector=HEADERS_PER_SECTOR,
                        sector_size=4096, reuse=reuse,
                    )
                    assert built is not None
                    prepares, (wal, *_rest) = built
                    outs.append((prepares.tobytes(), wal.tobytes()))
                assert outs[0] == outs[1], "reuse differential under races"
        finally:
            stop.set()
            for t in threads:
                t.join()
    finally:
        assert fastpath.configure_hash(0)
    assert fastpath.hash_stats()["lane_jobs"] > 0, "pool lanes never ran"
    print(f"asan-replay: hash pool + digest table fuzz ok "
          f"({rounds} racing rounds)")


def check_commit_lanes(events: int = 600, batch: int = 200) -> None:
    """The port's own stage: the host engine's native commit lanes
    through TorchStateMachine(device="cpu", engine="host") on small
    streams of each class of workload.py (order-free, skewed, linked
    chains, pending / post / void pairs, balancing riders and chains
    with pendings, the wave stream's limited chains), every reply and
    the state root equal to the port's oracle, each lane called."""
    from tigerbeetle_tpu_torch import constants as cfg
    from tigerbeetle_tpu_torch import workload
    from tigerbeetle_tpu_torch.state_machine.cpu import CpuStateMachine
    from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
    from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness

    calls = collections.Counter()

    def counted(owner, name):
        fn = getattr(owner, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        setattr(owner, name, call)

    for name in ("commit_transfers", "commit_linked", "commit_two_phase", "commit_exact"):
        counted(fastpath.NativeFastpath, name)
    counted(fastpath, "decode_store")
    streams = {
        "simple": workload.gen_simple(events, 200, batch),
        "zipf": workload.gen_zipf(events, 100, batch),
        "linked": workload.gen_linked(events, 200, batch),
        "two_phase": workload.gen_two_phase(events, 200, batch),
        "offkernel": workload.gen_offkernel(events, 401, batch),
        "waves_host": workload.gen_waves_host(events, 2_000, 100, batch),
    }
    for name, (setup, timed, (capacity, transfers)) in streams.items():
        sm = TorchStateMachine(cfg.PRODUCTION, account_capacity=capacity + 3,
                               transfer_capacity=transfers, device="cpu", engine="host")
        port = SingleNodeHarness(sm)
        oracle = SingleNodeHarness(CpuStateMachine())
        for k, (op, body) in enumerate(setup + timed):
            assert port.submit(op, body) == oracle.submit(op, body), f"{name}: op {k}"
        assert sm.state_root() == oracle.sm.state_root(), f"{name}: state root"
    lanes = ("commit_transfers", "commit_linked", "commit_two_phase", "commit_exact",
             "decode_store")
    assert all(calls[lane] for lane in lanes), dict(calls)
    print("asan-replay: commit lanes ok "
          f"({', '.join(f'{lane} {calls[lane]}' for lane in lanes)})")


def main() -> int:
    assert native_available(), "sanitized native runtime failed to load"
    assert fastpath.available(), "sanitized fastpath failed to load"
    from tigerbeetle_tpu_torch.runtime import native

    print(f"asan-replay: libraries {fastpath.build_info['path']} {native._load()._name}")
    check_fixture_differential()
    check_finalize_parity()
    check_torn_frames()
    check_pipeline_fuzz()
    check_drain_fuzz()
    check_hash_pool()
    check_sendv_torn()
    check_oversize_frames()
    check_commit_lanes()
    print("ASAN-REPLAY-OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
