"""Per-component fuzzer registry (reference: src/fuzz_tests.zig:24-42).

Each fuzzer is a seeded, self-checking exerciser of one component's
invariants against a simple model.  All register under FUZZERS and run
from one entry point:

    python -m tigerbeetle_tpu_torch.testing.fuzz smoke            # all, brief
    python -m tigerbeetle_tpu_torch.testing.fuzz journal --seed 7 --rounds 200

The smoke tier runs in CI on every test run (tests/test_fuzzers.py);
long runs are for soak sessions, mirroring the reference's CFO fleet
(reference: src/scripts/cfo.zig:1-46).

This package's own copy of ``tigerbeetle_tpu/testing/fuzz.py``.
"""
# tbcheck: allow-file(no-print): fuzzer entry point — progress and
# repro lines print to the terminal/CI log by design.

from __future__ import annotations

import sys

import numpy as np

from tigerbeetle_tpu_torch import constants as cfg
from tigerbeetle_tpu_torch.vsr.storage import MemoryStorage, ZoneLayout


def _layout(grid_size: int = 1 << 20) -> ZoneLayout:
    return ZoneLayout(config=cfg.TEST_MIN, grid_size=grid_size)


# ---------------------------------------------------------------------------
# ewah: encode/decode roundtrip over adversarial bit patterns
# (reference: src/ewah.zig fuzz).


def fuzz_ewah(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.lsm import ewah

    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        n = int(rng.integers(0, 200))
        style = rng.integers(0, 4)
        if style == 0:
            words = rng.integers(0, 1 << 63, n, np.uint64)
        elif style == 1:
            words = np.zeros(n, np.uint64)
        elif style == 2:
            words = np.full(n, ~np.uint64(0), np.uint64)
        else:
            # Long uniform runs with random literals sprinkled in.
            words = np.zeros(n, np.uint64)
            for _ in range(int(rng.integers(0, 4))):
                if n == 0:
                    break
                at = int(rng.integers(n))
                ln = int(rng.integers(1, n - at + 1))
                words[at : at + ln] = (
                    ~np.uint64(0) if rng.random() < 0.5
                    else np.uint64(rng.integers(1, 1 << 62))
                )
        blob = ewah.encode(words)
        out = ewah.decode(blob, len(words))
        assert np.array_equal(out, words), (seed, style, n)


# ---------------------------------------------------------------------------
# snapshot codec: roundtrip + corruption detection
# (fixed-layout checksummed blobs, utils/snapshot.py).


def fuzz_snapshot(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.utils import snapshot

    rng = np.random.default_rng(seed)
    dtypes = [np.uint8, np.uint32, np.uint64, np.int64, np.bool_]
    for _ in range(rounds):
        entries = {}
        for k in range(int(rng.integers(1, 8))):
            kind = rng.integers(0, 3)
            name = f"k{k}"
            if kind == 0:
                dt = dtypes[int(rng.integers(len(dtypes)))]
                entries[name] = rng.integers(0, 100, int(rng.integers(0, 50))).astype(dt)
            elif kind == 1:
                entries[name] = rng.bytes(int(rng.integers(0, 100)))
            else:
                entries[name] = int(rng.integers(0, 1 << 60))
        blob = snapshot.encode(entries)
        out = snapshot.decode(blob)
        assert set(out) == set(entries)
        for name, val in entries.items():
            got = out[name]
            if isinstance(val, np.ndarray):
                assert np.array_equal(got, val) and got.dtype == val.dtype
            else:
                assert got == val, (name, got, val)
        # One flipped byte anywhere must be detected, never silently
        # decoded into different data.
        if len(blob) > 0:
            at = int(rng.integers(len(blob)))
            bad = bytearray(blob)
            bad[at] ^= 0xFF
            try:
                out2 = snapshot.decode(bytes(bad))
            except (snapshot.SnapshotError, ValueError, KeyError):
                continue
            # Extremely unlikely benign flip (e.g. padding): contents
            # must still match exactly.
            for name, val in entries.items():
                got = out2[name]
                if isinstance(val, np.ndarray):
                    assert np.array_equal(got, val), "silent corruption"
                else:
                    assert got == val, "silent corruption"


# ---------------------------------------------------------------------------
# free set: reserve/acquire/release protocol vs a model + EWAH
# checkpoint roundtrip (reference: src/vsr/free_set.zig fuzz).


def fuzz_free_set(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.vsr.free_set import FreeSet

    rng = np.random.default_rng(seed)
    for _ in range(max(1, rounds // 20)):
        n = int(rng.integers(8, 256))
        fs = FreeSet(n)
        acquired: set[int] = set()
        for _ in range(rounds):
            roll = rng.random()
            if roll < 0.5 and fs.count_reservable() > 0:
                want = int(
                    rng.integers(1, min(8, fs.count_reservable()) + 1)
                )
                r = fs.reserve(want)
                took = [fs.acquire(r) for _ in range(int(rng.integers(want + 1)))]
                fs.forfeit(r)
                for a in took:
                    assert a not in acquired, "double allocation"
                    # A quarantined block must never be handed out.
                    assert not fs.quarantine[a - 1], "reused quarantined"
                    acquired.add(a)
            elif acquired and roll < 0.8:
                a = acquired.pop()
                fs.release(a)
            else:
                fs.checkpoint()
                # Freeze: released blocks are free in the encoded blob
                # but quarantined from reuse until the next freeze.
                assert not (fs.quarantine & ~fs.free).any(), seed
                blob = fs.encode()
                back = FreeSet.decode(blob, n)
                assert np.array_equal(back.free, fs.free), seed
        for a in acquired:
            assert not fs.is_free(a)


# ---------------------------------------------------------------------------
# journal: append + torn writes + sector corruption -> recovery
# classification (reference: src/vsr/journal.zig format/recovery fuzz).


def fuzz_journal(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.vsr import wire
    from tigerbeetle_tpu_torch.vsr.journal import Journal

    rng = np.random.default_rng(seed)
    cluster = 7
    for case in range(max(1, rounds // 10)):
        storage = MemoryStorage(_layout(), seed=seed + case)
        j = Journal(storage, cluster)
        slot_count = j.slot_count
        n_ops = int(rng.integers(1, slot_count))  # no ring wrap: chain stays whole
        parent = 0
        appended: dict[int, bytes] = {}
        for op in range(1, n_ops + 1):
            body = rng.bytes(int(rng.integers(0, 200)))
            h = wire.make_header(
                command=wire.Command.prepare, cluster=cluster, op=op,
                parent=parent,
            )
            wire.finalize_header(h, body)
            parent = wire.u128(h, "checksum")
            j.write_prepare(h, body)
            appended[op] = h.tobytes() + body

        # Latent corruption of random prepare slots (not headers: a
        # corrupt header ring with intact prepare stays recoverable and
        # is covered by state "ok").
        corrupted: set[int] = set()
        for _ in range(int(rng.integers(0, 3))):
            op = int(rng.integers(1, n_ops + 1))
            corrupted.add(op)
            storage.corrupt_sector(
                storage.layout.prepare_slot_offset(j.slot_for_op(op))
            )

        fresh = Journal(storage, cluster)
        rec = fresh.recover(0)
        # Every op below the head that was NOT corrupted must be
        # recovered with byte-identical content; corrupted ops must be
        # classified faulty or truncate the head, never silently served.
        for op in range(1, rec.op_head + 1):
            if op in corrupted:
                assert op in rec.faulty_ops or op not in rec.headers, op
                continue
            if op in rec.headers:
                got = fresh.read_prepare(op)
                assert got is not None, op
                assert (got[0].tobytes() + got[1]) == appended[op], op
        for op in rec.faulty_ops:
            assert op in corrupted, f"op {op} falsely classified faulty"


# ---------------------------------------------------------------------------
# superblock: checkpoint sequences + copy corruption -> quorum open
# (reference: src/vsr/superblock_quorums.zig fuzz).


def fuzz_superblock(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.vsr.storage import SUPERBLOCK_COPIES
    from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

    rng = np.random.default_rng(seed)
    for case in range(max(1, rounds // 10)):
        storage = MemoryStorage(_layout(), seed=seed + case)
        sb = SuperBlock(storage, cluster=3)
        sb.format(replica=0, replica_count=1)
        last = (0, 0)
        for _ in range(int(rng.integers(1, 8))):
            commit_min = int(rng.integers(1, 1000))
            sb.checkpoint(
                commit_min=commit_min,
                commit_min_checksum=int(rng.integers(1 << 60)),
                commit_max=commit_min,
                checkpoint_offset=0, checkpoint_size=0,
                checkpoint_checksum=0,
            )
            last = (int(sb.working["sequence"]), commit_min)

        # Corrupt up to COPIES - QUORUM_OPEN copies: open() must still
        # land on the last checkpoint.
        copy_size = storage.layout.superblock_size // SUPERBLOCK_COPIES
        for copy in rng.choice(
            SUPERBLOCK_COPIES, size=int(rng.integers(0, 3)), replace=False
        ):
            storage.corrupt_sector(
                storage.layout.superblock_offset + int(copy) * copy_size
            )
        fresh = SuperBlock(storage, cluster=3)
        h = fresh.open()
        assert (int(h["sequence"]), int(h["commit_min"])) == last, seed


# ---------------------------------------------------------------------------
# lsm tree: put/remove/seal/compact/lookup/scan vs a dict model
# (reference: src/lsm/tree.zig fuzz via forest fuzz).


def fuzz_tree(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.lsm.runs import pack_u128
    from tigerbeetle_tpu_torch.lsm.tree import Tree
    from tigerbeetle_tpu_torch.vsr.grid import Grid

    rng = np.random.default_rng(seed)
    for case in range(max(1, rounds // 40)):
        storage = MemoryStorage(_layout(grid_size=1 << 22), seed=seed + case)
        grid = Grid(storage, block_size=4096, block_count=1 << 10)
        tree = Tree(grid, "fuzz", value_size=8, memtable_max=64)
        model: dict[bytes, bytes] = {}
        key_space = 500
        for _ in range(rounds):
            roll = rng.random()
            if roll < 0.55:
                n = int(rng.integers(1, 40))
                key_lo = rng.integers(0, key_space, n).astype(np.uint64)
                keys = pack_u128(key_lo, np.zeros(n, np.uint64))
                vals = rng.integers(0, 1 << 62, n).astype(np.uint64)
                tree.put_batch(keys, vals)
                raw = vals.view(np.uint8).reshape(n, 8)
                for i in range(n):
                    model[bytes(keys[i])] = bytes(raw[i])
            elif roll < 0.75:
                n = int(rng.integers(1, 20))
                key_lo = rng.integers(0, key_space, n).astype(np.uint64)
                keys = pack_u128(key_lo, np.zeros(n, np.uint64))
                tree.remove_batch(keys)
                for i in range(n):
                    model.pop(bytes(keys[i]), None)
            elif roll < 0.85:
                tree.seal_memtable()
            else:
                tree.maybe_seal()

            if rng.random() < 0.15:
                # Full batch point-lookup diff.
                probe_lo = rng.integers(0, key_space, 32).astype(np.uint64)
                probe = pack_u128(probe_lo, np.zeros(32, np.uint64))
                found, values = tree.lookup_batch(probe)
                for i in range(len(probe)):
                    k = bytes(probe[i])
                    if k in model:
                        assert found[i], (seed, k)
                        assert bytes(values[i]) == model[k]
                    else:
                        assert not found[i], (seed, k)
        # Final scan over the whole key range matches the model.
        lo = pack_u128(np.zeros(1, np.uint64), np.zeros(1, np.uint64))[0]
        hi = pack_u128(
            np.full(1, ~np.uint64(0)), np.full(1, ~np.uint64(0))
        )[0]
        keys, values = tree.scan_range(bytes(lo), bytes(hi))
        got = {bytes(keys[i]): bytes(values[i]) for i in range(len(keys))}
        assert got == model, (seed, len(got), len(model))


# ---------------------------------------------------------------------------
# manifest log: event stream + compaction + replay vs a model
# (reference: src/lsm/manifest_log.zig fuzz).


def fuzz_manifest_log(seed: int, rounds: int) -> None:
    from tigerbeetle_tpu_torch.lsm.manifest_log import ManifestLog
    from tigerbeetle_tpu_torch.vsr.grid import Grid

    rng = np.random.default_rng(seed)
    for case in range(max(1, rounds // 40)):
        # Grid sized for the workload's compaction peak: live state
        # alone can reach ~350 blocks, and a compacting checkpoint
        # holds the old log blocks (still staged for release) plus the
        # fresh snapshot concurrently.
        storage = MemoryStorage(_layout(grid_size=1 << 24), seed=seed + case)
        grid = Grid(storage, block_size=4096, block_count=1 << 12)
        mlog = ManifestLog(grid)
        model: dict[tuple, list] = {}
        next_run = 0
        addresses: list[int] = []
        for _ in range(rounds):
            roll = rng.random()
            if roll < 0.5:
                tree_id = int(rng.integers(1, 4))
                level = int(rng.integers(0, 3))
                run_id = next_run
                next_run += 1
                blocks = [
                    (int(rng.integers(1, 1000)), int(rng.integers(1, 50)),
                     rng.bytes(16), rng.bytes(16))
                    for _ in range(int(rng.integers(1, 100)))
                ]
                mlog.run_add(tree_id, level, run_id, blocks)
                model[(tree_id, level, run_id)] = blocks
            elif roll < 0.7 and model:
                key = list(model)[int(rng.integers(len(model)))]
                mlog.run_remove(*key)
                del model[key]
            else:
                addresses = mlog.checkpoint()
                # The durable-checkpoint ack that makes staged block
                # releases reusable (production: forest.py:150 at the
                # freeze + the flip's release_quarantine).  Without it
                # every log compaction leaks its released blocks into
                # staging and long runs exhaust the grid.
                grid.free_set.checkpoint()
                grid.free_set.release_quarantine()
        addresses = mlog.checkpoint()
        tail = mlog.tail_bytes()
        replayed = ManifestLog(grid).open(addresses, tail)
        assert replayed == model, (seed, len(replayed), len(model))


FUZZERS = {
    "ewah": fuzz_ewah,
    "snapshot": fuzz_snapshot,
    "free_set": fuzz_free_set,
    "journal": fuzz_journal,
    "superblock": fuzz_superblock,
    "tree": fuzz_tree,
    "manifest_log": fuzz_manifest_log,
}

SMOKE_ROUNDS = 60


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        names = " | ".join(["smoke", "all", *FUZZERS])
        print(f"usage: python -m tigerbeetle_tpu_torch.testing.fuzz "
              f"<{names}> [--seed N] [--rounds N]")
        return 2
    name = argv[0]
    seed = 42
    rounds = 400
    args = argv[1:]
    while args:
        if args[0] in ("--seed", "--rounds") and len(args) < 2:
            print(f"{args[0]} requires a value")
            return 2
        if args[0] == "--seed":
            seed = int(args[1])
        elif args[0] == "--rounds":
            rounds = int(args[1])
        else:
            print(f"unknown flag {args[0]}")
            return 2
        args = args[2:]
    if name == "smoke":
        targets, rounds = list(FUZZERS), SMOKE_ROUNDS
    elif name == "all":
        targets = list(FUZZERS)
    elif name in FUZZERS:
        targets = [name]
    else:
        print(f"unknown fuzzer {name!r}; have: {', '.join(FUZZERS)}")
        return 2
    for t in targets:
        FUZZERS[t](seed, rounds)
        print(f"fuzz {t}: ok (seed={seed} rounds={rounds})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
