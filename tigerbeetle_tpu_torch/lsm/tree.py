"""LSM tree: memtable + leveled sorted runs in grid blocks.

This package's own copy of ``tigerbeetle_tpu/lsm/tree.py``.

reference: src/lsm/tree.zig:69-253 (mutable/immutable memtable + 7
on-disk levels, growth factor 8 — src/config.zig:156-157),
src/lsm/table.zig (sorted tables in grid blocks), compaction merging a
level into the next (src/lsm/compaction.zig:1-32).

Host-idiomatic re-design: runs are columnar numpy batches (V16 keys in
big-endian pack order so memcmp == numeric u128 order, fixed-size
values, tombstone flags), serialized one chunk per grid block with
per-block key fences for binary search.  All operations are batch
-vectorized (searchsorted over fences + block payloads) — there is no
per-key Python in lookups.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tigerbeetle_tpu_torch.lsm.runs import KEY_DTYPE, keys_le, pack_u128
from tigerbeetle_tpu_torch.vsr.grid import Grid

LEVELS = 7          # reference: src/config.zig lsm_levels
GROWTH = 8          # reference: src/config.zig lsm_growth_factor


def _entry_size(value_size: int) -> int:
    return 16 + 1 + value_size  # key + flags + value


# Sparse-value block encoding (a write-amplification lever): values
# are split into 8-byte groups and only NONZERO groups are
# written, prefixed by a per-row u32 presence mask.  Wire objects are
# mostly-zero (reserved user_data, zeroed reconstructible fields, high
# u128 limbs), so this halves the dominant object-tree seal bytes; the
# worst case costs 4 bytes/row.  Block header bit 31 of the count word
# marks encoded payloads, so raw blocks (older files, non-sparse
# trees) keep parsing.
_SPARSE_FLAG = 0x8000_0000


def _entry_size_sparse(value_size: int) -> int:
    return 16 + 1 + 4 + value_size  # worst case: all groups nonzero


@dataclasses.dataclass
class RunBlock:
    address: int
    count: int
    key_min: bytes  # first key in block
    key_max: bytes  # last key in block


@dataclasses.dataclass
class Run:
    blocks: list[RunBlock]
    id: int = 0  # tree-scoped creation counter (manifest-log identity)

    @property
    def count(self) -> int:
        return sum(b.count for b in self.blocks)

    @property
    def key_min(self) -> bytes:
        return self.blocks[0].key_min

    @property
    def key_max(self) -> bytes:
        return self.blocks[-1].key_max


class Tree:
    def __init__(self, grid: Grid, name: str, *, value_size: int = 8,
                 memtable_max: int = 8192, sparse_values: bool = False) -> None:
        self.grid = grid
        self.name = name
        self.value_size = value_size
        self.value_dtype = np.dtype(f"V{value_size}")
        self.memtable_max = memtable_max
        self.sparse_values = sparse_values and value_size % 8 == 0
        if self.sparse_values:
            assert value_size // 8 <= 32, "sparse mask is u32 (32 groups)"
        # Manifest-log wiring (set by the forest): run add/remove
        # events append to the shared log instead of full-manifest
        # rewrites (reference: src/lsm/manifest_log.zig).
        self.tree_id = 0
        self.mlog = None
        self._next_run_id = 0
        # Memtable: list of individually-sorted columnar batches
        # (keys KEY_DTYPE, flags u8, values (n, value_size) u8), newest
        # LAST.  Vectorized throughout — one put_batch is one argsort,
        # no per-key Python (the spill path feeds 8k-row batches from
        # the commit hot path).
        self.memtable: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.memtable_count = 0
        # levels[i] = runs, newest last.
        self.levels: list[list[Run]] = [[] for _ in range(LEVELS)]
        # At most one resumable merge in flight per tree.
        self._job: "CompactionJob | None" = None

    # ------------------------------------------------------------------
    # Writes.

    def _push_batch(self, keys: np.ndarray, flags: np.ndarray,
                    values: np.ndarray) -> None:
        if len(keys) == 0:
            return
        # Strictly-increasing input (spill streams keyed by row number
        # / timestamp) skips the sort AND the dedupe — void-dtype
        # argsort is the hot cost of the LSM ingest path.
        if len(keys) == 1 or not keys_le(keys[1:], keys[:-1]).any():
            self.memtable.append((keys, flags, values))
            self.memtable_count += len(keys)
            return
        # Stable sort + keep the LAST write per duplicate key within
        # the batch (dict-overwrite semantics).
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        flags = flags[order]
        values = values[order]
        keep = np.ones(len(keys), bool)
        keep[:-1] = keys[:-1] != keys[1:]
        if not keep.all():
            keys, flags, values = keys[keep], flags[keep], values[keep]
        self.memtable.append((keys, flags, values))
        self.memtable_count += len(keys)

    def put_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values).view(np.uint8).reshape(
            len(keys), -1
        )
        assert values.shape[1] == self.value_size, (
            f"{self.name}: value width {values.shape[1]} != "
            f"value_size {self.value_size}"
        )
        self._push_batch(
            np.asarray(keys, KEY_DTYPE), np.zeros(len(keys), np.uint8), values
        )

    def remove_batch(self, keys: np.ndarray) -> None:
        self._push_batch(
            np.asarray(keys, KEY_DTYPE),
            np.ones(len(keys), np.uint8),
            np.zeros((len(keys), self.value_size), np.uint8),
        )

    def put(self, key_hi: int, key_lo: int, value: bytes | int) -> None:
        key = pack_u128(
            np.array([key_lo], np.uint64), np.array([key_hi], np.uint64)
        )
        if isinstance(value, int):
            value = value.to_bytes(self.value_size, "little")
        self._push_batch(
            key, np.zeros(1, np.uint8),
            np.frombuffer(value, np.uint8).reshape(1, -1),
        )

    # ------------------------------------------------------------------
    # Reads.

    def lookup_batch(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (found bool[n], values (n, value_size) uint8).

        Newest wins: memtable, then level 0 runs newest-first, then
        deeper levels.  Tombstones report not-found.
        """
        n = len(keys)
        found = np.zeros(n, bool)
        resolved = np.zeros(n, bool)
        values = np.zeros((n, self.value_size), np.uint8)

        for bkeys, bflags, bvals in reversed(self.memtable):
            todo = np.flatnonzero(~resolved)
            if len(todo) == 0:
                break
            sub = keys[todo]
            pos = np.searchsorted(bkeys, sub)
            pos_c = np.minimum(pos, len(bkeys) - 1)
            hit = bkeys[pos_c] == sub
            hi = todo[hit]
            p = pos_c[hit]
            resolved[hi] = True
            live = bflags[p] == 0
            found[hi[live]] = True
            values[hi[live]] = bvals[p[live]]

        for run in self._runs_newest_first():
            todo = np.flatnonzero(~resolved)
            if len(todo) == 0:
                break
            self._run_lookup(run, keys, todo, found, resolved, values)
        return found, values

    def _runs_newest_first(self):
        for level in range(LEVELS):
            for run in reversed(self.levels[level]):
                yield run

    def _run_lookup(self, run: Run, keys, todo, found, resolved, values):
        fences = np.array([b.key_min for b in run.blocks], KEY_DTYPE)
        maxes = np.array([b.key_max for b in run.blocks], KEY_DTYPE)
        sub = keys[todo]
        # Candidate block per key: rightmost block whose min <= key.
        bi = np.searchsorted(fences, sub, side="right") - 1
        in_range = (bi >= 0) & keys_le(sub, maxes[np.clip(bi, 0, None)])
        for block_index in np.unique(bi[in_range]):
            mask = in_range & (bi == block_index)
            idx = todo[mask]
            bkeys, bflags, bvalues = self._read_run_block(
                run.blocks[block_index]
            )
            pos = np.searchsorted(bkeys, keys[idx])
            pos_c = np.minimum(pos, len(bkeys) - 1)
            hit = bkeys[pos_c] == keys[idx]
            hi = idx[hit]
            p = pos_c[hit]
            resolved[hi] = True
            live = bflags[p] == 0
            found[hi[live]] = True
            values[hi[live]] = bvalues[p[live]]

    def _read_run_block(self, block: RunBlock):
        payload = self.grid.read_block(block.address)
        word = int.from_bytes(payload[:4], "little")
        count = word & ~_SPARSE_FLAG
        at = 4
        keys = np.frombuffer(payload[at : at + 16 * count], KEY_DTYPE)
        at += 16 * count
        flags = np.frombuffer(payload[at : at + count], np.uint8)
        at += count
        if not word & _SPARSE_FLAG:
            vals = np.frombuffer(
                payload[at : at + count * self.value_size], np.uint8
            ).reshape(count, self.value_size)
            return keys, flags, vals
        g = self.value_size // 8
        bits = np.frombuffer(payload[at : at + 4 * count], "<u4")
        at += 4 * count
        mask = (bits[:, None] >> np.arange(g, dtype=np.uint32)) & 1
        mask = mask.astype(bool)
        nnz = int(mask.sum())
        v64 = np.zeros((count, g), "<u8")
        v64[mask] = np.frombuffer(payload[at : at + 8 * nnz], "<u8")
        return keys, flags, v64.view(np.uint8).reshape(count, self.value_size)

    # ------------------------------------------------------------------
    # Range scans (ascending).  Returns merged (keys, values), newest
    # wins, tombstones dropped.

    def scan_range(self, key_min: bytes, key_max: bytes) -> tuple[np.ndarray, np.ndarray]:
        streams = []
        kmin = np.frombuffer(key_min, KEY_DTYPE)
        kmax = np.frombuffer(key_max, KEY_DTYPE)
        for bkeys, bflags, bvals in reversed(self.memtable):
            lo = np.searchsorted(bkeys, kmin)[0]
            hi = np.searchsorted(bkeys, kmax, side="right")[0]
            if lo < hi:
                streams.append((bkeys[lo:hi], bflags[lo:hi], bvals[lo:hi]))
        for run in self._runs_newest_first():
            if run.key_max < key_min or run.key_min > key_max:
                continue
            parts = []
            for block in run.blocks:
                if block.key_max < key_min or block.key_min > key_max:
                    continue
                bkeys, bflags, bvals = self._read_run_block(block)
                lo = np.searchsorted(bkeys, np.array([key_min], KEY_DTYPE))[0]
                hi = np.searchsorted(
                    bkeys, np.array([key_max], KEY_DTYPE), side="right"
                )[0]
                parts.append((bkeys[lo:hi], bflags[lo:hi], bvals[lo:hi]))
            if parts:
                streams.append(
                    tuple(np.concatenate([p[j] for p in parts]) for j in range(3))
                )
        return k_way_merge(streams, self.value_size)

    # ------------------------------------------------------------------
    # Memtable seal + compaction.

    def maybe_seal(self) -> None:
        if self.memtable_count >= self.memtable_max:
            self.seal_memtable()

    def seal_memtable(self) -> None:
        """Seal the memtable into a level-0 run.  Compaction debt this
        creates is NOT paid here — beats (compact_beat) amortize it
        across commits, and compact_drain() settles the rest at
        checkpoint (reference: src/lsm/compaction.zig:1-32 paces the
        same debt across the beats of a bar)."""
        if not self.memtable:
            return
        # Newest batch first: k_way_merge keeps the newest version.
        keys, flags, vals = k_way_merge_flags(
            list(reversed(self.memtable)), self.value_size
        )
        self.memtable.clear()
        self.memtable_count = 0
        run = self._new_run(keys, flags, vals, level=0)
        self.levels[0].append(run)

    def _new_run(self, keys, flags, vals, *, level: int) -> Run:
        run = self._write_run(keys, flags, vals)
        run.id = self._next_run_id
        self._next_run_id += 1
        if self.mlog is not None:
            self.mlog.run_add(
                self.tree_id, level, run.id,
                [
                    (b.address, b.count, b.key_min, b.key_max)
                    for b in run.blocks
                ],
            )
        return run

    def _block_payload(self, k, f, v) -> bytes:
        if not self.sparse_values:
            return (
                len(k).to_bytes(4, "little")
                + k.tobytes() + f.tobytes() + v.tobytes()
            )
        n = len(k)
        g = self.value_size // 8
        v64 = np.ascontiguousarray(v).view("<u8").reshape(n, g)
        mask = v64 != 0
        bits = mask @ (np.uint32(1) << np.arange(g, dtype=np.uint32))
        return (
            (n | _SPARSE_FLAG).to_bytes(4, "little")
            + k.tobytes() + f.tobytes()
            + bits.astype("<u4").tobytes() + v64[mask].tobytes()
        )

    def _per_block(self) -> int:
        entry = (
            _entry_size_sparse(self.value_size)
            if self.sparse_values
            else _entry_size(self.value_size)
        )
        return (self.grid.payload_size - 4) // entry

    def _write_run(self, keys, flags, vals) -> Run:
        per_block = self._per_block()
        blocks = []
        fs = self.grid.free_set
        n = len(keys)
        n_blocks = (n + per_block - 1) // per_block
        reservation = fs.reserve(n_blocks)
        for at in range(0, n, per_block):
            k = keys[at : at + per_block]
            f = flags[at : at + per_block]
            v = vals[at : at + per_block]
            payload = self._block_payload(k, f, v)
            address = fs.acquire(reservation)
            self.grid.write_block(address, payload)
            blocks.append(
                RunBlock(
                    address=address, count=len(k),
                    key_min=k[0].tobytes(), key_max=k[-1].tobytes(),
                )
            )
        fs.forfeit(reservation)
        return Run(blocks=blocks)

    def _level_run_max(self, level: int) -> int:
        """Constant run cap per level IS the geometric invariant here:
        a level-L run is the merge of ~GROWTH level-(L-1) runs, so run
        SIZE grows by GROWTH per level and a cap of GROWTH runs gives
        each level ~GROWTH^L capacity (reference: src/config.zig
        lsm_growth_factor; table-count-based in the reference because
        its tables are fixed-size — ours are not)."""
        del level
        return GROWTH

    # -- paced compaction -------------------------------------------------
    #
    # A merge of level L into L+1 reads both levels and rewrites them —
    # done synchronously it is a latency cliff that grows with state.
    # Instead an over-full level opens a resumable CompactionJob that
    # advances a bounded number of grid blocks per beat; the replica
    # beats every commit and drains at checkpoint
    # (reference: src/lsm/compaction.zig:1-32, forest.zig:846
    # CompactionPipeline).

    def _over_full_level(self) -> int | None:
        for level in range(LEVELS - 1):
            if len(self.levels[level]) > self._level_run_max(level):
                return level
        return None

    def compaction_pending(self) -> bool:
        return self._job is not None or self._over_full_level() is not None

    def compact_beat(self, block_budget: int) -> int:
        """Advance compaction by at most `block_budget` grid blocks
        (read + written); returns blocks actually used.  Deterministic:
        driven by commit count, never wall clock, so replicas stay
        byte-identical."""
        used = 0
        while used < block_budget:
            if self._job is None:
                level = self._over_full_level()
                if level is None:
                    break
                self._job = CompactionJob(self, level)
            used += self._job.step(block_budget - used)
            if self._job.done:
                self._job = None
        return used

    def compact_drain(self) -> None:
        """Checkpoint barrier: settle every pending merge (the free
        set and manifest log must not reference half-built runs in a
        checkpoint)."""
        while self.compaction_pending():
            self.compact_beat(1 << 30)

    # Whole-batch compatibility shim (tests, standalone harnesses).
    def compact(self) -> None:
        self.compact_drain()

    def _read_run_all(self, run: Run):
        parts = [self._read_run_block(b) for b in run.blocks]
        return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))

    def _write_one_block(self, keys, flags, vals) -> RunBlock:
        """Write a single run block (incremental output of a paced
        merge; _write_run covers the whole-run seal path)."""
        fs = self.grid.free_set
        reservation = fs.reserve(1)
        address = fs.acquire(reservation)
        fs.forfeit(reservation)
        payload = self._block_payload(keys, flags, vals)
        self.grid.write_block(address, payload)
        return RunBlock(
            address=address, count=len(keys),
            key_min=keys[0].tobytes(), key_max=keys[-1].tobytes(),
        )

    def _release_run(self, run: Run) -> None:
        for block in run.blocks:
            self.grid.free_set.release(block.address)

    # ------------------------------------------------------------------
    # Manifest (persisted inside the checkpoint blob).

    def memtable_manifest(self) -> dict:
        """Memtable batches only — run/block state lives in the
        manifest log (lsm/manifest_log.py), not here."""
        man = {}
        if self.memtable:
            man["mt_keys"] = np.concatenate([b[0] for b in self.memtable])
            man["mt_flags"] = np.concatenate([b[1] for b in self.memtable])
            man["mt_vals"] = np.concatenate([b[2] for b in self.memtable])
            man["mt_lens"] = np.array(
                [len(b[0]) for b in self.memtable], np.uint64
            )
        return man

    def restore_memtable(self, manifest: dict) -> None:
        self.memtable = []
        self.memtable_count = 0
        if "mt_lens" in manifest and len(manifest["mt_lens"]):
            keys = np.asarray(manifest["mt_keys"]).astype(KEY_DTYPE, copy=False)
            flags = np.asarray(manifest["mt_flags"])
            vals = np.asarray(manifest["mt_vals"])
            at = 0
            for n in manifest["mt_lens"]:
                n = int(n)
                self.memtable.append(
                    (keys[at : at + n], flags[at : at + n], vals[at : at + n])
                )
                at += n
            self.memtable_count = at

    def restore_runs(self, runs: dict) -> None:
        """runs: {(level, run_id): [(addr, count, kmin, kmax), ...]}
        from the manifest-log replay.  Run order within a level is
        run_id order (creation order == newest last)."""
        self.levels = [[] for _ in range(LEVELS)]
        next_id = 0
        for (level, run_id), refs in sorted(runs.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            blocks = [
                RunBlock(
                    address=int(addr), count=int(count),
                    key_min=bytes(kmin), key_max=bytes(kmax),
                )
                for addr, count, kmin, kmax in refs
            ]
            self.levels[level].append(Run(blocks=blocks, id=run_id))
            next_id = max(next_id, run_id + 1)
        self._next_run_id = next_id


class _JobInput:
    """Cursor over one input run's blocks (newest-precedence order is
    the inputs list order, not anything here)."""

    __slots__ = ("run", "block", "keys", "flags", "vals", "offset")

    def __init__(self, run: Run) -> None:
        self.run = run
        self.block = 0
        self.keys = None
        self.flags = None
        self.vals = None
        self.offset = 0

    @property
    def exhausted(self) -> bool:
        return self.keys is None and self.block >= len(self.run.blocks)


class CompactionJob:
    """Resumable merge of level L (+ level L+1) into one level-(L+1)
    run, advanced a bounded number of blocks at a time.

    Visibility: input runs stay in `tree.levels` (reads keep working)
    until the final step, which atomically swaps them for the output
    run and records the change in the manifest log.  A crash mid-job
    loses only unreferenced output blocks — the last checkpoint's free
    set never saw them (checkpoints drain jobs first).

    Chunk correctness: each step merges all entries with key <= bound,
    where bound = min over loaded blocks of that block's key_max.  Any
    entry <= bound must live in its input's CURRENT block (later
    blocks start above their predecessor's key_max >= bound), so
    newest-wins dedupe within the chunk is globally correct.
    """

    def __init__(self, tree: Tree, level: int) -> None:
        self.tree = tree
        self.level = level
        # Snapshot the input run lists: new seals arriving at level 0
        # during the job are NOT part of it.
        self.inputs_a = list(tree.levels[level])
        self.inputs_b = list(tree.levels[level + 1])
        # Newest first across both levels for merge precedence.
        self.inputs = [
            _JobInput(r) for r in reversed(self.inputs_a + self.inputs_b)
        ]
        self.drop_tombstones = level + 1 == LEVELS - 1 or not any(
            tree.levels[i] for i in range(level + 2, LEVELS)
        )
        self.out_blocks: list[RunBlock] = []
        self._buf: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._buf_count = 0
        self.done = False

    def _try_move(self) -> bool:
        """Move optimization (reference: src/lsm/compaction.zig
        disjoint-table move): when the input runs cover pairwise
        disjoint key ranges — the common case for trees keyed by
        monotonically increasing values, like the spill object trees'
        row numbers — the merge is pure metadata: the SAME grid blocks
        re-file as one level-(L+1) run, no reads, no rewrites.

        Only the level-L runs move; level L+1 keeps its runs untouched
        (disjointness makes cross-level shadowing impossible).  That
        keeps each move's manifest event O(level-L blocks): re-listing
        an ever-growing merged L+1 run every move would be O(total
        state) metadata per beat — the superlinear drag this bounds."""
        runs = self.inputs_a + self.inputs_b
        ordered = sorted(runs, key=lambda r: r.key_min)
        for prev, cur in zip(ordered, ordered[1:]):
            if not prev.key_max < cur.key_min:
                return False
        tree = self.tree
        level = self.level
        moved = sorted(self.inputs_a, key=lambda r: r.key_min)
        if tree.mlog is not None:
            for run in self.inputs_a:
                tree.mlog.run_remove(tree.tree_id, level, run.id)
        drop = set(id(r) for r in self.inputs_a)
        tree.levels[level] = [
            r for r in tree.levels[level] if id(r) not in drop
        ]
        out = Run(blocks=[b for r in moved for b in r.blocks])
        out.id = tree._next_run_id
        tree._next_run_id += 1
        if tree.mlog is not None:
            tree.mlog.run_add(
                tree.tree_id, level + 1, out.id,
                [
                    (b.address, b.count, b.key_min, b.key_max)
                    for b in out.blocks
                ],
            )
        tree.levels[level + 1].append(out)
        self.done = True
        return True

    def step(self, block_budget: int) -> int:
        if not self.done and not self.out_blocks and not self._buf:
            # First step: a disjoint input set moves instead of merging.
            if self._try_move():
                return 0
        tree = self.tree
        per_block = tree._per_block()
        used = 0
        while used < block_budget and not self.done:
            # Load the current block of every non-exhausted input.
            loaded = []
            for inp in self.inputs:
                if inp.keys is None and inp.block < len(inp.run.blocks):
                    if used >= block_budget:
                        return used
                    inp.keys, inp.flags, inp.vals = tree._read_run_block(
                        inp.run.blocks[inp.block]
                    )
                    inp.offset = 0
                    used += 1
                if inp.keys is not None:
                    loaded.append(inp)
            if not loaded:
                used += self._finalize(per_block)
                return used
            # bytes comparison == key order (big-endian pack).
            bound = np.frombuffer(
                min(inp.keys[-1].tobytes() for inp in loaded), KEY_DTYPE
            )
            chunk = []
            for inp in loaded:
                hi = int(
                    np.searchsorted(
                        inp.keys[inp.offset :], bound, side="right"
                    )[0]
                ) + inp.offset
                if hi > inp.offset:
                    chunk.append(
                        (
                            inp.keys[inp.offset : hi],
                            inp.flags[inp.offset : hi],
                            inp.vals[inp.offset : hi],
                        )
                    )
                inp.offset = hi
                if inp.offset == len(inp.keys):
                    inp.keys = inp.flags = inp.vals = None
                    inp.block += 1
            keys, flags, vals = k_way_merge_flags(chunk, tree.value_size)
            if self.drop_tombstones:
                live = flags == 0
                keys, flags, vals = keys[live], flags[live], vals[live]
            if len(keys):
                self._buf.append((keys, flags, vals))
                self._buf_count += len(keys)
            while self._buf_count >= per_block and used < block_budget:
                used += self._flush_block(per_block)
        return used

    def _pop_buffered(self, count: int):
        keys = np.concatenate([b[0] for b in self._buf])
        flags = np.concatenate([b[1] for b in self._buf])
        vals = np.concatenate([b[2] for b in self._buf])
        take = (keys[:count], flags[:count], vals[:count])
        rest = keys[count:], flags[count:], vals[count:]
        self._buf = [rest] if len(rest[0]) else []
        self._buf_count = len(rest[0])
        return take

    def _flush_block(self, per_block: int) -> int:
        keys, flags, vals = self._pop_buffered(per_block)
        self.out_blocks.append(self.tree._write_one_block(keys, flags, vals))
        return 1

    def _finalize(self, per_block: int) -> int:
        used = 0
        while self._buf_count:
            used += self._flush_block(per_block)
        tree = self.tree
        level = self.level
        if tree.mlog is not None:
            for lvl, runs in ((level, self.inputs_a), (level + 1, self.inputs_b)):
                for run in runs:
                    tree.mlog.run_remove(tree.tree_id, lvl, run.id)
        for run in self.inputs_a + self.inputs_b:
            tree._release_run(run)
        # New seals may have landed at `level` during the job: keep them.
        drop = set(id(r) for r in self.inputs_a + self.inputs_b)
        tree.levels[level] = [
            r for r in tree.levels[level] if id(r) not in drop
        ]
        survivors = [
            r for r in tree.levels[level + 1] if id(r) not in drop
        ]
        if self.out_blocks:
            out = Run(blocks=self.out_blocks)
            out.id = tree._next_run_id
            tree._next_run_id += 1
            if tree.mlog is not None:
                tree.mlog.run_add(
                    tree.tree_id, level + 1, out.id,
                    [
                        (b.address, b.count, b.key_min, b.key_max)
                        for b in out.blocks
                    ],
                )
            tree.levels[level + 1] = [out] + survivors
        else:
            tree.levels[level + 1] = survivors
        self.done = True
        return used


# ----------------------------------------------------------------------
# Merges (reference: src/lsm/k_way_merge.zig, zig_zag_merge.zig).


def k_way_merge_flags(streams, value_size: int):
    """Merge (keys, flags, values) streams, NEWEST FIRST: the first
    stream containing a key wins.  Returns sorted unique arrays with
    tombstones retained.  Inputs are individually sorted+unique (run
    blocks and memtable batches are, by construction), which enables
    two fast paths: a single stream passes through, and streams with
    pairwise-disjoint key ranges concatenate without sorting."""
    streams = [s for s in streams if len(s[0])]
    if not streams:
        return (
            np.zeros(0, KEY_DTYPE), np.zeros(0, np.uint8),
            np.zeros((0, value_size), np.uint8),
        )
    if len(streams) == 1:
        return streams[0]
    ordered = sorted(streams, key=lambda s: s[0][0].tobytes())
    if all(
        ordered[i][0][-1].tobytes() < ordered[i + 1][0][0].tobytes()
        for i in range(len(ordered) - 1)
    ):
        return tuple(
            np.concatenate([s[j] for s in ordered]) for j in range(3)
        )
    # Native streaming merge (csrc/host/tb_lsm.inc): the streams are
    # already sorted, so C++ merges in O(n*k) 16-byte compares — far
    # cheaper than the void-dtype argsort over the concatenation the
    # numpy merge below pays.  That merge runs only under
    # TB_FASTPATH_DISABLE; a library that fails to build raises.
    from tigerbeetle_tpu_torch.runtime import fastpath

    if fastpath.available():
        return fastpath.kway_merge(streams, value_size)
    keys = np.concatenate([s[0] for s in streams])
    flags = np.concatenate([s[1] for s in streams])
    vals = np.concatenate([s[2] for s in streams])
    order = np.argsort(keys, kind="stable")  # stable: newer first per key
    keys, flags, vals = keys[order], flags[order], vals[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], flags[first], vals[first]


def k_way_merge(streams, value_size: int):
    """As k_way_merge_flags but tombstones dropped (query surface)."""
    keys, flags, vals = k_way_merge_flags(streams, value_size)
    live = flags == 0
    return keys[live], vals[live]


def zig_zag_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-key intersection (reference: src/lsm/zig_zag_merge.zig —
    vectorized equivalent of the leapfrog merge)."""
    return np.intersect1d(a.view(KEY_DTYPE), b.view(KEY_DTYPE))
