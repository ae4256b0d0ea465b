"""Forest: owns every groove's trees; open/compact/checkpoint.

This package's own copy of ``tigerbeetle_tpu/lsm/forest.py``.

reference: src/lsm/forest.zig:31,324,375,547 — the forest opens from
the manifest log, paces compaction, and checkpoints all trees plus the
free set.  Run/block metadata persists through the append-only,
self-compacting manifest LOG in grid blocks (lsm/manifest_log.py;
reference: src/lsm/manifest_log.zig): each checkpoint appends only the
run add/remove events since the last one, so checkpoint cost is
O(delta) even when the forest holds millions of blocks.  The checkpoint
blob carries just the log's block addresses, any unflushed tail
events, per-tree memtable batches, and the free set (snapshot codec —
no pickle anywhere in the durable path).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.lsm.groove import Groove
from tigerbeetle_tpu_torch.lsm.manifest_log import ManifestLog
from tigerbeetle_tpu_torch.utils import snapshot as snapcodec
from tigerbeetle_tpu_torch.vsr.free_set import FreeSet
from tigerbeetle_tpu_torch.vsr.grid import Grid
from tigerbeetle_tpu_torch.vsr.storage import Storage


class Forest:
    def __init__(self, storage: Storage, *, block_size: int = 1 << 16,
                 block_count: int = 1 << 12, base_offset: int | None = None,
                 memtable_max: int = 8192,
                 cache_blocks: int | None = None) -> None:
        # The grid cache absorbs compaction's read-back of recently
        # written runs.  The file-backed default (4096 x 64KiB =
        # 256MiB) mirrors the reference's GiB-scale grid cache
        # (src/vsr/grid.zig cache sizing): where the OS page cache is
        # evicted under memory pressure, a grid pread costs a real disk
        # read (milliseconds) without it.  Memory backends
        # (tests, fuzz clusters) keep a small cache — their reads are
        # already RAM copies, and dozens of in-process replicas must
        # not each pin 256MiB.
        if cache_blocks is None:
            cache_blocks = (
                4096
                if getattr(storage, "supports_async_writeback", False)
                else 256
            )
        self.grid = Grid(
            storage, block_size=block_size, block_count=block_count,
            base_offset=base_offset, cache_blocks=cache_blocks,
        )
        self.memtable_max = memtable_max
        self.grooves: dict[str, Groove] = {}
        self.mlog = ManifestLog(self.grid)
        # tree_id -> Tree, assigned in groove-creation order (stable
        # across restarts because grooves are re-declared identically
        # before open()).
        self._trees: list = []
        self._beat_cursor = 0

    def groove(self, name: str, *, object_size: int,
               index_fields: list[str], index_value_size: int = 1) -> Groove:
        assert name not in self.grooves
        g = Groove(
            self.grid, name, object_size=object_size,
            index_fields=index_fields, memtable_max=self.memtable_max,
            index_value_size=index_value_size,
        )
        self.grooves[name] = g
        for tree in (g.id_tree, g.object_tree, *g.indexes.values()):
            tree.tree_id = len(self._trees)
            tree.mlog = self.mlog
            self._trees.append(tree)
        return g

    def compact(self) -> None:
        for g in self.grooves.values():
            g.maybe_seal()

    def compact_beat(self, block_budget: int = 16) -> int:
        """One beat of paced compaction: advance pending merges by at
        most `block_budget` grid blocks across all trees, round-robin
        from where the last beat stopped (reference:
        src/lsm/forest.zig:846 CompactionPipeline beats).  Driven once
        per commit by the replica — commit-count pacing keeps replicas
        deterministic."""
        used = 0
        n = len(self._trees)
        for k in range(n):
            if used >= block_budget:
                break
            tree = self._trees[(self._beat_cursor + k) % n]
            used += tree.compact_beat(block_budget - used)
        self._beat_cursor = (self._beat_cursor + 1) % max(1, n)
        return used

    def compaction_pending(self) -> bool:
        return any(t.compaction_pending() for t in self._trees)

    def manifest_blob(self) -> bytes:
        """Pure snapshot: log addresses + unflushed tail + memtable
        batches + free set + in-flight merge outputs.  Mutates nothing
        (mid-interval snapshots and the convergence checkers call this
        between checkpoints).

        `orphans`: output blocks of merges still in flight.  The free
        set counts them allocated but no manifest entry references
        them; a restore releases them and the merge restarts from its
        (still-referenced) inputs — which is what lets checkpoints
        proceed WITHOUT draining compaction."""
        orphans = []
        for tree in self._trees:
            if tree._job is not None:
                orphans.extend(b.address for b in tree._job.out_blocks)
        return snapcodec.encode_tree(
            {
                "log_addrs": np.array(self.mlog.blocks, np.uint64),
                "log_tail": self.mlog.tail_bytes(),
                "memtables": {
                    str(t.tree_id): t.memtable_manifest()
                    for t in self._trees
                },
                "free_set": self.grid.free_set.encode(),
                "block_count": self.grid.block_count,
                "orphans": np.array(orphans, np.uint64),
            }
        )

    def checkpoint(self) -> bytes:
        """Seal all memtables (bounds the blob), finish any ACTIVE
        merge jobs, flush+compact the manifest log, release staged
        blocks, and return the checkpoint blob.

        Draining only the in-flight jobs — not every over-full level —
        keeps checkpoints deterministic cluster-wide (no job ever
        crosses a checkpoint, so blobs are state-functions; a crashed
        replica restoring the blob converges with one that kept
        running) while the latency stays bounded: an active job is at
        most one level merge, and the disjoint-range moves that
        dominate the big trees are metadata-only.  Remaining over-full
        levels start their merges in the next interval's beats."""
        for tree in self._trees:
            tree.seal_memtable()
            while tree._job is not None:
                tree.compact_beat(1 << 30)
        # Log flush acquires blocks BEFORE staged releases activate, so
        # blocks referenced by the previous superblock are never
        # overwritten inside this checkpoint's crash window.
        self.mlog.checkpoint()
        self.grid.free_set.checkpoint()
        return self.manifest_blob()

    def open(self, blob: bytes) -> None:
        # Cancel any in-flight merges from the pre-restore state: a
        # stale job would release blocks and log manifest events
        # against the RESTORED free set/manifest (double-free).  Its
        # partially-written output blocks are unreferenced in the
        # restored state and simply get reused.
        for tree in self._trees:
            tree._job = None
        self._beat_cursor = 0
        state = snapcodec.decode_tree(blob)
        self.grid.free_set = FreeSet.decode(
            state["free_set"], state["block_count"]
        )
        # Merge outputs that were in flight at checkpoint time: no
        # manifest entry references them — reclaim (staged; activates
        # at the next checkpoint, so re-crashing re-releases them
        # idempotently from the same blob).
        for addr in state.get("orphans", np.zeros(0, np.uint64)):
            self.grid.free_set.release(int(addr))
        runs = self.mlog.open(
            [int(a) for a in state["log_addrs"]], state["log_tail"]
        )
        per_tree: dict[int, dict] = {}
        for (tree_id, level, run_id), refs in runs.items():
            per_tree.setdefault(tree_id, {})[(level, run_id)] = refs
        memtables = state.get("memtables", {})
        for tree in self._trees:
            tree.restore_runs(per_tree.get(tree.tree_id, {}))
            tree.restore_memtable(memtables.get(str(tree.tree_id), {}))
