"""Append-only, self-compacting manifest log in grid blocks.

This package's own copy of ``tigerbeetle_tpu/lsm/manifest_log.py``.

reference: src/lsm/manifest_log.zig:1-40 — instead of rewriting every
tree's table list at each checkpoint (O(total runs), which grows with
state), the forest appends only the run add/remove EVENTS since the
last checkpoint, and the log compacts itself (rewrites live state as
fresh snapshot events, releasing old blocks) once dead events
dominate.  The checkpoint blob then carries only the log's block
addresses: O(delta) per checkpoint.

Event wire format (little-endian), one record per run event:
    tree_id  u16
    op       u8   (1 = run_add, 2 = run_remove)
    level    u8
    run_id   u32  (tree-scoped, assigned by Tree in creation order)
    n_blocks u32  (run_add only; 0 for run_remove)
    then n_blocks x block refs:
        addr u64 | count u64 | key_min 16B | key_max 16B

Replay applies events in log order; runs within a level order by
run_id (creation order == newest-last, the merge priority the trees
rely on).
"""

from __future__ import annotations

import struct

import numpy as np

_EV_HEAD = struct.Struct("<HBBII")
_BLOCK_REF = struct.Struct("<QQ16s16s")

OP_ADD = 1
OP_REMOVE = 2
OP_ADD_CONT = 3  # continuation: extends the refs of a prior OP_ADD

class ManifestLog:
    def __init__(self, grid) -> None:
        self.grid = grid
        # A single event record must fit one grid-block payload (4-byte
        # record count + event head + refs); runs with more blocks
        # split into OP_ADD + OP_ADD_CONT records.
        self._refs_per_event = (
            grid.payload_size - 4 - _EV_HEAD.size
        ) // _BLOCK_REF.size
        assert self._refs_per_event >= 1, grid.payload_size
        # Closed log blocks (addresses, oldest first).
        self.blocks: list[int] = []
        # Open tail: encoded event records not yet written to a block.
        self._tail: list[bytes] = []
        # Live-state accounting for the compaction trigger.
        self._events_total = 0
        self._runs_live = 0

    # -- event intake (called by trees through the forest) --------------

    def run_add(self, tree_id: int, level: int, run_id: int, blocks) -> None:
        """blocks: iterable of (addr, count, key_min bytes, key_max)."""
        refs = [
            _BLOCK_REF.pack(addr, count, kmin, kmax)
            for addr, count, kmin, kmax in blocks
        ]
        for at in range(0, max(len(refs), 1), self._refs_per_event):
            chunk = refs[at : at + self._refs_per_event]
            op = OP_ADD if at == 0 else OP_ADD_CONT
            self._tail.append(
                _EV_HEAD.pack(tree_id, op, level, run_id, len(chunk))
                + b"".join(chunk)
            )
            self._events_total += 1
        self._runs_live += 1

    def run_remove(self, tree_id: int, level: int, run_id: int) -> None:
        self._tail.append(_EV_HEAD.pack(tree_id, OP_REMOVE, level, run_id, 0))
        self._events_total += 1
        self._runs_live -= 1

    # -- checkpoint ------------------------------------------------------

    def checkpoint(self) -> list[int]:
        """Flush tail events into grid blocks; compact the whole log
        when dead events outnumber live runs (evaluated BEFORE the
        flush, so a compacting checkpoint never writes the tail twice).
        Returns the block address list to persist in the blob."""
        if self._events_total > 2 * max(self._runs_live, 8):
            self._compact()
        else:
            self._flush_tail()
        return list(self.blocks)

    def _flush_tail(self) -> None:
        if not self._tail:
            return
        payload_max = self.grid.payload_size - 4
        chunks: list[list[bytes]] = [[]]
        size = 0
        for rec in self._tail:
            if size + len(rec) > payload_max:
                chunks.append([])
                size = 0
            chunks[-1].append(rec)
            size += len(rec)
        self._tail = []
        fs = self.grid.free_set
        reservation = fs.reserve(len(chunks))
        for recs in chunks:
            body = b"".join(recs)
            address = fs.acquire(reservation)
            self.grid.write_block(
                address, len(recs).to_bytes(4, "little") + body, block_type=2
            )
            self.blocks.append(address)
        fs.forfeit(reservation)

    def _compact(self) -> None:
        """Rewrite the live state (blocks + unflushed tail) as fresh
        snapshot events and release every old log block (reference:
        manifest_log.zig compacts its own blocks the same way)."""
        state = self._replay(include_tail=True)
        old = self.blocks
        self.blocks = []
        self._tail = []
        self._events_total = 0
        self._runs_live = 0
        for (tree_id, level, run_id), blocks in sorted(state.items()):
            self.run_add(tree_id, level, run_id, blocks)
        self._flush_tail()
        for address in old:
            self.grid.free_set.release(address)

    def tail_bytes(self) -> bytes:
        """Unflushed tail events, encoded like a block payload — the
        PURE mid-interval snapshot carries these alongside the block
        addresses (flushing would mutate the grid)."""
        return len(self._tail).to_bytes(4, "little") + b"".join(self._tail)

    # -- open ------------------------------------------------------------

    def open(self, addresses: list[int], tail: bytes = b"") -> dict:
        """Replay the log (+ an optional unflushed tail from a
        mid-interval snapshot) -> {(tree_id, level, run_id): [block
        refs]}, adopting addresses + tail as the current contents."""
        self.blocks = list(addresses)
        self._tail = []
        if len(tail) > 4:
            n = int.from_bytes(tail[:4], "little")
            at = 4
            for _ in range(n):
                head = _EV_HEAD.unpack_from(tail, at)
                size = _EV_HEAD.size + head[4] * _BLOCK_REF.size
                self._tail.append(tail[at : at + size])
                at += size
        state, n_events = self._replay(include_tail=True, count_events=True)
        self._events_total = n_events
        self._runs_live = len(state)
        return state

    def _replay(self, include_tail: bool = False, count_events: bool = False):
        state: dict = {}
        n_events = 0

        def apply(payload: bytes) -> None:
            nonlocal n_events
            n = int.from_bytes(payload[:4], "little")
            at = 4
            for _ in range(n):
                tree_id, op, level, run_id, n_blocks = _EV_HEAD.unpack_from(
                    payload, at
                )
                at += _EV_HEAD.size
                n_events += 1
                if op in (OP_ADD, OP_ADD_CONT):
                    refs = []
                    for _b in range(n_blocks):
                        addr, count, kmin, kmax = _BLOCK_REF.unpack_from(
                            payload, at
                        )
                        at += _BLOCK_REF.size
                        refs.append((addr, count, kmin, kmax))
                    key = (tree_id, level, run_id)
                    if op == OP_ADD:
                        state[key] = refs
                    else:
                        state[key].extend(refs)
                elif op == OP_REMOVE:
                    state.pop((tree_id, level, run_id), None)
                else:
                    raise ValueError(f"manifest log: unknown op {op}")

        for address in self.blocks:
            apply(self.grid.read_block(address))
        if include_tail:
            apply(self.tail_bytes())
        if count_events:
            return state, n_events
        return state
