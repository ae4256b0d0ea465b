"""SuperBlock: 4-copy quorum-written root of persistent state.

This package's own copy of ``tigerbeetle_tpu/vsr/superblock.py``.

Keeps the reference's protocol (reference: src/vsr/superblock.zig:1-56,
superblock_quorums.zig): the superblock is written as 4 identical
copies; opening requires a quorum (2 of 4) of valid copies agreeing on
the highest sequence, so a crash mid-update can never lose both the
old and the new state.

State tracked (ours — the checkpoint reference is a grid-zone snapshot
blob instead of an LSM manifest):
- VSR state: view / log_view / commit_min / commit_max,
- checkpoint: op (`commit_min`), checksum of the prepare at that op,
  and the (offset, size, checksum) of the state snapshot in the grid
  zone (double-buffered A/B regions so a torn snapshot write leaves
  the previous checkpoint intact).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.constants import HEADER_SIZE
from tigerbeetle_tpu_torch.vsr import wire
from tigerbeetle_tpu_torch.vsr.storage import (
    SUPERBLOCK_COPIES,
    SUPERBLOCK_COPY_SIZE,
    Storage,
)

VIEW_HEADERS_MAX = 14  # canonical-suffix headers the superblock holds

SUPERBLOCK_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("cluster_lo", "<u8"), ("cluster_hi", "<u8"),
        ("sequence", "<u8"),
        ("replica", "<u2"), ("replica_count", "<u2"),
        ("view", "<u4"), ("log_view", "<u4"),
        ("version", "<u4"),
        ("commit_min", "<u8"),
        ("commit_max", "<u8"),
        ("commit_min_checksum_lo", "<u8"), ("commit_min_checksum_hi", "<u8"),
        ("checkpoint_offset", "<u8"),
        ("checkpoint_size", "<u8"),
        ("checkpoint_checksum_lo", "<u8"), ("checkpoint_checksum_hi", "<u8"),
        # Cluster membership (reconfiguration; reference:
        # src/vsr.zig:273-311): epoch + the slot->process permutation.
        # member_count == 0 means the identity default.
        ("epoch", "<u8"),
        ("member_count", "<u2"),
        ("members", "V64"),
        # Canonical log claim of the installed log_view: the highest
        # op the view's canonical said exists.  Restart must not
        # forget it — a recovering replica whose journal understates
        # the claim would send understating DVCs, and a view-change
        # quorum of understating DVCs truncated committed ops (VOPR
        # seed 1064614514; reference durably keeps its vsr_headers in
        # the superblock for the same reason).
        ("op_claimed", "<u8"),
        # Canonical suffix headers of the installed log_view (the
        # reference durably keeps `vsr_headers` in its superblock,
        # src/vsr/superblock.zig).  A replica that installed a
        # canonical tail but crashed before its journal ring durably
        # absorbed it would otherwise restart vouching the PRE-merge
        # siblings its ring still holds — at the freshest log_view,
        # where the merge trusts it most (the stale-carrier class,
        # VOPR seeds 925761995/941686528/199800160).  Persisting the
        # installed suffix atomically with log_view closes the gap:
        # restart re-vouches the canonical copies.
        ("vh_count", "<u2"),
        # The log_view at which the suffix was installed: passive view
        # entries advance log_view while KEEPING the suffix, so the
        # precedence rule in _tail_headers (ring entries prepared at
        # or after the install outrank the suffix) must compare
        # against the install point, not the current log_view.
        ("vh_log_view", "<u4"),
        ("view_headers", f"V{VIEW_HEADERS_MAX * HEADER_SIZE}"),
        # State root (state_machine/commitment.py): the 16-byte
        # incremental commitment of the account table at commit_min.
        # Recovery recomputes it from the restored snapshot and
        # asserts equality; the VOPR compares it cross-replica.  Zero
        # = no checkpoint taken yet / state machine without roots.
        # APPENDED (carved from reserved) so every earlier field keeps
        # its offset: an old data file decodes root=0 here, which the
        # restore assert treats as "not recorded" and skips.
        ("state_root_lo", "<u8"), ("state_root_hi", "<u8"),
        ("reserved",
         f"V{SUPERBLOCK_COPY_SIZE - 224 - VIEW_HEADERS_MAX * HEADER_SIZE}"),
    ]
)
assert SUPERBLOCK_DTYPE.itemsize == SUPERBLOCK_COPY_SIZE

QUORUM_OPEN = 2  # of SUPERBLOCK_COPIES


class SuperBlock:
    def __init__(self, storage: Storage, cluster: int) -> None:
        self.storage = storage
        self.cluster = cluster
        self.working = np.zeros(1, SUPERBLOCK_DTYPE)[0]

    # ------------------------------------------------------------------

    def format(self, replica: int, replica_count: int) -> None:
        h = np.zeros(1, SUPERBLOCK_DTYPE)[0]
        h["cluster_lo"] = self.cluster & 0xFFFFFFFFFFFFFFFF
        h["cluster_hi"] = self.cluster >> 64
        h["sequence"] = 1
        h["replica"] = replica
        h["replica_count"] = replica_count
        h["version"] = wire.VERSION
        h["commit_min"] = 0
        h["commit_max"] = 0
        root = wire.root_prepare(self.cluster)
        h["commit_min_checksum_lo"] = root["checksum_lo"]
        h["commit_min_checksum_hi"] = root["checksum_hi"]
        self._write(h)

    def checkpoint(
        self,
        commit_min: int,
        commit_min_checksum: int,
        commit_max: int,
        checkpoint_offset: int,
        checkpoint_size: int,
        checkpoint_checksum: int,
        view: int | None = None,
        log_view: int | None = None,
        epoch: int | None = None,
        members: list[int] | None = None,
        state_root: int = 0,
    ) -> None:
        """Durably advance to a new checkpoint (snapshot must already
        be synced in the grid zone — write ordering is the caller's
        contract)."""
        h = self.working.copy()
        h["sequence"] = int(h["sequence"]) + 1
        if epoch is not None:
            h["epoch"] = epoch
        if members is not None:
            assert len(members) <= 64
            h["member_count"] = len(members)
            h["members"] = bytes(members).ljust(64, b"\x00")
        h["commit_min"] = commit_min
        h["commit_max"] = commit_max
        h["commit_min_checksum_lo"] = commit_min_checksum & 0xFFFFFFFFFFFFFFFF
        h["commit_min_checksum_hi"] = commit_min_checksum >> 64
        h["checkpoint_offset"] = checkpoint_offset
        h["checkpoint_size"] = checkpoint_size
        h["checkpoint_checksum_lo"] = checkpoint_checksum & 0xFFFFFFFFFFFFFFFF
        h["checkpoint_checksum_hi"] = checkpoint_checksum >> 64
        h["state_root_lo"] = state_root & 0xFFFFFFFFFFFFFFFF
        h["state_root_hi"] = state_root >> 64
        if view is not None:
            h["view"] = view
        if log_view is not None:
            h["log_view"] = log_view
        self._write(h)

    def view_change(self, view: int, log_view: int, commit_max: int,
                    op_claimed: int | None = None,
                    view_headers: list[bytes] | None = None) -> None:
        """Durably record a view change (required before participating
        in the new view — reference: superblock view_change trigger).
        `op_claimed` records the installed canonical log claim of
        log_view (overwrites — it belongs to that log_view).
        `view_headers` (raw 256-byte wire headers, ascending op)
        overwrites the persisted canonical suffix; None keeps the
        previous set (it still belongs to the unchanged log_view)."""
        h = self.working.copy()
        h["sequence"] = int(h["sequence"]) + 1
        h["view"] = view
        h["log_view"] = log_view
        h["commit_max"] = max(int(h["commit_max"]), commit_max)
        if op_claimed is not None:
            h["op_claimed"] = op_claimed
        if view_headers is not None:
            # Keep the HIGHEST ops when the suffix overflows: stale
            # siblings that no chain link can pin live only in the
            # uncommitted range above the merge's commit floor, which
            # the pipeline bounds at 8 ops (< VIEW_HEADERS_MAX).  Ops
            # further down are committed cluster-wide — a stale ring
            # sibling there is caught by the canonical chain walk and
            # repaired by the exact checksum the op above vouches.
            suffix = view_headers[-VIEW_HEADERS_MAX:]
            h["vh_count"] = len(suffix)
            h["vh_log_view"] = log_view
            h["view_headers"] = b"".join(suffix).ljust(
                VIEW_HEADERS_MAX * HEADER_SIZE, b"\x00"
            )
        self._write(h)

    def view_headers(self) -> list[bytes]:
        """The persisted canonical suffix of the current log_view."""
        n = int(self.working["vh_count"])
        raw = bytes(self.working["view_headers"])
        return [
            raw[i * HEADER_SIZE:(i + 1) * HEADER_SIZE] for i in range(n)
        ]

    def _write(self, h: np.ndarray) -> None:
        payload = h.tobytes()[16:]
        c = wire.checksum(payload)
        h["checksum_lo"] = c & 0xFFFFFFFFFFFFFFFF
        h["checksum_hi"] = c >> 64
        raw = h.tobytes()
        for copy in range(SUPERBLOCK_COPIES):
            self.storage.write(
                self.storage.layout.superblock_offset + copy * SUPERBLOCK_COPY_SIZE,
                raw,
            )
        self.storage.sync()
        self.working = h

    # ------------------------------------------------------------------

    def open(self) -> np.ndarray:
        """Quorum read: highest sequence with >= QUORUM_OPEN agreeing
        valid copies wins.

        With cluster=None the superblock adopts the cluster id found
        in the file (`tigerbeetle start` doesn't ask the operator to
        repeat what `format` already recorded — reference:
        src/tigerbeetle/main.zig start reads it from the superblock)."""
        copies = []
        for copy in range(SUPERBLOCK_COPIES):
            raw = self.storage.read(
                self.storage.layout.superblock_offset + copy * SUPERBLOCK_COPY_SIZE,
                SUPERBLOCK_COPY_SIZE,
            )
            h = np.frombuffer(raw, SUPERBLOCK_DTYPE)[0]
            if self._valid(h):
                copies.append(h)
        by_checksum: dict[int, list[np.ndarray]] = {}
        for h in copies:
            key = int(h["checksum_lo"]) | (int(h["checksum_hi"]) << 64)
            by_checksum.setdefault(key, []).append(h)
        quorums = [
            group[0]
            for group in by_checksum.values()
            if len(group) >= QUORUM_OPEN
        ]
        if not quorums:
            raise RuntimeError(
                "superblock: no quorum of valid copies"
                + (
                    f" for cluster {self.cluster} (data file formatted for"
                    " a different cluster?)"
                    if self.cluster is not None and self._any_other_cluster()
                    else ""
                )
            )
        self.working = max(quorums, key=lambda h: int(h["sequence"])).copy()
        if self.cluster is None:
            self.cluster = int(self.working["cluster_lo"]) | (
                int(self.working["cluster_hi"]) << 64
            )
        return self.working

    def _any_other_cluster(self) -> bool:
        """True if any copy is checksum-valid under SOME cluster id
        other than ours (diagnostic for the mismatch error; a copy
        valid under our OWN cluster means corruption, not mismatch)."""
        saved, self.cluster = self.cluster, None
        try:
            for copy in range(SUPERBLOCK_COPIES):
                raw = self.storage.read(
                    self.storage.layout.superblock_offset
                    + copy * SUPERBLOCK_COPY_SIZE,
                    SUPERBLOCK_COPY_SIZE,
                )
                h = np.frombuffer(raw, SUPERBLOCK_DTYPE)[0]
                if self._valid(h):
                    found = int(h["cluster_lo"]) | (
                        int(h["cluster_hi"]) << 64
                    )
                    if found != saved:
                        return True
            return False
        finally:
            self.cluster = saved

    def _valid(self, h: np.ndarray) -> bool:
        payload = h.tobytes()[16:]
        c = wire.checksum(payload)
        if int(h["checksum_lo"]) != c & 0xFFFFFFFFFFFFFFFF:
            return False
        if int(h["checksum_hi"]) != c >> 64:
            return False
        cluster = int(h["cluster_lo"]) | (int(h["cluster_hi"]) << 64)
        cluster_ok = self.cluster is None or cluster == self.cluster
        return cluster_ok and int(h["version"]) == wire.VERSION
