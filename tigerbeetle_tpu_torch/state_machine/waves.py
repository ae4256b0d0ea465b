"""Conflict-aware wave execution and its speculative front end.

Counterpart of ``tigerbeetle_tpu/state_machine/waves.py``.  The exact
scan (K3) pays one serial step per EVENT; a batch whose events mostly
touch disjoint accounts need not.  A host partitioner (``plan_waves``,
numpy, copied from the reference) builds the batch's conflict graph and
gives each event a level; each level executes as ONE parallel wave
step over its index set (kernel K7, ``csrc/wave_step.cu``), runs of
mutually independent linked chains execute one chain position at a
time (kernel K8, ``csrc/chain_wave.cu``), and what is truly serial
runs through K3's resumable scan segments at its batch position.  All
segment kinds thread ONE carry — K3's scratch buffer (``kernel.
carry_views``) — and the (A, 8) table, updated in place, so the outputs
are bit for bit the full scan's.

The speculative front end (the device engine's default) executes the
WHOLE batch as one wave step behind an on-device conflict validation
(kernel K9, ``csrc/spec_conflicts.cu``: the wavefront's round-0 test),
commits the validated lanes (K7 with a commit mask) and replays only
the conflicted residue through a ``plan_residue`` plan.

Every kernel has its plain PyTorch version here (``wave_step_plain``,
``chain_wave_plain``, ``spec_conflicts_plain``; K3's are in
``kernel.py``): a wrapper launches the kernel on CUDA tensors and runs
the plain version on CPU tensors.  The executors (``_execute_plan``,
``run_speculative_engine``, ``continue_plan_engine``,
``finalize_engine``) upload the batch's (B, 52) event matrix once and
pass each segment as an int32 index list (a (P, C) index plane for a
chain wave) instead of re-gathering columns per segment.  The
reference pads segments to compile-cache buckets (``_SEG_BUCKETS``);
padding lanes are inactive and write nothing, so the port drops it.

The row-sharded executor (``_execute_plan_sharded``, at the end of the
module) runs the same kernels over the shard tables of a ("shard",)
mesh (``parallel/sharded.py``): it gathers the rows a batch can touch
into a compact table once (kernel K14), runs the dense executor there
with the batch's slots remapped, and writes the rows back onto their
owners.  A row-sharded device engine runs its wave records through it
(``run_plan_engine`` with the engine's mesh).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck, kernels
from tigerbeetle_tpu_torch.ops import u128 as w
from tigerbeetle_tpu_torch.ops.u128 import MASK32, from_u64, s64, ult
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import kernel
from tigerbeetle_tpu_torch.state_machine.kernel import (
    AF_CR_LIMIT,
    AF_DR_LIMIT,
    COL,
    CREATED_FIELDS,
    F_BAL_CR,
    F_BAL_DR,
    F_LINKED,
    F_PENDING,
    F_POST,
    F_VOID,
    NS_PER_S,
    S_EXPIRED,
    S_PENDING,
    S_POSTED,
    S_VOIDED,
    U64_MAX,
)

def min_ratio() -> float:
    """Minimum step-count reduction (batch length / executed steps)
    before the wave path beats the plain scan; below it the partition
    degrades toward per-event waves and the scan's single fused
    dispatch wins.  Read live (like mode()) so tests and bench arms
    can toggle TB_WAVES_MIN_RATIO after import."""
    return envcheck.env_float("TB_WAVES_MIN_RATIO", 2.0, minimum=0.0)


def mode() -> str:
    """TB_WAVES routing mode of the host exact path (the reference's,
    read live):

    - unset/"auto": the host fast lane takes the batches it can, and a
      batch bound for the exact scan is planned first; the plan runs
      when admitted and profitable.
    - "0": off — the exact path always runs the B-step scan.
    - "1": force — route every batch to the exact path (bypassing the
      mirror's order-free lane) and execute the wave plan even when
      unprofitable: the differential tests' routing.
    - "exact": route to the exact path like "1", but keep the
      profitability and admission decision.
    - "scan": route to the exact path, never plan waves — the pure
      sequential scan on identical routing, the control arm."""
    return envcheck.env_choice(
        "TB_WAVES", "auto", ("auto", "0", "1", "exact", "scan")
    )


def dev_mode() -> str:
    """TB_DEV_WAVES routing mode of the device engine's window
    (independent of TB_WAVES, which governs the host exact path):

    - unset/"auto": window batches that fall off the semantic kernels
      (K1, K5, K6) are speculated or wave-dispatched against the
      device table when admitted (and, planned up front, profitable);
      a decline drains the window and takes the exact host path.
    - "0": off — off-kernel batches always drain to the host.
    - "1": force — execute every ADMITTED plan even when unprofitable
      (admission is never bypassed: it is the correctness proof)."""
    return envcheck.env_choice("TB_DEV_WAVES", "auto", ("auto", "0", "1"))


def spec_mode() -> str:
    """TB_WAVES_SPECULATE routing mode for the device wave dispatcher
    (see envcheck.waves_speculate for the full contract): "auto"/"1"
    speculate behind the residue-cap gate, "0" keeps the pessimistic
    plan-first path, "force" routes every window batch optimistically.
    Read live (like mode()) so tests and bench arms can toggle it
    after import."""
    return envcheck.waves_speculate()


def spec_residue_cap() -> float:
    """TB_WAVES_SPEC_RESIDUE_CAP, read live (envcheck-validated)."""
    return envcheck.spec_residue_cap()


def chain_max() -> int:
    """TB_WAVES_CHAIN_MAX: longest chain (in positions) a chain-wave
    segment may carry — longer chains keep the exact scan, whose cost
    is one step per member.  0 disables chain waves entirely.  Read
    live so tests and bench arms can toggle it after import."""
    return envcheck.env_int(
        "TB_WAVES_CHAIN_MAX", 64, minimum=0, maximum=4096
    )


# ---------------------------------------------------------------------------
# Partitioner.


@dataclass
class WavePlan:
    """Execution plan: ordered segments whose index sets cover [0, n).

    Segment order is the EXECUTION order; a "wave" segment's indices
    need not be contiguous (topological-level scheduling), a "scan"
    segment is always a contiguous chain run executed at its batch
    position, and a "chains" segment is a contiguous run of mutually
    independent linked chains executed position-stepped (one device
    step per chain POSITION — `chain_steps` holds the padded step
    count per segment index).
    """

    n: int
    # (kind, idx): kind "wave" = one parallel step over idx (int
    # array, ascending), kind "scan" = len(idx) exact sequential
    # steps over a contiguous run, kind "chains" = chain_steps[k]
    # position steps over a contiguous run of independent chains.
    segments: list = field(default_factory=list)
    wave_mask: np.ndarray | None = None  # events whose snapshots are
    # rewritten to batch finals (wave + chain-wave events)
    chain_steps: dict = field(default_factory=dict)
    # Host-integer sum of the batch's per-event amount bounds — the
    # admission term a later window batch must count while this one is
    # in flight (set by gpu._plan_wave_execution).
    batch_bound: int = 0

    @property
    def n_waves(self) -> int:
        return sum(1 for k, _ in self.segments if k == "wave")

    @property
    def parallel_events(self) -> int:
        return sum(len(ix) for k, ix in self.segments if k == "wave")

    @property
    def n_steps(self) -> int:
        """Device-step equivalents: 1 per wave, length per scan run,
        padded position count per chain-wave run."""
        total = 0
        for k, (kind, ix) in enumerate(self.segments):
            if kind == "wave":
                total += 1
            elif kind == "chains":
                total += self.chain_steps[k]
            else:
                total += len(ix)
        return total

    @property
    def ratio(self) -> float:
        return self.n / max(1, self.n_steps)

    def profitable(self, ratio_floor: float | None = None) -> bool:
        return self.ratio >= (
            min_ratio() if ratio_floor is None else ratio_floor
        )


# How many wavefront rounds the vectorized level assigner runs before
# handing the region to the Python-walk fallback: profitable plans
# have FEW levels (the ratio gate needs n / steps >= min_ratio), so a
# region still unassigned after this many rounds is serial enough that
# the O(n) walk is the cheaper exact algorithm.
_WAVEFRONT_CAP = 24


def _inb_pv_write_pairs(n: int, meta: dict):
    """(event, slot) pairs for in-batch post/voids: the slot union of
    the id-group each finalizer's pending reference names (the creator
    is whichever group member applied, so the finalizer's static write
    set is the union).  Shared by the partitioner's conflict entries
    and the per-column overflow admission (gpu.py)."""
    inb = meta["inb_pv"]
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    if not inb.any():
        return empty
    id_group = meta["id_group"]
    ref = np.unique(meta["p_group"][inb])
    member = np.isin(id_group, ref)
    g2 = np.concatenate([id_group[member], id_group[member]])
    s2 = np.concatenate([meta["ev_dr"][member], meta["ev_cr"][member]])
    keep = s2 >= 0
    g2, s2 = g2[keep], s2[keep]
    if len(g2) == 0:
        return empty
    span = int(s2.max()) + 2
    key = np.unique(g2 * span + s2)
    pg, ps = key // span, key % span
    evs = np.flatnonzero(inb)
    lo = np.searchsorted(pg, meta["p_group"][evs], side="left")
    hi = np.searchsorted(pg, meta["p_group"][evs], side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return empty
    out_ev = np.repeat(evs, cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    out_slot = ps[np.repeat(lo, cnt) + within]
    return out_ev.astype(np.int64), out_slot.astype(np.int64)


def _levels_walk(lo: int, hi: int, meta: dict, group_slots) -> np.ndarray:
    """Per-event Python walk over region [lo, hi) — the REFERENCE
    level assignment (the vectorized wavefront must agree exactly;
    tests/test_device_waves.py fuzzes the two against each other) and
    the fallback for regions more serial than _WAVEFRONT_CAP levels.

    Level = 1 + max level of every earlier conflicting event: same-id
    claims (exists ladder), pending refs, first-wins finalize targets,
    then balance-slot RAW/WAR (a reader must see exactly the earlier
    writers' adds; later writers must apply after it reads).  Reads
    also serialize against earlier reads — a balancing/limit reader's
    own writes are data-dependent, and the greedy rule this
    generalizes kept reader pairs ordered.
    """
    id_group = meta["id_group"]
    p_group = meta["p_group"]
    p_tgt = meta["p_tgt"]
    writes0, writes1 = meta["writes0"], meta["writes1"]
    reads0, reads1 = meta["reads0"], meta["reads1"]
    inb_pv = meta["inb_pv"]
    group_level: dict[int, int] = {}
    ptgt_level: dict[int, int] = {}
    write_level: dict[int, int] = {}
    read_level: dict[int, int] = {}
    levels = np.zeros(hi - lo, np.int32)
    for e in range(lo, hi):
        g = int(id_group[e])
        pg = int(p_group[e])
        pt = int(p_tgt[e])
        ww = []
        if writes0[e] >= 0:
            ww.append(int(writes0[e]))
        if writes1[e] >= 0:
            ww.append(int(writes1[e]))
        if inb_pv[e]:
            ww.extend(group_slots.get(pg, ()))
        rr = []
        if reads0[e] >= 0:
            rr.append(int(reads0[e]))
        if reads1[e] >= 0:
            rr.append(int(reads1[e]))

        lvl = group_level.get(g, -1) + 1
        if pg >= 0:
            lvl = max(lvl, group_level.get(pg, -1) + 1)
        if pt >= 0:
            lvl = max(lvl, ptgt_level.get(pt, -1) + 1)
        for s in rr:
            lvl = max(
                lvl,
                write_level.get(s, -1) + 1,
                read_level.get(s, -1) + 1,
            )
        for s in ww:
            lvl = max(lvl, read_level.get(s, -1) + 1)

        levels[e - lo] = lvl
        if lvl > group_level.get(g, -1):
            group_level[g] = lvl
        if pg >= 0 and lvl > group_level.get(pg, -1):
            group_level[pg] = lvl
        if pt >= 0 and lvl > ptgt_level.get(pt, -1):
            ptgt_level[pt] = lvl
        for s in ww:
            if lvl > write_level.get(s, -1):
                write_level[s] = lvl
        for s in rr:
            if lvl > read_level.get(s, -1):
                read_level[s] = lvl
    return levels


def _levels_wavefront(
    lo: int, hi: int, meta: dict, inb_ev, inb_slot, cap: int = None
) -> np.ndarray | None:
    """Vectorized level assignment for region [lo, hi): Kahn's
    algorithm by level over the conflict DAG.  At round k every
    still-unassigned event with no unassigned predecessor takes level
    k — which equals the walk's greedy level exactly (a predecessor's
    level is strictly below its successors', so "all predecessors
    assigned" first becomes true at round 1 + max pred level).

    Per round the blocked test is a segmented min over sorted-by-token
    entry arrays: for a serial token (id/pending-group claim,
    first-wins target) only the minimum-index unassigned claimant is
    unblocked; for a balance slot a reader is unblocked only as the
    minimum-index unassigned toucher, a writer when no unassigned
    reader precedes it (commuting writers share a round).  Rounds cost
    O(entries) vectorized; plans worth executing have few levels, so a
    region still unassigned after `cap` rounds returns None and the
    caller uses the O(n) walk.
    """
    if cap is None:
        cap = _WAVEFRONT_CAP
    m = hi - lo
    if m <= 1:
        return np.zeros(m, np.int32)
    rel = np.arange(m, dtype=np.int64)
    # Serial tokens: even ids = id/pending groups, odd = durable
    # first-wins targets (namespaces never collide).
    id_group = meta["id_group"][lo:hi]
    s_tok = [2 * id_group]
    s_ev = [rel]
    pg = meta["p_group"][lo:hi]
    msk = pg >= 0
    s_tok.append(2 * pg[msk])
    s_ev.append(rel[msk])
    pt = meta["p_tgt"][lo:hi]
    msk = pt >= 0
    s_tok.append(2 * pt[msk] + 1)
    s_ev.append(rel[msk])
    ser_tok = np.concatenate(s_tok)
    ser_ev = np.concatenate(s_ev)
    _, ser_tok = np.unique(ser_tok, return_inverse=True)
    n_ser = int(ser_tok.max()) + 1

    # Slot entries: (slot, event, role).
    sl, se, sr = [], [], []
    for name, is_read in (
        ("reads0", True), ("reads1", True),
        ("writes0", False), ("writes1", False),
    ):
        a = meta[name][lo:hi]
        msk = a >= 0
        sl.append(a[msk])
        se.append(rel[msk])
        sr.append(np.full(int(msk.sum()), is_read))
    if len(inb_ev):
        msk = (inb_ev >= lo) & (inb_ev < hi)
        sl.append(inb_slot[msk])
        se.append(inb_ev[msk] - lo)
        sr.append(np.zeros(int(msk.sum()), bool))
    slot = np.concatenate(sl)
    sev = np.concatenate(se)
    sread = np.concatenate(sr)
    have_slots = len(slot) > 0
    if have_slots:
        _, slot = np.unique(slot, return_inverse=True)
        n_slot = int(slot.max()) + 1

    levels = np.full(m, -1, np.int32)
    un = np.ones(m, bool)
    big = np.int64(m)
    for lvl in range(cap):
        blk = np.zeros(m, bool)
        act = un[ser_ev]
        t_min = np.full(n_ser, big, np.int64)
        np.minimum.at(t_min, ser_tok[act], ser_ev[act])
        e_act = ser_ev[act]
        np.logical_or.at(blk, e_act, e_act > t_min[ser_tok[act]])
        if have_slots:
            sact = un[sev]
            a_min = np.full(n_slot, big, np.int64)
            np.minimum.at(a_min, slot[sact], sev[sact])
            r_min = np.full(n_slot, big, np.int64)
            ract = sact & sread
            np.minimum.at(r_min, slot[ract], sev[ract])
            es = sev[sact]
            lim = np.where(
                sread[sact], a_min[slot[sact]], r_min[slot[sact]]
            )
            np.logical_or.at(blk, es, es > lim)
        take = un & ~blk
        if not take.any():
            # The DAG is acyclic (edges point forward), so this is
            # unreachable while events remain — guard anyway.
            return None
        levels[take] = lvl
        un &= ~take
        if not un.any():
            return levels
    return None


def _chain_wave_steps(i: int, j: int, n: int, meta: dict, claims):
    """Chain-wave admission for the chain run [i, j): the padded
    position-step count when the run's chains may execute
    position-stepped, else None (keep the exact scan).

    Requirements — each guards a specific exactness argument:
    - no must-scan members (history snapshots are semantically read)
      and no post/void members (first-wins + rollback un-finalize
      would couple chains);
    - every member's id-group is claimed exactly once batch-wide
      (fresh-or-durable-dup ids, never referenced by another event:
      a rolled-back member's created-record registration can then
      never feed a later exists/pending merge);
    - chains are pairwise independent: a balance slot touched by two
      different chains must have NO reader (commuting adds may share;
      a read coupled to another chain's writes — or its rollback —
      would diverge from the sequential order);
    - the longest chain fits the TB_WAVES_CHAIN_MAX cap, and the
      padded step count actually beats the scan's one step/member.
    """
    cap = chain_max()
    if cap < 2:
        return None
    if meta["chain_serial"][i:j].any() or meta["is_pv"][i:j].any():
        return None
    if (claims[meta["id_group"][i:j]] != 1).any():
        return None
    linked = meta["linked"][i:j]
    m = j - i
    starts = np.empty(m, bool)
    starts[0] = True
    starts[1:] = ~linked[:-1]
    chain_rel = np.cumsum(starts) - 1
    n_chains = int(chain_rel[-1]) + 1
    if n_chains < 2:
        return None
    max_len = int(np.bincount(chain_rel).max())
    if max_len > cap:
        return None
    steps = _bucket_positions(max_len)
    if steps >= m:
        return None
    # Pairwise chain independence over balance slots.
    sl, ch, rd = [], [], []
    for name, is_read in (
        ("reads0", True), ("reads1", True),
        ("writes0", False), ("writes1", False),
    ):
        a = meta[name][i:j]
        msk = a >= 0
        sl.append(a[msk])
        ch.append(chain_rel[msk])
        rd.append(np.full(int(msk.sum()), is_read))
    slot = np.concatenate(sl)
    if len(slot):
        chain_of = np.concatenate(ch)
        isr = np.concatenate(rd)
        order = np.lexsort((chain_of, slot))
        slot, chain_of, isr = slot[order], chain_of[order], isr[order]
        seg_new = np.empty(len(slot), bool)
        seg_new[0] = True
        seg_new[1:] = slot[1:] != slot[:-1]
        seg_id = np.cumsum(seg_new) - 1
        n_seg = int(seg_id[-1]) + 1
        first_chain = chain_of[seg_new][seg_id]
        multi = np.zeros(n_seg, bool)
        np.logical_or.at(multi, seg_id, chain_of != first_chain)
        has_read = np.zeros(n_seg, bool)
        np.logical_or.at(has_read, seg_id, isr)
        if (multi & has_read).any():
            return None
    return steps


def plan_waves(
    n: int, meta: dict, use_walk: bool = False, inb_pairs=None,
    claims=None, group_slots_fn=None,
) -> WavePlan:
    """Partition a batch into wave/chain-wave/scan segments.

    Chain runs (contiguous spans of ``chain_member`` events) are
    barriers at their batch position: runs of mutually independent
    linked chains execute position-stepped as a "chains" segment
    (~max_chain_len device steps — see _chain_wave_steps for the
    admission), everything else stays an exact scan.  The chain-free
    REGIONS between them schedule like a parallel-EVM conflict graph
    (arXiv:2503.04595): each event's *level* is one more than the
    highest level of any earlier in-region event it conflicts with
    (shared id/pending token, first-wins target, or a read-write
    balance-slot overlap), and each level executes as ONE wave —
    commuting adds never conflict, so a two_phase batch of (pending,
    finalize) pairs collapses to exactly two waves.  Level order
    preserves sequential semantics for every conflicting pair;
    non-conflicting events commute, so any interleaving of levels is
    bit-identical to the scan.

    Levels come from the vectorized wavefront (_levels_wavefront,
    sorted-token segmented mins — <100 µs for bench-shaped batches) and
    fall back to the per-event Python walk for regions more serial
    than _WAVEFRONT_CAP levels; ``use_walk=True`` forces the walk —
    the reference algorithm the fuzz pins the wavefront against.

    `meta` comes from resolve.wave_dependency_metadata — see there for
    the field contract; `inb_pairs` lets a caller that already built
    the in-batch finalizer write pairs (_inb_pv_write_pairs — the
    admission in gpu._plan_wave_execution needs them too) pass them
    in instead of recomputing.  Runs once per batch on the host, only
    when the wave path is a routing candidate.

    `claims` / `group_slots_fn` exist for SUBSET planning
    (plan_residue): when `meta` covers only a batch's conflicted
    residue, the chain-wave claims admission and the walk fallback's
    in-batch slot unions must still count the COMMITTED events outside
    the subset — the caller supplies full-batch claim counts and a
    full-batch group->slot-union factory, and the subset-local lazy
    builders are skipped.
    """
    chain_member = meta["chain_member"]
    id_group = meta["id_group"]
    p_group = meta["p_group"]
    p_tgt = meta["p_tgt"]
    reads0, reads1 = meta["reads0"], meta["reads1"]
    inb_pv = meta["inb_pv"]

    # Fast path for the dominant shape (fresh unique ids, no chains, no
    # finalizers, no balance readers): the whole batch is ONE wave —
    # skip level assignment entirely.  The arange test covers the
    # ascending-id encoding (gpu.py's identity grouping) without the
    # O(n log n) unique().
    if (
        not chain_member.any()
        and not inb_pv.any()
        and (reads0 < 0).all()
        and (reads1 < 0).all()
        and (p_tgt < 0).all()
        and (p_group < 0).all()
        and (
            (len(id_group) == n and id_group[0] == 0
             and bool((np.diff(id_group) == 1).all()))
            or len(np.unique(id_group)) == n
        )
    ):
        plan = WavePlan(n, segments=[("wave", np.arange(n))])
        plan.wave_mask = np.ones(n, bool)
        return plan

    inb_ev, inb_slot = (
        inb_pairs if inb_pairs is not None else _inb_pv_write_pairs(n, meta)
    )
    group_slots = None  # walk-fallback slot unions, built lazily

    plan = WavePlan(n)
    wave_mask = np.zeros(n, bool)
    segments = plan.segments

    def walk_group_slots():
        # In-batch pending references resolve to the creating event at
        # run time; statically, the finalizer may write the slots of
        # ANY event sharing that id-group, so its write set is the
        # group's slot union.
        nonlocal group_slots
        if group_slots is None:
            if group_slots_fn is not None:
                group_slots = group_slots_fn()
            else:
                group_slots = {}
                if inb_pv.any():
                    ev_dr, ev_cr = meta["ev_dr"], meta["ev_cr"]
                    for e in range(n):
                        g = int(id_group[e])
                        s = group_slots.setdefault(g, set())
                        if ev_dr[e] >= 0:
                            s.add(int(ev_dr[e]))
                        if ev_cr[e] >= 0:
                            s.add(int(ev_cr[e]))
        return group_slots

    def level_region(lo: int, hi: int) -> None:
        levels = None
        if not use_walk:
            levels = _levels_wavefront(lo, hi, meta, inb_ev, inb_slot)
        if levels is None:
            levels = _levels_walk(lo, hi, meta, walk_group_slots())
        for lvl in range(int(levels.max()) + 1 if hi > lo else 0):
            idx = lo + np.flatnonzero(levels == lvl)
            segments.append(("wave", idx))
            wave_mask[idx] = True

    i = 0
    while i < n:
        if chain_member[i]:
            j = i
            while j < n and chain_member[j]:
                j += 1
            if claims is None:
                span = int(max(id_group.max(), p_group.max())) + 1
                claims = np.bincount(id_group, minlength=span)
                pgv = p_group[p_group >= 0]
                if len(pgv):
                    claims = claims + np.bincount(pgv, minlength=span)
            steps = _chain_wave_steps(i, j, n, meta, claims)
            if steps is not None:
                segments.append(("chains", np.arange(i, j)))
                plan.chain_steps[len(segments) - 1] = steps
                wave_mask[i:j] = True
            else:
                segments.append(("scan", np.arange(i, j)))
            i = j
            continue
        j = i
        while j < n and not chain_member[j]:
            j += 1
        level_region(i, j)
        i = j

    plan.wave_mask = wave_mask
    return plan


def plan_residue(n: int, meta: dict, idx: np.ndarray) -> WavePlan:
    """Wave plan for the conflicted RESIDUE of a speculatively-executed
    batch: the level partition plan_waves builds, restricted to the
    ascending global indices `idx`, with every segment's index set in
    GLOBAL batch coordinates and `wave_mask` a (n,) global mask.

    Soundness of planning the subset in isolation: a committed
    (non-conflicted) event commutes with every residue event — a
    conflict in either direction would have blocked one of them at
    validation — so pre-applying all committed effects is sequentially
    equivalent, and only residue-internal order constraints remain.
    Two full-batch terms still leak into the subset plan and are
    supplied from the full metadata: the chain-wave admission's
    claimed-exactly-once-batch-wide counts (a committed claimant
    outside the subset must still decline the chain wave — its created
    record feeds the member's exists merge, which the chain-wave step
    does not model) and the walk fallback's in-batch finalizer slot
    unions (the committed creator's slots are part of a residue
    finalizer's static write set)."""
    idx = np.asarray(idx, np.int64)
    sub = {
        key: (val[idx] if isinstance(val, np.ndarray) else val)
        for key, val in meta.items()
    }
    inb_ev, inb_slot = _inb_pv_write_pairs(n, meta)
    if len(inb_ev):
        keep = np.isin(inb_ev, idx)
        local = np.searchsorted(idx, inb_ev[keep])
        inb_pairs = (local.astype(np.int64), inb_slot[keep])
    else:
        inb_pairs = (inb_ev, inb_slot)
    claims = None
    if sub["chain_member"].any():
        id_group, p_group = meta["id_group"], meta["p_group"]
        span = int(max(id_group.max(), p_group.max())) + 1
        claims = np.bincount(id_group, minlength=span)
        pgv = p_group[p_group >= 0]
        if len(pgv):
            claims = claims + np.bincount(pgv, minlength=span)

    def group_slots_full():
        out: dict = {}
        ev_dr, ev_cr = meta["ev_dr"], meta["ev_cr"]
        id_group = meta["id_group"]
        for e in range(n):
            s = out.setdefault(int(id_group[e]), set())
            if ev_dr[e] >= 0:
                s.add(int(ev_dr[e]))
            if ev_cr[e] >= 0:
                s.add(int(ev_cr[e]))
        return out

    local_plan = plan_waves(
        len(idx), sub, inb_pairs=inb_pairs, claims=claims,
        group_slots_fn=group_slots_full,
    )
    plan = WavePlan(len(idx))
    mask = np.zeros(n, bool)
    for k, (kind, seg) in enumerate(local_plan.segments):
        gseg = idx[np.asarray(seg)]
        plan.segments.append((kind, gseg))
        if kind == "chains":
            plan.chain_steps[len(plan.segments) - 1] = (
                local_plan.chain_steps[k]
            )
        if kind in ("wave", "chains"):
            mask[gseg] = True
    plan.wave_mask = mask
    return plan


# ---------------------------------------------------------------------------
# Overflow admission (host, against the balance mirror).


def admission_ok(
    mirror_lo: np.ndarray,
    mirror_hi: np.ndarray,
    slots: np.ndarray,
    bound_lo: np.ndarray,
    bound_hi: np.ndarray,
    extra: int = 0,
) -> bool:
    """Per-column superset overflow admission for the whole batch.

    `slots` / `bound_lo` / `bound_hi` are aligned per-CONTRIBUTION
    arrays: each (slot, bound) entry upper-bounds one balance-column
    addition the batch can make at that slot (slot < 0 entries are
    ignored; an event appears once per slot it can add through —
    dr/cr for a create, the target's slot union for a finalizer).

    True when, for every touched slot, (pre dp+dpo) + T and
    (pre cp+cpo) + T provably fit u128, where T = the slot's bound sum
    plus `extra` — a host-integer upper bound on contributions already
    in flight but not yet reflected in the mirror (the device engine's
    window pipelining; zero on the drained host path).  Then every
    per-event ov_* term is false in ANY execution order: amounts are
    non-negative, so each sequential prefix of any column (and either
    pair) is bounded by pre + all-applied additions to that slot, and
    releases only shrink it.  Per-column bounding (instead of the old
    whole-table "any nonzero hi limb declines" rule) admits u128-scale
    balances as long as their remaining headroom covers the batch —
    ROADMAP "Wave-path admission breadth".
    """
    valid = slots >= 0
    if not valid.all():
        slots = slots[valid]
        bound_lo = bound_lo[valid]
        bound_hi = bound_hi[valid]
    if len(slots) == 0:
        return True
    # float64 limb bincounts are exact below 2^53: < 2^21 entries of
    # 32-bit limbs (same bound compact_deltas relies on).
    assert len(slots) < (1 << 21)
    m32 = np.uint64(0xFFFFFFFF)
    # The sums run over the DISTINCT touched slots (the reference's run
    # over every row up to the largest slot: ~25 ms per batch on a
    # 2^20-row table; untouched rows sum to zero, so the verdict is the
    # same).
    touched, inv = np.unique(slots, return_inverse=True)
    acc = [
        np.bincount(inv, limb.astype(np.float64), len(touched)).astype(np.uint64)
        for limb in (
            bound_lo & m32, bound_lo >> np.uint64(32),
            bound_hi & m32, bound_hi >> np.uint64(32),
        )
    ]
    c0, c1, c2, c3 = acc
    c1 = c1 + (c0 >> np.uint64(32))
    c2 = c2 + (c1 >> np.uint64(32))
    c3 = c3 + (c2 >> np.uint64(32))
    if ((c3 >> np.uint64(32)) != 0).any():
        return False  # one slot's bound sum alone exceeds u128
    T_lo = (c0 & m32) | ((c1 & m32) << np.uint64(32))
    T_hi = (c2 & m32) | ((c3 & m32) << np.uint64(32))
    if extra:
        if extra >> 128:
            return False
        e_lo = np.uint64(extra & ((1 << 64) - 1))
        e_hi = np.uint64(extra >> 64)
        nl = T_lo + e_lo
        carry = (nl < T_lo).astype(np.uint64)
        nh = T_hi + e_hi
        ov = nh < T_hi
        nh2 = nh + carry
        if (ov | (nh2 < nh)).any():
            return False
        T_lo, T_hi = nl, nh2
    for a, b in ((0, 1), (2, 3)):
        # pre pair = column a + column b (cannot overflow u128: the
        # engine's own overflow codes maintain the pair invariant —
        # checked anyway, a corrupt mirror must decline, not admit).
        pl = mirror_lo[touched, a] + mirror_lo[touched, b]
        cy = (pl < mirror_lo[touched, a]).astype(np.uint64)
        ph_p = mirror_hi[touched, a] + mirror_hi[touched, b]
        p_ov = ph_p < mirror_hi[touched, a]
        ph = ph_p + cy
        p_ov = p_ov | (ph < ph_p)
        if p_ov.any():
            return False
        sl = pl + T_lo
        s_cy = (sl < pl).astype(np.uint64)
        sh_p = ph + T_hi
        s_ov = sh_p < ph
        s_ov = s_ov | ((sh_p + s_cy) < sh_p)
        if s_ov.any():
            return False
    return True



def _bucket_positions(p: int) -> int:
    """Chain-wave position count: the next power of two >= the longest
    chain, floored at 8 (the reference's compile-cache bucket, kept
    because it is the plan's step count, ``WavePlan.n_steps``, and K8's
    position count; padding positions hold inactive cells)."""
    b = 8
    while b < p:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Pending wave-record compaction.  A queued "waves" record used to
# retain its full (B,)-padded host event dict until launch (~3 MB at
# B=8192; a 96-batch window ~300 MB of host RAM).  Most columns are
# all-zero, constant, or narrow for common batches, and padding past
# the batch length is zeros by construction — so pending records store
# a lossless columnar encoding and rebuild the padded dict at launch
# (DeviceEngine.submit_waves / _exec_waves).  The engine reports the
# retained bytes as `pending_window_bytes` (bench `device_waves`).

_PER_COLUMN_OVERHEAD = 8  # name/tag bookkeeping, counted honestly


class PackedColumns:
    """Lossless columnar encoding of a dict of (B,) numpy arrays whose
    tails (beyond row `n`) are zeros — except full-length aranges
    ("i"), which re-derive.  Per column: all-zero -> nothing, constant
    -> one scalar, arange -> nothing, bool -> bit-packed, integers ->
    the narrowest dtype that holds the value range."""

    __slots__ = ("n", "B", "cols", "nbytes", "padded_nbytes")

    def __init__(self, cols: dict, n: int) -> None:
        self.n = n
        self.cols = {}
        self.nbytes = 0
        self.padded_nbytes = 0
        B = None
        for name, arr in cols.items():
            arr = np.asarray(arr)
            B = arr.shape[0] if B is None else B
            assert arr.shape == (B,), (name, arr.shape, B)
            self.padded_nbytes += arr.nbytes
            self.cols[name] = enc = self._encode(arr, n)
            payload = enc[2]
            self.nbytes += _PER_COLUMN_OVERHEAD + (
                payload.nbytes if isinstance(payload, np.ndarray) else 8
            )
        self.B = B

    @staticmethod
    def _encode(arr: np.ndarray, n: int):
        dt = arr.dtype
        if dt.kind in "iu" and arr[0] == 0 and bool(
            (np.diff(arr) == 1).all()
        ):
            return (dt, "arange", None)
        head, tail = arr[:n], arr[n:]
        if tail.any():
            # Unexpectedly nonzero padding: store verbatim — the codec
            # must be lossless for ANY input, compact for common ones.
            return (dt, "full", arr.copy())
        if not head.any():
            return (dt, "zero", None)
        if bool((head == head[0]).all()):
            return (dt, "const", head[0])
        if dt.kind == "b":
            return (dt, "bits", np.packbits(head))
        if dt.kind == "u":
            vmax = int(head.max())
            for nt in (np.uint8, np.uint16, np.uint32, np.uint64):
                if vmax <= int(np.iinfo(nt).max):
                    return (dt, "arr", head.astype(nt))
        if dt.kind == "i":
            vmin, vmax = int(head.min()), int(head.max())
            for nt in (np.int8, np.int16, np.int32, np.int64):
                ii = np.iinfo(nt)
                if ii.min <= vmin and vmax <= ii.max:
                    return (dt, "arr", head.astype(nt))
        return (dt, "arr", head.copy())

    def unpack(self) -> dict:
        out = {}
        for name, (dt, tag, payload) in self.cols.items():
            if tag == "arange":
                out[name] = np.arange(self.B, dtype=dt)
                continue
            if tag == "full":
                out[name] = payload.copy()
                continue
            arr = np.zeros(self.B, dt)
            if tag == "const":
                arr[: self.n] = payload
            elif tag == "bits":
                arr[: self.n] = np.unpackbits(
                    payload, count=self.n
                ).astype(bool)
            elif tag == "arr":
                arr[: self.n] = payload.astype(dt)
            out[name] = arr
        return out


def pack_wave_record(ev: dict, dstat_init, hist_fix, n: int) -> PackedColumns:
    """One compact bundle for everything a pending "waves" record must
    retain until launch: the event dict plus the dstat seed and the
    snapshot-rewrite mask (all (B,) columns, same codec)."""
    cols = dict(ev)
    cols["__dstat_init__"] = np.asarray(dstat_init)
    cols["__hist_fix__"] = np.asarray(hist_fix)
    return PackedColumns(cols, n)


def unpack_wave_record(pk: PackedColumns):
    """-> (ev, dstat_init, hist_fix), bit-identical to what was packed."""
    cols = pk.unpack()
    dstat_init = cols.pop("__dstat_init__")
    hist_fix = cols.pop("__hist_fix__")
    return cols, dstat_init, hist_fix


def pack_spec_record(ev: dict, dstat_init, spec_serial, n: int) -> PackedColumns:
    """Sibling codec for a pending SPECULATIVE record (same lossless
    columnar compaction, same admission/recovery treatment as a wave
    record): the event dict plus the dstat seed and the known-serial
    mask the on-device validator force-conflicts.  No hist_fix column
    — the snapshot-rewrite mask depends on the validation outcome and
    is derived at launch."""
    cols = dict(ev)
    cols["__dstat_init__"] = np.asarray(dstat_init)
    serial = np.zeros(len(cols["flags"]), bool)
    serial[:n] = np.asarray(spec_serial)[:n]
    cols["__spec_serial__"] = serial
    return PackedColumns(cols, n)


def unpack_spec_record(pk: PackedColumns):
    """-> (ev, dstat_init, spec_serial), bit-identical to what was
    packed."""
    cols = pk.unpack()
    dstat_init = cols.pop("__dstat_init__")
    spec_serial = cols.pop("__spec_serial__")
    return cols, dstat_init, spec_serial


def touched_slots(ev: dict, n: int | None = None) -> np.ndarray:
    """Balance rows a wave batch can modify — the event dict's own
    dr/cr slots plus the durable pending targets' (post/void writes
    land on the TARGET's accounts; in-batch targets resolve to the
    creator event's slots, already covered).  A superset is fine: the
    incremental-commitment refresh of an unmodified row is a no-op
    (device_engine._commit_update)."""
    parts = []
    for key in ("dr_slot", "cr_slot", "p_dr_slot", "p_cr_slot"):
        col = ev.get(key)
        if col is None:
            continue
        a = np.asarray(col).astype(np.int64).ravel()
        if n is not None:
            a = a[:n]
        parts.append(a[a >= 0])
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(parts))


# ---------------------------------------------------------------------------
# Plain versions of K7, K8 and K9: the reference's step bodies
# (_wave_step_impl, _chain_wave_impl, _spec_conflicts) in PyTorch, u64
# values held in int64 lanes, the carry read and written through
# kernel.carry_views.  The reference's ops seam (a whole table, or a
# shard's rows inside shard_map) has one implementation here: the dense
# table.  The sharded executor hands them a compact table of the batch's
# rows instead (_execute_plan_sharded).

_E_FIELD_MAP = {
    "flags": "e_flags", "dr_slot": "e_dr_slot", "cr_slot": "e_cr_slot",
    "amount_lo": "e_amount_lo", "amount_hi": "e_amount_hi",
    "pending_lo": "e_pending_lo", "pending_hi": "e_pending_hi",
    "ud128_lo": "e_ud128_lo", "ud128_hi": "e_ud128_hi",
    "ud64": "e_ud64", "ud32": "e_ud32", "timeout": "e_timeout",
    "code": "e_code",
}
_P_FIELD_MAP = {
    "flags": "p_flags", "dr_slot": "p_dr_slot", "cr_slot": "p_cr_slot",
    "amount_lo": "p_amount_lo", "amount_hi": "p_amount_hi",
    "ud128_lo": "p_ud128_lo", "ud128_hi": "p_ud128_hi",
    "ud64": "p_ud64", "ud32": "p_ud32", "timeout": "p_timeout",
    "ledger": "p_ledger", "code": "p_code",
}
_EXISTS_SENTINEL = 1  # "run the exists ladder here" (no ladder yields 1)


def _s32(x):
    """The int32 in the low bits of int64 lanes."""
    return ((x & MASK32) ^ 0x80000000) - 0x80000000


def _lanes(events, idx, n):
    """(columns of the lanes' event rows, global indices, active) for
    an index tensor: int32 columns sign-extended from their low 32 bits,
    u32 columns masked, bool columns as bool (as the kernels read the
    packed words).  An index outside [0, B) is a padding lane."""
    B = events.shape[0]
    ix = idx.to(torch.int64)
    rows = events[ix.clamp(0, B - 1)]
    c = {}
    for k, (name, dtype) in enumerate(kernel.EVENT_FIELDS):
        x = rows[:, k]
        if dtype == np.int32:
            x = _s32(x)
        elif dtype == np.uint32:
            x = x & MASK32
        elif dtype == np.bool_:
            x = x != 0
        c[name] = x
    i = c["i"]
    active = (ix >= 0) & (ix < B) & (i >= 0) & (i < n)
    return c, i, active


def _first_nonzero(like, *pairs):
    """Precedence cascade: the first true (cond, code) pair wins."""
    r = torch.zeros_like(like)
    for cond, code in pairs:
        r = r.masked_fill((r == 0) & cond, code)
    return r


def _record(created, j):
    """The created records at (clipped) event indices j."""
    return {f: created[k][j] for k, f in enumerate(CREATED_FIELDS)}


def _merge(cond, rec, c, field_map):
    out = dict(rec)
    for f, name in field_map.items():
        out[f] = torch.where(cond, c[name], rec[f])
    return out


def _exists_normal(c, e):
    """reference: src/state_machine.zig:1587-1606 (raw t.amount)."""
    yes = torch.ones_like(c["flags"], dtype=torch.bool)
    return _first_nonzero(
        c["flags"],
        (c["flags"] != e["flags"], kernel.R_EXISTS_DIFF_FLAGS),
        (c["dr_slot"] != e["dr_slot"], kernel.R_EXISTS_DIFF_DR),
        (c["cr_slot"] != e["cr_slot"], kernel.R_EXISTS_DIFF_CR),
        ((c["amount_lo"] != e["amount_lo"]) | (c["amount_hi"] != e["amount_hi"]),
         kernel.R_EXISTS_DIFF_AMOUNT),
        ((c["ud128_lo"] != e["ud128_lo"]) | (c["ud128_hi"] != e["ud128_hi"]),
         kernel.R_EXISTS_DIFF_UD128),
        (c["ud64"] != e["ud64"], kernel.R_EXISTS_DIFF_UD64),
        (c["ud32"] != e["ud32"], kernel.R_EXISTS_DIFF_UD32),
        (c["timeout"] != e["timeout"], kernel.R_EXISTS_DIFF_TIMEOUT),
        (c["code"] != e["code"], kernel.R_EXISTS_DIFF_CODE),
        (yes, kernel.R_EXISTS),
    )


def _exists_post_void(c, e, p):
    """reference: src/state_machine.zig:1743-1804 (zero means inherit)."""
    amount_diff = torch.where(
        (c["amount_lo"] == 0) & (c["amount_hi"] == 0),
        (e["amount_lo"] != p["amount_lo"]) | (e["amount_hi"] != p["amount_hi"]),
        (c["amount_lo"] != e["amount_lo"]) | (c["amount_hi"] != e["amount_hi"]),
    )
    ud128_diff = torch.where(
        (c["ud128_lo"] == 0) & (c["ud128_hi"] == 0),
        (e["ud128_lo"] != p["ud128_lo"]) | (e["ud128_hi"] != p["ud128_hi"]),
        (c["ud128_lo"] != e["ud128_lo"]) | (c["ud128_hi"] != e["ud128_hi"]),
    )
    ud64_diff = torch.where(c["ud64"] == 0, e["ud64"] != p["ud64"], c["ud64"] != e["ud64"])
    ud32_diff = torch.where(c["ud32"] == 0, e["ud32"] != p["ud32"], c["ud32"] != e["ud32"])
    yes = torch.ones_like(c["flags"], dtype=torch.bool)
    return _first_nonzero(
        c["flags"],
        (c["flags"] != e["flags"], kernel.R_EXISTS_DIFF_FLAGS),
        (amount_diff, kernel.R_EXISTS_DIFF_AMOUNT),
        ((c["pending_lo"] != e["pending_lo"]) | (c["pending_hi"] != e["pending_hi"]),
         kernel.R_EXISTS_DIFF_PENDING_ID),
        (ud128_diff, kernel.R_EXISTS_DIFF_UD128),
        (ud64_diff, kernel.R_EXISTS_DIFF_UD64),
        (ud32_diff, kernel.R_EXISTS_DIFF_UD32),
        (yes, kernel.R_EXISTS),
    )


def _u128_col(row, k):
    return (row[:, 2 * k], row[:, 2 * k + 1])


def _normal_verdict(c, flags, dr_row, cr_row, ts_i, e_any, exists_rn):
    """The normal create_transfer path against the lanes' current rows:
    (clamped amount, result code, ts_i + timeout in ns)."""
    dr_dp, dr_dpo, dr_cpo = _u128_col(dr_row, 0), _u128_col(dr_row, 1), _u128_col(dr_row, 3)
    cr_dpo, cr_cp, cr_cpo = _u128_col(cr_row, 1), _u128_col(cr_row, 2), _u128_col(cr_row, 3)
    bal_dr = (flags & F_BAL_DR) != 0
    bal_cr = (flags & F_BAL_CR) != 0
    amount = (c["amount_lo"], c["amount_hi"])
    amount = w.select((bal_dr | bal_cr) & w.is_zero(amount),
                      (torch.full_like(amount[0], -1), torch.zeros_like(amount[1])), amount)
    dr_balance, _ = w.add(dr_dpo, dr_dp)
    amount = w.select(bal_dr, w.minimum(amount, w.sub_sat(dr_cpo, dr_balance)), amount)
    bd_fail = bal_dr & w.is_zero(amount)
    cr_balance, _ = w.add(cr_cpo, cr_cp)
    amount = w.select(bal_cr & ~bd_fail, w.minimum(amount, w.sub_sat(cr_dpo, cr_balance)), amount)
    bc_fail = bal_cr & w.is_zero(amount) & ~bd_fail
    is_pending = (flags & F_PENDING) != 0
    _, ov_dp = w.add(amount, dr_dp)
    _, ov_cp = w.add(amount, cr_cp)
    _, ov_dpo = w.add(amount, dr_dpo)
    _, ov_cpo = w.add(amount, cr_cpo)
    dr_total, _ = w.add(dr_dp, dr_dpo)
    _, ov_debits = w.add(amount, dr_total)
    cr_total, _ = w.add(cr_cp, cr_cpo)
    _, ov_credits = w.add(amount, cr_total)
    ts_plus = ts_i + c["timeout"] * NS_PER_S
    ov_timeout = ult(ts_plus, ts_i)
    dr_lhs, _ = w.add(dr_total, amount)
    exceeds_cr = ((c["dr_flags"] & AF_DR_LIMIT) != 0) & w.gt(dr_lhs, dr_cpo)
    cr_lhs, _ = w.add(cr_total, amount)
    exceeds_dr = ((c["cr_flags"] & AF_CR_LIMIT) != 0) & w.gt(cr_lhs, cr_dpo)
    rn = _first_nonzero(
        flags,
        (e_any, _EXISTS_SENTINEL),
        (bd_fail, kernel.R_EXCEEDS_CREDITS),
        (bc_fail, kernel.R_EXCEEDS_DEBITS),
        (is_pending & ov_dp, kernel.R_OVERFLOWS_DP),
        (is_pending & ov_cp, kernel.R_OVERFLOWS_CP),
        (ov_dpo, kernel.R_OVERFLOWS_DPO),
        (ov_cpo, kernel.R_OVERFLOWS_CPO),
        (ov_debits, kernel.R_OVERFLOWS_DEBITS),
        (ov_credits, kernel.R_OVERFLOWS_CREDITS),
        (ov_timeout, kernel.R_OVERFLOWS_TIMEOUT),
        (exceeds_cr, kernel.R_EXCEEDS_CREDITS),
        (exceeds_dr, kernel.R_EXCEEDS_DEBITS),
    )
    return amount, torch.where(rn == _EXISTS_SENTINEL, exists_rn, rn), ts_plus


def _snapshots(o_dr, o_cr, is_pv, is_post, is_pending, amount, pv_amount, p_amount):
    """The rows after the lane's own effect (pre-rows + own deltas)."""
    o_dr_dp, o_dr_dpo = _u128_col(o_dr, 0), _u128_col(o_dr, 1)
    o_cr_cp, o_cr_cpo = _u128_col(o_cr, 2), _u128_col(o_cr, 3)
    n_dr_dp = w.select(is_pv, w.sub(o_dr_dp, p_amount)[0],
                       w.select(is_pending, w.add(o_dr_dp, amount)[0], o_dr_dp))
    n_dr_dpo = w.select(is_pv, w.select(is_post, w.add(o_dr_dpo, pv_amount)[0], o_dr_dpo),
                        w.select(is_pending, o_dr_dpo, w.add(o_dr_dpo, amount)[0]))
    n_cr_cp = w.select(is_pv, w.sub(o_cr_cp, p_amount)[0],
                       w.select(is_pending, w.add(o_cr_cp, amount)[0], o_cr_cp))
    n_cr_cpo = w.select(is_pv, w.select(is_post, w.add(o_cr_cpo, pv_amount)[0], o_cr_cpo),
                        w.select(is_pending, o_cr_cpo, w.add(o_cr_cpo, amount)[0]))
    new_dr = torch.stack([n_dr_dp[0], n_dr_dp[1], n_dr_dpo[0], n_dr_dpo[1],
                          o_dr[:, 4], o_dr[:, 5], o_dr[:, 6], o_dr[:, 7]], dim=-1)
    new_cr = torch.stack([o_cr[:, 0], o_cr[:, 1], o_cr[:, 2], o_cr[:, 3],
                          n_cr_cp[0], n_cr_cp[1], n_cr_cpo[0], n_cr_cpo[1]], dim=-1)
    return new_dr, new_cr


def _apply_add_sub(table, adds=None, subs=None):
    """table += segment-summed adds, -= segment-summed subs, exact
    u128 per (row, column) mod 2^128 (the reference's _apply_add_sub /
    _accum_u128: 32-bit limb sums, then carries).  Each spec is (slots,
    cols, lo, hi, valid) with slots clipped into the table."""
    cells = table.view(-1, 2)  # column c of row s is cell 4 s + c
    for spec, op in ((adds, w.add), (subs, w.sub)):
        if spec is None:
            continue
        slots, cols, lo, hi, valid = spec
        if not bool(valid.any()):
            continue
        keys = slots[valid] * 4 + cols[valid]
        uniq, inv = torch.unique(keys, return_inverse=True)
        acc = torch.zeros((len(uniq), 4), dtype=torch.int64, device=table.device)
        acc.index_add_(0, inv, w.limbs32(lo[valid], hi[valid]))
        d_lo, d_hi, _ = w.from_limbs32(acc)
        (n_lo, n_hi), _ = op((cells[uniq, 0], cells[uniq, 1]), (d_lo, d_hi))
        cells[uniq, 0] = n_lo
        cells[uniq, 1] = n_hi


def _scatter_max_last(v, applied, i):
    if bool(applied.any()):
        v["scalars"][2] = torch.maximum(v["scalars"][2], i[applied].max())


def wave_step_plain(table, events, words, idx, n, ts_base, mask=None) -> None:
    """Plain version of K7 (the reference's _wave_step_impl): one wave
    over the global event indices `idx` against the carry in `words`,
    every lane reading the pre-wave table and carry; `mask` (bool or
    uint8, per lane) deactivates lanes — a masked lane writes nothing.
    Table and carry updated in place."""
    B, A = events.shape[0], table.shape[0]
    v = kernel.carry_views(words, B)
    created, gc = v["created"], v["group_creator"]
    c, i, active = _lanes(events, idx, n)
    if mask is not None:
        active = active & mask.to(torch.bool)
    flags = c["flags"]
    is_pv = (flags & (F_POST | F_VOID)) != 0
    ts_b = s64(int(ts_base))
    ts_i = ts_b + i
    # No chain terms: wave events are never chain members.
    pre = c["static_result"].masked_fill(c["ts_nonzero"], kernel.R_TIMESTAMP_MUST_BE_ZERO)

    e_creator = gc[c["id_group"].clamp(0, B - 1)]
    e_inb = e_creator >= 0
    e_any = e_inb | c["e_found"]
    e = _merge(~e_inb, _record(created, e_creator.clamp(0, B - 1)), c, _E_FIELD_MAP)
    dr_row = table[c["dr_slot"].clamp(0, A - 1)]
    cr_row = table[c["cr_slot"].clamp(0, A - 1)]
    amount, rn, ts_plus = _normal_verdict(c, flags, dr_row, cr_row, ts_i, e_any,
                                          _exists_normal(c, e))
    is_pending = (flags & F_PENDING) != 0

    pg = c["p_group"]
    p_creator = gc[pg.clamp(0, B - 1)]
    p_dur = c["p_found"]
    p_any = p_dur | ((pg >= 0) & (p_creator >= 0))
    pc = p_creator.clamp(0, B - 1)
    p = _merge(p_dur, _record(created, pc), c, _P_FIELD_MAP)
    p_timestamp = torch.where(p_dur, c["p_timestamp"], ts_b + pc)
    p_amount = (p["amount_lo"], p["amount_hi"])
    raw = (c["amount_lo"], c["amount_hi"])
    pv_amount = w.select(w.is_zero(raw), p_amount, raw)
    tgt = c["p_tgt"].clamp(0, B - 1)
    st = torch.where(p_dur, v["dstat"][tgt], v["inb_status"][pc])
    rp_pre = _first_nonzero(
        flags,
        (~p_any, kernel.R_PENDING_NOT_FOUND),
        ((p["flags"] & F_PENDING) == 0, kernel.R_PENDING_NOT_PENDING),
        (~c["dr_id_zero"] & (c["dr_slot"] != p["dr_slot"]), kernel.R_PENDING_DIFF_DR),
        (~c["cr_id_zero"] & (c["cr_slot"] != p["cr_slot"]), kernel.R_PENDING_DIFF_CR),
        ((c["ledger"] > 0) & (c["ledger"] != p["ledger"]), kernel.R_PENDING_DIFF_LEDGER),
        ((c["code"] > 0) & (c["code"] != p["code"]), kernel.R_PENDING_DIFF_CODE),
        (w.gt(pv_amount, p_amount), kernel.R_EXCEEDS_PENDING_AMOUNT),
        (((flags & F_VOID) != 0) & w.lt(pv_amount, p_amount), kernel.R_PENDING_DIFF_AMOUNT),
        (e_any, _EXISTS_SENTINEL),
        (st == S_POSTED, kernel.R_ALREADY_POSTED),
        (st == S_VOIDED, kernel.R_ALREADY_VOIDED),
        (st == S_EXPIRED, kernel.R_PENDING_EXPIRED),
    )
    rp_pre = torch.where(rp_pre == _EXISTS_SENTINEL, _exists_post_void(c, e, p), rp_pre)
    p_expires = p_timestamp + p["timeout"] * NS_PER_S
    overdue = (p["timeout"] != 0) & ~ult(ts_i, p_expires)
    rp = rp_pre.masked_fill((rp_pre == 0) & overdue, kernel.R_PENDING_EXPIRED)

    gate = active & (pre == 0)
    r = torch.where(gate, torch.where(is_pv, rp, rn), torch.where(active, pre, 0))
    pv_inserted = gate & is_pv & (rp_pre == 0)
    normal_applied = gate & ~is_pv & (rn == 0)
    pv_applied = gate & is_pv & (rp == 0)
    inserted = pv_inserted | normal_applied
    applied = pv_applied | normal_applied
    is_post = (flags & F_POST) != 0

    ud128_inherit = is_pv & (c["ud128_lo"] == 0) & (c["ud128_hi"] == 0)
    up_dr = torch.where(is_pv, p["dr_slot"], c["dr_slot"])
    up_cr = torch.where(is_pv, p["cr_slot"], c["cr_slot"])
    rec = {
        "flags": flags, "dr_slot": up_dr, "cr_slot": up_cr,
        "amount_lo": torch.where(is_pv, pv_amount[0], amount[0]),
        "amount_hi": torch.where(is_pv, pv_amount[1], amount[1]),
        "pending_lo": c["pending_lo"], "pending_hi": c["pending_hi"],
        "ud128_lo": torch.where(ud128_inherit, p["ud128_lo"], c["ud128_lo"]),
        "ud128_hi": torch.where(ud128_inherit, p["ud128_hi"], c["ud128_hi"]),
        "ud64": torch.where(is_pv & (c["ud64"] == 0), p["ud64"], c["ud64"]),
        "ud32": torch.where(is_pv & (c["ud32"] == 0), p["ud32"], c["ud32"]),
        "timeout": torch.where(is_pv, 0, c["timeout"]),
        "ledger": torch.where(is_pv, p["ledger"], c["ledger"]),
        "code": torch.where(is_pv, p["code"], c["code"]),
    }

    safe_dr = up_dr.clamp(0, A - 1)
    safe_cr = up_cr.clamp(0, A - 1)
    # Snapshots from the PRE-wave rows, before any delta lands.
    new_dr, new_cr = _snapshots(table[safe_dr], table[safe_cr], is_pv, is_post, is_pending,
                                amount, pv_amount, p_amount)
    zi = torch.zeros_like(i)
    post_ap = pv_applied & is_post
    _apply_add_sub(
        table,
        adds=(torch.cat([safe_dr, safe_cr, safe_dr, safe_cr]),
              torch.cat([torch.where(is_pending, zi, zi + 1),
                         torch.where(is_pending, zi + 2, zi + 3), zi + 1, zi + 3]),
              torch.cat([amount[0], amount[0], pv_amount[0], pv_amount[0]]),
              torch.cat([amount[1], amount[1], pv_amount[1], pv_amount[1]]),
              torch.cat([normal_applied, normal_applied, post_ap, post_ap])),
        subs=(torch.cat([safe_dr, safe_cr]), torch.cat([zi, zi + 2]),
              torch.cat([p_amount[0], p_amount[0]]), torch.cat([p_amount[1], p_amount[1]]),
              torch.cat([pv_applied, pv_applied])),
    )

    # Scatters at the lanes' own indices, then the cross-index ones.
    ii = i[inserted]
    for k, f in enumerate(CREATED_FIELDS):
        created[k][ii] = rec[f][inserted]
    gc[c["id_group"].clamp(0, B - 1)[inserted]] = ii
    ia = i[active]
    v["created_mask"][ia] = inserted[active].to(torch.int64)
    v["inb_status"][ia] = (normal_applied & is_pending)[active].to(torch.int64)
    new_status = torch.where(is_post, S_POSTED, S_VOIDED)
    m = pv_applied & p_dur
    v["dstat"][tgt[m]] = new_status[m]
    m = pv_applied & ~p_dur
    v["inb_status"][pc[m]] = new_status[m]
    v["hist_dr"][ia] = new_dr[active]
    v["hist_cr"][ia] = new_cr[active]
    v["results"][ia] = r[active]
    _scatter_max_last(v, applied, i)
    pulse_c = torch.where(normal_applied & is_pending & (c["timeout"] != 0), ts_plus, 0)
    v["pulse_create"][ia] = pulse_c[active]
    pulse_r = torch.where(pv_applied & (p["timeout"] != 0), p_expires, 0)
    v["pulse_remove"][ia] = pulse_r[active]


def chain_wave_plain(table, events, words, plane, n, ts_base) -> None:
    """Plain version of K8 (the reference's _chain_wave_impl): the
    (P, C) index plane's positions in order, each lane one chain, every
    position's reads seeing all chains' earlier positions; then the dead
    chains' repair.  Table and carry updated in place."""
    B, A = events.shape[0], table.shape[0]
    v = kernel.carry_views(words, B)
    created, gc = v["created"], v["group_creator"]
    P, C = plane.shape
    alive = torch.ones(C, dtype=torch.bool, device=table.device)
    ts_b = s64(int(ts_base))
    log = []
    for pos in range(P):
        c, i, active = _lanes(events, plane[pos], n)
        flags = c["flags"]
        chain_open = ((flags & F_LINKED) != 0) & (i == n - 1)
        pre = _first_nonzero(
            flags,
            (chain_open, kernel.R_LINKED_EVENT_CHAIN_OPEN),
            (~alive, kernel.R_LINKED_EVENT_FAILED),
            (c["ts_nonzero"], kernel.R_TIMESTAMP_MUST_BE_ZERO),
        )
        pre = torch.where(pre == 0, c["static_result"], pre)
        # Ids are claimed once batch-wide: only a durable duplicate exists.
        e = {f: c[name] for f, name in _E_FIELD_MAP.items()}
        safe_dr = c["dr_slot"].clamp(0, A - 1)
        safe_cr = c["cr_slot"].clamp(0, A - 1)
        dr_row, cr_row = table[safe_dr], table[safe_cr]
        amount, rn, ts_plus = _normal_verdict(c, flags, dr_row, cr_row, ts_b + i,
                                              c["e_found"], _exists_normal(c, e))
        gate = active & (pre == 0)
        r = torch.where(gate, rn, torch.where(active, pre, 0))
        applied = gate & (rn == 0)
        alive = alive & ~(active & alive & (r != 0))
        is_pending = (flags & F_PENDING) != 0
        no = torch.zeros_like(is_pending)
        new_dr, new_cr = _snapshots(dr_row, cr_row, no, no, is_pending, amount, amount, amount)
        zi = torch.zeros_like(i)
        cols_dr = torch.where(is_pending, zi, zi + 1)
        cols_cr = torch.where(is_pending, zi + 2, zi + 3)
        _apply_add_sub(table, adds=(torch.cat([safe_dr, safe_cr]), torch.cat([cols_dr, cols_cr]),
                                    torch.cat([amount[0], amount[0]]),
                                    torch.cat([amount[1], amount[1]]),
                                    torch.cat([applied, applied])))
        ii = i[applied]
        rec = dict(c, amount_lo=amount[0], amount_hi=amount[1])
        for k, f in enumerate(CREATED_FIELDS):
            created[k][ii] = rec[f][applied]
        gidx = c["id_group"].clamp(0, B - 1)
        gc[gidx[applied]] = ii
        ia = i[active]
        v["created_mask"][ia] = applied[active].to(torch.int64)
        v["inb_status"][ia] = (applied & is_pending)[active].to(torch.int64)
        v["hist_dr"][ia] = new_dr[active]
        v["hist_cr"][ia] = new_cr[active]
        v["results"][ia] = r[active]
        _scatter_max_last(v, applied, i)
        pulse_c = torch.where(applied & is_pending & (c["timeout"] != 0), ts_plus, 0)
        v["pulse_create"][ia] = pulse_c[active]
        log.append((i, applied, safe_dr, safe_cr, cols_dr, cols_cr, amount, gidx))

    # Dead chains: subtract every applied member again, results 1, the
    # registrations undone (records and pulses stay).
    dead = ~alive
    for i, applied, safe_dr, safe_cr, cols_dr, cols_cr, amount, gidx in log:
        rb = applied & dead
        if not bool(rb.any()):
            continue
        _apply_add_sub(table, subs=(torch.cat([safe_dr, safe_cr]), torch.cat([cols_dr, cols_cr]),
                                    torch.cat([amount[0], amount[0]]),
                                    torch.cat([amount[1], amount[1]]), torch.cat([rb, rb])))
        v["results"][i[rb]] = kernel.R_LINKED_EVENT_FAILED
        v["created_mask"][i[rb]] = 0
        v["inb_status"][i[rb]] = 0
        gc[gidx[rb]] = -1


def spec_conflicts_plain(events, idx, serial, n, A) -> torch.Tensor:
    """Plain version of K9 (the reference's _spec_conflicts): per-lane
    blocked flags (bool) — an earlier claimant of the lane's id/pending
    group or durable target, an earlier toucher of a slot it reads, an
    earlier reader of a slot it writes, or `serial` set."""
    B = events.shape[0]
    c, i, active = _lanes(events, idx, n)
    flags = c["flags"]
    is_pv = (flags & (F_POST | F_VOID)) != 0
    big = torch.tensor(B, dtype=torch.int64, device=events.device)

    def seg_min(size, *entries):
        """Per-entry minima of i over (mask, index) pairs; index `size`
        catches the masked-off lanes."""
        out = torch.full((size + 1,), int(big), dtype=torch.int64, device=events.device)
        for mask, ix in entries:
            out.scatter_reduce_(0, torch.where(mask, ix, size), i, reduce="amin")
        return out

    idg = c["id_group"].clamp(0, B - 1)
    pgm = active & (c["p_group"] >= 0)
    pgc = c["p_group"].clamp(0, B - 1)
    tok = seg_min(B, (active, idg), (pgm, pgc))
    blk = active & (i > tok[idg])
    blk = blk | (pgm & (i > tok[pgc]))
    ptm = active & (c["p_tgt"] >= 0)
    ptc = c["p_tgt"].clamp(0, B - 1)
    blk = blk | (ptm & (i > seg_min(B, (ptm, ptc))[ptc]))

    dr, cr = c["dr_slot"], c["cr_slot"]
    read_dr = active & ~is_pv & (dr >= 0) & (((flags & F_BAL_DR) != 0)
                                              | ((c["dr_flags"] & AF_DR_LIMIT) != 0))
    read_cr = active & ~is_pv & (cr >= 0) & (((flags & F_BAL_CR) != 0)
                                              | ((c["cr_flags"] & AF_CR_LIMIT) != 0))
    neg = torch.full_like(dr, -1)
    w0 = torch.where(is_pv, torch.where(c["p_found"], c["p_dr_slot"], neg), dr)
    w1 = torch.where(is_pv, torch.where(c["p_found"], c["p_cr_slot"], neg), cr)
    wm0, wm1 = active & (w0 >= 0), active & (w1 >= 0)
    dr_c, cr_c = dr.clamp(0, A - 1), cr.clamp(0, A - 1)
    w0_c, w1_c = w0.clamp(0, A - 1), w1.clamp(0, A - 1)
    a_min = seg_min(A, (read_dr, dr_c), (read_cr, cr_c), (wm0, w0_c), (wm1, w1_c))
    r_min = seg_min(A, (read_dr, dr_c), (read_cr, cr_c))
    blk = blk | (read_dr & (i > a_min[dr_c])) | (read_cr & (i > a_min[cr_c]))
    blk = blk | (wm0 & (i > r_min[w0_c])) | (wm1 & (i > r_min[w1_c]))
    if serial is not None:
        blk = blk | (active & serial.to(torch.bool))
    return blk


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors launch K7 / K8 / K9 (raising on any CUDA
# error), CPU tensors run the plain versions.

class SpecScratch:
    """K9's four minima arrays (tokens and targets: one entry per batch
    row; slot minima: one per table row), made at first use and made
    anew, larger, when a call needs more; and the count of K9 calls made
    on them.  The kernel takes each call's tag from that count and fills
    the arrays when they are new or the tag wraps (csrc/spec_conflicts.cu
    alone knows the encoding), so nothing is reset between calls."""

    def __init__(self, device, calls: int = 0) -> None:
        self.device = device
        self.calls = calls
        self.fresh = True
        self.arrays = None

    def take(self, B: int, A: int):
        """(tok, tgt, a_min, r_min, calls, fresh) for one call on a B-row
        batch and an A-row table: `fresh` when the arrays hold nothing
        of K9's yet."""
        s = self.arrays
        if s is None or s[0].numel() < B or s[2].numel() < A:
            rows = max(B, kernel.BATCH_BUCKETS[-1])
            empty = lambda m: torch.empty((m,), dtype=torch.int32,  # noqa: E731
                                          device=self.device)
            s = self.arrays = (empty(rows), empty(rows), empty(A), empty(A))
            self.fresh = True
        return s + (self.calls, self.fresh)

    def launched(self) -> None:
        """Counts a call that launched on the arrays of the last take."""
        self.calls += 1
        self.fresh = False


class WaveScratch:
    """The wave kernels' device buffers, made at first use and reused:
    the carry (K3's scratch at the largest batch bucket) and K9's tagged
    minima (a SpecScratch; `spec_calls` the calls it counts as made
    before the first).  K7 and K8
    need none: K7's lane records stay in its blocks' shared memory, each
    K8 chain's state in its thread, and K8's dead-chain repair reads the
    carry."""

    def __init__(self, device, spec_calls: int = 0) -> None:
        self.device = device
        self._carry = None
        self._spec = SpecScratch(device, spec_calls)

    def carry(self) -> torch.Tensor:
        if self._carry is None:
            self._carry = torch.empty(kernel.scratch_words(kernel.BATCH_BUCKETS[-1]),
                                      dtype=torch.int64, device=self.device)
        return self._carry


def _check_index(idx, device, dims=1):
    if idx.dtype != torch.int32 or idx.dim() != dims or idx.device != device:
        raise ValueError(f"indices must be a {dims}-D int32 tensor on {device}")
    if not idx.is_contiguous():
        raise ValueError("indices must be contiguous")


def wave_step(table, events, words, idx, n, ts_base, mask=None) -> None:
    """K7: one wave over the global event indices `idx` (int32 (K,));
    `mask` an optional (K,) uint8 commit mask."""
    B = events.shape[0]
    kernel._check_table_events(table, events, n)
    kernel._check_carry(words, B, table.device)
    _check_index(idx, table.device)
    if mask is not None and (mask.dtype != torch.uint8 or mask.shape != idx.shape
                             or mask.device != table.device or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous uint8 tensor shaped like idx")
    if table.device.type == "cpu":
        wave_step_plain(table, events, words, idx, n, ts_base, mask)
        return
    if events.data_ptr() % 16:
        raise ValueError("K7 reads event rows in 16-byte pieces: events must be 16-byte aligned")
    kernels.wave_step(table, events, idx, mask, int(n), int(ts_base) & U64_MAX, words)


# K8 runs one chain per thread in one cluster of at most 16 blocks of
# 512 threads (csrc/chain_wave.cu).
CHAIN_WAVE_MAX_CHAINS = 16 * 512


def chain_wave(table, events, words, plane, n, ts_base) -> None:
    """K8: one chain wave over the (P, C) int32 index plane (on the card,
    C at most CHAIN_WAVE_MAX_CHAINS); it needs no scratch beyond the
    carry."""
    B = events.shape[0]
    kernel._check_table_events(table, events, n)
    kernel._check_carry(words, B, table.device)
    _check_index(plane, table.device, dims=2)
    if table.device.type == "cpu":
        chain_wave_plain(table, events, words, plane, n, ts_base)
        return
    if plane.shape[1] > CHAIN_WAVE_MAX_CHAINS:
        raise ValueError(f"K8 holds at most {CHAIN_WAVE_MAX_CHAINS} chains a wave")
    kernels.chain_wave(table, events, plane, int(n), int(ts_base) & U64_MAX, words)


def spec_conflicts(events, idx, serial, n, A, scratch=None) -> torch.Tensor:
    """K9: (K,) uint8 conflict flags of the lanes `idx` (int32 (K,));
    `serial` a (K,) uint8 force-conflict mask or None; A the table's
    rows."""
    B = events.shape[0]
    if events.dtype != torch.int64 or events.shape != (B, kernel.N_EVENT_COLS):
        raise ValueError("events must be (B, 52) int64")
    _check_index(idx, events.device)
    if serial is not None and (serial.dtype != torch.uint8 or serial.shape != idx.shape
                               or serial.device != events.device):
        raise ValueError("serial must be a uint8 tensor shaped like idx")
    if events.device.type == "cpu":
        return spec_conflicts_plain(events, idx, serial, n, A).to(torch.uint8)
    out = torch.empty(idx.shape[0], dtype=torch.uint8, device=events.device)
    if out.numel() == 0:
        return out
    spec = (scratch or WaveScratch(events.device))._spec
    kernels.spec_conflicts(events, idx, serial, int(n), A, *spec.take(B, A), out)
    spec.launched()
    return out


# ---------------------------------------------------------------------------
# Executors.  The table is updated IN PLACE.  Where the reference's
# engine executors do not donate the table (so a transient link fault
# can retry the batch from the same handle), the port has no retry: a
# CUDA error raises out of the wrapper with the table holding part of
# the batch, and the engine's recovery re-uploads the table from the
# host mirror, which holds exactly the batches before it.


def _chain_plane(flags, idx, P, B) -> np.ndarray:
    """A chain run's (P, C) index plane, position-major, one lane per
    chain, padding cells B.  Chain boundaries re-derive from the linked
    flags, so the executor and the planner cannot disagree."""
    idx = np.asarray(idx, np.int64)
    linked = (np.asarray(flags)[idx] & F_LINKED) != 0
    m = len(idx)
    starts = np.empty(m, bool)
    starts[0] = True
    starts[1:] = ~linked[:-1]
    chain_rel = np.cumsum(starts) - 1
    pos = np.arange(m) - np.flatnonzero(starts)[chain_rel]
    assert int(pos.max()) < P, "chain run exceeds its position count"
    plane = np.full((P, int(chain_rel[-1]) + 1), B, np.int32)
    plane[pos, chain_rel] = idx
    return plane


def _index_plan(ev, plan, B):
    """Every segment's indices in ONE int32 host array (one upload per
    batch) and, per segment, (kind, offset, shape)."""
    parts, segs, off = [], [], 0
    for k, (kind, idx) in enumerate(plan.segments):
        if kind == "chains":
            a = _chain_plane(ev["flags"], idx, plan.chain_steps[k], B)
        else:
            a = np.asarray(idx, np.int32)
        parts.append(a.ravel())
        segs.append((kind, off, a.shape))
        off += a.size
    buf = np.concatenate(parts).astype(np.int32) if parts else np.zeros(0, np.int32)
    return buf, segs


@dataclass
class SegmentCarry:
    """A batch between executor calls: its packed (B, 52) events on the
    table's device and its carry (K3's scratch image)."""

    events: torch.Tensor
    words: torch.Tensor


# The executors' kernels, or their plain versions (a reference run on
# the card: TorchStateMachine(plain=True)); the wrappers above still run
# the plain versions on CPU tensors.
_KERNEL_FNS = {
    "init": kernel.exact_init, "segment": kernel.scan_segment,
    "finalize": kernel.finalize, "wave": wave_step, "chain": chain_wave,
    "spec": spec_conflicts,
}
_PLAIN_FNS = {
    "init": kernel.make_carry,
    "segment": kernel.scan_segment_plain,
    "finalize": kernel.finalize_plain,
    "wave": wave_step_plain,
    "chain": chain_wave_plain,
    "spec": lambda events, idx, serial, n, A, scratch=None: (
        spec_conflicts_plain(events, idx, serial, n, A).to(torch.uint8)),
}


def _begin(table, ev, dstat_init, scratch, fns) -> SegmentCarry:
    pk = from_u64(kernel.pack_events(ev), table.device)
    B = pk.shape[0]
    if scratch is not None and fns is _KERNEL_FNS and table.device.type == "cuda":
        words = scratch.carry()
    else:
        words = torch.empty(kernel.scratch_words(B), dtype=torch.int64, device=table.device)
    dstat = np.asarray(dstat_init, np.uint32).view(np.int32)
    fns["init"](words, torch.from_numpy(dstat.copy()).to(table.device))
    return SegmentCarry(pk, words)


def _run_segments(table, carry: SegmentCarry, ev, n, ts_base, plan, scratch, fns) -> None:
    buf, segs = _index_plan(ev, plan, carry.events.shape[0])
    ix = torch.from_numpy(buf).to(table.device)
    for kind, off, shape in segs:
        seg = ix[off:off + int(np.prod(shape))]
        if kind == "wave":
            fns["wave"](table, carry.events, carry.words, seg, n, ts_base)
        elif kind == "chains":
            fns["chain"](table, carry.events, carry.words, seg.view(shape), n, ts_base)
        else:
            fns["segment"](table, carry.events, carry.words, seg, n, ts_base)


def _finish(table, carry: SegmentCarry, hist_fix, fns) -> torch.Tensor:
    B = carry.events.shape[0]
    fix = torch.from_numpy(np.asarray(hist_fix, bool).astype(np.uint8)).to(table.device)
    return fns["finalize"](table, carry.words, B, fix)


def _fns(plain: bool) -> dict:
    return _PLAIN_FNS if plain else _KERNEL_FNS


def run_create_transfers_waves(table, ev, dstat_init, n, ts_base, plan, hist_fix,
                               scratch=None, plain=False) -> torch.Tensor:
    """Execute a batch by its wave plan: the same outputs, bit for bit,
    as kernel.run_create_transfers — the (B, 37) packed outputs, the
    table updated in place.  `ev` is the host dict of (B,) arrays per
    kernel.EVENT_FIELDS; `hist_fix` the (B,) bool mask of events whose
    snapshots become batch finals (wave and chain-wave events)."""
    fns = _fns(plain)
    carry = _begin(table, ev, dstat_init, scratch, fns)
    _run_segments(table, carry, ev, n, ts_base, plan, scratch, fns)
    return _finish(table, carry, hist_fix, fns)


def run_plan_engine(table, ev, dstat_init, n, ts_base, plan, hist_fix, mesh=None,
                    scratch=None, plain=False) -> torch.Tensor:
    """The device engine's wave record (reference: run_plan_engine,
    :1919-1941): the dense executor on the engine's table, or with a row
    `mesh` the sharded executor on its shard tables (`table` is then
    their list).  The tables are updated in place; returns the (B, 37)
    packed outputs."""
    if mesh is None:
        return run_create_transfers_waves(table, ev, dstat_init, n, ts_base, plan, hist_fix,
                                          scratch, plain)
    return _execute_plan_sharded(table, ev, dstat_init, n, ts_base, plan, hist_fix, mesh,
                                 scratch, plain)[1]


def run_speculative_engine(table, ev, dstat_init, spec_serial, n, ts_base, scratch=None,
                           plain=False):
    """One speculative step: a fresh carry, K9's validation of the whole
    batch, then K7 over every lane with commit mask = not conflicted.
    Returns (carry, conflicted (n,) uint8 on the table's device): the
    carry holds exactly the committed events' effects; fetch the flags,
    then finalize_engine (no conflict) or continue_plan_engine."""
    fns = _fns(plain)
    carry = _begin(table, ev, dstat_init, scratch, fns)
    idx = torch.arange(n, dtype=torch.int32, device=table.device)
    serial = torch.from_numpy(np.asarray(spec_serial, bool)[:n].astype(np.uint8))
    conflicted = fns["spec"](carry.events, idx, serial.to(table.device), n, table.shape[0],
                             scratch=scratch)
    fns["wave"](table, carry.events, carry.words, idx, n, ts_base,
                mask=(conflicted == 0).to(torch.uint8))
    return carry, conflicted


def continue_plan_engine(table, carry, ev, n, ts_base, plan, hist_fix, scratch=None,
                         plain=False):
    """Replay the conflicted residue's plan (global indices) from the
    speculative carry, then finalize: the (B, 37) packed outputs."""
    fns = _fns(plain)
    _run_segments(table, carry, ev, n, ts_base, plan, scratch, fns)
    return _finish(table, carry, hist_fix, fns)


def finalize_engine(table, carry, hist_fix, plain=False):
    """Finalize a speculative carry whose residue is empty."""
    return _finish(table, carry, hist_fix, _fns(plain))


# ---------------------------------------------------------------------------
# Row-sharded executor: the reference's _execute_plan_sharded over a 1-D
# ("shard",) mesh of shard-local tables (parallel/sharded.py).  The
# reference runs each step body inside shard_map (_sharded_fns), every
# row read recombined from its single owner (_ShardTableOps: sharded.
# gather_rows) and every write landing on owned rows only.  Here the
# rows a batch can touch are gathered once (kernel K14 gather on every
# shard + the sum over shard) into a compact table, the dense executor
# runs the whole plan there with the batch's slot columns remapped onto
# it, and the rows are written back onto their owners (K14 scatter).
# Nothing else writes the shard tables in between, so each read the
# reference makes from the owners sees the row the compact table holds.
# Every table access of K7, K8 and K3 finalize is a row at a clipped
# slot of the batch's slot columns or of a created record (which copies
# them), so the compact table serves every read, the reads in the middle
# of K8 included, and the results are the dense executor's bit for bit.


def plan_shardable(plan: WavePlan) -> bool:
    """True when every segment has a sharded executor: "wave" and
    "chains" do; "scan" segments (K3's sequential walk) keep
    single-table scope."""
    return all(kind in ("wave", "chains") for kind, _ in plan.segments)


_SLOT_COLS = ("dr_slot", "cr_slot", "e_dr_slot", "e_cr_slot", "p_dr_slot", "p_cr_slot")
_OUT_SLOT_COLS = (kernel._SCALAR_COLS.index("dr_slot"), kernel._SCALAR_COLS.index("cr_slot"))


def _batch_rows(ev: dict, A: int) -> np.ndarray:
    """The sorted global rows a batch can touch (sharded.compact_rows of
    every value of its slot columns)."""
    return sharded.compact_rows(
        np.concatenate([np.asarray(ev[c], np.int64) for c in _SLOT_COLS]), A)


def _remap_slots(ev: dict, rows: np.ndarray, A: int) -> dict:
    """The batch with its slot columns moved onto the compact table of
    `rows` (sharded.remap_slots)."""
    out = dict(ev)
    for c in _SLOT_COLS:
        out[c] = sharded.remap_slots(np.asarray(ev[c], np.int64), rows, A).astype(np.int32)
    return out


def _unmap_slots(packed: torch.Tensor, rows: torch.Tensor, A: int) -> torch.Tensor:
    """The packed outputs' created-record slots back in global rows (the
    inverse of _remap_slots)."""
    K = rows.numel()
    for col in _OUT_SLOT_COLS:
        v = packed[:, col]
        packed[:, col] = torch.where(v < 0, v, torch.where(v < K, rows[v.clamp(0, K - 1)],
                                                           v - K + A))
    return packed


def _execute_plan_sharded(tables, ev: dict, dstat_init, n: int, ts_base: int, plan: WavePlan,
                          hist_fix: np.ndarray, mesh, scratch=None, plain: bool = False):
    """Execute a batch by its wave plan over the shard tables of a 1-D
    ("shard",) mesh (one (A / n_shard, 8) int64 tensor per shard, each
    on its shard's device, updated in place): the same (B, 37) packed
    outputs and the same joined table, bit for bit, as
    run_create_transfers_waves on the whole table.  The caller proved
    plan_shardable(plan).  Returns (tables, packed outputs on the mesh's
    first device).  `plain` runs the plain versions (a reference run on
    the card)."""
    assert plan_shardable(plan), "scan segments have no sharded executor (plan_shardable)"
    n_shard = mesh.shape["shard"]
    assert len(tables) == n_shard, (len(tables), n_shard)
    A = n_shard * tables[0].shape[0]
    home = mesh.device(0)
    rows = _batch_rows(ev, A)
    slots = torch.from_numpy(rows).to(home)
    compact = sharded.gather_rows(tables, slots, home, plain=plain)
    packed = run_create_transfers_waves(compact, _remap_slots(ev, rows, A), dstat_init, n,
                                        ts_base, plan, hist_fix, scratch, plain)
    sharded.scatter_rows(tables, slots, compact, plain=plain)
    return tables, _unmap_slots(packed, slots, A)
