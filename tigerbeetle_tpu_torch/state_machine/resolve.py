"""Dependency metadata for the wave partitioner (host, numpy).

Counterpart of the wave part of ``tigerbeetle_tpu/state_machine/
resolve.py``: ``wave_dependency_metadata`` (what each event of a batch
claims, reads and writes), ``spec_meta_from_events`` (the same from a
padded event dict, for the speculative dispatcher's residue planner)
and ``_exclusive_prefix``.  Copied as they are; the reference's
host-only linked and two-phase resolvers are not ported (those batches
take the device kernels or the exact lane, with the same results).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.types import AccountFlags, TransferFlags

AF = AccountFlags
TF = TransferFlags


def _exclusive_prefix(values: np.ndarray) -> np.ndarray:
    """[0, v0, v0+v1, ...] — prefix sums excluding the element itself."""
    out = np.empty(len(values) + 1, values.dtype)
    out[0] = 0
    np.cumsum(values, out=out[1:])
    return out


def spec_meta_from_events(ev: dict, n: int, pv_serial: bool) -> dict:
    """wave_dependency_metadata rebuilt from a (B,)-padded host event
    dict (kernel.EVENT_FIELDS contract): the speculative dispatcher
    plans its residue at window launch, where the padded arrays are all
    that is left of the submit-time joins.  The same values the submit
    path passed, so the same metadata."""
    return wave_dependency_metadata(
        n,
        np.asarray(ev["flags"][:n], np.uint32),
        ev["dr_slot"][:n].astype(np.int64),
        ev["cr_slot"][:n].astype(np.int64),
        np.asarray(ev["dr_flags"][:n], np.uint32),
        np.asarray(ev["cr_flags"][:n], np.uint32),
        ev["id_group"][:n].astype(np.int64),
        ev["p_group"][:n].astype(np.int64),
        ev["p_tgt"][:n].astype(np.int64),
        np.asarray(ev["p_found"][:n], bool),
        ev["p_dr_slot"][:n].astype(np.int64),
        ev["p_cr_slot"][:n].astype(np.int64),
        pv_serial=pv_serial,
    )


def wave_dependency_metadata(
    n: int,
    flags: np.ndarray,
    dr_slot: np.ndarray,
    cr_slot: np.ndarray,
    dr_flags: np.ndarray,
    cr_flags: np.ndarray,
    id_group: np.ndarray,
    p_group: np.ndarray,
    p_tgt: np.ndarray,
    p_found: np.ndarray,
    p_dr_slot: np.ndarray,
    p_cr_slot: np.ndarray,
    pv_serial: bool = False,
) -> dict:
    """Per-event dependency metadata for waves.plan_waves.

    - ``chain_member``: the event runs outside plain waves — a linked
      chain member (the closing event included), an event on a history
      account (its snapshot must be sequential), or, with
      ``pv_serial``, any post/void.  ``chain_linked`` is the linked-run
      part alone, ``chain_serial`` the must-scan part; a chain run with
      no serial member may run as a chain wave.
    - ``is_pv``: post/void flag.
    - ``id_group`` / ``p_group`` / ``p_tgt``: the exact path's compact
      reference tokens; two events conflict when both claim one.
    - ``writes0/1``: slots whose balance columns the apply ADDS to
      (normal: dr/cr; post/void: the durable target's accounts), -1
      for none.  ``reads0/1``: slots whose balance the verdict or the
      applied amount reads (balancing clamps, limit checks), -1 none.
    - ``inb_pv``: a post/void naming an in-batch id (its write set
      widens to that id-group's slot union, from ``ev_dr`` / ``ev_cr``).
    """
    TFv = np.uint32
    linked = (flags & TFv(TF.linked)) != 0
    is_pv = (flags & TFv(TF.post_pending_transfer | TF.void_pending_transfer)) != 0
    chain_linked = linked.copy()
    if n > 1:
        chain_linked[1:] |= linked[:-1]
    hist = ((dr_flags | cr_flags) & TFv(AF.history)) != 0
    chain_serial = hist & ~is_pv
    if pv_serial:
        chain_serial = chain_serial | is_pv
    chain_member = chain_linked | chain_serial

    bal_dr = (flags & TFv(TF.balancing_debit)) != 0
    bal_cr = (flags & TFv(TF.balancing_credit)) != 0
    read_dr = (
        (bal_dr | ((dr_flags & TFv(AF.debits_must_not_exceed_credits)) != 0))
        & (dr_slot >= 0) & ~is_pv
    )
    read_cr = (
        (bal_cr | ((cr_flags & TFv(AF.credits_must_not_exceed_debits)) != 0))
        & (cr_slot >= 0) & ~is_pv
    )

    neg = np.int64(-1)
    dr64 = dr_slot.astype(np.int64)
    cr64 = cr_slot.astype(np.int64)
    pdr64 = np.where(p_found, p_dr_slot.astype(np.int64), neg)
    pcr64 = np.where(p_found, p_cr_slot.astype(np.int64), neg)
    writes0 = np.where(is_pv, pdr64, np.where(dr_slot >= 0, dr64, neg))
    writes1 = np.where(is_pv, pcr64, np.where(cr_slot >= 0, cr64, neg))
    reads0 = np.where(read_dr, dr64, neg)
    reads1 = np.where(read_cr, cr64, neg)

    return {
        "chain_member": chain_member,
        "chain_linked": chain_linked,
        "chain_serial": chain_serial,
        "linked": linked,
        "is_pv": is_pv,
        "id_group": np.asarray(id_group, np.int64),
        "p_group": np.asarray(p_group, np.int64),
        "p_tgt": np.asarray(p_tgt, np.int64),
        "writes0": writes0,
        "writes1": writes1,
        "reads0": reads0,
        "reads1": reads1,
        "inb_pv": is_pv & (np.asarray(p_group) >= 0),
        "ev_dr": np.where(dr_slot >= 0, dr64, neg),
        "ev_cr": np.where(cr_slot >= 0, cr64, neg),
    }
