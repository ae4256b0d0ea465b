"""Seeded batches for the exact scan's differential checks.

Event columns per ``state_machine.kernel.EVENT_FIELDS`` drawn from
small value pools, so ids, pending references, slots and balances
collide, then made coherent enough that every rung of every ladder is
reached: each class leans on one shape (linked chains with rollback,
post/void against durable and in-batch pendings, balancing, limit
accounts, near-2^128 balances, overdue posts, duplicate and existing
ids, timeout overflow, history accounts).  numpy only: the tests hand
the same inputs to the JAX package's scan, the card checks to K3.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.state_machine import kernel as k3

M64 = (1 << 64) - 1
CLASSES = (
    "linked", "post_void", "balancing", "limits", "overflow", "overdue",
    "exists", "timeout_overflow", "history", "mixed",
)


def _pick(rng, pool, size, p=None):
    pool = np.asarray(pool, dtype=object)
    return pool[rng.choice(len(pool), size=size, p=p)]


def make_case(seed, B, cls, A=24, n=None, rows=None):
    """(table (A, 8) u64, ev dict of (B,) arrays per EVENT_FIELDS,
    dstat_init (B,) u32, n, ts_base) for one batch leaning on `cls`.
    Slots are drawn from `rows` (default: every row of the table) and
    -1; n defaults to a random count in [B/2, B]."""
    rng = np.random.default_rng(seed)
    if n is None:
        n = int(rng.integers(B // 2, B + 1))
    rows = np.arange(A) if rows is None else np.asarray(rows)

    def slots(size):
        s = rows[rng.integers(0, len(rows), size)].astype(np.int32)
        s[rng.random(size) < 1 / (len(rows) + 1)] = -1
        return s

    big = cls == "overflow"
    lo_pool = [0, 1, 5, 50, 1000, M64 - 3, M64]
    hi_pool = [0, 0, 0, 1, M64] if big else [0, 0, 0, 0, 1]
    table = np.zeros((A, 8), np.uint64)
    R = len(rows)
    table[rows, 0::2] = _pick(rng, lo_pool, (R, 4)).astype(np.uint64)
    table[rows, 1::2] = _pick(rng, hi_pool, (R, 4)).astype(np.uint64)
    if cls in ("balancing", "limits", "linked"):
        table[rows, 6] = rng.integers(0, 3000, R).astype(np.uint64)   # cpo: funded
        table[rows, 2] = rng.integers(0, 3000, R).astype(np.uint64)   # dpo

    flag_p = {
        "linked": (0.5, 0.1, 0.05, 0.05),
        "post_void": (0.1, 0.4, 0.45, 0.02),
        "balancing": (0.2, 0.1, 0.1, 0.5),
        "limits": (0.4, 0.2, 0.1, 0.1),
        "overflow": (0.2, 0.3, 0.2, 0.1),
        "overdue": (0.1, 0.4, 0.45, 0.0),
        "exists": (0.2, 0.3, 0.3, 0.1),
        "timeout_overflow": (0.1, 0.6, 0.2, 0.0),
        "history": (0.2, 0.3, 0.2, 0.1),
        "mixed": (0.3, 0.3, 0.3, 0.2),
    }[cls]
    linked, pending, pv, bal = flag_p
    flags = np.where(rng.random(B) < linked, 1, 0)
    flags |= np.where(rng.random(B) < pending, 2, 0)
    pvr = rng.random(B)
    flags |= np.where(pvr < pv / 2, 4, np.where(pvr < pv, 8, 0))
    balr = rng.random(B)
    flags |= np.where(balr < bal / 2, 16, np.where(balr < bal, 32, 0))
    flags[rng.random(B) < 0.02] |= 12  # post and void together
    flags = flags.astype(np.uint32)

    groups = max(2, B // (8 if cls == "exists" else 2))
    ev = {"i": np.arange(B, dtype=np.int32), "flags": flags}
    ev["ts_nonzero"] = rng.random(B) < 0.03
    ev["static_result"] = np.where(
        rng.random(B) < 0.05, rng.integers(4, 25, B), 0
    ).astype(np.uint32)
    amt_lo_pool = [0, 1, 7, 40, 300, 1 << 40] + ([M64, M64 - 1] if big else [])
    amt_hi_pool = [0, 0, 0, 1] + ([M64, 1 << 63] if big else [])
    for f, pool in (("amount_lo", amt_lo_pool), ("amount_hi", amt_hi_pool)):
        ev[f] = _pick(rng, pool, B).astype(np.uint64)
    ev["pending_lo"] = rng.integers(0, groups + 4, B).astype(np.uint64)
    ev["pending_hi"] = np.where(rng.random(B) < 0.05, 1, 0).astype(np.uint64)
    ev["ud128_lo"] = rng.integers(0, 3, B).astype(np.uint64)
    ev["ud128_hi"] = rng.integers(0, 2, B).astype(np.uint64)
    ev["ud64"] = rng.integers(0, 3, B).astype(np.uint64)
    ev["ud32"] = rng.integers(0, 3, B).astype(np.uint32)
    tmax = (1 << 32) - 1 if cls == "timeout_overflow" else 4
    ev["timeout"] = np.where(rng.random(B) < 0.5, rng.integers(0, tmax + 1, B), 0).astype(np.uint64)
    ev["ledger"] = rng.integers(0, 3, B).astype(np.uint32)
    ev["code"] = rng.integers(0, 3, B).astype(np.uint32)
    ev["dr_slot"] = slots(B)
    ev["cr_slot"] = slots(B)
    af = {"limits": [0, 0, 2, 4, 8, 10], "linked": [0, 0, 2, 4, 8, 10],
          "history": [8, 8, 8, 0, 10, 12]}.get(cls, [0, 0, 0, 8, 2, 4])
    ev["dr_flags"] = _pick(rng, af, B).astype(np.uint32)
    ev["cr_flags"] = _pick(rng, af, B).astype(np.uint32)
    ev["dr_id_zero"] = rng.random(B) < 0.1
    ev["cr_id_zero"] = rng.random(B) < 0.1
    ev["id_group"] = rng.integers(0, groups, B).astype(np.int32)
    ev["p_group"] = np.where(rng.random(B) < 0.6, rng.integers(-1, groups, B), -1).astype(np.int32)
    ev["e_found"] = rng.random(B) < (0.3 if cls == "exists" else 0.05)
    ev["p_found"] = rng.random(B) < 0.5
    for pre in ("e", "p"):
        ev[f"{pre}_flags"] = (rng.integers(0, 64, B) | (2 if pre == "p" else 0)).astype(np.uint32)
        ev[f"{pre}_flags"][rng.random(B) < 0.1] &= np.uint32(~2 & 0xFFFFFFFF)
        ev[f"{pre}_dr_slot"] = slots(B)
        ev[f"{pre}_cr_slot"] = slots(B)
        ev[f"{pre}_amount_lo"] = _pick(rng, amt_lo_pool, B).astype(np.uint64)
        ev[f"{pre}_amount_hi"] = _pick(rng, amt_hi_pool, B).astype(np.uint64)
        ev[f"{pre}_ud128_lo"] = rng.integers(0, 3, B).astype(np.uint64)
        ev[f"{pre}_ud128_hi"] = rng.integers(0, 2, B).astype(np.uint64)
        ev[f"{pre}_ud64"] = rng.integers(0, 3, B).astype(np.uint64)
        ev[f"{pre}_ud32"] = rng.integers(0, 3, B).astype(np.uint32)
        ev[f"{pre}_timeout"] = rng.integers(0, 3, B).astype(np.uint64)
        ev[f"{pre}_code"] = rng.integers(0, 3, B).astype(np.uint32)
    ev["e_pending_lo"] = rng.integers(0, groups + 4, B).astype(np.uint64)
    ev["e_pending_hi"] = np.zeros(B, np.uint64)
    ev["p_ledger"] = rng.integers(0, 3, B).astype(np.uint32)
    ts_base = (M64 - (1 << 60)) if cls == "timeout_overflow" else 10_000_000_000
    # Durable pendings created 0..20 s before the batch: with timeouts
    # of 1-2 s many are overdue (the QUIRK path).
    ev["p_timestamp"] = (np.uint64(ts_base)
                         - rng.integers(0, 20, B).astype(np.uint64) * np.uint64(10**9))
    ev["p_tgt"] = np.where(ev["p_found"], rng.integers(0, max(2, B // 4), B), -1).astype(np.int32)
    dstat = rng.choice([0, 1, 1, 1, 2, 3, 4], size=B).astype(np.uint32)
    with np.errstate(over="ignore"):  # field + 1 may wrap on purpose
        _cohere(rng, ev, B)
    return table, ev, dstat, n, ts_base


_SAME = ("flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi", "pending_lo",
         "pending_hi", "ud128_lo", "ud128_hi", "ud64", "ud32", "timeout", "code")
_PENDING_REF = ("ledger", "dr_id_zero", "cr_id_zero", "p_group") + tuple(
    name for name, _ in k3.EVENT_FIELDS if name.startswith("p_") and name != "p_group"
)


def _cohere(rng, ev, B):
    """Make the exists and pending ladders reachable past their first
    rungs: a share of events repeat an earlier event (same id group,
    same fields but at most one), a share of durable duplicates match
    their event but at most one field, and post/voids mostly agree with
    their pending's accounts, ledger, code and amount."""
    is_pv = (ev["flags"] & 12) != 0
    for j in np.flatnonzero(is_pv):
        if rng.random() < 0.85:
            ev["flags"][j] &= np.uint32(~0x32 & 0xFFFFFFFF)  # pv alone
            ev["p_flags"][j] |= np.uint32(2)
            ev["dr_slot"][j] = ev["p_dr_slot"][j]
            ev["cr_slot"][j] = ev["p_cr_slot"][j]
            ev["ledger"][j] = ev["p_ledger"][j] if rng.random() < 0.5 else 0
            ev["code"][j] = ev["p_code"][j] if rng.random() < 0.5 else 0
            if rng.random() < 0.5:
                ev["amount_lo"][j], ev["amount_hi"][j] = 0, 0
            else:
                ev["amount_lo"][j] = ev["p_amount_lo"][j]
                ev["amount_hi"][j] = ev["p_amount_hi"][j]
            if rng.random() < 0.3:
                f = ("dr_slot", "cr_slot", "ledger", "code", "amount_lo")[int(rng.integers(0, 5))]
                ev[f][j] = ev[f][j] + 1
    for j in range(1, B):
        if rng.random() < 0.25:
            k = int(rng.integers(0, j))
            for f in _SAME + _PENDING_REF:
                ev[f][j] = ev[f][k]
            ev["id_group"][j] = ev["id_group"][k]
            if rng.random() < 0.7:
                f = _SAME[int(rng.integers(0, len(_SAME)))]
                ev[f][j] = ev[f][j] + 1
        if ev["e_found"][j] and rng.random() < 0.8:
            for f in _SAME:
                ev["e_" + f][j] = ev[f][j] if f != "code" else ev["code"][j]
            if rng.random() < 0.7:
                f = _SAME[int(rng.integers(0, len(_SAME)))]
                ev["e_" + f][j] = ev["e_" + f][j] + 1
