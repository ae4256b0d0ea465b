"""Seeded batches and plans for the wave kernels' differential checks.

numpy only: the CPU tests hand the same inputs to the JAX package's
wave executor and to the port's plain versions, the card tests and
``chip_smoke.py`` to the kernels (K7 wave step, K8 chain wave, K9
speculative conflicts, K3 segments and finalize).

- ``plan_case``: a ``scan_cases`` batch of one class and its wave plan
  (waves, chain waves and scan segments, as ``TB_WAVES=1`` plans it).
- ``chain_case``: a batch of mutually independent linked chains that
  the planner runs as ONE chain wave: chains share credited hub
  accounts (written by several chains, read by none), and chains die
  mid-way (static codes, a nonzero timestamp, a durable duplicate,
  balancing clamps and debit or credit limits on the chain's own
  accounts, the batch's last event left linked).
- ``wide_case``: a batch whose plan is ONE wave of every event: posted
  and pending transfers over shared accounts, post/voids of distinct
  durable pendings, balancing and limit readers on accounts nobody else
  touches, durable duplicates.
- ``finalize_case``: a table and a seeded carry image for K3's finalize
  alone, at any B (odd ones too), with no row, every row or a share of
  the rows fixed, created slots that clip (-1 and >= A) among them.
- ``spec_stream``: K9 batches to run back to back on one scratch, each
  of another class over one row pool, so each reuses the slots and the
  groups of the batches before it.
- ``distinct_spec_case``: a K9 batch whose slots, groups and targets
  are all distinct (no conflict but the serial mask's).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import resolve, waves
from tigerbeetle_tpu_torch.testing import scan_cases

F_LINKED, F_PENDING, F_POST, F_VOID, F_BAL_DR = 1, 2, 4, 8, 16
AF_DR_LIMIT, AF_CR_LIMIT = 2, 4
TS_BASE = 10_000_000_000


def _plan(ev, n):
    return waves.plan_waves(n, resolve.spec_meta_from_events(ev, n, pv_serial=False))


def plan_case(seed, B, cls, A=24, rows=None, n=None):
    """(table, ev, dstat, n, ts_base, plan) for a scan_cases batch."""
    table, ev, dstat, n, ts_base = scan_cases.make_case(seed, B, cls, A=A, n=n, rows=rows)
    return table, ev, dstat, n, ts_base, _plan(ev, n)


def _blank(B):
    ev = {name: np.zeros(B, dtype) for name, dtype in k3.EVENT_FIELDS}
    ev["i"] = np.arange(B, dtype=np.int32)
    ev["id_group"] = np.arange(B, dtype=np.int32)
    ev["p_group"] = np.full(B, -1, np.int32)
    ev["p_tgt"] = np.full(B, -1, np.int32)
    return ev


def _table(rng, A, rows):
    """Balances with headroom: every column below 2^40, funded credits
    so limit checks and balancing clamps both pass and fail."""
    table = np.zeros((A, 8), np.uint64)
    table[rows, 0::2] = rng.integers(0, 6000, (len(rows), 4)).astype(np.uint64)
    return table


def chain_case(seed, n_chains, B, A=None, rows=None, max_len=7, hubs=8):
    """(table, ev, dstat, n, ts_base, plan) for a batch of `n_chains`
    independent chains of 2..max_len members; the plan is one "chains"
    segment over [0, n)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, max_len + 1, n_chains)
    n = int(lens.sum())
    assert n <= B, (n, B)
    if A is None:
        A = 2 * n_chains + hubs + 8
    rows = np.arange(A) if rows is None else np.asarray(rows)
    pick = rng.choice(rows, 2 * n_chains + hubs, replace=False).astype(np.int32)
    dr_priv, cr_priv, hub = pick[:n_chains], pick[n_chains:2 * n_chains], pick[2 * n_chains:]
    chain = np.repeat(np.arange(n_chains), lens)
    ends = np.cumsum(lens) - 1

    ev = _blank(B)
    flags = np.full(n, F_LINKED, np.uint32)
    flags[ends] = 0
    flags[n - 1] |= F_LINKED  # the last chain stays open
    pend = rng.random(n) < 0.2
    flags[pend] |= F_PENDING
    bal = rng.random(n) < 0.1
    flags[bal] |= F_BAL_DR
    ev["flags"][:n] = flags
    ev["timeout"][:n] = np.where(pend, rng.integers(0, 4, n), 0).astype(np.uint64)
    amount = rng.integers(1, 2000, n).astype(np.uint64)
    unbounded = bal & (rng.random(n) < 0.5)
    amount[unbounded] = 0  # balancing: maxInt
    ev["amount_lo"][:n] = amount
    ev["dr_slot"][:n] = dr_priv[chain]
    to_hub = rng.random(n) < 0.5
    ev["cr_slot"][:n] = np.where(to_hub, hub[rng.integers(0, hubs, n)], cr_priv[chain])
    dr_lim = rng.random(n_chains) < 0.3
    cr_lim = rng.random(n_chains) < 0.2
    ev["dr_flags"][:n] = np.where(dr_lim[chain], AF_DR_LIMIT, 0)
    ev["cr_flags"][:n] = np.where(cr_lim[chain] & ~to_hub, AF_CR_LIMIT, 0)
    ev["static_result"][:n] = np.where(rng.random(n) < 0.03, rng.integers(21, 25, n), 0)
    ev["ts_nonzero"][:n] = rng.random(n) < 0.02
    ev["ledger"][:n] = 1
    ev["code"][:n] = rng.integers(1, 3, n)
    ev["ud64"][:n] = rng.integers(0, 5, n).astype(np.uint64)
    ev["ud32"][:n] = rng.integers(0, 5, n)
    dup = rng.random(n) < 0.03
    ev["e_found"][:n] = dup
    for f in ("flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi", "ud64", "ud32",
              "timeout", "code"):
        ev["e_" + f][:n] = np.where(dup, ev[f][:n], 0)
    ev["e_code"][:n] += (dup & (rng.random(n) < 0.5)).astype(np.uint32)

    table = _table(rng, A, pick)
    dstat = np.zeros(B, np.uint32)
    plan = _plan(ev, n)
    assert [k for k, _ in plan.segments] == ["chains"], plan.segments
    return table, ev, dstat, n, TS_BASE, plan


def wide_case(seed, B, A, rows=None, n=None):
    """(table, ev, dstat, n, ts_base, plan) for a batch whose plan is one
    wave of all n events."""
    rng = np.random.default_rng(seed)
    n = B - 2 if n is None else n
    rows = np.arange(A) if rows is None else np.asarray(rows)
    kind = rng.choice(4, n, p=[0.55, 0.2, 0.15, 0.1])  # posted, pending, post/void, reader
    n_read = int((kind == 3).sum())
    n_shared = min(4096, len(rows) - n_read)
    pick = rng.choice(rows, n_read + n_shared, replace=False).astype(np.int32)
    readers, shared = pick[:n_read], pick[n_read:]

    ev = _blank(B)
    flags = np.zeros(n, np.uint32)
    flags[kind == 1] = F_PENDING
    pv = kind == 2
    flags[pv] = np.where(rng.random(int(pv.sum())) < 0.7, F_POST, F_VOID)
    rd = kind == 3
    flags[rd] = np.where(rng.random(n_read) < 0.5, F_BAL_DR, 0)
    ev["flags"][:n] = flags
    di = rng.integers(0, len(shared), n)
    ev["dr_slot"][:n] = shared[di]
    ev["cr_slot"][:n] = shared[(di + rng.integers(1, len(shared), n)) % len(shared)]
    ev["dr_slot"][:n][rd] = readers
    ev["dr_flags"][:n] = np.where(rd & ((flags & F_BAL_DR) == 0), AF_DR_LIMIT, 0)
    ev["amount_lo"][:n] = rng.integers(1, 3000, n).astype(np.uint64)
    ev["timeout"][:n] = np.where(kind == 1, rng.integers(0, 5, n), 0).astype(np.uint64)
    ev["ledger"][:n] = np.where(pv, 0, 1)
    ev["code"][:n] = np.where(pv, 0, rng.integers(1, 4, n))
    ev["static_result"][:n] = np.where(rng.random(n) < 0.02, rng.integers(8, 25, n), 0)
    ev["ts_nonzero"][:n] = rng.random(n) < 0.01
    ev["ud128_lo"][:n] = rng.integers(0, 4, n).astype(np.uint64)
    ev["ud64"][:n] = rng.integers(0, 4, n).astype(np.uint64)

    # Post/voids: distinct durable pendings (first-wins targets), their
    # own accounts from the shared pool, amounts inherited or partial.
    n_pv = int(pv.sum())
    ev["p_found"][:n] = pv
    ev["p_tgt"][:n][pv] = np.arange(n_pv, dtype=np.int32)
    ev["dr_id_zero"][:n] = pv
    ev["cr_id_zero"][:n] = pv
    ev["p_flags"][:n] = np.where(pv, F_PENDING, 0)
    ev["p_flags"][:n][pv & (rng.random(n) < 0.05)] = 0
    ev["p_dr_slot"][:n] = np.where(pv, shared[rng.integers(0, len(shared), n)], 0)
    ev["p_cr_slot"][:n] = np.where(pv, shared[rng.integers(0, len(shared), n)], 0)
    p_amt = rng.integers(1, 3000, n).astype(np.uint64)
    ev["p_amount_lo"][:n] = np.where(pv, p_amt, 0)
    ev["amount_lo"][:n][pv] = np.where(rng.random(n_pv) < 0.6, 0, p_amt[pv] // 2)
    ev["p_ledger"][:n] = np.where(pv, 1, 0)
    ev["p_code"][:n] = np.where(pv, 2, 0)
    ev["p_timeout"][:n] = np.where(pv, rng.integers(0, 3, n), 0).astype(np.uint64)
    ev["p_timestamp"][:n] = np.where(
        pv, np.uint64(TS_BASE) - rng.integers(0, 3, n).astype(np.uint64) * np.uint64(10**9), 0
    )
    ev["p_ud64"][:n] = np.where(pv, 9, 0).astype(np.uint64)
    dstat = np.zeros(B, np.uint32)
    dstat[:n_pv] = rng.choice([1, 1, 1, 1, 2, 3, 4], n_pv)

    dup = (rng.random(n) < 0.02) & ~pv
    ev["e_found"][:n] = dup
    for f in ("flags", "dr_slot", "cr_slot", "amount_lo", "amount_hi", "ud64", "timeout",
              "code"):
        ev["e_" + f][:n] = np.where(dup, ev[f][:n], 0)
    ev["e_ud64"][:n] += (dup & (rng.random(n) < 0.5)).astype(np.uint64)

    table = _table(rng, A, pick)
    plan = _plan(ev, n)
    assert [k for k, _ in plan.segments] == ["wave"], [k for k, _ in plan.segments]
    return table, ev, dstat, n, TS_BASE, plan


FIX_MODES = ("none", "all", "some")


def finalize_case(seed, B, A, fix):
    """(table (A, 8) u64, carry image (scratch_words(B),) u64, hist_fix
    (B,) bool or None) for finalize: every carry word drawn at random
    (in its field's range: the image is carry_from_dict of its own
    carry_to_dict), about half the results 0, a quarter of the created
    records' account slots outside [0, A) (-1 and A .. A + 3, which the
    rewrite clips), last_applied anywhere in [-1, B).  `fix` is one of
    FIX_MODES: None, all set, or a random third set."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 64, (A, 8), dtype=np.uint64)
    w = rng.integers(0, 1 << 64, k3.scratch_words(B), dtype=np.uint64)
    carry = k3.carry_to_dict(w, B)
    carry["results"] = np.where(rng.random(B) < 0.5, 0, rng.integers(1, 56, B)).astype(
        carry["results"].dtype)
    for name in ("dr_slot", "cr_slot"):
        slots = rng.integers(0, A, B)
        odd = rng.random(B)
        slots = np.where(odd < 0.12, -1, np.where(odd < 0.25, A + rng.integers(0, 4, B), slots))
        carry["created"][name] = slots.astype(carry["created"][name].dtype)
    carry["last_applied"] = int(rng.integers(-1, B))
    words = k3.carry_from_dict(carry)
    hist_fix = {"none": None, "all": np.ones(B, bool), "some": rng.random(B) < 0.33}[fix]
    return table, words, hist_fix


SPEC_CLASSES = ("mixed", "post_void", "balancing", "limits", "exists", "linked", "history")


def _spec_serial(rng, ev, n, B):
    """The engine's serial mask (chain members) plus a few more, as
    uint8 over B lanes."""
    serial = np.zeros(B, np.uint8)
    meta = resolve.spec_meta_from_events(ev, n, False)
    serial[:n] = meta["chain_member"] | (rng.random(n) < 0.05)
    return serial


def spec_stream(seed, count, B, A, rows=None):
    """`count` K9 batches, [(ev, n, serial (B,) uint8)]: scan_cases
    batches of SPEC_CLASSES in turn, all over `rows` (default: every row
    of the A-row table) and one group space, so each batch reuses the
    slots, groups and targets of those before it."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(count):
        cls = SPEC_CLASSES[j % len(SPEC_CLASSES)]
        _t, ev, _d, n, _ts = scan_cases.make_case(seed * 1000 + j, B, cls, A=A, rows=rows)
        out.append((ev, n, _spec_serial(rng, ev, n, B)))
    return out


def distinct_spec_case(seed, B, A, n=None):
    """(ev, n, serial) of a K9 batch in which no two lanes share a slot,
    a token or a target: a "mixed" scan_cases batch whose four slot
    columns take 4 B distinct rows of the A-row table (A >= 4 B), whose
    id groups are distinct, with no pending group and distinct durable
    targets and no linked event.  Its only conflicts are the serial
    mask's."""
    rng = np.random.default_rng(seed)
    # The batch's other columns over a few rows (its slots are replaced).
    _t, ev, _d, n, _ts = scan_cases.make_case(seed, B, "mixed", A=A, n=n, rows=np.arange(8))
    rows = rng.choice(A, 4 * B, replace=False).astype(np.int32)
    for j, name in enumerate(("dr_slot", "cr_slot", "p_dr_slot", "p_cr_slot")):
        ev[name] = rows[j * B:(j + 1) * B]
    ev["id_group"] = np.arange(B, dtype=np.int32)
    ev["p_group"] = np.full(B, -1, np.int32)
    ev["p_tgt"] = np.where(ev["p_found"], np.arange(B), -1).astype(np.int32)
    ev["flags"] = ev["flags"] & np.uint32(~F_LINKED & 0xFFFFFFFF)
    return ev, n, _spec_serial(rng, ev, n, B)
