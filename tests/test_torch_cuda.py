"""Kernels K1-K14 and K3's segment and finalize entries on a CUDA card
against their plain PyTorch versions, and TorchStateMachine on the
card against the CPU run or the plain-version run.  They
skip without a card; on one, run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: the suite's conftest imports the JAX package, which a
machine with the card need not have.)
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch import kernels, workload
from tigerbeetle_tpu_torch.ops.u128 import from_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import (
    commit_cases, flush_cases, orderfree_cases, scan_cases, seeded, semantic_cases,
    shard_cases, wave_cases,
)
from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness
from torch_link_quiet import link_quiet  # noqa: F401  (autouse: no engine lost its link)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tables(rng, A):
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, (A, 4), dtype=np.int64)
    hi = rng.integers(0, 1 << 40, (A, 4), dtype=np.int64)
    meta = np.ones((A, 2), np.int32)
    return (torch.from_numpy(np.stack([lo, hi], -1).reshape(A, 8)),
            torch.from_numpy(meta))


@pytest.mark.parametrize("mode", [dk.MODE_FULL, dk.MODE_LO, dk.MODE_TIGHT])
def test_orderfree_kernel_matches_plain(card, mode):
    rng = np.random.default_rng(mode)
    A, B = 4096, dk.B
    table, meta = _tables(rng, A)
    dr = rng.integers(0, A, B)
    cr = (dr + 1) % A
    if mode == dk.MODE_TIGHT:
        pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
        pk[:, 0] = dk.TIGHT_CODE_BIT
        pk[:, 1], pk[:, 2], pk[:, 3], pk[:, 4] = dr + 1, cr + 1, rng.integers(1, 100, B), 1
        pk[:70, 1] = 0
        pk_t = torch.from_numpy(pk.view(np.int32))
    else:
        pk = np.zeros((B, dk.N_COLS), np.uint64)
        pk[:, dk.COL_SLOTS] = (dr + 1).astype(np.uint64) | (
            (cr + 1).astype(np.uint64) << np.uint64(32)
        )
        pk[:, dk.COL_AMT_LO] = rng.integers(1, 1 << 63, B).astype(np.uint64)
        pk[:, dk.COL_AMT_HI] = rng.integers(0, 1 << 20, B).astype(np.uint64)
        pk[:, dk.COL_MISC] = np.uint64(1 << 16) | np.uint64(1 << 32)
        pk_t = torch.from_numpy(pk.view(np.int64))
    ring = torch.zeros((8, dk.SUMMARY_WORDS), dtype=torch.int64)
    t_p, r_p = table.clone(), ring.clone()
    dk.orderfree_plain(t_p, meta, r_p, 3, pk_t, B - 5, 1 << 40, mode=mode)
    t_k, r_k = table.to(card), ring.to(card)
    before = kernels.launches["orderfree"]
    dk.orderfree(t_k, meta.to(card), r_k, 3, pk_t.to(card), B - 5, 1 << 40, mode=mode)
    torch.cuda.synchronize()
    assert kernels.launches["orderfree"] == before + 1
    assert torch.equal(t_k.cpu(), t_p) and torch.equal(r_k.cpu(), r_p)


def _k1_vs_plain(card, table, meta, pk, n, mode, scratch=None, ts_base=1 << 40, ring_at=3):
    """One K1 launch on the card against orderfree_plain on the CPU
    (numpy inputs), bit for bit; returns the summary and the kernel's
    new table (CPU)."""
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).view(dt).copy())  # noqa: E731
    t, m = to(table, np.int64), to(meta, np.int32)
    p = to(pk, np.int32 if pk.dtype == np.uint32 else np.int64)
    ring = torch.zeros((8, dk.SUMMARY_WORDS), dtype=torch.int64)
    t_p, r_p = t.clone(), ring.clone()
    dk.orderfree_plain(t_p, m, r_p, ring_at, p, n, ts_base, mode=mode)
    t_k, r_k = t.to(card), ring.to(card)
    before = kernels.launches["orderfree"]
    dk.orderfree(t_k, m.to(card), r_k, ring_at, p.to(card), n, ts_base, mode=mode,
                 scratch=scratch)
    torch.cuda.synchronize()
    assert kernels.launches["orderfree"] == before + 1
    assert torch.equal(t_k.cpu(), t_p) and torch.equal(r_k.cpu(), r_p)
    return dk.unpack_summary(r_p[ring_at].numpy().view(np.uint64)), t_p


def _k1_batch(mode, B, dr, cr, amt_lo, amt_hi=0, pending=None):
    """A K1 batch in `mode`'s format: tight keeps amounts' low 32 bits."""
    if mode == dk.MODE_TIGHT:
        return orderfree_cases.pack_tight(B, dr, cr, np.asarray(amt_lo, np.uint64) & M32_NP)
    flags = 0 if pending is None else np.where(pending, dk.F_PENDING, 0)
    return orderfree_cases.pack_wide(B, dr, cr, amt_lo, amt_hi, flags=flags)


M32_NP = np.uint64((1 << 32) - 1)
MODES = [dk.MODE_FULL, dk.MODE_LO, dk.MODE_TIGHT]


@pytest.mark.parametrize("mode", MODES)
def test_orderfree_kernel_one_pair_largest_sums(card, mode):
    """Every event on one pair of rows, every amount limb 2^32 - 1: the
    largest limb sums (8190 x (2^32 - 1) per limb) and one owner's
    hottest row, combined in warps; zero balances, so lo and tight
    apply and full (every limb of 2^128 - 1) overflows."""
    B, n, A = dk.B, 8190, 1 << 12
    table = np.zeros((A, 8), np.uint64)
    meta = np.ones((A, 2), np.uint32)
    pending = np.random.default_rng(3).random(n) < 0.3
    pk = _k1_batch(mode, B, np.full(n, 17), np.full(n, 4000), np.full(n, (1 << 64) - 1,
                   np.uint64), np.full(n, (1 << 64) - 1, np.uint64), pending)
    s, t = _k1_vs_plain(card, table, meta, pk, n, mode)
    assert s["overflow"] == (mode == dk.MODE_FULL) and s["n_fail"] == 0
    assert (t.numpy() != 0).any() == (mode != dk.MODE_FULL)


@pytest.mark.parametrize("mode", MODES)
def test_orderfree_kernel_crowded_hash_rows(card, mode):
    """16,380 distinct rows whose homes in K1's hash table all lie in its
    first 4096 slots (an eighth of it): long probe chains; a second
    batch on the same scratch (bit-exact only if the first left the
    table at rest)."""
    B, n, A = dk.B, 8190, 1 << 20
    rows = orderfree_cases.crowded_slots(A, 2 * n, B, 4096)
    rng = np.random.default_rng(4)
    table, meta = orderfree_cases.tables(rng, A)
    scratch = dk.OrderfreeScratch(B, card)
    for k in range(2):
        perm = rng.permutation(rows)
        pk = _k1_batch(mode, B, perm[:n], perm[n:], rng.integers(1, 1 << 62, n, dtype=np.int64),
                       rng.integers(0, 1 << 20, n), rng.random(n) < 0.5)
        s, table = _k1_vs_plain(card, table, meta, pk, n, mode, scratch=scratch)
        table = table.numpy().view(np.uint64)
        assert not s["overflow"] and s["n_fail"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_orderfree_kernel_every_event_fails(card, mode):
    """A batch where every event fails (debit or credit account not
    found, same accounts): the summary caps at FAIL_CAP, nothing
    applies, last applied + 1 is 0."""
    B, n, A = dk.B, 8190, 1 << 12
    rng = np.random.default_rng(5)
    table, meta = orderfree_cases.tables(rng, A)
    dr = rng.integers(0, A, n)
    cr = (dr + 1) % A
    dr[0::2] = -1
    cr[1::2] = -1
    pk = _k1_batch(mode, B, dr, cr, rng.integers(1, 100, n))
    s, t = _k1_vs_plain(card, table, meta, pk, n, mode)
    assert s["n_fail"] == n and s["cap_exceeded"] and s["last_applied"] == -1
    assert np.array_equal(t.numpy().view(np.uint64), table)


@pytest.mark.parametrize("mode", MODES)
def test_orderfree_kernel_overflow_then_second_launch(card, mode):
    """An overflowing batch (one row at 2^128 - 1 in its column), then a
    second batch on the same scratch: bit-exact only if the first left
    the hash table at rest."""
    B, n, A = dk.B, 8190, 1 << 16
    rng = np.random.default_rng(6)
    table, meta = orderfree_cases.tables(rng, A)
    scratch = dk.OrderfreeScratch(B, card)
    dr = rng.integers(0, A, n)
    bad = int(dr[0])
    table[bad, 2:4] = np.uint64((1 << 64) - 1)   # debits_posted of event 0's debit row
    pk = _k1_batch(mode, B, dr, (dr + 1) % A, rng.integers(1, 1 << 40, n))
    s, t = _k1_vs_plain(card, table, meta, pk, n, mode, scratch=scratch)
    assert s["overflow"] and np.array_equal(t.numpy().view(np.uint64), table)
    table[bad, 2:4] = 0
    dr = rng.integers(0, A, n)
    pk = _k1_batch(mode, B, dr, (dr + 1) % A, rng.integers(1, 1 << 40, n))
    s, _ = _k1_vs_plain(card, table, meta, pk, n, mode, scratch=scratch)
    assert not s["overflow"]


@pytest.mark.parametrize("n", [0, 1, 511, 4097])
def test_orderfree_kernel_partial_batches(card, n):
    """n = 0 and n < B: padding events never apply or fail."""
    B, A = dk.B, 1 << 12
    rng = np.random.default_rng(7 + n)
    table, meta = orderfree_cases.tables(rng, A)
    dr = rng.integers(0, A, B)
    for mode in MODES:
        pk = _k1_batch(mode, B, dr, (dr + 3) % A, rng.integers(1, 1 << 30, B))
        s, _ = _k1_vs_plain(card, table, meta, pk, n, mode)
        assert s["n_active"] == n and s["last_applied"] == n - 1


@pytest.mark.parametrize("B", [32, 512, 1000, 8192])
def test_orderfree_kernel_five_row_table(card, B):
    """A 5-row table (every event on a few rows, some slots past it) at
    one-block and cluster batch sizes."""
    A, n = 5, B - 3
    rng = np.random.default_rng(B)
    table, meta = orderfree_cases.tables(rng, A)
    dr = rng.integers(0, A, n)
    cr = (dr + rng.integers(1, A, n)) % A
    cr[::97] = A + 3                             # a slot past the table (clamped)
    for mode in MODES:
        pk = _k1_batch(mode, B, dr, cr, rng.integers(1, 1 << 60, n, dtype=np.int64),
                       rng.integers(0, 4, n), rng.random(n) < 0.5)
        _k1_vs_plain(card, table, meta, pk, n, mode)


@pytest.mark.parametrize("mode", MODES)
def test_orderfree_kernel_skewed(card, mode):
    """gen_zipf's skew: 8190 events over 100 accounts."""
    table, meta, pk, n = orderfree_cases.skewed(8, dk.B, 8190, 1 << 12)
    if mode != dk.MODE_TIGHT:
        w = pk[:n].astype(np.int64)
        pk = _k1_batch(mode, dk.B, w[:, 1] - 1, w[:, 2] - 1, w[:, 3], w[:, 3] >> 4,
                       np.random.default_rng(9).random(n) < 0.3)
    _k1_vs_plain(card, table, meta, pk, n, mode)


@pytest.mark.parametrize("kind", ["orderfree", "orderfree_lo", "orderfree_tight"])
def test_orderfree_run_window_wraps_the_ring(card, kind):
    """G = 4 batches through scan_of and through run_window (offsets
    past the stack's end wrap and clamp as dynamic_slice), ring rows
    wrapping past the end: each equals its plain loop."""
    G, A = 4, 1 << 16
    table, meta, ring, stack, ns, tsb = _launcher_inputs(kind, A, G, card)
    outs = []
    for plain in (False, True):
        t, r = table.clone(), ring.clone()
        dk.scan_of(kind, G, plain=plain)(t, meta, r, 254, stack, ns, tsb)
        fn = dk.PLAIN[kind] if plain else None
        dk.run_window(kind, t, meta, r, 255, stack, 2, G, ns, tsb, fn=fn)
        torch.cuda.synchronize()
        outs.append((t, r))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_commitment_kernels_match_plain(card):
    rng = np.random.default_rng(5)
    table, meta = _tables(rng, 5000)
    rows = torch.arange(5000)
    rh_p, dg_p = cm.rebuild_plain(table, meta, rows)
    rh_k, dg_k = cm.rebuild(table.to(card), meta.to(card), rows.to(card))
    assert torch.equal(rh_k.cpu(), rh_p) and torch.equal(dg_k.cpu(), dg_p)
    slots = torch.from_numpy(cm.pad_slots(np.sort(rng.choice(5000, 300, replace=False))))
    table[slots[:300], 5] += 3
    cm.update_plain(table, meta, rh_p, dg_p, slots, slots)
    cm.update(table.to(card), meta.to(card), rh_k, dg_k, slots.to(card), slots.to(card))
    assert torch.equal(rh_k.cpu(), rh_p) and torch.equal(dg_k.cpu(), dg_p)
    got = cm.probe(table.to(card), meta.to(card), dg_k, rows.to(card))
    assert torch.equal(got.cpu(), cm.probe_plain(table, meta, dg_p, rows))


@pytest.mark.parametrize("engine", ["device", "host"])
def test_state_machine_on_card_matches_cpu(card, engine):
    setup, timed, sizing = workload.gen_simple(20_000, batch=2000)
    ops = setup + timed
    roots, replies = [], []
    for device in (None, "cpu"):
        sm = TorchStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                               device=device, engine=engine)
        h = SingleNodeHarness(sm)
        futs = [h.submit_async(op, body) for op, body in ops]
        replies.append([f.result() for f in futs])
        sm.verify_device_mirror()
        roots.append(sm.state_root())
    assert replies[0] == replies[1] and roots[0] == roots[1]


@pytest.mark.parametrize("B,cls", [(B, c) for B in (256, 8192) for c in scan_cases.CLASSES])
def test_exact_scan_kernel_matches_plain(card, B, cls):
    table, ev, dstat, n, ts_base = scan_cases.make_case(
        B + scan_cases.CLASSES.index(cls), B, cls, A=4096,
        rows=np.arange(0, 4096, 97), n=min(B, 8190),
    )
    t = torch.from_numpy(table.view(np.int64))
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
    ds = torch.from_numpy(dstat.view(np.int32))
    t_p = t.clone()
    _, out_p = k3.run_create_transfers(t_p, pk, ds, n, ts_base)
    t_k = t.to(card)
    before = kernels.launches["exact_scan"]
    _, out_k = k3.run_create_transfers(t_k, pk.to(card), ds.to(card), n, ts_base)
    torch.cuda.synchronize()
    assert kernels.launches["exact_scan"] == before + 1
    assert torch.equal(out_k.cpu(), out_p) and torch.equal(t_k.cpu(), t_p)


@pytest.mark.parametrize("padded", [False, True])
def test_apply_deltas_kernel_matches_plain(card, padded):
    rng = np.random.default_rng(9)
    A, K = 1 << 16, 32_768
    table, _ = _tables(rng, A)
    keys = rng.choice(A * 4, size=K // 2 if padded else K, replace=False)
    packed = np.zeros((4, K), np.int64)
    packed[0, : len(keys)] = keys // 4
    packed[1, : len(keys)] = keys % 4
    packed[2, : len(keys)] = rng.integers(-(1 << 63), (1 << 63) - 1, len(keys))
    packed[3, : len(keys)] = rng.integers(-(1 << 63), (1 << 63) - 1, len(keys))
    packed[0, len(keys):] = A + np.arange(K - len(keys))
    pk = torch.from_numpy(packed)
    t_p = dk.apply_deltas(table.clone(), pk)
    before = kernels.launches["apply_deltas"]
    t_k = dk.apply_deltas(table.to(card), pk.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["apply_deltas"] == before + 1
    assert torch.equal(t_k.cpu(), t_p)


def _k4_vs_plain(card, table, pk, offset=0):
    """K4 on a copy of `table` on the card (`offset` int64 words past a
    16-byte aligned allocation) against the plain version on the CPU,
    one launch."""
    t_p = dk.apply_deltas(table.clone(), pk)
    base = torch.empty(table.numel() + offset, dtype=torch.int64, device=card)
    t_k = base[offset:].view(table.shape)
    t_k.copy_(table.to(card))
    assert (t_k.data_ptr() % 16 == 0) == (offset % 2 == 0)
    before = kernels.launches["apply_deltas"]
    dk.apply_deltas(t_k, pk.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["apply_deltas"] == before + (pk.shape[1] > 0)
    assert torch.equal(t_k.cpu(), t_p)


def _k4_entries(rng, A, k, padding=0):
    keys = rng.choice(A * 4, size=k - padding, replace=False)
    packed = np.zeros((4, k), np.int64)
    packed[0, : len(keys)] = keys // 4
    packed[1, : len(keys)] = keys % 4
    packed[2:, : len(keys)] = rng.integers(-(1 << 63), (1 << 63) - 1, (2, len(keys)))
    packed[0, len(keys):] = A + np.arange(padding)
    packed[2, len(keys):] = 5
    return torch.from_numpy(packed)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 127, 4097, 32_767])
@pytest.mark.parametrize("offset", [0, 1])
def test_apply_deltas_kernel_uneven_counts_match_plain(card, k, offset):
    """One entry, counts that no thread's share of entries divides (the
    last live or padding), on a 16-byte aligned table and on a view one
    word off it (the 8-byte path)."""
    rng = np.random.default_rng(k + offset)
    table, _ = _tables(rng, 1 << 14)
    _k4_vs_plain(card, table, _k4_entries(rng, 1 << 14, k, padding=k // 3), offset)


@pytest.mark.parametrize("compact", [False, True])
def test_apply_deltas_kernel_flush_shapes_match_plain(card, compact):
    """A simple_host flush on a 2^20-row table, and a sharded_host flush
    on its compact table (the flushed rows only), launch by launch."""
    table, chunks = flush_cases.flush_case(31, 1 << 20, 1_000_000, compact=compact)
    t = torch.from_numpy(table)
    t_k = t.to(card)
    for packed in chunks:
        pk = torch.from_numpy(packed)
        dk.apply_deltas(t, pk)
        dk.apply_deltas(t_k, pk.to(card))
    torch.cuda.synchronize()
    assert len(chunks) == 3 and torch.equal(t_k.cpu(), t)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_exact_streams_on_card_match_cpu(card, engine, monkeypatch):
    """The bench's linked and two_phase shapes at 2000 events per batch:
    K3 (and K2 updates, K4 flushes) on the card against the plain run,
    with the scan routing (no wave plans)."""
    monkeypatch.setenv("TB_WAVES", "scan")
    monkeypatch.setenv("TB_DEV_WAVES", "0")
    for gen in (workload.gen_linked, workload.gen_two_phase):
        setup, timed, sizing = gen(6000, batch=2000)
        ops = setup + timed
        out = []
        for device in (None, "cpu"):
            sm = TorchStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                                   device=device, engine=engine)
            h = SingleNodeHarness(sm)
            futs = [h.submit_async(op, body) for op, body in ops]
            replies = [f.result() for f in futs]
            sm.verify_device_mirror()
            routed = (sm.stat_exact_batches, sm.stat_linked_batches,
                      sm.stat_two_phase_batches, sm.stat_resolve_iters)
            out.append((replies, sm.state_root(), routed))
        assert out[0] == out[1]
        exact, linked, two_phase, _ = out[0][2]
        if engine == "host":
            assert exact > 0
        else:  # the device engine routes them to K5 and K6
            assert (linked if gen is workload.gen_linked else two_phase) > 0


def _semantic_on_card(card, kind, table, meta, pk, n):
    """One K5 or K6 batch on the card and on the plain version (CPU):
    the table and the whole ring are equal, and the kernel launched
    once."""
    fn, name = (dk.linked, "linked") if kind.startswith("linked") else (dk.two_phase, "two_phase")
    variant = {"small": kind == "linked_small"} if name == "linked" else {"lo_only": kind == "two_phase_lo"}
    t = torch.from_numpy(table.view(np.int64).copy())
    m = torch.from_numpy(meta.view(np.int32).copy())
    pk_t = torch.from_numpy(pk.view(np.int64).copy())
    ring = torch.zeros((8, dk.SUMMARY_WORDS), dtype=torch.int64)
    t_p, r_p = t.clone(), ring.clone()
    fn(t_p, m, r_p, 3, pk_t, n, 1 << 40, **variant)
    t_k, r_k = t.to(card), ring.to(card)
    before = kernels.launches[name]
    fn(t_k, m.to(card), r_k, 3, pk_t.to(card), n, 1 << 40, **variant)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert torch.equal(r_k.cpu(), r_p)
    assert torch.equal(t_k.cpu(), t_p)


@pytest.mark.parametrize("scenario", semantic_cases.LINKED_SCENARIOS)
@pytest.mark.parametrize("kind", ["linked", "linked_small"])
def test_linked_kernel_matches_plain(card, kind, scenario):
    i = semantic_cases.LINKED_SCENARIOS.index(scenario)
    _semantic_on_card(card, kind, *semantic_cases.linked_case(500 + i, dk.B, scenario, A=4096))


@pytest.mark.parametrize("scenario", semantic_cases.TWO_PHASE_SCENARIOS)
@pytest.mark.parametrize("kind", ["two_phase", "two_phase_lo"])
def test_two_phase_kernel_matches_plain(card, kind, scenario):
    i = semantic_cases.TWO_PHASE_SCENARIOS.index(scenario)
    _semantic_on_card(card, kind, *semantic_cases.two_phase_case(600 + i, dk.B, scenario, A=4096))


@pytest.mark.parametrize("kind", ["linked", "two_phase"])
def test_semantic_kernels_above_2_17_rows(card, kind):
    """Slots above 2^17 (the reference's u64-key sort path)."""
    A = (1 << 17) + 4096
    rows = np.arange(1 << 17, A)
    gen = semantic_cases.linked_case if kind == "linked" else semantic_cases.two_phase_case
    _semantic_on_card(card, kind, *gen(700, dk.B, "limits" if kind == "linked" else "races",
                                       A=A, rows=rows))


@pytest.mark.parametrize("kind", ["two_phase", "two_phase_lo"])
def test_two_phase_kernel_one_scratch_rests(card, kind):
    """K6 over every scenario in turn with ONE scratch, flagged batches
    among them: each batch equals the plain version bit for bit, and
    after each the hash table (keys, sums, marks) and the target
    segments are back at zero (only the blocks' totals, the last 3 x
    1024 int32, are written anew).  One cooperative grid of at most one
    block per SM."""
    blocks, threads, _smem = kernels.two_phase_geometry(dk.B)
    assert blocks * threads >= dk.B
    assert blocks <= torch.cuda.get_device_properties(card).multi_processor_count
    scratch = dk.TwoPhaseScratch(dk.B, card)
    rest = scratch.words.numel() - 3 * 1024 // 2
    for i, scenario in enumerate(semantic_cases.TWO_PHASE_SCENARIOS):
        table, meta, pk, n = semantic_cases.two_phase_case(650 + i, dk.B, scenario, A=1 << 15)
        t = torch.from_numpy(table.view(np.int64).copy())
        m = torch.from_numpy(meta.view(np.int32).copy())
        pk_t = torch.from_numpy(pk.view(np.int64).copy())
        ring = torch.zeros((8, dk.SUMMARY_WORDS), dtype=torch.int64)
        t_p, r_p = t.clone(), ring.clone()
        dk.two_phase(t_p, m, r_p, 2, pk_t, n, 1 << 40, lo_only=kind == "two_phase_lo")
        t_k, r_k = t.to(card), ring.to(card)
        dk.two_phase(t_k, m.to(card), r_k, 2, pk_t.to(card), n, 1 << 40,
                     lo_only=kind == "two_phase_lo", scratch=scratch)
        torch.cuda.synchronize()
        assert torch.equal(r_k.cpu(), r_p), scenario
        assert torch.equal(t_k.cpu(), t_p), scenario
        assert not scratch.words[:rest].any(), f"{scenario}: scratch not at rest"


def test_two_phase_kernel_refuses_what_it_does_not_take(card):
    """Above 8192 events, or a table off 16-byte alignment, the wrapper
    raises before any launch."""
    table, meta, pk, n = semantic_cases.two_phase_case(660, dk.B, "mixed", A=4096)
    m = torch.from_numpy(meta.view(np.int32)).to(card)
    ring = torch.zeros((2, dk.SUMMARY_WORDS), dtype=torch.int64, device=card)
    big = torch.from_numpy(np.concatenate([pk, pk]).view(np.int64)).to(card)
    t = torch.from_numpy(table.view(np.int64)).to(card)
    with pytest.raises(ValueError, match="8192"):
        dk.two_phase(t, m, ring, 0, big, n, 1 << 40)
    off = torch.zeros(table.size + 1, dtype=torch.int64, device=card)[1:].view(-1, 8)
    with pytest.raises(ValueError, match="16-byte"):
        dk.two_phase(off, m, ring, 0, big[:dk.B], n, 1 << 40)


def _entries(meta, pk, n):
    """Limit entries of a batch (events whose debit / credit account
    carries a limit flag), before the static ladder."""
    lim = dk.AF_DR_LIMIT | dk.AF_CR_LIMIT
    w = pk[:n, dk.COL_SLOTS]
    count = 0
    for s in ((w & np.uint64(0xFFFFFFFF)).astype(np.int64) - 1, (w >> np.uint64(32)).astype(np.int64) - 1):
        count += int(((s >= 0) & ((meta[np.clip(s, 0, None), 0] & lim) != 0)).sum())
    return count


@pytest.mark.parametrize("entries", ["none", "few", "all"])
@pytest.mark.parametrize("kind", ["linked", "linked_small"])
def test_linked_kernel_entry_counts(card, kind, entries):
    """K5 at B = 8192 (one cluster of 16 blocks) with no limit entry, a
    few, and 2B (both sides of every event limited)."""
    table, meta, pk, n = semantic_cases.linked_case(800, dk.B, "limits", A=4096, pool=1000)
    slots = (pk[:n, dk.COL_SLOTS] & np.uint64(0xFFFFFFFF)).astype(np.int64) - 1
    meta[:, 0] = 0
    if entries == "few":
        meta[slots[17], 0] = dk.AF_DR_LIMIT
        table[slots[17]] = 0     # unfunded: its debits fail
    elif entries == "all":
        meta[:, 0] = dk.AF_DR_LIMIT | dk.AF_CR_LIMIT
    V = _entries(meta, pk, n)
    assert (V == 0) if entries == "none" else (0 < V < 64 if entries == "few" else V == 2 * n)
    assert kernels.linked_geometry(dk.B)[0] == 16
    _semantic_on_card(card, kind, table, meta, pk, n)


@pytest.mark.parametrize("kind", ["linked", "linked_small"])
def test_linked_kernel_segment_across_blocks(card, kind):
    """One debit-limited hub account named by every other event: its
    segment of ~4096 sorted entries spans several blocks' shares, so
    its prefixes and boundaries are read across the cluster."""
    table, meta, pk, n = semantic_cases.linked_case(801, dk.B, "limits", A=4096, pool=1000)
    hub = 4000
    meta[hub, 0] = dk.AF_DR_LIMIT
    table[hub] = 0
    table[hub, 6] = 1_000_000     # credits for ~half the hub's debits
    w = pk[:n, dk.COL_SLOTS]
    cr = (w >> np.uint64(32)).astype(np.int64) - 1
    every = np.arange(n) % 2 == 0
    every &= cr != hub
    pk[:n, dk.COL_SLOTS] = np.where(every, np.uint64(hub + 1) | (w & ~np.uint64(0xFFFFFFFF)), w)
    _semantic_on_card(card, kind, table, meta, pk, n)


@pytest.mark.parametrize("B", [32, 512, 2048])
def test_linked_kernel_smaller_batches(card, B):
    """Smaller power-of-two batches: one block (B <= 512, where the
    fixpoint's 64 iterations run on __syncthreads) and a 4-block
    cluster, on the non-converging cascade and on limits."""
    assert kernels.linked_geometry(B)[0] == max(1, B // 512)
    for scenario in ("nonconverge", "limits") if B >= 128 else ("limits",):
        # Seed 803 + B: a cascade the random chains leave whole (64
        # iterations, FLAG_PRECOND).
        table, meta, pk, n = semantic_cases.linked_case(803 + B, B, scenario, A=4096)
        _semantic_on_card(card, "linked_small", table, meta, pk, n)
        _semantic_on_card(card, "linked", table, meta, pk, n)


@pytest.mark.parametrize("case", ["round_2", "round_3", "near_below", "near_above"])
@pytest.mark.parametrize("kind", ["linked", "linked_small"])
def test_linked_kernel_precondition_float_sum(card, kind, case):
    """The contribution sum rounded per element to float64 and summed in
    float64 (the reference's test), on the inputs where rounding
    decides and on totals near 2^61."""
    amounts = dict(semantic_cases.FLOAT_SUM_AMOUNTS,
                   near_below=semantic_cases.near_bound_amounts(61, 512, (1 << 61) - (1 << 30)),
                   near_above=semantic_cases.near_bound_amounts(62, 512, (1 << 61) + (1 << 30)))
    _semantic_on_card(card, kind, *semantic_cases.float_sum_case(5, dk.B, amounts[case], A=4096))


# ---------------------------------------------------------------------------
# The wave kernels: K7, K8, K9 and K3's segments and finalize.


def _wave_inputs(card, table, ev, dstat):
    """(table, packed events, carry) on the card, the carry initialised
    by tb_exact_init, and the same three for the plain run (on the card
    too), with exact_init held against make_carry."""
    t = torch.from_numpy(table.view(np.int64)).to(card)
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64)).to(card)
    ds = torch.from_numpy(dstat.view(np.int32)).to(card)
    B = pk.shape[0]
    w_k = torch.empty(k3.scratch_words(B), dtype=torch.int64, device=card)
    before = kernels.launches["exact_init"]
    k3.exact_init(w_k, ds)
    w_p = k3.make_carry(torch.empty_like(w_k), ds)
    torch.cuda.synchronize()
    assert kernels.launches["exact_init"] == before + 1 and torch.equal(w_k, w_p)
    return (t, pk, w_k), (t.clone(), pk, w_p)


def _step(card, plan, k, ev, n, ts_base, kern, plain):
    """Segment k of the plan with the kernel on `kern` and the plain
    version on `plain` ((table, events, carry) each); both equal after."""
    kind, idx = plan.segments[k]
    B = kern[1].shape[0]
    if kind == "chains":
        ix = torch.from_numpy(waves._chain_plane(ev["flags"], idx, plan.chain_steps[k], B))
        name, run_k = "chain_wave", lambda t, p, w, x: waves.chain_wave(
            t, p, w, x, n, ts_base)
        run_p = lambda t, p, w, x: waves.chain_wave_plain(t, p, w, x, n, ts_base)  # noqa: E731
    elif kind == "wave":
        ix = torch.from_numpy(np.asarray(idx, np.int32))
        name, run_k = "wave_step", lambda t, p, w, x: waves.wave_step(
            t, p, w, x, n, ts_base)
        run_p = lambda t, p, w, x: waves.wave_step_plain(t, p, w, x, n, ts_base)  # noqa: E731
    else:
        ix = torch.from_numpy(np.asarray(idx, np.int32))
        name = "exact_segment"
        run_k = lambda t, p, w, x: k3.scan_segment(t, p, w, x, n, ts_base)  # noqa: E731
        run_p = lambda t, p, w, x: k3.scan_segment_plain(t, p, w, x, n, ts_base)  # noqa: E731
    ix = ix.to(card)
    before = kernels.launches[name]
    run_k(*kern, ix)
    run_p(*plain, ix)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert torch.equal(kern[0], plain[0]), f"{kind}: table"
    assert torch.equal(kern[2], plain[2]), f"{kind}: carry"


def _run_plan(card, case):
    table, ev, dstat, n, ts_base, plan = case
    kern, plain = _wave_inputs(card, table, ev, dstat)
    for k in range(len(plan.segments)):
        _step(card, plan, k, ev, n, ts_base, kern, plain)
    B = kern[1].shape[0]
    fix = torch.zeros(B, dtype=torch.uint8)
    fix[:n] = torch.from_numpy(plan.wave_mask.astype(np.uint8))
    fix = fix.to(card)
    out_k = k3.finalize(kern[0], kern[2], B, fix)
    out_p = k3.finalize_plain(plain[0], plain[2], B, fix)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    return plan


@pytest.mark.parametrize("B,offset", [(8192, 0), (8191, 0), (1, 0), (8192, 1), (4097, 1)])
def test_exact_init_kernel_matches_plain(card, B, offset):
    """K3 init alone: the wave batch, an odd B (8-byte words), one row,
    and carries one word off 16-byte alignment (8-byte words too); a
    scratch left by an earlier batch comes out as make_carry's, the
    words past the carry keep their sentinel; one launch a call."""
    rng = np.random.default_rng(B + offset)
    n = k3.scratch_words(B)
    ds = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, B, dtype=np.int64)
                          .astype(np.int32)).to(card)
    base = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n + offset + 3)).to(card)
    tail = base[offset + n:].clone()
    w = base[offset:offset + n]
    assert (w.data_ptr() % 16 == 0) == (offset == 0)
    before = kernels.launches["exact_init"]
    k3.exact_init(w, ds)
    want = k3.make_carry(torch.empty_like(w), ds)
    torch.cuda.synchronize()
    assert kernels.launches["exact_init"] == before + 1
    assert torch.equal(w, want)
    assert torch.equal(base[offset + n:], tail)


@pytest.mark.parametrize("fix", wave_cases.FIX_MODES)
@pytest.mark.parametrize("B,A,offset", [(203, 37, 0), (8192, 1 << 20, 0), (8192, 4096, 1),
                                        (97, 5000, 1)])
def test_finalize_kernel_matches_plain(card, B, A, offset, fix):
    """K3 finalize alone on seeded carries (wave_cases.finalize_case):
    batches that are odd or a multiple of the 32-row tile, no row /
    every row / a third fixed, rewrites at created slots that clip, a
    compact table, and a carry one word off 16-byte alignment (the
    snapshots then move in 8-byte pieces); one launch, bit for bit."""
    table, words, hist_fix = wave_cases.finalize_case(B + A + offset, B, A, fix)
    t = torch.from_numpy(table.view(np.int64)).to(card)
    w = torch.zeros(words.size + offset, dtype=torch.int64, device=card)[offset:]
    w.copy_(torch.from_numpy(words.view(np.int64)))
    hf = None if hist_fix is None else torch.from_numpy(hist_fix.astype(np.uint8)).to(card)
    assert kernels.exact_finalize_geometry(B) == (-(-B // 32), 128)
    before = kernels.launches["exact_finalize"]
    out = k3.finalize(t, w, B, hf)
    want = k3.finalize_plain(t, w, B, hf)
    torch.cuda.synchronize()
    assert kernels.launches["exact_finalize"] == before + 1
    assert torch.equal(out, want)


@pytest.mark.parametrize("cls", scan_cases.CLASSES)
def test_wave_plans_match_plain(card, cls):
    """Every segment kind of real plans — waves, chain waves, scan
    segments resumed from wave carries — and finalize, kernel against
    plain version from the same carry, step by step."""
    kinds = set()
    for seed in range(3):
        for B in (256, 2048):
            plan = _run_plan(card, wave_cases.plan_case(
                31 * seed + B + scan_cases.CLASSES.index(cls), B, cls, A=4096,
                rows=np.arange(0, 4096, 37)))
            kinds |= {k for k, _ in plan.segments}
    assert "wave" in kinds


@pytest.mark.parametrize("n_chains,max_len", [(4096, 2), (1000, 7), (40, 7)])
def test_chain_wave_matches_plain(card, n_chains, max_len):
    """K8: dead chains (static codes, duplicates, limits, an open tail)
    and hub accounts credited by many chains."""
    _run_plan(card, wave_cases.chain_case(n_chains + max_len, n_chains, 8192, A=1 << 17,
                                          max_len=max_len))


def _chain_wave_case(seed, n_chains, max_len, P=None, dead_at=None):
    """A chain_case batch on a 2^17-row table (hub accounts credited by
    chains in every block, an open tail) and its (P, C) plane, C =
    `n_chains`, the first of at least 40 (the planner scans fewer); with
    `dead_at`, every chain's member at that position fails statically."""
    table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(
        seed, max(n_chains, 40), 8192, A=1 << 17, max_len=max_len)
    P = plan.chain_steps[0] if P is None else P
    plane = waves._chain_plane(ev["flags"], plan.segments[0][1], max(P, max_len), 8192)
    plane = np.ascontiguousarray(plane[:P, :n_chains])
    if dead_at is not None:
        cells = plane[dead_at]
        ev["static_result"][cells[cells < 8192]] = 22
    return (table, ev, dstat, n, ts_base), plane


def _chain_wave_check(card, case, plane, words=None):
    """K8 against its plain version on one plane, bit for bit; `words`
    (the kernel's carry buffer) is initialised for this batch in place."""
    table, ev, dstat, n, ts_base = case
    kern, plain = _wave_inputs(card, table, ev, dstat)
    if words is not None:
        kern = (kern[0], kern[1],
                k3.exact_init(words, torch.from_numpy(dstat.view(np.int32)).to(card)))
    plane = torch.from_numpy(np.ascontiguousarray(plane)).to(card)
    before = kernels.launches["chain_wave"]
    waves.chain_wave(*kern, plane, n, ts_base)
    waves.chain_wave_plain(*plain, plane, n, ts_base)
    torch.cuda.synchronize()
    assert kernels.launches["chain_wave"] == before + 1
    assert torch.equal(kern[0], plain[0]), "table"
    size = plain[2].numel()
    assert torch.equal(kern[2][:size], plain[2]), "carry"
    return k3.carry_to_dict(kern[2], kern[1].shape[0])


@pytest.mark.parametrize("n_chains", [1, 33, 511, 512, 513, 2048, 4095])
def test_chain_wave_across_blocks_matches_plain(card, n_chains):
    """K8 over one to sixteen blocks of a cluster: chains in different
    blocks credit the same hub accounts, so every snapshot after the
    first position holds other blocks' adds."""
    case, plane = _chain_wave_case(100 + n_chains, n_chains, 2 if n_chains > 2048 else 4)
    res = _chain_wave_check(card, case, plane)["results"]
    assert (res[:case[3]] == 0).any()


@pytest.mark.parametrize("P", [1, "max"])
def test_chain_wave_position_counts_match_plain(card, P):
    """One position, and the longest plane the admission makes
    (TB_WAVES_CHAIN_MAX chains, bucketed)."""
    longest = waves.chain_max()
    case, plane = _chain_wave_case(7, 100, longest,
                                   P=1 if P == 1 else waves._bucket_positions(longest))
    _chain_wave_check(card, case, plane)


def test_chain_wave_every_chain_dead_matches_plain(card):
    """Every chain fails at its second member: all of them repaired."""
    case, plane = _chain_wave_case(9, 3000, 2, dead_at=1)
    res = _chain_wave_check(card, case, plane)["results"]
    first = res[plane[0][plane[0] < 8192]]
    assert (first != 0).all() and (first == 1).any()


def test_chain_wave_reused_scratch_matches_plain(card):
    """K8's only scratch is the carry: a WaveScratch carry reused, dirty
    past the batch's words, from a larger batch's chain wave."""
    words = waves.WaveScratch(card).carry()
    for n_chains, B in ((4095, 8192), (40, 2048)):
        table, ev, dstat, n, ts_base, plan = wave_cases.chain_case(
            11 + n_chains, n_chains, B, A=1 << 17, max_len=2)
        plane = waves._chain_plane(ev["flags"], plan.segments[0][1], plan.chain_steps[0], B)
        _chain_wave_check(card, (table, ev, dstat, n, ts_base), plane, words=words)


def _segments_check(card, case, segments):
    """K3 segments one after another on one carry, each against its
    plain version from the same carry; the carry dict after each."""
    table, ev, dstat, n, ts_base = case
    kern, plain = _wave_inputs(card, table, ev, dstat)
    seen = []
    for rows in segments:
        rows_t = torch.from_numpy(np.asarray(rows, np.int32)).to(card)
        before = kernels.launches["exact_segment"]
        k3.scan_segment(*kern, rows_t, n, ts_base)
        k3.scan_segment_plain(*plain, rows_t, n, ts_base)
        torch.cuda.synchronize()
        assert kernels.launches["exact_segment"] == before + 1
        assert torch.equal(kern[0], plain[0]), "table"
        assert torch.equal(kern[2], plain[2]), "carry"
        seen.append(k3.carry_to_dict(kern[2], kern[1].shape[0]))
    return seen


def test_scan_segment_lengths_0_and_1_match_plain(card):
    case = scan_cases.make_case(41, 256, "mixed", A=4096, rows=np.arange(0, 4096, 97))
    segs = [[], [0], [], [1], [2], list(range(3, case[3]))]
    _segments_check(card, case, segs)


def test_scan_segment_chain_across_segments_matches_plain(card):
    """A linked chain that starts in one segment and fails in the next:
    chain_start comes from the carry, and the rollback reaches back
    into the first segment."""
    case = scan_cases.make_case(43, 2048, "linked", A=4096, rows=np.arange(0, 4096, 37))
    n, flags = case[3], case[1]["flags"]
    crossed = 0
    for s in [s for s in range(2, n - 2) if flags[s - 1] & 1 and flags[s - 2] & 1][:12]:
        first, second = _segments_check(card, case, [range(s), range(s, n)])
        start = first["chain_start"]
        if start >= 0 and (second["results"][start:s] == 1).all():
            crossed += 1
    assert crossed > 0


def _with_inbatch_pendings(case, pairs, seed):
    """`pairs` pendings created in the batch, each posted or voided by a
    later event that names it by its id group alone (inherited amount,
    slots, ledger and code), on fresh id groups."""
    table, ev, dstat, n, ts_base = case
    rng = np.random.default_rng(seed)
    B = ev["flags"].shape[0]
    picks = np.sort(rng.choice(n, 2 * pairs, replace=False)).reshape(pairs, 2)
    fresh = iter(range(B // 2, B))
    for j, k in picks:
        for x in (j, k):
            ev["id_group"][x] = next(fresh)
            for f in ("static_result", "ts_nonzero", "e_found", "p_found", "timeout",
                      "dr_flags", "cr_flags"):
                ev[f][x] = 0
        ev["flags"][j] = 2
        ev["flags"][k] = 4 if rng.random() < 0.5 else 8
        ev["amount_lo"][j], ev["amount_hi"][j] = 5, 0
        ev["cr_slot"][j] = ev["dr_slot"][j] + 37
        ev["p_group"][k] = ev["id_group"][j]
        ev["p_tgt"][k] = -1
        ev["amount_lo"][k] = ev["amount_hi"][k] = ev["ledger"][k] = ev["code"][k] = 0
        ev["dr_id_zero"][k] = ev["cr_id_zero"][k] = True
    return table, ev, dstat, n, ts_base


def test_scan_segment_post_void_matches_plain(card):
    """Posts and voids against pendings created in the batch and against
    durable ones, walked in segments of 64."""
    case = scan_cases.make_case(47, 2048, "post_void", A=4096, rows=np.arange(1, 4096 - 37, 37))
    case = _with_inbatch_pendings(case, 60, 47)
    n = case[3]
    last = _segments_check(card, case, [range(k, min(k + 64, n)) for k in range(0, n, 64)])[-1]
    kinds = set(last["u_status_kind"][:n].tolist())
    assert {1, 2} <= kinds, kinds


def test_scan_segment_padding_rows_match_plain(card):
    """Indices outside [0, B) in a segment are padding: skipped."""
    case = scan_cases.make_case(53, 256, "mixed", A=4096, rows=np.arange(0, 4096, 97))
    n, B = case[3], 256
    rows = []
    for k in range(n):
        rows.append(k)
        if k % 7 == 0:
            rows += [-1, B, B + 5, (1 << 31) - 1][k % 4:]
    _segments_check(card, case, [rows[:40], [-3, B], rows[40:]])


@pytest.mark.parametrize("masked", [False, True])
def test_wave_step_full_width_matches_plain(card, masked):
    """K7 over one 8190-lane wave on a 2^17-row table, with and without a
    commit mask (any subset of a wave is a wave)."""
    table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(11 + masked, 8192, 1 << 17)
    kern, plain = _wave_inputs(card, table, ev, dstat)
    idx = torch.from_numpy(np.asarray(plan.segments[0][1], np.int32)).to(card)
    mask = None
    if masked:
        rng = np.random.default_rng(3)
        mask = torch.from_numpy((rng.random(len(idx)) < 0.7).astype(np.uint8)).to(card)
    waves.wave_step(*kern, idx, n, ts_base, mask=mask)
    waves.wave_step_plain(*plain, idx, n, ts_base, mask)
    torch.cuda.synchronize()
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[2], plain[2])


def _one_wave(card, K, seed, hub=False, mask_p=None, shape=None):
    """K7 over a wide_case wave of K lanes on a 2^17-row table against
    the plain version; `hub`: every 5th lane that posts or pends
    credits one account, so lanes in every block write one row."""
    table, ev, dstat, n, ts_base, plan = wave_cases.wide_case(seed, 8192, 1 << 17, n=K)
    if hub:
        writers = (np.arange(8192) % 5 == 0) & (np.arange(8192) < n) & (ev["p_found"] == 0)
        writers &= (ev["flags"] & 0xC) == 0
        ev["cr_slot"][writers] = 131_000
        assert writers.sum() * 8 > n  # a writer in about every 8 lanes
    kern, plain = _wave_inputs(card, table, ev, dstat)
    idx = torch.from_numpy(np.asarray(plan.segments[0][1], np.int32)).to(card)
    assert idx.numel() == K
    mask = None
    if mask_p is not None:
        rng = np.random.default_rng(seed)
        mask = torch.from_numpy((rng.random(K) < mask_p).astype(np.uint8)).to(card)
    before = kernels.launches["wave_step"]
    if shape is None:
        waves.wave_step(*kern, idx, n, ts_base, mask=mask)
        assert kernels.launches["wave_step"] == before + 1
    else:
        kernels.wave_step(kern[0], kern[1], idx, mask, n, ts_base, kern[2], shape=shape)
    waves.wave_step_plain(*plain, idx, n, ts_base, mask)
    torch.cuda.synchronize()
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[2], plain[2])


@pytest.mark.parametrize("K", [1, 32, 511, 512, 513, 4096, 8190])
def test_wave_step_lane_counts_match_plain(card, K):
    """K7 at one block (K <= 8), clusters of 2-16 blocks and the
    cooperative grid above 16 x 64 lanes: one launch a wave."""
    blocks, threads, mode, lanes = kernels.wave_step_geometry(K)
    assert blocks * lanes >= K and lanes <= threads and (mode == 0) == (blocks == 1)
    assert (mode == 2) == (K > 16 * 64)
    _one_wave(card, K, 900 + K % 97)


@pytest.mark.parametrize("K", [513, 8190])
def test_wave_step_hub_row_matches_plain(card, K):
    """One balance row written by lanes in every block of the wave."""
    _one_wave(card, K, 910, hub=True)


@pytest.mark.parametrize("K", [33, 4096])
def test_wave_step_commit_mask_matches_plain(card, K):
    _one_wave(card, K, 920, mask_p=0.6)


@pytest.mark.parametrize("shape", [(256, False), (64, False), (8, False), (256, True),
                                   (128, True), (64, True), (32, True)])
def test_wave_step_shapes_match_plain(card, shape):
    """The launch shapes the probes compare: 16-block clusters of 256,
    64 and 8 lanes a block and cooperative grids at K = 4096, grids at
    8190."""
    lanes, grid = shape
    K = 4096 if not grid or lanes == 256 else 8190
    if not grid:
        K = min(K, 16 * lanes)
    _one_wave(card, K, 930, hub=True, shape=shape)


@pytest.mark.parametrize("cls", ["mixed", "post_void", "balancing", "linked"])
def test_speculative_step_matches_plain(card, cls):
    """K9 on a whole 8190-event batch, then K7 with commit mask = not
    conflicted, against the plain versions; then the residue plan."""
    table, ev, dstat, n, ts_base = scan_cases.make_case(
        77 + scan_cases.CLASSES.index(cls), 8192, cls, A=1 << 17,
        rows=np.arange(0, 1 << 17, 13), n=8190)
    serial = np.zeros(8192, bool)
    out = []
    for plain in (False, True):
        t = torch.from_numpy(table.view(np.int64).copy()).to(card)
        carry, confl = waves.run_speculative_engine(
            t, ev, dstat, serial, n, ts_base, scratch=waves.WaveScratch(card), plain=plain)
        torch.cuda.synchronize()
        out.append((t, carry.words[:k3.scratch_words(8192)].clone(), confl))
    assert torch.equal(out[0][2], out[1][2])
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert 0 < int(out[0][2].sum()) < n


def _k9_vs_plain(card, ev, n, serial, A, scratch, idx=None):
    """K9 on the card through `scratch` against the plain version (on the
    CPU) of the same lanes: their flags, one launch, a fresh output."""
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64))
    idx = torch.arange(n, dtype=torch.int32) if idx is None else idx
    ser = torch.from_numpy(np.asarray(serial, np.uint8)[: idx.numel()].copy())
    want = waves.spec_conflicts(pk, idx, ser, n, A)
    before = kernels.launches["spec_conflicts"]
    got = waves.spec_conflicts(pk.to(card), idx.to(card), ser.to(card), n, A, scratch=scratch)
    torch.cuda.synchronize()
    assert kernels.launches["spec_conflicts"] == before + 1
    assert torch.equal(got.cpu(), want)
    return want


def test_spec_conflicts_back_to_back_on_one_scratch(card):
    """Fourteen batches of seven classes over one row pool, back to back
    through one WaveScratch: each call's entries must lose to the next
    call's and read as absent, so every call equals the plain version."""
    scratch = waves.WaveScratch(card)
    rows = np.arange(0, 1 << 17, 13)
    for ev, n, serial in wave_cases.spec_stream(21, 14, 8192, 1 << 17, rows=rows):
        want = _k9_vs_plain(card, ev, n, serial, 1 << 17, scratch)
        assert 0 < int(want.sum()) < n


def test_spec_conflicts_across_the_tag_wrap(card):
    """Calls on one scratch from three calls below the end of a tag
    cycle: the call that takes tag 1 fills every entry back at rest
    first (the cycle's last tag's entries would win every minimum); the
    calls on either side equal the plain version."""
    cycle = kernels.spec_conflicts_cycle()
    scratch = waves.WaveScratch(card, spec_calls=cycle - 3)
    rows = np.arange(0, 1 << 16, 7)
    counts = []
    for ev, n, serial in wave_cases.spec_stream(22, 6, 8192, 1 << 16, rows=rows):
        counts.append(scratch._spec.calls % cycle + 1)  # the call's tag
        _k9_vs_plain(card, ev, n, serial, 1 << 16, scratch)
    assert counts == [cycle - 2, cycle - 1, cycle, 1, 2, 3]


def test_spec_conflicts_wrap_survives_an_empty_and_a_failed_call(card):
    """The call after the cycle's last tag is empty, then fails the
    library's checks (n above 8192): neither counts, so the next call
    still takes tag 1 and fills; it equals the plain version."""
    cycle = kernels.spec_conflicts_cycle()
    scratch = waves.WaveScratch(card, spec_calls=cycle - 1)
    stream = wave_cases.spec_stream(25, 2, 8192, 1 << 16, rows=np.arange(0, 1 << 16, 5))
    ev, n, serial = stream[0]
    _k9_vs_plain(card, ev, n, serial, 1 << 16, scratch)
    pk = torch.from_numpy(k3.pack_events(ev).view(np.int64)).to(card)
    before = kernels.launches["spec_conflicts"]
    empty = waves.spec_conflicts(pk, torch.zeros(0, dtype=torch.int32, device=card), None, n,
                                 1 << 16, scratch=scratch)
    assert empty.shape == (0,) and kernels.launches["spec_conflicts"] == before
    with pytest.raises(RuntimeError):
        waves.spec_conflicts(pk, torch.arange(n, dtype=torch.int32, device=card), None, 9000,
                             1 << 16, scratch=scratch)
    assert scratch._spec.calls == cycle
    ev, n, serial = stream[1]
    _k9_vs_plain(card, ev, n, serial, 1 << 16, scratch)


def test_spec_conflicts_empty_call_at_the_wrap_still_fills(card):
    """The library itself: a call of no lanes that takes tag 1 (or finds
    its arrays new) still puts every entry at rest."""
    cycle = kernels.spec_conflicts_cycle()
    pk = torch.zeros((64, 52), dtype=torch.int64, device=card)
    idx = torch.zeros(0, dtype=torch.int32, device=card)
    out = torch.empty(0, dtype=torch.uint8, device=card)
    for calls, fresh in ((cycle, False), (5, True)):
        arrays = [torch.zeros(m, dtype=torch.int32, device=card) for m in (64, 64, 300, 300)]
        kernels.spec_conflicts(pk, idx, None, 10, 300, *arrays, calls, fresh, out)
        torch.cuda.synchronize()
        assert all(bool((a == -1).all()) for a in arrays)


@pytest.mark.parametrize("K", [1, 4097, 8190, 40_000])
def test_spec_conflicts_lane_counts_match_plain(card, K):
    """K lanes of an 8190-event batch in a random order, duplicates and
    padding lanes (indices -1 and B) among them; 40,000 lanes exceed the
    cooperative grid's threads, so lanes loop."""
    ev, n, serial = wave_cases.spec_stream(23 + K, 1, 8192, 1 << 17,
                                           rows=np.arange(0, 1 << 17, 11))[0]
    rng = np.random.default_rng(K)
    idx = rng.permutation(8192)[:K] if K <= 8192 else rng.integers(0, 8192, K)
    if K > 2:
        idx[rng.choice(K, 2, replace=False)] = [-1, 8192]
    ser = rng.random(K) < 0.05
    _k9_vs_plain(card, ev, n, ser, 1 << 17, waves.WaveScratch(card),
                 idx=torch.from_numpy(idx.astype(np.int32)))


def test_spec_conflicts_distinct_slots_match_plain(card):
    """Every slot, group and target distinct on a 2^20-row table: only
    the serial mask blocks."""
    ev, n, serial = wave_cases.distinct_spec_case(24, 8192, 1 << 20, n=8190)
    want = _k9_vs_plain(card, ev, n, serial, 1 << 20, waves.WaveScratch(card))
    assert torch.equal(want, torch.from_numpy(serial[:n].astype(np.uint8)))


def test_offkernel_on_card_matches_plain(card):
    """The offkernel stream on the device engine: speculative and chain-
    wave records through K7, K8, K9 on the card against the same run on
    the plain versions (on the card)."""
    setup, timed, sizing = workload.gen_offkernel(6 * 2000, n_accounts=20_001, batch=2000)
    ops = setup + timed
    out, launched = [], []
    for plain in (False, True):
        kernels.reset_launches()
        sm = TorchStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                               engine="device", plain=plain)
        h = SingleNodeHarness(sm)
        futs = [h.submit_async(op, body) for op, body in ops]
        replies = [f.result() for f in futs]
        sm._dev.drain()
        sm.verify_device_mirror()
        launched.append(dict(kernels.launches))
        out.append((replies, sm.state_root(), sm.stat_dev_wave_batches,
                    {k: v for k, v in sm._dev.spec_stats.items() if not k.endswith("_s")}))
    assert out[0] == out[1]
    assert out[0][2] > 0 and out[0][3]["attempts"] > 0
    for name in ("wave_step", "chain_wave", "spec_conflicts", "exact_init", "exact_finalize"):
        assert launched[0][name] > 0 and launched[1][name] == 0


@pytest.mark.parametrize("width,dtype", [(8, torch.int64), (2, torch.int32)])
def test_tier_set_rows_kernel_matches_plain(card, width, dtype):
    """K10: distinct admitted slots plus distinct out-of-range padding."""
    rng = np.random.default_rng(width)
    H, k = 5000, 700
    info = torch.iinfo(dtype)
    table = torch.from_numpy(rng.integers(info.min, info.max, (H, width))).to(dtype)
    src = torch.from_numpy(rng.integers(info.min, info.max, (k + 9, width))).to(dtype)
    idx = torch.from_numpy(np.concatenate([rng.choice(H, k, replace=False),
                                           H + np.arange(9)]).astype(np.int64))
    want = dk.tier_set_rows_plain(table.clone(), idx, src)
    before = kernels.launches["tier_set_rows"]
    got = dk.tier_set_rows(table.to(card), idx.to(card), src.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["tier_set_rows"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_commit_admit_kernel_matches_plain(card):
    rng = np.random.default_rng(12)
    H, k = 6000, 1500
    row_hash = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (H, 2)))
    digest = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, 2))
    slots = torch.from_numpy(cm.pad_slots(rng.choice(H, k, replace=False).astype(np.int64)))
    new_lo, new_hi = (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, len(slots)))
                      for _ in range(2))
    rh_p, dg_p = cm.admit_plain(row_hash.clone(), digest.clone(), slots, new_lo, new_hi)
    before = kernels.launches["commit_admit"]
    rh_k, dg_k = cm.admit(row_hash.to(card), digest.to(card), slots.to(card), new_lo.to(card),
                          new_hi.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["commit_admit"] == before + 1
    assert torch.equal(rh_k.cpu(), rh_p) and torch.equal(dg_k.cpu(), dg_p)


def _admit_on_card(card, row_hash, digest, slots, new_lo, new_hi, offset=0):
    """K2 admit on the card (row_hash in a view `offset` words into its
    buffer) and its plain version on the CPU, from u64 numpy inputs:
    ((row_hash, digest) of the kernel, of the plain version)."""
    rh, dg, lo, hi = (from_u64(a) for a in (row_hash, digest, new_lo, new_hi))
    sl = torch.from_numpy(np.asarray(slots, np.int64))
    want = cm.admit_plain(rh.clone(), dg.clone(), sl, lo, hi)
    H = rh.shape[0]
    buf = torch.empty(H * 2 + offset, dtype=torch.int64, device=card)
    rh_k = buf[offset:].view(H, 2)
    rh_k.copy_(rh)
    before = kernels.launches["commit_admit"]
    got = cm.admit(rh_k, dg.to(card), sl.to(card), lo.to(card), hi.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["commit_admit"] == before + (len(sl) > 0)
    return tuple(t.cpu() for t in got), want


@pytest.mark.parametrize("H", [13, 1_000_003])
@pytest.mark.parametrize("case", sorted(commit_cases.PAST_CASES))
def test_commit_admit_past_the_table_matches_plain(card, case, H):
    """Slots past the table: old is row H-1 before the call, nothing is
    stored, also when a lane of the call owns row H-1."""
    inputs = commit_cases.admit_case(commit_cases.past_slots(case, H), H, H % 97)
    (rh_k, dg_k), (rh_p, dg_p) = _admit_on_card(card, *inputs)
    assert torch.equal(rh_k, rh_p) and torch.equal(dg_k, dg_p)


@pytest.mark.parametrize("k", [80, 130, 16_380, 16_384])
@pytest.mark.parametrize("offset", [0, 1])
def test_commit_admit_main_path_shapes_match_plain(card, k, offset):
    """K2 admit at a timed admission's 80-130 slots and a warm-up's
    16,380 (padded with -1 to 16,384) and at 16,384 slots of a 2^20-row
    table, on a 16-byte-aligned row_hash and one 8 bytes off."""
    rng = np.random.default_rng(k + offset)
    A = 1 << 20
    slots = rng.choice(A, k, replace=False).astype(np.int64)
    if k == 16_380:
        slots = cm.pad_slots(slots)
    inputs = commit_cases.admit_case(slots, A, k)
    (rh_k, dg_k), (rh_p, dg_p) = _admit_on_card(card, *inputs, offset=offset)
    assert torch.equal(rh_k, rh_p) and torch.equal(dg_k, dg_p)


@pytest.mark.parametrize("owner_first", [True, False])
def test_commit_admit_past_the_table_across_blocks(card, owner_first):
    """16,384 slots over many blocks: 2,000 of them past the table, one
    owning row H-1, at the front or the back of the call."""
    rng = np.random.default_rng(3 + owner_first)
    H = 300_001
    live = rng.choice(H - 1, 14_383, replace=False)
    past = H + rng.choice(10 * H, 2_000, replace=False)
    slots = rng.permutation(np.concatenate([live, past])).astype(np.int64)
    slots = np.concatenate([[H - 1], slots] if owner_first else [slots, [H - 1]])
    inputs = commit_cases.admit_case(slots, H, 5)
    for offset in (0, 1):
        (rh_k, dg_k), (rh_p, dg_p) = _admit_on_card(card, *inputs, offset=offset)
        assert torch.equal(rh_k, rh_p) and torch.equal(dg_k, dg_p)


def _update_on_card(card, bal, meta, row_hash, digest, slots, rows):
    b, rh, dg, r = (from_u64(a) for a in (bal, row_hash, digest, rows))
    m = torch.from_numpy(np.ascontiguousarray(meta).view(np.int32))
    sl = torch.from_numpy(np.asarray(slots, np.int64))
    want = cm.update_plain(b, m, rh.clone(), dg.clone(), sl, r)
    got = cm.update(b.to(card), m.to(card), rh.to(card), dg.to(card), sl.to(card), r.to(card))
    torch.cuda.synchronize()
    return tuple(t.cpu() for t in got), want


@pytest.mark.parametrize("A", [13, 100_003])
@pytest.mark.parametrize("case", sorted(commit_cases.PAST_CASES))
def test_commit_update_past_the_table_matches_plain(card, case, A):
    """K2 update at slots past the table: row A-1's columns hashed under
    the lane's own id against row A-1's old hash, nothing stored past
    the table, also when a lane of the call owns row A-1."""
    inputs = commit_cases.update_case(commit_cases.past_slots(case, A), A, A % 89)
    (rh_k, dg_k), (rh_p, dg_p) = _update_on_card(card, *inputs)
    assert torch.equal(rh_k, rh_p) and torch.equal(dg_k, dg_p)


def test_commit_update_past_the_table_across_blocks(card):
    """A padded window of touched slots over many blocks with 1,000 past
    the table and the owner of row A-1 among them; a sentinel after the
    table's hashes stays as it was (no store past the table)."""
    rng = np.random.default_rng(17)
    A = 200_003
    slots = np.concatenate([rng.choice(A - 1, 20_000, replace=False), [A - 1],
                            A + rng.choice(A, 1_000, replace=False)])
    slots = cm.pad_slots(rng.permutation(slots).astype(np.int64))
    bal, meta, row_hash, digest, _, rows = commit_cases.update_case(slots, A, 4)
    (rh_k, dg_k), (rh_p, dg_p) = _update_on_card(card, bal, meta, row_hash, digest, slots, rows)
    assert torch.equal(rh_k, rh_p) and torch.equal(dg_k, dg_p)
    buf = torch.full((A * 2 + 2 * 1024,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64, device=card)
    rh = buf[: A * 2].view(A, 2)
    rh.copy_(from_u64(row_hash))
    m = torch.from_numpy(np.ascontiguousarray(meta).view(np.int32)).to(card)
    cm.update(from_u64(bal).to(card), m, rh, from_u64(digest).to(card),
              torch.from_numpy(slots).to(card), from_u64(rows).to(card))
    torch.cuda.synchronize()
    assert torch.equal(rh.cpu(), rh_p)
    assert (buf[A * 2:] == 0x5A5A5A5A5A5A5A5A).all()


@pytest.mark.parametrize("rows,cols,dtype", [(1, 8, torch.int64), (100_003, 8, torch.int64),
                                             (70_001, 2, torch.int32), (513, 32, torch.int64),
                                             (999, 1, torch.int32)])
def test_checksum_kernel_matches_plain(card, rows, cols, dtype):
    """K11, meta words >= 2^31 included (zero-extended)."""
    rng = np.random.default_rng(rows)
    info = torch.iinfo(dtype)
    table = torch.from_numpy(rng.integers(info.min, info.max, (rows, cols))).to(dtype)
    before = kernels.launches["checksum"]
    got = dk.checksum(table.to(card))
    torch.cuda.synchronize()
    assert kernels.launches["checksum"] == before + 1
    assert torch.equal(got.cpu(), dk.checksum_plain(table))


@pytest.mark.parametrize("engine", ["device", "host"])
def test_tiered_state_machine_on_card_matches_plain(card, engine, monkeypatch):
    """TB_HOT_CAPACITY below the accounts: the tiering stream on the card
    through K10, K2 admit and K11 against the plain-version run and the
    all-resident run."""
    n_acct, head = 20_000, 1500
    ops = [(op, body) for op, body in workload._create_accounts(n_acct)]
    ops += workload.gen_tiering(12, 2000, n_acct, head, 0.008, workload.TID0)
    out = []
    for hot, plain in (("2048", False), ("2048", True), (None, False)):
        if hot is None:
            monkeypatch.delenv("TB_HOT_CAPACITY", raising=False)
        else:
            monkeypatch.setenv("TB_HOT_CAPACITY", hot)
        kernels.reset_launches()
        sm = TorchStateMachine(account_capacity=1 << 15, transfer_capacity=1 << 16,
                               engine=engine, plain=plain)
        h = SingleNodeHarness(sm)
        replies = [h.submit(op, body) for op, body in ops]
        launched = dict(kernels.launches)
        sm.verify_device_mirror()
        out.append((replies, sm.state_root()))
        if hot is not None and not plain:
            assert launched["tier_set_rows"] > 0
            assert sm._dev.hot.misses > 0
            if engine == "device":
                assert launched["commit_admit"] > 0
    assert out[0] == out[1] == out[2]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_tiered_exact_streams_on_card_match_cpu(card, engine, monkeypatch):
    """Tiered engines on streams that take the exact path: the bench's
    linked and waves_host shapes under a 256-row hot set, on the card
    (K3, K7/K8 waves over the logical image, the tiered write-back and
    digest rebuild, K5 on hot slots) against the CPU run."""
    monkeypatch.setenv("TB_HOT_CAPACITY", "256")
    streams = (workload.gen_linked(2000, batch=500),
               workload.gen_waves_host(1000, n_accounts=4000, n_limited=100, batch=200))
    for setup, timed, sizing in streams:
        ops = setup + timed
        out = []
        for device in (None, "cpu"):
            sm = TorchStateMachine(account_capacity=sizing[0], transfer_capacity=sizing[1],
                                   device=device, engine=engine)
            assert sm._dev.hot is not None
            h = SingleNodeHarness(sm)
            futs = [h.submit_async(op, body) for op, body in ops]
            replies = [f.result() for f in futs]
            sm.verify_device_mirror()
            t = sm._dev.hot
            out.append((replies, sm.state_root(), sm.stat_exact_events, sm.stat_linked_batches,
                        sm.stat_tier_punts, t.hits, t.misses, t.evicts))
        assert out[0] == out[1]
        assert out[0][2] > 0 or out[0][3] > 0


@pytest.mark.parametrize("shard", [0, 5])
def test_shard_kernels_match_plain(card, shard):
    """K12 (with and without a mask), K13 admit / apply and K14 gather /
    scatter against their plain versions on the card, bit for bit."""
    rows, n_shard = 1 << 12, 8
    local = rows // n_shard
    row0 = shard * local
    balances, *events = shard_cases.apply_events(90 + shard, rows, 8190, near_ceiling=64)
    mesh = sharded.make_mesh([card], dp=1)
    ev = [x[0] for x in sharded.shard_events(mesh, *events)]
    mask = torch.from_numpy(np.random.default_rng(shard).random(8190) < 0.5).to(card)
    for m in (None, mask):
        got = sharded.accumulate(local, row0, *ev, mask=m)
        want = sharded._accumulate(local, row0, *ev, mask=m)
        assert torch.equal(got, want)
    acc = sharded.accumulate(local, row0, *ev)
    table = sharded.shard_balances(sharded.make_row_mesh([card] * n_shard), balances)[shard]
    got = sharded.admit(table, acc, row0, ev[0], ev[1])
    want = sharded.admit_plain(table, acc, row0, ev[0], ev[1])
    assert torch.equal(got, want) and bool(want.any())
    t_k, t_p = table.clone(), table.clone()
    sharded.apply(t_k, acc)
    sharded.apply_plain(t_p, acc)
    assert torch.equal(t_k, t_p)
    slots = torch.from_numpy(np.random.default_rng(7).choice(rows, 1000, replace=False)).to(card)
    assert torch.equal(sharded.gather_part(t_k, slots, shard),
                       sharded.gather_part_plain(t_k, slots, shard))
    new = torch.randint(-(1 << 62), 1 << 62, (1000, 8), dtype=torch.int64, device=card)
    sharded.scatter_part(t_k, slots, new, shard)
    sharded.scatter_part_plain(t_p, slots, new, shard)
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("owned", ["none", "all", "ceiling"])
def test_shard_admit_ownership_edges(card, owned):
    """K13 admit on an 8190-event slice where no slot is this shard's,
    where every slot is, and where every side of every event names a
    row within 2^40 of 2^128 in some column (most reject)."""
    rows, n_shard, shard, E = 1 << 14, 4, 2, 8190
    local = rows // n_shard
    row0 = shard * local
    rng = np.random.default_rng(11)
    balances, dr, cr, lo, hi, pend = shard_cases.apply_events(12, rows, E, near_ceiling=0,
                                                              out_of_range=0)
    if owned == "none":
        dr = rng.integers(0, row0, E)
        cr = rng.integers(row0 + local, rows, E)
    else:
        dr = row0 + rng.integers(0, local, E)
        cr = row0 + (dr - row0 + 1 + rng.integers(0, local - 1, E)) % local
    if owned == "ceiling":
        col = rng.integers(0, 4, rows)
        balances[np.arange(rows), 2 * col] = np.uint64((1 << 64) - (1 << 40))
        balances[np.arange(rows), 2 * col + 1] = np.uint64((1 << 64) - 1)
    mesh = sharded.make_mesh([card], dp=1)
    ev = [x[0] for x in sharded.shard_events(mesh, dr.astype(np.int32), cr.astype(np.int32),
                                             lo, hi, pend)]
    acc = sharded.accumulate(local, row0, *ev)
    table = sharded.shard_balances(sharded.make_row_mesh([card] * n_shard), balances)[shard]
    got = sharded.admit(table, acc, row0, ev[0], ev[1])
    want = sharded.admit_plain(table, acc, row0, ev[0], ev[1])
    assert torch.equal(got, want)
    assert bool(want.any()) == (owned == "ceiling")
    unaligned = torch.empty(acc.numel() + 1, dtype=torch.int64, device=card)[1:].view_as(acc)
    unaligned.copy_(acc)
    assert torch.equal(sharded.admit(table, unaligned, row0, ev[0], ev[1]), want)


def test_sharded_paths_on_card_match_plain_and_dense(card):
    """build_apply_step on a 2 x 2 mesh of one card against the oracle
    and the plain run; _execute_plan_sharded on a 4-shard row mesh
    against the dense executor and the plain run."""
    rows = 1 << 14
    balances, *events = shard_cases.apply_events(5, rows, 8190, near_ceiling=32)
    mesh = sharded.make_mesh([card] * 4, dp=2)
    outs = []
    for plain in (False, True):
        step = sharded.build_apply_step(mesh, rows, plain=plain)
        tables, admitted = step(sharded.shard_balances(mesh, balances),
                                *sharded.shard_events(mesh, *events))
        outs.append((shard_cases.join_tables(tables), admitted.cpu().numpy()))
    want, want_admitted = shard_cases.apply_oracle(balances, *events)
    for got, got_admitted in outs:
        np.testing.assert_array_equal(got_admitted, want_admitted)
        np.testing.assert_array_equal(got, want)

    row_mesh = sharded.make_row_mesh([card] * 4)
    for name, (table, ev, dstat, n, ts_base, plan) in shard_cases.shardable_cases(
            3, 8192, rows):
        fix = shard_cases.hist_fix(plan, n, 8192)
        dense = torch.from_numpy(table.view(np.int64).copy()).to(card)
        want = waves.run_create_transfers_waves(dense, ev, dstat, n, ts_base, plan, fix)
        for plain in (False, True):
            tables, packed = waves._execute_plan_sharded(
                sharded.shard_balances(row_mesh, table), ev, dstat, n, ts_base, plan, fix,
                row_mesh, plain=plain)
            assert torch.equal(packed, want), name
            np.testing.assert_array_equal(shard_cases.join_tables(tables),
                                          dense.cpu().numpy().view(np.uint64))


@pytest.mark.parametrize("width", [1, 2, 8])
def test_shard_rows_kernel_at_width_matches_plain(card, width):
    """K14 gather and scatter at the row layer's widths (meta W = 1, row
    hashes W = 2, balances W = 8) against the plain versions, with -1
    and out-of-table slots."""
    rng = np.random.default_rng(width)
    local, shard = 1 << 10, 3
    t = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (local, width))).to(card)
    slots = torch.from_numpy(np.concatenate([rng.choice(8 * local, 500, replace=False),
                                             [-1, 8 * local]])).to(card)
    assert torch.equal(sharded.gather_part(t, slots, shard),
                       sharded.gather_part_plain(t, slots, shard))
    new = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (502, width))).to(card)
    t_k, t_p = t.clone(), t.clone()
    sharded.scatter_part(t_k, slots, new, shard)
    sharded.scatter_part_plain(t_p, slots, new, shard)
    assert torch.equal(t_k, t_p)


def _on_side_stream(launch):
    """Run `launch()` on a fresh stream while the default stream is kept
    busy, and copy its result to the host on that stream alone: a kernel
    launched on any other than the current stream would still sit behind
    the default stream's spin when the copy reads the table."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    torch.cuda._sleep(1 << 28)  # ~0.15 s of spinning on the default stream
    with torch.cuda.stream(side):
        out = launch()
        host = out.cpu()
        side.synchronize()
    torch.cuda.synchronize()
    return host


def _k10_inputs(rng, H, k, pad, width, dtype):
    info = torch.iinfo(dtype)
    table = torch.from_numpy(rng.integers(info.min, info.max, (H, width))).to(dtype)
    src = torch.from_numpy(rng.integers(info.min, info.max, (k + pad, width))).to(dtype)
    idx = torch.from_numpy(np.concatenate([rng.choice(H, k, replace=False),
                                           H + np.arange(pad)]).astype(np.int64))
    return table, idx, src


@pytest.mark.parametrize("side_stream", [False, True])
@pytest.mark.parametrize("k,pad", [(0, 0), (1, 0), (0, 64), (128, 64), (16_384, 64)])
@pytest.mark.parametrize("width,dtype", [(8, torch.int64), (2, torch.int32)])
def test_tier_set_rows_edges_match_plain(card, width, dtype, k, pad, side_stream):
    """K10 on a 2^15-row balance (8 int64) or meta (2 int32) table: no
    rows, one row, padding only, 128 and 16,384 rows with 64 distinct
    padding indices past H; on the current stream, and on a side stream
    while the default one is busy.  A call with no rows launches
    nothing."""
    rng = np.random.default_rng(k + pad + width)
    table, idx, src = _k10_inputs(rng, 1 << 15, k, pad, width, dtype)
    want = dk.tier_set_rows_plain(table.clone(), idx, src)
    t, i, sr = table.to(card), idx.to(card), src.to(card)
    before = kernels.launches["tier_set_rows"]
    if side_stream:
        got = _on_side_stream(lambda: dk.tier_set_rows(t, i, sr))
    else:
        got = dk.tier_set_rows(t, i, sr).cpu()
    assert kernels.launches["tier_set_rows"] == before + (1 if k + pad else 0)
    assert torch.equal(got, want)


def _k14_scatter_inputs(rng, width, local, shard, shards=4):
    """A shard table and distinct slots: owned rows, rows of the other
    shards, -1 and slots past every shard, shuffled."""
    A = local * shards
    table = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (local, width)))
    own = rng.choice(local, local // 3, replace=False) + shard * local
    other = rng.choice(np.setdiff1d(np.arange(A), shard * local + np.arange(local)), 700,
                       replace=False)
    slots = rng.permutation(np.concatenate([own, other, [-1, A, A + 1, 1 << 40]]))
    rows = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (len(slots), width)))
    return table, torch.from_numpy(slots.astype(np.int64)), rows


@pytest.mark.parametrize("side_stream", [False, True])
@pytest.mark.parametrize("width", [1, 2, 8])
def test_shard_scatter_drops_what_it_does_not_own(card, width, side_stream):
    """K14 scatter at W = 1, 2 and 8 onto shard 2 of 4: the owned rows
    written, slots -1, past every shard and owned by another shard
    dropped; on the current stream, and on a side stream while the
    default one is busy."""
    rng = np.random.default_rng(40 + width)
    local, shard = 4096, 2
    table, slots, rows = _k14_scatter_inputs(rng, width, local, shard)
    want = table.clone()
    sharded.scatter_part_plain(want, slots, rows, shard)
    t, sl, r = table.to(card), slots.to(card), rows.to(card)
    before = kernels.launches["shard_scatter"]

    def launch():
        sharded.scatter_part(t, sl, r, shard)
        return t

    got = _on_side_stream(launch) if side_stream else launch().cpu()
    assert kernels.launches["shard_scatter"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("K", [1, 1001, 300_001])
@pytest.mark.parametrize("width", [1, 2, 8])
def test_shard_gather_edges_match_plain(card, width, K, aligned):
    """K14 gather at W = 1, 2 and 8 from shard 2 of 4 (row0 != 0): one
    slot, an odd K, and more pieces than the grid has threads (each
    thread then keeps several in flight); slots owned, owned by other
    shards, -1 and past every shard; a table and an output one word off
    16-byte alignment (8-byte words); one launch a call."""
    rng = np.random.default_rng(width * 7 + K + aligned)
    local, shard, shards = 1 << 16, 2, 4
    A = local * shards
    table = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (local, width)))
    edges = np.array([shard * local + 5, -1, A, A + 1, 1 << 40, shard * local,
                      (shard + 1) * local - 1, shard * local - 1, (shard + 1) * local])
    slots = rng.integers(0, A, K)
    slots[:min(K, len(edges))] = edges[:K]
    slots = torch.from_numpy(rng.permutation(slots))
    want = sharded.gather_part_plain(table, slots, shard)

    def placed(t):  # t's values at an aligned pointer, or one word past one
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = flat[int(not aligned):][:t.numel()].view(t.shape)
        view.copy_(t.to(card))
        assert (view.data_ptr() % 16 == 0) == aligned
        return view

    t, sl = placed(table), slots.to(card)
    before = kernels.launches["shard_gather"]
    got = sharded.gather_part(t, sl, shard)
    assert kernels.launches["shard_gather"] == before + 1
    assert torch.equal(got.cpu(), want)
    out = placed(torch.full((K, width), 7, dtype=torch.int64))
    kernels.shard_gather(t, shard * local, sl, out)
    assert torch.equal(out.cpu(), want)


def test_row_kernels_on_unaligned_views_match_plain(card):
    """K10 and K14 scatter on tables and sources that are views at an
    offset of one word (8 bytes; 4 for int32 meta): the kernels move
    them with narrower pieces, bit for bit as the plain versions."""
    rng = np.random.default_rng(77)

    def shifted(t):  # the same values at a pointer one element past an aligned one
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = flat[1:].view(t.shape)
        view.copy_(t.to(card))
        return view

    for width, dtype in ((8, torch.int64), (2, torch.int32)):
        table, idx, src = _k10_inputs(rng, 1 << 12, 900, 7, width, dtype)
        t, sr = shifted(table), shifted(src)
        assert t.data_ptr() % 16 != 0 and sr.data_ptr() % 16 != 0
        got = dk.tier_set_rows(t, idx.to(card), sr).cpu()
        assert torch.equal(got, dk.tier_set_rows_plain(table.clone(), idx, src))
    for width in (2, 8):
        table, slots, rows = _k14_scatter_inputs(rng, width, 1024, 1)
        want = table.clone()
        sharded.scatter_part_plain(want, slots, rows, 1)
        t = shifted(table)
        sharded.scatter_part(t, slots.to(card), shifted(rows), 1)
        assert torch.equal(t.cpu(), want)


def test_tier_set_rows_refuses_other_rows_on_the_card(card):
    """K10 is compiled for the engine's rows (8 int64 words, 2 int32
    words): any other row raises on the card."""
    table = torch.zeros((64, 4), dtype=torch.int64, device=card)
    idx = torch.arange(3, device=card)
    with pytest.raises(RuntimeError, match="tb_tier_set_rows"):
        dk.tier_set_rows(table, idx, torch.ones((3, 4), dtype=torch.int64, device=card))


def test_row_kernels_launch_on_another_card(card):
    """With cuda:0 current, K10 and K14 scatter on cuda:1 tensors launch
    on cuda:1 (on its current stream) and leave cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(91)
    table, idx, src = _k10_inputs(rng, 1 << 14, 3000, 9, 8, torch.int64)
    part, slots, rows = _k14_scatter_inputs(rng, 8, 2048, 3)
    want_t = dk.tier_set_rows_plain(table.clone(), idx, src)
    want_p = part.clone()
    sharded.scatter_part_plain(want_p, slots, rows, 3)
    torch.cuda.set_device(0)
    t, p = table.to(other), part.to(other)
    dk.tier_set_rows(t, idx.to(other), src.to(other))
    sharded.scatter_part(p, slots.to(other), rows.to(other), 3)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)
    assert torch.equal(t.cpu(), want_t) and torch.equal(p.cpu(), want_p)


@pytest.mark.parametrize("dtype,cols", [(torch.int64, 8), (torch.int32, 2)])
def test_checksum_row0_kernel_matches_plain(card, dtype, cols):
    """K11 with row0 against its plain version; four shards' digests sum
    to the joined table's."""
    rng = np.random.default_rng(cols)
    hi = (1 << 62) if dtype == torch.int64 else (1 << 31) - 1
    table = torch.from_numpy(rng.integers(-hi, hi, (1 << 14, cols))).to(dtype).to(card)
    local = table.shape[0] // 4
    parts = [dk.checksum(table[s * local:(s + 1) * local].contiguous(), s * local)
             for s in range(4)]
    for s, p in enumerate(parts):
        assert torch.equal(p, dk.checksum_plain(table[s * local:(s + 1) * local], s * local))
    assert torch.equal(torch.stack(parts).sum(0), dk.checksum(table))


@pytest.mark.parametrize("engine", ["device", "host"])
def test_sharded_engine_on_card_matches_unsharded(card, engine, monkeypatch):
    """Either engine over 4 shards of the card against the unsharded
    engine on the same stream (gen_simple plus the offkernel shapes):
    replies, root and tables equal; the sharded run went through K14."""
    monkeypatch.setenv("TB_DEV_WAVES", "1")
    setup, timed, sizing = workload.gen_simple(3 * 8190, n_accounts=20_000)
    s2, t2, _ = workload.gen_offkernel(2 * 8190, n_accounts=20_001)
    ops = setup + timed + s2[1:] + t2
    out = []
    for devices in ([card] * 4, [card]):
        kernels.reset_launches()
        sm = TorchStateMachine(account_capacity=1 << 15, transfer_capacity=1 << 17,
                               engine=engine, devices=devices)
        h = SingleNodeHarness(sm)
        replies = [f.result() for f in [h.submit_async(op, body) for op, body in ops]]
        sm.verify_device_mirror()
        table = sharded.dense(sm._dev.read() if engine == "host" else sm._dev.balances)
        out.append((replies, sm.state_root(), table.cpu(), dict(kernels.launches)))
    assert out[0][:2] == out[1][:2] and torch.equal(out[0][2], out[1][2])
    assert out[0][3]["shard_gather"] > 0 and out[1][3]["shard_gather"] == 0


@pytest.mark.parametrize("hot", [None, 1 << 12])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_sharded_engine_across_cards_matches_one_card(card, engine, hot, monkeypatch):
    """Either engine built with no device named: its tables shard over
    every visible card, each shard's kernels launched on its own card's
    stream.  Replies, root and tables equal a dense engine's on cuda:0
    (TB_DEV_WAVES=1 sends the offkernel batches through the sharded wave
    executor; a 4096-row hot set takes K10 and K2 admit per shard)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    monkeypatch.setenv("TB_DEV_WAVES", "1")
    if hot is not None:
        monkeypatch.setenv("TB_HOT_CAPACITY", str(hot))
    setup, timed, _ = workload.gen_simple(3 * 8190, n_accounts=20_000)
    s2, t2, _ = workload.gen_offkernel(2 * 8190, n_accounts=20_001)
    ops = setup + timed + s2[1:] + t2
    out = []
    for devices in (None, [card]):
        sm = TorchStateMachine(account_capacity=1 << 15, transfer_capacity=1 << 17,
                               engine=engine, devices=devices)
        if devices is None:
            shards = sm._dev.balances.shards
            assert len({t.device for t in shards}) == n == len(shards)
        h = SingleNodeHarness(sm)
        replies = [f.result() for f in [h.submit_async(op, body) for op, body in ops]]
        sm.verify_device_mirror()
        table = sharded.dense(sm._dev.read() if engine == "host" else sm._dev.balances)
        out.append((replies, sm.state_root(), table.cpu()))
    assert out[0][:2] == out[1][:2] and torch.equal(out[0][2], out[1][2])


def _launcher_inputs(kind, A, G, card):
    """A (G, B, C) stack of the experiments' probe batches over an
    A-row table, with meta and a ring, on the card."""
    from tigerbeetle_tpu_torch.experiments import common

    table, meta, ring = common.tables(A, card)
    stack = common.upload(common.probe_stack(kind, A, G, seed=3), card)
    ns = np.array([common.N - g for g in range(G)], np.int64)
    tsb = np.arange(G, dtype=np.uint64) + np.uint64(1 << 40)
    return table, meta, ring, stack, ns, tsb


@pytest.mark.parametrize("kind", list(dk.KIND_MODE))
def test_scan_of_matches_its_plain_version(card, kind):
    """G = 4 batches from a resident stack, ring rows wrapping past the
    end: the kernels' launcher equals the plain loop and the same batches
    launched one per call; the batches count as scan_of."""
    G, A = 4, 1 << 16
    table, meta, ring, stack, ns, tsb = _launcher_inputs(kind, A, G, card)
    runs = []
    for fn in (dk.scan_of(kind, G), dk.scan_of(kind, G, plain=True), None):
        t, r = table.clone(), ring.clone()
        kernels.reset_launches()
        if fn is None:
            for g in range(G):
                dk.KERNELS[kind](t, meta, r, (254 + g) % 256, stack[g], int(ns[g]), int(tsb[g]))
        else:
            fn(t, meta, r, 254, stack, ns, tsb)
        torch.cuda.synchronize()
        runs.append((t, r, dict(kernels.launches)))
    assert runs[0][2]["scan_of"] == G and runs[1][2]["scan_of"] == 0
    assert runs[2][2][dk.FAMILY[kind]] == G and runs[0][2][dk.FAMILY[kind]] == 0
    for t, r, _ in runs[1:]:
        assert torch.equal(runs[0][0], t) and torch.equal(runs[0][1], r)


@pytest.mark.parametrize("name", sorted(dk.STAGED))
def test_staged_matches_its_plain_version(card, name):
    """Batch g of a superbatch for g = 0, G - 1, G and -1 (the clamp)."""
    kind, G, A = dk.STAGED[name], 3, 1 << 16
    table, meta, ring, stack, ns, _ = _launcher_inputs(kind, A, G, card)
    sup = stack.reshape(G * stack.shape[1], stack.shape[2])
    for g in (0, G - 1, G, -1):
        t_k, r_k, t_p, r_p = table.clone(), ring.clone(), table.clone(), ring.clone()
        kernels.reset_launches()
        getattr(dk, name)(t_k, meta, r_k, 5, sup, g, int(ns[-1]), 1 << 40)
        assert kernels.launches["staged"] == 1
        dk.staged(kind, plain=True)(t_p, meta, r_p, 5, sup, g, int(ns[-1]), 1 << 40)
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_p) and torch.equal(r_k, r_p), g


def test_graft_entry_on_the_card(card):
    from tigerbeetle_tpu_torch import graft_entry as ge

    fn, args = ge.entry()
    table, packed = fn(*args)
    cfn, cargs = ge.entry(device="cpu")
    c_table, c_packed = cfn(*cargs)
    assert torch.equal(table.cpu(), c_table) and torch.equal(packed.cpu(), c_packed)
    ge.dryrun_multichip(4)


def test_probes_on_the_card(card, capsys):
    import importlib

    for name in ("scan_kinds_probe", "scan_resident_probe", "scan_probe", "stage_sweep",
                 "staged_prod_probe", "kernel_time_probe", "kernel_time_probe2"):
        mod = importlib.import_module(f"tigerbeetle_tpu_torch.experiments.{name}")
        assert mod.main(["--rows", str(1 << 16), "--reps", "1"]) == 0
        assert capsys.readouterr().out.splitlines()[-1].startswith("check: ")


@pytest.mark.parametrize("engine", ["host", "device"])
def test_sharded_vopr_on_the_card_matches_the_oracle(card, engine):
    """The router's ShardedVopr, 2 shards x 2 replicas, every replica on
    TorchStateMachine on the card: equal to the same seed on the oracle,
    and the engine's kernels launched."""
    import dataclasses

    from tigerbeetle_tpu_torch import constants as cfg

    config = dataclasses.replace(cfg.TEST_MIN, clients_max=16)  # ShardedCluster's
    seed, params = seeded.SHARDED_VOPR_CASES[0]  # 11, no nemesis
    _, want = seeded.sharded_vopr_run(seed, params)
    kernels.reset_launches()
    v, got = seeded.sharded_vopr_run(
        seed, params, lambda: TorchStateMachine(config, engine=engine, device=card))
    launches = dict(kernels.launches)
    assert v._strict_cross and v.compensations == 0
    assert all(r.sm.device == card for s in v.cluster.shards for r in s.replicas)
    assert got == want
    for name in ("apply_deltas",) if engine == "host" else ("orderfree", "commit_update"):
        assert launches[name] > 0, launches
