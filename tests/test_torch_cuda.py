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
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine import waves
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import scan_cases, semantic_cases, shard_cases, wave_cases
from tigerbeetle_tpu_torch.testing.harness import SingleNodeHarness

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


@pytest.mark.parametrize("B,cls", [(256, c) for c in scan_cases.CLASSES] + [(8192, "mixed")])
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


def _step(card, plan, k, ev, n, ts_base, kern, plain, scratch):
    """Segment k of the plan with the kernel on `kern` and the plain
    version on `plain` ((table, events, carry) each); both equal after."""
    kind, idx = plan.segments[k]
    B = kern[1].shape[0]
    if kind == "chains":
        ix = torch.from_numpy(waves._chain_plane(ev["flags"], idx, plan.chain_steps[k], B))
        name, run_k = "chain_wave", lambda t, p, w, x: waves.chain_wave(
            t, p, w, x, n, ts_base, scratch=scratch)
        run_p = lambda t, p, w, x: waves.chain_wave_plain(t, p, w, x, n, ts_base)  # noqa: E731
    elif kind == "wave":
        ix = torch.from_numpy(np.asarray(idx, np.int32))
        name, run_k = "wave_step", lambda t, p, w, x: waves.wave_step(
            t, p, w, x, n, ts_base, scratch=scratch)
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
    scratch = waves.WaveScratch(card)
    for k in range(len(plan.segments)):
        _step(card, plan, k, ev, n, ts_base, kern, plain, scratch)
    B = kern[1].shape[0]
    fix = torch.zeros(B, dtype=torch.uint8)
    fix[:n] = torch.from_numpy(plan.wave_mask.astype(np.uint8))
    fix = fix.to(card)
    out_k = k3.finalize(kern[0], kern[2], B, fix)
    out_p = k3.finalize_plain(plain[0], plain[2], B, fix)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    return plan


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
    waves.wave_step(*kern, idx, n, ts_base, mask=mask, scratch=waves.WaveScratch(card))
    waves.wave_step_plain(*plain, idx, n, ts_base, mask)
    torch.cuda.synchronize()
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[2], plain[2])


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
