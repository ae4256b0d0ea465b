"""Kernels K1-K6 on a CUDA card against their plain PyTorch versions,
and TorchStateMachine on the card against the CPU run.  They
skip without a card; on one, run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: the suite's conftest imports the JAX package, which a
machine with the card need not have.)
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch import kernels, workload
from tigerbeetle_tpu_torch.state_machine import commitment as cm
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.state_machine import kernel as k3
from tigerbeetle_tpu_torch.state_machine.gpu import TorchStateMachine
from tigerbeetle_tpu_torch.testing import scan_cases, semantic_cases
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
def test_exact_streams_on_card_match_cpu(card, engine):
    """The bench's linked and two_phase shapes at 2000 events per batch:
    K3 (and K2 updates, K4 flushes) on the card against the plain run."""
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
