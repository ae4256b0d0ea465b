"""The multi-batch launchers of tigerbeetle_tpu_torch/state_machine/
device_kernels.py against the JAX package's, on the CPU (the launchers
run the kernels' plain versions on CPU tensors): scan_of for every kind
against scan_kernels[kind][G] with the ring wrapping, staged for the
five *_staged names at g = 0, G - 1, G, -1 and -(G + 1) against the
reference's (the clamped superbatch slice), and run_window at offsets
outside the window buffer against scan_win_kernels (the
dynamic_slice rule: a negative start wraps once, then clamps).  Table
and ring bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import device_kernels as ref
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.testing import semantic_cases as sc

A = 1024  # table rows
R = 8     # ring rows


def _orderfree_pk(rng, kind, n):
    """An order-free batch of `kind`'s layout: a share of unknown debit
    accounts and of pending transfers, so codes and balances vary."""
    B = dk.B
    dr = rng.integers(0, A - 1, n)
    dr1 = dr + 1
    dr1[rng.random(n) < 0.05] = 0  # debit account not found
    amount = rng.integers(1, 1 << 31, n)
    pending = rng.random(n) < 0.3
    if kind == "orderfree_tight":
        pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
        pk[:n, 0] = dk.TIGHT_CODE_BIT | np.where(pending, dk.F_PENDING << dk.TIGHT_FLAGS_SHIFT, 0)
        pk[:n, 1] = dr1
        pk[:n, 2] = dr + 2
        pk[:n, 3] = amount
        pk[:n, 4] = 1
        return pk
    pk = np.zeros((B, dk.N_COLS), np.uint64)
    pk[:n, dk.COL_SLOTS] = dr1.astype(np.uint64) | ((dr + 2).astype(np.uint64) << np.uint64(32))
    pk[:n, dk.COL_AMT_LO] = amount.astype(np.uint64)
    flags = np.where(pending, dk.F_PENDING, 0).astype(np.uint64)
    pk[:n, dk.COL_MISC] = flags | np.uint64((1 << 16) | (1 << 32))
    return pk


def _inputs(kind, G, seed):
    """(table, meta, stack (G, B, C), ns, tsb) for `kind`: the linked and
    two-phase batches from testing/semantic_cases.py (the table and meta
    of the first), the order-free ones drawn here; batch sizes differ."""
    rng = np.random.default_rng(seed)
    ns = np.array([dk.B - 3 * g for g in range(G)], np.int64)
    tsb = (np.uint64(1 << 40) + np.arange(G, dtype=np.uint64) * np.uint64(dk.B))
    fam = dk.FAMILY[kind]
    if fam == "orderfree":
        table = np.zeros((A, 8), np.uint64)
        table[:, ::2] = rng.integers(0, 1 << 40, (A, 4), dtype=np.uint64)
        meta = np.zeros((A, 2), np.uint32)
        meta[:, 1] = 1
        stack = np.stack([_orderfree_pk(rng, kind, int(ns[g])) for g in range(G)])
        return table, meta, stack, ns, tsb
    case = sc.linked_case if fam == "linked" else sc.two_phase_case
    scenario = "limits" if fam == "linked" else "mixed"
    cases = [case(seed + g, dk.B, scenario, A=A, n=int(ns[g])) for g in range(G)]
    table, meta = cases[0][0], cases[0][1]
    return table, meta, np.stack([c[2] for c in cases]), ns, tsb


def _t(a):
    return torch.from_numpy(a.view(np.int32 if a.dtype == np.uint32 else np.int64).copy())


def _ring(seed):
    return np.random.default_rng(seed).integers(0, 1 << 62, (R, dk.SUMMARY_WORDS),
                                                dtype=np.uint64)


CASES = [(kind, 4) for kind in dk.KIND_MODE] + [("orderfree_tight", 16)]


@pytest.mark.parametrize("kind,G", CASES)
def test_scan_of_matches_jax_scan(kind, G):
    """G batches from a resident stack, ring rows (ring_at0 + g) % R
    wrapping past the ring's end."""
    assert G in ref.SCAN_SIZES and G in dk.SCAN_SIZES
    table, meta, stack, ns, tsb = _inputs(kind, G, 7 * G + len(kind))
    ring = _ring(G)
    at0 = R - 2
    jt, jr = ref.scan_kernels[kind][G](
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), at0,
        jnp.asarray(stack), jnp.asarray(ns), jnp.asarray(tsb),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    out_t, out_r = dk.scan_kernels[kind][G](t, _t(meta), r, at0, _t(stack), ns, tsb)
    assert out_t is t and out_r is r  # in place
    assert np.array_equal(to_u64(t), np.asarray(jt))
    assert np.array_equal(to_u64(r), np.asarray(jr))
    rows = [(at0 + g) % R for g in range(G)]
    assert [int(x) for x in to_u64(r)[rows[:R], 3]] == list(ns[-R:] if G > R else ns)
    assert not np.array_equal(to_u64(t), table)


def test_scan_of_reads_host_copies_of_tensor_scalars():
    """ns / tsb given as tensors give the same result as host arrays."""
    kind, G = "orderfree_lo", 4
    table, meta, stack, ns, tsb = _inputs(kind, G, 3)
    outs = []
    for ns_, tsb_ in ((ns, tsb), (torch.from_numpy(ns), torch.from_numpy(tsb.view(np.int64)))):
        t, r = from_u64(table.copy()), from_u64(_ring(0))
        dk.scan_kernels[kind][G](t, _t(meta), r, -3, _t(stack), ns_, tsb_)
        outs.append((to_u64(t), to_u64(r)))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


STAGED_G = 3


@pytest.mark.parametrize("name", sorted(dk.STAGED))
def test_staged_matches_jax_at_every_batch_index(name):
    """Batch g of a (G * B, C) superbatch, g inside and outside [0, G):
    the reference clamps the slice (g = -1 wraps to the last batch,
    g >= G reads the last, g <= -(G + 1) the first)."""
    kind = dk.STAGED[name]
    G = STAGED_G
    table, meta, stack, ns, _tsb = _inputs(kind, G, 11 + len(name))
    sup = stack.reshape(G * dk.B, stack.shape[2])
    jfn = getattr(ref, name)
    pfn = getattr(dk, name)
    reads = {}
    for g in (0, G - 1, G, -1, -(G + 1)):
        ring = _ring(g + 5)
        n = int(ns[-1])
        jt, jr = jfn(jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), 2,
                     jnp.asarray(sup), g, n, jnp.uint64(1 << 40))
        t, r = from_u64(table.copy()), from_u64(ring.copy())
        pfn(t, _t(meta), r, 2, _t(sup), g, n, 1 << 40)
        assert np.array_equal(to_u64(t), np.asarray(jt)), g
        assert np.array_equal(to_u64(r), np.asarray(jr)), g
        reads[g] = to_u64(t)
    assert np.array_equal(reads[-1], reads[G - 1]) and np.array_equal(reads[G], reads[G - 1])
    assert not np.array_equal(reads[0], reads[G - 1])


def test_staged_passes_a_view_not_a_copy(monkeypatch):
    seen = []
    super_pk = torch.zeros((3 * dk.B, dk.N_COLS), dtype=torch.int64)
    monkeypatch.setitem(dk.PLAIN, "orderfree_lo", lambda *a, **k: seen.append(a[4]))
    dk.staged("orderfree_lo", plain=True)(None, None, None, 0, super_pk, 1, 0, 0)
    (pk,) = seen
    assert pk.is_contiguous() and pk.shape == (dk.B, dk.N_COLS)
    assert pk.data_ptr() == super_pk[dk.B].data_ptr()


@pytest.mark.parametrize("start,extent,size,want", [
    (0, 5, 1, 0), (4, 5, 1, 4), (-1, 5, 1, 4), (-5, 5, 1, 0), (-7, 5, 1, 0), (5, 5, 1, 4),
    (9, 5, 1, 4), (-1, 10, 3, 7), (-6, 10, 3, 4), (-100, 10, 3, 0), (8, 10, 3, 7),
])
def test_dynamic_start_follows_dynamic_slice(start, extent, size, want):
    got = int(jax.lax.dynamic_slice(jnp.arange(extent), (start,), (size,))[0])
    assert got == want
    assert dk.dynamic_start(start, extent, size) == want


@pytest.mark.parametrize("off_of", [lambda W: -1, lambda W: -(W + 2), lambda W: W + 3])
def test_run_window_clamps_offsets_as_scan_win(off_of):
    """Window offsets outside the (W, B, C) buffer: every batch, n and
    ts_base index is taken as the reference's dynamic_slice takes it."""
    kind, G, W = "orderfree_tight", 4, 6
    table, meta, big, ns, tsb = _inputs(kind, W, 21)
    off = off_of(W)
    ring = _ring(1)
    jt, jr = ref.scan_win_kernels[kind][G](
        jnp.asarray(table), jnp.asarray(meta), jnp.asarray(ring), R - 1,
        jnp.asarray(big), off, jnp.asarray(ns), jnp.asarray(tsb),
    )
    t, r = from_u64(table.copy()), from_u64(ring.copy())
    dk.run_window(kind, t, _t(meta), r, R - 1, _t(big), off, G, ns, tsb)
    assert np.array_equal(to_u64(t), np.asarray(jt))
    assert np.array_equal(to_u64(r), np.asarray(jr))
