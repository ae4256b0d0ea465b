"""Kernel K4's plain version (device_kernels.apply_deltas on CPU
tensors) against both reference functions it replaces,
device_kernels._apply_deltas and kernel_fast._flush_impl: unique
(slot, col) u128 modular adds with carries from lo into hi, wrap past
2^128, and padding entries (slot >= A) dropped."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tigerbeetle_tpu.state_machine import device_kernels as ref_dk
from tigerbeetle_tpu.state_machine import kernel_fast as ref_kf
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk

M64 = np.uint64((1 << 64) - 1)
A = 64
K = 256


def make_case(seed, padded, K=K):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 63, (A, 8), dtype=np.uint64) << np.uint64(1)
    table[:5, 0::2] = M64            # lo limbs at max: every add carries
    table[5:8, :] = M64              # whole u128 at max: wraps to small
    live = K // 2 if padded else K
    keys = rng.choice(A * 4, size=min(live, A * 4), replace=False)
    packed = np.zeros((4, K), np.uint64)
    packed[0, : len(keys)] = keys // 4
    packed[1, : len(keys)] = keys % 4
    packed[2, : len(keys)] = rng.integers(0, 1 << 63, len(keys), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    packed[3, : len(keys)] = rng.integers(0, 1 << 40, len(keys), dtype=np.uint64)
    packed[2, :3] = M64              # lo carry on top of a max lo limb
    # Padding: distinct out-of-range slots, as the reference's flush
    # writes them; their deltas must never land.
    packed[0, len(keys):] = A + np.arange(K - len(keys), dtype=np.uint64)
    packed[2, len(keys):] = 7
    return table, packed


def port(table, packed):
    t = torch.from_numpy(table.copy().view(np.int64))
    out = dk.apply_deltas(t, torch.from_numpy(packed.view(np.int64)))
    assert out is t  # in place
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_apply_matches_both_references(seed, padded):
    table, packed = make_case(seed, padded)
    want_dk = np.asarray(ref_dk.apply_deltas(jnp.asarray(table), jnp.asarray(packed)))
    want_kf = np.asarray(ref_kf._flush_impl(jnp.asarray(table), jnp.asarray(packed)))
    np.testing.assert_array_equal(want_dk, want_kf)
    np.testing.assert_array_equal(port(table, packed), want_dk)


@pytest.mark.parametrize("k", [1, 2, 255, 257])
def test_plain_apply_uneven_counts_match_both_references(k):
    """One entry, and counts that are no multiple of the kernel's entries
    a thread (a live entry, or padding, last)."""
    table, packed = make_case(30 + k, k > 2, K=k)
    want_dk = np.asarray(ref_dk.apply_deltas(jnp.asarray(table), jnp.asarray(packed)))
    want_kf = np.asarray(ref_kf._flush_impl(jnp.asarray(table), jnp.asarray(packed)))
    np.testing.assert_array_equal(want_dk, want_kf)
    np.testing.assert_array_equal(port(table, packed), want_dk)
    assert (want_dk != table).any()


def test_negative_deltas_release_exactly():
    """Pending expiry enqueues two's-complement deltas: adding 2^128 - x
    subtracts x, borrow included."""
    table = np.zeros((A, 8), np.uint64)
    table[3, 0] = 5          # debits_pending = 5
    table[4, 4] = 0
    table[4, 5] = 1          # credits_pending = 2^64
    amt = [5, 7]
    packed = np.zeros((4, 2), np.uint64)
    packed[0] = [3, 4]
    packed[1] = [0, 2]
    for j, x in enumerate(amt):
        neg = (1 << 128) - x
        packed[2, j] = neg & int(M64)
        packed[3, j] = neg >> 64
    got = port(table, packed)
    assert got[3, 0] == 0 and got[3, 1] == 0
    assert int(got[4, 4]) == (1 << 64) - 7 and got[4, 5] == 0
    np.testing.assert_array_equal(
        got, np.asarray(ref_dk.apply_deltas(jnp.asarray(table), jnp.asarray(packed)))
    )


def test_empty_and_shape_checks():
    t = torch.zeros((A, 8), dtype=torch.int64)
    dk.apply_deltas(t, torch.zeros((4, 0), dtype=torch.int64))
    assert not t.any()
    with pytest.raises(ValueError):
        dk.apply_deltas(t, torch.zeros((3, 4), dtype=torch.int64))
