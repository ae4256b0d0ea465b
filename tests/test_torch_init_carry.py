"""K3 init's plain version (tigerbeetle_tpu_torch/state_machine/kernel.py
make_carry, reached through the exact_init wrapper on CPU tensors)
against the JAX package's waves._init_carry_keep, bit for bit: batches
of 1, 7, 512 and 513 rows (odd and even, one that is a multiple of the
kernel's old 256-thread block and one that is not), durable statuses
from a seed that include negative int32 values (the carry widens them
as u32).  Both carries are mapped through the carry's dict view, and
the port's scratch image must also equal carry_from_dict of the
reference's word for word, its fourth scalar included.  The words past
scratch_words(B) are left as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import waves as rw
from tigerbeetle_tpu_torch.state_machine import kernel as k3

SENTINEL = 0x5A5A5A5A5A5A5A5A
PAST = 5  # words after the carry that must keep the sentinel


def dstat_init(seed, B):
    rng = np.random.default_rng(seed)
    ds = rng.integers(-(1 << 31), 1 << 31, B, dtype=np.int64).astype(np.int32)
    ds[0] = -1
    return ds


def reference(ds):
    balances = jnp.zeros((4, 8), jnp.uint64)
    carry = rw._init_carry_keep(balances, jnp.asarray(ds.view(np.uint32)))
    out = {k: np.asarray(v) for k, v in carry.items() if k not in ("balances", "created")}
    out["created"] = {f: np.asarray(v) for f, v in carry["created"].items()}
    return out


def assert_dicts_equal(got, want, path=""):
    assert set(got) == set(want), path
    for key, w in want.items():
        if isinstance(w, dict):
            assert_dicts_equal(got[key], w, f"{path}{key}.")
        else:
            g = np.asarray(got[key])
            assert g.dtype == np.asarray(w).dtype, f"{path}{key}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}{key}")


@pytest.mark.parametrize("B", [1, 7, 512, 513])
def test_init_carry_matches_jax(B):
    ds = dstat_init(B, B)
    assert (ds < 0).any()
    n = k3.scratch_words(B)
    words = torch.full((n + PAST,), SENTINEL, dtype=torch.int64)
    out = k3.exact_init(words, torch.from_numpy(ds))
    assert out is words
    want = reference(ds)
    assert_dicts_equal(k3.carry_to_dict(words[:n], B), want)
    np.testing.assert_array_equal(words[:n].numpy().view(np.uint64), k3.carry_from_dict(want))
    assert (words[n:] == SENTINEL).all()


def test_init_carry_overwrites_every_word():
    """A carry image left by an earlier batch (every word set) comes out
    as a fresh one: no region keeps a stale word."""
    B = 513
    ds = torch.from_numpy(dstat_init(3, B))
    n = k3.scratch_words(B)
    fresh = k3.exact_init(torch.zeros(n, dtype=torch.int64), ds)
    stale = torch.from_numpy(np.random.default_rng(4).integers(-(1 << 63), (1 << 63) - 1, n))
    assert torch.equal(k3.exact_init(stale, ds), fresh)
