"""State commitment of the port (tigerbeetle_tpu_torch/state_machine/
commitment.py): the pinned golden digest, and the rebuild / update /
probe plain versions of kernel K2 against the JAX device_fns() — bit
for bit, -1 padding included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from tigerbeetle_tpu.state_machine import commitment as ref
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.state_machine import commitment as cm


def _fixture_table():
    bal = np.arange(64, dtype=np.uint64).reshape(8, 8) * np.uint64(0x0123456789ABCDEF)
    meta = np.arange(16, dtype=np.uint32).reshape(8, 2) + np.uint32(1)
    return bal, meta


def _meta_t(meta_u32):
    return torch.from_numpy(np.ascontiguousarray(meta_u32).view(np.int32))


def test_golden_digest_pinned():
    """The reference's pinned root (tests/test_commitment.py) holds on the
    host path and on the plain device version."""
    bal, meta = _fixture_table()
    d = cm.table_digest(bal, meta)
    assert int(d[0]) == 0xB84D53B618D40315, hex(int(d[0]))
    assert int(d[1]) == 0x924D31B47961A88B, hex(int(d[1]))
    assert cm.root_bytes(d).hex() == "1503d418b6534db88ba86179b4314d92"
    row_hash, digest = cm.rebuild(from_u64(bal), _meta_t(meta), torch.arange(8))
    assert np.array_equal(to_u64(digest), d)


def _random_tables(seed, rows):
    rng = np.random.default_rng(seed)
    bal = rng.integers(0, 1 << 63, (rows, 8), dtype=np.uint64)
    bal |= rng.integers(0, 2, (rows, 8), dtype=np.uint64) << np.uint64(63)
    bal[rng.random(rows) < 0.2] = 0  # all-zero rows hash to (0, 0)
    meta = rng.integers(0, 1 << 32, (rows, 2), dtype=np.uint64).astype(np.uint32)
    meta[rng.random(rows) < 0.2] = 0
    return bal, meta


@pytest.mark.parametrize("rows", [1, 8, 257, 1024])
def test_rebuild_matches_jax(rows):
    bal, meta = _random_tables(rows, rows)
    logical = np.arange(rows, dtype=np.uint64) + np.uint64(3)  # non-identity binding
    jrh, jdg = ref.device_fns()["rebuild"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(logical)
    )
    trh, tdg = cm.rebuild(from_u64(bal), _meta_t(meta), from_u64(logical))
    assert np.array_equal(to_u64(trh), np.asarray(jrh))
    assert np.array_equal(to_u64(tdg), np.asarray(jdg))
    assert np.array_equal(to_u64(tdg), cm.table_digest(bal, meta, start_row=3))


@pytest.mark.parametrize("n_touched", [0, 1, 100, 300])
def test_update_matches_jax_with_padding(n_touched):
    rows = 512
    bal, meta = _random_tables(40 + n_touched, rows)
    fns = ref.device_fns()
    ident = np.arange(rows, dtype=np.uint64)
    jrh, jdg = fns["rebuild"](jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(ident))
    rng = np.random.default_rng(n_touched)
    slots = np.sort(rng.choice(rows, n_touched, replace=False)).astype(np.int64)
    bal2 = bal.copy()
    bal2[slots, 1] += np.uint64(977)
    meta2 = meta.copy()
    meta2[slots[: n_touched // 2], 0] ^= np.uint32(5)
    padded = cm.pad_slots(slots)
    assert np.array_equal(padded, ref.pad_slots(slots))
    assert (padded[n_touched:] == -1).all()
    jrh2, jdg2 = fns["update"](
        jnp.asarray(bal2), jnp.asarray(meta2), jrh, jdg,
        jnp.asarray(padded), jnp.asarray(padded),
    )
    trh = from_u64(np.asarray(jrh).copy())
    tdg = from_u64(np.asarray(jdg).copy())
    out_rh, out_dg = cm.update(
        from_u64(bal2), _meta_t(meta2), trh, tdg,
        torch.from_numpy(padded), torch.from_numpy(padded),
    )
    assert out_rh is trh and out_dg is tdg  # updated in place
    assert np.array_equal(to_u64(trh), np.asarray(jrh2))
    assert np.array_equal(to_u64(tdg), np.asarray(jdg2))
    assert np.array_equal(to_u64(tdg), cm.table_digest(bal2, meta2))


def test_probe_matches_jax():
    bal, meta = _random_tables(77, 300)
    ident = np.arange(300, dtype=np.uint64)
    stale = np.array([12345, 67890], np.uint64)
    want = ref.device_fns()["probe"](
        jnp.asarray(bal), jnp.asarray(meta), jnp.asarray(stale), jnp.asarray(ident)
    )
    got = cm.probe(from_u64(bal), _meta_t(meta), from_u64(stale), from_u64(ident))
    assert np.array_equal(to_u64(got), np.asarray(want))


def test_host_commitment_refresh_tracks_from_scratch():
    from tigerbeetle_tpu_torch.state_machine.mirror import BalanceMirror

    rows = 64
    rng = np.random.default_rng(5)
    meta = rng.integers(1, 9, (rows, 2)).astype(np.uint32)
    mirror = BalanceMirror(rows)
    twin = cm.HostCommitment(rows, meta_fn=lambda s: meta[s])
    mirror.commitment = twin
    twin.rebuild(mirror)  # meta is nonzero from the start
    for step in range(5):
        s = rng.choice(rows, 10, replace=False)
        mirror.lo[s, step % 4] += np.uint64(step + 1)
        twin.refresh(s, mirror)
        assert np.array_equal(twin.digest, cm.table_digest(mirror.rows8(np.arange(rows)), meta))
