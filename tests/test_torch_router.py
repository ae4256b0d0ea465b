"""The port's router and its sharding helpers against the reference's.

- tests/test_router.py's 16 cases re-pointed (tests/torch_repoint.py):
  each runs on the port's runtime/router.py, testing/cluster.py
  (``ShardedCluster``, ``SimRouter``, ``RoutedClient``) and types.py, and
  again on the reference's.  Both pass the case's own checks and record
  equal client replies, HashLog digests, commit points, state roots and
  storage images for every shard.  The CPU oracle serves the shards here;
  the engine arms are in test_torch_router_host.py and
  test_torch_router_device.py.
- Differentials of the copies on seeded numpy ids: ``shard_of_account``
  at 1-4 shards, ``XShardIds``, ``coord_account_id`` / ``is_coord_account``,
  ``xleg_tag`` / ``xleg_untag``, the two new dtypes, the cluster
  commitment fold, and every envcheck reader the router reads, with the
  variables set (good and bad values) and unset.
"""

import numpy as np
import pytest

import torch_repoint as rp
from tigerbeetle_tpu import envcheck as ref_env
from tigerbeetle_tpu import types as ref_types
from tigerbeetle_tpu.state_machine import commitment as ref_cm
from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import commitment as cm

CASES = rp.case_names("test_router.py")


@pytest.mark.parametrize("case", CASES, ids=[c[5:] for c in CASES])
def test_repointed_case_matches_reference(case, tmp_path):
    rp.run_both("test_router.py", case, "oracle", tmp_path)


def _ids(seed: int, n: int) -> list[int]:
    """Seeded u128 ids: small sequential-looking ones, full-width ones,
    and the edges."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + rng.integers(0, 2, n, dtype=np.uint64)
    hi = rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + rng.integers(0, 2, n, dtype=np.uint64)
    small = rng.integers(1, 10_000, n)
    wide = [int(a) | (int(b) << 64) for a, b in zip(lo, hi)]
    return [0, 1, types.U64_MAX, types.U64_MAX + 1, types.U128_MAX, *map(int, small), *wide]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_of_account_matches_reference(n_shards):
    ids = _ids(n_shards, 400)
    got = [types.shard_of_account(i, n_shards) for i in ids]
    assert got == [ref_types.shard_of_account(i, n_shards) for i in ids]
    assert set(got) == set(range(n_shards))


def test_xshard_ids_and_coord_namespace_match_reference():
    for tid in _ids(7, 60):
        a, b = types.XShardIds(tid), ref_types.XShardIds(tid)
        assert types.XShardIds._ROLES == ref_types.XShardIds._ROLES
        assert [getattr(a, r) for r in a._ROLES] == [getattr(b, r) for r in b._ROLES]
        assert types.is_coord_account(tid) == ref_types.is_coord_account(tid)
    for role in ("ledger-marker", "hold_debit"):
        assert types.XShardIds._derive(5, role) == ref_types.XShardIds._derive(5, role)
    rng = np.random.default_rng(11)
    for ledger in [1, 0xFFFFFFFF, *map(int, rng.integers(1, 1 << 32, 40))]:
        cid = types.coord_account_id(ledger)
        assert cid == ref_types.coord_account_id(ledger)
        assert types.is_coord_account(cid) and ref_types.is_coord_account(cid)
    for name in ("COORD_ID_TAG", "COORD_REGISTRY_LEDGER", "COORD_REGISTRY_ACCOUNT",
                 "COORD_REGISTRY_FUNDING", "XLEG_DEBIT", "XLEG_CREDIT", "_SHARD_MIX"):
        assert getattr(types, name) == getattr(ref_types, name), name
    for leg in (types.XLEG_DEBIT, types.XLEG_CREDIT):
        for peer in map(int, rng.integers(0, 64, 20)):
            tag = types.xleg_tag(leg, peer)
            assert tag == ref_types.xleg_tag(leg, peer)
            assert types.xleg_untag(tag) == ref_types.xleg_untag(tag) == (leg, peer)
    for dt in ("TRANSFER_PENDING_DTYPE", "ACCOUNT_BALANCES_GROOVE_DTYPE"):
        assert getattr(types, dt) == getattr(ref_types, dt), dt


def test_fold_cluster_matches_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 4):
        roots = [rng.integers(0, 1 << 63, 2, dtype=np.uint64).tobytes() for _ in range(n)]
        assert cm.fold_cluster(roots) == ref_cm.fold_cluster(roots)
        assert cm.digest_of_root(roots[0]).tolist() == ref_cm.digest_of_root(roots[0]).tolist()
    assert cm.fold_cluster([]) == ref_cm.fold_cluster([])


READERS = {
    # reader: (variable, good values, bad values)
    "router_queue": ("TB_ROUTER_QUEUE", ["1", "300"], ["0", "-2", "1.5"]),
    "coord_retry_ms": ("TB_COORD_RETRY_MS", ["10", "60000"], ["9", "60001", "abc"]),
    "coord_timeout_s": ("TB_COORD_TIMEOUT_S", ["6", "86400"], ["5", "1", "0", "86401", "x"]),
    "read_policy": ("TB_READ_POLICY", ["auto", "primary", "follower"], ["leader", "AUTO"]),
    "read_fallback_ms": ("TB_READ_FALLBACK_MS", ["10", "60000"], ["9", "60001", "z"]),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_router_envcheck_readers_match_reference(reader, monkeypatch):
    """Same default unset and empty, same value when set, and a parse
    error naming the same variable where the reference raises."""
    name, good, bad = READERS[reader]
    port_fn, ref_fn = getattr(envcheck, reader), getattr(ref_env, reader)
    monkeypatch.delenv(name, raising=False)
    assert port_fn() == ref_fn()
    for value in ["", *good]:
        monkeypatch.setenv(name, value)
        assert port_fn() == ref_fn(), (name, value)
    for value in bad:
        monkeypatch.setenv(name, value)
        with pytest.raises(ref_env.EnvVarError) as want:
            ref_fn()
        with pytest.raises(envcheck.EnvVarError) as got:
            port_fn()
        assert str(got.value) == str(want.value), (name, value)


def test_view_change_budget_matches_reference():
    assert envcheck.view_change_budget_s() == ref_env.view_change_budget_s() == 5.0
