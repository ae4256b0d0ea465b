"""The row layer under the sharded engines, on the CPU (plain versions):

- K14 at row widths W = 1, 2 and 8 (a shard's gather part and owned
  write-back) against numpy, and ``sharded.ShardedTable`` (split, join,
  gather, scatter, owned; an int32 meta table moved as one int64 word
  per row) against plain indexing;
- K11 with ``row0``: the per-shard digests of a split table sum to the
  reference's ``device_kernels.checksum`` of the joined table, and
  row0 = 0 is the whole-table digest;
- the packed-slot remap of every semantic kind (``_remap_pk``): K1
  (tight, lo, full), K5 and K6 run on the compact table of the rows a
  batch can touch give the ring row and the touched rows of the dense
  run, bit for bit."""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu.state_machine import device_kernels as ref_dk
from tigerbeetle_tpu_torch.ops.u128 import from_u64, to_u64
from tigerbeetle_tpu_torch.parallel import sharded
from tigerbeetle_tpu_torch.state_machine import device_engine as de
from tigerbeetle_tpu_torch.state_machine import device_kernels as dk
from tigerbeetle_tpu_torch.testing import semantic_cases

SHARDS = 8
A = 1024


def _rand_words(rng, rows, width):
    return rng.integers(-(1 << 63), (1 << 63) - 1, (rows, width), dtype=np.int64)


@pytest.mark.parametrize("width", [1, 2, 8])
def test_k14_parts_at_width(width):
    """gather_part / scatter_part on every shard of a (A, W) table: owned
    rows gathered, zeros elsewhere (-1 and rows past the table too);
    the write-back touches owned rows only."""
    rng = np.random.default_rng(width)
    full = _rand_words(rng, A, width)
    local = A // SHARDS
    slots = np.concatenate([rng.choice(A, 60, replace=False), [-1, A, A + 7]])
    new = _rand_words(rng, len(slots), width)
    for s in range(SHARDS):
        part = torch.from_numpy(full[s * local:(s + 1) * local].copy())
        t_slots = torch.from_numpy(slots.astype(np.int64))
        own = (slots >= s * local) & (slots < (s + 1) * local)
        want = np.where(own[:, None], full[np.clip(slots, 0, A - 1)], 0)
        got = sharded.gather_part(part, t_slots, s)
        assert got.shape == (len(slots), width)
        assert (got.numpy() == want).all()
        sharded.scatter_part(part, t_slots, torch.from_numpy(new), s)
        expect = full[s * local:(s + 1) * local].copy()
        expect[slots[own] - s * local] = new[own]
        assert (part.numpy() == expect).all()


def test_k14_rejects_a_row_of_the_wrong_width():
    part = torch.zeros((8, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        sharded.scatter_part(part, torch.zeros(3, dtype=torch.int64),
                             torch.zeros((3, 8), dtype=torch.int64), 0)


@pytest.mark.parametrize("width", [3, 4, 16])
def test_k14_refuses_a_width_it_has_no_form_for(width):
    """K14 has forms for W = 1, 2 and 8 only: any other width raises,
    on the CPU as on the card."""
    part = torch.zeros((8, width), dtype=torch.int64)
    slots = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        sharded.gather_part(part, slots, 0)
    with pytest.raises(ValueError):
        sharded.scatter_part(part, slots, torch.zeros((3, width), dtype=torch.int64), 0)


@pytest.mark.parametrize("dtype,cols", [(torch.int64, 8), (torch.int32, 2)])
def test_sharded_checksum_equals_the_dense_one(dtype, cols):
    """sharded.checksum of a ShardedTable (K11 per shard under its row0,
    summed) equals that of the joined table, and a dense table passes
    through."""
    rng = np.random.default_rng(cols)
    full = torch.from_numpy(_rand_words(rng, A, cols)).to(dtype)
    t = sharded.ShardedTable.split(sharded.make_row_mesh(["cpu"] * SHARDS), full)
    want = dk.checksum(full)
    assert torch.equal(sharded.checksum(t, dk.checksum), want)
    assert torch.equal(sharded.checksum(full, dk.checksum), want)


@pytest.mark.parametrize("dtype,width", [(torch.int64, 8), (torch.int64, 2), (torch.int32, 2)])
def test_sharded_table_layer(dtype, width):
    """split / join round trip, gather of any global rows (zeros for -1),
    scatter onto the owners, map with each shard's first row, owned."""
    rng = np.random.default_rng(width)
    if dtype == torch.int32:
        full = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, (A, width),
                                             dtype=np.int64).astype(np.int32))
    else:
        full = torch.from_numpy(_rand_words(rng, A, width))
    mesh = sharded.make_row_mesh(["cpu"] * SHARDS)
    t = sharded.ShardedTable.split(mesh, full)
    assert t.rows == A and t.local_rows == A // SHARDS and torch.equal(t.join(), full)
    slots = np.concatenate([np.sort(rng.choice(A, 50, replace=False)), [-1]])
    got = t.gather(torch.from_numpy(slots))
    assert got.dtype == dtype and torch.equal(got[:-1], full[slots[:-1]])
    assert not got[-1].any()
    new = got.clone()
    new[:-1] = full[:50] if dtype == torch.int64 else full[:50] ^ 1
    t.scatter(torch.from_numpy(slots), new)
    want = full.clone()
    want[slots[:-1]] = new[:-1]
    assert torch.equal(t.join(), want)
    assert t.map(lambda shard, row0: row0) == [s * (A // SHARDS) for s in range(SHARDS)]
    parts = list(t.owned(slots))
    for s, idx, pos in parts:
        assert (idx.numpy() == slots[pos] - s * t.local_rows).all()
    seen = np.concatenate([pos for _s, _idx, pos in parts])
    assert sorted(seen.tolist()) == list(range(50))
    assert sharded.dense(t).equal(want) and sharded.place(want, None) is want


def test_row_mesh_rule():
    """Shard only with more than one device and rows that divide."""
    assert sharded.row_mesh_for(A, None) is None
    assert sharded.row_mesh_for(A, ["cpu"]) is None
    assert sharded.row_mesh_for(A + 4, ["cpu"] * SHARDS) is None
    assert sharded.row_mesh_for(A, ["cpu"] * SHARDS).shape == {"shard": SHARDS}


@pytest.mark.parametrize("dtype,cols", [(np.uint64, 8), (np.uint32, 2)])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_k11_row0_sums_to_the_reference_digest(dtype, cols, shards):
    """Every shard's digest under its first global row, summed mod 2^64,
    equals the reference's K11 of the joined table (balances and meta)."""
    rng = np.random.default_rng(shards)
    full = rng.integers(0, np.iinfo(dtype).max, (A, cols), dtype=dtype, endpoint=True)
    t = from_u64(full) if dtype == np.uint64 else torch.from_numpy(full.view(np.int32))
    local = A // shards
    total = sum(to_u64(dk.checksum(t[s * local:(s + 1) * local], s * local)).astype(object)
                for s in range(shards))
    want = np.asarray(ref_dk.checksum(full)).astype(object)
    assert [int(x) % (1 << 64) for x in total] == [int(x) for x in want]


def test_k11_row0_in_python_ints():
    rng = np.random.default_rng(3)
    full = rng.integers(0, 1 << 63, (16, 4), dtype=np.int64)
    row0 = 1 << 40
    got = to_u64(dk.checksum_plain(torch.from_numpy(full), row0))
    M, G = (1 << 64) - 1, dk._GOLDEN
    cols = [sum(int(v) for v in full[:, j]) & M for j in range(4)]
    mixed = [sum(int(full[r, j]) * (((row0 + r) * G + 1) & M) for r in range(16)) & M
             for j in range(4)]
    assert [int(x) for x in got] == cols + mixed
    with pytest.raises(ValueError):
        dk.checksum(torch.from_numpy(full), -1)


def _orderfree_pk(rng, kind, n):
    B = dk.B
    dr = rng.integers(0, A, n)
    cr = (dr + 1 + rng.integers(0, A - 1, n)) % A
    if kind == "orderfree_tight":
        pk = np.zeros((B, dk.N_COLS_TIGHT), np.uint32)
        pk[:n, 0] = dk.TIGHT_CODE_BIT
        pk[:n, 1] = dr + 1
        pk[:n, 2] = cr + 1
        pk[:n, 3] = rng.integers(1, 100, n)
        pk[:n, 4] = 1
        pk[:5, 1] = 0  # debit account not found
        return pk
    pk = np.zeros((B, dk.N_COLS), np.uint64)
    pk[:n, dk.COL_SLOTS] = (dr + 1).astype(np.uint64) | ((cr + 1).astype(np.uint64) << np.uint64(32))
    pk[:n, dk.COL_AMT_LO] = rng.integers(1, 1 << 62, n).astype(np.uint64)
    if kind == "orderfree":
        pk[:n, dk.COL_AMT_HI] = rng.integers(0, 1 << 20, n).astype(np.uint64)
    flags = np.where(rng.random(n) < 0.3, dk.F_PENDING, 0).astype(np.uint64)
    pk[:n, dk.COL_MISC] = flags | np.uint64((1 << 16) | (1 << 32))
    return pk


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    n = dk.B - 3
    if kind.startswith("orderfree"):
        table = rng.integers(0, 1 << 62, (A, 8), dtype=np.int64)
        table[:, 1::2] = rng.integers(0, 1 << 20, (A, 4))
        meta = np.zeros((A, 2), np.int32)
        meta[:, 1] = 1
        return torch.from_numpy(table), torch.from_numpy(meta), _orderfree_pk(rng, kind, n), n
    if kind.startswith("linked"):
        table, meta, pk, n = semantic_cases.linked_case(seed, dk.B, "limits", A=A, pool=200)
    else:
        table, meta, pk, n = semantic_cases.two_phase_case(seed, dk.B, "durable", A=A)
    t = table if isinstance(table, torch.Tensor) else from_u64(np.asarray(table, np.uint64))
    m = meta if isinstance(meta, torch.Tensor) else torch.from_numpy(
        np.asarray(meta, np.uint32).view(np.int32))
    return t, m, np.asarray(pk), n


@pytest.mark.parametrize("kind", ["orderfree_tight", "orderfree_lo", "orderfree", "linked_small",
                                  "linked", "two_phase_lo", "two_phase"])
def test_packed_remap_runs_the_dense_kernel_on_compact_rows(kind):
    """The engine's sharded unit: the compact rows of a batch, its slot
    words remapped, the dense kernel's plain version on the compact
    table.  Ring row and every table row equal the dense run's."""
    table, meta, pk, n = _case(kind, 11)
    ring = torch.zeros((4, dk.SUMMARY_WORDS), dtype=torch.int64)
    dense_t = table.clone()
    to_t = (lambda a: torch.from_numpy(a.view(np.int32))) if pk.dtype == np.uint32 else from_u64
    dk.PLAIN[kind](dense_t, meta, ring, 0, to_t(pk), n, 1 << 40)

    rows = sharded.compact_rows(de._touched_of_pk(kind, pk, n), A)
    assert rows[0] == 0 and rows[-1] == A - 1 and (np.diff(rows) > 0).all()
    remapped = de._remap_pk(kind, pk, rows, A)
    idx = torch.from_numpy(rows)
    compact = table[idx].clone()
    dk.PLAIN[kind](compact, meta[idx].clone(), ring, 1, to_t(remapped), n, 1 << 40)
    assert torch.equal(ring[0], ring[1])
    got = table.clone()
    got[idx] = compact
    assert torch.equal(got, dense_t)
    assert (remapped[n:] == 0).all()  # padding words stay 0 (none)


def test_remap_keeps_none_order_and_clip():
    """0 (none) stays 0; slots map strictly increasingly; a slot >= A
    maps past the compact rows, as waves._remap_slots does."""
    rows = np.array([0, 5, 9, A - 1])
    pk = np.zeros((4, dk.N_COLS), np.uint64)
    words = np.array([0, 6, 10, A], np.uint64)  # none, slot 5, slot 9, slot A - 1
    pk[:, dk.COL_SLOTS] = words | ((words[::-1] + np.uint64(0)) << np.uint64(32))
    out = de._remap_pk("orderfree", pk, rows, A)
    lo = (out[:, dk.COL_SLOTS] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (out[:, dk.COL_SLOTS] >> np.uint64(32)).astype(np.int64)
    assert lo.tolist() == [0, 2, 3, 4] and hi.tolist() == [4, 3, 2, 0]
    tight = np.zeros((2, dk.N_COLS_TIGHT), np.uint32)
    tight[:, 1] = [A + 3, 1]  # slot A + 2 (past the table), slot 0
    assert de._remap_pk("orderfree_tight", tight, rows, A)[:, 1].tolist() == [4 + 2 + 1, 1]
