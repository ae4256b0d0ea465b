"""The port's LSM tier against the reference's, bit for bit.

tests/test_lsm.py, test_manifest_log.py and test_compaction_pacing.py
re-pointed at the port's modules (lsm/, vsr/free_set.py, vsr/grid.py,
utils/cache.py).  Each case is a scenario run twice on the same seeded
numpy inputs: once over the port's modules and once over the
reference's.  Every assertion of the original case holds on both runs,
and the two runs must give equal observations (lookups, scans, blobs,
manifests, level shapes) and byte-equal storage images, so the port
writes the reference's blocks.

The k-way merge: the port's native merge (csrc/host/tb_lsm.inc) against
the reference's native merge and against the port's numpy merge under
TB_FASTPATH_DISABLE=1, and a broken build of the library raising.
"""

import importlib
import shutil
import types as pytypes

import numpy as np
import pytest

from tigerbeetle_tpu.runtime import fastpath as ref_fastpath
from tigerbeetle_tpu_torch.kernels import host_build
from tigerbeetle_tpu_torch.runtime import fastpath

_MODULES = {
    "cfg": "constants",
    "ewah": "lsm.ewah",
    "runs": "lsm.runs",
    "tree": "lsm.tree",
    "forest": "lsm.forest",
    "manifest_log": "lsm.manifest_log",
    "scan_builder": "lsm.scan_builder",
    "free_set": "vsr.free_set",
    "grid": "vsr.grid",
    "storage": "vsr.storage",
    "cache": "utils.cache",
}


def _package(root: str):
    return pytypes.SimpleNamespace(
        **{k: importlib.import_module(f"{root}.{v}") for k, v in _MODULES.items()}
    )


PORT = _package("tigerbeetle_tpu_torch")
REF = _package("tigerbeetle_tpu")


class Image:
    """A MemoryStorage's written pages, compared as bytes."""

    def __init__(self, storage):
        self.pages = {k: bytes(v) for k, v in storage._pages.items()}

    def __eq__(self, other):
        return isinstance(other, Image) and self.pages == other.pages

    def __repr__(self):
        return f"Image({len(self.pages)} pages)"


def _same(a, b, what="obs"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert a == b, what


def both(scenario, *args):
    """Run `scenario(m, *args)` over the port and the reference; the
    observations must be equal."""
    got = scenario(PORT, *args)
    want = scenario(REF, *args)
    _same(got, want)
    return got


def storage(m, grid_size=1 << 22):
    return m.storage.MemoryStorage(
        m.storage.ZoneLayout(config=m.cfg.TEST_MIN, grid_size=grid_size)
    )


def grid(m, block_size=4096, block_count=1 << 10):
    return m.grid.Grid(storage(m), block_size=block_size, block_count=block_count)


def keys_of(m, ids):
    ids = np.asarray(ids, np.uint64)
    return m.runs.pack_u128(ids, np.zeros(len(ids), np.uint64))


def levels(tree):
    return [[(r.id, [b.address for b in r.blocks]) for r in lvl] for lvl in tree.levels]


# ----------------------------------------------------------------------
# tests/test_lsm.py


def _ewah(m, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    words = np.zeros(n, np.uint64)
    for _ in range(10):
        at = int(rng.integers(n))
        ln = int(rng.integers(1, 30))
        kind = rng.integers(3)
        if kind == 0:
            words[at : at + ln] = 0
        elif kind == 1:
            words[at : at + ln] = np.uint64(0xFFFFFFFFFFFFFFFF)
        else:
            words[at : at + ln] = rng.integers(1, 1 << 63, min(ln, n - at), dtype=np.uint64)
    encoded = m.ewah.encode(words)
    np.testing.assert_array_equal(m.ewah.decode(encoded, n), words)
    uniform = m.ewah.encode(np.zeros(1000, np.uint64))
    assert len(uniform) == 8
    return [np.asarray(encoded), np.asarray(uniform)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewah_roundtrip(seed):
    both(_ewah, seed)


def _free_set(m):
    fs = m.free_set.FreeSet(64)
    r1 = fs.reserve(4)
    r2 = fs.reserve(4)
    a = [fs.acquire(r1), fs.acquire(r2), fs.acquire(r1)]
    assert len(set(a)) == 3
    fs.forfeit(r1)
    fs.forfeit(r2)
    assert fs.count_free() == 61
    fs.release(a[0])
    assert not fs.is_free(a[0])
    fs.checkpoint()
    assert fs.is_free(a[0])
    blob = fs.encode()
    fs2 = m.free_set.FreeSet.decode(blob, 64)
    np.testing.assert_array_equal(fs2.free, fs.free)
    return [a, bytes(blob), fs.free.copy()]


def test_free_set_reserve_acquire_forfeit():
    both(_free_set)


def _grid_blocks(m):
    g = grid(m)
    fs = g.free_set
    r = fs.reserve(2)
    a1, a2 = fs.acquire(r), fs.acquire(r)
    fs.forfeit(r)
    g.write_block(a1, b"hello world")
    g.write_block(a2, b"x" * 1000)
    g.flush_writes()
    image = Image(g.storage)
    assert g.read_block(a1) == b"hello world"
    assert g.verify_block(a2)
    g.storage.corrupt_sector(g._offset(a2))
    assert not g.verify_block(a2)
    assert g.read_block(a2) == b"x" * 1000
    g._cache.remove(a2)
    with pytest.raises(RuntimeError):
        g.read_block(a2)
    return [a1, a2, image]


def test_grid_blocks_checksummed():
    both(_grid_blocks)


def _tree_across_seals(m):
    t = m.tree.Tree(grid(m), "t", value_size=8, memtable_max=64)
    rng = np.random.default_rng(0)
    all_ids = rng.permutation(np.arange(1, 2001, dtype=np.uint64))
    for at in range(0, 2000, 50):
        chunk = all_ids[at : at + 50]
        t.put_batch(keys_of(m, chunk), chunk.astype("<u8").view("V8"))
        t.maybe_seal()
    assert any(t.levels[i] for i in range(7))
    probe = rng.permutation(np.arange(1, 3001, dtype=np.uint64))
    found, values = t.lookup_batch(keys_of(m, probe))
    expect = probe <= 2000
    np.testing.assert_array_equal(found, expect)
    got = values.view("<u8").reshape(-1)[expect]
    np.testing.assert_array_equal(got, probe[expect])
    t.grid.flush_writes()
    return [found, np.asarray(values), levels(t), Image(t.grid.storage)]


def test_tree_put_lookup_across_seals():
    both(_tree_across_seals)


def _tree_overwrite(m):
    t = m.tree.Tree(grid(m), "t", value_size=8, memtable_max=16)
    ids = np.arange(1, 101, dtype=np.uint64)
    t.put_batch(keys_of(m, ids), ids.astype("<u8").view("V8"))
    t.seal_memtable()
    t.put_batch(keys_of(m, ids), (ids * 7).astype("<u8").view("V8"))
    t.seal_memtable()
    found, values = t.lookup_batch(keys_of(m, ids))
    assert found.all()
    np.testing.assert_array_equal(values.view("<u8").reshape(-1), ids * 7)
    t.grid.flush_writes()
    return [np.asarray(values), levels(t), Image(t.grid.storage)]


def test_tree_overwrite_newest_wins():
    both(_tree_overwrite)


def _tree_tombstones(m):
    t = m.tree.Tree(grid(m), "t", value_size=8, memtable_max=16)
    ids = np.arange(1, 101, dtype=np.uint64)
    t.put_batch(keys_of(m, ids), ids.astype("<u8").view("V8"))
    t.seal_memtable()
    t.remove_batch(keys_of(m, ids[:50]))
    t.seal_memtable()
    found, _ = t.lookup_batch(keys_of(m, ids))
    np.testing.assert_array_equal(found, ids > 50)
    for _ in range(20):
        t.put_batch(keys_of(m, ids[50:]), ids[50:].astype("<u8").view("V8"))
        t.seal_memtable()
    found, _ = t.lookup_batch(keys_of(m, ids))
    np.testing.assert_array_equal(found, ids > 50)
    t.grid.flush_writes()
    return [found, levels(t), Image(t.grid.storage)]


def test_tree_tombstones():
    both(_tree_tombstones)


def _tree_scan_range(m):
    t = m.tree.Tree(grid(m), "t", value_size=8, memtable_max=32)
    ids = np.arange(1, 301, dtype=np.uint64)
    t.put_batch(keys_of(m, ids), ids.astype("<u8").view("V8"))
    t.seal_memtable()
    t.put_batch(keys_of(m, np.array([500], np.uint64)), np.array([500], "<u8").view("V8"))
    keys, values = t.scan_range(keys_of(m, [100]).tobytes(), keys_of(m, [200]).tobytes())
    assert len(keys) == 101
    np.testing.assert_array_equal(values.view("<u8").reshape(-1), np.arange(100, 201))
    return [np.asarray(keys), np.asarray(values)]


def test_tree_scan_range():
    both(_tree_scan_range)


def _merge_newest_first(m):
    v = lambda a: np.asarray(a, "<u8").view(np.uint8).reshape(-1, 8)  # noqa: E731
    newest = (keys_of(m, [1, 2, 3]), np.zeros(3, np.uint8), v([10, 20, 30]))
    oldest = (keys_of(m, [2, 3, 4]), np.zeros(3, np.uint8), v([99, 99, 40]))
    keys, flags, vals = m.tree.k_way_merge_flags([newest, oldest], 8)
    np.testing.assert_array_equal(vals.view("<u8").reshape(-1), [10, 20, 30, 40])
    return [keys, flags, vals]


def test_k_way_merge_newest_first():
    both(_merge_newest_first)


def _groove_forest(m):
    st = storage(m)
    f = m.forest.Forest(st, block_size=4096, block_count=1 << 10, memtable_max=64)
    g = f.groove("transfers", object_size=128, index_fields=["ledger", "code"])
    n = 500
    ids = np.arange(1, n + 1, dtype=np.uint64)
    ts = ids * 10
    objects = np.zeros((n, 128), np.uint8)
    objects[:, 0] = (ids & 0xFF).astype(np.uint8)
    ledgers = np.where(ids % 2 == 0, 7, 8).astype(np.uint64)
    codes = np.full(n, 3, np.uint64)
    g.insert_batch(ids, np.zeros(n, np.uint64), ts, objects, {"ledger": ledgers, "code": codes})
    found, got_ts = g.lookup_ids(ids[:10], np.zeros(10, np.uint64))
    assert found.all()
    np.testing.assert_array_equal(got_ts, ts[:10])
    found, objs = g.get_objects(ts[:10])
    assert found.all()
    np.testing.assert_array_equal(objs[:, 0], ids[:10] & 0xFF)
    scan = g.index_scan("ledger", 7)
    np.testing.assert_array_equal(scan, ts[ids % 2 == 0])
    inter = g.index_intersect([g.index_scan("ledger", 7), g.index_scan("code", 3)])
    np.testing.assert_array_equal(inter, ts[ids % 2 == 0])
    blob = f.checkpoint()
    f2 = m.forest.Forest(st, block_size=4096, block_count=1 << 10, memtable_max=64)
    f2.groove("transfers", object_size=128, index_fields=["ledger", "code"])
    f2.open(blob)
    g2 = f2.grooves["transfers"]
    found, got_ts = g2.lookup_ids(ids, np.zeros(n, np.uint64))
    assert found.all()
    np.testing.assert_array_equal(got_ts, ts)
    np.testing.assert_array_equal(g2.index_scan("ledger", 8), ts[ids % 2 == 1])
    return [bytes(blob), np.asarray(scan), np.asarray(inter), np.asarray(objs), Image(st)]


def test_groove_end_to_end_with_forest_checkpoint():
    both(_groove_forest)


def _tree_scales(m):
    t = m.tree.Tree(grid(m, block_count=1 << 12), "big", value_size=8, memtable_max=256)
    rng = np.random.default_rng(3)
    ids = rng.permutation(np.arange(1, 20_001, dtype=np.uint64))
    for at in range(0, len(ids), 256):
        chunk = ids[at : at + 256]
        t.put_batch(keys_of(m, chunk), chunk.astype("<u8").view("V8"))
        t.maybe_seal()
    probe = rng.choice(ids, 1000, replace=False)
    found, values = t.lookup_batch(keys_of(m, probe))
    assert found.all()
    np.testing.assert_array_equal(values.view("<u8").reshape(-1), probe)
    t.grid.flush_writes()
    return [np.asarray(values), levels(t), Image(t.grid.storage)]


def test_tree_scales_past_memtable():
    both(_tree_scales)


def _scan_fixture(m, seed=0, n=500):
    rng = np.random.default_rng(seed)
    f = m.forest.Forest(storage(m), block_size=4096, block_count=1 << 12)
    g = f.groove("things", object_size=16, index_fields=["color", "size"])
    ts = np.arange(1, n + 1, dtype=np.uint64)
    color = rng.integers(1, 5, n).astype(np.uint64)
    size = rng.integers(1, 4, n).astype(np.uint64)
    objects = np.zeros((n, 16), np.uint8)
    objects[:, 0] = color
    objects[:, 1] = size
    objects[:, 2:10] = ts.astype("<u8").view(np.uint8).reshape(n, 8)
    g.insert_batch(ts, np.zeros(n, np.uint64), ts, objects, {"color": color, "size": size})
    return g, ts, color, size


def _scan_eq(m):
    g, ts, color, _size = _scan_fixture(m)
    b = m.scan_builder.ScanBuilder(g)
    got = b.evaluate(b.eq("color", 3))
    np.testing.assert_array_equal(got, ts[color == 3])
    return [np.asarray(got)]


def test_scan_builder_eq_matches_bruteforce():
    both(_scan_eq)


def _scan_compound(m):
    g, ts, color, size = _scan_fixture(m, seed=1)
    b = m.scan_builder.ScanBuilder(g)
    expr = b.intersect(b.union(b.eq("color", 1), b.eq("color", 2)), b.eq("size", 3))
    got = b.evaluate(expr, ts_min=100, ts_max=400, reversed=True, limit=7)
    mask = ((color == 1) | (color == 2)) & (size == 3) & (ts >= 100) & (ts <= 400)
    want = ts[mask][::-1][:7]
    np.testing.assert_array_equal(got, want)
    rows = m.scan_builder.ScanLookup(g).fetch(got)
    assert rows.shape == (len(got), 16)
    np.testing.assert_array_equal(rows[:, 2:10].copy().view("<u8").reshape(-1), want)
    return [np.asarray(got), np.asarray(rows)]


def test_scan_builder_union_intersect_range_direction_limit():
    both(_scan_compound)


def _scan_after_compaction(m):
    g, ts, color, size = _scan_fixture(m, seed=2, n=300)
    for t in (g.id_tree, g.object_tree, *g.indexes.values()):
        t.seal_memtable()
        t.compact()
    b = m.scan_builder.ScanBuilder(g)
    got = b.evaluate(b.union(b.eq("color", 4), b.eq("size", 2)))
    np.testing.assert_array_equal(got, ts[(color == 4) | (size == 2)])
    return [np.asarray(got), [levels(t) for t in (g.id_tree, g.object_tree)]]


def test_scan_builder_survives_seal_and_compaction():
    both(_scan_after_compaction)


def _cache_basics(m):
    c = m.cache.SetAssociativeCache(capacity=16, ways=4)
    for k in range(8):
        c.put(k, k * 10)
    for k in range(8):
        assert c.get(k) == k * 10
    c.put(3, 999)
    assert c.get(3) == 999
    c.remove(3)
    assert c.get(3) is None and 3 not in c
    return [c.hits, c.misses]


def test_set_associative_cache_basics():
    both(_cache_basics)


def _cache_clock(m):
    c = m.cache.SetAssociativeCache(capacity=16, ways=4)
    for k in range(128):
        c.put(k, k)
    survivors = [k for k in range(128) if k in c]
    assert len(survivors) <= 16
    hits_before = c.hits
    for k in survivors:
        assert c.get(k) == k
    assert c.hits == hits_before + len(survivors)
    return [survivors, c.hits, c.misses]


def test_set_associative_cache_bounded_with_clock_eviction():
    both(_cache_clock)


def _grid_cache(m):
    g = grid(m)
    fs = g.free_set
    res = fs.reserve(4)
    addrs = [fs.acquire(res) for _ in range(4)]
    fs.forfeit(res)
    for a in addrs:
        g.write_block(a, bytes([a]) * 50)
    before = g._cache.misses
    for a in addrs:
        assert g.read_block(a) == bytes([a]) * 50
    assert g._cache.misses == before
    g.flush_writes()
    return [addrs, Image(g.storage)]


def test_grid_cache_is_set_associative():
    both(_grid_cache)


# ----------------------------------------------------------------------
# tests/test_manifest_log.py


def make_forest(m, st=None):
    st = st or storage(m, 1 << 20)
    f = m.forest.Forest(st, memtable_max=64)
    f.groove("things", object_size=32, index_fields=["field"], index_value_size=8)
    return st, f


def put_batch(groove, start, n):
    ids = np.arange(start, start + n, dtype=np.uint64)
    groove.insert_batch(
        ids, np.zeros(n, np.uint64), ids * 10, np.full((n, 32), 7, np.uint8), {"field": ids % 5},
    )


def _appends_only_delta(m):
    st, f = make_forest(m)
    g = f.grooves["things"]
    put_batch(g, 1, 200)
    blob1 = f.checkpoint()
    blocks_1 = list(f.mlog.blocks)
    assert blocks_1
    put_batch(g, 201, 200)
    blob2 = f.checkpoint()
    blocks_2 = list(f.mlog.blocks)
    assert len(blocks_2) >= len(blocks_1)
    assert blocks_2[: len(blocks_1)] == blocks_1
    f.grid.flush_writes()
    return [bytes(blob1), bytes(blob2), blocks_1, blocks_2, Image(st)]


def test_checkpoint_appends_only_delta():
    both(_appends_only_delta)


def _replay_matches_live(m):
    st, f = make_forest(m)
    g = f.grooves["things"]
    for k in range(6):
        put_batch(g, 1 + k * 300, 300)
        f.checkpoint()
    blob = f.checkpoint()
    _, f2 = make_forest(m, st)
    f2.open(blob)
    g2 = f2.grooves["things"]
    ids = np.array([1, 500, 1200, 1799], np.uint64)
    found1, ts1 = g.lookup_ids(ids, np.zeros(4, np.uint64))
    found2, ts2 = g2.lookup_ids(ids, np.zeros(4, np.uint64))
    np.testing.assert_array_equal(found1, found2)
    np.testing.assert_array_equal(ts1, ts2)
    live = [levels(t) for t in f._trees]
    assert live == [levels(t) for t in f2._trees]
    f.grid.flush_writes()
    return [bytes(blob), np.asarray(ts2), live, Image(st)]


def test_replay_matches_live_state():
    both(_replay_matches_live)


def _self_compaction(m):
    st, f = make_forest(m)
    g = f.grooves["things"]
    for _round in range(30):
        put_batch(g, 1, 128)
        f.checkpoint()
    live_runs = sum(len(lvl) for t in f._trees for lvl in t.levels)
    assert f.mlog._events_total <= 2 * max(live_runs, 8) + 16
    blob = f.checkpoint()
    _, f2 = make_forest(m, st)
    f2.open(blob)
    ids = np.arange(1, 129, dtype=np.uint64)
    found, _ts = f2.grooves["things"].lookup_ids(ids, np.zeros(len(ids), np.uint64))
    assert found.all()
    f.grid.flush_writes()
    return [bytes(blob), f.mlog._events_total, live_runs, Image(st)]


def test_self_compaction_bounds_log():
    both(_self_compaction)


def _mid_interval_snapshot(m):
    st, f = make_forest(m)
    g = f.grooves["things"]
    put_batch(g, 1, 200)
    f.checkpoint()
    put_batch(g, 201, 200)
    blob = f.manifest_blob()
    assert len(f.mlog._tail) > 0 or f.mlog.blocks
    _, f2 = make_forest(m, st)
    f2.open(blob)
    found, ts = f2.grooves["things"].lookup_ids(
        np.array([1, 250, 400], np.uint64), np.zeros(3, np.uint64)
    )
    assert found.all()
    return [bytes(blob), np.asarray(ts)]


def test_mid_interval_snapshot_carries_tail():
    both(_mid_interval_snapshot)


def _oversized_run(m):
    st = storage(m)
    g = m.grid.Grid(st, block_size=4096, block_count=1 << 9)
    mlog = m.manifest_log.ManifestLog(g)
    refs = [(1000 + i, 7, b"\x01" * 16, b"\x02" * 16) for i in range(300)]
    mlog.run_add(5, 0, 1, refs)
    addresses = mlog.checkpoint()
    replayed = m.manifest_log.ManifestLog(g).open(addresses)
    assert list(replayed.keys()) == [(5, 0, 1)]
    got = replayed[(5, 0, 1)]
    assert [r[0] for r in got] == [1000 + i for i in range(300)]
    g.flush_writes()
    return [list(addresses), [list(r) for r in got], Image(st)]


def test_oversized_run_splits_to_block_capacity():
    both(_oversized_run)


# ----------------------------------------------------------------------
# tests/test_compaction_pacing.py


def make_tree(m, memtable_max=64, value_size=8):
    g = m.grid.Grid(storage(m), block_size=1 << 12, block_count=1 << 10)
    return m.tree.Tree(g, "t", value_size=value_size, memtable_max=memtable_max)


def put_range(m, tree, lo, hi, tag):
    keys = m.runs.pack_u128(np.arange(lo, hi, dtype=np.uint64), np.zeros(hi - lo, np.uint64))
    tree.put_batch(keys, np.full(hi - lo, tag, np.uint64))


def check_values(m, tree, expect: dict):
    ids = np.fromiter(expect.keys(), np.uint64)
    keys = m.runs.pack_u128(ids, np.zeros(len(ids), np.uint64))
    found, vals = tree.lookup_batch(np.asarray(keys, m.runs.KEY_DTYPE))
    assert found.all()
    assert (vals.view(np.uint64).reshape(-1) == np.fromiter(expect.values(), np.uint64)).all()
    return np.asarray(vals)


def _beats_bounded(m):
    tree = make_tree(m)
    expect = {}
    growth = m.tree.GROWTH
    for round_ in range(growth * 3):
        lo = (round_ % 4) * 100
        put_range(m, tree, lo, lo + 64, tag=round_)
        expect.update({k: round_ for k in range(lo, lo + 64)})
        tree.seal_memtable()
    assert tree.compaction_pending()
    used_log = []
    while tree.compaction_pending():
        used = tree.compact_beat(4)
        assert used <= 4
        used_log.append(used)
        assert len(used_log) < 10_000
        if len(used_log) % 7 == 0:
            check_values(m, tree, expect)
    vals = check_values(m, tree, expect)
    for level in range(len(tree.levels) - 1):
        assert len(tree.levels[level]) <= tree._level_run_max(level)
    tree.grid.flush_writes()
    return [used_log, vals, levels(tree), Image(tree.grid.storage)]


def test_beats_are_bounded_and_reads_stay_correct():
    both(_beats_bounded)


def _seals_during_job(m):
    tree = make_tree(m)
    expect = {}
    for round_ in range(m.tree.GROWTH + 1):
        put_range(m, tree, 0, 64, tag=round_)
        expect.update({k: round_ for k in range(64)})
        tree.seal_memtable()
    assert tree.compaction_pending()
    tree.compact_beat(2)
    put_range(m, tree, 1000, 1064, tag=77)
    expect.update({k: 77 for k in range(1000, 1064)})
    tree.seal_memtable()
    put_range(m, tree, 0, 8, tag=99)
    expect.update({k: 99 for k in range(8)})
    tree.seal_memtable()
    while tree.compaction_pending():
        tree.compact_beat(3)
    tree.grid.flush_writes()
    return [check_values(m, tree, expect), levels(tree), Image(tree.grid.storage)]


def test_seals_during_job_survive():
    both(_seals_during_job)


def _tombstones_last_level(m):
    tree = make_tree(m, memtable_max=32)
    put_range(m, tree, 0, 32, tag=1)
    tree.seal_memtable()
    keys = m.runs.pack_u128(np.arange(0, 16, dtype=np.uint64), np.zeros(16, np.uint64))
    tree.remove_batch(np.asarray(keys, m.runs.KEY_DTYPE))
    tree.seal_memtable()
    for _ in range(m.tree.GROWTH):
        put_range(m, tree, 100, 132, tag=2)
        tree.seal_memtable()
    while tree.compaction_pending():
        tree.compact_beat(4)
    found, _ = tree.lookup_batch(np.asarray(keys, m.runs.KEY_DTYPE))
    assert not found.any()
    tree.grid.flush_writes()
    return [check_values(m, tree, {k: 1 for k in range(16, 32)}), levels(tree),
            Image(tree.grid.storage)]


def test_tombstones_drop_only_at_last_level():
    both(_tombstones_last_level)


def _forest_fixture(m):
    st = storage(m)
    f = m.forest.Forest(st, block_size=1 << 12, block_count=1 << 10, memtable_max=64)
    f.groove("obj", object_size=16, index_fields=[])
    return st, f


def _fill(forest, rounds, rng):
    g = forest.grooves["obj"]
    objs_by_id = {}
    for round_ in range(rounds):
        ids = np.arange(1 + round_ * 64, 1 + round_ * 64 + 64, dtype=np.uint64)
        objs = rng.integers(0, 2**63, (64, 2), np.uint64)
        ts = (np.arange(64, dtype=np.uint64) + np.uint64(1)) * np.uint64(1000) + np.uint64(round_)
        g.insert_batch(ids, np.zeros(64, np.uint64), ts, objs.view(np.uint8), {})
        for i, v in zip(ids, objs):
            objs_by_id[int(i)] = v
    return objs_by_id


def _check_objects(forest, objs_by_id):
    g = forest.grooves["obj"]
    ids = np.fromiter(objs_by_id.keys(), np.uint64)
    found, ts = g.lookup_ids(ids, np.zeros(len(ids), np.uint64))
    assert found.all()
    found2, objs = g.get_objects(ts)
    assert found2.all()
    want = np.stack([objs_by_id[int(i)] for i in ids])
    assert (objs.view(np.uint64).reshape(len(ids), 2) == want).all()
    return np.asarray(objs)


def _checkpoint_drains(m):
    st, forest = _forest_fixture(m)
    objs_by_id = _fill(forest, m.tree.GROWTH * 2, np.random.default_rng(3))
    forest.compact_beat(4)
    assert any(t._job is not None for t in forest._trees)
    blob = forest.checkpoint()
    assert all(t._job is None for t in forest._trees)
    first = _check_objects(forest, objs_by_id)
    while forest.compaction_pending():
        forest.compact_beat(8)
    forest.grid.flush_writes()
    return [bytes(blob), first, _check_objects(forest, objs_by_id), Image(st)]


def test_checkpoint_drains_active_jobs_only():
    both(_checkpoint_drains)


def _orphan_reclaim(m):
    st, forest = _forest_fixture(m)
    objs_by_id = _fill(forest, m.tree.GROWTH * 2, np.random.default_rng(3))
    forest.compact_beat(4)
    assert any(t._job is not None for t in forest._trees)
    blob = forest.manifest_blob()
    forest2 = m.forest.Forest(st, block_size=1 << 12, block_count=1 << 10, memtable_max=64)
    forest2.groove("obj", object_size=16, index_fields=[])
    forest2.open(blob)
    assert all(t._job is None for t in forest2._trees)
    _check_objects(forest2, objs_by_id)
    while forest2.compaction_pending():
        forest2.compact_beat(8)
    blob2 = forest2.checkpoint()
    forest2.grid.flush_writes()
    return [bytes(blob), bytes(blob2), _check_objects(forest2, objs_by_id), Image(st)]


def test_midinterval_snapshot_orphan_reclaim():
    both(_orphan_reclaim)


# ----------------------------------------------------------------------
# The native k-way merge.


def _streams(seed, k=5, value_size=9):
    """k sorted-unique overlapping streams, stream 0 newest, with
    tombstone flags on some entries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(0, 400))
        ids = np.unique(rng.integers(0, 1000, n).astype(np.uint64))
        hi = rng.integers(0, 2, len(ids)).astype(np.uint64)  # both key words vary
        keys = PORT.runs.pack_u128(ids, hi)
        keys = np.sort(keys)
        flags = (rng.random(len(keys)) < 0.2).astype(np.uint8)
        vals = rng.integers(0, 256, (len(keys), value_size), np.uint8)
        out.append((keys, flags, vals))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_merge_equals_reference_and_numpy(seed, monkeypatch):
    streams = _streams(seed)
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    native = fastpath.kway_merge(streams, 9)
    ref = ref_fastpath.kway_merge(streams, 9)
    assert ref is not None, "the reference's native library did not load"
    _same(list(native), list(ref))
    assert fastpath.available()
    _same(list(PORT.tree.k_way_merge_flags(streams, 9)), list(native))
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    numpy_merge = PORT.tree.k_way_merge_flags(streams, 9)
    _same(list(numpy_merge), list(native))
    # Newest first: every merged key carries the entry of the lowest
    # stream index that holds it.
    index = [{k.tobytes(): j for j, k in enumerate(s[0])} for s in streams]
    for i, key in enumerate(native[0]):
        owner = next(n for n, ix in enumerate(index) if key.tobytes() in ix)
        j = index[owner][key.tobytes()]
        assert streams[owner][2][j].tobytes() == native[2][i].tobytes()
        assert streams[owner][1][j] == native[1][i]


def test_broken_merge_build_raises(tmp_path, monkeypatch):
    """The merge takes the native library; a library that does not build
    raises instead of falling back to the numpy merge."""
    src = tmp_path / "src"
    shutil.copytree(host_build.HOST_SRC, src)
    inc = src / "tb_lsm.inc"
    inc.write_text("#error deliberately broken merge\n" + inc.read_text())
    monkeypatch.setattr(host_build, "HOST_SRC", src)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("TB_FASTPATH_DISABLE", raising=False)
    streams = _streams(5, k=2)
    with pytest.raises(fastpath.NativeFastpathError, match="deliberately broken merge"):
        PORT.tree.k_way_merge_flags(streams, 9)
    monkeypatch.setenv("TB_FASTPATH_DISABLE", "1")
    assert len(PORT.tree.k_way_merge_flags(streams, 9)[0])
