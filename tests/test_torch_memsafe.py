"""tools/memsafe.py, the guard-band and repeat check of K1-K14 and the
launchers, run on the CPU over the plain versions (on a card it checks
the kernels: chip_smoke.py's memsafe phase).

- Every row of chip_smoke.py's kernels line runs its small cases twice
  (two guard patterns) and its contention case again: no guard band
  changes and the outputs are equal bit for bit.
- A faulty plain function that stores one element past its output (or
  before it) is caught by the band it lands in; one that reads one
  element past its input is caught by the outputs that differ under the
  two patterns.
- On the card a case's bands count as watched only for the ring, the
  buffer a binding takes as a raw address.
- The launch-level guard (the card's): a raw binding replaced by a fake
  that stores past an argument is caught, the views are copied back to
  the arguments, and the real bindings are restored.
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.tools import memsafe

ROWS = memsafe.rows()
CPU = torch.device("cpu")


def test_rows_are_the_kernels_line():
    names = [r.name for r in ROWS]
    assert len(names) == 24 and len(set(names)) == 24
    assert set(names) == set(kernels.launches)
    for row in ROWS:
        assert row.contention in row.cases


@pytest.mark.parametrize("row", ROWS, ids=[r.name for r in ROWS])
def test_plain_version_is_clean(row):
    res = memsafe.check_row(row, CPU, repeats=2, quick=True)
    assert res.findings == [], res.findings
    assert res.cases >= 2 and res.repeats == 2 and res.watched > 0
    assert res.line().endswith(": clean")


def _row(fn):
    return memsafe.Row("faulty", {"only": fn}, "only")


def test_store_past_the_output_is_caught():
    def store_past(put):
        src = put("src", np.arange(64, dtype=np.int64))
        out = put("out", np.zeros(64, np.int64))
        wide = torch.as_strided(out, (65,), (1,))
        wide[:64] = src * 2
        wide[64] = 7
        return {"out": out}

    res = memsafe.check_row(_row(store_past), CPU, repeats=2)
    assert res.findings
    assert "store outside out: after guard changed at byte 512" in res.findings[0]


def test_store_before_the_output_is_caught():
    def store_before(put):
        out = put("out", np.zeros(64, np.int32))
        torch.as_strided(out, (1,), (1,), out.storage_offset() - 1)[0] = 1
        return {"out": out}

    res = memsafe.check_row(_row(store_before), CPU, repeats=2)
    assert "store outside out: before guard changed at byte -4" in res.findings[0]


def test_read_past_the_input_is_caught():
    def read_past(put):
        src = put("src", np.arange(64, dtype=np.int64))
        out = put("out", np.zeros(64, np.int64))
        out.copy_(torch.as_strided(src, (64,), (1,), src.storage_offset() + 1))
        return {"out": out}

    res = memsafe.check_row(_row(read_past), CPU, repeats=2)
    assert any("second guard pattern: out differs" in f for f in res.findings), res.findings


def test_unaligned_views_keep_their_offset():
    arena = memsafe.Arena(CPU, 1)
    view = arena.put("t", np.arange(10, dtype=np.int64), offset=8)
    assert view.data_ptr() % 16 == 8 and view.tolist() == list(range(10))
    assert memsafe.GUARD_BYTES % 256 == 0 and arena.watched == 2 * memsafe.GUARD_BYTES
    assert arena.check() == []


def test_card_counts_only_the_case_bands_a_launch_can_reach():
    """With the launches guarded (the card), a case's bands count only
    for the buffers a binding takes as a raw address (the ring): the
    launch copies every other one.  On the CPU every band counts."""
    case = next(r for r in ROWS if r.name == "orderfree").cases["one_row"]
    _, found, plain = memsafe.run_once("orderfree", case, CPU, 1)
    _, found_guarded, guarded = memsafe.run_once("orderfree", case, CPU, 1, memsafe.Launches())
    assert found == found_guarded == []
    assert memsafe.RAW_POINTER_BUFFERS == ("ring",)
    assert plain == 4 * 2 * memsafe.GUARD_BYTES  # table, ring, meta, pk
    assert guarded == 2 * memsafe.GUARD_BYTES  # the ring's


def test_launch_guard_catches_a_binding_that_stores_past(monkeypatch):
    def fake_checksum(table, out, row0=0):
        out.fill_(int(table.sum()))
        torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 5

    monkeypatch.setattr(kernels, "checksum", fake_checksum)
    state = memsafe.Launches()
    table, out = torch.ones((4, 8), dtype=torch.int64), torch.zeros(2, dtype=torch.int64)
    with memsafe.install(state):
        kernels.checksum(table, out)
    assert kernels.checksum is fake_checksum
    assert out.tolist() == [32, 32]  # the view's result copied back
    assert state.calls == 1 and state.watched == 4 * memsafe.GUARD_BYTES
    assert state.findings == [
        "checksum launch: store outside argument 1: after guard changed at byte 16 of "
        "the buffer"]


def test_launch_guard_copies_scratch_objects(monkeypatch):
    class Scratch:
        def __init__(self):
            self.words = torch.zeros(8, dtype=torch.int64)
            self.batch = 8

    seen = {}

    def fake_linked(table, meta, ring_row, pk, n, small, scratch, count_as="linked",
                    stamps=None):
        seen["scratch"] = scratch
        scratch.words += 3

    monkeypatch.setattr(kernels, "linked", fake_linked)
    scratch = Scratch()
    with memsafe.install(memsafe.Launches()) as state:
        kernels.linked(torch.zeros((2, 8), dtype=torch.int64),
                       torch.zeros((2, 2), dtype=torch.int32),
                       0, torch.zeros((4, 8), dtype=torch.int64), 4, False, scratch)
    assert seen["scratch"] is not scratch and seen["scratch"].batch == 8
    assert scratch.words.tolist() == [3] * 8 and state.findings == []
