"""The launch path of the kernel bindings (``tigerbeetle_tpu_torch.
kernels``), on the CPU: each library function is replaced by a ctypes
callback built from the binding's own signature, so every argument goes
through the same ctypes conversion as on the card.

- every binding passes exactly its signature's arguments, the current
  stream's raw handle last, and counts one launch;
- K10 and K14 scatter pass their tensors' data pointers and sizes;
- the current device is switched only when the tensors lie on another
  card, and back after;
- a non-zero status raises RuntimeError and counts nothing;
- nothing CUDA-only is looked up when the module is imported.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from tigerbeetle_tpu_torch import kernels

STREAM = 0x5EED0


def _z(shape, dtype=torch.int64):
    return torch.zeros(shape, dtype=dtype)


T, M, V, PK = _z((16, 8)), _z((16, 2), torch.int32), _z(16), _z((4, 16))
SC = SimpleNamespace(slot_idx=V, words=V, batch=4)

# binding name -> (library, symbol, a call of the binding on CPU tensors)
CALLS = {
    "orderfree": ("orderfree", "tb_orderfree",
                  lambda: kernels.orderfree(T, M, 4096, PK, 2, 5, 7, SC)),
    "linked": ("linked", "tb_linked", lambda: kernels.linked(T, M, 4096, PK, 5, True, SC)),
    "two_phase": ("two_phase", "tb_two_phase",
                  lambda: kernels.two_phase(T, M, 4096, PK, 5, False, SC)),
    "commit_hash_all": ("commitment", "tb_commit_hash_all",
                        lambda: kernels.commit_hash_all(T, M, V, None, V, "commit_rebuild")),
    "commit_update": ("commitment", "tb_commit_update",
                      lambda: kernels.commit_update(T, M, V, V, V, V)),
    "commit_admit": ("commitment", "tb_commit_admit",
                     lambda: kernels.commit_admit(V, V, V, V, V)),
    "tier_set_rows": ("tier", "tb_tier_set_rows", lambda: kernels.tier_set_rows(T, V, T)),
    "checksum": ("checksum", "tb_checksum", lambda: kernels.checksum(T, V, 32)),
    "exact_scan": ("exact_scan", "tb_exact_scan",
                   lambda: kernels.exact_scan(T, PK, V, 5, 7, V, PK)),
    "apply_deltas": ("apply_deltas", "tb_apply_deltas", lambda: kernels.apply_deltas(T, PK)),
    "exact_init": ("exact_scan", "tb_exact_init", lambda: kernels.exact_init(V, V)),
    "exact_segment": ("exact_scan", "tb_exact_segment",
                      lambda: kernels.exact_segment(T, PK, V, 5, 7, V)),
    "exact_finalize": ("exact_scan", "tb_exact_finalize",
                       lambda: kernels.exact_finalize(T, 16, V, None, PK)),
    "wave_step": ("wave_step", "tb_wave_step",
                  lambda: kernels.wave_step(T, PK, V, None, 5, 7, V)),
    "chain_wave": ("chain_wave", "tb_chain_wave",
                   lambda: kernels.chain_wave(T, PK, PK, 5, 7, V)),
    "spec_conflicts": ("spec_conflicts", "tb_spec_conflicts",
                       lambda: kernels.spec_conflicts(PK, V, None, 5, 16, V, V, V, V, 3, True,
                                                      V)),
    "shard_accumulate": ("shard_apply", "tb_shard_accumulate",
                         lambda: kernels.shard_accumulate(T, 0, V, V, V, V, V, None)),
    "shard_admit": ("shard_apply", "tb_shard_admit",
                    lambda: kernels.shard_admit(T, T, 0, V, V, V)),
    "shard_apply": ("shard_apply", "tb_shard_apply", lambda: kernels.shard_apply(T, T)),
    "shard_gather": ("shard_rows", "tb_shard_gather",
                     lambda: kernels.shard_gather(T, 16, V, T)),
    "shard_scatter": ("shard_rows", "tb_shard_scatter",
                      lambda: kernels.shard_scatter(T, 16, V, T)),
}


@pytest.fixture
def fake_cuda(monkeypatch):
    """Every library function replaced by a ctypes callback of its own
    signature that records its arguments and returns `state.rc`; the
    current device is `state.current`, the raw stream STREAM + index,
    and torch.cuda.device a recorder of the devices it switches to."""
    state = SimpleNamespace(calls=[], rc=0, current=-1, switched=[])
    fns = {}
    for lib, symbols in kernels._SIGNATURES.items():
        for symbol, argtypes in symbols.items():
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)

            def record(*args, symbol=symbol):
                state.calls.append((symbol, args))
                return state.rc

            fns[symbol] = proto(record)
        fns[lib + ".err"] = lambda rc: b"fake error"

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            state.switched.append(self.index)

        def __exit__(self, *exc):
            state.switched.append(("back", self.index))

    monkeypatch.setattr(kernels, "_FNS", fns)
    monkeypatch.setattr(kernels, "_current_device", lambda: state.current)
    monkeypatch.setattr(kernels, "_raw_stream", lambda index: STREAM + index)
    monkeypatch.setattr(torch.cuda, "device", Device)
    kernels.reset_launches()
    yield state
    kernels.reset_launches()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_binding_passes_its_signature_and_the_stream(fake_cuda, name):
    lib, symbol, call = CALLS[name]
    counted = {"commit_hash_all": "commit_rebuild"}.get(name, name)
    call()
    assert [s for s, _ in fake_cuda.calls] == [symbol]
    args = fake_cuda.calls[0][1]
    assert len(args) == len(kernels._SIGNATURES[lib][symbol])
    assert args[-1] == STREAM - 1  # CPU tensors: device index -1
    assert fake_cuda.switched == []  # that device is "current" here
    assert kernels.launches[counted] == 1
    assert sum(kernels.launches.values()) == 1


def test_k10_and_k14_scatter_pass_pointers_and_sizes(fake_cuda):
    table, idx, src = _z((32, 8)), _z(5), _z((5, 8))
    kernels.tier_set_rows(table, idx, src)
    meta, msrc = _z((32, 2), torch.int32), _z((5, 2), torch.int32)
    kernels.tier_set_rows(meta, idx, msrc)
    part, rows = _z((8, 2)), _z((5, 2))
    kernels.shard_scatter(part, 24, idx, rows)
    assert [a for _, a in fake_cuda.calls] == [
        (table.data_ptr(), 32, 64, idx.data_ptr(), src.data_ptr(), 5, STREAM - 1),
        (meta.data_ptr(), 32, 8, idx.data_ptr(), msrc.data_ptr(), 5, STREAM - 1),
        (part.data_ptr(), 8, 24, idx.data_ptr(), 5, 2, rows.data_ptr(), STREAM - 1),
    ]
    assert kernels.launches["tier_set_rows"] == 2 and kernels.launches["shard_scatter"] == 1


def test_k2_update_passes_the_table_rows_and_admit_its_hash_rows(fake_cuda):
    """K2 update takes the table's rows (a slot past them reads row A-1)
    beside its pointers; admit the hash table's rows; the empty kernel
    (a measurement) counts nothing."""
    bal, meta, rh = _z((37, 8)), _z((37, 2), torch.int32), _z((37, 2))
    dg, slots, rows = _z(2), _z(5), _z(5)
    kernels.commit_update(bal, meta, rh, dg, slots, rows)
    kernels.commit_admit(rh, dg, slots, rows, rows)
    kernels.commit_empty(-1, 4, 64)
    assert [a for _, a in fake_cuda.calls] == [
        (bal.data_ptr(), meta.data_ptr(), 37, rh.data_ptr(), dg.data_ptr(), slots.data_ptr(),
         rows.data_ptr(), 5, STREAM - 1),
        (rh.data_ptr(), 37, dg.data_ptr(), slots.data_ptr(), rows.data_ptr(), rows.data_ptr(),
         5, STREAM - 1),
        (4, 64, STREAM - 1),
    ]
    assert kernels.launches["commit_update"] == 1 and kernels.launches["commit_admit"] == 1
    assert sum(kernels.launches.values()) == 2


def test_k8_and_k3_segment_pass_pointers_and_sizes(fake_cuda):
    """K8 takes the table, events, plane and carry and no scratch of its
    own (each chain's state stays in its thread; the repair reads the
    carry); K3's segment entry the table, events, rows and carry."""
    table, ev, plane, carry = _z((32, 8)), _z((16, 52)), _z((3, 5), torch.int32), _z(999)
    rows = _z(7, torch.int32)
    kernels.chain_wave(table, ev, plane, 12, 1 << 40, carry)
    kernels.exact_segment(table, ev, rows, 12, 1 << 40, carry)
    assert [a for _, a in fake_cuda.calls] == [
        (table.data_ptr(), 32, ev.data_ptr(), 16, plane.data_ptr(), 3, 5, 12, 1 << 40,
         carry.data_ptr(), STREAM - 1),
        (table.data_ptr(), 32, ev.data_ptr(), 16, rows.data_ptr(), 7, 12, 1 << 40,
         carry.data_ptr(), STREAM - 1),
    ]
    assert len(kernels._SIGNATURES["chain_wave"]["tb_chain_wave"]) == 11
    assert kernels.launches["chain_wave"] == 1 and kernels.launches["exact_segment"] == 1


def test_wave_scratch_holds_no_chain_wave_log():
    """WaveScratch keeps the carry and K9's arrays; K8's cell log and
    alive flags and K7's lane records (now in its blocks' shared
    memory) are gone."""
    from tigerbeetle_tpu_torch.state_machine import waves

    scratch = waves.WaveScratch(torch.device("cpu"))
    assert not hasattr(scratch, "cells") and not hasattr(scratch, "lanes")
    assert set(vars(scratch)) == {"device", "_carry", "_spec"}


def test_k7_and_k5_pass_no_buffer_of_their_own(fake_cuda):
    """K7 takes the table, events, indices, mask and carry and no lane
    buffer (one launch per wave; the lane records stay on chip); its
    shaped entry adds the launch shape and counts nothing.  K5 passes
    its stamp buffer as a nullable pointer."""
    table, ev, idx, carry = _z((32, 8)), _z((16, 52)), _z(5, torch.int32), _z(999)
    kernels.wave_step(table, ev, idx, None, 12, 1 << 40, carry)
    kernels.wave_step(table, ev, idx, None, 12, 1 << 40, carry, shape=(64, True))
    head = (table.data_ptr(), 32, ev.data_ptr(), 16, idx.data_ptr(), 5, None, 12, 1 << 40,
            carry.data_ptr())
    assert [a for _, a in fake_cuda.calls] == [head + (STREAM - 1,),
                                                head + (64, 1, STREAM - 1)]
    assert kernels.launches["wave_step"] == 1
    kernels.linked(T, M, 4096, PK, 5, True, SC)
    kernels.linked(T, M, 4096, PK, 5, True, SC, stamps=V)
    assert fake_cuda.calls[-2][1][-2] is None and fake_cuda.calls[-1][1][-2] == V.data_ptr()
    assert kernels.launches["linked"] == 2


def test_nullable_pointers_pass_as_null(fake_cuda):
    kernels.exact_finalize(T, 16, V, None, PK)
    kernels.exact_finalize(T, 16, V, V, PK)
    (_, without), (_, with_fix) = fake_cuda.calls
    assert without[4] is None and with_fix[4] == V.data_ptr()


def test_device_is_switched_only_for_another_card(fake_cuda):
    fake_cuda.current = 3  # the tensors' device (-1 here) is not current
    kernels.shard_scatter(_z((8, 2)), 0, V, _z((16, 2)))
    assert fake_cuda.switched == [-1, ("back", -1)]
    assert fake_cuda.calls[0][1][-1] == STREAM - 1  # the tensors' device's stream
    fake_cuda.current = -1
    kernels.shard_scatter(_z((8, 2)), 0, V, _z((16, 2)))
    assert fake_cuda.switched == [-1, ("back", -1)]
    assert kernels.launches["shard_scatter"] == 2


def test_a_failed_launch_raises_and_counts_nothing(fake_cuda):
    fake_cuda.rc = 1
    with pytest.raises(RuntimeError, match=r"tb_tier_set_rows: CUDA error 1 \(fake error\)"):
        kernels.tier_set_rows(T, V, T)
    assert kernels.launches["tier_set_rows"] == 0


def test_cuda_lookups_wait_for_the_first_launch():
    """Importing the bindings (and every wrapper module) looks nothing up:
    the CPU build of torch has no _cuda_getCurrentRawStream."""
    code = ("import tigerbeetle_tpu_torch.kernels as k\n"
            "import tigerbeetle_tpu_torch.state_machine.device_kernels\n"
            "import tigerbeetle_tpu_torch.parallel.sharded\n"
            "assert k._raw_stream is None and k._current_device is None and not k._FNS\n")
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_k9_passes_its_arrays_lengths_call_count_and_freshness(fake_cuda):
    """K9 takes its four minima arrays with their lengths, the calls made
    on them before (a 64-bit count: the library derives the tag) and
    whether they are new; no output buffer of the scratch (the wrapper's
    fresh tensor)."""
    ev, idx, serial, out = _z((16, 52)), _z(7, torch.int32), _z(7, torch.uint8), _z(7)
    tok, tgt, a_min, r_min = _z(16), _z(16), _z(40), _z(40)
    kernels.spec_conflicts(ev, idx, serial, 12, 33, tok, tgt, a_min, r_min, 5, False, out)
    kernels.spec_conflicts(ev, idx, None, 12, 33, tok, tgt, a_min, r_min, 1 << 40, True, out)
    head = (ev.data_ptr(), 16, idx.data_ptr(), 7)
    mid = (12, 33, tok.data_ptr(), tgt.data_ptr(), 16, a_min.data_ptr(), r_min.data_ptr(), 40)
    assert [a for _, a in fake_cuda.calls] == [
        head + (serial.data_ptr(),) + mid + (5, 0, out.data_ptr(), STREAM - 1),
        head + (None,) + mid + (1 << 40, 1, out.data_ptr(), STREAM - 1),
    ]
    assert kernels.launches["spec_conflicts"] == 2


def test_spec_scratch_counts_launched_calls_and_marks_new_arrays_fresh():
    """The scratch counts only the calls that launched; arrays made or
    grown are fresh (the kernel fills them) until a call launches on
    them, and the count runs on across a growth."""
    from tigerbeetle_tpu_torch.state_machine import waves

    scratch = waves.WaveScratch(torch.device("cpu"), spec_calls=41)
    spec = scratch._spec
    first = spec.take(64, 100)
    assert first[4:] == (41, True)
    assert spec.take(64, 100)[4:] == (41, True)  # a take that did not launch counts nothing
    tok, tgt, a_min, r_min = first[:4]
    assert tok.numel() == tgt.numel() == 8192 and a_min.numel() == r_min.numel() == 100
    assert all(a.dtype == torch.int32 for a in (tok, tgt, a_min, r_min))
    spec.launched()
    assert spec.take(64, 100)[4:] == (42, False)
    spec.launched()
    grown = spec.take(64, 5000)
    assert grown[2].numel() == 5000 and grown[4:] == (43, True)
    spec.launched()
    again = spec.take(64, 10)
    assert again[2] is grown[2] and again[4:] == (44, False)  # a smaller table reuses them
