"""ctypes bindings of the hand-written CUDA kernels, with launch counts.

Every binding takes CUDA tensors the caller has already checked (the
wrappers in ``state_machine/device_kernels.py``,
``state_machine/commitment.py``, ``state_machine/waves.py`` and
``parallel/sharded.py`` do), launches on the current stream of the
device its tensors lie on without synchronising, raises on a non-zero
CUDA status, and adds one to its entry in ``launches``.  Nothing here
imports or builds anything until the first launch.
"""

from __future__ import annotations

import ctypes

import torch

# Launches per kernel since the last reset_launches(): the proof that a
# run went through the kernels and not their plain versions.
launches = {
    "orderfree": 0,
    "commit_update": 0,
    "commit_rebuild": 0,
    "commit_probe": 0,
    "exact_scan": 0,
    "apply_deltas": 0,
    "linked": 0,
    "two_phase": 0,
    "exact_init": 0,
    "exact_segment": 0,
    "exact_finalize": 0,
    "wave_step": 0,
    "chain_wave": 0,
    "spec_conflicts": 0,
    "tier_set_rows": 0,
    "commit_admit": 0,
    "checksum": 0,
    "shard_accumulate": 0,
    "shard_admit": 0,
    "shard_apply": 0,
    "shard_gather": 0,
    "shard_scatter": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

_SIGNATURES = {
    "orderfree": {
        # table, meta, A, ring_row, pk, mode, n, B, ts_base, slot_idx,
        # codes, touched, acc, newrows, ctrl, stream
        "tb_orderfree": [
            _P, _P, _I64, _P, _P, _I, _I, _I, _U64, _P, _P, _P, _P, _P,
            _P, _P,
        ],
    },
    "commitment": {
        # balances, meta, rows, A, row_hash (nullable), fold_out, stream
        "tb_commit_hash_all": [_P, _P, _P, _I64, _P, _P, _P],
        # balances, meta, row_hash, digest, slots, rows, k, stream
        "tb_commit_update": [_P, _P, _P, _P, _P, _P, _I64, _P],
        # row_hash, H, digest, slots, new_lo, new_hi, k, stream
        "tb_commit_admit": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    },
    "tier": {
        # table, H, width, word_bytes, idx, src, k, stream
        "tb_tier_set_rows": [_P, _I64, _I, _I, _P, _P, _I64, _P],
    },
    "checksum": {
        # table, R, row0, C, word_bytes, out, stream
        "tb_checksum": [_P, _I64, _I64, _I, _I, _P, _P],
    },
    "shard_apply": {
        # acc, local_rows, row0, dr, cr, lo, hi, pending, mask (nullable),
        # E, stream
        "tb_shard_accumulate": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _P],
        # table, acc, local_rows, row0, dr, cr, E, reject, stream
        "tb_shard_admit": [_P, _P, _I64, _I64, _P, _P, _I64, _P, _P],
        # table, acc, local_rows, stream
        "tb_shard_apply": [_P, _P, _I64, _P],
    },
    "shard_rows": {
        # table, local_rows, row0, slots, k, width, out / rows, stream
        "tb_shard_gather": [_P, _I64, _I64, _P, _I64, _I64, _P, _P],
        "tb_shard_scatter": [_P, _I64, _I64, _P, _I64, _I64, _P, _P],
    },
    "exact_scan": {
        # table, A, ev, B, dstat_init, n, ts_base, scratch, out, stream
        "tb_exact_scan": [_P, _I64, _P, _I, _P, _I, _U64, _P, _P, _P],
        # next, steps, sink, stream
        "tb_l2_chase": [_P, _I64, _P, _P],
        # scratch, B, dstat_init, stream
        "tb_exact_init": [_P, _I, _P, _P],
        # table, A, ev, B, rows, L, n, ts_base, scratch, stream
        "tb_exact_segment": [_P, _I64, _P, _I, _P, _I, _I, _U64, _P, _P],
        # table, A, B, scratch, hist_fix (nullable), out, stream
        "tb_exact_finalize": [_P, _I64, _I, _P, _P, _P, _P],
    },
    "wave_step": {
        # table, A, ev, B, idx, K, mask (nullable), n, ts_base, scratch,
        # lanes, stream
        "tb_wave_step": [_P, _I64, _P, _I, _P, _I, _P, _I, _U64, _P, _P, _P],
    },
    "chain_wave": {
        # table, A, ev, B, plane, P, C, n, ts_base, scratch, ys, alive,
        # stream
        "tb_chain_wave": [_P, _I64, _P, _I, _P, _I, _I, _I, _U64, _P, _P, _P, _P],
    },
    "spec_conflicts": {
        # ev, B, idx, K, serial (nullable), n, A, tok, tgt, a_min, r_min,
        # out, stream
        "tb_spec_conflicts": [_P, _I, _P, _I, _P, _I, _I64, _P, _P, _P, _P, _P, _P],
    },
    "apply_deltas": {
        # table, A, packed, k, stride, stream
        "tb_apply_deltas": [_P, _I64, _P, _I64, _I64, _P],
    },
    "linked": {
        # table, meta, A, ring_row, pk, n, B, small, slot_idx, words, stream
        "tb_linked": [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P],
    },
    "two_phase": {
        # table, meta, A, ring_row, pk, n, B, lo_only, slot_idx, words, stream
        "tb_two_phase": [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P],
    },
}

_FNS: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _fn(lib: str, symbol: str):
    fn = _FNS.get(symbol)
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        handle = build.load(lib)
        fn = getattr(handle, symbol)
        fn.argtypes = _SIGNATURES[lib][symbol]
        fn.restype = _I
        err = getattr(handle, "tb_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        _FNS[symbol] = fn
        _FNS[lib + ".err"] = err
    return fn


def _launch(lib: str, symbol: str, count_as: str | None, *args) -> None:
    """Call `symbol` with `args` (tensors pass as their data pointers,
    None as a null pointer) on the current stream of the device of the
    first tensor argument, with that device current: a shard's tensors
    may lie on another card than the current one."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = _fn(lib, symbol)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = _FNS[lib + ".err"](rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    if count_as is not None:
        launches[count_as] += 1


def orderfree(table, meta, ring_row_ptr, pk, mode, n, ts_base_u64, scratch):
    _launch(
        "orderfree", "tb_orderfree", "orderfree",
        table, meta, table.shape[0], ring_row_ptr, pk,
        mode, n, pk.shape[0], ts_base_u64, scratch.slot_idx,
        scratch.codes, scratch.touched, scratch.acc,
        scratch.newrows, scratch.ctrl,
    )


def linked(table, meta, ring_row_ptr, pk, n, small, scratch):
    _launch(
        "linked", "tb_linked", "linked",
        table, meta, table.shape[0], ring_row_ptr, pk, n,
        pk.shape[0], int(small), scratch.slot_idx, scratch.words,
    )


def two_phase(table, meta, ring_row_ptr, pk, n, lo_only, scratch):
    _launch(
        "two_phase", "tb_two_phase", "two_phase",
        table, meta, table.shape[0], ring_row_ptr, pk, n,
        pk.shape[0], int(lo_only), scratch.slot_idx, scratch.words,
    )


def scratch_words(lib: str, batch: int) -> int:
    """u64 words of K5's or K6's scratch buffer for a `batch`-event
    bucket (the layout is the kernel source's)."""
    fn = _FNS.get(lib + ".words")
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        fn = getattr(build.load(lib), f"tb_{lib}_scratch_words")
        fn.argtypes = [_I]
        fn.restype = _I64
        _FNS[lib + ".words"] = fn
    return int(fn(batch))


def commit_hash_all(balances, meta, rows, row_hash, fold_out, count_as):
    _launch(
        "commitment", "tb_commit_hash_all", count_as,
        balances, meta, rows, balances.shape[0],
        row_hash, fold_out,
    )


def commit_update(balances, meta, row_hash, digest, slots, rows):
    _launch(
        "commitment", "tb_commit_update", "commit_update",
        balances, meta, row_hash, digest,
        slots, rows, slots.shape[0],
    )


def commit_admit(row_hash, digest, slots, new_lo, new_hi):
    _launch(
        "commitment", "tb_commit_admit", "commit_admit",
        row_hash, row_hash.shape[0], digest, slots,
        new_lo, new_hi, slots.shape[0],
    )


def tier_set_rows(table, idx, src):
    _launch(
        "tier", "tb_tier_set_rows", "tier_set_rows",
        table, table.shape[0], table.shape[1], table.element_size(),
        idx, src, idx.shape[0],
    )


def checksum(table, out, row0=0):
    _launch(
        "checksum", "tb_checksum", "checksum",
        table, table.shape[0], row0, table.shape[1], table.element_size(), out,
    )


def exact_scan(table, events, dstat_init, n, ts_base_u64, scratch_words, out):
    _launch(
        "exact_scan", "tb_exact_scan", "exact_scan",
        table, table.shape[0], events, events.shape[0],
        dstat_init, n, ts_base_u64, scratch_words, out,
    )


def apply_deltas(table, packed):
    _launch(
        "apply_deltas", "tb_apply_deltas", "apply_deltas",
        table, table.shape[0], packed, packed.shape[1],
        packed.shape[1],
    )


def l2_chase(next_idx, steps, sink):
    """The dependent-load chase that measures K3's serial floor (a
    measurement, not a kernel of the port: not counted).  `next_idx` is
    a CUDA int32 permutation of its own indices."""
    if next_idx.dtype != torch.int32 or not next_idx.is_cuda or not next_idx.is_contiguous():
        raise ValueError("next_idx must be a contiguous CUDA int32 tensor")
    _launch("exact_scan", "tb_l2_chase", None, next_idx, steps, sink)


def exact_init(scratch_words, dstat_init):
    """K3's initial carry for a (B,)-row batch in `scratch_words`."""
    _launch(
        "exact_scan", "tb_exact_init", "exact_init",
        scratch_words, dstat_init.shape[0], dstat_init,
    )


def exact_segment(table, events, rows, n, ts_base_u64, scratch_words):
    """A K3 scan segment over the int32 global event indices `rows`."""
    _launch(
        "exact_scan", "tb_exact_segment", "exact_segment",
        table, table.shape[0], events, events.shape[0],
        rows, rows.shape[0], n, ts_base_u64, scratch_words,
    )


def exact_finalize(table, batch, scratch_words, hist_fix, out):
    """The packed outputs of the carry; `hist_fix` a (B,) uint8 mask or
    None."""
    _launch(
        "exact_scan", "tb_exact_finalize", "exact_finalize",
        table, table.shape[0], batch, scratch_words,
        hist_fix, out,
    )


def aux_words(lib: str, symbol: str) -> int:
    """A word count a kernel source exports (lane-record or cell-log
    words per lane)."""
    fn = _FNS.get(symbol)
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        fn = getattr(build.load(lib), symbol)
        fn.argtypes = []
        fn.restype = _I64
        _FNS[symbol] = fn
    return int(fn())


def wave_step(table, events, idx, mask, n, ts_base_u64, scratch_words, lanes):
    _launch(
        "wave_step", "tb_wave_step", "wave_step",
        table, table.shape[0], events, events.shape[0], idx,
        idx.shape[0], mask, n, ts_base_u64, scratch_words, lanes,
    )


def chain_wave(table, events, plane, n, ts_base_u64, scratch_words, ys, alive):
    _launch(
        "chain_wave", "tb_chain_wave", "chain_wave",
        table, table.shape[0], events, events.shape[0], plane,
        plane.shape[0], plane.shape[1], n, ts_base_u64, scratch_words,
        ys, alive,
    )


def spec_conflicts(events, idx, serial, n, A, tok, tgt, a_min, r_min, out):
    _launch(
        "spec_conflicts", "tb_spec_conflicts", "spec_conflicts",
        events, events.shape[0], idx, idx.shape[0], serial, n, A,
        tok, tgt, a_min, r_min, out,
    )


def shard_accumulate(acc, row0, dr, cr, lo, hi, pending, mask):
    _launch(
        "shard_apply", "tb_shard_accumulate", "shard_accumulate",
        acc, acc.shape[0], row0, dr, cr, lo, hi,
        pending, mask, dr.shape[0],
    )


def shard_admit(table, acc, row0, dr, cr, reject):
    _launch(
        "shard_apply", "tb_shard_admit", "shard_admit",
        table, acc, table.shape[0], row0, dr, cr, dr.shape[0],
        reject,
    )


def shard_apply(table, acc):
    _launch("shard_apply", "tb_shard_apply", "shard_apply", table, acc,
            table.shape[0])


def shard_gather(table, row0, slots, out):
    """K14 gather over an (local_rows, W) int64 table: W u64 words per row."""
    _launch(
        "shard_rows", "tb_shard_gather", "shard_gather",
        table, table.shape[0], row0, slots, slots.shape[0], table.shape[1],
        out,
    )


def shard_scatter(table, row0, slots, rows):
    _launch(
        "shard_rows", "tb_shard_scatter", "shard_scatter",
        table, table.shape[0], row0, slots, slots.shape[0], table.shape[1],
        rows,
    )
