"""ctypes bindings of the hand-written CUDA kernels, with launch counts.

Every binding takes CUDA tensors the caller has already checked (the
wrappers in ``state_machine/device_kernels.py`` and
``state_machine/commitment.py`` do), launches on PyTorch's current
stream without synchronising, raises on a non-zero CUDA status, and
adds one to its entry in ``launches``.  Nothing here imports or builds
anything until the first launch.
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


def _launch(lib: str, symbol: str, count_as: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fn(lib, symbol)(*args, stream)
    if rc != 0:
        msg = _FNS[lib + ".err"](rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    launches[count_as] += 1


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def orderfree(table, meta, ring_row_ptr, pk, mode, n, ts_base_u64, scratch):
    _launch(
        "orderfree", "tb_orderfree", "orderfree",
        _ptr(table), _ptr(meta), table.shape[0], ring_row_ptr, _ptr(pk),
        mode, n, pk.shape[0], ts_base_u64, _ptr(scratch.slot_idx),
        _ptr(scratch.codes), _ptr(scratch.touched), _ptr(scratch.acc),
        _ptr(scratch.newrows), _ptr(scratch.ctrl),
    )


def commit_hash_all(balances, meta, rows, row_hash, fold_out, count_as):
    _launch(
        "commitment", "tb_commit_hash_all", count_as,
        _ptr(balances), _ptr(meta), _ptr(rows), balances.shape[0],
        _ptr(row_hash), _ptr(fold_out),
    )


def commit_update(balances, meta, row_hash, digest, slots, rows):
    _launch(
        "commitment", "tb_commit_update", "commit_update",
        _ptr(balances), _ptr(meta), _ptr(row_hash), _ptr(digest),
        _ptr(slots), _ptr(rows), slots.shape[0],
    )
