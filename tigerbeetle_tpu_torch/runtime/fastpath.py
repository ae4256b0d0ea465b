"""ctypes bindings of the host engine's native commit path.

Counterpart of ``tigerbeetle_tpu/runtime/fastpath.py``, bound to the
port's own library (``csrc/host/``, built by ``kernels/host_build.py``
at first use).  Wire decode, the static ladder, account resolution,
duplicate detection, u128 overflow admission and the serial linked /
two-phase / exact engines run in C++, and so does the LSM's k-way merge
(``kway_merge``, for lsm/tree.py); Python keeps orchestration, the
columnar stores and the device queue.  The balance mirror's memory is
OWNED by the native library and wrapped zero-copy as numpy arrays, so
every host-side mutation is visible to the native admission checks and
the other way round.

No silent fallback: a failed build or load raises NativeFastpathError
with the compiler's output.  TB_FASTPATH_DISABLE (any non-empty value)
is the one way to run without the library (``available()`` is then
False and the machine takes its Python lanes).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from tigerbeetle_tpu_torch import envcheck
from tigerbeetle_tpu_torch.kernels import host_build

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_LOADED: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()
# The default library's (path, digest, seconds spent building it in this
# process), once loaded.
build_info: dict = {}


class NativeFastpathError(RuntimeError):
    """The native library could not be built or loaded (the message
    carries the compiler's output)."""


def _register(lib: ctypes.CDLL) -> None:
    """Argument and return types of every symbol the port binds."""
    lib.tb_fp_create.restype = ctypes.c_void_p
    lib.tb_fp_create.argtypes = [ctypes.c_uint64]
    lib.tb_fp_destroy.argtypes = [ctypes.c_void_p]
    lib.tb_fp_balances_lo.restype = _U64P
    lib.tb_fp_balances_lo.argtypes = [ctypes.c_void_p]
    lib.tb_fp_balances_hi.restype = _U64P
    lib.tb_fp_balances_hi.argtypes = [ctypes.c_void_p]
    lib.tb_fp_add_accounts.argtypes = [
        ctypes.c_void_p, _U64P, _U64P, _U32P, _U32P,
        ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.tb_fp_remove_accounts.argtypes = [
        ctypes.c_void_p, _U64P, _U64P, ctypes.c_uint32,
    ]
    lib.tb_fp_add_transfer_ids.argtypes = [
        ctypes.c_void_p, _U64P, _U64P, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.tb_fp_remove_transfer_ids.argtypes = [
        ctypes.c_void_p, _U64P, _U64P, ctypes.c_uint32,
    ]
    lib.tb_fp_commit_transfers.restype = ctypes.c_int
    lib.tb_fp_commit_transfers.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint32, ctypes.c_uint64,
        _U32P, _I32P, _I32P, _I64P, _I64P, _U64P, _U64P, _U32P,
    ]
    lib.tb_fp_commit_linked.restype = ctypes.c_int
    lib.tb_fp_commit_linked.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint32, ctypes.c_uint64,
        _U32P, _I32P, _I32P, _I64P, _I64P, _U64P, _U64P, _U32P,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tb_fp_commit_two_phase.restype = ctypes.c_int
    lib.tb_fp_commit_two_phase.argtypes = [
        ctypes.c_void_p, _U8P, ctypes.c_uint32, ctypes.c_uint64,
        # durable-target join
        _I64P, _U32P, _I32P, _I32P, _U64P, _U64P, _U32P, _U32P,
        _U64P, _U64P, _U64P, _U32P, _U32P, _U32P,
        # outputs
        _U32P, _I32P, _I32P, _U64P, _U64P, _U64P, _U64P, _U64P,
        _U32P, _U32P, _U32P, _U32P,
        _I64P, _U32P, _U32P,
        _I64P, _I64P, _U64P, _U64P, _U32P,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.tb_fp_commit_exact.restype = ctypes.c_int
    lib.tb_fp_commit_exact.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_uint32, _U32P, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint32,
        _U64P, _I64P, _I64P, _U64P, _U64P, _U32P,
    ]
    lib.tb_lsm_kway_merge.restype = ctypes.c_int64
    lib.tb_lsm_kway_merge.argtypes = [
        ctypes.c_int32, ctypes.POINTER(_U8P), ctypes.POINTER(_U8P),
        ctypes.POINTER(_U8P), _I64P, ctypes.c_int32, _U8P, _U8P, _U8P,
    ]
    lib.tb_fp_decode_store.argtypes = [
        _U8P, ctypes.c_uint32, ctypes.c_uint64,
        _U64P, _U64P, _U64P, _U64P, _U64P, _U64P,
        _U64P, _U64P, _U64P,
        _U32P, _U32P, _U32P, _U32P, _U32P, _U64P, _U8P,
    ]


def load(src: Path | None = None, out_dir: Path | None = None) -> ctypes.CDLL:
    """The library built from the sources of `src` into `out_dir`
    (default: the package's csrc/host/ into build/native/), built first
    when missing; raises NativeFastpathError when it cannot be built or
    loaded."""
    default = src is None and out_dir is None
    src = host_build.HOST_SRC if src is None else src
    out_dir = host_build.BUILD_DIR if out_dir is None else out_dir
    with _lock:
        try:
            path, seconds = host_build.build(src, out_dir)
        except host_build.NativeBuildError as exc:
            raise NativeFastpathError(f"native fast path build failed: {exc}") from exc
        lib = _LOADED.get(path)
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL(str(path))
            _register(lib)
        except (OSError, AttributeError) as exc:
            raise NativeFastpathError(f"native fast path load failed ({path}): {exc}") from exc
        _LOADED[path] = lib
        if default:
            build_info.update(path=str(path), digest=host_build.digest(src), seconds=seconds)
        return lib


def _load() -> ctypes.CDLL | None:
    """The port's library, or None under TB_FASTPATH_DISABLE."""
    if envcheck.fastpath_disabled():
        return None
    return load()


def available() -> bool:
    """True unless TB_FASTPATH_DISABLE is set; raises when the library
    cannot be built or loaded."""
    return _load() is not None


def decode_store(events: np.ndarray, n: int, ts_base: int, cols: dict, lo: int) -> None:
    """One C pass: wire Transfer records -> contiguous store columns
    written in place at cols[name][lo:lo+n] (the store's fields minus
    dr/cr slots).  PRECONDITION: every event applied — callers with
    failures take the shared slow path.  `events` is the contiguous
    wire-record array (read-only views are fine: the C side only
    reads)."""
    lib = load()
    assert events.flags["C_CONTIGUOUS"]

    def at(name, ptype):
        arr = cols[name]
        return ctypes.cast(arr.ctypes.data + lo * arr.dtype.itemsize, ptype)

    lib.tb_fp_decode_store(
        ctypes.cast(events.__array_interface__["data"][0], _U8P),
        n, ts_base,
        at("id_lo", _U64P), at("id_hi", _U64P),
        at("amount_lo", _U64P), at("amount_hi", _U64P),
        at("pending_lo", _U64P), at("pending_hi", _U64P),
        at("ud128_lo", _U64P), at("ud128_hi", _U64P), at("ud64", _U64P),
        at("ud32", _U32P), at("timeout", _U32P), at("ledger", _U32P),
        at("code", _U32P), at("flags", _U32P), at("timestamp", _U64P),
        at("status", _U8P),
    )


def kway_merge(streams, value_size: int, lib: ctypes.CDLL | None = None):
    """Native k-way merge of sorted-unique (keys V16, flags u8, vals
    (n, value_size) u8) streams, stream 0 newest: a key present in
    several streams keeps the newest stream's entry.  Returns the merged
    (keys, flags, vals).  `lib`: the loaded library (default: the
    port's, built at first use; a failed build raises)."""
    lib = load() if lib is None else lib
    k = len(streams)
    total = sum(len(s[0]) for s in streams)
    keys_c = [np.ascontiguousarray(s[0]) for s in streams]
    flags_c = [np.ascontiguousarray(s[1]) for s in streams]
    vals_c = [np.ascontiguousarray(s[2]) for s in streams]
    key_ptrs = (_U8P * k)(*[_p(a, _U8P) for a in keys_c])
    flag_ptrs = (_U8P * k)(*[_p(a, _U8P) for a in flags_c])
    val_ptrs = (_U8P * k)(*[_p(a, _U8P) for a in vals_c])
    lens = (ctypes.c_int64 * k)(*[len(s[0]) for s in streams])
    out_keys = np.empty(total, dtype="V16")
    out_flags = np.empty(total, np.uint8)
    out_vals = np.empty((total, value_size), np.uint8)
    n = lib.tb_lsm_kway_merge(
        k, key_ptrs, flag_ptrs, val_ptrs, lens, value_size,
        _p(out_keys, _U8P) if total else None,
        _p(out_flags, _U8P) if total else None,
        _p(out_vals, _U8P) if total else None,
    )
    return out_keys[:n], out_flags[:n], out_vals[:n]


def _p(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


class _OwnedView(np.ndarray):
    """ndarray view that keeps its native owner alive (lifetime tie),
    propagated to any derived view via __array_finalize__."""

    _owner = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self._owner = getattr(obj, "_owner", None)


class NativeFastpath:
    """One native fast-path instance per TorchStateMachine."""

    def __init__(self, account_capacity: int, lib: ctypes.CDLL | None = None) -> None:
        """`lib`: the loaded library (default: the port's, built at
        first use; raises NativeFastpathError when it cannot be)."""
        lib = lib if lib is not None else load()
        self._lib = lib
        self._fp = lib.tb_fp_create(account_capacity)
        self.capacity = account_capacity
        # Zero-copy numpy views over the native balance mirror.  The
        # views hold a reference back to this object, so the native
        # buffers cannot be freed while any view (the BalanceMirror's)
        # is alive.
        self.lo = np.ctypeslib.as_array(
            lib.tb_fp_balances_lo(self._fp), shape=(account_capacity, 4)
        ).view(_OwnedView)
        self.lo._owner = self
        self.hi = np.ctypeslib.as_array(
            lib.tb_fp_balances_hi(self._fp), shape=(account_capacity, 4)
        ).view(_OwnedView)
        self.hi._owner = self
        # Reusable output buffers (sized for the largest batch).
        n_max = 8192
        self._results = np.empty(n_max, np.uint32)
        self._dr_slot = np.empty(n_max, np.int32)
        self._cr_slot = np.empty(n_max, np.int32)
        # Deltas are bounded both by touched columns (4 per account) and
        # by 4 per event (a post/void touches dp+dpo and cp+cpo).
        d_max = min(4 * account_capacity, 4 * n_max) + 8
        self._dslot = np.empty(d_max, np.int64)
        self._dcol = np.empty(d_max, np.int64)
        self._dlo = np.empty(d_max, np.uint64)
        self._dhi = np.empty(d_max, np.uint64)
        self._ndeltas = ctypes.c_uint32(0)
        self._packed = None
        self._field_dtypes = None
        self._last_applied = ctypes.c_int32(-1)
        # Two-phase resolver outputs (reused per call).
        self._tp_amt_lo = np.empty(n_max, np.uint64)
        self._tp_amt_hi = np.empty(n_max, np.uint64)
        self._tp_ud128_lo = np.empty(n_max, np.uint64)
        self._tp_ud128_hi = np.empty(n_max, np.uint64)
        self._tp_ud64 = np.empty(n_max, np.uint64)
        self._tp_ud32 = np.empty(n_max, np.uint32)
        self._tp_ledger = np.empty(n_max, np.uint32)
        self._tp_code = np.empty(n_max, np.uint32)
        self._tp_inb = np.empty(n_max, np.uint32)
        self._tp_dur_rows = np.empty(n_max, np.int64)
        self._tp_dur_status = np.empty(n_max, np.uint32)
        self._tp_ndur = ctypes.c_uint32(0)
        self._tp_empty_u64 = np.zeros(n_max, np.uint64)
        self._tp_empty_u32 = np.zeros(n_max, np.uint32)
        self._tp_empty_i32 = np.full(n_max, -1, np.int32)
        self._tp_empty_i64 = np.full(n_max, -1, np.int64)

    def __del__(self):
        if getattr(self, "_fp", None):
            self._lib.tb_fp_destroy(self._fp)
            self._fp = None

    def add_accounts(self, id_lo, id_hi, flags, ledger, base_slot: int) -> None:
        id_lo = np.ascontiguousarray(id_lo, np.uint64)
        id_hi = np.ascontiguousarray(id_hi, np.uint64)
        flags = np.ascontiguousarray(flags, np.uint32)
        ledger = np.ascontiguousarray(ledger, np.uint32)
        self._lib.tb_fp_add_accounts(
            self._fp, _p(id_lo, _U64P), _p(id_hi, _U64P),
            _p(flags, _U32P), _p(ledger, _U32P), len(id_lo), base_slot,
        )

    def remove_accounts(self, id_lo, id_hi) -> None:
        id_lo = np.ascontiguousarray(id_lo, np.uint64)
        id_hi = np.ascontiguousarray(id_hi, np.uint64)
        self._lib.tb_fp_remove_accounts(self._fp, _p(id_lo, _U64P), _p(id_hi, _U64P), len(id_lo))

    def add_transfer_ids(self, id_lo, id_hi, base_row: int) -> None:
        id_lo = np.ascontiguousarray(id_lo, np.uint64)
        id_hi = np.ascontiguousarray(id_hi, np.uint64)
        self._lib.tb_fp_add_transfer_ids(
            self._fp, _p(id_lo, _U64P), _p(id_hi, _U64P), base_row, len(id_lo)
        )

    def remove_transfer_ids(self, id_lo, id_hi) -> None:
        id_lo = np.ascontiguousarray(id_lo, np.uint64)
        id_hi = np.ascontiguousarray(id_hi, np.uint64)
        self._lib.tb_fp_remove_transfer_ids(
            self._fp, _p(id_lo, _U64P), _p(id_hi, _U64P), len(id_lo)
        )

    def _deltas(self):
        k = self._ndeltas.value
        return self._dslot[:k], self._dcol[:k], self._dlo[:k], self._dhi[:k]

    def commit_exact(self, ev: dict, field_order, dstat_init, B: int, n: int, ts_base: int):
        """Serial exact engine (csrc/host/tb_exact.inc): the scan
        kernel's inputs and packed-output layout, so the caller unpacks
        with kernel.unpack_outputs.  Mutates the shared mirror; returns
        (packed (B, N_COLS) u64, deltas views): the packed buffer is
        reused per call (the engine overwrites rows [0, B))."""
        from tigerbeetle_tpu_torch.state_machine import kernel

        dtypes = self._field_dtypes
        if dtypes is None:
            dtypes = self._field_dtypes = [np.dtype(dt) for _name, dt in field_order]
        arrays = []
        ptrs = (ctypes.c_void_p * len(field_order))()
        for k, (name, _dt) in enumerate(field_order):
            a = np.ascontiguousarray(ev[name], dtypes[k])
            arrays.append(a)  # keep alive for the call
            ptrs[k] = a.ctypes.data

        dstat = np.ascontiguousarray(dstat_init, np.uint32)
        packed = self._packed
        if packed is None or packed.shape[0] < B:
            packed = self._packed = np.empty((max(B, 8192), kernel.N_COLS), np.uint64)
        packed = packed[:B]
        rc = self._lib.tb_fp_commit_exact(
            self._fp, ptrs, len(field_order), _p(dstat, _U32P), B, n, ts_base,
            kernel.N_COLS,
            _p(packed, _U64P), _p(self._dslot, _I64P), _p(self._dcol, _I64P),
            _p(self._dlo, _U64P), _p(self._dhi, _U64P),
            ctypes.byref(self._ndeltas),
        )
        assert rc == 0, f"exact engine field-order skew ({rc})"
        return packed, self._deltas()

    def commit_transfers(self, body: bytes, n: int, ts_base: int):
        """-> None (fallback: nothing mutated) or (results, dr_slot,
        cr_slot, (dslot, dcol, dlo, dhi)): views into reusable buffers,
        valid until the next call."""
        if n > len(self._results):
            return None  # oversized batch: take the exact path
        # Zero-copy pointer into the immutable bytes (the C side reads).
        buf = ctypes.cast(ctypes.c_char_p(body), _U8P)
        rc = self._lib.tb_fp_commit_transfers(
            self._fp, buf, n, ts_base,
            _p(self._results, _U32P), _p(self._dr_slot, _I32P),
            _p(self._cr_slot, _I32P), _p(self._dslot, _I64P),
            _p(self._dcol, _I64P), _p(self._dlo, _U64P),
            _p(self._dhi, _U64P), ctypes.byref(self._ndeltas),
        )
        if rc != 0:
            return None
        return self._results[:n], self._dr_slot[:n], self._cr_slot[:n], self._deltas()

    def commit_linked(self, body: bytes, n: int, ts_base: int):
        """Serial native resolver for linked-chain / limit-account
        batches (csrc/host/tb_linked.inc).  -> None (fallback) or
        (results, dr_slot, cr_slot, deltas, last_applied)."""
        if n > len(self._results):
            return None
        buf = ctypes.cast(ctypes.c_char_p(body), _U8P)
        rc = self._lib.tb_fp_commit_linked(
            self._fp, buf, n, ts_base,
            _p(self._results, _U32P), _p(self._dr_slot, _I32P),
            _p(self._cr_slot, _I32P), _p(self._dslot, _I64P),
            _p(self._dcol, _I64P), _p(self._dlo, _U64P),
            _p(self._dhi, _U64P), ctypes.byref(self._ndeltas),
            ctypes.byref(self._last_applied),
        )
        if rc != 0:
            return None
        return (
            self._results[:n], self._dr_slot[:n], self._cr_slot[:n], self._deltas(),
            int(self._last_applied.value),
        )

    def commit_two_phase(self, body: bytes, n: int, ts_base: int, join: dict | None):
        """Serial native resolver for two-phase batches
        (csrc/host/tb_two_phase.inc).  `join` carries the durable pending
        targets' columns (None when the batch references none);
        -> None (fallback) or a dict of output views valid until the
        next native call."""
        if n > len(self._results):
            return None
        buf = ctypes.cast(ctypes.c_char_p(body), _U8P)
        if join is None:
            j_row = self._tp_empty_i64
            j_flags = j_ledger = j_code = j_ud32 = j_timeout = j_status = self._tp_empty_u32
            j_dr = j_cr = self._tp_empty_i32
            j_amt_lo = j_amt_hi = j_u128lo = j_u128hi = j_ud64 = self._tp_empty_u64
        else:
            j_row = np.ascontiguousarray(join["row"], np.int64)
            j_flags = np.ascontiguousarray(join["flags"], np.uint32)
            j_dr = np.ascontiguousarray(join["dr_slot"], np.int32)
            j_cr = np.ascontiguousarray(join["cr_slot"], np.int32)
            j_amt_lo = np.ascontiguousarray(join["amount_lo"], np.uint64)
            j_amt_hi = np.ascontiguousarray(join["amount_hi"], np.uint64)
            j_ledger = np.ascontiguousarray(join["ledger"], np.uint32)
            j_code = np.ascontiguousarray(join["code"], np.uint32)
            j_u128lo = np.ascontiguousarray(join["ud128_lo"], np.uint64)
            j_u128hi = np.ascontiguousarray(join["ud128_hi"], np.uint64)
            j_ud64 = np.ascontiguousarray(join["ud64"], np.uint64)
            j_ud32 = np.ascontiguousarray(join["ud32"], np.uint32)
            j_timeout = np.ascontiguousarray(join["timeout"], np.uint32)
            j_status = np.ascontiguousarray(join["status"], np.uint32)
        rc = self._lib.tb_fp_commit_two_phase(
            self._fp, buf, n, ts_base,
            _p(j_row, _I64P), _p(j_flags, _U32P), _p(j_dr, _I32P),
            _p(j_cr, _I32P), _p(j_amt_lo, _U64P), _p(j_amt_hi, _U64P),
            _p(j_ledger, _U32P), _p(j_code, _U32P), _p(j_u128lo, _U64P),
            _p(j_u128hi, _U64P), _p(j_ud64, _U64P), _p(j_ud32, _U32P),
            _p(j_timeout, _U32P), _p(j_status, _U32P),
            _p(self._results, _U32P), _p(self._dr_slot, _I32P),
            _p(self._cr_slot, _I32P), _p(self._tp_amt_lo, _U64P),
            _p(self._tp_amt_hi, _U64P), _p(self._tp_ud128_lo, _U64P),
            _p(self._tp_ud128_hi, _U64P), _p(self._tp_ud64, _U64P),
            _p(self._tp_ud32, _U32P), _p(self._tp_ledger, _U32P),
            _p(self._tp_code, _U32P), _p(self._tp_inb, _U32P),
            _p(self._tp_dur_rows, _I64P), _p(self._tp_dur_status, _U32P),
            ctypes.byref(self._tp_ndur),
            _p(self._dslot, _I64P), _p(self._dcol, _I64P),
            _p(self._dlo, _U64P), _p(self._dhi, _U64P),
            ctypes.byref(self._ndeltas), ctypes.byref(self._last_applied),
        )
        if rc != 0:
            return None
        nd = self._tp_ndur.value
        return {
            "results": self._results[:n],
            "row_dr": self._dr_slot[:n],
            "row_cr": self._cr_slot[:n],
            "amt_lo": self._tp_amt_lo[:n],
            "amt_hi": self._tp_amt_hi[:n],
            "ud128_lo": self._tp_ud128_lo[:n],
            "ud128_hi": self._tp_ud128_hi[:n],
            "ud64": self._tp_ud64[:n],
            "ud32": self._tp_ud32[:n],
            "ledger": self._tp_ledger[:n],
            "code": self._tp_code[:n],
            "inb_status": self._tp_inb[:n],
            "dur_rows": self._tp_dur_rows[:nd],
            "dur_status": self._tp_dur_status[:nd],
            "deltas": self._deltas(),
            "last_applied": int(self._last_applied.value),
        }
