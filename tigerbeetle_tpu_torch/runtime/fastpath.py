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
with the compiler's output.  TB_NATIVE_SANITIZE=asan loads the
sanitized build (``build/native/asan/``), as ``runtime/native.py``
does; a value it does not know raises its EnvVarError.  TB_FASTPATH_DISABLE (any non-empty value)
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
# The default library by (source dir, build dir): after its first load
# a call neither rehashes the sources nor takes the lock (the server
# drain and the flight dump, which may run in a signal handler, call in
# per message).
_DEFAULT: dict[tuple[Path, Path], ctypes.CDLL] = {}
_lock = threading.RLock()
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
    # The server drain's frame verify / reply finalize and the hash pool.
    lib.tb_fp_verify_frames.argtypes = [
        _U8P, ctypes.POINTER(ctypes.c_uint64), _U32P, ctypes.c_uint32, _U8P,
    ]
    lib.tb_fp_verify_frames2.restype = ctypes.c_uint64
    lib.tb_fp_verify_frames2.argtypes = [
        _U8P, ctypes.POINTER(ctypes.c_uint64), _U32P, ctypes.c_uint32, _U8P,
    ]
    lib.tb_fp_finalize_headers.argtypes = [
        _U8P, ctypes.c_uint32, ctypes.POINTER(_U8P), _U32P,
    ]
    lib.tb_hash_configure.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.tb_hash_engine.restype = ctypes.c_int32
    lib.tb_hash_engine.argtypes = []
    lib.tb_hash_stats.argtypes = [_U64P]
    # The VSR commit pipeline (csrc/host/tb_pipeline.cpp).
    lib.tb_pl_abi_version.restype = ctypes.c_uint32
    lib.tb_pl_abi_version.argtypes = []
    lib.tb_pl_create.restype = ctypes.c_void_p
    lib.tb_pl_create.argtypes = []
    lib.tb_pl_destroy.argtypes = [ctypes.c_void_p]
    lib.tb_pl_reset.argtypes = [ctypes.c_void_p]
    lib.tb_pl_size.restype = ctypes.c_uint32
    lib.tb_pl_size.argtypes = [ctypes.c_void_p]
    lib.tb_pl_build_prepare.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, _U8P,
    ]
    lib.tb_pl_build_prepare_ok.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, _U8P,
    ]
    lib.tb_pl_frame_prepare.restype = ctypes.c_uint64
    lib.tb_pl_frame_prepare.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        _U8P, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        _U8P, _U8P,
    ]
    lib.tb_pl_note_prepare.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_uint32,
    ]
    lib.tb_pl_on_ack.restype = ctypes.c_int
    lib.tb_pl_on_ack.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tb_pl_mark_all_synced.argtypes = [ctypes.c_void_p]
    lib.tb_pl_set_synced.restype = ctypes.c_int
    lib.tb_pl_set_synced.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.tb_pl_drop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tb_pl_commit_ready.restype = ctypes.c_int
    lib.tb_pl_commit_ready.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.tb_pl_votes.restype = ctypes.c_uint32
    lib.tb_pl_votes.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    # The drain loop's batch family.
    lib.tb_pl_build_prepares.restype = ctypes.c_int64
    lib.tb_pl_build_prepares.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_U8P),
        _U64P, _U64P, _U64P, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_uint32, _U8P,
        _U8P, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        _U8P, ctypes.c_uint64, _U64P, _U64P, _U64P, _U8P, _U64P,
    ]
    lib.tb_pl_accept_prepares.restype = ctypes.c_int64
    lib.tb_pl_accept_prepares.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_U8P), _U64P,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, _U8P,
        _U8P, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        _U8P, ctypes.c_uint64, _U64P, _U64P, _U64P, _U8P, _U64P,
    ]
    lib.tb_pl_on_acks.restype = ctypes.c_int64
    lib.tb_pl_on_acks.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, _I64P,
    ]
    lib.tb_pl_commit_ready_run.restype = ctypes.c_uint64
    lib.tb_pl_commit_ready_run.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
    ]


def load(src: Path | None = None, out_dir: Path | None = None) -> ctypes.CDLL:
    """The library built from the sources of `src` into `out_dir`
    (default: the package's csrc/host/ into build/native/), built first
    when missing; raises NativeFastpathError when it cannot be built or
    loaded."""
    sanitize = envcheck.native_sanitize()
    default = src is None and out_dir is None
    src = host_build.HOST_SRC if src is None else src
    out_dir = host_build.BUILD_DIR if out_dir is None else out_dir
    if default:
        lib = _DEFAULT.get((src, out_dir))
        if lib is not None:
            return lib
    with _lock:
        try:
            path, seconds = host_build.build(src, out_dir, sanitize=sanitize)
        except host_build.NativeBuildError as exc:
            raise NativeFastpathError(f"native fast path build failed: {exc}") from exc
        lib = _LOADED.get(path)
        if lib is not None:
            if default:
                _DEFAULT[(src, out_dir)] = lib
            return lib
        try:
            lib = ctypes.CDLL(str(path))
            _register(lib)
        except (OSError, AttributeError) as exc:
            raise NativeFastpathError(f"native fast path load failed ({path}): {exc}") from exc
        _LOADED[path] = lib
        # The validated pool sizing goes down at load: C never reads
        # the environment itself.
        lib.tb_hash_configure(envcheck.hash_threads(), 0)
        if default:
            build_info.update(path=str(path), digest=host_build.digest(src, sanitize=sanitize),
                              seconds=seconds)
            _DEFAULT[(src, out_dir)] = lib
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


# ----------------------------------------------------------------------
# Columnar ingest: batch frame verification + batch reply finalize
# (the server-drain half of the fast path — runtime/server.py).


def batch_verify_available() -> bool:
    """True unless TB_FASTPATH_DISABLE is set (the drain then verifies
    frames with hashlib)."""
    return _load() is not None


def verify_frames(arena: np.ndarray, offsets: np.ndarray,
                  lens: np.ndarray, n: int):
    """One native pass over `n` frames packed in `arena`: header +
    body checksums, version, size — exactly wire.verify_header per
    frame.  -> u8 ok flags, or None under TB_FASTPATH_DISABLE (caller
    takes the vectorized Python fallback).  The flag
    buffer is allocated per call: several buses poll concurrently in
    one process (in-process test clusters, router + shards) and
    ctypes releases the GIL during the C pass — a shared module
    buffer raced."""
    lib = _load()
    if lib is None:
        return None
    ok = np.empty(n, np.uint8)
    offsets = np.ascontiguousarray(offsets[:n], np.uint64)
    lens = np.ascontiguousarray(lens[:n], np.uint32)
    lib.tb_fp_verify_frames(
        ctypes.cast(arena.ctypes.data, _U8P),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _p(lens, _U32P), n, _p(ok, _U8P),
    )
    return ok


def verify_frames2(arena: np.ndarray, offsets: np.ndarray,
                   lens: np.ndarray, n: int):
    """Counted verify: same contract as verify_frames, plus the call
    opens a new digest-table crossing (verified body digests are cached
    for the build seams, the previous drain's entries die) and returns
    the body bytes hashed.  -> (ok u8 flags, bytes_hashed), or None
    under TB_FASTPATH_DISABLE."""
    lib = _load()
    if lib is None:
        return None
    ok = np.empty(n, np.uint8)
    offsets = np.ascontiguousarray(offsets[:n], np.uint64)
    lens = np.ascontiguousarray(lens[:n], np.uint32)
    bytes_hashed = lib.tb_fp_verify_frames2(
        ctypes.cast(arena.ctypes.data, _U8P),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _p(lens, _U32P), n, _p(ok, _U8P),
    )
    return ok, int(bytes_hashed)


def verify_frames_py2(arena: np.ndarray, offsets: np.ndarray,
                      lens: np.ndarray, n: int,
                      hdrs: np.ndarray | None = None):
    """Pure-Python vectorized fallback: structural checks (version,
    size) in one numpy pass, checksums per frame via hashlib (C-speed
    SHA-256 — the same hashes the legacy path paid, minus its
    per-message numpy/dispatch churn).  Pass `hdrs` when the caller
    already gathered the header records (verify_and_gather) so the
    fallback arm doesn't pay the gather twice.  Returns (ok u8 flags,
    body bytes hashed) — the byte count matches the native pass by
    construction (a frame failing the header checksum never reaches
    its body hash)."""
    from tigerbeetle_tpu_torch.vsr import wire

    if hdrs is None:
        hdrs = wire.headers_from_arena(arena, offsets, n)
    ok = (
        (hdrs["version"] == wire.VERSION)
        & (hdrs["size"] == lens[:n])
        & (lens[:n] >= np.uint32(256))
    )
    bytes_hashed = 0
    mv = memoryview(arena)  # zero-copy per-frame slices
    for i in np.nonzero(ok)[0]:
        off = int(offsets[i])
        size = int(lens[i])
        frame = mv[off : off + size]
        c = wire.checksum(frame[16:256])
        if (
            int(hdrs[i]["checksum_lo"]) != c & 0xFFFFFFFFFFFFFFFF
            or int(hdrs[i]["checksum_hi"]) != c >> 64
        ):
            ok[i] = False
            continue
        bytes_hashed += size - 256
        cb = wire.checksum(frame[256:])
        if (
            int(hdrs[i]["checksum_body_lo"]) != cb & 0xFFFFFFFFFFFFFFFF
            or int(hdrs[i]["checksum_body_hi"]) != cb >> 64
        ):
            ok[i] = False
    return ok.astype(np.uint8), bytes_hashed


def verify_frames_py(arena: np.ndarray, offsets: np.ndarray,
                     lens: np.ndarray, n: int,
                     hdrs: np.ndarray | None = None) -> np.ndarray:
    """verify_frames_py2 without the byte count."""
    return verify_frames_py2(arena, offsets, lens, n, hdrs=hdrs)[0]


def verify_and_gather(arena: np.ndarray, moffs: np.ndarray,
                      mlens: np.ndarray):
    """The shared drain-decode sequence (server dispatch + open-loop
    client completions): one batch checksum pass over the message
    frames — native, or the vectorized Python fallback — plus one
    vectorized header gather.  -> (ok u8 flags, (n,) HEADER_DTYPE
    records, native bool, body bytes hashed)."""
    from tigerbeetle_tpu_torch.vsr import wire

    n = len(moffs)
    hdrs = wire.headers_from_arena(arena, moffs, n)
    res = verify_frames2(arena, moffs, mlens, n)
    if res is not None:
        ok, bytes_hashed = res
        return ok, hdrs, True, bytes_hashed
    ok, bytes_hashed = verify_frames_py2(arena, moffs, mlens, n, hdrs=hdrs)
    return ok, hdrs, False, bytes_hashed


# ----------------------------------------------------------------------
# Native commit pipeline: per-prepare header construction, journal
# append framing, and the primary's in-flight slot table live in
# csrc/host/tb_pipeline.cpp; VsrReplica (vsr/multi.py) keeps view
# changes, checkpoints, and recovery.  The differential contract is
# absolute: TB_NATIVE_PIPELINE=0/1 must produce bit-identical frames.

# Expected tb_pl_abi_version() (the reference's ABI 3: the drain loop's
# batch family and the digest-reuse flags word).  tb_pipeline.cpp and
# the bindings below change together.
PIPELINE_ABI = 3


def pipeline_error() -> str | None:
    """Why the native pipeline cannot serve although the library loaded
    (an ABI that disagrees with the bindings), else None."""
    lib = _load()
    if lib is None:
        return None  # TB_FASTPATH_DISABLE: the pure-Python path
    got = int(lib.tb_pl_abi_version())
    if got != PIPELINE_ABI:
        return (
            f"libtb_fastpath pipeline ABI {got} != expected {PIPELINE_ABI}: "
            "csrc/host/tb_pipeline.cpp and runtime/fastpath.py disagree"
        )
    return None


def pipeline_available() -> bool:
    lib = _load()
    return lib is not None and pipeline_error() is None


def drain_error() -> str | None:
    """Why the native drain loop cannot serve, else None (the batch
    symbols ship with the pipeline, so this is pipeline_error())."""
    return pipeline_error()


def drain_available() -> bool:
    lib = _load()
    return lib is not None and drain_error() is None


def create_pipeline():
    """A NativePipeline for one VsrReplica, or None under
    TB_FASTPATH_DISABLE (pure-Python path).  A library whose pipeline
    ABI disagrees raises."""
    lib = _load()
    if lib is None:
        return None
    err = pipeline_error()
    if err is not None:
        raise RuntimeError(err)
    return NativePipeline(lib)


class NativePipeline:
    """One native in-flight slot table + header builder per replica.

    Headers cross the boundary as raw 256-byte buffers; built headers
    come back as fresh HEADER_DTYPE records (bit-identical to the
    wire.make_header/copy_trace/finalize_header sequence)."""

    def __init__(self, lib) -> None:
        from tigerbeetle_tpu_torch.vsr.wire import HEADER_DTYPE

        self._lib = lib
        self._pl = lib.tb_pl_create()
        assert self._pl, "tb_pl_create failed"
        self._dtype = HEADER_DTYPE

    def __del__(self):  # noqa: D105
        try:
            if getattr(self, "_pl", None):
                self._lib.tb_pl_destroy(self._pl)
                self._pl = None
        # tbcheck: allow(broad-except): __del__ at interpreter
        # teardown — the lib handle may already be gone.
        except Exception:
            pass

    def build_prepare(self, request: np.void, body: bytes, *, cluster: int,
                      view: int, op: int, commit: int, timestamp: int,
                      parent: int, replica: int, context: int,
                      release: int, reuse: bool = False) -> np.void:
        out = np.empty(1, self._dtype)
        self._lib.tb_pl_build_prepare(
            request.tobytes(), body, len(body),
            cluster & 0xFFFFFFFFFFFFFFFF, cluster >> 64, view, op,
            commit, timestamp, parent & 0xFFFFFFFFFFFFFFFF, parent >> 64,
            replica, context, release, 1 if reuse else 0,
            ctypes.cast(out.ctypes.data, _U8P),
        )
        return out[0]

    def build_prepare_ok(self, prepare: np.void, view: int,
                         replica: int) -> np.void:
        out = np.empty(1, self._dtype)
        self._lib.tb_pl_build_prepare_ok(
            prepare.tobytes(), view, replica,
            ctypes.cast(out.ctypes.data, _U8P),
        )
        return out[0]

    def note_prepare(self, header: np.void, synced: bool,
                     self_replica: int) -> None:
        self._lib.tb_pl_note_prepare(
            self._pl, header.tobytes(), 1 if synced else 0, self_replica
        )

    def on_ack(self, header: np.void) -> int | None:
        """Vote count after recording the ack, or None when the op has
        no in-flight entry / the checksum names a stale sibling — the
        same cases _on_prepare_ok drops."""
        votes = self._lib.tb_pl_on_ack(self._pl, header.tobytes())
        return None if votes < 0 else int(votes)

    def on_acks(self, headers: np.ndarray, cluster: int,
                view: int) -> tuple[int, np.ndarray]:
        """Vote a contiguous run of prepare_ok headers in one call.
        Returns (accepted_count, verdicts) where verdicts[i]
        is the entry's vote count after ack i, or negative for the
        drops the per-ack path also takes: -4 foreign cluster, -3
        stale/future view, -1 unknown op, -2 stale-sibling checksum."""
        k = len(headers)
        assert headers.dtype.itemsize == 256
        out = np.empty(k, np.int64)
        accepted = self._lib.tb_pl_on_acks(
            self._pl, headers.tobytes(), k,
            cluster & 0xFFFFFFFFFFFFFFFF, cluster >> 64, view,
            _p(out, _I64P),
        )
        return int(accepted), out

    def commit_ready_run(self, commit_min: int, quorum: int) -> int:
        """Length of the contiguous commit-ready run above commit_min
        — tb_pl_commit_ready extended to the whole drain."""
        return int(
            self._lib.tb_pl_commit_ready_run(self._pl, commit_min, quorum)
        )

    def mark_all_synced(self) -> None:
        self._lib.tb_pl_mark_all_synced(self._pl)

    def set_synced(self, op: int, synced: bool) -> bool:
        return self._lib.tb_pl_set_synced(
            self._pl, op, 1 if synced else 0
        ) == 0

    def drop(self, op: int) -> None:
        self._lib.tb_pl_drop(self._pl, op)

    def commit_ready(self, commit_min: int, quorum: int) -> bool:
        return bool(self._lib.tb_pl_commit_ready(self._pl, commit_min, quorum))

    def votes(self, op: int) -> int:
        return int(self._lib.tb_pl_votes(self._pl, op))

    def reset(self) -> None:
        self._lib.tb_pl_reset(self._pl)

    def size(self) -> int:
        return int(self._lib.tb_pl_size(self._pl))


def frame_prepare(header: np.void, body: bytes, headers_ring: np.ndarray,
                  slot: int, headers_per_sector: int, sector_size: int,
                  out_prepare: np.ndarray, out_sector: np.ndarray) -> int:
    """Journal append framing in one C pass: builds the sector-padded
    prepare buffer into `out_prepare` (returns the padded length),
    writes `headers_ring[slot] = header` in place, and builds the
    slot's redundant-header sector into `out_sector` — byte-identical
    to journal.write_prepare's Python framing.  Caller guarantees the
    library is loaded (pipeline_available())."""
    lib = _load()
    assert headers_ring.flags["C_CONTIGUOUS"]
    return int(lib.tb_pl_frame_prepare(
        header.tobytes(), body, len(body),
        ctypes.cast(headers_ring.ctypes.data, _U8P), slot,
        headers_per_sector, sector_size,
        ctypes.cast(out_prepare.ctypes.data, _U8P),
        ctypes.cast(out_sector.ctypes.data, _U8P),
    ))


def _padded_total(body_lens: np.ndarray, sector_size: int) -> int:
    """Sum of sector-padded prepare sizes — sized exactly like the C
    side's capacity check so a successful allocation here can never
    overflow there."""
    msgs = body_lens + np.uint64(256 + sector_size - 1)
    return int((msgs // np.uint64(sector_size)).sum()) * sector_size


def build_prepares(pl: NativePipeline, req_hdrs: np.ndarray, bodies: list,
                   timestamps: np.ndarray, contexts: np.ndarray, *,
                   cluster: int, view: int, op0: int, commit: int,
                   parent: int, replica: int, release: int, synced: bool,
                   headers_ring: np.ndarray, slot_count: int,
                   headers_per_sector: int, sector_size: int,
                   reuse: bool = False):
    """One C call for a whole drain's prepare builds: K headers
    chained parent->checksum, registered in the slot table with the
    self-vote, and framed for the journal.  Returns (prepares, frames)
    where `prepares` is a (K,) HEADER_DTYPE array and `frames` is the
    WAL write-descriptor tuple (wal_arena, wal_off, wal_len, slots,
    sector_arena, sector_index), or None on arena overflow (caller
    loops the per-prepare path; nothing was mutated)."""
    lib = _load()
    k = len(bodies)
    assert req_hdrs.dtype.itemsize == 256 and req_hdrs.flags["C_CONTIGUOUS"]
    assert headers_ring.flags["C_CONTIGUOUS"]
    ptrs = (_U8P * k)(
        *[ctypes.cast(ctypes.c_char_p(b), _U8P) for b in bodies]
    )
    blens = np.array([len(b) for b in bodies], np.uint64)
    ts = np.ascontiguousarray(timestamps, np.uint64)
    ctx = np.ascontiguousarray(contexts, np.uint64)
    from tigerbeetle_tpu_torch.vsr.wire import HEADER_DTYPE

    prepares = np.empty(k, HEADER_DTYPE)
    wal_arena = np.zeros(_padded_total(blens, sector_size), np.uint8)
    sector_arena = np.zeros(k * sector_size, np.uint8)
    wal_off = np.empty(k, np.uint64)
    wal_len = np.empty(k, np.uint64)
    slots = np.empty(k, np.uint64)
    sector_index = np.empty(k, np.uint64)
    rc = lib.tb_pl_build_prepares(
        pl._pl, req_hdrs.tobytes(), ptrs, _p(blens, _U64P),
        _p(ts, _U64P), _p(ctx, _U64P), k,
        cluster & 0xFFFFFFFFFFFFFFFF, cluster >> 64, view, op0, commit,
        parent & 0xFFFFFFFFFFFFFFFF, parent >> 64, replica, release,
        1 if synced else 0, 1 if reuse else 0,
        ctypes.cast(prepares.ctypes.data, _U8P),
        ctypes.cast(headers_ring.ctypes.data, _U8P), slot_count,
        headers_per_sector, sector_size,
        ctypes.cast(wal_arena.ctypes.data, _U8P), len(wal_arena),
        _p(wal_off, _U64P), _p(wal_len, _U64P), _p(slots, _U64P),
        ctypes.cast(sector_arena.ctypes.data, _U8P),
        _p(sector_index, _U64P),
    )
    if rc < 0:
        return None
    return prepares, (wal_arena, wal_off, wal_len, slots, sector_arena,
                      sector_index)


def accept_prepares(hdrs: np.ndarray, bodies: list, *, view: int,
                    replica: int, build_oks: bool,
                    headers_ring: np.ndarray, slot_count: int,
                    headers_per_sector: int, sector_size: int):
    """One C call for a backup drain's accepted-prepare run:
    frame K prepares for the journal and build their prepare_ok
    headers.  Returns (oks, frames) — `oks` a (K,) HEADER_DTYPE array
    (contents undefined when build_oks=False) and `frames` as in
    build_prepares — or None on arena overflow (nothing mutated)."""
    lib = _load()
    k = len(bodies)
    assert hdrs.dtype.itemsize == 256 and hdrs.flags["C_CONTIGUOUS"]
    assert headers_ring.flags["C_CONTIGUOUS"]
    ptrs = (_U8P * k)(
        *[ctypes.cast(ctypes.c_char_p(b), _U8P) for b in bodies]
    )
    blens = np.array([len(b) for b in bodies], np.uint64)
    from tigerbeetle_tpu_torch.vsr.wire import HEADER_DTYPE

    oks = np.empty(k, HEADER_DTYPE)
    wal_arena = np.zeros(_padded_total(blens, sector_size), np.uint8)
    sector_arena = np.zeros(k * sector_size, np.uint8)
    wal_off = np.empty(k, np.uint64)
    wal_len = np.empty(k, np.uint64)
    slots = np.empty(k, np.uint64)
    sector_index = np.empty(k, np.uint64)
    rc = lib.tb_pl_accept_prepares(
        hdrs.tobytes(), ptrs, _p(blens, _U64P), k, view, replica,
        1 if build_oks else 0,
        ctypes.cast(oks.ctypes.data, _U8P),
        ctypes.cast(headers_ring.ctypes.data, _U8P), slot_count,
        headers_per_sector, sector_size,
        ctypes.cast(wal_arena.ctypes.data, _U8P), len(wal_arena),
        _p(wal_off, _U64P), _p(wal_len, _U64P), _p(slots, _U64P),
        ctypes.cast(sector_arena.ctypes.data, _U8P),
        _p(sector_index, _U64P),
    )
    if rc < 0:
        return None
    return oks, (wal_arena, wal_off, wal_len, slots, sector_arena,
                 sector_index)


def finalize_headers(headers: np.ndarray, bodies: list) -> bool:
    """Batch reply finalize: set size + checksum_body + checksum on
    each 256-byte header record in the contiguous `headers` array for
    its body in `bodies` — one C call instead of 2n hashlib calls.
    Returns False under TB_FASTPATH_DISABLE (caller loops
    wire.finalize_header)."""
    lib = _load()
    if lib is None:
        return False
    n = len(headers)
    assert headers.dtype.itemsize == 256 and headers.flags["C_CONTIGUOUS"]
    assert len(bodies) == n
    ptrs = (_U8P * n)(
        *[ctypes.cast(ctypes.c_char_p(b), _U8P) for b in bodies]
    )
    blens = np.array([len(b) for b in bodies], np.uint32)
    lib.tb_fp_finalize_headers(
        ctypes.cast(headers.ctypes.data, _U8P), n, ptrs, _p(blens, _U32P)
    )
    return True


# ----------------------------------------------------------------------
# Hash-once commit path: pool configuration, engine
# identity, and the scalar-fallback forensics.

# tb_hash_engine() codes (csrc/host/sha256.h Sha256Engine).
HASH_ENGINE_NAMES = {1: "evp", 2: "sha256-legacy", 3: "scalar"}

_scalar_warned = False


def configure_hash(threads: int | None = None, force_engine: int = 0) -> bool:
    """(Re)apply the hash-pool lane count (default: the validated
    TB_HASH_THREADS) and optionally force a SHA-256 engine tier for
    tests (0 = auto).  Returns False under TB_FASTPATH_DISABLE (inline
    hashlib hashing everywhere — nothing to configure)."""
    lib = _load()
    if lib is None:
        return False
    if threads is None:
        threads = envcheck.hash_threads()
    lib.tb_hash_configure(threads, force_engine)
    return True


def hash_engine_name() -> str:
    """Which SHA-256 implementation the native library dispatches to
    ("evp" = libcrypto EVP one-shot / SHA-NI, "sha256-legacy" =
    libcrypto's compat entry, "scalar" = the portable ~225 MB/s core),
    or "hashlib" when no native library serves the hot path (Python's
    hashlib — itself OpenSSL-backed).  Recorded in bench rows so a
    number can never silently come from the wrong engine."""
    lib = _load()
    if lib is None:
        return "hashlib"
    return HASH_ENGINE_NAMES.get(int(lib.tb_hash_engine()), "unknown")


def hash_scalar_fallback() -> int:
    """1 when the native library resolved NEITHER libcrypto tier and
    every native checksum runs on the 225 MB/s scalar core — surfaced
    as the hash.scalar_fallback gauge plus a one-time RuntimeWarning
    (a silent 8x hash regression must never pass as a normal run)."""
    global _scalar_warned
    if hash_engine_name() != "scalar":
        return 0
    if not _scalar_warned:
        _scalar_warned = True
        import warnings

        warnings.warn(
            "native SHA-256 resolved neither libcrypto's EVP one-shot "
            "nor SHA256(): hashing runs on the ~225 MB/s scalar "
            "fallback core (expect ~8x slower checksums; install a "
            "libcrypto.so to restore SHA-NI dispatch)",
            RuntimeWarning, stacklevel=2,
        )
    return 1


def hash_stats() -> dict:
    """Process-global hash-pool counters: jobs executed on worker
    lanes (hash.lanes_busy), drain-scoped digest-table hits, and the
    configured lane count.  Zeros under TB_FASTPATH_DISABLE."""
    lib = _load()
    if lib is None:
        return {"lane_jobs": 0, "table_hits": 0, "threads": 0}
    out = np.zeros(3, np.uint64)
    lib.tb_hash_stats(_p(out, _U64P))
    return {
        "lane_jobs": int(out[0]),
        "table_hits": int(out[1]),
        "threads": int(out[2]),
    }
