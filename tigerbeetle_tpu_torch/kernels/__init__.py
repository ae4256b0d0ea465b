"""ctypes bindings of the hand-written CUDA kernels, with launch counts.

Every binding takes CUDA tensors the caller has already checked (the
wrappers in ``state_machine/device_kernels.py``,
``state_machine/commitment.py``, ``state_machine/waves.py`` and
``parallel/sharded.py`` do), launches on the current stream of the
device its tensors lie on without synchronising, raises on a non-zero
CUDA status, and adds one to its entry in ``launches``.  Each binding
names its pointers and sizes to the resolved ctypes function itself;
``_launch`` adds the raw handle of the device's current stream and
switches the current device only when the tensors lie on another
card.  Nothing here imports or builds anything until the first
launch.
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
    # K1 / K5 / K6 launched by the G-batch and superbatch launchers
    # (device_kernels.scan_of, staged): counted here, not under their
    # kernels' own names.
    "scan_of": 0,
    "staged": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

_SIGNATURES = {
    "orderfree": {
        # table, meta, A, ring_row, pk, mode, n, B, ts_base, words,
        # cap (the scratch's batch), stamps (nullable), stream
        "tb_orderfree": [_P, _P, _I64, _P, _P, _I, _I, _I, _U64, _P, _I, _P, _P],
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
        # table, H, row_bytes, idx, src, k, stream
        "tb_tier_set_rows": [_P, _I64, _I, _P, _P, _I64, _P],
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
        # stream
        "tb_wave_step": [_P, _I64, _P, _I, _P, _I, _P, _I, _U64, _P, _P],
        # ... scratch, lanes per block, grid, stream
        "tb_wave_step_shaped": [_P, _I64, _P, _I, _P, _I, _P, _I, _U64, _P, _I, _I, _P],
    },
    "chain_wave": {
        # table, A, ev, B, plane, P, C, n, ts_base, scratch, stream
        "tb_chain_wave": [_P, _I64, _P, _I, _P, _I, _I, _I, _U64, _P, _P],
    },
    "spec_conflicts": {
        # ev, B, idx, K, serial (nullable), n, A, tok, tgt, tok_n, a_min,
        # r_min, a_n, calls, fresh, out, stream
        "tb_spec_conflicts": [_P, _I, _P, _I, _P, _I, _I64, _P, _P, _I64, _P, _P, _I64, _I64,
                              _I, _P, _P],
    },
    "apply_deltas": {
        # table, A, packed, k, stride, stream
        "tb_apply_deltas": [_P, _I64, _P, _I64, _I64, _P],
    },
    "linked": {
        # table, meta, A, ring_row, pk, n, B, small, slot_idx, words,
        # stamps (nullable), stream
        "tb_linked": [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    },
    "two_phase": {
        # table, meta, A, ring_row, pk, n, B, lo_only, words, cap (the
        # scratch's batch), stream
        "tb_two_phase": [_P, _P, _I64, _P, _P, _I, _I, _I, _P, _I, _P],
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


# The current-device and raw-stream lookups of a CUDA build of torch
# (the CPU build lacks them): resolved at the first launch, never at
# import.  torch._C._cuda_getCurrentRawStream(index) is the handle
# PyTorch's own inductor wrapper passes to its kernels; it builds no
# Stream object.
_current_device = None
_raw_stream = None


def _resolve_cuda() -> None:
    global _current_device, _raw_stream
    _current_device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream


def _launch(lib: str, symbol: str, count_as: str | None, device: int, *args) -> None:
    """Call `symbol` with `args` (data pointers, sizes; None is a null
    pointer) and the current stream of CUDA device `device`, with that
    device current: a shard's tensors may lie on another card than the
    current one.  The device is switched only then, and back after."""
    fn = _FNS.get(symbol) or _fn(lib, symbol)
    if _raw_stream is None:
        _resolve_cuda()
    if device == _current_device():
        rc = fn(*args, _raw_stream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _raw_stream(device))
    if rc != 0:
        msg = _FNS[lib + ".err"](rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc} ({msg})")
    if count_as is not None:
        launches[count_as] += 1


def _ptr(t):
    """A nullable tensor argument's data pointer (None stays NULL)."""
    return None if t is None else t.data_ptr()


def orderfree(table, meta, ring_row_ptr, pk, mode, n, ts_base_u64, scratch,
              count_as="orderfree", stamps=None):
    """K1; `scratch` holds `words` (its hash table) made for a batch of
    `scratch.batch` >= pk.shape[0] events; `stamps` a zeroed CUDA int64
    tensor of orderfree_stamps() words for the stage stamps of a
    measurement, or None."""
    _launch(
        "orderfree", "tb_orderfree", count_as, table.get_device(),
        table.data_ptr(), meta.data_ptr(), table.shape[0], ring_row_ptr, pk.data_ptr(),
        mode, n, pk.shape[0], ts_base_u64, scratch.words.data_ptr(), scratch.batch,
        _ptr(stamps),
    )


def linked(table, meta, ring_row_ptr, pk, n, small, scratch, count_as="linked", stamps=None):
    """K5; `stamps` a CUDA int64 tensor of linked_stamps() words for
    the stage stamps of a measurement, or None."""
    _launch(
        "linked", "tb_linked", count_as, table.get_device(),
        table.data_ptr(), meta.data_ptr(), table.shape[0], ring_row_ptr, pk.data_ptr(), n,
        pk.shape[0], int(small), scratch.slot_idx.data_ptr(), scratch.words.data_ptr(),
        _ptr(stamps),
    )


def two_phase(table, meta, ring_row_ptr, pk, n, lo_only, scratch, count_as="two_phase"):
    """K6; `scratch` holds `words` (its hash table and target segments)
    made for a batch of `scratch.batch` >= pk.shape[0] events."""
    _launch(
        "two_phase", "tb_two_phase", count_as, table.get_device(),
        table.data_ptr(), meta.data_ptr(), table.shape[0], ring_row_ptr, pk.data_ptr(), n,
        pk.shape[0], int(lo_only), scratch.words.data_ptr(), scratch.batch,
    )


def scratch_words(lib: str, batch: int) -> int:
    """u64 words of K1's, K5's or K6's scratch buffer for a
    `batch`-event bucket (the layout is the kernel source's)."""
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
        "commitment", "tb_commit_hash_all", count_as, balances.get_device(),
        balances.data_ptr(), meta.data_ptr(), rows.data_ptr(), balances.shape[0],
        _ptr(row_hash), fold_out.data_ptr(),
    )


def commit_update(balances, meta, row_hash, digest, slots, rows):
    _launch(
        "commitment", "tb_commit_update", "commit_update", balances.get_device(),
        balances.data_ptr(), meta.data_ptr(), row_hash.data_ptr(), digest.data_ptr(),
        slots.data_ptr(), rows.data_ptr(), slots.shape[0],
    )


def commit_admit(row_hash, digest, slots, new_lo, new_hi):
    _launch(
        "commitment", "tb_commit_admit", "commit_admit", row_hash.get_device(),
        row_hash.data_ptr(), row_hash.shape[0], digest.data_ptr(), slots.data_ptr(),
        new_lo.data_ptr(), new_hi.data_ptr(), slots.shape[0],
    )


def tier_set_rows(table, idx, src):
    """K10 over an (H, W) table of 64-byte (8 int64) or 8-byte (2 int32)
    rows; the library refuses any other row size."""
    H, W = table.shape
    _launch(
        "tier", "tb_tier_set_rows", "tier_set_rows", table.get_device(),
        table.data_ptr(), H, W * table.element_size(), idx.data_ptr(), src.data_ptr(),
        idx.shape[0],
    )


def checksum(table, out, row0=0):
    _launch(
        "checksum", "tb_checksum", "checksum", table.get_device(),
        table.data_ptr(), table.shape[0], row0, table.shape[1], table.element_size(),
        out.data_ptr(),
    )


def exact_scan(table, events, dstat_init, n, ts_base_u64, scratch_words, out):
    _launch(
        "exact_scan", "tb_exact_scan", "exact_scan", table.get_device(),
        table.data_ptr(), table.shape[0], events.data_ptr(), events.shape[0],
        dstat_init.data_ptr(), n, ts_base_u64, scratch_words.data_ptr(), out.data_ptr(),
    )


def apply_deltas_geometry(k: int) -> tuple[int, int]:
    """K4's launch for k entries on the current card: (blocks, threads
    per block)."""
    return _geometry("apply_deltas", "tb_apply_deltas_geometry", k, 2)


def apply_deltas(table, packed):
    _launch(
        "apply_deltas", "tb_apply_deltas", "apply_deltas", table.get_device(),
        table.data_ptr(), table.shape[0], packed.data_ptr(), packed.shape[1],
        packed.shape[1],
    )


def l2_chase(next_idx, steps, sink):
    """The dependent-load chase that measures K3's serial floor (a
    measurement, not a kernel of the port: not counted).  `next_idx` is
    a CUDA int32 permutation of its own indices."""
    if next_idx.dtype != torch.int32 or not next_idx.is_cuda or not next_idx.is_contiguous():
        raise ValueError("next_idx must be a contiguous CUDA int32 tensor")
    _launch("exact_scan", "tb_l2_chase", None, next_idx.get_device(),
            next_idx.data_ptr(), steps, sink.data_ptr())


def exact_init(scratch_words, dstat_init):
    """K3's initial carry for a (B,)-row batch in `scratch_words`."""
    _launch(
        "exact_scan", "tb_exact_init", "exact_init", scratch_words.get_device(),
        scratch_words.data_ptr(), dstat_init.shape[0], dstat_init.data_ptr(),
    )


def exact_segment(table, events, rows, n, ts_base_u64, scratch_words):
    """A K3 scan segment over the int32 global event indices `rows`."""
    _launch(
        "exact_scan", "tb_exact_segment", "exact_segment", table.get_device(),
        table.data_ptr(), table.shape[0], events.data_ptr(), events.shape[0],
        rows.data_ptr(), rows.shape[0], n, ts_base_u64, scratch_words.data_ptr(),
    )


def exact_finalize(table, batch, scratch_words, hist_fix, out):
    """The packed outputs of the carry; `hist_fix` a (B,) uint8 mask or
    None."""
    _launch(
        "exact_scan", "tb_exact_finalize", "exact_finalize", table.get_device(),
        table.data_ptr(), table.shape[0], batch, scratch_words.data_ptr(),
        _ptr(hist_fix), out.data_ptr(),
    )


def _stamps(lib: str) -> int:
    symbol = f"tb_{lib}_stamps"
    fn = _FNS.get(symbol)
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        fn = getattr(build.load(lib), symbol)
        fn.argtypes = []
        fn.restype = _I
        _FNS[symbol] = fn
    return int(fn())


def linked_stamps() -> int:
    """Words of K5's stage-stamp buffer."""
    return _stamps("linked")


def orderfree_stamps() -> int:
    """Words of K1's stage-stamp buffer."""
    return _stamps("orderfree")


def _geometry(lib: str, symbol: str, size: int, width: int) -> tuple[int, ...]:
    fn = _FNS.get(symbol)
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        fn = getattr(build.load(lib), symbol)
        fn.argtypes = [_I, ctypes.POINTER(_I)]
        fn.restype = _I
        _FNS[symbol] = fn
    geom = (_I * width)()
    fn(size, geom)
    return tuple(geom)


def orderfree_geometry(B: int) -> tuple[int, int, int]:
    """K1's launch for a B-event batch on the current card: (blocks of
    its cooperative grid, threads per block, dynamic shared-memory
    bytes)."""
    return _geometry("orderfree", "tb_orderfree_geometry", B, 3)


def exact_finalize_geometry(B: int) -> tuple[int, int]:
    """K3 finalize's launch for a B-row batch: (blocks, threads per
    block)."""
    return _geometry("exact_scan", "tb_exact_finalize_geometry", B, 2)


def two_phase_geometry(B: int) -> tuple[int, int, int]:
    """K6's launch for a B-event batch on the current card: (blocks of
    its cooperative grid, threads per block, dynamic shared-memory
    bytes)."""
    return _geometry("two_phase", "tb_two_phase_geometry", B, 3)


def linked_geometry(B: int) -> tuple[int, int, int]:
    """K5's launch for a B-event batch: (blocks in its one cluster,
    threads per block, dynamic shared-memory bytes)."""
    return _geometry("linked", "tb_linked_geometry", B, 3)


def wave_step(table, events, idx, mask, n, ts_base_u64, scratch_words, shape=None):
    """K7; `shape` (lanes per block, grid) forces a launch shape (the
    probes' comparison; not counted), None takes the kernel's own."""
    args = (table.data_ptr(), table.shape[0], events.data_ptr(), events.shape[0],
            idx.data_ptr(), idx.shape[0], _ptr(mask), n, ts_base_u64, scratch_words.data_ptr())
    if shape is None:
        _launch("wave_step", "tb_wave_step", "wave_step", table.get_device(), *args)
    else:
        _launch("wave_step", "tb_wave_step_shaped", None, table.get_device(), *args,
                int(shape[0]), int(bool(shape[1])))


def wave_step_geometry(K: int) -> tuple[int, int, int, int]:
    """K7's launch for a K-lane wave: (blocks, threads per block,
    barrier: 0 one block, 1 cluster, 2 cooperative grid, lanes per
    block)."""
    return _geometry("wave_step", "tb_wave_step_geometry", K, 4)


def chain_wave(table, events, plane, n, ts_base_u64, scratch_words):
    _launch(
        "chain_wave", "tb_chain_wave", "chain_wave", table.get_device(),
        table.data_ptr(), table.shape[0], events.data_ptr(), events.shape[0],
        plane.data_ptr(), plane.shape[0], plane.shape[1], n, ts_base_u64,
        scratch_words.data_ptr(),
    )


def chain_wave_geometry(C: int) -> tuple[int, int]:
    """K8's launch for a C-chain wave: (blocks in its one cluster,
    threads per block)."""
    return _geometry("chain_wave", "tb_chain_wave_geometry", C, 2)


def spec_conflicts(events, idx, serial, n, A, tok, tgt, a_min, r_min, calls, fresh, out):
    """K9: one cooperative launch; `tok` / `tgt` and `a_min` / `r_min`
    its tagged minima arrays (int32, read as u32), `calls` the calls
    made on them before, `fresh` true when they hold nothing of K9's."""
    _launch(
        "spec_conflicts", "tb_spec_conflicts", "spec_conflicts", events.get_device(),
        events.data_ptr(), events.shape[0], idx.data_ptr(), idx.shape[0], _ptr(serial), n, A,
        tok.data_ptr(), tgt.data_ptr(), tok.shape[0], a_min.data_ptr(), r_min.data_ptr(),
        a_min.shape[0], calls, int(fresh), out.data_ptr(),
    )


def spec_conflicts_geometry(K: int) -> tuple[int, int]:
    """K9's launch for K lanes: (blocks of its cooperative grid, threads
    per block)."""
    return _geometry("spec_conflicts", "tb_spec_conflicts_geometry", K, 2)


def spec_conflicts_cycle() -> int:
    """The K9 calls a tag cycle lasts: call c on a scratch takes tag
    c % cycle + 1, and the call that takes tag 1 fills its arrays."""
    fn = _FNS.get("tb_spec_conflicts_cycle")
    if fn is None:
        from tigerbeetle_tpu_torch.kernels import build

        fn = build.load("spec_conflicts").tb_spec_conflicts_cycle
        fn.argtypes, fn.restype = [], _I
        _FNS["tb_spec_conflicts_cycle"] = fn
    return fn()


def shard_accumulate(acc, row0, dr, cr, lo, hi, pending, mask):
    _launch(
        "shard_apply", "tb_shard_accumulate", "shard_accumulate", acc.get_device(),
        acc.data_ptr(), acc.shape[0], row0, dr.data_ptr(), cr.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), pending.data_ptr(), _ptr(mask), dr.shape[0],
    )


def shard_admit(table, acc, row0, dr, cr, reject):
    _launch(
        "shard_apply", "tb_shard_admit", "shard_admit", table.get_device(),
        table.data_ptr(), acc.data_ptr(), table.shape[0], row0, dr.data_ptr(), cr.data_ptr(),
        dr.shape[0], reject.data_ptr(),
    )


def shard_apply(table, acc):
    _launch("shard_apply", "tb_shard_apply", "shard_apply", table.get_device(),
            table.data_ptr(), acc.data_ptr(), table.shape[0])


def shard_gather(table, row0, slots, out):
    """K14 gather over an (local_rows, W) int64 table: W u64 words per row."""
    local_rows, W = table.shape
    _launch(
        "shard_rows", "tb_shard_gather", "shard_gather", table.get_device(),
        table.data_ptr(), local_rows, row0, slots.data_ptr(), slots.shape[0], W,
        out.data_ptr(),
    )


def shard_scatter(table, row0, slots, rows):
    local_rows, W = table.shape
    _launch(
        "shard_rows", "tb_shard_scatter", "shard_scatter", table.get_device(),
        table.data_ptr(), local_rows, row0, slots.data_ptr(), slots.shape[0], W,
        rows.data_ptr(),
    )
