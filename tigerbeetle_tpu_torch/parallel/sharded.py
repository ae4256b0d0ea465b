"""Row-sharded balance apply over a mesh of shards.

Counterpart of ``tigerbeetle_tpu/parallel/sharded.py``.  The account
balance table, the only mutable device state, is split row-wise over
the mesh's "shard" axis: shard s owns the rows [s * local_rows,
(s + 1) * local_rows).  An order-free ``create_transfers`` batch is
split over the "dp" axis: each dp group takes one slice of its events.
One step (``build_apply_step``):

1. every (dp, shard) cell sums the candidate u128 deltas of its event
   slice onto the rows the shard owns, in 32-bit limbs so the sums
   cannot wrap (kernel K12, ``csrc/shard_apply.cu``);
2. the sums are combined over dp;
3. each row that would overflow rejects every event touching it (a
   conservative row-granularity admission; kernel K13 admit), the
   reject masks are OR-ed over shard, and an event naming a row no
   shard owns is rejected;
4. the admitted deltas are summed again from scratch and applied to
   the owned rows (K12, then K13 apply).  Removing events only shrinks
   a row's sums, so the admitted sums cannot overflow.

The mesh is single-controller, as the reference's is: one process
drives every device of a ``Mesh``, a grid of ``torch.device``s that may
repeat a device (one card hosting several shards, as the reference's
tests host eight on virtual CPU devices).  The reference's collectives
are explicit here: an all-gather over an axis copies each part onto the
destination device, followed by the exact local sum the reference does
(``_combine``); the any-over-shard is the OR of the gathered masks.
Each shard's table is one tensor, on the shard's device in dp row 0:
the dp replicas the reference keeps compute identical bits, so one copy
serves them.  ``shard_map_kwargs`` has no counterpart: nothing here
runs under ``shard_map``.

``own_rows`` is the one definition of the contiguous row layout; the
row gather (``gather_rows``, kernel K14 ``csrc/shard_rows.cu``, at the
row widths 1, 2 and 8) and the owned-row write-back (``scatter_rows``) of the
sharded wave executors (``state_machine/waves.py``) resolve ownership
through it.  ``ShardedTable`` is the engines' row layer on top of them
(split, join, gather into a compact table on the mesh's first device,
scatter back, per-shard map), and ``row_mesh_for`` the reference's rule
for when an engine's tables shard.  Every kernel has its plain PyTorch
version here: a wrapper launches the kernel on CUDA tensors and runs
the plain version on CPU tensors.  u64 values live in int64 lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.device import resolve_device
from tigerbeetle_tpu_torch.ops import u128 as w

# Delta-column layout: 4 u128 columns per account row.
# debits_pending, debits_posted, credits_pending, credits_posted.
COL_DP, COL_DPO, COL_CP, COL_CPO = range(4)


class Mesh:
    """A grid of torch devices with named axes (the reference's
    ``jax.sharding.Mesh``); ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names) -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes {axis_names}")
        self.devices = grid
        self.shape = dict(zip(axis_names, grid.shape))

    def device(self, shard: int, dp: int = 0) -> torch.device:
        """The device of (dp, shard) cell; a 1-D ("shard",) mesh has dp 0."""
        if "dp" in self.shape:
            return self.devices[dp, shard]
        return self.devices[shard]


def resolve_devices(devices=None) -> list:
    """`devices` as torch devices; None is every visible CUDA device
    (raising without one, as device.resolve_device does)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def make_row_mesh(devices=None) -> Mesh:
    """1-D ("shard",) mesh over `devices`: the row-sharding axis the
    sharded wave executors (``waves._execute_plan_sharded``) partition
    the table over."""
    devs = resolve_devices(devices)
    return Mesh(_grid(devs, (len(devs),)), ("shard",))


def row_mesh_for(rows: int, devices) -> Mesh | None:
    """The ("shard",) mesh an engine's (rows, C) tables split over: None
    (one dense table) unless `devices` holds more than one device and
    `rows` divides among them (the reference's rule,
    device_engine.py:528-537 and kernel_fast.py:107-113)."""
    if devices is None or len(devices) < 2 or rows % len(devices):
        return None
    return make_row_mesh(devices)


def make_mesh(devices=None, dp: int | None = None) -> Mesh:
    """Mesh over `devices` shaped (dp, shard).

    Defaults: dp=2 when the device count allows (so both axes are
    exercised), else a pure "shard" mesh.
    """
    devs = resolve_devices(devices)
    n = len(devs)
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    assert n % dp == 0, (n, dp)
    return Mesh(_grid(devs, (dp, n // dp)), ("dp", "shard"))


def own_rows(slots, local_rows: int, shard: int):
    """For global row indices `slots`, (local, rel): the mask of rows
    `shard` owns and their clipped shard-local indices.  The ONE
    definition of the contiguous row layout (the reference reads the
    shard from lax.axis_index; here the caller names it)."""
    row0 = shard * local_rows
    local = (slots >= row0) & (slots < row0 + local_rows)
    rel = (slots - row0).clamp(0, local_rows - 1)
    return local, rel


def _combine(parts, device):
    """All-gather onto `device` and the exact local sum (int64 lanes
    wrap as u64 does, so the sum holds the u64 bits).  The parts are
    fresh tensors, so the sum accumulates into the first in place."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out.add_(p.to(device))
    return out


ROW_WIDTHS = (1, 2, 8)  # K14's row widths: meta, row hashes, balances


def _check_rows(table, slots, name):
    """K14's checks of a shard table and its slots; returns the table's
    device and shape.  Each attribute is read once (they run ahead of
    every launch of the row layer)."""
    shape = table.shape
    if table.dtype is not torch.int64 or len(shape) != 2 or shape[1] not in ROW_WIDTHS:
        raise ValueError(f"local table must be (local_rows, W) int64 with W in {ROW_WIDTHS}, "
                         f"got {tuple(shape)} {table.dtype}")
    if slots.dtype is not torch.int64 or slots.ndim != 1:
        raise ValueError(f"{name}: slots must be (K,) int64")
    dev = table.device
    if slots.device != dev or not (table.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous and on one device")
    return dev, shape


# ---------------------------------------------------------------------------
# K14: a shard's part of a row gather, and the owned-row write-back, for
# (local_rows, W) int64 tables of the row layer's widths (the engine's
# balances, W = 8; its meta seen as one int64 per row, W = 1; its row
# hashes, W = 2).


def gather_part_plain(local_table, slots, shard: int):
    """Plain version of K14 gather: the (K, W) owned rows of the global
    `slots`, zeros where `shard` does not own the row (a slot outside
    every shard, -1 included, gathers zeros)."""
    local, rel = own_rows(slots, local_table.shape[0], shard)
    return torch.where(local[:, None], local_table[rel], 0)


def gather_part(local_table, slots, shard: int):
    """K14 gather on CUDA tensors (raising on any CUDA error);
    gather_part_plain on CPU tensors."""
    _check_rows(local_table, slots, "gather")
    if local_table.is_cpu:
        return gather_part_plain(local_table, slots, shard)
    out = torch.empty((slots.shape[0], local_table.shape[1]), dtype=torch.int64,
                      device=local_table.device)
    if slots.shape[0]:
        kernels.shard_gather(local_table, shard * local_table.shape[0], slots, out)
    return out


def scatter_part_plain(local_table, slots, rows, shard: int) -> None:
    """Plain version of K14 scatter: the rows of the distinct global
    `slots` that `shard` owns are overwritten by `rows`; the others
    are dropped.  In place."""
    local, rel = own_rows(slots, local_table.shape[0], shard)
    local_table[rel[local]] = rows[local]


def scatter_part(local_table, slots, rows, shard: int) -> None:
    """K14 scatter on CUDA tensors; scatter_part_plain on CPU tensors."""
    dev, (local_rows, W) = _check_rows(local_table, slots, "scatter")
    K = slots.shape[0]
    if rows.dtype is not torch.int64 or rows.shape != (K, W):
        raise ValueError(f"rows must be (K, {W}) int64")
    if rows.device != dev or not rows.is_contiguous():
        raise ValueError("rows must be contiguous on the table's device")
    if local_table.is_cpu:
        scatter_part_plain(local_table, slots, rows, shard)
        return
    if K:
        kernels.shard_scatter(local_table, shard * local_rows, slots, rows)


def gather_rows(local_tables, slots, device=None, plain: bool = False):
    """Cross-shard row gather: the full (K, W) rows of the global row
    indices `slots` ((K,) int64, already clipped to [0, total_rows)) on
    `device` (default: shard 0's).  Each shard contributes the rows it
    owns and zeros elsewhere; gathering the parts and summing them
    recombines the rows exactly, since each row has exactly one owner.
    The reference's runs inside a shard_map body, one table per device;
    this one takes the list of shard tables."""
    part = gather_part_plain if plain else gather_part
    device = local_tables[0].device if device is None else device
    return _combine([part(t, slots.to(t.device), s) for s, t in enumerate(local_tables)],
                    device)


def scatter_rows(local_tables, slots, rows, plain: bool = False) -> None:
    """Write the (K, W) `rows` of the distinct global `slots` back onto
    their owners; every shard keeps only the rows it owns."""
    part = scatter_part_plain if plain else scatter_part
    for s, t in enumerate(local_tables):
        dev = t.device
        part(t, slots if slots.device == dev else slots.to(dev),
             rows if rows.device == dev else rows.to(dev), s)


# ---------------------------------------------------------------------------
# The engines' row layer: one table split over a ("shard",) mesh.


def _words(table: torch.Tensor) -> torch.Tensor:
    """An (R, C) int64 or int32 table as (R, W) int64 words (an int32
    table's row pairs as one word: C must be even)."""
    return table if table.dtype == torch.int64 else table.view(torch.int64)


class ShardedTable:
    """An (A, C) table (int64, or int32 with C even) split row-wise over
    a 1-D ("shard",) mesh: shard s holds rows [s * A / S, (s + 1) * A /
    S) on its device (``own_rows``).  The row layer every sharded engine
    site calls: ``split`` / ``join``, the K14 ``gather`` of global rows
    into a compact table on the home device (the mesh's first) and the
    K14 ``scatter`` back onto the owners, and ``map`` over the shards
    with each one's first global row.  `plain` runs K14's plain
    versions (a reference run on the card)."""

    def __init__(self, mesh: Mesh, shards: list, plain: bool = False) -> None:
        assert len(shards) == mesh.shape["shard"], (len(shards), mesh.shape)
        self.mesh = mesh
        self.shards = shards
        self.plain = plain

    @classmethod
    def split(cls, mesh: Mesh, table: torch.Tensor, plain: bool = False) -> "ShardedTable":
        """`table`'s rows cut into the mesh's shards (copies)."""
        n = mesh.shape["shard"]
        assert table.shape[0] % n == 0, (table.shape[0], n)
        local = table.shape[0] // n
        return cls(mesh, [table[s * local:(s + 1) * local].to(mesh.device(s)).clone()
                          for s in range(n)], plain)

    @property
    def home(self) -> torch.device:
        return self.mesh.device(0)

    @property
    def local_rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def rows(self) -> int:
        return self.local_rows * len(self.shards)

    def join(self) -> torch.Tensor:
        """The whole table on the home device (a copy)."""
        return torch.cat([t.to(self.home) for t in self.shards])

    def gather(self, slots: torch.Tensor) -> torch.Tensor:
        """The (K, C) rows of the global int64 `slots` on the home
        device; zeros where no shard owns a slot (-1, or >= rows)."""
        out = gather_rows([_words(t) for t in self.shards], slots.to(self.home), self.home,
                          plain=self.plain)
        return out.view(self.shards[0].dtype)

    def scatter(self, slots: torch.Tensor, compact: torch.Tensor) -> None:
        """Write the (K, C) `compact` rows of the distinct global `slots`
        onto their owners; a slot no shard owns is dropped."""
        home = self.home
        scatter_rows([_words(t) for t in self.shards],
                     slots if slots.device == home else slots.to(home), _words(compact),
                     plain=self.plain)

    def map(self, fn) -> list:
        """[fn(shard table, its first global row) for every shard]."""
        L = self.local_rows
        return [fn(t, s * L) for s, t in enumerate(self.shards)]

    def owned(self, idx: np.ndarray):
        """For the global rows `idx` (host int64): (shard index, the
        shard's local rows as an int64 tensor on its device, positions
        in `idx`) for every shard that owns any of them (own_rows)."""
        slots = torch.from_numpy(idx)
        for s, t in enumerate(self.shards):
            local, rel = own_rows(slots, self.local_rows, s)
            pos = torch.nonzero(local).flatten()
            if len(pos):
                yield s, rel[pos].to(t.device), pos.numpy()

    def sum(self, parts) -> torch.Tensor:
        """The wrapping int64 sum of per-shard results on the home device
        (the combine of a fold or a digest over shard)."""
        return _combine(parts, self.home)


def compact_rows(slots: np.ndarray, A: int) -> np.ndarray:
    """The sorted global rows of a compact table serving global `slots`:
    each clipped into [0, A), with rows 0 and A - 1 (where a kernel's
    clip of a slot outside the table lands).  A mark per table row, not
    a sort: a window of the sharded engine names ~1.6M slots."""
    mark = np.zeros(A, bool)
    mark[np.clip(slots, 0, A - 1)] = True
    mark[[0, A - 1]] = True
    return np.flatnonzero(mark)


def remap_slots(s: np.ndarray, rows: np.ndarray, A: int) -> np.ndarray:
    """Global slots `s` moved onto the compact table of `rows`
    (compact_rows): a slot in [0, A) becomes its row's position, a
    negative slot stays, a slot s >= A becomes s - A + len(rows).  The
    map is strictly increasing (equal, unequal and ordered slots stay
    so), and a clip into the compact table lands on the row the clip
    into the whole table would."""
    pos = np.searchsorted(rows, np.clip(s, 0, A - 1))
    return np.where(s < 0, s, np.where(s >= A, s - A + len(rows), pos))


def place(table: torch.Tensor, mesh: Mesh | None, plain: bool = False):
    """A dense table as an engine holds it: itself without a mesh, else
    split over the mesh."""
    return table if mesh is None else ShardedTable.split(mesh, table, plain)


def checksum(table, fn) -> torch.Tensor:
    """K11's (16,) digest of a dense or sharded table by `fn` (the
    kernel's wrapper or its plain version, called as fn(table, row0)):
    sharded, `fn` on every shard under its first global row, the words
    summed on the home device (every word is a wrapping sum over
    rows)."""
    if isinstance(table, ShardedTable):
        return table.sum(table.map(fn))
    return fn(table)


def dense(table) -> torch.Tensor:
    """The whole table of a dense or sharded engine table (a copy on the
    home device when sharded)."""
    return table.join() if isinstance(table, ShardedTable) else table


# ---------------------------------------------------------------------------
# K12: masked limb sums of an event slice onto the shard's rows.


def _accumulate(local_rows, row0, dr_slot, cr_slot, amount_lo, amount_hi, is_pending,
                mask=None):
    """Plain version of K12 (the reference's _accumulate): masked
    local-row limb accumulation of one event slice.  Returns
    (local_rows, 4, 4) limb sums in int64 lanes.  Non-local or masked
    events contribute zero (amounts zeroed, row clipped); `mask` None
    is all-ones."""
    acc = torch.zeros((local_rows * 4, 4), dtype=torch.int64, device=dr_slot.device)
    if mask is None:
        mask = torch.ones_like(is_pending)
    for slot, col_p, col_posted in ((dr_slot, COL_DP, COL_DPO), (cr_slot, COL_CP, COL_CPO)):
        local = mask & (slot >= row0) & (slot < row0 + local_rows)
        row = (slot.to(torch.int64) - row0).clamp(0, local_rows - 1)
        col = torch.where(is_pending, col_p, col_posted)
        lo = torch.where(local, amount_lo, 0)
        hi = torch.where(local, amount_hi, 0)
        acc.index_add_(0, row * 4 + col, w.limbs32(lo, hi))
    return acc.view(local_rows, 4, 4)


def _check_events(dr, cr, lo, hi, pending, mask=None):
    E = dr.shape[0]
    for t, dtype, name in ((dr, torch.int32, "dr_slot"), (cr, torch.int32, "cr_slot"),
                           (lo, torch.int64, "amount_lo"), (hi, torch.int64, "amount_hi"),
                           (pending, torch.bool, "is_pending")):
        if t.dtype != dtype or tuple(t.shape) != (E,):
            raise ValueError(f"{name} must be ({E},) {dtype}, got {tuple(t.shape)} {t.dtype}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (E,)):
        raise ValueError(f"mask must be ({E},) bool")
    for t in (dr, cr, lo, hi, pending) + (() if mask is None else (mask,)):
        if t.device != dr.device or not t.is_contiguous():
            raise ValueError("event tensors must be contiguous and on one device")


def accumulate(local_rows, row0, dr_slot, cr_slot, amount_lo, amount_hi, is_pending,
               mask=None):
    """K12 on CUDA tensors (raising on any CUDA error); _accumulate on
    CPU tensors.  Slots int32, amounts int64 (u64 bits), is_pending and
    mask bool."""
    _check_events(dr_slot, cr_slot, amount_lo, amount_hi, is_pending, mask)
    if dr_slot.device.type == "cpu":
        return _accumulate(local_rows, row0, dr_slot, cr_slot, amount_lo, amount_hi,
                           is_pending, mask)
    acc = torch.empty((local_rows, 4, 4), dtype=torch.int64, device=dr_slot.device)
    kernels.shard_accumulate(acc, row0, dr_slot, cr_slot, amount_lo, amount_hi, is_pending,
                             mask)
    return acc


# ---------------------------------------------------------------------------
# K13: per-row overflow -> per-event reject; the apply of admitted sums.


def admit_plain(local_table, acc, row0, dr_slot, cr_slot):
    """Plain version of K13 admit (the reference's local step, :195-206):
    per event, whether a slot this shard owns names a row whose old
    value + dp-combined sums overflow u128 in some column."""
    local_rows = local_table.shape[0]
    d_lo, d_hi, d_carry = w.from_limbs32(acc)  # (local_rows, 4)
    old = (local_table[:, 0::2], local_table[:, 1::2])
    _, carry = w.add(old, (d_lo, d_hi))
    row_over = (carry | (d_carry != 0)).any(dim=1)
    reject = torch.zeros_like(dr_slot, dtype=torch.bool)
    for slot in (dr_slot, cr_slot):
        local = (slot >= row0) & (slot < row0 + local_rows)
        row = (slot.to(torch.int64) - row0).clamp(0, local_rows - 1)
        reject |= local & row_over[row]
    return reject


def admit(local_table, acc, row0, dr_slot, cr_slot):
    """K13 admit on CUDA tensors; admit_plain on CPU tensors.  Returns
    the (E,) bool reject mask of this shard."""
    local_rows = local_table.shape[0]
    if local_table.dtype != torch.int64 or tuple(local_table.shape) != (local_rows, 8):
        raise ValueError("local table must be (local_rows, 8) int64")
    if acc.dtype != torch.int64 or tuple(acc.shape) != (local_rows, 4, 4):
        raise ValueError(f"acc must be ({local_rows}, 4, 4) int64")
    for t in (acc, dr_slot, cr_slot):
        if t.device != local_table.device or not t.is_contiguous():
            raise ValueError("tensors must be contiguous and on one device")
    if dr_slot.dtype != torch.int32 or cr_slot.dtype != torch.int32:
        raise ValueError("slots must be int32")
    if local_table.device.type == "cpu":
        return admit_plain(local_table, acc, row0, dr_slot, cr_slot)
    reject = torch.empty(dr_slot.shape[0], dtype=torch.uint8, device=dr_slot.device)
    kernels.shard_admit(local_table, acc, row0, dr_slot, cr_slot, reject)
    return reject.bool()


def apply_plain(local_table, acc) -> None:
    """Plain version of K13 apply (the reference's :211-217): the table
    += the admitted limb sums, mod 2^128 per column.  In place."""
    a_lo, a_hi, _ = w.from_limbs32(acc)
    (new_lo, new_hi), _ = w.add((local_table[:, 0::2], local_table[:, 1::2]), (a_lo, a_hi))
    local_table[:, 0::2] = new_lo
    local_table[:, 1::2] = new_hi


def apply(local_table, acc) -> None:
    """K13 apply on CUDA tensors; apply_plain on CPU tensors."""
    local_rows = local_table.shape[0]
    if acc.dtype != torch.int64 or tuple(acc.shape) != (local_rows, 4, 4):
        raise ValueError(f"acc must be ({local_rows}, 4, 4) int64")
    if acc.device != local_table.device or not (acc.is_contiguous()
                                                and local_table.is_contiguous()):
        raise ValueError("tensors must be contiguous and on one device")
    if local_table.device.type == "cpu":
        apply_plain(local_table, acc)
        return
    kernels.shard_apply(local_table, acc)


_KERNEL_FNS = {"accumulate": accumulate, "admit": admit, "apply": apply}
_PLAIN_FNS = {"accumulate": _accumulate, "admit": admit_plain, "apply": apply_plain}


# ---------------------------------------------------------------------------
# The step.


def build_apply_step(mesh: Mesh, table_rows: int, plain: bool = False):
    """The sharded apply: (local_tables, dr_slot, cr_slot, amount_lo,
    amount_hi, is_pending) -> (local_tables, admitted).

    `local_tables` is one (table_rows / n_shard, 8) int64 tensor per
    shard (``shard_balances``), updated in place (the reference donates
    it).  Each event argument is one (E / dp,) tensor per dp group
    (``shard_events``).  Returns the tables and the (E,) bool admitted
    mask, concatenated over dp, on the mesh's first device.  `plain`
    runs the plain versions wherever the tensors lie (a reference run
    on the card)."""
    n_shard = mesh.shape["shard"]
    n_dp = mesh.shape.get("dp", 1)
    assert table_rows % n_shard == 0, (table_rows, n_shard)
    local_rows = table_rows // n_shard
    fns = _PLAIN_FNS if plain else _KERNEL_FNS

    def step(local_tables, dr_slot, cr_slot, amount_lo, amount_hi, is_pending):
        assert len(local_tables) == n_shard, (len(local_tables), n_shard)
        slices = list(zip(dr_slot, cr_slot, amount_lo, amount_hi, is_pending))
        assert len(slices) == n_dp, (len(slices), n_dp)

        def combined(s, masks):
            # 1-2 / 4. Every (dp, shard) cell's sums, combined over dp
            # onto the shard's table.
            parts = []
            for d, ev in enumerate(slices):
                dev = mesh.device(s, d)
                mask = None if masks is None else masks[d].to(dev)
                parts.append(fns["accumulate"](local_rows, s * local_rows,
                                               *(t.to(dev) for t in ev), mask=mask))
            return _combine(parts, local_tables[s].device)

        # 3. Per-row overflow -> per-event reject, agreed across shards.
        accs = [combined(s, None) for s in range(n_shard)]
        admitted = []
        for d, (dr, cr, *_rest) in enumerate(slices):
            parts = [fns["admit"](t, accs[s], s * local_rows, dr.to(t.device), cr.to(t.device))
                     for s, t in enumerate(local_tables)]
            home = mesh.device(0, d)
            reject = torch.stack([p.to(home) for p in parts]).any(dim=0)
            # Out-of-range slots belong to no shard: their deltas were
            # dropped above, so they must never read as admitted.
            for slot in (dr.to(home), cr.to(home)):
                reject |= (slot < 0) | (slot >= n_shard * local_rows)
            admitted.append(~reject)
        del accs

        # 4. Apply admitted deltas (monotone: subset sums cannot overflow).
        for s, t in enumerate(local_tables):
            fns["apply"](t, combined(s, admitted))
        first = mesh.device(0, 0)
        return local_tables, torch.cat([a.to(first) for a in admitted])

    return step


def shard_balances(mesh: Mesh, balances: np.ndarray) -> list:
    """A host (rows, 8) u64 balance table as the step's shard tables:
    shard s's rows on its device in dp row 0."""
    n_shard = mesh.shape["shard"]
    rows = balances.shape[0]
    assert rows % n_shard == 0, (rows, n_shard)
    local = rows // n_shard
    return [w.from_u64(balances[s * local:(s + 1) * local]).clone().to(mesh.device(s))
            for s in range(n_shard)]


def _tensor(a: np.ndarray) -> torch.Tensor:
    """Event column -> tensor: slots int32, u64 amounts as int64 bits,
    flags bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy())
    if a.dtype == np.uint64:
        return w.from_u64(a).clone()
    return torch.from_numpy(a.astype(np.int32))


def shard_events(mesh: Mesh, *arrays) -> tuple:
    """Split each (E,) host array into its dp slices, slice d on the
    device of the (dp d, shard 0) cell.  Returns one list per array."""
    dp = mesh.shape.get("dp", 1)
    for a in arrays:
        assert len(a) % dp == 0, (len(a), dp)
    return tuple(
        [_tensor(part).to(mesh.device(0, d)) for d, part in enumerate(np.split(np.asarray(a), dp))]
        for a in arrays
    )
