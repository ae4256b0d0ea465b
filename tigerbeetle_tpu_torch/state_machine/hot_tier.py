"""Hot/cold account tiering: a device-resident hot set over the table.

Counterpart of ``tigerbeetle_tpu/state_machine/hot_tier.py``.  With
``TB_HOT_CAPACITY`` set below the logical account capacity, both
engines keep only a fixed budget of hot rows on the card; the host
mirror is the cold tier and holds the whole logical table.  Each
batch's touched-account set is computed up front, its cold rows are
admitted into the device table before the device step, and the card
acts as a cache over the logical table instead of a ceiling on it.

This module owns the host-side tier state both engines share:

- ``HotTier``: the logical <-> hot slot maps, LRU admission and
  eviction over the hot-row budget, and the hit / miss / evict /
  prefetch counters.
- ``grow_zero_host`` / ``grow_zero_device``: the one resize path of
  every table, host and device.
- ``mirror_hot_table8`` / ``gather_hot``: the hot-shaped image of the
  mirror (what a tiered device balance table must equal) and of a
  logical table on the card.

Invariants:

- The hot map only changes against a quiesced device pipeline: every
  admission first drains the in-flight windows and flushes the
  write-behind lane, so evicted rows are clean (their bytes already
  reached the mirror) and every packed batch launches under the map it
  was translated with.
- The state root keeps covering the whole logical table: the host
  commitment twin is logical-capacity-shaped, the device maintains the
  hot partial (row hashes bound to logical row ids), and because the
  fold is a per-lane sum, ``twin.digest == partial(hot) +
  partial(cold)`` (``commitment.HostCommitment.partial``).

``from_env`` returns None unless tiering is on; every caller's tiered
branch is then dead and the engines are all-resident, as before.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import envcheck


def grow_zero_host(array: np.ndarray, capacity: int) -> np.ndarray:
    """Zero-widen a host (rows, ...) array to `capacity` rows; the input
    itself when already wide enough.  All-zero rows hash to (0, 0), so
    growth never moves a state root."""
    if capacity <= len(array):
        return array
    out = np.zeros((capacity,) + array.shape[1:], array.dtype)
    out[: len(array)] = array
    return out


def grow_zero_device(table: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-widen a device (rows, C) table to `capacity` rows, on the
    table's device (no host round trip); the input itself when already
    wide enough."""
    have = table.shape[0]
    if capacity <= have:
        return table
    return torch.cat([table, table.new_zeros((capacity - have,) + tuple(table.shape[1:]))])


def mirror_hot_table8(mirror, logical_of: np.ndarray) -> np.ndarray:
    """Hot-shaped (hot_rows, 8) u64 device-layout image of the mirror:
    row i holds logical row logical_of[i], zeros for a free hot slot."""
    out = np.zeros((len(logical_of), 8), np.uint64)
    occ = logical_of >= 0
    rows = logical_of[occ]
    out[occ, 0::2] = mirror.lo[rows]
    out[occ, 1::2] = mirror.hi[rows]
    return out


def gather_hot(image: torch.Tensor, logical_of: np.ndarray) -> torch.Tensor:
    """Hot-shaped (hot_rows, 8) table gathered out of a logical (A, 8)
    image on its device: row i is logical row logical_of[i], zeros for a
    free hot slot (a tiered write-back of the exact path's result)."""
    lof = torch.from_numpy(logical_of).to(image.device)
    rows = image[lof.clamp(min=0)]
    return torch.where((lof >= 0)[:, None], rows, 0)


def from_env(logical_capacity: int) -> "HotTier | None":
    """The tier of a `logical_capacity`-row table, or None when
    TB_HOT_CAPACITY leaves it all-resident (0 or unset, or a budget
    that covers every row).  Read at construction, so one process can
    run arms under different settings."""
    budget = envcheck.hot_capacity()
    if budget <= 0 or budget >= logical_capacity:
        return None
    return HotTier(logical_capacity, budget)


class HotTier:
    """Logical <-> hot maps + LRU admission over a fixed hot-row budget.
    The counters are plain host numbers, read in both engines."""

    def __init__(self, logical_capacity: int, hot_rows: int) -> None:
        assert 0 < hot_rows < logical_capacity
        self.hot_rows = hot_rows
        self.logical_capacity = logical_capacity
        # logical row -> hot slot (-1 = cold).
        self.hot_of = np.full(logical_capacity, -1, np.int64)
        # hot slot -> logical row (-1 = free).
        self.logical_of = np.full(hot_rows, -1, np.int64)
        # LRU stamps: one clock tick per batch.
        self._stamp = np.zeros(hot_rows, np.int64)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evicts = 0
        self.prefetches = 0
        self.prefetch_stall_us = 0.0

    # -- planning ------------------------------------------------------

    def plan(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """(unique_logical, missing_logical) of a batch's touched set;
        negative entries (not-found joins) are ignored."""
        uniq = np.unique(np.asarray(slots, np.int64))
        uniq = uniq[uniq >= 0]
        if len(uniq) == 0:
            return uniq, uniq
        return uniq, uniq[self.hot_of[uniq] < 0]

    def record_use(self, rows: np.ndarray, hits: int, misses: int) -> None:
        """Stamp the batch's resident rows for the LRU and count the
        hit / miss split; one clock tick per batch."""
        self._clock += 1
        hot = self.hot_of[rows]
        self._stamp[hot[hot >= 0]] = self._clock
        self.hits += hits
        self.misses += misses

    # -- admission -----------------------------------------------------

    def admit(self, missing: np.ndarray, protect: np.ndarray, partial: bool = False):
        """Assign hot slots to the cold `missing` rows: free slots first,
        then the least recently used occupants whose logical rows are
        not in `protect` (the batch's own touched set).  Returns
        (admitted_logical, hot_slots, evicted_logical), or None when the
        batch cannot fit and partial=False (the caller takes the host
        path).  With partial=True a prefix of `missing` is admitted and
        the rest stays cold (the host engine, where the mirror leads and
        a cold row's deltas are simply dropped).  The caller holds the
        pipeline quiesced."""
        need = len(missing)
        free = np.flatnonzero(self.logical_of < 0)
        take_free = free[:need]
        n_evict = need - len(take_free)
        victims = np.zeros(0, np.int64)
        if n_evict > 0:
            occupied = np.flatnonzero(self.logical_of >= 0)
            evictable = occupied[~np.isin(self.logical_of[occupied], protect)]
            if len(evictable) < n_evict:
                if not partial:
                    return None
                n_evict = len(evictable)
            if n_evict > 0:
                order = np.argsort(self._stamp[evictable], kind="stable")
                victims = evictable[order[:n_evict]]
        hot_slots = np.concatenate([take_free, victims])
        admitted = missing[: len(hot_slots)]
        evicted = self.logical_of[victims]
        if len(evicted):
            self.hot_of[evicted] = -1
        self.hot_of[admitted] = hot_slots
        self.logical_of[hot_slots] = admitted
        self._stamp[hot_slots] = self._clock
        self.evicts += len(evicted)
        self.prefetches += 1
        return admitted, hot_slots, evicted

    def note_stall(self, seconds: float) -> None:
        """Account one admission barrier's wall time (the drain, flush
        and upload the batch waited on before its device step)."""
        self.prefetch_stall_us += seconds * 1e6

    # -- geometry ------------------------------------------------------

    def occupied(self) -> np.ndarray:
        """Logical rows currently resident (any order)."""
        return self.logical_of[self.logical_of >= 0]

    def grow_logical(self, capacity: int) -> None:
        """Widen the logical address space; the hot-row budget stays put
        (growth of the logical table does not grow the device tables)."""
        self.hot_of = grow_zero_host(self.hot_of, capacity)
        if capacity > self.logical_capacity:
            # grow_zero_host zero-fills; new rows are cold, not slot 0.
            self.hot_of[self.logical_capacity : capacity] = -1
            self.logical_capacity = capacity

    def translate(self, arr: np.ndarray) -> np.ndarray:
        """Hot-space copy of a logical slot array; negative entries pass
        through.  Callers prefetch first, so mapped entries are never
        -1."""
        out = np.asarray(arr, np.int64).copy()
        m = out >= 0
        out[m] = self.hot_of[out[m]]
        return out
