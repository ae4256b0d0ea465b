"""Set-associative cache (reference: src/lsm/set_associative_cache.zig).

This package's own copy of ``tigerbeetle_tpu/utils/cache.py``.

The reference caches grid blocks and objects in N-way set-associative
tables rather than LRU maps: memory use is exactly bounded up front
(static allocation), lookup cost is O(ways), and eviction needs no
linked-list bookkeeping — a clock bit per way approximates LRU.  Same
design here: `ways` slots per set, sets chosen by key hash, clock
second-chance eviction within the set.
"""

from __future__ import annotations


class SetAssociativeCache:
    """key (int) -> value, N-way set associative with clock eviction."""

    def __init__(self, capacity: int = 256, ways: int = 4) -> None:
        assert capacity % ways == 0 and capacity > 0
        self.ways = ways
        self.sets = capacity // ways
        # Per-slot parallel arrays: key (None = empty), value, clock bit.
        n = capacity
        self._keys: list[int | None] = [None] * n
        self._values: list[object] = [None] * n
        self._clock: list[bool] = [False] * n
        self._hand: list[int] = [0] * self.sets
        self.hits = 0
        self.misses = 0

    def _set_base(self, key: int) -> int:
        # Fibonacci hash of the key selects the set.
        h = (key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        return (h % self.sets) * self.ways

    def get(self, key: int):
        base = self._set_base(key)
        for i in range(base, base + self.ways):
            if self._keys[i] == key:
                self._clock[i] = True
                self.hits += 1
                return self._values[i]
        self.misses += 1
        return None

    def put(self, key: int, value) -> None:
        base = self._set_base(key)
        empty = -1
        for i in range(base, base + self.ways):
            if self._keys[i] == key:
                self._values[i] = value
                self._clock[i] = True
                return
            if empty < 0 and self._keys[i] is None:
                empty = i
        if empty >= 0:
            slot = empty
        else:
            # Clock second-chance within the set (reference eviction).
            s = base // self.ways
            while True:
                i = base + self._hand[s]
                self._hand[s] = (self._hand[s] + 1) % self.ways
                if self._clock[i]:
                    self._clock[i] = False
                else:
                    slot = i
                    break
        self._keys[slot] = key
        self._values[slot] = value
        self._clock[slot] = True

    def remove(self, key: int) -> None:
        base = self._set_base(key)
        for i in range(base, base + self.ways):
            if self._keys[i] == key:
                self._keys[i] = None
                self._values[i] = None
                self._clock[i] = False
                return

    def __contains__(self, key: int) -> bool:
        base = self._set_base(key)
        return any(
            self._keys[i] == key for i in range(base, base + self.ways)
        )
