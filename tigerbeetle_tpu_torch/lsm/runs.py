"""u128 key packing for order-preserving numpy sorts.

This package's own copy of ``tigerbeetle_tpu/lsm/runs.py``.

The reference orders LSM keys numerically (src/lsm/composite_key.zig);
on the host we pack u128 (lo, hi) limb pairs into 16-byte big-endian
void scalars so numpy's memcmp ordering equals numeric u128 ordering
(sort/searchsorted/unique work unchanged). The hot-path id directories
live in utils/hashindex.py; this packing serves the exact-scan path's
id grouping and future on-disk sorted runs.
"""

from __future__ import annotations

import numpy as np

KEY_DTYPE = np.dtype("V16")
_PACK_DTYPE = np.dtype([("hi", ">u8"), ("lo", ">u8")])


def pack_u128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) uint64 limb arrays -> V16 keys with numeric ordering."""
    s = np.empty(len(lo), dtype=_PACK_DTYPE)
    s["hi"] = hi
    s["lo"] = lo
    return s.view(KEY_DTYPE).reshape(-1)


def key_words(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """V16 keys -> (word0, word1) native uint64, lexicographic order."""
    w = keys.view(">u8").astype(np.uint64).reshape(-1, 2)
    return w[:, 0], w[:, 1]


def keys_le(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise a <= b for V16 keys (void dtypes lack ordering
    ufuncs; sort/searchsorted still use memcmp order)."""
    a0, a1 = key_words(a)
    b0, b1 = key_words(b)
    return (a0 < b0) | ((a0 == b0) & (a1 <= b1))
