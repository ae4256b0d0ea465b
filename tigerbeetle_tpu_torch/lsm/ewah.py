"""EWAH word-aligned hybrid RLE bitset codec.

This package's own copy of ``tigerbeetle_tpu/lsm/ewah.py``.

reference: src/ewah.zig:12-20 — used to compress the free set for
checkpoint persistence.  Encoding: a stream of (marker, literals)
pairs; the marker word packs {uniform_bit: 1, uniform_word_count: 31,
literal_word_count: 32} and is followed by that many literal 64-bit
words.  Vectorized numpy implementation (the reference is scalar Zig).
"""

from __future__ import annotations

import numpy as np


def encode(words: np.ndarray) -> bytes:
    """uint64 word array -> EWAH bytes."""
    words = np.asarray(words, np.uint64)
    out: list[int] = []
    i = 0
    n = len(words)
    ZERO, ONES = np.uint64(0), np.uint64(0xFFFFFFFFFFFFFFFF)
    while i < n:
        # Run of uniform words.
        bit = 1 if words[i] == ONES else 0 if words[i] == ZERO else None
        run = 0
        if bit is not None:
            uniform = ONES if bit else ZERO
            j = i
            while j < n and words[j] == uniform and run < (1 << 31) - 1:
                j += 1
                run += 1
            i = j
        # Literal words until the next uniform run (or end).
        lit_start = i
        while i < n and words[i] != ZERO and words[i] != ONES:
            i += 1
        lits = words[lit_start:i]
        marker = (
            np.uint64(bit or 0)
            | (np.uint64(run) << np.uint64(1))
            | (np.uint64(len(lits)) << np.uint64(32))
        )
        out.append(int(marker))
        out.extend(int(w) for w in lits)
    return np.asarray(out, np.uint64).tobytes()


def decode(data: bytes, word_count: int) -> np.ndarray:
    """EWAH bytes -> uint64 word array of `word_count` words."""
    stream = np.frombuffer(data, np.uint64)
    out = np.zeros(word_count, np.uint64)
    at = 0
    pos = 0
    ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
    while at < len(stream):
        marker = int(stream[at])
        at += 1
        bit = marker & 1
        run = (marker >> 1) & 0x7FFFFFFF
        lit = marker >> 32
        if run:
            if bit:
                out[pos : pos + run] = ONES
            pos += run
        if lit:
            out[pos : pos + lit] = stream[at : at + lit]
            at += lit
            pos += lit
    assert pos == word_count, (pos, word_count)
    return out
