"""u128 arithmetic on (lo, hi) limb pairs held in int64 lanes.

Counterpart of ``tigerbeetle_tpu/ops/u128.py``.  PyTorch's uint64 has
almost no operators on the CPU, so every u64 value here is an int64
tensor holding the same 64 bits.  Add, sub and mul wrap mod 2^64 with
identical bits; unsigned compare flips the sign bit first, and a
logical right shift is an arithmetic shift plus a mask.  numpy u64
arrays cross over by ``.view(np.int64)`` (``from_u64`` / ``to_u64``).
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN = -(1 << 63)  # int64 with only the sign bit set
MASK32 = 0xFFFFFFFF

# A u128 value is a tuple (lo, hi) of int64 tensors.
U128 = tuple


def s64(value: int) -> int:
    """Python int in [0, 2^64) (or any int, taken mod 2^64) -> the
    int64 with the same bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def from_u64(array: np.ndarray, device=None) -> torch.Tensor:
    """numpy u64 (or any 8-byte integer) array -> int64 tensor, same bits."""
    a = np.ascontiguousarray(array)
    assert a.dtype.itemsize == 8, a.dtype
    t = torch.from_numpy(a.view(np.int64))
    return t if device is None else t.to(device)


def to_u64(tensor: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy u64 array, same bits."""
    return tensor.detach().cpu().numpy().view(np.uint64)


def ult(a, b):
    """Unsigned a < b on int64 lanes."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def shr(x, n: int):
    """Logical right shift of an int64 lane by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def add(a: U128, b: U128):
    """(a + b) mod 2^128 and an overflow flag."""
    lo = a[0] + b[0]
    carry = ult(lo, a[0]).to(torch.int64)
    hi_partial = a[1] + b[1]
    ov1 = ult(hi_partial, a[1])
    hi = hi_partial + carry
    ov2 = ult(hi, hi_partial)
    return (lo, hi), ov1 | ov2


def sub(a: U128, b: U128):
    """(a - b) mod 2^128 and an underflow (borrow-out) flag."""
    lo = a[0] - b[0]
    borrow = ult(a[0], b[0])
    hi = a[1] - b[1] - borrow.to(torch.int64)
    under = ult(a[1], b[1]) | ((a[1] == b[1]) & borrow)
    return (lo, hi), under


def sub_sat(a: U128, b: U128) -> U128:
    """max(a - b, 0) (reference: src/state_machine.zig:1519,1525)."""
    (lo, hi), under = sub(a, b)
    zero = torch.zeros_like(lo)
    return (torch.where(under, zero, lo), torch.where(under, zero, hi))


def eq(a: U128, b: U128):
    return (a[0] == b[0]) & (a[1] == b[1])


def ne(a: U128, b: U128):
    return ~eq(a, b)


def gt(a: U128, b: U128):
    return ult(b[1], a[1]) | ((a[1] == b[1]) & ult(b[0], a[0]))


def lt(a: U128, b: U128):
    return gt(b, a)


def is_zero(a: U128):
    return (a[0] == 0) & (a[1] == 0)


def minimum(a: U128, b: U128) -> U128:
    a_gt = gt(a, b)
    return (torch.where(a_gt, b[0], a[0]), torch.where(a_gt, b[1], a[1]))


def select(pred, a: U128, b: U128) -> U128:
    return (torch.where(pred, a[0], b[0]), torch.where(pred, a[1], b[1]))


def limbs32(lo, hi):
    """(K,) u128 limb pair -> (K, 4) little-endian 32-bit limbs, each
    non-negative in its int64 lane (sums of up to 2^31 never wrap)."""
    return torch.stack(
        [lo & MASK32, shr(lo, 32), hi & MASK32, shr(hi, 32)], dim=-1
    )


def from_limbs32(acc):
    """(..., 4) non-negative limb sums -> (lo, hi, carry_out); the sum
    is taken mod 2^128, carry_out is what spilled past 2^128."""
    c0 = acc[..., 0]
    c1 = acc[..., 1] + (c0 >> 32)
    c2 = acc[..., 2] + (c1 >> 32)
    c3 = acc[..., 3] + (c2 >> 32)
    lo = (c0 & MASK32) | ((c1 & MASK32) << 32)
    hi = (c2 & MASK32) | ((c3 & MASK32) << 32)
    return lo, hi, c3 >> 32
