"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on torch int64 tensors.

A field element is a ``torch.int64`` tensor holding the u64 bit pattern
(``numpy.uint64 -> .view(np.int64) -> torch.from_numpy`` is zero-copy), so a
CUDA kernel reads the same memory as ``uint64_t``.  Values live in
[0, 2^64) and are folded into [0, p) only at comparisons, digests and
outputs; 128-bit products reduce with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

Torch has no unsigned 64-bit arithmetic on every backend, so the plain code
works on the int64 bit patterns directly:

* ``+``, ``-`` and ``*`` wrap modulo 2^64 exactly like u64 arithmetic;
* an unsigned compare flips the sign bit of both sides first (`ult`);
* ``>>`` is arithmetic on int64, so every right shift is masked (`_hi32`).

The 64x64 -> 128 product takes its low half from the wrapping ``a * b`` and
its high half from four 32x32 partial products (each < 2^64, so each fits
the u64 bit pattern exactly).

Every op accepts tensors or Python ints (a Python int is taken mod p and
placed on the other operand's device).
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1          # 2^64 mod p
M32 = (1 << 32) - 1
_SIGN = -(1 << 63)

GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)


def to_i64(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


_P_I64 = to_i64(P)


def _t(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(to_i64(int(v) % P), dtype=torch.int64,
                        device=like.device)


def _pair(a, b):
    if not isinstance(a, torch.Tensor):
        a = _t(a, b)
    return a, _t(b, a)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _hi32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 32) & M32


def _reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo + hi * 2^64) mod p, non-canonical; hi is any u64."""
    hh = _hi32(hi)
    hl = hi & M32
    t0 = lo - hh
    t0 = torch.where(ult(lo, hh), t0 - EPSILON, t0)   # borrow: -2^64 = -EPS
    t1 = (hl << 32) - hl                               # hl * EPS, < 2^64
    r = t0 + t1
    return torch.where(ult(r, t1), r + EPSILON, r)     # carry: +2^64 = +EPS


def add(a, b) -> torch.Tensor:
    """Field addition; each 2^64 wrap folds back as +EPSILON (twice at
    most: after the second fold the value is below 2^33)."""
    a, b = _pair(a, b)
    s = a + b
    e = torch.where(ult(s, a), EPSILON, 0)
    s = s + e
    return torch.where(ult(s, e), s + EPSILON, s)


def sub(a, b) -> torch.Tensor:
    """Field subtraction; each borrow folds as -EPSILON, twice at most."""
    a, b = _pair(a, b)
    d = a - b
    e = torch.where(ult(a, b), EPSILON, 0)
    d2 = d - e
    return torch.where(ult(d, e), d2 - EPSILON, d2)


def mul(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    al = a & M32
    ah = _hi32(a)
    bl = b & M32
    bh = _hi32(b)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    mid = _hi32(ll) + (lh & M32) + (hl & M32)          # < 3 * 2^32
    hi = ah * bh + _hi32(lh) + _hi32(hl) + (mid >> 32)
    return _reduce128(a * b, hi)


def sqr(a) -> torch.Tensor:
    return mul(a, a)


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Fold a non-canonical element into [0, p)."""
    return torch.where(ult(a, _P_I64), a, a - _P_I64)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), canonicalize(a))


def eq(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    return canonicalize(a) == canonicalize(b)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant k (k < 2^32)."""
    assert 0 <= k < 1 << 32
    return mul(a, k)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """Raise to a fixed Python-int power (square-and-multiply)."""
    r = torch.ones_like(a)
    b = a
    while e > 0:
        if e & 1:
            r = mul(r, b)
        e >>= 1
        if e:
            b = sqr(b)
    return r


def inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by Fermat, a^(p-2); inv(0) = 0."""
    return pow_const(a, P - 2)


def field_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Field sum along `dim` with one reduction: the low and high 32-bit
    halves are summed as integers (exact below 2^31 terms), then the
    128-bit total reduces once.  Equal mod p to a chain of `add`s."""
    assert x.shape[dim] < 1 << 31
    lo = (x & M32).sum(dim)
    hi = _hi32(x).sum(dim)
    # total = lo + hi * 2^32 = (lo + (hi & M32) << 32) + (hi >> 32) * 2^64
    t = lo + ((hi & M32) << 32)
    carry = ult(t, lo).to(torch.int64)
    return _reduce128(t, (hi >> 32) + carry)


def from_u64(x, device) -> torch.Tensor:
    """numpy/Python u64 values -> int64 tensor on `device` (zero-copy view
    on the host side)."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    """Canonical values as a host numpy uint64 array."""
    return canonicalize(a).cpu().numpy().view(np.uint64)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, to_i64(value % P), dtype=torch.int64,
                      device=device)
