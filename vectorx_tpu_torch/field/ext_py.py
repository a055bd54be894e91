"""Scalar Python-int arithmetic in GF(p^2) = GF(p)[x]/(x^2 - 7).

Host-side companion of `vectorx_tpu_torch.field.extension` for the (tiny) verifier
and transcript computations.  Elements are (c0, c1) int tuples.
"""

from __future__ import annotations

from vectorx_tpu_torch.field.extension import W
from vectorx_tpu_torch.field.goldilocks import P

ZERO = (0, 0)
ONE = (1, 0)


def add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def mul(a, b):
    return (
        (a[0] * b[0] + W * a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


def exp(a, e: int):
    r = ONE
    while e > 0:
        if e & 1:
            r = mul(r, a)
        e >>= 1
        a = mul(a, a)
    return r


def from_base(x: int):
    return (x % P, 0)


def horner(coeffs, x):
    """Evaluate sum coeffs[i] x^i; coeffs are extension pairs."""
    acc = ZERO
    for c in reversed(coeffs):
        acc = add(mul(acc, x), c)
    return acc
