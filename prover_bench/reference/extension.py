"""Quadratic extension GF(p^2) = GF(p)[x] / (x^2 - W), W = 7, on tensors.

An element is a pair ``(c0, c1)`` = c0 + c1·x of base-field int64 tensors
(`goldilocks`).  FRI folds and the DEEP codeword live here.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

W = 7  # x^2 = 7; 7 is a quadratic non-residue mod p.


def add(a, b):
    return gl.add(a[0], b[0]), gl.add(a[1], b[1])


def sub(a, b):
    return gl.sub(a[0], b[0]), gl.sub(a[1], b[1])


def mul(a, b):
    """(a0 + a1 x)(b0 + b1 x) = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) x,
    the cross term by Karatsuba."""
    t00 = gl.mul(a[0], b[0])
    t11 = gl.mul(a[1], b[1])
    cross = gl.mul(gl.add(a[0], a[1]), gl.add(b[0], b[1]))
    cross = gl.sub(gl.sub(cross, t00), t11)
    return gl.add(t00, gl.mul_small(t11, W)), cross


def mul_base(a, b):
    """Multiply an extension element by a base-field element."""
    return gl.mul(a[0], b), gl.mul(a[1], b)


def sqr(a):
    return mul(a, a)


def neg(a):
    return gl.neg(a[0]), gl.neg(a[1])


def inv(a):
    """1 / (a0 + a1 x) = (a0 - a1 x) / (a0^2 - W a1^2)."""
    norm = gl.sub(gl.sqr(a[0]), gl.mul_small(gl.sqr(a[1]), W))
    ninv = gl.inv(norm)
    return gl.mul(a[0], ninv), gl.mul(gl.neg(a[1]), ninv)


def pow_const(a, e: int):
    """Raise to a fixed Python-int power (square-and-multiply)."""
    r = from_base(torch.ones_like(a[0]))
    b = a
    while e > 0:
        if e & 1:
            r = mul(r, b)
        e >>= 1
        if e:
            b = sqr(b)
    return r


def from_base(b):
    return b, torch.zeros_like(b)


def eq(a, b):
    return gl.eq(a[0], b[0]) & gl.eq(a[1], b[1])


def zeros(shape, device):
    return gl.zeros(shape, device), gl.zeros(shape, device)


def from_pair_u64(c0, c1, device):
    """Build from numpy arrays/ints of the two coefficients."""
    return gl.from_u64(c0, device), gl.from_u64(c1, device)
