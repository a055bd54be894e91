"""Quadratic extension GF(p^2) = GF(p)[x] / (x^2 - W), W = 7, on tensors.

An element is a pair ``(c0, c1)`` = c0 + c1·x of base-field int64 tensors
(`vectorx_tpu_torch.field.goldilocks`), the port of
`vectorx_tpu.field.extension` (whose elements are 4-tuples of uint32
limbs).  FRI folds and the DEEP codeword live here.
"""

from __future__ import annotations

import numpy as np

from vectorx_tpu_torch.field import goldilocks as gl

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


def inv(a):
    """1 / (a0 + a1 x) = (a0 - a1 x) / (a0^2 - W a1^2)."""
    norm = gl.sub(gl.sqr(a[0]), gl.mul_small(gl.sqr(a[1]), W))
    ninv = gl.inv(norm)
    return gl.mul(a[0], ninv), gl.mul(gl.neg(a[1]), ninv)


def to_pair_u64(a) -> tuple[np.ndarray, np.ndarray]:
    return gl.to_u64(a[0]), gl.to_u64(a[1])
