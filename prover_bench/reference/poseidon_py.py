"""Scalar Python-int Poseidon — same parameters as `poseidon.py`, every
round with the dense MDS — for the host-side Fiat-Shamir transcript."""

from __future__ import annotations

from operator import mul

from .goldilocks import P
from . import poseidon as pv


def permute(state: list[int]) -> list[int]:
    assert len(state) == pv.WIDTH
    rc, mds = pv.int_params()
    s = [x % P for x in state]
    r = 0

    def mds_layer(s):
        return [sum(map(mul, row, s)) % P for row in mds]

    for _ in range(pv.FULL_ROUNDS // 2):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, pv.ALPHA, P) for x in s]
        s = mds_layer(s)
        r += 1
    for _ in range(pv.PARTIAL_ROUNDS):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s[0] = pow(s[0], pv.ALPHA, P)
        s = mds_layer(s)
        r += 1
    for _ in range(pv.FULL_ROUNDS // 2):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, pv.ALPHA, P) for x in s]
        s = mds_layer(s)
        r += 1
    return s
