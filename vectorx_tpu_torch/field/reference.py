"""Pure-Python integer model of the Goldilocks field, used as a test oracle.

Mirrors the semantics of `vectorx_tpu_torch.field.goldilocks` (a copy of
`vectorx_tpu.field.reference`, so the port needs no JAX package).
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def inv(a: int) -> int:
    if a % P == 0:
        return 0
    return pow(a, P - 2, P)


def exp(a: int, e: int) -> int:
    return pow(a, e, P)
