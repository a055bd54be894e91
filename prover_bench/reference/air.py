"""AIR (algebraic intermediate representation) interface: an `Air`
describes a fixed-shape trace (width x 2^log_n rows), transition
constraints between consecutive rows, and boundary constraints, evaluated
over the whole LDE domain by `DeviceAlgebra` (int64 tensors, vectorized
across all points at once)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import goldilocks as gl


def _device_op(op, host):
    """A field op on tensors, folded on the host when both operands are
    Python ints (constants, e.g. a challenge squared)."""
    def f(a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return op(a, b)
        return host(int(a), int(b)) % gl.P
    return staticmethod(f)


class DeviceAlgebra:
    """Elements are int64 tensors (base field, vectorized) or Python ints
    (constants, folded in by the field ops)."""

    add = _device_op(gl.add, lambda a, b: a + b)
    sub = _device_op(gl.sub, lambda a, b: a - b)
    mul = _device_op(gl.mul, lambda a, b: a * b)

    @staticmethod
    def constant(v):
        return v if isinstance(v, torch.Tensor) else int(v) % gl.P


def bit_word(bits: torch.Tensor) -> torch.Tensor:
    """Σ_i 2^i·bits[..., i, :] over the bit axis (-2) of stacked (..., k, N)
    field elements (k ≤ 32): the device form of a word assembled from bit
    columns."""
    w = torch.tensor([1 << i for i in range(bits.shape[-2])],
                     dtype=torch.int64, device=bits.device)[:, None]
    return gl.field_sum(gl.mul(bits, w), -2)


@dataclass
class Air:
    width: int
    log_n: int
    constraint_degree: int = 2  # max total degree of any transition constraint

    @property
    def n(self) -> int:
        return 1 << self.log_n

    def public_inputs(self) -> list[int]:
        return []

    def constant_columns(self):
        """Preprocessed columns as a (K, n) uint64 array (round constants,
        selectors, …).  Committed once per AIR ("verification key"), opened
        like witness columns.  Default: none."""
        import numpy as np

        return np.zeros((0, self.n), dtype=np.uint64)

    def transition(self, alg, local: list, nxt: list, public: list[int],
                   consts: list | None = None):
        """Constraint values that must vanish on every row but the last.
        `local`/`nxt` are lists of `width` algebra elements; `consts` holds
        the constant columns evaluated on the same row."""
        raise NotImplementedError

    def boundaries(self, public: list[int]):
        """[(row, col, value_int)] equality constraints on trace cells."""
        return []
