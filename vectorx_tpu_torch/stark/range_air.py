"""Range-check AIR: proves every value in a set of witness columns lies in
[0, 2^bits), via the STARK core's LogUp lookup argument against a
preprocessed identity table.

Port of `vectorx_tpu.stark.range_air`: the counterpart of curta/starkyx's
global 16-bit range table that the ed25519 field-op AIRs lean on for limb
range checks.  Each PAIR of value columns shares one
lookup (2 inputs keeps the synthesized constraint inside the degree-4
quotient budget), with a per-lookup multiplicity column.

Layout (width = V + V/2):
  cols [0, V)        : value columns (rows 0..n-2 carry data; last row 0)
  cols [V, V + V/2)  : multiplicity columns, one per pair
Constant column 0    : table t[i] = min(i, 2^bits - 1)

The lookup covers rows 0..n-2 (the STARK's transition window), so the
table needs 2^bits <= n/2 — i.e. bits <= log_n - 1.
"""

from __future__ import annotations

import numpy as np

from vectorx_tpu_torch.stark.air import Air, Lookup


class RangeCheckAir(Air):
    def __init__(self, log_n: int, bits: int, values: np.ndarray):
        """`values` is (V, n) or (V, n-1) uint64; V must be even.  Row n-1
        is forced to zero (it sits outside the lookup's coverage)."""
        V = values.shape[0]
        assert V % 2 == 0, "value columns are range-checked in pairs"
        assert bits <= log_n - 1, "table must fit in rows 0..n-2"
        super().__init__(width=V + V // 2, log_n=log_n, constraint_degree=4)
        self.bits = bits
        self.V = V
        n = self.n
        vals = np.zeros((V, n), dtype=np.uint64)
        vals[:, : values.shape[1]] = values[:, : n]
        vals[:, n - 1] = 0
        assert np.all(vals < (1 << bits)), "witness value out of range"
        self.values = vals

    def lookups(self):
        return [Lookup(inputs=(2 * i, 2 * i + 1), table=0,
                       multiplicity=self.V + i)
                for i in range(self.V // 2)]

    def constant_columns(self):
        t = np.minimum(np.arange(self.n, dtype=np.uint64),
                       np.uint64((1 << self.bits) - 1))
        return t[None, :]

    def transition(self, alg, local, nxt, public, consts=None):
        return []  # all constraints are synthesized lookups

    def build_trace(self) -> np.ndarray:
        n = self.n
        tr = np.zeros((self.width, n), dtype=np.uint64)
        tr[: self.V] = self.values
        for i in range(self.V // 2):
            pair = self.values[2 * i : 2 * i + 2, : n - 1]
            counts = np.bincount(pair.reshape(-1).astype(np.int64),
                                 minlength=1 << self.bits)
            # table is the identity on rows < 2^bits, so multiplicity for
            # value v sits at row v (all < n-1 by the bits bound)
            tr[self.V + i, : 1 << self.bits] = counts[: 1 << self.bits]
        return tr
