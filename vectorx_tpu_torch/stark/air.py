"""AIR (algebraic intermediate representation) interface.

Port of `vectorx_tpu.stark.air`.  An `Air` describes a fixed-shape trace
(width x 2^log_n rows), transition constraints between consecutive rows,
and boundary constraints.  Constraints are written once against an abstract
algebra and evaluated twice:

* over the whole LDE domain on the trace's device (`DeviceAlgebra`: int64
  tensors, vectorized across all points at once), and
* host-side at the single DEEP point ζ in GF(p^2) (`ExtAlgebra`: Python
  ints).

The LogUp memory bus (`BusPort`) is declared here so AIRs can name it, but
its constraints are not ported yet: the prover and verifier raise
`NotImplementedError` for an AIR with bus ports.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import goldilocks as gl


class DeviceAlgebra:
    """Elements are int64 tensors (base field, vectorized) or Python ints
    (constants, folded in by the field ops)."""

    add = staticmethod(gl.add)
    sub = staticmethod(gl.sub)
    mul = staticmethod(gl.mul)

    @staticmethod
    def constant(v):
        return v if isinstance(v, torch.Tensor) else int(v) % gl.P


class ExtAlgebra:
    """Elements are (c0, c1) Python-int pairs in GF(p^2)."""

    add = staticmethod(ext_py.add)
    sub = staticmethod(ext_py.sub)
    mul = staticmethod(ext_py.mul)

    @staticmethod
    def constant(v: int):
        return ext_py.from_base(v)


@dataclass(frozen=True)
class Lookup:
    """A LogUp multiset-inclusion argument: every value in the witness
    columns `inputs` (over rows 0..n-2) appears in the preprocessed table
    column `table`; `multiplicity` is a witness column counting, per table
    row, how many input cells hold that value.

    Plays the role of curta/starkyx's global 16-bit range table that the
    ed25519/hash AIRs lean on for limb range checks.  Degree of the synthesized
    transition constraint is 2 + len(inputs) (≤ 2 inputs per lookup keeps
    it inside the degree-4 quotient budget)."""

    inputs: tuple          # witness column indices (1 or 2)
    table: int             # preprocessed (constant) column index
    multiplicity: int      # witness column index

    @property
    def degree(self) -> int:
        return 2 + len(self.inputs)


# Independent repetitions of the lookup argument (separate β challenges,
# separate running-sum columns).  Two base-field repetitions ≈ squared
# soundness error — the same trade starky makes with its base-field
# grand-product challenges.
NUM_LOOKUP_SETS = 2


@dataclass(frozen=True)
class BusPort:
    """One port of the LogUp memory bus — the mechanism that lets a
    row-programmed machine (the recursive verifier AIR) move values across
    arbitrarily distant rows with O(1) columns per port, where plonky2
    uses copy constraints/wiring (SURVEY.md §2 E1/E2).

    Per row, the port carries the (address, multiplicity) pair in two
    preprocessed columns and reads its value from a fixed witness column
    pair **on the next row** (so a slot writing a fresh register and the
    bus write of that value land on the same row).  Semantics: over rows
    0..n−2, the multiset equation

        Σ_rows m[r] / (β − addr[r] − δ·v0'[r] − δ²·v1'[r])  =  0

    holds for random β, δ — a value written once with multiplicity +k is
    read (m = −1 ≡ P−1) exactly k times, and every read returns the
    written value.  Enforced by one helper column per (port, challenge
    set): h·(β − addr − δ·v0' − δ²·v1') = m (degree 2), accumulated by a
    running-sum column Z with Z[0] = Z[n−1] = 0."""

    value_cols: tuple   # (v0_col, v1_col) witness columns, read on next row
    addr_col: int       # preprocessed column: address (0 ⇒ port inactive)
    mult_col: int       # preprocessed column: multiplicity mod P (−1 = read)


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

    def lookups(self) -> list[Lookup]:
        """LogUp lookups to enforce.  Each adds NUM_LOOKUP_SETS auxiliary
        running-sum columns, committed after a Fiat-Shamir challenge drawn
        post-trace-commit.  Default: none."""
        return []

    def bus_ports(self) -> list[BusPort]:
        """Memory-bus ports (see BusPort).  Adds NUM_LOOKUP_SETS·(P+1)
        auxiliary columns (one helper per port per set + one running sum
        per set).  Default: none."""
        return []

    def constant_columns(self):
        """Preprocessed columns as a (K, n) uint64 array (round constants,
        selectors, …).  Committed once per AIR ("verification key"), opened
        like witness columns — the role plonky2's constants/sigmas
        commitment plays (SURVEY.md §2 E1).  Default: none."""
        import numpy as np

        return np.zeros((0, self.n), dtype=np.uint64)

    def num_constants(self) -> int:
        """K without necessarily materializing the columns — AIRs with an
        expensive O(n) host build (MachineAir) override this so a warm-VK
        verify (stark/vk.py token path) never touches them."""
        return self.constant_columns().shape[0]

    def transition(self, alg, local: list, nxt: list, public: list[int],
                   consts: list | None = None):
        """Constraint values that must vanish on every row but the last.
        `local`/`nxt` are lists of `width` algebra elements; `consts` holds
        the constant columns evaluated on the same row."""
        raise NotImplementedError

    def boundaries(self, public: list[int]):
        """[(row, col, value_int)] equality constraints on trace cells."""
        return []


def _lookup_transitions_device(local, aux_local, aux_next, consts, betas,
                               lookups):
    """Stacked device path for uniform 2-input lookups: all L constraints
    of one challenge set evaluate as a few batched ops on (L, N) tensors."""
    L = len(lookups)
    a = torch.stack([local[lk.inputs[0]] for lk in lookups])
    b = torch.stack([local[lk.inputs[1]] for lk in lookups])
    m = torch.stack([local[lk.multiplicity] for lk in lookups])
    t = torch.stack([consts[lk.table] for lk in lookups])
    out = []
    for s, beta in enumerate(betas):
        ba = gl.sub(beta, a)
        bb = gl.sub(beta, b)
        bt = gl.sub(beta, t)
        prod = gl.mul(ba, bb)
        cols = [lk_i * NUM_LOOKUP_SETS + s for lk_i in range(L)]
        zl = torch.stack([aux_local[c] for c in cols])
        zn = torch.stack([aux_next[c] for c in cols])
        lhs = gl.mul(gl.mul(gl.sub(zn, zl), bt), prod)
        rhs = gl.sub(gl.mul(gl.add(ba, bb), bt), gl.mul(m, prod))
        c = gl.sub(lhs, rhs)
        out.append([c[i] for i in range(L)])
    # interleave back to (lookup-major, set-minor) order
    return [out[s][i] for i in range(L) for s in range(len(betas))]


def lookup_transitions(alg, local, nxt, aux_local, aux_next, consts,
                       betas, lookups):
    """Synthesize the LogUp transition constraints, one per (lookup,
    challenge set), against an abstract algebra — evaluated on-device over
    the LDE domain and host-side at ζ, exactly like `Air.transition`.

    For lookup l with inputs a_j, table t, multiplicity m, running sum Z
    and challenge β, rows 0..n-2 must satisfy (denominators cleared):

        (Z' − Z)·(β−t)·Π_j(β−a_j)
          = [Σ_j Π_{k≠j}(β−a_k)]·(β−t) − m·Π_j(β−a_j)
    """
    if alg is DeviceAlgebra and lookups and \
            all(len(lk.inputs) == 2 for lk in lookups):
        return _lookup_transitions_device(local, aux_local, aux_next,
                                          consts, betas, lookups)
    out = []
    for li, lk in enumerate(lookups):
        t = consts[lk.table]
        m = local[lk.multiplicity]
        for s, beta in enumerate(betas):
            b = alg.constant(beta)
            bt = alg.sub(b, t)
            bins = [alg.sub(b, local[j]) for j in lk.inputs]
            prod_in = bins[0]
            for x in bins[1:]:
                prod_in = alg.mul(prod_in, x)
            if len(bins) == 1:
                sum_excl = alg.constant(1)
            else:
                # Σ_j Π_{k≠j}; with ≤2 inputs this is just the other factor
                sum_excl = alg.add(bins[1], bins[0]) if len(bins) == 2 else \
                    _sum_excl_general(alg, bins)
            col = li * NUM_LOOKUP_SETS + s
            dz = alg.sub(aux_next[col], aux_local[col])
            lhs = alg.mul(alg.mul(dz, bt), prod_in)
            rhs = alg.sub(alg.mul(sum_excl, bt), alg.mul(m, prod_in))
            out.append(alg.sub(lhs, rhs))
    return out


def _sum_excl_general(alg, bins):
    total = None
    for j in range(len(bins)):
        term = None
        for k, x in enumerate(bins):
            if k == j:
                continue
            term = x if term is None else alg.mul(term, x)
        total = term if total is None else alg.add(total, term)
    return total


def bus_aux_layout(air: Air):
    """Aux-column count: one running-sum column per (lookup, challenge
    set).  Returns (helper_base, z_base, n_aux_total) like the reference;
    an AIR with bus ports raises (the bus is not ported yet)."""
    if air.bus_ports():
        raise NotImplementedError("bus ports are not ported yet")
    n_lk = len(air.lookups()) * NUM_LOOKUP_SETS
    return n_lk, n_lk, n_lk


def lookup_boundaries(air: Air):
    """Z[0] = 0 and Z[n−1] = 0 for every running-sum aux column (lookup
    sums and bus sums; bus helper columns are unconstrained at the
    boundary).  Column indices are offset by `air.width` (the aux columns
    sit after the witness columns in the opened-value ordering)."""
    out = []
    n_lk = len(air.lookups()) * NUM_LOOKUP_SETS
    z_cols = list(range(n_lk))
    if air.bus_ports():
        raise NotImplementedError("bus ports are not ported yet")
    for a in z_cols:
        out.append((0, air.width + a, 0))
        out.append((air.n - 1, air.width + a, 0))
    return out


class FibonacciAir(Air):
    """Toy AIR used by tests and benchmarks: columns (a, b), rows step the
    Fibonacci recurrence; public inputs pin the start and end values."""

    def __init__(self, log_n: int, a0: int = 1, b0: int = 1):
        super().__init__(width=2, log_n=log_n, constraint_degree=2)
        self.a0, self.b0 = a0, b0
        # compute the final value for the boundary
        a, b = a0, b0
        for _ in range(self.n - 1):
            a, b = b, (a + b) % gl.P
        self.final = b

    def public_inputs(self):
        return [self.a0, self.b0, self.final]

    def transition(self, alg, local, nxt, public, consts=None):
        a, b = local
        an, bn = nxt
        return [
            alg.sub(an, b),                    # a' = b
            alg.sub(bn, alg.add(a, b)),        # b' = a + b
        ]

    def boundaries(self, public):
        return [
            (0, 0, public[0]),
            (0, 1, public[1]),
            (self.n - 1, 1, public[2]),
        ]

    def build_trace(self):
        """Generate the witness trace as numpy uint64 (width, n)."""
        import numpy as np

        n = self.n
        tr = np.zeros((2, n), dtype=np.uint64)
        a, b = self.a0, self.b0
        for i in range(n):
            tr[0, i] = a
            tr[1, i] = b
            a, b = b, (a + b) % gl.P
        return tr
