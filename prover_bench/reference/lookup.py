"""The LogUp lookup argument, plainly: a lookup says that every value of its
input columns over rows 0..n-2 lies in a preprocessed table column, with a
witness column of multiplicities.  Each lookup l and challenge set s adds
one auxiliary running-sum column Z_{l,s} (column l·S + s after the trace):

    Z[0] = 0,  Z[i+1] = Z[i] + Σ_j 1/(β_s − a_j[i]) − m[i]/(β_s − t[i]),

constrained, denominators cleared, on rows 0..n-2 by

    (Z' − Z)·(β−t)·Π_j(β−a_j) = [Σ_j Π_{k≠j}(β−a_k)]·(β−t) − m·Π_j(β−a_j)

and at its two ends by Z[0] = Z[n−1] = 0."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import goldilocks as gl

# independent repetitions of the argument, each with its own challenge β_s
NUM_LOOKUP_SETS = 2


@dataclass(frozen=True)
class Lookup:
    inputs: tuple          # witness columns (1 or 2)
    table: int             # constant column
    multiplicity: int      # witness column

    @property
    def degree(self) -> int:
        return 2 + len(self.inputs)


def running_sums(lookups, tr: torch.Tensor, consts: torch.Tensor,
                 betas) -> torch.Tensor:
    """The aux rows Z_{l,s} (A, n) over trace rows `tr` (W, n) and constant
    rows `consts` (K, n); every denominator is inverted in one batch."""
    dens = []
    for lk in lookups:
        for beta in betas:
            dens.append(gl.sub(beta, consts[lk.table]))
            dens += [gl.sub(beta, tr[j]) for j in lk.inputs]
    inv = iter(gl.inv(torch.stack(dens)))
    steps = []
    for lk in lookups:
        for _ in betas:
            step = gl.neg(gl.mul(tr[lk.multiplicity], next(inv)))
            for _j in lk.inputs:
                step = gl.add(step, next(inv))
            steps.append(step)
    return _exclusive_prefix_sum(torch.stack(steps))


def _exclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ_{r<i} x[..., r] mod p: the low and high 32-bit halves summed as
    integers (below 2^49 each for fewer than 2^17 terms), then joined."""
    lo = torch.cumsum(x & gl.M32, -1)
    hi = torch.cumsum((x >> 32) & gl.M32, -1)
    inc = gl.canonicalize(gl.add(gl.mul(hi, 1 << 32), lo))
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)


def transitions(local, aux_local, aux_next, consts, betas, lookups):
    """The constraint of every (lookup, set), lookup-major, over a block
    of points: `local`, `aux_local`, `aux_next` and `consts` are lists of
    (B,) int64 tensors.  Lookups of one arity are stacked."""
    out = [None] * (len(lookups) * len(betas))
    by_arity: dict = {}
    for li, lk in enumerate(lookups):
        by_arity.setdefault(len(lk.inputs), []).append(li)
    for arity, idx in by_arity.items():
        ins = [torch.stack([local[lookups[li].inputs[j]] for li in idx])
               for j in range(arity)]
        t = torch.stack([consts[lookups[li].table] for li in idx])
        m = torch.stack([local[lookups[li].multiplicity] for li in idx])
        for s, beta in enumerate(betas):
            bt = gl.sub(beta, t)
            bins = [gl.sub(beta, a) for a in ins]
            prod = bins[0]
            for x in bins[1:]:
                prod = gl.mul(prod, x)
            excl = None          # Σ_j Π_{k≠j} (β − a_k); 1 for one input
            for j in range(arity):
                term = None
                for k, x in enumerate(bins):
                    if k != j:
                        term = x if term is None else gl.mul(term, x)
                excl = term if excl is None else gl.add(excl, term)
            if excl is None:
                excl = torch.ones_like(prod)
            cols = [li * NUM_LOOKUP_SETS + s for li in idx]
            zl = torch.stack([aux_local[c] for c in cols])
            zn = torch.stack([aux_next[c] for c in cols])
            lhs = gl.mul(gl.mul(gl.sub(zn, zl), bt), prod)
            rhs = gl.sub(gl.mul(excl, bt), gl.mul(m, prod))
            for li, c in zip(idx, gl.sub(lhs, rhs)):
                out[li * len(betas) + s] = c
    return out


def boundaries(width: int, n: int, lookups):
    """Z[0] = 0 and Z[n−1] = 0 for every running sum, its column offset by
    the trace `width`."""
    out = []
    for a in range(len(lookups) * NUM_LOOKUP_SETS):
        out.append((0, width + a, 0))
        out.append((n - 1, width + a, 0))
    return out
