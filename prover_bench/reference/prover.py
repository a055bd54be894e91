"""STARK prover: trace commit -> constraint composition -> quotient -> DEEP
opening -> FRI -> grind -> openings, on one device.  Every stage runs
eagerly on the device the caller names (`stages`); the Fiat-Shamir
transcript stays on the host.  All arithmetic is exact."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import ext_py
from . import extension as ge
from . import goldilocks as gl
from .fri import (FriConfig, FriQueryRound,
                                       FriQueryStep, derive_query_indices,
                                       fold_and_commit)
from .transcript import Challenger
from .ntt import _root_of_unity
from . import stages
from .air import Air, DeviceAlgebra

P = gl.P


@dataclass(frozen=True)
class StarkConfig:
    fri: FriConfig = field(default_factory=FriConfig)

    @property
    def rate_bits(self):
        return self.fri.rate_bits


@dataclass
class TreeOpening:
    leaf: list  # ints
    path: list


@dataclass
class StarkProof:
    trace_cap: list
    quotient_cap: list
    trace_at_zeta: list          # W ext pairs
    trace_at_zeta_next: list     # W ext pairs
    quotient_at_zeta: list       # chunks ext pairs
    fri_proof: object
    trace_openings: list         # per query: TreeOpening
    quotient_openings: list      # per query: TreeOpening
    constants_at_zeta: list = field(default_factory=list)  # K ext pairs
    constants_openings: list = field(default_factory=list)
    aux_cap: list = field(default_factory=list)            # lookup Z columns
    aux_at_zeta: list = field(default_factory=list)
    aux_at_zeta_next: list = field(default_factory=list)
    aux_openings: list = field(default_factory=list)


# Points per block of the composition (`composition_block`): the block's
# committed rows times its points stay under this many elements.
COMPOSITION_BLOCK_ELEMS = 1 << 27


def _num_quotient_chunks(air: Air) -> int:
    return max(air.constraint_degree, 2) - 1


def preprocess(air: Air, config: StarkConfig, consts_u64, *, device,
               domain=stages.LOCAL):
    """Commit to the preprocessed (constant) columns — the AIR's
    verification key.  Returns (tree, lde, coeffs), or Nones when the AIR
    has no constant columns."""
    if consts_u64.shape[0] == 0:
        return None, None, None
    coeff, lde, tree = domain.commit_rows(
        gl.from_u64(consts_u64, device), rate_bits=config.rate_bits,
        cap_height=config.fri.cap_height)
    return tree, lde, coeff


# ---------------------------------------------------------------------------
# Constraint composition
# ---------------------------------------------------------------------------

def _window(m: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """Columns [s, e) of the (R, N) matrix m, wrapping around past N."""
    N = m.shape[1]
    if e <= N:
        return m[:, s:e]
    return torch.cat([m[:, s:], m[:, :e - N]], dim=1)


def composition_block(rows: int, N: int) -> int:
    """Points per block of the composition: the largest power of two with
    rows · block ≤ COMPOSITION_BLOCK_ELEMS (at least 1024, at most N)."""
    block = 1 << max(0, (COMPOSITION_BLOCK_ELEMS // max(1, rows))
                     .bit_length() - 1)
    return max(min(block, N), min(1024, N))


def _transition_sums(air, public, blowup, tr, cl, powers, s, e):
    """(Σ_i α^i·T_i(x), number of constraints) over LDE points [s, e): the
    transition constraints of one block, "next row" read `blowup` points
    ahead.  `powers(k)` returns [α^0 .. α^(k-1)]."""
    blk = _window(tr, s, e)
    blk_n = _window(tr, s + blowup, e + blowup)
    local = list(blk.unbind(0))
    nxt = list(blk_n.unbind(0))
    consts = list(_window(cl, s, e).unbind(0)) if cl.shape[0] else None
    tvals = list(air.transition(DeviceAlgebra, local, nxt, public, consts))
    del local, nxt, blk, blk_n
    n_trans = len(tvals)
    ap = powers(n_trans)
    chunk = max(1, min(n_trans, stages.SUM_CHUNK_ELEMS // (e - s)))
    zero = torch.zeros(e - s, dtype=torch.int64, device=tr.device)
    acc = (zero, zero)
    for i in range(0, n_trans, chunk):
        j = min(i + chunk, n_trans)
        acc = ge.add(acc, stages.weighted_sum(torch.stack(tvals[i:j]),
                                              ap[i:j]))
        tvals[i:j] = [None] * (j - i)   # free consumed buffers promptly
    return acc, n_trans


def _composition(air, public, boundaries, x_last, blowup, tr, cl, alpha,
                 x, zh):
    """acc(x) = Σ_i α^i·T_i(x)·(x−x_last) + Σ_b α^{t+b}·B_b(x)·Z_H(x)/(x−x_b)
    over the LDE domain, as an ext pair (c0, c1) of (N,) tensors.

    The transition constraints are evaluated in blocks of consecutive LDE
    points (`composition_block`): a point's constraints read only its own
    column and the one `blowup` ahead, so the blocks concatenate to the
    whole-domain result while a wide AIR's stacked temporaries stay bounded.
    `blowup` is the index distance of "the next trace row"; `zh` is a
    tensor over the points of `x`.
    """
    W = tr.shape[0]
    N = x.shape[0]
    dev = tr.device
    ap = [ext_py.ONE]

    def powers(k):
        while len(ap) < k:
            ap.append(ext_py.mul(ap[-1], alpha))
        return ap[:k]

    block = composition_block(W + cl.shape[0], N)
    parts0, parts1 = [], []
    n_trans = 0
    for s in range(0, N, block):
        e = min(s + block, N)
        (t0, t1), n_trans = _transition_sums(air, public, blowup, tr, cl,
                                             powers, s, e)
        xm = gl.sub(x[s:e], x_last)
        parts0.append(gl.mul(t0, xm))
        parts1.append(gl.mul(t1, xm))
    acc = (torch.cat(parts0), torch.cat(parts1))
    del parts0, parts1

    if boundaries:
        n_bnd = len(boundaries)
        # 1/(x − x_row) once per unique row, then the boundary axis chunked
        w = _root_of_unity(air.log_n, inverse=False)
        rows = [row for (row, _c, _v) in boundaries]
        uniq = sorted(set(rows))
        seg = torch.tensor([uniq.index(r) for r in rows], device=dev)
        xr = stages.const_column([pow(w, r, P) for r in uniq], dev)
        dinv = gl.inv(gl.sub(x[None, :], xr))
        vals = stages.const_column([v for (_r, _c, v) in boundaries], dev)
        apb = powers(n_trans + n_bnd)[n_trans:]
        cb = max(1, stages.SUM_CHUNK_ELEMS // max(1, N))
        for s in range(0, n_bnd, cb):
            e = min(s + cb, n_bnd)
            pc = torch.stack([tr[c, :N] for (_r, c, _v) in boundaries[s:e]])
            zhb = zh[None] if isinstance(zh, torch.Tensor) else zh
            b = gl.mul(gl.mul(gl.sub(pc, vals[s:e]), zhb), dinv[seg[s:e]])
            acc = ge.add(acc, stages.weighted_sum(b, apb[s:e]))
    return acc


# ---------------------------------------------------------------------------
# Opening assembly
# ---------------------------------------------------------------------------

def _tree_openings(leaves_u64, path_levels, n_queries: int):
    """(R, Q) leaves + per-level (Q, 4) siblings -> [TreeOpening]."""
    return [TreeOpening(
        leaf=[int(x) for x in leaves_u64[:, qi]],
        path=[[int(x) for x in lvl[qi]] for lvl in path_levels])
        for qi in range(n_queries)]


def _fri_rounds(fri_pairs, fri_paths, n_queries: int):
    rounds = []
    for qi in range(n_queries):
        steps = []
        for (pr, sibs) in zip(fri_pairs, fri_paths):
            pair = [int(pr[0][qi]), int(pr[1][qi]),
                    int(pr[2][qi]), int(pr[3][qi])]
            path = [[int(x) for x in lvl[qi]] for lvl in sibs]
            steps.append(FriQueryStep(pair=pair, path=path))
        rounds.append(FriQueryRound(steps=steps))
    return rounds


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------

def prove(air: Air, trace_u64: np.ndarray, config: StarkConfig = StarkConfig(),
          *, device, domain=stages.LOCAL) -> StarkProof:
    """Prove `air` (no lookups, no bus) on the (W, n) uint64 trace, every
    stage on `device`."""
    n = air.n
    W = air.width
    assert trace_u64.shape == (W, n)
    dev = torch.device(device)
    blowup = 1 << config.rate_bits
    log_N = air.log_n + config.rate_bits
    cap_h = config.fri.cap_height
    rate = config.rate_bits
    challenger = Challenger()
    public = air.public_inputs()
    challenger.observe_many(public)

    # ---- preprocessed (constant) columns ----------------------------------
    consts_u64 = air.constant_columns()
    K = consts_u64.shape[0]
    const_tree, const_lde, const_coeff = preprocess(air, config, consts_u64,
                                                    device=dev, domain=domain)
    if const_tree is not None:
        challenger.observe_cap(const_tree.cap_ints())

    # ---- trace commit -------------------------------------------------------
    tr = gl.from_u64(trace_u64, dev)
    coeff, tr_lde, trace_tree = domain.commit_rows(tr, rate_bits=rate,
                                                   cap_height=cap_h)
    challenger.observe_cap(trace_tree.cap_ints())
    empty = torch.zeros((0, n << rate), dtype=torch.int64, device=dev)
    del tr

    # ---- constraint composition -------------------------------------------
    alpha = challenger.get_extension_challenge()
    x = domain.points(stages.domain_x(log_N, gl.GENERATOR, dev))
    zh, zhinv = stages.zh_on_domain(air.log_n, rate, dev)
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    boundaries = list(air.boundaries(public))
    acc = _composition(air, public, boundaries, x_last, blowup, tr_lde,
                       const_lde if K else empty, alpha, x, domain.points(zh))

    # ---- quotient -----------------------------------------------------------
    chunks = _num_quotient_chunks(air)
    ok, q = domain.quotient(acc, domain.points(zhinv), chunks, rate)
    del acc
    assert ok, \
        "composition polynomial exceeds quotient degree bound (AIR misconfigured?)"
    _, q_lde, quot_tree = domain.commit_rows(q, rate_bits=rate,
                                             cap_height=cap_h, do_intt=False)
    challenger.observe_cap(quot_tree.cap_ints())

    # ---- DEEP openings (all groups at ζ and w·ζ) ---------------------------
    zeta = challenger.get_extension_challenge()
    w_zeta = ext_py.mul(zeta, ext_py.from_base(w))
    opened = _open_at_zeta((coeff, None, const_coeff, q), chunks, zeta,
                           w_zeta, air.log_n, challenger, domain)

    # ---- DEEP composition codeword ------------------------------------------
    gamma = challenger.get_extension_challenge()
    npts = x.shape[0]
    ldes = tuple(None if g is None else g[:, :npts] for g in
                 (tr_lde, None, const_lde if K else None, q_lde))
    L = stages.deep_compose(ldes, opened, gamma, zeta, w_zeta, W, 0, K,
                            chunks, x)
    del ldes

    # ---- FRI ------------------------------------------------------------------
    fri_proof, fri_layers = fold_and_commit(L, log_N, gl.GENERATOR,
                                            config.fri, challenger,
                                            domain=domain)
    del L
    indices = derive_query_indices(challenger, log_N, config.fri.num_queries)

    # ---- bulk query openings --------------------------------------------------
    leaf_groups = [tr_lde, q_lde]
    trees = [trace_tree, quot_tree]
    if K:
        leaf_groups.append(const_lde)
        trees.append(const_tree)
    g_leaves, g_paths, fri_pairs, fri_paths = domain.open_positions(
        indices, leaf_groups, trees, fri_layers)
    Q = len(indices)
    trace_openings = _tree_openings(g_leaves[0], g_paths[0], Q)
    quotient_openings = _tree_openings(g_leaves[1], g_paths[1], Q)
    constants_openings: list = []
    if K:
        constants_openings = _tree_openings(g_leaves[2], g_paths[2], Q)
    fri_proof.query_rounds = _fri_rounds(fri_pairs, fri_paths, Q)

    return _proof(trace_tree, quot_tree, None, opened, fri_proof,
                  trace_openings, quotient_openings, constants_openings, [])


def _open_at_zeta(groups, chunks: int, zeta, w_zeta, log_n: int,
                  challenger: Challenger, domain=stages.LOCAL):
    """Evaluate the coefficient groups (trace, aux | None, const | None,
    quotient chunks; as `domain` holds them) at ζ and w·ζ and observe
    every value.  Returns (tz, tnz, az, anz, kz, qz) as lists of ext int
    pairs."""
    present = [g for g in groups if g is not None]
    evals = iter(domain.deep_evals(present, zeta, w_zeta, log_n))
    tz, tnz = next(evals)
    az, anz = next(evals) if groups[1] is not None else ([], [])
    kz = next(evals)[0] if groups[2] is not None else []
    qflat = next(evals)[0]
    # Q_k(ζ) = e0 + x·e1: the chunk rows are the c0/c1 coefficient vectors
    # of an extension-valued polynomial
    qz = [ext_py.add(qflat[2 * k], ext_py.mul((0, 1), qflat[2 * k + 1]))
          for k in range(chunks)]
    for pair in (*tz, *tnz, *az, *anz, *kz, *qz):
        challenger.observe(pair[0])
        challenger.observe(pair[1])
    return tz, tnz, az, anz, kz, qz


def _proof(trace_tree, quot_tree, aux_tree, opened, fri_proof,
           trace_openings, quotient_openings, constants_openings,
           aux_openings) -> StarkProof:
    tz, tnz, az, anz, kz, qz = opened
    return StarkProof(
        trace_cap=trace_tree.cap_ints(),
        quotient_cap=quot_tree.cap_ints(),
        trace_at_zeta=tz,
        trace_at_zeta_next=tnz,
        quotient_at_zeta=qz,
        fri_proof=fri_proof,
        trace_openings=trace_openings,
        quotient_openings=quotient_openings,
        constants_at_zeta=kz,
        constants_openings=constants_openings,
        aux_cap=aux_tree.cap_ints() if aux_tree is not None else [],
        aux_at_zeta=az,
        aux_at_zeta_next=anz,
        aux_openings=aux_openings,
    )
