"""STARK prover: trace commit -> constraint composition -> quotient -> DEEP
opening -> FRI -> grind -> openings, on one device.

Port of the unstreamed `vectorx_tpu.stark.prover.prove`.  Every stage runs
eagerly on the device the caller names (`stark.stages`); the Fiat-Shamir
transcript stays on the host and is identical to the verifier's.  All
arithmetic is exact, so a proof's JSON equals the reference's for the same
statement and config.

Not ported yet: `prove_streamed` (when the reference would stream, the port
raises `NotImplementedError`) and the LogUp memory bus (an AIR with bus
ports raises `NotImplementedError`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import extension as ge
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import (FriConfig, FriProof, FriQueryRound,
                                       FriQueryStep, derive_query_indices)
from vectorx_tpu_torch.fri.transcript import Challenger
from vectorx_tpu_torch.ntt.ntt import _root_of_unity
from vectorx_tpu_torch.stark import stages
from vectorx_tpu_torch.stark.air import (NUM_LOOKUP_SETS, Air, DeviceAlgebra,
                                         bus_aux_layout, lookup_boundaries,
                                         lookup_transitions)

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


# The reference switches to its coset-streamed prover when the committed
# LDE matrices would exceed this many elements; the port follows the same
# rule and refuses such statements until `prove_streamed` is ported.
STREAM_THRESHOLD_ELEMS = 1 << 28


def _num_quotient_chunks(air: Air) -> int:
    return max(air.constraint_degree, 2) - 1


def _commit_cols(air: Air) -> int:
    _, _, A = bus_aux_layout(air)
    return (air.width + A + air.num_constants()
            + 2 * _num_quotient_chunks(air))


def _use_streaming(air: Air, config: StarkConfig) -> bool:
    return _commit_cols(air) * (air.n << config.rate_bits) \
        > STREAM_THRESHOLD_ELEMS


def _refuse_streaming(air: Air, config: StarkConfig) -> None:
    if _use_streaming(air, config):
        raise NotImplementedError(
            f"{type(air).__name__}(log_n={air.log_n}) commits "
            f"{_commit_cols(air)} columns x 2^{air.log_n + config.rate_bits}"
            f" points, above STREAM_THRESHOLD_ELEMS = 2^28: the reference "
            f"proves it with prove_streamed, which is not ported yet")


def preprocess(air: Air, config: StarkConfig, consts_u64=None, *, device):
    """Commit to the preprocessed (constant) columns — the AIR's
    verification key.  Returns (tree, lde, coeffs), or Nones when the AIR
    has no constant columns."""
    consts = air.constant_columns() if consts_u64 is None else consts_u64
    if consts.shape[0] == 0:
        return None, None, None
    _refuse_streaming(air, config)
    coeff, lde, tree = stages.commit_rows(
        gl.from_u64(consts, device), rate_bits=config.rate_bits,
        cap_height=config.fri.cap_height)
    return tree, lde, coeff


def _exclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis in GF(p)."""
    inc = gl.field_cumsum(x, -1)
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)


# ---------------------------------------------------------------------------
# Lookup auxiliary witness
# ---------------------------------------------------------------------------

def aux_witness(air: Air, tr: torch.Tensor, consts: torch.Tensor,
                betas: list[int]) -> torch.Tensor:
    """The LogUp running sums Z_{l,s} as (A, n) rows, (lookup, set) order:

        Z_{l,s}[i] = Σ_{r<i} [ Σ_j 1/(β_s − a_j[r]) − m[r]/(β_s − t[r]) ].

    Lookups are vectorized by arity; one batched inverse per arity group."""
    lookups = air.lookups()
    S = NUM_LOOKUP_SETS
    n = tr.shape[-1]
    dev = tr.device
    lr = torch.zeros((len(lookups), S, n), dtype=torch.int64, device=dev)
    bs = stages.const_column(betas, dev)[:, :, None, None]  # (S, 1, 1, 1)
    by_ni: dict = {}
    for li, lk in enumerate(lookups):
        by_ni.setdefault(len(lk.inputs), []).append(li)
    for ni, idxs in sorted(by_ni.items()):
        sel = torch.tensor(idxs, device=dev)
        a = tr[torch.tensor([lookups[i].inputs for i in idxs], device=dev)]
        t = consts[torch.tensor([lookups[i].table for i in idxs], device=dev)]
        m = tr[torch.tensor([lookups[i].multiplicity for i in idxs],
                            device=dev)]
        # denominators (S, G, ni+1, n): β_s − inputs, β_s − table
        iv = gl.inv(gl.sub(bs, torch.cat([a, t[:, None]], dim=1)[None]))
        c = iv[:, :, 0]
        for j in range(1, ni):
            c = gl.add(c, iv[:, :, j])
        c = gl.sub(c, gl.mul(m[None], iv[:, :, ni]))
        lr[sel] = c.transpose(0, 1)
    return _exclusive_prefix_sum(lr.reshape(len(lookups) * S, n))


# ---------------------------------------------------------------------------
# Constraint composition
# ---------------------------------------------------------------------------

def _composition(air, public, boundaries, x_last, blowup, tr, ax, cl,
                 alpha, betas, x, zh):
    """acc(x) = Σ_i α^i·T_i(x)·(x−x_last) + Σ_b α^{t+b}·B_b(x)·Z_H(x)/(x−x_b)
    over the LDE domain, as an ext pair (c0, c1) of (N,) tensors."""
    W, N = tr.shape
    K = cl.shape[0]
    dev = tr.device
    lookups = air.lookups()
    local = [tr[j] for j in range(W)]
    nxt = [torch.roll(tr[j], -blowup) for j in range(W)]
    consts = [cl[k] for k in range(K)] if K else None
    tvals = list(air.transition(DeviceAlgebra, local, nxt, public, consts))
    if lookups:
        aux_local = [ax[a] for a in range(ax.shape[0])]
        aux_nxt = [torch.roll(ax[a], -blowup) for a in range(ax.shape[0])]
        tvals += lookup_transitions(DeviceAlgebra, local, nxt, aux_local,
                                    aux_nxt, consts, betas, lookups)
    n_trans = len(tvals)
    n_bnd = len(boundaries)
    ap = [ext_py.ONE]
    for _ in range(n_trans + n_bnd - 1):
        ap.append(ext_py.mul(ap[-1], alpha))

    acc = (torch.zeros(N, dtype=torch.int64, device=dev),
           torch.zeros(N, dtype=torch.int64, device=dev))
    xm = gl.sub(x, x_last)
    chunk = max(1, min(n_trans, stages.SUM_CHUNK_ELEMS // max(1, N)))
    for s in range(0, n_trans, chunk):
        e = min(s + chunk, n_trans)
        ts = gl.mul(torch.stack(tvals[s:e]), xm[None])
        acc = ge.add(acc, stages.weighted_sum(ts, ap[s:e]))
        tvals[s:e] = [None] * (e - s)   # free consumed buffers promptly

    if boundaries:
        # 1/(x − x_row) once per unique row, then the boundary axis chunked
        w = _root_of_unity(air.log_n, inverse=False)
        rows = [row for (row, _c, _v) in boundaries]
        uniq = sorted(set(rows))
        seg = torch.tensor([uniq.index(r) for r in rows], device=dev)
        xr = stages.const_column([pow(w, r, P) for r in uniq], dev)
        dinv = gl.inv(gl.sub(x[None, :], xr))
        vals = stages.const_column([v for (_r, _c, v) in boundaries], dev)
        apb = ap[n_trans:]
        cb = max(1, stages.SUM_CHUNK_ELEMS // max(1, N))
        for s in range(0, n_bnd, cb):
            e = min(s + cb, n_bnd)
            # column index >= W addresses an aux column (lookup_boundaries)
            pc = torch.stack([tr[c] if c < W else ax[c - W]
                              for (_r, c, _v) in boundaries[s:e]])
            b = gl.mul(gl.mul(gl.sub(pc, vals[s:e]), zh[None]),
                       dinv[seg[s:e]])
            acc = ge.add(acc, stages.weighted_sum(b, apb[s:e]))
    return acc


# ---------------------------------------------------------------------------
# FRI prove — fold/commit layers on the device
# ---------------------------------------------------------------------------

def _fri_prove_staged(L, log_len: int, shift: int, config: FriConfig,
                      challenger: Challenger):
    """Fold-and-commit layers.  Returns (FriProof without query rounds,
    [(codeword, DeviceTree)] per layer)."""
    layers = []
    caps = []
    c = L
    n = 1 << log_len
    cur_shift = shift
    cur_log = log_len
    while n > config.final_poly_len << config.rate_bits:
        tree = stages.fri_commit_layer(
            c, cur_log, min(config.cap_height, cur_log - 1))
        cap = tree.cap_ints()
        caps.append(cap)
        challenger.observe_cap(cap)
        beta = challenger.get_extension_challenge()
        c_next = stages.fri_fold(c, beta, cur_log, cur_shift)
        layers.append((c, tree))
        c = c_next
        cur_shift = (cur_shift * cur_shift) % P
        cur_log -= 1
        n >>= 1
    ok, final_coeffs = stages.fri_final_coeffs(c, cur_shift,
                                               config.final_poly_len)
    assert ok, "FRI input codeword exceeds the claimed degree bound"
    for (a, b) in final_coeffs:
        challenger.observe(a)
        challenger.observe(b)
    pow_witness = stages.grind(challenger, config.pow_bits, L[0].device)
    proof = FriProof(caps=caps, final_coeffs=final_coeffs,
                     pow_witness=pow_witness)
    return proof, layers


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
          *, device) -> StarkProof:
    """Prove `air` on the (W, n) uint64 trace, every stage on `device`."""
    _refuse_streaming(air, config)
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
                                                    device=dev)
    if const_tree is not None:
        challenger.observe_cap(const_tree.cap_ints())

    # ---- trace commit -------------------------------------------------------
    tr = gl.from_u64(trace_u64, dev)
    coeff, tr_lde, trace_tree = stages.commit_rows(tr, rate_bits=rate,
                                                   cap_height=cap_h)
    challenger.observe_cap(trace_tree.cap_ints())

    # ---- lookup aux columns (committed after post-trace challenges) -------
    lookups = air.lookups()
    _, _, A = bus_aux_layout(air)
    betas: list[int] = []
    aux_tree = aux_lde = aux_coeff = None
    empty = torch.zeros((0, n << rate), dtype=torch.int64, device=dev)
    if lookups:
        assert K, "lookup tables live in constant_columns()"
        assert air.constraint_degree >= max(lk.degree for lk in lookups), \
            "constraint_degree must cover the synthesized lookup constraints"
        betas = challenger.get_n_challenges(NUM_LOOKUP_SETS)
        ax = aux_witness(air, tr, gl.from_u64(consts_u64, dev), betas)
        aux_coeff, aux_lde, aux_tree = stages.commit_rows(
            ax, rate_bits=rate, cap_height=cap_h)
        del ax
        challenger.observe_cap(aux_tree.cap_ints())
    del tr

    # ---- constraint composition -------------------------------------------
    alpha = challenger.get_extension_challenge()
    x = stages.domain_x(log_N, gl.GENERATOR, dev)
    zh, zhinv = stages.zh_on_domain(air.log_n, rate, dev)
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    boundaries = list(air.boundaries(public)) + \
        (lookup_boundaries(air) if lookups else [])
    acc = _composition(air, public, boundaries, x_last, blowup, tr_lde,
                       aux_lde if A else empty, const_lde if K else empty,
                       alpha, betas, x, zh)

    # ---- quotient -----------------------------------------------------------
    chunks = _num_quotient_chunks(air)
    ok, q = stages.quotient_coeffs(acc, zhinv, chunks, rate)
    del acc
    assert ok, \
        "composition polynomial exceeds quotient degree bound (AIR misconfigured?)"
    _, q_lde, quot_tree = stages.commit_rows(q, rate_bits=rate,
                                             cap_height=cap_h, do_intt=False)
    challenger.observe_cap(quot_tree.cap_ints())

    # ---- DEEP openings (all groups at ζ and w·ζ) ---------------------------
    zeta = challenger.get_extension_challenge()
    w_zeta = ext_py.mul(zeta, ext_py.from_base(w))
    groups = [coeff]
    if aux_coeff is not None:
        groups.append(aux_coeff)
    if K:
        groups.append(const_coeff)
    groups.append(q)
    evals = stages.deep_eval_groups(groups, zeta, w_zeta, air.log_n)
    gi = 1
    trace_at_zeta, trace_at_zeta_next = evals[0]
    aux_at_zeta: list = []
    aux_at_zeta_next: list = []
    if aux_coeff is not None:
        aux_at_zeta, aux_at_zeta_next = evals[gi]
        gi += 1
    constants_at_zeta: list = []
    if K:
        constants_at_zeta = evals[gi][0]
        gi += 1
    quot_at_zeta_flat = evals[gi][0]
    # Q_k(ζ) = e0 + x·e1: the chunk rows are the c0/c1 coefficient vectors
    # of an extension-valued polynomial
    quotient_at_zeta = [
        ext_py.add(quot_at_zeta_flat[2 * k],
                   ext_py.mul((0, 1), quot_at_zeta_flat[2 * k + 1]))
        for k in range(chunks)]
    for pair in (*trace_at_zeta, *trace_at_zeta_next, *aux_at_zeta,
                 *aux_at_zeta_next, *constants_at_zeta, *quotient_at_zeta):
        challenger.observe(pair[0])
        challenger.observe(pair[1])

    # ---- DEEP composition codeword ------------------------------------------
    gamma = challenger.get_extension_challenge()
    ldes = (tr_lde, aux_lde if A else None, const_lde if K else None, q_lde)
    opened = (trace_at_zeta, trace_at_zeta_next, aux_at_zeta,
              aux_at_zeta_next, constants_at_zeta, quotient_at_zeta)
    L = stages.deep_compose(ldes, opened, gamma, zeta, w_zeta,
                            W, A, K, chunks, log_N)

    # ---- FRI ------------------------------------------------------------------
    fri_proof, fri_layers = _fri_prove_staged(L, log_N, gl.GENERATOR,
                                              config.fri, challenger)
    del L
    indices = derive_query_indices(challenger, log_N, config.fri.num_queries)

    # ---- bulk query openings --------------------------------------------------
    leaf_groups = [tr_lde, q_lde]
    trees = [trace_tree, quot_tree]
    if K:
        leaf_groups.append(const_lde)
        trees.append(const_tree)
    if A:
        leaf_groups.append(aux_lde)
        trees.append(aux_tree)
    g_leaves, g_paths, fri_pairs, fri_paths = stages.open_positions(
        indices, leaf_groups, trees, fri_layers)
    Q = len(indices)
    trace_openings = _tree_openings(g_leaves[0], g_paths[0], Q)
    quotient_openings = _tree_openings(g_leaves[1], g_paths[1], Q)
    gi = 2
    constants_openings: list = []
    if K:
        constants_openings = _tree_openings(g_leaves[gi], g_paths[gi], Q)
        gi += 1
    aux_openings: list = []
    if A:
        aux_openings = _tree_openings(g_leaves[gi], g_paths[gi], Q)
    fri_proof.query_rounds = _fri_rounds(fri_pairs, fri_paths, Q)

    return StarkProof(
        trace_cap=trace_tree.cap_ints(),
        quotient_cap=quot_tree.cap_ints(),
        trace_at_zeta=trace_at_zeta,
        trace_at_zeta_next=trace_at_zeta_next,
        quotient_at_zeta=quotient_at_zeta,
        fri_proof=fri_proof,
        trace_openings=trace_openings,
        quotient_openings=quotient_openings,
        constants_at_zeta=constants_at_zeta,
        constants_openings=constants_openings,
        aux_cap=aux_tree.cap_ints() if lookups else [],
        aux_at_zeta=aux_at_zeta,
        aux_at_zeta_next=aux_at_zeta_next,
        aux_openings=aux_openings,
    )
