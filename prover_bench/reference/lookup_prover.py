"""The one-device STARK prover of `prover.py` for AIRs with LogUp lookups
(`lookup.py`): after the trace commitment the transcript draws one β per
challenge set, the running sums Z_{l,s} are committed as a fourth group
(the aux group), and the composition adds their transition and boundary
constraints.  Everything else is `prover.py`'s: the same stages on the
same device, every LDE standing whole; the proof's fields in the same
order (trace, quotient, constants, aux)."""

from __future__ import annotations

import numpy as np
import torch

from . import ext_py
from . import extension as ge
from . import goldilocks as gl
from . import lookup, stages
from .air import DeviceAlgebra
from .fri import derive_query_indices, fold_and_commit
from .ntt import _root_of_unity
from .prover import (StarkConfig, StarkProof, _fri_rounds,
                     _num_quotient_chunks, _open_at_zeta, _proof,
                     _tree_openings, _window, composition_block, preprocess)
from .transcript import Challenger

P = gl.P


def _transition_sums(air, public, blowup, tr, ax, cl, betas, powers, s, e):
    """(Σ_i α^i·T_i(x), number of constraints) over LDE points [s, e): the
    AIR's transition constraints, then the lookups', "next row" read
    `blowup` points ahead."""
    local = list(_window(tr, s, e).unbind(0))
    nxt = list(_window(tr, s + blowup, e + blowup).unbind(0))
    consts = list(_window(cl, s, e).unbind(0))
    tvals = list(air.transition(DeviceAlgebra, local, nxt, public, consts))
    tvals += lookup.transitions(
        local, list(_window(ax, s, e).unbind(0)),
        list(_window(ax, s + blowup, e + blowup).unbind(0)), consts, betas,
        air.lookups())
    del local, nxt
    n_trans = len(tvals)
    ap = powers(n_trans)
    chunk = max(1, min(n_trans, stages.SUM_CHUNK_ELEMS // (e - s)))
    zero = torch.zeros(e - s, dtype=torch.int64, device=tr.device)
    acc = (zero, zero)
    for i in range(0, n_trans, chunk):
        j = min(i + chunk, n_trans)
        acc = ge.add(acc, stages.weighted_sum(torch.stack(tvals[i:j]),
                                              ap[i:j]))
        tvals[i:j] = [None] * (j - i)
    return acc, n_trans


def _composition(air, public, boundaries, x_last, blowup, tr, ax, cl, alpha,
                 betas, x, zh):
    """acc(x) = Σ_i α^i·T_i(x)·(x−x_last) + Σ_b α^{t+b}·B_b(x)·Z_H(x)/(x−x_b)
    over the LDE domain, in blocks of points (`composition_block`); a
    boundary's column at or past the trace width is an aux column."""
    W = tr.shape[0]
    N = x.shape[0]
    dev = tr.device
    ap = [ext_py.ONE]

    def powers(k):
        while len(ap) < k:
            ap.append(ext_py.mul(ap[-1], alpha))
        return ap[:k]

    block = composition_block(W + ax.shape[0] + cl.shape[0], N)
    parts0, parts1 = [], []
    n_trans = 0
    for s in range(0, N, block):
        e = min(s + block, N)
        (t0, t1), n_trans = _transition_sums(air, public, blowup, tr, ax, cl,
                                             betas, powers, s, e)
        xm = gl.sub(x[s:e], x_last)
        parts0.append(gl.mul(t0, xm))
        parts1.append(gl.mul(t1, xm))
    acc = (torch.cat(parts0), torch.cat(parts1))
    del parts0, parts1

    w = _root_of_unity(air.log_n, inverse=False)
    rows = [row for (row, _c, _v) in boundaries]
    uniq = sorted(set(rows))
    seg = torch.tensor([uniq.index(r) for r in rows], device=dev)
    xr = stages.const_column([pow(w, r, P) for r in uniq], dev)
    dinv = gl.inv(gl.sub(x[None, :], xr))
    vals = stages.const_column([v for (_r, _c, v) in boundaries], dev)
    apb = powers(n_trans + len(boundaries))[n_trans:]
    cb = max(1, stages.SUM_CHUNK_ELEMS // max(1, N))
    for s in range(0, len(boundaries), cb):
        e = min(s + cb, len(boundaries))
        pc = torch.stack([tr[c] if c < W else ax[c - W]
                          for (_r, c, _v) in boundaries[s:e]])
        b = gl.mul(gl.mul(gl.sub(pc, vals[s:e]), zh[None]), dinv[seg[s:e]])
        acc = ge.add(acc, stages.weighted_sum(b, apb[s:e]))
    return acc


def prove(air, trace_u64: np.ndarray, config: StarkConfig = StarkConfig(),
          *, device) -> StarkProof:
    """Prove `air` (lookups, constant columns, no bus) on the (W, n) uint64
    trace, every stage on `device`."""
    n = air.n
    W = air.width
    assert trace_u64.shape == (W, n)
    dev = torch.device(device)
    blowup = 1 << config.rate_bits
    log_N = air.log_n + config.rate_bits
    cap_h = config.fri.cap_height
    rate = config.rate_bits
    domain = stages.LOCAL
    lookups = air.lookups()
    assert lookups and air.constraint_degree >= max(lk.degree
                                                    for lk in lookups)
    challenger = Challenger()
    public = air.public_inputs()
    challenger.observe_many(public)

    # ---- preprocessed (constant) columns ----------------------------------
    consts_u64 = air.constant_columns()
    K = consts_u64.shape[0]
    const_tree, const_lde, const_coeff = preprocess(air, config, consts_u64,
                                                    device=dev)
    challenger.observe_cap(const_tree.cap_ints())

    # ---- trace commit -------------------------------------------------------
    tr = gl.from_u64(trace_u64, dev)
    coeff, tr_lde, trace_tree = domain.commit_rows(tr, rate_bits=rate,
                                                   cap_height=cap_h)
    challenger.observe_cap(trace_tree.cap_ints())

    # ---- lookup running sums, after their challenges ---------------------
    betas = [challenger.get_challenge()
             for _ in range(lookup.NUM_LOOKUP_SETS)]
    ax = lookup.running_sums(lookups, tr, gl.from_u64(consts_u64, dev),
                             betas)
    A = ax.shape[0]
    aux_coeff, aux_lde, aux_tree = domain.commit_rows(ax, rate_bits=rate,
                                                      cap_height=cap_h)
    del ax, tr
    challenger.observe_cap(aux_tree.cap_ints())

    # ---- constraint composition -------------------------------------------
    alpha = challenger.get_extension_challenge()
    x = stages.domain_x(log_N, gl.GENERATOR, dev)
    zh, zhinv = stages.zh_on_domain(air.log_n, rate, dev)
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    boundaries = list(air.boundaries(public)) + \
        lookup.boundaries(W, n, lookups)
    acc = _composition(air, public, boundaries, x_last, blowup, tr_lde,
                       aux_lde, const_lde, alpha, betas, x, zh)

    # ---- quotient -----------------------------------------------------------
    chunks = _num_quotient_chunks(air)
    ok, q = domain.quotient(acc, zhinv, chunks, rate)
    del acc
    assert ok, "composition polynomial exceeds quotient degree bound"
    _, q_lde, quot_tree = domain.commit_rows(q, rate_bits=rate,
                                             cap_height=cap_h, do_intt=False)
    challenger.observe_cap(quot_tree.cap_ints())

    # ---- DEEP openings (all groups at ζ and w·ζ) ---------------------------
    zeta = challenger.get_extension_challenge()
    w_zeta = ext_py.mul(zeta, ext_py.from_base(w))
    opened = _open_at_zeta((coeff, aux_coeff, const_coeff, q), chunks, zeta,
                           w_zeta, air.log_n, challenger, domain)

    # ---- DEEP composition codeword ------------------------------------------
    gamma = challenger.get_extension_challenge()
    L = stages.deep_compose((tr_lde, aux_lde, const_lde, q_lde), opened,
                            gamma, zeta, w_zeta, W, A, K, chunks, x)

    # ---- FRI ------------------------------------------------------------------
    fri_proof, fri_layers = fold_and_commit(L, log_N, gl.GENERATOR,
                                            config.fri, challenger,
                                            domain=domain)
    del L
    indices = derive_query_indices(challenger, log_N, config.fri.num_queries)

    # ---- query openings -------------------------------------------------------
    g_leaves, g_paths, fri_pairs, fri_paths = domain.open_positions(
        indices, [tr_lde, q_lde, const_lde, aux_lde],
        [trace_tree, quot_tree, const_tree, aux_tree], fri_layers)
    Q = len(indices)
    openings = [_tree_openings(g_leaves[g], g_paths[g], Q) for g in range(4)]
    fri_proof.query_rounds = _fri_rounds(fri_pairs, fri_paths, Q)
    return _proof(trace_tree, quot_tree, aux_tree, opened, fri_proof,
                  *openings)
