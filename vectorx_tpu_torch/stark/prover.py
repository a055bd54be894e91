"""STARK prover: trace commit -> constraint composition -> quotient -> DEEP
opening -> FRI -> grind -> openings, on one device.

Port of `vectorx_tpu.stark.prover`.  Every stage runs eagerly on the
device the caller names (`stark.stages`); the Fiat-Shamir transcript stays
on the host and is identical to the verifier's.  All arithmetic is exact,
so a proof's JSON equals the reference's for the same statement and config.

Two schedules give bit-identical proofs: `prove` keeps every committed LDE
on the device; past `STREAM_THRESHOLD_ELEMS` it hands the statement to
`prove_streamed`, which evaluates every full-domain stage one
stride-`blowup` coset at a time (leaf hashing: a block of rows at a time)
and keeps its trees on the host.
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
                                         bus_aux_layout, bus_transitions,
                                         lookup_boundaries, lookup_transitions)

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


# Statements whose committed LDE matrices (trace + aux + constants +
# quotient chunks, each over the blown-up domain) exceed this many elements
# go to the coset-streamed prover (`prove_streamed`).  The reference streams
# above 2^28, a bound sized for a 16 GB TPU.
# This one is sized for an 80 GB H100 from measurements (PERF.md): the
# header_range path's largest statement, a 2^14-row Blake2bAir chunk at the
# production FriConfig() (2853 columns x 2^17 points, 3.7e8 elements, 2.79
# GiB standing), peaked at 9.54 GiB alone and at 10.76 GiB across the whole
# tree-256 statement, 3.43-3.86x its standing LDE bytes, on an NVIDIA H100
# 80GB HBM3 (700 W power limit).  Narrow, long statements on the same card:
# FibonacciAir(23) (4 columns x 2^26 points, the NTT's largest domain, half
# the bound) peaked at 30.6 GiB allocated / 41.4 GiB reserved by the
# caching allocator, RangeCheckAir(22, 16, V=2) (12 columns x 2^25 points,
# 0.75 of the bound) at 30.2 / 41.0 GiB.  At 2^29 elements a wide statement
# peaks near 3.86 x 4 GiB = 15 GiB; the corner, 8 columns x 2^26 points,
# near FibonacciAir(23) plus 4 columns at 31-60 B per element (the Blake2b
# chunk's and RangeCheck's marginal costs): 38-46 GiB allocated, 52-62 GiB
# reserved, under 80 GB with headroom.  2^30 would put it at 54-76 GiB
# allocated, with none.
STREAM_THRESHOLD_ELEMS = 1 << 29
# Points per block of the composition (`composition_block`): the block's
# committed rows times its points stay under this many elements.
COMPOSITION_BLOCK_ELEMS = 1 << 27


def _num_quotient_chunks(air: Air) -> int:
    return max(air.constraint_degree, 2) - 1


def _commit_cols(air: Air) -> int:
    _, _, A = bus_aux_layout(air)
    return (air.width + A + air.num_constants()
            + 2 * _num_quotient_chunks(air))


def _use_streaming(air: Air, config: StarkConfig) -> bool:
    return _commit_cols(air) * (air.n << config.rate_bits) \
        > STREAM_THRESHOLD_ELEMS


def preprocess(air: Air, config: StarkConfig, consts_u64=None, *, device,
               streamed: bool | None = None):
    """Commit to the preprocessed (constant) columns — the AIR's
    verification key.  Returns (tree, lde, coeffs), or Nones when the AIR
    has no constant columns.  Streamed (by default: past the streaming
    bound), the tree is a HostTree and the lde None (the streamed prover
    evaluates the columns per coset)."""
    consts = air.constant_columns() if consts_u64 is None else consts_u64
    if consts.shape[0] == 0:
        return None, None, None
    from vectorx_tpu_torch.stark import vk

    if _use_streaming(air, config) if streamed is None else streamed:
        coeff = stages.to_coeffs(gl.from_u64(consts, device))
        tree = stages.commit_streamed(coeff, air.log_n + config.rate_bits,
                                      config.fri.cap_height)
        lde = None
    else:
        coeff, lde, tree = stages.commit_rows(
            gl.from_u64(consts, device), rate_bits=config.rate_bits,
            cap_height=config.fri.cap_height)
    vk.seed_token(air, config, tree.cap_ints())
    return tree, lde, coeff


def _exclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis in GF(p)."""
    inc = gl.field_cumsum(x, -1)
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)


# ---------------------------------------------------------------------------
# Lookup / bus auxiliary witness
# ---------------------------------------------------------------------------

def aux_witness(air: Air, tr: torch.Tensor, consts: torch.Tensor,
                betas: list[int], deltas: list[int]) -> torch.Tensor:
    """Every auxiliary column as (A, n) rows: the LogUp running sums
    Z_{l,s} in (lookup, set) order, then the bus helpers h_{p,s} in
    (port, set) order, then the bus running sums Z_s:

        Z_{l,s}[i] = Σ_{r<i} [ Σ_j 1/(β_s − a_j[r]) − m[r]/(β_s − t[r]) ]
        h_{p,s}·(β_s − addr − δ_s·v0' − δ_s²·v1') = m,  Z_s = Σ_{r<i} Σ_p h.

    Lookups are vectorized by arity; the bus takes one batched inverse."""
    rows = []
    if air.lookups():
        rows.append(_lookup_sums(air, tr, consts, betas))
    if air.bus_ports():
        rows.append(_bus_columns(air, tr, consts, betas, deltas))
    return torch.cat(rows)


def _lookup_sums(air: Air, tr: torch.Tensor, consts: torch.Tensor,
                 betas: list[int]) -> torch.Tensor:
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


def _bus_columns(air: Air, tr: torch.Tensor, consts: torch.Tensor,
                 betas: list[int], deltas: list[int]) -> torch.Tensor:
    ports = air.bus_ports()
    S = NUM_LOOKUP_SETS
    dev = tr.device
    addr = consts[[p.addr_col for p in ports]][:, None]       # (Pp, 1, n)
    mult = consts[[p.mult_col for p in ports]][:, None]
    # values are read on the next row
    v0 = torch.roll(tr[[p.value_cols[0] for p in ports]], -1, dims=-1)[:, None]
    v1 = torch.roll(tr[[p.value_cols[1] for p in ports]], -1, dims=-1)[:, None]
    b = stages.const_column(betas, dev)                        # (S, 1)
    d1 = stages.const_column(deltas, dev)
    d2 = stages.const_column([d * d for d in deltas], dev)
    den = gl.sub(b, gl.add(gl.add(addr, gl.mul(v0, d1)), gl.mul(v1, d2)))
    h = gl.mul(mult, gl.inv(den))                              # (Pp, S, n)
    z = _exclusive_prefix_sum(gl.field_sum(h, 0))              # (S, n)
    return torch.cat([h.reshape(len(ports) * S, -1), z])


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


def _transition_sums(air, public, blowup, tr, ax, cl, betas, deltas, powers,
                     s, e):
    """(Σ_i α^i·T_i(x), number of constraints) over LDE points [s, e): the
    transition constraints of one block, "next row" read `blowup` points
    ahead.  `powers(k)` returns [α^0 .. α^(k-1)]."""
    blk = _window(tr, s, e)
    blk_n = _window(tr, s + blowup, e + blowup)
    local = list(blk.unbind(0))
    nxt = list(blk_n.unbind(0))
    consts = list(_window(cl, s, e).unbind(0)) if cl.shape[0] else None
    tvals = list(air.transition(DeviceAlgebra, local, nxt, public, consts))
    lookups = air.lookups()
    if lookups or air.bus_ports():
        aux_local = list(_window(ax, s, e).unbind(0))
        aux_next = list(_window(ax, s + blowup, e + blowup).unbind(0))
        if lookups:
            tvals += lookup_transitions(DeviceAlgebra, local, nxt, aux_local,
                                        aux_next, consts, betas, lookups)
        if air.bus_ports():
            tvals += bus_transitions(DeviceAlgebra, local, nxt, aux_local,
                                     aux_next, consts, betas, deltas, air)
        del aux_local, aux_next
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


def _composition(air, public, boundaries, x_last, blowup, tr, ax, cl,
                 alpha, betas, deltas, x, zh):
    """acc(x) = Σ_i α^i·T_i(x)·(x−x_last) + Σ_b α^{t+b}·B_b(x)·Z_H(x)/(x−x_b)
    over the LDE domain, as an ext pair (c0, c1) of (N,) tensors.

    The transition constraints are evaluated in blocks of consecutive LDE
    points (`composition_block`): a point's constraints read only its own
    column and the one `blowup` ahead, so the blocks concatenate to the
    whole-domain result while a wide AIR's stacked temporaries stay bounded.
    `blowup` is the index distance of "the next trace row": the blowup on
    the whole LDE domain, 1 on one stride-`blowup` coset (`prove_streamed`);
    `zh` is a tensor over the points or, on one coset, a Python int.
    """
    W, N = tr.shape
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
                                             betas, deltas, powers, s, e)
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
            # column index >= W addresses an aux column (lookup_boundaries)
            pc = torch.stack([tr[c] if c < W else ax[c - W]
                              for (_r, c, _v) in boundaries[s:e]])
            zhb = zh[None] if isinstance(zh, torch.Tensor) else zh
            b = gl.mul(gl.mul(gl.sub(pc, vals[s:e]), zhb), dinv[seg[s:e]])
            acc = ge.add(acc, stages.weighted_sum(b, apb[s:e]))
    return acc


# ---------------------------------------------------------------------------
# FRI prove — fold/commit layers on the device
# ---------------------------------------------------------------------------

def _fri_prove_staged(L, log_len: int, shift: int, config: FriConfig,
                      challenger: Challenger, spill: bool = False):
    """Fold-and-commit layers.  Returns (FriProof without query rounds,
    [(codeword, tree)] per layer): device codewords and DeviceTrees, or
    with `spill` (the streamed prover) host uint64 codewords and HostTrees,
    moved off the device as each layer is committed."""
    layers = []
    caps = []
    c = L
    n = 1 << log_len
    cur_shift = shift
    cur_log = log_len
    while n > config.final_poly_len << config.rate_bits:
        tree = stages.fri_commit_layer(
            c, cur_log, min(config.cap_height, cur_log - 1))
        if spill:
            tree = stages.HostTree.from_device(tree)
        cap = tree.cap_ints()
        caps.append(cap)
        challenger.observe_cap(cap)
        beta = challenger.get_extension_challenge()
        c_next = stages.fri_fold(c, beta, cur_log, cur_shift)
        layers.append((stages.spill_codeword(c) if spill else c, tree))
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
    """Prove `air` on the (W, n) uint64 trace, every stage on `device`.
    A statement above STREAM_THRESHOLD_ELEMS goes to `prove_streamed`."""
    if _use_streaming(air, config):
        return prove_streamed(air, trace_u64, config, device=device)
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

    # ---- lookup/bus aux columns (committed after post-trace challenges) ---
    lookups = air.lookups()
    ports = air.bus_ports()
    _, _, A = bus_aux_layout(air)
    aux_tree = aux_lde = aux_coeff = None
    empty = torch.zeros((0, n << rate), dtype=torch.int64, device=dev)
    betas, deltas = _aux_challenges(air, K, challenger)
    if lookups or ports:
        ax = aux_witness(air, tr, gl.from_u64(consts_u64, dev), betas, deltas)
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
        (lookup_boundaries(air) if (lookups or ports) else [])
    acc = _composition(air, public, boundaries, x_last, blowup, tr_lde,
                       aux_lde if A else empty, const_lde if K else empty,
                       alpha, betas, deltas, x, zh)

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
    opened = _open_at_zeta((coeff, aux_coeff, const_coeff, q), chunks, zeta,
                           w_zeta, air.log_n, challenger)

    # ---- DEEP composition codeword ------------------------------------------
    gamma = challenger.get_extension_challenge()
    ldes = (tr_lde, aux_lde if A else None, const_lde if K else None, q_lde)
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

    return _proof(trace_tree, quot_tree, aux_tree, opened, fri_proof,
                  trace_openings, quotient_openings, constants_openings,
                  aux_openings)


def _aux_challenges(air: Air, K: int, challenger: Challenger):
    """The post-trace challenges (betas, deltas) of the lookup and bus
    arguments; empty lists when the AIR has neither."""
    lookups = air.lookups()
    ports = air.bus_ports()
    if not (lookups or ports):
        return [], []
    assert K, "lookup tables / bus addresses live in constant_columns()"
    if lookups:
        assert air.constraint_degree >= max(lk.degree for lk in lookups), \
            "constraint_degree must cover the synthesized lookup constraints"
    betas = challenger.get_n_challenges(NUM_LOOKUP_SETS)
    deltas = challenger.get_n_challenges(NUM_LOOKUP_SETS) if ports else []
    return betas, deltas


def _open_at_zeta(groups, chunks: int, zeta, w_zeta, log_n: int,
                  challenger: Challenger):
    """Evaluate the coefficient groups (trace, aux | None, const | None,
    quotient chunks) at ζ and w·ζ and observe every value.  Returns
    (tz, tnz, az, anz, kz, qz) as lists of ext int pairs."""
    present = [g for g in groups if g is not None]
    evals = iter(stages.deep_eval_groups(present, zeta, w_zeta, log_n))
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


# ---------------------------------------------------------------------------
# Coset-streamed prove (1/blowup of the device memory, bit-identical proofs)
# ---------------------------------------------------------------------------

def _interleave_cosets(parts):
    """[(n,) per coset c = 0..blowup-1] -> (N,) in LDE natural order."""
    return torch.stack(parts, dim=-1).reshape(-1)


def prove_streamed(air: Air, trace_u64: np.ndarray,
                   config: StarkConfig = StarkConfig(), *,
                   device) -> StarkProof:
    """Coset-streamed prover: the same proof as `prove`, with the committed
    LDEs never standing on the device.

    The LDE domain splits into `blowup` stride-`blowup` cosets: index
    j = blowup·t + c is the point g·w_N^c·w_n^t.  The constraint
    composition and DEEP run one coset at a time as a size-n transform of
    the coefficient rows, where "the next trace row" is the next point of
    the same coset; leaf hashing runs a block of rows at a time over the
    whole domain (`stages.commit_streamed`).  Only single (N,) codewords
    (composition, DEEP) and the (N, 12) leaf sponges are built at full
    size; commitments and FRI layers go to the host (`stages.HostTree`),
    and the queried leaves are recomputed from their cosets."""
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
    const_tree, _, const_coeff = preprocess(air, config, consts_u64,
                                            device=dev, streamed=True)
    if const_tree is not None:
        challenger.observe_cap(const_tree.cap_ints())

    # ---- trace commit -------------------------------------------------------
    tr = gl.from_u64(trace_u64, dev)
    coeff = stages.to_coeffs(tr)
    trace_tree = stages.commit_streamed(coeff, log_N, cap_h)
    challenger.observe_cap(trace_tree.cap_ints())

    # ---- lookup/bus aux columns ----------------------------------------------
    lookups = air.lookups()
    ports = air.bus_ports()
    _, _, A = bus_aux_layout(air)
    aux_tree = aux_coeff = None
    betas, deltas = _aux_challenges(air, K, challenger)
    if lookups or ports:
        ax = aux_witness(air, tr, gl.from_u64(consts_u64, dev), betas, deltas)
        aux_coeff = stages.to_coeffs(ax)
        del ax
        aux_tree = stages.commit_streamed(aux_coeff, log_N, cap_h)
        challenger.observe_cap(aux_tree.cap_ints())
    del tr

    # ---- constraint composition, coset by coset -----------------------------
    alpha = challenger.get_extension_challenge()
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    boundaries = list(air.boundaries(public)) + \
        (lookup_boundaries(air) if (lookups or ports) else [])
    zh_vals, _ = stages.zh_values(air.log_n, rate)
    wt = stages.shift_table(w, n, dev)
    empty = torch.zeros((0, n), dtype=torch.int64, device=dev)
    parts0, parts1 = [], []
    for c in range(blowup):
        shift = stages.coset_shift(c, log_N)
        a0, a1 = _composition(
            air, public, boundaries, x_last, 1,
            stages.coset_eval_rows(coeff, shift),
            stages.coset_eval_rows(aux_coeff, shift) if A else empty,
            stages.coset_eval_rows(const_coeff, shift) if K else empty,
            alpha, betas, deltas, gl.mul(wt, shift), zh_vals[c])
        parts0.append(a0)
        parts1.append(a1)
    acc = (_interleave_cosets(parts0), _interleave_cosets(parts1))
    del parts0, parts1

    # ---- quotient -----------------------------------------------------------
    _, zhinv = stages.zh_on_domain(air.log_n, rate, dev)
    chunks = _num_quotient_chunks(air)
    ok, q = stages.quotient_coeffs(acc, zhinv, chunks, rate)
    del acc
    assert ok, "composition polynomial exceeds quotient degree bound"
    quot_tree = stages.commit_streamed(q, log_N, cap_h)
    challenger.observe_cap(quot_tree.cap_ints())

    # ---- DEEP openings at ζ (coefficient side, as in `prove`) ----------------
    zeta = challenger.get_extension_challenge()
    w_zeta = ext_py.mul(zeta, ext_py.from_base(w))
    groups = (coeff, aux_coeff, const_coeff, q)
    opened = _open_at_zeta(groups, chunks, zeta, w_zeta, air.log_n,
                           challenger)

    # ---- DEEP composition codeword, coset by coset ---------------------------
    gamma = challenger.get_extension_challenge()
    parts0, parts1 = [], []
    for c in range(blowup):
        l0, l1 = stages.deep_compose_coset(groups, opened, gamma, zeta,
                                           w_zeta, W, A, K, chunks, log_N, c)
        parts0.append(l0)
        parts1.append(l1)
    L = (_interleave_cosets(parts0), _interleave_cosets(parts1))
    del parts0, parts1

    # ---- FRI (codewords and trees move to the host as folding proceeds) -----
    fri_proof, fri_host = _fri_prove_staged(L, log_N, gl.GENERATOR,
                                            config.fri, challenger, spill=True)
    del L
    indices = derive_query_indices(challenger, log_N, config.fri.num_queries)

    # ---- openings: recompute only the queried cosets --------------------------
    named = [coeff, q] + ([const_coeff] if K else []) + \
        ([aux_coeff] if A else [])
    trees = [trace_tree, quot_tree] + ([const_tree] if K else []) + \
        ([aux_tree] if A else [])
    leaf_at: list[dict] = [{} for _ in named]
    by_coset: dict[int, list[int]] = {}
    for j in indices:
        by_coset.setdefault(j % blowup, []).append(j)
    for c, js in by_coset.items():
        ts = sorted({j // blowup for j in js})
        t_pos = {t: k for k, t in enumerate(ts)}
        cols = torch.tensor(ts, dtype=torch.int64, device=dev)
        shift = stages.coset_shift(c, log_N)
        for g, grp in enumerate(named):
            vals = gl.to_u64(stages.coset_eval_rows(grp, shift)[:, cols])
            for j in js:
                leaf_at[g][j] = [int(v) for v in vals[:, t_pos[j // blowup]]]
    g_paths, fri_pairs, fri_paths = stages.open_positions_host(
        indices, trees, fri_host)
    Q = len(indices)
    openings = [[TreeOpening(leaf=leaf_at[g][j],
                             path=[[int(x) for x in lvl[qi]]
                                   for lvl in g_paths[g]])
                 for qi, j in enumerate(indices)] for g in range(len(named))]
    fri_proof.query_rounds = _fri_rounds(fri_pairs, fri_paths, Q)
    return _proof(trace_tree, quot_tree, aux_tree, opened, fri_proof,
                  openings[0], openings[1], openings[2] if K else [],
                  openings[-1] if A else [])
