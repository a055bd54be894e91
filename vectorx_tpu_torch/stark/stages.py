"""Prover stages on the device of the tensors they are given.

Port of `vectorx_tpu.stark.stages`:

    commit        : iNTT -> coset-LDE -> leaf hash -> Merkle layers
    streamed      : the same commitment a block of rows at a time, its
                    digest layers kept on the host (`HostTree`)
    quotient      : Z_H division -> coset iNTT -> chunk split
    DEEP eval     : every coefficient group at ζ and w·ζ
    DEEP compose  : the batched opening codeword L(x)
    FRI, grind    : `vectorx_tpu_torch.fri.fri` (fold + commit per layer,
                    final coefficients, proof of work), named here too
    openings      : every queried leaf + Merkle path in one gather

Torch runs eagerly, so the reference's jit-cache machinery (`cached_jit`,
`env_key`) has no counterpart; device constants (domain points, power
tables) are still built once and cached per device.  Every NTT goes through
`vectorx_tpu_torch.ntt`, i.e. the CUDA kernels for CUDA tensors.  Field sums
use the one-pass lazy reduction `goldilocks.field_sum`, equal mod p to the
reference's pairwise tree sums; every value leaving a stage is canonical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vectorx_tpu_torch import merkle, tracing
from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import extension as ge
from vectorx_tpu_torch.field import goldilocks as gl
# The FRI prover stages live in `fri.fri` (`stark/` imports `fri/`, never
# the reverse) and are named here too, as the reference's stages names them.
from vectorx_tpu_torch.fri.fri import (  # noqa: F401
    LocalFri, fri_commit_layer, fri_final_coeffs, fri_fold, fri_fold_pairs,
    grind, spill_codeword)
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.merkle import DeviceTree, PoseidonMerkleTree
from vectorx_tpu_torch.ntt import coset_intt, coset_lde, coset_ntt, intt
from vectorx_tpu_torch.ntt.ntt import _root_of_unity, device_powers

P = gl.P

# Peak-memory knob for wide-trace LDEs: transforms over a (rows, N) array
# run in row blocks of ~LDE_CHUNK_ELEMS elements, so temporaries stay
# bounded however wide the AIR is.
LDE_CHUNK_ELEMS = 1 << 26
# Row blocks of the (rows, N) weighted column sums (composition, DEEP).
SUM_CHUNK_ELEMS = 1 << 25

_DEV: dict = {}


def _dev(key: tuple, device, build):
    k = key + (str(torch.device(device)),)
    v = _DEV.get(k)
    if v is None:
        v = _DEV[k] = build()
    return v


def ext_const(pair, device):
    """A Python (c0, c1) pair as a broadcastable pair of 0-dim tensors."""
    return (torch.tensor(gl.to_i64(pair[0] % P), device=device),
            torch.tensor(gl.to_i64(pair[1] % P), device=device))


def const_column(vals, device) -> torch.Tensor:
    """Python ints -> (len, 1) int64 column for row-wise broadcasting."""
    return gl.from_u64(np.array([v % P for v in vals], dtype=np.uint64),
                       device)[:, None]


# ---------------------------------------------------------------------------
# Row-chunked transforms
# ---------------------------------------------------------------------------

def rows_chunked(fn, x: torch.Tensor, out_cols: int) -> torch.Tensor:
    """Apply `fn` over row blocks sized so block_rows · out_cols <=
    LDE_CHUNK_ELEMS; equal to one full-width call (rows are independent)."""
    rows = x.shape[0]
    block = max(1, LDE_CHUNK_ELEMS // max(1, out_cols))
    if rows <= block:
        return fn(x)
    return torch.cat([fn(x[s:s + block]) for s in range(0, rows, block)],
                     dim=0)


def intt_rows(x: torch.Tensor) -> torch.Tensor:
    return rows_chunked(intt, x, x.shape[-1])


def coset_lde_rows(c: torch.Tensor, N: int) -> torch.Tensor:
    """coeffs (rows, n) -> coset evaluations (rows, N), row-chunked."""
    rate_bits = (N // c.shape[-1]).bit_length() - 1
    assert c.shape[-1] << rate_bits == N, "N must be n times a power of two"
    return rows_chunked(lambda a: coset_lde(a, rate_bits), c, N)


# ---------------------------------------------------------------------------
# Cached device constants
# ---------------------------------------------------------------------------

def domain_x(log_len: int, shift: int, device) -> torch.Tensor:
    """x_i = shift·w^i over a 2^log_len domain."""
    def build():
        w = _root_of_unity(log_len, inverse=False)
        return gl.mul(device_powers(w, 1 << log_len, device), shift)

    return _dev(("x", log_len, shift), device, build)


def shift_table(shift: int, n: int, device) -> torch.Tensor:
    """[shift^0 .. shift^(n-1)] on `device`."""
    return device_powers(shift, n, device)


@functools.lru_cache(maxsize=None)
def zh_values(log_n: int, rate_bits: int):
    """Z_H(x) = x^n − 1 on the stride-`blowup` cosets: (vals, invs) Python
    int lists of length blowup, indexed by coset c = j % blowup."""
    n = 1 << log_n
    blowup = 1 << rate_bits
    w8 = _root_of_unity(log_n + rate_bits, inverse=False)
    z8 = pow(w8, n, P)
    g_n = pow(gl.GENERATOR, n, P)
    vals = [(g_n * pow(z8, i, P) - 1) % P for i in range(blowup)]
    invs = [pow(v, P - 2, P) for v in vals]
    return vals, invs


def zh_on_domain(log_n: int, rate_bits: int, device):
    """(zh, zh_inv) over the length-N LDE domain (period-`blowup` values)."""
    def build():
        N = 1 << (log_n + rate_bits)
        vals, invs = zh_values(log_n, rate_bits)
        zh = const_column(vals, device)[:, 0]
        zhi = const_column(invs, device)[:, 0]
        reps = N // len(vals)
        return zh.repeat(reps), zhi.repeat(reps)

    return _dev(("zh", log_n, rate_bits), device, build)


# ---------------------------------------------------------------------------
# Commitments
# ---------------------------------------------------------------------------

def to_coeffs(rows: torch.Tensor) -> torch.Tensor:
    """Row-wise iNTT — evaluations (R, n) -> coefficients."""
    return intt_rows(rows)


def lde_rows(c: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """Coefficient rows (R, n) -> coset LDE (R, n·2^rate_bits)."""
    return coset_lde_rows(c, c.shape[-1] << rate_bits)


def commit_rows(rows: torch.Tensor, *, rate_bits: int, cap_height: int,
                do_intt: bool = True):
    """Commit to polynomial rows (R, n): iNTT (optional) -> rate-2^k coset
    LDE -> leaf hash (columns are leaves) -> Merkle layers.
    Returns (coeffs, lde, DeviceTree)."""
    N = rows.shape[-1] << rate_bits
    with tracing.span("stages.commit_rows", rows=rows.shape[0], points=N):
        c = intt_rows(rows) if do_intt else rows
        lde = coset_lde_rows(c, N)
        layers = merkle.build_layers(lde.T, cap_height=cap_height)
        return c, lde, DeviceTree(layers, cap_height)


def coset_shift(c: int, log_N: int) -> int:
    """Shift of the c-th stride-`blowup` coset: LDE index j = blowup·t + c
    is the point g·w_N^c·w_n^t."""
    return (gl.GENERATOR * pow(_root_of_unity(log_N, inverse=False), c, P)) % P


def coset_eval_rows(c: torch.Tensor, shift: int) -> torch.Tensor:
    """Degree-<n coefficient rows (R, n) evaluated on the coset shift·H —
    the streamed prover's per-coset transform (`coset_ntt`, i.e. the CUDA
    kernels on a CUDA tensor), row-chunked."""
    return rows_chunked(lambda a: coset_ntt(a, shift), c, c.shape[-1])


def hash_rows_leaves(rows: torch.Tensor) -> torch.Tensor:
    """Leaf digests of evaluation rows (R, n): columns are leaves."""
    return merkle.hash_leaves(rows.T)


def _absorb(state: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One overwrite-mode sponge step of `poseidon.hash_no_pad` for every
    leaf at once: (N, 12) states, (N, k ≤ 8) lanes."""
    return merkle._rows_blocked(
        lambda s, x: poseidon.permute(torch.cat([x, s[:, x.shape[1]:]], 1)),
        state, rows)


def commit_streamed(c: torch.Tensor, log_N: int, cap_height: int):
    """Merkle tree over the LDE leaves of coefficient rows (R, n), a block
    of rows at a time: each block's LDE (rows, N) is absorbed into the N
    leaf sponges (8 rows per permutation, as `hash_no_pad` absorbs a
    leaf), so only the (N, 12) sponge states and one block stand on the
    device; the layers are kept on the host (`HostTree`).  Equal to the
    tree of `commit_rows` over the same rows, with its number of Poseidon
    calls: a wide statement is not hashed once per coset."""
    R = c.shape[0]
    N = 1 << log_N
    with tracing.span("stages.commit_streamed", columns=R, points=N):
        if R <= poseidon.DIGEST:
            digs = hash_rows_leaves(coset_lde_rows(c, N))
        else:
            step = max(poseidon.RATE,
                       LDE_CHUNK_ELEMS // N // poseidon.RATE * poseidon.RATE)
            st = torch.zeros((N, poseidon.WIDTH), dtype=torch.int64,
                             device=c.device)
            for r0 in range(0, R, step):
                e = coset_lde_rows(c[r0:r0 + step], N)
                for a in range(0, e.shape[0], poseidon.RATE):
                    st = _absorb(st, e[a:a + poseidon.RATE].T)
                del e
            digs = st[:, :poseidon.DIGEST]
            del st
        return merkle.build_tree_from_digests(digs, cap_height)


# The streamed prover's name for the host tree (the reference's HostTree).
HostTree = PoseidonMerkleTree


def open_positions_host(indices, trees, fri_layers):
    """Host twin of `open_positions` for the streamed prover: `trees` are
    HostTrees, `fri_layers` ((c0, c1) uint64, HostTree) per fold layer.
    Returns (group_paths, fri_pairs, fri_paths) in `open_positions`'s
    formats (the streamed prover recomputes the queried leaves itself)."""
    idx = np.asarray(indices, dtype=np.int64)
    group_paths = [t.open_paths(idx) for t in trees]
    fri_pairs, fri_paths = [], []
    cur = idx
    for (c0, c1), tree in fri_layers:
        h = c0.shape[0] // 2
        i = cur % h
        fri_pairs.append((c0[i], c1[i], c0[i + h], c1[i + h]))
        fri_paths.append(tree.open_paths(i))
        cur = i
    return group_paths, fri_pairs, fri_paths


class LocalDomain(LocalFri):
    """How `prove` lays out the LDE domain: all of it on one device.

    `prove` reaches every stage that depends on the layout through these
    hooks; `vectorx_tpu_torch.parallel.sharded_prove.ShardedDomain` splits
    the domain's points over ranks behind the same ones.  An LDE a hook
    returns holds the points `points()` selects, followed by the "next
    row" points the composition reads past them (none here: it wraps).
    Coefficients a hook returns are the polynomials this layout commits
    and evaluates (all of them here); `prove` only hands them back to the
    hooks."""

    def commit_rows(self, rows, *, rate_bits: int, cap_height: int,
                    do_intt: bool = True):
        """(coeffs of the committed rows, LDE of this layout's points,
        tree)."""
        return commit_rows(rows, rate_bits=rate_bits, cap_height=cap_height,
                           do_intt=do_intt)

    def points(self, t):
        """The entries of a full-domain (..., N) table at this layout's
        points."""
        return t

    def aux_rows(self, air, tr, consts, betas, deltas):
        """The lookup/bus aux rows this layout commits (`commit_rows`)."""
        from vectorx_tpu_torch.stark import prover

        return prover.aux_witness(air, tr, consts, betas, deltas)

    def quotient(self, acc, zhinv, chunks: int, rate_bits: int):
        """(ok, quotient-chunk coefficients for `commit_rows(...,
        do_intt=False)`) from the composition codeword over this layout's
        points; `ok` is the degree check, the same on every rank."""
        return quotient_coeffs(acc, zhinv, chunks, rate_bits)

    def deep_evals(self, groups, zeta, w_zeta, log_n: int):
        """`deep_eval_groups` of the coefficient groups `commit_rows` and
        `quotient` returned."""
        return deep_eval_groups(groups, zeta, w_zeta, log_n)

    def open_positions(self, indices, leaf_groups, trees, fri_layers):
        return open_positions(indices, leaf_groups, trees, fri_layers)


LOCAL = LocalDomain()


# ---------------------------------------------------------------------------
# Quotient
# ---------------------------------------------------------------------------

def quotient_coeffs(acc, zhinv: torch.Tensor, chunks: int, rate_bits: int):
    """Composition codeword (c0, c1) over the LDE domain -> (ok, canonical
    quotient-chunk coefficient rows (2·chunks, n)), rows interleaved
    [Q0.c0, Q0.c1, Q1.c0, ...]; `ok` says everything above chunks·n
    vanished."""
    with tracing.span("stages.quotient_coeffs", points=acc[0].shape[0]):
        n = acc[0].shape[0] >> rate_bits
        qc0 = gl.canonicalize(coset_intt(gl.mul(acc[0], zhinv)))
        qc1 = gl.canonicalize(coset_intt(gl.mul(acc[1], zhinv)))
        nn = chunks * n
        ok = bool((qc0[nn:] == 0).all()) and bool((qc1[nn:] == 0).all())
        q = torch.stack([qc0[:nn].reshape(chunks, n),
                         qc1[:nn].reshape(chunks, n)], dim=1)
        return ok, q.reshape(2 * chunks, n)


# ---------------------------------------------------------------------------
# DEEP evaluation at ζ / w·ζ
# ---------------------------------------------------------------------------

def ext_power_table(pt, count: int, device):
    """[pt^0 .. pt^(count-1)] in GF(p^2) by doubling with host seeds
    pt^(2^i)."""
    tab = (torch.ones(1, dtype=torch.int64, device=device),
           torch.zeros(1, dtype=torch.int64, device=device))
    cur = pt
    while tab[0].shape[0] < count:
        nxt = ge.mul(tab, ext_const(cur, device))
        tab = tuple(torch.cat([a, b]) for a, b in zip(tab, nxt))
        cur = ext_py.mul(cur, cur)
    return tab[0][:count], tab[1][:count]


def dot_rows(c: torch.Tensor, tab) -> torch.Tensor:
    """Σ_j c[r, j]·tab[j] for base rows (R, n) against an ext table, as
    (R, 2) (c0, c1) per row."""
    n = c.shape[-1]
    ch = max(1, LDE_CHUNK_ELEMS // max(1, 4 * n))
    e0, e1 = [], []
    for s in range(0, c.shape[0], ch):
        blk = c[s:s + ch]
        e0.append(gl.field_sum(gl.mul(blk, tab[0]), -1))
        e1.append(gl.field_sum(gl.mul(blk, tab[1]), -1))
    return torch.stack([torch.cat(e0), torch.cat(e1)], dim=1)


def ext_pairs(t: torch.Tensor) -> list:
    """(R, 2) ext values -> R canonical (c0, c1) int pairs."""
    return [(int(x), int(y)) for x, y in gl.to_u64(t)]


def deep_eval_groups(groups, zeta, w_zeta, log_n: int):
    """Evaluate every coefficient group (R_i, n) at ζ and w·ζ.
    Returns per group ([evals at ζ], [evals at w·ζ]) as ext int pairs."""
    dev = groups[0].device
    n = groups[0].shape[-1]
    tz = ext_power_table(zeta, n, dev)
    twz = ext_power_table(w_zeta, n, dev)
    return [(ext_pairs(dot_rows(g, tz)), ext_pairs(dot_rows(g, twz)))
            for g in groups]


# ---------------------------------------------------------------------------
# DEEP composition codeword
# ---------------------------------------------------------------------------

def _ext_dot(weights, vals):
    acc = ext_py.ZERO
    for w, v in zip(weights, vals):
        acc = ext_py.add(acc, ext_py.mul(w, v))
    return acc


def weighted_sum(cols: torch.Tensor, weights) -> tuple:
    """Σ_j w_j·cols[j] over rows (B, N) with ext weights: (c0, c1) (N,)."""
    B, N = cols.shape
    dev = cols.device
    w0 = const_column([w[0] for w in weights], dev)
    w1 = const_column([w[1] for w in weights], dev)
    ch = max(1, min(B, SUM_CHUNK_ELEMS // max(1, N)))
    s0 = s1 = None
    for s in range(0, B, ch):
        blk = cols[s:s + ch]
        c0 = gl.field_sum(gl.mul(blk, w0[s:s + ch]), 0)
        c1 = gl.field_sum(gl.mul(blk, w1[s:s + ch]), 0)
        s0 = c0 if s0 is None else gl.add(s0, c0)
        s1 = c1 if s1 is None else gl.add(s1, c1)
    return s0, s1


def _base_group_weighted(cols, weights, opened, inv_den):
    """Σ_j w_j (P_j(x) − y_j) · inv_den for base-field columns (B, N)."""
    dev = cols.device
    diff = ge.sub(weighted_sum(cols, weights),
                  ext_const(_ext_dot(weights, opened), dev))
    return ge.mul(diff, inv_den)


def deep_compose(ldes, opened, gamma, zeta, w_zeta,
                 W: int, A: int, K: int, chunks: int, x):
    """The DEEP codeword at the points `x` of the LDE domain that the LDE
    rows hold (all of it, or a rank's block).

    ldes: (trace, aux | None, const | None, quotient) LDE rows (R, N).
    opened: (tz, tnz, az, anz, kz, qz) lists of ext int pairs."""
    return _deep_L(ldes, opened, gamma, zeta, w_zeta, W, A, K, chunks, x)


def deep_compose_coset(coeffs, opened, gamma, zeta, w_zeta,
                       W: int, A: int, K: int, chunks: int,
                       log_N: int, c: int):
    """Streamed variant: evaluate the coefficient groups (as in `ldes`) on
    stride-`blowup` coset `c` and form the DEEP codeword there."""
    n = coeffs[0].shape[-1]
    with tracing.span("stages.deep_compose_coset", coset=c, points=n):
        s = coset_shift(c, log_N)
        ldes = tuple(None if g is None else coset_eval_rows(g, s)
                     for g in coeffs)
        log_n = n.bit_length() - 1
        x = gl.mul(shift_table(_root_of_unity(log_n, inverse=False), n,
                               coeffs[0].device), s)
        return _deep_L(ldes, opened, gamma, zeta, w_zeta, W, A, K, chunks, x)


def _deep_L(ldes, opened, gamma, zeta, w_zeta, W, A, K, chunks, x):
    """The DEEP codeword on one evaluation set (points `x`): the full
    domain or one coset."""
    tr = ldes[0]
    dev = tr.device
    x_ext = (x, torch.zeros_like(x))
    inv_x_zeta = ge.inv(ge.sub(x_ext, ext_const(zeta, dev)))
    inv_x_wzeta = ge.inv(ge.sub(x_ext, ext_const(w_zeta, dev)))
    del x_ext

    n_polys = 2 * W + 2 * A + K + chunks
    g = [ext_py.ONE]
    for _ in range(n_polys - 1):
        g.append(ext_py.mul(g[-1], gamma))
    tz, tnz, az, anz, kz, qz = opened

    L = ge.add(_base_group_weighted(tr, g[0:W], tz, inv_x_zeta),
               _base_group_weighted(tr, g[W:2 * W], tnz, inv_x_wzeta))
    if A:
        ax = ldes[1]
        L = ge.add(L, _base_group_weighted(ax, g[2 * W:2 * W + A], az,
                                           inv_x_zeta))
        L = ge.add(L, _base_group_weighted(ax, g[2 * W + A:2 * W + 2 * A],
                                           anz, inv_x_wzeta))
    if K:
        L = ge.add(L, _base_group_weighted(
            ldes[2], g[2 * W + 2 * A:2 * W + 2 * A + K], kz, inv_x_zeta))
    # quotient chunks: extension-valued columns, interleaved c0/c1 rows
    q = ldes[3]
    qg = g[2 * W + 2 * A + K:]
    qc0, qc1 = q[0::2], q[1::2]
    g0 = const_column([w[0] for w in qg], dev)
    g1 = const_column([w[1] for w in qg], dev)
    s_c0 = gl.field_sum(gl.add(gl.mul(qc0, g0),
                               gl.mul_small(gl.mul(qc1, g1), ge.W)), 0)
    s_c1 = gl.field_sum(gl.add(gl.mul(qc1, g0), gl.mul(qc0, g1)), 0)
    qdiff = ge.sub((s_c0, s_c1), ext_const(_ext_dot(qg, qz), dev))
    return ge.add(L, ge.mul(qdiff, inv_x_zeta))


# ---------------------------------------------------------------------------
# Bulk query openings
# ---------------------------------------------------------------------------

def open_positions(indices, leaf_groups, trees, fri_layers):
    """Gather every queried leaf + Merkle path.

    indices: Q query positions into the length-N domain.
    leaf_groups: (R, N) committed rows whose columns are the tree leaves.
    trees: DeviceTree per leaf group.
    fri_layers: (codeword (c0, c1), DeviceTree) per fold layer; the query
        index folds as i <- i mod h between layers.

    Returns (group_leaves (R, Q) each, group_paths [(Q, 4) per level],
    fri_pairs [4 arrays (Q,)], fri_paths) as canonical uint64 numpy."""
    dev = trees[0].layers[0].device
    idx = torch.tensor(list(indices), dtype=torch.int64, device=dev)

    def path(layers, cur):
        sibs = []
        for layer in layers[:-1]:
            sibs.append(gl.to_u64(layer[cur ^ 1]))
            cur = cur >> 1
        return sibs

    group_leaves = [gl.to_u64(g[:, idx]) for g in leaf_groups]
    group_paths = [path(t.layers, idx) for t in trees]
    fri_pairs, fri_paths = [], []
    cur = idx
    for (c0, c1), tree in fri_layers:
        h = c0.shape[0] // 2
        i = cur % h
        fri_pairs.append((gl.to_u64(c0[i]), gl.to_u64(c1[i]),
                          gl.to_u64(c0[i + h]), gl.to_u64(c1[i + h])))
        fri_paths.append(path(tree.layers, i))
        cur = i
    return group_leaves, group_paths, fri_pairs, fri_paths
