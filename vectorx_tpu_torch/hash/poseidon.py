"""Poseidon permutation over Goldilocks — width 12, x^7 S-box, 8 full + 22
partial rounds — plus the sponge / two-to-one compression used for Merkle
caps and the Fiat-Shamir transcript, on torch int64 tensors.

Port of `vectorx_tpu.hash.poseidon`: the same Grain-LFSR round constants and
Cauchy MDS (generated here in plain Python, no JAX), the same sparse
partial-round decomposition, the same sponge layout (rate 8, capacity 4,
overwrite-mode absorb, 4-element digests).  `load_round_constants` and
`set_params` swap the parameter table, as in the reference.

State layout: an int64 tensor of shape (..., 12) on any device; leading
dimensions batch independent permutations.  Plain torch (no kernel).
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from vectorx_tpu_torch import tracing
from vectorx_tpu_torch.field import goldilocks as gl

P = gl.P

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST = 4
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 22
ALPHA = 7
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS


# ---------------------------------------------------------------------------
# Parameter generation (Grain LFSR + Cauchy MDS), per the Poseidon reference.
# ---------------------------------------------------------------------------

def _grain_bits(n_bits: int, t: int, r_f: int, r_p: int):
    """The Grain LFSR bit stream from the official generate_params procedure."""
    state = []
    for value, width in ((1, 2), (0, 4), (n_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
        state.extend(int(b) for b in bin(value)[2:].zfill(width))
    state.extend([1] * 30)
    assert len(state) == 80

    def update():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()

    def next_bit():
        # evaluate bits in pairs: emit the second iff the first is 1
        while True:
            if update() == 1:
                return update()
            update()

    while True:
        yield next_bit()


@functools.lru_cache(maxsize=None)
def _generated_round_constants() -> tuple:
    gen = _grain_bits(64, WIDTH, FULL_ROUNDS, PARTIAL_ROUNDS)
    consts = []
    while len(consts) < WIDTH * N_ROUNDS:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(gen)
        if v < P:
            consts.append(v)
    return tuple(consts)


@functools.lru_cache(maxsize=None)
def _generated_mds() -> tuple:
    """Cauchy MDS: M[i][j] = 1 / (x_i + y_j), x_i = i, y_j = t + j."""
    rows = []
    for i in range(WIDTH):
        row = []
        for j in range(WIDTH):
            row.append(pow((i + (WIDTH + j)) % P, P - 2, P))
        rows.append(tuple(row))
    return tuple(rows)


_OVERRIDE = {"rc": None, "mds": None}
_PARAMS_EPOCH = 0
_DEV: dict = {}


def params_epoch() -> int:
    """Monotone counter bumped whenever the parameter table changes; caches
    of derived parameters are keyed on it."""
    return _PARAMS_EPOCH


def set_params(rc, mds) -> None:
    """Install a parameter table: 360 round constants and a 12x12 MDS
    matrix (ints or numpy arrays; taken mod p)."""
    rc = tuple(int(x) % P for x in np.asarray(rc, dtype=object).reshape(-1))
    assert len(rc) == WIDTH * N_ROUNDS
    mds = tuple(tuple(int(x) % P for x in row) for row in
                np.asarray(mds, dtype=object))
    assert len(mds) == WIDTH and all(len(r) == WIDTH for r in mds)
    global _PARAMS_EPOCH
    _OVERRIDE["rc"] = rc
    _OVERRIDE["mds"] = mds
    _PARAMS_EPOCH += 1
    _fast_partial_params.cache_clear()
    _DEV.clear()


def reset_params() -> None:
    """Back to the generated (Grain LFSR + Cauchy) table."""
    global _PARAMS_EPOCH
    _OVERRIDE["rc"] = None
    _OVERRIDE["mds"] = None
    _PARAMS_EPOCH += 1
    _fast_partial_params.cache_clear()
    _DEV.clear()


def load_round_constants(path: str) -> None:
    """Load an external parameter table (e.g. plonky2's) from JSON:
    {"round_constants": [360 ints], "mds": [[12x12 ints]]}."""
    with open(path) as f:
        data = json.load(f)
    set_params(data["round_constants"], data["mds"])


def int_params():
    """(round constants, MDS) as Python ints — the current table."""
    return (_OVERRIDE["rc"] or _generated_round_constants(),
            _OVERRIDE["mds"] or _generated_mds())


def _mat_inv_mod_p(m: list[list[int]]) -> list[list[int]]:
    """Inverse of a small matrix over GF(p) by Gauss-Jordan (exact ints)."""
    t = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(t)]
         for i, row in enumerate(m)]
    for col in range(t):
        piv = next(r for r in range(col, t) if a[r][col] % P != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [(x * inv) % P for x in a[col]]
        for r in range(t):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[t:] for row in a]


def _mat_vec(m, v):
    return [sum(mi * vi for mi, vi in zip(row, v)) % P for row in m]


def _mat_mul(a, b):
    t = len(a)
    return [[sum(a[i][k] * b[k][j] for k in range(t)) % P for j in range(t)]
            for i in range(t)]


@functools.lru_cache(maxsize=None)
def _fast_partial_params():
    """Sparse decomposition of the partial-round chain (Poseidon paper
    App. B; plonky2's `poseidon::partial_rounds` fast path).

    Each partial round's dense MDS matvec (144 muls) is replaced by a
    sparse matrix ρ_i (first row arbitrary, first column arbitrary,
    identity elsewhere: 23 muls), with ONE leftover dense matrix σ_last
    applied after the chain and the round constants transformed to match.
    Bit-exact with the naive chain: round i's map is M·sbox0·(+c_i);
    decomposing N_i = σ_i·ρ_i (N_0 = M, N_{i+1} = M·σ_i) and commuting
    σ through sbox0 (it fixes lane 0) gives
        chain = σ_last · Π_i [ρ_i · sbox0 · (+c_i')],  c_i' = σ_{i-1}^{-1}c_i.
    """
    rc, mds = int_params()
    m = [list(row) for row in mds]
    half = FULL_ROUNDS // 2
    cs = [list(rc[(half + i) * WIDTH:(half + i + 1) * WIDTH])
          for i in range(PARTIAL_ROUNDS)]

    rho_v, rho_w, c_prime = [], [], []
    n = m
    prev_inv_hat = None
    for i in range(PARTIAL_ROUNDS):
        n_hat = [row[1:] for row in n[1:]]
        omega = [row[0] for row in n[1:]]
        nu = n[0][1:]
        n_hat_inv = _mat_inv_mod_p(n_hat)
        w_hat = _mat_vec(n_hat_inv, omega)
        rho_v.append([n[0][0]] + nu)            # first row of ρ_i
        rho_w.append(w_hat)                     # first column (below) of ρ_i
        if i == 0:
            c_prime.append(cs[0])
        else:
            c_prime.append([cs[i][0]] + _mat_vec(prev_inv_hat, cs[i][1:]))
        prev_inv_hat = n_hat_inv
        # σ_i = blockdiag(1, N̂_i);  N_{i+1} = M · σ_i
        sigma = [[1 if (r == 0 and c == 0) else 0 for c in range(WIDTH)]
                 for r in range(WIDTH)]
        for r in range(1, WIDTH):
            for c in range(1, WIDTH):
                sigma[r][c] = n_hat[r - 1][c - 1]
        n = _mat_mul(m, sigma)
        sigma_last = sigma                      # σ of the LAST decomposition

    return rho_v, rho_w, c_prime, sigma_last


def _dev_params(device):
    """The parameter tables as int64 tensors on `device`, cached per
    (parameter epoch, device)."""
    dev = torch.device(device)
    key = (_PARAMS_EPOCH, str(dev))
    prm = _DEV.get(key)
    if prm is None:
        rc, mds = int_params()
        rho_v, rho_w, c_prime, sigma = _fast_partial_params()

        def t(a):
            return gl.from_u64(np.array(a, dtype=np.uint64), dev)

        prm = _DEV[key] = {
            "rc": t(rc).reshape(N_ROUNDS, WIDTH), "mds": t(mds),
            "v": t(rho_v), "w": t(rho_w), "c": t(c_prime), "sigma": t(sigma),
            "mds_T": limbs(np.array(mds, dtype=object).T, dev),
            "sigma_T": limbs(np.array(sigma, dtype=object).T, dev)}
    return prm


def limbs(m, device) -> torch.Tensor:
    """A (K, R) matrix of field elements as its four 16-bit limbs, a
    (4, K, R) float64 tensor on `device`, for `_matmul_limbs`."""
    m = np.array(m, dtype=np.uint64)
    return torch.stack([
        torch.from_numpy(((m >> np.uint64(16 * b))
                          & np.uint64(0xFFFF)).astype(np.float64))
        for b in range(4)]).to(device)


# ---------------------------------------------------------------------------
# Permutation
# ---------------------------------------------------------------------------

def _sbox(x):
    """x^7 = x^4 * x^2 * x (4 muls)."""
    x2 = gl.sqr(x)
    x4 = gl.sqr(x2)
    return gl.mul(gl.mul(x2, x4), x)


def _mds_layer(s, m):
    """Dense 12x12 field matvec out_i = sum_j M[i][j] * s_j (one lazy sum).
    The field-op version of `_matmul_limbs`, kept as its reference."""
    return gl.field_sum(gl.mul(s[..., None, :], m), -1)


def _matmul_limbs(s: torch.Tensor, limbs: torch.Tensor) -> torch.Tensor:
    """s (..., K) times a constant (K, R) field matrix (K <= 16), exact, as
    eight float64 matmuls: the 32-bit halves of s against
    the 16-bit limbs of the matrix, each product below 2^48 and each
    K-term sum an integer below 2^52, so float64 holds every partial sum
    exactly.  The sums are carried through 16-bit digits into a 128-bit
    value plus a top word t < 2^8, folded with 2^128 = -2^32 (mod p).
    Equal mod p to `_mds_layer`."""
    halves = ((s & gl.M32).double(), ((s >> 32) & gl.M32).double())
    parts = {}
    for a, h in enumerate(halves):
        for b in range(4):
            k = 2 * a + b                      # shift 16·k
            d = (h @ limbs[b]).long()
            parts[k] = d if k not in parts else parts[k] + d
    carry = torch.zeros_like(parts[0])
    digits = []
    for k in range(8):
        v = carry + parts[k] if k in parts else carry
        digits.append(v & 0xFFFF)
        carry = v >> 16
    lo = digits[0] | (digits[1] << 16) | (digits[2] << 32) | (digits[3] << 48)
    hi = digits[4] | (digits[5] << 16) | (digits[6] << 32) | (digits[7] << 48)
    return gl.sub(gl._reduce128(lo, hi), carry << 32)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on a (..., 12) state."""
    assert state.shape[-1] == WIDTH
    with tracing.span("poseidon.permute", states=state.numel() // WIDTH):
        return _permute(state)


def _permute(state: torch.Tensor) -> torch.Tensor:
    prm = _dev_params(state.device)
    rc = prm["rc"]
    half = FULL_ROUNDS // 2

    # the dense 12x12 matvecs as exact float64 limb matmuls
    # (`_matmul_limbs`), which need no (states, 12, 12) temporaries; the
    # sparse rounds' products as field ops, which launch fewer kernels
    s = state
    for r in range(half):
        s = _matmul_limbs(_sbox(gl.add(s, rc[r])), prm["mds_T"])
    # sparse partial rounds: +c', sbox on lane 0, rho matvec (out0 = v.s,
    # out_{1:} = s_{1:} + w.s0); the dense residue is one sigma matvec
    for i in range(PARTIAL_ROUNDS):
        s = gl.add(s, prm["c"][i])
        s0 = _sbox(s[..., :1])
        s = torch.cat([s0, s[..., 1:]], dim=-1)
        s = torch.cat([gl.field_sum(gl.mul(s, prm["v"][i]), -1)[..., None],
                       gl.add(s[..., 1:], gl.mul(s0, prm["w"][i]))], dim=-1)
    s = _matmul_limbs(s, prm["sigma_T"])
    for r in range(half + PARTIAL_ROUNDS, N_ROUNDS):
        s = _matmul_limbs(_sbox(gl.add(s, rc[r])), prm["mds_T"])
    return s


# ---------------------------------------------------------------------------
# Sponge / digests (plonky2 layout: rate 8, capacity 4, 4-element digest)
# ---------------------------------------------------------------------------

def hash_no_pad(x: torch.Tensor) -> torch.Tensor:
    """Hash (..., k) field elements to a (..., 4) digest: overwrite-mode
    sponge, 8 lanes per permutation, no padding, squeeze the first 4."""
    st = torch.zeros((*x.shape[:-1], WIDTH), dtype=torch.int64,
                     device=x.device)
    for start in range(0, x.shape[-1], RATE):
        chunk = x[..., start:start + RATE]
        st = permute(torch.cat([chunk, st[..., chunk.shape[-1]:]], dim=-1))
    return st[..., :DIGEST]


def absorb_blocks(state: torch.Tensor, blocks: torch.Tensor,
                  m: int) -> torch.Tensor:
    """Thread one (12,) sponge state through the first `m` of the (M, 8)
    full-rate `blocks`: each overwrites the rate lanes and permutes —
    exactly the host Challenger's duplex."""
    for i in range(m):
        state = permute(torch.cat([blocks[i], state[RATE:]]))
    return state


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress two (..., 4) digests into one — the Merkle interior node."""
    z = torch.zeros((*left.shape[:-1], WIDTH - 2 * DIGEST),
                    dtype=torch.int64, device=left.device)
    return permute(torch.cat([left, right, z], dim=-1))[..., :DIGEST]
