"""ed25519 field-op AIR: ZK proof of batched GF(2^255-19) modular
multiplications — the core building block of curta's EdDSA STARK that the
reference circuits' justification delegates signature checking to
(upstream circuits/builder/justification.rs:237-243).

Port of `vectorx_tpu.stark.ed25519_air`.  Each row r < n-1 proves one
modular multiplication

    a_r · b_r = k_r · q + d_r       over ℤ,  q = 2^255 − 19,  d_r < 2^256

with all operands as 8-bit limbs, via the polynomial-identity technique:
p(x) = a(x)·b(x) − k(x)·q(x) − d(x) vanishes at x = 2^8, so the prover
witnesses the carry quotient c(x) = p(x)/(x − 2^8) and the AIR checks the
64 coefficient identities  p_i = c_{i−1} − 2^8·c_i  (degree-2).  Carry
coefficients are bounded |c_i| < 2^15, stored offset-by-2^15 as two
range-checked bytes.  Every limb and carry byte is range-checked against
one shared preprocessed byte table through the STARK core's LogUp
argument (stark/air.py).

Output convention is semi-reduced (d < 2^256, congruent mod q), matching
the batched ladder in curves/ed25519_batch.py; canonicalization is a
host-side equality at the chain ends.

Column layout (width 384):
  [0,32)    a limbs          [32,64)   b limbs
  [64,96)   d limbs          [96,129)  k limbs (k < 2^264)
  [129,255) carry bytes e (63 carries × 2 bytes, ascending)
  255       zero padding (keeps the lookup pairing even)
  [256,384) multiplicities, one per lookup pair
Constant column 0: byte table t[i] = min(i, 255).

Row 0's (a, b, d) limbs are pinned to public inputs, so a composed
statement can expose one multiplication and chain the rest privately.
Row n-1 sits outside the transition window and is zero padding.

Field values on the device are int64 tensors of u64 bit patterns, as in
the rest of the port's field layer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark.air import Air, DeviceAlgebra, Lookup

Q = (1 << 255) - 19
Q_LIMBS = [(Q >> (8 * i)) & 0xFF for i in range(32)]
NA, NK, NC = 32, 33, 63        # a/b/d limbs, k limbs, carry coefficients
COL_A, COL_B, COL_D, COL_K = 0, 32, 64, 96
COL_E = 129                    # 126 carry-byte columns
COL_PAD = 255
COL_M = 256                    # 128 multiplicity columns
WIDTH = 384
OFFSET = 1 << 15               # carry offset: c' = c + 2^15 ∈ [0, 2^16)


def _diag_indices(rows: int, cols: int):
    """(U, V, mask) of shape (64, rows) gathering the anti-diagonals of a
    (rows, cols) limb-product array: coefficient i sums entries (u, i−u)."""
    U = np.zeros((64, rows), dtype=np.int32)
    V = np.zeros((64, rows), dtype=np.int32)
    M = np.zeros((64, rows), dtype=bool)
    for i in range(64):
        us = range(max(0, i - cols + 1), min(rows - 1, i) + 1)
        for j, u in enumerate(us):
            U[i, j], V[i, j], M[i, j] = u, i - u, True
    return U, V, M


_AB_IDX = _diag_indices(NA, NA)
_KQ_IDX = _diag_indices(NK, NA)
# the constant term of identity i: p_i − c_{i−1} + 256·c_i with
# c_j = c'_j − 2^15
_CONSTS = [(OFFSET if i > 0 else 0) - (256 * OFFSET if i < NC else 0)
           for i in range(64)]


@functools.lru_cache(maxsize=None)
def _device_tables(device_str: str):
    """The gather indices and masks of `_AB_IDX` / `_KQ_IDX`, q's limbs and
    the identities' constants as tensors on one device."""
    def idx(t):
        U, V, M = t
        return (torch.from_numpy(U.astype(np.int64)).to(device_str),
                torch.from_numpy(V.astype(np.int64)).to(device_str),
                torch.from_numpy(M).to(device_str)[:, :, None])

    q = torch.tensor(Q_LIMBS, dtype=torch.int64, device=device_str)
    consts = torch.tensor([gl.to_i64(c % gl.P) for c in _CONSTS],
                          dtype=torch.int64, device=device_str)
    return idx(_AB_IDX), idx(_KQ_IDX), q, consts


def _to_limbs(x: int, count: int) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(count)]


def mul_witness(a: int, b: int):
    """(d, k, carry-bytes) for one modular multiplication."""
    d = (a * b) % Q
    k = (a * b - d) // Q
    al, bl = _to_limbs(a, NA), _to_limbs(b, NA)
    dl, kl = _to_limbs(d, NA), _to_limbs(k, NK)
    p = np.zeros(64, dtype=np.int64)
    p[: 2 * NA - 1] += np.convolve(np.array(al), np.array(bl))
    p[: NK + NA - 1] -= np.convolve(np.array(kl), np.array(Q_LIMBS))
    p[:NA] -= np.array(dl)
    # synthetic division by (x − 256), ascending:  p_i = c_{i−1} − 256·c_i
    c = np.zeros(NC, dtype=np.int64)
    prev = 0
    for i in range(NC):
        num = prev - p[i]
        assert num % 256 == 0
        c[i] = num // 256
        prev = c[i]
    assert c[NC - 1] == p[63], "top carry mismatch"
    assert np.all(np.abs(c) < OFFSET), "carry out of range"
    cp = c + OFFSET
    e = np.zeros(2 * NC, dtype=np.uint64)
    e[0::2] = cp & 0xFF
    e[1::2] = cp >> 8
    return dl, kl, e


class FpMulAir(Air):
    """Batched GF(2^255−19) multiplication proofs, one per row.

    With `chain=True` the rows form an iterated-squaring chain
    a_{r+1} = b_{r+1} = d_r (enforced by degree-2 selector constraints
    against a preprocessed chain column), and the final product is pinned
    as a public input: the proof states d_final = x^(2^(n-1)) mod q —
    the mechanism ed25519 decompression exponentiation and the
    double-and-add point ladder chain through."""

    def __init__(self, log_n: int, muls: list[tuple[int, int]],
                 chain: bool = False):
        assert log_n >= 9, "byte table needs 2^8 <= n/2"
        assert len(muls) <= (1 << log_n) - 1
        super().__init__(width=WIDTH, log_n=log_n, constraint_degree=4)
        self.chain = chain
        if chain:
            assert len(muls) == 1, "chain derives all rows from muls[0]"
            x = muls[0][0]
            muls = [(x, x)]
            for _ in range((1 << log_n) - 2):
                d = (muls[-1][0] * muls[-1][1]) % Q
                muls.append((d, d))
        self.muls = list(muls)
        a0, b0 = (muls[0] if muls else (0, 0))
        self.pub_a, self.pub_b = a0, b0
        self.pub_d = (a0 * b0) % Q
        af, bf = (muls[-1] if muls else (0, 0))
        self.pub_final = (af * bf) % Q

    # ---- framework hooks --------------------------------------------------

    def public_inputs(self):
        pub = (_to_limbs(self.pub_a, NA) + _to_limbs(self.pub_b, NA)
               + _to_limbs(self.pub_d, NA))
        if self.chain:
            pub += _to_limbs(self.pub_final, NA)
        return pub

    def lookups(self):
        return [Lookup(inputs=(2 * i, 2 * i + 1), table=0,
                       multiplicity=COL_M + i) for i in range(128)]

    def constant_columns(self):
        t = np.minimum(np.arange(self.n, dtype=np.uint64), np.uint64(255))
        if not self.chain:
            return t[None, :]
        s = np.zeros(self.n, dtype=np.uint64)
        s[: self.n - 2] = 1      # link rows r -> r+1 for r <= n-3
        return np.stack([t, s])

    def boundaries(self, public):
        out = []
        for j in range(NA):
            out.append((0, COL_A + j, public[j]))
            out.append((0, COL_B + j, public[NA + j]))
            out.append((0, COL_D + j, public[2 * NA + j]))
        if self.chain:
            for j in range(NA):
                out.append((self.n - 2, COL_D + j, public[3 * NA + j]))
        return out

    # ---- constraints ------------------------------------------------------

    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        a = [local[COL_A + j] for j in range(NA)]
        b = [local[COL_B + j] for j in range(NA)]
        d = [local[COL_D + j] for j in range(NA)]
        k = [local[COL_K + j] for j in range(NK)]
        cp = [alg.add(local[COL_E + 2 * i],
                      alg.mul(alg.constant(256), local[COL_E + 2 * i + 1]))
              for i in range(NC)]
        out = []
        for i in range(64):
            acc = alg.constant(0)
            for u in range(max(0, i - NA + 1), min(NA - 1, i) + 1):
                acc = alg.add(acc, alg.mul(a[u], b[i - u]))
            for u in range(max(0, i - NA + 1), min(NK - 1, i) + 1):
                acc = alg.sub(acc, alg.mul(k[u],
                                           alg.constant(Q_LIMBS[i - u])))
            if i < NA:
                acc = alg.sub(acc, d[i])
            # p_i − c_{i−1} + 256·c_i, with c_j = c'_j − 2^15
            if i > 0:
                acc = alg.sub(acc, cp[i - 1])
            if i < NC:
                acc = alg.add(acc, alg.mul(alg.constant(256), cp[i]))
            out.append(alg.add(acc, alg.constant(_CONSTS[i])))
        if self.chain:
            s = consts[1]
            for j in range(NA):
                out.append(alg.mul(s, alg.sub(nxt[COL_A + j], d[j])))
                out.append(alg.mul(s, alg.sub(nxt[COL_B + j], d[j])))
        return out

    def _transition_device(self, local, nxt, consts):
        """Stacked torch evaluation of the same constraints in the same
        order: the a·b convolution is ONE broadcast limb product
        (32, 32, N) and k·q one (33, 32, N); each coefficient identity
        gathers its anti-diagonal (masked slots gather a zero) and sums it
        in one field reduction."""
        add, sub, mul = gl.add, gl.sub, gl.mul
        ab_idx, kq_idx, q, consts_i = _device_tables(str(local[0].device))

        def stack(cols, base, count):
            return torch.stack(cols[base:base + count])

        def diag_sum(prod, idx):
            U, V, M = idx
            return gl.field_sum(torch.where(M, prod[U, V], 0), 1)

        a, b = stack(local, COL_A, NA), stack(local, COL_B, NA)
        d, k = stack(local, COL_D, NA), stack(local, COL_K, NK)
        e = stack(local, COL_E, 2 * NC)
        cp = add(e[0::2], mul(e[1::2], 256))          # c' for the 63 carries
        p = sub(diag_sum(mul(a[:, None], b[None, :]), ab_idx),
                diag_sum(mul(k[:, None], q[None, :, None]), kq_idx))
        zrow = torch.zeros_like(cp[:1])
        p = sub(p, torch.cat([d, torch.zeros_like(d)]))
        p = sub(p, torch.cat([zrow, cp]))
        p = add(p, torch.cat([mul(cp, 256), zrow]))
        out = list(add(p, consts_i[:, None]).unbind(0))
        if self.chain:
            s = consts[1][None]
            da = mul(sub(stack(nxt, COL_A, NA), d), s)
            db = mul(sub(stack(nxt, COL_B, NA), d), s)
            for j in range(NA):
                out.append(da[j])
                out.append(db[j])
        return out

    # ---- witness ----------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        n = self.n
        tr = np.zeros((WIDTH, n), dtype=np.uint64)
        # padding rows prove 0·0 = 0 (carries all at the offset value)
        pad_d, pad_k, pad_e = mul_witness(0, 0)
        for r in range(n - 1):
            a, b = self.muls[r] if r < len(self.muls) else (0, 0)
            if r < len(self.muls):
                dlb, klb, e = mul_witness(a, b)
            else:
                dlb, klb, e = pad_d, pad_k, pad_e
            tr[COL_A:COL_A + NA, r] = _to_limbs(a, NA)
            tr[COL_B:COL_B + NA, r] = _to_limbs(b, NA)
            tr[COL_D:COL_D + NA, r] = dlb
            tr[COL_K:COL_K + NK, r] = klb
            tr[COL_E:COL_E + 2 * NC, r] = e
        # multiplicities: count every byte cell of rows 0..n-2 per pair
        for i in range(128):
            pair = tr[2 * i:2 * i + 2, : n - 1]
            counts = np.bincount(pair.reshape(-1).astype(np.int64),
                                 minlength=256)
            tr[COL_M + i, :256] = counts[:256]
        return tr

    def outputs(self) -> list[int]:
        """Semi-reduced products for every row, for chaining checks."""
        return [(a * b) % Q for (a, b) in self.muls]
