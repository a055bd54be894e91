"""The ed25519 EdDSA ladder AIR: proves [S]B = R + [h]A for a batch of
signatures, each (A_cmp, R_cmp, S, h), in 4·nbits + 4 trace rows.

Layout, witness, constant columns, byte-table lookups and constraints as
the program's `stark/ed25519_ladder_air.py` stated them when this copy was
frozen.  `transition` evaluates the constraints on tensors over a block of
points, as the prover's composition does (no scalar algebra: nothing here
verifies).

A routed multiplication machine: every row carries 8 GF(2^255−19)
multiplication payloads (a limb convolution over bytes with 3-byte
carries), whose operands are selector-routed linear combinations of the
row's registers.  Row types: dbl (extended-Edwards doubling), cadd
(unified addition of the base, kept where the scalar bit is 1), dec (point
decompression, with the sign bit and x ≤ q−1 bound), uadd (saves R + [h]A
and restarts the accumulator) and eq (projective equality with the saved
point).  Per signature: dec(A), 2·nbits ladder rows for [h]A, dec(R),
uadd, 2·nbits ladder rows for [S]B, eq.  The statement (compressed
points and scalar bytes) lives in constant columns; every payload byte is
range-checked against the byte table by a LogUp lookup.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ed25519 as ed
from . import goldilocks as gl
from .air import Air
from .lookup import Lookup

Q = ed.Q
NA, NK, NC = 32, 33, 63
CB = 3                       # carry bytes (operand combos reach |c| < 2^18)
COFF = 1 << 20               # carry offset: c' = c + COFF ∈ [0, 2^24)
PAYW = NA + NK + CB * NC     # 254 columns per payload
Q_LIMBS = [(Q >> (8 * i)) & 0xFF for i in range(NA)]
QM1_LIMBS = [((Q - 1) >> (8 * i)) & 0xFF for i in range(NA)]

# ---------------------------------------------------------------------------
# column layout
# ---------------------------------------------------------------------------

COL_X1, COL_Y1, COL_Z1, COL_T1 = 0, 32, 64, 96
COL_SX, COL_SY, COL_SZ = 128, 160, 192
COL_X2B, COL_Y2B, COL_KT2B = 224, 256, 288
COL_ACC = 320
COL_XB = 352                 # canonicality witness: q−1−x bytes
COL_XC = 384                 # canonicality carry bits
COL_BR, COL_SGN, COL_XH, COL_PAD0 = 416, 417, 418, 419
COL_P = 420                  # payload j at COL_P + PAYW*j: d | k | e
N_PAY = 8
_PAY_END = COL_P + PAYW * N_PAY      # 2452

# sign-bit binding columns: COL_Y2D holds 2·y2b[31]; byte-checking it
# forces y2b[31] < 128, so y2b[31] = cmp31 − 128·sgn pins sgn to the
# statement's compressed sign bit.
COL_Y2D, COL_PAD1 = _PAY_END, _PAY_END + 1

# byte-checked column pairs (for the LogUp argument)
_CHECK_PAIRS = (
    [(COL_P + 2 * i, COL_P + 2 * i + 1) for i in range(PAYW * N_PAY // 2)]
    + [(COL_X2B + 2 * i, COL_X2B + 2 * i + 1) for i in range(16)]
    + [(COL_Y2B + 2 * i, COL_Y2B + 2 * i + 1) for i in range(16)]
    + [(COL_XB + 2 * i, COL_XB + 2 * i + 1) for i in range(16)]
    + [(COL_XH, COL_PAD0), (COL_Y2D, COL_PAD1)])
COL_M = _PAY_END + 2
WIDTH = COL_M + len(_CHECK_PAIRS)

# preprocessed columns
_CONST_NAMES = (["table", "sel_dbl", "sel_cadd", "sel_uadd", "sel_decA",
                 "sel_decR", "sel_eq", "sel_gbase", "sel_bcopy"]
                + [f"cmp{i}" for i in range(32)]
                + [f"scl{i}" for i in range(32)]
                + [f"pbit{i}" for i in range(32)])
_CONST = {n: i for i, n in enumerate(_CONST_NAMES)}
N_CONST = len(_CONST)
_SEL_NAMES = ("sel_dbl", "sel_cadd", "sel_uadd", "sel_decA", "sel_decR",
              "sel_eq", "sel_gbase", "sel_bcopy")

# ---------------------------------------------------------------------------
# operand routing (compile-time data)
# ---------------------------------------------------------------------------

# witness limb-vector sources
S_X1, S_Y1, S_Z1, S_T1 = 0, 1, 2, 3
S_X2B, S_Y2B, S_KT2B = 4, 5, 6
S_SX, S_SY, S_SZ = 7, 8, 9
S_D = 10                      # S_D+j = payload j's output d
# constant limb-vector sources
K_2Q, K_ONE, K_D, K_2D, K_BX, K_BY, K_BKT = range(18, 25)
NSRC = 25

_SRC_COL = {S_X1: COL_X1, S_Y1: COL_Y1, S_Z1: COL_Z1, S_T1: COL_T1,
            S_X2B: COL_X2B, S_Y2B: COL_Y2B, S_KT2B: COL_KT2B,
            S_SX: COL_SX, S_SY: COL_SY, S_SZ: COL_SZ,
            **{S_D + j: COL_P + PAYW * j for j in range(N_PAY)}}


def _limbs(x: int, count: int = NA) -> list[int]:
    return [(x >> (8 * i)) & 0xFF for i in range(count)]


_BKT = (2 * ed.D * ed.BX * ed.BY) % Q
# the constant sources as integers (their limb vectors are these values'
# bytes, so a routed operand's value is Σ weight · source value)
_KINT = {K_2Q: 2 * Q, K_ONE: 1, K_D: ed.D, K_2D: (2 * ed.D) % Q,
         K_BX: ed.BX, K_BY: ed.BY, K_BKT: _BKT}
_KVEC = {k: _limbs(v) for k, v in _KINT.items()}

# per row-type payload programs: 8 payloads of (a_terms, b_terms), each a
# tuple of (source, weight)
_ROUTE = {
    # doubling: A=X1², B=Y1², C=2Z1², M=X1·Y1 (E=2M), D'=−A,
    # G=B−A, F=B−A−C, H=−A−B; X3=E·F, Y3=G·H, Z3=F·G, T3=E·H
    "dbl": [
        (((S_X1, 1),), ((S_X1, 1),)),
        (((S_Y1, 1),), ((S_Y1, 1),)),
        (((S_Z1, 1),), ((S_Z1, 2),)),
        (((S_X1, 1),), ((S_Y1, 1),)),
        (((S_D + 3, 2),),
         ((S_D + 1, 1), (S_D + 0, -1), (S_D + 2, -1), (K_2Q, 2))),
        (((S_D + 1, 1), (S_D + 0, -1), (K_2Q, 1)),
         ((S_D + 0, -1), (S_D + 1, -1), (K_2Q, 2))),
        (((S_D + 1, 1), (S_D + 0, -1), (S_D + 2, -1), (K_2Q, 2)),
         ((S_D + 1, 1), (S_D + 0, -1), (K_2Q, 1))),
        (((S_D + 3, 2),), ((S_D + 0, -1), (S_D + 1, -1), (K_2Q, 2))),
    ],
    # unified add with base (x2b, y2b, kt2b), Z2=1:
    # A=(Y1−X1)(y2−x2), B=(Y1+X1)(y2+x2), C=T1·kt2, D=2Z1,
    # E=B−A, F=D−C, G=D+C, H=B+A; X3=E·F, Y3=G·H, Z3=F·G, T3=E·H
    "cadd": [
        (((S_Y1, 1), (S_X1, -1), (K_2Q, 1)),
         ((S_Y2B, 1), (S_X2B, -1), (K_2Q, 1))),
        (((S_Y1, 1), (S_X1, 1)), ((S_Y2B, 1), (S_X2B, 1))),
        (((S_T1, 1),), ((S_KT2B, 1),)),
        (((S_Z1, 1),), ((K_ONE, 2),)),
        (((S_D + 1, 1), (S_D + 0, -1), (K_2Q, 1)),
         ((S_D + 3, 1), (S_D + 2, -1), (K_2Q, 1))),
        (((S_D + 3, 1), (S_D + 2, 1)), ((S_D + 1, 1), (S_D + 0, 1))),
        (((S_D + 3, 1), (S_D + 2, -1), (K_2Q, 1)),
         ((S_D + 3, 1), (S_D + 2, 1))),
        (((S_D + 1, 1), (S_D + 0, -1), (K_2Q, 1)),
         ((S_D + 1, 1), (S_D + 0, 1))),
    ],
    # decompression: yy=y², dyy=yy·d, xx=x², u=xx·(dyy+1),
    # eqzero(u−(yy−1)), t2=x·y, kt2=t2·2d, pad
    "dec": [
        (((S_Y2B, 1),), ((S_Y2B, 1),)),
        (((S_D + 0, 1),), ((K_D, 1),)),
        (((S_X2B, 1),), ((S_X2B, 1),)),
        (((S_D + 2, 1),), ((S_D + 1, 1), (K_ONE, 1))),
        (((S_D + 3, 1), (S_D + 0, -1), (K_ONE, 1), (K_2Q, 1)),
         ((K_ONE, 1),)),
        (((S_X2B, 1),), ((S_Y2B, 1),)),
        (((S_D + 5, 1),), ((K_2D, 1),)),
        ((), ()),
    ],
    # projective equality vs the saved registers
    "eq": [
        (((S_X1, 1),), ((S_SZ, 1),)),
        (((S_SX, 1),), ((S_Z1, 1),)),
        (((S_D + 0, 1), (S_D + 1, -1), (K_2Q, 1)), ((K_ONE, 1),)),
        (((S_Y1, 1),), ((S_SZ, 1),)),
        (((S_SY, 1),), ((S_Z1, 1),)),
        (((S_D + 3, 1), (S_D + 4, -1), (K_2Q, 1)), ((K_ONE, 1),)),
        ((), ()),
        ((), ()),
    ],
}
# payload program selector per row type (uadd shares cadd's program,
# decA/decR share dec's)
_PROG_SELS = {"dbl": ("sel_dbl",), "cadd": ("sel_cadd", "sel_uadd"),
              "dec": ("sel_decA", "sel_decR"), "eq": ("sel_eq",)}

_IDENTITY = (0, 1, 1, 0)
_GBASE = (ed.BX, ed.BY, _BKT)


# ---------------------------------------------------------------------------
# witness helpers
# ---------------------------------------------------------------------------

def _routed_limbs(terms, regs) -> np.ndarray:
    """Integer limb vectors of a routed operand: Σ weight · source limbs.
    `regs` maps each witness source to its limbs, (32,) at one row or
    (rows, 32) for a batch of rows (int64)."""
    out = np.zeros(NA, dtype=np.int64)
    for src, w in terms:
        out = out + w * (np.array(_KVEC[src], dtype=np.int64)
                         if src in _KVEC else regs[src])
    return out


def _payload_witness(a_limbs, b_limbs):
    """(d_limbs, k_limbs, e_bytes) for one routed multiplication: the
    scalar form of `_payload_carries` (one row, one payload)."""
    a = np.array([a_limbs], dtype=np.int64)
    b = np.array([b_limbs], dtype=np.int64)
    a_val = sum(int(v) << (8 * u) for u, v in enumerate(a_limbs))
    b_val = sum(int(v) << (8 * u) for u, v in enumerate(b_limbs))
    d, k = _divmod_q(a_val * b_val)
    dl = np.array([_limbs(d)], dtype=np.int64)
    kl = np.array([_limbs(k, NK)], dtype=np.int64)
    e = _payload_carries(a, b, dl, kl)
    return dl[0].tolist(), kl[0].tolist(), e[0].tolist()


def _divmod_q(prod: int) -> tuple[int, int]:
    d = prod % Q
    k = (prod - d) // Q
    assert 0 <= k < (1 << (8 * NK)), "k out of range"
    return d, k


_QV = np.array(Q_LIMBS, dtype=np.int64)


def _payload_carries(a, b, dl, kl) -> np.ndarray:
    """(R, CB·NC) carry bytes e of R multiplications at once: the limb
    identity Σ a_u·b_{i−u} − Σ k_u·q_{i−u} − d_i − c_{i−1} + 256·c_i = 0
    solved for the carries c (offset by COFF, 3 bytes each).  a, b: (R, 32)
    routed limbs (any sign), dl (R, 32) and kl (R, 33) bytes; every partial
    sum is below 2^40 in magnitude."""
    R = a.shape[0]
    p = np.zeros((R, 64), dtype=np.int64)
    for u in range(NA):
        p[:, u:u + NA] += a[:, u:u + 1] * b
    for u in range(NK):
        p[:, u:u + NA] -= kl[:, u:u + 1] * _QV
    p[:, :NA] -= dl
    c = np.zeros((R, NC), dtype=np.int64)
    prev = np.zeros(R, dtype=np.int64)
    for i in range(NC):
        num = prev - p[:, i]
        assert not np.any(num % 256), "carry division"
        prev = num // 256
        c[:, i] = prev
    assert np.array_equal(c[:, NC - 1], p[:, 63]), "top carry"
    cp = c + COFF
    assert np.all((cp >= 0) & (cp < (1 << (8 * CB)))), "carry out of range"
    return ((cp[:, :, None] >> (8 * np.arange(CB))) & 0xFF).reshape(R, -1)


_PAD_PAYLOAD = None


def _pad_payload():
    global _PAD_PAYLOAD
    if _PAD_PAYLOAD is None:
        _PAD_PAYLOAD = _payload_witness([0] * NA, [0] * NA)
    return _PAD_PAYLOAD


def _as_sigs(sigs):
    out = []
    for s in sigs:
        a_cmp, r_cmp, s_scalar, h_scalar = s
        out.append((bytes(a_cmp), bytes(r_cmp), int(s_scalar),
                    int(h_scalar)))
    return out


def _bytes_rows(vals, count: int) -> np.ndarray:
    """Python ints (rows x k) -> (rows, k, count) int64 little-endian bytes."""
    rows = len(vals)
    k = len(vals[0]) if rows else 0
    blob = b"".join(v.to_bytes(count, "little") for row in vals for v in row)
    return np.frombuffer(blob, dtype=np.uint8).reshape(rows, k, count) \
        .astype(np.int64)


class Ed25519LadderAir(Air):
    """Batch EdDSA-equation proofs: one (A_cmp, R_cmp, S, h) tuple per
    signature, statement-bound via preprocessed columns."""

    def __init__(self, sigs, nbits: int = 253, log_n: int | None = None):
        self.sigs = _as_sigs(sigs)
        self.nbits = nbits
        self._shape(log_n)
        super().__init__(width=WIDTH, log_n=self._log_n,
                         constraint_degree=4)
        self._witness = True

    def _shape(self, log_n):
        assert self.sigs
        for (_a, _r, s, h) in self.sigs:
            assert 0 <= s < (1 << self.nbits)
            assert 0 <= h < (1 << self.nbits)
        self.rows_per_sig = 4 * self.nbits + 4
        self.total_rows = self.rows_per_sig * len(self.sigs)
        # byte table needs n ≥ 257; +1 keeps the last sig's eq row off the
        # masked final transition row
        need = max(9, (self.total_rows + 1).bit_length())
        self._log_n = log_n if log_n is not None else need
        assert (1 << self._log_n) >= self.total_rows + 1

    @classmethod
    def statement(cls, sigs, nbits: int = 253,
                  log_n: int | None = None) -> "Ed25519LadderAir":
        """Verifier-side construction — no witness computation."""
        self = object.__new__(cls)
        self.sigs = _as_sigs(sigs)
        self.nbits = nbits
        self._shape(log_n)
        Air.__init__(self, width=WIDTH, log_n=self._log_n,
                     constraint_degree=4)
        self._witness = False
        return self

    # -- row schedule -------------------------------------------------------

    def _row_types(self):
        """Per signature-block offset: (type, extra) where type in
        {decA, dbl, cadd, decR, uadd, dbl1, cadd1, eq}."""
        nb = self.nbits
        sched = [("decA", None)]
        for j in range(nb):
            sched.append(("dbl", None))
            sched.append(("cadd", nb - 1 - j))      # bit index
        sched.append(("decR", None))
        sched.append(("uadd", None))
        for j in range(nb):
            sched.append(("dbl1", None))
            sched.append(("cadd1", nb - 1 - j))
        sched.append(("eq", None))
        assert len(sched) == self.rows_per_sig
        return sched

    # -- framework hooks ----------------------------------------------------

    def public_inputs(self):
        return [len(self.sigs), self.nbits]

    def lookups(self):
        return [Lookup(inputs=pair, table=0, multiplicity=COL_M + i)
                for i, pair in enumerate(_CHECK_PAIRS)]

    def constant_columns(self):
        cols = np.zeros((N_CONST, self.n), dtype=np.uint64)
        c = _CONST
        cols[c["table"]] = np.minimum(np.arange(self.n, dtype=np.uint64),
                                      np.uint64(255))
        sched = self._row_types()
        nb = self.nbits
        rps = self.rows_per_sig
        # per-signature row offsets of each type
        dec_a, dec_r, uadd, eq = 0, 2 * nb + 1, 2 * nb + 2, rps - 1
        dbl = np.arange(1, 2 * nb + 1, 2)
        cadd = dbl + 1
        dbl1 = np.arange(2 * nb + 3, 4 * nb + 3, 2)
        cadd1 = dbl1 + 1
        bits = np.array([b for (ty, b) in sched if ty == "cadd"])
        for si, (a_cmp, r_cmp, s_scalar, h_scalar) in enumerate(self.sigs):
            base = si * rps
            cols[c["sel_decA"], base + dec_a] = 1
            cols[c["sel_dbl"], base + dbl] = 1
            cols[c["sel_cadd"], base + cadd] = 1
            cols[c["sel_decR"], base + dec_r] = 1
            cols[c["sel_uadd"], base + uadd] = 1
            cols[c["sel_dbl"], base + dbl1] = 1
            cols[c["sel_gbase"], base + dbl1] = 1
            cols[c["sel_cadd"], base + cadd1] = 1
            cols[c["sel_gbase"], base + cadd1] = 1
            cols[c["sel_eq"], base + eq] = 1
            # base copy: decA, every dbl, every cadd but the one into
            # decR (bit 0), decR
            cols[c["sel_bcopy"], base + dec_a] = 1
            cols[c["sel_bcopy"], base + dbl] = 1
            cols[c["sel_bcopy"], base + cadd[bits != 0]] = 1
            cols[c["sel_bcopy"], base + dec_r] = 1
            for rows in (cadd, cadd1):
                cols[c["pbit0"] + bits // 8, base + rows] = \
                    np.uint64(1) << (bits % 8).astype(np.uint64)
            cmp0, scl0 = c["cmp0"], c["scl0"]
            cols[cmp0:cmp0 + 32, base + dec_a] = np.frombuffer(a_cmp,
                                                               np.uint8)
            cols[cmp0:cmp0 + 32, base + dec_r] = np.frombuffer(r_cmp,
                                                               np.uint8)
            cols[scl0:scl0 + 32, base + dec_r] = _limbs(h_scalar)
            cols[scl0:scl0 + 32, base + eq] = _limbs(s_scalar)
        return cols

    def boundaries(self, public):
        return []

    # -- witness ------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        assert self._witness, "statement-only AIR has no witness"
        tr = np.zeros((WIDTH, self.n), dtype=np.uint64)
        # padding payloads on every row first (overwritten below)
        _pd, _pk, pe = _pad_payload()
        pe_col = np.array(pe, dtype=np.uint64)[:, None]
        for j in range(N_PAY):
            pc = COL_P + PAYW * j
            tr[pc + NA + NK:pc + PAYW, : self.n - 1] = pe_col
        rows = {prog: [] for prog in _ROUTE}   # program -> row records
        for si in range(len(self.sigs)):
            self._run_sig(tr, si, rows)
        for prog, recs in rows.items():
            if recs:
                self._emit_payloads(tr, prog, recs)
        # multiplicities over rows 0..n-2 for every checked pair
        pairs = np.array(_CHECK_PAIRS)
        vals = tr[pairs, : self.n - 1].astype(np.int64)   # (P, 2, n-1)
        assert vals.max() < 256, "a byte-checked cell is not a byte"
        offs = 256 * np.arange(len(pairs), dtype=np.int64)[:, None, None]
        counts = np.bincount((vals + offs).reshape(-1),
                             minlength=256 * len(pairs))
        tr[COL_M:COL_M + len(pairs), :256] = counts.reshape(len(pairs), 256)
        return tr

    def _run_sig(self, tr, si, rows):
        """The ladder of signature `si` in Python ints: writes the per-row
        register limbs, accumulator, scalar bit and decompression extras,
        and records every row's (row, register values, payload outputs d,
        quotients k) under its payload program."""
        a_cmp, r_cmp, s_scalar, h_scalar = self.sigs[si]
        A = ed.point_decompress(a_cmp)
        R = ed.point_decompress(r_cmp)
        assert A is not None and R is not None, "invalid compressed point"
        base = si * self.rows_per_sig
        sched = self._row_types()
        state = list(_IDENTITY)
        saved = (0, 0, 0)
        acc_limbs = [0] * NA
        cur_base = None          # (x2, y2, kt2)
        reg_rows, acc_rows, reg_vals = [], [], []

        def run_row(r, prog, bpoint):
            regs = [*state, *bpoint, *saved]
            vals = {i: v for i, v in enumerate(regs)}
            ds, ks = [], []
            for j, (a_t, b_t) in enumerate(_ROUTE[prog]):
                a = sum(w * (_KINT[s] if s in _KINT else vals[s])
                        for s, w in a_t)
                b = sum(w * (_KINT[s] if s in _KINT else vals[s])
                        for s, w in b_t)
                d, k = _divmod_q(a * b)
                vals[S_D + j] = d
                ds.append(d)
                ks.append(k)
            rows[prog].append((r, regs, ds, ks))
            reg_rows.append(r)
            reg_vals.append(regs)
            acc_rows.append(list(acc_limbs))
            return ds

        def dec_row(r, point, cmp_bytes):
            x, y = point[0], point[1]
            kt2 = (2 * ed.D * x * y) % Q
            run_row(r, "dec", (x, y, kt2))
            sgn = cmp_bytes[31] >> 7
            xl = _limbs(x)
            tr[COL_SGN, r] = sgn
            tr[COL_XH, r] = (xl[0] - sgn) // 2
            tr[COL_Y2D, r] = 2 * _limbs(y)[31]
            # canonicality: x + b = q−1 with byte carries
            b_val = (Q - 1) - x
            assert b_val >= 0
            bl = _limbs(b_val)
            carry = 0
            for u in range(NA):
                tot = xl[u] + bl[u] + carry
                nc = (tot - QM1_LIMBS[u]) // 256
                assert tot == QM1_LIMBS[u] + 256 * nc and nc in (0, 1)
                tr[COL_XB + u, r] = bl[u]
                tr[COL_XC + u, r] = nc
                carry = nc
            assert carry == 0
            return (x, y, kt2)

        for off, (ty, bit_idx) in enumerate(sched):
            r = base + off
            if ty == "decA":
                # dec rows carry zero state/saved/acc (the previous eq row
                # and the decA transition force this shape)
                state = [0, 0, 0, 0]
                saved = (0, 0, 0)
                acc_limbs = [0] * NA
                cur_base = dec_row(r, A, a_cmp)
                state = list(_IDENTITY)   # forced by the decA transition
            elif ty == "decR":
                cur_base = dec_row(r, R, r_cmp)
                # state (acc2) passes through unchanged
            elif ty in ("dbl", "dbl1"):
                d = run_row(r, "dbl", cur_base if ty == "dbl" else _GBASE)
                state = d[4:8]
            elif ty in ("cadd", "cadd1"):
                scalar = h_scalar if ty == "cadd" else s_scalar
                bit = (scalar >> bit_idx) & 1
                tr[COL_BR, r] = bit
                d = run_row(r, "cadd", cur_base if ty == "cadd" else _GBASE)
                if bit:
                    state = d[4:8]
                acc_limbs = list(acc_limbs)
                acc_limbs[bit_idx // 8] += bit << (bit_idx % 8)
            elif ty == "uadd":
                tr[COL_BR, r] = 1
                d = run_row(r, "cadd", cur_base)
                saved = (d[4], d[5], d[6])
                state = list(_IDENTITY)
                acc_limbs = [0] * NA
            elif ty == "eq":
                # fail fast on a false statement: the eq payloads could
                # not satisfy their pinned-zero outputs anyway
                assert (state[0] * saved[2] - saved[0] * state[2]) % Q == 0 \
                    and (state[1] * saved[2] - saved[1] * state[2]) % Q == 0, \
                    "[S]B != R + [h]A — refusing to build a false witness"
                run_row(r, "eq", (0, 0, 0))
        # register limbs and the accumulator of every row of the signature
        idx = np.array(reg_rows)
        regs = _bytes_rows(reg_vals, NA)                # (rows, 10, 32)
        for s in range(S_D):
            col = _SRC_COL[s]
            tr[col:col + NA, idx] = regs[:, s].T
        tr[COL_ACC:COL_ACC + NA, idx] = np.array(acc_rows, dtype=np.uint64).T

    def _emit_payloads(self, tr, prog, recs):
        """The 8 payloads' d, k and carry bytes of every row that runs
        program `prog`, as (rows, ...) numpy batches."""
        idx = np.array([r for (r, _regs, _d, _k) in recs])
        src = _bytes_rows([regs + ds for (_r, regs, ds, _k) in recs], NA)
        kl = _bytes_rows([ks for (_r, _regs, _d, ks) in recs], NK)
        regs = {s: src[:, s] for s in range(S_D + N_PAY)}
        for j, (a_t, b_t) in enumerate(_ROUTE[prog]):
            pc = COL_P + PAYW * j
            if not a_t and not b_t:
                continue          # the padding payload, written first
            dl = src[:, S_D + j]
            e = _payload_carries(_routed_limbs(a_t, regs),
                                 _routed_limbs(b_t, regs), dl, kl[:, j])
            tr[pc:pc + NA, idx] = dl.T
            tr[pc + NA:pc + NA + NK, idx] = kl[:, j].T
            tr[pc + NA + NK:pc + PAYW, idx] = e.T

    # -- constraints --------------------------------------------------------

    def transition(self, alg, local, nxt, public, consts=None):
        """The constraint values over a block of B points (`local`, `nxt`,
        `consts`: lists of (B,) int64 tensors), stacked: (j, limb, B)
        operand batches and one limb convolution per payload, all exact
        field multiply-adds.  Emission order: the 64 convolution
        coefficients of each payload, the state, saved and base registers,
        the scalar accumulator and its end checks, the dec-row extras, the
        cadd bit's booleanity, the eq row's forced zeros.

        Memory: the prover evaluates this over blocks of B points
        (`prover.composition_block`: 2^27 elements over the 5757 rows of
        trace, aux and constants gives B = 2^14).  At B = 2^14 the sources
        are (18, 32, B) int64, 72 MiB; each routed operand batch (8, 32, B),
        32 MiB; per payload the limb products (32, 32, B), 128 MiB, and
        their anti-diagonal gather (64, 32, B), 256 MiB, plus the
        field-sum halves of the same size — under 1.5 GiB of temporaries
        at a time, since the payloads are taken one after another."""
        add, sub, mul = gl.add, gl.sub, gl.mul
        dev = local[0].device
        sels = {nm: consts[_CONST[nm]] for nm in _SEL_NAMES}

        def stack(cols, base, count):
            return torch.stack(cols[base:base + count])

        def const_col(vals):
            return torch.tensor([gl.to_i64(v % gl.P) for v in vals],
                                dtype=torch.int64, device=dev)[:, None]

        def gate(rows, sel):
            return mul(rows, sel[None])

        def emit(rows):
            out.extend(rows.unbind(0))

        out = []
        srcs = torch.stack([stack(local, _SRC_COL[s], NA)
                            for s in range(S_D + N_PAY)])   # (18, 32, B)

        # routed operands: (8, 32, B) accumulated over programs
        def operand(side):
            acc = None
            for prog_name, sel_names in _PROG_SELS.items():
                sel = sels[sel_names[0]]
                for extra in sel_names[1:]:
                    sel = add(sel, sels[extra])
                prog = _ROUTE[prog_name]
                rows = []
                cmat = np.zeros((N_PAY, NA), dtype=object)
                for j in range(N_PAY):
                    row = None
                    for src, w in prog[j][side]:
                        if src in _KVEC:
                            cmat[j] += w * np.array(_KVEC[src], dtype=object)
                        else:
                            t = mul(srcs[src], w) if w != 1 else srcs[src]
                            row = t if row is None else add(row, t)
                    rows.append(torch.zeros_like(srcs[0]) if row is None
                                else row)
                cont = torch.stack(rows)
                if np.any(cmat != 0):
                    cont = add(cont, torch.tensor(
                        [[gl.to_i64(int(v) % gl.P) for v in r] for r in cmat],
                        dtype=torch.int64, device=dev)[:, :, None])
                gated = mul(cont, sel[None, None])
                acc = gated if acc is None else add(acc, gated)
            return acc

        a_ops = operand(0)
        b_ops = operand(1)

        # payload stacks: d (8, 32, B), k (8, 33, B), carries c' (8, 63, B)
        pay = torch.stack([stack(local, COL_P + PAYW * j, PAYW)
                           for j in range(N_PAY)])
        dstk = pay[:, :NA]
        kstk = pay[:, NA:NA + NK]
        estk = pay[:, NA + NK:]
        cp = add(add(estk[:, 0::3], mul(estk[:, 1::3], 256)),
                 mul(estk[:, 2::3], 65536))

        # anti-diagonal index of the 32x32 limb products: conv[i] sums
        # ab[u, i-u]; masked slots gather a zero
        U = np.zeros((64, NA), dtype=np.int64)
        V = np.zeros((64, NA), dtype=np.int64)
        M = np.zeros((64, NA), dtype=bool)
        for i in range(64):
            for t, u in enumerate(range(max(0, i - NA + 1),
                                        min(NA - 1, i) + 1)):
                U[i, t], V[i, t], M[i, t] = u, i - u, True
        Ut, Vt = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
        Mt = torch.from_numpy(M).to(dev)[:, :, None]
        # k·q: conv_k[i] = Σ_u k[u]·q[i-u] as a (64, 33) constant matrix
        qmat = np.zeros((64, NK), dtype=np.int64)
        for i in range(64):
            for u in range(max(0, i - NA + 1), min(NK - 1, i) + 1):
                qmat[i, u] = Q_LIMBS[i - u]
        qmat = torch.from_numpy(qmat).to(dev)[:, :, None]
        consts_i = const_col([(COFF if i > 0 else 0)
                              - (256 * COFF if i < NC else 0)
                              for i in range(64)])
        zrow = torch.zeros_like(dstk[0, :1])
        for j in range(N_PAY):
            ab = mul(a_ops[j][:, None], b_ops[j][None, :])   # (32, 32, B)
            conv = gl.field_sum(torch.where(Mt, ab[Ut, Vt], 0), 1)
            del ab
            convk = gl.field_sum(mul(kstk[j][None], qmat), 1)
            p = sub(conv, convk)
            p = sub(p, torch.cat([dstk[j], torch.zeros_like(dstk[j])]))
            p = sub(p, torch.cat([zrow, cp[j]]))
            p = add(p, torch.cat([mul(cp[j], 256), zrow]))
            emit(add(p, consts_i))

        br = local[COL_BR]

        # 2. state transition
        su = add(sels["sel_uadd"], sels["sel_decA"])
        for t_i, (col, idv) in enumerate(
                zip((COL_X1, COL_Y1, COL_Z1, COL_T1), _IDENTITY)):
            dj = dstk[4 + t_i]
            cur = stack(local, col, NA)
            sel_out = gate(dj, sels["sel_dbl"])
            cd = add(cur, mul(sub(dj, cur), br[None]))
            sel_out = add(sel_out, gate(cd, sels["sel_cadd"]))
            if idv:
                sel_out = add(sel_out, mul(const_col(_limbs(idv)), su[None]))
            sel_out = add(sel_out, gate(cur, sels["sel_decR"]))
            emit(sub(stack(nxt, col, NA), sel_out))

        # 3. saved registers
        copy_sel = add(add(sels["sel_decA"], sels["sel_dbl"]),
                       add(sels["sel_cadd"], sels["sel_decR"]))
        for t_i, col in enumerate((COL_SX, COL_SY, COL_SZ)):
            v = add(gate(stack(local, col, NA), copy_sel),
                    gate(dstk[4 + t_i], sels["sel_uadd"]))
            emit(sub(stack(nxt, col, NA), v))

        # 4. base registers
        for col in (COL_X2B, COL_Y2B, COL_KT2B):
            emit(gate(sub(stack(nxt, col, NA), stack(local, col, NA)),
                      sels["sel_bcopy"]))
        for col, kv in ((COL_X2B, K_BX), (COL_Y2B, K_BY),
                        (COL_KT2B, K_BKT)):
            emit(gate(sub(stack(local, col, NA), const_col(_KVEC[kv])),
                      sels["sel_gbase"]))

        # 5. scalar-bit accumulator
        accv = stack(local, COL_ACC, NA)
        pbit = stack(consts, _CONST["pbit0"], NA)
        v = gate(accv, sels["sel_dbl"])
        v = add(v, gate(add(accv, mul(pbit, br[None])), sels["sel_cadd"]))
        v = add(v, gate(accv, sels["sel_decR"]))
        emit(sub(stack(nxt, COL_ACC, NA), v))

        # 6. scalar end checks
        end_sel = add(sels["sel_decR"], sels["sel_eq"])
        emit(gate(sub(accv, stack(consts, _CONST["scl0"], NA)), end_sel))

        # 7. dec-row extras
        sel_dec = add(sels["sel_decA"], sels["sel_decR"])
        emit(gate(dstk[4], sel_dec))
        emit(gate(sub(stack(local, COL_KT2B, NA), dstk[6]), sel_dec))
        sgn = local[COL_SGN]
        y2b = stack(local, COL_Y2B, NA)
        e = sub(y2b, stack(consts, _CONST["cmp0"], NA))
        e = torch.cat([e[:31], add(e[31], mul(sgn, 128))[None]])
        emit(gate(e, sel_dec))
        out.append(mul(sel_dec, sub(local[COL_X2B],
                                    add(mul(local[COL_XH], 2), sgn))))
        out.append(mul(sel_dec, mul(sgn, sub(sgn, 1))))
        out.append(mul(sel_dec, sub(local[COL_Y2D], mul(y2b[31], 2))))
        # canonicality chain
        xc = stack(local, COL_XC, NA)
        cin = torch.cat([torch.zeros_like(xc[:1]), xc[:-1]])
        lhs = add(add(stack(local, COL_X2B, NA), stack(local, COL_XB, NA)),
                  cin)
        rhs = add(const_col(QM1_LIMBS), mul(xc, 256))
        emit(gate(sub(lhs, rhs), sel_dec))
        out.append(mul(sel_dec, xc[NA - 1]))
        emit(gate(mul(xc, sub(xc, 1)), sel_dec))

        # 8. cadd bit booleanity
        out.append(mul(sels["sel_cadd"], mul(br, sub(br, 1))))

        # 9. eq-row forced zeros
        emit(gate(dstk[2], sels["sel_eq"]))
        emit(gate(dstk[5], sels["sel_eq"]))
        return out
