"""SHA-512 AIR: proves digest_i = SHA512(message_i) for a BATCH of
independent multi-block messages in one trace.

Port of `vectorx_tpu.stark.sha512_air`.  The EdDSA gadget hashes the
53-byte signed precommit with SHA-512 to derive the challenge scalar
h = SHA512(R ‖ A ‖ M) mod L (curta EdDSA, upstream
circuits/builder/justification.rs:237-243); this AIR is the hash half of
that statement.  Wiring: the digest is public, so the verifier reduces it
mod L host-side and feeds the scalar to `ed25519_ladder_air`.

Arithmetization — one round per row, 81-row section per 128-byte block,
plus one digest row per message; the 64-bit variant of `sha256_air`:

* working variables a,b,c and e,f,g are 64 bit-columns each (the 64-bit
  rotations are free bit reindexings; Ch/Maj/Σ/σ are degree ≤ 3 bit
  polynomials); d and h only feed modular adds, so they stay (lo, hi)
  32-bit limb pairs (a full 64-bit word can exceed the Goldilocks
  modulus, so every word value is limb-split, as in `blake2b_air`);
* mod-2^64 additions split into two 32-bit limb equations with small
  carry-bit columns (≤ 7 terms ⇒ 3-bit carries);
* the chaining value h0..h7 lives in 8 (lo, hi) pairs, copy-constrained
  within a section, feed-forward at the handoff row, IV-loaded at message
  starts;
* the message schedule is a 17-slot sliding window of (lo, hi) pairs with
  bit views of slots 2 and 15 for σ1/σ0;
* K round constants are TWO preprocessed columns (lo, hi) — K values
  exceed the field modulus as single cells.

STATEMENT BINDING: message words and claimed digests live in preprocessed
columns exactly as in `sha256_air` (`bind="consts"`).

A 64-bit word never sits in a torch int64 tensor as a value: torch's `>>`
on int64 is arithmetic, so a rotation of a word with its top bit set would
be wrong.  Words are (lo, hi) pairs of field values or bit columns on the
device, Python ints in the reference computation and numpy uint64 in the
witness build.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark.air import Air, DeviceAlgebra, bit_word

ROUNDS = 80
SECTION = 81  # 80 round rows + post-state/handoff row

_K = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817]

_IV = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF


def sha512_pad(msg: bytes) -> bytes:
    """Standard SHA-512 padding to whole 128-byte blocks."""
    bitlen = len(msg) * 8
    out = msg + b"\x80"
    out += b"\x00" * ((112 - len(out) % 128) % 128)
    return out + bitlen.to_bytes(16, "big")


# ---------------------------------------------------------------------------
# column layout
# ---------------------------------------------------------------------------

def _layout():
    names = []
    for fam in ("A", "B", "C", "E", "F", "G"):
        names += [f"{fam}{i}" for i in range(64)]
    names += ["Dlo", "Dhi", "Hlo", "Hhi"]
    for k in range(17):
        names += [f"W{k}lo", f"W{k}hi"]
    names += [f"WB2_{i}" for i in range(64)]
    names += [f"WB15_{i}" for i in range(64)]
    names += [f"CA{i}" for i in range(6)]    # a' carries: lo 3 bits, hi 3
    names += [f"CE{i}" for i in range(6)]
    names += [f"CW{i}" for i in range(4)]    # schedule carries: lo 2, hi 2
    for i in range(8):
        names += [f"H{i}lo", f"H{i}hi"]      # chaining value
    names += [f"CH{i}" for i in range(16)]   # feed-forward: lo/hi bit each
    return {n: i for i, n in enumerate(names)}


_COLS = _layout()
WIDTH = len(_COLS)

_CONST_NAMES = ["Klo", "Khi", "sel_round", "sel_schedule", "sel_shift",
                "sel_state", "sel_wbits", "sel_handoff",
                "sel_secstart", "sel_hcopy",
                "sel_mload", "sel_msgstart", "sel_digest",
                "mwlo", "mwhi",
                *[f"dig{i}{p}" for i in range(8) for p in ("lo", "hi")]]
_CONST = {n: i for i, n in enumerate(_CONST_NAMES)}
N_CONST = len(_CONST)


def _as_messages(messages) -> list[bytes]:
    if isinstance(messages, (bytes, bytearray)):
        return [bytes(messages)]
    return [bytes(m) for m in messages]


def _fam(cols, fam):
    base = _COLS[f"{fam}0"]
    return cols[base:base + 64]


# -- numpy uint64 word helpers of the witness build ---------------------------

_U = np.uint64


def _np_rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> _U(n)) | (x << _U(64 - n))


def _np_sig0(x):
    return _np_rotr(x, 1) ^ _np_rotr(x, 8) ^ (x >> _U(7))


def _np_sig1(x):
    return _np_rotr(x, 19) ^ _np_rotr(x, 61) ^ (x >> _U(6))


def _np_cap_s1(e):
    return _np_rotr(e, 14) ^ _np_rotr(e, 18) ^ _np_rotr(e, 41)


def _np_cap_s0(a):
    return _np_rotr(a, 28) ^ _np_rotr(a, 34) ^ _np_rotr(a, 39)


def _lo(x):
    return x & _U(M32)


def _hi(x):
    return x >> _U(32)


def _np_bits(x: np.ndarray, nbits: int) -> np.ndarray:
    """(L,) uint64 -> (nbits, L) little-endian bits."""
    return (x[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) & _U(1)


def _carry(terms, res) -> tuple[np.ndarray, np.ndarray]:
    """Limb carries of Σ terms = res + (c_lo + c_hi·2^32)·2^32 (mod 2^64,
    limb-split): c_lo carries the low halves into the high ones."""
    lo = sum(_lo(t) for t in terms)
    c_lo = (lo - _lo(res)) >> _U(32)
    hi = sum(_hi(t) for t in terms) + c_lo
    c_hi = (hi - _hi(res)) >> _U(32)
    return c_lo, c_hi


class Sha512Air(Air):
    """Full SHA-512 of a batch of messages.  Pass a single `bytes` or a
    list of them."""

    def __init__(self, messages):
        self.messages = _as_messages(messages)
        self._shape()
        super().__init__(width=WIDTH, log_n=self._log_n,
                         constraint_degree=4)
        self._run()

    def _shape(self):
        assert self.messages
        self.msg_blocks = []
        self.bases = []
        row = 0
        for msg in self.messages:
            padded = sha512_pad(msg)
            blocks = [padded[i:i + 128] for i in range(0, len(padded), 128)]
            self.msg_blocks.append(blocks)
            self.bases.append(row)
            row += SECTION * len(blocks) + 1
        self.total_rows = row
        # n ≥ total_rows + 1 keeps every digest row out of the masked
        # last transition row
        self._log_n = max(7, self.total_rows.bit_length())

    @property
    def num_blocks(self) -> int:
        return sum(len(b) for b in self.msg_blocks)

    # -- reference computation (also the witness) ---------------------------

    @staticmethod
    def _rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & M64

    def _sig0(self, x):
        return (self._rotr(x, 1) ^ self._rotr(x, 8) ^ (x >> 7)) & M64

    def _sig1(self, x):
        return (self._rotr(x, 19) ^ self._rotr(x, 61) ^ (x >> 6)) & M64

    def _cap_s1(self, e):
        return self._rotr(e, 14) ^ self._rotr(e, 18) ^ self._rotr(e, 41)

    def _cap_s0(self, a):
        return self._rotr(a, 28) ^ self._rotr(a, 34) ^ self._rotr(a, 39)

    def _run(self):
        self._per_msg = []   # per message: (section_w, section_states, chains)
        self.digests = []
        for blocks in self.msg_blocks:
            h = list(_IV)
            chains = [list(h)]
            section_w = []
            section_states = []
            for blk in blocks:
                w = [int.from_bytes(blk[8 * i:8 * i + 8], "big")
                     for i in range(16)]
                for i in range(16, 80):
                    w.append((w[i - 16] + self._sig0(w[i - 15]) + w[i - 7]
                              + self._sig1(w[i - 2])) & M64)
                section_w.append(w)
                a, b, c, d, e, f, g, hh = h
                states = [(a, b, c, d, e, f, g, hh)]
                for r in range(80):
                    S1 = self._cap_s1(e)
                    ch = ((e & f) ^ ((~e) & g)) & M64
                    t1 = (hh + S1 + ch + _K[r] + w[r]) & M64
                    S0 = self._cap_s0(a)
                    maj = ((a & b) ^ (a & c) ^ (b & c)) & M64
                    t2 = (S0 + maj) & M64
                    hh, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M64,
                                               c, b, a, (t1 + t2) & M64)
                    states.append((a, b, c, d, e, f, g, hh))
                section_states.append(states)
                h = [(hv + sv) & M64 for hv, sv in zip(h, states[80])]
                chains.append(list(h))
            self._per_msg.append((section_w, section_states, chains))
            self.digests.append(list(h))

    def digest_bytes_list(self) -> list[bytes]:
        return [b"".join(int.to_bytes(x, 8, "big") for x in d)
                for d in self.digests]

    def digest_bytes(self) -> bytes:
        assert len(self.messages) == 1
        return self.digest_bytes_list()[0]

    @classmethod
    def statement(cls, messages, claimed_digests) -> "Sha512Air":
        """Verifier-side construction — no hashing."""
        self = object.__new__(cls)
        self.messages = _as_messages(messages)
        if isinstance(claimed_digests, (bytes, bytearray)):
            claimed_digests = [bytes(claimed_digests)]
        assert len(claimed_digests) == len(self.messages)
        assert all(len(d) == 64 for d in claimed_digests)
        self._shape()
        Air.__init__(self, width=WIDTH, log_n=self._log_n,
                     constraint_degree=4)
        self.digests = [
            [int.from_bytes(d[8 * i:8 * i + 8], "big") for i in range(8)]
            for d in claimed_digests]
        self._per_msg = None   # statement-only: no witness data
        return self

    # -- AIR interface ------------------------------------------------------

    def public_inputs(self):
        return [len(self.messages)]

    def constant_columns(self):
        cols = np.zeros((N_CONST, self.n), dtype=np.uint64)
        c = _CONST
        K = np.array(_K, dtype=np.uint64)
        for mi, blocks in enumerate(self.msg_blocks):
            mbase = self.bases[mi]
            for s, blk in enumerate(blocks):
                base = mbase + s * SECTION
                cols[c["Klo"], base:base + 80] = _lo(K)
                cols[c["Khi"], base:base + 80] = _hi(K)
                cols[c["sel_round"], base:base + 80] = 1
                cols[c["sel_schedule"], base + 16:base + 80] = 1
                cols[c["sel_wbits"], base + 16:base + 80] = 1
                cols[c["sel_shift"], base:base + 79] = 1
                cols[c["sel_state"], base:base + 81] = 1
                cols[c["sel_handoff"], base + 80] = 1
                cols[c["sel_secstart"], base] = 1
                cols[c["sel_hcopy"], base:base + 80] = 1
                mw = np.frombuffer(blk, dtype=">u8").astype(np.uint64)
                cols[c["sel_mload"], base:base + 16] = 1
                cols[c["mwlo"], base:base + 16] = _lo(mw)
                cols[c["mwhi"], base:base + 16] = _hi(mw)
            cols[c["sel_msgstart"], mbase] = 1
            drow = mbase + SECTION * len(blocks)
            cols[c["sel_digest"], drow] = 1
            for i in range(8):
                cols[c[f"dig{i}lo"], drow] = self.digests[mi][i] & M32
                cols[c[f"dig{i}hi"], drow] = self.digests[mi][i] >> 32
        return cols

    def boundaries(self, public):
        return []

    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        one = alg.constant(1)
        two = alg.constant(2)
        pow32 = alg.constant(1 << 32)
        sels = {nm: consts[_CONST[nm]] for nm in _CONST}

        def gate(sel, expr):
            return alg.mul(sels[sel], expr)

        def boolean(sel, b):
            return gate(sel, alg.mul(b, alg.sub(b, one)))

        def word_lo(bits):
            acc = None
            for i in range(32):
                t = alg.mul(alg.constant(1 << i), bits[i])
                acc = t if acc is None else alg.add(acc, t)
            return acc

        def word_hi(bits):
            acc = None
            for i in range(32):
                t = alg.mul(alg.constant(1 << i), bits[32 + i])
                acc = t if acc is None else alg.add(acc, t)
            return acc

        def xor3(x, y, z):
            s = alg.add(alg.add(x, y), z)
            p = alg.add(alg.add(alg.mul(x, y), alg.mul(y, z)),
                        alg.mul(z, x))
            xyz = alg.mul(alg.mul(x, y), z)
            return alg.add(alg.sub(s, alg.mul(two, p)),
                           alg.mul(alg.constant(4), xyz))

        def add64_eqs(out, sel, res_lo, res_hi, clo_bits, chi_bits,
                      terms):
            """res + carries·2^32 = Σ terms, limb-split; terms are
            (lo, hi) expression pairs."""
            c_lo = None
            for i, b in enumerate(clo_bits):
                t = alg.mul(alg.constant(1 << i), b)
                c_lo = t if c_lo is None else alg.add(c_lo, t)
            c_hi = None
            for i, b in enumerate(chi_bits):
                t = alg.mul(alg.constant(1 << i), b)
                c_hi = t if c_hi is None else alg.add(c_hi, t)
            rhs_lo = terms[0][0]
            rhs_hi = terms[0][1]
            for t in terms[1:]:
                rhs_lo = alg.add(rhs_lo, t[0])
                rhs_hi = alg.add(rhs_hi, t[1])
            lhs_lo = alg.add(res_lo, alg.mul(pow32, c_lo))
            out.append(gate(sel, alg.sub(lhs_lo, rhs_lo)))
            lhs_hi = alg.add(res_hi, alg.mul(pow32, c_hi))
            rhs_hi = alg.add(rhs_hi, c_lo)
            out.append(gate(sel, alg.sub(lhs_hi, rhs_hi)))

        A = _fam(local, "A"); B = _fam(local, "B"); C = _fam(local, "C")
        E = _fam(local, "E"); F = _fam(local, "F"); G = _fam(local, "G")
        An = _fam(nxt, "A"); Bn = _fam(nxt, "B"); Cn = _fam(nxt, "C")
        En = _fam(nxt, "E"); Fn = _fam(nxt, "F"); Gn = _fam(nxt, "G")
        Dp = (local[_COLS["Dlo"]], local[_COLS["Dhi"]])
        Hp = (local[_COLS["Hlo"]], local[_COLS["Hhi"]])
        Dpn = (nxt[_COLS["Dlo"]], nxt[_COLS["Dhi"]])
        Hpn = (nxt[_COLS["Hlo"]], nxt[_COLS["Hhi"]])
        W = [(local[_COLS[f"W{k}lo"]], local[_COLS[f"W{k}hi"]])
             for k in range(17)]
        Wn = [(nxt[_COLS[f"W{k}lo"]], nxt[_COLS[f"W{k}hi"]])
              for k in range(17)]
        WB2 = [local[_COLS[f"WB2_{i}"]] for i in range(64)]
        WB15 = [local[_COLS[f"WB15_{i}"]] for i in range(64)]
        CA = [local[_COLS[f"CA{i}"]] for i in range(6)]
        CE = [local[_COLS[f"CE{i}"]] for i in range(6)]
        CW = [local[_COLS[f"CW{i}"]] for i in range(4)]
        H = [(local[_COLS[f"H{i}lo"]], local[_COLS[f"H{i}hi"]])
             for i in range(8)]
        Hn = [(nxt[_COLS[f"H{i}lo"]], nxt[_COLS[f"H{i}hi"]])
              for i in range(8)]
        CH = [local[_COLS[f"CH{i}"]] for i in range(16)]

        out = []

        # --- booleanity ----------------------------------------------------
        for fam in (A, B, C, E, F, G):
            for b in fam:
                out.append(boolean("sel_state", b))
        for b in (*WB2, *WB15):
            out.append(boolean("sel_wbits", b))
        for b in (*CA, *CE):
            out.append(boolean("sel_round", b))
        for b in CW:
            out.append(boolean("sel_schedule", b))
        for b in CH:
            out.append(boolean("sel_handoff", b))

        # --- round function ------------------------------------------------
        s1b = [xor3(E[(i + 14) % 64], E[(i + 18) % 64], E[(i + 41) % 64])
               for i in range(64)]
        chb = [alg.add(alg.mul(E[i], F[i]),
                       alg.mul(alg.sub(one, E[i]), G[i]))
               for i in range(64)]
        s0b = [xor3(A[(i + 28) % 64], A[(i + 34) % 64], A[(i + 39) % 64])
               for i in range(64)]
        majb = [alg.sub(
            alg.add(alg.add(alg.mul(A[i], B[i]), alg.mul(A[i], C[i])),
                    alg.mul(B[i], C[i])),
            alg.mul(two, alg.mul(alg.mul(A[i], B[i]), C[i])))
            for i in range(64)]
        S1 = (word_lo(s1b), word_hi(s1b))
        Ch = (word_lo(chb), word_hi(chb))
        S0 = (word_lo(s0b), word_hi(s0b))
        Maj = (word_lo(majb), word_hi(majb))
        K = (sels["Klo"], sels["Khi"])
        Awords = (word_lo(A), word_hi(A))
        Bwords = (word_lo(B), word_hi(B))
        Cwords = (word_lo(C), word_hi(C))
        Ewords = (word_lo(E), word_hi(E))
        Fwords = (word_lo(F), word_hi(F))
        Gwords = (word_lo(G), word_hi(G))
        # a' = T1 + T2 = (h + S1 + ch + K + w) + (S0 + maj): 7 terms
        add64_eqs(out, "sel_round", word_lo(An), word_hi(An),
                  CA[:3], CA[3:], [Hp, S1, Ch, K, W[0], S0, Maj])
        # e' = d + T1: 6 terms
        add64_eqs(out, "sel_round", word_lo(En), word_hi(En),
                  CE[:3], CE[3:], [Dp, Hp, S1, Ch, K, W[0]])
        for Xn, X in ((Bn, A), (Cn, B), (Fn, E), (Gn, F)):
            for i in range(64):
                out.append(gate("sel_round", alg.sub(Xn[i], X[i])))
        out.append(gate("sel_round", alg.sub(Dpn[0], Cwords[0])))
        out.append(gate("sel_round", alg.sub(Dpn[1], Cwords[1])))
        out.append(gate("sel_round", alg.sub(Hpn[0], Gwords[0])))
        out.append(gate("sel_round", alg.sub(Hpn[1], Gwords[1])))

        # --- schedule window ----------------------------------------------
        for k in range(1, 17):
            out.append(gate("sel_shift", alg.sub(Wn[k][0], W[k - 1][0])))
            out.append(gate("sel_shift", alg.sub(Wn[k][1], W[k - 1][1])))
        out.append(gate("sel_wbits", alg.sub(word_lo(WB2), W[2][0])))
        out.append(gate("sel_wbits", alg.sub(word_hi(WB2), W[2][1])))
        out.append(gate("sel_wbits", alg.sub(word_lo(WB15), W[15][0])))
        out.append(gate("sel_wbits", alg.sub(word_hi(WB15), W[15][1])))
        zero = alg.constant(0)
        sig1b = [xor3(WB2[(i + 19) % 64], WB2[(i + 61) % 64],
                      WB2[i + 6] if i + 6 < 64 else zero)
                 for i in range(64)]
        sig0b = [xor3(WB15[(i + 1) % 64], WB15[(i + 8) % 64],
                      WB15[i + 7] if i + 7 < 64 else zero)
                 for i in range(64)]
        sig1 = (word_lo(sig1b), word_hi(sig1b))
        sig0 = (word_lo(sig0b), word_hi(sig0b))
        add64_eqs(out, "sel_schedule", W[0][0], W[0][1], CW[:2], CW[2:],
                  [sig1, W[7], sig0, W[16]])

        # --- chaining ------------------------------------------------------
        for i in range(8):
            out.append(gate("sel_hcopy", alg.sub(Hn[i][0], H[i][0])))
            out.append(gate("sel_hcopy", alg.sub(Hn[i][1], H[i][1])))
        state_words = [Awords, Bwords, Cwords, Dp,
                       Ewords, Fwords, Gwords, Hp]
        for i in range(8):
            add64_eqs(out, "sel_handoff", Hn[i][0], Hn[i][1],
                      [CH[2 * i]], [CH[2 * i + 1]],
                      [H[i], state_words[i]])
        for i, sw in enumerate(state_words):
            out.append(gate("sel_secstart", alg.sub(sw[0], H[i][0])))
            out.append(gate("sel_secstart", alg.sub(sw[1], H[i][1])))

        # --- statement binding ---------------------------------------------
        out.append(gate("sel_mload", alg.sub(W[0][0], sels["mwlo"])))
        out.append(gate("sel_mload", alg.sub(W[0][1], sels["mwhi"])))
        for i in range(8):
            out.append(gate("sel_msgstart",
                            alg.sub(H[i][0], alg.constant(_IV[i] & M32))))
            out.append(gate("sel_msgstart",
                            alg.sub(H[i][1], alg.constant(_IV[i] >> 32))))
        for i in range(8):
            out.append(gate("sel_digest",
                            alg.sub(H[i][0], sels[f"dig{i}lo"])))
            out.append(gate("sel_digest",
                            alg.sub(H[i][1], sels[f"dig{i}hi"])))

        return out

    def _transition_device(self, local, nxt, consts):
        """Stacked torch evaluation of the same constraints, in the same
        order: each bit family is one (64, N) tensor, rotations are
        `torch.roll` on the bit axis, a 64-bit word is a (lo, hi) pair of
        32-bit weighted field sums (`bit_word` over bits 0..31, 32..63),
        and the (lo, hi) constraints of a word pair interleave as a
        (k, 2, N) stack."""
        add, sub, mul = gl.add, gl.sub, gl.mul
        dev = local[0].device

        def stack(cols, names):
            return torch.stack([cols[_COLS[nm]] for nm in names])

        def fam(cols, f):
            base = _COLS[f"{f}0"]
            return torch.stack(cols[base:base + 64])

        def word(bits):
            return (bit_word(bits[:32]), bit_word(bits[32:]))

        def xor3(x, y, z):
            s = add(add(x, y), z)
            p = add(add(mul(x, y), mul(y, z)), mul(z, x))
            return add(sub(s, mul(p, 2)), mul(mul(mul(x, y), z), 4))

        def roll(bits, n):
            # result bit i = input bit (i+n) % 64
            return torch.roll(bits, -n, 0)

        def shr(bits, n):
            # result bit i = input bit i+n (0 beyond 63)
            return torch.cat([bits[n:], torch.zeros_like(bits[:n])])

        sels = {nm: consts[_CONST[nm]] for nm in _CONST}
        out = []

        def gate(sel_name, expr):
            out.append(mul(sels[sel_name], expr))

        def gate_rows(sel_name, rows):
            out.extend(mul(rows, sels[sel_name][None]).unbind(0))

        def gate_pairs(sel_name, lo, hi):
            # (k, N) lo and hi rows emitted lo0, hi0, lo1, hi1, ...
            gate_rows(sel_name, torch.stack([lo, hi], 1).flatten(0, 1))

        def carry_val(bits):
            return bit_word(bits) if bits.shape[0] > 1 else bits[0]

        def add64(sel_name, res, clo, chi, terms):
            c_lo, c_hi = carry_val(clo), carry_val(chi)
            rhs_lo, rhs_hi = terms[0]
            for t in terms[1:]:
                rhs_lo = add(rhs_lo, t[0])
                rhs_hi = add(rhs_hi, t[1])
            gate(sel_name, sub(add(res[0], mul(c_lo, 1 << 32)), rhs_lo))
            gate(sel_name, sub(add(res[1], mul(c_hi, 1 << 32)),
                               add(rhs_hi, c_lo)))

        A = fam(local, "A"); B = fam(local, "B"); C = fam(local, "C")
        E = fam(local, "E"); F = fam(local, "F"); G = fam(local, "G")
        An = fam(nxt, "A"); Bn = fam(nxt, "B"); Cn = fam(nxt, "C")
        En = fam(nxt, "E"); Fn = fam(nxt, "F"); Gn = fam(nxt, "G")
        Dw = (local[_COLS["Dlo"]], local[_COLS["Dhi"]])
        Hw = (local[_COLS["Hlo"]], local[_COLS["Hhi"]])
        Dwn = (nxt[_COLS["Dlo"]], nxt[_COLS["Dhi"]])
        Hwn = (nxt[_COLS["Hlo"]], nxt[_COLS["Hhi"]])
        W = [(local[_COLS[f"W{k}lo"]], local[_COLS[f"W{k}hi"]])
             for k in range(17)]
        Wn = [(nxt[_COLS[f"W{k}lo"]], nxt[_COLS[f"W{k}hi"]])
              for k in range(17)]
        WB2 = stack(local, [f"WB2_{i}" for i in range(64)])
        WB15 = stack(local, [f"WB15_{i}" for i in range(64)])
        CA = stack(local, [f"CA{i}" for i in range(6)])
        CE = stack(local, [f"CE{i}" for i in range(6)])
        CW = stack(local, [f"CW{i}" for i in range(4)])
        CH = stack(local, [f"CH{i}" for i in range(16)])
        Hlo = stack(local, [f"H{i}lo" for i in range(8)])
        Hhi = stack(local, [f"H{i}hi" for i in range(8)])
        Hnlo = stack(nxt, [f"H{i}lo" for i in range(8)])
        Hnhi = stack(nxt, [f"H{i}hi" for i in range(8)])

        # --- booleanity ----------------------------------------------------
        for sel_name, bits in (("sel_state", A), ("sel_state", B),
                               ("sel_state", C), ("sel_state", E),
                               ("sel_state", F), ("sel_state", G),
                               ("sel_wbits", WB2), ("sel_wbits", WB15),
                               ("sel_round", CA), ("sel_round", CE),
                               ("sel_schedule", CW), ("sel_handoff", CH)):
            gate_rows(sel_name, mul(bits, sub(bits, 1)))

        # --- round function ------------------------------------------------
        S1 = word(xor3(roll(E, 14), roll(E, 18), roll(E, 41)))
        Ch = word(add(mul(E, F), mul(sub(1, E), G)))
        S0 = word(xor3(roll(A, 28), roll(A, 34), roll(A, 39)))
        AB = mul(A, B)
        Maj = word(sub(add(add(AB, mul(A, C)), mul(B, C)),
                       mul(mul(AB, C), 2)))
        K = (sels["Klo"], sels["Khi"])
        Aw = word(A); Bw = word(B); Cw = word(C)
        Ew = word(E); Fw = word(F); Gw = word(G)
        add64("sel_round", word(An), CA[:3], CA[3:],
              [Hw, S1, Ch, K, W[0], S0, Maj])
        add64("sel_round", word(En), CE[:3], CE[3:],
              [Dw, Hw, S1, Ch, K, W[0]])
        for Xn, X in ((Bn, A), (Cn, B), (Fn, E), (Gn, F)):
            gate_rows("sel_round", sub(Xn, X))
        gate("sel_round", sub(Dwn[0], Cw[0]))
        gate("sel_round", sub(Dwn[1], Cw[1]))
        gate("sel_round", sub(Hwn[0], Gw[0]))
        gate("sel_round", sub(Hwn[1], Gw[1]))

        # --- schedule window ----------------------------------------------
        Wlo = torch.stack([w[0] for w in W])
        Whi = torch.stack([w[1] for w in W])
        gate_pairs("sel_shift",
                   sub(torch.stack([w[0] for w in Wn[1:]]), Wlo[:16]),
                   sub(torch.stack([w[1] for w in Wn[1:]]), Whi[:16]))
        wb2w = word(WB2)
        wb15w = word(WB15)
        gate("sel_wbits", sub(wb2w[0], W[2][0]))
        gate("sel_wbits", sub(wb2w[1], W[2][1]))
        gate("sel_wbits", sub(wb15w[0], W[15][0]))
        gate("sel_wbits", sub(wb15w[1], W[15][1]))
        sig1 = word(xor3(roll(WB2, 19), roll(WB2, 61), shr(WB2, 6)))
        sig0 = word(xor3(roll(WB15, 1), roll(WB15, 8), shr(WB15, 7)))
        add64("sel_schedule", W[0], CW[:2], CW[2:],
              [sig1, W[7], sig0, W[16]])

        # --- chaining ------------------------------------------------------
        gate_pairs("sel_hcopy", sub(Hnlo, Hlo), sub(Hnhi, Hhi))
        sw_lo = torch.stack([Aw[0], Bw[0], Cw[0], Dw[0],
                             Ew[0], Fw[0], Gw[0], Hw[0]])
        sw_hi = torch.stack([Aw[1], Bw[1], Cw[1], Dw[1],
                             Ew[1], Fw[1], Gw[1], Hw[1]])
        ch_lo, ch_hi = CH[0::2], CH[1::2]
        gate_pairs("sel_handoff",
                   sub(add(Hnlo, mul(ch_lo, 1 << 32)), add(Hlo, sw_lo)),
                   sub(add(Hnhi, mul(ch_hi, 1 << 32)),
                       add(add(Hhi, sw_hi), ch_lo)))
        gate_pairs("sel_secstart", sub(sw_lo, Hlo), sub(sw_hi, Hhi))

        # --- statement binding (same emission order as the scalar path) ----
        gate("sel_mload", sub(W[0][0], sels["mwlo"]))
        gate("sel_mload", sub(W[0][1], sels["mwhi"]))
        iv_lo = torch.tensor([v & M32 for v in _IV], dtype=torch.int64,
                             device=dev)[:, None]
        iv_hi = torch.tensor([v >> 32 for v in _IV], dtype=torch.int64,
                             device=dev)[:, None]
        gate_pairs("sel_msgstart", sub(Hlo, iv_lo), sub(Hhi, iv_hi))
        dig_lo = torch.stack([sels[f"dig{i}lo"] for i in range(8)])
        dig_hi = torch.stack([sels[f"dig{i}hi"] for i in range(8)])
        gate_pairs("sel_digest", sub(Hlo, dig_lo), sub(Hhi, dig_hi))
        return out

    # -- witness ------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        tr = np.zeros((WIDTH, self.n), dtype=np.uint64)
        for mi in range(len(self.messages)):
            self._build_message_trace(tr, mi)
        return tr

    def _build_message_trace(self, tr: np.ndarray, mi: int) -> None:
        """One message's sections, each written as whole-column slices of
        numpy uint64 words (wrapping adds are the mod-2^64 adds)."""
        c = _COLS
        section_w, section_states, chains = self._per_msg[mi]
        mbase = self.bases[mi]
        Kc = np.array(_K, dtype=np.uint64)
        for s in range(len(self.msg_blocks[mi])):
            base = mbase + s * SECTION
            w = np.array(section_w[s], dtype=np.uint64)              # (80,)
            st = np.array(section_states[s], dtype=np.uint64)        # (81, 8)
            chain = np.array(chains[s], dtype=np.uint64)
            nchain = np.array(chains[s + 1], dtype=np.uint64)
            # schedule window: W_k at row base+r holds w[r-k]
            for k in range(17):
                end = min(SECTION, k + 80)
                tr[c[f"W{k}lo"], base + k:base + end] = _lo(w[:end - k])
                tr[c[f"W{k}hi"], base + k:base + end] = _hi(w[:end - k])
            # rows 16..79: bit views of w[r-2] and w[r-15], schedule carries
            rows = slice(base + 16, base + 80)
            tr[c["WB2_0"]:c["WB2_0"] + 64, rows] = _np_bits(w[14:78], 64)
            tr[c["WB15_0"]:c["WB15_0"] + 64, rows] = _np_bits(w[1:65], 64)
            c_lo, c_hi = _carry([_np_sig1(w[14:78]), w[9:73],
                                 _np_sig0(w[1:65]), w[0:64]], w[16:80])
            tr[c["CW0"]:c["CW0"] + 2, rows] = _np_bits(c_lo, 2)
            tr[c["CW2"]:c["CW2"] + 2, rows] = _np_bits(c_hi, 2)
            # working state bits and limbs over the 81 rows
            for fi, f in ((0, "A"), (1, "B"), (2, "C"), (4, "E"), (5, "F"),
                          (6, "G")):
                tr[c[f"{f}0"]:c[f"{f}0"] + 64, base:base + SECTION] = \
                    _np_bits(st[:, fi], 64)
            tr[c["Dlo"], base:base + SECTION] = _lo(st[:, 3])
            tr[c["Dhi"], base:base + SECTION] = _hi(st[:, 3])
            tr[c["Hlo"], base:base + SECTION] = _lo(st[:, 7])
            tr[c["Hhi"], base:base + SECTION] = _hi(st[:, 7])
            # round carries over rows 0..79
            a, b, cc, d, e, f, g, h = (st[:80, i] for i in range(8))
            S1 = _np_cap_s1(e)
            ch = (e & f) ^ (~e & g)
            S0 = _np_cap_s0(a)
            maj = (a & b) ^ (a & cc) ^ (b & cc)
            ca_lo, ca_hi = _carry([h, S1, ch, Kc, w, S0, maj], st[1:, 0])
            ce_lo, ce_hi = _carry([d, h, S1, ch, Kc, w], st[1:, 4])
            r80 = slice(base, base + 80)
            tr[c["CA0"]:c["CA0"] + 3, r80] = _np_bits(ca_lo, 3)
            tr[c["CA3"]:c["CA3"] + 3, r80] = _np_bits(ca_hi, 3)
            tr[c["CE0"]:c["CE0"] + 3, r80] = _np_bits(ce_lo, 3)
            tr[c["CE3"]:c["CE3"] + 3, r80] = _np_bits(ce_hi, 3)
            # chain columns over the section, feed-forward carries at the
            # handoff row, the chain after the handoff (next section start
            # or digest row)
            hc = [c[f"H{i}lo"] for i in range(8)]
            hh = [c[f"H{i}hi"] for i in range(8)]
            tr[hc, base:base + SECTION] = _lo(chain)[:, None]
            tr[hh, base:base + SECTION] = _hi(chain)[:, None]
            f_lo, f_hi = _carry([chain, st[80]], nchain)
            tr[[c[f"CH{2 * i}"] for i in range(8)], base + 80] = f_lo
            tr[[c[f"CH{2 * i + 1}"] for i in range(8)], base + 80] = f_hi
            tr[hc, base + SECTION] = _lo(nchain)
            tr[hh, base + SECTION] = _hi(nchain)
