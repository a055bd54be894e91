"""SHA-256 AIR: proves digest_i = SHA256(message_i) for a BATCH of
independent multi-block messages in one trace.

Port of `vectorx_tpu.stark.sha256_air`, in both of its statement bindings
(`bind="consts"` and `bind="public"`, below).  The counterpart of the
reference's curta SHA-256 STARK gadget (`curta_sha256`, upstream
circuits/builder/justification.rs:140,156): the authority-set chained
commitment and the data-root Merkle interior nodes are exactly chains of
this hash.

Arithmetization — one round per row, 65-row section per 64-byte block,
plus one digest row per message:

* message m occupies rows [base_m, base_m + 65·k_m]: k_m sections of
  64 round rows + a post-state/handoff row each, then a digest row;
* working variables a,b,c and e,f,g are 32 bit-columns each (rotations are
  free bit reindexings; Ch/Maj/Σ/σ are degree ≤ 3 bit polynomials); d and h
  only feed modular adds, so they stay word columns;
* the chaining value h0..h7 lives in 8 word columns, copy-constrained
  within a section; the handoff row adds the section's final working state
  (feed-forward, with 1-bit carries) and the next section-start row loads
  the working state from it; each message-start row loads the IV;
* the message schedule is a 17-slot sliding window of word columns with
  bit views of slots 2 and 15 for σ1/σ0;
* every mod-2^32 addition carries small carry-bit columns.

STATEMENT BINDING: the message words and claimed digests live in
preprocessed (constant) columns — `mword` streams w[r] under `sel_mload`,
`dig0..dig7` hold the digest words at each message's digest row under
`sel_digest`.  The verifier derives the constants commitment from the
statement itself, so a proof only verifies against the exact (messages,
digests) it was built for.  With `bind="public"` the constant columns carry
only the shape (the binding selectors are zero); the message words and
digests are public inputs, pinned by boundary constraints to `W0` over each
section's first 16 rows and to `H0..H7` on each digest row.  The transition
emits the same constraints in both modes.

The constraints are written twice: once against the abstract algebra (the
verifier's scalar evaluation at ζ) and once as stacked torch ops over the
whole LDE block (`_transition_device`).  Both emit the same constraints in
the same order — the composition pairs them with α powers by index.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch import tracing
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark.air import Air, DeviceAlgebra, bit_word

ROUNDS = 64
SECTION = 65  # 64 round rows + post-state/handoff row

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

M32 = 0xFFFFFFFF


def sha256_pad(msg: bytes) -> bytes:
    """Standard SHA-256 padding to a whole number of 64-byte blocks."""
    bitlen = len(msg) * 8
    out = msg + b"\x80"
    out += b"\x00" * ((56 - len(out) % 64) % 64)
    return out + bitlen.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# column layout
# ---------------------------------------------------------------------------

def _layout():
    names = []
    for fam in ("A", "B", "C", "E", "F", "G"):
        names += [f"{fam}{i}" for i in range(32)]
    names += ["Dw", "Hw"]
    names += [f"W{k}" for k in range(17)]
    names += [f"WB2_{i}" for i in range(32)]
    names += [f"WB15_{i}" for i in range(32)]
    names += [f"CA{i}" for i in range(3)]
    names += [f"CE{i}" for i in range(3)]
    names += [f"CW{i}" for i in range(2)]
    names += [f"H{i}" for i in range(8)]      # chaining value
    names += [f"CH{i}" for i in range(8)]     # feed-forward carry bits
    return {n: i for i, n in enumerate(names)}


_COLS = _layout()
WIDTH = len(_COLS)

_CONST_NAMES = ["K", "sel_round", "sel_schedule", "sel_shift",
                "sel_state", "sel_wbits", "sel_handoff",
                "sel_secstart", "sel_hcopy",
                # statement-binding columns (see module docstring)
                "sel_mload", "sel_msgstart", "sel_digest", "mword",
                *[f"dig{i}" for i in range(8)]]
_CONST = {n: i for i, n in enumerate(_CONST_NAMES)}
N_CONST = len(_CONST)


def _as_messages(messages) -> list[bytes]:
    if isinstance(messages, (bytes, bytearray)):
        return [bytes(messages)]
    return [bytes(m) for m in messages]


def _fam(cols, fam):
    base = _COLS[f"{fam}0"]
    return cols[base:base + 32]


def _np_rotr(x: np.ndarray, n: int) -> np.ndarray:
    return ((x >> np.uint64(n)) | (x << np.uint64(32 - n))) & np.uint64(M32)


def _np_sig0(x: np.ndarray) -> np.ndarray:
    return _np_rotr(x, 7) ^ _np_rotr(x, 18) ^ (x >> np.uint64(3))


def _np_sig1(x: np.ndarray) -> np.ndarray:
    return _np_rotr(x, 17) ^ _np_rotr(x, 19) ^ (x >> np.uint64(10))


def _np_bits(x: np.ndarray, nbits: int) -> np.ndarray:
    """(L,) uint64 -> (nbits, L) little-endian bits."""
    return (x[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) \
        & np.uint64(1)


class Sha256Air(Air):
    """Full SHA-256 of a batch of messages (any number of 64-byte blocks
    each).  Pass a single `bytes` or a list of them.

    `bind` selects how the statement is bound: "consts" (default) puts the
    message words and digests in the preprocessed columns, "public" makes
    them public inputs bound by boundary constraints, so that the constant
    columns depend on the shape alone and the recursion aggregator can
    wire the publics to tape values."""

    def __init__(self, messages, bind: str = "consts"):
        assert bind in ("consts", "public")
        self.bind = bind
        self.messages = _as_messages(messages)
        self._shape()
        super().__init__(width=WIDTH, log_n=self._log_n,
                         constraint_degree=4)
        self._run()

    def _shape(self):
        """Per-message block lists, section-start bases, and trace size."""
        assert self.messages
        self.msg_blocks = []
        self.bases = []
        row = 0
        for msg in self.messages:
            padded = sha256_pad(msg)
            blocks = [padded[i:i + 64] for i in range(0, len(padded), 64)]
            self.msg_blocks.append(blocks)
            self.bases.append(row)
            row += SECTION * len(blocks) + 1   # sections + digest row
        self.total_rows = row
        # n ≥ total_rows + 1 keeps every digest row out of the masked
        # last transition row
        self._log_n = max(7, self.total_rows.bit_length())

    # -- reference computation (also the witness) ---------------------------

    @staticmethod
    def _rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M32

    def _sig0(self, x):
        return (self._rotr(x, 7) ^ self._rotr(x, 18) ^ (x >> 3)) & M32

    def _sig1(self, x):
        return (self._rotr(x, 17) ^ self._rotr(x, 19) ^ (x >> 10)) & M32

    def _run(self):
        self._per_msg = []   # per message: (section_w, section_states, chains)
        self.digests = []
        for blocks in self.msg_blocks:
            h = list(_IV)
            chains = [list(h)]
            section_w = []
            section_states = []
            for blk in blocks:
                w = [int.from_bytes(blk[4 * i:4 * i + 4], "big")
                     for i in range(16)]
                for i in range(16, 64):
                    w.append((w[i - 16] + self._sig0(w[i - 15]) + w[i - 7]
                              + self._sig1(w[i - 2])) & M32)
                section_w.append(w)
                a, b, c, d, e, f, g, hh = h
                states = [(a, b, c, d, e, f, g, hh)]
                for r in range(64):
                    S1 = self._rotr(e, 6) ^ self._rotr(e, 11) \
                        ^ self._rotr(e, 25)
                    ch = ((e & f) ^ ((~e) & g)) & M32
                    t1 = (hh + S1 + ch + _K[r] + w[r]) & M32
                    S0 = self._rotr(a, 2) ^ self._rotr(a, 13) \
                        ^ self._rotr(a, 22)
                    maj = ((a & b) ^ (a & c) ^ (b & c)) & M32
                    t2 = (S0 + maj) & M32
                    hh, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32,
                                               c, b, a, (t1 + t2) & M32)
                    states.append((a, b, c, d, e, f, g, hh))
                section_states.append(states)
                h = [(hv + sv) & M32 for hv, sv in zip(h, states[64])]
                chains.append(list(h))
            self._per_msg.append((section_w, section_states, chains))
            self.digests.append(list(h))

    @property
    def message(self) -> bytes:
        assert len(self.messages) == 1
        return self.messages[0]

    @property
    def blocks(self) -> list[bytes]:
        assert len(self.messages) == 1
        return self.msg_blocks[0]

    @property
    def num_blocks(self) -> int:
        return sum(len(b) for b in self.msg_blocks)

    @property
    def digest(self) -> list[int]:
        assert len(self.digests) == 1
        return self.digests[0]

    def digest_bytes(self) -> bytes:
        return b"".join(int.to_bytes(x, 4, "big") for x in self.digest)

    def digest_bytes_list(self) -> list[bytes]:
        return [b"".join(int.to_bytes(x, 4, "big") for x in d)
                for d in self.digests]

    @classmethod
    def statement(cls, messages, claimed_digests) -> "Sha256Air":
        """Verifier-side construction: the STATEMENT (messages + claimed
        digests) without computing any hash — verification must not need to
        re-hash, only to check the proof against this statement.  Accepts
        a single message + 32-byte digest or parallel lists."""
        self = object.__new__(cls)
        self.bind = "consts"
        self.messages = _as_messages(messages)
        if isinstance(claimed_digests, (bytes, bytearray)):
            claimed_digests = [bytes(claimed_digests)]
        assert len(claimed_digests) == len(self.messages)
        assert all(len(d) == 32 for d in claimed_digests)
        self._shape()
        Air.__init__(self, width=WIDTH, log_n=self._log_n,
                     constraint_degree=4)
        self.digests = [
            [int.from_bytes(d[4 * i:4 * i + 4], "big") for i in range(8)]
            for d in claimed_digests]
        self._per_msg = None   # statement-only: no witness data
        return self

    @classmethod
    def public_shape(cls, block_counts: list[int]) -> "Sha256Air":
        """Verifier-side construction for bind="public": only the shape
        (blocks per message) is statement data; `public_inputs()` returns
        zero placeholders for the message words and digests, which the
        caller supplies (in the aggregator, by wiring tape values)."""
        self = object.__new__(cls)
        self.bind = "public"
        self.messages = None
        self.msg_blocks = [[None] * k for k in block_counts]
        self.bases = []
        row = 0
        for k in block_counts:
            self.bases.append(row)
            row += SECTION * k + 1
        self.total_rows = row
        self._log_n = max(7, self.total_rows.bit_length())
        Air.__init__(self, width=WIDTH, log_n=self._log_n,
                     constraint_degree=4)
        self.digests = None
        self._per_msg = None
        return self

    # -- AIR interface ------------------------------------------------------

    def public_inputs(self):
        if self.bind == "public":
            # the message count, then per message 16 words per padded
            # block and its 8 digest words
            out = [len(self.msg_blocks)]
            for mi, blocks in enumerate(self.msg_blocks):
                if self.messages is None:
                    out += [0] * (16 * len(blocks) + 8)
                    continue
                for blk in blocks:
                    out += np.frombuffer(blk, dtype=">u4").tolist()
                out += self.digests[mi]
            return out
        # the statement lives in the preprocessed columns; the constants
        # cap binds it into the transcript
        return [len(self.messages)]

    def constant_columns(self):
        cols = np.zeros((N_CONST, self.n), dtype=np.uint64)
        c = _CONST
        K = np.array(_K, dtype=np.uint64)
        for mi, blocks in enumerate(self.msg_blocks):
            mbase = self.bases[mi]
            for s, blk in enumerate(blocks):
                base = mbase + s * SECTION
                cols[c["K"], base:base + 64] = K
                cols[c["sel_round"], base:base + 64] = 1
                cols[c["sel_schedule"], base + 16:base + 64] = 1
                cols[c["sel_wbits"], base + 16:base + 64] = 1
                cols[c["sel_shift"], base:base + 63] = 1
                cols[c["sel_state"], base:base + 65] = 1
                cols[c["sel_handoff"], base + 64] = 1
                cols[c["sel_secstart"], base] = 1
                # H constant within the section (rows base..base+63)
                cols[c["sel_hcopy"], base:base + 64] = 1
                if self.bind == "consts":
                    # message words streamed into W0 over the first 16 rows
                    cols[c["sel_mload"], base:base + 16] = 1
                    cols[c["mword"], base:base + 16] = np.frombuffer(
                        blk, dtype=">u4")
            cols[c["sel_msgstart"], mbase] = 1
            if self.bind == "consts":
                drow = mbase + SECTION * len(blocks)
                cols[c["sel_digest"], drow] = 1
                for i in range(8):
                    cols[c[f"dig{i}"], drow] = self.digests[mi][i]
        return cols

    def boundaries(self, public):
        """bind="public": each section's 16 message words on `W0` over its
        first 16 rows, each message's digest on `H0..H7` at its digest row
        (public[0] is the message count)."""
        if self.bind != "public":
            return []
        out = []
        idx = 1
        for mi, blocks in enumerate(self.msg_blocks):
            mbase = self.bases[mi]
            for s in range(len(blocks)):
                base = mbase + s * SECTION
                for r in range(16):
                    out.append((base + r, _COLS["W0"], public[idx]))
                    idx += 1
            drow = mbase + SECTION * len(blocks)
            for i in range(8):
                out.append((drow, _COLS[f"H{i}"], public[idx]))
                idx += 1
        return out

    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        one = alg.constant(1)
        two = alg.constant(2)
        k_col = consts[_CONST["K"]]
        sel_round = consts[_CONST["sel_round"]]
        sel_sched = consts[_CONST["sel_schedule"]]
        sel_shift = consts[_CONST["sel_shift"]]
        sel_state = consts[_CONST["sel_state"]]
        sel_wbits = consts[_CONST["sel_wbits"]]
        sel_handoff = consts[_CONST["sel_handoff"]]
        sel_secstart = consts[_CONST["sel_secstart"]]
        sel_hcopy = consts[_CONST["sel_hcopy"]]

        def gate(sel, expr):
            return alg.mul(sel, expr)

        def boolean(sel, b):
            return gate(sel, alg.mul(b, alg.sub(b, one)))

        def word(bits):
            acc = None
            for i, b in enumerate(bits):
                t = alg.mul(alg.constant(1 << i), b)
                acc = t if acc is None else alg.add(acc, t)
            return acc

        def xor3(x, y, z):
            # degree-3 expansion: x+y+z − 2(xy+yz+zx) + 4xyz
            s = alg.add(alg.add(x, y), z)
            p = alg.add(alg.add(alg.mul(x, y), alg.mul(y, z)), alg.mul(z, x))
            xyz = alg.mul(alg.mul(x, y), z)
            return alg.add(alg.sub(s, alg.mul(two, p)),
                           alg.mul(alg.constant(4), xyz))

        A = _fam(local, "A"); B = _fam(local, "B"); C = _fam(local, "C")
        E = _fam(local, "E"); F = _fam(local, "F"); G = _fam(local, "G")
        An = _fam(nxt, "A"); Bn = _fam(nxt, "B"); Cn = _fam(nxt, "C")
        En = _fam(nxt, "E"); Fn = _fam(nxt, "F"); Gn = _fam(nxt, "G")
        Dw = local[_COLS["Dw"]]; Hw = local[_COLS["Hw"]]
        Dwn = nxt[_COLS["Dw"]]; Hwn = nxt[_COLS["Hw"]]
        W = [local[_COLS[f"W{k}"]] for k in range(17)]
        Wn = [nxt[_COLS[f"W{k}"]] for k in range(17)]
        WB2 = [local[_COLS[f"WB2_{i}"]] for i in range(32)]
        WB15 = [local[_COLS[f"WB15_{i}"]] for i in range(32)]
        CA = [local[_COLS[f"CA{i}"]] for i in range(3)]
        CE = [local[_COLS[f"CE{i}"]] for i in range(3)]
        CW = [local[_COLS[f"CW{i}"]] for i in range(2)]
        H = [local[_COLS[f"H{i}"]] for i in range(8)]
        Hn = [nxt[_COLS[f"H{i}"]] for i in range(8)]
        CH = [local[_COLS[f"CH{i}"]] for i in range(8)]

        out = []

        # --- booleanity ----------------------------------------------------
        for fam in (A, B, C, E, F, G):
            for b in fam:
                out.append(boolean(sel_state, b))
        for b in (*WB2, *WB15):
            out.append(boolean(sel_wbits, b))
        for b in (*CA, *CE):
            out.append(boolean(sel_round, b))
        for b in CW:
            out.append(boolean(sel_sched, b))
        for b in CH:
            out.append(boolean(sel_handoff, b))

        # --- round function ------------------------------------------------
        S1 = word([xor3(E[(i + 6) % 32], E[(i + 11) % 32], E[(i + 25) % 32])
                   for i in range(32)])
        Ch = word([alg.add(alg.mul(E[i], F[i]),
                           alg.mul(alg.sub(one, E[i]), G[i]))
                   for i in range(32)])
        S0 = word([xor3(A[(i + 2) % 32], A[(i + 13) % 32], A[(i + 22) % 32])
                   for i in range(32)])
        Maj = word([alg.sub(
            alg.add(alg.add(alg.mul(A[i], B[i]), alg.mul(A[i], C[i])),
                    alg.mul(B[i], C[i])),
            alg.mul(two, alg.mul(alg.mul(A[i], B[i]), C[i])))
            for i in range(32)])
        T1 = alg.add(alg.add(alg.add(Hw, S1), alg.add(Ch, k_col)), W[0])
        T2 = alg.add(S0, Maj)
        pow32 = alg.constant(1 << 32)
        lhs_a = alg.add(word(An), alg.mul(pow32, word(CA)))
        out.append(gate(sel_round, alg.sub(lhs_a, alg.add(T1, T2))))
        lhs_e = alg.add(word(En), alg.mul(pow32, word(CE)))
        out.append(gate(sel_round, alg.sub(lhs_e, alg.add(Dw, T1))))
        # pipeline copies in blocked order (must match _transition_device's
        # constraint emission order — the α powers pair by index)
        for Xn, X in ((Bn, A), (Cn, B), (Fn, E), (Gn, F)):
            for i in range(32):
                out.append(gate(sel_round, alg.sub(Xn[i], X[i])))
        out.append(gate(sel_round, alg.sub(Dwn, word(C))))
        out.append(gate(sel_round, alg.sub(Hwn, word(G))))

        # --- schedule window ----------------------------------------------
        for k in range(1, 17):
            out.append(gate(sel_shift, alg.sub(Wn[k], W[k - 1])))
        out.append(gate(sel_wbits, alg.sub(word(WB2), W[2])))
        out.append(gate(sel_wbits, alg.sub(word(WB15), W[15])))
        zero = alg.constant(0)
        sig1 = word([xor3(WB2[(i + 17) % 32], WB2[(i + 19) % 32],
                          WB2[i + 10] if i + 10 < 32 else zero)
                     for i in range(32)])
        sig0 = word([xor3(WB15[(i + 7) % 32], WB15[(i + 18) % 32],
                          WB15[i + 3] if i + 3 < 32 else zero)
                     for i in range(32)])
        lhs_w = alg.add(W[0], alg.mul(pow32, word(CW)))
        rhs_w = alg.add(alg.add(sig1, W[7]), alg.add(sig0, W[16]))
        out.append(gate(sel_sched, alg.sub(lhs_w, rhs_w)))

        # --- chaining ------------------------------------------------------
        # H constant inside a section
        for i in range(8):
            out.append(gate(sel_hcopy, alg.sub(Hn[i], H[i])))
        # handoff (post-state row): next.H_i + carry·2^32 = H_i + state_i
        state_words = [word(A), word(B), word(C), Dw,
                       word(E), word(F), word(G), Hw]
        for i in range(8):
            lhs = alg.add(Hn[i], alg.mul(pow32, CH[i]))
            out.append(gate(sel_handoff,
                            alg.sub(lhs, alg.add(H[i], state_words[i]))))
        # section start: working state loads the chain value
        for i, sw in enumerate(state_words):
            out.append(gate(sel_secstart, alg.sub(sw, H[i])))

        # statement binding: message words stream into W0, the chain loads
        # the IV at message starts, the digest row pins the chain against
        # the preprocessed digest columns
        out.append(gate(consts[_CONST["sel_mload"]],
                        alg.sub(W[0], consts[_CONST["mword"]])))
        for i in range(8):
            out.append(gate(consts[_CONST["sel_msgstart"]],
                            alg.sub(H[i], alg.constant(_IV[i]))))
        for i in range(8):
            out.append(gate(consts[_CONST["sel_digest"]],
                            alg.sub(H[i], consts[_CONST[f"dig{i}"]])))

        return out

    def _transition_device(self, local, nxt, consts):
        """Stacked torch evaluation of the same constraints, in the same
        order: each bit family is one (32, N) tensor, rotations are
        `torch.roll` on the bit axis, word sums are one weighted field sum.
        A few hundred tensor ops in place of ~100k scalar ones."""
        add, sub, mul = gl.add, gl.sub, gl.mul
        dev = local[0].device

        def stack(cols, names):
            return torch.stack([cols[_COLS[nm]] for nm in names])

        def fam(cols, f):
            base = _COLS[f"{f}0"]
            return torch.stack(cols[base:base + 32])

        def xor3(x, y, z):
            s = add(add(x, y), z)
            p = add(add(mul(x, y), mul(y, z)), mul(z, x))
            return add(sub(s, mul(p, 2)), mul(mul(mul(x, y), z), 4))

        def roll(bits, n):
            # result bit i = input bit (i+n) % 32
            return torch.roll(bits, -n, 0)

        def shr(bits, n):
            # result bit i = input bit i+n (0 beyond 31)
            return torch.cat([bits[n:], torch.zeros_like(bits[:n])])

        sels = {nm: consts[_CONST[nm]] for nm in _CONST}
        out = []

        def gate(sel_name, expr):
            out.append(mul(sels[sel_name], expr))

        def gate_rows(sel_name, rows):
            out.extend(mul(rows, sels[sel_name][None]).unbind(0))

        A = fam(local, "A"); B = fam(local, "B"); C = fam(local, "C")
        E = fam(local, "E"); F = fam(local, "F"); G = fam(local, "G")
        An = fam(nxt, "A"); Bn = fam(nxt, "B"); Cn = fam(nxt, "C")
        En = fam(nxt, "E"); Fn = fam(nxt, "F"); Gn = fam(nxt, "G")
        Dw = local[_COLS["Dw"]]; Hw = local[_COLS["Hw"]]
        Dwn = nxt[_COLS["Dw"]]; Hwn = nxt[_COLS["Hw"]]
        W = [local[_COLS[f"W{k}"]] for k in range(17)]
        Wn = [nxt[_COLS[f"W{k}"]] for k in range(17)]
        WB2 = stack(local, [f"WB2_{i}" for i in range(32)])
        WB15 = stack(local, [f"WB15_{i}" for i in range(32)])
        CA = stack(local, [f"CA{i}" for i in range(3)])
        CE = stack(local, [f"CE{i}" for i in range(3)])
        CW = stack(local, [f"CW{i}" for i in range(2)])
        Hs = stack(local, [f"H{i}" for i in range(8)])
        Hns = stack(nxt, [f"H{i}" for i in range(8)])
        CH = stack(local, [f"CH{i}" for i in range(8)])

        # --- booleanity ----------------------------------------------------
        for sel_name, bits in (("sel_state", A), ("sel_state", B),
                               ("sel_state", C), ("sel_state", E),
                               ("sel_state", F), ("sel_state", G),
                               ("sel_wbits", WB2), ("sel_wbits", WB15),
                               ("sel_round", CA), ("sel_round", CE),
                               ("sel_schedule", CW), ("sel_handoff", CH)):
            gate_rows(sel_name, mul(bits, sub(bits, 1)))

        # --- round function ------------------------------------------------
        S1 = bit_word(xor3(roll(E, 6), roll(E, 11), roll(E, 25)))
        Ch = bit_word(add(mul(E, F), mul(sub(1, E), G)))
        S0 = bit_word(xor3(roll(A, 2), roll(A, 13), roll(A, 22)))
        AB = mul(A, B)
        Maj = bit_word(sub(add(add(AB, mul(A, C)), mul(B, C)),
                           mul(mul(AB, C), 2)))
        T1 = add(add(add(Hw, S1), add(Ch, sels["K"])), W[0])
        T2 = add(S0, Maj)
        lhs_a = add(bit_word(An), mul(bit_word(CA), 1 << 32))
        gate("sel_round", sub(lhs_a, add(T1, T2)))
        lhs_e = add(bit_word(En), mul(bit_word(CE), 1 << 32))
        gate("sel_round", sub(lhs_e, add(Dw, T1)))
        for Xn, X in ((Bn, A), (Cn, B), (Fn, E), (Gn, F)):
            gate_rows("sel_round", sub(Xn, X))
        gate("sel_round", sub(Dwn, bit_word(C)))
        gate("sel_round", sub(Hwn, bit_word(G)))

        # --- schedule window ----------------------------------------------
        for k in range(1, 17):
            gate("sel_shift", sub(Wn[k], W[k - 1]))
        gate("sel_wbits", sub(bit_word(WB2), W[2]))
        gate("sel_wbits", sub(bit_word(WB15), W[15]))
        sig1 = bit_word(xor3(roll(WB2, 17), roll(WB2, 19), shr(WB2, 10)))
        sig0 = bit_word(xor3(roll(WB15, 7), roll(WB15, 18), shr(WB15, 3)))
        lhs_w = add(W[0], mul(bit_word(CW), 1 << 32))
        rhs_w = add(add(sig1, W[7]), add(sig0, W[16]))
        gate("sel_schedule", sub(lhs_w, rhs_w))

        # --- chaining ------------------------------------------------------
        gate_rows("sel_hcopy", sub(Hns, Hs))
        sw = torch.stack([bit_word(A), bit_word(B), bit_word(C), Dw,
                          bit_word(E), bit_word(F), bit_word(G), Hw])
        gate_rows("sel_handoff", sub(add(Hns, mul(CH, 1 << 32)),
                                     add(Hs, sw)))
        gate_rows("sel_secstart", sub(sw, Hs))

        # --- statement binding (same emission order as the scalar path) ----
        gate("sel_mload", sub(W[0], sels["mword"]))
        iv = torch.tensor(_IV, dtype=torch.int64, device=dev)[:, None]
        gate_rows("sel_msgstart", sub(Hs, iv))
        dig = torch.stack([sels[f"dig{i}"] for i in range(8)])
        gate_rows("sel_digest", sub(Hs, dig))
        return out

    # -- witness ------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        with tracing.span("sha256_air.build_trace", rows=self.n):
            tr = np.zeros((WIDTH, self.n), dtype=np.uint64)
            for mi in range(len(self.messages)):
                self._build_message_trace(tr, mi)
            return tr

    def _build_message_trace(self, tr: np.ndarray, mi: int) -> None:
        """One message's sections, each written as whole-column slices."""
        c = _COLS
        section_w, section_states, chains = self._per_msg[mi]
        mbase = self.bases[mi]
        Kc = np.array(_K, dtype=np.uint64)
        for s in range(len(self.msg_blocks[mi])):
            base = mbase + s * SECTION
            w = np.array(section_w[s], dtype=np.uint64)              # (64,)
            st = np.array(section_states[s], dtype=np.uint64)        # (65, 8)
            chain = np.array(chains[s], dtype=np.uint64)
            # schedule window: W_k at row base+r holds w[r-k]
            for k in range(17):
                end = min(SECTION, k + 64)
                tr[c[f"W{k}"], base + k:base + end] = w[:end - k]
            # rows 16..63: bit views of w[r-2] and w[r-15], schedule carries
            rows = slice(base + 16, base + 64)
            tr[c["WB2_0"]:c["WB2_0"] + 32, rows] = _np_bits(w[14:62], 32)
            tr[c["WB15_0"]:c["WB15_0"] + 32, rows] = _np_bits(w[1:49], 32)
            total = _np_sig1(w[14:62]) + w[9:57] + _np_sig0(w[1:49]) \
                + w[0:48]
            tr[c["CW0"]:c["CW0"] + 2, rows] = _np_bits(
                total >> np.uint64(32), 2)
            # working state bits and words over the 65 rows
            for fi, f in ((0, "A"), (1, "B"), (2, "C"), (4, "E"), (5, "F"),
                          (6, "G")):
                tr[c[f"{f}0"]:c[f"{f}0"] + 32, base:base + SECTION] = \
                    _np_bits(st[:, fi], 32)
            tr[c["Dw"], base:base + SECTION] = st[:, 3]
            tr[c["Hw"], base:base + SECTION] = st[:, 7]
            # round carries over rows 0..63
            a, b, cc, d, e, f, g, h = (st[:64, i] for i in range(8))
            S1 = _np_rotr(e, 6) ^ _np_rotr(e, 11) ^ _np_rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1f = h + S1 + ch + Kc + w
            S0 = _np_rotr(a, 2) ^ _np_rotr(a, 13) ^ _np_rotr(a, 22)
            maj = (a & b) ^ (a & cc) ^ (b & cc)
            tr[c["CA0"]:c["CA0"] + 3, base:base + 64] = _np_bits(
                (t1f + S0 + maj) >> np.uint64(32), 3)
            tr[c["CE0"]:c["CE0"] + 3, base:base + 64] = _np_bits(
                (d + t1f) >> np.uint64(32), 3)
            # chain columns + feed-forward carries at the handoff row, and
            # the chain after the handoff (next section start / digest row)
            tr[c["H0"]:c["H0"] + 8, base:base + SECTION] = chain[:, None]
            tr[c["CH0"]:c["CH0"] + 8, base + 64] = \
                (chain + st[64]) >> np.uint64(32)
            tr[c["H0"]:c["H0"] + 8, base + SECTION] = np.array(
                chains[s + 1], dtype=np.uint64)


class Sha256CompressAir(Sha256Air):
    """One 64-byte block compressed from the IV, taken as already padded
    (the single-block compression entry point, `bind="consts"`, log_n 7)."""

    def __init__(self, block: bytes):
        assert len(block) == 64
        self.bind = "consts"
        self.messages = [block]
        self.msg_blocks = [[block]]
        self.bases = [0]
        self.total_rows = SECTION + 1
        self._log_n = 7
        Air.__init__(self, width=WIDTH, log_n=7, constraint_degree=4)
        self._run()
