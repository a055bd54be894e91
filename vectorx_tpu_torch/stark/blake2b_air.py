"""Blake2b-256 AIR: proves digest_i = Blake2b256(message_i) for a BATCH
of independent messages in one trace.

Port of `vectorx_tpu.stark.blake2b_air`, in both of its statement bindings
(`bind="consts"` and `bind="public"`, below).  The counterpart of the reference's curta Blake2b STARK — the
Avail header-hash gadget (`curta_blake2b_variable`,
upstream circuits/builder/header.rs:13-20).

Arithmetization — one HALF-ROUND per row (column phase / diagonal phase),
25-row section per 128-byte block:

* the 16-word working state v lives as 64 bit-columns per word (1024 bit
  columns); XORs are degree-2 bit polynomials and the G rotations
  (32/24/16/63) are free bit reindexings;
* each row runs 4 G functions; the per-G intermediate values a₁,d₁,c₁,b₁
  get their own bit columns (4·4·64 = 1024); the G outputs are the next
  row's state;
* 64-bit additions split into two 32-bit limb equations with 2-bit carry
  columns (sums stay ≪ p, so the integer equations are sound in GF(p));
* the chaining state h is 8×64 bit columns, copy-constrained through the
  section, initialized/finalized with XOR constraints (h' = h ⊕ v_low ⊕
  v_high at the handoff row);
* the 16 message words are 32 limb columns (copy-constrained within a
  section, pinned at each section-start row to preprocessed `mc` message
  columns); σ-routing is done with 0/1 selector-constant columns (part of
  the committed verification key), so each G's x/y operands are Σ_w sel·m_w;
* the block counter t and finalization flag are constants per section
  (the message length is public).

STATEMENT BINDING: messages and claimed digests live in preprocessed
columns (`mc*`, `dg*`, `sel_msgstart`, `sel_digest`) exactly as in
sha256_air — the verifier derives the constants commitment from the
statement itself, so a proof only verifies against the exact batch of
(message, digest) pairs it was built for.  With `bind="public"` only the
message lengths are in the constant columns: the mode gates `sel_mpin` /
`sel_dgpin` and the `mc*` / `dg*` columns are zero, and the message limbs
and digest limbs are public inputs pinned by boundary constraints to the
`M*` columns at each section start and the `DG*` columns at each digest
row.  The transition emits the same constraints in both modes.

The device twin (`_transition_device`) works on stacked bit matrices —
(1024, N) state bits, (4, 4, 64, N) intermediates, (4, 4, 4, N) carries —
and emits the scalar path's constraints in the scalar path's order.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark.air import Air, DeviceAlgebra, bit_word

SECTION = 25  # 24 half-rounds + post-state/handoff row

_IV = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]

# word quadruples per phase: column rows use (0,4,8,12).., diagonal rows
# use the rolled pattern
_COL_QUADS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
_DIAG_QUADS = [(0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]

M32 = 0xFFFFFFFF


def blake2b_pad(message: bytes) -> list[bytes]:
    """Zero-pad to whole 128-byte blocks (≥ 1 block, per Blake2b)."""
    blocks = []
    if not message:
        return [b"\x00" * 128]
    for i in range(0, len(message), 128):
        blk = message[i:i + 128]
        blocks.append(blk + b"\x00" * (128 - len(blk)))
    return blocks


# ---------------------------------------------------------------------------
# column layout
# ---------------------------------------------------------------------------

def _layout():
    names = []
    for w in range(16):                       # working state v, bits
        names += [f"V{w}_{i}" for i in range(64)]
    for g in range(4):                        # per-G intermediates, bits
        for nm in ("a1", "d1", "c1", "b1"):
            names += [f"I{g}{nm}_{i}" for i in range(64)]
    for w in range(8):                        # chain h, bits
        names += [f"H{w}_{i}" for i in range(64)]
    for w in range(16):                       # message limbs (lo, hi)
        names += [f"M{w}lo", f"M{w}hi"]
    # carries: per G, 4 adds × (lo 2 bits + hi 2 bits)
    for g in range(4):
        for add_i in range(4):
            names += [f"C{g}_{add_i}_{i}" for i in range(4)]
    # digest limbs as word columns (boundary-bindable in public mode)
    for w in range(4):
        names += [f"DG{w}lo", f"DG{w}hi"]
    return {n: i for i, n in enumerate(names)}


_COLS = _layout()
WIDTH = len(_COLS)

_CONST_NAMES = (["sel_col", "sel_diag", "sel_state", "sel_hcopy",
                 "sel_mcopy", "sel_init", "sel_final",
                 "v12init_lo", "v12init_hi", "v14init_lo", "v14init_hi",
                 # statement binding (batched statements live in the
                 # preprocessed columns — see sha256_air module docstring)
                 "sel_msgstart", "sel_digest",
                 # mode gates: = sel_init / sel_digest in bind="consts",
                 # zero in bind="public" (statement moves to boundaries)
                 "sel_mpin", "sel_dgpin"]
                + [f"mc{w}{p}" for w in range(16) for p in ("lo", "hi")]
                + [f"dg{w}{p}" for w in range(4) for p in ("lo", "hi")]
                + [f"sig{g}_{op}_{w}" for g in range(4) for op in (0, 1)
                   for w in range(16)])
_CONST = {n: i for i, n in enumerate(_CONST_NAMES)}
N_CONST = len(_CONST)

# parameterized IV (digest_size=32, no key) — the chain start of every message
_H0 = list(_IV)
_H0[0] ^= 0x01010000 ^ 32


def _as_messages(messages) -> list[bytes]:
    if isinstance(messages, (bytes, bytearray)):
        return [bytes(messages)]
    return [bytes(m) for m in messages]


def _vbits(cols, w):
    base = _COLS[f"V{w}_0"]
    return cols[base:base + 64]


def _ibits(cols, g, nm):
    base = _COLS[f"I{g}{nm}_0"]
    return cols[base:base + 64]


def _hbits(cols, w):
    base = _COLS[f"H{w}_0"]
    return cols[base:base + 64]


def _np_bits(x: np.ndarray, nbits: int) -> np.ndarray:
    """(..., L) uint64 -> (..., nbits, L) little-endian bits."""
    x = np.asarray(x, dtype=np.uint64)
    sh = np.arange(nbits, dtype=np.uint64)[:, None]
    return (x[..., None, :] >> sh) & np.uint64(1)


class Blake2bAir(Air):
    """Blake2b-256 (digest_size=32, no key) of a batch of messages.
    Pass a single `bytes` or a list of them; `bind` is "consts" (default)
    or "public", as for `Sha256Air`."""

    def __init__(self, messages, bind: str = "consts"):
        assert bind in ("consts", "public")
        self.bind = bind
        self.messages = _as_messages(messages)
        self._shape()
        super().__init__(width=WIDTH, log_n=self._log_n,
                         constraint_degree=4)
        self._run()

    @classmethod
    def public_shape(cls, msg_lens: list[int]) -> "Blake2bAir":
        """Verifier-side construction for bind="public": only the message
        lengths are statement data; the message limbs and digest limbs
        arrive through the public inputs (zero placeholders here)."""
        self = object.__new__(cls)
        self.bind = "public"
        # zero messages of the right lengths fix the shape (t counters,
        # section counts) without fixing any content
        self.messages = [b"\x00" * n for n in msg_lens]
        self._shape()
        Air.__init__(self, width=WIDTH, log_n=self._log_n,
                     constraint_degree=4)
        self.msg_digest_words = None
        self._per_msg = None
        return self

    def _shape(self):
        assert self.messages
        self.msg_blocks = [blake2b_pad(m) for m in self.messages]
        self.bases = []
        row = 0
        for blocks in self.msg_blocks:
            self.bases.append(row)
            row += SECTION * len(blocks) + 1   # sections + digest row
        self.total_rows = row
        # n ≥ total_rows + 1 keeps every digest row out of the masked
        # last transition row
        self._log_n = max(5, self.total_rows.bit_length())

    # -- reference computation / witness ------------------------------------

    @staticmethod
    def _rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & ((1 << 64) - 1)

    def _t_for(self, mi: int, s: int) -> int:
        """Byte counter after block s of message mi (Blake2b semantics:
        message length for the last block, 128·(s+1) otherwise)."""
        if s == len(self.msg_blocks[mi]) - 1:
            return len(self.messages[mi]) if self.messages[mi] else 0
        return 128 * (s + 1)

    def _run(self):
        self._per_msg = []   # per message: (rows, inters, carries, chains)
        self.msg_digest_words = []
        for mi in range(len(self.messages)):
            self._run_message(mi)
        self.digest_words = self.msg_digest_words[-1] \
            if len(self.messages) == 1 else None

    def _run_message(self, mi: int):
        M64 = (1 << 64) - 1
        h = list(_H0)
        chains = [list(h)]
        m_rows = []           # per section: list of 25 v-state snapshots
        m_inters = []         # per section: per row, per g, (a1,d1,c1,b1)
        m_carries = []        # per section: per row, per g, 4 (lo,hi)
        blocks = self.msg_blocks[mi]
        for s, blk in enumerate(blocks):
            m = [int.from_bytes(blk[8 * w:8 * w + 8], "little")
                 for w in range(16)]
            v = h[:8] + list(_IV)
            v[12] ^= self._t_for(mi, s) & M64
            if s == len(blocks) - 1:
                v[14] ^= M64
            states = [list(v)]
            inters = []
            carries = []

            def add64_with_carries(terms_rec):
                """terms: 64-bit ints; returns (sum mod 2^64, c_lo, c_hi)."""
                lo = sum(t & M32 for t in terms_rec)
                c_lo = lo >> 32
                hi = sum(t >> 32 for t in terms_rec) + c_lo
                c_hi = hi >> 32
                return ((hi & M32) << 32) | (lo & M32), c_lo, c_hi

            for hr in range(24):
                rnd = hr // 2
                quads = _COL_QUADS if hr % 2 == 0 else _DIAG_QUADS
                sig = _SIGMA[rnd]
                row_inters = []
                row_carries = []
                for g, (ia, ib, ic, id_) in enumerate(quads):
                    base = (0 if hr % 2 == 0 else 8) + 2 * g
                    x = m[sig[base]]
                    y = m[sig[base + 1]]
                    a, b, c, d = v[ia], v[ib], v[ic], v[id_]
                    a1, c0l, c0h = add64_with_carries([a, b, x])
                    d1 = self._rotr(d ^ a1, 32)
                    c1, c1l, c1h = add64_with_carries([c, d1])
                    b1 = self._rotr(b ^ c1, 24)
                    a2, c2l, c2h = add64_with_carries([a1, b1, y])
                    d2 = self._rotr(d1 ^ a2, 16)
                    c2, c3l, c3h = add64_with_carries([c1, d2])
                    b2 = self._rotr(b1 ^ c2, 63)
                    v[ia], v[ib], v[ic], v[id_] = a2, b2, c2, d2
                    row_inters.append((a1, d1, c1, b1))
                    row_carries.append(((c0l, c0h), (c1l, c1h),
                                        (c2l, c2h), (c3l, c3h)))
                states.append(list(v))
                inters.append(row_inters)
                carries.append(row_carries)
            h = [(hv ^ v[i] ^ v[i + 8]) for i, hv in enumerate(h)]
            chains.append(list(h))
            m_rows.append(states)
            m_inters.append(inters)
            m_carries.append(carries)
        self._per_msg.append((m_rows, m_inters, m_carries, chains))
        self.msg_digest_words.append(chains[-1][:4])

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

    def digest_bytes(self) -> bytes:
        assert len(self.messages) == 1
        return b"".join(int.to_bytes(x, 8, "little")
                        for x in self.msg_digest_words[0])

    def digest_bytes_list(self) -> list[bytes]:
        return [b"".join(int.to_bytes(x, 8, "little") for x in d)
                for d in self.msg_digest_words]

    @classmethod
    def statement(cls, messages, claimed_digests) -> "Blake2bAir":
        """Verifier-side statement: messages + claimed 32-byte digests,
        without computing any hash.  Accepts a single message + digest or
        parallel lists."""
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
        self.msg_digest_words = [
            [int.from_bytes(d[8 * i:8 * i + 8], "little") for i in range(4)]
            for d in claimed_digests]
        self._per_msg = None   # statement-only: no witness data
        return self

    # -- AIR interface ------------------------------------------------------

    def public_inputs(self):
        if self.bind == "public":
            # the message count, then per message 32 limbs (lo, hi) per
            # 128-byte block and its 8 digest limbs
            out = [len(self.messages)]
            for mi, blocks in enumerate(self.msg_blocks):
                for blk in blocks:
                    out += np.frombuffer(blk, dtype="<u4").tolist()
                if self.msg_digest_words is None:
                    out += [0] * 8
                    continue
                for dw in self.msg_digest_words[mi]:
                    out += [dw & M32, dw >> 32]
            return out
        # the statement lives in the preprocessed columns (see the
        # sha256_air module docstring); the constants cap binds it
        return [len(self.messages)]

    def constant_columns(self):
        cols = np.zeros((N_CONST, self.n), dtype=np.uint64)
        c = _CONST
        # per half-round: the phase selector and the σ-routing selectors
        hr_sel = np.zeros((N_CONST, 24), dtype=np.uint64)
        for hr in range(24):
            hr_sel[c["sel_col" if hr % 2 == 0 else "sel_diag"], hr] = 1
            sig = _SIGMA[hr // 2]
            off = 0 if hr % 2 == 0 else 8
            for g in range(4):
                hr_sel[c[f"sig{g}_0_{sig[off + 2 * g]}"], hr] = 1
                hr_sel[c[f"sig{g}_1_{sig[off + 2 * g + 1]}"], hr] = 1
        mc0 = c["mc0lo"]
        for mi, blocks in enumerate(self.msg_blocks):
            mbase = self.bases[mi]
            for s, blk in enumerate(blocks):
                base = mbase + s * SECTION
                cols[:, base:base + 24] = hr_sel
                cols[c["sel_state"], base:base + 25] = 1
                cols[c["sel_hcopy"], base:base + 24] = 1
                cols[c["sel_mcopy"], base:base + 24] = 1
                cols[c["sel_init"], base] = 1
                cols[c["sel_final"], base + 24] = 1
                # precomputed t/f-injected IV words for this section
                v12 = _IV[4] ^ self._t_for(mi, s)
                v14 = _IV[6] ^ ((1 << 64) - 1) if s == len(blocks) - 1 \
                    else _IV[6]
                cols[c["v12init_lo"], base] = v12 & M32
                cols[c["v12init_hi"], base] = v12 >> 32
                cols[c["v14init_lo"], base] = v14 & M32
                cols[c["v14init_hi"], base] = v14 >> 32
                if self.bind == "consts":
                    # statement: the section's message limbs, bound to the
                    # M witness columns at the section-start row
                    cols[c["sel_mpin"], base] = 1
                    cols[mc0:mc0 + 32, base] = np.frombuffer(blk,
                                                             dtype="<u4")
            cols[c["sel_msgstart"], mbase] = 1
            drow = mbase + SECTION * len(blocks)
            cols[c["sel_digest"], drow] = 1
            if self.bind == "consts":
                cols[c["sel_dgpin"], drow] = 1
                for w in range(4):
                    dw = self.msg_digest_words[mi][w]
                    cols[c[f"dg{w}lo"], drow] = dw & M32
                    cols[c[f"dg{w}hi"], drow] = dw >> 32
        return cols

    def boundaries(self, public):
        """bind="public": each section's 32 message limbs on the `M*`
        columns at its first row, each message's 8 digest limbs on the
        `DG*` columns at its digest row (public[0] is the message count)."""
        if self.bind != "public":
            return []
        out = []
        idx = 1
        m_cols = [_COLS[f"M{w}{p}"] for w in range(16) for p in ("lo", "hi")]
        dg_cols = [_COLS[f"DG{w}{p}"] for w in range(4) for p in ("lo", "hi")]
        for mi, blocks in enumerate(self.msg_blocks):
            mbase = self.bases[mi]
            for si in range(len(blocks)):
                for col in m_cols:
                    out.append((mbase + si * SECTION, col, public[idx]))
                    idx += 1
            drow = mbase + SECTION * len(blocks)
            for col in dg_cols:
                out.append((drow, col, public[idx]))
                idx += 1
        return out

    # The transition is generated and shared by the scalar (verifier) and
    # device (prover) paths; the device path is a stacked re-emission of the
    # SAME constraints in the SAME order.
    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        one = alg.constant(1)
        two = alg.constant(2)

        def word32(bits):
            acc = None
            for i, b in enumerate(bits):
                t = alg.mul(alg.constant(1 << i), b)
                acc = t if acc is None else alg.add(acc, t)
            return acc

        def xor2(x, y):
            return alg.sub(alg.add(x, y), alg.mul(two, alg.mul(x, y)))

        sel_col = consts[_CONST["sel_col"]]
        sel_diag = consts[_CONST["sel_diag"]]
        sel_state = consts[_CONST["sel_state"]]
        sel_hcopy = consts[_CONST["sel_hcopy"]]
        sel_mcopy = consts[_CONST["sel_mcopy"]]
        sel_init = consts[_CONST["sel_init"]]
        sel_final = consts[_CONST["sel_final"]]
        sel_round = alg.add(sel_col, sel_diag)

        out = []

        def gate(sel, e):
            out.append(alg.mul(sel, e))

        # booleanity
        for w in range(16):
            for b in _vbits(local, w):
                gate(sel_state, alg.mul(b, alg.sub(b, one)))
        for g in range(4):
            for nm in ("a1", "d1", "c1", "b1"):
                for b in _ibits(local, g, nm):
                    gate(sel_round, alg.mul(b, alg.sub(b, one)))
        for w in range(8):
            for b in _hbits(local, w):
                gate(sel_state, alg.mul(b, alg.sub(b, one)))
        for g in range(4):
            for add_i in range(4):
                for i in range(4):
                    b = local[_COLS[f"C{g}_{add_i}_{i}"]]
                    gate(sel_round, alg.mul(b, alg.sub(b, one)))

        # copies: h and m constant within a section
        for w in range(8):
            hb = _hbits(local, w)
            hbn = _hbits(nxt, w)
            for i in range(64):
                gate(sel_hcopy, alg.sub(hbn[i], hb[i]))
        for w in range(16):
            gate(sel_mcopy, alg.sub(nxt[_COLS[f"M{w}lo"]],
                                    local[_COLS[f"M{w}lo"]]))
            gate(sel_mcopy, alg.sub(nxt[_COLS[f"M{w}hi"]],
                                    local[_COLS[f"M{w}hi"]]))

        # G functions for both phases
        def add64_eqs(sel, out_bits, in_terms_lo, in_terms_hi, g, add_i):
            """out + carries·2^32 = inputs, limb-wise."""
            c_lo = [local[_COLS[f"C{g}_{add_i}_{i}"]] for i in range(2)]
            c_hi = [local[_COLS[f"C{g}_{add_i}_{i}"]] for i in range(2, 4)]
            carry_lo = alg.add(c_lo[0], alg.mul(two, c_lo[1]))
            carry_hi = alg.add(c_hi[0], alg.mul(two, c_hi[1]))
            lo_out = word32(out_bits[:32])
            hi_out = word32(out_bits[32:])
            lhs_lo = alg.add(lo_out, alg.mul(alg.constant(1 << 32), carry_lo))
            rhs_lo = in_terms_lo[0]
            for t in in_terms_lo[1:]:
                rhs_lo = alg.add(rhs_lo, t)
            gate(sel, alg.sub(lhs_lo, rhs_lo))
            lhs_hi = alg.add(hi_out, alg.mul(alg.constant(1 << 32), carry_hi))
            rhs_hi = in_terms_hi[0]
            for t in in_terms_hi[1:]:
                rhs_hi = alg.add(rhs_hi, t)
            rhs_hi = alg.add(rhs_hi, carry_lo)
            gate(sel, alg.sub(lhs_hi, rhs_hi))

        def xor_rot_eqs(sel, out_bits, xa, xb, rot):
            """out = rotr(xa ⊕ xb, rot):  out_i = xa_{(i+rot)%64} ⊕ xb_…"""
            for i in range(64):
                j = (i + rot) % 64
                gate(sel, alg.sub(out_bits[i], xor2(xa[j], xb[j])))

        def msg_operand(g, op):
            lo = None
            hi = None
            for w in range(16):
                sel = consts[_CONST[f"sig{g}_{op}_{w}"]]
                tl = alg.mul(sel, local[_COLS[f"M{w}lo"]])
                th = alg.mul(sel, local[_COLS[f"M{w}hi"]])
                lo = tl if lo is None else alg.add(lo, tl)
                hi = th if hi is None else alg.add(hi, th)
            return lo, hi

        # Blocked emission order (step-major, then g) so the vectorized
        # device path can stack the 4 G's of each step into one pass.
        for phase, quads, sel in ((0, _COL_QUADS, sel_col),
                                  (1, _DIAG_QUADS, sel_diag)):
            gvars = []
            for g, (ia, ib, ic, id_) in enumerate(quads):
                gvars.append(dict(
                    A=_vbits(local, ia), B=_vbits(local, ib),
                    C=_vbits(local, ic), D=_vbits(local, id_),
                    An=_vbits(nxt, ia), Bn=_vbits(nxt, ib),
                    Cn=_vbits(nxt, ic), Dn=_vbits(nxt, id_),
                    a1=_ibits(local, g, "a1"), d1=_ibits(local, g, "d1"),
                    c1=_ibits(local, g, "c1"), b1=_ibits(local, g, "b1"),
                    mx=msg_operand(g, 0), my=msg_operand(g, 1)))
            for g, v in enumerate(gvars):   # a1 = a + b + x
                add64_eqs(sel, v["a1"],
                          [word32(v["A"][:32]), word32(v["B"][:32]),
                           v["mx"][0]],
                          [word32(v["A"][32:]), word32(v["B"][32:]),
                           v["mx"][1]], g, 0)
            for g, v in enumerate(gvars):   # d1 = rotr32(d ^ a1)
                xor_rot_eqs(sel, v["d1"], v["D"], v["a1"], 32)
            for g, v in enumerate(gvars):   # c1 = c + d1
                add64_eqs(sel, v["c1"],
                          [word32(v["C"][:32]), word32(v["d1"][:32])],
                          [word32(v["C"][32:]), word32(v["d1"][32:])], g, 1)
            for g, v in enumerate(gvars):   # b1 = rotr24(b ^ c1)
                xor_rot_eqs(sel, v["b1"], v["B"], v["c1"], 24)
            for g, v in enumerate(gvars):   # a2 = a1 + b1 + y
                add64_eqs(sel, v["An"],
                          [word32(v["a1"][:32]), word32(v["b1"][:32]),
                           v["my"][0]],
                          [word32(v["a1"][32:]), word32(v["b1"][32:]),
                           v["my"][1]], g, 2)
            for g, v in enumerate(gvars):   # d2 = rotr16(d1 ^ a2)
                xor_rot_eqs(sel, v["Dn"], v["d1"], v["An"], 16)
            for g, v in enumerate(gvars):   # c2 = c1 + d2
                add64_eqs(sel, v["Cn"],
                          [word32(v["c1"][:32]), word32(v["Dn"][:32])],
                          [word32(v["c1"][32:]), word32(v["Dn"][32:])], g, 3)
            for g, v in enumerate(gvars):   # b2 = rotr63(b1 ^ c2)
                xor_rot_eqs(sel, v["Bn"], v["b1"], v["Cn"], 63)

        # section init: v = h[0..8] ++ IV with t/f injections (at the
        # section-start row, the v columns themselves must match)
        for w in range(8):
            hb = _hbits(local, w)
            vb = _vbits(local, w)
            for i in range(64):
                gate(sel_init, alg.sub(vb[i], hb[i]))
        for w in range(8, 16):
            vb = _vbits(local, w)
            iv = _IV[w - 8]
            if w == 12:
                # the t-injected word is a per-section preprocessed constant
                gate(sel_init, alg.sub(word32(vb[:32]),
                                       consts[_CONST["v12init_lo"]]))
                gate(sel_init, alg.sub(word32(vb[32:]),
                                       consts[_CONST["v12init_hi"]]))
            elif w == 14:
                gate(sel_init, alg.sub(word32(vb[:32]),
                                       consts[_CONST["v14init_lo"]]))
                gate(sel_init, alg.sub(word32(vb[32:]),
                                       consts[_CONST["v14init_hi"]]))
            else:
                for i in range(64):
                    gate(sel_init, alg.sub(vb[i],
                                           alg.constant((iv >> i) & 1)))

        # handoff: next.h = h ⊕ v_low ⊕ v_high (degree-3 xor3 expansion so
        # the gated constraint stays within the degree-4 budget)
        def xor3(x, y, z):
            s = alg.add(alg.add(x, y), z)
            p = alg.add(alg.add(alg.mul(x, y), alg.mul(y, z)),
                        alg.mul(z, x))
            xyz = alg.mul(alg.mul(x, y), z)
            return alg.add(alg.sub(s, alg.mul(two, p)),
                           alg.mul(alg.constant(4), xyz))

        for w in range(8):
            hb = _hbits(local, w)
            hbn = _hbits(nxt, w)
            vlo = _vbits(local, w)
            vhi = _vbits(local, w + 8)
            for i in range(64):
                gate(sel_final,
                     alg.sub(hbn[i], xor3(hb[i], vlo[i], vhi[i])))

        # statement binding (mirrored bit-for-bit by the device path):
        # message limbs pin to the preprocessed mc columns at each section
        # start, the chain loads the parameterized IV at message starts,
        # and the digest row pins the first 4 chain words to dg columns
        sel_mpin = consts[_CONST["sel_mpin"]]
        for w in range(16):
            gate(sel_mpin, alg.sub(local[_COLS[f"M{w}lo"]],
                                   consts[_CONST[f"mc{w}lo"]]))
            gate(sel_mpin, alg.sub(local[_COLS[f"M{w}hi"]],
                                   consts[_CONST[f"mc{w}hi"]]))
        sel_msgstart = consts[_CONST["sel_msgstart"]]
        for w in range(8):
            hb = _hbits(local, w)
            for i in range(64):
                gate(sel_msgstart,
                     alg.sub(hb[i], alg.constant((_H0[w] >> i) & 1)))
        sel_digest = consts[_CONST["sel_digest"]]
        sel_dgpin = consts[_CONST["sel_dgpin"]]
        for w in range(4):
            hb = _hbits(local, w)
            gate(sel_dgpin, alg.sub(word32(hb[:32]),
                                    consts[_CONST[f"dg{w}lo"]]))
            gate(sel_dgpin, alg.sub(word32(hb[32:]),
                                    consts[_CONST[f"dg{w}hi"]]))
        # digest-limb word columns (boundary-bindable in public mode)
        for w in range(4):
            hb = _hbits(local, w)
            gate(sel_digest, alg.sub(local[_COLS[f"DG{w}lo"]],
                                     word32(hb[:32])))
            gate(sel_digest, alg.sub(local[_COLS[f"DG{w}hi"]],
                                     word32(hb[32:])))

        return out

    def _transition_device(self, local, nxt, consts):
        """Stacked torch evaluation — identical constraints and emission
        order to the scalar path, stacked over bit/G axes (the scalar graph
        is ~100k ops; this is a few hundred tensor ops)."""
        add, sub, mul = gl.add, gl.sub, gl.mul
        dev = local[0].device
        N = local[0].shape[-1]
        c = _COLS

        def rows(cols, start, count):
            return torch.stack(cols[start:start + count])

        def xor2(x, y):
            return sub(add(x, y), mul(mul(x, y), 2))

        def xor3(x, y, z):
            s = add(add(x, y), z)
            p = add(add(mul(x, y), mul(y, z)), mul(z, x))
            return add(sub(s, mul(p, 2)), mul(mul(mul(x, y), z), 4))

        def bits_const(word, nbits=64):
            return torch.tensor([(word >> i) & 1 for i in range(nbits)],
                                dtype=torch.int64, device=dev)[:, None]

        sels = {nm: consts[_CONST[nm]] for nm in
                ("sel_col", "sel_diag", "sel_state", "sel_hcopy",
                 "sel_mcopy", "sel_init", "sel_final", "sel_mpin",
                 "sel_msgstart", "sel_digest", "sel_dgpin")}
        sel_round = add(sels["sel_col"], sels["sel_diag"])
        out = []

        def gate_rows(sel, e):
            """Gate a stacked (k, N) expression; append its k constraints."""
            out.extend(mul(e, sel[None]).unbind(0))

        def booleanity(sel, b):
            gate_rows(sel, mul(b, sub(b, 1)))

        V = rows(local, c["V0_0"], 1024)
        I = rows(local, c["I0a1_0"], 1024)
        Hb = rows(local, c["H0_0"], 512)
        Hbn = rows(nxt, c["H0_0"], 512)
        Cb = rows(local, c["C0_0_0"], 64)
        M = rows(local, c["M0lo"], 32)

        # --- booleanity (same family order as the scalar path) -------------
        booleanity(sels["sel_state"], V)
        booleanity(sel_round, I)
        booleanity(sels["sel_state"], Hb)
        booleanity(sel_round, Cb)

        # --- copies ---------------------------------------------------------
        gate_rows(sels["sel_hcopy"], sub(Hbn, Hb))
        gate_rows(sels["sel_mcopy"], sub(rows(nxt, c["M0lo"], 32), M))

        # --- G functions -----------------------------------------------------
        V = V.view(16, 64, N)
        Vn = rows(nxt, c["V0_0"], 1024).view(16, 64, N)
        I = I.view(4, 4, 64, N)                    # (g, a1/d1/c1/b1, bit)
        a1, d1, c1, b1 = I[:, 0], I[:, 1], I[:, 2], I[:, 3]
        Cb = Cb.view(4, 4, 4, N)                   # (g, add, carry bit)
        Mlo, Mhi = M[0::2], M[1::2]                # (16, N) each
        s0 = _CONST["sig0_0_0"]
        SIG = torch.stack(consts[s0:s0 + 128]).view(4, 2, 16, N)

        def operands(op):
            """(4, N) σ-routed message limbs (lo, hi) for operand op of
            each G: Σ_w sel_w·m_w."""
            sel = SIG[:, op]
            return (gl.field_sum(mul(sel, Mlo[None]), 1),
                    gl.field_sum(mul(sel, Mhi[None]), 1))

        def emit_add(sel, out_bits, lo_terms, hi_terms, add_i):
            """out + carries·2^32 = inputs, limb-wise; emitted per g as
            [g0_lo, g0_hi, g1_lo, ...] like the scalar loops."""
            cb = Cb[:, add_i]                      # (4, 4, N)
            c_lo = add(cb[:, 0], mul(cb[:, 1], 2))
            c_hi = add(cb[:, 2], mul(cb[:, 3], 2))
            lhs_lo = add(bit_word(out_bits[:, :32]), mul(c_lo, 1 << 32))
            lhs_hi = add(bit_word(out_bits[:, 32:]), mul(c_hi, 1 << 32))
            rhs_lo = lo_terms[0]
            for t in lo_terms[1:]:
                rhs_lo = add(rhs_lo, t)
            rhs_hi = hi_terms[0]
            for t in hi_terms[1:]:
                rhs_hi = add(rhs_hi, t)
            rhs_hi = add(rhs_hi, c_lo)
            e = torch.stack([mul(sub(lhs_lo, rhs_lo), sel),
                             mul(sub(lhs_hi, rhs_hi), sel)], dim=1)
            out.extend(e.reshape(8, N).unbind(0))

        def emit_xor_rot(sel, out_bits, xa, xb, rot):
            """out_i = xa_{(i+rot)%64} ⊕ xb_{(i+rot)%64}; emitted g-major,
            bit-minor like the scalar loops."""
            x = xor2(torch.roll(xa, -rot, 1), torch.roll(xb, -rot, 1))
            out.extend(mul(sub(out_bits, x), sel).reshape(256, N).unbind(0))

        def lo(x):
            return bit_word(x[:, :32])

        def hi(x):
            return bit_word(x[:, 32:])

        for quads, selname in ((_COL_QUADS, "sel_col"),
                               (_DIAG_QUADS, "sel_diag")):
            sel = sels[selname]
            ia, ib, ic, id_ = (list(q) for q in zip(*quads))
            A, B, C, D = V[ia], V[ib], V[ic], V[id_]
            An, Bn, Cn, Dn = Vn[ia], Vn[ib], Vn[ic], Vn[id_]
            mx, my = operands(0), operands(1)
            emit_add(sel, a1, [lo(A), lo(B), mx[0]], [hi(A), hi(B), mx[1]], 0)
            emit_xor_rot(sel, d1, D, a1, 32)
            emit_add(sel, c1, [lo(C), lo(d1)], [hi(C), hi(d1)], 1)
            emit_xor_rot(sel, b1, B, c1, 24)
            emit_add(sel, An, [lo(a1), lo(b1), my[0]],
                     [hi(a1), hi(b1), my[1]], 2)
            emit_xor_rot(sel, Dn, d1, An, 16)
            emit_add(sel, Cn, [lo(c1), lo(Dn)], [hi(c1), hi(Dn)], 3)
            emit_xor_rot(sel, Bn, b1, Cn, 63)

        # --- section init: v = h ++ IV with the t/f injections --------------
        sel_init = sels["sel_init"]
        Vlow = V[:8].reshape(512, N)
        gate_rows(sel_init, sub(Vlow, Hb))
        for w in range(8, 16):
            if w in (12, 14):
                name = f"v{w}init"
                out.append(mul(sel_init, sub(bit_word(V[w, :32]),
                                             consts[_CONST[name + "_lo"]])))
                out.append(mul(sel_init, sub(bit_word(V[w, 32:]),
                                             consts[_CONST[name + "_hi"]])))
            else:
                gate_rows(sel_init, sub(V[w], bits_const(_IV[w - 8])))

        # --- handoff: next.h = h ⊕ v_low ⊕ v_high ----------------------------
        gate_rows(sels["sel_final"],
                  sub(Hbn, xor3(Hb, Vlow, V[8:].reshape(512, N))))

        # --- statement binding (same emission order as the scalar path) ------
        mc0 = _CONST["mc0lo"]
        gate_rows(sels["sel_mpin"], sub(M, torch.stack(consts[mc0:mc0 + 32])))
        h0 = torch.cat([bits_const(_H0[w]) for w in range(8)])
        gate_rows(sels["sel_msgstart"], sub(Hb, h0))
        Hw = Hb.view(8, 64, N)
        hws = [(bit_word(Hw[w, :32]), bit_word(Hw[w, 32:])) for w in range(4)]
        for w in range(4):
            out.append(mul(sels["sel_dgpin"],
                           sub(hws[w][0], consts[_CONST[f"dg{w}lo"]])))
            out.append(mul(sels["sel_dgpin"],
                           sub(hws[w][1], consts[_CONST[f"dg{w}hi"]])))
        for w in range(4):
            out.append(mul(sels["sel_digest"],
                           sub(local[c[f"DG{w}lo"]], hws[w][0])))
            out.append(mul(sels["sel_digest"],
                           sub(local[c[f"DG{w}hi"]], hws[w][1])))
        return out

    # -- witness ------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        tr = np.zeros((WIDTH, self.n), dtype=np.uint64)
        for mi in range(len(self.messages)):
            self._build_message_trace(tr, mi)
        return tr

    def _build_message_trace(self, tr: np.ndarray, mi: int) -> None:
        """One message's sections, each written as whole-column slices."""
        c = _COLS
        m_rows, m_inters, m_carries, chains = self._per_msg[mi]
        mbase = self.bases[mi]
        blocks = self.msg_blocks[mi]
        for s, blk in enumerate(blocks):
            base = mbase + s * SECTION
            st = np.array(m_rows[s], dtype=np.uint64)          # (25, 16)
            inters = np.array(m_inters[s], dtype=np.uint64)    # (24, 4, 4)
            carries = np.array(m_carries[s], dtype=np.uint64)  # (24,4,4,2)
            chain = np.array(chains[s], dtype=np.uint64)       # (8,)
            rows = slice(base, base + SECTION)
            tr[c["V0_0"]:c["V0_0"] + 1024, rows] = \
                _np_bits(st.T, 64).reshape(1024, SECTION)
            tr[c["H0_0"]:c["H0_0"] + 512, rows] = \
                _np_bits(chain[:, None], 64).reshape(512, 1)
            tr[c["M0lo"]:c["M0lo"] + 32, rows] = \
                np.frombuffer(blk, dtype="<u4").astype(np.uint64)[:, None]
            # intermediates (g, a1/d1/c1/b1, bit) over the 24 round rows
            tr[c["I0a1_0"]:c["I0a1_0"] + 1024, base:base + 24] = \
                _np_bits(inters.transpose(1, 2, 0), 64).reshape(1024, 24)
            # carries (g, add, [lo bit 0, lo bit 1, hi bit 0, hi bit 1])
            cbits = _np_bits(carries.transpose(1, 2, 3, 0), 2)
            tr[c["C0_0_0"]:c["C0_0_0"] + 64, base:base + 24] = \
                cbits.reshape(64, 24)
        # chain value after the last handoff (the digest row)
        final_row = mbase + len(blocks) * SECTION
        last = np.array(chains[-1], dtype=np.uint64)
        tr[c["H0_0"]:c["H0_0"] + 512, final_row] = \
            _np_bits(last[:, None], 64).reshape(512)
        dg = np.stack([last[:4] & np.uint64(M32), last[:4] >> np.uint64(32)],
                      axis=1).reshape(8)
        tr[c["DG0lo"]:c["DG0lo"] + 8, final_row] = dg
