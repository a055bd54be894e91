"""Verifier-VM AIR: executes a shadow-verifier tape (ssa.py) as ONE wide
STARK trace, so that verifying many child proofs becomes a single proof.

Port of `vectorx_tpu.recursion.machine`.  Lowering (`compile_tape`), the
constant columns and the witness trace are host Python/numpy, as in the
reference; the constraints evaluate over the LDE domain as stacked torch
ops on the prover's device (`_transition_device`), in the order of the
scalar path the verifier runs.  Where plonky2x reduce circuits verify two
child proofs each across a log-depth tree of proofs, here the whole tree of
child verifications is ROWS of one machine trace.

Machine model — row families sharing one 28-column trace and an 8-port
LogUp memory bus (stark/air.py `BusPort`):

* FMA rows: up to TWO independent units per row, each computing
  out = A·B + C over GF(p²) where an operand is `coeff·bus_read + const`
  with program (preprocessed) coefficient and constant.  Unit 1 rides
  ports 0-3 (reads a,b,c + write out), unit 2 ports 4-7.  An `is_assert`
  flag forces a unit's out to 0.  The bus is a multiset argument, so
  unit 2 may read unit 1's same-row output (or vice versa) freely.
* Multi-write rows: publish up to 8 fresh witness values (proof
  elements, inverse hints) in one row — no compute constraint.  The
  `bits` variant additionally constrains every port value boolean.
* Poseidon slots (9 rows): stage row absorbs ≤8 bus values into the
  sponge lanes (keeping or zeroing the rest); four packed full-round-pair
  rows and two packed 11-partial-round rows run the permutation (sbox
  witnesses live on the next row's raw columns; partial blocks use
  precomputed affine propagation tables); the OUTW row publishes up to 8
  output lanes onto the bus.

All cross-row data flow rides the bus (order-independent multiset
argument), so program scheduling is free: Poseidon chains are laid out
contiguously after the FMA program regardless of tape interleaving.

The program (selectors, operand coefficients, bus addresses and
multiplicities) lives in 50 preprocessed columns — a pure function of the
child STATEMENT, never of the proof — so the machine's preprocessed
commitment is the verification key binding exactly "this trace verifies
those child statements".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from operator import mul

import numpy as np
import torch

from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.hash import poseidon as pv
from vectorx_tpu_torch.recursion import ssa
from vectorx_tpu_torch.stark.air import Air, BusPort, DeviceAlgebra

WIDTH = pv.WIDTH            # 12 Poseidon lanes
N_PORTS = 8
TRACE_W = WIDTH + 2 * N_PORTS   # 12 state + 8 ext port-value pairs = 28

# witness column indices
def _v0(p):
    return WIDTH + 2 * p


def _v1(p):
    return WIDTH + 2 * p + 1


# constant (preprocessed) column indices
C0 = 0                      # C0..C11: rc / absorb mask / FMA unit-1 payload
C2_0 = 12                   # C12..C23: FMA unit-2 payload (rc2 later)
SEL_FPACK = 24              # packed full-round pair (rounds a, a+1)
SEL_PA = 25                 # packed partial block, rounds 4..14
SEL_PB = 26                 # packed partial block, rounds 15..25
SEL_STAGE = 27
KEEP = 28
SEL_OUTW = 29
SEL_COPY = 30
SEL_FMA = 31
SEL_BIT = 32                # multi-write row of boolean witnesses
SEL_FMA2 = 33               # unit 2 active (ports 4-7)
ADDR0 = 34                  # ADDR0+p: port address
MULT0 = 34 + N_PORTS        # MULT0+p: port multiplicity
N_CONSTS = MULT0 + N_PORTS  # 50
# Layout version of the lowered program and its constant columns.  It
# salts every cache key derived from a program (the VK token, progcache
# keys), so a cache written under another layout is never served.
MACHINE_FORMAT_VERSION = 1

# FMA payload layout within a unit's 12-column block
FMA_CA = 0                  # +0, +1 = const of operand A (ext)
FMA_CB = 2
FMA_CC = 4
FMA_FA = 6                  # +6, +7, +8 = port coefficients (base)
FMA_FB = 7
FMA_FC = 8
FMA_ASSERT = 9              # +9 = is_assert flag

HALF = pv.FULL_ROUNDS // 2  # 4
# Packed Poseidon slot: [stage, F01, F23, PA, PB, F45, F67, OUTW, BUF].
# Each F row advances two full rounds (12 sbox witnesses on the next row's
# raw columns 12..23); each P row advances 11 partial rounds (11 lane-0
# sbox witnesses), using precomputed affine propagation tables.
SLOT_ROWS = 9
SB0 = WIDTH                 # raw witness column of sbox witness k = SB0+k
N_PARTIAL = (pv.PARTIAL_ROUNDS) // 2  # 11 per packed row


def _sbox_tables():
    """Affine propagation tables for the two packed partial blocks.

    For a block of 11 partial rounds starting at round `start`, over
    variables [S_0..S_11, v_0..v_10] (v_k = the round-k lane-0 sbox
    output): A[k] = (coeffs, const) with u_k[0] = A[k]·vars + const, and
    (O, Oc) with state-after-block = O·vars + Oc."""
    rc, mds = pv.int_params()
    NV = WIDTH + N_PARTIAL
    out = []
    for start in (HALF, HALF + N_PARTIAL):
        T = [[1 if i == j else 0 for j in range(NV)] for i in range(WIDTH)]
        Tc = [0] * WIDTH
        A = []
        for k in range(N_PARTIAL):
            rnd = start + k
            uc = [(Tc[i] + rc[rnd * WIDTH + i]) % P for i in range(WIDTH)]
            A.append((list(T[0]), uc[0]))
            rows = [list(T[i]) for i in range(WIDTH)]
            consts = list(uc)
            rows[0] = [0] * NV
            rows[0][WIDTH + k] = 1
            consts[0] = 0
            T = [[sum(mds[i][j] * rows[j][c] for j in range(WIDTH)) % P
                  for c in range(NV)] for i in range(WIDTH)]
            Tc = [sum(mds[i][j] * consts[j] for j in range(WIDTH)) % P
                  for i in range(WIDTH)]
        out.append((A, T, Tc))
    return out


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = _sbox_tables()
    return _TABLES


@dataclass
class _FmaRow:
    """One FMA/fresh row.  Operands: (coeff, addr, const) with addr=0 for
    a pure constant.  out_addr=0 means no bus write (pure assert)."""

    a: tuple = (0, 0, (0, 0))
    b: tuple = (0, 0, (0, 0))
    c: tuple = (0, 0, (0, 0))
    out_addr: int = 0
    is_assert: bool = False
    compute: bool = True     # False: fresh row (out unconstrained)
    is_bit: bool = False     # fresh row whose value is constrained boolean
    public_index: int = -1
    unit2: object = None     # second _FmaRow merged onto ports 4-7


@dataclass
class _MultiWrite:
    """Publish up to 8 fresh witness values via ports 0..7 in one row.
    `bits=True` constrains every port value boolean (sel_bit)."""

    out_addrs: list
    bits: bool = False


@dataclass
class _Slot:
    """One Poseidon duplex as a 32-row slot."""

    buf_addrs: list          # ≤8 machine addresses absorbed into lanes 0..
    keep: bool               # keep capacity/state lanes from previous slot
    out_addrs: list          # 8 addresses for output lanes 0..7 (0 = unused)
    chain_next: bool = False # next slot continues this sponge


@dataclass
class Program:
    """Lowered machine program + (in witness mode) the value assignment."""

    items: list                      # _FmaRow | _MultiWrite | _Slot
    n_rows: int
    reads: dict                      # machine addr -> read count
    publics: list                    # values in public-index order
    values: dict | None              # addr -> ext pair (witness mode only)
    witness: bool


class LoweringError(Exception):
    pass


def _row_count(item) -> int:
    return SLOT_ROWS if isinstance(item, _Slot) else 1


def _pack_items(items: list) -> list:
    """Post-pass: merge consecutive plain fresh rows (8 per row), bit rows
    (8 per row), and pair adjacent compute rows into dual-unit rows.  The
    bus is order-independent, so merging preserves semantics exactly."""
    out = []
    i = 0
    n = len(items)
    while i < n:
        it = items[i]
        if isinstance(it, _FmaRow) and not it.compute \
                and it.public_index < 0:
            run = []
            want_bits = it.is_bit
            while i < n and isinstance(items[i], _FmaRow) \
                    and not items[i].compute \
                    and items[i].public_index < 0 \
                    and items[i].is_bit == want_bits \
                    and len(run) < N_PORTS:
                run.append(items[i].out_addr)
                i += 1
            out.append(_MultiWrite(out_addrs=run, bits=want_bits))
            continue
        if isinstance(it, _FmaRow) and it.compute and it.unit2 is None \
                and i + 1 < n and isinstance(items[i + 1], _FmaRow) \
                and items[i + 1].compute and items[i + 1].unit2 is None:
            it.unit2 = items[i + 1]
            out.append(it)
            i += 2
            continue
        out.append(it)
        i += 1
    return out


class _Lowerer:
    """Turns an ssa.Builder tape into a machine Program.

    Deterministic function of the tape STRUCTURE: statement-mode and
    witness-mode tapes (which match node-for-node, see shadow.py) lower to
    the identical program; witness mode additionally computes the value of
    every machine address."""

    def __init__(self, builder):
        self.ssa = ssa
        self.b = builder
        self.witness = builder.witness
        self.items: list = []
        self.chains: list = []        # finished duplex chains (lists of _Slot)
        self.open_chain: dict = {}    # tape duplex node idx -> chain
        self.reads: dict = {}
        self.values: dict = {} if self.witness else None
        self.addr_of: dict = {}       # tape vid -> machine addr
        self.bit_addr: dict = {}      # BitRef -> machine addr
        self.publics: list = []
        self._next_addr = 1
        self._cap_addrs: set = set()

    # -- helpers -------------------------------------------------------------

    def _alloc(self, value=None) -> int:
        a = self._next_addr
        self._next_addr += 1
        if self.witness:
            assert value is not None
            self.values[a] = (value[0] % P, value[1] % P)
        return a

    def _alloc_stmt(self) -> int:
        a = self._next_addr
        self._next_addr += 1
        return a

    def _read(self, addr: int) -> int:
        self.reads[addr] = self.reads.get(addr, 0) + 1
        return addr

    def _val(self, addr: int):
        return self.values[addr] if self.witness else None

    def _emit(self, row: _FmaRow):
        # central read accounting: every port-read operand counts here
        if row.compute:
            for coeff, addr, _c in (row.a, row.b, row.c):
                if coeff and addr:
                    self._read(addr)
        self.items.append(row)

    def _operand(self, aff):
        """Lower an Affine to (coeff, addr, const); multi-term affines are
        folded into a chain of FMA rows first."""
        terms = [(self.addr_of[v], c) for v, c in aff.terms.items()]
        terms += [(self.bit_addr[r], c) for r, c in aff.bits.items()]
        const = (aff.const[0] % P, aff.const[1] % P)
        if not terms:
            return (0, 0, const)
        if len(terms) == 1:
            return (terms[0][1] % P, terms[0][0], const)

        # fold: t1 = c0·v0 + (c1·v1 + const); then t += ck·vk
        def term_val(addr, c):
            v = self.values[addr]
            return ((v[0] * c) % P, (v[1] * c) % P)

        (a0, c0), (a1, c1) = terms[0], terms[1]
        run = None
        if self.witness:
            run = ext_py.add(ext_py.add(term_val(a0, c0),
                                        term_val(a1, c1)), const)
        acc = self._alloc(run) if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(a=(c0 % P, a0, (0, 0)),
                           b=(0, 0, (1, 0)),
                           c=(c1 % P, a1, const),
                           out_addr=acc))
        for addr, c in terms[2:]:
            if self.witness:
                run = ext_py.add(run, term_val(addr, c))
            nxt = self._alloc(run) if self.witness else self._alloc_stmt()
            self._emit(_FmaRow(a=(c % P, addr, (0, 0)),
                               b=(0, 0, (1, 0)),
                               c=(1, acc, (0, 0)),
                               out_addr=nxt))
            acc = nxt
        return (1, acc, (0, 0))

    def _fresh_value(self, value) -> int:
        addr = self._alloc(value) if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(out_addr=addr, compute=False))
        return addr

    def _fresh_bit(self, value) -> int:
        """Fresh witness constrained boolean by the row itself."""
        addr = self._alloc(value) if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(out_addr=addr, compute=False, is_bit=True))
        return addr

    def _fma_row(self, a, b, c, out_value=None, is_assert=False):
        """Emit out = A·B + C (or assert A·B + C == 0)."""
        oa, ob, oc = self._operand(a), self._operand(b), self._operand(c)
        if is_assert:
            self._emit(_FmaRow(a=oa, b=ob, c=oc, is_assert=True))
            return 0
        addr = self._alloc(out_value) if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(a=oa, b=ob, c=oc, out_addr=addr))
        return addr

    # -- tape walk -----------------------------------------------------------

    def run(self) -> Program:
        ssa = self.ssa
        for idx, node in enumerate(self.b.nodes):
            if isinstance(node, ssa.Fresh):
                val = self.b.values.get(node.out) if self.witness else None
                if node.public_index >= 0:
                    # publics known in both modes (statement data)
                    val = self.b.values[node.out]
                    addr = self._alloc_public(val)
                    self._emit(_FmaRow(out_addr=addr, compute=False,
                                       public_index=node.public_index))
                    while len(self.publics) <= node.public_index:
                        self.publics.append(None)
                    self.publics[node.public_index] = val[0]
                else:
                    addr = self._fresh_value(val)
                self.addr_of[node.out] = addr
            elif isinstance(node, ssa.Fma):
                ov = self.b.values.get(node.out) if self.witness else None
                self.addr_of[node.out] = self._fma_row(
                    node.a, node.b, node.c, out_value=ov)
            elif isinstance(node, ssa.Assert):
                self._fma_row(node.a, node.b, node.c, is_assert=True)
            elif isinstance(node, ssa.Duplex):
                self._lower_duplex(idx, node)
            elif isinstance(node, ssa.BitDec):
                self._lower_bitdec(node)
            else:
                raise LoweringError(f"unknown tape node {type(node)}")
        items = _pack_items(self.items)
        # poseidon chains laid out after the FMA program
        for chain in self.chains:
            for k, slot in enumerate(chain):
                slot.chain_next = k + 1 < len(chain)
                items.append(slot)
        n_rows = sum(_row_count(it) for it in items)
        assert all(p is not None for p in self.publics), "public index gap"
        return Program(items=items, n_rows=n_rows, reads=self.reads,
                       publics=self.publics, values=self.values,
                       witness=self.witness)

    def _alloc_public(self, value) -> int:
        a = self._next_addr
        self._next_addr += 1
        if self.witness:
            self.values[a] = (value[0] % P, value[1] % P)
        return a

    def _lower_duplex(self, idx, node):
        buf_addrs = [self._read(self.addr_of[v]) for v in node.buf]
        out_addrs = []
        for lane, vid in enumerate(node.outs):
            if self.witness:
                addr = self._alloc(self.b.values[vid])
            else:
                addr = self._alloc_stmt()
            self.addr_of[vid] = addr
            out_addrs.append(addr)
        slot = _Slot(buf_addrs=buf_addrs, keep=node.keep_state,
                     out_addrs=out_addrs[:N_PORTS])
        # lanes 8..11 are capacity: consumers must never read them off the
        # bus (they flow to the next slot through the state columns)
        self._cap_addrs.update(out_addrs[N_PORTS:])
        if node.keep_state:
            if node.prev < 0 or node.prev not in self.open_chain:
                raise LoweringError("keep_state duplex without live prev")
            chain = self.open_chain.pop(node.prev)
            chain.append(slot)
        else:
            chain = [slot]
            self.chains.append(chain)
        self.open_chain[idx] = chain

    def _lower_bitdec(self, node):
        xaddr = self.addr_of[node.x]
        xval = self._val(xaddr)
        nbits = node.nbits
        bit_addrs = []
        for i in range(nbits):
            bv = ((xval[0] >> i) & 1) if self.witness else None
            addr = self._fresh_bit((bv, 0) if self.witness else None)
            self.bit_addr[self.ssa.BitRef(node=node.node, index=i)] = addr
            bit_addrs.append(addr)
        acc = self._recompose(bit_addrs)
        # Σ 2^i·b_i == x
        self._emit(_FmaRow(a=(1, acc, (0, 0)),
                           b=(0, 0, (1, 0)),
                           c=(P - 1, xaddr, (0, 0)),
                           is_assert=True))
        if node.canonical:
            if nbits != 64:
                raise LoweringError("canonical bitdec requires 64 bits")
            self._canonical_check(bit_addrs)

    def _recompose(self, bit_addrs) -> int:
        """Machine addr holding Σ_i 2^i · bits[i] (weights relative to the
        slice: bit_addrs[0] has weight 1)."""
        assert len(bit_addrs) >= 2
        run = None
        if self.witness:
            run = (self.values[bit_addrs[0]][0]
                   + 2 * self.values[bit_addrs[1]][0]) % P
        acc = self._alloc((run, 0) if self.witness else None) \
            if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(a=(1, bit_addrs[0], (0, 0)),
                           b=(0, 0, (1, 0)),
                           c=(2, bit_addrs[1], (0, 0)),
                           out_addr=acc))
        for i, a in enumerate(bit_addrs[2:], start=2):
            w = pow(2, i, P)
            if self.witness:
                run = (run + w * self.values[a][0]) % P
            nxt = self._alloc((run, 0)) if self.witness \
                else self._alloc_stmt()
            self._emit(_FmaRow(a=(w, a, (0, 0)),
                               b=(0, 0, (1, 0)),
                               c=(1, acc, (0, 0)),
                               out_addr=nxt))
            acc = nxt
        return acc

    def _canonical_check(self, bit_addrs):
        """x < P for a 64-bit decomposition: if hi32 == 2^32−1 then lo32
        must be 0 (P − 1 = (2^32−1)·2^32)."""
        hi = self._recompose(bit_addrs[32:])
        lo = self._recompose(bit_addrs[:32])
        full = (1 << 32) - 1
        dval = None
        if self.witness:
            dval = ((self.values[hi][0] - full) % P, 0)
        diff = self._alloc(dval) if self.witness else self._alloc_stmt()
        self._emit(_FmaRow(a=(1, hi, (0, 0)),
                           b=(0, 0, (1, 0)),
                           c=(0, 0, ((P - full) % P, 0)),
                           out_addr=diff))
        zval = wval = None
        if self.witness:
            zval = (1, 0) if dval[0] == 0 else (0, 0)
            wval = (0, 0) if dval[0] == 0 else (pow(dval[0], P - 2, P), 0)
        z = self._fresh_bit(zval)
        winv = self._fresh_value(wval)
        # winv·diff + z − 1 == 0  (z=0 ⟹ diff invertible ⟹ hi ≠ 2^32−1)
        self._emit(_FmaRow(a=(1, winv, (0, 0)),
                           b=(1, diff, (0, 0)),
                           c=(1, z, (P - 1, 0)),
                           is_assert=True))
        # z·lo == 0  (hi all-ones forces lo = 0)
        self._emit(_FmaRow(a=(1, z, (0, 0)),
                           b=(1, lo, (0, 0)),
                           c=(0, 0, (0, 0)),
                           is_assert=True))


def compile_tape(builder) -> Program:
    """Lower an ssa tape to a machine program (+ values in witness mode)."""
    low = _Lowerer(builder)
    prog = low.run()
    # capacity lanes must never be bus-read
    for a in low._cap_addrs:
        if prog.reads.get(a):
            raise LoweringError("capacity lane consumed off the bus")
    return prog


def _unit_cols(cols, base, r, row: _FmaRow, reads, addr_base, mult_base):
    """Fill one FMA unit's payload + its 3 read ports and write port."""
    (fa, aa, ca), (fb, ab, cb), (fc, ac, cc) = row.a, row.b, row.c
    cols[base + FMA_CA, r] = ca[0]
    cols[base + FMA_CA + 1, r] = ca[1]
    cols[base + FMA_CB, r] = cb[0]
    cols[base + FMA_CB + 1, r] = cb[1]
    cols[base + FMA_CC, r] = cc[0]
    cols[base + FMA_CC + 1, r] = cc[1]
    cols[base + FMA_FA, r] = fa
    cols[base + FMA_FB, r] = fb
    cols[base + FMA_FC, r] = fc
    cols[base + FMA_ASSERT, r] = 1 if row.is_assert else 0
    for p, (coeff, addr, _c) in enumerate((row.a, row.b, row.c)):
        if coeff and addr:
            cols[addr_base + p, r] = addr
            cols[mult_base + p, r] = P - 1      # read
    if row.out_addr and reads.get(row.out_addr, 0):
        cols[addr_base + 3, r] = row.out_addr
        cols[mult_base + 3, r] = reads[row.out_addr]  # write


class MachineAir(Air):
    """The verifier-VM AIR for one lowered program.

    It stands in for plonky2x's reduce nodes, each of which verifies two
    child proofs in-circuit."""

    def __init__(self, program: Program):
        rows = program.n_rows
        # n ≥ rows + 1: the last row must stay free of ports/boundaries
        log_n = max(6, rows.bit_length())
        super().__init__(width=TRACE_W, log_n=log_n, constraint_degree=8)
        self.program = program
        self._rc, self._mds = pv.int_params()
        self._consts = None
        self._publics = [int(v) % P for v in program.publics]

    # -- Air interface -------------------------------------------------------

    def public_inputs(self):
        return list(self._publics)

    def bus_ports(self):
        return [BusPort(value_cols=(_v0(p), _v1(p)),
                        addr_col=ADDR0 + p, mult_col=MULT0 + p)
                for p in range(N_PORTS)]

    def num_constants(self) -> int:
        # fixed machine layout: the verifier learns K without the O(n)
        # host build of the columns themselves (stark/verifier.py)
        return N_CONSTS

    def vk_token(self):
        """VK-cache token (stark/vk.py): the program's content-address key
        from recursion/progcache.py, when it has one.  The key hashes the
        statement + FRI config the program was derived from, and the
        constant columns are a pure function of the program (n_rows pins
        log_n) and of the layout (MACHINE_FORMAT_VERSION), so the token
        uniquely determines the columns."""
        k = getattr(self.program, "_stmt_key", None)
        return None if k is None else \
            ("mprog", MACHINE_FORMAT_VERSION, k, self.log_n)

    def constant_columns(self):
        if self._consts is not None:
            return self._consts
        # The row loop below is host Python over every program row — tens
        # of seconds at flagship scale (2^21 rows).  The columns are a
        # pure function of the program, and verifiers build a fresh
        # MachineAir per verification around the progcache-shared Program
        # (recursion/progcache.py), so memoize on the Program object:
        # repeat verifications (gateway steady state, tamper checks) skip
        # the rebuild entirely.
        cached = getattr(self.program, "_consts_cache", None)
        if cached is not None:
            self._consts = cached
            return cached
        n = self.n
        cols = np.zeros((N_CONSTS, n), dtype=np.uint64)
        r = 0
        reads = self.program.reads
        for it in self.program.items:
            if isinstance(it, _FmaRow):
                if it.compute:
                    cols[SEL_FMA, r] = 1
                    _unit_cols(cols, C0, r, it, reads, ADDR0, MULT0)
                    if it.unit2 is not None:
                        cols[SEL_FMA2, r] = 1
                        _unit_cols(cols, C2_0, r, it.unit2, reads,
                                   ADDR0 + 4, MULT0 + 4)
                elif it.out_addr and reads.get(it.out_addr, 0) or \
                        it.public_index >= 0:
                    # solo fresh/public row: write port 3
                    if reads.get(it.out_addr, 0):
                        cols[ADDR0 + 3, r] = it.out_addr
                        cols[MULT0 + 3, r] = reads[it.out_addr]
                r += 1
            elif isinstance(it, _MultiWrite):
                if it.bits:
                    cols[SEL_BIT, r] = 1
                for p, addr in enumerate(it.out_addrs):
                    if addr and reads.get(addr, 0):
                        cols[ADDR0 + p, r] = addr
                        cols[MULT0 + p, r] = reads[addr]
                r += 1
            else:  # _Slot: [stage, F01, F23, PA, PB, F45, F67, OUTW, BUF]
                base = r
                cols[SEL_STAGE, base] = 1
                cols[KEEP, base] = 1 if it.keep else 0
                for lane, addr in enumerate(it.buf_addrs):
                    cols[C0 + lane, base] = 1                # absorb mask
                    cols[ADDR0 + lane, base] = addr
                    cols[MULT0 + lane, base] = P - 1         # read
                # full-pack rows: rc of round a in C0.., of round a+1 in C2_0..
                for fi, a in enumerate((0, 2, 26, 28)):
                    rr = base + (1, 2, 5, 6)[fi]
                    cols[SEL_FPACK, rr] = 1
                    for j in range(WIDTH):
                        cols[C0 + j, rr] = self._rc[a * WIDTH + j]
                        cols[C2_0 + j, rr] = self._rc[(a + 1) * WIDTH + j]
                cols[SEL_PA, base + 3] = 1
                cols[SEL_PB, base + 4] = 1
                outw = base + 7
                cols[SEL_OUTW, outw] = 1
                for p, addr in enumerate(it.out_addrs):
                    if addr and reads.get(addr, 0):
                        cols[ADDR0 + p, outw] = addr
                        cols[MULT0 + p, outw] = reads[addr]  # write
                if it.chain_next:
                    cols[SEL_COPY, base + 7] = 1
                    cols[SEL_COPY, base + 8] = 1
                r += SLOT_ROWS
        assert r == self.program.n_rows
        self.program._consts_cache = cols
        self._consts = cols
        return cols

    def boundaries(self, public):
        out = []
        r = 0
        for it in self.program.items:
            if isinstance(it, _FmaRow):
                if it.public_index >= 0:
                    out.append((r + 1, _v0(3), public[it.public_index]))
                    out.append((r + 1, _v1(3), 0))
                r += 1
            elif isinstance(it, _MultiWrite):
                r += 1
            else:
                r += SLOT_ROWS
        return out

    # -- constraints ----------------------------------------------------------

    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        W_EXT = 7  # x² = 7 (field/extension.py)
        S = local[:WIDTH]
        Sn = nxt[:WIDTH]
        rc1 = consts[C0:C0 + WIDTH]
        rc2 = consts[C2_0:C2_0 + WIDTH]
        sel_f = consts[SEL_FPACK]
        sel_pa, sel_pb = consts[SEL_PA], consts[SEL_PB]
        sel_stage, keep = consts[SEL_STAGE], consts[KEEP]
        sel_outw, sel_copy = consts[SEL_OUTW], consts[SEL_COPY]
        sel_fma, sel_fma2 = consts[SEL_FMA], consts[SEL_FMA2]
        sel_bit = consts[SEL_BIT]
        one = alg.constant(1)
        SBn = [nxt[SB0 + k] for k in range(WIDTH)]  # sbox witnesses

        def pow7(x):
            x2 = alg.mul(x, x)
            x4 = alg.mul(x2, x2)
            return alg.mul(alg.mul(x4, x2), x)

        def mds_row(i, vals):
            acc = None
            for j in range(WIDTH):
                t = alg.mul(alg.constant(self._mds[i][j]), vals[j])
                acc = t if acc is None else alg.add(acc, t)
            return acc

        # full-pack: round a sbox witnesses SBn; round a+1 inline
        u7 = [pow7(alg.add(S[j], rc1[j])) for j in range(WIDTH)]
        m1 = [mds_row(i, SBn) for i in range(WIDTH)]
        v2 = [pow7(alg.add(m1[j], rc2[j])) for j in range(WIDTH)]

        # partial-pack: affine propagation over [S, SBn[:11]]
        def affine(coeffs, const, vars_):
            acc = alg.constant(const)
            for cf, xv in zip(coeffs, vars_):
                if cf:
                    acc = alg.add(acc, alg.mul(alg.constant(cf), xv))
            return acc

        pvars = S + SBn[:N_PARTIAL]
        psbox = []   # per block: 11 expected sbox inputs (pre-^7)
        pout = []    # per block: 12 output-state affines
        for (A, O, Oc) in _tables():
            psbox.append([affine(A[k][0], A[k][1], pvars)
                          for k in range(N_PARTIAL)])
            pout.append([affine(O[i], Oc[i], pvars) for i in range(WIDTH)])

        out = []
        for i in range(WIDTH):
            c = alg.mul(sel_f, alg.sub(Sn[i], mds_row(i, v2)))
            c = alg.add(c, alg.mul(sel_pa, alg.sub(Sn[i], pout[0][i])))
            c = alg.add(c, alg.mul(sel_pb, alg.sub(Sn[i], pout[1][i])))
            c = alg.add(c, alg.mul(sel_copy, alg.sub(Sn[i], S[i])))
            # stage: S'_i = am_i·V0'_i + keep·(1−am_i)·S_i  (am_i = C_i)
            am = consts[C0 + i]
            stay = alg.mul(keep, alg.mul(alg.sub(one, am), S[i]))
            absorbed = alg.mul(am, nxt[_v0(i)]) if i < N_PORTS \
                else alg.constant(0)
            c = alg.add(c, alg.mul(sel_stage,
                                   alg.sub(Sn[i], alg.add(absorbed, stay))))
            out.append(c)
        # sbox-witness constraints: full rows define all 12; partial rows
        # define the first 11 (lane-0 sboxes of 11 chained rounds)
        for k in range(WIDTH):
            c = alg.mul(sel_f, alg.sub(SBn[k], u7[k]))
            if k < N_PARTIAL:
                c = alg.add(c, alg.mul(sel_pa,
                                       alg.sub(SBn[k], pow7(psbox[0][k]))))
                c = alg.add(c, alg.mul(sel_pb,
                                       alg.sub(SBn[k], pow7(psbox[1][k]))))
            out.append(c)

        # FMA units: out = A·B + C over GF(p²); operand = f·Vp' + const
        def unit(sel, base, port0):
            fa, fb, fc = consts[base + FMA_FA], consts[base + FMA_FB], \
                consts[base + FMA_FC]
            ca = (consts[base + FMA_CA], consts[base + FMA_CA + 1])
            cb = (consts[base + FMA_CB], consts[base + FMA_CB + 1])
            cc = (consts[base + FMA_CC], consts[base + FMA_CC + 1])
            isa = consts[base + FMA_ASSERT]

            def op(f, c, p):
                return (alg.add(alg.mul(f, nxt[_v0(p)]), c[0]),
                        alg.add(alg.mul(f, nxt[_v1(p)]), c[1]))

            A = op(fa, ca, port0)
            B = op(fb, cb, port0 + 1)
            C = op(fc, cc, port0 + 2)
            ab0 = alg.add(alg.mul(A[0], B[0]),
                          alg.mul(alg.constant(W_EXT), alg.mul(A[1], B[1])))
            ab1 = alg.add(alg.mul(A[0], B[1]), alg.mul(A[1], B[0]))
            o0, o1 = nxt[_v0(port0 + 3)], nxt[_v1(port0 + 3)]
            out.append(alg.mul(sel, alg.sub(o0, alg.add(ab0, C[0]))))
            out.append(alg.mul(sel, alg.sub(o1, alg.add(ab1, C[1]))))
            out.append(alg.mul(sel, alg.mul(isa, o0)))
            out.append(alg.mul(sel, alg.mul(isa, o1)))

        unit(sel_fma, C0, 0)
        unit(sel_fma2, C2_0, 4)

        # port hygiene + boolean rows
        for p in range(N_PORTS):
            am = consts[C0 + p]
            z = alg.mul(sel_stage, alg.mul(am, nxt[_v1(p)]))
            z = alg.add(z, alg.mul(sel_outw, nxt[_v1(p)]))
            z = alg.add(z, alg.mul(sel_bit, nxt[_v1(p)]))
            out.append(z)
            w = alg.mul(sel_outw, alg.sub(nxt[_v0(p)], S[p]))
            w = alg.add(w, alg.mul(sel_bit, alg.mul(
                nxt[_v0(p)], alg.sub(nxt[_v0(p)], one))))
            out.append(w)
        return out

    def _dev_consts(self, device):
        """The constant matrices of the stacked constraints, on `device`:
        MDS, and per partial block its sbox-input rows (A, consts) and
        output rows (O, consts)."""
        key = str(torch.device(device))
        cache = self.__dict__.setdefault("_dev_mats", {})
        if key not in cache:
            def t(m):
                return gl.from_u64(np.array(m, dtype=np.uint64), device)

            blocks = [(t([A[k][0] for k in range(N_PARTIAL)]),
                       t([A[k][1] for k in range(N_PARTIAL)]), t(O), t(Oc))
                      for (A, O, Oc) in _tables()]
            cache[key] = (t(self._mds), blocks)
        return cache[key]

    def _transition_device(self, local, nxt, consts):
        """Stacked device path — the scalar path's constraints in its order,
        batched over the points with the 12-lane state as (12, N) tensors."""
        S = torch.stack(local[:WIDTH])
        Sn = torch.stack(nxt[:WIDTH])
        rc1 = torch.stack(consts[C0:C0 + WIDTH])
        rc2 = torch.stack(consts[C2_0:C2_0 + WIDTH])
        SBn = torch.stack(nxt[SB0:SB0 + WIDTH])
        mds, blocks = self._dev_consts(S.device)

        def pow7(x):
            x2 = gl.mul(x, x)
            x4 = gl.mul(x2, x2)
            return gl.mul(gl.mul(x4, x2), x)

        def matvec(M, x, c=None):
            """(R, C) constant matrix times (C, N) rows (+ a constant per
            row), accumulated column by column: O(R·N) live memory."""
            acc = None
            for j in range(M.shape[1]):
                t = gl.mul(x[j][None, :], M[:, j:j + 1])
                acc = t if acc is None else gl.add(acc, t)
            return acc if c is None else gl.add(acc, c[:, None])

        # full-pack: u7 = (S+rc1)^7 (the SBn definition), then round a+1
        u7 = pow7(gl.add(S, rc1))
        v2 = pow7(gl.add(matvec(mds, SBn), rc2))
        f_out = matvec(mds, v2)
        del v2
        # partial-pack blocks: vars = [S(12), SBn[:11]]
        pv_ = torch.cat([S, SBn[:N_PARTIAL]])
        p_sbox = [pow7(matvec(A, pv_, Ac)) for (A, Ac, _O, _Oc) in blocks]
        p_out = [matvec(O, pv_, Oc) for (_A, _Ac, O, Oc) in blocks]
        del pv_

        def gate(term, k):
            return gl.mul(term, consts[k][None])

        out = []
        # lane constraints
        t = gate(gl.sub(Sn, f_out), SEL_FPACK)
        t = gl.add(t, gate(gl.sub(Sn, p_out[0]), SEL_PA))
        t = gl.add(t, gate(gl.sub(Sn, p_out[1]), SEL_PB))
        t = gl.add(t, gate(gl.sub(Sn, S), SEL_COPY))
        # stage: S'_i = am_i·V0'_i + keep·(1−am_i)·S_i  (am_i = C_i)
        am = rc1
        v0 = torch.stack([nxt[_v0(i)] for i in range(N_PORTS)])
        absorbed = torch.cat([gl.mul(am[:N_PORTS], v0),
                              torch.zeros_like(Sn[N_PORTS:])])
        stay = gl.mul(gl.mul(gl.sub(1, am), S), consts[KEEP][None])
        t = gl.add(t, gate(gl.sub(Sn, gl.add(absorbed, stay)), SEL_STAGE))
        out.extend(t.unbind(0))
        del f_out, p_out, absorbed, stay, t, v0
        # sbox-witness constraints: full rows define all 12; partial rows
        # define the first 11 (lane-0 sboxes of 11 chained rounds)
        k_ = gate(gl.sub(SBn, u7), SEL_FPACK)
        pa = gl.add(k_[:N_PARTIAL],
                    gate(gl.sub(SBn[:N_PARTIAL], p_sbox[0]), SEL_PA))
        pa = gl.add(pa, gate(gl.sub(SBn[:N_PARTIAL], p_sbox[1]), SEL_PB))
        out.extend(pa.unbind(0))
        out.extend(k_[N_PARTIAL:].unbind(0))
        del u7, p_sbox, k_, pa

        # FMA units: out = A·B + C over GF(p²); operand = f·Vp' + const
        def unit(sf, base, port0):
            def op(fi, ci, p):
                f = consts[base + fi]
                return (gl.add(gl.mul(f, nxt[_v0(p)]), consts[base + ci]),
                        gl.add(gl.mul(f, nxt[_v1(p)]), consts[base + ci + 1]))

            A0, A1 = op(FMA_FA, FMA_CA, port0)
            B0, B1 = op(FMA_FB, FMA_CB, port0 + 1)
            C0_, C1_ = op(FMA_FC, FMA_CC, port0 + 2)
            ab0 = gl.add(gl.mul(A0, B0), gl.mul_small(gl.mul(A1, B1), 7))
            ab1 = gl.add(gl.mul(A0, B1), gl.mul(A1, B0))
            o0, o1 = nxt[_v0(port0 + 3)], nxt[_v1(port0 + 3)]
            out.append(gl.mul(gl.sub(o0, gl.add(ab0, C0_)), sf))
            out.append(gl.mul(gl.sub(o1, gl.add(ab1, C1_)), sf))
            isa = gl.mul(consts[base + FMA_ASSERT], sf)
            out.append(gl.mul(isa, o0))
            out.append(gl.mul(isa, o1))

        unit(consts[SEL_FMA], C0, 0)
        unit(consts[SEL_FMA2], C2_0, 4)

        # port hygiene + boolean rows
        so, ss, sb = consts[SEL_OUTW], consts[SEL_STAGE], consts[SEL_BIT]
        for p in range(N_PORTS):
            v0p, v1p = nxt[_v0(p)], nxt[_v1(p)]
            z = gl.mul(gl.mul(ss, consts[C0 + p]), v1p)
            z = gl.add(gl.add(z, gl.mul(so, v1p)), gl.mul(sb, v1p))
            out.append(z)
            w1 = gl.mul(so, gl.sub(v0p, local[p]))
            w2 = gl.mul(gl.mul(v0p, gl.sub(v0p, 1)), sb)
            out.append(gl.add(w1, w2))
        return out

    # -- witness --------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        prog = self.program
        assert prog.witness, "trace requires a witness-mode program"
        vals = prog.values
        tr = np.zeros((TRACE_W, self.n), dtype=np.uint64)

        def setv(row, p, addr):
            v = vals[addr]
            tr[_v0(p), row] = v[0]
            tr[_v1(p), row] = v[1]

        def fill_unit(r, row: _FmaRow, port0):
            for p, (coeff, addr, _c) in enumerate((row.a, row.b, row.c)):
                if coeff and addr:
                    setv(r + 1, port0 + p, addr)
            if not row.is_assert and row.out_addr:
                setv(r + 1, port0 + 3, row.out_addr)
            # asserts leave the out cell 0 == the asserted value

        r = 0
        prev_state = None
        for it in prog.items:
            if isinstance(it, _FmaRow):
                if it.compute:
                    fill_unit(r, it, 0)
                    if it.unit2 is not None:
                        fill_unit(r, it.unit2, 4)
                else:
                    setv(r + 1, 3, it.out_addr)
                r += 1
            elif isinstance(it, _MultiWrite):
                for p, addr in enumerate(it.out_addrs):
                    setv(r + 1, p, addr)
                r += 1
            else:
                base = r
                state = list(prev_state) if it.keep and prev_state else \
                    [0] * WIDTH
                tr[:WIDTH, base] = state            # stage row state
                for lane, addr in enumerate(it.buf_addrs):
                    v = vals[addr]
                    assert v[1] == 0
                    state[lane] = v[0]
                    setv(base + 1, lane, addr)
                # packed rows: S at [absorbed, after r1, r3, r14, r25,
                # r27, r29]; sbox witnesses on the NEXT row's raw columns
                rc, mds = self._rc, self._mds
                s = list(state)
                tr[:WIDTH, base + 1] = s
                state_rows = {1: base + 2, 3: base + 3, 14: base + 4,
                              25: base + 5, 27: base + 6, 29: base + 7}
                sbox_rows = {0: base + 2, 2: base + 3, 26: base + 6,
                             28: base + 7}
                for k in range(pv.N_ROUNDS):
                    u = [(x + rc[k * WIDTH + j]) % P
                         for j, x in enumerate(s)]
                    if HALF <= k < pv.N_ROUNDS - HALF:
                        u[0] = pow(u[0], pv.ALPHA, P)
                        # partial sbox witness: block row, position k-in-block
                        blk_row = base + 4 if k < HALF + N_PARTIAL \
                            else base + 5
                        kk = (k - HALF) % N_PARTIAL
                        tr[SB0 + kk, blk_row] = u[0]
                    else:
                        u = [pow(x, pv.ALPHA, P) for x in u]
                        if k in sbox_rows:
                            for j in range(WIDTH):
                                tr[SB0 + j, sbox_rows[k]] = u[j]
                    s = [sum(map(mul, row, u)) % P for row in mds]
                    if k in state_rows:
                        tr[:WIDTH, state_rows[k]] = s
                # BUF row: final state (chain copy) + outw port values
                tr[:WIDTH, base + 8] = s
                for p in range(N_PORTS):
                    tr[_v0(p), base + 8] = s[p]
                    tr[_v1(p), base + 8] = 0
                for p, addr in enumerate(it.out_addrs):
                    if addr and prog.reads.get(addr, 0):
                        assert vals[addr] == (s[p], 0)
                prev_state = s
                r += SLOT_ROWS
        return tr
