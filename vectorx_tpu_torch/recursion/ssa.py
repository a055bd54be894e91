"""Op tape for the recursive verifier: a straight-line SSA program over
GF(p²) values, Poseidon duplexes, and bit decompositions.

The tape is built twice from the same code path (`shadow.py`):

* statement mode — no proof; records structure only.  The tape is a pure
  function of (child statement, config), so prover and verifier derive
  identical programs (the machine AIR's preprocessed columns).
* witness mode — a concrete proof fills every FRESH value; assertions are
  checked eagerly, so a tampered proof fails during witness build exactly
  where the host verifier (stark/verifier.py) would reject.

Ops map 1:1 onto the machine AIR's row capabilities (machine.py): FMA
slots with affine-routed operands, duplex = absorb + 30 Poseidon round
rows + squeeze, BITDEC rows with persistent bit columns readable by slot
A-ports."""

from __future__ import annotations

from dataclasses import dataclass, field

from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.hash import poseidon_py
from vectorx_tpu_torch.hash.poseidon import RATE, WIDTH


@dataclass(frozen=True)
class BitRef:
    """Bit i of a BITDEC node — readable only through slot A-ports while
    that decomposition's bits are held live."""

    node: int
    index: int


class Affine:
    """const + Σ coeff·value + Σ coeff·bit, coefficients in the base field,
    const in GF(p²).  Bit terms restrict the affine to A-port routing."""

    __slots__ = ("const", "terms", "bits")

    def __init__(self, const=ext_py.ZERO, terms=None, bits=None):
        self.const = const
        self.terms = dict(terms or {})   # vid -> base coeff
        self.bits = dict(bits or {})     # BitRef -> base coeff

    @staticmethod
    def of(x):
        if isinstance(x, Affine):
            return x
        if isinstance(x, BitRef):
            return Affine(bits={x: 1})
        if isinstance(x, int):
            return Affine(terms={x: 1})
        if isinstance(x, tuple):         # ext constant
            return Affine(const=(x[0] % P, x[1] % P))
        raise TypeError(type(x))

    def scaled(self, k: int) -> "Affine":
        k %= P
        return Affine(ext_py.mul(self.const, (k, 0)),
                      {v: (c * k) % P for v, c in self.terms.items()},
                      {b: (c * k) % P for b, c in self.bits.items()})

    def plus(self, other) -> "Affine":
        other = Affine.of(other)
        t = dict(self.terms)
        for v, c in other.terms.items():
            t[v] = (t.get(v, 0) + c) % P
        bb = dict(self.bits)
        for b, c in other.bits.items():
            bb[b] = (bb.get(b, 0) + c) % P
        return Affine(ext_py.add(self.const, other.const),
                      {v: c for v, c in t.items() if c},
                      {b: c for b, c in bb.items() if c})

    @property
    def is_const(self):
        return not self.terms and not self.bits


# --- tape nodes ------------------------------------------------------------

@dataclass
class Fma:
    """result = a·b + c"""

    a: Affine
    b: Affine
    c: Affine
    out: int


@dataclass
class Fresh:
    """Witness input (a proof element); `public_index` ≥ 0 marks a
    statement value pinned by a boundary constraint instead."""

    out: int
    tag: str
    public_index: int = -1


@dataclass
class Duplex:
    """Poseidon duplex: overwrite lanes [0, len(buf)) with buf, keep lanes
    len(buf).. from the previous duplex's output state (keep_state) or
    zero them (fresh sponge); permute.  Emits 12 output-lane vids."""

    buf: list            # vids
    keep_state: bool
    outs: list           # 12 vids
    prev: int            # node index of previous Duplex (state source) or -1


@dataclass
class BitDec:
    """Decompose `x` (base-field value in a vid) into `nbits` bits;
    `canonical` adds the x < P gadget (required when nbits == 64)."""

    x: int
    nbits: int
    canonical: bool
    node: int            # own node index (BitRefs point here)


@dataclass
class Assert:
    """a·b + c must equal zero."""

    a: Affine
    b: Affine
    c: Affine
    where: str


class TapeCheckFailed(Exception):
    """Witness-mode assertion failure — the proof would be rejected."""


class Builder:
    def __init__(self, witness: bool):
        self.witness = witness
        self.nodes: list = []
        self.values: dict[int, tuple] = {}   # vid -> ext pair (witness mode)
        self.bitvals: dict[BitRef, int] = {}
        self._next = 0
        self.n_public = 0
        self._const_cache: dict[tuple, int] = {}

    # -- helpers ------------------------------------------------------------

    def _vid(self) -> int:
        self._next += 1
        return self._next - 1

    def eval_affine(self, a: Affine):
        acc = a.const
        for v, c in a.terms.items():
            acc = ext_py.add(acc, ext_py.mul(self.values[v], (c, 0)))
        for b, c in a.bits.items():
            acc = ext_py.add(acc, ((self.bitvals[b] * c) % P, 0))
        return acc

    # -- ops ----------------------------------------------------------------

    def fresh(self, value, tag: str) -> Affine:
        vid = self._vid()
        self.nodes.append(Fresh(out=vid, tag=tag))
        if self.witness:
            assert value is not None, f"missing witness for {tag}"
            self.values[vid] = (value[0] % P, value[1] % P) \
                if isinstance(value, tuple) else (value % P, 0)
        return Affine(terms={vid: 1})

    def public(self, value, index: int) -> Affine:
        vid = self._vid()
        self.nodes.append(Fresh(out=vid, tag=f"public{index}",
                                public_index=index))
        self.n_public = max(self.n_public, index + 1)
        # publics are statement data: known in both modes
        self.values[vid] = (value[0] % P, value[1] % P) \
            if isinstance(value, tuple) else (value % P, 0)
        return Affine(terms={vid: 1})

    def fma(self, a, b, c=ext_py.ZERO) -> Affine:
        a, b, c = Affine.of(a), Affine.of(b), Affine.of(c)
        if a.is_const and b.is_const:
            return c.plus(Affine(const=ext_py.mul(a.const, b.const)))
        if a.is_const:
            a, b = b, a
        if b.is_const:                   # scale+shift folds into the affine
            if b.const[1] == 0:
                return a.scaled(b.const[0]).plus(c)
            # ext-constant multiplier: needs a real slot unless a is a
            # plain value; fall through to materialize
        vid = self._vid()
        self.nodes.append(Fma(a=a, b=b, c=c, out=vid))
        if self.witness:
            self.values[vid] = ext_py.add(
                ext_py.mul(self.eval_affine(a), self.eval_affine(b)),
                self.eval_affine(c))
        return Affine(terms={vid: 1})

    def const_value(self, v) -> Affine:
        """A constant pinned into a value slot (out = const·1 + 0).
        Memoized: repeated constants (zero pads, shared table entries)
        share one slot — identically in both modes, so the tape structure
        stays statement-deterministic."""
        if isinstance(v, int):
            v = (v % P, 0)
        cached = self._const_cache.get(v)
        if cached is not None:
            return Affine(terms={cached: 1})
        vid = self._vid()
        self.nodes.append(Fma(a=Affine(const=v),
                              b=Affine(const=ext_py.ONE),
                              c=Affine(const=ext_py.ZERO), out=vid))
        self.values[vid] = v
        self._const_cache[v] = vid
        return Affine(terms={vid: 1})

    def materialize(self, a) -> Affine:
        """Force an affine into a single value (for port-width or
        bit-operand limits)."""
        a = Affine.of(a)
        if a.is_const:
            return self.const_value(a.const)
        if not a.bits and not a.const[0] and not a.const[1] \
                and len(a.terms) == 1 and next(iter(a.terms.values())) == 1:
            return a
        # Emit the Fma node directly: fma() folds ·1 back into the affine.
        vid = self._vid()
        self.nodes.append(Fma(a=a, b=Affine(const=ext_py.ONE),
                              c=Affine(const=ext_py.ZERO), out=vid))
        if self.witness:
            self.values[vid] = self.eval_affine(a)
        return Affine(terms={vid: 1})

    def add(self, a, b):
        return Affine.of(a).plus(b)

    def sub(self, a, b):
        return Affine.of(a).plus(Affine.of(b).scaled(P - 1))

    def mul(self, a, b):
        return self.fma(a, b)

    def duplex(self, buf: list, keep_state: bool, prev: int) -> tuple:
        """Returns (node_index, [12 output Affines])."""
        buf_vids = []
        for x in buf:
            m = self.materialize(x)
            buf_vids.append(next(iter(m.terms)))
        outs = [self._vid() for _ in range(WIDTH)]
        node = Duplex(buf=buf_vids, keep_state=keep_state, outs=outs,
                      prev=prev)
        idx = len(self.nodes)
        self.nodes.append(node)
        if self.witness:
            if keep_state and prev >= 0:
                state = [self.values[v][0] for v in self.nodes[prev].outs]
            else:
                state = [0] * WIDTH
            for i, v in enumerate(buf_vids):
                val = self.values[v]
                assert val[1] == 0, "sponge absorbs base-field values"
                state[i] = val[0]
            out_state = poseidon_py.permute(state)
            for o, s in zip(outs, out_state):
                self.values[o] = (s, 0)
        return idx, [Affine(terms={o: 1}) for o in outs]

    def bitdec(self, x, nbits: int, canonical: bool) -> list:
        m = self.materialize(x)
        xv = next(iter(m.terms))
        node_idx = len(self.nodes)
        self.nodes.append(BitDec(x=xv, nbits=nbits, canonical=canonical,
                                 node=node_idx))
        refs = [BitRef(node=node_idx, index=i) for i in range(nbits)]
        if self.witness:
            val = self.values[xv]
            if val[1] != 0:
                raise TapeCheckFailed("bitdec of non-base value")
            v = val[0]
            if v >= (1 << nbits):
                raise TapeCheckFailed(
                    f"bitdec: value needs more than {nbits} bits")
            for i, r in enumerate(refs):
                self.bitvals[r] = (v >> i) & 1
        return refs

    def assert_zero(self, a, b=None, c=None, where: str = ""):
        """a·b + c == 0; defaults b=1, c=0."""
        a = Affine.of(a)
        b = Affine.of(b) if b is not None else Affine(const=ext_py.ONE)
        c = Affine.of(c) if c is not None else Affine(const=ext_py.ZERO)
        self.nodes.append(Assert(a=a, b=b, c=c, where=where))
        if self.witness:
            got = ext_py.add(ext_py.mul(self.eval_affine(a),
                                        self.eval_affine(b)),
                             self.eval_affine(c))
            if got != ext_py.ZERO:
                raise TapeCheckFailed(f"assertion failed: {where}")

    def assert_eq(self, a, b, where: str = ""):
        self.assert_zero(self.sub(a, b), where=where)

    def inverse(self, a, witness_value=None, where: str = "inv") -> Affine:
        """Witnessed inverse: fresh i with a·i == 1."""
        a = Affine.of(a)
        if self.witness and witness_value is None:
            witness_value = ext_py.inv(self.eval_affine(a))
        inv = self.fresh(witness_value, tag=where)
        self.assert_zero(a, inv, Affine(const=(P - 1, 0)), where=where)
        return inv
