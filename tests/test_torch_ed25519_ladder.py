"""`Ed25519LadderAir` in the port against the JAX package, on CPU torch.

* Every row type (decA, dbl, cadd with bit 0 and 1, decR, uadd, dbl1,
  cadd1, eq) satisfies the port's constraints on the port's trace.
* On one row of each type and at random field points, the stacked device
  twin equals the port's generic path and the reference's `transition`.
* Constant columns, lookups and trace equal the reference's at nbits=8
  (two signatures) and at nbits=253 with one signature (trace build).
* The ladder's result equals host scalar multiplication; a wrong equation
  has no witness.
* The statement binds: on every row of `tests/test_ed25519_ladder.py`'s
  nbits=8 statement, the device twin of the honest trace vanishes, and
  against a forged scalar or a forged pubkey in the statement's constant
  columns it does not.  A proof of this 3520-column AIR at that test's
  config is about 720 Poseidon calls over 4096 leaves, minutes on one CPU
  thread, so the round trip runs in the slow tier, as the reference's
  does, and on the card in `chip_smoke.py` phase 12.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from vectorx_tpu.stark import ed25519_ladder_air as jladder
from vectorx_tpu.stark.air import ExtAlgebra as JExtAlgebra
from vectorx_tpu_torch.curves import ed25519 as ed
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.stark import ed25519_ladder_air as tladder
from vectorx_tpu_torch.stark.air import DeviceAlgebra, ExtAlgebra
from vectorx_tpu_torch.stark.ed25519_ladder_air import (COL_SX, COL_SZ,
                                                        COL_X1, COL_Z1,
                                                        Ed25519LadderAir)

torch.set_num_threads(1)

P = gl.P
Q = ed.Q
RATE_BITS = 3        # tests/test_ed25519_ladder.py's config


def _neg(p):
    return ((Q - p[0]) % Q, p[1], p[2], (Q - p[3]) % Q)


def make_instance(a_secret=12345, s_scalar=173, h_scalar=89):
    """A valid toy equation [S]B = R + [h]A with R derived to match
    (`tests/test_ed25519_ladder.py::make_instance`)."""
    A_pt = ed.scalar_mult(a_secret, ed.B_POINT)
    a_cmp = ed.point_compress(A_pt)
    sb = ed.scalar_mult(s_scalar, ed.B_POINT)
    ha = ed.scalar_mult(h_scalar, A_pt)
    r_cmp = ed.point_compress(ed.point_add(sb, _neg(ha)))
    return (a_cmp, r_cmp, s_scalar, h_scalar)


SIG = make_instance()
SIG2 = make_instance(a_secret=777, s_scalar=201, h_scalar=45)


def real_signature():
    """A real ed25519 signature over a 53-byte message, as the ladder
    statement of `zk_justification` takes it: (A, R, S, h mod L)."""
    sk = b"\x07" * 32
    pk, msg = ed.public_key(sk), b"m" * 53
    sig = ed.sign(sk, msg)
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                       "little") % ed.L
    return (pk, sig[:32], int.from_bytes(sig[32:], "little"), h)


@pytest.fixture(scope="module")
def toy():
    """The nbits=8 two-signature statement, port and reference, with the
    port's trace and constant columns."""
    tair = Ed25519LadderAir([SIG, SIG2], nbits=8)
    jair = jladder.Ed25519LadderAir([SIG, SIG2], nbits=8)
    return tair, jair, tair.build_trace(), tair.constant_columns()


def _picks(air):
    """One row of each type of the first signature (cadd with each bit
    value), and the second signature's decA and dbl rows."""
    sched = air._row_types()
    picks = {}
    for off, (ty, b) in enumerate(sched):
        picks.setdefault(ty, off)
        if ty == "cadd":
            picks.setdefault(f"cadd_bit{(SIG[3] >> b) & 1}", off)
    picks["decA_sig2"] = air.rows_per_sig
    picks["dbl_sig2"] = air.rows_per_sig + 1
    return picks


ROW_TYPES = ["decA", "dbl", "cadd", "cadd_bit0", "cadd_bit1", "decR",
             "uadd", "dbl1", "cadd1", "eq", "decA_sig2", "dbl_sig2"]


def _scalar_eval(air, alg, loc, nxt, cc, p):
    return air.transition(alg, [(int(v), 0) for v in loc[:, p]],
                          [(int(v), 0) for v in nxt[:, p]], [],
                          [(int(v), 0) for v in cc[:, p]])


@pytest.mark.parametrize("ty", ROW_TYPES)
def test_row_type_satisfies_constraints(toy, ty):
    tair, _, tr, cc = toy
    r = _picks(tair)[ty]
    vals = _scalar_eval(tair, ExtAlgebra, tr[:, [r]], tr[:, [r + 1]],
                        cc[:, [r]], 0)
    bad = [i for i, v in enumerate(vals) if v != (0, 0)]
    assert not bad, f"{ty} row {r}: constraints {bad[:8]} nonzero"


def test_device_transition_matches_generic_and_reference(toy):
    """One row of each type (constraint values zero) and random field
    points (every constraint live): the twin, the generic path and the
    reference's scalar transition agree."""
    tair, jair, tr, cc = toy
    rows = np.array(sorted(set(_picks(tair).values())))
    rng = np.random.default_rng(7)
    rnd = [rng.integers(0, P, size=(k, 2), dtype=np.uint64)
           for k in (tair.width, tair.width, cc.shape[0])]
    for loc, nxt, con, on_trace in ((tr[:, rows], tr[:, rows + 1],
                                     cc[:, rows], True), (*rnd, False)):
        dev = tair.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                              list(gl.from_u64(nxt, "cpu")), [],
                              list(gl.from_u64(con, "cpu")))
        dev = np.stack([gl.to_u64(v) for v in dev])
        for p in range(loc.shape[1]):
            want = [int(x) for x in dev[:, p]]
            gen = _scalar_eval(tair, ExtAlgebra, loc, nxt, con, p)
            assert gen == [(w, 0) for w in want]
            ref = _scalar_eval(jair, JExtAlgebra, loc, nxt, con, p)
            assert [v[0] % P for v in ref] == want
            if on_trace:
                assert not any(want)


def test_constants_lookups_and_trace_match_reference(toy):
    tair, jair, tr, cc = toy
    assert (tair.width, tair.log_n, tair.public_inputs()) == \
        (jair.width, jair.log_n, jair.public_inputs()) == \
        (3520, 9, [2, 8])
    assert np.array_equal(cc, jair.constant_columns())
    assert [(lk.inputs, lk.table, lk.multiplicity)
            for lk in tair.lookups()] == \
        [(lk.inputs, lk.table, lk.multiplicity) for lk in jair.lookups()]
    assert np.array_equal(tr, jair.build_trace())
    stmt = Ed25519LadderAir.statement([SIG, SIG2], nbits=8)
    assert np.array_equal(stmt.constant_columns(), cc)


def test_full_width_trace_matches_reference():
    """One real signature at nbits=253 (1016 rows, log_n 10)."""
    sig = real_signature()
    tair = Ed25519LadderAir([sig])
    jair = jladder.Ed25519LadderAir([sig])
    assert (tair.total_rows, tair.log_n) == (1016, 10)
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())


def test_payload_witness_matches_reference():
    """The batched limb identity (`_payload_carries`) at operand edges:
    the padding payload, all-255 limbs, and the widest routed operands of
    the dbl program (signed limbs) over registers at 0, 1, Q-1 and random
    values."""
    S_D, K_2Q = tladder.S_D, tladder.K_2Q
    wide_a = ((S_D + 1, 1), (S_D + 0, -1), (S_D + 2, -1), (K_2Q, 2))
    wide_b = ((S_D + 0, -1), (S_D + 1, -1), (K_2Q, 2))
    rng = np.random.default_rng(3)
    vals = [0, 1, Q - 1] + [int.from_bytes(rng.bytes(32), "little") % Q
                            for _ in range(3)]
    cases = [([0] * 32, [0] * 32), ([255] * 32, [255] * 32)]
    for i in range(len(vals)):
        regs = {S_D + j: np.array(tladder._limbs(vals[(i + j) % len(vals)]))
                for j in range(3)}
        cases.append((tladder._routed_limbs(wide_a, regs).tolist(),
                      tladder._routed_limbs(wide_b, regs).tolist()))
    for a, b in cases:
        assert tladder._payload_witness(a, b) == \
            jladder._payload_witness(a, b)


def test_ladder_result_matches_host_scalar_mult():
    """The witness's final accumulator equals [S]B and saved = R + [h]A."""
    sig = make_instance(a_secret=777, s_scalar=201, h_scalar=45)
    air = Ed25519LadderAir([sig], nbits=8)
    tr = air.build_trace()
    eq_row = air.rows_per_sig - 1

    def reg(base, r):
        return sum(int(tr[base + u, r]) << (8 * u) for u in range(32))

    sb = ed.scalar_mult(sig[2], ed.B_POINT)
    x1, z1 = reg(COL_X1, eq_row), reg(COL_Z1, eq_row)
    assert (x1 * sb[2] - sb[0] * z1) % Q == 0
    r_pt = ed.point_decompress(sig[1])
    ha = ed.scalar_mult(sig[3], ed.point_decompress(sig[0]))
    acc3 = ed.point_add(r_pt, ha)
    sx, sz = reg(COL_SX, eq_row), reg(COL_SZ, eq_row)
    assert (sx * acc3[2] - acc3[0] * sz) % Q == 0


def test_wrong_equation_has_no_witness():
    bad = (SIG[0], SIG[1], SIG[2] + 1, SIG[3])   # S off by one
    air = Ed25519LadderAir([bad], nbits=8)
    with pytest.raises(AssertionError):
        air.build_trace()


# ---------------------------------------------------------------------------
# The statement binds: the device twin over every row of the trace
# ---------------------------------------------------------------------------

def _forged(kind):
    if kind == "scalar":
        return (SIG[0], SIG[1], SIG[2] ^ 1, SIG[3])
    other = ed.point_compress(ed.scalar_mult(999, ed.B_POINT))
    return (other, SIG[1], SIG[2], SIG[3])


@pytest.fixture(scope="module")
def honest_trace():
    air = Ed25519LadderAir([SIG], nbits=8)
    return air, gl.from_u64(air.build_trace(), "cpu")


def _violated(air, tr, stmt):
    """Indices of the constraints the twin finds nonzero on some row
    0..n-2 of the trace `tr` against the statement `stmt`'s constants."""
    n = air.n
    cc = gl.from_u64(stmt.constant_columns(), "cpu")
    vals = air.transition(DeviceAlgebra, list(tr[:, :n - 1]),
                          list(tr[:, 1:]), [], list(cc[:, :n - 1]))
    return [i for i, v in enumerate(vals)
            if bool((gl.canonicalize(v) != 0).any())]


def test_device_twin_vanishes_on_every_row(honest_trace):
    air, tr = honest_trace
    assert _violated(air, tr, Ed25519LadderAir.statement([SIG], nbits=8)) \
        == []


@pytest.mark.parametrize("kind", ["scalar", "pubkey"])
def test_forged_statement_violates_constraints(honest_trace, kind):
    """The honest trace against a forged S (the eq row's scalar check) or
    a forged A (decompression's y binding) in the statement."""
    air, tr = honest_trace
    stmt = Ed25519LadderAir.statement([_forged(kind)], nbits=8)
    assert _violated(air, tr, stmt)


@pytest.mark.slow
def test_zk_roundtrip_and_statement_tamper():
    """The port's proof at tests/test_ed25519_ladder.py's config: its
    verifier accepts it and rejects a forged scalar and pubkey; the
    reference's verifier accepts it."""
    from vectorx_tpu import stark as jstark
    from vectorx_tpu.fri.fri import FriConfig as JFriConfig
    from vectorx_tpu.stark import serialize as jser
    from vectorx_tpu_torch import stark as tstark
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.stark import serialize as tser

    knobs = dict(rate_bits=RATE_BITS, cap_height=0, num_queries=12,
                 final_poly_len=4, pow_bits=0)
    cfg = tstark.StarkConfig(fri=FriConfig(**knobs))
    air = Ed25519LadderAir([SIG], nbits=8)
    proof = tstark.prove(air, air.build_trace(), cfg, device="cpu")
    stmt = Ed25519LadderAir.statement([SIG], nbits=8)
    assert tstark.verify(stmt, proof, cfg, device="cpu")
    for kind in ("scalar", "pubkey"):
        forged = Ed25519LadderAir.statement([_forged(kind)], nbits=8)
        assert not tstark.verify(forged, proof, cfg, device="cpu")
    jcfg = jstark.StarkConfig(fri=JFriConfig(**knobs))
    jproof = jser.proof_from_json(json.loads(json.dumps(
        tser.proof_to_json(proof))))
    assert jstark.verify(jladder.Ed25519LadderAir.statement([SIG], nbits=8),
                         jproof, jcfg)
