"""`FpMulAir` in the port against the JAX package, on CPU torch, at
`tests/test_ed25519_air.py`'s config.

* `mul_witness`, `_diag_indices`, the trace, the constant columns, the
  lookups, the public inputs and the boundaries equal the reference's at
  log_n 9, plain and `chain=True`.
* The stacked device twin equals the port's scalar transition and the
  reference's on the int oracle of that test, on trace rows (all zero)
  and at random field points (every constraint live), plain and chained.
* The port's `FpMulAir(9)` proves and verifies on CPU torch, a tampered
  `pub_d` is rejected, and the reference's verifier accepts the port's
  proof.  The chained statement's round trip runs on the card
  (`chip_smoke.py` phase 15).
"""

import json

import numpy as np
import pytest
import torch

from test_torch_recursion import share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import ed25519_air as jfp
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import ed25519_air as tfp
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.air import DeviceAlgebra

torch.set_num_threads(1)

P = gl.P
Q = tfp.Q
KNOBS = dict(rate_bits=3, cap_height=1, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))
RNG = np.random.default_rng(13)


def _rand256():
    return int.from_bytes(RNG.bytes(32), "little")


MULS = [(_rand256(), _rand256()) for _ in range(5)]
X = _rand256() % Q


class IntAlg:
    """`tests/test_ed25519_air.py`'s int oracle."""
    add = staticmethod(lambda u, v: (u + v) % P)
    sub = staticmethod(lambda u, v: (u - v) % P)
    mul = staticmethod(lambda u, v: (u * v) % P)
    constant = staticmethod(lambda v: v % P)


def _pair(chain):
    args = ([(X, X)], True) if chain else (MULS, False)
    return tfp.FpMulAir(9, *args), jfp.FpMulAir(9, *args)


def test_mul_witness_and_diag_indices_match_reference():
    for a, b in MULS + [(0, 0), (Q - 1, Q - 1), ((1 << 256) - 1, 1 << 255)]:
        for got, want in zip(tfp.mul_witness(a, b), jfp.mul_witness(a, b)):
            assert np.array_equal(np.asarray(got, dtype=np.uint64),
                                  np.asarray(want, dtype=np.uint64))
    for got, want in ((tfp._AB_IDX, jfp._AB_IDX), (tfp._KQ_IDX, jfp._KQ_IDX)):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert tfp.Q_LIMBS == jfp.Q_LIMBS


@pytest.mark.parametrize("chain", [False, True], ids=["plain", "chain"])
def test_statement_matches_reference(chain):
    tair, jair = _pair(chain)
    assert (tair.width, tair.log_n, tair.constraint_degree) == \
        (jair.width, jair.log_n, jair.constraint_degree)
    assert tair.public_inputs() == jair.public_inputs()
    pub = tair.public_inputs()
    assert tair.boundaries(pub) == jair.boundaries(pub)
    assert [(lk.inputs, lk.table, lk.multiplicity)
            for lk in tair.lookups()] == \
        [(lk.inputs, lk.table, lk.multiplicity) for lk in jair.lookups()]
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    assert tair.outputs() == jair.outputs()
    if chain:
        assert tair.pub_final == pow(X, 1 << 511, Q)


def _scalar(air, loc, nxt, con, p, public):
    return air.transition(IntAlg, [int(v) for v in loc[:, p]],
                          [int(v) for v in nxt[:, p]], public,
                          [int(v) for v in con[:, p]])


@pytest.mark.parametrize("chain", [False, True], ids=["plain", "chain"])
def test_device_twin_matches_scalar_and_reference(chain):
    """Trace rows (every constraint zero) and random field points: the
    twin, the port's scalar path and the reference's agree."""
    tair, jair = _pair(chain)
    tr, cc = tair.build_trace(), tair.constant_columns()
    rows = np.array([0, 1, 2, 100, tair.n - 3, tair.n - 2])
    rng = np.random.default_rng(7)
    rnd = [rng.integers(0, P, size=(k, 3), dtype=np.uint64)
           for k in (tair.width, tair.width, cc.shape[0])]
    pub = tair.public_inputs()
    for loc, nxt, con, on_trace in ((tr[:, rows], tr[:, rows + 1],
                                     cc[:, rows], True), (*rnd, False)):
        dev = tair.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                              list(gl.from_u64(nxt, "cpu")), pub,
                              list(gl.from_u64(con, "cpu")))
        dev = np.stack([gl.to_u64(v) for v in dev])
        assert dev.shape[0] == 64 + (2 * tfp.NA if chain else 0)
        for p in range(loc.shape[1]):
            want = [int(x) for x in dev[:, p]]
            assert _scalar(tair, loc, nxt, con, p, pub) == want
            assert _scalar(jair, loc, nxt, con, p, pub) == want
            if on_trace:
                assert not any(want)
            else:
                assert all(want)


@pytest.fixture(scope="module")
def proof():
    air = tfp.FpMulAir(9, MULS)
    return tstark.prove(air, air.build_trace(), CFG, device="cpu")


def test_roundtrip_and_tamper(proof):
    assert tstark.verify(tfp.FpMulAir(9, MULS), proof, CFG, device="cpu")
    bad = tfp.FpMulAir(9, MULS)
    bad.pub_d = (bad.pub_d + 1) % Q
    assert not tstark.verify(bad, proof, CFG, device="cpu")


def test_reference_verifier_accepts_port_proof(proof):
    share_vk_caps([tfp.FpMulAir(9, MULS)], [jfp.FpMulAir(9, MULS)], CFG,
                  JCFG)
    jproof = jser.proof_from_json(json.loads(json.dumps(
        tser.proof_to_json(proof))))
    assert jstark.verify(jfp.FpMulAir(9, MULS), jproof, JCFG)
