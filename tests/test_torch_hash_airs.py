"""The hash AIRs of the header_range path (`Sha256Air`, `Blake2bAir`) in the
port against the JAX package, on CPU torch.

* Constant columns, witness traces and digests are equal (exact u64).
* The port's stacked device transition equals its scalar transition at
  random points, and the reference's device transition on the same inputs
  (canonical field values, exact).
* `proof_to_json` of the port's proof equals the reference proof of the
  same statement (`tests/test_sha256_air.py`'s single-key authority
  commitment and `tests/test_blake2b_air.py`'s single header, which load
  from the golden fixtures), and each package's verifier accepts the
  other's proof.
* A 2^14-row Blake2b chunk, which the reference proves streamed, is under
  the port's H100 streaming bound.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import prover as jprover
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.blake2b_air import Blake2bAir as JBlake2bAir
from vectorx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import prover as tprover
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.air import DeviceAlgebra, ExtAlgebra
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.sha256_air import Sha256Air
from vectorx_tpu_torch.stark.vk import constants_cap

torch.set_num_threads(1)

P = gl.P
# the config of tests/test_sha256_air.py and tests/test_blake2b_air.py
KNOBS = dict(rate_bits=3, cap_height=0, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))

AIRS = {"sha256": (Sha256Air, JSha256Air),
        "blake2b": (Blake2bAir, JBlake2bAir)}
BATCH = [b"header one", b"x" * 130, b"", b"third message " * 9,
         bytes(range(64))]
PROVED = {"sha256": [b"\x05" * 32], "blake2b": b"avail header bytes"}


@pytest.mark.parametrize("name", list(AIRS))
def test_constants_trace_and_digests_match_reference(name):
    tcls, jcls = AIRS[name]
    tair, jair = tcls(BATCH), jcls(BATCH)
    assert (tair.width, tair.log_n) == (jair.width, jair.log_n)
    assert tair.digest_bytes_list() == jair.digest_bytes_list()
    want = hashlib.sha256 if name == "sha256" else \
        (lambda m: hashlib.blake2b(m, digest_size=32))
    assert tair.digest_bytes_list() == [want(m).digest() for m in BATCH]
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    stmt = tcls.statement(BATCH, tair.digest_bytes_list())
    assert np.array_equal(stmt.constant_columns(), tair.constant_columns())
    assert stmt.public_inputs() == jair.public_inputs()


def _reference_pairs(a):
    import jax.numpy as jnp

    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.uint64(32)).astype(np.uint32)
    return [(jnp.asarray(lo[i]), jnp.asarray(hi[i])) for i in range(len(a))]


@pytest.mark.parametrize("name", list(AIRS))
def test_device_transition_matches_scalar_and_reference(name):
    tcls, jcls = AIRS[name]
    tair, jair = tcls(b"abc"), jcls(b"abc")
    rng = np.random.default_rng(7)
    npts = 4
    K = tair.constant_columns().shape[0]
    loc, nxt = (rng.integers(0, P, size=(tair.width, npts), dtype=np.uint64)
                for _ in range(2))
    cc = rng.integers(0, P, size=(K, npts), dtype=np.uint64)
    dev = tair.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                          list(gl.from_u64(nxt, "cpu")), [],
                          list(gl.from_u64(cc, "cpu")))
    dev = np.stack([gl.to_u64(v) for v in dev])
    for p in range(2):
        col = [(int(v), 0) for v in loc[:, p]]
        ncol = [(int(v), 0) for v in nxt[:, p]]
        ccol = [(int(v), 0) for v in cc[:, p]]
        scal = tair.transition(ExtAlgebra, col, ncol, [], ccol)
        assert [v[1] for v in scal] == [0] * len(scal)
        assert [v[0] for v in scal] == [int(x) for x in dev[:, p]]
    ref = jair._transition_device(_reference_pairs(loc),
                                  _reference_pairs(nxt), _reference_pairs(cc))
    ref = np.stack([(np.asarray(lo).astype(np.uint64)
                     | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))
                    % np.uint64(P) for lo, hi in ref])
    assert np.array_equal(ref, dev)


@pytest.fixture(scope="module")
def proofs():
    """name -> (port air, reference air, port JSON, reference JSON)."""
    out = {}
    for name, (tcls, jcls) in AIRS.items():
        tair, jair = tcls(PROVED[name]), jcls(PROVED[name])
        trace = tair.build_trace()
        tp = tstark.prove(tair, trace, CFG, device="cpu")
        jp = jstark.prove(jair, trace, JCFG)
        out[name] = (tair, jair, tser.proof_to_json(tp),
                     jser.proof_to_json(jp))
    return out


@pytest.mark.parametrize("name", list(AIRS))
def test_proof_json_matches_reference(proofs, name):
    _, _, tjson, jjson = proofs[name]
    assert json.dumps(tjson) == json.dumps(jjson)


@pytest.mark.parametrize("name", list(AIRS))
def test_port_verifier_accepts_reference_proof(proofs, name):
    tair, _, _, jjson = proofs[name]
    assert tstark.verify(tair, tser.proof_from_json(jjson), CFG,
                         device="cpu")


class _Cap:
    def __init__(self, cap):
        self._cap = cap

    def cap_ints(self):
        return self._cap


@pytest.mark.parametrize("name", list(AIRS))
def test_reference_verifier_accepts_port_proof(proofs, name):
    """The verification key (constants cap) is derived by the port: the
    proof's constant openings are Merkle-checked against it, so a wrong
    cap would be rejected."""
    tair, jair, tjson, _ = proofs[name]
    pre = (_Cap(constants_cap(tair, CFG, device="cpu")),)
    assert jstark.verify(jair, jser.proof_from_json(tjson), JCFG,
                         preprocessed=pre)


def test_authority_commitment_matches_reference(proofs):
    """`prove_authority_commitment` of one key is the proved SHA statement
    above (`tests/test_sha256_air.py::test_zk_authority_commitment_single_
    key`); a wrong claimed step digest is rejected."""
    import dataclasses

    from vectorx_tpu_torch.circuits.zk_commitment import (
        prove_authority_commitment, verify_authority_commitment)
    from vectorx_tpu_torch.hash.sha256 import chained_hash

    proof = prove_authority_commitment(PROVED["sha256"], CFG, device="cpu")
    assert proof.commitment == chained_hash(PROVED["sha256"])
    assert proof.chunk_sizes == [1]
    assert json.dumps(tser.proof_to_json(proof.step_proofs[0])) == \
        json.dumps(proofs["sha256"][3])
    assert verify_authority_commitment(proof, CFG, device="cpu")
    bad = dataclasses.replace(proof, step_digests=[b"\x00" * 32],
                              commitment=b"\x00" * 32)
    assert not verify_authority_commitment(bad, CFG, device="cpu")


def test_forged_sha256_statement_rejected(proofs):
    tair, _, tjson, _ = proofs["sha256"]
    forged = Sha256Air.statement(PROVED["sha256"], b"\x00" * 32)
    assert not tstark.verify(forged, tser.proof_from_json(tjson), CFG,
                             device="cpu")


def test_blake2b_chunk_under_the_h100_streaming_bound(monkeypatch):
    """A chunk at the header_range row budget (2^14 rows, production FRI):
    the reference streams it, the port proves it unstreamed; a statement
    over the port's bound goes to `prove_streamed` (the call is recorded,
    not proven)."""
    msgs = [bytes(2048)] * 40                     # 40 x 401 rows
    digests = [b"\x00" * 32] * len(msgs)
    tair = Blake2bAir.statement(msgs, digests)
    jair = JBlake2bAir.statement(msgs, digests)
    assert tair.log_n == 14
    prod, jprod = tstark.StarkConfig(), jstark.StarkConfig()
    assert jprover._use_streaming(jair, jprod)
    assert not tprover._use_streaming(tair, prod)
    assert tprover._commit_cols(tair) == jprover._commit_cols(jair) == 2853
    big = Blake2bAir.statement(msgs * 9, digests * 9)   # 2^17 rows
    assert tprover._use_streaming(big, prod)
    calls = []
    monkeypatch.setattr(tprover, "prove_streamed",
                        lambda air, trace, config, *, device:
                        calls.append((air, config, device)) or "streamed")
    assert tstark.prove(big, np.zeros((0, 0), dtype=np.uint64), prod,
                        device="cpu") == "streamed"
    assert calls == [(big, prod, "cpu")]
