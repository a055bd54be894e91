"""`Sha512Air` in the port against the JAX package, on CPU torch.

* Digests equal hashlib's and the reference's for
  `tests/test_sha512_air.py`'s messages.
* Constant columns, trace and public inputs equal the reference's for the
  117-byte EdDSA challenge shape (exact u64).
* The stacked device transition equals the port's scalar transition and
  the reference's on the reference test's rows of the real trace and at
  random field points.
* The batched statement of `tests/test_sha512_air.py` (whose reference
  proof is a golden fixture): the port's proof JSON equals the
  reference's, each verifier accepts the other's proof, and a forged
  digest or message is rejected.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.air import ExtAlgebra as JExtAlgebra
from vectorx_tpu.stark.sha512_air import Sha512Air as JSha512Air
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import vk
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.air import DeviceAlgebra, ExtAlgebra
from vectorx_tpu_torch.stark.sha512_air import WIDTH, Sha512Air
from vectorx_tpu_torch.stark.vk import constants_cap

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def isolated_vk_cache(tmp_path_factory):
    """Verification keys in a temporary cache, as in
    `tests/test_torch_recursion.py`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VECTORX_VK_CACHE", str(tmp_path_factory.mktemp("vk")))
        vk.clear_memory_cache()
        yield
        vk.clear_memory_cache()


P = gl.P
# the config of tests/test_sha512_air.py
KNOBS = dict(rate_bits=3, cap_height=0, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))

DIGEST_MSGS = (b"", b"abc", b"x" * 111, b"y" * 112, b"z" * 117,
               bytes(range(200)))
CHALLENGE = bytes(range(117))     # R ‖ A ‖ 53-byte precommit
BATCH = [b"challenge one", bytes(range(117))]


@pytest.mark.parametrize("msg", DIGEST_MSGS, ids=lambda m: str(len(m)))
def test_digest_matches_hashlib_and_reference(msg):
    tair = Sha512Air(msg)
    assert tair.digest_bytes() == hashlib.sha512(msg).digest()
    assert tair.digest_bytes() == JSha512Air(msg).digest_bytes()


def test_constants_trace_and_publics_match_reference():
    tair, jair = Sha512Air(CHALLENGE), JSha512Air(CHALLENGE)
    assert (tair.width, tair.log_n, tair.total_rows) == \
        (jair.width, jair.log_n, jair.total_rows) == (WIDTH, 8, 163)
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    assert tair.public_inputs() == jair.public_inputs()
    assert tair.boundaries(tair.public_inputs()) == \
        jair.boundaries(jair.public_inputs()) == []
    stmt = Sha512Air.statement(CHALLENGE, tair.digest_bytes())
    assert np.array_equal(stmt.constant_columns(), tair.constant_columns())


def _device_eval(air, loc, nxt, cc):
    vals = air.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                          list(gl.from_u64(nxt, "cpu")), [],
                          list(gl.from_u64(cc, "cpu")))
    return np.stack([gl.to_u64(v) for v in vals])


def _scalar_eval(air, alg, loc, nxt, cc, p):
    return air.transition(alg, [(int(v), 0) for v in loc[:, p]],
                          [(int(v), 0) for v in nxt[:, p]], [],
                          [(int(v), 0) for v in cc[:, p]])


def test_device_transition_matches_scalar_and_reference():
    """On the reference test's rows of the witness trace (every value
    zero) and at random field points (every constraint live), the stacked
    twin, the port's scalar path and the reference's scalar path agree."""
    tair, jair = Sha512Air(CHALLENGE), JSha512Air(CHALLENGE)
    tr, cc = tair.build_trace(), tair.constant_columns()
    rng = np.random.default_rng(0)
    rows = sorted({0, 15, 16, 79, 80, 81, 96, 161, 162,
                   *(int(r) for r in rng.integers(0, tair.n - 1, size=6))})
    idx = np.array(rows)
    rng = np.random.default_rng(7)
    rnd = [rng.integers(0, P, size=(k, 2), dtype=np.uint64)
           for k in (WIDTH, WIDTH, cc.shape[0])]
    for loc, nxt, con, trace_rows in ((tr[:, idx], tr[:, idx + 1],
                                       cc[:, idx], True), (*rnd, False)):
        dev = _device_eval(tair, loc, nxt, con)
        for p in range(loc.shape[1]):
            want = [int(x) for x in dev[:, p]]
            scal = _scalar_eval(tair, ExtAlgebra, loc, nxt, con, p)
            assert [v for v in scal] == [(w, 0) for w in want]
            ref = _scalar_eval(jair, JExtAlgebra, loc, nxt, con, p)
            assert [v[0] % P for v in ref] == want
            if trace_rows:
                assert not any(want), f"row {rows[p]}"


@pytest.fixture(scope="module")
def proofs():
    """The batched statement: port air, reference air, port JSON,
    reference JSON (the reference's is its test's golden fixture)."""
    tair, jair = Sha512Air(BATCH), JSha512Air(BATCH)
    trace = tair.build_trace()
    assert np.array_equal(trace, jair.build_trace())
    tp = tstark.prove(tair, trace, CFG, device="cpu")
    jp = jstark.prove(jair, trace, JCFG)
    return tair, jair, tser.proof_to_json(tp), jser.proof_to_json(jp)


def test_batched_proof_json_matches_reference(proofs):
    _, _, tjson, jjson = proofs
    assert json.dumps(tjson) == json.dumps(jjson)


def test_port_verifier_accepts_reference_proof(proofs):
    tair, _, _, jjson = proofs
    exp = [hashlib.sha512(m).digest() for m in BATCH]
    assert tair.digest_bytes_list() == exp
    stmt = Sha512Air.statement(BATCH, exp)
    assert tstark.verify(stmt, tser.proof_from_json(jjson), CFG,
                         device="cpu")


class _Cap:
    def __init__(self, cap):
        self._cap = cap

    def cap_ints(self):
        return self._cap


def test_reference_verifier_accepts_port_proof(proofs):
    """The verification key (constants cap) is derived by the port; the
    proof's constant openings are Merkle-checked against it."""
    tair, jair, tjson, _ = proofs
    pre = (_Cap(constants_cap(tair, CFG, device="cpu")),)
    assert jstark.verify(jair, jser.proof_from_json(tjson), JCFG,
                         preprocessed=pre)


@pytest.mark.parametrize("forge", ["digest", "message"])
def test_forged_statement_rejected(proofs, forge):
    _, _, tjson, _ = proofs
    exp = [hashlib.sha512(m).digest() for m in BATCH]
    msgs = list(BATCH)
    if forge == "digest":
        exp[1] = b"\x00" * 64
    else:
        msgs[0] = b"challenge two"
    assert not tstark.verify(Sha512Air.statement(msgs, exp),
                             tser.proof_from_json(tjson), CFG, device="cpu")
