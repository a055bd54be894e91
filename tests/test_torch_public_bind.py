"""The hash AIRs' `bind="public"` mode in the port against the JAX package,
on CPU torch, for `Blake2bAir` and `Sha256Air` and the cases of
`tests/test_blake2b_public_bind.py` (round trip, wrong publics rejected,
`public_shape` is length-only, consts bind unchanged).

* Statements made from a seeded numpy generator: `public_inputs()`,
  `constant_columns()`, `boundaries()`, the witness trace and the digests
  equal the reference's, and the port's stacked device transition equals
  its scalar one in public mode.
* At that file's config (2 queries), the port's proof JSON of the
  reference tests' own public-bind statements
  (`tests/test_blake2b_public_bind.py`, `tests/test_recursion_succinct.py`)
  equals the reference's proof, which loads from the golden fixtures, and
  each package's verifier accepts the other's proof.  A reference proof of
  any other statement would prove for real on XLA:CPU, for minutes.
* Two public-mode statements of one shape have one verification-key
  cache key; consts-mode keys still change with the statement.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.blake2b_air import Blake2bAir as JBlake2bAir
from vectorx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark import vk
from vectorx_tpu_torch.stark.air import DeviceAlgebra, ExtAlgebra
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.sha256_air import Sha256Air, sha256_pad

from test_torch_hash_airs import _Cap
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)

torch.set_num_threads(1)

# tests/test_blake2b_public_bind.py's config
KNOBS = dict(rate_bits=3, cap_height=1, num_queries=2, final_poly_len=2,
             pow_bits=1)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))

_rng = np.random.default_rng(2024)
# one message of one block and one of several, for each AIR
SEEDED = [_rng.bytes(int(n)) for n in (_rng.integers(1, 50),
                                       _rng.integers(130, 300))]
# the public-bind statements the reference's own tests prove
REFERENCE = {"blake2b": [b"avail header bytes here", b"Z" * 150],
             "sha256": [b"hello", b"B" * 70]}
AIRS = {"blake2b": (Blake2bAir, JBlake2bAir,
                    lambda m: hashlib.blake2b(m, digest_size=32).digest(),
                    lambda msgs: [len(m) for m in msgs]),
        "sha256": (Sha256Air, JSha256Air,
                   lambda m: hashlib.sha256(m).digest(),
                   lambda msgs: [len(sha256_pad(m)) // 64 for m in msgs])}


def _pair(name, msgs, bind="public"):
    tcls, jcls = AIRS[name][:2]
    return tcls(msgs, bind=bind), jcls(msgs, bind=bind)


def _same_statement(tair, jair):
    """public_inputs(), constant_columns() and boundaries() equal the
    reference's."""
    pub = tair.public_inputs()
    assert pub == jair.public_inputs()
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert tair.boundaries(pub) == jair.boundaries(pub)
    assert (tair.width, tair.log_n) == (jair.width, jair.log_n)


@pytest.fixture(scope="module")
def proofs():
    """name -> (port air, port proof JSON, reference proof JSON) for the
    reference tests' statements, proved once each."""
    out = {}
    for name in AIRS:
        tair, jair = _pair(name, REFERENCE[name])
        trace = tair.build_trace()
        tproof = tstark.prove(tair, trace, CFG, device="cpu")
        jproof = jstark.prove(jair, trace, JCFG)    # golden fixture
        out[name] = (tair, tser.proof_to_json(tproof),
                     jser.proof_to_json(jproof))
    return out


@pytest.mark.parametrize("name", list(AIRS))
def test_public_bind_roundtrip(proofs, name):
    digest = AIRS[name][2]
    tair, jair = _pair(name, SEEDED)
    _same_statement(tair, jair)
    assert tair.digest_bytes_list() == jair.digest_bytes_list() == \
        [digest(m) for m in SEEDED]
    assert np.array_equal(tair.build_trace(), jair.build_trace())

    rair, tjson, jjson = proofs[name]
    _same_statement(rair, _pair(name, REFERENCE[name])[1])
    assert json.dumps(tjson) == json.dumps(jjson)
    assert tstark.verify(rair, tser.proof_from_json(jjson), CFG,
                         device="cpu")
    pre = (_Cap(vk.constants_cap(rair, CFG, device="cpu")),)
    assert jstark.verify(_pair(name, REFERENCE[name])[1],
                         jser.proof_from_json(tjson), JCFG, preprocessed=pre)


@pytest.mark.parametrize("name", list(AIRS))
def test_public_bind_rejects_wrong_publics(proofs, name):
    rair, tjson, _ = proofs[name]
    proof = tser.proof_from_json(tjson)
    for idx in (1, -1):   # a message limb; a digest limb
        bad = AIRS[name][0](REFERENCE[name], bind="public")
        pubs = bad.public_inputs()
        pubs[idx] = (pubs[idx] + 1) % (1 << 32)
        bad.public_inputs = lambda p=pubs: p
        assert not tstark.verify(bad, proof, CFG, device="cpu")


@pytest.mark.parametrize("name", list(AIRS))
def test_public_shape_program_is_length_only(name):
    tcls, jcls, _, shape_of = AIRS[name]
    shape = shape_of(SEEDED)
    ps, jps = tcls.public_shape(shape), jcls.public_shape(shape)
    full = tcls(SEEDED, bind="public")
    assert np.array_equal(ps.constant_columns(), full.constant_columns())
    _same_statement(ps, jps)
    assert len(ps.public_inputs()) == len(full.public_inputs())
    # the stacked device transition equals the scalar one in public mode
    rng = np.random.default_rng(5)
    consts = full.constant_columns()
    rows = rng.choice(full.total_rows, size=3, replace=False)
    loc, nxt = (rng.integers(0, gl.P, size=(full.width, 3), dtype=np.uint64)
                for _ in range(2))
    cc = consts[:, rows]
    dev = full.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                          list(gl.from_u64(nxt, "cpu")), [],
                          list(gl.from_u64(cc, "cpu")))
    dev = np.stack([gl.to_u64(v) for v in dev])
    for p in range(3):
        scal = full.transition(ExtAlgebra, [(int(v), 0) for v in loc[:, p]],
                               [(int(v), 0) for v in nxt[:, p]], [],
                               [(int(v), 0) for v in cc[:, p]])
        assert [v[0] for v in scal] == [int(x) for x in dev[:, p]]


@pytest.mark.parametrize("name", list(AIRS))
def test_consts_bind_unchanged(proofs, name):
    """The consts-mode statement is the reference's, with no boundaries
    (its proofs are held equal to the reference's in
    `test_torch_hash_airs.py` and `test_torch_header_range.py`), and a
    public-mode proof does not verify as the consts-mode statement of the
    same messages."""
    tair, jair = _pair(name, SEEDED, bind="consts")
    _same_statement(tair, jair)
    assert tair.boundaries(tair.public_inputs()) == []
    stmt = AIRS[name][0].statement(SEEDED, tair.digest_bytes_list())
    assert np.array_equal(stmt.constant_columns(), tair.constant_columns())
    _, tjson, _ = proofs[name]
    consts = AIRS[name][0](REFERENCE[name])
    assert not tstark.verify(consts, tser.proof_from_json(tjson), CFG,
                             device="cpu")


@pytest.mark.parametrize("name", list(AIRS))
def test_public_shape_shares_one_verification_key(name):
    """Two public-mode statements of one shape and the public-shape AIR
    have one content key, so `stark.vk` serves them one cap; consts mode
    keys each statement apart.  The key hashes the constant columns the
    cap is derived from, so equal keys mean equal caps."""
    tcls, _, _, shape_of = AIRS[name]
    other = [bytes(len(m)) for m in SEEDED]
    assert shape_of(other) == shape_of(SEEDED)
    a, b = tcls(SEEDED, bind="public"), tcls(other, bind="public")
    ps = tcls.public_shape(shape_of(SEEDED))
    assert a.public_inputs() != b.public_inputs()
    assert len({vk.cache_key(x.constant_columns(), CFG)
                for x in (a, b, ps)}) == 1
    ca, cb = tcls(SEEDED), tcls(other)
    assert len({vk.cache_key(x.constant_columns(), CFG)
                for x in (ca, cb, a)}) == 3
