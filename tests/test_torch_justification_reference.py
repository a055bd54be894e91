"""The benchmark's plain reference of the GRANDPA justification cells
(`prover_bench/reference/`) against the port, on CPU torch.

* The reference's frozen ladder AIR equals the port's at nbits=8 (two
  signatures) and at nbits=253 with one real signature: trace, constant
  columns, lookups, and the transition on trace rows and at seeded random
  field points (against the port's device twin and its generic path).
* The reference prover with LogUp aux columns gives the port's streamed
  proof integer for integer (`RangeCheckAir(6, 5, V=4)` past a lowered
  `STREAM_THRESHOLD_ELEMS`).
* At 20 authorities both statements modules' inputs follow
  `zk_justification`'s chunk split and `_ladder_sigs`, and the forged
  slot of the justification traffic carries (S + 1) mod L.
* `verify_simple_justification` (the device backend, on the CPU) gives
  the reference's verdict on an honest and a forged justification.

No ladder is proved here: at nbits=8 that is minutes on one CPU thread.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from prover_bench.reference import ed25519_ladder_air as rladder
from prover_bench.reference import goldilocks as rgl
from prover_bench.reference import justification as rjust
from prover_bench.reference import lookup_prover
from prover_bench.reference.air import DeviceAlgebra as RDeviceAlgebra
from prover_bench.reference.fri import FriConfig as RFriConfig
from prover_bench.reference.prover import StarkConfig as RStarkConfig
from vectorx_tpu_torch.circuits import zk_justification as zk
from vectorx_tpu_torch.circuits.justification import (
    JustificationError, verify_simple_justification)
from vectorx_tpu_torch.curves import ed25519 as ed
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.stark import prover as tprover
from vectorx_tpu_torch.stark.air import DeviceAlgebra, ExtAlgebra
from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
from vectorx_tpu_torch.stark.range_air import RangeCheckAir
from vectorx_tpu_torch.stark.serialize import proof_to_json

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = gl.P
Q = ed.Q
FRI = dict(rate_bits=2, cap_height=1, num_queries=2, final_poly_len=4,
           pow_bits=1)


def toy_sig(a_secret, s_scalar, h_scalar):
    """A valid equation [S]B = R + [h]A with small scalars, R made to
    match."""
    A = ed.scalar_mult(a_secret, ed.B_POINT)
    ha = ed.scalar_mult(h_scalar, A)
    minus_ha = ((Q - ha[0]) % Q, ha[1], ha[2], (Q - ha[3]) % Q)
    R = ed.point_add(ed.scalar_mult(s_scalar, ed.B_POINT), minus_ha)
    return (ed.point_compress(A), ed.point_compress(R), s_scalar, h_scalar)


def real_sig():
    sk = b"\x07" * 32
    pk, msg = ed.public_key(sk), b"m" * 53
    sig = ed.sign(sk, msg)
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                       "little") % ed.L
    return (pk, sig[:32], int.from_bytes(sig[32:], "little"), h)


STATEMENTS = {"nbits8": ([toy_sig(12345, 173, 89), toy_sig(777, 201, 45)],
                         8),
              "nbits253": ([real_sig()], 253)}
_BUILT: dict = {}


def built(name):
    """(port AIR, reference AIR, port trace, port constants), once."""
    if name not in _BUILT:
        sigs, nbits = STATEMENTS[name]
        port = Ed25519LadderAir(sigs, nbits=nbits)
        _BUILT[name] = (port, rladder.Ed25519LadderAir(sigs, nbits=nbits),
                        port.build_trace(), port.constant_columns())
    return _BUILT[name]


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_reference_ladder_layout_witness_and_lookups(name):
    port, ref, trace, consts = built(name)
    assert (ref.width, ref.log_n, ref.public_inputs()) == \
        (port.width, port.log_n, port.public_inputs())
    assert np.array_equal(ref.constant_columns(), consts)
    assert [(lk.inputs, lk.table, lk.multiplicity, lk.degree)
            for lk in ref.lookups()] == \
        [(lk.inputs, lk.table, lk.multiplicity, lk.degree)
         for lk in port.lookups()]
    assert np.array_equal(ref.build_trace(), trace)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_reference_ladder_transition(name):
    """On every row type of the first signature (all constraints zero) and
    at seeded random points (every constraint live)."""
    port, ref, trace, consts = built(name)
    rows = np.arange(min(port.rows_per_sig, 64))
    rows = np.unique(np.concatenate([rows, [port.rows_per_sig - 1]]))
    rng = np.random.default_rng(19)
    rnd = [rng.integers(0, P, size=(k, 3), dtype=np.uint64)
           for k in (port.width, port.width, consts.shape[0])]
    for loc, nxt, con, on_trace in ((trace[:, rows], trace[:, rows + 1],
                                     consts[:, rows], True), (*rnd, False)):
        dev = port.transition(DeviceAlgebra, list(gl.from_u64(loc, "cpu")),
                              list(gl.from_u64(nxt, "cpu")), [],
                              list(gl.from_u64(con, "cpu")))
        dev = np.stack([gl.to_u64(v) for v in dev])
        ref_vals = ref.transition(
            RDeviceAlgebra, list(rgl.from_u64(loc, "cpu")),
            list(rgl.from_u64(nxt, "cpu")), [],
            list(rgl.from_u64(con, "cpu")))
        assert np.array_equal(np.stack([rgl.to_u64(v) for v in ref_vals]),
                              dev)
        assert on_trace == (not dev.any())
        p = loc.shape[1] - 1
        gen = port.transition(ExtAlgebra, [(int(v), 0) for v in loc[:, p]],
                              [(int(v), 0) for v in nxt[:, p]], [],
                              [(int(v), 0) for v in con[:, p]])
        assert gen == [(int(v), 0) for v in dev[:, p]]


def test_reference_lookup_prover_equals_streamed_prove(monkeypatch):
    rng = np.random.default_rng(3)
    air = RangeCheckAir(6, 5, rng.integers(0, 32, size=(4, 63),
                                           dtype=np.uint64))
    trace = air.build_trace()
    streamed = []
    orig = tprover.prove_streamed
    monkeypatch.setattr(tprover, "STREAM_THRESHOLD_ELEMS", 1 << 8)
    monkeypatch.setattr(tprover, "prove_streamed",
                        lambda *a, **k: streamed.append(a[0]) or orig(*a, **k))
    port = tprover.prove(air, trace, tprover.StarkConfig(
        fri=FriConfig(**FRI)), device="cpu")
    assert streamed == [air]
    ref = lookup_prover.prove(air, trace, RStarkConfig(fri=RFriConfig(**FRI)),
                              device="cpu")
    assert json.dumps(proof_to_json(port)) == json.dumps(proof_to_json(ref))


def _config(name):
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    conf = next(c for c in spec["configs"] if c["name"] == name)
    return json.load(open(os.path.join(ROOT, conf["file"])))


def _traffic(name):
    return json.load(open(os.path.join(ROOT, "prover_bench", "traffic",
                                       name + ".json")))


SEED = 2 ** 31 + 19


def test_ladder_statements_follow_the_chunk_split():
    from prover_bench.statements import ed25519_ladder_chunks as mod

    config = dict(_config("zk_justification_300"),
                  max_authority_set_size=20, signers=20)
    st = mod.Statements(config, _traffic("ladder"), SEED, "cpu")
    assert (st.per_chunk, st.chunks) == (16, 1)
    for i in (0, 1, -1):
        j = st.chain.get_justification(1 + i % st.blocks)
        enabled = list(range(20))
        assert zk._enabled_indices(j) == enabled
        digests = [hashlib.sha512(m).digest() for m in zk.challenge_messages(
            j.pubkeys, j.signatures, j.signed_message, enabled)]
        sigs = zk._ladder_sigs(j.pubkeys, j.signatures, j.signed_message,
                               enabled, digests)
        assert zk.ladder_chunk_sizes(len(sigs)) == [16, 4]
        assert st.inputs(i)["sigs"] == sigs[:16]
    assert st.inputs(0)["sigs"] != st.inputs(1)["sigs"]


def test_justification_statements_forge_one_slot():
    from prover_bench.statements import grandpa_justification as mod

    traffic = _traffic("justification")
    config = dict(_config("header_range_256"), max_authority_set_size=20)
    st = mod.Statements(config, traffic, SEED, "cpu")
    slot, every = traffic["forged_slot"], traffic["forged_every"]
    for i in (slot - 1, slot, slot + every):
        inp = st.inputs(i)
        j = inp["justification"]
        honest = st.chain.get_justification(1 + i % st.blocks)
        assert inp["expected"] == (i % every != slot)
        assert inp["set_hash"] == st.chain.compute_authority_set_hash(
            j.block_number - 1)
        diff = [k for k in range(20) if j.signatures[k] !=
                honest.signatures[k]]
        assert len(diff) == (0 if inp["expected"] else 1)
        for k in diff:
            s = int.from_bytes(honest.signatures[k][32:], "little")
            assert j.signatures[k] == honest.signatures[k][:32] + \
                ((s + 1) % ed.L).to_bytes(32, "little")


@pytest.mark.parametrize("forged", [False, True])
def test_simple_justification_verdict_matches_reference(forged):
    chain = FixtureChain(seed=5, num_blocks=4, epoch_length=5,
                         authorities_per_era=lambda era: 4,
                         sign_fraction=1.0)
    j = chain.get_justification(3)
    set_hash = chain.compute_authority_set_hash(2)
    if forged:
        s = int.from_bytes(j.signatures[2][32:], "little")
        j.signatures[2] = j.signatures[2][:32] + \
            ((s + 1) % ed.L).to_bytes(32, "little")
    try:
        verify_simple_justification(j, 3, j.block_hash, j.authority_set_id,
                                    set_hash, signature_backend="device",
                                    device="cpu", rng=random.Random(7))
        port = True
    except JustificationError:
        port = False
    ref = rjust.justification_verdict(
        j.pubkeys, j.signatures, j.validator_signed, j.num_authorities,
        j.signed_message, 3, j.block_hash, j.authority_set_id, set_hash)
    assert port == ref == (not forged)
