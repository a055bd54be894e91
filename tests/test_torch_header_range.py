"""The header_range statement in the port against the JAX package, on CPU
torch (exact byte equality throughout).

* SCALE and ABI round trips encode to the reference's bytes; the fixture
  chain's headers, hashes and commitments equal the reference chain's.
* `verify_subchain` and `HeaderRangeCircuit.run` give the reference's
  `DummyHeaderRange` output; `RotateCircuit.run` and `rotate` give the
  reference's next-set commitment; the justification and rotate
  rejections of `tests/test_circuits.py` reject in the port too, the
  justification ones on both signature backends.
* The tree=2 `prove_header_range_zk` of `tests/test_zk_header_range.py`
  (same chain, same config, so the reference's component proofs load from
  the golden fixtures): every component proof's JSON equals the
  reference's, the port's verifier accepts the proof and rejects tampered
  or structurally wrong ones.
"""

import dataclasses
import json
import random

import pytest
import torch

from vectorx_tpu import scale as jscale
from vectorx_tpu.circuits import DummyHeaderRange, DummyRotate
from vectorx_tpu.circuits import RotateCircuit as JRotateCircuit
from vectorx_tpu.circuits.rotate import rotate as jrotate
from vectorx_tpu.circuits.zk_header_range import \
    prove_header_range_zk as jprove_zk
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.io import abi as jabi
from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu.stark.prover import StarkConfig as JStarkConfig
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits import (HeaderRangeCircuit, RotateCircuit,
                                        RotateError, SubchainError,
                                        verify_subchain)
from vectorx_tpu_torch.circuits.rotate import rotate, verify_epoch_end_header
from vectorx_tpu_torch.circuits.justification import (
    JustificationError, verify_simple_justification)
from vectorx_tpu_torch.circuits.zk_header_range import (
    ZkHeaderRangeProof, prove_header_range_zk, verify_header_range_zk)
from vectorx_tpu_torch.curves import ed25519
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io import abi
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.stark.prover import StarkConfig
from vectorx_tpu_torch.stark import serialize as tser

torch.set_num_threads(1)


def _chains(**kw):
    return FixtureChain(**kw), JFixtureChain(**kw)


CIRCUIT_KW = dict(seed=7, num_blocks=70, epoch_length=24,
                  authorities_per_era=lambda e: 5)
CHAIN, JCHAIN = _chains(**CIRCUIT_KW)


def hr_input(chain, trusted, target, set_id):
    return abi.HeaderRangeInput(
        trusted_block=trusted,
        trusted_header_hash=chain.get_block_hash(trusted),
        authority_set_id=set_id,
        authority_set_hash=chained_hash(chain.era_pubkeys(set_id)),
        target_block=target).encode()


def test_scale_and_abi_round_trips_match_reference():
    for v in (0, 1, 63, 64, 16383, 16384, 2**30 - 1, 2**30, 2**32 - 1):
        enc = scale.compact_encode(v)
        assert enc == jscale.compact_encode(v)
        assert scale.compact_decode(enc + bytes(4)) == \
            jscale.compact_decode(enc + bytes(4))
    pre = scale.encode_precommit(b"\x09" * 32, 317857, 42, 298)
    assert pre == jscale.encode_precommit(b"\x09" * 32, 317857, 42, 298)
    assert scale.decode_precommit(pre) == (b"\x09" * 32, 317857, 42, 298)
    fields = dict(parent_hash=b"\x01" * 32, block_number=123456,
                  state_root=b"\x02" * 32, extrinsics_root=b"\x03" * 32,
                  digest_logs=[scale.encode_other_log(b"abc"),
                               scale.encode_scheduled_change_log(
                                   [b"\x05" * 32] * 3)],
                  extension_filler=b"\x06" * 50, data_root=b"\x07" * 32)
    enc = scale.Header(**fields).encode()
    assert enc == jscale.Header(**fields).encode()
    assert scale.decode_header(enc).encode() == enc
    inp = abi.HeaderRangeInput(5, b"\x11" * 32, 3, b"\x22" * 32, 21)
    raw = inp.encode()
    assert raw == jabi.HeaderRangeInput(5, b"\x11" * 32, 3, b"\x22" * 32,
                                        21).encode()
    assert abi.HeaderRangeInput.decode(raw) == inp
    out = abi.HeaderRangeOutput(b"\x01" * 32, b"\x02" * 32, b"\x03" * 32)
    assert abi.HeaderRangeOutput.decode(out.encode()) == out
    assert abi.RotateInput(4, b"\x05" * 32).encode() == \
        jabi.RotateInput(4, b"\x05" * 32).encode()


def test_fixture_chain_matches_reference():
    for b in (0, 1, 23, 24, 25, 69):
        assert CHAIN.get_encoded_header(b) == JCHAIN.get_encoded_header(b)
        assert CHAIN.get_block_hash(b) == JCHAIN.get_block_hash(b)
    assert CHAIN.era_pubkeys(2) == JCHAIN.era_pubkeys(2)
    j, jj = CHAIN.get_justification(20), JCHAIN.get_justification(20)
    assert (j.signatures, j.validator_signed, j.signed_message) == \
        (jj.signatures, jj.validator_signed, jj.signed_message)
    assert CHAIN.get_merkle_root_commitments(32, 3, 20) == \
        JCHAIN.get_merkle_root_commitments(32, 3, 20)


def test_subchain_matches_reference_commitments():
    out = verify_subchain(CHAIN, 3, CHAIN.get_block_hash(3), 20,
                          max_num_headers=32, device="cpu")
    assert out.target_header_hash == JCHAIN.get_block_hash(20)
    assert (out.state_root_merkle_root, out.data_root_merkle_root) == \
        JCHAIN.get_merkle_root_commitments(32, 3, 20)
    with pytest.raises(SubchainError):
        verify_subchain(CHAIN, 3, b"\x00" * 32, 20, max_num_headers=32,
                        device="cpu")


@pytest.mark.parametrize("trusted,target,set_id,tree",
                         [(5, 21, 0, 32), (24, 40, 1, 16)])
def test_header_range_circuit_matches_reference_dummy(trusted, target,
                                                      set_id, tree):
    circuit = HeaderRangeCircuit(max_authority_set_size=8,
                                 max_num_headers=tree)
    out = circuit.run(hr_input(CHAIN, trusted, target, set_id), CHAIN,
                      device="cpu")
    assert out == DummyHeaderRange(tree).run(
        hr_input(JCHAIN, trusted, target, set_id), JCHAIN)


def test_header_range_rejects_wrong_set():
    circuit = HeaderRangeCircuit(max_authority_set_size=8,
                                 max_num_headers=16)
    with pytest.raises(JustificationError):
        circuit.run(hr_input(CHAIN, 5, 21, 1), CHAIN, device="cpu")


def test_rotate_circuit_matches_reference():
    """`RotateCircuit.run` and `rotate` give the reference's commitment of
    the next authority set; a wrong current-set hash, an attested region
    cut inside the validator list and an authority bound below the set
    size are rejected, as in `tests/test_circuits.py`."""
    inp = abi.RotateInput(1, chained_hash(CHAIN.era_pubkeys(1))).encode()
    out = RotateCircuit(max_authority_set_size=8).run(inp, CHAIN)
    assert out == JRotateCircuit(max_authority_set_size=8).run(inp, JCHAIN)
    assert out == DummyRotate().run(inp, JCHAIN)
    assert out == chained_hash(CHAIN.era_pubkeys(2))

    end = CHAIN.last_justified_block(1)
    assert end == JCHAIN.last_justified_block(1)
    rd = CHAIN.get_header_rotate(end, max_authorities=8, max_header_size=4096)
    jrd = JCHAIN.get_header_rotate(end, max_authorities=8,
                                   max_header_size=4096)
    just = CHAIN.get_justification(end, max_authorities=8)
    args = (1, chained_hash(CHAIN.era_pubkeys(1)), end, 8)
    assert rotate(rd, just, *args) == jrotate(
        jrd, JCHAIN.get_justification(end, max_authorities=8), *args)

    with pytest.raises(JustificationError):
        RotateCircuit(max_authority_set_size=8).run(
            abi.RotateInput(1, b"\x11" * 32).encode(), CHAIN)
    with pytest.raises(RotateError):
        verify_epoch_end_header(rd.header_bytes, rd.start_position + 8,
                                rd.num_authorities, rd.start_position,
                                rd.padded_pubkeys, 8)
    with pytest.raises(RotateError):
        verify_epoch_end_header(rd.header_bytes, rd.header_size,
                                rd.num_authorities, rd.start_position,
                                rd.padded_pubkeys,
                                max_authorities=rd.num_authorities - 1)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_justification_rejects_tail_entries_beyond_authority_set(backend):
    j = CHAIN.get_justification(20)
    args = (20, CHAIN.get_block_hash(20), 0,
            chained_hash(CHAIN.era_pubkeys(0)))
    kw = dict(signature_backend=backend, device="cpu",
              rng=random.Random(2))
    verify_simple_justification(j, *args, **kw)   # valid as fetched

    attacker = b"\x66" * 32
    bad = dataclasses.replace(
        j, validator_signed=list(j.validator_signed) + [True],
        pubkeys=list(j.pubkeys) + [ed25519.public_key(attacker)],
        signatures=list(j.signatures) + [ed25519.sign(attacker,
                                                      j.signed_message)])
    bad2 = dataclasses.replace(j, signatures=list(j.signatures)
                               + [b"\x00" * 64])
    bad3 = dataclasses.replace(j, num_authorities=len(j.pubkeys) + 1)
    forged = list(j.signatures)
    first = j.validator_signed.index(True)
    forged[first] = bytes(64)
    bad4 = dataclasses.replace(j, signatures=forged)
    for b in (bad, bad2, bad3, bad4):
        with pytest.raises(JustificationError):
            verify_simple_justification(b, *args, **kw)


# ---------------------------------------------------------------------------
# header_range in zero knowledge, tree = 2
# ---------------------------------------------------------------------------

KNOBS = dict(rate_bits=3, cap_height=0, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = StarkConfig(fri=FriConfig(**KNOBS))
JCFG = JStarkConfig(fri=JFriConfig(**KNOBS))
ZK_KW = dict(seed=19, num_blocks=12, epoch_length=6,
             authorities_per_era=lambda e: 4)


@pytest.fixture(scope="module")
def zk_reference():
    """(port chain, input, reference proof); the reference's component
    proofs load from the golden fixtures."""
    chain, jchain = _chains(**ZK_KW)
    inp = hr_input(chain, 7, 9, 1)
    ref = jprove_zk(jchain, inp, tree_size=2, max_authorities=8, config=JCFG)
    return chain, inp, ref


@pytest.fixture(scope="module")
def zk(zk_reference):
    """(port chain, input, port proof, reference proof)."""
    chain, inp, ref = zk_reference
    proof = prove_header_range_zk(chain, inp, tree_size=2, max_authorities=8,
                                  config=CFG, device="cpu")
    return chain, inp, proof, ref


def test_zk_component_proofs_match_reference(zk):
    _, _, proof, ref = zk
    assert len(proof.header_proofs) == len(proof.sha_proofs) == 1
    for mine, theirs in zip(proof.header_proofs + proof.sha_proofs,
                            ref.header_proofs + ref.sha_proofs):
        assert json.dumps(tser.proof_to_json(mine)) == \
            json.dumps(jser.proof_to_json(theirs))
    assert (proof.output_bytes, proof.header_hashes, proof.state_levels,
            proof.data_levels, proof.header_chunk_sizes,
            proof.sha_chunk_sizes) == \
        (ref.output_bytes, ref.header_hashes, ref.state_levels,
         ref.data_levels, ref.header_chunk_sizes, ref.sha_chunk_sizes)


def test_zk_header_range_verifies_and_tampering_rejects(zk):
    chain, inp, proof, _ = zk
    assert proof.output_bytes == DummyHeaderRange(2).run(inp, chain)
    assert verify_header_range_zk(proof, tree_size=2, config=CFG,
                                  device="cpu", rng=random.Random(5))
    bad = dataclasses.replace(proof, header_hashes=[b"\x00" * 32]
                              + list(proof.header_hashes[1:]))
    assert not verify_header_range_zk(bad, tree_size=2, config=CFG,
                                      device="cpu")
    # a valid SHA proof of another statement in place of this one
    swapped = dataclasses.replace(
        proof, sha_proofs=[tser.proof_from_json(tser.proof_to_json(
            proof.header_proofs[0]))])
    assert not verify_header_range_zk(swapped, tree_size=2, config=CFG,
                                      device="cpu")


def test_wiring_rejections_without_valid_proofs(zk):
    chain, inp, _, _ = zk
    headers = [chain.get_encoded_header(8), chain.get_encoded_header(9)]
    hashes = [chain.get_block_hash(8), chain.get_block_hash(9)]
    out = abi.HeaderRangeOutput(hashes[-1], b"\x00" * 32,
                                b"\x00" * 32).encode()
    just = chain.get_justification(9, max_authorities=8)
    fake = ZkHeaderRangeProof(
        input_bytes=inp, output_bytes=out, headers=headers,
        header_hashes=hashes, header_chunk_sizes=[2],
        header_proofs=[object()], state_levels=[], data_levels=[],
        sha_chunk_sizes=[], sha_proofs=[], justification=just)
    assert not verify_header_range_zk(fake, tree_size=2, config=CFG,
                                      device="cpu")
    fake2 = dataclasses.replace(fake, headers=headers[:1],
                                header_hashes=hashes[:1],
                                header_chunk_sizes=[1])
    assert not verify_header_range_zk(fake2, tree_size=2, config=CFG,
                                      device="cpu")
