"""The ZK rotate statement in the port against the JAX package, on CPU
torch, at `tests/test_zk_rotate.py`'s chain (4 authorities) and config.

* Component path: the port's `prove_rotate_zk` gives the reference's
  public fields and the same component proof JSON (the Blake2b header
  proof and the SHA-256 commitment chain); each package's
  `verify_rotate_zk` accepts the other's proof; the four tampers of
  `tests/test_zk_rotate.py` are rejected.
* The aggregated variant is in `test_torch_zk_rotate_agg.py`.
"""

import copy
import dataclasses
import json
import random

import pytest
import torch

from vectorx_tpu.circuits import zk_rotate as jzr
from vectorx_tpu.circuits.zk_commitment import \
    AuthorityCommitmentProof as JCommitment
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.prover import StarkConfig as JStarkConfig
from vectorx_tpu_torch.circuits import DummyRotate
from vectorx_tpu_torch.circuits import zk_rotate as tzr
from vectorx_tpu_torch.circuits.zk_commitment import AuthorityCommitmentProof
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.abi import RotateInput, RotateOutput
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.prover import StarkConfig

from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from test_torch_recursion import share_vk_caps

torch.set_num_threads(1)

KNOBS = dict(rate_bits=3, cap_height=0, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = StarkConfig(fri=FriConfig(**KNOBS))
JCFG = JStarkConfig(fri=JFriConfig(**KNOBS))
CHAIN_ARGS = dict(seed=19, num_blocks=12, epoch_length=6,
                  authorities_per_era=lambda e: 4)
CHAIN = FixtureChain(**CHAIN_ARGS)
JCHAIN = JFixtureChain(**CHAIN_ARGS)
INPUT = RotateInput(1, chained_hash(CHAIN.era_pubkeys(1))).encode()
PUBLIC = ("input_bytes", "output_bytes", "epoch_end_block", "header_bytes",
          "header_size", "num_authorities", "start_position", "header_hash")


def _proofs_of(zk, ser):
    return [json.dumps(ser.proof_to_json(p))
            for p in [zk.header_proof] + list(zk.commitment.step_proofs)]


def _convert(zk, proof_cls, commitment_cls, from_ser, to_ser):
    """A ZkRotateProof of one package as the other's (proofs via JSON)."""
    conv = [to_ser.proof_from_json(from_ser.proof_to_json(p))
            for p in [zk.header_proof] + list(zk.commitment.step_proofs)]
    c = zk.commitment
    return proof_cls(**{f: getattr(zk, f) for f in PUBLIC},
                     header_proof=conv[0], justification=zk.justification,
                     commitment=commitment_cls(
                         pubkeys=list(c.pubkeys),
                         step_digests=list(c.step_digests),
                         chunk_sizes=list(c.chunk_sizes),
                         step_proofs=conv[1:], commitment=c.commitment))


@pytest.fixture(scope="module")
def proofs():
    """(port proof, reference proof); the reference's components load
    from the golden fixtures of `tests/test_zk_rotate.py`."""
    port = tzr.prove_rotate_zk(CHAIN, INPUT, max_authorities=8, config=CFG,
                               device="cpu")
    ref = jzr.prove_rotate_zk(JCHAIN, INPUT, max_authorities=8, config=JCFG)
    return port, ref


def test_component_proofs_match_reference(proofs):
    port, ref = proofs
    for f in PUBLIC:
        assert getattr(port, f) == getattr(ref, f), f
    assert dataclasses.asdict(port.justification) == \
        dataclasses.asdict(ref.justification)
    assert port.commitment.chunk_sizes == ref.commitment.chunk_sizes
    assert _proofs_of(port, tser) == _proofs_of(ref, jser)
    assert port.output_bytes == DummyRotate().run(INPUT, CHAIN)
    out = RotateOutput.decode(port.output_bytes)
    assert out.new_authority_set_hash == chained_hash(CHAIN.era_pubkeys(2))


def test_port_verifier_accepts_reference_proof(proofs):
    ref = _convert(proofs[1], tzr.ZkRotateProof, AuthorityCommitmentProof,
                   jser, tser)
    assert tzr.verify_rotate_zk(ref, max_authorities=8, config=CFG,
                                device="cpu", rng=random.Random(1))


def test_reference_verifier_accepts_port_proof(proofs):
    """The reference gets the children's verification keys the port
    derives (content-addressed by the same key function); the proofs'
    constant openings are Merkle-checked against them."""
    port = proofs[0]
    airs = aggregate_children(port)
    share_vk_caps(airs, airs, CFG, JCFG)
    conv = _convert(port, jzr.ZkRotateProof, JCommitment, tser, jser)
    assert jzr.verify_rotate_zk(conv, max_authorities=8, config=JCFG)


def aggregate_children(zk):
    return tzr.aggregate_children(zk.header_bytes, zk.header_hash,
                                  zk.commitment)


def _tamper_header_hash(p):
    p.header_hash = b"\x00" * 32


def _tamper_output(p):
    p.output_bytes = b"\x11" * 32


def _tamper_header_proof(p):
    z = p.header_proof.trace_at_zeta
    z[0] = ((z[0][0] + 1) % P, z[0][1])


def _tamper_pubkeys(p):
    p.commitment.pubkeys = list(p.commitment.pubkeys)
    p.commitment.pubkeys[0] = b"\x07" * 32


@pytest.mark.parametrize("tamper", [_tamper_header_hash, _tamper_output,
                                    _tamper_header_proof, _tamper_pubkeys],
                         ids=["header_hash", "output", "header_proof",
                              "pubkeys"])
def test_tampered_proof_rejected(proofs, tamper):
    bad = copy.deepcopy(proofs[0])
    tamper(bad)
    assert not tzr.verify_rotate_zk(bad, max_authorities=8, config=CFG,
                                    device="cpu", rng=random.Random(2))
