"""`zk_justification` in the port against the JAX package, on CPU torch.

* The reference test's wiring rejections (`tests/test_zk_justification.py`)
  hold on the port.
* The statement side equals the reference's: the challenge messages, their
  digests, the ladder tuples (A, R, S, h mod L) and the SHA-512 and ladder
  chunk sizes, at the reference test's chain (1 authority), at 20
  authorities (16 signers: one SHA-512 chunk, one full ladder chunk) and
  at 300 (240 signers: 3 SHA-512 and 15 ladder chunks).
* `verify_justification_zk` returns False, and never raises, for garbage
  child proofs: with the port's real commitment and SHA-512 proofs of the
  1-authority statement in place, a garbage ladder proof, a garbage
  SHA-512 proof and a tampered challenge digest are each rejected.
"""

import dataclasses
import hashlib

import pytest
import torch

from vectorx_tpu.circuits import zk_commitment as jcommit
from vectorx_tpu.circuits import zk_justification as jzk
from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.circuits import zk_justification as tzk
from vectorx_tpu_torch.circuits.zk_commitment import (
    AuthorityCommitmentProof, prove_authority_commitment)
from vectorx_tpu_torch.circuits.zk_justification import (
    ZkJustificationProof, verify_justification_zk)
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import vk
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.stark.sha512_air import Sha512Air

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


# the config of tests/test_zk_justification.py
CFG = tstark.StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0,
                                       num_queries=12, final_poly_len=4,
                                       pow_bits=0))
CHAIN_ARGS = dict(seed=23, num_blocks=8, epoch_length=4)
CHAIN = FixtureChain(**CHAIN_ARGS, authorities_per_era=lambda e: 1)


def _setup(chain=CHAIN, block=3):
    j = chain.get_justification(block)
    set_hash = chained_hash(chain.era_pubkeys(j.authority_set_id))
    return j, set_hash


def _verify(proof, j, set_hash, **kw):
    args = dict(block_number=j.block_number, block_hash=j.block_hash,
                authority_set_id=j.authority_set_id)
    args.update(kw)
    return verify_justification_zk(proof, args["block_number"],
                                   args["block_hash"],
                                   args["authority_set_id"], set_hash, CFG,
                                   device="cpu")


def test_wiring_rejections_without_valid_proofs():
    j, set_hash = _setup()
    fake_commit = AuthorityCommitmentProof(
        pubkeys=list(j.pubkeys[:j.num_authorities]),
        step_digests=[set_hash], chunk_sizes=[1],
        step_proofs=[object()], commitment=set_hash)
    fake = ZkJustificationProof(
        signed_message=j.signed_message, pubkeys=list(j.pubkeys),
        signatures=list(j.signatures),
        validator_signed=list(j.validator_signed),
        num_authorities=j.num_authorities,
        challenge_digests=[b"\x00" * 64] * sum(j.validator_signed),
        commitment_proof=fake_commit,
        sha_chunk_sizes=[sum(j.validator_signed)], sha_proofs=[object()],
        ladder_chunk_sizes=[sum(j.validator_signed)],
        ladder_proofs=[object()])
    # garbage proof objects cannot verify
    assert not _verify(fake, j, set_hash)
    # wrong block number
    assert not _verify(fake, j, set_hash, block_number=j.block_number + 1)
    # threshold failure: no validators marked
    fake.validator_signed = [False] * len(fake.validator_signed)
    assert not _verify(fake, j, set_hash)


def test_tail_entry_outside_set_rejected():
    j, set_hash = _setup()
    fake = ZkJustificationProof(
        signed_message=j.signed_message,
        pubkeys=list(j.pubkeys) + [b"\x01" * 32],
        signatures=list(j.signatures) + [b"\x02" * 64],
        validator_signed=list(j.validator_signed) + [True],
        num_authorities=j.num_authorities,
        challenge_digests=[], commitment_proof=None,
        sha_chunk_sizes=[], sha_proofs=[],
        ladder_chunk_sizes=[], ladder_proofs=[])
    assert not _verify(fake, j, set_hash)


def _reference_statement(j):
    """The reference's statement side, as its `prove_justification_zk`
    builds it."""
    enabled = jzk._enabled_indices(j)
    msgs = [j.signatures[i][:32] + j.pubkeys[i] + j.signed_message
            for i in enabled]
    digests = [hashlib.sha512(m).digest() for m in msgs]
    sigs = jzk._ladder_sigs(j.pubkeys, j.signatures, j.signed_message,
                            enabled, digests)
    per_proof = max(1, jzk.MAX_LADDER_ROWS // (4 * 253 + 4))
    return dict(enabled=enabled, msgs=msgs, digests=digests, sigs=sigs,
                sha=jcommit.chunk_by_rows(msgs, jzk._sha512_rows),
                ladder=[len(sigs[i:i + per_proof])
                        for i in range(0, len(sigs), per_proof)])


def _port_statement(j):
    enabled = tzk._enabled_indices(j)
    msgs = tzk.challenge_messages(j.pubkeys, j.signatures, j.signed_message,
                                  enabled)
    digests = [Sha512Air(m).digest_bytes() for m in msgs]
    sigs = tzk._ladder_sigs(j.pubkeys, j.signatures, j.signed_message,
                            enabled, digests)
    return dict(enabled=enabled, msgs=msgs, digests=digests, sigs=sigs,
                sha=tzk.chunk_by_rows(msgs, tzk._sha512_rows),
                ladder=tzk.ladder_chunk_sizes(len(sigs)))


@pytest.mark.parametrize("authorities,signers,sha,ladder", [
    (1, 1, [1], [1]),
    (20, 16, [16], [16]),
    (300, 240, [100, 100, 40], [16] * 15)])
def test_statement_side_matches_reference(authorities, signers, sha,
                                          ladder):
    chain = FixtureChain(**CHAIN_ARGS,
                         authorities_per_era=lambda e: authorities)
    jchain = JFixtureChain(**CHAIN_ARGS,
                           authorities_per_era=lambda e: authorities)
    j, jj = chain.get_justification(3), jchain.get_justification(3)
    assert (j.pubkeys, j.signatures, j.signed_message) == \
        (jj.pubkeys, jj.signatures, jj.signed_message)
    got, want = _port_statement(j), _reference_statement(jj)
    assert got == want
    assert len(got["enabled"]) == signers
    assert (got["sha"], got["ladder"]) == (sha, ladder)
    assert tzk._sha512_rows(got["msgs"][0]) == 163     # 117 B, 2 blocks


@pytest.fixture(scope="module")
def partial():
    """A 1-authority statement whose commitment and SHA-512 proofs are the
    port's real proofs; the ladder proof is left for each test to fill."""
    j, set_hash = _setup()
    enabled = tzk._enabled_indices(j)
    msgs = tzk.challenge_messages(j.pubkeys, j.signatures, j.signed_message,
                                  enabled)
    air = Sha512Air(msgs)
    commitment = prove_authority_commitment(
        j.pubkeys[:j.num_authorities], CFG, device="cpu")
    sha_proof = tstark.prove(air, air.build_trace(), CFG, device="cpu")
    proof = ZkJustificationProof(
        signed_message=j.signed_message, pubkeys=list(j.pubkeys),
        signatures=list(j.signatures),
        validator_signed=list(j.validator_signed),
        num_authorities=j.num_authorities,
        challenge_digests=air.digest_bytes_list(),
        commitment_proof=commitment,
        sha_chunk_sizes=[len(msgs)], sha_proofs=[sha_proof],
        ladder_chunk_sizes=[len(msgs)], ladder_proofs=[object()])
    return j, set_hash, proof


@pytest.mark.parametrize("child", ["ladder", "sha512", "digest"])
def test_garbage_child_proof_rejected_without_raising(partial, child,
                                                      monkeypatch):
    """Each malformed child is a rejection from the child's own verify:
    the children verified before it accept."""
    j, set_hash, proof = partial
    sha_proof = proof.sha_proofs[0]
    if child == "ladder":
        # a SHA-512 proof, or no proof at all, as the ladder proof
        bad = [dataclasses.replace(proof, ladder_proofs=[sha_proof]),
               proof]
    elif child == "sha512":
        bad = [dataclasses.replace(proof, sha_proofs=[object()]),
               dataclasses.replace(proof, sha_proofs=[
                   proof.commitment_proof.step_proofs[0]])]
    else:
        bad = [dataclasses.replace(proof,
                                   challenge_digests=[b"\xff" * 64])]
    # the child verifies that run: every one accepts but the last
    want = {"ladder": ["Sha512Air", "Ed25519LadderAir"],
            "sha512": ["Sha512Air"], "digest": ["Sha512Air"]}[child]
    seen = []

    def recorded(air, stark, config, device, _orig=tzk._safe_verify):
        ok = _orig(air, stark, config, device)
        seen.append((type(air).__name__, ok))
        return ok

    monkeypatch.setattr(tzk, "_safe_verify", recorded)
    for p in bad:
        seen.clear()
        assert _verify(p, j, set_hash) is False
        assert seen == [(name, True) for name in want[:-1]] + \
            [(want[-1], False)]
