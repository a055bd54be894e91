"""The succinct header_range in the port against the JAX package, on CPU
torch, at `tests/test_succinct_header_range.py`'s `CFG` and `CHAIN`.

* The chain and both commitment trees on one tape (that test's
  `_build_sections`) lower to a machine `Program` equal to the
  reference's, in witness mode (replaying the reference's child proofs,
  golden fixtures, carried over as JSON) and in statement mode, with 32
  equal publics.
* The whole statement-mode `_range_tape`, the justification's SHA-512
  and ladder children included, lowers to the reference's `Program`.
* The reference's tamper cases raise `TapeCheckFailed` in the port, and
  `_statement` rejects the shapes the reference's rejects.
* `_justification_children` gives the reference's SHA-512 and ladder
  statements at 1 and 4 authorities.
* The verifier's bookkeeping rejects a bad precommit, a tail
  `validator_signed` entry, a count under the threshold, a non-canonical
  S and a wrong digest count before any tape or STARK work.

The machine proof is not run on the CPU; `chip_smoke.py` phase 13 proves
and verifies the statement on the card.
"""

import dataclasses
import hashlib

import pytest
import torch

from test_succinct_header_range import (CHAIN_PROOFS, DATA_LEAVES, HEADERS,
                                        STATE_LEAVES, TREE_PROOFS)
from test_succinct_header_range import CFG as JCFG
from test_succinct_header_range import CHAIN as JCHAIN
from test_succinct_header_range import INP as JINP
from test_succinct_header_range import OUT as JOUT
from test_succinct_header_range import _build_sections as j_build_sections
from test_torch_recursion import _program_fields, share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from vectorx_tpu.circuits import succinct_header_range as jshr
from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.recursion.ssa import Builder as JBuilder
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.blake2b_air import Blake2bAir as JBlake2bAir
from vectorx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits import DummyHeaderRange
from vectorx_tpu_torch.circuits import succinct_header_range as shr
from vectorx_tpu_torch.curves.ed25519 import L
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.abi import HeaderRangeInput, HeaderRangeOutput
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.recursion.ssa import Builder, TapeCheckFailed
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.prover import StarkConfig
from vectorx_tpu_torch.stark.sha256_air import Sha256Air

torch.set_num_threads(1)

# tests/test_succinct_header_range.py's config and chain
CFG = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0, num_queries=2,
                                final_poly_len=2, pow_bits=0))
CHAIN_ARGS = dict(seed=19, num_blocks=12, epoch_length=6)
CHAIN = FixtureChain(**CHAIN_ARGS, authorities_per_era=lambda e: 1)
INP = HeaderRangeInput.decode(JINP.encode())
OUT = HeaderRangeOutput.decode(JOUT.encode())
LENS = [len(h) for h in HEADERS]
# the reference's chain and tree child proofs, as port proofs
PROOFS = [tser.proof_from_json(jser.proof_to_json(p))
          for p in CHAIN_PROOFS + TREE_PROOFS]


def _share_section_vks():
    """The port's verification keys of the chain and tree children, given
    to the reference (its own derivation costs minutes on XLA:CPU)."""
    share_vk_caps([Blake2bAir.public_shape(LENS), Sha256Air.public_shape([2])],
                  [JBlake2bAir.public_shape(LENS),
                   JSha256Air.public_shape([2])], CFG, JCFG)


def _build_sections(witness: bool, out=None, inp=None):
    """The reference test's `_build_sections` on the port: the chain and
    both trees on one tape, with the carried child proofs in witness
    mode."""
    out = out or OUT
    inp = inp or INP
    b = Builder(witness=witness)
    trusted_h = [b.public(v, i) for i, v in
                 enumerate(shr._limbs32(inp.trusted_header_hash))]
    final_h = [b.public(v, 8 + i) for i, v in
               enumerate(shr._limbs32(out.target_header_hash))]
    state_root_h = [b.public(v, 16 + i) for i, v in
                    enumerate(shr._words_be(out.state_root_commitment))]
    data_root_h = [b.public(v, 24 + i) for i, v in
                   enumerate(shr._words_be(out.data_root_commitment))]
    stmt = {"inp": inp, "header_lens": LENS}
    cursor = shr._ProofCursor(PROOFS if witness else None)
    headers = HEADERS if witness else None
    sw, dw = shr._chain_section(b, stmt, CFG, cursor, headers, trusted_h,
                                final_h, device="cpu")
    shr._tree_section(b, sw, 2, state_root_h, CFG, cursor,
                      STATE_LEAVES if witness else None, "st", device="cpu")
    shr._tree_section(b, dw, 2, data_root_h, CFG, cursor,
                      DATA_LEAVES if witness else None, "dt", device="cpu")
    return b


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_sections_program_matches_reference(witness):
    _share_section_vks()
    prog = compile_tape(_build_sections(witness))
    jprog = jcompile(j_build_sections(witness))
    assert len(prog.publics) == 32
    assert _program_fields(prog) == _program_fields(jprog)


def _bad_output():
    return HeaderRangeOutput(OUT.target_header_hash, b"\x00" * 32,
                             OUT.data_root_commitment), None


def _bad_block_number():
    return None, HeaderRangeInput(
        INP.trusted_block + 1, INP.trusted_header_hash,
        INP.authority_set_id, INP.authority_set_hash, INP.target_block + 1)


def _bad_trusted_hash():
    return None, HeaderRangeInput(
        INP.trusted_block, b"\x11" * 32, INP.authority_set_id,
        INP.authority_set_hash, INP.target_block)


@pytest.mark.parametrize("tamper", [_bad_output, _bad_block_number,
                                    _bad_trusted_hash],
                         ids=["state_commitment", "block_number_pin",
                              "trusted_hash"])
def test_tampered_statement_raises(tamper):
    _share_section_vks()
    out, inp = tamper()
    with pytest.raises(TapeCheckFailed):
        _build_sections(witness=True, out=out, inp=inp)


NO_JUSTIFICATION = {"signed_message": b"\x00" * 53, "pubkeys": [],
                    "signatures": [], "validator_signed": [],
                    "num_authorities": 0, "challenge_digests": []}


@pytest.mark.parametrize("lens,tree", [([100], 2), ([100, 100], 3),
                                       ([100, 100], 1), ([], 2),
                                       ([100, 100], 2)])
def test_statement_validation_matches_reference(lens, tree):
    args = (INP.encode(), OUT.encode(), lens, tree, NO_JUSTIFICATION)
    try:
        want = jshr._statement(*args)
    except ValueError:
        with pytest.raises(ValueError):
            shr._statement(*args)
        return
    got = shr._statement(*args)
    assert (got["inp"].encode(), got["out"].encode()) == \
        (want["inp"].encode(), want["out"].encode())
    assert got["header_lens"] == want["header_lens"] == lens


def _jfields(j) -> dict:
    """The reference prover's justification fields for `j`."""
    enabled = [i for i in range(j.num_authorities) if j.validator_signed[i]]
    msgs = [j.signatures[i][:32] + j.pubkeys[i] + j.signed_message
            for i in enabled]
    return {"signed_message": j.signed_message, "pubkeys": list(j.pubkeys),
            "signatures": list(j.signatures),
            "validator_signed": list(j.validator_signed),
            "num_authorities": j.num_authorities,
            "challenge_digests": [hashlib.sha512(m).digest() for m in msgs]}


@pytest.mark.parametrize("authorities", [1, 4])
def test_justification_children_match_reference(authorities):
    j = FixtureChain(**CHAIN_ARGS, authorities_per_era=lambda e: authorities
                     ).get_justification(INP.target_block)
    jj = JFixtureChain(**CHAIN_ARGS, authorities_per_era=lambda e: authorities
                       ).get_justification(INP.target_block)
    fields = shr._justification_fields(j)
    assert fields == _jfields(jj)
    msgs, sha, ladder = shr._justification_children(fields)
    jmsgs, jsha, jladder = jshr._justification_children(_jfields(jj))
    assert msgs == jmsgs and len(msgs) == sum(j.validator_signed)
    assert [len(a.messages) for a in sha] == \
        [len(a.messages) for a in jsha] == [len(msgs)]
    assert [a.public_inputs() for a in sha] == \
        [a.public_inputs() for a in jsha]
    assert [a.sigs for a in ladder] == [a.sigs for a in jladder]
    assert [len(a.sigs) for a in ladder] == [len(msgs)]
    assert [(a.log_n, a.width, a.public_inputs()) for a in ladder] == \
        [(a.log_n, a.width, a.public_inputs()) for a in jladder]


def _range_stmt(mod, chain):
    j = chain.get_justification(INP.target_block)
    fields = shr._justification_fields(j) if mod is shr else _jfields(j)
    return mod._statement(INP.encode(), OUT.encode(), LENS, 2, fields)


def test_range_tape_statement_mode_matches_reference():
    """The verifier's whole tape, justification children included."""
    stmt = _range_stmt(shr, CHAIN)
    jstmt = _range_stmt(jshr, JCHAIN)
    auth = stmt["pubkeys"][:stmt["num_authorities"]]
    _, sha, ladder = shr._justification_children(stmt)
    _, jsha, jladder = jshr._justification_children(jstmt)
    _share_section_vks()
    share_vk_caps([Sha256Air.public_shape([1] * len(auth))] + sha + ladder,
                  [JSha256Air.public_shape([1] * len(auth))] + jsha + jladder,
                  CFG, JCFG)
    b = Builder(witness=False)
    shr._range_tape(b, stmt, CFG, shr._ProofCursor(None), None,
                    device="cpu")
    jb = JBuilder(witness=False)
    jshr._range_tape(jb, jstmt, JCFG, jshr._ProofCursor(None), None)
    prog, jprog = compile_tape(b), jcompile(jb)
    assert len(prog.publics) == 40
    assert _program_fields(prog) == _program_fields(jprog)
    assert shr._stmt_prog_key(stmt, CFG) != \
        shr._stmt_prog_key(dict(stmt, tree_size=4), CFG)


# ---- the verifier's host bookkeeping ----------------------------------------

CHAIN4 = FixtureChain(**CHAIN_ARGS, authorities_per_era=lambda e: 4)


def _unproved(chain):
    """A proof object of the 4-authority chain's range with every public
    field real and no machine proof."""
    inp = HeaderRangeInput(INP.trusted_block,
                           chain.get_block_hash(INP.trusted_block),
                           INP.authority_set_id,
                           chained_hash(chain.era_pubkeys(
                               INP.authority_set_id)),
                           INP.target_block).encode()
    j = chain.get_justification(INP.target_block)
    lens = [len(chain.get_encoded_header(n)) for n in
            range(INP.trusted_block + 1, INP.target_block + 1)]
    return shr.SuccinctHeaderRangeProof(
        input_bytes=inp, output_bytes=DummyHeaderRange(2).run(inp, chain),
        header_lens=lens, tree_size=2, machine_proof=None,
        **shr._justification_fields(j))


def _bookkeeping_cases(p):
    bh, bn, rnd, sid = scale.decode_precommit(p.signed_message)
    first = p.validator_signed.index(True)
    s_big = (L + 1).to_bytes(32, "little")
    sigs = list(p.signatures)
    sigs[first] = sigs[first][:32] + s_big
    n = p.num_authorities
    return {
        "precommit_block": dataclasses.replace(
            p, signed_message=scale.encode_precommit(bh, bn + 1, rnd, sid)),
        "precommit_garbage": dataclasses.replace(p, signed_message=b"\x01"),
        "tail_entry": dataclasses.replace(
            p, pubkeys=p.pubkeys + [b"\x05" * 32],
            signatures=p.signatures + [bytes(64)],
            validator_signed=p.validator_signed + [True]),
        "under_threshold": dataclasses.replace(
            p, validator_signed=[i < (2 * n) // 3 for i in range(n)],
            challenge_digests=p.challenge_digests[:(2 * n) // 3]),
        "non_canonical_s": dataclasses.replace(p, signatures=sigs),
        "digest_count": dataclasses.replace(
            p, challenge_digests=p.challenge_digests[:-1]),
    }


def test_verifier_bookkeeping_rejects_before_the_machine(monkeypatch):
    p = _unproved(CHAIN4)
    reached = []
    monkeypatch.setattr(shr, "_machine_verify",
                        lambda *a, **kw: reached.append(a) or True)
    cases = _bookkeeping_cases(p)
    for name, bad in cases.items():
        assert not shr.verify_header_range_succinct(bad, CFG, device="cpu"), \
            name
    assert reached == []
    assert shr.verify_header_range_succinct(p, CFG, device="cpu")
    assert len(reached) == 1
    # the reference turns the same proofs away on its host checks
    jp = jshr.SuccinctHeaderRangeProof(**{
        f.name: getattr(p, f.name)
        for f in dataclasses.fields(jshr.SuccinctHeaderRangeProof)})
    for name, bad in _bookkeeping_cases(jp).items():
        assert not jshr.verify_header_range_succinct(bad, JCFG), name
