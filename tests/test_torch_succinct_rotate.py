"""The succinct rotate in the port against the JAX package, on CPU torch,
at `tests/test_succinct_rotate.py`'s `CFG` and `CHAIN`.

* `_pinned_bytes` equals the reference's, and the real epoch-end header
  carries every pinned byte.
* The header section and both commitment chains on one tape (that test's
  `_build_core`) lower to a machine `Program` equal to the reference's,
  in witness mode (replaying the reference's child proofs, golden
  fixtures, carried over as JSON) and in statement mode.
* A wrong new pubkey, a wrong start position, a tampered output hash and
  a wrong authority count are rejected in the port as in the reference.
* `_statement`'s validation matches the reference's.
* The verifier turns away a new set larger than `max_authorities` and a
  justification of another block before any tape or STARK work.

The machine proof is not run on the CPU; `chip_smoke.py` phase 14 proves
and verifies the statement on the card.
"""

import dataclasses

import pytest
import torch

from test_succinct_rotate import CFG as JCFG
from test_succinct_rotate import (CONSUMED, HEADER, NEW_PUBKEYS, PROOFS, RD,
                                  SET_ID)
from test_succinct_rotate import INP as JINP
from test_succinct_rotate import OUT as JOUT
from test_succinct_rotate import _build_core as j_build_core
from test_succinct_rotate import _meta
from test_torch_recursion import _program_fields, share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from vectorx_tpu.circuits import succinct_rotate as jsrt
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.blake2b_air import Blake2bAir as JBlake2bAir
from vectorx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits import succinct_rotate as srt
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.abi import RotateInput, RotateOutput
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.recursion.ssa import Builder, TapeCheckFailed
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.prover import StarkConfig
from vectorx_tpu_torch.stark.sha256_air import Sha256Air

torch.set_num_threads(1)

# tests/test_succinct_rotate.py's config
CFG = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0, num_queries=2,
                                final_poly_len=2, pow_bits=0))
INP = RotateInput.decode(JINP.encode())
OUT = RotateOutput.decode(JOUT.encode())
# the reference's header and chain child proofs, as port proofs
TPROOFS = [tser.proof_from_json(jser.proof_to_json(p)) for p in PROOFS]


def _share_vks():
    """The port's verification keys of the header and chain children,
    given to the reference."""
    share_vk_caps([Blake2bAir.public_shape([len(HEADER)]),
                   Sha256Air.public_shape([1])],
                  [JBlake2bAir.public_shape([len(HEADER)]),
                   JSha256Air.public_shape([1])], CFG, JCFG)


def _build_core(witness: bool, meta=None, inp=None, out=None):
    """The reference test's `_build_core` on the port: the header section
    and both commitment chains, with the carried child proofs in witness
    mode."""
    meta = meta or _meta()
    inp = inp or INP
    out = out or OUT
    stmt = srt._statement(inp.encode(), out.encode(), meta)
    b = Builder(witness=witness)
    auth_h = [b.public(v, i)
              for i, v in enumerate(srt._words_be(inp.authority_set_hash))]
    new_h = [b.public(v, 8 + i) for i, v in
             enumerate(srt._words_be(out.new_authority_set_hash))]
    cursor = srt._ProofCursor(TPROOFS if witness else None)
    header = HEADER if witness else None
    bh = scale.decode_precommit(stmt["signed_message"])[0]
    srt._header_section(b, stmt, CFG, cursor, header, bh, device="cpu")
    srt._commitment_section(b, stmt["pubkeys"][:1], auth_h, CFG, cursor,
                            witness=witness, device="cpu")
    srt._commitment_section(b, stmt["new_pubkeys"], new_h, CFG, cursor,
                            witness=witness, device="cpu")
    return b


def test_pinned_bytes_match_reference_and_header():
    stmt = srt._statement(INP.encode(), OUT.encode(), _meta())
    pins = srt._pinned_bytes(stmt)
    assert pins == jsrt._pinned_bytes(
        jsrt._statement(JINP.encode(), JOUT.encode(), _meta()))
    assert all(HEADER[o] == v for o, v in pins.items())
    assert HEADER[RD.start_position + 2:RD.start_position + 6] == \
        scale.CONSENSUS_ENGINE_ID


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_core_program_matches_reference(witness):
    _share_vks()
    prog = compile_tape(_build_core(witness))
    jprog = jcompile(j_build_core(witness))
    assert len(prog.publics) == 16
    assert _program_fields(prog) == _program_fields(jprog)


def _wrong_new_pubkey():
    bad = list(NEW_PUBKEYS)
    bad[0] = b"\x07" * 32
    return dict(meta=_meta(new_pubkeys=bad),
                out=RotateOutput(new_authority_set_hash=chained_hash(bad)))


def _wrong_start_position():
    return dict(meta=_meta(start_position=RD.start_position + 1))


def _tampered_output_hash():
    return dict(out=RotateOutput(new_authority_set_hash=b"\x13" * 32))


def _wrong_authority_count():
    bad_keys = NEW_PUBKEYS + [b"\x09" * 32]
    return dict(meta=_meta(num_authorities=2, new_pubkeys=bad_keys),
                out=RotateOutput(new_authority_set_hash=chained_hash(
                    bad_keys)))


@pytest.mark.parametrize("tamper", [_wrong_new_pubkey, _wrong_start_position,
                                    _tampered_output_hash,
                                    _wrong_authority_count],
                         ids=["new_pubkey", "start_position", "output_hash",
                              "authority_count"])
def test_tamper_rejected_as_in_reference(tamper):
    """Each raises in the port where it raises in the reference: a tape
    check, or the statement's own validation."""
    _share_vks()
    kw = tamper()
    with pytest.raises((TapeCheckFailed, ValueError)) as got:
        _build_core(witness=True, **kw)
    # the reference's `_build_core` reads the same ABI fields
    with pytest.raises(Exception) as want:
        j_build_core(witness=True, **kw)
    assert (got.type is ValueError) == (want.type is ValueError)


@pytest.mark.parametrize("over", [
    dict(len_prefix_consumed=3), dict(start_position=len(HEADER)),
    dict(num_authorities=0), dict(header_len=RD.start_position + 20),
    dict(new_pubkeys=[b"\x01" * 31]), dict(start_position=-1), {}],
    ids=["prefix", "start_past_header", "no_authorities", "window_past_end",
         "short_pubkey", "negative_start", "valid"])
def test_statement_validation_matches_reference(over):
    meta = _meta(**over)
    try:
        jsrt._statement(JINP.encode(), JOUT.encode(), meta)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            srt._statement(INP.encode(), OUT.encode(), meta)
        return
    stmt = srt._statement(INP.encode(), OUT.encode(), meta)
    assert stmt["len_prefix_consumed"] == CONSUMED and not over


def test_verifier_rejects_before_the_machine(monkeypatch):
    """Host checks run first: more new authorities than `max_authorities`,
    or a justification of another block or set, never reach the tape."""
    reached = []
    monkeypatch.setattr(srt, "_machine_verify",
                        lambda *a, **kw: reached.append(a) or True)
    m = _meta()
    j_sig = bytes(32) + (1).to_bytes(32, "little")
    p = srt.SuccinctRotateProof(
        input_bytes=INP.encode(), output_bytes=OUT.encode(),
        machine_proof=None, **dict(m, signatures=[j_sig],
                                   validator_signed=[True],
                                   challenge_digests=[bytes(64)]))
    assert srt.verify_rotate_succinct(p, 8, CFG, device="cpu")
    assert len(reached) == 1
    bh, bn, rnd, sid = scale.decode_precommit(p.signed_message)
    for bad, max_auth in (
            (p, 0),
            (dataclasses.replace(p, signed_message=scale.encode_precommit(
                bh, bn + 1, rnd, sid)), 8),
            (dataclasses.replace(p, signed_message=scale.encode_precommit(
                bh, bn, rnd, SET_ID + 1)), 8),
            (dataclasses.replace(p, validator_signed=[False]), 8)):
        assert not srt.verify_rotate_succinct(bad, max_auth, CFG,
                                              device="cpu")
    assert len(reached) == 1
