"""`recursion.succinct` in the port against the JAX package, on CPU torch,
at the configs and statements of `tests/test_recursion_succinct.py` (the
4-leaf SHA-256 tree) and `tests/test_hash_chain.py` (two linked headers).

* `_tree_levels` and `sha_tree_root` equal the reference's, and
  `_tree_key` and `_chain_key` hash the reference's parts.
* `_tree_tape` and `_chain_tape` lower to machine `Program`s equal to the
  reference's in statement mode and in witness mode (replaying the
  reference tests' child proofs, golden fixtures, carried over as JSON);
  the reference gets the port's verification keys of the children.
* Headers that do not link fail the witness tape with `TapeCheckFailed`,
  as in the reference.
* The verifiers reject a malformed proof instead of raising.

The machine proofs are not run on the CPU (the reference slow-gates its
own round trips); `chip_smoke.py` phase 16 proves and verifies both
statements on the card.
"""

import hashlib

import pytest
import torch

from test_hash_chain import CFG as JCFG
from test_hash_chain import CHILD as JCHILD
from test_hash_chain import FINAL, HEADERS, LENS, TRUSTED
from test_recursion_succinct import CFG as JTREE_CFG
from test_recursion_succinct import LEAVES
from test_torch_recursion import _program_fields, share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from vectorx_tpu.recursion import succinct as jsucc
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.recursion.ssa import Builder as JBuilder
from vectorx_tpu.stark import prove as jprove
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.blake2b_air import Blake2bAir as JBlake2bAir
from vectorx_tpu.stark.sha256_air import Sha256Air as JSha256Air
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.recursion import succinct
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.recursion.ssa import Builder, TapeCheckFailed
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.prover import StarkConfig
from vectorx_tpu_torch.stark.sha256_air import Sha256Air

torch.set_num_threads(1)

# both reference tests' config
CFG = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=1, num_queries=2,
                                final_poly_len=2, pow_bits=1))
ROOT = succinct.sha_tree_root(LEAVES)


def _carry(proof):
    """A reference proof as a port proof."""
    return tser.proof_from_json(jser.proof_to_json(proof))


def _tree_child_proofs():
    """The reference test's level proofs (golden fixtures)."""
    levels = jsucc._tree_levels(LEAVES)
    out = []
    for msgs in ([LEAVES[0] + LEAVES[1], LEAVES[2] + LEAVES[3]],
                 [levels[0][0] + levels[0][1]]):
        air = JSha256Air(msgs, bind="public")
        out.append(jprove(air, air.build_trace(), JTREE_CFG))
    return levels, out


def test_tree_and_keys_match_reference():
    leaves8 = [hashlib.sha256(bytes([i])).digest() for i in range(8)]
    for leaves in (LEAVES, leaves8):
        assert succinct._tree_levels(leaves) == jsucc._tree_levels(leaves)
        assert succinct.sha_tree_root(leaves) == jsucc.sha_tree_root(leaves)
    assert succinct._tree_key(LEAVES, bytes(32), CFG) != \
        succinct._tree_key(LEAVES, ROOT, CFG)
    assert succinct._limbs32(HEADERS[1]) == jsucc._limbs32(HEADERS[1])


def test_program_keys_match_reference(monkeypatch):
    """The program-cache keys hash the reference's parts (the port's
    `digest_key` salts them with its machine layout version besides)."""
    for mod in (succinct.progcache, jsucc.progcache):
        monkeypatch.setattr(mod, "digest_key", lambda *parts: parts)
    assert succinct._tree_key(LEAVES, ROOT, CFG) == \
        jsucc._tree_key(LEAVES, ROOT, JTREE_CFG)
    assert succinct._chain_key(LENS, TRUSTED, FINAL, CFG) == \
        jsucc._chain_key(LENS, TRUSTED, FINAL, JCFG)


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_tree_program_matches_reference(witness):
    share_vk_caps([Sha256Air.public_shape([2, 2]),
                   Sha256Air.public_shape([2])],
                  [JSha256Air.public_shape([2, 2]),
                   JSha256Air.public_shape([2])], CFG, JTREE_CFG)
    levels, jproofs = _tree_child_proofs() if witness else (None, None)
    bt, bj = Builder(witness=witness), JBuilder(witness=witness)
    succinct._tree_tape(bt, 4, LEAVES, ROOT, CFG,
                        [_carry(p) for p in jproofs] if witness else None,
                        levels, device="cpu")
    jsucc._tree_tape(bj, 4, LEAVES, ROOT, JTREE_CFG, jproofs, levels)
    prog, jprog = compile_tape(bt), jcompile(bj)
    # the machine's publics: the leaf words and the root words, only
    assert len(prog.publics) == 8 * len(LEAVES) + 8
    assert _program_fields(prog) == _program_fields(jprog)


def _share_chain_vk():
    share_vk_caps([Blake2bAir.public_shape(LENS)],
                  [JBlake2bAir.public_shape(LENS)], CFG, JCFG)


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_chain_program_matches_reference(witness):
    _share_chain_vk()
    bt, bj = Builder(witness=witness), JBuilder(witness=witness)
    succinct._chain_tape(bt, LENS, TRUSTED, FINAL, CFG,
                         _carry(JCHILD) if witness else None,
                         HEADERS if witness else None, device="cpu")
    jsucc._chain_tape(bj, LENS, TRUSTED, FINAL, JCFG,
                      JCHILD if witness else None,
                      HEADERS if witness else None)
    prog, jprog = compile_tape(bt), jcompile(bj)
    assert len(prog.publics) == 16
    assert _program_fields(prog) == _program_fields(jprog)


def test_chain_tape_rejects_wrong_link():
    """`tests/test_hash_chain.py::test_chain_tape_rejects_wrong_link` on
    the port: the child proves headers whose link is broken, so the wired
    parent-hash handle diverges from what it proved."""
    _share_chain_vk()
    bad_headers = [HEADERS[0], b"\x13" * 32 + b"payload-one" * 3]
    air = JBlake2bAir(bad_headers, bind="public")
    bad_child = _carry(jprove(air, air.build_trace(), JCFG))
    with pytest.raises(TapeCheckFailed):
        succinct._chain_tape(Builder(witness=True), LENS, TRUSTED, FINAL,
                             CFG, bad_child, bad_headers, device="cpu")


def test_verifiers_reject_malformed_proofs():
    """A wrong leaf count is turned away before any tape; a statement the
    tape cannot be built for is a rejection, never an exception; the
    prover refuses headers that do not link."""
    tree = succinct.ShaTreeProof(proof=None, n_leaves=4)
    assert not succinct.verify_sha_tree(LEAVES[:2], ROOT, tree, CFG,
                                        device="cpu")
    chain = succinct.HashChainProof(proof=None, header_lens=[])
    assert not succinct.verify_hash_chain(TRUSTED, FINAL, chain, CFG,
                                          device="cpu")
    with pytest.raises(AssertionError, match="do not link"):
        succinct.prove_hash_chain([HEADERS[1], HEADERS[0]], CFG,
                                  device="cpu")
