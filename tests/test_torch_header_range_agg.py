"""The aggregated ZK header_range and `zk_merkle` in the port against the
JAX package, on CPU torch, at `tests/test_zk_header_range.py`'s tree=2
statement and config.

* The machine `Program` the aggregated statement's tape lowers to, in
  statement mode and in witness mode (205,364 rows), equals the
  reference's, with equal public offsets.  Both tapes replay the
  reference's component proofs (golden fixtures), the port's carried over
  as JSON; `test_torch_header_range.py` holds the port's own component
  proofs equal to them.  Both use the verification keys the port derives.
  The machine proof is not run on the CPU; `chip_smoke.py` phase 11 proves
  the tree-16, 300-authority statement on the card.
* The aggregated verifier turns a bad statement away before it touches
  the machine proof.
* `prove_merkle_root` of `tests/test_sha256_air.py`'s two leaves: the
  proof JSON equals the reference's, each package's verifier accepts the
  other's proof, and a tampered root is rejected.
"""

import dataclasses
import json
import random

import pytest
import torch

from vectorx_tpu.circuits import zk_header_range as jzhr
from vectorx_tpu.circuits import zk_merkle as jzm
from vectorx_tpu.circuits.subchain import decode_header_fields
from vectorx_tpu.merkle import sha256_merkle_root
from vectorx_tpu.recursion import aggregate as jagg
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu_torch.circuits import zk_header_range as thr
from vectorx_tpu_torch.circuits import zk_merkle as tzm
from vectorx_tpu_torch.recursion import aggregate
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.stark import serialize as tser

from test_torch_header_range import CFG, JCFG
from test_torch_header_range import zk_reference  # noqa: F401  (fixture)
from test_torch_recursion import _program_fields, share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)

torch.set_num_threads(1)

PUBLIC = ("input_bytes", "output_bytes", "headers", "header_hashes",
          "header_chunk_sizes", "state_levels", "data_levels",
          "sha_chunk_sizes", "justification")


@pytest.fixture(scope="module")
def proofs(zk_reference):
    """(the reference's tree=2 proof as a port proof, the reference's)."""
    _, _, ref = zk_reference
    conv = [tser.proof_from_json(jser.proof_to_json(p))
            for p in list(ref.header_proofs) + list(ref.sha_proofs)]
    nh = len(ref.header_proofs)
    port = thr.ZkHeaderRangeProof(**{f: getattr(ref, f) for f in PUBLIC},
                                  header_proofs=conv[:nh],
                                  sha_proofs=conv[nh:])
    return port, ref


def _reference_children(ref):
    """The reference's child AIRs, as its `aggregate_header_range_proof`
    builds them."""
    state, data = [], []
    for enc in ref.headers:
        d = decode_header_fields(enc, len(enc))
        state.append(d.state_root)
        data.append(d.data_root)
    s_msgs, s_digs, _ = jzhr._tree_messages(state, ref.state_levels)
    d_msgs, d_digs, _ = jzhr._tree_messages(data, ref.data_levels)
    return jzhr._component_airs(ref, s_msgs + d_msgs, s_digs + d_digs)


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_aggregated_program_matches_reference(proofs, witness):
    port, ref = proofs
    airs, jairs = thr.aggregate_children(port), _reference_children(ref)
    assert [(type(a).__name__, a.log_n, a.width) for a in airs] == \
        [(type(a).__name__, a.log_n, a.width) for a in jairs] == \
        [("Blake2bAir", 7, 2664), ("Sha256Air", 9, 299)]
    kids = list(port.header_proofs) + list(port.sha_proofs)
    jkids = list(ref.header_proofs) + list(ref.sha_proofs)
    b, offs = aggregate._build_tape(airs, CFG,
                                    proofs=kids if witness else None,
                                    device="cpu")
    share_vk_caps(airs, jairs, CFG, JCFG)
    jb, joffs = jagg._build_tape(jairs, JCFG,
                                 proofs=jkids if witness else None)
    prog, jprog = compile_tape(b), jcompile(jb)
    assert prog.n_rows == jprog.n_rows == 205364
    assert offs == joffs
    assert _program_fields(prog) == _program_fields(jprog)


def test_aggregated_verifier_rejects_a_bad_statement(proofs, monkeypatch):
    """The public checks run before the machine proof is touched: a
    tampered header hash, output root, chunk cover or justification is
    rejected with no call of `aggregate_verify`; the untampered statement
    passes them and reaches it."""
    port = proofs[0]
    reached = []
    monkeypatch.setattr(aggregate, "aggregate_verify",
                        lambda *a, **kw: reached.append(a) or True)
    agg = thr.ZkHeaderRangeAggProof(
        **{f: getattr(port, f) for f in PUBLIC}, aggregated_proof=None)
    out = bytearray(port.output_bytes)
    out[40] ^= 1                                  # the state root
    just = port.justification
    forged = list(just.signatures)
    forged[just.validator_signed.index(True)] = bytes(64)
    bad_just = dataclasses.replace(just, signatures=forged)
    for bad in (dataclasses.replace(agg, header_hashes=[bytes(32)]
                                    + list(agg.header_hashes[1:])),
                dataclasses.replace(agg, output_bytes=bytes(out)),
                dataclasses.replace(agg, sha_chunk_sizes=[1]),
                dataclasses.replace(agg, justification=bad_just)):
        assert not thr.verify_header_range_zk_aggregated(
            bad, 2, CFG, device="cpu", rng=random.Random(3))
    assert reached == []
    assert thr.verify_header_range_zk_aggregated(agg, 2, CFG, device="cpu",
                                                 rng=random.Random(3))
    assert len(reached) == 1


def test_zk_merkle_matches_reference():
    """`tests/test_sha256_air.py::test_zk_merkle_root_two_leaves` in the
    port: proof JSON equal, verifiers interchangeable, tampered root
    rejected."""
    leaves = [b"\x01" * 32, b"\x02" * 32]
    proof = tzm.prove_merkle_root(leaves, CFG, device="cpu")
    ref = jzm.prove_merkle_root(leaves, JCFG)      # golden fixture
    assert proof.root == ref.root == sha256_merkle_root(leaves)
    assert (proof.level_digests, proof.chunk_sizes) == \
        (ref.level_digests, ref.chunk_sizes)
    assert [json.dumps(tser.proof_to_json(p)) for p in proof.node_proofs] == \
        [json.dumps(jser.proof_to_json(p)) for p in ref.node_proofs]
    # equal JSON: the port's verifier accepting its proof accepts the
    # reference's
    assert tzm.verify_merkle_root(proof, CFG, device="cpu")
    messages, digests, _ = tzm._interior_messages(leaves,
                                                  proof.level_digests)
    share_vk_caps([tzm.Sha256Air.statement(messages, digests)],
                  [jzm.Sha256Air.statement(messages, digests)], CFG, JCFG)
    mine = dataclasses.replace(ref, node_proofs=[
        jser.proof_from_json(tser.proof_to_json(p))
        for p in proof.node_proofs])
    assert jzm.verify_merkle_root(mine, JCFG)
    bad = dataclasses.replace(proof, root=bytes(32))
    assert not tzm.verify_merkle_root(bad, CFG, device="cpu")
    assert not tzm.verify_merkle_root(
        dataclasses.replace(proof, leaves=leaves[:1] * 3), CFG, device="cpu")
