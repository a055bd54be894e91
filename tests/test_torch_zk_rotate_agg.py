"""The aggregated ZK rotate in the port against the JAX package, on CPU
torch, at `tests/test_zk_rotate.py`'s chain (4 authorities) and config.

The machine `Program`s the aggregated statement's tape lowers to, in
statement mode and in witness mode (205,364 rows), equal the reference's.
Both tapes replay the reference's component proofs (golden fixtures), the
port's as a port `ZkRotateProof` carried over as JSON, and both use the
verification keys of the children that the port derives;
`test_torch_zk_rotate.py` holds the port's own component proofs equal to
them.  The machine proof at 2^18 rows is not run on the CPU
(`tests/test_zk_rotate.py` skips it too); `chip_smoke.py` phase 9 proves
the 300-authority statement on the card.
"""

import dataclasses
import random

import pytest
import torch

from vectorx_tpu.circuits import zk_rotate as jzr
from vectorx_tpu.recursion import aggregate as jagg
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu_torch.circuits import zk_rotate as tzr
from vectorx_tpu_torch.circuits.zk_commitment import AuthorityCommitmentProof
from vectorx_tpu_torch.recursion import aggregate
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.stark import serialize as tser

from test_torch_recursion import _program_fields, share_vk_caps
from test_torch_recursion import isolated_caches  # noqa: F401  (autouse)
from test_torch_zk_rotate import (CFG, INPUT, JCFG, JCHAIN, PUBLIC, _convert,
                                  aggregate_children)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def proofs():
    """(the reference's proof as a port proof, the reference's proof)."""
    ref = jzr.prove_rotate_zk(JCHAIN, INPUT, max_authorities=8, config=JCFG)
    port = _convert(ref, tzr.ZkRotateProof, AuthorityCommitmentProof, jser,
                    tser)
    return port, ref


@pytest.mark.parametrize("witness", [False, True],
                         ids=["statement_mode", "witness_mode"])
def test_aggregated_program_matches_reference(proofs, witness):
    port, ref = proofs
    airs = aggregate_children(port)
    jairs = [jzr.Blake2bAir.statement([ref.header_bytes], [ref.header_hash])]
    jairs += jzr._commitment_airs(ref.commitment)
    assert [(type(a).__name__, a.log_n, a.width) for a in airs] == \
        [(type(a).__name__, a.log_n, a.width) for a in jairs]
    kids = [port.header_proof] + list(port.commitment.step_proofs)
    jkids = [ref.header_proof] + list(ref.commitment.step_proofs)
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


def test_aggregated_verifier_rejects_a_bad_statement(proofs):
    """The aggregated verifier's public checks run before the machine
    proof is touched: a commitment statement that does not end in the
    claimed output, or whose chunks do not cover the authorities, is
    rejected with no machine proof at all."""
    port = proofs[0]
    stmt = dataclasses.replace(port.commitment, step_proofs=[])
    agg = tzr.ZkRotateAggProof(
        **{f: getattr(port, f) for f in PUBLIC},
        commitment_statement=stmt, aggregated_proof=None,
        justification=port.justification)
    for bad in (dataclasses.replace(agg, output_bytes=b"\x11" * 32),
                dataclasses.replace(agg, commitment_statement=dataclasses
                                    .replace(stmt, chunk_sizes=[1]))):
        assert not tzr.verify_rotate_zk_aggregated(
            bad, max_authorities=8, config=CFG, device="cpu",
            rng=random.Random(3))
