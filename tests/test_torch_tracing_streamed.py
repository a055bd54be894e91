"""The port's spans on the streamed prove, the ladder AIR and the batched
signature check, on CPU torch.

* A streamed prove (`RangeCheckAir` past a lowered
  `STREAM_THRESHOLD_ELEMS`) records one `stark.prove_streamed` root
  (`rows`, `width`, `committed_columns`) with `prove`'s nine stage spans in
  order, and inside them `stages.commit_streamed` (`columns`, `points`) for
  each committed group, `prover.aux_witness` (`lookups`, `columns`), one
  `prover.composition_coset` and one `stages.deep_compose_coset` per coset
  (`coset`, `rows` / `points`), `stages.quotient_coeffs` and the FRI
  stages; its proof is byte-identical with tracing on and off.
* The unstreamed prove keeps its root and its stage spans.
* `Ed25519LadderAir` records `ed25519_ladder.build_trace` (`signatures`,
  `rows`) and `ed25519_ladder.transition` (`rows`).
* `batch_verify` records `ed25519_batch.batch_verify` (`terms`) with
  `ed25519_batch.terms` and `ed25519_batch.ladder` (or `.msm`) in it.
* With no tracer installed nothing is recorded.
"""

import random

import numpy as np
import pytest
import torch

from vectorx_tpu_torch import tracing
from vectorx_tpu_torch.curves import ed25519 as ed
from vectorx_tpu_torch.curves import ed25519_batch
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import prover
from vectorx_tpu_torch.stark.air import DeviceAlgebra
from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
from vectorx_tpu_torch.stark.range_air import RangeCheckAir
from vectorx_tpu_torch.stark.serialize import proof_to_json

torch.set_num_threads(1)

CFG = prover.StarkConfig(fri=FriConfig(rate_bits=2, cap_height=1,
                                       num_queries=2, final_poly_len=4,
                                       pow_bits=1))
STAGES = ["stark.preprocess", "stark.trace_commit", "stark.aux_commit",
          "stark.composition", "stark.quotient", "stark.open_zeta",
          "stark.deep_compose", "stark.fri", "stark.query_openings"]


def range_air():
    rng = np.random.default_rng(3)
    return RangeCheckAir(6, 5, rng.integers(0, 32, size=(4, 63),
                                            dtype=np.uint64))


@pytest.fixture(scope="module")
def streamed():
    """(proof with tracing off, proof with tracing on, the records of the
    second prove), both streamed."""
    air = range_air()
    trace = air.build_trace()
    saved = prover.STREAM_THRESHOLD_ELEMS
    prover.STREAM_THRESHOLD_ELEMS = 1 << 8
    try:
        off = prover.prove(air, trace, CFG, device="cpu")
        t = tracing.install(tracing.Tracer())
        try:
            on = prover.prove(air, trace, CFG, device="cpu")
        finally:
            tracing.uninstall()
    finally:
        prover.STREAM_THRESHOLD_ELEMS = saved
    return off, on, t.records


def test_streamed_proof_is_byte_identical_with_tracing_on_and_off(streamed):
    off, on, _records = streamed
    assert proof_to_json(on) == proof_to_json(off)


def test_streamed_prove_has_one_root_and_prove_stages(streamed):
    _off, _on, records = streamed
    air = range_air()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["stark.prove_streamed"]
    root = roots[0]
    assert root.counts == {"rows": air.n, "width": air.width,
                           "committed_columns": prover._commit_cols(air)}
    assert [r.name for r in records if r.parent == root.rid] == STAGES
    assert all(r.root == root.rid and r.t1 >= r.t0 for r in records)


def test_streamed_prove_stage_spans_and_counts(streamed):
    _off, _on, records = streamed
    air = range_air()
    blowup = 1 << CFG.rate_bits
    N = air.n * blowup
    stage_of = {r.rid: r.name for r in records if r.name in STAGES}

    def named(name):
        return [r for r in records if r.name == name]

    # constants, trace, aux, quotient: one streamed commitment each
    commits = named("stages.commit_streamed")
    A = 2 * len(air.lookups())
    assert [(r.counts["columns"], stage_of[r.parent]) for r in commits] == [
        (1, "stark.preprocess"), (air.width, "stark.trace_commit"),
        (A, "stark.aux_commit"),
        (2 * prover._num_quotient_chunks(air), "stark.quotient")]
    assert all(r.counts["points"] == N for r in commits)
    aux = named("prover.aux_witness")
    assert [(r.counts, stage_of[r.parent]) for r in aux] == [
        ({"lookups": len(air.lookups()), "columns": A}, "stark.aux_commit")]
    for name, count in (("prover.composition_coset", "rows"),
                        ("stages.deep_compose_coset", "points")):
        got = named(name)
        assert [r.counts for r in got] == [{"coset": c, count: air.n}
                                           for c in range(blowup)]
    assert {stage_of[r.parent] for r in named("prover.composition_coset")} \
        == {"stark.composition"}
    assert {stage_of[r.parent] for r in named("stages.deep_compose_coset")} \
        == {"stark.deep_compose"}
    [q] = named("stages.quotient_coeffs")
    assert (q.counts, stage_of[q.parent]) == ({"points": N}, "stark.quotient")
    fri = {r.name for r in records
           if r.parent in stage_of and stage_of[r.parent] == "stark.fri"}
    assert {"fri.commit_layer", "fri.fold", "fri.final", "fri.grind"} <= fri


def test_unstreamed_prove_keeps_its_root_and_stages():
    air = range_air()
    t = tracing.install(tracing.Tracer())
    try:
        prover.prove(air, air.build_trace(), CFG, device="cpu")
    finally:
        tracing.uninstall()
    roots = [r for r in t.records if r.parent is None]
    assert [r.name for r in roots] == ["stark.prove"]
    assert [r.name for r in t.records if r.parent == roots[0].rid] == STAGES
    assert not [r for r in t.records if r.name.endswith("_streamed")]


def _toy_sig():
    A = ed.scalar_mult(12345, ed.B_POINT)
    ha = ed.scalar_mult(89, A)
    minus_ha = ((ed.Q - ha[0]) % ed.Q, ha[1], ha[2], (ed.Q - ha[3]) % ed.Q)
    R = ed.point_add(ed.scalar_mult(173, ed.B_POINT), minus_ha)
    return (ed.point_compress(A), ed.point_compress(R), 173, 89)


def test_ladder_air_spans():
    air = Ed25519LadderAir([_toy_sig()], nbits=8)
    t = tracing.install(tracing.Tracer())
    try:
        trace = air.build_trace()
        cols = [gl.from_u64(trace[:, :5], "cpu"),
                gl.from_u64(trace[:, 1:6], "cpu"),
                gl.from_u64(air.constant_columns()[:, :5], "cpu")]
        air.transition(DeviceAlgebra, list(cols[0]), list(cols[1]), [],
                       list(cols[2]))
    finally:
        tracing.uninstall()
    assert [(r.name, r.counts, r.parent) for r in t.records] == [
        ("ed25519_ladder.build_trace", {"signatures": 1, "rows": air.n},
         None),
        ("ed25519_ladder.transition", {"rows": 5}, None)]


def _batch(n):
    secrets = [bytes([i + 1]) * 32 for i in range(n)]
    msg = b"p" * 53
    return ([ed.public_key(s) for s in secrets], [msg] * n,
            [ed.sign(s, msg) for s in secrets])


@pytest.mark.parametrize("method, mask", [("ladder", None),
                                          ("ladder", [True, False, True]),
                                          ("msm", None)])
def test_batch_verify_spans(method, mask):
    pubkeys, msgs, sigs = _batch(3)
    t = tracing.install(tracing.Tracer())
    try:
        assert ed25519_batch.batch_verify(pubkeys, msgs, sigs, mask,
                                          rng=random.Random(5), device="cpu",
                                          method=method)
    finally:
        tracing.uninstall()
    signed = 3 if mask is None else sum(mask)
    root = t.records[0]
    assert (root.name, root.counts, root.parent) == (
        "ed25519_batch.batch_verify", {"terms": 2 * signed + 1}, None)
    assert [(r.name, r.parent) for r in t.records[1:]] == [
        ("ed25519_batch.terms", root.rid),
        (f"ed25519_batch.{method}", root.rid)]


def test_off_records_nothing():
    t = tracing.install(tracing.Tracer())
    assert tracing.uninstall() is t
    pubkeys, msgs, sigs = _batch(2)
    assert ed25519_batch.batch_verify(pubkeys, msgs, sigs,
                                      rng=random.Random(5), device="cpu")
    air = Ed25519LadderAir([_toy_sig()], nbits=8)
    air.build_trace()
    saved = prover.STREAM_THRESHOLD_ELEMS
    prover.STREAM_THRESHOLD_ELEMS = 1 << 8
    try:
        ra = range_air()
        prover.prove(ra, ra.build_trace(), CFG, device="cpu")
    finally:
        prover.STREAM_THRESHOLD_ELEMS = saved
    assert t.records == []
