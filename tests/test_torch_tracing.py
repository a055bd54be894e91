"""The port's spans (`vectorx_tpu_torch.tracing`) on CPU torch.

* Off (no tracer installed), `span` returns the one shared no-op object,
  reads no clock and records nothing.
* A proof is byte-identical with tracing on and off.
* A prove records one `stark.prove` root with its stages in order, every
  record closed and sharing the root.
* `poseidon.permute`'s `states` over a Merkle tree add up to its leaf
  hashes and two-to-one nodes.
* The verifier records `vk.derive` on a key-cache miss only.
* A raising body closes its spans; self time is duration less children.
"""

import hashlib
import time

import pytest
import torch

from vectorx_tpu_torch import merkle, tracing
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import (FibonacciAir, StarkConfig, prove,
                                     verify, vk)
from vectorx_tpu_torch.stark.serialize import proof_to_json
from vectorx_tpu_torch.stark.sha256_air import Sha256Air

torch.set_num_threads(1)

CFG = StarkConfig(fri=FriConfig(rate_bits=2, cap_height=1, num_queries=2,
                                final_poly_len=4, pow_bits=1))
MSGS = [b"abc" * 3]
AIRS = {"fibonacci": lambda: FibonacciAir(log_n=5),
        "sha256": lambda: Sha256Air(MSGS)}
STAGES = ["stark.preprocess", "stark.trace_commit", "stark.aux_commit",
          "stark.composition", "stark.quotient", "stark.open_zeta",
          "stark.deep_compose", "stark.fri", "stark.query_openings"]


@pytest.fixture
def tracer():
    t = tracing.install(tracing.Tracer())
    try:
        yield t
    finally:
        tracing.uninstall()


_PROVED: dict = {}


def proved(name: str):
    """(proof with tracing off, proof with tracing on, the tracer's
    records of the second prove), once per AIR."""
    if name not in _PROVED:
        air = AIRS[name]()
        trace = air.build_trace()
        off = prove(air, trace, CFG, device="cpu")
        t = tracing.install(tracing.Tracer())
        try:
            on = prove(air, trace, CFG, device="cpu")
        finally:
            tracing.uninstall()
        _PROVED[name] = (off, on, t.records)
    return _PROVED[name]


def test_off_records_nothing_and_returns_the_shared_object():
    t = tracing.install(tracing.Tracer())
    assert tracing.uninstall() is t
    sp = tracing.span("stark.prove", rows=8, width=2)
    assert sp is tracing.OFF and tracing.span("other") is sp
    with sp as inner:
        inner.stage("stark.fri")
    air = FibonacciAir(log_n=3)
    prove(air, air.build_trace(), CFG, device="cpu")
    assert t.records == []


def test_off_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "perf_counter", no_clock)
    with tracing.span("poseidon.permute", states=4) as sp:
        sp.stage("x")


@pytest.mark.parametrize("name", list(AIRS))
def test_proof_is_byte_identical_with_tracing_on_and_off(name):
    off, on, records = proved(name)
    assert records
    assert proof_to_json(on) == proof_to_json(off)


@pytest.mark.parametrize("name", list(AIRS))
def test_one_root_per_prove_with_its_stages_in_order(name):
    _off, _on, records = proved(name)
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["stark.prove"]
    root = roots[0]
    assert root.counts == {"rows": AIRS[name]().n,
                           "width": AIRS[name]().width}
    assert [r.name for r in records if r.parent == root.rid] == STAGES
    assert all(r.t1 >= r.t0 >= 0 for r in records)
    assert all(r.root == root.rid for r in records)
    by_rid = {r.rid: r for r in records}
    for r in records:
        if r.parent is not None:
            p = by_rid[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1


@pytest.mark.parametrize("log_n, width, cap", [(3, 5, 0), (4, 8, 1),
                                               (4, 12, 2), (5, 17, 1)])
def test_poseidon_states_over_a_merkle_tree(tracer, log_n, width, cap):
    n = 1 << log_n
    leaves = torch.arange(n * width, dtype=torch.int64).reshape(n, width)
    merkle.build_layers(leaves, cap)
    states = [r.counts["states"] for r in tracer.records
              if r.name == "poseidon.permute"]
    assert sum(states) == n * -(-width // 8) + (n - (1 << cap))


def test_vk_derive_on_a_key_cache_miss_only(tmp_path, monkeypatch, tracer):
    _off, proof, _records = proved("sha256")
    monkeypatch.setenv("VECTORX_VK_CACHE", str(tmp_path))
    vk.clear_memory_cache()
    try:
        st = Sha256Air.statement(MSGS, [hashlib.sha256(m).digest()
                                        for m in MSGS])
        counts = []
        for _ in range(2):
            start = len(tracer.records)
            assert verify(st, proof, CFG, device="cpu")
            new = tracer.records[start:]
            assert new[0].name == "stark.verify" and new[0].parent is None
            counts.append(sum(r.name == "vk.derive" for r in new))
        assert counts == [1, 0]
        derive = next(r for r in tracer.records if r.name == "vk.derive")
        assert derive.counts == {"columns": st.num_constants(),
                                 "rows": st.n}
    finally:
        vk.clear_memory_cache()


@pytest.mark.parametrize("where", ["span", "stage"])
def test_a_raising_body_closes_its_spans(tracer, where):
    with pytest.raises(ValueError):
        with tracing.span("outer") as sp:
            if where == "stage":
                sp.stage("stage")
            with tracing.span("inner"):
                raise ValueError("planted")
    assert all(r.t1 >= r.t0 for r in tracer.records)
    assert len(tracer.records) == (3 if where == "stage" else 2)
    with tracing.span("after"):
        pass
    assert tracer.records[-1].parent is None


def test_self_time_is_duration_less_children():
    ticks = iter([0, 10, 12, 18, 30, 40, 45, 100])
    t = tracing.install(tracing.Tracer(clock=lambda: next(ticks)))
    try:
        with tracing.span("outer"):            # 0 .. 100
            with tracing.span("a"):            # 10 .. 30
                with tracing.span("a.child"):  # 12 .. 18
                    pass
            with tracing.span("b"):            # 40 .. 45
                pass
    finally:
        tracing.uninstall()
    got = {r.name: (r.ns, r.self_ns) for r in t.records}
    assert got == {"outer": (100, 75), "a": (20, 14), "a.child": (6, 6),
                   "b": (5, 5)}
