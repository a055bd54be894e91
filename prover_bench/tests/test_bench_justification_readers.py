"""The readers of the GRANDPA justification cells on synthetic runs: the
program-span readers give their spans' seconds per statement of their
phase, and None where their root span is absent (a program without the
spans) or no tracer was installed; each twin reads what its base reads."""

from __future__ import annotations

import pytest

from prover_bench import harness, progtrace, spans
from vectorx_tpu_torch import tracing

# reader -> (phase, program span, root span)
PROGRAM = {
    "trace_build_s.ladder": ("prove", "ed25519_ladder.build_trace",
                             "stark.prove_streamed"),
    "constraints_s.ladder": ("prove", "prover.composition_coset",
                             "stark.prove_streamed"),
    "aux_s.ladder": ("prove", "prover.aux_witness", "stark.prove_streamed"),
    "commit_s.ladder": ("prove", "stages.commit_streamed",
                        "stark.prove_streamed"),
    "batch_terms_s.justification": ("verify", "ed25519_batch.terms",
                                     "ed25519_batch.batch_verify"),
    "batch_ladder_s.justification": ("verify", "ed25519_batch.ladder",
                                     "ed25519_batch.batch_verify"),
}
TWINS = {"device_idle_pct.prove.ladder": "device_idle_pct.prove",
         "poseidon_roofline.ladder": "poseidon_roofline",
         "ntt_roofline.ladder": "ntt_roofline",
         "device_idle_pct.verify.justification": "device_idle_pct.verify"}


@pytest.fixture
def state(monkeypatch):
    s = progtrace.Session()
    monkeypatch.setattr(progtrace, "STATE", s)
    return s


def a_run(statements=1):
    """`statements` statements, each proved over 1-101 us and verified over
    102-152 us after the one before (host ns)."""
    hs, prove_s, verify_s = [], [], []
    for k in range(statements):
        off = 200_000 * k
        for layer, t0, t1 in (("prove", 1_000, 101_000),
                              ("verify", 102_000, 152_000)):
            hs.append(spans.Span(sid=len(hs), layer=layer, parent=None,
                                 path=(), t0=(off + t0) / 1e9,
                                 t1=(off + t1) / 1e9))
        prove_s.append(1e-4)
        verify_s.append(5e-5)
    return harness.Run(setup_s=1.0, prove_s=prove_s, verify_s=verify_s,
                       spans=hs)


def program(phase, name, root, statements=1, with_root=True):
    """Per statement: a root span over its phase, two `name` spans of 10
    and 30 us inside it, and a `name` span outside every harness span."""
    recs = []

    def record(name_, parent, t0, t1):
        rid = len(recs)
        recs.append(tracing.Record(rid, name_, parent,
                                   rid if parent is None else parent, t0, t1))
        return rid

    base = 2_000 if phase == "prove" else 103_000
    for k in range(statements):
        off = 200_000 * k + base
        top = record(root if with_root else "other", None, off, off + 45_000)
        record(name, top, off + 1_000, off + 11_000)
        record(name, top, off + 12_000, off + 42_000)
    record(name, None, 10_000_000, 10_050_000)
    return recs


@pytest.mark.parametrize("name", list(PROGRAM))
@pytest.mark.parametrize("statements", [1, 3])
def test_program_span_seconds_per_statement(state, name, statements):
    phase, span, root = PROGRAM[name]
    state.tracer = tracing.Tracer()
    state.tracer.records = program(phase, span, root, statements)
    got = harness.reader(name).read(a_run(statements))
    assert got == pytest.approx(40e-6)


@pytest.mark.parametrize("name", list(PROGRAM))
def test_program_span_readers_read_none_without_their_spans(state, name):
    phase, span, root = PROGRAM[name]
    reader = harness.reader(name)
    assert reader.read(a_run()) is None                 # no tracer
    state.tracer = tracing.Tracer()                      # nothing recorded
    assert reader.read(a_run()) is None
    state.tracer.records = program(phase, span, root, with_root=False)
    assert reader.read(a_run()) is None                  # no root span
    other = "verify" if phase == "prove" else "prove"
    state.tracer.records = program(other, span, root)
    assert reader.read(a_run()) is None                  # the other phase


@pytest.mark.parametrize("name", list(TWINS))
def test_twins_read_what_their_base_reads(name):
    run = a_run()
    for sp in run.spans:
        sp.traced, sp.dev_s, sp.busy_s = True, 1e-4, 2.5e-5
    base = harness.reader(TWINS[name])
    twin = harness.reader(name)
    assert twin.SPANS == base.SPANS
    assert twin.read(run) == base.read(run)
    assert twin.read(a_run()) is None


def test_the_justification_readers_arm_only_where_spans_are_recorded(
        monkeypatch):
    """`justification_spans.recorded()` is True on this program and False
    where `batch_verify` opens no span (a program without them), so there
    `arm()` leaves `progtrace` unarmed: its attribution cannot cut a
    window in which the program opened no span."""
    from prover_bench import justification_spans
    from vectorx_tpu_torch.curves import ed25519_batch

    assert justification_spans.recorded()
    monkeypatch.setattr(ed25519_batch, "batch_verify",
                        lambda *a, **k: True)
    assert not justification_spans.recorded()
    armed = []
    monkeypatch.setattr(progtrace, "arm", lambda: armed.append(1) or True)
    assert not justification_spans.arm() and not armed
