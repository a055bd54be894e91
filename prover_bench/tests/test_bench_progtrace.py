"""The program's spans on the device trace's clock (`progtrace`), on
synthetic device operations, markers and program records: where idle gaps
and operations are charged, how the two clocks are joined, and what each
reader of the program's spans returns."""

from __future__ import annotations

import inspect
import json
import sys
import time

import pytest

from prover_bench import devtrace, harness, progtrace, spans
from vectorx_tpu_torch import tracing

M = "marker"
READERS = ["vk_derive_s", "poseidon_calls", "poseidon_ops_per_call",
           "poseidon_idle_s"]


def harness_spans(prove=(1_000, 101_000), verify=(102_000, 152_000),
                  window=(0, 153_000)):
    """The traced statement's harness spans (host ns): traced > prove,
    verify; and their boundaries in order."""
    def span(sid, layer, parent, path, t):
        return spans.Span(sid=sid, layer=layer, parent=parent, path=path,
                          t0=t[0] / 1e9, t1=t[1] / 1e9, traced=True)

    hs = [span(0, "traced", None, (), window),
          span(1, "prove", 0, ("traced",), prove),
          span(2, "verify", 0, ("traced",), verify)]
    bounds = [("open", 0), ("open", 1), ("close", 1), ("open", 2),
              ("close", 2), ("close", 0)]
    return hs, bounds


def markers(hs, bounds, offset):
    """One marker op a boundary, starting at the device time that
    `offset(host ns)` gives (device = host - offset), 100 ns long."""
    out = []
    for kind, sid in bounds:
        h = round((hs[sid].t0 if kind == "open" else hs[sid].t1) * 1e9)
        d = h - offset(h)
        out.append((d, d + 100, M))
    return out


def record(rid, name, parent, t0, t1, **counts):
    return tracing.Record(rid, name, parent, 0 if parent is not None else rid,
                          t0, t1, counts=counts)


def program():
    """stark.prove over the prove span; poseidon.permute at 10-40 us and
    50-60 us inside it; in verify, stark.verify with vk.derive."""
    return [record(0, "stark.prove", None, 2_000, 100_000),
            record(1, "poseidon.permute", 0, 10_000, 40_000, states=8),
            record(2, "poseidon.permute", 0, 50_000, 60_000, states=8),
            record(3, "stark.verify", None, 103_000, 150_000),
            record(4, "vk.derive", 3, 110_000, 140_000, columns=3, rows=8)]


def run_attribution(ops, offset=lambda h: 0):
    hs, bounds = harness_spans()
    ops = sorted(ops + markers(hs, bounds, offset))
    assert devtrace.attribute(ops, M, bounds, hs) is not None
    return progtrace.attribute(ops, M, bounds, hs, program())


def test_a_gap_inside_a_permute_is_charged_there():
    # busy 12-15 us and 20-25 us: the 5 us between lie inside permute 1
    ops = [(12_000, 15_000, "a"), (20_000, 25_000, "b")]
    prove = run_attribution(ops)["prove"]
    idle = prove.idle
    assert idle["poseidon.permute"] >= 5_000 / 1e9
    # the other gaps: 1.1-12 us (none to 2, stark.prove to 10, permute),
    # 25-101 us (permute to 40, stark.prove, permute 50-60, stark.prove
    # to 100, none)
    assert idle["poseidon.permute"] == pytest.approx(
        (2_000 + 5_000 + 15_000 + 10_000) / 1e9)
    assert idle["stark.prove"] == pytest.approx(58_000 / 1e9)
    assert idle[None] == pytest.approx(1_900 / 1e9)
    assert sum(idle.values()) == pytest.approx(prove.span_idle)
    assert prove.ops == {"poseidon.permute": 2}
    assert prove.ops_per_call("poseidon.permute") == 1.0
    assert prove.calls == {"stark.prove": 1, "poseidon.permute": 2}


def test_a_gap_across_two_spans_is_split():
    # one gap, 8-45 us: stark.prove 8-10, permute 10-40, stark.prove 40-45
    ops = [(1_200, 8_000, "a"), (45_000, 99_000, "b")]
    res = run_attribution(ops)
    idle = res["prove"].idle
    assert idle["poseidon.permute"] == pytest.approx(30_000 / 1e9)
    assert idle["stark.prove"] == pytest.approx((2_000 + 5_000 + 1_000)
                                                / 1e9)
    assert sum(idle.values()) == pytest.approx(res["prove"].span_idle)
    # the verify span: all idle, vk.derive 110-140 of 102.1-152 us
    verify = res["verify"]
    assert verify.idle["vk.derive"] == pytest.approx(30_000 / 1e9)
    assert sum(verify.idle.values()) == pytest.approx(verify.span_idle)
    assert verify.ops == {} and verify.calls == {"stark.verify": 1,
                                                 "vk.derive": 1}


def test_the_report_names_the_top_spans_and_the_balance(capsys):
    hs, _ = harness_spans()
    res = run_attribution([(1_200, 8_000, "a"), (45_000, 99_000, "b")])
    progtrace.report(res, hs, program())
    lines = capsys.readouterr().err.splitlines()
    assert lines[0].startswith("progtrace: program spans by self seconds")
    assert any(ln.startswith("progtrace: prove idle") for ln in lines)
    assert any(ln.startswith("progtrace: verify idle") for ln in lines)
    table = json.loads(lines[-1].split(" ", 1)[1])
    assert table["prove"]["poseidon.permute"]["calls"] == 2
    # 1.1-1.2 us before stark.prove opens, 100-101 us after it closes
    assert table["prove"]["none"]["idle_s"] == pytest.approx(1_100 / 1e9)
    assert table["window_prove_s"]["stark.prove"] == pytest.approx(98e-6)


def test_the_clock_offset_is_interpolated_between_markers():
    c = progtrace.Clock([0, 1_000, 3_000], [5_000, 7_000, 9_000])
    # offsets 5000, 6000, 6000 (host - device); held past the ends
    assert c.h0 + c.host(500) == pytest.approx(500 + 5_500)
    assert c.h0 + c.host(2_000) == pytest.approx(2_000 + 6_000)
    assert c.h0 + c.host(-100) == pytest.approx(-100 + 5_000)
    assert c.h0 + c.host(4_000) == pytest.approx(4_000 + 6_000)


def test_an_op_is_charged_where_the_host_was_through_a_drifting_offset():
    # the device clock runs ahead of the host by 1 us at the prove span's
    # open and by 21 us at its close (linear in between): an op at device
    # 66.8 us is at host 55 us, inside permute 2 (50-60 us); either end's
    # offset alone would put it in stark.prove
    def offset(h):
        return -1_000 - (h - 1_000) * 20_000 // 100_000 if h <= 101_000 \
            else -21_000

    hs, bounds = harness_spans()
    ops = sorted([(55_000 + 1_000 + 10_800, 55_000 + 1_000 + 10_900, "x")]
                 + markers(hs, bounds, offset))
    devtrace.attribute(ops, M, bounds, hs)
    prove = progtrace.attribute(ops, M, bounds, hs, program())["prove"]
    assert prove.ops == {"poseidon.permute": 1}
    assert sum(prove.idle.values()) == pytest.approx(prove.span_idle)


@pytest.mark.parametrize("lost", [0, 2, 5])
def test_a_lost_marker_reads_nothing(lost):
    """The trace lost the marker of boundary `lost` (the window's open, the
    prove span's close, the window's close): as in `devtrace`, whose
    reading then fails too, nothing is charged."""
    ops = [(12_000, 15_000, "a"), (20_000, 25_000, "b")]
    hs, bounds = harness_spans()
    ms = markers(hs, bounds, lambda h: 3_000 - h // 1_000)
    drift = sorted(ops + ms[:lost] + ms[lost + 1:])
    assert devtrace.attribute(drift, M, bounds, hs) is None
    assert progtrace.attribute(drift, M, bounds, hs, program()) is None


@pytest.fixture
def state(monkeypatch):
    s = progtrace.Session()
    monkeypatch.setattr(progtrace, "STATE", s)
    return s


def a_run(prove_s=(1.0,), verify_s=(1.0,)):
    hs, _ = harness_spans()
    return harness.Run(setup_s=1.0, prove_s=list(prove_s),
                       verify_s=list(verify_s), spans=hs)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_none_without_program_spans(state, name):
    r = harness.reader(name)
    assert r.read(a_run()) is None          # no tracer: the parent's program
    state.tracer = tracing.Tracer()         # a tracer that recorded nothing
    state.result = {"prove": progtrace.Phase(), "verify": progtrace.Phase()}
    assert r.read(a_run()) is None


def test_the_readers_read_the_program_spans(state):
    state.tracer = tracing.Tracer()
    state.tracer.records = program()
    ops = [(12_000, 15_000, "a"), (20_000, 25_000, "b")]
    state.result = run_attribution(ops)
    got = {n: harness.reader(n).read(a_run()) for n in READERS}
    assert got == pytest.approx({
        "vk_derive_s": 30_000 / 1e9, "poseidon_calls": 2.0,
        "poseidon_ops_per_call": 1.0,
        "poseidon_idle_s": 32_000 / 1e9})
    # per statement: two proved statements, the same spans
    assert harness.reader("poseidon_calls").read(
        a_run(prove_s=(1.0, 1.0))) == 1.0


def test_the_harness_calls_what_arm_wraps_through_its_modules():
    assert progtrace.unwrapped_calls(inspect.getsource(harness)) == []


@pytest.mark.parametrize("source, missed", [
    ("from prover_bench.spans import install\ninstall(rec, [])\n"
     "spans.uninstall(u)\ndevtrace.attribute(o, m, b, s)\n",
     ["spans.install"]),
    ("spans.install(rec, [])\nspans.uninstall(u)\n", ["devtrace.attribute"]),
    ("", ["spans.install", "spans.uninstall", "devtrace.attribute"]),
])
def test_arm_names_the_calls_its_wrappers_would_miss(source, missed):
    assert progtrace.unwrapped_calls(source) == missed


def test_arm_raises_where_the_harness_moved_away(monkeypatch):
    monkeypatch.setattr(progtrace, "_ARMED", [])
    monkeypatch.setattr(inspect, "getsource",
                        lambda mod: "from prover_bench.spans import install")
    with pytest.raises(RuntimeError, match="spans.install"):
        progtrace.arm()


def test_without_the_programs_tracer_arm_wraps_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "vectorx_tpu_torch.tracing", None)
    assert progtrace.arm() is False


def test_a_traced_cpu_run_installs_the_tracer_beside_the_spans(tiny):
    assert progtrace.arm()
    root, s = tiny
    r = harness.run_cell(root, s, "header_range_256.roots", 2 ** 31 + 977,
                         0.0, True, "cpu", time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["poseidon_calls"]["value"] > 0
    assert r["metrics"]["vk_derive_s"]["value"] > 0
    # no device trace on the CPU: the device readers read nothing
    assert not {"poseidon_ops_per_call", "poseidon_idle_s"} & set(
        r["metrics"])
    assert tracing.span("after") is tracing.OFF
    # an untraced run installs no tracer
    r = harness.run_cell(root, s, "header_range_256.roots", 5, 0.0, False,
                         "cpu", time.perf_counter())
    assert r["correct"] and "poseidon_calls" not in r["metrics"]
