"""The program's own spans (`vectorx_tpu_torch.tracing`) in a traced run,
put on the device trace's clock without a sync.

Each harness span boundary syncs the card, launches a marker kernel and then
reads the host clock (`spans.Recorder`), so every marker pairs a device time
with a host time; where the markers do not match the boundaries one for one,
nothing is read, as in `devtrace`.  `Clock` interpolates the offset between
the two clocks from the neighbouring pairs and maps a device time onto the
host clock.
`attribute` then charges, in the traced statement:

- each idle gap of the card inside a harness `prove` or `verify` span to the
  innermost program span open on the host across it, split where the
  innermost span changes ("none" where no program span is open);
- each device operation to the innermost program span open on the host
  when the operation started.

Program spans launch nothing and sync nothing.  `arm()`, which the readers
that need them call when they are loaded, wraps the harness's
`spans.install`, `spans.uninstall` and `devtrace.attribute`: a
`tracing.Tracer` is installed beside the harness's spans (in a traced run
only, where the harness installs them) and removed beside them, and the
device operations are attributed before the harness drops them.  This
works only while `harness.py` calls those three through their modules'
attributes: `arm()` checks that it does, and raises where it does not, so
that a harness that moved away from them fails the run instead of reading
None.  On a program without `vectorx_tpu_torch.tracing`, `arm()` wraps
nothing and every reader of this module returns None.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from prover_bench import devtrace, spans

PHASES = ("prove", "verify")


class Session:
    """What one traced run recorded: the program's tracer, and the
    attribution of the traced statement's device trace."""

    def __init__(self):
        self.tracer = None
        self.result: dict | None = None      # harness layer -> Phase


STATE = Session()
_ARMED: list = []


WRAPPED = (("spans", "install"), ("spans", "uninstall"),
           ("devtrace", "attribute"))


def unwrapped_calls(source: str) -> list:
    """Of `WRAPPED`, the calls that `source` does not make as
    `<module>.<name>(...)`: those that `arm()`'s wrappers would miss."""
    made = {(n.func.value.id, n.func.attr) for n in ast.walk(ast.parse(source))
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)}
    return [f"{m}.{a}" for m, a in WRAPPED if (m, a) not in made]


def arm() -> bool:
    """Wrap the harness's span install and device attribution (once).
    Returns whether the program has a tracer to install; raises where the
    harness does not call what is wrapped through its module."""
    try:
        tracing = importlib.import_module("vectorx_tpu_torch.tracing")
    except ImportError:
        return False
    if _ARMED:
        return True
    from prover_bench import harness
    missed = unwrapped_calls(inspect.getsource(harness))
    if harness.spans is not spans or harness.devtrace is not devtrace:
        missed.append("the modules spans and devtrace")
    if missed:
        raise RuntimeError(f"progtrace: harness.py no longer calls "
                           f"{', '.join(missed)} as progtrace wraps them; "
                           f"the program's spans would read nothing")
    install, uninstall = spans.install, spans.uninstall
    cut = devtrace.attribute

    def install_beside(recorder, targets):
        STATE.tracer = tracing.install(tracing.Tracer())
        STATE.result = None
        return install(recorder, targets)

    def uninstall_beside(undo):
        uninstall(undo)
        tracing.uninstall()

    def attribute_beside(ops, marker_name, boundaries, hspans):
        idle = cut(ops, marker_name, boundaries, hspans)
        if idle is not None and STATE.tracer is not None:
            STATE.result = attribute(ops, marker_name, boundaries, hspans,
                                     STATE.tracer.records)
            if STATE.result is not None:
                report(STATE.result, hspans, STATE.tracer.records)
        return idle

    spans.install = install_beside
    spans.uninstall = uninstall_beside
    devtrace.attribute = attribute_beside
    _ARMED.append((install, uninstall, cut))
    return True


# ---------------------------------------------------------------------------
# The two clocks
# ---------------------------------------------------------------------------

class Clock:
    """Device ns -> host ns, from (device, host) pairs in time order: the
    offset host - device is interpolated linearly between the neighbouring
    pairs and held past the first and the last."""

    def __init__(self, dev, host):
        self.d0 = int(dev[0])
        self.h0 = int(host[0])
        d = np.asarray(dev, dtype=np.int64) - self.d0
        off = (np.asarray(host, dtype=np.int64) - self.h0) - d
        self.d = d.astype(np.float64)
        self.off = off.astype(np.float64)

    def host(self, t):
        """Host ns, less `h0`, of device ns `t` (a number or an array)."""
        x = (np.asarray(t, dtype=np.int64) - self.d0).astype(np.float64)
        return x + np.interp(x, self.d, self.off)


def _segments(records, h0: int):
    """(starts, owners): from starts[i] (host ns less h0) to starts[i+1]
    the innermost open program span is records[owners[i]] (-1: none)."""
    events = []
    for r in records:
        if r.t1 < 0:
            continue
        events.append((r.t0, 1, r.rid))
        events.append((r.t1, 0, -r.rid))
    events.sort()
    starts, owners, open_ = [], [], []
    for t, kind, key in events:
        if kind:
            open_.append(key)
        else:
            rid = -key
            if open_ and open_[-1] == rid:
                open_.pop()
            else:
                open_.remove(rid)
        owner = open_[-1] if open_ else -1
        if owners and starts[-1] == t - h0:
            owners[-1] = owner
        elif not owners or owners[-1] != owner:
            starts.append(t - h0)
            owners.append(owner)
    return (np.asarray(starts, dtype=np.float64),
            np.asarray(owners, dtype=np.int64))


def _owner_at(starts, owners, h):
    i = np.searchsorted(starts, h, side="right") - 1
    return np.where(i >= 0, owners[np.maximum(i, 0)], -1)


def _gaps(op_t0, op_t1, a: int, b: int):
    """Idle intervals (g0, g1) of the card in device ns [a, b], the
    operations (op_t0, op_t1) sorted by start."""
    lo, hi = np.searchsorted(op_t0, a), np.searchsorted(op_t0, b)
    busy = np.maximum.accumulate(op_t1[lo:hi]) if hi > lo else []
    g0 = np.concatenate([[a], busy])
    g1 = np.minimum(np.concatenate([op_t0[lo:hi], [b]]), b)
    keep = g1 > g0
    return g0[keep], g1[keep]


def _charge(g0, g1, clock, starts, owners, n_records: int):
    """Idle device seconds of the gaps (g0, g1) per owner record (index
    n_records: no program span), split over the segments in proportion to
    their host overlap."""
    out = np.zeros(n_records + 1)
    if not len(g0):
        return out
    h0, h1 = clock.host(g0), clock.host(g1)
    dur = (g1 - g0) / 1e9
    i0 = np.searchsorted(starts, h0, side="right") - 1
    i1 = np.searchsorted(starts, h1, side="left") - 1
    own = _owner_at(starts, owners, h0)
    one = (i0 == i1) | (h1 <= h0)
    np.add.at(out, np.where(own[one] < 0, n_records, own[one]), dur[one])
    for k in np.nonzero(~one)[0]:
        span_h = h1[k] - h0[k]
        t = h0[k]
        i = i0[k]
        while t < h1[k]:
            end = starts[i + 1] if i + 1 < len(starts) else h1[k]
            end = min(end, h1[k])
            who = owners[i] if i >= 0 else -1
            out[n_records if who < 0 else who] += dur[k] * (end - t) / span_h
            t = end
            i += 1
    return out


@dataclass
class Phase:
    """One harness span (`prove` or `verify`) of the traced statement, by
    program span name (None: no program span open on the host)."""

    calls: dict = field(default_factory=dict)    # program spans inside it
    self_s: dict = field(default_factory=dict)   # their host self seconds
    incl_s: dict = field(default_factory=dict)   # their host seconds
    ops: dict = field(default_factory=dict)      # device operations charged
    op_s: dict = field(default_factory=dict)     # their device seconds
    idle: dict = field(default_factory=dict)     # idle card seconds charged
    span_idle: float | None = None   # the harness's dev_s - busy_s

    def ops_per_call(self, name: str) -> float | None:
        if not self.calls.get(name):
            return None
        return self.ops.get(name, 0) / self.calls[name]


def _by_name(values, records, n_records: int) -> dict:
    out = defaultdict(float)
    for rid in np.nonzero(values)[0]:
        out[None if rid == n_records else records[rid].name] += values[rid]
    return dict(out)


def attribute(ops, marker_name: str, boundaries, hspans, records):
    """Charge the device operations and idle gaps of the traced statement's
    prove and verify spans to the program's spans `records`
    (`tracing.Record`s); `ops`, `boundaries` and `hspans` as
    `devtrace.attribute` takes them.  Returns {harness layer: Phase}, or
    None when the markers do not match the boundaries one for one or no
    span was traced."""
    marks = [(s, e) for s, e, n in ops if n == marker_name]
    if not marks or len(marks) != len(boundaries):
        return None
    host = [round((hspans[sid].t0 if kind == "open" else hspans[sid].t1)
                  * 1e9) for kind, sid in boundaries]
    at = dict(zip(boundaries, marks))
    clock = Clock([s for s, _ in marks], host)
    win = next((s for s in hspans if s.layer == "traced" and s.traced), None)
    if win is None:
        return None
    work = sorted((s, e) for s, e, n in ops if n != marker_name)
    op_t0 = np.array([s for s, _ in work], dtype=np.int64)
    op_t1 = np.array([e for _, e in work], dtype=np.int64)
    starts, owners = _segments(records, clock.h0)
    n = len(records)
    out = {}
    for sp in hspans:
        if sp.layer not in PHASES or not sp.traced or sp.parent != win.sid:
            continue
        ph = out[sp.layer] = Phase(
            span_idle=sp.dev_s - sp.busy_s if sp.dev_s > 0 else None)
        h0, h1 = round(sp.t0 * 1e9), round(sp.t1 * 1e9)
        for r in records:
            if r.t1 >= 0 and h0 <= r.t0 and r.t1 <= h1:
                ph.calls[r.name] = ph.calls.get(r.name, 0) + 1
                ph.self_s[r.name] = ph.self_s.get(r.name, 0.0) \
                    + r.self_ns / 1e9
                ph.incl_s[r.name] = ph.incl_s.get(r.name, 0.0) + r.ns / 1e9
        a, b = at[("open", sp.sid)][1], at[("close", sp.sid)][0]
        lo, hi = np.searchsorted(op_t0, a), np.searchsorted(op_t0, b)
        who = _owner_at(starts, owners, clock.host(op_t0[lo:hi]))
        who = np.where(who < 0, n, who)
        ph.ops = _by_name(np.bincount(who, minlength=n + 1), records, n)
        ph.op_s = _by_name(np.bincount(
            who, weights=(op_t1[lo:hi] - op_t0[lo:hi]) / 1e9,
            minlength=n + 1), records, n)
        g0, g1 = _gaps(op_t0, op_t1, a, b)
        ph.idle = _by_name(_charge(g0, g1, clock, starts, owners, n),
                           records, n)
    return out or None


# ---------------------------------------------------------------------------
# What the readers and the run's stderr read
# ---------------------------------------------------------------------------

def inside(records, hspans, layer: str) -> list:
    """The closed program records that lie inside a harness span of
    `layer`."""
    spans_ns = [(round(s.t0 * 1e9), round(s.t1 * 1e9)) for s in hspans
                if s.layer == layer]
    return [r for r in records if r.t1 >= 0 and any(
        a <= r.t0 and r.t1 <= b for a, b in spans_ns)]


def per_statement(run, layer: str, name: str, root: str, count):
    """`count(record)` summed over the program's `name` records inside the
    run's harness spans of `layer`, per statement of that layer; None when
    no program `root` span lies inside them."""
    if STATE.tracer is None:
        return None
    recs = inside(STATE.tracer.records, run.spans, layer)
    statements = len(run.prove_s if layer == "prove" else run.verify_s)
    if not statements or not any(r.name == root for r in recs):
        return None
    return sum(count(r) for r in recs if r.name == name) / statements


def report(phases: dict, hspans, records) -> None:
    """The ten program spans with the most self seconds and the ten with
    the most idle card seconds in the traced statement, each phase's idle
    balance, and one JSON line of every span name's numbers."""
    out = sys.stderr
    self_s, idle = defaultdict(float), defaultdict(float)
    for ph in phases.values():
        for name, s in ph.self_s.items():
            self_s[name] += s
        for name, s in ph.idle.items():
            idle["(none)" if name is None else name] += s
    print("progtrace: program spans by self seconds, traced statement:",
          file=out)
    for name, s in devtrace.top(self_s):
        print(f"  {name}: {s:.4f} s", file=out)
    print("progtrace: program spans by idle card seconds, traced statement:",
          file=out)
    for name, s in devtrace.top(idle):
        print(f"  {name}: {s:.4f} s", file=out)
    for layer, ph in phases.items():
        charged = sum(s for k, s in ph.idle.items() if k is not None)
        own = "the harness read none" if ph.span_idle is None else \
            f"the span's {ph.span_idle:.4f} s"
        print(f"progtrace: {layer} idle {charged:.4f} s in program spans + "
              f"{ph.idle.get(None, 0.0):.4f} s outside them, against "
              f"{own}", file=out)
    statements = max(1, sum(1 for s in hspans if s.layer == "prove"))
    window = defaultdict(float)
    for r in inside(records, hspans, "prove"):
        window[r.name] += r.ns / 1e9 / statements
    table = {"window_prove_s": dict(window)}
    for layer, ph in phases.items():
        table[layer] = {
            "none": {"ops": int(ph.ops.get(None, 0)),
                     "idle_s": ph.idle.get(None, 0.0)},
            **{name: {"calls": ph.calls.get(name, 0),
                      "self_s": ph.self_s.get(name, 0.0),
                      "incl_s": ph.incl_s.get(name, 0.0),
                      "ops": int(ph.ops.get(name, 0)),
                      "op_s": ph.op_s.get(name, 0.0),
                      "idle_s": ph.idle.get(name, 0.0)}
               for name in ph.calls}}
    print("progtrace_table " + json.dumps(table, sort_keys=True), file=out)
