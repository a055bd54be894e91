"""One run of one cell: set-up, the measured window, the reference check
and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in `BENCHMARK.json`:
`configs/<config>.json` (through the configuration's `file`),
`traffic/<traffic>.json`, whose `kind` names the module under
`statements/` that makes, proves and checks the statements, and
`metrics/<metric>.py`, whose `read(run)` returns the metric's value or
None when the run holds nothing for it.

The window is a closed loop, one statement in flight: statements are
proved and verified back to back, no statement starts after `seconds`
have passed, and the window closes when the last one started has been
verified, so it overshoots `seconds` by at most one statement.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

from prover_bench import devtrace, hostload, spans
from prover_bench.seeds import derive

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = {"jax", "jaxlib", "flax", "vectorx_tpu"}


@dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    prove_s: list = field(default_factory=list)    # one entry a statement
    verify_s: list = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0                            # over the window
    spans: list = field(default_factory=list)      # spans.Span
    traced_statements: int = 0                     # inside the device trace


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def cell_parts(root: str, spec: dict, workload: str):
    """(cell, configuration file, traffic file) of `workload`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(root, conf["file"])
    traffic = load_json(root, os.path.join(
        os.path.relpath(HERE, root), "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(spec: dict, key: str, workload: str) -> list:
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "prover_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def statements_module(kind: str):
    return importlib.import_module(f"prover_bench.statements.{kind}")


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def card_line(count: int) -> dict:
    """The card's name, the cards the run uses, and the power limit
    nvidia-smi reads."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def run_cell(root: str, spec: dict, workload: str, seed: int,
             seconds: float, trace: bool, device, t0: float) -> dict:
    """Set up, measure, check.  Returns the result line (without the
    card's fields when `device` is not CUDA)."""
    import torch

    cell, config, traffic = cell_parts(root, spec, workload)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kind = statements_module(traffic["kind"])
    st = kind.Statements(config, traffic, seed, device)
    rec = spans.Recorder(sync)
    metrics = cell_metrics(spec, "per_layer" if trace else "end_to_end",
                           workload)
    readers = {m["name"]: reader(m["name"]) for m in metrics}

    # ---- set-up: one whole statement of the cell's shapes, so that every
    # table, kernel and allocator block the window uses exists ------------
    warm = st.inputs(-1)
    try:
        st.verify(warm, st.prove(warm, spans.Recorder(sync)))
    except Exception:
        # the window's statements fail the same way, and are counted
        traceback.print_exc()
    del warm
    dev_trace = None
    if trace and on_card:
        dev_trace = devtrace.DeviceTrace()
        dev_trace.calibrate()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(setup_s=time.perf_counter() - t0)
    undo = []
    if trace:
        undo = spans.install(rec, [t for r in readers.values()
                                   for t in getattr(r, "SPANS", [])])

    # ---- the window -------------------------------------------------------
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kept, verdicts = [], []
    traced = contextlib.ExitStack()
    if dev_trace is not None and dev_trace.marker_name is not None:
        # the device trace covers the window's first statement
        dev_trace.start()
        rec.marker = dev_trace.marker
        traced.enter_context(rec.span("traced"))
    gcc = hostload.GcClock()
    t_open = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t_open < seconds:
        inp = st.inputs(i)
        ok, keep, host = False, None, ""
        try:
            h0 = hostload.snapshot(gcc)
            with rec.span("prove") as sp:
                out = st.prove(inp, rec)
            run.prove_s.append(sp.seconds)
            h1 = hostload.snapshot(gcc)
            with rec.span("verify") as sv:
                ok = st.verify(inp, out)
            run.verify_s.append(sv.seconds)
            host = (f"; prove {hostload.describe(h0, h1)}; verify "
                    f"{hostload.describe(h1, hostload.snapshot(gcc))}")
            keep = st.keep(out)
            del out
        except Exception:
            traceback.print_exc()
        kept.append(keep)
        verdicts.append(ok)
        print(f"statement {i}: {'accepted' if ok else 'NOT ACCEPTED'}, "
              f"prove and verify ends at {time.perf_counter() - t_open:.3f} "
              f"s of the window{host}", file=sys.stderr)
        i += 1
        if rec.marker is not None:
            traced.close()
            rec.marker = None
            run.traced_statements = i
            ops = dev_trace.stop()
    sync()
    run.window_s = time.perf_counter() - t_open
    gcc.close()
    print(f"window: {i} statements in {run.window_s:.3f} s", file=sys.stderr)
    spans.uninstall(undo)
    banned = banned_modules()
    if banned:
        raise SystemExit(f"modules of the JAX package or JAX loaded: {banned}")
    run.peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    run.spans = rec.spans

    failed = sum(1 for ok in verdicts if not ok)
    result = {"correct": False, "attempted": i, "failed": failed,
              "metrics": {}, "device": {}}
    if on_card:
        result["device"] = card_line(cell["chips"])
        result["device"]["memory_peak_bytes"] = max(setup_peak,
                                                    run.peak_bytes)

    # ---- the device trace ------------------------------------------------
    if trace and run.traced_statements:
        idle = devtrace.attribute(ops, dev_trace.marker_name,
                                  rec.boundaries, rec.spans)
        del ops
        win = next(s for s in rec.spans if s.layer == "traced")
        if idle is not None and win.dev_s > 0:
            result["device"]["busy_s"] = win.busy_s
            result["device"]["window_s"] = win.dev_s
            result["breakdown"] = {"device_ops": devtrace.top(win.kernels),
                                   "idle_gaps": devtrace.top(idle)}

    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check: the reference on a statement drawn from the seed ------
    if on_card:
        torch.cuda.empty_cache()
    j = derive(seed, "sample") % i
    checks = {"rejected": (failed, 0)}
    numbers = {}
    if kept[j] is not None:
        t_ref = time.perf_counter()
        numbers = st.compare(kept[j], st.reference(st.inputs(j)))
        print(f"reference: statement {j} of {i} worked out again in "
              f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for name, limit in st.checks.items():
        checks[name] = (numbers.get(name), limit)
    result["correct"] = all(v is not None and v <= lim
                            for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    return result


def main(args, t0: float, root: str) -> int:
    import torch

    spec = load_json(root, "BENCHMARK.json")
    cell, _config, _traffic = cell_parts(root, spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no card: the cell needs {cell['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    vk = tempfile.mkdtemp(prefix="prover_bench_vk_")
    os.environ["VECTORX_VK_CACHE"] = vk
    try:
        result = run_cell(root, spec, args.workload, args.seed,
                          args.seconds, bool(args.trace), "cuda", t0)
    finally:
        shutil.rmtree(vk, ignore_errors=True)
    print(json.dumps(result))
    return 0
