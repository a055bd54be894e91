"""The device trace of a traced run, cut at the benchmark's own spans.

`torch.profiler` records the card's operations (kernels, copies, sets)
through CUPTI.  Every span boundary of the traced interval synchronized
the device and then launched one marker kernel (`torch.cuda._sleep`), so
the n-th marker in the trace is the n-th boundary the recorder saw: a
device operation belongs to the innermost span open at its start.  Each
span gets its device interval, the summed time and the union of the
operations inside it, and their times by name; the gaps between
operations are charged to the innermost span open across them.
"""

from __future__ import annotations

import sys
from collections import defaultdict


class DeviceTrace:
    """Start and stop the profiler, then read the card's operations."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.marker_name = None

    def _profiler(self):
        torch = self.torch
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def marker(self) -> None:
        self.torch.cuda._sleep(1)

    def calibrate(self) -> None:
        """Learn the marker kernel's name from a trace of one marker (and
        bring CUPTI up before the window)."""
        prof = self._profiler()
        prof.start()
        self.torch.cuda.synchronize()
        self.marker()
        self.torch.cuda.synchronize()
        prof.stop()
        names = {name for _s, _e, name in self._ops(prof)}
        self.marker_name = names.pop() if len(names) == 1 else None
        if self.marker_name is None:
            print(f"devtrace: the marker's trace holds {sorted(names)}; no "
                  f"device metric can be read", file=sys.stderr)

    def start(self) -> None:
        self.prof = self._profiler()
        self.prof.start()

    def stop(self) -> list:
        """Stop; the device operations as (start_ns, end_ns, name), sorted
        by start."""
        self.torch.cuda.synchronize()
        self.prof.stop()
        ops = self._ops(self.prof)
        self.prof = None
        ops.sort()
        return ops

    def _ops(self, prof) -> list:
        cuda = self.torch._C._autograd.DeviceType.CUDA
        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
        return out


def attribute(ops: list, marker_name: str, boundaries: list, spans: list):
    """Cut the sorted device operations `ops` at the markers, one per
    recorded boundary, and fill each traced span's device fields.
    Returns {innermost span path: idle seconds} over the traced interval,
    or None when the markers do not match the boundaries."""
    marks = [op for op in ops if op[2] == marker_name]
    if len(marks) != len(boundaries):
        print(f"devtrace: {len(marks)} markers in the trace against "
              f"{len(boundaries)} span boundaries; no device metric is "
              f"read", file=sys.stderr)
        return None
    at = {}
    for (kind, sid), (s, e, _n) in zip(boundaries, marks):
        at[(kind, sid)] = (s, e)
    for sp in spans:
        if sp.traced:
            sp.dev_s = (at[("close", sp.sid)][0] - at[("open", sp.sid)][1]) / 1e9

    self_kernel = defaultdict(float)
    self_busy = defaultdict(float)
    self_names = defaultdict(lambda: defaultdict(float))
    idle_by_path = defaultdict(float)
    stack: list[int] = []
    busy_end = None
    it = iter(zip(boundaries, marks))
    for start, end, name in ops:
        if name == marker_name:
            kind, sid = next(it)[0]
            if busy_end is not None and start > busy_end and stack:
                idle_by_path[_path(spans, stack[-1])] += (start - busy_end) / 1e9
            busy_end = end if busy_end is None else max(busy_end, end)
            if kind == "open":
                stack.append(sid)
            else:
                stack.pop()
            continue
        if not stack:
            continue
        sid = stack[-1]
        dur = (end - start) / 1e9
        self_kernel[sid] += dur
        self_names[sid][name] += dur
        if busy_end is None or start >= busy_end:
            if busy_end is not None and start > busy_end:
                idle_by_path[_path(spans, sid)] += (start - busy_end) / 1e9
            self_busy[sid] += dur
            busy_end = end
        elif end > busy_end:
            self_busy[sid] += (end - busy_end) / 1e9
            busy_end = end

    # inclusive sums: a child is recorded after its parent
    for sp in reversed(spans):
        if not sp.traced:
            continue
        sp.kernel_s += self_kernel.get(sp.sid, 0.0)
        sp.busy_s += self_busy.get(sp.sid, 0.0)
        for name, sec in self_names.get(sp.sid, {}).items():
            sp.kernels[name] = sp.kernels.get(name, 0.0) + sec
        if sp.parent is not None and spans[sp.parent].traced:
            par = spans[sp.parent]
            par.kernel_s += sp.kernel_s
            par.busy_s += sp.busy_s
            for name, sec in sp.kernels.items():
                par.kernels[name] = par.kernels.get(name, 0.0) + sec
    return dict(idle_by_path)


def _path(spans, sid: int) -> str:
    sp = spans[sid]
    return "/".join((*sp.path, sp.layer))


def top(pairs: dict, k: int = 10) -> list:
    """The k largest (name, seconds) entries, largest first."""
    return [[n, s] for n, s in sorted(pairs.items(), key=lambda kv: -kv[1])[:k]]
