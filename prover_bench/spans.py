"""Host spans around calls into the layers of the program under test.

`Recorder` keeps every span in memory: its layer, its host start and end,
the layers it runs inside, and the work its counter read from the call's
arguments.  In a traced run each span boundary synchronizes the device
and launches one marker kernel, so the device trace can be cut at the
same boundaries (`devtrace`).  `install` wraps module attributes of the
program with such spans, as `chip_smoke.StageTimer` does, and undoes it.
"""

from __future__ import annotations

import importlib
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    sid: int
    layer: str
    parent: int | None
    path: tuple            # layers of the enclosing spans, outermost first
    t0: float
    t1: float = 0.0
    counts: dict = field(default_factory=dict)
    traced: bool = False   # both boundaries carry a marker kernel
    # filled from the device trace (inclusive of child spans)
    dev_s: float = 0.0     # device interval between the two markers
    kernel_s: float = 0.0  # summed device op time inside the span
    busy_s: float = 0.0    # union of device op intervals inside the span
    kernels: dict = field(default_factory=dict)   # op name -> seconds

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """Spans of one run.  `sync` waits for the device (a no-op on a CPU
    run); `marker`, when set, launches one marker kernel."""

    def __init__(self, sync=lambda: None):
        self.sync = sync
        self.marker = None
        self.spans: list[Span] = []
        self.boundaries: list[tuple[str, int]] = []
        self._stack: list[Span] = []

    def inside(self, layer: str) -> bool:
        return any(s.layer == layer for s in self._stack)

    def _boundary(self, kind: str, sid: int) -> bool:
        self.sync()
        if self.marker is None:
            return False
        self.marker()
        self.boundaries.append((kind, sid))
        return True

    @contextmanager
    def span(self, layer: str, counts: dict | None = None):
        parent = self._stack[-1] if self._stack else None
        s = Span(sid=len(self.spans), layer=layer,
                 parent=None if parent is None else parent.sid,
                 path=tuple(p.layer for p in self._stack), t0=0.0,
                 counts=counts or {})
        self.spans.append(s)
        opened = self._boundary("open", s.sid)
        s.t0 = time.perf_counter()
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            closed = self._boundary("close", s.sid)
            s.t1 = time.perf_counter()
            s.traced = opened and closed


def install(recorder: Recorder, targets) -> list:
    """Wrap each (layer, module, attribute, counter) target with a span of
    `layer`; a call inside a span of the same layer opens none.
    `counter(args, kwargs)` returns the work of one call as a dict.
    Returns the undo list for `uninstall`.  A target the program no
    longer has is named on stderr and skipped: its layer's metrics then
    read nothing."""
    undo = []
    seen = set()
    for layer, module, attr, counter in targets:
        if (module, attr) in seen:
            continue
        seen.add((module, attr))
        try:
            owner = importlib.import_module(module)
            orig = getattr(owner, attr)
        except (ImportError, AttributeError) as e:
            print(f"spans: no {module}.{attr} ({e}); layer {layer} "
                  f"reads nothing there", file=sys.stderr)
            continue

        def wrapped(*a, _orig=orig, _layer=layer, _counter=counter, **kw):
            if recorder.inside(_layer):
                return _orig(*a, **kw)
            counts = _counter(a, kw) if _counter else None
            with recorder.span(_layer, counts):
                return _orig(*a, **kw)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))
    return undo


def uninstall(undo) -> None:
    for owner, attr, orig in reversed(undo):
        setattr(owner, attr, orig)
