"""Spans inside the port: the stages of a prove or a verify, Poseidon's
calls, the NTT's transforms, the verifier's key derivation.

`span(name, **counts)` is a context manager around one piece of work.  With
no tracer installed it returns one shared no-op object after a single
check of a module global: it reads no clock and records nothing.  With a
`Tracer` installed (`install`), it records the span's name, its parent, its
root (the outermost span open in the thread, so every span of one prove or
verify shares it), its host start and end (`time.perf_counter_ns`) and the
counts given.  A span closes when its body raises.

Spans launch nothing on the device and synchronize nothing: what the device
did meanwhile is read from a device trace put on the same host clock.  The
records stay in the tracer's memory; the port writes them nowhere.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class Record:
    rid: int                   # index in `Tracer.records`
    name: str
    parent: int | None
    root: int
    t0: int                    # host ns, time.perf_counter_ns
    t1: int = -1               # -1 while open
    counts: dict = field(default_factory=dict)
    child_ns: int = 0          # summed duration of the closed children

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    @property
    def self_ns(self) -> int:
        """Duration less the part the span's children cover."""
        return self.ns - self.child_ns


class Tracer:
    """The records of every span opened while this tracer is installed.
    Parent chains follow a stack per thread."""

    def __init__(self, clock=time.perf_counter_ns):
        self.clock = clock
        self.records: list[Record] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str, counts: dict) -> Record:
        st = self._stack()
        parent = st[-1] if st else None
        with self._lock:
            rid = len(self.records)
            rec = Record(rid, name, None if parent is None else parent.rid,
                         rid if parent is None else parent.root, 0,
                         counts=counts)
            self.records.append(rec)
        st.append(rec)
        rec.t0 = self.clock()
        return rec

    def close(self, rec: Record) -> None:
        rec.t1 = self.clock()
        st = self._stack()
        st.remove(rec)
        if rec.parent is not None:
            self.records[rec.parent].child_ns += rec.ns


class _Span:
    """An open span; `stage(name)` closes the stage opened before it in
    this span, if any, and opens the next as a child."""

    __slots__ = ("tracer", "name", "counts", "rec", "_stage")

    def __init__(self, tracer: Tracer, name: str, counts: dict):
        self.tracer = tracer
        self.name = name
        self.counts = counts
        self._stage = None

    def __enter__(self):
        self.rec = self.tracer.open(self.name, self.counts)
        return self

    def __exit__(self, *exc):
        self.stage(None)
        self.tracer.close(self.rec)
        return False

    def stage(self, name: str | None, **counts) -> None:
        if self._stage is not None:
            self.tracer.close(self._stage)
            self._stage = None
        if name is not None:
            self._stage = self.tracer.open(name, counts)


class _Off:
    """What `span` returns with no tracer installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def stage(self, name, **counts) -> None:
        pass


OFF = _Off()
_tracer: Tracer | None = None


def span(name: str, **counts):
    """A span of `name` with `counts` (numbers read from shapes) on the
    installed tracer, or `OFF`."""
    if _tracer is None:
        return OFF
    return _Span(_tracer, name, counts)


def install(tracer: Tracer) -> Tracer:
    """Record every span opened from now on into `tracer`."""
    global _tracer
    _tracer = tracer
    return tracer


def uninstall() -> Tracer | None:
    """Stop recording; returns the tracer that was installed."""
    global _tracer
    tracer, _tracer = _tracer, None
    return tracer
