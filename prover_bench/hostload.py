"""What the host did while a statement ran, for the run's log on standard
error: the process's CPU seconds (all threads, and of them the kernel's)
and the garbage collector's seconds.  Read at statement boundaries only;
no metric reads them."""

from __future__ import annotations

import gc
import os
import time


class GcClock:
    """Seconds spent in the garbage collector since it was installed."""

    def __init__(self):
        self.total = 0.0
        self._t = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None

    def close(self):
        gc.callbacks.remove(self._cb)


def snapshot(gcc: GcClock) -> dict:
    t = os.times()
    return {"wall": time.perf_counter(), "cpu": t.user + t.system,
            "sys": t.system, "gc": gcc.total}


def describe(a: dict, b: dict) -> str:
    d = {k: b[k] - a[k] for k in a}
    return (f"{d['wall']:.3f} s (cpu {d['cpu']:.2f}, sys {d['sys']:.2f}, "
            f"gc {d['gc']:.3f})")
