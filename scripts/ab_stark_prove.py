#!/usr/bin/env python3
"""Prove the first slice's statements from several checkouts of the port, in
turns, on one card: an A/B of prove seconds within one machine.

    python3 scripts/ab_stark_prove.py DIR [DIR ...]

Each DIR is a checkout of this repository (for example the parent commit
unpacked with `git archive`); give them in the order to run, such as
parent, change, change, parent.  For each, a fresh process builds that
checkout's kernels and runs its `chip_smoke.py` phase-3 statements
(FibonacciAir(20) and RangeCheckAir(19, 16, V=8) at `FriConfig()`, each
proved cold and warm with stage timers, verified and tampered), and prints
its lines tagged with the checkout.  Needs one CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

PHASE3 = r'''
import sys
import numpy as np
import torch
import chip_smoke as cs
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import FibonacciAir, RangeCheckAir, StarkConfig

if not torch.cuda.is_available():
    raise SystemExit("needs a CUDA device")
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)   # the peak-memory counters need a context
card = cs.card_line()
cfg = StarkConfig(fri=FriConfig())
values = np.random.default_rng(0).integers(0, 1 << 16, size=(8, (1 << 19) - 1),
                                           dtype=np.uint64)
for name, air in (("FibonacciAir(log_n=20)", FibonacciAir(log_n=20)),
                  ("RangeCheckAir(log_n=19, bits=16, V=8)",
                   RangeCheckAir(19, 16, values))):
    cs.prove_and_check(name, air, cfg, dev, card)
'''


def main(dirs: list[str]) -> int:
    if not dirs:
        raise SystemExit(__doc__)
    for d in dirs:
        d = os.path.abspath(d)
        proc = subprocess.run([sys.executable, "-c", PHASE3], cwd=d,
                              capture_output=True, text=True)
        tag = os.path.basename(d.rstrip("/"))
        for line in proc.stdout.splitlines():
            if "phase 3:" in line:
                print(f"[{tag}] {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
