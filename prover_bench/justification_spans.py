"""Whether the program records spans in its batched signature check
(`curves.ed25519_batch.batch_verify`), for the readers of the cell
header_range_256.justification.

Those readers arm the program's tracer (`progtrace.arm`) only where the
check records spans: `progtrace` cannot attribute a traced window in which
the program opened no span at all, which is the whole window of this cell
on a program without them.  The probe checks no signature: it calls
`batch_verify` on an empty batch under a tracer of its own, before the
harness installs any.
"""

from __future__ import annotations

import importlib
import random

from prover_bench import progtrace


def recorded() -> bool:
    """Whether an empty `batch_verify` records a span."""
    try:
        tracing = importlib.import_module("vectorx_tpu_torch.tracing")
    except ImportError:
        return False
    batch = importlib.import_module("vectorx_tpu_torch.curves.ed25519_batch")
    tracer = tracing.install(tracing.Tracer())
    try:
        batch.batch_verify([], [], [], rng=random.Random(0), device="cpu")
    finally:
        tracing.uninstall()
    return bool(tracer.records)


def arm() -> bool:
    """`progtrace.arm()` where the check records spans; whether armed."""
    return recorded() and progtrace.arm()
