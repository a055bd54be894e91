"""Seeds of a run's inputs, derived from `--seed`: any whole number gives
the same inputs every time it is given."""

from __future__ import annotations

import hashlib


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for the inputs named by `parts` (a purpose, an index)
    of the run seeded with `seed`."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1
