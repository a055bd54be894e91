"""Where the benchmark cuts the program into layers: for each span layer,
the module attributes of `vectorx_tpu_torch` whose calls it wraps, and the
counter that reads a call's work from its arguments' shapes.  A metric
reader lists the targets it needs in its `SPANS`; the harness installs
the union of those of the cell's metrics, and only in a traced run.

The program's modules call these attributes through their modules at call
time (`poseidon.hash_no_pad`, the `fri.fri` globals, `cuda_ntt.coset_lde`),
so a wrapper set on the module is the one they reach.
"""

from __future__ import annotations

import math


def _rows(t) -> int:
    return math.prod(t.shape[:-1])


def _cuda(t) -> bool:
    return bool(getattr(t, "is_cuda", False))


def hash_states(a, kw) -> dict:
    """`poseidon.hash_no_pad(x)`: one permutation per 8 lanes of a row."""
    x = a[0]
    return {"states": _rows(x) * -(-x.shape[-1] // 8) if _cuda(x) else 0}


def compress_states(a, kw) -> dict:
    """`poseidon.two_to_one(left, right)`: one permutation per row."""
    return {"states": _rows(a[0]) if _cuda(a[0]) else 0}


def permute_states(a, kw) -> dict:
    """`poseidon.permute(state)`: one permutation per (…, 12) row."""
    return {"states": _rows(a[0]) if _cuda(a[0]) else 0}


def transform_shape(a, kw) -> dict:
    """`ntt._transform(x, log_n, inverse, shift=None)`."""
    x, log_n = a[0], a[1]
    if not _cuda(x):
        return {}
    return {"rows": x.numel() >> log_n, "log_n": log_n, "rate_bits": 0,
            "lde": False}


def lde_shape(a, kw) -> dict:
    """`cuda_ntt.coset_lde(x, rate_bits, shift=…)`."""
    x = a[0]
    rate_bits = a[1] if len(a) > 1 else kw["rate_bits"]
    if not _cuda(x):
        return {}
    n = x.shape[-1]
    return {"rows": x.numel() // n, "log_n": n.bit_length() - 1,
            "rate_bits": rate_bits, "lde": True}


POSEIDON = "vectorx_tpu_torch.hash.poseidon"
POSEIDON_SPANS = [("poseidon", POSEIDON, "hash_no_pad", hash_states),
                  ("poseidon", POSEIDON, "two_to_one", compress_states),
                  ("poseidon", POSEIDON, "permute", permute_states)]

NTT_SPANS = [("ntt", "vectorx_tpu_torch.ntt.ntt", "_transform",
              transform_shape),
             ("ntt", "vectorx_tpu_torch.ntt.cuda_ntt", "coset_lde",
              lde_shape),
             ("ntt", "vectorx_tpu_torch.ntt.cuda_ntt", "coset_lde_plain",
              lde_shape)]

COMMIT_SPANS = [("commit", "vectorx_tpu_torch.stark.stages", "commit_rows",
                 None)]

FRI_SPANS = [("fri", "vectorx_tpu_torch.fri.fri", name, None)
             for name in ("fri_commit_layer", "fri_fold", "fri_final_coeffs",
                          "grind")]


def proving(spans, layer: str) -> list:
    """The spans of `layer` that run inside a prove span."""
    return [s for s in spans if s.layer == layer and "prove" in s.path]


def per_statement(spans, layer: str, statements: int) -> float | None:
    """Seconds a statement spends in `layer` while it is proved."""
    sel = proving(spans, layer)
    if not sel or not statements:
        return None
    return sum(s.seconds for s in sel) / statements


def idle_pct(spans, layer: str) -> float | None:
    """The share of the traced spans of `layer` in which the card runs no
    operation, in %."""
    sel = [s for s in spans if s.layer == layer and s.traced and s.dev_s > 0]
    if not sel:
        return None
    return 100.0 * (1.0 - sum(s.busy_s for s in sel)
                    / sum(s.dev_s for s in sel))
