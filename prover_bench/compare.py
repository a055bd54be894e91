"""The comparison that decides `correct`: outputs of the program against
the reference's, element by element."""

from __future__ import annotations

import dataclasses

import numpy as np


def flatten(obj) -> list[int]:
    """Every integer of a proof object (dataclasses, lists, tuples, ints),
    in field order."""
    out: list[int] = []

    def walk(o):
        if dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        else:
            out.append(int(o))

    walk(obj)
    return out


def proof_diff(program, reference) -> int:
    """Positions at which the two proofs' integers differ, plus the
    difference of their lengths."""
    a, b = flatten(program), flatten(reference)
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def array_diff(program: np.ndarray, reference: np.ndarray) -> int:
    """Elements that differ between two arrays of field elements (every
    element when the shapes differ)."""
    if program.shape != reference.shape:
        return max(program.size, reference.size)
    return int(np.count_nonzero(program != reference))
