"""ed25519 (RFC 8032) — host reference implementation.

Role: GRANDPA precommit signatures.  The reference pre-verifies every
signature host-side with ed25519-dalek before witnessing
(upstream circuits/input/mod.rs:241-247, bin/indexer.rs:73-92) and
batch-verifies them in-circuit via curta's EdDSA STARK
(upstream circuits/builder/justification.rs:237-243).

This module is the host path: keygen/sign (used by the hermetic synthetic
Avail fixtures — the reference has no offline fixtures, SURVEY.md §4) and
verify (witness pre-check).  The batched verification path lives in
`vectorx_tpu_torch.curves.ed25519_batch` (the ladder on 16-bit limbs).
"""

from __future__ import annotations

import hashlib

# Curve constants (RFC 8032 §5.1)
Q = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, Q - 2, Q)) % Q
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
B_POINT = (BX, BY, 1, (BX * BY) % Q)  # extended coordinates (X, Y, Z, T)
IDENTITY = (0, 1, 1, 0)


def _inv(x: int) -> int:
    return pow(x, Q - 2, Q)


def point_add(p, q):
    """Extended-coordinates addition (complete formula for a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % Q
    b = ((y1 + x1) * (y2 + x2)) % Q
    c = (2 * t1 * t2 * D) % Q
    dd = (2 * z1 * z2) % Q
    e = b - a
    f = dd - c
    g = dd + c
    h = b + a
    return ((e * f) % Q, (g * h) % Q, (f * g) % Q, (e * h) % Q)


def point_double(p):
    return point_add(p, p)


def scalar_mult(k: int, p):
    r = IDENTITY
    while k > 0:
        if k & 1:
            r = point_add(r, p)
        p = point_add(p, p)
        k >>= 1
    return r


def point_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % Q == 0 and (y1 * z2 - y2 * z1) % Q == 0


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x = (x * zi) % Q
    y = (y * zi) % Q
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes):
    """Decompress a 32-byte point; returns None if invalid."""
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= Q:
        return None
    # x^2 = (y^2 - 1) / (d y^2 + 1)
    y2 = (y * y) % Q
    u = (y2 - 1) % Q
    v = (D * y2 + 1) % Q
    # candidate root: (u/v)^((q+3)/8)
    x = (u * pow(v, 3, Q) * pow(u * pow(v, 7, Q) % Q, (Q - 5) // 8, Q)) % Q
    vxx = (v * x * x) % Q
    if vxx == u % Q:
        pass
    elif vxx == (-u) % Q:
        x = (x * pow(2, (Q - 1) // 4, Q)) % Q
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = Q - x
    return (x, y, 1, (x * y) % Q)


def secret_expand(secret: bytes):
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= (1 << 254)
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(scalar_mult(a, B_POINT))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(secret)
    pk = point_compress(scalar_mult(a, B_POINT))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = point_compress(scalar_mult(r, B_POINT))
    h = int.from_bytes(hashlib.sha512(R + pk + msg).digest(), "little") % L
    s = (r + h * a) % L
    return R + int.to_bytes(s, 32, "little")


def verify(pubkey: bytes, msg: bytes, signature: bytes) -> bool:
    """Check [S]B = R + [H(R,A,M)]A — the equation the reference's
    `verify_signature` (input/mod.rs:241-247) and curta's EdDSA AIR enforce."""
    if len(signature) != 64:
        return False
    A = point_decompress(pubkey)
    if A is None:
        return False
    R = point_decompress(signature[:32])
    if R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(
        hashlib.sha512(signature[:32] + pubkey + msg).digest(), "little") % L
    sB = scalar_mult(s, B_POINT)
    hA = scalar_mult(h, A)
    return point_equal(sB, point_add(R, hA))
