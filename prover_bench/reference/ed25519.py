"""ed25519 (RFC 8032) on the host in Python ints: the curve's constants,
point decompression and the single-signature check [S]B = R + [h]A with
h = SHA-512(R ‖ A ‖ M) mod L, as RFC 8032 §5.1.7 states it."""

from __future__ import annotations

import hashlib

Q = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, Q - 2, Q)) % Q
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
B_POINT = (BX, BY, 1, (BX * BY) % Q)   # extended coordinates (X, Y, Z, T)
IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    """Extended-coordinates addition, a = −1 (RFC 8032 §5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % Q
    b = ((y1 + x1) * (y2 + x2)) % Q
    c = (2 * t1 * t2 * D) % Q
    dd = (2 * z1 * z2) % Q
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return ((e * f) % Q, (g * h) % Q, (f * g) % Q, (e * h) % Q)


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


def point_decompress(s: bytes):
    """RFC 8032 §5.1.3: the point of a 32-byte encoding, None if it is
    none."""
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= Q:
        return None
    u = (y * y - 1) % Q
    v = (D * y * y + 1) % Q
    x = (u * pow(v, 3, Q) * pow(u * pow(v, 7, Q) % Q, (Q - 5) // 8, Q)) % Q
    if (v * x * x) % Q == (-u) % Q:
        x = (x * pow(2, (Q - 1) // 4, Q)) % Q
    elif (v * x * x) % Q != u:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = Q - x
    return (x, y, 1, (x * y) % Q)


def verify(pubkey: bytes, msg: bytes, signature: bytes) -> bool:
    """RFC 8032 §5.1.7, cofactorless: S < L and [S]B = R + [h]A."""
    if len(signature) != 64:
        return False
    A = point_decompress(pubkey)
    R = point_decompress(signature[:32])
    s = int.from_bytes(signature[32:], "little")
    if A is None or R is None or s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(signature[:32] + pubkey + msg)
                       .digest(), "little") % L
    return point_equal(scalar_mult(s, B_POINT),
                       point_add(R, scalar_mult(h, A)))
