"""Batched ed25519 verification on a torch device — GRANDPA signature
checking.  Port of the ladder path of `vectorx_tpu.curves.ed25519_batch`.

Where the reference circuits batch-verify ≤300 signatures inside curta's
EdDSA STARK (upstream circuits/builder/justification.rs:237-243),
this module verifies them as ONE randomized aggregate curve equation:

    Σ_i z_i·( [S_i]B − [h_i]A_i − R_i ) = 𝒪,   z_i random 128-bit,

a single multi-scalar multiplication over 2n+1 points, run as ONE batched
double-and-add ladder (253 steps over (N, 16)-limb coordinates) and a
log-depth pairwise point reduction.

Field arithmetic: GF(2^255 − 19) as 16 × 16-bit limbs, as in the reference,
but held in int64 (the reference holds them in uint32).  The largest value
any step holds is a product column: at most 16 products of two 16-bit limbs,
below 2^36, far inside int64; the reference instead splits each product into
16-bit halves to stay inside uint32.  A subtraction adds the complement
(a + 2^256 − b) so every column is non-negative.  Each step computes the
same integer as the reference's step and carries it into the same 16-bit
digits (`_carry16` does it in a fixed number of vector ops instead of a
ripple over the columns), so the limbs equal the reference's limb for limb.
Values stay semi-reduced (< 2^256) between ops; canonicalization happens
only at equality checks.

The Pippenger `msm` (and `batch_verify(method="msm")`) runs on the device
of its point tensors, as plain torch; `msm_sharded` splits its points over
the ranks of a `parallel.mesh.Mesh`.  Not ported: the compile-cache guard.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from vectorx_tpu_torch import tracing
from vectorx_tpu_torch.curves import ed25519 as host

Q = host.Q
L = host.L
NLIMB = 16
MASK16 = 0xFFFF


# ---------------------------------------------------------------------------
# limb helpers
# ---------------------------------------------------------------------------

def _limbs(x: int) -> list[int]:
    return [(x >> (16 * i)) & MASK16 for i in range(NLIMB)]


@functools.lru_cache(maxsize=None)
def _const(x: int, device_str: str) -> torch.Tensor:
    return torch.tensor(_limbs(x), dtype=torch.int64, device=device_str)


def from_int(x: int, batch_shape=(), *, device) -> torch.Tensor:
    return _const(x, str(torch.device(device))).expand(*batch_shape, NLIMB)


def from_ints(xs: list[int], *, device) -> torch.Tensor:
    return torch.tensor([_limbs(x) for x in xs], dtype=torch.int64,
                        device=device)


def to_ints(a: torch.Tensor) -> list[int]:
    arr = a.cpu().reshape(-1, NLIMB).tolist()
    return [sum(v << (16 * i) for i, v in enumerate(row)) % Q for row in arr]


def _carry16(cols: torch.Tensor, bits: int) -> torch.Tensor:
    """Propagate carries over (..., k) non-negative columns, each < 2^bits
    (bits ≤ 48) -> k 16-bit limbs plus a final carry limb appended: the
    same digits as a sequential ripple, in a fixed number of vector ops.

    Parallel passes move each column's high part one column up until every
    column is ≤ 2^16 (the last column keeps its whole value).  Then a
    column can only pass a 1 on: it carries out iff it is 2^16, or it is
    0xFFFF and receives a carry — so the carry out of column i is that of
    the last column j ≤ i that is not 0xFFFF, found by a running max.

    Every step updates the padded copy in place (each shifted high part is
    read before the columns are masked), a few launches a pass: a batched
    ladder runs this some 30 times a point addition."""
    x = torch.nn.functional.pad(cols, (0, 1))
    body, shifted = x[..., :-1], x[..., 1:]     # views of x
    bound = (1 << bits) - 1
    while bound > 1 << 16:
        high = body >> 16
        body.bitwise_and_(MASK16)
        shifted.add_(high)
        bound = MASK16 + (bound >> 16)
    pos = _positions(body.shape[-1], str(body.device))
    last = torch.cummax(torch.where(body == MASK16, -1, pos), dim=-1).values
    cout = torch.gather(body >> 16, -1, last.clamp(min=0)) * (last >= 0)
    shifted.add_(cout)
    body.bitwise_and_(MASK16)
    return x


@functools.lru_cache(maxsize=None)
def _positions(k: int, device_str: str) -> torch.Tensor:
    return torch.arange(k, device=device_str)


def _fold_once(limbs: torch.Tensor, high_bits: int) -> torch.Tensor:
    """One pass of 2^256 ≡ 38: value = low + 38·high, for 16-bit low limbs
    and high limbs < 2^high_bits.  Exact for any input; output limbs are
    16-bit with one appended carry limb."""
    low = limbs[..., :NLIMB]
    high = limbs[..., NLIMB:] * 38                     # limb j ≡ 38·2^(16j)
    k = high.shape[-1]
    cols = low + torch.nn.functional.pad(high, (0, NLIMB - k))
    return _carry16(cols, max(16, high_bits + 6) + 1)


def _fold_n(limbs: torch.Tensor, n: int) -> torch.Tensor:
    """n fold passes, then drop the (provably zero) tail.  A value < 2^512
    needs 3 passes to reach 16 limbs; a value < 2^257 needs 2.  Every limb
    past the low 16 is below 2^16 on entry, and after one fold the carry
    limb is below 2^7."""
    for i in range(n):
        limbs = _fold_once(limbs, 16 if i == 0 else 7)
    return limbs[..., :NLIMB]


def add(a, b):
    # a + b < 2^257 → 2 folds guarantee < 2^256
    return _fold_n(_carry16(a + b, 17), 2)


def sub(a, b):
    """a − b for semi-reduced inputs: the columns a_i + (0xFFFF − b_i), plus
    1 at column 0, carry to a + 2^256 − b, whose carry limb is 0 exactly
    when a < b.  Then the 16 limbs hold (a − b) mod 2^256 and the borrow
    of 2^256 ≡ 38 is compensated by adding 2q − 38."""
    cols = a + (MASK16 - b)
    cols[..., 0].add_(1)
    t = _carry16(cols, 18)
    limbs = t[..., :NLIMB]
    # 2q − 38 = 2^256 − 76 (fits 16 limbs); adding it ≡ −38 mod q
    comp = from_int(2 * Q - 38, device=a.device)
    adjusted = _fold_n(_carry16(limbs + comp, 17), 2)
    return torch.where((t[..., NLIMB] == 0)[..., None], adjusted, limbs)


@functools.lru_cache(maxsize=None)
def _diag_index(device_str: str) -> torch.Tensor:
    """Column of each (i, j) limb product: i + j."""
    i = torch.arange(NLIMB)
    return (i[:, None] + i[None, :]).reshape(-1).to(device_str)


def mul(a, b):
    """Schoolbook 16x16-limb product: the 256 limb products (each < 2^32)
    add into 31 columns (< 16·2^32 = 2^36), carried into 16-bit digits;
    product < 2^512 → 3 folds."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).flatten(-2)
    cols = torch.zeros((*prod.shape[:-1], 2 * NLIMB - 1), dtype=torch.int64,
                       device=prod.device)
    cols.index_add_(-1, _diag_index(str(prod.device)), prod)
    return _fold_n(_carry16(cols, 36), 3)


def sqr(a):
    return mul(a, a)


def canonical(a):
    """Fully reduce semi-reduced (< 2^256) limbs into [0, q)."""
    def cond_sub(x, k):
        # t = x + (2^256 − kq); bit 256 of t set ⟺ x ≥ kq, and then
        # t mod 2^256 = x − kq.
        t = _carry16(x + from_int((1 << 256) - k * Q, device=x.device), 17)
        ge = t[..., NLIMB] > 0
        return torch.where(ge[..., None], t[..., :NLIMB], x)

    # x < 2^256 < 2q + 38: subtract 2q then q
    return cond_sub(cond_sub(a, 2), 1)


def eq(a, b):
    return torch.all(canonical(a) == canonical(b), dim=-1)


# ---------------------------------------------------------------------------
# point ops: extended coordinates (X, Y, Z, T), a = -1 complete formulas
# ---------------------------------------------------------------------------

_D2 = (2 * host.D) % Q


def _stack(*xs):
    return torch.stack(torch.broadcast_tensors(*xs))


def point_add(p, q):
    """The reference's formulas, with the independent field ops of each
    step stacked into one call (the same limbs, fewer launches)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    ys, xs = _stack(y1, y2), _stack(x1, x2)
    s, u = sub(ys, xs), add(ys, xs)          # y − x, y + x of p and q
    a, b, tt, zz = mul(_stack(s[0], u[0], t1, z1), _stack(s[1], u[1], t2, z2))
    c = mul(tt, from_int(_D2, device=tt.device))
    d = add(zz, zz)
    e, f = sub(_stack(b, d), _stack(a, c))
    g, h = add(_stack(d, b), _stack(c, a))
    X, Y, Z, T = mul(_stack(e, g, f, e), _stack(f, h, g, h))
    return (X, Y, Z, T)


def point_identity(batch_shape, *, device):
    z = from_int(0, batch_shape, device=device)
    o = from_int(1, batch_shape, device=device)
    return (z, o, o, z)


def point_select(mask, p, q):
    """mask (...,) bool: p where True else q."""
    m = mask[..., None]
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def is_identity(p):
    x, y, z, _ = p
    zero = from_int(0, x.shape[:-1], device=x.device)
    return eq(x, zero) & eq(y, z)


def scalar_mult_batched(bits: torch.Tensor, points):
    """[s_i]P_i for all i at once.

    bits: (N, 253) scalar bits, MSB first; points: 4×(N, 16).  One
    double-and-add ladder, vectorized over N."""
    acc = point_identity((bits.shape[0],), device=bits.device)
    mask = bits.bool()
    for k in range(bits.shape[1]):
        acc = point_add(acc, acc)
        acc = point_select(mask[:, k], point_add(acc, points), acc)
    return acc


def _reduce_points(p):
    """Pairwise-sum a batch of points down to one."""
    while p[0].shape[0] > 1:
        if p[0].shape[0] % 2:
            pad = point_identity((1,), device=p[0].device)
            p = tuple(torch.cat([a, b], dim=0) for a, b in zip(p, pad))
        p = point_add(tuple(a[0::2] for a in p), tuple(a[1::2] for a in p))
    return p


# ---------------------------------------------------------------------------
# Pippenger MSM — bucketed multi-scalar multiplication
# ---------------------------------------------------------------------------
# Σ_i [s_i]P_i via windowed buckets, in fixed-shape vector steps:
#
#   1. every (point i, window k) pair becomes one element keyed by
#      key = k·2^w + digit_{i,k} — ALL windows bucket in one pass;
#   2. one stable argsort groups equal buckets; a log-depth SEGMENTED
#      Hillis-Steele scan with `point_add` folds each bucket's run, and the
#      run-ends scatter into the (K, 2^w) bucket table;
#   3. Σ_d d·B_d per window via a batched suffix scan over the bucket
#      axis (2^w − 1 steps, each a (K,)-wide point-add);
#   4. Horner over windows: w doublings + 1 add per window.
#
# Work: ~log2(NK)·NK + 2^w·K + w·K point-adds against the ladder's 2·253·N.

MSM_WINDOW = 8                       # digits per window; 2^w buckets


def _digits_host(scalars: list[int], w: int, k: int) -> np.ndarray:
    """(N, K) little-endian w-bit digits."""
    out = np.zeros((len(scalars), k), dtype=np.int64)
    mask = (1 << w) - 1
    for i, s in enumerate(scalars):
        for j in range(k):
            out[i, j] = (s >> (w * j)) & mask
    return out


def _bucket_keys(digits: np.ndarray, k: int, nb: int) -> np.ndarray:
    """(N·K,) keys k·2^w + digit, point-major; digit-0 elements are
    weight-0 and point at the trash slot k·2^w up front."""
    keys = (np.arange(k, dtype=np.int64)[None, :] * nb + digits).reshape(-1)
    return np.where(digits.reshape(-1) == 0, np.int64(k * nb), keys)


def _point_shift(p, j):
    """Shift points right by j along axis 0, front-filled with identity."""
    ident = point_identity((j,), device=p[0].device)
    return tuple(torch.cat([iv, a[:-j]], dim=0) for iv, a in zip(ident, p))


def _segmented_bucket_sums(keys: torch.Tensor, points, n_buckets: int):
    """Inclusive segmented scan + run-end scatter: bucket b gets the sum of
    all points whose (sorted) key is b.  Buckets with no members hold the
    identity."""
    m = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    keys = keys[order]
    acc = tuple(a[order] for a in points)
    j = 1
    while j < m:
        shifted = _point_shift(acc, j)
        same = torch.cat([torch.zeros(j, dtype=torch.bool,
                                      device=keys.device),
                          keys[j:] == keys[:-j]])
        acc = point_select(same, point_add(acc, shifted), acc)
        j <<= 1
    run_end = torch.cat([keys[:-1] != keys[1:],
                         torch.ones(1, dtype=torch.bool, device=keys.device)])
    # scatter run-end sums into the bucket table; non-run-ends go to a
    # trash slot.  Run ends have unique keys, so only the trash slot sees
    # duplicate indices, and only there is CUDA's index_put_
    # nondeterministic (the slot is dropped).
    idx = torch.where(run_end, keys, n_buckets)
    buckets = []
    for ident, a in zip(point_identity((n_buckets + 1,), device=keys.device),
                        acc):
        table = ident.clone(memory_format=torch.contiguous_format)
        table[idx] = a
        buckets.append(table[:n_buckets])
    return tuple(buckets)


def _weighted_bucket_reduce(buckets, k: int, nb: int):
    """Per window: Σ_d d·B_d = Σ_j suffix_j where suffix_j = Σ_{d≥j} B_d.
    One (K,)-batched point-add pair per bucket index, d = nb−1 .. 1
    (bucket 0 is weight-0 and was keyed to trash)."""
    seq = tuple(a.reshape(k, nb, NLIMB)[:, 1:].flip(1).transpose(0, 1)
                for a in buckets)                          # (nb−1, K, 16)
    suffix = total = point_identity((k,), device=buckets[0].device)
    for d in range(nb - 1):
        suffix = point_add(suffix, tuple(a[d] for a in seq))
        total = point_add(total, suffix)
    return total                                           # (K, 16) coords


def _horner_windows(window_sums, w: int):
    """S = Σ_k 2^{wk}·S_k, highest window first: w doublings + 1 add/step."""
    acc = point_identity((), device=window_sums[0].device)
    for i in reversed(range(window_sums[0].shape[0])):
        for _ in range(w):
            acc = point_add(acc, acc)
        acc = point_add(acc, tuple(a[i] for a in window_sums))
    return acc


def _window_sums(scalars: list[int], points, w: int, k: int):
    """The K window sums S_k of Σ_i [s_i]P_i (steps 1-3): digits, bucket
    keys, segmented bucket sums, the weighted reduce; 4×(K, 16) limbs."""
    nb = 1 << w
    keys = torch.from_numpy(_bucket_keys(_digits_host(scalars, w, k), k, nb))
    flat = tuple(a.repeat_interleave(k, dim=0) for a in points)  # (N·K, 16)
    buckets = _segmented_bucket_sums(keys.to(points[0].device), flat, k * nb)
    return _weighted_bucket_reduce(buckets, k, nb)


def msm(scalars: list[int], points, w: int = MSM_WINDOW):
    """Pippenger MSM: Σ_i [s_i]P_i (points as 4×(N, 16) limb tensors, on
    the device the sum runs on).  Returns one extended point (4×(16,)
    limbs, semi-reduced)."""
    assert len(scalars) == points[0].shape[0]
    nbits = max(253, max((s.bit_length() for s in scalars), default=1))
    k = (nbits + w - 1) // w
    return _horner_windows(_window_sums(scalars, points, w, k), w)


def msm_sharded(mesh, scalars: list[int], points, w: int = MSM_WINDOW):
    """Per-rank bucket sharding: each rank Pippenger-reduces its block of
    the points (digit → bucket → window sums locally), the (K, 16)-limb
    window sums of all four coordinates are gathered in ONE all_gather, and
    the fold over the ranks (in rank order) and Horner run on every rank —
    point addition is not componentwise, so the combine is a gather and a
    fold rather than a sum.  `points` are every rank's same 4×(N, 16)
    tensors on `mesh.device`; returns one extended point, as `msm`."""
    n = points[0].shape[0]
    assert len(scalars) == n
    p = mesh.world
    pad = (-n) % p
    if pad:
        ident = point_identity((pad,), device=points[0].device)
        points = tuple(torch.cat([a, b], dim=0)
                       for a, b in zip(points, ident))
        scalars = list(scalars) + [0] * pad
    k = (253 + w - 1) // w
    m = (n + pad) // p
    mine = slice(mesh.rank * m, (mesh.rank + 1) * m)
    wsums = torch.stack(_window_sums(scalars[mine],
                                     tuple(a[mine] for a in points), w, k))
    everyone = mesh.all_gather(wsums[None], dim=0)             # (p, 4, K, 16)
    acc = tuple(everyone[0])
    for r in range(1, p):
        acc = point_add(acc, tuple(everyone[r]))
    return _horner_windows(acc, w)


# ---------------------------------------------------------------------------
# batched verification
# ---------------------------------------------------------------------------

def _bits_msb(x: int, width: int = 253) -> list[int]:
    return [(x >> (width - 1 - i)) & 1 for i in range(width)]


def batch_terms(pubkeys: list[bytes], msgs: list[bytes],
                signatures: list[bytes], signed_mask: list[bool] | None = None,
                *, rng):
    """The aggregate equation's (scalars, points) over the masked-in
    signatures, host-side: [z_i·h_i](−A_i), [z_i](−R_i) and
    [Σ z_i·s_i]B, whose sum is the identity iff every one verifies
    (with overwhelming probability over the z_i).  None if a signature
    does not parse; empty lists if none is masked in."""
    n = len(pubkeys)
    signed_mask = signed_mask or [True] * n
    idxs = [i for i in range(n) if signed_mask[i]]
    if not idxs:
        return [], []
    scalars: list[int] = []
    points: list[tuple] = []
    agg_sB = 0
    for i in idxs:
        A = host.point_decompress(pubkeys[i])
        R = host.point_decompress(signatures[i][:32])
        s = int.from_bytes(signatures[i][32:], "little")
        if A is None or R is None or s >= L:
            return None
        z = rng.getrandbits(128) | 1
        h = int.from_bytes(hashlib.sha512(
            signatures[i][:32] + pubkeys[i] + msgs[i]).digest(),
            "little") % L
        agg_sB = (agg_sB + z * s) % L
        scalars.append((z * h) % L)            # subtracted via negated point
        points.append(tuple(c % Q for c in A))
        scalars.append(z % L)
        points.append(tuple(c % Q for c in R))
    scalars.append(agg_sB)
    points.append(host.B_POINT)
    # negate the A_i and R_i terms: [zh](-A) and [z](-R)
    points = [((Q - x) % Q, y, zc, (Q - t) % Q)
              for (x, y, zc, t) in points[:-1]] + [points[-1]]
    return scalars, points


def batch_verify(pubkeys: list[bytes], msgs: list[bytes],
                 signatures: list[bytes],
                 signed_mask: list[bool] | None = None, *,
                 rng, device, method: str = "ladder") -> bool:
    """Conditional batched verification (curta_eddsa_verify_sigs_conditional
    semantics): signatures where mask is False are skipped; returns True
    iff every masked-in signature verifies.

    `rng` draws the 128-bit randomizers z_i (`rng.getrandbits(128)`, e.g.
    a seeded `random.Random` in tests or `secrets.SystemRandom()` in a
    verifier); the curve work runs on `device`.  `method`: "msm" sums the
    2n+1 points with the Pippenger bucket pipeline at `MSM_WINDOW`; any
    other value runs one batched double-and-add ladder and a reduction.

    Spans: `ed25519_batch.batch_verify` (`terms`: 2·signed + 1), and in it
    `ed25519_batch.terms` (the host's decompressions, challenges and
    randomizers) and `ed25519_batch.ladder` or `ed25519_batch.msm` (the
    curve work on `device`, up to the verdict's copy to the host)."""
    signed = sum(map(bool, signed_mask or [True] * len(pubkeys)))
    with tracing.span("ed25519_batch.batch_verify",
                      terms=2 * signed + 1 if signed else 0) as sp:
        sp.stage("ed25519_batch.terms")
        terms = batch_terms(pubkeys, msgs, signatures, signed_mask, rng=rng)
        if terms is None:
            return False
        scalars, points = terms
        if not scalars:
            return True
        sp.stage("ed25519_batch.msm" if method == "msm"
                 else "ed25519_batch.ladder")
        pts = tuple(from_ints([p[c] for p in points], device=device)
                    for c in range(4))
        if method == "msm":
            total = msm(scalars, pts, MSM_WINDOW)
            return bool(is_identity(tuple(a[None, :] for a in total))[0])
        bits = torch.from_numpy(np.array([_bits_msb(s) for s in scalars],
                                         dtype=np.int64)).to(device)
        total = _reduce_points(scalar_mult_batched(bits, pts))
        return bool(is_identity(total)[0])
