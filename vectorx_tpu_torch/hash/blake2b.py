"""Blake2b-256 — batched variable-length torch compression + host reference.

Port of `vectorx_tpu.hash.blake2b`: the Avail header hash.  A batch of
headers (each with its own byte length, zero-padded to a shared maximum) is
hashed in one fixed-shape computation: every row runs the same
`max_blocks` compressions, per-row masks select the right counter and
finalization flag, and out-of-range blocks leave the state unchanged.

The reference carries a 64-bit word as a (lo, hi) uint32 pair; here it is
one int64 tensor holding the u64 bit pattern (as in `field.goldilocks`):
``+`` wraps modulo 2^64 exactly like u64, XOR is bitwise, and the
arithmetic right shift of a rotation is masked to the logical one.

Host path: hashlib.blake2b (C).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from vectorx_tpu_torch.field.goldilocks import to_i64

_IV = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]


def _rotr64(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) & ((1 << (64 - r)) - 1)) | (x << (64 - r))


def _g4(a, b, c, d, x, y):
    """Four G functions in parallel on (B, 4) 64-bit lanes."""
    a = a + b + x
    d = _rotr64(d ^ a, 32)
    c = c + d
    b = _rotr64(b ^ c, 24)
    a = a + b + y
    d = _rotr64(d ^ a, 16)
    c = c + d
    b = _rotr64(b ^ c, 63)
    return a, b, c, d


@functools.lru_cache(maxsize=None)
def _sigma_index(device_str: str) -> torch.Tensor:
    """(12, 4, 4) message-word indices per round: column x, column y,
    diagonal x, diagonal y (the reference's _SIG_CX/_CY/_DX/_DY)."""
    s = np.array(_SIGMA, dtype=np.int64)
    idx = np.stack([s[:, 0:8:2], s[:, 1:8:2], s[:, 8:16:2], s[:, 9:16:2]],
                   axis=1)
    return torch.from_numpy(idx).to(device_str)


def _iv_words(device) -> torch.Tensor:
    return torch.tensor([to_i64(v) for v in _IV], dtype=torch.int64,
                        device=device)


def compress(h: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
             is_last: torch.Tensor) -> torch.Tensor:
    """One Blake2b compression per batch row.

    h: (B, 8) chain; m: (B, 16) message words; t: (B,) byte counter
    (< 2^32 for inputs up to the 35,840 B header bound); is_last: (B,)
    bool.  Returns the new (B, 8) chain."""
    dev = h.device
    sig = _sigma_index(str(dev))
    iv = _iv_words(dev)
    v = torch.cat([h, iv.expand(h.shape[0], 8)], dim=1)
    v[:, 12] ^= t
    v[:, 14] ^= torch.where(is_last, -1, 0)        # 0xFFFF...FF when last
    a, b, c, d = v[:, 0:4], v[:, 4:8], v[:, 8:12], v[:, 12:16]
    for r in range(12):
        cx, cy, dx, dy = sig[r]
        a, b, c, d = _g4(a, b, c, d, m[:, cx], m[:, cy])
        # diagonalize: rotate lanes b by 1, c by 2, d by 3
        b, c, d = (torch.roll(b, -1, 1), torch.roll(c, -2, 1),
                   torch.roll(d, -3, 1))
        a, b, c, d = _g4(a, b, c, d, m[:, dx], m[:, dy])
        b, c, d = (torch.roll(b, 1, 1), torch.roll(c, 2, 1),
                   torch.roll(d, 3, 1))
    return h ^ torch.cat([a, b], dim=1) ^ torch.cat([c, d], dim=1)


@functools.lru_cache(maxsize=None)
def _h0(digest_size: int) -> tuple:
    h = list(_IV)
    h[0] ^= 0x01010000 ^ digest_size
    return tuple(to_i64(x) for x in h)


def blake2b_batch(msgs: np.ndarray, lengths: np.ndarray, device,
                  digest_size: int = 32) -> np.ndarray:
    """Blake2b of a batch of variable-length messages in fixed shape.

    msgs: (B, max_len) uint8, zero-padded; lengths: (B,) actual byte
    counts.  Every row runs the same max_blocks compressions on `device`;
    per-row masks pick the right counter and final-block flag, and
    out-of-range blocks leave the state unchanged.  Returns
    (B, digest_size) uint8."""
    B, max_len = msgs.shape
    max_blocks = max(1, (max_len + 127) // 128)
    pad_len = max_blocks * 128
    buf = np.zeros((B, pad_len), dtype=np.uint8)
    buf[:, :max_len] = msgs
    # Blake2b pads with zeros: mask any caller bytes past each row's length
    # so the digest depends only on the first `lengths[i]` bytes
    lengths = np.asarray(lengths, dtype=np.int64)
    buf[np.arange(pad_len)[None, :] >= lengths[:, None]] = 0
    words = torch.from_numpy(
        buf.view("<u8").view(np.int64).reshape(B, max_blocks, 16)).to(device)
    length_t = torch.from_numpy(lengths).to(device)
    nblocks = torch.clamp((length_t + 127) // 128, min=1)
    h = torch.tensor(_h0(digest_size), dtype=torch.int64,
                     device=device).expand(B, 8).contiguous()
    for blk in range(max_blocks):
        t = torch.clamp(length_t, max=(blk + 1) * 128)
        nh = compress(h, words[:, blk], t, nblocks == blk + 1)
        h = torch.where((blk < nblocks)[:, None], nh, h)
    out = h.cpu().numpy().view("<u8").view(np.uint8).reshape(B, 64)
    return out[:, :digest_size].copy()


def blake2b_256(data: bytes) -> bytes:
    """Host single-shot (hashlib) — the Avail header hash
    (`sp_core::Blake2Hasher`, header.rs:31)."""
    return hashlib.blake2b(data, digest_size=32).digest()
