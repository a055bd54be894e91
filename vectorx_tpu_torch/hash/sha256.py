"""SHA-256 — batched torch compression + host reference.

Port of `vectorx_tpu.hash.sha256`.  The reference runs the 64-round
compression on uint32 lanes; CPU torch has no uint32 add, shift or compare,
so here a 32-bit word is an int64 tensor holding a value in [0, 2^32): every
add and left shift is masked back to 32 bits, and right shifts of such
non-negative values are exact.  The batch axis is vectorized; the schedule
and rounds unroll in Python (eager torch has no compile-time cost to save).

Host paths use hashlib (C speed), e.g. the sequential chained
authority-set commitment.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

M32 = 0xFFFFFFFF

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & M32


def compress_blocks(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression per batch row.

    state: (B, 8) int64 words; words: (B, 16) int64 (one 64-byte block per
    row, big-endian words).  Returns the updated (B, 8) state."""
    w = list(words.unbind(1))
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state.unbind(1)
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + (_K[t] + w[t])
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + S0 + maj) & M32)
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & M32


def _pad_to_blocks(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """(B, msg_len) bytes -> (B, nblocks, 16) big-endian words with SHA
    padding (all rows share msg_len)."""
    B = msgs.shape[0]
    total = msg_len + 1 + 8
    nblocks = (total + 63) // 64
    buf = np.zeros((B, nblocks * 64), dtype=np.uint8)
    buf[:, :msg_len] = msgs
    buf[:, msg_len] = 0x80
    buf[:, -8:] = np.frombuffer(int(msg_len * 8).to_bytes(8, "big"),
                                dtype=np.uint8)
    return buf.reshape(B, nblocks, 16, 4).view(">u4")[..., 0].astype(np.int64)


def _state0(B: int, device) -> torch.Tensor:
    return torch.tensor(_H0, dtype=torch.int64,
                        device=device).expand(B, 8).contiguous()


def digest_words_to_bytes(state: torch.Tensor) -> np.ndarray:
    """(B, 8) int64 words -> (B, 32) uint8 big-endian digests."""
    st = state.cpu().numpy().astype(">u4")
    return st.view(np.uint8).reshape(-1, 32)


def sha256_batch(msgs: np.ndarray, device) -> np.ndarray:
    """SHA-256 of a batch of equal-length messages.

    msgs: (B, L) uint8.  Returns (B, 32) uint8 digests.  The compression
    loop runs on `device`, vectorized over B."""
    B, L = msgs.shape
    words = torch.from_numpy(_pad_to_blocks(msgs, L)).to(device)
    state = _state0(B, device)
    for blk in range(words.shape[1]):
        state = compress_blocks(state, words[:, blk])
    return digest_words_to_bytes(state)


def hash_pairs_words(level: torch.Tensor) -> torch.Tensor:
    """SHA256(left || right) of each sibling pair of (n, 8) digest words,
    staying on the device: (n, 8) -> (n/2, 8)."""
    m = level.shape[0] // 2
    state = compress_blocks(_state0(m, level.device), level.reshape(m, 16))
    # the padding block of a 64-byte message: 0x80, zeros, bit length 512
    pad = torch.zeros(16, dtype=torch.int64, device=level.device)
    pad[0] = 0x80000000
    pad[15] = 512
    return compress_blocks(state, pad.expand(m, 16))


def sha256(data: bytes) -> bytes:
    """Host single-shot (hashlib)."""
    return hashlib.sha256(data).digest()


def chained_hash(items: list[bytes]) -> bytes:
    """Chained SHA-256: H(..H(H(x0) || x1) || x2 ..) — the authority-set
    commitment shape (justification.rs:127-162, input/mod.rs:250-260)."""
    acc = b""
    for item in items:
        acc = hashlib.sha256(acc + item).digest()
    return acc
