"""The port's byte hashes on CPU torch against the JAX package and hashlib:
batched SHA-256, variable-length Blake2b, the chained commitment and the
SHA-256 Merkle roots.  Every comparison is exact (digest bytes, or u64 word
bit patterns carried across by `interop`)."""

import hashlib

import numpy as np
import pytest
import torch

from vectorx_tpu import merkle as jmerkle
from vectorx_tpu.hash import blake2b as jb2
from vectorx_tpu.hash import sha256 as jsha
from vectorx_tpu_torch import interop
from vectorx_tpu_torch import merkle as tmerkle
from vectorx_tpu_torch.hash import blake2b as tb2
from vectorx_tpu_torch.hash import sha256 as tsha

torch.set_num_threads(1)

LENGTHS = [0, 1, 55, 56, 64, 127, 128, 129, 35840]


def _messages():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in LENGTHS]


def test_blake2b_batch_matches_reference_and_hashlib():
    msgs = _messages()
    buf = np.zeros((len(msgs), max(LENGTHS)), dtype=np.uint8)
    for i, m in enumerate(msgs):
        buf[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
    buf[0, :7] = 0xAB                   # bytes past a row's length are ignored
    lengths = np.array(LENGTHS)
    got = tb2.blake2b_batch(buf, lengths, "cpu")
    assert np.array_equal(got, jb2.blake2b_batch(buf, lengths))
    for i, m in enumerate(msgs):
        assert got[i].tobytes() == hashlib.blake2b(
            m, digest_size=32).digest(), LENGTHS[i]


def test_blake2b_compression_on_reference_words():
    """One compression on random state and message words, carried in as
    the reference's (lo, hi) lane pairs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    h = rng.integers(0, 2**64, size=(3, 8), dtype=np.uint64)
    m = rng.integers(0, 2**64, size=(3, 16), dtype=np.uint64)
    t = np.array([128, 77, 0], dtype=np.uint32)
    last = np.array([0, 1, 1], dtype=np.uint32)

    def halves(x):
        return ((x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (x >> np.uint64(32)).astype(np.uint32))

    (hl, hh), (ml, mh) = halves(h), halves(m)
    jl, jh = jb2._compress_body(jnp.asarray(hl), jnp.asarray(hh),
                                jnp.asarray(ml), jnp.asarray(mh),
                                jnp.asarray(t), jnp.asarray(last))
    got = tb2.compress(interop.limbs_to_tensor(hl, hh, "cpu"),
                       interop.limbs_to_tensor(ml, mh, "cpu"),
                       torch.from_numpy(t.astype(np.int64)),
                       torch.from_numpy(last.astype(bool)))
    gl_, gh = interop.tensor_to_limbs(got)
    assert np.array_equal(gl_, np.asarray(jl))
    assert np.array_equal(gh, np.asarray(jh))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 127, 128, 129])
def test_sha256_batch_matches_reference_and_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, size=(3, length), dtype=np.uint8)
    got = tsha.sha256_batch(msgs, "cpu")
    assert np.array_equal(got, jsha.sha256_batch(msgs))
    for i in range(3):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_sha256_long_message_and_chained_hash():
    msg = _messages()[-1]
    got = tsha.sha256_batch(np.frombuffer(msg, dtype=np.uint8)[None], "cpu")
    assert got[0].tobytes() == hashlib.sha256(msg).digest()
    items = [bytes([i]) * 32 for i in range(7)]
    assert tsha.chained_hash(items) == jsha.chained_hash(items)


@pytest.mark.parametrize("n", [1, 2, 8, 256])
def test_sha256_merkle_roots_match_reference(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    as_bytes = [row.tobytes() for row in leaves]
    want = jmerkle.sha256_merkle_root(as_bytes)
    assert tmerkle.sha256_merkle_root(as_bytes) == want
    assert tmerkle.sha256_merkle_root_device(leaves, "cpu") == want
    assert jmerkle.sha256_merkle_root_device(leaves) == want
    # zero-extension to the next power of two
    if n > 1:
        assert tmerkle.sha256_merkle_root(as_bytes[:-1]) == \
            jmerkle.sha256_merkle_root(as_bytes[:-1])
