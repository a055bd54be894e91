"""Hermetic synthetic Avail chain — the offline fixture backend.

The reference has no offline fixtures (every non-trivial test hits a live
Avail RPC — SURVEY.md §4 "no mocks, no fake backends"); this module is the
fixture layer our build adds: a deterministic chain of SCALE-encoded headers
with real blake2b hash-links, real ed25519 GRANDPA justifications, and
ScheduledChange consensus logs at epoch ends, exposing the same query API as
the live client (`RpcDataFetcher`, upstream circuits/input/mod.rs:292+)
so circuits and services run identically against fixtures or a live node.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.curves import ed25519
from vectorx_tpu_torch.hash.blake2b import blake2b_256
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.merkle import sha256_merkle_root

# Deterministic stand-ins for plonky2x's DUMMY_PUBLIC_KEY / DUMMY_SIGNATURE
# (input/mod.rs:20): a real keypair's pubkey and a real signature over a
# fixed message, used only in masked-out lanes.
DUMMY_SECRET = b"\x42" * 32
DUMMY_PUBLIC_KEY = ed25519.public_key(DUMMY_SECRET)
DUMMY_SIGNATURE = ed25519.sign(DUMMY_SECRET, b"vectorx-tpu dummy")


@dataclass
class JustificationData:
    """Mirror of the reference `CircuitJustification` (input/types.rs:30-44)."""

    authority_set_id: int
    signed_message: bytes                 # 53-byte precommit
    validator_signed: list[bool]          # padded to max size by caller
    pubkeys: list[bytes]                  # canonical order, padded
    signatures: list[bytes]               # aligned with pubkeys, padded
    num_authorities: int
    block_number: int
    block_hash: bytes


@dataclass
class HeaderRotateData:
    """Mirror of the reference `HeaderRotateData` (input/types.rs:10-20)."""

    header_bytes: bytes
    header_size: int
    num_authorities: int
    start_position: int
    end_position: int
    new_authority_set_hash: bytes
    padded_pubkeys: list[bytes]


class FixtureChain:
    """Deterministic synthetic chain.

    Era s (authority set id s) governs blocks (s·E, (s+1)·E]; the epoch-end
    header at (s+1)·E carries the ScheduledChange log announcing era s+1's
    authorities; its justification is signed by era s's set — matching the
    set-id semantics the reference derives from grandpa storage
    (input/mod.rs:594-608, 657-700, 835-845).
    """

    def __init__(self, seed: int = 0, num_blocks: int = 64,
                 epoch_length: int = 20, authorities_per_era=None,
                 sign_fraction: float = 0.8, extension_bytes=0):
        """`extension_bytes`: extra per-header extension filler, for
        realistic-size headers (Avail mainnet headers run KBs; the
        reference bounds them at 35,840 B, consts.rs:9-16).  An int pads
        every header uniformly; a callable `block_number -> int` yields
        MIXED header sizes (real chains interleave near-empty and
        data-heavy blocks)."""
        self.seed = seed
        self.num_blocks = num_blocks
        self.epoch_length = epoch_length
        self.sign_fraction = sign_fraction
        self.extension_bytes = extension_bytes
        self._era_sizes = authorities_per_era or (lambda era: 4)
        self._headers: list[scale.Header] = []
        self._encoded: list[bytes] = []
        self._hashes: list[bytes] = []
        self._build()

    # -- key material -------------------------------------------------------

    @functools.lru_cache(maxsize=None)
    def _era_secrets(self, era: int) -> list[bytes]:
        n = self._era_sizes(era)
        return [hashlib.sha256(
            b"vxt-authority" + self.seed.to_bytes(4, "little")
            + era.to_bytes(8, "little") + i.to_bytes(4, "little")).digest()
            for i in range(n)]

    @functools.lru_cache(maxsize=None)
    def era_pubkeys(self, era: int) -> list[bytes]:
        return [ed25519.public_key(s) for s in self._era_secrets(era)]

    # -- chain construction -------------------------------------------------

    def _rand(self, *tags) -> bytes:
        h = hashlib.sha256(b"vxt-rand" + repr((self.seed, *tags)).encode())
        return h.digest()

    def _build(self):
        parent = b"\x00" * 32
        for n in range(self.num_blocks + 1):
            logs = []
            if n > 0 and n % self.epoch_length == 0:
                era = n // self.epoch_length   # new era id
                # filler log before the consensus log exercises start_position
                logs.append(scale.encode_other_log(self._rand("other", n)[:8]))
                logs.append(
                    scale.encode_scheduled_change_log(self.era_pubkeys(era)))
            ext = (self.extension_bytes(n) if callable(self.extension_bytes)
                   else self.extension_bytes)
            filler_len = ext + 40 + (n * 7) % 64
            hdr = scale.Header(
                parent_hash=parent,
                block_number=n,
                state_root=self._rand("state", n),
                extrinsics_root=self._rand("extr", n),
                digest_logs=logs,
                extension_filler=(self._rand("ext", n)
                                  * ((filler_len // 32) + 1))[:filler_len],
                data_root=self._rand("data", n),
            )
            enc = hdr.encode()
            h = blake2b_256(enc)
            self._headers.append(hdr)
            self._encoded.append(enc)
            self._hashes.append(h)
            parent = h

    # -- RpcDataFetcher-equivalent API (SURVEY.md §2 C10) -------------------

    def get_header(self, block_number: int) -> scale.Header:
        return self._headers[block_number]

    def get_encoded_header(self, block_number: int) -> bytes:
        return self._encoded[block_number]

    def get_block_hash(self, block_number: int) -> bytes:
        return self._hashes[block_number]

    def get_head(self) -> scale.Header:
        return self._headers[-1]

    def get_block_headers_range(self, start: int, end: int) -> list[bytes]:
        """Encoded headers for [start, end] inclusive (input/mod.rs:531-563)."""
        return [self._encoded[i] for i in range(start, end + 1)]

    def get_authority_set_id(self, block_number: int) -> int:
        """grandpa.current_set_id as stored at this block."""
        return block_number // self.epoch_length

    def get_authorities(self, block_number: int) -> list[bytes]:
        """Authority set active after this block (input/mod.rs:612-639)."""
        return self.era_pubkeys(self.get_authority_set_id(block_number))

    def compute_authority_set_hash(self, block_number: int) -> bytes:
        """Chained SHA-256 commitment (input/mod.rs:643-655)."""
        return chained_hash(self.get_authorities(block_number))

    def last_justified_block(self, authority_set_id: int) -> int:
        """Last block justified by this set = its epoch-end block; 0 if the
        era is still open (input/mod.rs:417-451)."""
        blk = (authority_set_id + 1) * self.epoch_length
        return blk if blk <= self.num_blocks else 0

    def _signer_era(self, block_number: int) -> int:
        return self.get_authority_set_id(block_number - 1)

    def get_justification(self, block_number: int, round_: int = 1,
                          max_authorities: int | None = None
                          ) -> JustificationData:
        """A simple justification for any block (the fixture chain's analogue
        of the Redis-indexed + epoch-end justifications,
        input/mod.rs:657-829)."""
        era = self._signer_era(block_number)
        secrets = self._era_secrets(era)
        pubkeys = list(self.era_pubkeys(era))
        n = len(pubkeys)
        msg = scale.encode_precommit(self._hashes[block_number], block_number,
                                     round_, era)
        num_signers = max(int(n * self.sign_fraction), (2 * n) // 3 + 1)
        signed = [i < num_signers for i in range(n)]
        sigs = [ed25519.sign(secrets[i], msg) if signed[i] else DUMMY_SIGNATURE
                for i in range(n)]
        if max_authorities is not None:
            assert n <= max_authorities
            pad = max_authorities - n
            pubkeys += [DUMMY_PUBLIC_KEY] * pad
            sigs += [DUMMY_SIGNATURE] * pad
            signed += [False] * pad
        return JustificationData(
            authority_set_id=era,
            signed_message=msg,
            validator_signed=signed,
            pubkeys=pubkeys,
            signatures=sigs,
            num_authorities=n,
            block_number=block_number,
            block_hash=self._hashes[block_number],
        )

    def get_header_rotate(self, epoch_end_block: int,
                          max_authorities: int | None = None,
                          max_header_size: int | None = None
                          ) -> HeaderRotateData:
        """Rotate witness for an epoch-end block (input/mod.rs:835-968)."""
        assert epoch_end_block % self.epoch_length == 0 and epoch_end_block > 0
        hdr = self._headers[epoch_end_block]
        enc = self._encoded[epoch_end_block]
        new_era = epoch_end_block // self.epoch_length
        new_pubkeys = self.era_pubkeys(new_era)
        n = len(new_pubkeys)
        pos = hdr.consensus_log_position()
        assert pos is not None, "epoch-end header missing consensus log"
        value_len = 1 + len(scale.compact_encode(n)) + 40 * n + 4
        prefix_length = (6 + len(scale.compact_encode(value_len)) + 1
                         + len(scale.compact_encode(n)))
        end_position = pos + prefix_length + 40 * n + 4
        padded = list(new_pubkeys)
        if max_authorities is not None:
            padded += [DUMMY_PUBLIC_KEY] * (max_authorities - n)
        header_bytes = enc
        if max_header_size is not None:
            assert len(enc) <= max_header_size
            header_bytes = enc + b"\x00" * (max_header_size - len(enc))
        return HeaderRotateData(
            header_bytes=header_bytes,
            header_size=len(enc),
            num_authorities=n,
            start_position=pos,
            end_position=end_position,
            new_authority_set_hash=chained_hash(new_pubkeys),
            padded_pubkeys=padded,
        )

    def get_merkle_root_commitments(self, tree_size: int, start_block: int,
                                    end_block: int) -> tuple[bytes, bytes]:
        """(state_root_commitment, data_root_commitment) over
        [start_block+1, end_block], zero-leaf padded to tree_size — bit-exact
        with input/mod.rs:493-528."""
        assert tree_size & (tree_size - 1) == 0
        assert end_block - start_block <= tree_size, "Range too large!"
        state_leaves, data_leaves = [], []
        for b in range(start_block + 1, end_block + 1):
            state_leaves.append(self._headers[b].state_root)
            data_leaves.append(self._headers[b].data_root)
        pad = tree_size - len(state_leaves)
        state_leaves += [b"\x00" * 32] * pad
        data_leaves += [b"\x00" * 32] * pad
        return (sha256_merkle_root(state_leaves),
                sha256_merkle_root(data_leaves))

    def find_justifications_in_range(self, start: int, end: int) -> list[int]:
        """Every block in range has a fixture justification; mirrors the
        union of Redis blocks and epoch ends (input/mod.rs:364-412)."""
        return list(range(start, min(end, self.num_blocks) + 1))
