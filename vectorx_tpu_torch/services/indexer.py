"""Justification indexer (C15).

Mirrors `bin/indexer.rs`: for each finalized justification, re-verify the
header hash (blake2b of the encoded header, :43-50), rebuild the 53-byte
signed message (:63-68), ed25519-verify every precommit (:73-92), check the
>2/3 threshold (:103-111), align signatures to canonical authority order
with dummy-signature padding for non-signers (:114-127), and store to the
justification store (:129-142).

The reference subscribes to `grandpa_subscribeJustifications` over a
persistent WS; here `process_block` handles one justification and
`run_follow` polls the fetcher's head — the fixture chain serves
justifications for every block.

Port of `vectorx_tpu.services.indexer` (host code) over the port's own
`scale`, host ed25519 and Blake2b.
"""

from __future__ import annotations

import logging

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.curves import ed25519
from vectorx_tpu_torch.hash.blake2b import blake2b_256
from vectorx_tpu_torch.io.fixtures import DUMMY_SIGNATURE
from vectorx_tpu_torch.io.store import JustificationStore, StoredJustificationData

log = logging.getLogger("vectorx.indexer")


class IndexerError(ValueError):
    pass


class JustificationIndexer:
    def __init__(self, fetcher, store: JustificationStore,
                 chain_id: str = "fixture"):
        self.fetcher = fetcher
        self.store = store
        self.chain_id = chain_id
        self.last_processed = 0

    def process_block(self, block_number: int) -> StoredJustificationData:
        j = self.fetcher.get_justification(block_number)

        # 1. header re-hash check (indexer.rs:43-50)
        enc = self.fetcher.get_encoded_header(block_number)
        header_hash = blake2b_256(enc)
        msg_hash, msg_block, _round, set_id = scale.decode_precommit(
            j.signed_message)
        if header_hash != msg_hash or msg_block != block_number:
            raise IndexerError("justification does not match header")

        # 2. canonical authority order + per-signature verification
        authorities = self.fetcher.get_authorities(block_number - 1) \
            if block_number % self.fetcher.epoch_length == 0 else \
            self.fetcher.get_authorities(block_number)
        num_authorities = len(authorities)
        signed = []
        sigs = []
        provided = dict()
        for i, pk in enumerate(j.pubkeys[:j.num_authorities]):
            provided[pk] = (j.validator_signed[i], j.signatures[i])
        num_signed = 0
        for pk in authorities:
            did_sign, sig = provided.get(pk, (False, DUMMY_SIGNATURE))
            if did_sign:
                if not ed25519.verify(pk, j.signed_message, sig):
                    raise IndexerError("invalid signature in justification")
                num_signed += 1
                signed.append(True)
                sigs.append(sig)
            else:
                signed.append(False)
                sigs.append(DUMMY_SIGNATURE)

        # 3. threshold (indexer.rs:103-111)
        if not num_signed * 3 > num_authorities * 2:
            raise IndexerError("justification below 2/3 threshold")

        data = StoredJustificationData(
            block_number=block_number,
            signed_message=j.signed_message.hex(),
            pubkeys=[pk.hex() for pk in authorities],
            signatures=[s.hex() for s in sigs],
            validator_signed=signed,
            num_authorities=num_authorities,
            authority_set_id=set_id,
        )
        self.store.add_justification(self.chain_id, data)
        self.last_processed = max(self.last_processed, block_number)
        log.info("indexed justification for block %d", block_number)
        return data

    def run_follow(self, up_to: int | None = None) -> int:
        """Process every block from last_processed+1 to the chain head."""
        head = self.fetcher.get_head().block_number
        if up_to is not None:
            head = min(head, up_to)
        count = 0
        for b in range(self.last_processed + 1, head + 1):
            try:
                self.process_block(b)
                count += 1
            except IndexerError as e:
                log.warning("skipping block %d: %s", b, e)
        return count
