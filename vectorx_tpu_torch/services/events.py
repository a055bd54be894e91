"""Commitment-events indexer (C16).

Mirrors `bin/events.rs`: per deployment, read the stored cursor (or start
from the contract's genesis), scan `HeaderRangeCommitmentStored` events in
bounded batches (<= 50,000 blocks, events.rs:86-98), store each range's
data commitment as a packed (start, end, commitment) tuple, and advance the
cursor (:99-124, 158-185).

The Ethereum log source is abstracted: the in-process `VectorXContract`
model exposes its event list directly; a real deployment would back this
with an eth JSON-RPC `eth_getLogs` client.

Port of `vectorx_tpu.services.events` (host code).
"""

from __future__ import annotations

import logging

from vectorx_tpu_torch.io.store import JustificationStore
from vectorx_tpu_torch.services.contract import VectorXContract

log = logging.getLogger("vectorx.events")

BLOCK_BATCH = 50_000  # events.rs:86


class EventsIndexer:
    def __init__(self, contract: VectorXContract, store: JustificationStore,
                 eth_chain_id: int = 11155111):
        self.contract = contract
        self.store = store
        self.eth_chain_id = eth_chain_id

    def run_once(self) -> int:
        """Scan new HeaderRangeCommitmentStored events past the cursor.
        The cursor tracks an index into the contract's event log (the model's
        analogue of an Ethereum block height)."""
        addr = self.contract.address
        cursor = self.store.get_contract_cursor(self.eth_chain_id, addr) or 0
        events = self.contract.events
        end = min(len(events), cursor + BLOCK_BATCH)
        stored = 0
        for i in range(cursor, end):
            ev = events[i]
            if ev.name != "HeaderRangeCommitmentStored":
                continue
            self.store.add_data_commitment_range(
                self.eth_chain_id, addr,
                ev.args["startBlock"], ev.args["endBlock"],
                ev.args["dataCommitment"])
            stored += 1
            log.info("stored commitment range %d-%d",
                     ev.args["startBlock"], ev.args["endBlock"])
        self.store.set_contract_cursor(self.eth_chain_id, addr, end)
        return stored
