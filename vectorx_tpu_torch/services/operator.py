"""Operator loop (C14) — decides and submits rotate / header_range requests.

Mirrors `VectorXOperator` (upstream bin/vectorx.rs):
* rotate when the chain's authority set has moved past the contract's and
  the next set hash isn't stored yet (vectorx.rs:173-210);
* header_range stepping to the last justified block of the current set when
  in range, else to the highest `ideal_block_interval` multiple within the
  commitment tree size, probing justification availability upward
  (vectorx.rs:213-282, find_block_to_step_to :390-459);
* `is_dummy_operator` skips the justification probing (:430-432).

Instead of HTTPS to a closed proving platform (SuccinctClient,
vectorx.rs:122-130), requests go to the gateway, whose registered prover is
this repo's own circuit pipeline.

Port of `vectorx_tpu.services.operator` (host code); the proving runs in
the gateway's provers, on the device `make_gateway` was given.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from vectorx_tpu_torch.services.contract import VectorXContract

log = logging.getLogger("vectorx.operator")


@dataclass
class OperatorConfig:
    loop_delay_mins: int = 15        # LOOP_DELAY_MINS default (vectorx.rs:496)
    update_delay_blocks: int = 180   # UPDATE_DELAY_BLOCKS default (:510)
    is_dummy_operator: bool = False


class VectorXOperator:
    def __init__(self, contract: VectorXContract, fetcher,
                 config: OperatorConfig = OperatorConfig()):
        self.contract = contract
        self.fetcher = fetcher
        self.config = config

    # ---- rotate (vectorx.rs:173-210) --------------------------------------

    def find_and_request_rotate(self) -> bool:
        head = self.fetcher.get_head()
        head_authority_set_id = self.fetcher.get_authority_set_id(
            head.block_number - 1)
        current_authority_set_id = self.fetcher.get_authority_set_id(
            self.contract.latest_block - 1)
        next_exists = (current_authority_set_id + 1
                       in self.contract.authority_set_id_to_hash)
        if current_authority_set_id < head_authority_set_id and not next_exists:
            log.info("requesting rotate to set %d",
                     current_authority_set_id + 1)
            self.contract.request_rotate(current_authority_set_id)
            return True
        return False

    # ---- header range (vectorx.rs:213-282) --------------------------------

    def find_and_request_header_range(self) -> bool:
        latest = self.contract.latest_block
        current_authority_set_id = self.fetcher.get_authority_set_id(
            latest - 1)
        last_justified = self.fetcher.last_justified_block(
            current_authority_set_id)

        request_authority_set_id = current_authority_set_id
        if latest == last_justified:
            # stepping into the next epoch: need the next set in the contract
            if (current_authority_set_id + 1
                    not in self.contract.authority_set_id_to_hash):
                return False
            request_authority_set_id = current_authority_set_id + 1

        block_to_step_to = self.find_block_to_step_to(
            self.config.update_delay_blocks,
            self.contract.header_range_commitment_tree_size,
            latest,
            self.fetcher.get_head().block_number,
            request_authority_set_id)
        if block_to_step_to is None:
            return False
        log.info("requesting header range %d -> %d", latest, block_to_step_to)
        self.contract.request_header_range(request_authority_set_id,
                                           block_to_step_to)
        return True

    def find_block_to_step_to(self, ideal_block_interval: int,
                              tree_size: int, vectorx_current_block: int,
                              avail_current_block: int,
                              authority_set_id: int) -> int | None:
        """vectorx.rs:390-459."""
        last_justified = self.fetcher.last_justified_block(authority_set_id)
        if last_justified != 0 and \
                last_justified <= vectorx_current_block + tree_size:
            return last_justified

        max_valid = min(vectorx_current_block + tree_size,
                        avail_current_block)
        block = max_valid - (max_valid % ideal_block_interval)
        if block <= vectorx_current_block:
            return None
        if self.config.is_dummy_operator:
            return block
        while True:
            if block > vectorx_current_block + tree_size:
                log.warning("no justification found up to tree size; "
                            "indexer may be behind")
                return None
            if self._has_justification(block):
                return block
            block += 1

    def _has_justification(self, block: int) -> bool:
        try:
            return self.fetcher.get_justification(block) is not None
        except Exception:
            return False

    # ---- health / observability -------------------------------------------

    def blocks_behind_head(self) -> int:
        """How far the contract's latestBlock lags the chain's finalized
        head — the external health signal the reference documents for its
        monitoring endpoint (upstream README.md:121-133)."""
        head = self.fetcher.get_head().block_number
        return max(0, head - self.contract.latest_block)

    # ---- loop (vectorx.rs:461-491) ----------------------------------------

    def run_once(self) -> dict:
        rotated = self.find_and_request_rotate()
        ranged = self.find_and_request_header_range()
        behind = self.blocks_behind_head()
        log.info("health: blocksBehindHead=%d latestBlock=%d",
                 behind, self.contract.latest_block)
        return {"rotate_requested": rotated, "header_range_requested": ranged,
                "blocks_behind_head": behind}

    def run(self, iterations: int | None = None, sleep_fn=None) -> None:
        import time

        done = 0
        while iterations is None or done < iterations:
            self.run_once()
            done += 1
            if iterations is not None and done >= iterations:
                break
            (sleep_fn or time.sleep)(60 * self.config.loop_delay_mins)
