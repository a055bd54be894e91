"""In-process model of the VectorX light-client contract (C19/C20) and the
SuccinctGateway request/fulfill pattern.

Mirrors upstream contracts/src/VectorX.sol storage and semantics —
`latestBlock`, `latestAuthoritySetId`, `blockHeightToHeaderHash`,
`authoritySetIdToHash`, data/state commitments keyed
keccak256(abi.encode(start, end)) (VectorX.sol:20-51, :273), the
request/commit two-phase flow (:171-289), rotate (:294-371), and guardian
ops (:87-164).  Events mirror IVectorX.sol:11-41.

The Solidity source for on-chain deployment lives in `contracts/`; this
model is the execution backend for hermetic operator / indexer / e2e tests
(the reference has no such harness).

Port of `vectorx_tpu.services.contract` (host code) over the port's own
`io.keccak` and `io.abi`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vectorx_tpu_torch.io.abi import (HeaderRangeInput, HeaderRangeOutput,
                                      RotateInput, RotateOutput)
from vectorx_tpu_torch.io.keccak import keccak256


class ContractError(Exception):
    pass


def _abi_encode_u32_pair(a: int, b: int) -> bytes:
    """abi.encode(uint32, uint32): two left-padded 32-byte words."""
    return a.to_bytes(32, "big") + b.to_bytes(32, "big")


def range_key(start: int, end: int) -> bytes:
    return keccak256(_abi_encode_u32_pair(start, end))


@dataclass
class Event:
    name: str
    args: dict


@dataclass
class MockGateway:
    """ISuccinctGateway stand-in: `request_call` queues requests;
    `fulfill` runs the registered prover for the function id and invokes the
    callback with the verified output (the requestCall/verifiedCall flow at
    VectorX.sol:202-208, :259-262).

    When a prover is registered WITH a verifier, the prover must return
    `(output_bytes, proof)` and the gateway checks the proof against the
    request input and claimed output BEFORE running the callback — the
    trust boundary the reference's gateway enforces (the wrapped-proof
    verification inside `verifiedCall`).  A failed proof aborts the
    fulfillment; no state-changing callback runs."""

    provers: dict = field(default_factory=dict)  # fid -> (prover, verifier|None)
    pending: list = field(default_factory=list)

    def register_prover(self, function_id: bytes, prover,
                        verifier=None) -> None:
        self.provers[function_id] = (prover, verifier)

    def request_call(self, function_id: bytes, input_bytes: bytes,
                     callback) -> None:
        self.pending.append((function_id, input_bytes, callback))

    def fulfill_next(self) -> None:
        function_id, input_bytes, callback = self.pending.pop(0)
        prover, verifier = self.provers[function_id]
        result = prover(input_bytes)
        if verifier is not None:
            output, proof = result
            if not verifier(input_bytes, output, proof):
                raise ContractError("GatewayProofRejected")
        else:
            output = result
        self._verified = (function_id, input_bytes, output)
        try:
            callback()
        finally:
            self._verified = None

    def verified_call(self, function_id: bytes, input_bytes: bytes) -> bytes:
        """Only valid during a fulfill callback with matching args."""
        if not getattr(self, "_verified", None):
            raise ContractError("no verified call in flight")
        fid, inp, out = self._verified
        if fid != function_id or inp != input_bytes:
            raise ContractError("verified call input mismatch")
        return out


class VectorXContract:
    def __init__(self, gateway: MockGateway, genesis_height: int,
                 genesis_header: bytes, genesis_authority_set_id: int,
                 genesis_authority_set_hash: bytes,
                 header_range_function_id: bytes = b"\x01" * 32,
                 rotate_function_id: bytes = b"\x02" * 32,
                 header_range_commitment_tree_size: int = 256,
                 address: str = "0xvectorx"):
        self.gateway = gateway
        self.address = address
        self.frozen = False
        self.latest_block = genesis_height
        self.latest_authority_set_id = genesis_authority_set_id
        self.header_range_function_id = header_range_function_id
        self.rotate_function_id = rotate_function_id
        self.header_range_commitment_tree_size = header_range_commitment_tree_size
        self.block_height_to_header_hash: dict[int, bytes] = {
            genesis_height: genesis_header}
        self.authority_set_id_to_hash: dict[int, bytes] = {
            genesis_authority_set_id: genesis_authority_set_hash}
        self.data_root_commitments: dict[bytes, bytes] = {}
        self.state_root_commitments: dict[bytes, bytes] = {}
        self.range_start_blocks: dict[bytes, int] = {}
        self.events: list[Event] = []

    # ---- request/commit header range (VectorX.sol:171-289) ----------------

    def request_header_range(self, authority_set_id: int,
                             requested_block: int) -> None:
        trusted_header = self.block_height_to_header_hash.get(
            self.latest_block)
        if not trusted_header:
            raise ContractError("TrustedHeaderNotFound")
        authority_set_hash = self.authority_set_id_to_hash.get(
            authority_set_id)
        if not authority_set_hash:
            raise ContractError("AuthoritySetNotFound")
        if not requested_block > self.latest_block:
            raise ContractError("requested block must advance")
        input_bytes = HeaderRangeInput(
            self.latest_block, trusted_header, authority_set_id,
            authority_set_hash, requested_block).encode()
        self.gateway.request_call(
            self.header_range_function_id, input_bytes,
            lambda: self.commit_header_range(authority_set_id,
                                             requested_block))
        self.events.append(Event("HeaderRangeRequested", {
            "trustedBlock": self.latest_block,
            "trustedHeader": trusted_header,
            "authoritySetId": authority_set_id,
            "authoritySetHash": authority_set_hash,
            "targetBlock": requested_block}))

    def commit_header_range(self, authority_set_id: int,
                            target_block: int) -> None:
        if self.frozen:
            raise ContractError("ContractFrozen")
        trusted_header = self.block_height_to_header_hash.get(
            self.latest_block)
        if not trusted_header:
            raise ContractError("TrustedHeaderNotFound")
        authority_set_hash = self.authority_set_id_to_hash.get(
            authority_set_id)
        if not authority_set_hash:
            raise ContractError("AuthoritySetNotFound")
        if authority_set_id < self.latest_authority_set_id:
            raise ContractError("OldAuthoritySetId")
        if authority_set_id > self.latest_authority_set_id:
            self.latest_authority_set_id = authority_set_id
        if not target_block > self.latest_block:
            raise ContractError("target block must advance")

        input_bytes = HeaderRangeInput(
            self.latest_block, trusted_header, authority_set_id,
            authority_set_hash, target_block).encode()
        output = self.gateway.verified_call(self.header_range_function_id,
                                            input_bytes)
        out = HeaderRangeOutput.decode(output)

        self.block_height_to_header_hash[target_block] = \
            out.target_header_hash
        key = range_key(self.latest_block, target_block)
        self.data_root_commitments[key] = out.data_root_commitment
        self.state_root_commitments[key] = out.state_root_commitment
        self.range_start_blocks[key] = self.latest_block

        self.events.append(Event("HeadUpdate", {
            "blockNumber": target_block,
            "headerHash": out.target_header_hash}))
        self.events.append(Event("HeaderRangeCommitmentStored", {
            "startBlock": self.latest_block, "endBlock": target_block,
            "dataCommitment": out.data_root_commitment,
            "stateCommitment": out.state_root_commitment,
            "headerRangeCommitmentTreeSize":
                self.header_range_commitment_tree_size}))
        self.latest_block = target_block

    # ---- request/commit rotate (VectorX.sol:294-371) ----------------------

    def request_rotate(self, current_authority_set_id: int) -> None:
        current_hash = self.authority_set_id_to_hash.get(
            current_authority_set_id)
        if not current_hash:
            raise ContractError("AuthoritySetNotFound")
        if self.authority_set_id_to_hash.get(current_authority_set_id + 1):
            raise ContractError("NextAuthoritySetExists")
        input_bytes = RotateInput(current_authority_set_id,
                                  current_hash).encode()
        self.gateway.request_call(
            self.rotate_function_id, input_bytes,
            lambda: self.rotate(current_authority_set_id))
        self.events.append(Event("RotateRequested", {
            "currentAuthoritySetId": current_authority_set_id,
            "currentAuthoritySetHash": current_hash}))

    def rotate(self, current_authority_set_id: int) -> None:
        if self.frozen:
            raise ContractError("ContractFrozen")
        current_hash = self.authority_set_id_to_hash.get(
            current_authority_set_id)
        if not current_hash:
            raise ContractError("AuthoritySetNotFound")
        if self.authority_set_id_to_hash.get(current_authority_set_id + 1):
            raise ContractError("NextAuthoritySetExists")
        input_bytes = RotateInput(current_authority_set_id,
                                  current_hash).encode()
        output = self.gateway.verified_call(self.rotate_function_id,
                                            input_bytes)
        new_hash = RotateOutput.decode(output).new_authority_set_hash
        self.authority_set_id_to_hash[current_authority_set_id + 1] = new_hash
        self.events.append(Event("AuthoritySetStored", {
            "authoritySetId": current_authority_set_id + 1,
            "authoritySetHash": new_hash}))

    # ---- guardian ops (VectorX.sol:87-164) --------------------------------

    def update_freeze(self, frozen: bool) -> None:
        self.frozen = frozen

    def update_gateway(self, gateway: MockGateway) -> None:
        self.gateway = gateway

    def update_function_ids(self, header_range_fid: bytes,
                            rotate_fid: bytes) -> None:
        self.header_range_function_id = header_range_fid
        self.rotate_function_id = rotate_fid

    def update_genesis_state(self, height: int, header: bytes,
                             authority_set_id: int,
                             authority_set_hash: bytes) -> None:
        self.latest_block = height
        self.block_height_to_header_hash[height] = header
        self.latest_authority_set_id = authority_set_id
        self.authority_set_id_to_hash[authority_set_id] = authority_set_hash

    def update_block_range_data(self, start_blocks: list[int],
                                end_blocks: list[int],
                                header_hashes: list[bytes],
                                data_commitments: list[bytes],
                                state_commitments: list[bytes],
                                end_authority_set_id: int,
                                end_authority_set_hash: bytes) -> None:
        """Guardian recovery path (VectorX.sol:122-164)."""
        assert (len(start_blocks) == len(end_blocks) == len(header_hashes)
                == len(data_commitments) == len(state_commitments))
        if start_blocks[0] != self.latest_block:
            raise ContractError("range must start at latestBlock")
        for i in range(len(start_blocks)):
            if i < len(start_blocks) - 1:
                if end_blocks[i] != start_blocks[i + 1]:
                    raise ContractError("ranges must be contiguous")
            key = range_key(start_blocks[i], end_blocks[i])
            self.data_root_commitments[key] = data_commitments[i]
            self.state_root_commitments[key] = state_commitments[i]
            self.range_start_blocks[key] = start_blocks[i]
            self.block_height_to_header_hash[end_blocks[i]] = header_hashes[i]
            self.events.append(Event("HeaderRangeCommitmentStored", {
                "startBlock": start_blocks[i], "endBlock": end_blocks[i],
                "dataCommitment": data_commitments[i],
                "stateCommitment": state_commitments[i],
                "headerRangeCommitmentTreeSize":
                    self.header_range_commitment_tree_size}))
        self.latest_block = end_blocks[-1]
        self.authority_set_id_to_hash[end_authority_set_id] = \
            end_authority_set_hash
        self.latest_authority_set_id = end_authority_set_id
