"""Dummy (non-ZK) programs (C13) — byte-for-byte reference semantics.

Equivalents of `DummyHeaderRange<TREE_SIZE>`
(upstream circuits/dummy_header_range.rs:6-53) and `DummyRotate`
(upstream circuits/dummy_rotate.rs:5-30): the rustx
`Program::run(Vec<u8>) -> Vec<u8>` contract — parse the packed request,
compute the same outputs natively, concatenate.

Against real Avail data these reproduce the golden vectors checked into the
reference (dummy_header_range.rs:66-74: blocks 246150→246330 tree 256;
dummy_rotate.rs:43-53: authority set 117) — the only golden I/O vectors in
the reference tree (SURVEY.md §4 item 4).
"""

from __future__ import annotations

from vectorx_tpu_torch.io.abi import HeaderRangeInput, RotateInput


class DummyHeaderRange:
    def __init__(self, header_range_commitment_tree_size: int = 256):
        self.tree_size = header_range_commitment_tree_size

    def run(self, input_bytes: bytes, fetcher) -> bytes:
        inp = HeaderRangeInput.decode(input_bytes)
        target_header_hash = fetcher.get_block_hash(inp.target_block)
        state_c, data_c = fetcher.get_merkle_root_commitments(
            self.tree_size, inp.trusted_block, inp.target_block)
        return target_header_hash + state_c + data_c


class DummyRotate:
    def run(self, input_bytes: bytes, fetcher) -> bytes:
        inp = RotateInput.decode(input_bytes)
        epoch_end_block = fetcher.last_justified_block(inp.authority_set_id)
        return fetcher.compute_authority_set_hash(epoch_end_block)
