"""Top-level header_range and rotate circuits (C8, C9).

Port of `vectorx_tpu.circuits.header_range`; equivalents of
`HeaderRangeCircuit::define`
(upstream circuits/header_range.rs:26-59) and
`RotateCircuit::define` (upstream circuits/rotate.rs:80-109):
packed-ABI input -> verified computation -> packed-ABI output.

Size presets mirror the reference entrypoints
(bin/header_range_256.rs:15, bin/header_range_512.rs:15, bin/rotate.rs:14):
MAX_AUTHORITY_SET_SIZE=300, MAX_HEADER_SIZE=35840, tree size 256/512.
"""

from __future__ import annotations

from vectorx_tpu_torch.circuits.justification import verify_simple_justification
from vectorx_tpu_torch.circuits.rotate import rotate as rotate_check
from vectorx_tpu_torch.circuits.subchain import verify_subchain
from vectorx_tpu_torch.io.abi import (HeaderRangeInput, HeaderRangeOutput,
                                RotateInput, RotateOutput)

MAX_AUTHORITY_SET_SIZE = 300   # consts.rs:52
MAX_HEADER_SIZE = 35840        # consts.rs:9-16


class HeaderRangeCircuit:
    """header_range.rs:13-59 — const-generic sizes become ctor args."""

    def __init__(self, max_authority_set_size: int = MAX_AUTHORITY_SET_SIZE,
                 max_header_size: int = MAX_HEADER_SIZE,
                 max_num_headers: int = 256):
        self.max_authority_set_size = max_authority_set_size
        self.max_header_size = max_header_size
        self.max_num_headers = max_num_headers

    def run(self, input_bytes: bytes, fetcher, *, device) -> bytes:
        """evm_read 5 inputs, verify subchain + justification, evm_write 3
        outputs (header_range.rs:31-58).  The header hashes and commitment
        trees run on `device`."""
        inp = HeaderRangeInput.decode(input_bytes)

        subchain = verify_subchain(
            fetcher, inp.trusted_block, inp.trusted_header_hash,
            inp.target_block, self.max_num_headers, self.max_header_size,
            device=device)

        justification = fetcher.get_justification(
            inp.target_block, max_authorities=self.max_authority_set_size)
        verify_simple_justification(
            justification, inp.target_block, subchain.target_header_hash,
            inp.authority_set_id, inp.authority_set_hash)

        return HeaderRangeOutput(
            target_header_hash=subchain.target_header_hash,
            state_root_commitment=subchain.state_root_merkle_root,
            data_root_commitment=subchain.data_root_merkle_root,
        ).encode()


class RotateCircuit:
    """rotate.rs:67-109."""

    def __init__(self, max_authority_set_size: int = MAX_AUTHORITY_SET_SIZE,
                 max_header_size: int = MAX_HEADER_SIZE):
        self.max_authority_set_size = max_authority_set_size
        self.max_header_size = max_header_size

    def run(self, input_bytes: bytes, fetcher) -> bytes:
        inp = RotateInput.decode(input_bytes)

        # RotateHint (rotate.rs:27-65)
        epoch_end_block = fetcher.last_justified_block(inp.authority_set_id)
        if epoch_end_block == 0:
            raise ValueError("authority set still active; no epoch end block")
        rotate_data = fetcher.get_header_rotate(
            epoch_end_block, max_authorities=self.max_authority_set_size,
            max_header_size=self.max_header_size)
        justification = fetcher.get_justification(
            epoch_end_block, max_authorities=self.max_authority_set_size)

        new_hash = rotate_check(
            rotate_data, justification, inp.authority_set_id,
            inp.authority_set_hash, epoch_end_block,
            self.max_authority_set_size)

        return RotateOutput(new_authority_set_hash=new_hash).encode()
