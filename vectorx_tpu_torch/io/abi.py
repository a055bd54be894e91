"""EVM packed-ABI byte I/O (E2 semantics).

The circuits read their on-chain inputs and write outputs as
`abi.encodePacked` big-endian bytes (plonky2x `evm_read`/`evm_write`;
packing at upstream bin/vectorx.rs:24-26 and the dummy programs at
circuits/dummy_header_range.rs:12-21, dummy_rotate.rs:9-14):

* header_range input  = (u32 trusted_block, b32 trusted_header_hash,
                         u64 authority_set_id, b32 authority_set_hash,
                         u32 target_block)                       — 80 bytes
* header_range output = (b32 target_header_hash, b32 state_root_commitment,
                         b32 data_root_commitment)               — 96 bytes
* rotate input        = (u64 authority_set_id, b32 authority_set_hash)
                                                                 — 40 bytes
* rotate output       = (b32 new_authority_set_hash)             — 32 bytes
"""

from __future__ import annotations

from dataclasses import dataclass


def encode_packed(*fields) -> bytes:
    """Each field is (kind, value) with kind in {"u32", "u64", "b32"}."""
    out = bytearray()
    for kind, value in fields:
        if kind == "u32":
            out += int(value).to_bytes(4, "big")
        elif kind == "u64":
            out += int(value).to_bytes(8, "big")
        elif kind == "b32":
            assert len(value) == 32
            out += value
        else:
            raise ValueError(f"unknown kind {kind}")
    return bytes(out)


@dataclass
class HeaderRangeInput:
    trusted_block: int
    trusted_header_hash: bytes
    authority_set_id: int
    authority_set_hash: bytes
    target_block: int

    def encode(self) -> bytes:
        return encode_packed(
            ("u32", self.trusted_block), ("b32", self.trusted_header_hash),
            ("u64", self.authority_set_id), ("b32", self.authority_set_hash),
            ("u32", self.target_block))

    @classmethod
    def decode(cls, data: bytes) -> "HeaderRangeInput":
        assert len(data) == 80, f"expected 80 bytes, got {len(data)}"
        return cls(
            trusted_block=int.from_bytes(data[0:4], "big"),
            trusted_header_hash=data[4:36],
            authority_set_id=int.from_bytes(data[36:44], "big"),
            authority_set_hash=data[44:76],
            target_block=int.from_bytes(data[76:80], "big"),
        )


@dataclass
class HeaderRangeOutput:
    target_header_hash: bytes
    state_root_commitment: bytes
    data_root_commitment: bytes

    def encode(self) -> bytes:
        return (self.target_header_hash + self.state_root_commitment
                + self.data_root_commitment)

    @classmethod
    def decode(cls, data: bytes) -> "HeaderRangeOutput":
        assert len(data) == 96
        return cls(data[0:32], data[32:64], data[64:96])


@dataclass
class RotateInput:
    authority_set_id: int
    authority_set_hash: bytes

    def encode(self) -> bytes:
        return encode_packed(("u64", self.authority_set_id),
                             ("b32", self.authority_set_hash))

    @classmethod
    def decode(cls, data: bytes) -> "RotateInput":
        # Tolerate trailing bytes: the reference dummy program reads only
        # [0..8] and [8..40] (dummy_rotate.rs:13-14; its golden vector is
        # 44 bytes with a trailing u32).
        assert len(data) >= 40, f"expected >= 40 bytes, got {len(data)}"
        return cls(authority_set_id=int.from_bytes(data[0:8], "big"),
                   authority_set_hash=data[8:40])


@dataclass
class RotateOutput:
    new_authority_set_hash: bytes

    def encode(self) -> bytes:
        return self.new_authority_set_hash

    @classmethod
    def decode(cls, data: bytes) -> "RotateOutput":
        assert len(data) == 32
        return cls(new_authority_set_hash=data)
