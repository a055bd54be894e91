"""SCALE codec (host) + Avail header encode/decode.

Host-side equivalent of the reference's `codec`/`avail-subxt` usage
(SURVEY.md §2 E6) and the structural layout its circuits assume:

* compact u32, 4 modes (decoder.rs:39-92; tested against the same boundary
  cases as upstream circuits/builder/decoder.rs:238-249);
* header layout: parent_hash[0..32], compact block number at 32, state_root
  immediately after (offset 33/34/36/37 by mode), extrinsics_root, digest
  (compact count + items), extension ending with data_root as the LAST 32
  bytes (decoder.rs:104-157, consts.rs DATA_ROOT_OFFSET_FROM_END);
* GRANDPA precommit: 53 bytes = 0x01 || block_hash(32) || number(u32 LE) ||
  round(u64 LE) || set_id(u64 LE) (decoder.rs:159-200, input/mod.rs:262-290);
* epoch-end consensus log: DigestItem::Consensus = 0x04 || b"FRNK" ||
  compact(len) || [0x01 || compact(n) || (pubkey(32)‖weight(8=1 LE))*n ||
  delay(4=0)] (builder/rotate.rs:74-136, input/mod.rs:876-957).
"""

from __future__ import annotations

from dataclasses import dataclass, field

CONSENSUS_ENGINE_ID = b"FRNK"
ENCODED_PRECOMMIT_LENGTH = 53


# ---------------------------------------------------------------------------
# compact<u32>
# ---------------------------------------------------------------------------

def compact_encode(v: int) -> bytes:
    assert 0 <= v < (1 << 32)
    if v < (1 << 6):
        return bytes([v << 2])
    if v < (1 << 14):
        return int.to_bytes((v << 2) | 0b01, 2, "little")
    if v < (1 << 30):
        return int.to_bytes((v << 2) | 0b10, 4, "little")
    return bytes([0b11]) + int.to_bytes(v, 4, "little")


def compact_decode(data: bytes) -> tuple[int, int, int]:
    """-> (value, mode, bytes_consumed)."""
    mode = data[0] & 0b11
    if mode == 0:
        return data[0] >> 2, 0, 1
    if mode == 1:
        return int.from_bytes(data[:2], "little") >> 2, 1, 2
    if mode == 2:
        return int.from_bytes(data[:4], "little") >> 2, 2, 4
    n_extra = (data[0] >> 2) + 4
    assert n_extra == 4, "compact value exceeds u32"
    return int.from_bytes(data[1:5], "little"), 3, 5


def compact_byte_length(mode: int) -> int:
    return (1, 2, 4, 5)[mode]


# ---------------------------------------------------------------------------
# precommit
# ---------------------------------------------------------------------------

def encode_precommit(block_hash: bytes, block_number: int, round_: int,
                     set_id: int) -> bytes:
    assert len(block_hash) == 32
    out = (bytes([1]) + block_hash
           + int.to_bytes(block_number, 4, "little")
           + int.to_bytes(round_, 8, "little")
           + int.to_bytes(set_id, 8, "little"))
    assert len(out) == ENCODED_PRECOMMIT_LENGTH
    return out


def decode_precommit(data: bytes) -> tuple[bytes, int, int, int]:
    """-> (block_hash, block_number, round, authority_set_id).
    Mirrors input/mod.rs:262-290."""
    assert data[0] == 1, "not a precommit"
    return (
        data[1:33],
        int.from_bytes(data[33:37], "little"),
        int.from_bytes(data[37:45], "little"),
        int.from_bytes(data[45:53], "little"),
    )


# ---------------------------------------------------------------------------
# digest logs / headers
# ---------------------------------------------------------------------------

def encode_scheduled_change_log(pubkeys: list[bytes]) -> bytes:
    """DigestItem::Consensus(FRNK, ScheduledChange{authorities, delay=0})."""
    value = bytes([1]) + compact_encode(len(pubkeys))
    for pk in pubkeys:
        assert len(pk) == 32
        value += pk + int.to_bytes(1, 8, "little")  # weight = 1
    value += b"\x00" * 4  # delay = 0
    return bytes([4]) + CONSENSUS_ENGINE_ID + compact_encode(len(value)) + value


def encode_other_log(payload: bytes) -> bytes:
    """DigestItem::Other(Vec<u8>) — filler digest entry (variant 0)."""
    return bytes([0]) + compact_encode(len(payload)) + payload


@dataclass
class Header:
    """Structural Avail header (the fields the circuits consume)."""

    parent_hash: bytes
    block_number: int
    state_root: bytes
    extrinsics_root: bytes
    digest_logs: list = field(default_factory=list)  # encoded log bytes
    extension_filler: bytes = b""
    data_root: bytes = b"\x00" * 32

    def encode(self) -> bytes:
        out = bytearray()
        out += self.parent_hash
        out += compact_encode(self.block_number)
        out += self.state_root
        out += self.extrinsics_root
        out += compact_encode(len(self.digest_logs))
        for log in self.digest_logs:
            out += log
        out += self.extension_filler
        out += self.data_root
        return bytes(out)

    @property
    def digest_offset(self) -> int:
        return (32 + len(compact_encode(self.block_number)) + 32 + 32)

    def consensus_log_position(self) -> int | None:
        """start_position for the rotate witness: one byte before the FRNK
        consensus log (input/mod.rs:876-929 computes digest_offset + sum of
        preceding log lengths, which lands on the byte before the log since
        the compact digest count occupies 1 byte)."""
        pos = self.digest_offset
        for log in self.digest_logs:
            if log[0] == 4 and log[1:5] == CONSENSUS_ENGINE_ID:
                return pos
            pos += len(log)
        return None


def decode_header(data: bytes) -> Header:
    parent_hash = data[0:32]
    block_number, mode, consumed = compact_decode(data[32:37])
    off = 32 + consumed
    state_root = data[off:off + 32]
    off += 32
    extrinsics_root = data[off:off + 32]
    off += 32
    n_logs, _, c = compact_decode(data[off:off + 5])
    off += c
    logs = []
    for _ in range(n_logs):
        start = off
        variant = data[off]
        off += 1
        if variant == 4:
            off += 4  # engine id
            vlen, _, c = compact_decode(data[off:off + 5])
            off += c + vlen
        elif variant == 0:
            vlen, _, c = compact_decode(data[off:off + 5])
            off += c + vlen
        else:
            raise ValueError(f"unsupported digest variant {variant}")
        logs.append(data[start:off])
    return Header(
        parent_hash=parent_hash,
        block_number=block_number,
        state_root=state_root,
        extrinsics_root=extrinsics_root,
        digest_logs=logs,
        extension_filler=data[off:len(data) - 32],
        data_root=data[len(data) - 32:],
    )
