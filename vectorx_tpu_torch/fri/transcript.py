"""Fiat-Shamir transcript ("challenger") over the Poseidon duplex sponge.

Port of `vectorx_tpu.fri.transcript`.  Host-side (Python ints): the
transcript is a tiny sequential state threaded between the big batched
device computations, so bigint math beats tensor dispatches.  Semantics
mirror plonky2's `Challenger`: observed elements fill the rate lanes; a
duplex (overwrite + permute) runs whenever a challenge is requested with
pending inputs or an empty output buffer.  The state is kept canonical on
both the scalar and the bulk path.
"""

from __future__ import annotations

import numpy as np

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.hash import poseidon as pv
from vectorx_tpu_torch.hash import poseidon_py


class Challenger:
    def __init__(self):
        self.state = [0] * pv.WIDTH
        self.input_buf: list[int] = []
        self.output_buf: list[int] = []

    def copy(self) -> "Challenger":
        c = Challenger()
        c.state = list(self.state)
        c.input_buf = list(self.input_buf)
        c.output_buf = list(self.output_buf)
        return c

    def observe(self, element: int) -> None:
        self.output_buf = []
        self.input_buf.append(element % P)
        if len(self.input_buf) == pv.RATE:
            self._duplex()

    # Below this many elements, scalar host permutes are the cheaper path.
    BULK_MIN = 512

    def observe_many(self, elements) -> None:
        elems = [int(e) for e in elements]
        if len(elems) < self.BULK_MIN:
            for e in elems:
                self.observe(e)
            return
        self._observe_bulk(elems)

    def _observe_bulk(self, elems: list[int]) -> None:
        """Protocol-identical to element-wise observe: fill the current
        partial rate buffer, run every full-rate duplex through
        `poseidon.absorb_blocks` on host tensors, keep the tail buffered."""
        head = (-len(self.input_buf)) % pv.RATE
        for e in elems[:head]:
            self.observe(e)
        rest = elems[head:]
        nfull = len(rest) // pv.RATE
        if nfull == 0:
            for e in rest:
                self.observe(e)
            return
        arr = np.array(rest[: nfull * pv.RATE], dtype=np.uint64)
        arr %= np.uint64(P)
        blocks = gl.from_u64(arr.reshape(nfull, pv.RATE), "cpu")
        st = gl.from_u64(np.array(self.state, dtype=np.uint64), "cpu")
        st = pv.absorb_blocks(st, blocks, nfull)
        self.state = [int(x) for x in gl.to_u64(st)]
        self.input_buf = []
        self.output_buf = list(self.state[: pv.RATE])
        tail = rest[nfull * pv.RATE:]
        for e in tail:
            self.observe(e)

    def observe_digest(self, digest: list[int]) -> None:
        self.observe_many(digest)

    def observe_cap(self, cap: list[list[int]]) -> None:
        for d in cap:
            self.observe_digest(d)

    def observe_bytes32(self, data: bytes) -> None:
        """Absorb 32 bytes as four u64 limbs (big-endian)."""
        assert len(data) == 32
        for i in range(0, 32, 8):
            self.observe(int.from_bytes(data[i:i + 8], "big") % P)

    def _duplex(self) -> None:
        for i, x in enumerate(self.input_buf):
            self.state[i] = x
        self.input_buf = []
        self.state = poseidon_py.permute(self.state)
        self.output_buf = list(self.state[: pv.RATE])

    def get_challenge(self) -> int:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple[int, int]:
        return self.get_challenge(), self.get_challenge()
