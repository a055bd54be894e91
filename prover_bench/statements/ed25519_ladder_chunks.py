"""Traffic kind `ed25519_ladder_chunks`: the ed25519 ladder chunk proofs of
the in-ZK GRANDPA justification, one chunk a cycle.

A justification of `max_authority_set_size` authorities, `signers` of them
signed, checks each signature's equation [S]B = R + [h]A, h = SHA-512(R ‖
A ‖ M) mod L over the 53-byte precommit M, in chunks of as many
signatures as fit 2^max_ladder_log_n trace rows at
`ladder_rows_per_signature` rows each, as `circuits/zk_justification.py`
cuts them.  Statement i is full chunk i % C of justification i // C, C
full chunks a justification; justification r is the fixture chain's
justification of its own block, the chain's keys drawn from the run seed.
The (A, R, S, h) tuples are made with the statement (`inputs`), outside
the prove span, as `zk_justification._ladder_sigs` makes them.  The
program proves `Ed25519LadderAir(sigs)` (past the streaming bound, so
`prove` streams it) at the configuration's FriConfig and verifies it
against `Ed25519LadderAir.statement(sigs)`.
"""

from __future__ import annotations

import hashlib
import importlib

import numpy as np

from prover_bench import compare
from prover_bench.seeds import derive


class Statements:
    checks = {"trace_diff": 0, "proof_diff": 0}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.device = device
        self.nbits = config["nbits"]
        self.per_chunk = ((1 << config["max_ladder_log_n"])
                          // config["ladder_rows_per_signature"])
        self.chunks = config["signers"] // self.per_chunk
        self.blocks = traffic["blocks"]
        self._sigs = (None, None)
        fixtures = importlib.import_module("vectorx_tpu_torch.io.fixtures")
        self._zk = importlib.import_module(
            "vectorx_tpu_torch.circuits.zk_justification")
        self._air = importlib.import_module(
            "vectorx_tpu_torch.stark.ed25519_ladder_air")
        self._prover = importlib.import_module(
            "vectorx_tpu_torch.stark.prover")
        self._verifier = importlib.import_module(
            "vectorx_tpu_torch.stark.verifier")
        fri = importlib.import_module("vectorx_tpu_torch.fri.fri")
        self.stark_config = self._prover.StarkConfig(
            fri=fri.FriConfig(**config["fri"]))
        n = config["max_authority_set_size"]
        # one authority set (era 0) signs every block of the chain
        self.chain = fixtures.FixtureChain(
            seed=derive(seed, "chain") % (1 << 32), num_blocks=self.blocks,
            epoch_length=self.blocks + 1, authorities_per_era=lambda era: n,
            sign_fraction=config["signers"] / n)

    def justification_sigs(self, r: int) -> list:
        """The (A_cmp, R_cmp, S, h mod L) tuple of every signer of
        justification r, in the order the chunks take them."""
        if self._sigs[0] != r:
            zk = self._zk
            j = self.chain.get_justification(1 + r % self.blocks)
            enabled = zk._enabled_indices(j)
            assert len(enabled) == self.config["signers"]
            msgs = zk.challenge_messages(j.pubkeys, j.signatures,
                                         j.signed_message, enabled)
            digests = [hashlib.sha512(m).digest() for m in msgs]
            sigs = zk._ladder_sigs(j.pubkeys, j.signatures, j.signed_message,
                                   enabled, digests)
            self._sigs = (r, sigs)
        return self._sigs[1]

    def inputs(self, i: int) -> dict:
        r, k = divmod(i, self.chunks)
        s = k * self.per_chunk
        return {"sigs": self.justification_sigs(r)[s:s + self.per_chunk]}

    def prove(self, inp: dict, rec) -> dict:
        air = self._air.Ed25519LadderAir(inp["sigs"], nbits=self.nbits)
        trace = air.build_trace()
        proof = self._prover.prove(air, trace, self.stark_config,
                                   device=self.device)
        return {"trace": trace, "proof": proof}

    def verify(self, inp: dict, out: dict) -> bool:
        air = self._air.Ed25519LadderAir.statement(inp["sigs"],
                                                   nbits=self.nbits)
        return bool(self._verifier.verify(air, out["proof"],
                                          self.stark_config,
                                          device=self.device))

    def keep(self, out: dict) -> dict:
        return {"trace": np.asarray(out["trace"], dtype=np.uint64),
                "proof": out["proof"]}

    def reference(self, inp: dict, fri: dict | None = None) -> dict:
        from prover_bench.reference import justification

        trace, proof = justification.ladder_chunk_proof(
            inp["sigs"], self.nbits, fri or self.config["fri"], self.device)
        return {"trace": trace, "proof": proof}

    def compare(self, kept: dict, ref: dict) -> dict:
        return {"trace_diff": compare.array_diff(kept["trace"], ref["trace"]),
                "proof_diff": compare.proof_diff(kept["proof"], ref["proof"])}
