"""Traffic kind `grandpa_justification`: the gateway's check of a GRANDPA
simple justification before it commits a header_range,
`circuits.justification.verify_simple_justification` with the batched
signature check on the card (succinctlabs/vectorx
`verify_simple_justification`, circuits/builder/justification.rs:195-257).

Statement i is the fixture chain's justification of its own block by an
authority set of `max_authority_set_size` keys, every one of which signed;
the chain's keys are drawn from the run seed.  Statement i with
i % forged_every == forged_slot has one signature, drawn from the seed,
with S replaced by (S + 1) mod L, and must be rejected.  The justification
and its forgery are made with the statement (`inputs`); the verify span
holds the whole check: the chained SHA-256 commitment, the precommit, the
batched ed25519 verification (its randomizers from a generator seeded
from the run seed and i) and the threshold.  A statement fails when the
verdict differs from the expected one.
"""

from __future__ import annotations

import importlib
import random

from prover_bench.seeds import derive


class Statements:
    checks = {"verdict_diff": 0}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.seed = seed
        self.device = device
        self.blocks = traffic["blocks"]
        self.forged_every = traffic["forged_every"]
        self.forged_slot = traffic["forged_slot"]
        self.n = config["max_authority_set_size"]
        fixtures = importlib.import_module("vectorx_tpu_torch.io.fixtures")
        self._just = importlib.import_module(
            "vectorx_tpu_torch.circuits.justification")
        self._L = importlib.import_module(
            "vectorx_tpu_torch.curves.ed25519").L
        # one authority set (era 0) signs every block of the chain
        self.chain = fixtures.FixtureChain(
            seed=derive(seed, "chain") % (1 << 32), num_blocks=self.blocks,
            epoch_length=self.blocks + 1,
            authorities_per_era=lambda era: self.n, sign_fraction=1.0)

    def inputs(self, i: int) -> dict:
        block = 1 + i % self.blocks
        j = self.chain.get_justification(block)
        forged = i % self.forged_every == self.forged_slot
        if forged:
            k = derive(self.seed, "forged", i) % self.n
            sig = j.signatures[k]
            s = (int.from_bytes(sig[32:], "little") + 1) % self._L
            j.signatures[k] = sig[:32] + s.to_bytes(32, "little")
        return {"justification": j, "expected": not forged,
                "set_hash": self.chain.compute_authority_set_hash(block - 1),
                "randomizers": derive(self.seed, "randomizers", i)}

    def prove(self, inp: dict, rec) -> dict:
        return {}

    def verify(self, inp: dict, out: dict) -> bool:
        j = inp["justification"]
        try:
            self._just.verify_simple_justification(
                j, j.block_number, j.block_hash, j.authority_set_id,
                inp["set_hash"], signature_backend="device",
                device=self.device, rng=random.Random(inp["randomizers"]))
            out["verdict"] = True
        except self._just.JustificationError:
            out["verdict"] = False
        return out["verdict"] == inp["expected"]

    def keep(self, out: dict) -> dict:
        return {"verdict": out["verdict"]}

    def reference(self, inp: dict) -> dict:
        from prover_bench.reference import justification

        j = inp["justification"]
        return {"verdict": justification.justification_verdict(
            j.pubkeys, j.signatures, j.validator_signed, j.num_authorities,
            j.signed_message, j.block_number, j.block_hash,
            j.authority_set_id, inp["set_hash"])}

    def compare(self, kept: dict, ref: dict) -> dict:
        return {"verdict_diff": int(kept["verdict"] != ref["verdict"])}
