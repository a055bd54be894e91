"""Traffic kind `fri_lde`: the low-degree proof of an extension polynomial
of degree below 2^machine_log_n over its rate-2^rate_bits coset LDE, the
fold-and-commit loop that every STARK proof of the program runs.

Statement i's polynomial has uniform coefficients below 2^63 in both of
its (c0, c1) rows, made on the card from a generator seeded from the run
seed and i.  The program evaluates it with `ntt.coset_lde` on the coset
7·K and proves it with `fri.prove_low_degree` at the configuration's
FriConfig; `fri.fri_verify` checks the proof.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from prover_bench import compare
from prover_bench.seeds import derive


class Statements:
    checks = {"lde_diff": 0, "proof_diff": 0}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        self.log_n = config["machine_log_n"]
        self._fri = importlib.import_module("vectorx_tpu_torch.fri.fri")
        self._ntt = importlib.import_module("vectorx_tpu_torch.ntt")
        self._transcript = importlib.import_module(
            "vectorx_tpu_torch.fri.transcript")
        self._gl = importlib.import_module(
            "vectorx_tpu_torch.field.goldilocks")
        self.fri_config = self._fri.FriConfig(**config["fri"])
        self.log_len = self.log_n + self.fri_config.rate_bits

    def inputs(self, i: int) -> dict:
        g = torch.Generator(device=self.device)
        g.manual_seed(derive(self.seed, "polynomial", i))
        n = 1 << self.log_n
        hi = torch.randint(0, 1 << 31, (2, n), generator=g,
                           device=self.device, dtype=torch.int64)
        lo = torch.randint(0, 1 << 32, (2, n), generator=g,
                           device=self.device, dtype=torch.int64)
        return {"coeffs": (hi << 32) | lo}

    def prove(self, inp: dict, rec) -> dict:
        lde = self._ntt.coset_lde(inp["coeffs"], self.fri_config.rate_bits)
        proof = self._fri.prove_low_degree(
            (lde[0], lde[1]), self.log_len, self._gl.GENERATOR,
            self.fri_config, self._transcript.Challenger())
        return {"lde": lde, "proof": proof}

    def verify(self, inp: dict, out: dict) -> bool:
        return bool(self._fri.fri_verify(
            out["proof"], self.log_len, self._gl.GENERATOR, self.fri_config,
            self._transcript.Challenger()))

    def keep(self, out: dict) -> dict:
        from prover_bench.reference import goldilocks

        lde = goldilocks.canonicalize(out["lde"]).cpu().numpy()
        return {"lde": lde.view(np.uint64), "proof": out["proof"]}

    def reference(self, inp: dict, fri: dict | None = None) -> dict:
        from prover_bench import reference

        lde, proof = reference.fri_lde_proof(inp["coeffs"],
                                             fri or self.config["fri"])
        return self.keep({"lde": lde, "proof": proof})

    def compare(self, kept: dict, ref: dict) -> dict:
        return {"lde_diff": compare.array_diff(kept["lde"], ref["lde"]),
                "proof_diff": compare.proof_diff(kept["proof"], ref["proof"])}
