"""The benchmark's plain reference of the statements it proves.

A frozen copy of the plain torch path of `vectorx_tpu_torch` as it stood
when the benchmark was written: Goldilocks and its quadratic extension, Poseidon
(torch and scalar), the stage-by-stage NTT (no CUDA kernel), Poseidon
Merkle trees, the transcript, the FRI prover, the one-device STARK prover
(no lookups, no bus, no streaming, no verification-key cache) and the
SHA-256 AIR.  It imports nothing of the program, so a later change to the
program is held against this copy, computed on the same device from the
same inputs.  `sha256_chunk_proof` and `fri_lde_proof` are the two
statements of the benchmark's cells.
"""

from __future__ import annotations


def sha256_chunk_proof(messages, fri_config: dict, device):
    """(trace (W, n) uint64, StarkProof) of `Sha256Air(messages)` under
    `bind="consts"`, proved at FriConfig(**fri_config) on `device`."""
    from .fri import FriConfig
    from .prover import StarkConfig, prove
    from .sha256_air import Sha256Air

    air = Sha256Air(messages)
    trace = air.build_trace()
    cfg = StarkConfig(fri=FriConfig(**fri_config))
    return trace, prove(air, trace, cfg, device=device)


def fri_lde_proof(coeffs, fri_config: dict):
    """(LDE (2, N) int64 on the coefficients' device, FriProof) of the
    extension polynomial whose (c0, c1) coefficient rows are `coeffs`
    (2, n): its coset LDE on 7·K, |K| = n << rate_bits, then
    `prove_low_degree` at FriConfig(**fri_config)."""
    from . import goldilocks as gl
    from .fri import FriConfig, prove_low_degree
    from .ntt import coset_lde
    from .transcript import Challenger

    cfg = FriConfig(**fri_config)
    lde = coset_lde(coeffs, cfg.rate_bits)
    log_len = (coeffs.shape[-1] << cfg.rate_bits).bit_length() - 1
    proof = prove_low_degree((lde[0], lde[1]), log_len, gl.GENERATOR, cfg,
                             Challenger())
    return lde, proof
