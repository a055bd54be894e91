from vectorx_tpu_torch.stark.air import (Air, DeviceAlgebra, ExtAlgebra,
                                         FibonacciAir, Lookup)
from vectorx_tpu_torch.stark.prover import (StarkConfig, StarkProof,
                                            preprocess, prove)
from vectorx_tpu_torch.stark.range_air import RangeCheckAir
from vectorx_tpu_torch.stark.verifier import verify

__all__ = ["Air", "DeviceAlgebra", "ExtAlgebra", "FibonacciAir", "Lookup",
           "RangeCheckAir", "StarkConfig", "StarkProof", "preprocess",
           "prove", "verify"]


def __getattr__(name):
    # lazy AIR exports, as the reference package's
    if name == "PoseidonAir":
        from vectorx_tpu_torch.stark.poseidon_air import PoseidonAir
        return PoseidonAir
    if name == "Sha256Air":
        from vectorx_tpu_torch.stark.sha256_air import Sha256Air
        return Sha256Air
    if name == "Blake2bAir":
        from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
        return Blake2bAir
    if name == "FpMulAir":
        from vectorx_tpu_torch.stark.ed25519_air import FpMulAir
        return FpMulAir
    raise AttributeError(name)
