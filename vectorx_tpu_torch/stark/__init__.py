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
    # lazy AIR export, as the reference package's
    if name == "FpMulAir":
        from vectorx_tpu_torch.stark.ed25519_air import FpMulAir
        return FpMulAir
    raise AttributeError(name)
