from vectorx_tpu_torch.stark.air import (Air, DeviceAlgebra, ExtAlgebra,
                                         FibonacciAir, Lookup)
from vectorx_tpu_torch.stark.prover import (StarkConfig, StarkProof,
                                            preprocess, prove)
from vectorx_tpu_torch.stark.range_air import RangeCheckAir
from vectorx_tpu_torch.stark.verifier import verify

__all__ = ["Air", "DeviceAlgebra", "ExtAlgebra", "FibonacciAir", "Lookup",
           "RangeCheckAir", "StarkConfig", "StarkProof", "preprocess",
           "prove", "verify"]
