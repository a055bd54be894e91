from vectorx_tpu_torch.hash import poseidon, poseidon_py

__all__ = ["poseidon", "poseidon_py"]
