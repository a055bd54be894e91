"""PyTorch/CUDA port of `vectorx_tpu`, held bit for bit against it.

Imports torch and numpy only — never JAX and never the `vectorx_tpu`
package.  Every public function takes an explicit ``device`` or works on the
device of the tensors it is given; on a CUDA tensor the NTT runs the
hand-written kernel (`vectorx_tpu_torch.ntt.cuda_ntt`), on a CPU tensor its
plain torch version.
"""
