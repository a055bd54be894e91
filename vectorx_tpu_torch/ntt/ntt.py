"""Radix-2 NTT / iNTT / coset-LDE over Goldilocks, batched along leading axes.

Port of `vectorx_tpu.ntt.ntt`.  Conventions are the reference's:

* `ntt` maps coefficients -> evaluations over the two-adic subgroup of size
  n in natural order (w^0, w^1, ..); `intt` is its inverse;
* `coset_ntt`/`coset_intt` work on the coset shift·K; `lde` evaluates on
  g·K with |K| = n << rate_bits, g = GENERATOR = 7.

Dispatch (`_transform`): a CUDA tensor goes to the hand-written kernel
(`vectorx_tpu_torch.ntt.cuda_ntt.transform`), a CPU tensor to the plain
stage-by-stage torch transform below.  There is no size floor and no
fallback: a CUDA tensor the kernel refuses raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl

P = gl.P

_DEV_TABLES: dict = {}


def _root_of_unity(log_n: int, inverse: bool) -> int:
    assert log_n <= gl.TWO_ADICITY
    w = pow(gl.POWER_OF_TWO_GENERATOR, 1 << (gl.TWO_ADICITY - log_n), P)
    if inverse:
        w = pow(w, P - 2, P)
    return w


@functools.lru_cache(maxsize=None)
def power_table(base: int, count: int) -> np.ndarray:
    """[base^0, .., base^(count-1)] as a read-only canonical uint64 numpy
    array, built on the host by exact doubling: P_{2k} = P_k ++ base^k·P_k
    (log2(count) vectorized field multiplies on CPU tensors)."""
    out = torch.ones(min(count, 1), dtype=torch.int64)
    cur = base % P
    while out.numel() < count:
        out = torch.cat([out, gl.mul(out, cur)])
        cur = (cur * cur) % P
    arr = gl.to_u64(out[:count]).copy()
    arr.flags.writeable = False
    return arr


def device_table(key: tuple, build, device) -> torch.Tensor:
    """A host-built uint64 table, cached on `device` under `key`."""
    dev = torch.device(device)
    k = (key, str(dev))
    t = _DEV_TABLES.get(k)
    if t is None:
        t = _DEV_TABLES[k] = gl.from_u64(build(), dev)
    return t


def device_powers(base: int, count: int, device) -> torch.Tensor:
    """`power_table(base, count)` cached on `device`."""
    return device_table(("pow", base % P, count),
                        lambda: power_table(base % P, count), device)


def twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """[w^0 .. w^(n/2 - 1)] for the size-n transform, on `device`."""
    return device_powers(_root_of_unity(log_n, inverse),
                         max((1 << log_n) // 2, 1), device)


@functools.lru_cache(maxsize=None)
def bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _transform_torch(x: torch.Tensor, log_n: int,
                     inverse: bool) -> torch.Tensor:
    """Plain stage-by-stage transform — the port of `_transform_xla`:
    bit-reversal gather, then log2(n) radix-2 DIT butterfly stages."""
    n = 1 << log_n
    assert x.shape[-1] == n
    dev = x.device
    perm = device_table(("bitrev", log_n),
                        lambda: bit_reverse_perm(log_n).view(np.uint64), dev)
    x = x.index_select(-1, perm)
    tw = twiddles(log_n, inverse, dev)
    batch = x.shape[:-1]
    for s in range(log_n):
        m = 1 << s
        w = tw[::n // (2 * m)][:m]
        xs = x.reshape(*batch, n // (2 * m), 2, m)
        e, o = xs[..., 0, :], xs[..., 1, :]
        t = gl.mul(o, w)
        x = torch.stack([gl.add(e, t), gl.sub(e, t)], dim=-2).reshape(
            *batch, n)
    if inverse:
        x = gl.mul(x, pow(n, P - 2, P))
    return x


def _transform(x: torch.Tensor, log_n: int, inverse: bool,
               shift: int | None = None) -> torch.Tensor:
    """Dispatching transform: the CUDA kernel for a CUDA tensor, the plain
    torch version for a CPU tensor.  `shift` turns the forward transform
    into `coset_ntt` and the inverse into `coset_intt`."""
    from vectorx_tpu_torch.ntt import cuda_ntt

    x = x.contiguous()
    if x.is_cuda:
        return cuda_ntt.transform(x, log_n, inverse, shift)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return cuda_ntt.transform_plain(x, log_n, inverse, shift)


def _log2(n: int) -> int:
    log_n = int(n).bit_length() - 1
    assert 1 << log_n == n, "length must be a power of two"
    return log_n


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the size-n subgroup (natural order)."""
    return _transform(x, _log2(x.shape[-1]), inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Evaluations (natural order) -> coefficients."""
    return _transform(x, _log2(x.shape[-1]), inverse=True)


def coset_ntt(x: torch.Tensor, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Coefficients -> evaluations over the coset shift·K, |K| = n."""
    return _transform(x, _log2(x.shape[-1]), False, shift)


def coset_intt(x: torch.Tensor, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Evaluations over shift·K -> coefficients."""
    return _transform(x, _log2(x.shape[-1]), True, shift)


def lde(values: torch.Tensor, rate_bits: int = 3,
        shift: int = gl.GENERATOR) -> torch.Tensor:
    """Evaluations on H (|H| = n, natural order) -> evaluations on the coset
    shift·K with |K| = n · 2^rate_bits."""
    c = intt(values)
    n = values.shape[-1]
    c = torch.nn.functional.pad(c, (0, (n << rate_bits) - n))
    return coset_ntt(c, shift)
