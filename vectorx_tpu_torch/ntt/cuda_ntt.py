"""The hand-written Goldilocks NTT kernels (`csrc/ntt.cu`) and, beside them,
their plain torch version and a torch emulation of their algorithm.

Replaces `vectorx_tpu.ntt.pallas_ntt` (`transform`, `transform_big`,
`transform_any`) and the zero padding of the reference's `ntt.lde`.
K1 `ntt_tile` transforms columns of length n <= 2^S_BITS, a tile of
adjacent columns per block: radix-8 butterflies in registers with swizzled
shared-memory exchanges between them, coalesced loads and stores for
strided columns and for contiguous rows alike, a coset power on load, and
on store either a coset power (with n^-1 folded in) or the four-step
twiddle w^(c·k).  K4 `ntt_tile_t` is K1 on contiguous rows whose store
goes transposed, to natural order, so the four-step for
2^S_BITS < n <= 2^MAX_LOG_N is two passes over device memory: K1 down the
columns (twiddled on store), K4 along the rows.  K3 `ntt_tile_lde` is the
coset LDE's first pass from the unpadded coefficients: it reads only the
n coefficients of each row (no padded tensor exists) and replaces the DIT
stages that see only padding by copies; then K4, or K3 alone up to
2^S_BITS points.  K2 `ntt_transpose`, the plain transpose that ended the
three-pass four-step, is on no plan now; it stays for the comparison with
that route.  The port's limits are K1's column length (2^S_BITS) and
MAX_LOG_N; the TPU kernel's size gates do not apply.  On the H100 every
tile kernel is held back by the integer instructions of its butterflies,
not by device-memory bytes: `csrc/ntt.cu` carries the note with the
numbers, `chip_smoke.py` phase 1 prints each step's bounds and share.

* `transform` / `coset_lde` — the kernel paths: CUDA int64 tensors only,
  raise on anything the kernels do not take.  Never fall back.
* `transform_plain` / `coset_lde_plain` — the plain torch versions of the
  same functions (the CPU path, and the oracle `chip_smoke.py` holds the
  kernels against).
* `ntt_tile` / `ntt_tile_t` / `ntt_tile_lde` / `transpose` — one launch of
  K1 / K4 / K3 / K2, each with its plain torch version beside it
  (`ntt_tile_plain`, `ntt_tile_t_plain`, `ntt_tile_lde_plain`,
  `transpose_plain`) and its count in `LAUNCHES`.
* `emulate` / `emulate_lde` — `transform` / `coset_lde` with each kernel
  replaced by its plain version (same split, same steps, same stage order,
  same tables), so the CPU tests hold the kernels' algorithm.

The shared library is built with nvcc at first use, from `csrc/` only, into
`_build/<source hash>/` beside this package (listed in `.gitignore`); delete
that directory to force a rebuild.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from vectorx_tpu_torch import tracing
from vectorx_tpu_torch.field import goldilocks as gl

# the module, not the `ntt` function the package re-exports under that name
_ntt = importlib.import_module("vectorx_tpu_torch.ntt.ntt")

P = gl.P

S_BITS = 13                # K1's longest column: a tile of 2^14 u64 (128 KB)
MAX_LOG_N = 2 * S_BITS     # four-step: both halves are K1 sizes
POW_L = 12                 # two-level power tables: x^e = lo[e % 2^L]·hi[e >> L]

# Kernel launches, counted by the wrapper where it launches each kernel.
LAUNCHES = {"ntt_tile": 0, "ntt_transpose": 0, "ntt_tile_t": 0,
            "ntt_tile_lde": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO: dict = {}


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NTT kernels cannot be built")
    return path


def build() -> str:
    """Compile `csrc/*.cu` into a shared library keyed by a hash of the
    sources and flags; reuse it when present.  Returns its path and records
    the build time and the compiler's output in `BUILD_INFO`."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libvx_ntt.so")
    if os.path.exists(lib):
        BUILD_INFO.update(path=lib, seconds=0.0, cached=True, log="")
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cu = [s for s in srcs if s.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=lib, seconds=secs, cached=False,
                      log=proc.stdout + proc.stderr)
    return lib


def load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.vx_ntt_tile.argtypes = [vp, vp, ll, ci, ci, ci, vp, vp, vp, ci,
                                    vp, vp, ci, ci, ctypes.c_ulonglong, vp]
        lib.vx_ntt_tile.restype = ci
        lib.vx_ntt_tile_t.argtypes = [vp, vp, ll, ci, ci, vp, vp, vp, ci,
                                      ctypes.c_ulonglong, vp]
        lib.vx_ntt_tile_t.restype = ci
        lib.vx_ntt_tile_lde.argtypes = [vp, vp, ll, ci, ci, ci, vp, vp, vp,
                                        ci, vp, vp, ci, ci, ci, vp]
        lib.vx_ntt_tile_lde.restype = ci
        lib.vx_transpose.argtypes = [vp, vp, ll, ci, ci, vp]
        lib.vx_transpose.restype = ci
        lib.vx_ntt_tile_smem.argtypes = [ci, ci]
        lib.vx_ntt_tile_smem.restype = ci
        lib.vx_ntt_s_bits.argtypes = []
        lib.vx_ntt_s_bits.restype = ci
        if lib.vx_ntt_s_bits() != S_BITS:
            raise RuntimeError("csrc/ntt.cu and cuda_ntt.S_BITS disagree")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# Tables (host-built with exact integers, cached per device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pow2_host(base: int, log_count: int):
    """(lo, hi, L) with base^e = lo[e % 2^L]·hi[e >> L] for
    0 <= e < 2^log_count."""
    L = min(POW_L, log_count)
    lo = _ntt.power_table(base, 1 << L)
    hi = _ntt.power_table(pow(base, 1 << L, P), 1 << (log_count - L))
    return lo, hi, L


def pow_tables(base: int, log_count: int, device):
    """`_pow2_host` cached on `device`: the (lo, hi, L) a kernel reads."""
    lo, hi, L = _pow2_host(base % P, log_count)
    key = ("pow2", base % P, log_count)
    return (_ntt.device_table(key + ("lo",), lambda: lo, device),
            _ntt.device_table(key + ("hi",), lambda: hi, device), L)


def _pow_at(tables, e: torch.Tensor) -> torch.Tensor:
    lo, hi, L = tables
    return gl.mul(lo[e & ((1 << L) - 1)], hi[e >> L])


def split(log_n: int) -> tuple[int, int]:
    """Four-step split n = R·C: log R = floor(log_n / 2) (the columns'
    length), log C = the rest."""
    a = log_n // 2
    return a, log_n - a


def plan(x: torch.Tensor, log_n: int, inverse: bool, shift, s_bits: int):
    """Everything a transform needs besides the kernels themselves: the
    shared recipe of `transform` and `emulate`.  A K1 step is
    ("k1", batch, C, log_n, col, tw, pre, post, twiddle, scale) as
    `ntt_tile` takes it; a K4 step ("k4", batch, C, log_n, tw, post,
    scale) as `ntt_tile_t` takes it."""
    n = 1 << log_n
    dev = x.device
    scale = pow(n, P - 2, P) if inverse else 1
    pre = post = None
    if shift is not None:
        if inverse:
            post = pow_tables(pow(shift, P - 2, P), log_n, dev)
        else:
            pre = pow_tables(shift, log_n, dev)
    b = x.numel() // n
    if log_n <= s_bits:
        return [("k1", b, 1, log_n, False, _ntt.twiddles(log_n, inverse, dev),
                 pre, post, False, scale)]
    a, c = split(log_n)
    R, C = 1 << a, 1 << c
    w_n = _ntt._root_of_unity(log_n, inverse)
    return [
        # K1 down the C columns of length R (x[c + C·r], coset on load):
        # Y[k1][c] times w_n^(c·k1), stored (b, R, C)
        ("k1", b, C, a, True, _ntt.twiddles(a, inverse, dev), pre,
         pow_tables(w_n, log_n, dev), True, 1),
        # K4 along the R rows of length C: Z[k1][k2] stored at its natural
        # index k = k1 + R·k2, times post^(k1 + R·k2) and n^-1
        ("k4", b, R, c, _ntt.twiddles(c, inverse, dev), post, scale),
    ]


def plan_lde(x: torch.Tensor, rate_bits: int, shift: int, s_bits: int):
    """The coset LDE's recipe, shared by `coset_lde` and `emulate_lde`: the
    coefficients x (…, n) transformed on shift·K, |K| = N = n << rate_bits,
    as `coset_ntt` of their zero padding to N.  Up to 2^s_bits points one
    K3 step on whole rows; past it K3 as the four-step's column step (its
    columns' nonzero elements only) and K4.  A K3 step is ("k3", batch, C,
    log_n, col, tw, pre, post, twiddle, rate_bits) as `ntt_tile_lde`
    takes it."""
    n = x.shape[-1]
    log_N = _log2(n) + rate_bits
    dev = x.device
    b = x.numel() // n
    pre = pow_tables(shift, log_N, dev)
    if log_N <= s_bits:
        return [("k3", b, 1, log_N, False, _ntt.twiddles(log_N, False, dev),
                 pre, None, False, rate_bits)]
    a, c = split(log_N)
    R, C = 1 << a, 1 << c
    w_N = _ntt._root_of_unity(log_N, False)
    return [("k3", b, C, a, True, _ntt.twiddles(a, False, dev), pre,
             pow_tables(w_N, log_N, dev), True, rate_bits),
            ("k4", b, R, c, _ntt.twiddles(c, False, dev), None, 1)]


def _check(x: torch.Tensor, log_n: int):
    if x.dtype != torch.int64:
        raise TypeError(f"expected int64 (u64 bit patterns), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if not 0 <= log_n <= MAX_LOG_N:
        raise ValueError(f"log_n={log_n} outside [0, {MAX_LOG_N}]")
    if x.dim() < 1 or x.shape[-1] != 1 << log_n:
        raise ValueError(f"last dim {tuple(x.shape)} is not 2^{log_n}")
    if not x.is_cuda:
        raise ValueError("cuda_ntt.transform takes CUDA tensors only")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _log2(v: int) -> int:
    lg = v.bit_length() - 1
    if v <= 0 or 1 << lg != v:
        raise ValueError(f"{v} is not a power of two")
    return lg


_NO_POW = (None, None, 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def ntt_tile(src: torch.Tensor, batch: int, C: int, log_n: int, col: bool,
             tw, pre, post, twiddle: bool, scale: int) -> torch.Tensor:
    """Launch K1 once on the batch·C columns of length n = 2^log_n in
    `src` (batch items of n·C elements): column c's element i at i·C + c
    of its item when `col`, at c·n + i (contiguous rows) otherwise.
    Multiplies element i by pre^(c + C·i) on load; transforms each column
    with the 2^(log_n-1) stage twiddles `tw`; multiplies output k by
    post^(c·k) if `twiddle` else post^(c + C·k), and by `scale`; stores in
    the input's layout."""
    if not 0 <= log_n <= S_BITS:
        raise ValueError(f"K1 takes log_n <= {S_BITS}, got {log_n}")
    if (not src.is_contiguous() or src.dtype != torch.int64
            or src.numel() != batch * C << log_n):
        raise ValueError(f"K1 takes {batch} contiguous int64 items of "
                         f"2^{log_n} x {C}, got {tuple(src.shape)}")
    if not src.is_cuda:
        raise ValueError("ntt_tile takes CUDA tensors only")
    out = torch.empty_like(src)
    pre = pre or _NO_POW
    post = post or _NO_POW
    _launched("ntt_tile", load().vx_ntt_tile(
        src.data_ptr(), out.data_ptr(), batch * C, _log2(C), int(col), log_n,
        tw.data_ptr(), _ptr(pre[0]), _ptr(pre[1]), pre[2],
        _ptr(post[0]), _ptr(post[1]), post[2], int(twiddle), scale,
        _stream(src)))
    return out


def ntt_tile_t(src: torch.Tensor, batch: int, C: int, log_n: int, tw, post,
               scale: int) -> torch.Tensor:
    """Launch K4 once: K1 on the batch·C contiguous rows of length
    n = 2^log_n (C rows an item), with output k of row c times
    post^(c + C·k) and `scale`, stored transposed, at k·C + c of its item:
    each item (C, n) -> (n, C)."""
    if not 0 <= log_n <= S_BITS:
        raise ValueError(f"K4 takes log_n <= {S_BITS}, got {log_n}")
    if (not src.is_contiguous() or src.dtype != torch.int64
            or src.numel() != batch * C << log_n):
        raise ValueError(f"K4 takes {batch} contiguous int64 items of "
                         f"{C} x 2^{log_n}, got {tuple(src.shape)}")
    if not src.is_cuda:
        raise ValueError("ntt_tile_t takes CUDA tensors only")
    out = torch.empty_like(src)
    post = post or _NO_POW
    _launched("ntt_tile_t", load().vx_ntt_tile_t(
        src.data_ptr(), out.data_ptr(), batch * C, _log2(C), log_n,
        tw.data_ptr(), _ptr(post[0]), _ptr(post[1]), post[2], scale,
        _stream(src)))
    return out


def ntt_tile_lde(src: torch.Tensor, batch: int, C: int, log_n: int,
                 col: bool, tw, pre, post, twiddle: bool,
                 rate_bits: int) -> torch.Tensor:
    """Launch K3 once: `ntt_tile` (scale 1) on the batch items of n·C
    elements, n = 2^log_n, that are the items of `src`, (n·C) >> rate_bits
    coefficients each, padded with zeros, without the padding ever being
    read or stored: column c's element i is the coefficient at c + C·i
    where that is below the item's length, else 0.  `col` False takes
    whole rows (C = 1).  Returns (batch, n·C)."""
    if not 0 <= log_n <= S_BITS:
        raise ValueError(f"K3 takes log_n <= {S_BITS}, got {log_n}")
    if not 0 <= rate_bits <= _log2(C) + log_n or not (col or C == 1):
        raise ValueError(f"K3 takes whole rows (C = 1) or columns and "
                         f"0 <= rate_bits <= log2(C·n), got C={C}, "
                         f"log_n={log_n}, rate_bits={rate_bits}")
    if (not src.is_contiguous() or src.dtype != torch.int64
            or src.numel() != batch * (C << log_n >> rate_bits)):
        raise ValueError(f"K3 takes {batch} contiguous int64 items of "
                         f"2^{log_n} x {C} >> {rate_bits}, got "
                         f"{tuple(src.shape)}")
    if not src.is_cuda:
        raise ValueError("ntt_tile_lde takes CUDA tensors only")
    out = torch.empty((batch, C << log_n), dtype=torch.int64,
                      device=src.device)
    pre = pre or _NO_POW
    post = post or _NO_POW
    _launched("ntt_tile_lde", load().vx_ntt_tile_lde(
        src.data_ptr(), out.data_ptr(), batch * C, _log2(C), int(col), log_n,
        tw.data_ptr(), _ptr(pre[0]), _ptr(pre[1]), pre[2],
        _ptr(post[0]), _ptr(post[1]), post[2], int(twiddle), rate_bits,
        _stream(src)))
    return out


def transpose(src: torch.Tensor, batch: int, R: int, C: int) -> torch.Tensor:
    """Launch K2 once: (batch, R, C) -> (batch, C, R).  On no transform's
    plan since K4 stores in natural order; kept for the comparison with
    the three-pass four-step (`chip_smoke.py` phase 1,
    `scripts/ntt_k1_limits.py`)."""
    if (max(R, C) > 1 << S_BITS or src.numel() != batch * R * C
            or not src.is_contiguous() or src.dtype != torch.int64):
        raise ValueError(f"K2 takes contiguous int64 (batch, R, C) blocks "
                         f"with R, C <= 2^{S_BITS}, got {batch}x{R}x{C}")
    if not src.is_cuda:
        raise ValueError("ntt_transpose takes CUDA tensors only")
    out = torch.empty((batch, C, R), dtype=torch.int64, device=src.device)
    _launched("ntt_transpose", load().vx_transpose(
        src.data_ptr(), out.data_ptr(), batch, R, C, _stream(src)))
    return out


def transform(x: torch.Tensor, log_n: int, inverse: bool,
              shift: int | None = None) -> torch.Tensor:
    """NTT (or iNTT with `inverse`) of every length-2^log_n row of a CUDA
    int64 tensor, natural order in and out, batched over leading dims.
    `shift` makes it `coset_ntt` (forward: times shift^j on load) or
    `coset_intt` (inverse: times shift^-k on store)."""
    _check(x, log_n)
    return _run(x, plan(x, log_n, inverse, shift, S_BITS), KERNELS).reshape(
        x.shape)


def coset_lde(x: torch.Tensor, rate_bits: int,
              shift: int = gl.GENERATOR) -> torch.Tensor:
    """`coset_ntt` on shift·K, |K| = N = n << rate_bits, of the rows of
    coefficients x (…, n) padded with zeros to N, on a CUDA int64 tensor:
    K3 (then K4 past 2^S_BITS points) reads the n coefficients only; no
    padded tensor exists.  Returns (…, N)."""
    log_n = (x.shape[-1] if x.dim() else 0).bit_length() - 1
    if not 0 <= rate_bits <= MAX_LOG_N - max(log_n, 0):
        raise ValueError(f"rate_bits={rate_bits} outside "
                         f"[0, {MAX_LOG_N} - log2(n)]")
    _check(x, log_n)
    with tracing.span("ntt.coset_lde", rows=x.numel() >> log_n, log_n=log_n,
                      rate_bits=rate_bits):
        out = _run(x, plan_lde(x, rate_bits, shift, S_BITS), KERNELS)
        return out.reshape(*x.shape[:-1], x.shape[-1] << rate_bits)


def transform_plain(x: torch.Tensor, log_n: int, inverse: bool,
                    shift: int | None = None) -> torch.Tensor:
    """The plain torch version of `transform` (stage-by-stage butterflies
    plus separate coset passes) on any device."""
    n = 1 << log_n
    if shift is not None and not inverse:
        x = gl.mul(x, _ntt.device_powers(shift, n, x.device))
    y = _ntt._transform_torch(x, log_n, inverse)
    if shift is not None and inverse:
        y = gl.mul(y, _ntt.device_powers(pow(shift, P - 2, P), n, y.device))
    return y


def coset_lde_plain(x: torch.Tensor, rate_bits: int,
                    shift: int = gl.GENERATOR) -> torch.Tensor:
    """The plain torch version of `coset_lde`: pad, then `transform_plain`."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (n << rate_bits) - n))
    return transform_plain(x, _log2(n) + rate_bits, False, shift)


# ---------------------------------------------------------------------------
# Plain torch versions of each kernel, and the kernels' algorithm on them
# ---------------------------------------------------------------------------

def _dit(v: torch.Tensor, log_n: int, tw, first: int = 0) -> torch.Tensor:
    """Radix-2 DIT stages first .. log_n-1, in place, on bit-reversed
    columns along the last dim."""
    n = 1 << log_n
    b = torch.arange(n // 2, device=v.device)
    for s in range(first, log_n):
        m = 1 << s
        k = b & (m - 1)
        j = ((b >> s) << (s + 1)) | k
        u = v[..., j]
        t = gl.mul(v[..., j + m], tw[k << (log_n - 1 - s)])
        v[..., j] = gl.add(u, t)
        v[..., j + m] = gl.sub(u, t)
    return v


def _on_store(v: torch.Tensor, C: int, post, twiddle: bool, scale: int):
    """K1's products on store: output k of column c times post^(c·k) if
    `twiddle` else post^(c + C·k), and `scale`."""
    c = torch.arange(C, device=v.device)[:, None]
    k = torch.arange(v.shape[-1], device=v.device)[None, :]
    if post is not None:
        v = gl.mul(v, _pow_at(post, c * k if twiddle else c + C * k))
    if scale != 1:
        v = gl.mul(v, scale)
    return v


def _bitrev(log_n: int, dev):
    return torch.from_numpy(_ntt.bit_reverse_perm(log_n)).to(dev)


def ntt_tile_plain(src, batch, C, log_n, col, tw, pre, post, twiddle, scale):
    """The plain torch version of `ntt_tile` (K1): the same layouts, the
    same radix-2 DIT stages on bit-reversed columns and the same tables."""
    n = 1 << log_n
    dev = src.device
    v = src.reshape(batch, n, C).transpose(1, 2) if col else \
        src.reshape(batch, C, n)
    c = torch.arange(C, device=dev)[:, None]
    i = torch.arange(n, device=dev)[None, :]
    if pre is not None:
        v = gl.mul(v, _pow_at(pre, c + C * i))
    v = _dit(v[..., _bitrev(log_n, dev)], log_n, tw)
    v = _on_store(v, C, post, twiddle, scale)
    return (v.transpose(1, 2) if col else v).reshape(src.shape).contiguous()


def ntt_tile_t_plain(src, batch, C, log_n, tw, post, scale):
    """The plain torch version of `ntt_tile_t` (K4): K1's plain row step,
    each item's (C, n) result transposed to (n, C)."""
    out = ntt_tile_plain(src, batch, C, log_n, False, tw, None, post, False,
                         scale)
    return out.reshape(batch, C, 1 << log_n).transpose(1, 2).reshape(
        src.shape).contiguous()


def ntt_tile_lde_plain(src, batch, C, log_n, col, tw, pre, post, twiddle,
                       rate_bits):
    """The plain torch version of `ntt_tile_lde` (K3), from the unpadded
    coefficients as the kernel: a column's elements past its first m are
    padding, so after the bit reversal only every 2^skip-th position
    (skip = log_n - log2 m) holds a coefficient, and DIT stages 0 .. skip-1
    only copy it into the 2^skip positions of its block; the stages from
    `skip` on are K1's."""
    n_in = (C << log_n) >> rate_bits
    dev = src.device
    m = max(n_in // C, 1)
    skip = log_n - _log2(m)
    v = src.reshape(batch, n_in)
    if not col:
        v = v.reshape(batch, 1, m)
    elif n_in >= C:
        v = v.reshape(batch, m, C).transpose(1, 2)
    else:                                   # columns c >= n_in are padding
        v = torch.cat([v, v.new_zeros(batch, C - n_in)], 1)[..., None]
    c = torch.arange(C, device=dev)[:, None]
    i = torch.arange(m, device=dev)[None, :]
    if pre is not None:
        v = gl.mul(v, _pow_at(pre, c + C * i))
    v = v[..., _bitrev(log_n - skip, dev)].repeat_interleave(1 << skip, -1)
    v = _on_store(_dit(v, log_n, tw, skip), C, post, twiddle, 1)
    return (v.transpose(1, 2) if col else v).reshape(batch, -1).contiguous()


def transpose_plain(src, batch, R, C):
    """The plain torch version of `transpose` (K2)."""
    return src.reshape(batch, R, C).transpose(1, 2).contiguous()


KERNELS = {"k1": ntt_tile, "k2": transpose, "k3": ntt_tile_lde,
           "k4": ntt_tile_t}
PLAIN = {"k1": ntt_tile_plain, "k2": transpose_plain,
         "k3": ntt_tile_lde_plain, "k4": ntt_tile_t_plain}


def _run(x: torch.Tensor, steps, fns) -> torch.Tensor:
    cur = x.contiguous()
    for kind, *args in steps:
        cur = fns[kind](cur, *args)
    return cur


def emulate(x: torch.Tensor, log_n: int, inverse: bool,
            shift: int | None = None, s_bits: int = S_BITS) -> torch.Tensor:
    """`transform` with each kernel replaced by its plain version: the
    kernels' algorithm (split, steps, stage order, tables) in torch.  A
    small `s_bits` forces the four-step at small sizes."""
    return _run(x, plan(x, log_n, inverse, shift, s_bits), PLAIN).reshape(
        x.shape)


def emulate_lde(x: torch.Tensor, rate_bits: int, shift: int = gl.GENERATOR,
                s_bits: int = S_BITS) -> torch.Tensor:
    """`coset_lde` with each kernel replaced by its plain version."""
    out = _run(x, plan_lde(x, rate_bits, shift, s_bits), PLAIN)
    return out.reshape(*x.shape[:-1], x.shape[-1] << rate_bits)
