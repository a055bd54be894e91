"""The hand-written Goldilocks NTT kernels (`csrc/ntt.cu`) and, beside them,
their plain torch version and a torch emulation of their algorithm.

Replaces `vectorx_tpu.ntt.pallas_ntt` (`transform`, `transform_big`,
`transform_any`): K1 `ntt_rows_smem` is a batched transform of rows of
length n <= 2^S_BITS held whole in shared memory; K2
`ntt_twiddle_transpose` is the twiddled transpose of the four-step that
covers 2^S_BITS < n <= 2^(2·S_BITS).  `csrc/ntt.cu` carries the note on what
bounds them on the card and how the design deals with it.

* `transform` — the kernel path: CUDA int64 tensors only, raises on anything
  the kernels do not take.  Never falls back.
* `transform_plain` — the plain torch version of the same function (the CPU
  path, and the oracle `chip_smoke.py` holds the kernels against).
* `ntt_rows`/`twiddle_transpose` — one launch of K1/K2, each with its plain
  torch version beside it (`ntt_rows_plain`, `twiddle_transpose_plain`).
* `emulate` — `transform` with each kernel replaced by its plain version
  (same split, same stage order, same tables), so the CPU tests hold the
  kernels' algorithm against `transform_plain`.

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

from vectorx_tpu_torch.field import goldilocks as gl

# the module, not the `ntt` function the package re-exports under that name
_ntt = importlib.import_module("vectorx_tpu_torch.ntt.ntt")

P = gl.P

S_BITS = 13                # K1 holds a row of 2^S_BITS u64 in shared memory
MAX_LOG_N = 2 * S_BITS     # four-step: both halves are K1 sizes
POW_L = 12                 # two-level power tables: x^e = lo[e % 2^L]·hi[e >> L]

# Kernel launches, counted by the wrapper where it launches each kernel.
LAUNCHES = {"ntt_rows_smem": 0, "ntt_twiddle_transpose": 0}

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
        lib.vx_ntt_rows.argtypes = [vp, vp, ll, ci, ll, ll, ll, ll, vp,
                                    vp, vp, ci, ll, ll, ll, vp, vp, ci,
                                    ctypes.c_ulonglong, vp]
        lib.vx_ntt_rows.restype = ci
        lib.vx_twiddle_transpose.argtypes = [vp, vp, ll, ci, ci, vp, vp, ci,
                                             vp]
        lib.vx_twiddle_transpose.restype = ci
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
    shared recipe of `transform` and `emulate`."""
    n = 1 << log_n
    dev = x.device
    scale = pow(n, P - 2, P) if inverse else 1
    pre = post = None
    if shift is not None:
        if inverse:
            post = pow_tables(pow(shift, P - 2, P), log_n, dev)
        else:
            pre = pow_tables(shift, log_n, dev)
    steps = []
    b = x.numel() // n
    if log_n <= s_bits:
        steps.append(("k1", b, log_n, (1, 0, 1, n),
                      _ntt.twiddles(log_n, inverse, dev), pre,
                      (1, 0, 1), post, scale))
        return steps
    a, c = split(log_n)
    R, C = 1 << a, 1 << c
    w_n = _ntt._root_of_unity(log_n, inverse)
    steps += [
        # K1 down the columns: x[c + C·r] -> Y[k1][c], stored (b, C, R)
        ("k1", b * C, a, (C, 1, C, n), _ntt.twiddles(a, inverse, dev), pre,
         (1, 0, 1), None, 1),
        # K2: (b, C, R) -> (b, R, C), times w_n^(c·k1)
        ("k2", b, C, R, pow_tables(w_n, log_n, dev)),
        # K1 along the rows: Z[k1][k2], natural index k = k1 + R·k2
        ("k1", b * R, c, (1, 0, 1, C), _ntt.twiddles(c, inverse, dev), None,
         (R, 1, R), post, scale),
        # K2: (b, R, C) -> (b, C, R) = natural order
        ("k2", b, R, C, None),
    ]
    return steps


def _check(x: torch.Tensor, log_n: int):
    if not x.is_cuda:
        raise ValueError("cuda_ntt.transform takes CUDA tensors only")
    if x.dtype != torch.int64:
        raise TypeError(f"expected int64 (u64 bit patterns), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.dim() < 1 or x.shape[-1] != 1 << log_n:
        raise ValueError(f"last dim {tuple(x.shape)} is not 2^{log_n}")
    if not 0 <= log_n <= MAX_LOG_N:
        raise ValueError(f"log_n={log_n} outside [0, {MAX_LOG_N}]")


def _ptr(t):
    return None if t is None else t.data_ptr()


_NO_POW = (None, None, 0)


def ntt_rows(src: torch.Tensor, rows: int, log_n: int, ia, tw, pre, oa,
             post, scale: int) -> torch.Tensor:
    """Launch K1 once: transform `rows` rows of length 2^log_n read from
    `src` with addressing ia = (G, sR, sE, bstride) (element i of row r at
    (r // G)·bstride + (r % G)·sR + i·sE), times pre-table^(that index) on
    load; store (rows, 2^log_n) contiguous, times post-table^((r % oG)·oR
    + i·oE) and `scale`.  `tw` holds the 2^(log_n-1) stage twiddles."""
    if not 0 <= log_n <= S_BITS:
        raise ValueError(f"K1 takes log_n <= {S_BITS}, got {log_n}")
    out = torch.empty((rows, 1 << log_n), dtype=torch.int64,
                      device=src.device)
    pre = pre or _NO_POW
    post = post or _NO_POW
    err = load().vx_ntt_rows(
        src.data_ptr(), out.data_ptr(), rows, log_n, *ia, tw.data_ptr(),
        _ptr(pre[0]), _ptr(pre[1]), pre[2], *oa,
        _ptr(post[0]), _ptr(post[1]), post[2], scale,
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntt_rows_smem launch failed: cudaError {err}")
    LAUNCHES["ntt_rows_smem"] += 1
    return out


def twiddle_transpose(src: torch.Tensor, batch: int, R: int, C: int,
                      tw) -> torch.Tensor:
    """Launch K2 once: (batch, R, C) -> (batch, C, R), times
    tw-table^(r·c) on the way through when `tw` is given."""
    if max(R, C) > 1 << S_BITS or src.numel() != batch * R * C:
        raise ValueError(f"K2 takes (batch, R, C) blocks with R, C <= "
                         f"2^{S_BITS}, got {batch}x{R}x{C}")
    out = torch.empty((batch, C, R), dtype=torch.int64, device=src.device)
    tw = tw or _NO_POW
    err = load().vx_twiddle_transpose(
        src.data_ptr(), out.data_ptr(), batch, R, C,
        _ptr(tw[0]), _ptr(tw[1]), tw[2],
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntt_twiddle_transpose launch failed: "
                           f"cudaError {err}")
    LAUNCHES["ntt_twiddle_transpose"] += 1
    return out


def transform(x: torch.Tensor, log_n: int, inverse: bool,
              shift: int | None = None) -> torch.Tensor:
    """NTT (or iNTT with `inverse`) of every length-2^log_n row of a CUDA
    int64 tensor, natural order in and out, batched over leading dims.
    `shift` makes it `coset_ntt` (forward: times shift^j on load) or
    `coset_intt` (inverse: times shift^-k on store)."""
    _check(x, log_n)
    cur = x
    for st in plan(x, log_n, inverse, shift, S_BITS):
        cur = (ntt_rows if st[0] == "k1" else twiddle_transpose)(cur, *st[1:])
    return cur.reshape(x.shape)


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


# ---------------------------------------------------------------------------
# Plain torch versions of each kernel, and the kernels' algorithm on them
# ---------------------------------------------------------------------------

def ntt_rows_plain(src, rows, log_n, ia, tw, pre, oa, post, scale):
    """The plain torch version of `ntt_rows` (K1): the same gather, the
    same bit-reversed DIT stage order and the same tables."""
    n = 1 << log_n
    dev = src.device
    G, sR, sE, bstride = ia
    rr = torch.arange(rows, device=dev)[:, None]
    i = torch.arange(n, device=dev)[None, :]
    li = (rr % G) * sR + i * sE
    v = src.reshape(-1)[(rr // G) * bstride + li]
    if pre is not None:
        v = gl.mul(v, _pow_at(pre, li))
    buf = torch.empty_like(v)
    buf[:, torch.from_numpy(_ntt.bit_reverse_perm(log_n)).to(dev)] = v
    b = torch.arange(n // 2, device=dev)
    for s in range(log_n):
        m = 1 << s
        k = b & (m - 1)
        j = ((b >> s) << (s + 1)) | k
        u = buf[:, j]
        t = gl.mul(buf[:, j + m], tw[k << (log_n - 1 - s)])
        buf[:, j] = gl.add(u, t)
        buf[:, j + m] = gl.sub(u, t)
    if post is not None:
        oG, osR, osE = oa
        buf = gl.mul(buf, _pow_at(post, (rr % oG) * osR + i * osE))
    if scale != 1:
        buf = gl.mul(buf, scale)
    return buf


def twiddle_transpose_plain(src, batch, R, C, tw):
    """The plain torch version of `twiddle_transpose` (K2)."""
    dev = src.device
    v = src.reshape(batch, R, C)
    if tw is not None:
        e = (torch.arange(R, device=dev)[:, None]
             * torch.arange(C, device=dev)[None, :])
        v = gl.mul(v, _pow_at(tw, e))
    return v.transpose(1, 2).contiguous()


def emulate(x: torch.Tensor, log_n: int, inverse: bool,
            shift: int | None = None, s_bits: int = S_BITS) -> torch.Tensor:
    """`transform` with each kernel replaced by its plain version: the
    kernels' algorithm (split, stage order, tables) in torch.  A small
    `s_bits` forces the four-step at small sizes."""
    cur = x.contiguous()
    for st in plan(x, log_n, inverse, shift, s_bits):
        fn = ntt_rows_plain if st[0] == "k1" else twiddle_transpose_plain
        cur = fn(cur, *st[1:])
    return cur.reshape(x.shape)
