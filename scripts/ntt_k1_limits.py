#!/usr/bin/env python3
"""What holds the NTT row kernel K1 (`ntt_tile`) back on the card.

    python3 scripts/ntt_k1_limits.py

Builds K1 from `vectorx_tpu_torch/csrc/ntt.cu` as it is and in variants
that each take one part of its work away (text edits of the source, built
with the same nvcc flags into `vectorx_tpu_torch/_build/limits/`), and
times every variant with CUDA events at the main paths' K1 shapes beside a
plain copy of the same tensor.  A variant computes a wrong transform: it
only says what that part of the work costs.

* `kernel`          the kernel as shipped;
* `C field ops`     the field ops as plain C++ (64-bit compares and
                    selects) instead of the 32-bit carry chains;
* `no butterflies`  loads, shared-memory exchanges, coset/twiddle
                    products and stores only;
* `no products`     butterflies without the twiddle product;
* `no add/sub`      butterflies with wrapping u64 add and subtract;
* `no twiddle loads` the stage twiddles computed, not loaded.

Then prints the kernel's SASS instruction mix (cuobjdump) for the column
lengths 2^8 and 2^12.  Needs one CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

C_FIELD_OPS = r'''
constexpr uint64_t EPS = 0xFFFFFFFFull;
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) { s += EPS; if (s < EPS) s += EPS; }
  return s;
}
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) { uint64_t d2 = d - EPS; if (d < EPS) d2 -= EPS; d = d2; }
  return d;
}
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b, hi = __umul64hi(a, b);
  const uint64_t hh = hi >> 32, hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  const uint64_t t1 = (hl << 32) - hl;
  uint64_t r = t0 + t1;
  if (r < t1) r += EPS;
  return r;
}
'''


def variants(src: str) -> dict[str, str]:
    start = src.index("// The field ops work on 32-bit words")
    end = src.index("// x^e = lo[e mod 2^L]")
    edits = {
        "C field ops": (src[start:end], C_FIELD_OPS),
        "no butterflies": ("    radix<L, S0, E, FIRST>(x, klo, a.tw, skip);\n",
                           ""),
        "no products": ("if (!(FIRST && a == 0)) v = gl_mul(v, w[a]);",
                        "if (!(FIRST && a == 0)) v = v ^ w[a];"),
        "no add/sub": ("      x[t | (1 << q)] = gl_sub(x[t], v);\n"
                       "      x[t] = gl_add(x[t], v);",
                       "      x[t | (1 << q)] = x[t] - v;\n"
                       "      x[t] = x[t] + v;"),
        "no twiddle loads": (
            "__ldg(tw + ((klo + ((uint32_t)a << S0)) << sh))",
            "(tw[0] + klo + (uint64_t)a)"),
    }
    out = {"kernel": src}
    for name, (old, new) in edits.items():
        if old not in src:
            raise RuntimeError(f"variant {name!r}: its edit no longer applies")
        out[name] = src.replace(old, new)
    return out


def build(name: str, text: str, out_dir: str, nvcc: str, flags) -> ctypes.CDLL:
    slug = re.sub(r"\W+", "_", name)
    cu = os.path.join(out_dir, f"{slug}.cu")
    so = os.path.join(out_dir, f"{slug}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([nvcc, *flags, "-o", so, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.vx_ntt_tile.argtypes = [vp, vp, ll, ci, ci, ci, vp, vp, vp, ci, vp, vp,
                                ci, ci, ctypes.c_ulonglong, vp]
    lib.vx_ntt_tile.restype = ci
    lib.vx_transpose.argtypes = [vp, vp, ll, ci, ci, vp]
    lib.vx_transpose.restype = ci
    lib.vx_ntt_s_bits.restype = ci
    return lib


def sass_mix(so: str, log_n: int) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    m = re.search(r"Function : \S*ntt_tileILi%dE\S*\n(.*?)(?=\n\s*Function :|\Z)"
                  % log_n, sass, re.S)
    if not m:
        return "not found"
    ops = collections.Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", m.group(1)))
    return (f"{sum(ops.values())} instructions: "
            + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)))


def main() -> int:
    import importlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ntt_k1_limits: needs a CUDA device")
    from chip_smoke import card_line, cuda_ms, random_field
    from vectorx_tpu_torch.ntt import cuda_ntt

    ntt_mod = importlib.import_module("vectorx_tpu_torch.ntt.ntt")
    card = card_line()
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(cuda_ntt.BUILD_ROOT, "limits")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with open(os.path.join(cuda_ntt.CSRC_DIR, "ntt.cu")) as f:
        src = f.read()
    libs = {name: build(name, text, out_dir, nvcc, cuda_ntt.NVCC_FLAGS)
            for name, text in variants(src).items()}

    rng = np.random.default_rng(0)
    lde = random_field(rng, (512, 1 << 17), dev)
    sq = random_field(rng, (4096, 4096), dev)
    pre = cuda_ntt.pow_tables(7, 17, dev)
    post = cuda_ntt.pow_tables(ntt_mod._root_of_unity(17, False), 17, dev)
    tw8 = ntt_mod.twiddles(8, False, dev)
    tw12 = ntt_mod.twiddles(12, False, dev)
    shapes = {
        "(512, 2^17) column step, coset on load, twiddle on store":
            (lde, 512, 512, 8, True, tw8, pre, post, True, 1),
        "(512, 2^17) column step, no coset, no twiddle":
            (lde, 512, 512, 8, True, tw8, None, None, False, 1),
        "2^12 rows x 2^12": (sq, 4096, 1, 12, False, tw12, None, None, False, 1),
        "2^12 columns x 2^12":
            (sq, 1, 4096, 12, True, tw12, None, None, False, 1),
    }
    try:
        for rnd in range(3):
            order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
            for label, (x, *args) in shapes.items():
                times = {}
                for name in order:
                    cuda_ntt._LIB = libs[name]
                    times[name] = cuda_ms(lambda: cuda_ntt.ntt_tile(x, *args), 9)
                copy = cuda_ms(lambda: x.clone(), 9)
                print(f"round {rnd}: {label}: "
                      + ", ".join(f"{k} {times[k]:.4f}" for k in libs)
                      + f", copy of the tensor {copy:.4f} ms  [{card}]",
                      flush=True)
    finally:
        cuda_ntt._LIB = None
    so = os.path.join(out_dir, "kernel.so")
    for log_n in (8, 12):
        print(f"SASS of ntt_tile<{log_n}>: {sass_mix(so, log_n)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
