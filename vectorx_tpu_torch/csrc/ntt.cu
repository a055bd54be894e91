// Goldilocks NTT kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces: vectorx_tpu/ntt/pallas_ntt.py — `_kernel` + `transform` (the
// single-pass in-VMEM transform, n <= 2^18) and `transform_big` +
// `_dev_twiddle_grid` (the four-step for 2^20 <= n <= 2^24).
//
// What bounds it on the H100: a Goldilocks butterfly is one 64x64->128
// multiply (a*b and __umul64hi) plus a few adds, so the transform is bound by
// device-memory traffic, not by integer throughput.  The stage-by-stage path
// (plain torch, one kernel per stage and per field op) reads and writes the
// whole array about 2·log2(n) times; these kernels keep it to about 2 passes
// (load once, store once) for n <= 2^13, and about 8 passes (4 kernels)
// for the four-step up to 2^26.
//
// What the design does about it:
//  * K1 `ntt_rows_smem`: one block holds a whole row (n <= 2^S_BITS = 2^13,
//    64 KB) plus the stage twiddles (32 KB) in shared memory, runs all log2(n)
//    radix-2 DIT stages there with __syncthreads between them, and touches
//    device memory once on the way in and once on the way out.  The
//    bit-reversal is folded into the shared-memory store of the load, the
//    coset pre-multiply shift^j into the load, and the coset post-multiply
//    and the n^-1 scale of the inverse into the store.  Short rows share a
//    block (up to 2048 elements per block).  Input rows may be strided
//    (columns of a matrix), so the four-step's first transpose is folded into
//    the load.
//  * K2 `ntt_twiddle_transpose`: a 32x32 tiled shared-memory transpose of an
//    (R, C) block per batch item that multiplies by w^(r·c) on the way
//    through (or not).  The four-step for 2^13 < n <= 2^26 is: K1 down the
//    columns, K2 with twiddles, K1 along the rows, K2 plain.
//  * Powers (twiddle w^(r·c), coset shift^j) come from two 4096-entry tables,
//    x^e = lo[e mod 2^L] · hi[e >> L], built on the host with exact integers,
//    so no table grows with n.
//
// Values are u64 bit patterns in [0, 2^64), non-canonical like the rest of
// the package; reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

#include <cstdint>
#include <cuda_runtime.h>

#define VX_S_BITS 13

namespace {

constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {
    s += EPS;
    if (s < EPS) s += EPS;
  }
  return s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) {
    uint64_t d2 = d - EPS;
    if (d < EPS) d2 -= EPS;
    d = d2;
  }
  return d;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  const uint64_t t1 = (hl << 32) - hl;
  uint64_t r = t0 + t1;
  if (r < t1) r += EPS;
  return r;
}

// x^e = lo[e mod 2^L] * hi[e >> L]; lo == nullptr means "no multiply".
struct Pow2 {
  const uint64_t* lo;
  const uint64_t* hi;
  int L;
};

__device__ __forceinline__ uint64_t pow_at(const Pow2& p, uint64_t e) {
  return gl_mul(__ldg(p.lo + (e & ((1ull << p.L) - 1))), __ldg(p.hi + (e >> p.L)));
}

// Logical index of element i of row rr: (rr % G) * sR + i * sE; the element
// of batch item rr / G sits at (rr / G) * bstride + that index.
struct Addr {
  long long G, sR, sE, bstride;
};

__global__ void ntt_rows_smem(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, long long rows,
                              int log_n, int rpb, Addr ia,
                              const uint64_t* __restrict__ tw, Pow2 pre,
                              Addr oa, Pow2 post, uint64_t scale) {
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  uint64_t* tws = smem;
  uint64_t* buf = smem + (half > 0 ? half : 1);
  const long long row0 = (long long)blockIdx.x * rpb;
  const long long left = rows - row0;
  const int nrows = left < rpb ? (int)left : rpb;

  for (int t = threadIdx.x; t < half; t += blockDim.x) tws[t] = __ldg(tw + t);
  const int total = nrows << log_n;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t >> log_n;
    const int i = t & (n - 1);
    const long long rr = row0 + r;
    const long long li = (rr % ia.G) * ia.sR + (long long)i * ia.sE;
    uint64_t v = in[(rr / ia.G) * ia.bstride + li];
    if (pre.lo) v = gl_mul(v, pow_at(pre, (uint64_t)li));
    const int j = log_n ? (int)(__brev((unsigned)i) >> (32 - log_n)) : 0;
    buf[(r << log_n) + j] = v;
  }
  __syncthreads();

  const int nb = nrows * half;
  for (int s = 0; s < log_n; ++s) {
    const int m = 1 << s;
    const int tsh = log_n - 1 - s;
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      const int r = t >> (log_n - 1);
      const int b = t & (half - 1);
      const int k = b & (m - 1);
      const int j = ((b >> s) << (s + 1)) | k;
      uint64_t* row = buf + (r << log_n);
      const uint64_t u = row[j];
      const uint64_t v = gl_mul(row[j + m], tws[k << tsh]);
      row[j] = gl_add(u, v);
      row[j + m] = gl_sub(u, v);
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t >> log_n;
    const int i = t & (n - 1);
    const long long rr = row0 + r;
    uint64_t v = buf[t];
    if (post.lo)
      v = gl_mul(v, pow_at(post, (uint64_t)((rr % oa.G) * oa.sR + (long long)i * oa.sE)));
    if (scale != 1) v = gl_mul(v, scale);
    out[rr * n + i] = v;
  }
}

constexpr int TILE = 32;

// out[b][c][r] = in[b][r][c] * (tw ? w^(r*c) : 1) for each (R, C) batch item.
__global__ void ntt_twiddle_transpose(const uint64_t* __restrict__ in,
                                      uint64_t* __restrict__ out,
                                      long long batch, int R, int C, Pow2 tw) {
  __shared__ uint64_t tile[TILE][TILE + 1];
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const long long plane = (long long)R * C;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const uint64_t* src = in + b * plane;
    uint64_t* dst = out + b * plane;
    for (int dy = threadIdx.y; dy < TILE; dy += blockDim.y) {
      const int r = r0 + dy;
      const int c = c0 + threadIdx.x;
      if (r < R && c < C) {
        uint64_t v = src[(long long)r * C + c];
        if (tw.lo) v = gl_mul(v, pow_at(tw, (uint64_t)r * (uint64_t)c));
        tile[dy][threadIdx.x] = v;
      }
    }
    __syncthreads();
    for (int dy = threadIdx.y; dy < TILE; dy += blockDim.y) {
      const int c = c0 + dy;
      const int r = r0 + threadIdx.x;
      if (r < R && c < C) dst[(long long)c * R + r] = tile[threadIdx.x][dy];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int vx_ntt_s_bits() { return VX_S_BITS; }

// K1 launch.  Returns cudaGetLastError() (0 on success).
int vx_ntt_rows(const void* in, void* out, long long rows, int log_n,
                long long iG, long long isR, long long isE, long long ibstride,
                const void* tw, const void* pre_lo, const void* pre_hi,
                int pre_L, long long oG, long long osR, long long osE,
                const void* post_lo, const void* post_hi, int post_L,
                unsigned long long scale, void* stream) {
  if (log_n < 0 || log_n > VX_S_BITS || rows < 0 || iG <= 0 || oG <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int n = 1 << log_n;
  const int rpb = n >= 2048 ? 1 : 2048 / n;
  const int threads = n >= 4096 ? 512 : 256;
  const size_t smem = ((size_t)(n > 1 ? n / 2 : 1) + (size_t)rpb * n) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_rows_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpb - 1) / rpb;
  Addr ia{iG, isR, isE, ibstride};
  Addr oa{oG, osR, osE, 0};
  Pow2 pre{(const uint64_t*)pre_lo, (const uint64_t*)pre_hi, pre_L};
  Pow2 post{(const uint64_t*)post_lo, (const uint64_t*)post_hi, post_L};
  ntt_rows_smem<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, rows, log_n, rpb, ia,
      (const uint64_t*)tw, pre, oa, post, (uint64_t)scale);
  return (int)cudaGetLastError();
}

// K2 launch.  tw_lo == nullptr: plain transpose.
int vx_twiddle_transpose(const void* in, void* out, long long batch, int R,
                         int C, const void* tw_lo, const void* tw_hi, int tw_L,
                         void* stream) {
  if (batch < 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  dim3 block(TILE, 8);
  const long long gz = batch < 65535 ? batch : 65535;
  dim3 grid((C + TILE - 1) / TILE, (R + TILE - 1) / TILE, (unsigned)gz);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  Pow2 tw{(const uint64_t*)tw_lo, (const uint64_t*)tw_hi, tw_L};
  ntt_twiddle_transpose<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch, R, C, tw);
  return (int)cudaGetLastError();
}

}  // extern "C"
