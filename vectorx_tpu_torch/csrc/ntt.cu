// Goldilocks NTT kernels for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces: vectorx_tpu/ntt/pallas_ntt.py — `_kernel` + `transform` (the
// single-pass in-VMEM transform) and `transform_big` + `_dev_twiddle_grid`
// (the four-step), and the zero padding the reference's `ntt.lde` feeds
// them.  The TPU kernel's own limits (n <= 2^18 in one pass,
// 2^20 <= n <= 2^24 for the four-step) are VMEM's; the port's are these:
// K1 transforms columns of length n <= 2^13 (VX_S_BITS), and the four-step
// built from it (K1 + K4, or K3 + K4 for an LDE) covers n <= 2^26
// (cuda_ntt.MAX_LOG_N).
//
// What bounds it on the H100.  Not the bytes: a column of length n costs
// n/2·log2(n) butterflies, each a Goldilocks product (a 64x64->128
// multiply and its reduction) plus a modular add and subtract, about 40
// integer instructions, so at n = 2^8..2^12 an element costs 150-250
// integer instructions against 16 bytes of device traffic (one read, one
// write), and the card issues one warp instruction per scheduler per
// clock (integer adds and selects on 16 lanes of each SM quarter).
// Measured (scripts/ntt_k1_limits.py, H100 80GB HBM3 at 700 W): at 2^12
// rows x 2^12 the kernel takes 0.27 ms, the same kernel without its
// butterflies 0.12 ms and a plain copy of the tensor 0.11 ms; the
// butterflies' instructions are the rest.  By the count of 32-bit
// multiply-adds alone (eight a product) the bound is 0.04 ms and by bytes
// 0.08 ms; the kernel stays near the card's instruction issue rate.  The
// first version of K1 (one element per thread, log2(n) radix-2 stages
// through shared memory with a barrier each, 64-bit divisions per element,
// an n/2 twiddle table copied into every block, uncoalesced strided column
// reads, field ops as 64-bit compares and selects) took 0.49-0.53 ms there.
//
// What the design does about it:
//  * K1 `ntt_tile`: a block takes a tile of W adjacent columns x the whole
//    column length n (W = 8 up to n = 2^11, then 4 and 2, so the tile stays
//    at <= 128 KB of shared memory; for short rows W grows to 2048/n).  A
//    "column" is element i at i·C + c of a (n, C) block (the four-step's
//    strided first step) or a contiguous row (C = 1 per batch item: a
//    whole transform of up to 2^13 points); in both cases neighbouring
//    threads read neighbouring addresses, so a warp reads whole 32-byte
//    sectors.  K3 and K4 below run the same passes through `tile_pass`.
//  * Butterflies in registers: each thread owns 8 elements and runs 3
//    radix-2 DIT stages on them between shared-memory exchanges (radix-8;
//    the last pass takes the 1-3 stages left), so a column of 2^12 takes 4
//    passes and 3 barriers instead of 12.  The bit reversal of DIT costs
//    nothing: the first pass loads straight from device memory the 8
//    elements its butterflies need (stride n/8, from rev(g)), and the last
//    pass stores its 8 results straight to their natural positions.
//  * The field ops are PTX carry chains on 32-bit words (below): a carry
//    or borrow out of 2^64 folds back without a 64-bit compare or select,
//    which cut K1 by a fifth (0.95 against 1.19 ms at the (512, 2^17)
//    LDE block's column step, scripts/ntt_k1_limits.py).
//  * No cp.async or TMA staging ring: without its butterflies the kernel
//    already moves a tile at the speed of a plain copy, so overlapping the
//    next tile's loads with this tile's butterflies has nothing to hide;
//    the loads go straight into registers, 8 independent ones per thread.
//  * Shared memory holds the tile between passes with an XOR swizzle on the
//    low 4 bits of each index (`swz`, `col_xor`), chosen so that every
//    half-warp of 64-bit accesses in every pass hits 16 distinct bank pairs
//    for columns of 2^8 and longer.
//  * Twiddles come from the n/2-entry stage table in device memory through
//    the read-only cache: 7 loads per thread and pass, never a copy per
//    block.  Index math inside a tile is 32-bit; the 64-bit column base is
//    computed once per thread and pass.
//  * The coset pre-multiply shift^(c + C·i) and the store's post-multiply
//    come from one two-level table power per thread and a per-thread step
//    (one product per element); the n^-1 scale is folded into the
//    post-multiply's base.  The post-multiply is either a coset power
//    (c + C·k) or the four-step's twiddle w^(c·k), so the four-step's first
//    K1 leaves its output twiddled in (b, R, C) order and needs no
//    twiddled transpose.
//  * K4 `ntt_tile_t`: the four-step's row pass, K1's code on contiguous
//    rows (coset^-1 power and n^-1 on store) with its last pass mapped
//    column-fast and stored transposed: Z[k1][k2] goes straight to its
//    natural index k1 + R·k2.  A block holds W >= 8 adjacent rows k1
//    (W = 4 at C = 2^12, 2 at C = 2^13, where 8 rows would pass 227 KB),
//    so for each k2 a warp writes whole runs of W·8 = 64 B (32 B, 16 B):
//    full sectors except at C = 2^13 (n = 2^25, 2^26), where the other
//    half of each 32-byte sector is written by the block of the
//    neighbouring rows (phase 1 of chip_smoke.py times NTT (1, 2^26)
//    beside the three-pass route).  The
//    store goes from registers with plain coalesced st.global, not TMA:
//    the values leave the last radix pass in registers, and a TMA store
//    would first write the tile back to shared memory and wait on a
//    barrier, one more shared round trip for sectors that are already
//    whole.  The col_xor swizzle keeps that column-fast pass's
//    shared-memory reads conflict-free up to W = 8, as in K1's col layout.
//    So the four-step for 2^13 < n <= 2^26 is two passes over device
//    memory: K1 down the columns (coset on load, twiddle on store), K4.
//    K4 costs about what K1's row step costs (0.679 against 0.663 ms at
//    the (512, 2^17) block, chip_smoke.py phase 1, H100 80GB HBM3 at
//    700 W); K2's whole pass (0.405 ms there) is gone.
//  * K3 `ntt_tile_lde`: the coset LDE's first pass, from the coefficients
//    (b, n) without their zero padding to N = n << rate.  In the
//    four-step's (R, C) view column c's element r sits at r·C + c, nonzero
//    only for r < n/C, and those are the coefficient row's own elements;
//    K3 reads them only (no padded tensor exists) and multiplies only them
//    by the coset power.  After DIT's bit reversal only every 2^rate-th
//    position of a column holds a coefficient, so the first min(rate, 3)
//    stages of its first radix-8 pass are copies, not butterflies: a group
//    loads 8 >> rate values (one at rate 3) and replicates them.  It
//    stores twiddled in (b, R, C) order as K1's column step does, and K4
//    finishes; up to 2^13 points the same kernel runs the whole LDE on
//    contiguous rows.  Bound on the H100 as K1 is, by the butterflies'
//    instructions: at rate 3 and R = 2^8, 3 of the column's 8 stages go
//    (0.707 against K1's 0.956 ms at the (512, 2^14 -> 2^17) block), and
//    the LDE is K3 + K4, 1.389 ms, against pad + K1 + K1 + K2, 2.169 ms.
//    Where n < C (rate > log2 N / 2) a column holds at most one
//    coefficient, its r = 0 (none for c >= n), and loads only that.
//  * K2 `ntt_transpose`: a 32x32 tiled shared-memory transpose of (R, C)
//    blocks.  On no transform's plan since K4; kept for the comparison of
//    phase 1 and scripts/ntt_k1_limits.py.
//  * Powers x^e come from two 4096-entry tables, x^e = lo[e mod 2^12] ·
//    hi[e >> 12], built on the host with exact integers, so no table grows
//    with n.
//
// Values are u64 bit patterns in [0, 2^64), non-canonical like the rest of
// the package; reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).

#include <cstdint>
#include <cuda_runtime.h>

#define VX_S_BITS 13

namespace {

// The field ops work on 32-bit words with the carry flag (PTX add.cc /
// addc, sub.cc / subc), so a carry or borrow out of 2^64 costs no compare
// and no select: each folds back as a mask of 0 or 2^32 - 1 = EPS.  Inputs
// and outputs are any u64 bit patterns, congruent mod p to the plain torch
// field's (`field/goldilocks.py`) results.

// a + b: a carry out of 2^64 adds EPS; that can carry once more, never a
// third time (after the second fold the sum is below 2^33).
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 a0, a0, m;\n\t"
      "addc.cc.u32 a1, a1, 0;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 a0, a0, m;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// a - b: a borrow out of 2^64 subtracts EPS, at most twice.
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "sub.cc.u32 a0, a0, b0;\n\t"
      "subc.cc.u32 a1, a1, b1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 a0, a0, m;\n\t"
      "subc.cc.u32 a1, a1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 a0, a0, m;\n\t"
      "subc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// a * b: the 128-bit product r3:r2:r1:r0 from four 32x32 partial products,
// then r1:r0 - r3 + r2·EPS (2^64 = EPS, 2^96 = -1 mod p): the borrow of the
// subtraction takes EPS once (the difference is then >= p), the carry of
// the addition adds EPS once (the sum is then <= 2^64 - 2^33).
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1, r0, r1, r2, r3, m;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "mul.lo.u32 r0, a0, b0;\n\t"
      "mul.hi.u32 r1, a0, b0;\n\t"
      "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
      "madc.hi.u32 r2, a0, b1, 0;\n\t"
      "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
      "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
      "addc.u32 r3, 0, 0;\n\t"
      "mad.lo.cc.u32 r2, a1, b1, r2;\n\t"
      "madc.hi.u32 r3, a1, b1, r3;\n\t"
      "sub.cc.u32 r0, r0, r3;\n\t"
      "subc.cc.u32 r1, r1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 r0, r0, m;\n\t"
      "subc.u32 r1, r1, 0;\n\t"
      "sub.cc.u32 r3, 0, r2;\n\t"
      "subc.u32 r2, r2, 0;\n\t"
      "add.cc.u32 r0, r0, r3;\n\t"
      "addc.cc.u32 r1, r1, r2;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"
      "add.cc.u32 r0, r0, m;\n\t"
      "addc.u32 r1, r1, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t}"
      : "=l"(r) : "l"(a), "l"(b));
  return r;
}

// x^e = lo[e mod 2^L] * hi[e >> L]; lo == nullptr means "no multiply".
struct Pow2 {
  const uint64_t* lo;
  const uint64_t* hi;
  int L;
};

__device__ __forceinline__ uint64_t pow_at(const Pow2& p, uint32_t e) {
  return gl_mul(__ldg(p.lo + (e & ((1u << p.L) - 1))), __ldg(p.hi + (e >> p.L)));
}

// One launch of K1, K3 or K4.  Column gc of the ncols = batch·C columns
// is column c = gc mod C of batch item b = gc / C; its element i sits at
// b·n·C + i·C + c (col) or b·n·C + c·n + i (rows).  K1 stores in the
// layout it loads; K4 loads rows and stores element k at b·n·C + k·C + c;
// K3 loads from items of n·C >> rate elements (the coefficients without
// their zero padding; element i of column c only where c + C·i is below
// that size) and stores as K1.
struct K1Args {
  const uint64_t* in;
  uint64_t* out;
  long long ncols;
  int logC;
  int col;
  int logW;           // log2 of the columns per tile
  const uint64_t* tw; // [w^0 .. w^(n/2-1)], the stage twiddles
  Pow2 pre;           // times pre^(c + C·i) on load
  Pow2 post;          // times post^(c + C·k), or post^(c·k) if post_twiddle
  int post_twiddle;
  uint64_t scale;     // times scale on store (folded into post)
  int rate;           // K3: log2 of the padding factor
};

enum Mode { K1 = 0, K4 = 1, K3 = 2 };

template <int B>
__device__ __forceinline__ uint32_t rev(uint32_t x) {
  if constexpr (B == 0) return 0;
  else return __brev(x) >> (32 - B);
}

// The shared-memory swizzle: XOR of bits >= 4 of a column index into its
// low 4 bits (linear over GF(2), so swz(a ^ b) = swz(a) ^ swz(b)).  Bits
// 4-6 go to (b, parity(b)) and bits 7.. to 3, 0, 1, 2, 3, 0: with the pass
// structure below every half-warp access is conflict-free for n >= 2^8.
__host__ __device__ constexpr uint32_t swz(uint32_t j) {
  const uint32_t b = (j >> 4) & 7;
  const uint32_t par = (b ^ (b >> 1) ^ (b >> 2)) & 1;
  return j ^ b ^ (par << 3) ^ (((j >> 7) & 1) << 3) ^ ((j >> 8) & 15) ^
         (j >> 12);
}

// A per-column XOR into the low 4 bits, for the passes whose half-warps
// span several columns (the tile's first and last pass in col layout).
__device__ __forceinline__ uint32_t col_xor(uint32_t w, int logW) {
  switch (logW < 3 ? logW : 3) {
    case 3: return ((w & 1) ? 2u : 0u) ^ ((w & 2) ? 4u : 0u) ^ ((w & 4) ? 9u : 0u);
    case 2: return ((w & 1) ? 4u : 0u) ^ ((w & 2) ? 10u : 0u);
    case 1: return (w & 1) ? 12u : 0u;
    default: return 0u;
  }
}

// E radix-2 DIT stages S0 .. S0+E-1 on x[t] = element klo + t·2^S0 (+ a
// constant): pairs (t, t + 2^q) with twiddle w_n^((klo + (t mod 2^q)·2^S0)
// · 2^(L-1-S0-q)).  In the first pass klo = 0 and w^0 = 1 needs no product.
// The first `skip` stages act on inputs of which only every 2^skip-th is
// loaded (the others are zeros of K3's padding): such a stage leaves both
// outputs of a pair equal to its upper input, a copy instead of a
// butterfly.
template <int L, int S0, int E, bool FIRST>
__device__ __forceinline__ void radix(uint64_t (&x)[1 << E], uint32_t klo,
                                      const uint64_t* __restrict__ tw,
                                      int skip) {
#pragma unroll
  for (int q = 0; q < E; ++q) {
    if (q < skip) {
#pragma unroll
      for (int t = 0; t < (1 << E); ++t)
        if (!(t & (1 << q))) x[t | (1 << q)] = x[t];
      continue;
    }
    const int sh = L - 1 - S0 - q;
    uint64_t w[E > 0 ? 1 << (E - 1) : 1];
#pragma unroll
    for (int a = 0; a < (1 << q); ++a)
      w[a] = (FIRST && a == 0) ? 1 : __ldg(tw + ((klo + ((uint32_t)a << S0)) << sh));
#pragma unroll
    for (int t = 0; t < (1 << E); ++t) {
      if (t & (1 << q)) continue;
      const int a = t & ((1 << q) - 1);
      uint64_t v = x[t | (1 << q)];
      if (!(FIRST && a == 0)) v = gl_mul(v, w[a]);
      x[t | (1 << q)] = gl_sub(x[t], v);
      x[t] = gl_add(x[t], v);
    }
  }
}

// One pass of a tile: every (column w, group g) item holds 2^E elements.
// The first pass loads from device memory, the last stores to it, the
// others exchange through shared memory.  Items map column-fast where the
// pass touches device memory across columns (neighbouring threads take
// neighbouring columns: K1's and K3's loads and stores in col layout,
// K4's transposed store), group-fast otherwise.
template <int L, int S0, int E, bool FIRST, bool LAST, int MODE>
__device__ __forceinline__ void tile_pass(const K1Args& a, uint64_t* buf) {
  constexpr int LG = L - E;  // log2 of the items per column
  const uint32_t wmask = (1u << a.logW) - 1;
  const uint32_t items = 1u << (LG + a.logW);
  const bool in_col = MODE != K4 && a.col;
  const bool out_col = MODE == K4 || a.col;
  const bool colfast = (FIRST && in_col) || (LAST && out_col);
  const long long col0 = (long long)blockIdx.x << a.logW;
  const uint32_t C = 1u << a.logC;
  const long long cell = (long long)C << L;  // elements of an output item
  // K3: the first `skip` DIT stages see only zeros besides the loaded
  // every-2^skip-th input, and 2^(E - skip) loads a group suffice
  const int skip = (MODE == K3 && FIRST) ? (a.rate < E ? a.rate : E) : 0;
  for (uint32_t item = threadIdx.x; item < items; item += blockDim.x) {
    uint32_t w, g;
    if (colfast) {
      w = item & wmask;
      g = item >> a.logW;
    } else {
      g = item & ((1u << LG) - 1);
      w = item >> LG;
    }
    const long long gc = col0 + w;
    const bool live = gc < a.ncols;
    const uint32_t c = (uint32_t)gc & (C - 1);
    const long long bi = gc >> a.logC;
    uint64_t x[1 << E];
    uint32_t klo = 0;
    if constexpr (FIRST) {
      // DIT reads element rev(j) into position j = t + 2^E·g: the 2^E
      // elements i0 + u·2^LG with i0 = rev(g), u = rev(t).  In row layout
      // the item's rank is i0 itself, so neighbouring threads read
      // neighbouring addresses.
      uint32_t i0;
      if (in_col) {
        i0 = rev<LG>(g);
      } else {
        i0 = g;
        g = rev<LG>(g);
      }
      const long long in_cell = MODE == K3 ? cell >> a.rate : cell;
      const long long ibase =
          bi * in_cell + (in_col ? (long long)c : (long long)c << L);
      const uint32_t stride = in_col ? C : 1u;
      const bool pre = a.pre.lo != nullptr;
      uint64_t p = 0, step = 0;
      if (pre) {
        p = pow_at(a.pre, c + C * i0);
        if (skip < E) step = pow_at(a.pre, C << LG);
      }
#pragma unroll
      for (int u = 0; u < (1 << E); ++u) {
        uint64_t v = 0;
        if (u < (1 << (E - skip))) {
          const uint32_t i = i0 + ((uint32_t)u << LG);
          bool ok = live;
          if constexpr (MODE == K3) ok = ok && c + C * i < in_cell;
          v = ok ? a.in[ibase + i * stride] : 0;
          if (pre) {
            if (u > 0) p = gl_mul(p, step);
            v = gl_mul(v, p);
          }
        }
        x[rev<E>(u)] = v;
      }
    } else {
      klo = g & ((1u << S0) - 1);
    }
    // shared-memory slot of element j_t = klo + t·2^S0 + hi·2^(S0+E)
    const uint32_t hi = g >> S0;
    const uint32_t sb = (w << L) | (swz(klo | (hi << (S0 + E))) ^ col_xor(w, a.logW));
    if constexpr (!FIRST) {
#pragma unroll
      for (int t = 0; t < (1 << E); ++t) x[t] = buf[sb ^ swz((uint32_t)t << S0)];
    }
    radix<L, S0, E, FIRST>(x, klo, a.tw, skip);
    if constexpr (LAST) {
      // outputs k_t = klo + t·2^S0 (the last pass has hi = 0)
      const long long obase =
          bi * cell + (out_col ? (long long)c : (long long)c << L);
      const uint32_t stride = out_col ? C : 1u;
      const bool post = a.post.lo != nullptr;
      uint64_t p = 0, step = 0;
      if (post) {
        const uint32_t e0 = a.post_twiddle ? 0u : c;
        const uint32_t e1 = a.post_twiddle ? c : C;
        p = pow_at(a.post, e0 + e1 * klo);
        step = pow_at(a.post, e1 << S0);
        if (a.scale != 1) p = gl_mul(p, a.scale);
      }
#pragma unroll
      for (int t = 0; t < (1 << E); ++t) {
        uint64_t v = x[t];
        if (post) {
          v = gl_mul(v, p);
          p = gl_mul(p, step);
        } else if (a.scale != 1) {
          v = gl_mul(v, a.scale);
        }
        if (live) a.out[obase + (klo + ((uint32_t)t << S0)) * stride] = v;
      }
    } else {
#pragma unroll
      for (int t = 0; t < (1 << E); ++t) buf[sb ^ swz((uint32_t)t << S0)] = x[t];
    }
  }
}

__host__ __device__ constexpr int num_passes(int L) { return L <= 3 ? 1 : (L + 2) / 3; }

template <int L, int p, int MODE>
__device__ __forceinline__ void tile_passes(const K1Args& a, uint64_t* buf) {
  constexpr int P = num_passes(L);
  constexpr int S0 = 3 * p;
  constexpr int E = p == P - 1 ? L - S0 : 3;
  tile_pass<L, S0, E, p == 0, p == P - 1, MODE>(a, buf);
  if constexpr (p + 1 < P) {
    __syncthreads();
    tile_passes<L, p + 1, MODE>(a, buf);
  }
}

// K1: columns or rows in, the same layout out.
template <int L>
__global__ void __launch_bounds__(512) ntt_tile(K1Args a) {
  extern __shared__ uint64_t buf[];
  tile_passes<L, 0, K1>(a, buf);
}

// K4: rows in, stored transposed (the four-step's last pass, natural order).
template <int L>
__global__ void __launch_bounds__(512) ntt_tile_t(K1Args a) {
  extern __shared__ uint64_t buf[];
  tile_passes<L, 0, K4>(a, buf);
}

// K3: the coset LDE's first pass, from coefficients without their padding.
template <int L>
__global__ void __launch_bounds__(512) ntt_tile_lde(K1Args a) {
  extern __shared__ uint64_t buf[];
  tile_passes<L, 0, K3>(a, buf);
}

constexpr int TILE = 32;

// out[b][c][r] = in[b][r][c] for each (R, C) batch item.
__global__ void ntt_transpose(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, long long batch,
                              int R, int C) {
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
      if (r < R && c < C) tile[dy][threadIdx.x] = src[(long long)r * C + c];
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

typedef void (*TileKernel)(K1Args);

template <int L, int MODE>
TileKernel tile_kernel() {
  if constexpr (MODE == K1) return ntt_tile<L>;
  else if constexpr (MODE == K4) return ntt_tile_t<L>;
  else return ntt_tile_lde<L>;
}

template <int L, int MODE>
int launch_tile(const K1Args& a, long long blocks, int threads, size_t smem,
                cudaStream_t stream) {
  const TileKernel kernel = tile_kernel<L, MODE>();
  if (smem > 48 * 1024) {
    static bool raised = false;  // the attribute is per kernel, set once
    if (!raised) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 128 * 1024);
      if (e != cudaSuccess) return (int)e;
      raised = true;
    }
  }
  K1Args arg = a;
  void* args[] = {&arg};
  cudaError_t e = cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks),
                                   dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// log2 of a tile's width for a column length 2^log_n: 2^(11 - log_n)
// columns for short rows (2048 elements a tile), at least 8 adjacent
// columns where a pass touches device memory across columns (whole
// 64-byte segments: col layout, K4's store), at most 2^14 elements
// (128 KB) a tile.
int tile_log_w(int log_n, int colfast) {
  int lw = 11 - log_n;
  if (colfast && lw < 3) lw = 3;
  if (lw > 14 - log_n) lw = 14 - log_n;
  return lw < 0 ? 0 : lw;
}

int tile_smem(int log_n, int logW) {
  if (num_passes(log_n) == 1) return 0;
  return (int)sizeof(uint64_t) << (log_n + logW);
}

template <int MODE>
int launch(K1Args a, int log_n, void* stream) {
  if (log_n < 0 || log_n > VX_S_BITS || a.ncols < 0 || a.logC < 0 ||
      a.logC + log_n > 2 * VX_S_BITS)
    return (int)cudaErrorInvalidValue;
  if (a.ncols == 0) return 0;
  a.logW = tile_log_w(log_n, MODE == K4 || a.col);
  const long long blocks = (a.ncols + (1ll << a.logW) - 1) >> a.logW;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const long long elems = 1ll << (log_n + a.logW);
  const int threads = elems >= 4096 ? 512 : 256;
  const size_t smem = (size_t)tile_smem(log_n, a.logW);
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_n) {
    case 0: return launch_tile<0, MODE>(a, blocks, threads, smem, s);
    case 1: return launch_tile<1, MODE>(a, blocks, threads, smem, s);
    case 2: return launch_tile<2, MODE>(a, blocks, threads, smem, s);
    case 3: return launch_tile<3, MODE>(a, blocks, threads, smem, s);
    case 4: return launch_tile<4, MODE>(a, blocks, threads, smem, s);
    case 5: return launch_tile<5, MODE>(a, blocks, threads, smem, s);
    case 6: return launch_tile<6, MODE>(a, blocks, threads, smem, s);
    case 7: return launch_tile<7, MODE>(a, blocks, threads, smem, s);
    case 8: return launch_tile<8, MODE>(a, blocks, threads, smem, s);
    case 9: return launch_tile<9, MODE>(a, blocks, threads, smem, s);
    case 10: return launch_tile<10, MODE>(a, blocks, threads, smem, s);
    case 11: return launch_tile<11, MODE>(a, blocks, threads, smem, s);
    case 12: return launch_tile<12, MODE>(a, blocks, threads, smem, s);
    default: return launch_tile<13, MODE>(a, blocks, threads, smem, s);
  }
}

Pow2 pow2(const void* lo, const void* hi, int L) {
  return Pow2{(const uint64_t*)lo, (const uint64_t*)hi, L};
}

}  // namespace

extern "C" {

int vx_ntt_s_bits() { return VX_S_BITS; }

// The dynamic shared memory per block of K1 and K3 (`col` their layout)
// or K4 (col = 1): the tile, when it takes more than one pass.
int vx_ntt_tile_smem(int log_n, int col) {
  if (log_n < 0 || log_n > VX_S_BITS) return 0;
  return tile_smem(log_n, tile_log_w(log_n, col));
}

// K1 launch.  Returns cudaGetLastError() (0 on success).
int vx_ntt_tile(const void* in, void* out, long long ncols, int logC, int col,
                int log_n, const void* tw, const void* pre_lo,
                const void* pre_hi, int pre_L, const void* post_lo,
                const void* post_hi, int post_L, int post_twiddle,
                unsigned long long scale, void* stream) {
  return launch<K1>(
      K1Args{(const uint64_t*)in, (uint64_t*)out, ncols, logC, col, 0,
             (const uint64_t*)tw, pow2(pre_lo, pre_hi, pre_L),
             pow2(post_lo, post_hi, post_L), post_twiddle, (uint64_t)scale,
             0},
      log_n, stream);
}

// K4 launch: rows of length 2^log_n, C = 2^logC of them an item, stored
// transposed; times post^(c + C·k) and scale on store.
int vx_ntt_tile_t(const void* in, void* out, long long ncols, int logC,
                  int log_n, const void* tw, const void* post_lo,
                  const void* post_hi, int post_L, unsigned long long scale,
                  void* stream) {
  return launch<K4>(
      K1Args{(const uint64_t*)in, (uint64_t*)out, ncols, logC, 0, 0,
             (const uint64_t*)tw, pow2(nullptr, nullptr, 0),
             pow2(post_lo, post_hi, post_L), 0, (uint64_t)scale, 0},
      log_n, stream);
}

// K3 launch: K1's column step (col) or whole rows (C = 1) of the zero-padded
// coefficients, read from items of (C << log_n) >> rate elements.
int vx_ntt_tile_lde(const void* in, void* out, long long ncols, int logC,
                    int col, int log_n, const void* tw, const void* pre_lo,
                    const void* pre_hi, int pre_L, const void* post_lo,
                    const void* post_hi, int post_L, int post_twiddle,
                    int rate, void* stream) {
  if (rate < 0 || rate > logC + log_n || (!col && logC != 0))
    return (int)cudaErrorInvalidValue;
  return launch<K3>(
      K1Args{(const uint64_t*)in, (uint64_t*)out, ncols, logC, col, 0,
             (const uint64_t*)tw, pow2(pre_lo, pre_hi, pre_L),
             pow2(post_lo, post_hi, post_L), post_twiddle, 1, rate},
      log_n, stream);
}

// K2 launch.
int vx_transpose(const void* in, void* out, long long batch, int R, int C,
                 void* stream) {
  if (batch < 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  dim3 block(TILE, 8);
  const long long gz = batch < 65535 ? batch : 65535;
  dim3 grid((C + TILE - 1) / TILE, (R + TILE - 1) / TILE, (unsigned)gz);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  ntt_transpose<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch, R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
