// Hand-written Hopper (sm_90a) kernels of the jpegqs_tpu_torch solver path,
// plus the arithmetic canaries that pin the build's float semantics.
//
// Built by jpegqs_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -ftz=false -shared -Xcompiler -fPIC
// and loaded with ctypes: every entry point has a plain C interface, takes
// device pointers and a cudaStream_t, launches on that stream, allocates
// nothing, and returns cudaGetLastError().
//
// Layouts (the JAX package's public layouts): coefficients and pixels are
// planar int32[64, B] -- row k (natural position / pixel r*8+c) has stride B,
// so thread b of a warp reads address k*B + b and neighbouring threads read
// neighbouring words.  One thread owns one 8x8 block for the whole pass.
//
// Bit-exactness against the C scalar reference (and so against the JAX
// package):
//  * every fp32 product and sum of the solver fold is __fmul_rn/__fadd_rn,
//    which are never contracted into FMA (and the build passes -fmad=false);
//  * a2/a3 are strict left folds over the terms in the scalar order;
//  * a2/a3 is IEEE round-to-nearest (__fdiv_rn);
//  * the C (int) cast of the x86 build gives INT32_MIN for NaN and for
//    out-of-range values (the a3 == 0 case) -- masked explicitly, since
//    cvt.rzi saturates and maps NaN to 0;
//  * integer arithmetic that can wrap is done in uint32_t (signed overflow is
//    undefined in C++), arithmetic right shifts on int32_t;
//  * the rebalance is int64, as specref.rebalance_blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int kThreads = 128;

// The k = 63..1 sweep order: natural index of each step and whether the
// step opens a zigzag refresh (specref NATURAL_ORDER[63:0:-1] and
// ZIGZAG_REFRESH at those indices; quantsmooth.h:313-322, 1403-1409).
__constant__ int c_iseq[63] = {
    63, 62, 55, 47, 54, 61, 60, 53, 46, 39, 31, 38, 45, 52, 59, 58,
    51, 44, 37, 30, 23, 15, 22, 29, 36, 43, 50, 57, 56, 49, 42, 35,
    28, 21, 14, 7, 6, 13, 20, 27, 34, 41, 48, 40, 33, 26, 19, 12,
    5, 4, 11, 18, 25, 32, 24, 17, 10, 3, 2, 9, 16, 8, 1};
__constant__ int c_refresh[63] = {
    1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1,
    0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0,
    0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0,
    0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0};

// libjpeg islow butterfly (idct.h:59-89) in wrapping 32-bit arithmetic.
__device__ __forceinline__ void islow_pass(const u32 (&x)[8], u32 (&o)[8]) {
  u32 z2 = x[2], z3 = x[6];
  u32 z1 = (z2 + z3) * 4433u;
  u32 tmp2 = z1 - z3 * 15137u;
  u32 tmp3 = z1 + z2 * 6270u;
  z2 = x[0];
  z3 = x[4];
  u32 tmp0 = (z2 + z3) << 13;
  u32 tmp1 = (z2 - z3) << 13;
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  u32 z4 = tmp1 + tmp3;
  const u32 z5 = (z3 + z4) * 9633u;
  tmp0 *= 2446u;
  tmp1 *= 16819u;
  tmp2 *= 25172u;
  tmp3 *= 12299u;
  z1 *= 7373u;
  z2 *= 20995u;
  z3 = z5 - z3 * 16069u;
  z4 = z5 - z4 * 3196u;
  tmp0 += z3 - z1;
  tmp1 += z4 - z2;
  tmp2 += z3 - z2;
  tmp3 += z4 - z1;
  o[0] = tmp10 + tmp3;
  o[1] = tmp11 + tmp2;
  o[2] = tmp12 + tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
  o[5] = tmp12 - tmp1;
  o[6] = tmp11 - tmp2;
  o[7] = tmp10 - tmp3;
}

// Full islow IDCT of one block (idct.h:468-539): columns, DESCALE 2^11,
// rows, +CENTER rounding shift 2^18, clamp to 0..255.  c and p are indexed
// statically only, so with the caller's loops unrolled both stay in
// registers.
__device__ __forceinline__ void idct_block(const int (&c)[64], int* p) {
  int ws[64];
#pragma unroll
  for (int col = 0; col < 8; ++col) {
    u32 x[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = (u32)c[r * 8 + col];
    islow_pass(x, o);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[r * 8 + col] = (int)(o[r] + 1024u) >> 11;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    u32 x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = (u32)ws[r * 8 + k];
    islow_pass(x, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = (int)(o[k] + (257u << 17)) >> 18;
      p[r * 8 + k] = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
  }
}

// GET_ORIG_COEF (quantsmooth.h:332-336, non-NEON): the nearest dequantized
// lattice point a0 = round_half_away(c / q) * q, in the reference's
// fixed-point form with int32 wraparound.
__device__ __forceinline__ int orig_coef(int c, int dv, int x1, int qshr) {
  const int p = (int)((u32)x1 * (u32)c);
  const int a0 = (int)((u32)(p >> 16) + (u32)c);
  const int s = (int)((0u - (u32)a0) * (u32)qshr + 0x4000u);
  return (int)((u32)(s >> 15) * (u32)dv);
}

// Clamp to the quantization interval around a0 (quantsmooth.h:555-560).
__device__ __forceinline__ int interval_clamp(int add, int a0, int dv) {
  const int d0 = (dv - 1) >> 1;
  const int d1 = dv >> 1;
  const int dh = (int)((u32)a0 + (u32)(a0 < 0 ? d1 : d0));
  const int dl = (int)((u32)a0 - (u32)(a0 > 0 ? d1 : d0));
  return max(min(add, dh), dl);
}

// The C (int) cast of the x86 build (cvttss2si): truncation toward zero,
// INT32_MIN for NaN and out-of-range values.  cvt.rzi saturates and maps
// NaN to 0, so the range is tested first (NaN fails both compares).
__device__ __forceinline__ int c_cast(float x) {
  return (x >= -2147483648.0f && x < 2147483648.0f) ? (int)x : INT32_MIN;
}

// Term j of the diff vector in scalar fold order (quantsmooth.h:1521-1541)
// as a pair of indices into v[96] = {64 pixels r*8+c, top[8], bottom[8],
// left[8], right[8]}: 56 horizontal, 32 border, 56 vertical, 98 diagonal.
// Called with compile-time j only (unrolled loop), so it folds away.
__device__ __forceinline__ void term_idx(int j, int& a, int& b) {
  if (j < 56) {
    a = (j / 7) * 8 + j % 7;
    b = a + 1;
  } else if (j < 64) {
    a = j - 56;
    b = 64 + (j - 56);
  } else if (j < 72) {
    a = 56 + (j - 64);
    b = 72 + (j - 64);
  } else if (j < 80) {
    a = (j - 72) * 8;
    b = 80 + (j - 72);
  } else if (j < 88) {
    a = (j - 80) * 8 + 7;
    b = 88 + (j - 80);
  } else if (j < 144) {
    a = j - 88;
    b = a + 8;
  } else {
    const int k = j - 144, rc = k >> 1, r = rc / 7, c = rc % 7;
    if (k & 1) {
      a = r * 8 + c + 1;
      b = (r + 1) * 8 + c;
    } else {
      a = r * 8 + c;
      b = (r + 1) * 8 + c + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// B1: pixel bootstrap.
// Replaces jpegqs_tpu/ops/pallas_solver.py idct_pix_tiles (_solve_tiled with
// do_sweep=False, want_pix=True, aux_mode="none"; _idct_tile).
// Bound on this card: bytes -- 256 B read + 256 B written per block against
// ~1.3k integer ops.  Design: one thread per block, planar loads/stores so a
// warp touches 32 consecutive words per row; no shared memory needed.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
idct_pix_kernel(const int* __restrict__ coef, int* __restrict__ pix,
                int nblocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const size_t S = (size_t)nblocks;
  int c[64], p[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = coef[k * S + b];
  idct_block(c, p);
#pragma unroll
  for (int k = 0; k < 64; ++k) pix[k * S + b] = p[k];
}

// ---------------------------------------------------------------------------
// The pieces of a solver pass that B2, B3 and B4 share.
// ---------------------------------------------------------------------------

// The k = 63..1 sweep (quantsmooth.h:1403-1565) on one block: c the
// coefficients, v[64..95] the four border lines; v[0..63] receive the
// refreshed pixels.  Every product and sum of the a2/a3 folds is
// __fmul_rn/__fadd_rn in the scalar term order.  A thread refreshes (IDCT)
// only at a zigzag refresh point and only when one of its coefficients
// changed, as the C reference does; the TPU kernel's masked full-tile
// refresh gives the same values.
template <int NT>
__device__ __forceinline__ void sweep(int (&c)[64], int (&v)[96],
                                      const int* __restrict__ div,
                                      const int* __restrict__ x1,
                                      const int* __restrict__ qshr,
                                      const float* __restrict__ tab) {
  bool need = true;
  for (int k = 0; k < 63; ++k) {
    const int i = c_iseq[k];
    if (c_refresh[k] && need) {
      idct_block(c, v);
      need = false;
    }
    const float rng = (float)(div[i] * 2);
    const float* tr = tab + i * NT;
    float a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int ia, ib;
      term_idx(j, ia, ib);
      const float d = (float)(v[ia] - v[ib]);
      float t = fmaxf(__fsub_rn(rng, fabsf(d)), 0.0f);  // integral: exact
      t = __fmul_rn(t, t);
      const float u = __fmul_rn(d, t);
      const float w = __fmul_rn(__ldg(tr + j), t);
      a2 = __fadd_rn(a2, __fmul_rn(u, w));
      a3 = __fadd_rn(a3, __fmul_rn(w, w));
    }
    const int delta = c_cast(roundf(__fdiv_rn(a2, a3)));  // half away
    if (delta != 0) {
      const int coef1 = c[i];
      const int dv = div[i];
      const int a0 = orig_coef(coef1, dv, x1[i], qshr[i]);
      const int nc =
          interval_clamp((int)((u32)coef1 - (u32)delta), a0, dv);
      if (nc != coef1) {
        c[i] = nc;
        need = true;
      }
    }
  }
}

// AC energy restore (quantsmooth.h:1823-1848), int64 as specref
// .rebalance_blocks; sums in uint64 so they wrap like numpy's int64.
__device__ __forceinline__ void rebalance(int (&c)[64],
                                          const int* __restrict__ div,
                                          const int* __restrict__ x1,
                                          const int* __restrict__ qshr) {
  u64 m0 = 0, m1 = 0;
#pragma unroll 7
  for (int k = 1; k < 64; ++k) {
    const long long a0 = orig_coef(c[k], div[k], x1[k], qshr[k]);
    m0 += (u64)((long long)c[k] * a0);
    m1 += (u64)(a0 * a0);
  }
  const long long sm0 = (long long)m0, sm1 = (long long)m1;
  if (sm1 > sm0) {
    const long long num = (long long)((m1 << 13) + (u64)(sm0 >> 1));
    const long long den = sm0 == 0 ? 1 : sm0;
    const long long q64 =
        den == -1 ? (long long)(0ull - (u64)num) : num / den;  // C trunc
    const u32 mul = (u32)(u64)q64;                             // int trunc
#pragma unroll 7
    for (int k = 1; k < 64; ++k) {
      const int dv = div[k];
      const int a0 = orig_coef(c[k], dv, x1[k], qshr[k]);
      const long long prod = (int)((u32)c[k] * mul);
      c[k] = interval_clamp((int)((prod + 0x1000) >> 13), a0, dv);
    }
  }
}

// Write the block's coefficients and, when pix_out is given, their IDCT
// (the next pass's pixels).
__device__ __forceinline__ void emit_block(const int (&c)[64],
                                           int* __restrict__ coef_out,
                                           int* __restrict__ pix_out,
                                           size_t S, int b) {
#pragma unroll
  for (int k = 0; k < 64; ++k) coef_out[k * S + b] = c[k];
  if (pix_out != nullptr) {
    int p[64];
    idct_block(c, p);
#pragma unroll
    for (int k = 0; k < 64; ++k) pix_out[k * S + b] = p[k];
  }
}

// The four border lines of block b (v[64..95]: top, bottom, left, right)
// from the previous pass's pixels of its neighbours, replicated at the edges
// the caller flags (planar.borders_from_blocks; quantsmooth.h:1396-1401,
// 2612-2620).  Each ternary picks the index before the load, so a flagged
// edge reads nothing beyond it.
__device__ __forceinline__ void load_borders(const int* __restrict__ pix,
                                             size_t S, int b, int wb, bool t,
                                             bool d, bool l, bool r,
                                             int (&v)[96]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[64 + q] = pix[t ? q * S + b : (56 + q) * S + (b - wb)];
    v[72 + q] = pix[d ? (56 + q) * S + b : q * S + (b + wb)];
    v[80 + q] = pix[l ? (q * 8) * S + b : (q * 8 + 7) * S + (b - 1)];
    v[88 + q] = pix[r ? (q * 8 + 7) * S + b : (q * 8) * S + (b + 1)];
  }
}

// ---------------------------------------------------------------------------
// B2: one resident solver pass = border lines + k=63..1 sweep + rebalance +
// emitted pixels.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_rebalance_pix
// (_solve_tiled aux_mode="pix": _bord_from_pix, _diffs_tile, the _GROUPS
// sweep of _solve_kernel, _rebalance_tile, emit_pix).
// Bound on this card: fp32 operations -- ~9 non-FMA fp32 ops per term of
// non-zero table weight per block per pass (7,648 of the 63 x NT terms at
// NT = 144, 13,308 at NT = 242 with DIAGONALS; a zero-weight term cannot
// change the folds, but this kernel folds it all the same), against ~1 KB
// of coefficient/pixel traffic per block.
// Design: one thread per block.  The refreshed pixels and the four border
// lines live in registers (v[96]); each diff term is formed on the fly from
// two of them (term_idx, unrolled), so no diff array touches memory; the
// coefficients are indexed by the sweep step and sit in local memory.
// pix_out never aliases pix_in: neighbours' previous-pass pixels are read
// while others write.
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kThreads)
solve_rebalance_pix_kernel(const int* __restrict__ coef_in,
                           const int* __restrict__ pix_in,
                           int* __restrict__ coef_out,
                           int* __restrict__ pix_out,
                           const int* __restrict__ div,
                           const int* __restrict__ x1,
                           const int* __restrict__ qshr,
                           const float* __restrict__ tab,
                           int nblocks, int hb, int wb, int do_rebalance) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const size_t S = (size_t)nblocks;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = coef_in[k * S + b];

  // Edges come from the block's position inside its own image, so images
  // concatenated on the block axis never mix.
  int v[96];
  const int loc = b % (hb * wb);
  const int by = loc / wb, bx = loc % wb;
  load_borders(pix_in, S, b, wb, by == 0, by == hb - 1, bx == 0, bx == wb - 1,
               v);

  sweep<NT>(c, v, div, x1, qshr, tab);
  if (do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, coef_out, pix_out, S, b);
}

// ---------------------------------------------------------------------------
// The JOINT_YUV and LOW_QUALITY preambles of B3/B4 (quantsmooth.h:577-1179).
// ---------------------------------------------------------------------------

// The 10x10 halo of block b -- its pixels with the 1-pixel ring of its 8
// neighbours, edge-replicated -- from the previous pass's pixels
// (planar.blocks_halo10, pallas_solver._ring_from_pix).  The vertical ring
// goes on first, so a corner reads the neighbour's already-extended column:
// at a top-row block that is not in the left column the top-left corner is
// pixel 7 of the LEFT neighbour, at a left-column block not in the top row
// pixel 56 of the UP neighbour, and so on.  t, d, l, r flag the edges at
// which the ring replicates; each ternary picks the index before the load,
// so a flagged edge reads nothing beyond it.
__device__ __forceinline__ void load_halo(const int* __restrict__ pix,
                                          size_t S, int b, int wb, bool t,
                                          bool d, bool l, bool r,
                                          int (&h)[100]) {
  auto px = [&](int k, int blk) { return pix[(size_t)k * S + blk]; };
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int p = 0; p < 8; ++p) h[(q + 1) * 10 + p + 1] = px(q * 8 + p, b);
    h[1 + q] = t ? px(q, b) : px(56 + q, b - wb);
    h[91 + q] = d ? px(56 + q, b) : px(q, b + wb);
    h[(q + 1) * 10] = l ? px(q * 8, b) : px(q * 8 + 7, b - 1);
    h[(q + 1) * 10 + 9] = r ? px(q * 8 + 7, b) : px(q * 8, b + 1);
  }
  h[0] = l ? (t ? px(0, b) : px(56, b - wb))
           : (t ? px(7, b - 1) : px(63, b - wb - 1));
  h[9] = r ? (t ? px(7, b) : px(63, b - wb))
           : (t ? px(0, b + 1) : px(56, b - wb + 1));
  h[90] = l ? (d ? px(56, b) : px(0, b + wb))
            : (d ? px(63, b - 1) : px(7, b + wb - 1));
  h[99] = r ? (d ? px(63, b) : px(7, b + wb))
            : (d ? px(56, b + 1) : px(0, b + wb + 1));
}

// JOINT_YUV: the 3x3 (1,2,1)^2 weighted regression of the chroma halo h on
// the downsampled-luma halo g (quantsmooth.h:893-920, planar
// .joint_yuv_fblocks) -> the centred predicted block.  The statistics are
// integers below 2^24 (sAA <= 16 * 16 * 255^2), so int32 sums converted to
// float equal the reference's float sums exactly.
__device__ __forceinline__ void joint_fblock(const int (&h)[100],
                                             const int (&g)[100],
                                             float (&fb)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int sa = 0, sb = 0, saa = 0, sab = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int w = (dy == 1 ? 2 : 1) * (dx == 1 ? 2 : 1);
          const int a = g[(r + dy) * 10 + c + dx];
          const int bb = h[(r + dy) * 10 + c + dx];
          sa += w * a;
          sb += w * bb;
          saa += w * a * a;
          sab += w * a * bb;
        }
      }
      const int s_aa = saa * 16 - sa * sa;
      const int s_ab = sab * 16 - sa * sb;
      // guarded divide: no NaN reaches fminf/fmaxf (which would drop it)
      float scale = s_aa != 0 ? __fdiv_rn((float)s_ab, (float)s_aa) : 0.0f;
      scale = fminf(fmaxf(scale, -16.0f), 16.0f);
      const float centre = (float)(g[(r + 1) * 10 + c + 1] * 16 - sa);
      const float av = __fmul_rn(
          __fadd_rn(__fmul_rn(centre, scale), (float)sb), 0.0625f);
      fb[r * 8 + c] = fminf(__fsub_rn(fmaxf(av, 0.0f), 128.0f), 128.0f);
    }
  }
}

// LOW_QUALITY range (quantsmooth.h:929-938, planar.low_quality_range_p): a
// strict left fold of (float)(div * |AC|) with the product in 32-bit int,
// times 4 / sum|AC| when that sum is not 0, min 128, roundf.
__device__ __forceinline__ float lq_range(const int (&c)[64],
                                          const int* __restrict__ div) {
  float acc = 0.0f;
  u32 s = 0;
#pragma unroll
  for (int k = 1; k < 64; ++k) {
    const u32 a = c[k] < 0 ? 0u - (u32)c[k] : (u32)c[k];
    acc = __fadd_rn(acc, (float)(int)((u32)div[k] * a));
    s += a;
  }
  float rng = acc;
  if (s != 0) rng = __fmul_rn(acc, __fdiv_rn(4.0f, (float)(int)s));
  return roundf(fminf(rng, 128.0f));
}

// LOW_QUALITY 3x3 weighted gradient shrink (quantsmooth.h:1161-1175,
// planar.low_quality_fblocks): the 8 neighbours in row-major order, weight
// 2 for the orthogonal ones and fp32(2 * sqrt(fp32(0.5))) for the diagonal
// ones, fp32 folds in that order, an IEEE divide and the C (int) cast.
__device__ __forceinline__ void lq_fblock(const int (&h)[100], float rng,
                                          float (&fb)[64]) {
  const float c1 = __int_as_float(0x3FB504F3);  // planar.LQ_C1
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int a = h[(r + 1) * 10 + c + 1];
      float acc0 = 0.0f, accn = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int m = n < 4 ? n : n + 1;           // skip the centre
        const int dy = m / 3 - 1, dx = m % 3 - 1;
        const float t0 = (float)(a - h[(r + 1 + dy) * 10 + c + 1 + dx]);
        float t = fmaxf(__fsub_rn(rng, fabsf(t0)), 0.0f);  // integral
        t = __fmul_rn(t, t);                               // < 2^24: exact
        const float aw = __fmul_rn(dx != 0 && dy != 0 ? c1 : 2.0f, t);
        acc0 = __fadd_rn(acc0, __fmul_rn(__fmul_rn(t0, t), aw));
        accn = __fadd_rn(accn, __fmul_rn(aw, aw));
      }
      const float shifted = __fsub_rn((float)a, __fdiv_rn(acc0, accn));
      const int na = accn > 0.0f ? c_cast(shifted) : a;
      fb[r * 8 + c] = (float)(int)((u32)na - 128u);
    }
  }
}

// 8-point float FDCT butterfly, the scalar order of idct.h:608-628
// (pallas_solver._fdct_pass_t); the literals round to the same fp32 values
// as the JAX package's np.float32 constants.
__device__ __forceinline__ void fdct_pass(const float (&x)[8],
                                          float (&o)[8]) {
  float t0 = __fadd_rn(x[0], x[7]), t7 = __fsub_rn(x[0], x[7]);
  float t1 = __fadd_rn(x[1], x[6]), t6 = __fsub_rn(x[1], x[6]);
  float t2 = __fadd_rn(x[2], x[5]), t5 = __fsub_rn(x[2], x[5]);
  float t3 = __fadd_rn(x[3], x[4]), t4 = __fsub_rn(x[3], x[4]);
  float z1 = __fadd_rn(t0, t3), z4 = __fsub_rn(t0, t3);
  float z2 = __fadd_rn(t1, t2), z3 = __fsub_rn(t1, t2);
  o[0] = __fadd_rn(z1, z2);
  o[4] = __fsub_rn(z1, z2);
  z1 = __fmul_rn(__fadd_rn(z3, z4), 0.541196100f);
  o[2] = __fadd_rn(z1, __fmul_rn(z4, 0.765366865f));
  o[6] = __fsub_rn(z1, __fmul_rn(z3, 1.847759065f));
  z1 = __fadd_rn(t4, t7);
  z2 = __fadd_rn(t5, t6);
  z3 = __fadd_rn(t4, t6);
  z4 = __fadd_rn(t5, t7);
  const float z5 = __fmul_rn(__fadd_rn(z3, z4), 1.175875602f);
  t4 = __fmul_rn(t4, 0.298631336f);
  t5 = __fmul_rn(t5, 2.053119869f);
  t6 = __fmul_rn(t6, 3.072711026f);
  t7 = __fmul_rn(t7, 1.501321110f);
  z1 = __fmul_rn(z1, 0.899976223f);
  z2 = __fmul_rn(z2, 2.562915447f);
  z3 = __fsub_rn(__fmul_rn(z3, 1.961570560f), z5);
  z4 = __fsub_rn(__fmul_rn(z4, 0.390180644f), z5);
  o[7] = __fsub_rn(t4, __fadd_rn(z1, z3));
  o[5] = __fsub_rn(t5, __fadd_rn(z2, z4));
  o[3] = __fsub_rn(t6, __fadd_rn(z2, z3));
  o[1] = __fsub_rn(t7, __fadd_rn(z1, z4));
}

// fdct_clamp (quantsmooth.h:343-562, scalar 551-561): float FDCT of the
// predicted block (columns, then rows times 0.125 as its own rounded step),
// roundf, the C cast, then the clamp to the interval around the INCOMING
// coefficient.
__device__ __forceinline__ void fdct_clamp(const float (&fb)[64],
                                           int (&c)[64],
                                           const int* __restrict__ div,
                                           const int* __restrict__ x1,
                                           const int* __restrict__ qshr) {
  float ws[64];
#pragma unroll
  for (int col = 0; col < 8; ++col) {
    float x[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = fb[r * 8 + col];
    fdct_pass(x, o);
#pragma unroll
    for (int u = 0; u < 8; ++u) ws[u * 8 + col] = o[u];
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = ws[u * 8 + k];
    fdct_pass(x, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = u * 8 + k, dv = div[i];
      const int add = c_cast(roundf(__fmul_rn(o[k], 0.125f)));
      c[i] = interval_clamp(add, orig_coef(c[i], dv, x1[i], qshr[i]), dv);
    }
  }
}

// ---------------------------------------------------------------------------
// B3 (PRE = kJoint) and B4 (PRE = kLowQuality): one fused pass = the 10x10
// halo from the previous pass's pixels + the JOINT_YUV or LOW_QUALITY
// preamble + fdct_clamp, then (NT > 0) B2's sweep with the halo's edge
// lines as borders, the rebalance and the emitted pixels.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_fused_pix (_solve_tiled
// aux_mode="pix" with preamble "joint" / "lq": _halo_from_pix, _joint_tile
// or _lq_range_tile + _lq_shrink_tile, _fdct_clamp_tile, the sweep unless
// LOW_QUALITY, _rebalance_tile, emit_pix).
// Bound on this card: with the sweep (JOINT at q5/q6, NT 144/242) fp32
// operations, as B2 (13,308 non-zero-weight terms x 9 ops per block at
// NT 242); without it (JOINT at q1/q2, LQ at q0-q2) bytes -- ~1.0-1.4 KB
// per block (coefficients in and out, the 9-block pixel window, image2,
// pixels out) against ~5-7k fp32 ops.
// Design: one thread per block, as B2.  The halos (2 x 100 ints) and the
// predicted block do not fit in registers beside the coefficients, so
// some of them spill to local memory (L1-cached; the ptxas report says how
// much); they are dead once fdct_clamp has run, before the sweep's v[96]
// is live.  image2 [100, B] is read once per block.  pix_out never aliases
// pix_in.
// ---------------------------------------------------------------------------
constexpr int kJoint = 0;
constexpr int kLowQuality = 1;

struct FusedArgs {
  const int* coef_in;
  const int* pix_in;
  const int* image2;  // [100, B] downsampled-luma halos (kJoint only)
  int* coef_out;
  int* pix_out;       // may be NULL
  const int* div;
  const int* x1;
  const int* qshr;
  const float* tab;   // [64, NT] (NT > 0 only)
  int nblocks, hb, wb, do_rebalance;
};

template <int PRE, int NT>
__global__ void __launch_bounds__(kThreads)
solve_fused_pix_kernel(const FusedArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.nblocks) return;
  const size_t S = (size_t)a.nblocks;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * S + b];
  // edges from the block's position inside its own image, as B2
  int h[100];
  const int loc = b % (a.hb * a.wb);
  const int by = loc / a.wb, bx = loc % a.wb;
  load_halo(a.pix_in, S, b, a.wb, by == 0, by == a.hb - 1, bx == 0,
            bx == a.wb - 1, h);

  float fb[64];
  if constexpr (PRE == kJoint) {
    int g[100];
#pragma unroll
    for (int k = 0; k < 100; ++k) g[k] = a.image2[k * S + b];
    joint_fblock(h, g, fb);
  } else {
    lq_fblock(h, lq_range(c, div), fb);
  }
  fdct_clamp(fb, c, div, x1, qshr);

  if constexpr (NT > 0) {
    // the solver borders are rows/cols of the very halo
    int v[96];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[64 + q] = h[1 + q];
      v[72 + q] = h[91 + q];
      v[80 + q] = h[(q + 1) * 10];
      v[88 + q] = h[(q + 1) * 10 + 9];
    }
    sweep<NT>(c, v, div, x1, qshr, a.tab);
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, b);
}

// ---------------------------------------------------------------------------
// B5 and B6: the passes of B2 and B3/B4 on a GIVEN neighbourhood, the one
// the progress path materialises from the whole pre-iteration plane:
// border lines int32[32, .] (top, bottom, left, right, eight rows each) for
// B5, 10x10 halos int32[100, .] (row-major) for B6.  A block reads its
// neighbourhood at its own index, nbhd[j * ld + b]: no hb/wb, no edge logic.
// The inputs may be row chunks of whole planes -- n blocks, each input with
// its own row stride ld_* (the plane's block count), so a chunk after the
// first reads its own rows -- and the outputs are contiguous [64, n].  An
// output never aliases an input.  pix_out may be NULL.
// ---------------------------------------------------------------------------
struct GivenArgs {
  const int* coef_in;
  const int* nbhd;    // [32, .] borders (B5) or [100, .] halos (B6)
  const int* image2;  // [100, .] downsampled-luma halos (B6, kJoint only)
  int* coef_out;
  int* pix_out;       // may be NULL
  const int* div;
  const int* x1;
  const int* qshr;
  const float* tab;   // [64, NT] (NT > 0 only)
  int n, ld_coef, ld_nbhd, ld_image2, do_rebalance;
};

// B5: the k=63..1 sweep + rebalance (+ pixels) on given border lines.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_rebalance (_solve_tiled
// aux_mode="halo", preamble None: the [32, B] borders, the _GROUPS sweep of
// _solve_kernel, _rebalance_tile).
// Bound on this card: fp32 operations, as B2 -- 9 per term of non-zero table
// weight per block (7,648 terms at NT 144, 13,308 at NT 242) against
// (64 + 32 + 64) x 4 B of traffic per block.
// Design: B2 with its border gather replaced by 32 planar loads; the sweep,
// rebalance and emit are B2's device functions.
template <int NT>
__global__ void __launch_bounds__(kThreads)
solve_rebalance_kernel(const GivenArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.n) return;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[(size_t)k * a.ld_coef + b];
  int v[96];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[64 + j] = a.nbhd[(size_t)j * a.ld_nbhd + b];

  sweep<NT>(c, v, div, x1, qshr, a.tab);
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, (size_t)a.n, b);
}

// B6 (PRE = kJoint or kLowQuality): the preamble + fdct_clamp, the sweep
// unless NT == 0 (its borders are the halo's edge lines, as in B3), the
// rebalance and the pixels, on a given halo.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_fused (_solve_tiled
// aux_mode="halo", preamble "joint" / "lq").
// Bound on this card: with the sweep (JOINT at q5/q6) fp32 operations, as
// B3; without it (JOINT at q1/q2, LQ at q0-q2) bytes -- (64 + 100 + 100 +
// 64) x 4 B per block under JOINT, 100 ints fewer under LQ.
// Design: B3/B4 with the halo read from memory in place of load_halo; the
// preambles, fdct_clamp, sweep, rebalance and emit are theirs.
template <int PRE, int NT>
__global__ void __launch_bounds__(kThreads)
solve_fused_kernel(const GivenArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.n) return;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[(size_t)k * a.ld_coef + b];
  int h[100];
#pragma unroll
  for (int k = 0; k < 100; ++k) h[k] = a.nbhd[(size_t)k * a.ld_nbhd + b];

  float fb[64];
  if constexpr (PRE == kJoint) {
    int g[100];
#pragma unroll
    for (int k = 0; k < 100; ++k) g[k] = a.image2[(size_t)k * a.ld_image2 + b];
    joint_fblock(h, g, fb);
  } else {
    lq_fblock(h, lq_range(c, div), fb);
  }
  fdct_clamp(fb, c, div, x1, qshr);

  if constexpr (NT > 0) {
    int v[96];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[64 + q] = h[1 + q];
      v[72 + q] = h[91 + q];
      v[80 + q] = h[(q + 1) * 10];
      v[88 + q] = h[(q + 1) * 10 + 9];
    }
    sweep<NT>(c, v, div, x1, qshr, a.tab);
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, (size_t)a.n, b);
}

// ---------------------------------------------------------------------------
// B7 (PRE = kBorders, kJoint or kLowQuality): one resident pass of B2, B3 or
// B4 over blocks [b0, b1) only, with the edges given by the caller.
// Replaces jpegqs_tpu/ops/pallas_solver.py _solve_tiled(tile_range=(t0, t1))
// as the sharded resident loop calls it (parallel/sharded.py
// _sharded_resident_iters: solve_rebalance_pix / solve_fused_pix over a
// tile range of the ghost-extended shard, with the rank-selected edge masks
// of _ext_mask_parts).
// A shard's grid is its own block rows with one ghost row above and one
// below, which hold the neighbour shards' boundary pixel lines; the edges are
// not where the position says: the top edge is local row 1 on the first
// shard only (top_row, else -1), the bottom edge the row of the image's last
// real block row on the shard that holds it (bot_row, else -1; under
// pad-to-divisible sharding it may lie mid-shard, with dead rows below).
// The left and right edges are the grid's columns.  The block range lets a
// caller compute the interior rows, which read no ghost line, while the
// ghost lines are still being exchanged.  Neighbours are read from the
// whole input planes [., S]; the blocks of the range are written into the
// whole-size outputs [64, S] at their own index, so the passes of a split
// fill one output.  An output never aliases an input; pix_out may be NULL.
// Bound on this card: as B2 (kBorders), B3 (kJoint) or B4 (kLowQuality).
// Design: those kernels' device functions with the edge flags from the
// descriptor; one thread per block of the range.
// ---------------------------------------------------------------------------
constexpr int kBorders = 2;

struct RangeArgs {
  const int* coef_in;
  const int* pix_in;
  const int* image2;  // [100, S] downsampled-luma halos (kJoint only)
  int* coef_out;
  int* pix_out;       // may be NULL
  const int* div;
  const int* x1;
  const int* qshr;
  const float* tab;   // [64, NT] (NT > 0 only)
  int nblocks, wb, b0, b1, top_row, bot_row, do_rebalance;
};

template <int PRE, int NT>
__global__ void __launch_bounds__(kThreads)
solve_range_pix_kernel(const RangeArgs a) {
  const int b = a.b0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.b1) return;
  const size_t S = (size_t)a.nblocks;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;
  const int by = b / a.wb, bx = b % a.wb;
  const bool t = by == a.top_row, d = by == a.bot_row;
  const bool l = bx == 0, r = bx == a.wb - 1;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * S + b];

  if constexpr (PRE == kBorders) {
    int v[96];
    load_borders(a.pix_in, S, b, a.wb, t, d, l, r, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab);
  } else {
    int h[100];
    load_halo(a.pix_in, S, b, a.wb, t, d, l, r, h);
    float fb[64];
    if constexpr (PRE == kJoint) {
      int g[100];
#pragma unroll
      for (int k = 0; k < 100; ++k) g[k] = a.image2[k * S + b];
      joint_fblock(h, g, fb);
    } else {
      lq_fblock(h, lq_range(c, div), fb);
    }
    fdct_clamp(fb, c, div, x1, qshr);
    if constexpr (NT > 0) {
      int v[96];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[64 + q] = h[1 + q];
        v[72 + q] = h[91 + q];
        v[80 + q] = h[(q + 1) * 10];
        v[88 + q] = h[(q + 1) * 10 + 9];
      }
      sweep<NT>(c, v, div, x1, qshr, a.tab);
    }
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, b);
}

// ---------------------------------------------------------------------------
// T3: the card's fp32 peak probe.
// Replaces tools/vpu_peak.py peak_kernel: NCH independent chains
// a = a * k + b per thread, n_steps deep, the multiply and the add separate
// (never an FMA: the solver's fold never fuses), then a left fold of the
// chains -- 2 fp32 operations per step per chain.  Launched over enough
// threads to fill every SM; its time gives the rate of separate fp32
// operations this card sustains.  The constants round as the TPU kernel's
// np.float32 ones do (a double expression rounded once to float).
// ---------------------------------------------------------------------------
template <int NCH>
__global__ void __launch_bounds__(kThreads)
peak_kernel(const float* __restrict__ x, float* __restrict__ out,
            int n_steps, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = x[i];
  const float k = 0.99999f;
  float a[NCH], bb[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    a[c] = __fmul_rn(x0, (float)(1.0 + 0.001 * c));
    bb[c] = __fmul_rn(x0, 0.9999f);
  }
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) a[c] = __fadd_rn(__fmul_rn(a[c], k), bb[c]);
  }
  float acc = a[0];
#pragma unroll
  for (int c = 1; c < NCH; ++c) acc = __fadd_rn(acc, a[c]);
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// Canaries: replace the FMA-contraction and fold-order probes of
// tests/test_canary.py (_mosaic_muladd, _mosaic_fold) for this build.
// Written with plain * + / on purpose: they check what the compiler flags
// make of ordinary expressions.
// ---------------------------------------------------------------------------
__global__ void muladd_kernel(const float* a, const float* b, const float* c,
                              float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] * b[i] + c[i];
}

__global__ void fold_kernel(const float* terms, float* out, int nterms,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int j = 0; j < nterms; ++j) acc = acc + terms[(size_t)j * n + i];
  out[i] = acc;
}

__global__ void divide_kernel(const float* a, const float* b, float* out,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] / b[i];
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int jq_idct_pix(const int* coef, int* pix, int nblocks, void* stream) {
  if (nblocks > 0)
    idct_pix_kernel<<<blocks_for(nblocks), kThreads, 0,
                      (cudaStream_t)stream>>>(coef, pix, nblocks);
  return (int)cudaGetLastError();
}

// pix_out may be NULL (the last pass emits no pixels).  nt is 144 or 242.
int jq_solve_rebalance_pix(const int* coef_in, const int* pix_in,
                           int* coef_out, int* pix_out, const int* div,
                           const int* x1, const int* qshr, const float* tab,
                           int nt, int nblocks, int hb, int wb,
                           int do_rebalance, void* stream) {
  if (nt != 144 && nt != 242) return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const dim3 grid(blocks_for(nblocks)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (nt == 144)
      solve_rebalance_pix_kernel<144><<<grid, block, 0, s>>>(
          coef_in, pix_in, coef_out, pix_out, div, x1, qshr, tab, nblocks,
          hb, wb, do_rebalance);
    else
      solve_rebalance_pix_kernel<242><<<grid, block, 0, s>>>(
          coef_in, pix_in, coef_out, pix_out, div, x1, qshr, tab, nblocks,
          hb, wb, do_rebalance);
  }
  return (int)cudaGetLastError();
}

// B3 when image2 is given (nt 0: no sweep under LOW_QUALITY, or 144/242),
// B4 when it is NULL (nt must be 0: the LOW_QUALITY preamble never sweeps).
// pix_out may be NULL.
int jq_solve_fused_pix(const int* coef_in, const int* pix_in,
                       const int* image2, int* coef_out, int* pix_out,
                       const int* div, const int* x1, const int* qshr,
                       const float* tab, int nt, int nblocks, int hb, int wb,
                       int do_rebalance, void* stream) {
  if (nt != 0 && nt != 144 && nt != 242) return (int)cudaErrorInvalidValue;
  if (image2 == nullptr && nt != 0) return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const FusedArgs a{coef_in, pix_in,  image2, coef_out, pix_out,
                      div,     x1,      qshr,   tab,      nblocks,
                      hb,      wb,      do_rebalance};
    const dim3 grid(blocks_for(nblocks)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (image2 == nullptr)
      solve_fused_pix_kernel<kLowQuality, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 0)
      solve_fused_pix_kernel<kJoint, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 144)
      solve_fused_pix_kernel<kJoint, 144><<<grid, block, 0, s>>>(a);
    else
      solve_fused_pix_kernel<kJoint, 242><<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// B5: nt is 144 or 242.  ld_* are the row strides of the inputs (elements);
// the outputs are contiguous [64, n].  pix_out may be NULL.
int jq_solve_rebalance(const int* coef_in, const int* borders, int* coef_out,
                       int* pix_out, const int* div, const int* x1,
                       const int* qshr, const float* tab, int nt, int n,
                       int ld_coef, int ld_borders, int do_rebalance,
                       void* stream) {
  if (nt != 144 && nt != 242) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const GivenArgs a{coef_in, borders, nullptr, coef_out, pix_out,
                      div,     x1,      qshr,    tab,      n,
                      ld_coef, ld_borders, 0,    do_rebalance};
    const dim3 grid(blocks_for(n)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (nt == 144)
      solve_rebalance_kernel<144><<<grid, block, 0, s>>>(a);
    else
      solve_rebalance_kernel<242><<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// B6 with the JOINT_YUV preamble when image2 is given (nt 0, 144 or 242),
// with the LOW_QUALITY one when it is NULL (nt must be 0).  As B5 otherwise.
int jq_solve_fused(const int* coef_in, const int* halo, const int* image2,
                   int* coef_out, int* pix_out, const int* div, const int* x1,
                   const int* qshr, const float* tab, int nt, int n,
                   int ld_coef, int ld_halo, int ld_image2, int do_rebalance,
                   void* stream) {
  if (nt != 0 && nt != 144 && nt != 242) return (int)cudaErrorInvalidValue;
  if (image2 == nullptr && nt != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const GivenArgs a{coef_in, halo,    image2,    coef_out, pix_out,
                      div,     x1,      qshr,      tab,      n,
                      ld_coef, ld_halo, ld_image2, do_rebalance};
    const dim3 grid(blocks_for(n)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (image2 == nullptr)
      solve_fused_kernel<kLowQuality, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 0)
      solve_fused_kernel<kJoint, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 144)
      solve_fused_kernel<kJoint, 144><<<grid, block, 0, s>>>(a);
    else
      solve_fused_kernel<kJoint, 242><<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// B7: pre is kBorders (nt 144 or 242), kJoint (image2 given; nt 0, 144 or
// 242) or kLowQuality (nt 0).  Blocks [b0, b1) of the nblocks-block planes,
// wb blocks a row; top_row / bot_row the rows whose top / bottom edge
// replicates (-1: none).  pix_out may be NULL.
int jq_solve_range_pix(const int* coef_in, const int* pix_in,
                       const int* image2, int* coef_out, int* pix_out,
                       const int* div, const int* x1, const int* qshr,
                       const float* tab, int pre, int nt, int nblocks, int wb,
                       int b0, int b1, int top_row, int bot_row,
                       int do_rebalance, void* stream) {
  const bool swept = nt == 144 || nt == 242;
  const bool ok = pre == kBorders  ? swept
                  : pre == kJoint  ? image2 != nullptr && (nt == 0 || swept)
                                   : pre == kLowQuality && nt == 0;
  if (!ok || wb < 1 || b0 < 0 || b1 > nblocks)
    return (int)cudaErrorInvalidValue;
  if (b1 > b0) {
    const RangeArgs a{coef_in, pix_in, image2,  coef_out, pix_out, div,
                      x1,      qshr,   tab,     nblocks,  wb,      b0,
                      b1,      top_row, bot_row, do_rebalance};
    const dim3 grid(blocks_for(b1 - b0)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (pre == kBorders && nt == 144)
      solve_range_pix_kernel<kBorders, 144><<<grid, block, 0, s>>>(a);
    else if (pre == kBorders)
      solve_range_pix_kernel<kBorders, 242><<<grid, block, 0, s>>>(a);
    else if (pre == kLowQuality)
      solve_range_pix_kernel<kLowQuality, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 0)
      solve_range_pix_kernel<kJoint, 0><<<grid, block, 0, s>>>(a);
    else if (nt == 144)
      solve_range_pix_kernel<kJoint, 144><<<grid, block, 0, s>>>(a);
    else
      solve_range_pix_kernel<kJoint, 242><<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// T3: nch is 1, 4 or 16; one thread per element of x / out (n of them).
int jq_peak(const float* x, float* out, int nch, int n_steps, int n,
            void* stream) {
  if (nch != 1 && nch != 4 && nch != 16) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const dim3 grid(blocks_for(n)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (nch == 1)
      peak_kernel<1><<<grid, block, 0, s>>>(x, out, n_steps, n);
    else if (nch == 4)
      peak_kernel<4><<<grid, block, 0, s>>>(x, out, n_steps, n);
    else
      peak_kernel<16><<<grid, block, 0, s>>>(x, out, n_steps, n);
  }
  return (int)cudaGetLastError();
}

int jq_canary_muladd(const float* a, const float* b, const float* c,
                     float* out, int n, void* stream) {
  muladd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, out, n);
  return (int)cudaGetLastError();
}

int jq_canary_fold(const float* terms, float* out, int nterms, int n,
                   void* stream) {
  fold_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      terms, out, nterms, n);
  return (int)cudaGetLastError();
}

int jq_canary_divide(const float* a, const float* b, float* out, int n,
                     void* stream) {
  divide_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
