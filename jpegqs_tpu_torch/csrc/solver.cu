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
// The solver tables are f32[64, pitch]: a row holds the NT weights of one
// coefficient, padded with zeros to a multiple of four (pitch), so a row
// reads as float4.
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

#include <atomic>

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
// statically only, so with the caller's loops unrolled a register array
// stays in registers; c may also be a thread's column of shared memory, p
// an fp32 array (the pixels 0..255 are exact in fp32).
template <class C, class P>
__device__ __forceinline__ void idct_block(const C& c, P& p) {
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
// The pieces of a solver pass that B2-B7 share.
// ---------------------------------------------------------------------------

// A thread's column of a shared-memory array laid out [row][kThreads]:
// element k at p[k * kThreads], so the 32 threads of a warp touch 32
// neighbouring words (or half-words) and no two of them a bank.
template <typename T>
struct SmemCol {
  T* p;
  __device__ __forceinline__ T& operator[](int k) const {
    return p[k * kThreads];
  }
};

// Keeps the compiler from moving this thread's shared-memory accesses
// across the point where a region changes its element type (B3 overlays
// its u16 halos with int32 coefficients).
__device__ __forceinline__ void smem_retype() {
  asm volatile("" ::: "memory");
}

// Terms [J0, J1) of the a2/a3 folds of one sweep step (J0 a multiple of
// four; tr the step's table row, padded with zeros to a multiple of four
// columns).  The weights are read four at a time, one uniform float4 load;
// each diff is one fp32 subtract of two pixel values, integers 0..255, so
// it equals the int subtract and its conversion; every product and sum is
// __fmul_rn/__fadd_rn in the scalar term order.
template <int J0, int J1>
__device__ __forceinline__ void fold_terms(const float (&v)[96],
                                           const float* __restrict__ tr,
                                           float rng, float& a2, float& a3) {
#pragma unroll
  for (int j4 = J0; j4 < J1; j4 += 4) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(tr + j4));
    const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j4 + q >= J1) break;  // the row's zero pad is never folded
      int ia, ib;
      term_idx(j4 + q, ia, ib);
      const float d = __fsub_rn(v[ia], v[ib]);
      float t = fmaxf(__fsub_rn(rng, fabsf(d)), 0.0f);  // integral: exact
      t = __fmul_rn(t, t);
      const float u = __fmul_rn(d, t);
      const float w = __fmul_rn(wq[q], t);
      a2 = __fadd_rn(a2, __fmul_rn(u, w));
      a3 = __fadd_rn(a3, __fmul_rn(w, w));
    }
  }
}

// The k = 63..1 sweep (quantsmooth.h:1403-1565) on one block: c the
// coefficients, indexed by the step (a thread's column of shared memory or
// a local array); v[64..95] the four border lines; v[0..63] receive the
// refreshed pixels.  The pixel state is fp32: the pixels are integers
// 0..255, exact in fp32, converted once at each refresh and not at each
// term.  tab is f32[64, pitch], a step reading row i.
// A step folds its terms in the scalar order but skips the two classes
// whose weights are all zero, as the scalar code does: the 56 horizontal
// diffs when i & 7 == 0 and the 56 vertical ones when i <= 7.  A zero
// weight adds +-0 to both folds; they start at +0 and so never hold -0,
// which +-0 leaves unchanged: the skip is exact.  The branches depend on
// the step only, the same in every thread.
// A thread refreshes (IDCT) only at a zigzag refresh point and only when
// one of its coefficients changed, as the C reference does; the TPU
// kernel's masked full-tile refresh gives the same values.
template <int NT, class C>
__device__ __forceinline__ void sweep(C& c, float (&v)[96],
                                      const int* __restrict__ div,
                                      const int* __restrict__ x1,
                                      const int* __restrict__ qshr,
                                      const float* __restrict__ tab,
                                      int pitch) {
  static_assert(NT == 144 || NT == 242, "NT is 144 or 242");
  bool need = true;
  for (int k = 0; k < 63; ++k) {
    const int i = c_iseq[k];
    if (c_refresh[k] && need) {
      idct_block(c, v);
      need = false;
    }
    const float rng = (float)(div[i] * 2);
    const float* tr = tab + i * pitch;
    float a2 = 0.0f, a3 = 0.0f;
    if (i & 7) fold_terms<0, 56>(v, tr, rng, a2, a3);     // horizontal
    fold_terms<56, 88>(v, tr, rng, a2, a3);               // border
    if (i > 7) fold_terms<88, 144>(v, tr, rng, a2, a3);   // vertical
    if constexpr (NT > 144) fold_terms<144, NT>(v, tr, rng, a2, a3);
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
template <class C>
__device__ __forceinline__ void rebalance(C& c, const int* __restrict__ div,
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
template <class C>
__device__ __forceinline__ void emit_block(const C& c,
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
                                             float (&v)[96]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[64 + q] = pix[t ? q * S + b : (56 + q) * S + (b - wb)];
    v[72 + q] = pix[d ? (56 + q) * S + b : q * S + (b + wb)];
    v[80 + q] = pix[l ? (q * 8) * S + b : (q * 8 + 7) * S + (b - 1)];
    v[88 + q] = pix[r ? (q * 8 + 7) * S + b : (q * 8) * S + (b + 1)];
  }
}

// v[64..95] from the edge lines of a 10x10 halo: the fused passes' solver
// borders are rows/columns of the very halo.
template <class H>
__device__ __forceinline__ void halo_borders(const H& h, float (&v)[96]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[64 + q] = h[1 + q];
    v[72 + q] = h[91 + q];
    v[80 + q] = h[(q + 1) * 10];
    v[88 + q] = h[(q + 1) * 10 + 9];
  }
}

// ---------------------------------------------------------------------------
// B2: one resident solver pass = border lines + k=63..1 sweep + rebalance +
// emitted pixels.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_rebalance_pix
// (_solve_tiled aux_mode="pix": _bord_from_pix, _diffs_tile, the _GROUPS
// sweep of _solve_kernel, _rebalance_tile, emit_pix).
// Bound on this card: fp32 operations -- 9 non-FMA fp32 ops per term of
// non-zero table weight per block per pass (7,648 of the 63 x NT terms at
// NT = 144, 13,308 at NT = 242 with DIAGONALS), against ~1 KB of
// coefficient/pixel traffic per block.  An SM sub-partition issues one warp
// instruction a clock, so the bound is the issue slots of those 9; whatever
// else a term issues, and warps waiting on loads, keep the kernel from it.
// Design: one thread per block, 128 threads a CTA, at most 128 registers,
// so 4 CTAs (16 warps) share an SM.  Per term the sweep issues the 9
// operations, one fp32 subtract for the diff and a quarter of a float4
// table load: the pixel state is fp32 (v[96], the refreshed pixels and the
// border lines), converted at the refresh points, not per term; the two
// all-zero weight classes are skipped on the step; the table is read four
// weights a load.  The coefficients, indexed by the step, live in the
// thread's column of shared memory (32 KB a CTA), not in local memory.
// What remains between the kernel and its bound is latency: a term is a
// chain of dependent fp32 operations, v[96] leaves few registers to overlap
// terms, and 16 warps an SM hide only part of the wait.  At the 128-register
// cap ptxas spills 8 bytes (the block index, one border value).  Folding two
// steps of a refresh group per pass, border lines in shared memory and a
// 168-register build were measured and did not pay (PERF.md, Findings).
// pix_out never aliases pix_in: neighbours' previous-pass pixels are read
// while others write.
// ---------------------------------------------------------------------------
template <int NT>
__global__ void __launch_bounds__(kThreads, 4)
solve_rebalance_pix_kernel(const int* __restrict__ coef_in,
                           const int* __restrict__ pix_in,
                           int* __restrict__ coef_out,
                           int* __restrict__ pix_out,
                           const int* __restrict__ div,
                           const int* __restrict__ x1,
                           const int* __restrict__ qshr,
                           const float* __restrict__ tab, int pitch,
                           int nblocks, int hb, int wb, int do_rebalance) {
  __shared__ int coef_smem[64 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const size_t S = (size_t)nblocks;

  const SmemCol<int> c{coef_smem + threadIdx.x};
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = coef_in[k * S + b];

  // Edges come from the block's position inside its own image, so images
  // concatenated on the block axis never mix.
  float v[96];
  const int loc = b % (hb * wb);
  const int by = loc / wb, bx = loc % wb;
  load_borders(pix_in, S, b, wb, by == 0, by == hb - 1, bx == 0, bx == wb - 1,
               v);

  sweep<NT>(c, v, div, x1, qshr, tab, pitch);
  if (do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, coef_out, pix_out, S, b);
}

// ---------------------------------------------------------------------------
// The JOINT_YUV and LOW_QUALITY preambles of B3/B4 (quantsmooth.h:577-1179).
// ---------------------------------------------------------------------------

// The 10x10 halo of block b -- its pixels with the 1-pixel ring of its 8
// neighbours, edge-replicated -- from the previous pass's pixels
// (planar.blocks_halo10, pallas_solver._ring_from_pix), into h[0..99]
// (registers, or staged in shared memory).  The vertical ring goes on
// first, so a corner reads the neighbour's already-extended column:
// at a top-row block that is not in the left column the top-left corner is
// pixel 7 of the LEFT neighbour, at a left-column block not in the top row
// pixel 56 of the UP neighbour, and so on.  t, d, l, r flag the edges at
// which the ring replicates; each ternary picks the index before the load,
// so a flagged edge reads nothing beyond it.
template <class H>
__device__ __forceinline__ void load_halo(const int* __restrict__ pix,
                                          size_t S, int b, int wb, bool t,
                                          bool d, bool l, bool r, H& h) {
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
// float equal the reference's float sums exactly.  The 3x3 windows slide
// along each row, so each halo value of the row's three lines is read once
// per output row.
template <class H, class G>
__device__ __forceinline__ void joint_fblock(const H& h, const G& g,
                                             float (&fb)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int wa[3][3], wc[3][3];  // [dy][dx] windows of g (luma), h (chroma)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      wa[dy][1] = g[(r + dy) * 10];
      wa[dy][2] = g[(r + dy) * 10 + 1];
      wc[dy][1] = h[(r + dy) * 10];
      wc[dy][2] = h[(r + dy) * 10 + 1];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        wa[dy][0] = wa[dy][1];
        wa[dy][1] = wa[dy][2];
        wa[dy][2] = g[(r + dy) * 10 + c + 2];
        wc[dy][0] = wc[dy][1];
        wc[dy][1] = wc[dy][2];
        wc[dy][2] = h[(r + dy) * 10 + c + 2];
      }
      int sa = 0, sb = 0, saa = 0, sab = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int w = (dy == 1 ? 2 : 1) * (dx == 1 ? 2 : 1);
          const int a = wa[dy][dx];
          const int bb = wc[dy][dx];
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
      const float centre = (float)(wa[1][1] * 16 - sa);
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
template <class C>
__device__ __forceinline__ void fdct_clamp(const float (&fb)[64], C& c,
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
// B3 and B4: one fused pass = the 10x10 halo from the previous pass's pixels
// + the JOINT_YUV (B3) or LOW_QUALITY (B4) preamble + fdct_clamp, then (B3
// at NT > 0) the sweep with the halo's edge lines as borders, the rebalance
// and the emitted pixels.
// Replace jpegqs_tpu/ops/pallas_solver.py solve_fused_pix (_solve_tiled
// aux_mode="pix" with preamble "joint" / "lq": _halo_from_pix, _joint_tile
// or _lq_range_tile + _lq_shrink_tile, _fdct_clamp_tile, the sweep unless
// LOW_QUALITY, _rebalance_tile, emit_pix).
// ---------------------------------------------------------------------------
struct FusedArgs {
  const int* coef_in;
  const int* pix_in;
  const int* image2;  // [100, B] downsampled-luma halos (B3 only)
  int* coef_out;
  int* pix_out;       // may be NULL
  const int* div;
  const int* x1;
  const int* qshr;
  const float* tab;   // [64, pitch] (B3 with NT > 0 only)
  int pitch, nblocks, hb, wb, do_rebalance;
};

// Slot of element k (row-major) of a block's 10x10 halo as B3 stages it in
// shared memory: first the four edge lines the sweep takes as its borders
// (top, bottom, left, right, eight each: the order of v[64..95]), then the
// four corners, then the 8x8 interior.  k is a compile-time index wherever
// the halo is read or written, so the map costs nothing.
__device__ constexpr int halo_slot(int k) {
  const int r = k / 10, c = k % 10;
  if (r == 0 && c >= 1 && c <= 8) return c - 1;
  if (r == 9 && c >= 1 && c <= 8) return 7 + c;
  if (c == 0 && r >= 1 && r <= 8) return 15 + r;
  if (c == 9 && r >= 1 && r <= 8) return 23 + r;
  if (r == 0) return c == 0 ? 32 : 33;
  if (r == 9) return c == 0 ? 34 : 35;
  return 36 + (r - 1) * 8 + (c - 1);
}

// B3's shared memory per CTA: kJointWords 32-bit words a thread, word w of
// thread t at w * kThreads + t, so the 32 threads of a warp touch 32
// neighbouring words and no two of them a bank.  A word holds two 16-bit
// slots, slot s in word s / 2 (the low half when s is even): the staged
// halo in slots [0, 100), image2 in slots [100, 200).  After the preamble
// only the halo's edge lines (slots 0..31, words 0..15) are read again, so
// the coefficients, int32, overlay words [kJointCoefWord, kJointWords).
// Both views put a thread's data in its own words only: no thread reads or
// writes another's bytes, and no barrier is needed.
constexpr int kJointWords = 100;
constexpr int kJointCoefWord = kJointWords - 64;
constexpr int kJointSmem = kJointWords * kThreads * 4;  // 51,200 bytes

// Thread t's slot s, as an index of 16-bit values, and its coefficient k,
// as an index of 32-bit words, in B3's shared memory.
__host__ __device__ constexpr int joint_slot(int s, int t) {
  return 2 * ((s >> 1) * kThreads + t) + (s & 1);
}
__host__ __device__ constexpr int joint_coef(int k, int t) {
  return (kJointCoefWord + k) * kThreads + t;
}

// The layout, checked for every thread, slot and coefficient when this
// file compiles: each view gives a thread only words w with
// w % kThreads == t, inside the CTA's kJointSmem bytes; no coefficient
// shares a word with the halo's edge lines; and an index is the thread's
// base plus a part that does not depend on the thread, which is how
// SlotCol and SmemCol compute it.
constexpr bool joint_layout_ok() {
  for (int t = 0; t < kThreads; ++t) {
    for (int s = 0; s < 200; ++s) {
      const int w = joint_slot(s, t) / 2;
      if (w % kThreads != t || w >= kJointWords * kThreads ||
          joint_slot(s, t) != joint_slot(0, t) + joint_slot(s, 0))
        return false;
    }
    for (int k = 0; k < 64; ++k) {
      const int w = joint_coef(k, t);
      if (w % kThreads != t || w >= kJointWords * kThreads ||
          w <= joint_slot(31, t) / 2 || w != joint_coef(0, t) + k * kThreads)
        return false;
    }
  }
  return true;
}
static_assert(joint_layout_ok(),
              "B3's shared-memory views must keep each thread in its words");

// A thread's 16-bit slots of B3's shared memory, slot s at p[joint_slot(s,
// 0)] with p the CTA's shared memory plus joint_slot(0, t).  volatile: each
// read is a load where it stands, so the 3x3 windows of joint_fblock hold
// only their own values in registers.
struct SlotCol {
  volatile unsigned short* p;
  __device__ __forceinline__ volatile unsigned short& operator[](int s) const {
    return p[joint_slot(s, 0)];
  }
};

// A thread's staged halo, element k (row-major) in slot halo_slot(k).
struct HaloSmem {
  SlotCol s;
  __device__ __forceinline__ volatile unsigned short& operator[](int k) const {
    return s[halo_slot(k)];
  }
};

// A thread's staged image2, element k in slot 100 + k.
struct Image2Smem {
  SlotCol s;
  __device__ __forceinline__ volatile unsigned short& operator[](int k) const {
    return s[100 + k];
  }
};

// B3 (JOINT_YUV preamble; NT 0: no sweep, q1/q2 chroma; NT 144/242: q5/q6).
// Bound on this card: with the sweep fp32 operations, as B2 (13,308
// non-zero-weight terms x 9 ops per block at NT 242) plus the preamble's
// 1,664; without it bytes -- ~1.4 KB per block (coefficients in and out,
// the 9-block pixel window, image2, pixels out) against ~1.7k fp32 ops.
// Design: one thread per block, 128 threads a CTA, at most 128 registers and
// 51,200 B of shared memory, so 4 CTAs (16 warps) share an SM and the 12 MP
// 4:2:0 photo's 47,000-block chroma plane (368 CTAs) runs in one wave of
// 528 CTA slots.  The 10x10 pixel halo and the image2 halo are staged in
// shared memory as 16-bit values, each thread in its own words (no bank
// conflicts, no barrier), and not held in registers: the preamble holds
// only the predicted block (64 registers) and two sliding 3x3 windows.
// joint_fblock reads its 3x3 windows from there; the coefficients then
// overlay the dead halo interior and image2, and the sweep is B2's, its
// borders read from the staged halo's edge lines.  pix_out never aliases
// pix_in.
template <int NT>
__global__ void __launch_bounds__(kThreads, 4)
solve_joint_pix_kernel(const FusedArgs a) {
  extern __shared__ int joint_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.nblocks) return;
  const size_t S = (size_t)a.nblocks;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  const SlotCol col{reinterpret_cast<volatile unsigned short*>(joint_smem) +
                    joint_slot(0, threadIdx.x)};
  const HaloSmem h{col};
  const Image2Smem g{col};
  // edges from the block's position inside its own image, as B2
  const int loc = b % (a.hb * a.wb);
  const int by = loc / a.wb, bx = loc % a.wb;
  // image2 first: in this order ptxas fits NT 0 in 128 registers
  // without a spill (PERF.md, Findings)
#pragma unroll
  for (int k = 0; k < 100; ++k) g[k] = a.image2[k * S + b];
  load_halo(a.pix_in, S, b, a.wb, by == 0, by == a.hb - 1, bx == 0,
            bx == a.wb - 1, h);

  float fb[64];
  joint_fblock(h, g, fb);
  smem_retype();
  const SmemCol<int> c{joint_smem + joint_coef(0, threadIdx.x)};
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * S + b];
  fdct_clamp(fb, c, div, x1, qshr);

  if constexpr (NT > 0) {
    float v[96];
    halo_borders(h, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, b);
}

// B4 (LOW_QUALITY preamble; never sweeps).
// Bound on this card: bytes -- ~1.0 KB per block (coefficients in and out,
// the 9-block pixel window, pixels out) against ~6.9k fp32 ops.
// Design: one thread per block; the halo and the predicted block are held
// in registers beside the coefficients, and some of them spill to local
// memory (L1-cached; the ptxas report says how much).
__global__ void __launch_bounds__(kThreads)
solve_lq_pix_kernel(const FusedArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.nblocks) return;
  const size_t S = (size_t)a.nblocks;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * S + b];
  int h[100];
  const int loc = b % (a.hb * a.wb);
  const int by = loc / a.wb, bx = loc % a.wb;
  load_halo(a.pix_in, S, b, a.wb, by == 0, by == a.hb - 1, bx == 0,
            bx == a.wb - 1, h);
  float fb[64];
  lq_fblock(h, lq_range(c, div), fb);
  fdct_clamp(fb, c, div, x1, qshr);
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
  const float* tab;   // [64, pitch] (NT > 0 only)
  int pitch, n, ld_coef, ld_nbhd, ld_image2, do_rebalance;
};

constexpr int kJoint = 0;
constexpr int kLowQuality = 1;

// B5: the k=63..1 sweep + rebalance (+ pixels) on given border lines.
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_rebalance (_solve_tiled
// aux_mode="halo", preamble None: the [32, B] borders, the _GROUPS sweep of
// _solve_kernel, _rebalance_tile).
// Bound on this card: fp32 operations, as B2 -- 9 per term of non-zero table
// weight per block (7,648 terms at NT 144, 13,308 at NT 242) against
// (64 + 32 + 64) x 4 B of traffic per block.
// Design: one thread per block with its coefficients in a local array (not
// B2's shared memory); the border lines are 32 planar loads; the sweep,
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
  float v[96];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[64 + j] = a.nbhd[(size_t)j * a.ld_nbhd + b];

  sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
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
// Design: one thread per block, the halos and coefficients in registers and
// local arrays (not B3's shared-memory staging); the preambles,
// fdct_clamp, sweep, rebalance and emit are B3/B4's device functions.
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
    float v[96];
    halo_borders(h, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
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
// Design: the device functions of B2-B4 with the edge flags from the
// descriptor; one thread per block of the range, its halos and
// coefficients in registers and local arrays (not B2/B3's shared memory).
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
  const float* tab;   // [64, pitch] (NT > 0 only)
  int pitch, nblocks, wb, b0, b1, top_row, bot_row, do_rebalance;
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
    float v[96];
    load_borders(a.pix_in, S, b, a.wb, t, d, l, r, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
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
      float v[96];
      halo_borders(h, v);
      sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
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

// A table of NT used columns (0: no sweep) in rows of pitch floats: a
// multiple of four, so every row starts 16-byte aligned.
inline bool pitch_ok(int nt, int pitch) {
  return nt == 0 || (pitch >= nt && pitch % 4 == 0);
}

// B3 takes kJointSmem bytes of dynamic shared memory, above the 48 KB a
// launch gets without asking: granted once per device and instantiation
// (a bit per device; granting it twice is harmless).
template <int NT>
cudaError_t allow_joint_smem() {
  static std::atomic<unsigned long long> granted{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (granted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(solve_joint_pix_kernel<NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kJointSmem);
  if (e == cudaSuccess) granted.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int NT>
cudaError_t launch_joint(const FusedArgs& a, dim3 grid, cudaStream_t s) {
  const cudaError_t e = allow_joint_smem<NT>();
  if (e != cudaSuccess) return e;
  solve_joint_pix_kernel<NT><<<grid, kThreads, kJointSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int jq_idct_pix(const int* coef, int* pix, int nblocks, void* stream) {
  if (nblocks > 0)
    idct_pix_kernel<<<blocks_for(nblocks), kThreads, 0,
                      (cudaStream_t)stream>>>(coef, pix, nblocks);
  return (int)cudaGetLastError();
}

// pix_out may be NULL (the last pass emits no pixels).  nt is 144 or 242,
// tab f32[64, pitch].
int jq_solve_rebalance_pix(const int* coef_in, const int* pix_in,
                           int* coef_out, int* pix_out, const int* div,
                           const int* x1, const int* qshr, const float* tab,
                           int nt, int pitch, int nblocks, int hb, int wb,
                           int do_rebalance, void* stream) {
  if ((nt != 144 && nt != 242) || !pitch_ok(nt, pitch))
    return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const dim3 grid(blocks_for(nblocks)), block(kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (nt == 144)
      solve_rebalance_pix_kernel<144><<<grid, block, 0, s>>>(
          coef_in, pix_in, coef_out, pix_out, div, x1, qshr, tab, pitch,
          nblocks, hb, wb, do_rebalance);
    else
      solve_rebalance_pix_kernel<242><<<grid, block, 0, s>>>(
          coef_in, pix_in, coef_out, pix_out, div, x1, qshr, tab, pitch,
          nblocks, hb, wb, do_rebalance);
  }
  return (int)cudaGetLastError();
}

// B3 when image2 is given (nt 0: no sweep under LOW_QUALITY, or 144/242),
// B4 when it is NULL (nt must be 0: the LOW_QUALITY preamble never sweeps).
// tab f32[64, pitch] when nt > 0.  pix_out may be NULL.
int jq_solve_fused_pix(const int* coef_in, const int* pix_in,
                       const int* image2, int* coef_out, int* pix_out,
                       const int* div, const int* x1, const int* qshr,
                       const float* tab, int nt, int pitch, int nblocks,
                       int hb, int wb, int do_rebalance, void* stream) {
  if ((nt != 0 && nt != 144 && nt != 242) || !pitch_ok(nt, pitch))
    return (int)cudaErrorInvalidValue;
  if (image2 == nullptr && nt != 0) return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const FusedArgs a{coef_in, pix_in, image2,  coef_out, pix_out,
                      div,     x1,     qshr,    tab,      pitch,
                      nblocks, hb,     wb,      do_rebalance};
    const dim3 grid(blocks_for(nblocks));
    cudaStream_t s = (cudaStream_t)stream;
    if (image2 == nullptr)
      solve_lq_pix_kernel<<<grid, kThreads, 0, s>>>(a);
    else if (nt == 0)
      return (int)launch_joint<0>(a, grid, s);
    else if (nt == 144)
      return (int)launch_joint<144>(a, grid, s);
    else
      return (int)launch_joint<242>(a, grid, s);
  }
  return (int)cudaGetLastError();
}

// B5: nt is 144 or 242, tab f32[64, pitch].  ld_* are the row strides of
// the inputs (elements); the outputs are contiguous [64, n].  pix_out may
// be NULL.
int jq_solve_rebalance(const int* coef_in, const int* borders, int* coef_out,
                       int* pix_out, const int* div, const int* x1,
                       const int* qshr, const float* tab, int nt, int pitch,
                       int n, int ld_coef, int ld_borders, int do_rebalance,
                       void* stream) {
  if ((nt != 144 && nt != 242) || !pitch_ok(nt, pitch))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const GivenArgs a{coef_in, borders,    nullptr, coef_out, pix_out,
                      div,     x1,         qshr,    tab,      pitch,
                      n,       ld_coef,    ld_borders, 0,     do_rebalance};
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
                   const int* qshr, const float* tab, int nt, int pitch, int n,
                   int ld_coef, int ld_halo, int ld_image2, int do_rebalance,
                   void* stream) {
  if ((nt != 0 && nt != 144 && nt != 242) || !pitch_ok(nt, pitch))
    return (int)cudaErrorInvalidValue;
  if (image2 == nullptr && nt != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const GivenArgs a{coef_in, halo,    image2,    coef_out, pix_out,
                      div,     x1,      qshr,      tab,      pitch,
                      n,       ld_coef, ld_halo,   ld_image2, do_rebalance};
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
// 242) or kLowQuality (nt 0); tab f32[64, pitch] when nt > 0.  Blocks
// [b0, b1) of the nblocks-block planes, wb blocks a row; top_row / bot_row
// the rows whose top / bottom edge replicates (-1: none).  pix_out may be
// NULL.
int jq_solve_range_pix(const int* coef_in, const int* pix_in,
                       const int* image2, int* coef_out, int* pix_out,
                       const int* div, const int* x1, const int* qshr,
                       const float* tab, int pre, int nt, int pitch,
                       int nblocks, int wb, int b0, int b1, int top_row,
                       int bot_row, int do_rebalance, void* stream) {
  const bool swept = nt == 144 || nt == 242;
  const bool ok = pre == kBorders  ? swept
                  : pre == kJoint  ? image2 != nullptr && (nt == 0 || swept)
                                   : pre == kLowQuality && nt == 0;
  if (!ok || !pitch_ok(nt, pitch) || wb < 1 || b0 < 0 || b1 > nblocks)
    return (int)cudaErrorInvalidValue;
  if (b1 > b0) {
    const RangeArgs a{coef_in, pix_in,  image2,  coef_out, pix_out,
                      div,     x1,      qshr,    tab,      pitch,
                      nblocks, wb,      b0,      b1,       top_row,
                      bot_row, do_rebalance};
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
