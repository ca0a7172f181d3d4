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
// neighbouring words.  One thread owns one 8x8 block for the whole pass,
// except in the LOW_QUALITY passes (B4 and its B6/B7 forms) and B5's lane
// body, where 8 lanes of a warp share a block.
// The upsample_fdct kernel writes its output block-major, int16[B, 64], the
// layout the host copies.
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
// A pass's descriptor.  Every solver pass reads each block's coefficients
// and a neighbourhood and writes the block's new coefficients (and
// pixels); B2-B7 differ in where the neighbourhood comes from:
//  * the previous pass's pixels [64, S] (B2, B3, B4 and B7): a block reads
//    its neighbours at b -+ 1 and b -+ wb and replicates its own lines at
//    the edges the descriptor flags.  Its row is (b % period) / wb and its
//    column (b % period) % wb: its top edge replicates when that row is
//    top_row, its bottom edge when it is bot_row, its left edge when that
//    column is left_col, its right edge when it is right_col (-1: none).
//    B2-B4 pass period = hb * wb and the edges of the block's own image,
//    rows 0 and hb - 1, columns 0 and wb - 1 (images concatenated on the
//    block axis never mix); B7 passes period = S (the row is b / wb) and
//    the shard's edges, which on a 2-D grid with ghost columns are inner
//    columns of its grid, or none.  One
//    kernel body per preamble so serves both, the edges a runtime
//    descriptor (the integer work B2-B4 did already);
//  * a neighbourhood the caller materialised (B5, B6): border lines
//    [32, .] or 10x10 halos [100, .], read at the block's own index, no
//    edges.  A kernel body reads one or the other (template GIVEN).  The
//    joint passes of B6 and B7 have a second, one-thread body for
//    launches of few CTAs an SM (solve_joint_thread_kernel), B5 a lane
//    body for them (solve_borders_lanes_kernel).
// A pass runs over blocks [b0, b1), each array with its row stride ld_*.
// Pixel sources: every ld_* is S, the outputs are whole-size planes written
// at the block's own index (B7's ranges fill one output), and b1 <= S.
// Given sources: b0 = 0, the inputs may be row chunks of whole planes
// (column-slice views, ld_* their plane's block count) and the outputs are
// contiguous [64, b1].  An output never aliases an input; pix_out may be
// NULL.
// ---------------------------------------------------------------------------
struct PassArgs {
  const int* coef_in;   // [64, ld_coef]
  const int* nbhd;      // pixels [64, ld_nbhd], or given border lines /
                        // halos [32 / 100, ld_nbhd]
  const int* image2;    // [100, ld_image2] downsampled-luma halos (JOINT)
  int* coef_out;        // [64, ld_out]
  int* pix_out;         // [64, ld_out], may be NULL
  const int* div;
  const int* x1;
  const int* qshr;
  const float* tab;     // [64, pitch] (NT > 0 only)
  int pitch, b0, b1, ld_coef, ld_nbhd, ld_image2, ld_out;
  int wb, period;                    // the grid (pixel sources)
  int top_row, bot_row, left_col, right_col;  // the edges, -1: none
  int do_rebalance;
};

// The edges block b of a pixel source replicates at (top, bottom, left,
// right).
__device__ __forceinline__ void pix_edges(const PassArgs& a, int b, bool& t,
                                          bool& d, bool& l, bool& r) {
  const int loc = b % a.period;
  const int by = loc / a.wb, bx = loc - by * a.wb;
  t = by == a.top_row;
  d = by == a.bot_row;
  l = bx == a.left_col;
  r = bx == a.right_col;
}

// ---------------------------------------------------------------------------
// B2, B7's B2 form and B5: one solver pass = the block's four border lines
// + k=63..1 sweep + rebalance + emit.  The border lines come from the
// previous pass's pixels (B2; B7 over a block range with the shard's edges)
// or are given (B5, GIVEN: the progress path's materialised lines).
// Replaces jpegqs_tpu/ops/pallas_solver.py solve_rebalance_pix
// (_solve_tiled aux_mode="pix": _bord_from_pix, _diffs_tile, the _GROUPS
// sweep of _solve_kernel, _rebalance_tile, emit_pix), solve_rebalance
// (aux_mode="halo", preamble None: the [32, B] borders) and, over a block
// range with the descriptor's edges, _solve_tiled(tile_range=...) as the
// sharded loop calls it (see B7 below).
// Bound on this card: fp32 operations -- 9 non-FMA fp32 ops per term of
// non-zero table weight per block per pass (7,648 of the 63 x NT terms at
// NT = 144, 13,308 at NT = 242 with DIAGONALS), against ~1 KB of
// coefficient/pixel traffic per block (B5: (64 + 32 + 64) x 4 B).  An SM
// sub-partition issues one warp instruction a clock, so the bound is the
// issue slots of those 9; whatever else a term issues, and warps waiting on
// loads, keep the kernel from it.
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
// GIVEN changes the inputs only: the 32 given lines [32, ld_nbhd] (top,
// bottom, left, right) read at the block's own index, the coefficients at
// row stride ld_coef (a row chunk's inputs are column-slice views of whole
// planes), b0 = 0 and the outputs contiguous [64, b1].  B5's launches of few
// CTAs an SM take solve_borders_lanes_kernel (below) instead.  An output
// never aliases an input: neighbours' previous-pass pixels are read while
// others write.
// ---------------------------------------------------------------------------
template <int NT, bool GIVEN>
__global__ void __launch_bounds__(kThreads, 4)
solve_borders_kernel(const PassArgs a) {
  __shared__ int coef_smem[64 * kThreads];
  const int b = a.b0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.b1) return;
  // the row strides: one plane size S for the pixel sources
  const size_t S = (size_t)a.ld_out;
  const size_t ld_coef = GIVEN ? (size_t)a.ld_coef : S;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  const SmemCol<int> c{coef_smem + threadIdx.x};
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * ld_coef + b];

  float v[96];
  if constexpr (GIVEN) {
#pragma unroll
    for (int j = 0; j < 32; ++j) v[64 + j] = a.nbhd[j * (size_t)a.ld_nbhd + b];
  } else {
    bool t, d, l, r;
    pix_edges(a, b, t, d, l, r);
    load_borders(a.nbhd, S, b, a.wb, t, d, l, r, v);
  }

  sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, b);
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
// B3/B4 and their B6/B7 forms: one fused pass = the block's 10x10 halo + the
// JOINT_YUV (B3) or LOW_QUALITY (B4) preamble + fdct_clamp, then (JOINT at
// NT > 0) the sweep with the halo's edge lines as borders, the rebalance
// and the emitted pixels.  The halo comes from the previous pass's pixels
// (B3, B4; B7 over a block range with the shard's edges) or is given (B6).
// Replace jpegqs_tpu/ops/pallas_solver.py solve_fused_pix (_solve_tiled
// aux_mode="pix" with preamble "joint" / "lq": _halo_from_pix, _joint_tile
// or _lq_range_tile + _lq_shrink_tile, _fdct_clamp_tile, the sweep unless
// LOW_QUALITY, _rebalance_tile, emit_pix), solve_fused (aux_mode="halo")
// and _solve_tiled(tile_range=...) with those preambles.
// ---------------------------------------------------------------------------

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

// The block index of a one-thread-per-block pass, read again from the
// special registers (asm volatile: the compiler cannot reuse the value it
// worked out at the start, so it does not keep that live across the pass).
__device__ __forceinline__ int block_index_again(const PassArgs& a) {
#ifdef __CUDA_ARCH__
  unsigned tid, cta;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  return a.b0 + (int)(cta * blockDim.x + tid);
#else
  return a.b0 + (int)(blockIdx.x * blockDim.x + threadIdx.x);
#endif
}

// B3 (JOINT_YUV preamble; NT 0: no sweep, q1/q2 chroma; NT 144/242: q5/q6),
// and B6-joint (GIVEN: the halo given) and B7-joint on launches of more
// than two CTAs an SM (fewer take solve_joint_thread_kernel, see B7).
// Bound on this card: with the sweep fp32 operations, as B2 (13,308
// non-zero-weight terms x 9 ops per block at NT 242) plus the preamble's
// 1,664; without it bytes -- ~1.4 KB per block (coefficients in and out,
// the 9-block pixel window or the given halo, image2, pixels out) against
// ~1.7k fp32 ops.
// Design: one thread per block, 128 threads a CTA, at most 128 registers and
// 51,200 B of shared memory, so 4 CTAs (16 warps) share an SM and the 12 MP
// 4:2:0 photo's 47,000-block chroma plane (368 CTAs) runs in one wave of
// 528 CTA slots.  The 10x10 pixel halo and the image2 halo are staged in
// shared memory as 16-bit values, each thread in its own words (no bank
// conflicts, no barrier), and not held in registers: the preamble holds
// only the predicted block (64 registers) and two sliding 3x3 windows.
// The halo is load_halo's, under the descriptor's edges, or the given
// [100, .] rows copied as they stand: they are the materialised halos,
// corners included.  joint_fblock reads its 3x3 windows from there; the
// coefficients then overlay the dead halo interior and image2, and the
// sweep is B2's, its borders read from the staged halo's edge lines.  B6
// reads its block index again for the emit (block_index_again): 8-16%
// faster on the 47,000-block plane, though ptxas then spills more outside
// the sweep (PERF.md, Findings).  pix_out never aliases pix_in.
template <int NT, bool GIVEN>
__global__ void __launch_bounds__(kThreads, 4)
solve_joint_kernel(const PassArgs a) {
  extern __shared__ int joint_smem[];
  const int b = a.b0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.b1) return;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  // the row strides: one plane size S for the pixel sources (one value,
  // as the registers of the sweep need)
  const size_t S = (size_t)a.ld_out;
  const size_t ld_image2 = GIVEN ? (size_t)a.ld_image2 : S;
  const size_t ld_coef = GIVEN ? (size_t)a.ld_coef : S;

  const SlotCol col{reinterpret_cast<volatile unsigned short*>(joint_smem) +
                    joint_slot(0, threadIdx.x)};
  const HaloSmem h{col};
  const Image2Smem g{col};
  // image2 first: the order that fits NT 0 in 128 registers with the
  // least spill (PERF.md, Findings)
#pragma unroll
  for (int k = 0; k < 100; ++k) g[k] = a.image2[k * ld_image2 + b];
  if constexpr (GIVEN) {
#pragma unroll
    for (int k = 0; k < 100; ++k) h[k] = a.nbhd[k * (size_t)a.ld_nbhd + b];
  } else {
    bool t, d, l, r;
    pix_edges(a, b, t, d, l, r);
    load_halo(a.nbhd, S, b, a.wb, t, d, l, r, h);
  }

  float fb[64];
  joint_fblock(h, g, fb);
  smem_retype();
  const SmemCol<int> c{joint_smem + joint_coef(0, threadIdx.x)};
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * ld_coef + b];
  fdct_clamp(fb, c, div, x1, qshr);

  if constexpr (NT > 0) {
    float v[96];
    halo_borders(h, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, GIVEN ? block_index_again(a) : b);
}

// B4 (LOW_QUALITY preamble; never sweeps) and its forms B6-lq (GIVEN: the
// halo given) and B7-lq (a block range with the shard's edges).
// Bound on this card: bytes -- ~1.0 KB per block (coefficients in and out,
// the 9-block pixel window, pixels out; B6: the given halo, 400 B, in
// place of the window) against ~6.9k fp32 ops; the operations' issue
// slots come close to it.
// Design: kLqLanes = 8 lanes of one warp per block, lane r owning pixel row
// r, FDCT/IDCT column r and row r, coefficient row r (coefficients
// 8r..8r+7); a CTA of 128 threads takes kLqBlocks = 16 consecutive blocks
// of the pass (its tile starts at b0 + 16 x CTA, so a B7 tile need not be
// aligned to 16), which may cross image rows and images.  The CTA stages,
// from coalesced loads (a warp reads 8 consecutive blocks, 32 bytes, of
// each of 4 planar rows), its coefficient tile and its pixels in shared
// memory, the pixels as fp32 (integers 0..255, exact), with the quant
// tables.  From pixels: the window of each block's 8 rows with the row
// above (row 7 of the block above) and the row below (row 0 of the block
// below), plus the left / right columns of the blocks before and after the
// tile, and each block's edge flags from the descriptor (one thread a
// block works them out: the integer divides are not repeated per lane);
// the window holds every block of the plane the tile's blocks read, those
// past the range too, and a block of the tile past the range computes and
// stores nothing.  Given halos: each block's 100 rows as they stand, a
// halo row padded to kLqRow words.  Each lane then builds its three halo
// rows from there (from the window with its block's edge flags, the
// vertical ring first, as load_halo), folds its 8 pixels' shrinks in the
// scalar order (quantsmooth.h:1161-1175: the 8 neighbours in row-major
// order, planar.low_quality_fblocks), and the transposes of the FDCT and
// the IDCT go through the block's 8x8 scratch matrix (__syncwarp: a block's
// lanes are one warp's).  The range's float fold (quantsmooth.h:929-938)
// stays one chain, handed from lane to lane (__shfl_sync); its integer sum
// and the rebalance's u64 sums are split over the lanes and combined with
// xor shuffles (wrapping sums: exact in any order).  The results go back
// through shared memory to coalesced stores.  Rows are padded to 9 words
// (a given halo's to 11) and block matrices to a pitch of 8 (24) mod 32
// banks, so a lane group's row and column accesses hit 32 different banks.
// Each thread stages and stores one block's rows k0 + 8i with pointer
// strides: index arithmetic per element was the first layout's largest
// integer cost (PERF.md, Findings).  At most 64 registers (8 CTAs, 32
// warps, an SM; ptxas's report says how many CTAs fit).  pix_out never
// aliases pix_in.
// ---------------------------------------------------------------------------
constexpr int kLqLanes = 8;
constexpr int kLqBlocks = kThreads / kLqLanes;  // 16 blocks a CTA
constexpr int kLqPitch = 9;                      // a staged row, padded
constexpr int kLqMat = 8 * kLqPitch;             // an 8x8 matrix: 72 words
constexpr int kLqHalo = 104;                     // 10 rows, padded
constexpr int kLqRow = 11;                       // a given halo row, padded
constexpr int kLqGiven = 120;                    // a given halo, padded
static_assert(kLqMat % 32 == 8 && kLqHalo % 32 == 8 &&
                  kLqHalo >= 10 * kLqPitch,
              "B4's block pitches must be 8 banks apart");
static_assert(kLqRow % 2 == 1 && kLqRow >= 10 && kLqGiven % 16 == 8 &&
                  kLqGiven >= 10 * kLqRow,
              "a given halo's rows must be odd and its blocks 8 or 24 banks "
              "apart");

// The LOW_QUALITY passes' shared memory per CTA (17,536 bytes from pixels,
// 17,728 from given halos).  v: from pixels, the window, one 10-row matrix
// per block of the tile and of its two neighbours (index jj + 1 for block
// b0 + jj, jj = -1..kLqBlocks): row 0 the block above's row 7, rows 1..8
// the block's own, row 9 the block below's row 0; of the two neighbours
// only the column next to the tile; given halos: block j's halo at j *
// kLqGiven, row R at R * kLqRow.  c: the coefficient tile, in, then out
// (each lane reads and writes its own row).  w: each block's scratch matrix
// (fb, the FDCT's and the IDCT's intermediate rows, then the emitted
// pixels).  edge: each tile block's edge flags (pixels only).  tab: the
// quant tables div, x1, qshr (a lane reads its row's entries).
template <bool GIVEN>
struct LqSmem {
  float v[GIVEN ? kLqBlocks * kLqGiven : (kLqBlocks + 2) * kLqHalo];
  int c[kLqBlocks * kLqMat];
  u32 w[kLqBlocks * kLqMat];
  int edge[kLqBlocks];
  int tab[3 * 64];
};
constexpr int kLqTop = 1, kLqBottom = 2, kLqLeft = 4, kLqRight = 8;

// Element k (r * 8 + c) of tile block j in c / w.
__device__ __forceinline__ int lq_mat(int j, int k) {
  return j * kLqMat + (k >> 3) * kLqPitch + (k & 7);
}

// The tile block and first planar row a thread stages and stores: rows
// k0, k0 + 8, ..., k0 + 56 of block j, so at each step a warp covers 8
// consecutive blocks of 4 consecutive planar rows.
__device__ __forceinline__ void lq_tile_elem(int t, int& j, int& k0) {
  j = (t & 7) + 8 * ((t >> 5) & 1);
  k0 = ((t >> 3) & 3) + 4 * (t >> 6);
}

// Pixel k of block blk as fp32, or 0 outside the plane (such a value is
// never read: a block reads a neighbour only where it has one).
__device__ __forceinline__ float lq_px(const int* __restrict__ pix, size_t S,
                                       long long blk, int k) {
  return blk >= 0 && blk < (long long)S ? (float)pix[k * S + blk] : 0.0f;
}

// The LOW_QUALITY range (quantsmooth.h:929-938, planar.low_quality_range_p)
// on the lanes of one block: a strict left fold of (float)(div * |AC|) with
// the product in 32-bit int, times 4 / sum|AC| when that sum is not 0, min
// 128, roundf.  Lane ln holds coefficients 8 ln .. 8 ln + 7 (cr,
// incoming).  The float fold runs k = 1..63 in order,
// lane after lane: each stage, every lane folds its own terms onto the
// running value and the value of the stage's lane is passed on (lane 0's
// term of the DC is +0, which leaves the fold unchanged: it never holds
// -0).  The integer sum is combined with xor shuffles.
__device__ __forceinline__ float lq_range_lanes(const int* cr, int ln,
                                                const int* div) {
  float p[8];
  u32 s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = ln * 8 + k;
    const u32 a = i == 0 ? 0u : (cr[k] < 0 ? 0u - (u32)cr[k] : (u32)cr[k]);
    p[k] = (float)(int)((u32)div[i] * a);
    s += a;
  }
  float acc = 0.0f;
#pragma unroll
  for (int st = 0; st < kLqLanes; ++st) {
    float mine = acc;
#pragma unroll
    for (int k = 0; k < 8; ++k) mine = __fadd_rn(mine, p[k]);
    acc = __shfl_sync(0xffffffffu, mine, st, kLqLanes);
  }
#pragma unroll
  for (int off = 1; off < kLqLanes; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, kLqLanes);
  float rng = acc;
  if (s != 0) rng = __fmul_rn(acc, __fdiv_rn(4.0f, (float)(int)s));
  return roundf(fminf(rng, 128.0f));
}

// The rebalance on the lanes of one block: c the lane's coefficients
// 8 ln .. 8 ln + 7 (the DC, lane 0's first, is kept); the sums m0 / m1
// are split over the lanes and combined with xor shuffles; each lattice
// point a0 is computed once and kept for the clamp.
__device__ __forceinline__ void rebalance_lanes(int (&c)[8], int ln,
                                                const int* div, const int* x1,
                                                const int* qshr) {
  u64 m0 = 0, m1 = 0;
  int a0[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = ln * 8 + k;
    a0[k] = orig_coef(c[k], div[i], x1[i], qshr[i]);
    if (i == 0) continue;
    m0 += (u64)((long long)c[k] * a0[k]);
    m1 += (u64)((long long)a0[k] * a0[k]);
  }
#pragma unroll
  for (int off = 1; off < kLqLanes; off <<= 1) {
    m0 += __shfl_xor_sync(0xffffffffu, m0, off, kLqLanes);
    m1 += __shfl_xor_sync(0xffffffffu, m1, off, kLqLanes);
  }
  const long long sm0 = (long long)m0, sm1 = (long long)m1;
  if (sm1 > sm0) {
    const long long num = (long long)((m1 << 13) + (u64)(sm0 >> 1));
    const long long den = sm0 == 0 ? 1 : sm0;
    const long long q64 =
        den == -1 ? (long long)(0ull - (u64)num) : num / den;  // C trunc
    const u32 mul = (u32)(u64)q64;                             // int trunc
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = ln * 8 + k;
      if (i == 0) continue;
      const long long prod = (int)((u32)c[k] * mul);
      c[k] = interval_clamp((int)((prod + 0x1000) >> 13), a0[k], div[i]);
    }
  }
}

template <bool GIVEN>
__global__ void __launch_bounds__(kThreads, 9)
solve_lq_kernel(const PassArgs a) {
  __shared__ LqSmem<GIVEN> sm;
  const int t = threadIdx.x;
  const long long b0 = a.b0 + (long long)blockIdx.x * kLqBlocks;
  // the row strides: one plane size S for the pixel sources
  const size_t S = (size_t)a.ld_nbhd;
  const size_t ld_coef = GIVEN ? (size_t)a.ld_coef : S;
  const size_t ld_out = GIVEN ? (size_t)a.ld_out : S;
  const int wb = a.wb;

  // Staging: the quant tables, the coefficient tile ...
  if (t < 64) {
    sm.tab[t] = a.div[t];
    sm.tab[64 + t] = a.x1[t];
    sm.tab[128 + t] = a.qshr[t];
  }
  const int* div = sm.tab;
  const int* x1 = sm.tab + 64;
  const int* qshr = sm.tab + 128;
  int tj, tk;
  lq_tile_elem(t, tj, tk);
  const long long tb = b0 + tj;
  const bool tin = tb < a.b1;  // a block of the pass: staged and stored
  {
    const int* cin = a.coef_in + (tin ? tk * ld_coef + tb : 0);
    int* cs = sm.c + lq_mat(tj, tk);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cs[i * kLqPitch] = tin ? cin[i * 8 * ld_coef] : 0;
  }
  if constexpr (GIVEN) {
    // ... and each block's halo, rows k0 + 8i of block j (a warp: 16
    // consecutive blocks of 2 rows), row R of the halo at R * kLqRow
    const int j = t & (kLqBlocks - 1), k0 = t / kLqBlocks;
    const bool in = b0 + j < a.b1;
    const int* hin = a.nbhd + (in ? k0 * S + b0 + j : 0);
    float* vj = sm.v + j * kLqGiven;
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      const int k = k0 + 8 * i;
      if (k < 100)
        vj[k + (k / 10) * (kLqRow - 10)] = in ? (float)hin[i * 8 * S] : 0.0f;
    }
  } else {
    // ... the tile's own pixel rows, every tile block in the plane ...
    {
      const bool pin_ok = tb < (long long)S;
      const int* pin = a.nbhd + (pin_ok ? tk * S + tb : 0);
      float* vs = sm.v + (tj + 1) * kLqHalo + kLqPitch + tk;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        vs[i * kLqPitch] = pin_ok ? (float)pin[i * 8 * S] : 0.0f;
    }
    // ... the row above and the row below of each tile block, and its
    // edge flags from the descriptor ...
    {
      const int j = t & (kLqBlocks - 1), q = t / kLqBlocks;
      float* vj = sm.v + (j + 1) * kLqHalo;
      vj[q] = lq_px(a.nbhd, S, b0 + j - wb, 56 + q);
      vj[9 * kLqPitch + q] = lq_px(a.nbhd, S, b0 + j + wb, q);
      if (q == 0) {
        bool et, ed, el, er;
        pix_edges(a, (int)(b0 + j), et, ed, el, er);
        sm.edge[j] = (et ? kLqTop : 0) | (ed ? kLqBottom : 0) |
                     (el ? kLqLeft : 0) | (er ? kLqRight : 0);
      }
    }
    // ... and column 7 of the block before the tile (with its rows above
    // and below), column 0 of the block after it.
    if (t < 10) {
      const int R = t;
      const long long blk = b0 - 1 + (R == 0 ? -wb : R == 9 ? wb : 0);
      const int k = R == 0 ? 63 : R == 9 ? 7 : (R - 1) * 8 + 7;
      sm.v[R * kLqPitch + 7] = lq_px(a.nbhd, S, blk, k);
    } else if (t >= 16 && t < 26) {
      const int R = t - 16;
      const long long blk = b0 + kLqBlocks + (R == 0 ? -wb : R == 9 ? wb : 0);
      const int k = R == 0 ? 56 : R == 9 ? 0 : (R - 1) * 8;
      sm.v[(kLqBlocks + 1) * kLqHalo + R * kLqPitch] = lq_px(a.nbhd, S, blk,
                                                             k);
    }
  }
  __syncthreads();

  // One block per kLqLanes lanes; lanes of blocks past the range compute
  // and store nothing of theirs (they take part in the shuffles).
  const int j = t / kLqLanes, ln = t % kLqLanes;
  const int* cr = sm.c + lq_mat(j, ln * 8);  // the lane's incoming row
  const float rng = lq_range_lanes(cr, ln, div);

  // halo rows ln .. ln + 2
  float h[3][10];
  if constexpr (GIVEN) {
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const float* row = sm.v + j * kLqGiven + (ln + dr) * kLqRow;
#pragma unroll
      for (int q = 0; q < 10; ++q) h[dr][q] = row[q];
    }
  } else {
    // the staged row, or at a flagged top / bottom edge the block's own
    // first / last row; the ring columns from the neighbours' staged rows
    // (rows 0 / 9 of them: the vertical ring, which makes the corners), or
    // the block's own at a flagged side edge
    const int edge = sm.edge[j];
    const bool et = edge & kLqTop, ed = edge & kLqBottom,
               el = edge & kLqLeft, er = edge & kLqRight;
    const float* vj = sm.v + (j + 1) * kLqHalo;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int hr = ln + dr;
      const int R = hr == 0 && et ? 1 : (hr == 9 && ed ? 8 : hr);
      const float* row = vj + R * kLqPitch;
#pragma unroll
      for (int q = 0; q < 8; ++q) h[dr][q + 1] = row[q];
      h[dr][0] = el ? row[0] : row[7 - kLqHalo];
      h[dr][9] = er ? row[7] : row[kLqHalo];
    }
  }

  // the shrink of pixels (ln, 0..7), in the scalar fold order, into w
  u32* wj = sm.w + j * kLqMat;
  u32* wrow = wj + ln * kLqPitch;
  const float c1 = __int_as_float(0x3FB504F3);  // planar.LQ_C1
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float av = h[1][q + 1];
    float acc0 = 0.0f, accn = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int m = n < 4 ? n : n + 1;           // skip the centre
      const int dy = m / 3 - 1, dx = m % 3 - 1;
      // both pixels are integers 0..255: the fp32 difference is exact
      const float t0 = __fsub_rn(av, h[1 + dy][q + 1 + dx]);
      float tt = fmaxf(__fsub_rn(rng, fabsf(t0)), 0.0f);  // integral
      tt = __fmul_rn(tt, tt);                              // < 2^24: exact
      const float aw = __fmul_rn(dx != 0 && dy != 0 ? c1 : 2.0f, tt);
      acc0 = __fadd_rn(acc0, __fmul_rn(__fmul_rn(t0, tt), aw));
      accn = __fadd_rn(accn, __fmul_rn(aw, aw));
    }
    const int ai = (int)av;
    const float shifted = __fsub_rn(av, __fdiv_rn(acc0, accn));
    const int na = accn > 0.0f ? c_cast(shifted) : ai;
    wrow[q] = __float_as_uint((float)(int)((u32)na - 128u));
  }
  __syncwarp();

  // fdct_clamp: column ln (read and rewritten by this lane only), then
  // row ln against the incoming row
  float x[8], o[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = __uint_as_float(wj[r * kLqPitch + ln]);
  fdct_pass(x, o);
#pragma unroll
  for (int u = 0; u < 8; ++u) wj[u * kLqPitch + ln] = __float_as_uint(o[u]);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = __uint_as_float(wrow[q]);
  fdct_pass(x, o);
  int c[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = ln * 8 + q, dv = div[i];
    const int add = c_cast(roundf(__fmul_rn(o[q], 0.125f)));
    c[q] = interval_clamp(add, orig_coef(cr[q], dv, x1[i], qshr[i]), dv);
  }
  if (a.do_rebalance) rebalance_lanes(c, ln, div, x1, qshr);

  // emit: the row back into the tile, and the IDCT (column ln, then row
  // ln) into w
  int* crow = sm.c + lq_mat(j, ln * 8);
#pragma unroll
  for (int q = 0; q < 8; ++q) crow[q] = c[q];
  if (a.pix_out != nullptr) {
    __syncwarp();
    u32 xi[8], oi[8];
    const int* cj = sm.c + j * kLqMat;
#pragma unroll
    for (int r = 0; r < 8; ++r) xi[r] = (u32)cj[r * kLqPitch + ln];
    islow_pass(xi, oi);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      wj[r * kLqPitch + ln] = (u32)((int)(oi[r] + 1024u) >> 11);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q) xi[q] = wrow[q];
    islow_pass(xi, oi);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int v = (int)(oi[q] + (257u << 17)) >> 18;
      wrow[q] = (u32)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  __syncthreads();

  // coalesced stores of the tile's coefficients and pixels
  if (tin) {
    const size_t off = tk * ld_out + tb;
    const int* cs = sm.c + lq_mat(tj, tk);
    const u32* ws = sm.w + lq_mat(tj, tk);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a.coef_out[off + i * 8 * ld_out] = cs[i * kLqPitch];
    if (a.pix_out != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a.pix_out[off + i * 8 * ld_out] = (int)ws[i * kLqPitch];
    }
  }
}

// ---------------------------------------------------------------------------
// B5 and B6: the passes of B2 and B3/B4 on a GIVEN neighbourhood, the one
// the progress path materialises from the whole pre-iteration plane:
// border lines int32[32, .] (top, bottom, left, right, eight rows each) for
// B5, 10x10 halos int32[100, .] (row-major) for B6.  A block reads its
// neighbourhood at its own index, nbhd[j * ld_nbhd + b]: no edge logic.
// The inputs may be row chunks of whole planes (PassArgs); the outputs are
// contiguous [64, n].  B5 is solve_borders_kernel<NT, true> (B2's body; on
// launches of few CTAs an SM solve_borders_lanes_kernel<NT> below), B6
// solve_joint_kernel<NT, true> (JOINT_YUV; on launches of at most two CTAs
// an SM solve_joint_thread_kernel<NT, true>, see B7) and
// solve_lq_kernel<true> (LOW_QUALITY) above.
// Replace jpegqs_tpu/ops/pallas_solver.py solve_rebalance (_solve_tiled
// aux_mode="halo", preamble None) and solve_fused (aux_mode="halo",
// preamble "joint" / "lq").
// B6's bound on this card: with the sweep (JOINT at q5/q6) fp32
// operations, as B3; without it (JOINT at q1/q2, LQ at q0-q2) bytes --
// (64 + 100 + 100 + 64) x 4 B per block under JOINT, 100 ints fewer under
// LQ.  B5's: as B2.
//
// B5's lane body, for launches of few CTAs an SM (the PRECISE_PROGRESS row
// chunks): there B2's body takes one thread's chain of 63 sweep steps,
// whatever the launch's size, and most of an SM's issue slots are idle.
// The steps of a refresh group are independent -- each reads the pixels
// of the group's start and changes only its own coefficient -- so the
// lane body gives a block kSwLanes = 8 lanes of a warp (16 blocks a CTA)
// and runs a group's steps side by side, lane l the group's step l (the 14
// groups hold 1 to 8 steps): its chain is 14 steps long, not 63.  Each
// lane folds its step exactly as sweep does (fold_terms: the same terms in
// the same order, the same zero-weight classes skipped), from its own copy
// of the block's fp32 pixels and border lines (v[96], registers), and
// applies its delta to the block's coefficients, an 8x8 matrix in shared
// memory that the group's lanes share (each its own coefficient).  At a
// group start the warp refreshes when any of its blocks changed (the IDCT
// of unchanged coefficients gives the pixels they already have): lane r
// takes column r, then row r, through the block's scratch matrix, and
// every lane reads the 64 pixels back (__syncwarp); so does the emit.  The
// rebalance is the LOW_QUALITY kernel's (rebalance_lanes: lane r owns
// coefficient row r).  A lane reads its step's table row (8 rows a warp,
// L1-resident).  At most 168 registers: v[96] without a spill, 3 CTAs
// (48 blocks) an SM; at 128 registers and 4 CTAs ptxas spills 12 B and the
// small launches were up to 1.6x slower (PERF.md, Findings).  Per block it
// issues about twice B2's instructions (the groups fill 63 of 14 x 8
// lane-steps, and a warp runs a class of terms when any of its lanes folds
// it) and holds 8 copies of the block's state, so it pays only up to
// about 1.25 CTAs of 128 blocks an SM (cuda_solver.use_lane_body; PERF.md,
// Findings: at NT 242 4.7x B2's body at a quarter of one, 1.5x at one,
// 0.76x at two).  A first lane split -- the terms of one
// step over the lanes, their products through shared memory to two
// folding lanes -- was slower than this body at every size (its chain
// stayed 63 steps long, and its shared-memory traffic grew with the
// launch).  Blocks of the last tile past b1 compute on zeros and store
// nothing (they take part in the warp's votes and shuffles).
// ---------------------------------------------------------------------------
constexpr int kSwLanes = 8;                     // lanes a block
constexpr int kSwBlocks = kThreads / kSwLanes;  // 16 blocks a CTA
constexpr int kSwPix = 68;  // a block's pixels: 4 banks apart, float4 rows
static_assert(kSwLanes == kLqLanes && kSwPix >= 64 && kSwPix % 32 == 4,
              "B5's lane body shares the LOW_QUALITY kernel's lane helpers");

// The first step k of each refresh group (c_refresh), and 63.
__constant__ int c_group[15] = {0,  1,  3,  6,  10, 15, 21, 28,
                                36, 43, 49, 54, 58, 61, 63};

// B5's lane body's shared memory per CTA (13,568 bytes): per block the
// coefficients, the IDCT scratch matrix and the pixels.
struct SweepLanesSmem {
  int c[kSwBlocks * kLqMat];
  int w[kSwBlocks * kLqMat];
  float px[kSwBlocks * kSwPix];
};

// The IDCT of the block's coefficient matrix cj on its lanes (column ln,
// then row ln, through the scratch matrix wj) into the pixels pj, which
// every lane then reads into v[0..63].
__device__ __forceinline__ void lanes_pixels(const int* cj, int* wj,
                                             float* pj, int ln,
                                             float (&v)[96]) {
  __syncwarp();  // the coefficient updates; the last pixel reads
  u32 x[8], o[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = (u32)cj[r * kLqPitch + ln];
  islow_pass(x, o);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    wj[r * kLqPitch + ln] = (int)(o[r] + 1024u) >> 11;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = (u32)wj[ln * kLqPitch + q];
  islow_pass(x, o);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = (int)(o[q] + (257u << 17)) >> 18;
    pj[ln * 8 + q] = (float)(p < 0 ? 0 : (p > 255 ? 255 : p));
  }
  __syncwarp();
#pragma unroll
  for (int k4 = 0; k4 < 64; k4 += 4) {
    const float4 p4 = *reinterpret_cast<const float4*>(pj + k4);
    v[k4] = p4.x;
    v[k4 + 1] = p4.y;
    v[k4 + 2] = p4.z;
    v[k4 + 3] = p4.w;
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 3)
solve_borders_lanes_kernel(const PassArgs a) {
  __shared__ SweepLanesSmem sm;
  const int t = threadIdx.x;
  const int jb = t / kSwLanes, ln = t % kSwLanes;
  const int b = blockIdx.x * kSwBlocks + jb;  // given sources: b0 = 0
  const bool in = b < a.b1;
  const size_t ld_coef = (size_t)a.ld_coef, ld_nbhd = (size_t)a.ld_nbhd;
  const size_t ld_out = (size_t)a.ld_out;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;
  int* cj = sm.c + jb * kLqMat;
  int* wj = sm.w + jb * kLqMat;
  float* pj = sm.px + jb * kSwPix;

  // lane ln's coefficient row; every lane the 32 border values
#pragma unroll
  for (int q = 0; q < 8; ++q)
    cj[ln * kLqPitch + q] = in ? a.coef_in[(ln * 8 + q) * ld_coef + b] : 0;
  float v[96];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    v[64 + j] = in ? (float)a.nbhd[j * ld_nbhd + b] : 0.0f;

  bool need = true;  // this lane changed a coefficient since the refresh
  for (int g = 0; g < 14; ++g) {
    const int k0 = c_group[g];
    if (__any_sync(0xffffffffu, need)) {
      lanes_pixels(cj, wj, pj, ln, v);
      need = false;
    }
    if (ln < c_group[g + 1] - k0) {  // step k0 + ln: sweep's step body
      const int i = c_iseq[k0 + ln];
      const float rng = (float)(div[i] * 2);
      const float* tr = a.tab + i * a.pitch;
      float a2 = 0.0f, a3 = 0.0f;
      if (i & 7) fold_terms<0, 56>(v, tr, rng, a2, a3);     // horizontal
      fold_terms<56, 88>(v, tr, rng, a2, a3);               // border
      if (i > 7) fold_terms<88, 144>(v, tr, rng, a2, a3);   // vertical
      if constexpr (NT > 144) fold_terms<144, NT>(v, tr, rng, a2, a3);
      const int delta = c_cast(roundf(__fdiv_rn(a2, a3)));  // half away
      if (delta != 0) {
        int* ci = cj + (i >> 3) * kLqPitch + (i & 7);
        const int coef1 = *ci;
        const int dv = div[i];
        const int a0 = orig_coef(coef1, dv, x1[i], qshr[i]);
        const int nc =
            interval_clamp((int)((u32)coef1 - (u32)delta), a0, dv);
        if (nc != coef1) {
          *ci = nc;
          need = true;
        }
      }
    }
  }
  __syncwarp();

  int c[8];
  int* crow = cj + ln * kLqPitch;
#pragma unroll
  for (int q = 0; q < 8; ++q) c[q] = crow[q];
  if (a.do_rebalance) rebalance_lanes(c, ln, div, x1, qshr);
  if (in) {
#pragma unroll
    for (int q = 0; q < 8; ++q) a.coef_out[(ln * 8 + q) * ld_out + b] = c[q];
  }
  if (a.pix_out != nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q) crow[q] = c[q];
    lanes_pixels(cj, wj, pj, ln, v);
    if (in) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        a.pix_out[(ln * 8 + q) * ld_out + b] = (int)v[ln * 8 + q];
    }
  }
}

// ---------------------------------------------------------------------------
// B7: one resident pass of B2, B3 or B4 over blocks [b0, b1) only, with the
// edges given by the caller: solve_borders_kernel<NT, false>,
// solve_joint_kernel<NT, false> and solve_lq_kernel<false> above, with
// period = S and the shard's top_row / bot_row / left_col / right_col.
// Replaces jpegqs_tpu/ops/pallas_solver.py _solve_tiled(tile_range=(t0, t1))
// as the sharded resident loop calls it (parallel/sharded.py
// _sharded_resident_iters: solve_rebalance_pix / solve_fused_pix over a
// tile range of the ghost-extended shard, with the rank-selected edge masks
// of _ext_mask_parts and, on a 2-D row x column grid, _ext_mask_parts2d).
// A shard's grid is its own block rows with one ghost row above and one
// below, which hold the neighbour shards' boundary pixel lines; the edges are
// not where the position says: the top edge is local row 1 on the first
// shard only (top_row, else -1), the bottom edge the row of the image's last
// real block row on the shard that holds it (bot_row, else -1; under
// pad-to-divisible sharding it may lie mid-shard, with dead rows below).
// On a row-only grid the left and right edges are the grid's columns (0 and
// wb - 1).  On a 2-D grid the shard also has one ghost column left and one
// right, which hold the horizontal neighbours' boundary pixel columns, and
// the column edges are descriptor values as the row edges are: the left edge
// is local column 1 on the first column shard only, the right edge the
// column of the image's last real block column on the shard that holds it.
// The caller then launches one range per local row, over its real columns
// only, so no block of a range sits in a ghost column and the kernel bodies
// stay as they are: a block whose side edge is not flagged reads its
// neighbour at b -+ 1, a ghost column, and the vertical ring first makes the
// diagonal corners the diagonal shard's pixels (the exchange copies the
// columns of the row-extended grid).  The block range lets a
// caller compute the interior rows, which read no ghost line, while the
// ghost lines are still being exchanged.  Neighbours are read from the
// whole input planes [., S]; the blocks of the range are written into the
// whole-size outputs [64, S] at their own index, so the passes of a split
// fill one output.
// Bound on this card: as B2, B3 or B4.  Design: theirs; the JOINT_YUV
// form, as B6's, takes the one-thread joint body below on launches of at
// most two CTAs an SM.
// ---------------------------------------------------------------------------
// B7's preambles, as the wrappers number them.
constexpr int kJoint = 0;
constexpr int kLowQuality = 1;
constexpr int kBorders = 2;

// The one-thread joint body, B6-joint's and B7-joint's on launches of at
// most two CTAs an SM: one thread per block, the halos, the coefficients
// and the predicted block in registers and local memory (255 registers,
// so 2 CTAs an SM), the preamble, fdct_clamp, sweep, rebalance and emit
// B3's device functions.  B3's design (solve_joint_kernel: 16-bit halos
// and the coefficients in shared memory, 128 registers, 4 CTAs an SM)
// makes a thread slower and pays that back only with more CTAs an SM than
// this body holds: below them this body is faster (PERF.md, Findings: the
// m-CTAs-per-SM planes).  B7's ranges are mostly such launches (the chroma
// shard of a 2-shard 12 MP frame is 187 CTAs of 128, a one-row range 2),
// and so are B6's row chunks.
template <int NT, bool GIVEN>
__global__ void __launch_bounds__(kThreads)
solve_joint_thread_kernel(const PassArgs a) {
  const int b = a.b0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.b1) return;
  const size_t S = (size_t)a.ld_out;
  const size_t ld_nbhd = GIVEN ? (size_t)a.ld_nbhd : S;
  const size_t ld_image2 = GIVEN ? (size_t)a.ld_image2 : S;
  const size_t ld_coef = GIVEN ? (size_t)a.ld_coef : S;
  const int* __restrict__ div = a.div;
  const int* __restrict__ x1 = a.x1;
  const int* __restrict__ qshr = a.qshr;

  int c[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) c[k] = a.coef_in[k * ld_coef + b];
  int h[100];
  if constexpr (GIVEN) {
#pragma unroll
    for (int k = 0; k < 100; ++k) h[k] = a.nbhd[k * ld_nbhd + b];
  } else {
    bool t, d, l, r;
    pix_edges(a, b, t, d, l, r);
    load_halo(a.nbhd, S, b, a.wb, t, d, l, r, h);
  }
  float fb[64];
  int g[100];
#pragma unroll
  for (int k = 0; k < 100; ++k) g[k] = a.image2[k * ld_image2 + b];
  joint_fblock(h, g, fb);
  fdct_clamp(fb, c, div, x1, qshr);
  if constexpr (NT > 0) {
    float v[96];
    halo_borders(h, v);
    sweep<NT>(c, v, div, x1, qshr, a.tab, a.pitch);
  }
  if (a.do_rebalance) rebalance(c, div, x1, qshr);
  emit_block(c, a.coef_out, a.pix_out, S, b);
}

// ---------------------------------------------------------------------------
// UPSAMPLE_UV in block form, sampling factors HS x WS of 2 x 2, 2 x 1 or
// 1 x 2: one chroma component upsampled to the luma grid by the JOINT
// regression on the downsampled luma, centred, float FDCT, roundf, the C
// cast and int16 (planar.upsample_fdct_blocks: upsample_chroma_blocks, then
// fdct_round_i16; quantsmooth.h:1851-2394, 2691-2752).
// Replaces no TPU kernel: the JAX package runs this tail as XLA ops
// (jpegqs_tpu/engine.py's block-form branch: planar.upsample_chroma_blocks,
// fdct_float_p, roundf).
// Bound on this card: bytes -- per luma block its 64 pixels in (256 B), its
// share of the two halos (800 B a chroma block, which HS x WS luma blocks
// share) and 128 B of int16 out, against ~24 fp32 operations a pixel.
// Design: read each input once, keep every intermediate on the chip, write
// int16 once.  One thread per luma block, 128 a CTA.  The thread works out
// the regression of each of its 64 / (HS x WS) chroma pixels from 3x3
// windows that slide down the halo columns (neighbouring threads read the
// same chroma block: L1 hits), applies it to its HS x WS luma pixels at
// once, and runs the FDCT's column pass on each luma column as soon as it
// is complete, so the registers hold the 64 column outputs and one chroma
// column's pixels, not the whole block twice (upsample_columns).  The int16
// block goes through shared memory, rows padded to 33 words, so that a CTA
// stores its output as contiguous 16-byte chunks instead of a warp writing
// 128-byte strides.  A block that may hold a pixel of a replicate tail works
// each pixel out from its source pixel alone (upsample_pixel), staged as
// bytes in the thread's own shared words: nothing waits on another block.
// Every operation is the plain version's, in its order: the window sums are
// exact integers below 2^24 (as in joint_fblock), the divide is IEEE and
// guarded by s_aa != 0, and every other product and sum is rounded once.
// ---------------------------------------------------------------------------
struct UpsampleArgs {
  const int* chroma;  // [100, ld_c] the component's 10x10 halos
  const int* image2;  // [100, ld_c] the downsampled luma's 10x10 halos
  const int* luma;    // [64, ld_l] the luma pixels
  short* out;         // [nblocks, 64] the luma-size coefficients
  int nblocks, ld_l, ld_c;  // n images of bl_img luma / bc_img chroma
                            // blocks; the luma's and the halos' row strides
                            // (element offsets fit in 32 bits, which
                            // spares the registers 64-bit ones spilled:
                            // PERF.md, Findings)
  int wb_l, bl_img, wb_c, bc_img;
  int row0, col0;     // the shard's first global pixel row and column
  // Replicate tails, in global pixels (INT32_MAX: none): a row at or
  // below bottom_from copies local row src_row; then a column at or right
  // of right_from, in a row above right_rows, copies local column src_col.
  int bottom_from, src_row, right_from, right_rows, src_col;
};

constexpr int kUpPitch = 33;  // words of a thread's staged int16 block

// The regression of a chroma pixel on the downsampled luma from the 3x3
// windows wa (luma) and wc (chroma) around it (planar._regression_f,
// quantsmooth.h:893-912, 2367): scale = s_ab / s_aa clamped to +-16 and
// offset = chroma - luma_ds * scale + 0.5.
__device__ __forceinline__ void upsample_regression(const int (&wa)[3][3],
                                                    const int (&wc)[3][3],
                                                    float& scale,
                                                    float& offset) {
  int sa = 0, sb = 0, saa = 0, sab = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int w = (dy == 1 ? 2 : 1) * (dx == 1 ? 2 : 1);
      sa += w * wa[dy][dx];
      sb += w * wc[dy][dx];
      saa += w * wa[dy][dx] * wa[dy][dx];
      sab += w * wa[dy][dx] * wc[dy][dx];
    }
  }
  const int s_aa = saa * 16 - sa * sa;
  const int s_ab = sab * 16 - sa * sb;
  const float s = s_aa != 0 ? __fdiv_rn((float)s_ab, (float)s_aa) : 0.0f;
  scale = fminf(fmaxf(s, -16.0f), 16.0f);
  offset = __fadd_rn(
      __fsub_rn((float)wc[1][1], __fmul_rn((float)wa[1][1], scale)), 0.5f);
}

// One upsampled pixel from its luma pixel (quantsmooth.h:2379-2388):
// trunc(luma * scale + offset) clamped to 0..255.
__device__ __forceinline__ int upsample_apply(int luma, float scale,
                                              float offset) {
  const float v = __fadd_rn(__fmul_rn((float)luma, scale), offset);
  return (int)fminf(fmaxf(truncf(v), 0.0f), 255.0f);
}

// The upsampled pixel (y, x) of image img, in the local pixels of its luma
// grid, from its own chroma pixel's windows and luma pixel: the tail path.
template <int HS, int WS>
__device__ int upsample_pixel(const UpsampleArgs& a, int img, int y, int x) {
  const int S = a.ld_c;
  const int cy = y / HS, cx = x / WS;
  const int cb = img * a.bc_img + (cy >> 3) * a.wb_c + (cx >> 3);
  const int k0 = (cy & 7) * 10 + (cx & 7);
  int wa[3][3], wc[3][3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int i = (k0 + dy * 10 + dx) * S + cb;
      wa[dy][dx] = __ldg(a.image2 + i);
      wc[dy][dx] = __ldg(a.chroma + i);
    }
  }
  float scale, offset;
  upsample_regression(wa, wc, scale, offset);
  const int lb = img * a.bl_img + (y >> 3) * a.wb_l + (x >> 3);
  const int k = (y & 7) * 8 + (x & 7);
  return upsample_apply(__ldg(a.luma + (k * a.ld_l + lb)), scale, offset);
}

// The float FDCT's column pass (fdct_clamp's order) of luma block b
// (image img, block row by, column bx) with no tail pixel, into ws.  Chroma
// column by chroma column: each chroma pixel's regression once, from 3x3
// windows sliding down its halo columns, applied to its HS x WS luma
// pixels; once a chroma column's pixels are all in, its WS luma columns
// go through fdct_pass, so no more than 8 x WS centred pixels are live
// (the block's 64 at once spilled: PERF.md, Findings).
template <int HS, int WS>
__device__ __forceinline__ void upsample_columns(const UpsampleArgs& a,
                                                 int img, int by, int bx,
                                                 int b, float (&ws)[64]) {
  constexpr int RH = 8 / HS, RW = 8 / WS;
  const int S = a.ld_c;
  const int cb = img * a.bc_img + (by / HS) * a.wb_c + bx / WS;
  const int* __restrict__ g = a.image2 + cb;
  const int* __restrict__ h = a.chroma + cb;
  // the block's first chroma pixel in its chroma block
  const int k0 = (by % HS) * RH * 10 + (bx % WS) * RW;
#pragma unroll
  for (int c = 0; c < RW; ++c) {
    int wa[3][3], wc[3][3];
#pragma unroll
    for (int dy = 1; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int i = (k0 + (dy - 1) * 10 + c + dx) * S;
        wa[dy][dx] = __ldg(g + i);
        wc[dy][dx] = __ldg(h + i);
      }
    }
    float fb[8 * WS];  // the centred pixels of luma columns c*WS ..
#pragma unroll
    for (int r = 0; r < RH; ++r) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int i = (k0 + (r + 2) * 10 + c + dx) * S;
        wa[0][dx] = wa[1][dx];
        wa[1][dx] = wa[2][dx];
        wa[2][dx] = __ldg(g + i);
        wc[0][dx] = wc[1][dx];
        wc[1][dx] = wc[2][dx];
        wc[2][dx] = __ldg(h + i);
      }
      float scale, offset;
      upsample_regression(wa, wc, scale, offset);
#pragma unroll
      for (int dy = 0; dy < HS; ++dy) {
#pragma unroll
        for (int dx = 0; dx < WS; ++dx) {
          const int k = (r * HS + dy) * 8 + c * WS + dx;
          const int v = upsample_apply(
              __ldg(a.luma + (k * a.ld_l + b)), scale, offset);
          fb[(r * HS + dy) * WS + dx] = (float)(v - 128);  // - CENTERJSAMPLE
        }
      }
    }
#pragma unroll
    for (int dx = 0; dx < WS; ++dx) {
      float x[8], o[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = fb[r * WS + dx];
      fdct_pass(x, o);
#pragma unroll
      for (int u = 0; u < 8; ++u) ws[u * 8 + c * WS + dx] = o[u];
    }
  }
}

template <int HS, int WS>
__global__ void __launch_bounds__(kThreads, 4)
upsample_fdct_kernel(const UpsampleArgs a) {
  __shared__ u32 staged[kThreads * kUpPitch];  // 16,896 B: int16 out
  __shared__ u32 tail[16 * kThreads];  // 8,192 B: tail pixels, as bytes
  const int t = threadIdx.x;
  const int b = blockIdx.x * kThreads + t;
  if (b < a.nblocks) {
    const int img = b / a.bl_img, loc = b - img * a.bl_img;
    const int by = loc / a.wb_l, bx = loc - by * a.wb_l;
    // the float FDCT (planar.fdct_round_i16; fdct_clamp's order): the
    // column pass into ws, then the row pass, roundf, the C cast and the
    // int16 wrap, two coefficients a staged word
    float ws[64];
    if (a.row0 + by * 8 + 7 >= a.bottom_from ||
        a.col0 + bx * 8 + 7 >= a.right_from) {
      // byte k of the thread's pixels in word (k / 4) * kThreads + t
      unsigned char* px = reinterpret_cast<unsigned char*>(tail + t);
#pragma unroll 1
      for (int k = 0; k < 64; ++k) {
        const int y = by * 8 + (k >> 3), x = bx * 8 + (k & 7);
        const int ys = a.row0 + y >= a.bottom_from ? a.src_row : y;
        const int xs = a.row0 + ys < a.right_rows &&
                               a.col0 + x >= a.right_from
                           ? a.src_col
                           : x;
        px[(k >> 2) * kThreads * 4 + (k & 3)] =
            (unsigned char)upsample_pixel<HS, WS>(a, img, ys, xs);
      }
#pragma unroll
      for (int col = 0; col < 8; ++col) {
        float x[8], o[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int k = r * 8 + col;
          x[r] = (float)((int)px[(k >> 2) * kThreads * 4 + (k & 3)] - 128);
        }
        fdct_pass(x, o);
#pragma unroll
        for (int u = 0; u < 8; ++u) ws[u * 8 + col] = o[u];
      }
    } else {
      upsample_columns<HS, WS>(a, img, by, bx, b, ws);
    }
    u32* row = staged + t * kUpPitch;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float x[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = ws[u * 8 + k];
      fdct_pass(x, o);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const int v0 = c_cast(roundf(__fmul_rn(o[k], 0.125f)));
        const int v1 = c_cast(roundf(__fmul_rn(o[k + 1], 0.125f)));
        row[u * 4 + k / 2] =
            (u32)(unsigned short)v0 | ((u32)(unsigned short)v1 << 16);
      }
    }
  }
  __syncthreads();
  // the CTA's blocks are contiguous in out: 8 chunks of 16 bytes a block
  const int first = blockIdx.x * kThreads;
  const int chunks = min(kThreads, a.nblocks - first) * 8;
  uint4* out = reinterpret_cast<uint4*>(a.out) + (size_t)first * 8;
  for (int q = t; q < chunks; q += kThreads) {
    const u32* s = staged + (q >> 3) * kUpPitch + (q & 7) * 4;
    out[q] = make_uint4(s[0], s[1], s[2], s[3]);
  }
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

// The joint kernels take kJointSmem bytes of dynamic shared memory, above
// the 48 KB a launch gets without asking: granted once per device and
// instantiation (a bit per device; granting it twice is harmless), so a
// pass on any device of a sharded run finds its grant.
template <int NT, bool GIVEN>
cudaError_t allow_joint_smem() {
  static std::atomic<unsigned long long> granted{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (granted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(solve_joint_kernel<NT, GIVEN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kJointSmem);
  if (e == cudaSuccess) granted.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// The device's SM count, asked once per device.
cudaError_t sm_count(int* n) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (*n = cached[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64)
    cached[dev].store(*n, std::memory_order_relaxed);
  return e;
}

// A joint pass: B3's design, or (by_size: B6 and B7) the one-thread body
// when the launch holds at most two CTAs an SM, the most that body holds.
template <int NT, bool GIVEN>
cudaError_t launch_joint(const PassArgs& a, bool by_size, cudaStream_t s) {
  const int ctas = blocks_for(a.b1 - a.b0);
  int sms = 0;
  cudaError_t e = by_size ? sm_count(&sms) : cudaSuccess;
  if (e != cudaSuccess) return e;
  if (ctas <= 2 * sms) {
    solve_joint_thread_kernel<NT, GIVEN><<<ctas, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  e = allow_joint_smem<NT, GIVEN>();
  if (e != cudaSuccess) return e;
  solve_joint_kernel<NT, GIVEN><<<ctas, kThreads, kJointSmem, s>>>(a);
  return cudaGetLastError();
}

// One pass of preamble pre (kBorders: B2's; kJoint; kLowQuality) over
// blocks [a.b0, a.b1), a.b1 > a.b0; nt 0 (no sweep), 144 or 242; by_size
// as launch_joint; lanes (B5: GIVEN, kBorders) B5's lane body.
template <bool GIVEN>
cudaError_t launch_pass(const PassArgs& a, int pre, int nt, bool by_size,
                        bool lanes, cudaStream_t s) {
  const int n = a.b1 - a.b0;
  if (pre == kLowQuality) {
    solve_lq_kernel<GIVEN><<<(n + kLqBlocks - 1) / kLqBlocks, kThreads, 0,
                             s>>>(a);
  } else if (pre == kJoint) {
    return nt == 0     ? launch_joint<0, GIVEN>(a, by_size, s)
           : nt == 144 ? launch_joint<144, GIVEN>(a, by_size, s)
                       : launch_joint<242, GIVEN>(a, by_size, s);
  } else if (GIVEN && lanes) {
    const int ctas = (n + kSwBlocks - 1) / kSwBlocks;
    if (nt == 144)
      solve_borders_lanes_kernel<144><<<ctas, kThreads, 0, s>>>(a);
    else
      solve_borders_lanes_kernel<242><<<ctas, kThreads, 0, s>>>(a);
  } else if (nt == 144) {
    solve_borders_kernel<144, GIVEN><<<blocks_for(n), kThreads, 0, s>>>(a);
  } else {
    solve_borders_kernel<242, GIVEN><<<blocks_for(n), kThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// The descriptor of a pass from pixels: blocks [b0, b1) of S-block planes
// with rows wb blocks wide; the edges as pix_edges reads them.
PassArgs pix_pass(const int* coef_in, const int* pix_in, const int* image2,
                  int* coef_out, int* pix_out, const int* div, const int* x1,
                  const int* qshr, const float* tab, int pitch, int S,
                  int b0, int b1, int wb, int period, int top_row,
                  int bot_row, int left_col, int right_col,
                  int do_rebalance) {
  return PassArgs{coef_in,  pix_in,    image2,   coef_out, pix_out, div,
                  x1,       qshr,      tab,      pitch,    b0,      b1,
                  S,        S,         S,        S,        wb,      period,
                  top_row,  bot_row,   left_col, right_col, do_rebalance};
}

// The descriptor of a pass on given neighbourhoods: n blocks, the inputs'
// row strides ld_*, the outputs contiguous [64, n].
PassArgs given_pass(const int* coef_in, const int* nbhd, const int* image2,
                    int* coef_out, int* pix_out, const int* div,
                    const int* x1, const int* qshr, const float* tab,
                    int pitch, int n, int ld_coef, int ld_nbhd,
                    int ld_image2, int do_rebalance) {
  return PassArgs{coef_in, nbhd,      image2,  coef_out, pix_out, div,
                  x1,      qshr,      tab,     pitch,    0,       n,
                  ld_coef, ld_nbhd,   ld_image2, n,      1,       1,
                  -1,      -1,        -1,      -1,      do_rebalance};
}

// The descriptor of an upsample: nblocks luma blocks, n images of hb_l x
// wb_l, their chroma hb_c x wb_c; the replicate tails worked out as
// planar.upsample_chroma_blocks does, for a shard whose first global pixel
// row and column are row0 and col0 in an image of hb_l_total x wb_l_total
// luma blocks.  False when the geometry is not one the kernel takes.
bool upsample_args(const int* chroma, const int* image2, const int* luma,
                   short* out, int nblocks, int ld_luma, int hb_l, int wb_l,
                   int hb_c,
                   int wb_c, int img_w, int img_h, int ws, int hs, int row0,
                   int hb_l_total, int col0, int wb_l_total,
                   UpsampleArgs* a) {
  if (hb_l < 1 || wb_l < 1 || hb_c < 1 || wb_c < 1 || img_w < 1 ||
      img_h < 1 || row0 < 0 || col0 < 0 || hb_c * hs < hb_l ||
      ld_luma < nblocks || ld_luma > INT32_MAX / 64 ||
      wb_c * ws < wb_l || nblocks < 0 || nblocks % (hb_l * wb_l) != 0 ||
      !((ws == 2 && hs == 2) || (ws == 2 && hs == 1) || (ws == 1 && hs == 2)))
    return false;
  const int n = nblocks / (hb_l * wb_l);
  if ((long long)n * hb_c * wb_c > INT32_MAX / 100) return false;
  const int w1 = (img_w + ws - 1) / ws, h1 = (img_h + hs - 1) / hs;
  const int hh = hb_l_total * 8, ww = wb_l_total * 8;
  *a = UpsampleArgs{chroma, image2, luma, out, nblocks, ld_luma,
                    n * hb_c * wb_c,
                    wb_l, hb_l * wb_l, wb_c, hb_c * wb_c, row0, col0,
                    INT32_MAX, 0, INT32_MAX, 0, 0};
  if (w1 * ws < ww) {
    // the first min(8, h1) * hs rows only (quantsmooth.h:1861, 2390-2393)
    const int sc = w1 * ws - 1;
    const int lbc = min(max(sc / 8 - col0 / 8, 0), wb_l - 1);
    a->right_from = w1 * ws;
    a->right_rows = min(min(8, h1) * hs, min(h1 * hs, hh));
    a->src_col = lbc * 8 + sc % 8;
  }
  if (h1 * hs < hh) {  // quantsmooth.h:2729-2730
    const int sr = h1 * hs - 1;
    const int lb = min(max(sr / 8 - row0 / 8, 0), hb_l - 1);
    a->bottom_from = h1 * hs;
    a->src_row = lb * 8 + sr % 8;
  }
  return true;
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
  if ((nt != 144 && nt != 242) || !pitch_ok(nt, pitch) || hb < 1 || wb < 1)
    return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const PassArgs a = pix_pass(coef_in, pix_in, nullptr, coef_out, pix_out,
                                div, x1, qshr, tab, pitch, nblocks, 0,
                                nblocks, wb, hb * wb, 0, hb - 1, 0, wb - 1,
                                do_rebalance);
    return (int)launch_pass<false>(a, kBorders, nt, false, false,
                                   (cudaStream_t)stream);
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
  if ((nt != 0 && nt != 144 && nt != 242) || !pitch_ok(nt, pitch) ||
      hb < 1 || wb < 1)
    return (int)cudaErrorInvalidValue;
  if (image2 == nullptr && nt != 0) return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    const PassArgs a = pix_pass(coef_in, pix_in, image2, coef_out, pix_out,
                                div, x1, qshr, tab, pitch, nblocks, 0,
                                nblocks, wb, hb * wb, 0, hb - 1, 0, wb - 1,
                                do_rebalance);
    return (int)launch_pass<false>(a, image2 ? kJoint : kLowQuality, nt,
                                   false, false, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// B5: nt is 144 or 242, tab f32[64, pitch].  ld_* are the row strides of
// the inputs (elements); the outputs are contiguous [64, n].  pix_out may
// be NULL.  lanes: the lane body (the caller's choice by launch size,
// cuda_solver.use_lane_body), else B2's.
int jq_solve_rebalance(const int* coef_in, const int* borders, int* coef_out,
                       int* pix_out, const int* div, const int* x1,
                       const int* qshr, const float* tab, int nt, int pitch,
                       int n, int ld_coef, int ld_borders, int do_rebalance,
                       int lanes, void* stream) {
  if ((nt != 144 && nt != 242) || !pitch_ok(nt, pitch))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const PassArgs a = given_pass(coef_in, borders, nullptr, coef_out,
                                  pix_out, div, x1, qshr, tab, pitch, n,
                                  ld_coef, ld_borders, 0, do_rebalance);
    return (int)launch_pass<true>(a, kBorders, nt, false, lanes != 0,
                                  (cudaStream_t)stream);
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
    const PassArgs a = given_pass(coef_in, halo, image2, coef_out, pix_out,
                                  div, x1, qshr, tab, pitch, n, ld_coef,
                                  ld_halo, ld_image2, do_rebalance);
    return (int)launch_pass<true>(a, image2 ? kJoint : kLowQuality, nt,
                                  true, false, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// B7: pre is kBorders (nt 144 or 242), kJoint (image2 given; nt 0, 144 or
// 242) or kLowQuality (nt 0); tab f32[64, pitch] when nt > 0.  Blocks
// [b0, b1) of the nblocks-block planes, wb blocks a row; top_row / bot_row
// the rows whose top / bottom edge replicates, left_col / right_col the
// columns whose left / right edge does (-1: none).  pix_out may be NULL.
int jq_solve_range_pix(const int* coef_in, const int* pix_in,
                       const int* image2, int* coef_out, int* pix_out,
                       const int* div, const int* x1, const int* qshr,
                       const float* tab, int pre, int nt, int pitch,
                       int nblocks, int wb, int b0, int b1, int top_row,
                       int bot_row, int left_col, int right_col,
                       int do_rebalance, void* stream) {
  const bool swept = nt == 144 || nt == 242;
  const bool ok = pre == kBorders  ? swept
                  : pre == kJoint  ? image2 != nullptr && (nt == 0 || swept)
                                   : pre == kLowQuality && nt == 0;
  if (!ok || !pitch_ok(nt, pitch) || wb < 1 || b0 < 0 || b1 > nblocks)
    return (int)cudaErrorInvalidValue;
  if (b1 > b0) {
    const PassArgs a = pix_pass(coef_in, pix_in, image2, coef_out, pix_out,
                                div, x1, qshr, tab, pitch, nblocks, b0, b1,
                                wb, nblocks, top_row, bot_row, left_col,
                                right_col, do_rebalance);
    return (int)launch_pass<false>(a, pre, nt, true, false,
                                   (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// UPSAMPLE_UV of one chroma component in block form: chroma and image2
// int32[100, n * hb_c * wb_c] halos, luma int32[64, nblocks] pixels in rows
// ld_luma apart (a column-slice view of a larger plane, or nblocks), out
// int16[nblocks, 64], nblocks = n * hb_l * wb_l; (hs, ws) is (2, 2), (2, 1)
// or (1, 2).  row0 / col0 and hb_l_total / wb_l_total as
// planar.upsample_chroma_blocks takes them (0 and hb_l / wb_l unsharded).
int jq_upsample_fdct(const int* chroma, const int* image2, const int* luma,
                     short* out, int nblocks, int ld_luma, int hb_l,
                     int wb_l, int hb_c, int wb_c, int img_w, int img_h,
                     int ws, int hs, int row0, int hb_l_total, int col0,
                     int wb_l_total, void* stream) {
  UpsampleArgs a;
  if (!upsample_args(chroma, image2, luma, out, nblocks, ld_luma, hb_l, wb_l,
                     hb_c,
                     wb_c, img_w, img_h, ws, hs, row0, hb_l_total, col0,
                     wb_l_total, &a))
    return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (hs == 2 && ws == 2)
      upsample_fdct_kernel<2, 2><<<blocks_for(nblocks), kThreads, 0, s>>>(a);
    else if (hs == 2)
      upsample_fdct_kernel<2, 1><<<blocks_for(nblocks), kThreads, 0, s>>>(a);
    else
      upsample_fdct_kernel<1, 2><<<blocks_for(nblocks), kThreads, 0, s>>>(a);
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
