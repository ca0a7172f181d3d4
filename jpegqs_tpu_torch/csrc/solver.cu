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
// coefficients are indexed by the sweep step and sit in local memory.  A
// thread refreshes (IDCT) only at a zigzag refresh point and only when one
// of its coefficients changed, as the C reference does; the TPU kernel's
// masked full-tile refresh gives the same values.  pix_out never aliases
// pix_in: neighbours' previous-pass pixels are read while others write.
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

  // Border lines from the previous pass's pixels of the four neighbours,
  // with edge replication (planar.borders_from_blocks; quantsmooth.h:
  // 1396-1401, 2612-2620).  Edges come from the block's position inside its
  // own image, so images concatenated on the block axis never mix.
  int v[96];
  const int loc = b % (hb * wb);
  const int by = loc / wb, bx = loc % wb;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    v[64 + q] = pix_in[by == 0 ? q * S + b : (56 + q) * S + (b - wb)];
    v[72 + q] = pix_in[by == hb - 1 ? (56 + q) * S + b : q * S + (b + wb)];
    v[80 + q] = pix_in[bx == 0 ? (q * 8) * S + b : (q * 8 + 7) * S + (b - 1)];
    v[88 + q] =
        pix_in[bx == wb - 1 ? (q * 8 + 7) * S + b : (q * 8) * S + (b + 1)];
  }

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
    const float r = roundf(__fdiv_rn(a2, a3));  // half away from zero
    const int delta =
        (r >= -2147483648.0f && r < 2147483648.0f) ? (int)r : INT32_MIN;
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

  if (do_rebalance) {
    // AC energy restore (quantsmooth.h:1823-1848), int64 as specref
    // .rebalance_blocks; sums in uint64 so they wrap like numpy's int64.
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
      const u32 mul = (u32)(u64)q64;                  // int truncation
#pragma unroll 7
      for (int k = 1; k < 64; ++k) {
        const int dv = div[k];
        const int a0 = orig_coef(c[k], dv, x1[k], qshr[k]);
        const long long prod = (int)((u32)c[k] * mul);
        c[k] = interval_clamp((int)((prod + 0x1000) >> 13), a0, dv);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 64; ++k) coef_out[k * S + b] = c[k];
  if (pix_out != nullptr) {
    int p[64];
    idct_block(c, p);
#pragma unroll
    for (int k = 0; k < 64; ++k) pix_out[k * S + b] = p[k];
  }
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
