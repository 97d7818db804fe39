// Fused stride-1 conv + train-mode InstanceNorm + GLU for Hopper: the
// forward (K2) and its three backward steps (K3a, K3b, K3c).
//
// Replaces the JAX package's Pallas TPU kernels in ops/fused_codec.py:
//   K2  conv_in_glu_fwd  <- `_fwd_kernel`            (launched by `_fwd_impl`)
//   K3a in_glu_bwd_dz    <- `_bwd_dz_kernel_full`    (launched by `_bwd_impl`)
//   K3b conv_dgrad       <- `_dgrad_kernel`          (launched by `_bwd_impl`)
//   K3c conv_wgrad       <- `_wgrad_kernel`          (launched by `_bwd_impl`)
// The interface is NHWC: x [N, H, W, Cin], w [kh, kw, Cin, Cout] (row-major
// [kh*kw*Cin, Cout]), scale and bias f32 [Cout].  x and w are bf16 or f32;
// every sum accumulates in f32.
//
// The conv-shaped kernels are implicit GEMMs, never an im2col in device
// memory: output rows m = (n, h', w'), depth k = (dh, dw, ci), columns co.
// K3b and K3c have two kernels each; the wrapper picks one by dtype and
// shape before launch:
//   - bf16 with Cin and Cout multiples of 64 (the codec's 256 / 512): the
//     Hopper kernels in namespace `wg` below (cp.async ring + wgmma);
//   - every other case (f32, other channel counts): the WMMA kernels, which
//     K2 also uses.
//
// WMMA kernels (K2, and K3b / K3c outside the case above).  A block of 256
// threads owns a tile of rows x 128 columns and walks the depth in stages
// of 32: it gathers its A tile (the input taps, zero outside the padding)
// and its B tile into shared memory with 16-byte loads, synchronously and
// single-buffered, multiplies them (bf16: WMMA 16x16x16 tensor-core tiles
// with f32 accumulators, each warp 16 columns by all rows; f32: CUDA-core
// FMAs, so an f32 call keeps f32 accuracy), and at the end parks the f32
// result tile in shared memory for its epilogue.
//
// K2 block = one whole sample x a pair of channel tiles [c0, c0+64) and
// [C/2+c0, C/2+c0+64).  InstanceNorm needs each instance's statistics over
// its Ho*Wo <= 256 positions and the GLU pairs channel c with c + C/2, so
// with this ownership the statistics, the affine and the GLU all finish in
// the block's epilogue with no pass across blocks.  (The TPU kernel instead
// took 25-sample VMEM blocks and needed them to divide N; here the edge is
// masked and any N works.)
// K3a block = one sample x 128 channel pairs: the two per-instance means of
// the InstanceNorm backward are block-local by the same ownership.  dscale
// and dbias are sums over all N: each block writes its sample's partials
// and the wrapper sums them, so no float atomics and the result is the same
// bit for bit from run to run.
// K3b = the conv of dz padded by (kh-1-ph, kw-1-pw) with w2 = flip(w)
// transposed to [kh, kw, Cout, Cin] (formed by the wrapper).
// K3c = a GEMM [kh*kw*Cin, N*Ho*Wo] x [N*Ho*Wo, Cout].  On the TPU the
// sequential grid carried the sum; here the depth (313,600 at down4) is
// split across blocks, each block writes an f32 partial, and a second pass
// sums the partials in a fixed order (no atomics): dw is the same bit for
// bit from run to run.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// verify CLI's shapes, N = 2450, bf16:
//   K2, K3b, K3c: the products whose tap lies inside the unpadded input,
//     2*N*Cin*Cout * sum_dh valid_h(dh) * sum_dw valid_w(dw) (94 of 96
//     (h', dh) pairs, and 14 of 16 (w', dw) pairs at down4, 14 of 20 at
//     up0) = 0.845 TFLOP at both stages: ~0.855 ms on the tensor cores;
//     their bytes (x, z, y or dz, once each) are well under 1 GB
//     (~0.2-0.3 ms), so they are bound by operations.  The dense GEMMs over
//     the padding are larger: 2*N*Ho*Wo*kh*kw*Cin*Cout = 0.987 TFLOP at
//     down4 and 1.233 at up0 for K2 and K3c, the other way round for K3b.
//   K3a: reads dy and z and writes dz, ~0.80 GB at down4: ~0.24 ms, bound
//     by bytes.
//
// The Hopper K3b / K3c (bound by operations, so the design keeps the tensor
// cores fed and skips work that is known to be zero):
//   - tile 128 x 256 per block of two warpgroups, one m64n256k16 wgmma per
//     warpgroup and 16 of depth, f32 accumulators in registers (128 a
//     thread); operands in shared memory in wgmma's 128-byte swizzle;
//   - 64-deep stages through a ring of 4 (48 KB each), filled 3 stages
//     ahead with 16-byte cp.async (zero fill for padding and edges) while
//     the tensor cores work: copies overlap the math, and no register holds
//     a tile on its way to shared memory;
//   - addressing by additions: each thread's rows (K3b) or positions (K3c)
//     are decoded once per block; a stage adds one offset per stage (K3b)
//     or steps each position by fixed amounts (K3c);
//   - K3b: a block owns one dx column w and 128 (n, h) rows, so the taps dw
//     whose dz column is padding for that w are skipped as whole stages
//     (down4: 6 of 20 (w, dw) pairs; up0: 2 of 16) -- the GEMM it runs is
//     0.863 TFLOP at down4 and 0.864 at up0, not 1.233 / 0.987 (the h edges
//     are still multiplied: 2 % over the 0.845 bound); dx is written in
//     bf16 from the accumulators;
//   - K3c: the positions run in the order (w', n, h'), so the positions a
//     tap dw reads as padding are whole ranges and a block skips them
//     (down4: 2 of 16 (dw, w') pairs; up0: 6 of 20); grid (24 dw-row tiles,
//     2 column tiles, splits) at the codec's shapes, the split count chosen
//     on the host (ops/fused_codec.py: wgrad_splits) to fill the 132
//     SMs for at least two waves with the least idle tail (11 splits of 446
//     stages at down4: 528 blocks, 4 full waves); f32 partials, summed in a
//     fixed order by the second pass.
// Why not TMA for the tap tiles: a stage is a gather of rows at per-row
// offsets (taps of whole samples, ragged edges, any N), which cp.async
// takes as it comes; the price is the gather's instructions, which the
// additions-only addressing keeps small.  TMA boxes with multicast across a
// cluster (to halve the shared operand's L2 reads) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // GEMM depth per shared-memory stage
constexpr int kBN = 128;       // output columns per block
constexpr int kHalf = 64;      // K2: columns per GLU half in a block
constexpr int kCLd = kBN + 4;  // f32 result tile row stride

template <typename T>
struct Tr;
template <>
struct Tr<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  static constexpr int kPad = 4;  // shared-memory row padding (elements)
  static __device__ float to_f(float v) { return v; }
  static __device__ float from_f(float v) { return v; }
};
template <>
struct Tr<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPad = 8;
  static __device__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16(v);
  }
};

struct ConvGeom {
  int N, H, W, CI;  // input
  int Ho, Wo, CO;   // output
  int kh, kw, ph, pw;
  int K;            // kh * kw * CI
};

// Shared memory of one GEMM block: an A tile, a B tile, and (aliasing both,
// after the main loop) the f32 result tile of BM = 16 * MF rows.
// A_COL == false: A[m][k] stored row by row (row stride ALd);
// A_COL == true: A stored transposed, At[k][m] (K3c's im2col^T).
template <typename T, int MF, bool A_COL>
struct Layout {
  static constexpr int BM = 16 * MF;
  static constexpr int ALd = A_COL ? BM + Tr<T>::kPad : kBK + Tr<T>::kPad;
  static constexpr int AElems = A_COL ? kBK * ALd : BM * ALd;
  static constexpr int BLd = kBN + Tr<T>::kPad;
  static constexpr int BElems = kBK * BLd;
  static constexpr size_t Tiles = (size_t)(AElems + BElems) * sizeof(T);
  static constexpr size_t C = (size_t)BM * kCLd * sizeof(float);
  static constexpr size_t Bytes = Tiles > C ? Tiles : C;
};

// acc(BM x 128) += A(BM x kBK) . B(kBK x 128), rows limited to 16 * mf.
template <typename T, int MF, bool A_COL>
struct Core;

// bf16: warp w owns columns [16w, 16w + 16) and every row fragment.
template <int MF, bool A_COL>
struct Core<__nv_bfloat16, MF, A_COL> {
  using T = __nv_bfloat16;
  using L = Layout<T, MF, A_COL>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  }

  __device__ void step(const T* As, const T* Bs, int mf) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      wmma::load_matrix_sync(b, Bs + kk * L::BLd + 16 * warp, L::BLd);
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (i < mf) {
          if constexpr (A_COL) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
            wmma::load_matrix_sync(a, As + kk * L::ALd + 16 * i, L::ALd);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          } else {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
            wmma::load_matrix_sync(a, As + 16 * i * L::ALd + kk, L::ALd);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
    }
  }

  __device__ void store(float* Cs, int mf) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      if (i < mf) {
        wmma::store_matrix_sync(Cs + 16 * i * kCLd + 16 * warp, acc[i], kCLd,
                                wmma::mem_row_major);
      }
    }
  }
};

// f32: thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 16 i and
// columns tc + 16 j, j < 8.
template <int MF, bool A_COL>
struct Core<float, MF, A_COL> {
  using L = Layout<float, MF, A_COL>;
  float acc[MF][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void step(const float* As, const float* Bs, int mf) {
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll 2
    for (int k = 0; k < kBK; ++k) {
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * L::BLd + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (i < mf) {
          const float a = A_COL ? As[k * L::ALd + tr + 16 * i]
                                : As[(tr + 16 * i) * L::ALd + k];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }

  __device__ void store(float* Cs, int mf) {
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      if (i < mf) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Cs[(tr + 16 * i) * kCLd + tc + 16 * j] = acc[i][j];
      }
    }
  }
};

template <typename T>
__device__ __forceinline__ T zero_of() {
  return Tr<T>::from_f(0.0f);
}

// Column j of a 128-wide B tile -> global column, or -1 outside.  c_half == 0:
// the plain range [c0, c0 + 128); c_half = C/2 > 0 (K2): j < 64 maps to
// c0 + j and j >= 64 to C/2 + c0 + j - 64, for c0 + (j mod 64) < C/2.
__device__ __forceinline__ int col_of(int j, int c0, int CO, int c_half) {
  if (c_half == 0) {
    const int c = c0 + j;
    return c < CO ? c : -1;
  }
  const int jj = j < kHalf ? j : j - kHalf;
  if (c0 + jj >= c_half) return -1;
  return (j < kHalf ? 0 : c_half) + c0 + jj;
}

// B tile rows [r0, r0 + kBK) x 128 columns of the row-major matrix
// src [rows, CO] (the conv weights [K, CO], or dz [M, CO] in K3c), zero
// past `rows` and outside the columns.  vec: 16-byte loads (the column
// count of a half and the pointer allow them).
template <typename T>
__device__ void load_b(T* Bs, const T* __restrict__ src, long long rows,
                       int CO, long long r0, int c0, int c_half, bool vec) {
  constexpr int V = Tr<T>::kVec;
  constexpr int G = kBN / V;
  constexpr int ITERS = kBK * G / kThreads;
  constexpr int LD = kBN + Tr<T>::kPad;
#pragma unroll
  for (int q = 0; q < ITERS; ++q) {
    const int v = threadIdx.x + q * kThreads;
    const int kr = v / G;
    const int j = (v % G) * V;
    const long long r = r0 + kr;
    T* dst = Bs + kr * LD + j;
    if (vec) {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      const int c = col_of(j, c0, CO, c_half);
      if (r < rows && c >= 0)
        val = *reinterpret_cast<const uint4*>(src + r * CO + c);
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      for (int e = 0; e < V; ++e) {
        const int c = col_of(j + e, c0, CO, c_half);
        dst[e] = (r < rows && c >= 0) ? src[r * CO + c] : zero_of<T>();
      }
    }
  }
}

// The A tile of the implicit GEMM, row layout: A[r][k] for block rows r
// (global output rows m0 + r, r < rows_valid) and depth k0 .. k0 + kBK.
// Each thread always loads the same rows, so their (n, h', w') decode is
// done once.
template <typename T, int BM>
struct ConvRows {
  static constexpr int V = Tr<T>::kVec;
  static constexpr int G = kBK / V;
  static constexpr int RSTEP = kThreads / G;
  static constexpr int ITERS = (BM + RSTEP - 1) / RSTEP;
  static constexpr int LD = kBK + Tr<T>::kPad;
  int ho[ITERS], wo[ITERS];
  long long base[ITERS];  // offset of the row's sample in x; -1: no row

  __device__ void init(long long m0, int rows_valid, const ConvGeom& g) {
    const int hw = g.Ho * g.Wo;
#pragma unroll
    for (int q = 0; q < ITERS; ++q) {
      const int r = threadIdx.x / G + q * RSTEP;
      base[q] = -1;
      ho[q] = 0;
      wo[q] = 0;
      if (r < BM && r < rows_valid) {
        const long long m = m0 + r;
        const long long n = m / hw;
        const int rem = static_cast<int>(m - n * hw);
        ho[q] = rem / g.Wo;
        wo[q] = rem - ho[q] * g.Wo;
        base[q] = n * g.H * g.W * g.CI;
      }
    }
  }

  __device__ T tap(const T* __restrict__ x, const ConvGeom& g, int q,
                   int k) const {
    if (base[q] < 0 || k >= g.K) return zero_of<T>();
    const int t = k / g.CI;
    const int ci = k - t * g.CI;
    const int dh = t / g.kw;
    const int hi = ho[q] + dh - g.ph;
    const int wi = wo[q] + (t - dh * g.kw) - g.pw;
    if (hi < 0 || hi >= g.H || wi < 0 || wi >= g.W) return zero_of<T>();
    return x[base[q] + (static_cast<long long>(hi) * g.W + wi) * g.CI + ci];
  }

  __device__ void load(T* As, const T* __restrict__ x, const ConvGeom& g,
                       int k0, bool vec) const {
    const int kg = threadIdx.x % G;
    const int k = k0 + kg * V;
    if (vec) {  // CI % V == 0: the V taps share (dh, dw)
      const bool kvalid = k < g.K;
      const int t = kvalid ? k / g.CI : 0;
      const int ci = k - t * g.CI;
      const int dh = t / g.kw;
      const int dw = t - dh * g.kw;
#pragma unroll
      for (int q = 0; q < ITERS; ++q) {
        const int r = threadIdx.x / G + q * RSTEP;
        if (r >= BM) continue;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        const int hi = ho[q] + dh - g.ph;
        const int wi = wo[q] + dw - g.pw;
        if (kvalid && base[q] >= 0 && hi >= 0 && hi < g.H && wi >= 0 &&
            wi < g.W) {
          val = *reinterpret_cast<const uint4*>(
              x + base[q] + (static_cast<long long>(hi) * g.W + wi) * g.CI +
              ci);
        }
        *reinterpret_cast<uint4*>(As + r * LD + kg * V) = val;
      }
    } else {
#pragma unroll
      for (int q = 0; q < ITERS; ++q) {
        const int r = threadIdx.x / G + q * RSTEP;
        if (r >= BM) continue;
        for (int e = 0; e < V; ++e) As[r * LD + kg * V + e] = tap(x, g, q, k + e);
      }
    }
  }
};

// Main loop shared by K2 and K3b: the f32 tile of output rows m0 ..
// m0 + rows_valid and the 128 columns given by (c0, c_half), left in Cs.
template <typename T, int MF>
__device__ void conv_tile(unsigned char* smem, const T* __restrict__ x,
                          const T* __restrict__ w, const ConvGeom& g,
                          long long m0, int rows_valid, int c0, int c_half,
                          bool vec_a, bool vec_b) {
  using L = Layout<T, MF, false>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + L::AElems;
  const int mf = (rows_valid + 15) / 16;
  ConvRows<T, L::BM> rows;
  rows.init(m0, rows_valid, g);
  Core<T, MF, false> core;
  core.zero();
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    rows.load(As, x, g, k0, vec_a);
    load_b<T>(Bs, w, g.K, g.CO, k0, c0, c_half, vec_b);
    __syncthreads();
    core.step(As, Bs, mf);
    __syncthreads();
  }
  core.store(reinterpret_cast<float*>(smem), mf);  // aliases As / Bs
  __syncthreads();
}

// ---- K2 --------------------------------------------------------------------

template <typename T, int MF>
__global__ void __launch_bounds__(kThreads)
    conv_in_glu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ y,
                           T* __restrict__ z, float* __restrict__ mean_out,
                           float* __restrict__ var_out, ConvGeom g, float eps,
                           bool vec_a, bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][2][kBN];
  __shared__ float aff[2][kBN];
  const int n = blockIdx.x;
  const int c0 = blockIdx.y * kHalf;
  const int C2 = g.CO / 2;
  const int hw = g.Ho * g.Wo;
  conv_tile<T, MF>(smem, x, w, g, static_cast<long long>(n) * hw, hw, c0, C2,
                   vec_a, vec_b);
  const float* Cs = reinterpret_cast<const float*>(smem);

  // per-instance statistics of the tile's 128 columns, two row halves
  const int j = threadIdx.x % kBN;
  const int part = threadIdx.x / kBN;
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = part; r < hw; r += 2) {
    const float v = Cs[r * kCLd + j];
    s1 += v;
    s2 += v * v;
  }
  red[0][part][j] = s1;
  red[1][part][j] = s2;
  __syncthreads();
  if (threadIdx.x < kBN) {
    const float m = (red[0][0][j] + red[0][1][j]) / hw;
    const float var =
        fmaxf((red[1][0][j] + red[1][1][j]) / hw - m * m, 0.0f);
    const int c = col_of(j, c0, g.CO, C2);
    float a = 0.0f, b = 0.0f;
    if (c >= 0) {
      a = scale[c] * rsqrtf(var + eps);
      b = bias[c] - m * a;
      mean_out[static_cast<long long>(n) * g.CO + c] = m;
      var_out[static_cast<long long>(n) * g.CO + c] = var;
    }
    aff[0][j] = a;
    aff[1][j] = b;
  }
  __syncthreads();

  // affine + GLU; y and the pre-norm z in x's dtype
  for (int idx = threadIdx.x; idx < hw * kHalf; idx += kThreads) {
    const int r = idx / kHalf;
    const int jj = idx - r * kHalf;
    const int c = c0 + jj;
    if (c >= C2) continue;
    const float za = Cs[r * kCLd + jj];
    const float zg = Cs[r * kCLd + kHalf + jj];
    const float zna = za * aff[0][jj] + aff[1][jj];
    const float zng = zg * aff[0][kHalf + jj] + aff[1][kHalf + jj];
    const float sig = 1.0f / (1.0f + expf(-zng));
    const long long row = static_cast<long long>(n) * hw + r;
    y[row * C2 + c] = Tr<T>::from_f(zna * sig);
    z[row * g.CO + c] = Tr<T>::from_f(za);
    z[row * g.CO + C2 + c] = Tr<T>::from_f(zg);
  }
}

// ---- K3a -------------------------------------------------------------------

// Block (n, 128 channel pairs): GLU + affine + InstanceNorm backward.
//   zhat = (z - mean) rstd, zn = zhat scale + bias, sig = sigmoid(zn_g),
//   dzn_a = dy sig, dzn_g = dy zn_a sig (1 - sig),
//   dz = rstd (dzn scale - m1 - zhat m2), m1 = mean(dzn scale),
//   m2 = mean(dzn scale zhat) over the sample's positions;
// partial dscale = sum dzn zhat, dbias = sum dzn over the sample.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_glu_bwd_dz_kernel(const T* __restrict__ dy, const T* __restrict__ z,
                         const float* __restrict__ mean,
                         const float* __restrict__ var,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ dz,
                         float* __restrict__ dscale_part,
                         float* __restrict__ dbias_part, int hw, int CO,
                         float eps) {
  __shared__ float red[4][2][kBN];
  const int n = blockIdx.x;
  const int C2 = CO / 2;
  const int jj = threadIdx.x % kBN;
  const int part = threadIdx.x / kBN;
  const int c = blockIdx.y * kBN + jj;
  const bool valid = c < C2;
  const int cg = C2 + c;
  const long long stat = static_cast<long long>(n) * CO;
  float ma = 0.f, ra = 0.f, sa = 0.f, ba = 0.f;
  float mg = 0.f, rg = 0.f, sg = 0.f, bg = 0.f;
  if (valid) {
    ma = mean[stat + c];
    ra = rsqrtf(var[stat + c] + eps);
    sa = scale[c];
    ba = bias[c];
    mg = mean[stat + cg];
    rg = rsqrtf(var[stat + cg] + eps);
    sg = scale[cg];
    bg = bias[cg];
  }
  const long long row0 = static_cast<long long>(n) * hw;
  float s1a = 0.f, s2a = 0.f, s1g = 0.f, s2g = 0.f;
  if (valid) {
    for (int r = part; r < hw; r += 2) {
      const long long row = row0 + r;
      const float zha = (Tr<T>::to_f(z[row * CO + c]) - ma) * ra;
      const float zhg = (Tr<T>::to_f(z[row * CO + cg]) - mg) * rg;
      const float zna = zha * sa + ba;
      const float sig = 1.0f / (1.0f + expf(-(zhg * sg + bg)));
      const float d = Tr<T>::to_f(dy[row * C2 + c]);
      const float dza = d * sig;
      const float dzg = d * zna * sig * (1.0f - sig);
      s1a += dza;
      s2a += dza * zha;
      s1g += dzg;
      s2g += dzg * zhg;
    }
  }
  red[0][part][jj] = s1a;
  red[1][part][jj] = s2a;
  red[2][part][jj] = s1g;
  red[3][part][jj] = s2g;
  __syncthreads();
  if (!valid) return;
  s1a = red[0][0][jj] + red[0][1][jj];
  s2a = red[1][0][jj] + red[1][1][jj];
  s1g = red[2][0][jj] + red[2][1][jj];
  s2g = red[3][0][jj] + red[3][1][jj];
  if (part == 0) {
    dbias_part[stat + c] = s1a;
    dscale_part[stat + c] = s2a;
    dbias_part[stat + cg] = s1g;
    dscale_part[stat + cg] = s2g;
  }
  const float m1a = sa * s1a / hw, m2a = sa * s2a / hw;
  const float m1g = sg * s1g / hw, m2g = sg * s2g / hw;
  for (int r = part; r < hw; r += 2) {
    const long long row = row0 + r;
    const float zha = (Tr<T>::to_f(z[row * CO + c]) - ma) * ra;
    const float zhg = (Tr<T>::to_f(z[row * CO + cg]) - mg) * rg;
    const float zna = zha * sa + ba;
    const float sig = 1.0f / (1.0f + expf(-(zhg * sg + bg)));
    const float d = Tr<T>::to_f(dy[row * C2 + c]);
    const float dza = d * sig;
    const float dzg = d * zna * sig * (1.0f - sig);
    dz[row * CO + c] = Tr<T>::from_f(ra * (dza * sa - m1a - zha * m2a));
    dz[row * CO + cg] = Tr<T>::from_f(rg * (dzg * sg - m1g - zhg * m2g));
  }
}

// ---- K3b -------------------------------------------------------------------

constexpr int kMFDgrad = 8;  // 128 output rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_dgrad_kernel(const T* __restrict__ dz, const T* __restrict__ w2,
                      T* __restrict__ dx, ConvGeom g, bool vec_a,
                      bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BM = 16 * kMFDgrad;
  const long long M = static_cast<long long>(g.N) * g.Ho * g.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int rows = static_cast<int>(M - m0 < BM ? M - m0 : BM);
  const int c0 = blockIdx.y * kBN;
  conv_tile<T, kMFDgrad>(smem, dz, w2, g, m0, rows, c0, 0, vec_a, vec_b);
  const float* Cs = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < rows * kBN; idx += kThreads) {
    const int r = idx / kBN;
    const int j = idx - r * kBN;
    if (c0 + j < g.CO) dx[(m0 + r) * g.CO + c0 + j] = Tr<T>::from_f(Cs[r * kCLd + j]);
  }
}

// ---- K3c -------------------------------------------------------------------

constexpr int kMFWgrad = 8;  // 128 rows of dw's [kh*kw*Cin] per block

// Block (k tile, co tile, depth split s): the f32 partial
//   part[s][k][co] = sum over m in split s of im2col(x)[m][k] dz[m][co].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                      float* __restrict__ part, ConvGeom g,
                      long long per_split, bool vec_a, bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<T, kMFWgrad, true>;
  constexpr int V = Tr<T>::kVec;
  constexpr int G = L::BM / V;           // vectors per depth row
  constexpr int DSTEP = kThreads / G;    // depth rows between a thread's loads
  constexpr int ITERS = kBK / DSTEP;
  T* At = reinterpret_cast<T*>(smem);
  T* Bs = At + L::AElems;
  const int k0 = blockIdx.x * L::BM;
  const int c0 = blockIdx.y * kBN;
  const long long M = static_cast<long long>(g.N) * g.Ho * g.Wo;
  const long long mbeg = blockIdx.z * per_split;
  const long long mend = mbeg + per_split < M ? mbeg + per_split : M;
  const int hw = g.Ho * g.Wo;

  // this thread's depth rows and its V consecutive k, decoded once
  const int kk = (threadIdx.x % G) * V;
  const int k = k0 + kk;
  const bool kvalid = k < g.K;
  const int t = kvalid ? k / g.CI : 0;
  const int ci = k - t * g.CI;
  const int dh = t / g.kw;
  const int dw = t - dh * g.kw;

  Core<T, kMFWgrad, true> core;
  core.zero();
  const int mf = kMFWgrad;
  for (long long ms = mbeg; ms < mend; ms += kBK) {
#pragma unroll
    for (int q = 0; q < ITERS; ++q) {
      const int d = threadIdx.x / G + q * DSTEP;
      const long long m = ms + d;
      T* dst = At + d * L::ALd + kk;
      long long nb = -1;
      int ho = 0, wo = 0;
      if (m < mend) {
        const long long n = m / hw;
        const int rem = static_cast<int>(m - n * hw);
        ho = rem / g.Wo;
        wo = rem - ho * g.Wo;
        nb = n * g.H * g.W * g.CI;
      }
      if (vec_a) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        const int hi = ho + dh - g.ph;
        const int wi = wo + dw - g.pw;
        if (nb >= 0 && kvalid && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
          val = *reinterpret_cast<const uint4*>(
              x + nb + (static_cast<long long>(hi) * g.W + wi) * g.CI + ci);
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        for (int e = 0; e < V; ++e) {
          T val = zero_of<T>();
          const int ke = k + e;
          if (nb >= 0 && ke < g.K) {
            const int te = ke / g.CI;
            const int cie = ke - te * g.CI;
            const int dhe = te / g.kw;
            const int hi = ho + dhe - g.ph;
            const int wi = wo + (te - dhe * g.kw) - g.pw;
            if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
              val = x[nb + (static_cast<long long>(hi) * g.W + wi) * g.CI + cie];
          }
          dst[e] = val;
        }
      }
    }
    load_b<T>(Bs, dz, mend, g.CO, ms, c0, 0, vec_b);
    __syncthreads();
    core.step(At, Bs, mf);
    __syncthreads();
  }
  float* Cs = reinterpret_cast<float*>(smem);
  core.store(Cs, mf);
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.z) * g.K * g.CO;
  for (int idx = threadIdx.x; idx < L::BM * kBN; idx += kThreads) {
    const int r = idx / kBN;
    const int j = idx - r * kBN;
    if (k0 + r < g.K && c0 + j < g.CO)
      out[static_cast<long long>(k0 + r) * g.CO + c0 + j] = Cs[r * kCLd + j];
  }
}

// dw[i] = sum over s in order of part[s][i]: the same bits on every run.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ dw, int splits,
                                    long long count) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += stride) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * count + i];
    dw[i] = s;
  }
}

// ---- K3b, K3c for Hopper: cp.async ring + wgmma ----------------------------
//
// bf16 only, channel counts multiples of 64.  A block of 256 threads (two
// warpgroups) owns a 128 x 256 f32 tile: warpgroup w the rows
// [64 w, 64 w + 64), all 256 columns, one m64n256k16 wgmma per 16 of depth.
// The depth runs in 64-deep stages through a ring of kRing shared-memory
// stages: every thread gathers its share of a stage with 16-byte cp.async
// (zero fill for padding and ragged edges) straight into the 128-byte
// swizzled layout (hopper_wgmma.cuh) kAhead stages ahead of the one the
// tensor cores read, and one wgmma group stays in flight while the next
// gathers are issued.
//
// Ring discipline, at iteration s (stage s lives in slot s % kRing):
//   wait for this thread's copies of stage s; proxy fence; __syncthreads
//     (after it every thread's copies of s are visible to wgmma);
//   issue the four wgmmas of stage s, commit, wait until at most one group
//     (stage s) is pending; __syncthreads (every warpgroup has retired
//     stage s - 1);
//   gather stage s + kAhead into slot (s + kAhead) % kRing = (s - 1) % kRing.
// A thread's gathers run while its wgmma group of stage s is in flight and
// must end before that group retires, or the tensor cores idle: so what a
// thread computes per gather is kept to additions and compares.

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kBM = 128;  // tile rows: two warpgroups x 64
constexpr int kBN = 256;  // tile columns: one n256 wgmma
constexpr int kBK = 64;   // depth per stage (one 128-byte swizzle row)
constexpr int kRing = 4;
constexpr int kAhead = kRing - 1;
constexpr uint32_t kABytes = 2 * hopper::kAtomBytes;  // 128 x 64 bf16
constexpr uint32_t kBBytes = 4 * hopper::kAtomBytes;  // 64 x 256 bf16
constexpr uint32_t kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr size_t kSmemBytes = kRing * kStageBytes + 1024;  // + alignment

// Slot base of stage s, the dynamic shared memory aligned to 1024 bytes (the
// swizzle's period).
__device__ __forceinline__ uint32_t slot(uint32_t base, int s) {
  return base + static_cast<uint32_t>(s % kRing) * kStageBytes;
}

// K3b's B stage: 64 rows of depth from `src` (row-major, `ld` elements per
// row, already offset to the stage's first row and the tile's column c0),
// 256 columns as four MN-major atoms.  Thread t loads chunk t % 8 of atom
// (t / 8) % 4 for rows t / 32 + 8 q.  Columns at or past `cols_left` are
// zero.
__device__ __forceinline__ void load_w2(uint32_t dst, const bf16* src, int ld,
                                        int cols_left) {
  const int c = threadIdx.x & 7;
  const int j = (threadIdx.x >> 3) & 3;
  const int r0 = threadIdx.x >> 5;
  const bool ok = 64 * j < cols_left;
  const bf16* p = src + 64 * j + 8 * c;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = r0 + 8 * q;
    hopper::cp_async16(dst + j * hopper::kAtomBytes + hopper::swizzle128(r, c),
                       ok ? p + static_cast<long long>(r) * ld : src, ok);
  }
}

// The four k16 steps of one stage for this warpgroup.
template <int kTransA>
__device__ __forceinline__ void mma_stage(float (&acc)[128], uint32_t st,
                                          int wgi) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    // A: K-major rows of this warpgroup (k16 = +32 B), or the MN-major atom
    // of its 64 rows (k16 = 16 rows = +2048 B); B: MN-major, 4 atoms.
    const uint64_t da =
        kTransA ? hopper::make_desc(st + wgi * hopper::kAtomBytes + kk * 2048,
                                    hopper::kAtomBytes, 1024)
                : hopper::make_desc(st + wgi * hopper::kAtomBytes + kk * 32,
                                    16, 1024);
    const uint64_t db =
        hopper::make_desc(st + kABytes + kk * 2048, hopper::kAtomBytes, 1024);
    hopper::wgmma_m64n256k16<kTransA, 1>(acc, da, db);
  }
  hopper::wgmma_commit();
}

// Thread t's accumulator fragment -> (row, column) of the 128 x 256 tile:
// rows r and r + 8, columns col + 8 j and col + 8 j + 1.
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

// The ring's main loop (discipline above) over `nst` stages: acc = the sum
// of the stages' products; gather(s) fills stage s's slot.
template <int kTransA, typename Gather>
__device__ __forceinline__ void run_ring(float (&acc)[128], uint32_t base,
                                         int nst, Gather& gather) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  hopper::fence_operands(acc);
  const int wgi = threadIdx.x >> 7;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nst) gather(s);
    hopper::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    hopper::cp_async_wait<kAhead - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    mma_stage<kTransA>(acc, slot(base, s), wgi);
    hopper::wgmma_wait<1>();
    __syncthreads();  // every warpgroup has retired stage s - 1
    if (s + kAhead < nst) gather(s + kAhead);
    hopper::cp_async_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
}

// K3b.  The conv of dz [N, g.H, g.W, g.CI] (padded by (g.ph, g.pw)) with
// w2 [g.K, g.CO] into dx [N, g.Ho, g.Wo, g.CO].  A block owns one dx column
// w and 128 (n, h) rows of it: for that w the taps dw whose dz column
// w + dw - pw lies outside [0, g.W) are zero for every row, so the block
// skips their stages (6 of the 20 (w, dw) pairs at the codec's down4).
// Depth k = (dh, dw, ci) over the remaining taps; A = dz taps, K-major,
// 64 channels of one tap per stage; B = w2 rows, MN-major.  Each thread
// gathers the same four rows in every stage, so their offsets and the taps
// dh that fall inside the rows are set up once; a stage's tap and channel
// offset advance by addition and add one offset to each row's.
__global__ void __launch_bounds__(kThreads, 1)
    conv_dgrad_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ w2,
                      bf16* __restrict__ dx, ConvGeom g) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_addr(smem) + 1023u) & ~1023u;
  const long long rows = static_cast<long long>(g.N) * g.Ho;  // (n, h)
  const int w = blockIdx.x % g.Wo;
  const long long r_base = static_cast<long long>(blockIdx.x / g.Wo) * kBM;
  const int c0 = blockIdx.y * kBN;
  const int cols_left = g.CO - c0;
  const int dw_lo = g.pw - w > 0 ? g.pw - w : 0;
  const int dw_hi = g.W + g.pw - w < g.kw ? g.W + g.pw - w : g.kw;
  const int nst = dw_hi > dw_lo ? g.kh * (dw_hi - dw_lo) * (g.CI / kBK) : 0;

  const int c = threadIdx.x & 7;
  const int r0 = threadIdx.x >> 3;  // rows r0 + 32 q, q < 4
  // per row: the dz offset of tap (0, 0) at this thread's chunk, and the
  // taps dh that land inside [0, g.H) as a bit mask (0: no row)
  long long row_off[4];
  unsigned dh_ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long r = r_base + r0 + 32 * q;
    row_off[q] = 0;
    dh_ok[q] = 0u;
    if (r < rows) {
      const long long n = r / g.Ho;
      const int h = static_cast<int>(r - n * g.Ho);
      row_off[q] = ((n * g.H + h - g.ph) * g.W + w - g.pw) * g.CI + 8 * c;
      for (int dh = 0; dh < g.kh; ++dh) {
        const int hi = h + dh - g.ph;
        if (hi >= 0 && hi < g.H) dh_ok[q] |= 1u << dh;
      }
    }
  }
  int tap_h = 0, tap_w = dw_lo, ci0 = 0;  // the next stage to gather

  auto gather = [&](int s) {
    const uint32_t st = slot(base, s);
    const int tap_off = (tap_h * g.W + tap_w) * g.CI + ci0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (dh_ok[q] >> tap_h) & 1u;
      hopper::cp_async16(st + hopper::swizzle128(r0 + 32 * q, c),
                         ok ? dz + row_off[q] + tap_off : dz, ok);
    }
    const long long k = static_cast<long long>(tap_h * g.kw + tap_w) * g.CI + ci0;
    load_w2(st + kABytes, w2 + k * g.CO + c0, g.CO, cols_left);
    ci0 += kBK;
    if (ci0 == g.CI) {
      ci0 = 0;
      if (++tap_w == dw_hi) {
        tap_w = dw_lo;
        ++tap_h;
      }
    }
  };

  float acc[128];
  run_ring<0>(acc, base, nst, gather);

  const int col = frag_col();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r_base + frag_row() + 8 * half;
    if (r >= rows) continue;
    bf16* out = dx + (r * g.Wo + w) * g.CO + c0 + col;  // r = n Ho + h
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (8 * j < cols_left) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// K3c.  Block (dw rows k0 = 128 x, columns c0 = 256 y, split z): the f32
// partial of x taps^T . dz over its share of the output positions.  The
// positions run in the order j = (w', n, h'), so that the positions whose
// tap column w' + dw - pw lies outside [0, g.W) -- zero for a dw row --
// form whole ranges of j: the block keeps only the w' range that one of its
// two taps reads (at the codec's up0, 6 of the 20 (dw, w') pairs are zero).
// Split z covers j in [z per, (z + 1) per), cut to that range.  Depth runs
// over positions, 64 per stage: A = x taps^T, MN-major (one atom of 64
// channels of one tap per warpgroup), B = dz rows, MN-major.  Thread t
// gathers positions t / 8 and t / 8 + 32 of each stage, for A and for B;
// their (w', n, h') and x and dz offsets are decoded once and then advanced
// by 64 positions per stage with additions and carries (the split of 64
// into columns, samples and rows), no division or multiplication.
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                      float* __restrict__ part, ConvGeom g, long long per) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (hopper::smem_addr(smem) + 1023u) & ~1023u;
  const long long nho = static_cast<long long>(g.N) * g.Ho;  // j per column
  const int k0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  const int cols_left = g.CO - c0;

  const int c = threadIdx.x & 7;
  const int p0 = threadIdx.x >> 3;  // positions p0, p0 + 32 of a stage
  // the two 64-channel atoms of this block's 128 dw rows: tap and channel,
  // and the union of the w' ranges their taps read
  int dy[2], dxo[2], ci[2];
  bool k_ok[2];
  int wlo = g.Wo, whi = 0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int k = k0 + 64 * a;
    k_ok[a] = k < g.K;
    const int t = k_ok[a] ? k / g.CI : 0;
    const int dh = t / g.kw;
    dy[a] = dh - g.ph;
    dxo[a] = t - dh * g.kw - g.pw;
    ci[a] = k - t * g.CI + 8 * c;
    if (k_ok[a]) {
      const int lo = -dxo[a] > 0 ? -dxo[a] : 0;
      const int hi = g.W - dxo[a] < g.Wo ? g.W - dxo[a] : g.Wo;
      wlo = lo < wlo ? lo : wlo;
      whi = hi > whi ? hi : whi;
    }
  }
  long long jb = static_cast<long long>(blockIdx.z) * per;
  long long je = jb + per;
  if (jb < wlo * nho) jb = wlo * nho;
  if (je > whi * nho) je = whi * nho;
  const int nst = je > jb ? static_cast<int>((je - jb + kBK - 1) / kBK) : 0;

  // 64 positions = step_w columns + step_n samples + step_h rows; a stage
  // moves each position's x and dz offsets by fixed amounts, plus fixed
  // carries when its row passes g.Ho or its sample passes N
  const int step_w = static_cast<int>(kBK / nho);
  const int step_n = static_cast<int>((kBK - step_w * nho) / g.Ho);
  const int step_h = static_cast<int>(kBK - step_w * nho - step_n * g.Ho);
  const long long x_sample = static_cast<long long>(g.H) * g.W * g.CI;
  const long long z_sample = static_cast<long long>(g.Ho) * g.Wo * g.CO;
  const long long x_step = step_n * x_sample +
                           static_cast<long long>(step_h) * g.W * g.CI +
                           static_cast<long long>(step_w) * g.CI;
  const long long z_step = step_n * z_sample +
                           static_cast<long long>(step_h) * g.Wo * g.CO +
                           static_cast<long long>(step_w) * g.CO;
  const long long x_carry_h = static_cast<long long>(g.H - g.Ho) * g.W * g.CI;
  const long long x_carry_n = g.CI - g.N * x_sample;
  const long long z_carry_n = g.CO - g.N * z_sample;
  // per atom: the x offset of its tap and channels from a position's own
  int a_off[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) a_off[a] = (dy[a] * g.W + dxo[a]) * g.CI + ci[a];
  long long pj[2], x_off[2], z_off[2];
  int pos_w[2], pos_n[2], pos_h[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    pj[q] = jb + p0 + 32 * q;
    pos_w[q] = static_cast<int>(pj[q] / nho);
    const long long rest = pj[q] - pos_w[q] * nho;
    pos_n[q] = static_cast<int>(rest / g.Ho);
    pos_h[q] = static_cast<int>(rest - static_cast<long long>(pos_n[q]) * g.Ho);
    x_off[q] = ((static_cast<long long>(pos_n[q]) * g.H + pos_h[q]) * g.W + pos_w[q]) *
               g.CI;
    z_off[q] = ((static_cast<long long>(pos_n[q]) * g.Ho + pos_h[q]) * g.Wo +
                pos_w[q]) * g.CO + c0 + 8 * c;
  }

  auto gather = [&](int s) {
    const uint32_t st = slot(base, s);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool j_ok = pj[q] < je;
      const uint32_t row = hopper::swizzle128(p0 + 32 * q, c);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int hi = pos_h[q] + dy[a];
        const int wi = pos_w[q] + dxo[a];
        const bool ok = j_ok && k_ok[a] && hi >= 0 && hi < g.H && wi >= 0 &&
                        wi < g.W;
        hopper::cp_async16(st + a * hopper::kAtomBytes + row,
                           ok ? x + x_off[q] + a_off[a] : x, ok);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = j_ok && 64 * jj < cols_left;
        hopper::cp_async16(st + kABytes + jj * hopper::kAtomBytes + row,
                           ok ? dz + z_off[q] + 64 * jj : dz, ok);
      }
      // advance this position by one stage
      pj[q] += kBK;
      x_off[q] += x_step;
      z_off[q] += z_step;
      pos_h[q] += step_h;
      if (pos_h[q] >= g.Ho) {  // next sample, same column
        pos_h[q] -= g.Ho;
        ++pos_n[q];
        x_off[q] += x_carry_h;
      }
      pos_n[q] += step_n;
      if (pos_n[q] >= g.N) {  // next column, first sample
        pos_n[q] -= g.N;
        ++pos_w[q];
        x_off[q] += x_carry_n;
        z_off[q] += z_carry_n;
      }
      pos_w[q] += step_w;
    }
  };

  float acc[128];
  run_ring<1>(acc, base, nst, gather);

  float* out = part + static_cast<long long>(blockIdx.z) * g.K * g.CO;
  const int row = frag_row();
  const int col = frag_col();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = k0 + row + 8 * half;
    if (k >= g.K) continue;
    float* o = out + static_cast<long long>(k) * g.CO + c0 + col;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (8 * j < cols_left) {
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

}  // namespace wg

// ---- host side ---------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

ConvGeom make_geom(int N, int H, int W, int CI, int kh, int kw, int CO,
                   int ph, int pw) {
  ConvGeom g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.CI = CI;
  g.kh = kh;
  g.kw = kw;
  g.CO = CO;
  g.ph = ph;
  g.pw = pw;
  g.Ho = H + 2 * ph - kh + 1;
  g.Wo = W + 2 * pw - kw + 1;
  g.K = kh * kw * CI;
  return g;
}

template <typename T, int MF>
cudaError_t fwd_launch(const void* x, const void* w, const float* scale,
                       const float* bias, void* y, void* z, float* mean,
                       float* var, const ConvGeom& g, float eps,
                       cudaStream_t s) {
  using L = Layout<T, MF, false>;
  auto kernel = conv_in_glu_fwd_kernel<T, MF>;
  cudaError_t err = set_smem(kernel, L::Bytes);
  if (err != cudaSuccess) return err;
  const int C2 = g.CO / 2;
  const bool vec_a = g.CI % Tr<T>::kVec == 0 && aligned16(x);
  const bool vec_b = C2 % Tr<T>::kVec == 0 && aligned16(w);
  dim3 grid(g.N, (C2 + kHalf - 1) / kHalf);
  kernel<<<grid, kThreads, L::Bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<T*>(y), static_cast<T*>(z), mean, var, g, eps, vec_a, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dispatch(const void* x, const void* w, const float* scale,
                         const float* bias, void* y, void* z, float* mean,
                         float* var, const ConvGeom& g, float eps,
                         cudaStream_t s) {
  const int mf = (g.Ho * g.Wo + 15) / 16;
  if (mf <= 4) return fwd_launch<T, 4>(x, w, scale, bias, y, z, mean, var, g, eps, s);
  if (mf <= 8) return fwd_launch<T, 8>(x, w, scale, bias, y, z, mean, var, g, eps, s);
  if (mf <= 10) return fwd_launch<T, 10>(x, w, scale, bias, y, z, mean, var, g, eps, s);
  if (mf <= 16) return fwd_launch<T, 16>(x, w, scale, bias, y, z, mean, var, g, eps, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dgrad_launch(const void* dz, const void* w2, void* dx,
                         const ConvGeom& g, cudaStream_t s) {
  using L = Layout<T, kMFDgrad, false>;
  auto kernel = conv_dgrad_kernel<T>;
  cudaError_t err = set_smem(kernel, L::Bytes);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(g.N) * g.Ho * g.Wo;
  const bool vec_a = g.CI % Tr<T>::kVec == 0 && aligned16(dz);
  const bool vec_b = g.CO % Tr<T>::kVec == 0 && aligned16(w2);
  dim3 grid(static_cast<unsigned>((M + L::BM - 1) / L::BM),
            (g.CO + kBN - 1) / kBN);
  kernel<<<grid, kThreads, L::Bytes, s>>>(static_cast<const T*>(dz),
                                          static_cast<const T*>(w2),
                                          static_cast<T*>(dx), g, vec_a, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wgrad_launch(const void* x, const void* dz, float* part,
                         float* dw, const ConvGeom& g, int splits,
                         long long per_split, cudaStream_t s) {
  using L = Layout<T, kMFWgrad, true>;
  auto kernel = conv_wgrad_kernel<T>;
  cudaError_t err = set_smem(kernel, L::Bytes);
  if (err != cudaSuccess) return err;
  const bool vec_a = g.CI % Tr<T>::kVec == 0 && aligned16(x);
  const bool vec_b = g.CO % Tr<T>::kVec == 0 && aligned16(dz);
  dim3 grid((g.K + L::BM - 1) / L::BM, (g.CO + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, L::Bytes, s>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(dz), part, g,
                                          per_split, vec_a, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(g.K) * g.CO;
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  wgrad_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      part, dw, splits, count);
  return cudaGetLastError();
}

// What the wgmma kernels take: channel counts that are multiples of 64 (so
// a 64-deep stage is one tap's channels and a 64-column atom is all valid
// or all masked), kh <= 32 (K3b's tap mask) and 16-byte-aligned tensors.
// The wrapper (ops/fused_codec.py: uses_wgmma) chooses the variant by this
// rule; here it only guards the entry points with an error code.
bool wgmma_shape_ok(const ConvGeom& g, const void* a, const void* b,
                    const void* c) {
  return g.CI % 64 == 0 && g.CO % 64 == 0 && g.kh <= 32 && aligned16(a) &&
         aligned16(b) && aligned16(c);
}

}  // namespace

// Every entry point: dtype 0 = f32, 1 = bf16 (x, w, y, z, dy, dz, dx);
// scale, bias, mean, var and partials are f32.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (0 on success).

// K2.  x [N, H, W, CI], w [kh, kw, CI, CO] -> y [N, Ho, Wo, CO/2],
// z [N, Ho, Wo, CO], mean and var [N, CO].  Needs Ho * Wo <= 256.
extern "C" int mrssm_conv_in_glu_fwd(int dtype, const void* x, const void* w,
                                     const float* scale, const float* bias,
                                     void* y, void* z, float* mean,
                                     float* var, int N, int H, int W, int CI,
                                     int kh, int kw, int CO, int ph, int pw,
                                     float eps, void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? fwd_dispatch<__nv_bfloat16>(x, w, scale, bias, y, z, mean,
                                               var, g, eps, s)
                 : fwd_dispatch<float>(x, w, scale, bias, y, z, mean, var, g,
                                       eps, s);
  return static_cast<int>(err);
}

// K3a.  dy [N, hw, CO/2], z [N, hw, CO], mean and var [N, CO] -> dz
// [N, hw, CO] and the per-sample partials dscale_part, dbias_part [N, CO].
extern "C" int mrssm_in_glu_bwd_dz(int dtype, const void* dy, const void* z,
                                   const float* mean, const float* var,
                                   const float* scale, const float* bias,
                                   void* dz, float* dscale_part,
                                   float* dbias_part, int N, int hw, int CO,
                                   float eps, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(N, (CO / 2 + kBN - 1) / kBN);
  if (dtype == 1) {
    in_glu_bwd_dz_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(z), mean, var, scale, bias,
        static_cast<__nv_bfloat16*>(dz), dscale_part, dbias_part, hw, CO, eps);
  } else {
    in_glu_bwd_dz_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(z), mean, var,
        scale, bias, static_cast<float*>(dz), dscale_part, dbias_part, hw, CO,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3b.  A stride-1 conv: dz [N, H, W, CI] (here the forward's output and
// Cout) with w2 [kh, kw, CI, CO] and padding (ph, pw) -> dx [N, Ho, Wo, CO].
extern "C" int mrssm_conv_dgrad(int dtype, const void* dz, const void* w2,
                                void* dx, int N, int H, int W, int CI, int kh,
                                int kw, int CO, int ph, int pw, void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dgrad_launch<__nv_bfloat16>(dz, w2, dx, g, s)
                 : dgrad_launch<float>(dz, w2, dx, g, s);
  return static_cast<int>(err);
}

// K3c.  x [N, H, W, CI], dz [N, Ho, Wo, CO] -> dw f32 [kh, kw, CI, CO],
// through part f32 [splits, kh*kw*CI, CO]; split s covers the output rows
// [s * per_split, (s + 1) * per_split) (per_split a multiple of 32).
extern "C" int mrssm_conv_wgrad(int dtype, const void* x, const void* dz,
                                float* part, float* dw, int N, int H, int W,
                                int CI, int kh, int kw, int CO, int ph, int pw,
                                int splits, long long per_split,
                                void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0 || splits <= 0 || per_split % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? wgrad_launch<__nv_bfloat16>(x, dz, part, dw, g, splits, per_split, s)
          : wgrad_launch<float>(x, dz, part, dw, g, splits, per_split, s);
  return static_cast<int>(err);
}

// K3b on Hopper (wgmma).  bf16 only; the arguments of mrssm_conv_dgrad, with
// CI (dz's channels) and CO (dx's) multiples of 64.
extern "C" int mrssm_conv_dgrad_wgmma(const void* dz, const void* w2, void* dx,
                                      int N, int H, int W, int CI, int kh,
                                      int kw, int CO, int ph, int pw,
                                      void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0) return 0;
  if (!wgmma_shape_ok(g, dz, w2, dx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(wg::conv_dgrad_kernel, wg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(g.N) * g.Ho;
  dim3 grid(static_cast<unsigned>((rows + wg::kBM - 1) / wg::kBM * g.Wo),
            (g.CO + wg::kBN - 1) / wg::kBN);
  wg::conv_dgrad_kernel<<<grid, wg::kThreads, wg::kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dz),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(dx),
      g);
  return static_cast<int>(cudaGetLastError());
}

// K3c on Hopper (wgmma).  bf16 only; the arguments of mrssm_conv_wgrad, with
// CI and CO multiples of 64 and per_split a multiple of 64 (whole stages).
extern "C" int mrssm_conv_wgrad_wgmma(const void* x, const void* dz,
                                      float* part, float* dw, int N, int H,
                                      int W, int CI, int kh, int kw, int CO,
                                      int ph, int pw, int splits,
                                      long long per_split, void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0 || splits <= 0 || per_split % wg::kBK != 0 ||
      !wgmma_shape_ok(g, x, dz, part))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem(wg::conv_wgrad_kernel, wg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((g.K + wg::kBM - 1) / wg::kBM, (g.CO + wg::kBN - 1) / wg::kBN,
            splits);
  wg::conv_wgrad_kernel<<<grid, wg::kThreads, wg::kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dz), part, g, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = static_cast<long long>(g.K) * g.CO;
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  wgrad_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      part, dw, splits, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mrssm_fused_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
