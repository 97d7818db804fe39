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
// The three conv-shaped kernels are one implicit GEMM, never an im2col in
// device memory: output rows m = (n, h', w'), depth k = (dh, dw, ci),
// columns co.  A block of 256 threads owns a tile of rows x 128 columns and
// walks the depth in stages of 32: it gathers its A tile (the input taps,
// zero outside the padding) and its B tile into shared memory with 16-byte
// loads, multiplies them (bf16: WMMA 16x16x16 tensor-core tiles with f32
// accumulators; f32: CUDA-core FMAs, so an f32 call keeps f32 accuracy), and
// at the end parks the f32 result tile in shared memory for its epilogue.
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
// K3b = the same implicit GEMM as K2's main loop, without the IN/GLU
// epilogue, on dz padded by (kh-1-ph, kw-1-pw) with w2 = flip(w) transposed
// to [kh, kw, Cout, Cin] (formed by the wrapper).
// K3c = a GEMM [kh*kw*Cin, N*Ho*Wo] x [N*Ho*Wo, Cout].  On the TPU the
// sequential grid carried the sum; here the depth (313,600 at down4) is
// split across blocks, each block writes an f32 partial, and a second pass
// sums the partials in a fixed order (no atomics).
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// verify CLI's shapes, N = 2450, bf16:
//   K2, K3b, K3c: 2*N*Ho*Wo*kh*kw*Cin*Cout useful FLOPs = 0.987 TFLOP at
//     down4 (Ho*Wo = 128), 1.233 TFLOP at up0 (160): ~1.00 ms and ~1.25 ms
//     on the tensor cores; their bytes (x, z, y or dz, once each) are well
//     under 1 GB (~0.2-0.3 ms), so they are bound by operations.
//   K3a: reads dy and z and writes dz, ~0.80 GB at down4: ~0.24 ms, bound
//     by bytes.
// What the design does about it: the conv kernels run on the tensor cores
// with f32 accumulators and re-read their inputs from L2 rather than
// materialising an im2col; K3a makes two passes over one sample's z and dy
// (the second from L1/L2) and writes dz once.  Stage loads are synchronous
// and single-buffered: a simple kernel first; cp.async/TMA pipelines,
// wgmma and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

extern "C" const char* mrssm_fused_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
