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
// K2, K3b and K3c have two kernels each; the wrapper picks one by dtype and
// shape before launch (ops/fused_codec.py: fwd_uses_wgmma, uses_wgmma):
//   - bf16 with the channel counts multiples of 64 (Cin and Cout / 2 for
//     K2, Cin and Cout for K3b / K3c; the codec's 256 / 512): the Hopper
//     kernels in namespace `wg` below (wgmma, operands by TMA for K2 and by
//     a cp.async ring for K3b / K3c);
//   - every other case (f32, other channel counts): the WMMA kernels.
// K3a has one kernel for both dtypes.
//
// WMMA kernels (K2, K3b, K3c outside the case above).  A block of 256
// threads owns a tile of rows x 128 columns and walks the depth in stages
// of 32: it gathers its A tile (the input taps, zero outside the padding)
// and its B tile into shared memory with 16-byte loads, synchronously and
// single-buffered, multiplies them (bf16: WMMA 16x16x16 tensor-core tiles
// with f32 accumulators, each warp 16 columns by all rows; f32: CUDA-core
// FMAs, so an f32 call keeps f32 accuracy), and at the end parks the f32
// result tile in shared memory for its epilogue.  The WMMA K2 block is one
// whole sample x the channel tiles [c0, c0+64) and [C/2+c0, C/2+c0+64).
//
// Ownership, for every K2 and K3a kernel: InstanceNorm needs each
// instance's statistics over its Ho*Wo <= 256 positions and the GLU pairs
// channel c with c + C/2, so a block owns whole samples and matching value
// and gate channels; the statistics, the affine and the GLU (and the two
// per-instance means of the backward) finish inside the block, with no
// pass across blocks.  (The TPU kernel took 25-sample VMEM blocks and
// needed them to divide N; here any N works.)  dscale and dbias are sums
// over all N: K3a writes per-sample partials and the wrapper sums them, so
// no float atomics and the result is the same bit for bit from run to run.
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
//     K2 owns whole samples, so its padded taps are never whole stages: it
//     runs the dense GEMM, whose floor is 1.00 / 1.25 ms.
//   K3a: reads dy and z once and writes dz once, 0.80 GB at down4 and
//     1.0 GB at up0: 0.24 / 0.30 ms, bound by bytes.
//
// The Hopper K2 (bound by operations; the design keeps the tensor cores
// fed and every other thread's instructions off them):
//   - channels are wgmma's M and the sample's positions its N, so a sample
//     of 128 (down4) or 160 (up0) positions wastes no row (positions as M
//     would round 160 up to 192); a block of two warpgroups owns one sample
//     and 2 x 64 channel pairs, warpgroup w the value channels of pair tile
//     w and the matching gate channels, as two m64nNk16 wgmmas per 16 of
//     depth on one B (N = 128 / 160 positions rounded up to 32; 2 x N / 2
//     f32 accumulators a thread); past 160 positions the two warpgroups
//     split the positions instead (FwdTile);
//   - the operands come by TMA, not by each thread's cp.async: w as 64 x 64
//     boxes of [K][Cout] (MN-major atoms), x as a [1][Ho][Wo][64] box of
//     [N][H][W][Cin] at the tap's offset, whose rows are the sample's
//     positions in order and whose rows outside x the copy engine fills
//     with zeros (the padding, for free).  Thread 0 starts a stage's 3-5
//     copies on a full barrier (mbarrier) that counts their bytes; a ring
//     of 4 stages of 48 / 52 KB, loaded 3 ahead.  Gathering the stages
//     with cp.async by every thread (K3b's ring) instead costs ~300
//     instructions a thread per stage, and those, not the bytes, held the
//     tensor cores back;
//   - statistics from the f32 accumulators: a channel is an accumulator
//     row, so its sum and sum of squares are in-thread sums plus a shuffle
//     across the row's 4 lanes; the value and gate of a (channel, position)
//     are in the same thread, so the affine and the GLU need no exchange;
//   - z and y leave through swizzled [position][64] tiles in the ring's
//     space and go out in 16-byte rows (no scattered 2-byte stores).
//
// The K3a kernel (bound by bytes): one block per (sample, 4 V channel
// pairs), 4 ceil(Ho*Wo / 2) threads, two rows a thread: dy and both z
// halves are read once with 16-byte loads, all in flight before the first use
// and held in registers through the reduction, and dz is written once in
// 16-byte stores; the per-channel constants are laid out so that a warp
// reads them without bank conflicts (see the kernel).
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
// Their stages are gathers at per-row offsets that skip padded taps, which
// cp.async takes as it comes; K2's TMA ring (above) is the way to take the
// gather's instructions off them too.

#include <cuda.h>
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
  using Raw = uint32_t;
  static constexpr int kVec = 4;  // elements per 16-byte vector
  static constexpr int kPad = 4;  // shared-memory row padding (elements)
  static __device__ float to_f(float v) { return v; }
  static __device__ float from_f(float v) { return v; }
};
template <>
struct Tr<__nv_bfloat16> {
  using Raw = unsigned short;
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

constexpr int kDzColT = 4;          // K3a: threads a row
constexpr int kDzMaxThreads = 512;  // K3a: 4 x 256 / 2, at MAX_POSITIONS

// A row's 16 bytes, V elements of T, as four 32-bit words (bf16: two
// elements a word, the lower one first).
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_word(uint4& v, int k, uint32_t u) {
  if (k == 0) v.x = u;
  else if (k == 1) v.y = u;
  else if (k == 2) v.z = u;
  else v.w = u;
}

template <typename T>
__device__ __forceinline__ float unpack(const uint4& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(v, e));
  } else {
    const uint32_t u = word(v, e >> 1);
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
}

// The word of elements o[0..] (one f32, or two bf16 rounded to nearest).
template <typename T>
__device__ __forceinline__ uint32_t pack(const float* o) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(o[0]);
  } else {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(o[0]))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(o[1])))
            << 16);
  }
}

// 16 bytes from p: one load where `vec` (the row allows 16-byte loads),
// else the first `valid` elements one by one and zeros past them.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ p, int valid,
                                        bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  using Raw = typename Tr<T>::Raw;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int e = 0; e < Tr<T>::kVec; ++e) {
    if (e < valid) {
      const uint32_t u = reinterpret_cast<const Raw*>(p)[e];
      const int k = e * sizeof(T) / 4;
      set_word(v, k, word(v, k) | (u << (8 * ((e * sizeof(T)) % 4))));
    }
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p, const uint4& v,
                                        int valid, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  using Raw = typename Tr<T>::Raw;
#pragma unroll
  for (int e = 0; e < Tr<T>::kVec; ++e) {
    if (e < valid) {
      reinterpret_cast<Raw*>(p)[e] = static_cast<Raw>(
          word(v, e * sizeof(T) / 4) >> (8 * ((e * sizeof(T)) % 4)));
    }
  }
}

// Block (4 V channel pairs, sample n): GLU + affine + InstanceNorm backward.
//   zhat = (z - mean) rstd, zn = zhat scale + bias, sig = sigmoid(zn_g),
//   dzn_a = dy sig, dzn_g = dy zn_a sig (1 - sig),
//   dz = rstd (dzn scale - m1 - zhat m2), m1 = mean(dzn scale),
//   m2 = mean(dzn scale zhat) over the sample's positions;
// partial dscale = sum dzn zhat, dbias = sum dzn over the sample.
// The block has 4 ceil(hw / 2) threads (rounded up to whole warps): thread
// t owns the 16-byte column t % 4 (V channel pairs) of rows t / 4 and
// t / 4 + blockDim / 4.  It loads its dy, z value and z gate chunks once,
// all before the first use, and keeps them in registers through both
// passes; the sums go through a shuffle across the warp's 8 row groups and
// a fixed-order sum over the warps; dz is stored once, 16 bytes a store.
// The per-channel constants sit in shared memory as [value, gate][e][j]
// (pair V j + e of the tile), so a warp's 4 column threads read 4
// neighbouring float4s: stored as [pair] they were 256 bytes apart, a
// 4-way bank conflict on each of a thread's ~50 reads, which held the
// kernel to half its memory rate.  zhat = z rstd - mean rstd and
// dz = dzn k1 - zhat k2 - k3 fold those constants.
template <typename T>
__global__ void __launch_bounds__(kDzMaxThreads)
    in_glu_bwd_dz_kernel(const T* __restrict__ dy, const T* __restrict__ z,
                       const float* __restrict__ mean,
                       const float* __restrict__ var,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ dz,
                       float* __restrict__ dscale_part,
                       float* __restrict__ dbias_part, int hw, int CO,
                       float eps, bool vec) {
  constexpr int V = Tr<T>::kVec;
  constexpr int kRows = 2;                 // rows a thread
  constexpr int kCols = kDzColT * V;       // channel pairs per block
  constexpr int kPer = 4 / sizeof(T);      // elements per word
  // per pair: (rstd, -mean rstd, scale, bias), then after the sums
  // (rstd scale, rstd m2, rstd m1, 0), for the value and the gate half
  __shared__ float4 prm[2][kCols];
  __shared__ float4 red[kDzMaxThreads / 32][kCols];  // per warp: s1a..s2g
  __shared__ float4 mom[2][kCols];
  auto at = [](int pair) { return (pair % V) * kDzColT + pair / V; };
  const int row_step = blockDim.x / kDzColT;
  const int warps = blockDim.x / 32;
  const int n = blockIdx.y;
  const int C2 = CO / 2;
  const int c0 = blockIdx.x * kCols;
  const long long stat = static_cast<long long>(n) * CO;
  const int j = threadIdx.x % kDzColT;
  const int r0 = threadIdx.x / kDzColT;
  const int cj = c0 + V * j;
  const int valid = C2 - cj < V ? C2 - cj : V;
  const long long row0 = static_cast<long long>(n) * hw;
  uint4 za[kRows], zg[kRows], d[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    za[i] = zg[i] = d[i] = make_uint4(0u, 0u, 0u, 0u);
    const int r = r0 + row_step * i;
    if (r < hw && valid > 0) {
      const long long row = row0 + r;
      za[i] = load16(z + row * CO + cj, valid, vec);
      zg[i] = load16(z + row * CO + C2 + cj, valid, vec);
      d[i] = load16(dy + row * C2 + cj, valid, vec);
    }
  }
  for (int i = threadIdx.x; i < 2 * kCols; i += blockDim.x) {
    const int half = i / kCols;
    const int c = c0 + i - half * kCols;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C2) {
      const int cc = c + half * C2;
      const float r = rsqrtf(var[stat + cc] + eps);
      q = make_float4(r, -mean[stat + cc] * r, scale[cc], bias[cc]);
    }
    prm[half][at(i - half * kCols)] = q;
  }
  __syncthreads();

  // pass 1: per channel, the four sums over this thread's rows (zero rows
  // and channels past the edge add nothing: their dy is 0)
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float4 pa = prm[0][e * kDzColT + j];
    const float4 pg = prm[1][e * kDzColT + j];
    float s1a = 0.f, s2a = 0.f, s1g = 0.f, s2g = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float zha = fmaf(unpack<T>(za[i], e), pa.x, pa.y);
      const float zhg = fmaf(unpack<T>(zg[i], e), pg.x, pg.y);
      const float sig =
          __fdividef(1.0f, 1.0f + __expf(-fmaf(zhg, pg.z, pg.w)));
      const float dd = unpack<T>(d[i], e);
      const float dza = dd * sig;
      const float dzg = dd * fmaf(zha, pa.z, pa.w) * fmaf(-sig, sig, sig);
      s1a += dza;
      s2a = fmaf(dza, zha, s2a);
      s1g += dzg;
      s2g = fmaf(dzg, zhg, s2g);
    }
#pragma unroll
    for (int o = kDzColT; o < 32; o <<= 1) {
      s1a += __shfl_xor_sync(0xffffffffu, s1a, o);
      s2a += __shfl_xor_sync(0xffffffffu, s2a, o);
      s1g += __shfl_xor_sync(0xffffffffu, s1g, o);
      s2g += __shfl_xor_sync(0xffffffffu, s2g, o);
    }
    if ((threadIdx.x & 31) < kDzColT)
      red[warp][e * kDzColT + j] = make_float4(s1a, s2a, s1g, s2g);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCols; i += blockDim.x) {
    const int a = at(i);
    float4 sm = red[0][a];
    for (int k = 1; k < warps; ++k) {
      sm.x += red[k][a].x;
      sm.y += red[k][a].y;
      sm.z += red[k][a].z;
      sm.w += red[k][a].w;
    }
    const int c = c0 + i;
    if (c < C2) {
      dbias_part[stat + c] = sm.x;
      dscale_part[stat + c] = sm.y;
      dbias_part[stat + C2 + c] = sm.z;
      dscale_part[stat + C2 + c] = sm.w;
    }
    const float4 pa = prm[0][a], pg = prm[1][a];
    mom[0][a] = make_float4(pa.x * pa.z, pa.x * (pa.z * sm.y / hw),
                            pa.x * (pa.z * sm.x / hw), 0.f);
    mom[1][a] = make_float4(pg.x * pg.z, pg.x * (pg.z * sm.w / hw),
                            pg.x * (pg.z * sm.z / hw), 0.f);
  }
  __syncthreads();
  // pass 2 recomputes zhat, sig and dzn from the loaded words: holding
  // pass 1's values instead would take ~5 registers an element
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    asm volatile("" : "+r"(za[i].x), "+r"(za[i].y), "+r"(za[i].z), "+r"(za[i].w));
    asm volatile("" : "+r"(zg[i].x), "+r"(zg[i].y), "+r"(zg[i].z), "+r"(zg[i].w));
    asm volatile("" : "+r"(d[i].x), "+r"(d[i].y), "+r"(d[i].z), "+r"(d[i].w));
  }

  // pass 2: dz, word by word in place of z's words, then one store a row
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4 pa[kPer], pg[kPer], ma[kPer], mg[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int col = (k * kPer + u) * kDzColT + j;
      pa[u] = prm[0][col];
      pg[u] = prm[1][col];
      ma[u] = mom[0][col];
      mg[u] = mom[1][col];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float oa[kPer], og[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = k * kPer + u;
        const float zha = fmaf(unpack<T>(za[i], e), pa[u].x, pa[u].y);
        const float zhg = fmaf(unpack<T>(zg[i], e), pg[u].x, pg[u].y);
        const float sig =
            __fdividef(1.0f, 1.0f + __expf(-fmaf(zhg, pg[u].z, pg[u].w)));
        const float dd = unpack<T>(d[i], e);
        const float dzg =
            dd * fmaf(zha, pa[u].z, pa[u].w) * fmaf(-sig, sig, sig);
        oa[u] = fmaf(dd * sig, ma[u].x, -fmaf(zha, ma[u].y, ma[u].z));
        og[u] = fmaf(dzg, mg[u].x, -fmaf(zhg, mg[u].y, mg[u].z));
      }
      set_word(za[i], k, pack<T>(oa));
      set_word(zg[i], k, pack<T>(og));
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + row_step * i;
    if (r < hw && valid > 0) {
      const long long row = row0 + r;
      store16(dz + row * CO + cj, za[i], valid, vec);
      store16(dz + row * CO + C2 + cj, zg[i], valid, vec);
    }
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

// ---- K2, K3b, K3c for Hopper: a ring of stages + wgmma ---------------------
//
// bf16 only, channel counts multiples of 64.  A block of 256 threads is two
// warpgroups; each keeps its f32 accumulators in registers and runs
// m64nNk16 wgmmas on operands in shared memory.  The depth runs in 64-deep
// stages through a ring of shared-memory slots in the 128-byte swizzled
// layout (hopper_wgmma.cuh), all but one slot ahead of the one the tensor
// cores read, and one wgmma group stays in flight while the next stage is
// loaded.  K2 loads a stage by TMA (conv_in_glu_fwd_kernel); K3b and K3c
// have every thread gather its share with 16-byte cp.async (zero fill for
// padding and ragged edges).
//
// K3b's and K3c's ring discipline (run_ring), at iteration s (stage s in
// slot s % kRing):
//   wait for this thread's copies of stage s; proxy fence; __syncthreads
//     (after it every thread's copies of s are visible to wgmma);
//   start the wgmmas of stage s, commit, wait until at most one group
//     (stage s) is pending; __syncthreads (every warpgroup has retired
//     stage s - 1);
//   gather stage s + kAhead into slot (s + kAhead) % kRing = (s - 1) % kRing.
// A thread's gathers run while its wgmma group of stage s is in flight and
// must end before that group retires, or the tensor cores idle: so what a
// thread computes per gather is kept to additions and compares.
//
// K3b and K3c: a 128 x 256 tile per block, warpgroup w the rows
// [64 w, 64 w + 64), all 256 columns, one m64n256k16 wgmma per 16 of depth;
// a ring of 4 slots of 48 KB.

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kBM = 128;  // K3b / K3c tile rows: two warpgroups x 64
constexpr int kBN = 256;  // K3b / K3c tile columns: one n256 wgmma
constexpr int kBK = 64;   // depth per stage (one 128-byte swizzle row)
constexpr int kRing = 4;  // ring slots
constexpr int kAhead = kRing - 1;
constexpr uint32_t kABytes = 2 * hopper::kAtomBytes;  // 128 x 64 bf16
constexpr uint32_t kBBytes = 4 * hopper::kAtomBytes;  // 64 x 256 bf16
constexpr uint32_t kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr size_t kSmemBytes = kRing * kStageBytes + 1024;  // + alignment

// The dynamic shared memory's first address aligned to 1024 bytes (the
// swizzle's period).
__device__ __forceinline__ uint32_t ring_base(const void* smem) {
  return (hopper::smem_addr(smem) + 1023u) & ~1023u;
}

// K3b's / K3c's slot base of stage s.
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
    hopper::wgmma<kBN, kTransA, 1>(acc, da, db);
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
  const uint32_t base = ring_base(smem);
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
  const uint32_t base = ring_base(smem);
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

// K2's tile.  A block owns one sample and kPT tiles of 64 channel pairs:
// pair tile t is the value channels [c0 + 64 t, +64) and the gate channels
// [C/2 + c0 + 64 t, +64).  Channels are wgmma's M and the sample's
// positions its N: A = w rows, MN-major, one 64-channel atom per value tile
// and per gate tile (value atoms first); B = the sample's tap rows,
// K-major, kN rows (Ho*Wo rounded up; rows past Ho*Wo stay zero) x 64
// channels of one tap per stage.  A warpgroup runs two wgmmas per 16 of
// depth on one B descriptor, its value atom and its gate atom, so that the
// value and the gate of a (channel, position) meet in one thread.
//   kSplit == false (Ho*Wo <= 160): kPT = 2 and warpgroup w owns pair tile
//     w at all kN = kWN positions;
//   kSplit == true (160 < Ho*Wo <= 256): kPT = 1 and warpgroup w owns the
//     positions [w kWN, (w + 1) kWN) of kN = 2 kWN; the two add their
//     statistics through shared memory.
// A thread holds 2 x kWN / 2 accumulators (160 at most), which is why the
// positions split past 160 rather than take m64n256 pairs.
template <int kWN, bool kSplit>
struct FwdTile {
  static constexpr int kN = kSplit ? 2 * kWN : kWN;
  static constexpr int kPT = kSplit ? 1 : 2;
  static constexpr int kAtoms = 2 * kPT;
  static constexpr uint32_t kABytes = kAtoms * hopper::kAtomBytes;
  static constexpr uint32_t kTileBytes = kN * 128;  // [kN][64] bf16, swizzled
  static constexpr uint32_t kStageBytes = kABytes + kTileBytes;
  // after the main loop the ring holds, per pair tile, the z value, z gate
  // and y tiles on their way out
  static constexpr uint32_t kEpiBytes = 3 * kPT * kTileBytes;
  static constexpr uint32_t kRingBytes = kRing * kStageBytes;
  static constexpr size_t kSmemBytes =
      (kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes) + 1024;
  static_assert(kEpiBytes <= kRingBytes, "the epilogue reuses the ring");
};

// K2.  x [N, g.H, g.W, g.CI] and w [g.K, g.CO] -> y, z, mean, var for the
// block's sample and pair tiles (FwdTile above).  The operands come by TMA
// (tmap_w: w as [K][CO] in 64 x 64 boxes; tmap_x: x as [N][H][W][CI] in
// boxes of [1][Ho][Wo][64], whose rows are the sample's positions in
// order, with the rows whose tap falls outside x zero-filled by the copy
// engine): thread 0 starts a stage's copies and the stage's full barrier
// counts their bytes, so no other thread spends an instruction on loads
// while the tensor cores run.  After the loop each thread has its rows'
// sums in registers (a shuffle across the 4 lanes of a row completes a
// channel's), applies the affine and the GLU to its own value and gate
// accumulators, and parks z and y in swizzled [position][64] tiles, which
// the block writes out in 16-byte rows.
template <int kWN, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    conv_in_glu_fwd_kernel(const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           bf16* __restrict__ y, bf16* __restrict__ z,
                           float* __restrict__ mean_out,
                           float* __restrict__ var_out, ConvGeom g, float eps) {
  using F = FwdTile<kWN, kSplit>;
  constexpr int kLead = kRing - 1;  // stages loaded ahead
  extern __shared__ unsigned char smem[];
  __shared__ float part[2][2][64][2];  // kSplit: [warpgroup][value, gate]
                                       // [channel][sum, sum of squares]
  __shared__ uint64_t full[kRing];     // a slot's copies have landed
  const uint32_t base = ring_base(smem);
  unsigned char* sm = smem + (base - hopper::smem_addr(smem));
  const int C2 = g.CO / 2;
  const int P = g.Ho * g.Wo;
  const int tiles = (C2 + 64 * F::kPT - 1) / (64 * F::kPT);
  const int n = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - n * tiles) * 64 * F::kPT;
  const int nst = g.K / kBK;

  // B rows P .. kN of every slot stay zero: the copies write P rows
  const int pad_chunks = (F::kN - P) * 8;
  for (int i = threadIdx.x; i < kRing * pad_chunks; i += kThreads) {
    const int ring_slot = i / pad_chunks;
    const int k = i - ring_slot * pad_chunks;
    *reinterpret_cast<uint4*>(sm + ring_slot * F::kStageBytes + F::kABytes +
                              P * 128 + 16 * k) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i)
      hopper::mbar_init(hopper::smem_addr(&full[i]), 1);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // thread 0's copies of stage s: the active A atoms at depth 64 s and the
  // tap (tap_h, tap_w) rows at channels ci0 (stages run in that order)
  int tap_h = 0, tap_w = 0, ci0 = 0;
  uint32_t a_bytes = 0;
  for (int a = 0; a < F::kAtoms; ++a)
    if (c0 + 64 * (a % F::kPT) < C2) a_bytes += hopper::kAtomBytes;
  auto load = [&](int s) {
    const uint32_t st =
        base + static_cast<uint32_t>(s % kRing) * F::kStageBytes;
    const uint32_t bar = hopper::smem_addr(&full[s % kRing]);
    hopper::mbar_expect_tx(bar, a_bytes + static_cast<uint32_t>(P) * 128u);
#pragma unroll
    for (int a = 0; a < F::kAtoms; ++a) {
      const int ct = c0 + 64 * (a % F::kPT);
      if (ct < C2)
        hopper::tma_load_2d(st + a * hopper::kAtomBytes, &tmap_w, bar,
                            (a < F::kPT ? 0 : C2) + ct, kBK * s);
    }
    hopper::tma_load_4d(st + F::kABytes, &tmap_x, bar, ci0, tap_w - g.pw,
                        tap_h - g.ph, n);
    ci0 += kBK;
    if (ci0 == g.CI) {
      ci0 = 0;
      if (++tap_w == g.kw) {
        tap_w = 0;
        ++tap_h;
      }
    }
  };

  const int wgi = threadIdx.x >> 7;
  const int pt = kSplit ? 0 : wgi;  // this warpgroup's pair tile
  const bool active = c0 + 64 * pt < C2;
  const uint32_t b_off = F::kABytes + (kSplit ? wgi * kWN * 128 : 0);
  float acc_v[kWN / 2], acc_g[kWN / 2];
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) {
    acc_v[i] = 0.0f;
    acc_g[i] = 0.0f;
  }
  hopper::fence_operands(acc_v);
  hopper::fence_operands(acc_g);

  // the ring: stage s in slot s % kRing, loaded kLead stages ahead; one
  // wgmma group in flight; a slot is reloaded once both warpgroups have
  // retired the stage in it
  if (threadIdx.x == 0)
    for (int s = 0; s < kLead && s < nst; ++s) load(s);
  for (int s = 0; s < nst; ++s) {
    const uint32_t st =
        base + static_cast<uint32_t>(s % kRing) * F::kStageBytes;
    hopper::mbar_wait(hopper::smem_addr(&full[s % kRing]), (s / kRing) & 1);
    if (active) {  // a masked pair tile has nothing to multiply
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = hopper::make_desc(st + b_off + kk * 32, 16, 1024);
        hopper::wgmma<kWN, 1, 0>(
            acc_v,
            hopper::make_desc(st + pt * hopper::kAtomBytes + kk * 2048,
                              hopper::kAtomBytes, 1024),
            db);
        hopper::wgmma<kWN, 1, 0>(
            acc_g,
            hopper::make_desc(
                st + (F::kPT + pt) * hopper::kAtomBytes + kk * 2048,
                hopper::kAtomBytes, 1024),
            db);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<1>();
    __syncthreads();  // every warpgroup has retired stage s - 1
    if (threadIdx.x == 0 && s + kLead < nst) load(s + kLead);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc_v);
  hopper::fence_operands(acc_g);

  // statistics: rows ch and ch + 8 of each atom; positions past P are zero
  const int tw = threadIdx.x & 127;
  const int ch = ((tw >> 5) << 4) + ((tw & 31) >> 2);
  float sum[2][2][2] = {};  // [value, gate][row ch, ch + 8][sum, squares]
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc_v[4 * j + 2 * h + e];
        const float u = acc_g[4 * j + 2 * h + e];
        sum[0][h][0] += v;
        sum[0][h][1] += v * v;
        sum[1][h][0] += u;
        sum[1][h][1] += u * u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float& t = (&sum[0][0][0])[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
  }
  if constexpr (kSplit) {
    if ((tw & 3) == 0) {
#pragma unroll
      for (int vg = 0; vg < 2; ++vg)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 2; ++k) part[wgi][vg][ch + 8 * h][k] = sum[vg][h][k];
    }
    __syncthreads();
#pragma unroll
    for (int vg = 0; vg < 2; ++vg)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          sum[vg][h][k] = part[0][vg][ch + 8 * h][k] + part[1][vg][ch + 8 * h][k];
  }
  float a[2][2], b[2][2];  // [value, gate][row ch, ch + 8]: zn = z a + b
#pragma unroll
  for (int vg = 0; vg < 2; ++vg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = (vg ? C2 : 0) + c0 + 64 * pt + ch + 8 * h;
      const float m = sum[vg][h][0] / P;
      const float v = fmaxf(sum[vg][h][1] / P - m * m, 0.0f);
      a[vg][h] = 0.0f;
      b[vg][h] = 0.0f;
      if (active) {
        a[vg][h] = scale[cc] * rsqrtf(v + eps);
        b[vg][h] = bias[cc] - m * a[vg][h];
        if ((tw & 3) == 0 && (!kSplit || wgi == 0)) {
          mean_out[static_cast<long long>(n) * g.CO + cc] = m;
          var_out[static_cast<long long>(n) * g.CO + cc] = v;
        }
      }
    }
  }
  __syncthreads();  // every warpgroup is done with the ring

  // affine + GLU on this thread's own value and gate; z and y in bf16 into
  // the tiles [z value | z gate | y] x pair tile
  unsigned char* zv = sm + pt * F::kTileBytes;
  unsigned char* zg = sm + (F::kPT + pt) * F::kTileBytes;
  unsigned char* yt = sm + (2 * F::kPT + pt) * F::kTileBytes;
  const int p0 = (kSplit ? wgi * kWN : 0) + 2 * (tw & 3);
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = ch + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t off =
            hopper::swizzle128(p0 + 8 * j + e, cc >> 3) + (cc & 7) * 2;
        const float v = acc_v[4 * j + 2 * h + e];
        const float u = acc_g[4 * j + 2 * h + e];
        const float sig = 1.0f / (1.0f + expf(-(u * a[1][h] + b[1][h])));
        *reinterpret_cast<bf16*>(zv + off) = __float2bfloat16(v);
        *reinterpret_cast<bf16*>(zg + off) = __float2bfloat16(u);
        *reinterpret_cast<bf16*>(yt + off) =
            __float2bfloat16((v * a[0][h] + b[0][h]) * sig);
      }
    }
  }
  __syncthreads();

  // the tiles' first P rows out, 16 bytes a thread, 8 threads a row
  const long long row0 = static_cast<long long>(n) * P;
#pragma unroll
  for (int t = 0; t < F::kPT; ++t) {
    const int cb = c0 + 64 * t;
    if (cb >= C2) break;
#pragma unroll
    for (int which = 0; which < 3; ++which) {  // z value, z gate, y
      const unsigned char* tile = sm + (which * F::kPT + t) * F::kTileBytes;
      const int ld = which == 2 ? C2 : g.CO;
      bf16* dst = (which == 2 ? y : z) + row0 * ld + (which == 1 ? C2 : 0) + cb;
      for (int i = threadIdx.x; i < P * 8; i += kThreads) {
        const int p = i >> 3;
        const int k = i & 7;
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * ld + 8 * k) =
            *reinterpret_cast<const uint4*>(tile + hopper::swizzle128(p, k));
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

// K3a: a block of 4 ceil(hw / 2) threads, in whole warps, per (4 V channel
// pairs, sample).
template <typename T>
cudaError_t bwd_dz_launch(const void* dy, const void* z, const float* mean,
                          const float* var, const float* scale,
                          const float* bias, void* dz, float* dscale_part,
                          float* dbias_part, int N, int hw, int CO, float eps,
                          cudaStream_t s) {
  constexpr int kCols = kDzColT * Tr<T>::kVec;
  const int threads = (kDzColT * ((hw + 1) / 2) + 31) / 32 * 32;
  if (hw <= 0 || threads > kDzMaxThreads) return cudaErrorInvalidValue;
  const int C2 = CO / 2;
  const bool vec = C2 % Tr<T>::kVec == 0 && aligned16(dy) && aligned16(z) &&
                   aligned16(dz);
  in_glu_bwd_dz_kernel<T><<<dim3((C2 + kCols - 1) / kCols, N), threads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(z), mean, var, scale,
      bias, static_cast<T*>(dz), dscale_part, dbias_part, hw, CO, eps, vec);
  return cudaGetLastError();
}

// K2 on Hopper for one tile shape (wg::FwdTile).
template <int kWN, bool kSplit>
cudaError_t fwd_wgmma_launch(const CUtensorMap& tmap_x,
                             const CUtensorMap& tmap_w, const float* scale,
                             const float* bias, void* y, void* z, float* mean,
                             float* var, const ConvGeom& g, float eps,
                             cudaStream_t s) {
  using F = wg::FwdTile<kWN, kSplit>;
  auto kernel = wg::conv_in_glu_fwd_kernel<kWN, kSplit>;
  cudaError_t err = set_smem(kernel, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (g.CO / 2 + 64 * F::kPT - 1) / (64 * F::kPT);
  kernel<<<static_cast<unsigned>(g.N) * tiles, wg::kThreads, F::kSmemBytes,
           s>>>(tmap_x, tmap_w, scale, bias, static_cast<__nv_bfloat16*>(y),
                static_cast<__nv_bfloat16*>(z), mean, var, g, eps);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (so the
// library needs no link against libcuda); null where libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// K2's two tensor maps, bf16 in the 128-byte swizzle: x [N][H][W][CI] in
// boxes [1][Ho][Wo][64] (a tap's rows for one sample: out-of-range rows
// read as zeros) and w [K][CO] in boxes [64][64].
bool fwd_tensor_maps(const void* x, const void* w, const ConvGeom& g,
                     CUtensorMap* tmap_x, CUtensorMap* tmap_w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t x_dim[4] = {static_cast<cuuint64_t>(g.CI),
                               static_cast<cuuint64_t>(g.W),
                               static_cast<cuuint64_t>(g.H),
                               static_cast<cuuint64_t>(g.N)};
  const cuuint64_t x_stride[3] = {x_dim[0] * e, x_dim[0] * x_dim[1] * e,
                                  x_dim[0] * x_dim[1] * x_dim[2] * e};
  const cuuint32_t x_box[4] = {64, static_cast<cuuint32_t>(g.Wo),
                               static_cast<cuuint32_t>(g.Ho), 1};
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(g.CO),
                               static_cast<cuuint64_t>(g.K)};
  const cuuint64_t w_stride[1] = {w_dim[0] * e};
  const cuuint32_t w_box[2] = {64, 64};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), x_dim, x_stride, x_box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(tmap_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(w), w_dim, w_stride, w_box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile for Ho * Wo positions: all of them in each warpgroup, rounded up
// to 32, up to 160; past that, split across the two warpgroups.
cudaError_t fwd_wgmma_dispatch(const void* x, const void* w,
                               const float* scale, const float* bias, void* y,
                               void* z, float* mean, float* var,
                               const ConvGeom& g, float eps, cudaStream_t s) {
  CUtensorMap tx, tw;
  if (!fwd_tensor_maps(x, w, g, &tx, &tw)) return cudaErrorInvalidValue;
  const int p = g.Ho * g.Wo;
#define FWD_WGMMA(kWN, kSplit) \
  fwd_wgmma_launch<kWN, kSplit>(tx, tw, scale, bias, y, z, mean, var, g, eps, s)
  if (p <= 32) return FWD_WGMMA(32, false);
  if (p <= 64) return FWD_WGMMA(64, false);
  if (p <= 96) return FWD_WGMMA(96, false);
  if (p <= 128) return FWD_WGMMA(128, false);
  if (p <= 160) return FWD_WGMMA(160, false);
  if (p <= 256) return FWD_WGMMA(128, true);
#undef FWD_WGMMA
  return cudaErrorInvalidValue;
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

// K2's: Cin and C/2 multiples of 64 (so a pair tile's value and gate atoms
// are both whole), at most 256 positions, 16-byte-aligned tensors
// (ops/fused_codec.py: fwd_uses_wgmma).
bool fwd_wgmma_shape_ok(const ConvGeom& g, const void* x, const void* w,
                        const void* y, const void* z) {
  return g.CI % 64 == 0 && g.CO % 128 == 0 && g.Ho * g.Wo <= 256 &&
         aligned16(x) && aligned16(w) && aligned16(y) && aligned16(z);
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

// K2 on Hopper (wgmma).  bf16 only; the arguments of mrssm_conv_in_glu_fwd,
// with CI and CO / 2 multiples of 64.
extern "C" int mrssm_conv_in_glu_fwd_wgmma(const void* x, const void* w,
                                           const float* scale,
                                           const float* bias, void* y, void* z,
                                           float* mean, float* var, int N,
                                           int H, int W, int CI, int kh, int kw,
                                           int CO, int ph, int pw, float eps,
                                           void* stream) {
  const ConvGeom g = make_geom(N, H, W, CI, kh, kw, CO, ph, pw);
  if (N <= 0) return 0;
  if (!fwd_wgmma_shape_ok(g, x, w, y, z))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_wgmma_dispatch(
      x, w, scale, bias, y, z, mean, var, g, eps,
      static_cast<cudaStream_t>(stream)));
}

// K3a.  dy [N, hw, CO/2], z [N, hw, CO], mean and var [N, CO] -> dz
// [N, hw, CO] and the per-sample partials dscale_part, dbias_part [N, CO].
// Needs hw <= 256.
extern "C" int mrssm_in_glu_bwd_dz(int dtype, const void* dy, const void* z,
                                   const float* mean, const float* var,
                                   const float* scale, const float* bias,
                                   void* dz, float* dscale_part,
                                   float* dbias_part, int N, int hw, int CO,
                                   float eps, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? bwd_dz_launch<__nv_bfloat16>(
                       dy, z, mean, var, scale, bias, dz, dscale_part,
                       dbias_part, N, hw, CO, eps, s)
                 : bwd_dz_launch<float>(dy, z, mean, var, scale, bias, dz,
                                          dscale_part, dbias_part, N, hw, CO,
                                          eps, s);
  return static_cast<int>(err);
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
