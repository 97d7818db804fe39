// Bit-depth normalise with counter-based dequantisation noise, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel `_normalize_kernel`
// (ops/pallas_kernels.py:44-53, launched by `normalize_image_pallas`
// :63-94).  For every element
//
//     out[i] = floor(x[i] / 2^(8-b)) / 2^b - 0.5 + u[i] / 2^b
//
// with u[i] in [0, 1) built from 32 random bits by the TPU kernel's mantissa
// trick: float((bits >> 9) | 0x3F800000) - 1, a 23-bit uniform.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11) keyed by the 64-bit
// seed (key = seed lo, seed hi), counter = (g lo, g hi, 0, 0) for the group
// g = i / 4 of four consecutive elements; element i takes output word i % 4.
// The bits depend only on (seed, i): no block size, no shape rule (the TPU
// kernel needed the element count to divide by 512 and seeded per block).
//
// One rank's shard of a data-parallel batch: x is the rank's local block
// [L, B_local, row] of a global [L, B_global, row] batch, and its local row
// j is global row  offset + (j / block_rows) * block_stride + j % block_rows
// (contiguous rows, or one run of rows per micro-batch under gradient
// accumulation).  Then g counts groups of the GLOBAL batch, so each rank
// draws the bits a one-rank run draws for the same element.  A row holds a
// multiple of 4 elements (the wrapper checks), so a group never straddles
// two rows.  row_groups = 0 is the identity map.  Where every index of the
// map fits 32 bits (`narrow`, set by the host: a local block of under 2^34
// elements and a global batch of under 2^32 rows) its three divisions run
// in 32 bits, several times cheaper than 64-bit ones.
// ops/cuda_kernels.py::philox4x32_10 reproduces the same bits with int64
// tensor arithmetic, so the kernel is held against its plain version
// exactly, not only in distribution.
//
// Bound: memory bandwidth.  One read of x (f32 or uint8) and one f32 write
// per element; at the main-path shape [50, 50, 64, 64, 3] f32 that is
// 30.72 M x (4 B + 4 B) = 245.8 MB per call.  The Philox rounds are about
// 25 integer operations per element, below the bandwidth time on an H100.
// Design: each thread handles one group of four elements, so one Philox call
// yields the four words it needs, and moves them as one 16-byte load and
// store (4 bytes for uint8) when the pointers are aligned; a grid-stride
// loop over groups covers any size; a scalar path takes the ragged tail.
// The seed is read from device memory, so drawing it needs no host sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x);
    const uint32_t lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z);
    const uint32_t lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// inv_step = 2^-(8-b) and inv_levels = 2^-b are powers of two, so every
// product here is exact and the result equals the plain version's
// floor(x / 2^(8-b)) / 2^b - 0.5 + u / 2^b bit for bit, fused or not.
__device__ __forceinline__ float normalize_one(float x, uint32_t bits,
                                               float inv_step,
                                               float inv_levels) {
  const float q = floorf(x * inv_step) * inv_levels - 0.5f;
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return q + u * inv_levels;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(p);
  return make_float4(v.x, v.y, v.z, v.w);
}

// The Philox counter of local group g under the shard's row map, in index
// type I (uint32_t where the host found every index narrow, else int64_t).
template <typename I>
__device__ __forceinline__ int64_t global_group(int64_t g, I row_groups,
                                                I rows_local,
                                                int64_t rows_global,
                                                I row_offset, I block_rows,
                                                I block_stride) {
  const I gi = static_cast<I>(g);
  const I row = gi / row_groups;
  const I l = row / rows_local;
  const I j = row - l * rows_local;
  const I jb = j / block_rows;
  const I jg = row_offset + jb * block_stride + (j - jb * block_rows);
  return (static_cast<int64_t>(l) * rows_global + static_cast<int64_t>(jg)) *
             static_cast<int64_t>(row_groups) +
         static_cast<int64_t>(gi - row * row_groups);
}

template <typename T>
__global__ void normalize_image_kernel(const T* __restrict__ x,
                                       float* __restrict__ out, int64_t n,
                                       float inv_step, float inv_levels,
                                       const int64_t* __restrict__ seed,
                                       bool vectorized, bool narrow,
                                       int64_t row_groups,
                                       int64_t rows_local, int64_t rows_global,
                                       int64_t row_offset, int64_t block_rows,
                                       int64_t block_stride) {
  const uint64_t s = static_cast<uint64_t>(__ldg(seed));
  const uint2 key = make_uint2(static_cast<uint32_t>(s),
                               static_cast<uint32_t>(s >> 32));
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    int64_t c = g;
    if (row_groups > 0) {
      c = narrow ? global_group<uint32_t>(
                       g, static_cast<uint32_t>(row_groups),
                       static_cast<uint32_t>(rows_local), rows_global,
                       static_cast<uint32_t>(row_offset),
                       static_cast<uint32_t>(block_rows),
                       static_cast<uint32_t>(block_stride))
                 : global_group<int64_t>(g, row_groups, rows_local,
                                         rows_global, row_offset, block_rows,
                                         block_stride);
    }
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
                   0u, 0u),
        key);
    const int64_t base = g * 4;
    if (vectorized && base + 4 <= n) {
      const float4 v = load4(x + base);
      float4 o;
      o.x = normalize_one(v.x, r.x, inv_step, inv_levels);
      o.y = normalize_one(v.y, r.y, inv_step, inv_levels);
      o.z = normalize_one(v.z, r.z, inv_step, inv_levels);
      o.w = normalize_one(v.w, r.w, inv_step, inv_levels);
      *reinterpret_cast<float4*>(out + base) = o;
    } else {
      const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && base + j < n; ++j) {
        out[base + j] = normalize_one(static_cast<float>(x[base + j]),
                                      bits[j], inv_step, inv_levels);
      }
    }
  }
}

}  // namespace

// x: f32 (x_is_u8 == 0) or uint8 elements; out: f32; n elements; seed: one
// int64 in device memory; row_groups ... block_stride: the shard's map of
// local to global rows (row_groups = row elements / 4, or 0: no map).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int mrssm_normalize_image(const void* x, int x_is_u8, float* out,
                                     long long n, int bit_depth,
                                     const long long* seed, void* stream,
                                     long long row_groups,
                                     long long rows_local,
                                     long long rows_global,
                                     long long row_offset,
                                     long long block_rows,
                                     long long block_stride) {
  if (n <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  const long long max_blocks = static_cast<long long>(sms) * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  const float inv_step = 1.0f / static_cast<float>(1 << (8 - bit_depth));
  const float inv_levels = 1.0f / static_cast<float>(1 << bit_depth);
  const uintptr_t in_addr = reinterpret_cast<uintptr_t>(x);
  const bool out_aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* seed_ptr = reinterpret_cast<const int64_t*>(seed);
  const bool narrow = groups <= 0xFFFFFFFFll && rows_global <= 0xFFFFFFFFll;

  if (x_is_u8) {
    const bool vec = out_aligned && in_addr % 4 == 0;
    normalize_image_kernel<uint8_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const uint8_t*>(x), out, n, inv_step, inv_levels, seed_ptr,
        vec, narrow, row_groups, rows_local, rows_global, row_offset,
        block_rows, block_stride);
  } else {
    const bool vec = out_aligned && in_addr % 16 == 0;
    normalize_image_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(x), out, n, inv_step, inv_levels, seed_ptr,
        vec, narrow, row_groups, rows_local, rows_global, row_offset,
        block_rows, block_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mrssm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
