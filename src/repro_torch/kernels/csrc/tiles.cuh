// Helpers of the CUDA-core kernels that hold a block's operands in f32
// (mamba2_ssd_bwd.cu, rwkv6_scan_bwd.cu): the input types' conversions,
// the register-tiled product of a 256-thread block and a half-warp's sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tiles {

constexpr int kThreads = 256;           // a 16 x 16 grid of threads
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[i][j] += sum_k fa(m0 + ty + 16 i, k) fb(k, n0 + tx + 16 j), the block
// as a 16 x 16 grid of 4 x 4 tiles of a 64 x 64 output: each step loads
// four values of each operand for sixteen FMAs. Rows and columns past (M,
// Nn) read row / column 0 and are never stored.
template <typename FA, typename FB>
__device__ __forceinline__ void tile_prod(float (&acc)[4][4], int K, int m0, int n0, int M,
                                          int Nn, FA fa, FB fb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int mm[4], nn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mm[i] = m0 + ty + 16 * i < M ? m0 + ty + 16 * i : 0;
    nn[i] = n0 + tx + 16 * i < Nn ? n0 + tx + 16 * i : 0;
  }
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = fa(mm[i], k);
      b[i] = fb(k, nn[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// the sum over the 16 threads of a grid row (one half-warp); every one of
// them gets it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

}  // namespace tiles
