// browse_scores: one depth level of MemForest's level-synchronous tree browse.
//
// Replaces the TPU kernel src/repro/kernels/browse_scores.py:_browse_kernel
// (wrapper browse_scores). For every frontier entry f and child slot k:
//     out[f,k] = (sum_d child[f,k,d] * q[f,d]) * mask[f,k]
// A padded slot (mask 0) scores exactly 0, as in the reference.
//
// Bound on an H100: memory. Every child row is read once for one dot
// product: (F*K*D + F*D + 2*F*K) * 4 bytes for about 2*F*K*D operations.
// Design: one warp per (f, k) pair. Lanes read the child row and the query
// row with 16-byte loads (when D is a multiple of 4 and the rows are
// aligned), so each warp-wide load moves 512 contiguous bytes; a shuffle
// reduction finishes the dot product and lane 0 applies the mask.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
browse_scores_kernel(const float* __restrict__ child, const float* __restrict__ q,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int F, int K, int D, int vec4) {
  const long pair = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= (long)F * K) return;
  const long f = pair / K;
  const float* c = child + pair * D;
  const float* qr = q + f * D;

  float s = 0.f;
  if (vec4) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int i = lane; i < (D >> 2); i += 32) {
      const float4 a = c4[i];
      const float4 b = q4[i];
      s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int d = lane; d < D; d += 32) s += c[d] * qr[d];
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[pair] = s * mask[pair];
}

}  // namespace

extern "C" int memforest_browse_scores(const float* child, const float* q, const float* mask,
                                       float* out, int F, int K, int D, void* stream) {
  const long pairs = (long)F * K;
  if (pairs > 0) {
    const int vec4 = (D % 4 == 0) && (reinterpret_cast<std::uintptr_t>(child) % 16 == 0) &&
                     (reinterpret_cast<std::uintptr_t>(q) % 16 == 0);
    const long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    browse_scores_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        child, q, mask, out, F, K, D, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
