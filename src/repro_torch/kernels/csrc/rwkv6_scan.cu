// rwkv6_scan: chunked RWKV6 (Finch) WKV scan, the prefill of rwkv6's
// time-mix.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:_rwkv6_kernel
// (wrapper rwkv6_scan). Per head h (S is the (K, V) state):
//     o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t
// computed chunk by chunk in the reference's order (ref.rwkv6_chunked): with
// cum the inclusive and ce the exclusive sum of -exp(w) down each key column,
//     A[t,s] = sum_k r[t,k] k[s,k] exp(min(ce[t,k] - cum[s,k], 0))   (s < t)
//     A[t,t] = sum_k r[t,k] u[k] k[t,k]
//     o      = A.v + (r * exp(ce)).S
//     S     <- exp(cum_last) * S + (k * exp(min(cum_last - cum, 0)))^T v
// Every exponent is <= 0: the decay is data-dependent per key, so the
// factored form exp(+cum) would overflow, and the log-difference form is
// kept. r, k, v and u are bf16 or f32 (one type), w and the state f32; all
// arithmetic is f32 and o is written in r's type.
//
// Bound on an H100: at rwkv6-1.6b's prefill shape (B 8, T 128, H 32, K = V =
// 64) the kernel moves about 34 MB (r, k, v, o in bf16, w and the state in
// f32) and needs about 1 GFLOP, so memory bounds it (about 0.010 ms at 3.35
// TB/s); this version runs on the CUDA cores in f32, and its C*C*K/2
// exponentials per chunk are the largest item.
//
// Design: the Pallas grid walks (batch, head, chunk) with the chunk axis in
// sequence and materialises the (C, C, K) gate, a 1 MB VMEM tile. Here one
// block owns one (head, batch) and a loop inside it walks the chunks in
// order; the (K, V) state stays in shared memory for the whole scan. Per
// chunk: one thread per key column scans the log-decays; the 256 threads,
// as a 16 x 16 grid each owning a 4 x 4 tile of (t, s), form A directly,
// the gate's exponentials computed and summed in registers (the gate tensor
// never exists; the tiles above the diagonal are skipped at compile time);
// r and k are rescaled in place; o = A.v + r'.S and the state's k'^T.v run
// as register-tiled products over shared memory (8 loads for 16 FMAs).
// Rows of r, k and cum, which a warp reads sixteen at a time, are padded to
// K + 1 floats, so they fall in different banks. Shared memory comes to 113
// KB at the main shape, so two blocks fit on one SM: the launch opts in
// above the 48 KB default.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Register-tiled product over shared memory: the block's 256 threads as a
// 16 x 16 grid, thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of a 64 x 64 output tile:
//     acc[i][j] += sum_k A[m * a_m + k * a_k] * B[k * b_k + n * b_n]
// Each step loads four values of A and four of B for sixteen FMAs. Rows and
// columns past (M, Nn) read row / column 0 and are never stored.
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* A, int a_m, int a_k,
                                         const float* B, int b_k, int b_n, int K,
                                         int m0, int n0, int M, int Nn) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int am[4], bn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * i;
    am[i] = (m < M ? m : 0) * a_m;
    bn[i] = (n < Nn ? n : 0) * b_n;
  }
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[am[i] + k * a_k];
      b[i] = B[k * b_k + bn[i]];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

size_t smem_floats(int K, int V, int chunk) {
  const size_t c = chunk, KP = K + 1;
  return static_cast<size_t>(K) * V + 3 * c * KP + c * K + c * V + c * c + K;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const T* __restrict__ u,
                  const float* __restrict__ s_in, T* __restrict__ o,
                  float* __restrict__ s_out, int Tn, int H, int K, int V, int chunk) {
  extern __shared__ __align__(16) float smem[];
  // At K = V = 64 and a chunk of 64 this is 28,928 floats (113 KB): two
  // blocks fit on one SM. A and ce are read two rows at a time by a warp
  // and left unpadded for that (a two-way bank conflict on those loads).
  const int KP = K + 1;                 // padded rows of r, k and cum
  float* S = smem;                      // K x V, the carried state
  float* rs = S + K * V;                // chunk x KP: r, then r * exp(ce)
  float* ks = rs + chunk * KP;          // chunk x KP: k, then the update's k
  float* cm = ks + chunk * KP;          // chunk x KP: -exp(w), then its sums
  float* ce = cm + chunk * KP;          // chunk x K: exclusive log-decay sums
  float* vs = ce + chunk * K;           // chunk x V
  float* Am = vs + chunk * V;           // chunk x chunk
  float* us = Am + chunk * chunk;       // K: the bonus
  const float* tot = cm + (chunk - 1) * KP;   // the chunk's total log-decay

  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long state0 = (b * H + h) * static_cast<long>(K) * V;

  for (int i = tid; i < K * V; i += kThreads) S[i] = s_in[state0 + i];
  for (int i = tid; i < K; i += kThreads) us[i] = to_f32(u[h * K + i]);

  for (int t0 = 0; t0 < Tn; t0 += chunk) {
    __syncthreads();                    // the last chunk's readers are done
    for (int i = tid; i < chunk * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const long g = ((b * Tn + t0 + t) * H + h) * K + c;
      rs[t * KP + c] = to_f32(r[g]);
      ks[t * KP + c] = to_f32(k[g]);
      cm[t * KP + c] = -expf(w[g]);
    }
    for (int i = tid; i < chunk * V; i += kThreads) {
      const int t = i / V, c = i % V;
      vs[i] = to_f32(v[((b * Tn + t0 + t) * H + h) * V + c]);
    }
    __syncthreads();
    for (int c = tid; c < K; c += kThreads) {
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float ld = cm[t * KP + c];
        run += ld;
        cm[t * KP + c] = run;
        ce[t * K + c] = run - ld;
      }
    }
    __syncthreads();

    // A strictly below the diagonal: thread (ty, tx) owns rows ty + 16 i
    // and columns tx + 16 j. Blocks j > i lie above the diagonal and are
    // skipped at compile time, blocks j < i lie below it, and only the
    // diagonal blocks test s < t. The gate's exponents are <= 0, where
    // __expf's error (2 + 1.2 |x| ulp) stays far inside the tolerance.
    {
      float acc[4][4] = {};
      const bool below = tx < ty;
      for (int c = 0; c < K; ++c) {
        float rt[4], et[4], kk[4], cs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = min(ty + 16 * i, chunk - 1), s = min(tx + 16 * i, chunk - 1);
          rt[i] = rs[t * KP + c];
          et[i] = ce[t * K + c];
          kk[i] = ks[s * KP + c];
          cs[i] = cm[s * KP + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < i; ++j)
            acc[i][j] += rt[i] * kk[j] * __expf(fminf(et[i] - cs[j], 0.f));
          if (below) acc[i][i] += rt[i] * kk[i] * __expf(fminf(et[i] - cs[i], 0.f));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          if (t < chunk && s < chunk) Am[t * chunk + s] = acc[i][j];
        }
    }
    __syncthreads();
    // the bonus on the diagonal; r <- r * exp(ce); k <- k * exp(min(total - cum, 0))
    for (int t = tid; t < chunk; t += kThreads) {
      float d = 0.f;
      for (int c = 0; c < K; ++c) d += rs[t * KP + c] * us[c] * ks[t * KP + c];
      Am[t * chunk + t] = d;
    }
    __syncthreads();
    for (int i = tid; i < chunk * K; i += kThreads) {
      const int t = i / K, c = i % K;
      rs[t * KP + c] *= expf(ce[t * K + c]);
      ks[t * KP + c] *= expf(fminf(tot[c] - cm[t * KP + c], 0.f));
    }
    __syncthreads();

    // o = A.v + (r * exp(ce)).S, 64 columns of v at a time
    for (int c0 = 0; c0 < V; c0 += 64) {
      float intra[4][4] = {}, inter[4][4] = {};
      tile_mma(inter, rs, KP, 1, S, V, 1, K, 0, c0, chunk, V);
      tile_mma(intra, Am, chunk, 1, vs, V, 1, chunk, 0, c0, chunk, V);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, c = c0 + tx + 16 * j;
          if (t < chunk && c < V)
            o[((b * Tn + t0 + t) * H + h) * V + c] = from_f32<T>(inter[i][j] + intra[i][j]);
        }
    }
    __syncthreads();                    // every reader of the old state is done

    // S <- exp(total) * S + k'^T v, a 64 x 64 tile of (k, v) at a time
    for (int k0 = 0; k0 < K; k0 += 64)
      for (int c0 = 0; c0 < V; c0 += 64) {
        float acc[4][4] = {};
        tile_mma(acc, ks, 1, KP, vs, V, 1, chunk, k0, c0, K, V);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int j0 = k0 + ty + 16 * i, c = c0 + tx + 16 * j;
            if (j0 < K && c < V) S[j0 * V + c] = expf(tot[j0]) * S[j0 * V + c] + acc[i][j];
          }
      }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += kThreads) s_out[state0 + i] = S[i];
}

template <typename E>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s_in, void* o, float* s_out, int B, int T, int H, int K, int V,
           int chunk, cudaStream_t stream) {
  const size_t bytes = smem_floats(K, V, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(r), static_cast<const E*>(k), static_cast<const E*>(v), w,
      static_cast<const E*>(u), s_in, static_cast<E*>(o), s_out, T, H, K, V, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int memforest_rwkv6_scan(const void* r, const void* k, const void* v,
                                    const float* w, const void* u, const float* s_in,
                                    void* o, float* s_out, int B, int T, int H, int K,
                                    int V, int chunk, int bf16, void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(r, k, v, w, u, s_in, o, s_out, B, T, H, K, V, chunk, st);
  return launch<float>(r, k, v, w, u, s_in, o, s_out, B, T, H, K, V, chunk, st);
}
