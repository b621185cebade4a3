// mamba2_ssd: chunked Mamba2 SSD scan, the prefill of zamba2's Mamba2
// layers.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py:_ssd_kernel
// (wrapper mamba2_ssd). Per head h (S is the (P, N) state, the decay a scalar
// per head):
//     S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t (x) B_t,    y_t = S_t C_t
// computed chunk by chunk in the reference's order (ref.mamba2_ssd_chunked):
// with cum[t] the inclusive sum of dt.A over the chunk,
//     G[t,s]   = (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s        (s <= t)
//     y[t,p]   = sum_s G[t,s] x[s,p] + exp(cum_t) (C_t . S[p,:])
//     S[p,n]  <- exp(cum_last) S[p,n]
//                + sum_s (x[s,p] dt_s exp(min(cum_last - cum_s, 0))) B[s,n]
// Every exponent is <= 0. x, B and C are bf16 or f32 (one type), dt, A and
// the state f32; all arithmetic is f32 and y is written in x's type.
//
// Bound on an H100: at zamba2-7b's prefill shape (B 8, T 128, H 112, P = N
// = 64) the kernel moves about 59 MB (x and y in bf16, the f32 state in and
// out) and needs about 2.4 GFLOP, so memory bounds it (about 0.018 ms at 3.35
// TB/s); this version runs its products on the CUDA cores in f32.
//
// Design: the Pallas grid walks (batch, head, chunk) with the chunk axis in
// sequence and the state in VMEM scratch. Here one block owns one (head,
// batch) and a loop inside it walks the chunks in order, so no state carries
// between blocks. The (P, N) state stays in shared memory for the whole scan
// (16 KB at P = N = 64). Per chunk the block stages x (C x P) and B, C
// (C x N) as f32 and scans dt.A over the chunk with warp shuffles. The four
// products of a chunk (C.B^T, G.x, C.S^T and the state's (x w)^T.B, each
// 64 x 64 x 64 at the main shape) run as register-tiled products over
// shared memory: the 256 threads form a 16 x 16 grid, each owning a 4 x 4
// tile of the output, so a step loads 8 values for 16 FMAs. Rows that
// threads of one warp read at once are padded (S, B and C to N + 1 floats,
// G to C + 1), so they fall in different banks. B and C are shared by every
// head of a batch row: the H blocks of a row read the same rows, from L2.
// Shared memory comes to about 82 KB at the main shape, above the 48 KB
// default: the launch opts in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Inclusive prefix sum of vals[0, n), n <= 64, in place; run by one warp.
// Lane l holds values l and l + 32.
__device__ __forceinline__ void warp_scan64(float* vals, int n) {
  const int lane = threadIdx.x & 31;
  float a = lane < n ? vals[lane] : 0.f;
  float b = lane + 32 < n ? vals[lane + 32] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ya = __shfl_up_sync(kFull, a, off);
    const float yb = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      a += ya;
      b += yb;
    }
  }
  b += __shfl_sync(kFull, a, 31);
  if (lane < n) vals[lane] = a;
  if (lane + 32 < n) vals[lane + 32] = b;
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

size_t smem_floats(int P, int N, int chunk) {
  const size_t NP = N + 1, c = chunk;
  return P * NP + c * P + 2 * c * NP + c * (c + 1) + 3 * c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ s_in,
                  T* __restrict__ y, float* __restrict__ s_out, int Tn, int H,
                  int P, int N, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1;                 // padded rows of S, B and C
  float* S = smem;                      // P x NP, the carried state
  float* xs = S + P * NP;               // chunk x P
  float* Bs = xs + chunk * P;           // chunk x NP
  float* Cs = Bs + chunk * NP;          // chunk x NP
  const int GP = chunk + 1;             // padded rows of G
  float* G = Cs + chunk * NP;           // chunk x GP
  float* cum = G + chunk * GP;          // chunk: inclusive sum of dt.A
  float* dts = cum + chunk;             // chunk
  float* ws = dts + chunk;              // chunk: the state update's weights

  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  const long state0 = (b * H + h) * static_cast<long>(P) * N;

  for (int i = tid; i < P * N; i += kThreads) S[(i / N) * NP + i % N] = s_in[state0 + i];

  for (int t0 = 0; t0 < Tn; t0 += chunk) {
    __syncthreads();                    // the last chunk's readers are done
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[i] = to_f32(x[((b * Tn + t0 + t) * H + h) * P + p]);
    }
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long g = (b * Tn + t0 + t) * N + n;
      Bs[t * NP + n] = to_f32(Bm[g]);
      Cs[t * NP + n] = to_f32(Cm[g]);
    }
    for (int t = tid; t < chunk; t += kThreads) {
      const float d = dt[(b * Tn + t0 + t) * H + h];
      dts[t] = d;
      cum[t] = d * a;
    }
    __syncthreads();
    if (tid < 32) warp_scan64(cum, chunk);
    __syncthreads();

    // G[t,s] = (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s below the diagonal
    const float total = cum[chunk - 1];
    {
      float acc[4][4] = {};
      tile_mma(acc, Cs, NP, 1, Bs, 1, NP, N, 0, 0, chunk, chunk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          if (t < chunk && s < chunk)
            G[t * GP + s] = s <= t ? acc[i][j] * expf(fminf(cum[t] - cum[s], 0.f)) * dts[s] : 0.f;
        }
    }
    for (int s = tid; s < chunk; s += kThreads)
      ws[s] = dts[s] * expf(fminf(total - cum[s], 0.f));
    __syncthreads();

    // y = G.x + exp(cum_t) (C.S^T), 64 columns of p at a time
    for (int p0 = 0; p0 < P; p0 += 64) {
      float intra[4][4] = {}, inter[4][4] = {};
      tile_mma(intra, G, GP, 1, xs, P, 1, chunk, 0, p0, chunk, P);
      tile_mma(inter, Cs, NP, 1, S, 1, NP, N, 0, p0, chunk, P);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, p = p0 + tx + 16 * j;
          if (t < chunk && p < P)
            y[((b * Tn + t0 + t) * H + h) * P + p] =
                from_f32<T>(intra[i][j] + expf(cum[t]) * inter[i][j]);
        }
    }
    __syncthreads();                    // every reader of x and the old state is done
    for (int i = tid; i < chunk * P; i += kThreads) xs[i] *= ws[i / P];
    __syncthreads();

    // S <- exp(total) S + (x * w)^T B, a 64 x 64 tile of (p, n) at a time
    const float decay = expf(total);
    for (int p0 = 0; p0 < P; p0 += 64)
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {};
        tile_mma(acc, xs, 1, P, Bs, NP, 1, chunk, p0, n0, P, N);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + ty + 16 * i, n = n0 + tx + 16 * j;
            if (p < P && n < N) S[p * NP + n] = decay * S[p * NP + n] + acc[i][j];
          }
      }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) s_out[state0 + i] = S[(i / N) * NP + i % N];
}

template <typename E>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* s_in, void* y, float* s_out, int B, int T, int H, int P, int N,
           int chunk, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mamba2_ssd_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_ssd_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(Bm), static_cast<const E*>(Cm),
      s_in, static_cast<E*>(y), s_out, T, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int memforest_mamba2_ssd(const void* x, const float* dt, const float* A,
                                    const void* Bm, const void* Cm, const float* s_in,
                                    void* y, float* s_out, int B, int T, int H, int P,
                                    int N, int chunk, int bf16, void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s_in, y, s_out, B, T, H, P, N, chunk, st);
  return launch<float>(x, dt, A, Bm, Cm, s_in, y, s_out, B, T, H, P, N, chunk, st);
}
