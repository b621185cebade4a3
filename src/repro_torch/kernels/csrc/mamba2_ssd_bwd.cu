// mamba2_ssd_bwd: the gradient of the chunked Mamba2 SSD scan, the backward
// of zamba2's Mamba2 layers in training.
//
// No Pallas kernel has a backward: the reference differentiates its jnp
// chunked scan (src/repro/kernels/ref.py:mamba2_ssd_chunked). The plain
// version is ref.mamba2_ssd_bwd_ref; tests/test_torch_scan_design.py
// (ssd_bwd_schedule) emulates this kernel's schedule step by step. Per
// head h, with S0 the state entering a chunk, cum the inclusive sums of
// dt.A in row order, L[t,s] = exp(min(cum_t - cum_s, 0)) (s <= t), G =
// (C.B^T) L dt_s and w_s = dt_s exp(min(total - cum_s, 0)), the forward is
//     y = G.x + exp(cum_t) (C.S0^T),   S1 = exp(total) S0 + (x w)^T.B
// and, walking the chunks in reverse with dS the cotangent of S1 (ds_out
// for the last chunk),
//     dG = dy.x^T (s <= t),  dx = G^T.dy + w (B.dS^T)
//     dC = (dG L dt_s).B + exp(cum_t) (dy.S0),  dB = (dG L dt_s)^T.C + w (x.dS)
//     dS0 = exp(total) dS + (exp(cum) dy)^T.C
// and every term's cotangent of cum gathered into dcum (the pairs' Q =
// dG G, the carried state's term, w's), whose reverse sum in row order gives
// ddt += A revcumsum(dcum). dA = sum dt revcumsum(dcum) is taken term by
// term instead, each pair (t, s) weighted by D_t - D_s (D the sums of dt
// in row order), since the terms of the reverse-sum form cancel.
//
// A simple kernel on the CUDA cores, all math in f32: x, B, C and dy are
// bf16 or f32 (one type) and enter as f32; dt, A and the states are f32.
// One block of 256 threads per (head, batch), walking its chunks in
// reverse: the block holds the chunk's x, dy, B and C (f32, rows padded to
// an odd length) and G and d(C.B^T) in shared memory (106 KB at P = N = 64,
// two blocks an SM; 171 KB at P = N = 128); the entering state is read from
// the forward's chunk states and the carried dS lives in the dstate output
// itself, both in global memory (L1 and L2). The products run as register
// tiles, the 256 threads a 16 x 16 grid, each owning a 4 x 4 tile of a 64 x
// 64 output. cum, D and the reverse sums run on one thread in row order
// (a tree order moves exp(cum) by an ulp of |cum|, which reaches 700).
//
// Cross-block sums, deterministic (no atomics): dB and dC are written per
// head, (B, T, H, N) f32 partials, and dA per (batch, head); the wrapper
// sums them (a torch.sum over the kernel's outputs). Inside a block the
// column sums go through 16 row partials added in order, row sums through
// warp shuffles, and dA's pair terms through one block reduction at the end.
//
// Bound on an H100 at zamba2-7b's training shape (B 8, T 512, H 112, P = N
// = 64, bf16): the function reads x, dy (bf16) and the chunk states (f32)
// and writes dx, ddt, dstate, dB and dC: about 0.33 GB, 0.098 ms at 3.35
// TB/s (the heads' f32 partials of dB and dC add 0.23 GB that a fused sum
// would not write); its products, about 23 GFLOP, would take 0.023 ms on
// the bf16 tensor cores (chip_smoke.py computes both from the call's
// shapes).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::kFull;
using tiles::kThreads;
using tiles::row_sum16;
using tiles::tile_prod;
using tiles::to_f32;

constexpr int kMaxChunk = 64;

// the block's sum of v, in one order; every thread gets it. ``red`` holds 8
// floats; the caller syncs before ``red`` is reused.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// The block's working set in shared memory, floats: x and dy (chunk x (P +
// 1)), B and C (chunk x (N + 1)), G and d(C.B^T) (chunk x (chunk + 1)),
// nine chunk vectors, the 16 column partials and the reduction's room.
struct Layout {
  int PP, NP, CP;
  int xs, dys, bs, cs, g, dcb, vec, colpart, red, floats;
  __host__ __device__ Layout(int P, int N, int c) {
    PP = P + 1;
    NP = N + 1;
    CP = c + 1;
    xs = 0;
    dys = xs + c * PP;
    bs = dys + c * PP;
    cs = bs + c * NP;
    g = cs + c * NP;
    dcb = g + c * CP;
    vec = dcb + c * CP;
    colpart = vec + 9 * kMaxChunk;
    red = colpart + 16 * kMaxChunk;
    floats = red + 16;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ states, const T* __restrict__ dy,
               const float* __restrict__ ds_out, T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* dstate, int Tn, int H, int P, int N,
               int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(P, N, chunk);
  const int PP = L.PP, NP = L.NP, CP = L.CP;
  float* xs = smem + L.xs;
  float* dys = smem + L.dys;
  float* Bs = smem + L.bs;
  float* Cs = smem + L.cs;
  float* G = smem + L.g;
  float* dCB = smem + L.dcb;
  float* dts = smem + L.vec;            // the chunk's dt
  float* cum = dts + kMaxChunk;         // inclusive sums of dt.A
  float* Dv = cum + kMaxChunk;          // inclusive sums of dt
  float* ex = Dv + kMaxChunk;           // exp(min(total - cum, 0))
  float* wt = ex + kMaxChunk;           // the state update's weights dt ex
  float* rowQ = wt + kMaxChunk;         // sum_s Q[t, s]
  float* colR = rowQ + kMaxChunk;       // sum_t R[t, s]
  float* dcumI = colR + kMaxChunk;      // the carried state's term of dcum
  float* dwt = dcumI + kMaxChunk;       // w's cotangent
  float* colpart = smem + L.colpart;    // [16][64]
  float* red = smem + L.red;

  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  const int nchunks = Tn / chunk;
  const long PN = static_cast<long>(P) * N;
  float* dS = dstate + (b * H + h) * PN;   // the carried cotangent, in place
  for (long i = tid; i < PN; i += kThreads) dS[i] = ds_out ? ds_out[(b * H + h) * PN + i] : 0.f;
  float dA_pairs = 0.f;                 // this thread's share of dA's pair terms
  float dA_rest = 0.f;                  // thread 0: the other terms

  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int t0 = ci * chunk;
    const float* S0 = states + ((b * H + h) * nchunks + ci) * PN;
    __syncthreads();                    // the last chunk's readers are done
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int t = i / P, p = i % P;
      const long gi = ((b * Tn + t0 + t) * H + h) * P + p;
      xs[t * PP + p] = to_f32(x[gi]);
      dys[t * PP + p] = to_f32(dy[gi]);
    }
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long gi = (b * Tn + t0 + t) * N + n;
      Bs[t * NP + n] = to_f32(Bm[gi]);
      Cs[t * NP + n] = to_f32(Cm[gi]);
    }
    for (int t = tid; t < chunk; t += kThreads) dts[t] = dt[(b * Tn + t0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {                     // cum and D in row order
      float run = 0.f, rd = 0.f;
      for (int t = 0; t < chunk; ++t) {
        run += dts[t] * a;
        rd += dts[t];
        cum[t] = run;
        Dv[t] = rd;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    if (tid < chunk) {
      ex[tid] = expf(fminf(total - cum[tid], 0.f));
      wt[tid] = dts[tid] * ex[tid];
    }

    // C.B^T and dy.x^T; G, d(C.B^T), the row sums of Q = dG G, the column
    // sums of R = dG (C.B^T) L and dA's pair terms Q (D_t - D_s)
    {
      float cb[4][4] = {}, dg[4][4] = {};
      tile_prod(cb, N, 0, 0, chunk, chunk, [&](int m, int k) { return Cs[m * NP + k]; },
                [&](int k, int n) { return Bs[n * NP + k]; });
      tile_prod(dg, P, 0, 0, chunk, chunk, [&](int m, int k) { return dys[m * PP + k]; },
                [&](int k, int n) { return xs[n * PP + k]; });
      float rq[4] = {}, cr[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          float gv = 0.f, dcv = 0.f;
          if (t < chunk && s < chunk && s <= t) {
            const float l = expf(fminf(cum[t] - cum[s], 0.f));
            gv = cb[i][j] * l * dts[s];
            dcv = dg[i][j] * l * dts[s];
            const float r = dg[i][j] * cb[i][j] * l;
            const float q = r * dts[s];
            rq[i] += q;
            cr[j] += r;
            dA_pairs += q * (Dv[t] - Dv[s]);
          }
          if (t < chunk && s < chunk) {
            G[t * CP + s] = gv;
            dCB[t * CP + s] = dcv;
          }
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = row_sum16(rq[i]);
        if (tx == 0 && ty + 16 * i < chunk) rowQ[ty + 16 * i] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) colpart[ty * kMaxChunk + tx + 16 * j] = cr[j];
    }
    __syncthreads();
    if (tid < chunk) {
      float v = 0.f;
      for (int gi = 0; gi < 16; ++gi) v += colpart[gi * kMaxChunk + tid];
      colR[tid] = v;
    }

    // dx = G^T.dy + w (B.dS^T)
    for (int p0 = 0; p0 < P; p0 += 64) {
      float acc[4][4] = {}, bds[4][4] = {};
      tile_prod(acc, chunk, 0, p0, chunk, P, [&](int m, int k) { return G[k * CP + m]; },
                [&](int k, int n) { return dys[k * PP + n]; });
      tile_prod(bds, N, 0, p0, chunk, P, [&](int m, int k) { return Bs[m * NP + k]; },
                [&](int k, int n) { return dS[static_cast<long>(n) * N + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = ty + 16 * i, p = p0 + tx + 16 * j;
          if (s < chunk && p < P)
            dx[((b * Tn + t0 + s) * H + h) * P + p] = from_f32<T>(acc[i][j] + wt[s] * bds[i][j]);
        }
    }

    // dC = d(C.B^T).B + exp(cum_t) (dy.S0), and dcum's carried-state term
    {
      float ri[4] = {};
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {}, dys0[4][4] = {};
        tile_prod(acc, chunk, 0, n0, chunk, N, [&](int m, int k) { return dCB[m * CP + k]; },
                  [&](int k, int n) { return Bs[k * NP + n]; });
        tile_prod(dys0, P, 0, n0, chunk, N, [&](int m, int k) { return dys[m * PP + k]; },
                  [&](int k, int n) { return S0[static_cast<long>(k) * N + n]; });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ty + 16 * i, n = n0 + tx + 16 * j;
            if (t < chunk && n < N) {
              dC_part[((b * Tn + t0 + t) * H + h) * N + n] =
                  acc[i][j] + expf(cum[t]) * dys0[i][j];
              ri[i] += Cs[t * NP + n] * dys0[i][j];
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float v = row_sum16(ri[i]);
        if (tx == 0 && t < chunk) dcumI[t] = expf(cum[t]) * v;
      }
    }

    // dB = d(C.B^T)^T.C + w (x.dS), and w's cotangent sum_n B (x.dS)
    {
      float rw[4] = {};
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {}, xds[4][4] = {};
        tile_prod(acc, chunk, 0, n0, chunk, N, [&](int m, int k) { return dCB[k * CP + m]; },
                  [&](int k, int n) { return Cs[k * NP + n]; });
        tile_prod(xds, P, 0, n0, chunk, N, [&](int m, int k) { return xs[m * PP + k]; },
                  [&](int k, int n) { return dS[static_cast<long>(k) * N + n]; });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = ty + 16 * i, n = n0 + tx + 16 * j;
            if (s < chunk && n < N) {
              dB_part[((b * Tn + t0 + s) * H + h) * N + n] = acc[i][j] + wt[s] * xds[i][j];
              rw[i] += Bs[s * NP + n] * xds[i][j];
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
        const float v = row_sum16(rw[i]);
        if (tx == 0 && s < chunk) dwt[s] = v;
      }
    }
    __syncthreads();                    // dS, dy and the vectors are read
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int t = i / P, p = i % P;
      dys[t * PP + p] *= expf(cum[t]);
    }
    __syncthreads();

    // dS <- exp(total) dS + (exp(cum) dy)^T.C, and exp(total) sum dS S0
    float part = 0.f;
    const float decay = expf(total);
    for (int p0 = 0; p0 < P; p0 += 64)
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4] = {};
        tile_prod(acc, chunk, p0, n0, P, N, [&](int m, int k) { return dys[k * PP + m]; },
                  [&](int k, int n) { return Cs[k * NP + n]; });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + ty + 16 * i, n = n0 + tx + 16 * j;
            if (p < P && n < N) {
              const long e = static_cast<long>(p) * N + n;
              const float old = dS[e];
              part += old * S0[e];
              dS[e] = decay * old + acc[i][j];
            }
          }
      }
    const float dtot = decay * block_sum(part, red);

    // one thread, rows in reverse: dcum, its reverse sum, ddt and dA's terms
    if (tid == 0) {
      float swd = 0.f;
      for (int s = 0; s < chunk; ++s) swd += wt[s] * dwt[s];
      float run = 0.f, rest = dtot * Dv[chunk - 1];
      for (int s = chunk - 1; s >= 0; --s) {
        float dc = rowQ[s] - dts[s] * colR[s] + dcumI[s] - wt[s] * dwt[s];
        if (s == chunk - 1) dc += dtot + swd;
        run += dc;
        ddt[(b * Tn + t0 + s) * H + h] = colR[s] + ex[s] * dwt[s] + a * run;
        rest += dcumI[s] * Dv[s] + wt[s] * dwt[s] * (Dv[chunk - 1] - Dv[s]);
      }
      dA_rest += rest;
    }
  }
  __syncthreads();
  const float pairs = block_sum(dA_pairs, red);
  if (tid == 0) dA_part[b * H + h] = pairs + dA_rest;
}

template <typename E>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* states, const void* dy, const float* ds_out, void* dx, float* ddt,
           float* dA_part, float* dB_part, float* dC_part, float* dstate, int B, int T, int H,
           int P, int N, int chunk, cudaStream_t stream) {
  const size_t bytes = Layout(P, N, chunk).floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(Bm), static_cast<const E*>(Cm),
      states, static_cast<const E*>(dy), ds_out, static_cast<E*>(dx), ddt, dA_part, dB_part,
      dC_part, dstate, T, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, Bm, Cm, dy and dx bf16 (``bf16``) or f32; dt, A, the chunk states
// (B, H, T / chunk, P, N), ds_out (or null: zeros), ddt, dstate and the
// partials f32: dA_part (B, H), dB_part and dC_part (B, T, H, N). P, N <=
// 128 and chunk <= 64, else cudaErrorInvalidValue.
extern "C" int memforest_mamba2_ssd_bwd(const void* x, const float* dt, const float* A,
                                        const void* Bm, const void* Cm, const float* states,
                                        const void* dy, const float* ds_out, void* dx,
                                        float* ddt, float* dA_part, float* dB_part,
                                        float* dC_part, float* dstate, int B, int T, int H,
                                        int P, int N, int chunk, int bf16, void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  if (P > 128 || N > 128 || chunk > kMaxChunk || chunk < 1 || T % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, states, dy, ds_out, dx, ddt, dA_part, dB_part,
                                 dC_part, dstate, B, T, H, P, N, chunk, st);
  return launch<float>(x, dt, A, Bm, Cm, states, dy, ds_out, dx, ddt, dA_part, dB_part, dC_part,
                       dstate, B, T, H, P, N, chunk, st);
}
