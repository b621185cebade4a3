// mamba2_ssd_bwd: the gradient of the chunked Mamba2 SSD scan, the backward
// of zamba2's Mamba2 layers in training.
//
// No Pallas kernel has a backward: the reference differentiates its jnp
// chunked scan (src/repro/kernels/ref.py:mamba2_ssd_chunked). The plain
// version is ref.mamba2_ssd_bwd_ref; tests/test_torch_scan_design.py
// (ssd_bwd_schedule) emulates the bf16 path's schedule step by step. Per
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
// Two paths, chosen by the inputs' type.
//
// Bound on an H100 at zamba2-7b's training shape (B 8, T 512, H 112, P = N
// = 64, bf16): the function reads x, dy, B, C (bf16), dt and the chunk
// states (f32) and writes dx, ddt, dstate, dB and dC: about 0.33 GB, 0.098
// ms at 3.35 TB/s; its products, about 23 GFLOP, would take 0.023 ms on the
// bf16 tensor cores (chip_smoke.py computes both from the call's shapes).
//
// bf16, on the tensor cores. The first version (kept below for float32) ran
// at 35x that bound: every product on the CUDA cores (register tiles, 8
// shared-memory loads for 16 FMAs), x, dy, B and C widened to f32 in shared
// memory (106 KB a block), the carried dS read three times a chunk from the
// dstate output in global memory, and the heads' dB and dC written as (B,
// T, H, N) f32 partials (0.23 GB the bound does not count) for the wrapper
// to sum. This path:
//  - one block of 8 warps per (head, batch), walking the chunks in reverse
//    from the forward's chunk states; a cluster of up to 8 blocks over
//    neighbouring heads of one batch row (the largest divisor of H up to 8,
//    where N <= 64: 14 clusters of 8 at zamba2's shape);
//  - x, dy, B, C, dt and the chunk's f32 S0 arrive by cp.async in a
//    two-stage ring (the next chunk's copies, issued by warps 0 and 3 after
//    their dC, run under this chunk's work); rows past the chunk and
//    columns past P or N arrive as zeros, so any chunk <= 64 and any P, N <=
//    128 take the same 64-row, 16-padded tiles (past 227 KB: one stage, and
//    S0 read from global memory and split in registers, P = N = 128);
//  - every product is mma.sync m16n8k16 fed by ldmatrix: C.B^T, dy.x^T,
//    B.C^T and x.dy^T (the c x c products, one 16 x 16 block at a time,
//    only blocks with s <= t), d(C.B^T).B, dy.S0, d(C.B^T)^T.C, x.dS, G^T.dy,
//    B.dS^T and (exp(cum) dy)^T.C. Warps 0-3 take rows t = 16 w.. in the
//    row form (C.B^T, dy.x^T, Q, R, dA's pair terms, dC), warps 4-7 rows s
//    in the column form, the same products computed again transposed (B.C^T,
//    x.dy^T, R's column sums as row sums, dB, dx): G^T and d(C.B^T)^T are
//    then the column form's own fragments, which, packed in pairs, are the
//    A fragments of G^T.dy and d(C.B^T)^T.C; d(C.B^T)'s are the row form's
//    for d(C.B^T).B. No c x c tile goes through shared memory and no column
//    sum crosses warps. A warp of each form shares a scheduler (w, w + 4),
//    whose blocks of work add to 5;
//  - dS lives in registers as the accumulators of its own update, panels
//    of 16 p x 32 n over the 8 warps; after each update its bf16 split goes
//    to shared memory for the next chunk's B.dS^T and x.dS; dstate is
//    written once, at the end. S0's split is written once a chunk from the
//    staged tile;
//  - the heads' dB and dC: each block writes its (chunk x N) f32 tiles into
//    its shared memory, and during the next chunk's products each block of
//    the cluster reads its share of rows from every peer (distributed shared
//    memory) and adds them in head order, writing (B, T, H / cluster, N)
//    partials (8x fewer bytes), which the wrapper sums. Cluster barriers
//    split in arrive and wait around the work between; no atomics, so two
//    calls give equal bits;
//  - cum and D in row order on one thread; each row's terms of dcum, ddt and
//    dA by warp 1, then one lane walks the rows in reverse for the reverse
//    sums in row order, during the next chunk's products (two chunks'
//    vectors); dA's pair terms weighted by D_t - D_s.
// The split: mma.sync takes bf16 only. x, dy, B and C are bf16 inputs and
// enter exactly, as one term; G, d(C.B^T), S0, dS and exp(cum) dy are f32
// and enter as three bf16 terms (mma.cuh's split3: 24 bits of the
// mantissa), smallest first. Why three: emulated on the CPU (`PYTHONPATH=
// src:. python tests/test_torch_scan_design.py` prints the table; bf16
// inputs at 2x192x3x16x24), the gradients lie beyond chip_smoke.SCAN_BWD_TOL
// (bf16 2e-5, f32 2e-4, sum 1e-5 of the largest value) with one term:
// bf16 5.95e-4, f32 1.80e-3, sum 1.32e-5; with two: 4.8e-8, 4.0e-6, 1.2e-7;
// with three: 0, 4.0e-6, 1.2e-7. Two pass this criterion; the kernel keeps
// the forward's three. Shared memory: 200 KB at P = N = 64, one block an SM.
//
// float32, on the CUDA cores (the first version, kept for the parity
// phases), all math in f32. One block of 256 threads per (head, batch),
// walking its chunks in reverse: the block holds the chunk's x, dy, B and C
// (f32, rows padded to an odd length) and G and d(C.B^T) in shared memory
// (106 KB at P = N = 64, two blocks an SM; 171 KB at P = N = 128); the
// entering state is read from the forward's chunk states and the carried dS
// lives in the dstate output itself, both in global memory (L1 and L2). The
// products run as register tiles, the 256 threads a 16 x 16 grid, each
// owning a 4 x 4 tile of a 64 x 64 output. cum, D and the reverse sums run
// on one thread in row order (a tree order moves exp(cum) by an ulp of
// |cum|, which reaches 700). Cross-block sums, deterministic (no atomics):
// dB and dC are written per head, (B, T, H, N) f32 partials, and dA per
// (batch, head); the wrapper sums them. Inside a block the column sums go
// through 16 row partials added in order, row sums through warp shuffles,
// and dA's pair terms through one block reduction at the end.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "mma.cuh"
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
  float dA_rest = 0.f;                  // warp 1's first lane: the other terms

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBwThreads = 256;   // 8 warps: warp w owns rows 16 (w % 4).. of a chunk
constexpr int kTile = 64;         // rows of a chunk's tiles: a chunk <= 64, zeros past it
constexpr int kVecs = 11;         // f32 vectors of kTile a chunk, two chunks' sets
constexpr int kMaxSmem = 227 * 1024;   // the most a block may opt in to (H100)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The blocks of one cluster: neighbouring heads of one batch row, whose dB
// and dC the cluster sums in head order. The exchange holds one 64-column
// pass (N <= 64); else each head writes its own partial.
__host__ __device__ inline int bwd_cluster(int H, int Np) {
  if (Np > 64) return 1;
  for (int c = 8; c > 1; --c)
    if (H % c == 0) return c;
  return 1;
}

// Byte offsets into dynamic shared memory: a ring of ``stages`` stages of
// the chunk's x, dy (kTile x Pp), B, C (kTile x Np), dt and, where
// ``y_smem``, its f32 entering state S0 (Pp x Np); dS and, where
// ``y_smem``, S0 as three bf16 terms (Pp x Np); the vectors; the cluster's
// exchange of dB and dC (2 x kTile x Np f32). The first of (two stages, S0
// staged), (one stage, S0 staged), (one stage, S0 read from global memory)
// that fits: the first at P = N = 64 (197 KB, one block an SM), the last at
// P = N = 128. bf16 rows are padded by 8 (16 bytes), f32 rows by 4: the rows
// one ldmatrix reads start in different bank groups.
struct BwdLayout {
  int XS, NS, ES, SS, stages;
  bool y_smem;
  int x, dy, b, c, dt, s0, stage, ds, ys, vec, e, bytes;
  __host__ __device__ BwdLayout(int Pp, int Np, bool exchange) {
    XS = Pp + 8;
    NS = Np + 8;
    ES = Np + 4;
    SS = Np + 4;
    for (int form = 0; form < 3; ++form) {
      stages = form == 0 ? 2 : 1;
      y_smem = form < 2;
      x = 0;
      dy = x + kTile * XS * 2;
      b = dy + kTile * XS * 2;
      c = b + kTile * NS * 2;
      dt = c + kTile * NS * 2;
      s0 = dt + kTile * 4;
      stage = s0 + (y_smem ? Pp * SS * 4 : 0);
      ds = stages * stage;
      ys = ds + 3 * Pp * NS * 2;
      vec = ys + (y_smem ? 3 * Pp * NS * 2 : 0);
      e = vec + 2 * kVecs * kTile * 4 + 16 * 4;
      bytes = e + (exchange ? 2 * kTile * ES * 4 : 0);
      if (bytes <= kMaxSmem) break;
    }
  }
};

// One block of 8 warps per (head, batch), walking its chunks in reverse; a
// cluster of ``cl`` blocks over neighbouring heads. P and N are multiples of
// 8 (the wrapper pads them); Pp, Np are P, N rounded up to 16. Warp w < 4
// takes rows t = 16 w.. of the chunk in the row form (C.B^T, dy.x^T, then
// dC), warp w >= 4 rows s = 16 (w - 4).. in the column form (B.C^T, x.dy^T,
// then dB and dx). The carried dS lives in registers as panels of 16 p x 32
// n, panel w + 8 i in warp w (PW panels a warp at most), and as its split
// in shared memory.
template <int PW>
__global__ void __launch_bounds__(kBwThreads, 1)
ssd_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ states,
                    const __nv_bfloat16* __restrict__ dy, const float* __restrict__ ds_out,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dA_part, float* __restrict__ dB_part,
                    float* __restrict__ dC_part, float* __restrict__ dstate, int Tn, int H, int P,
                    int N, int chunk, int cl) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* smem = smem_bytes;
  const int Pp = (P + 15) & ~15, Np = (N + 15) & ~15;
  const BwdLayout L(Pp, Np, cl > 1);
  const int XS = L.XS, NS = L.NS, ES = L.ES;
  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int i = warp & 3;               // this warp's block of 16 rows
  const float a = A[h];
  const int nchunks = Tn / chunk;
  const long PN = static_cast<long>(P) * N, bh = b * H + h;
  const int Hc = H / cl, hc = h / cl;
  const int SS = L.SS;
  const uint32_t ds_u = mma::smem_u32(smem + L.ds), ys_u = mma::smem_u32(smem + L.ys);
  const int ds_term = Pp * NS * 2;      // bytes from one split term to the next
  __nv_bfloat16* dsh = reinterpret_cast<__nv_bfloat16*>(smem + L.ds);
  __nv_bfloat16* ysh = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);
  float* const vec0 = reinterpret_cast<float*>(smem + L.vec);   // two chunks' vectors
  float* const fin = vec0 + 2 * kVecs * kTile;                  // [8] dA's pair terms by warp
  float* E = reinterpret_cast<float*>(smem + L.e);      // [2][kTile][ES]: dB, dC

  // the chunk at t0 into ring stage ``st_i``: x, dy, B, C, dt and (where
  // staged) S0; rows past the chunk and columns past P or N arrive as zeros
  auto load = [&](int st_i, int t0, int ci, int me, int count) {
    unsigned char* base = smem + st_i * L.stage;
    const uint32_t x_u = mma::smem_u32(base + L.x), dy_u = mma::smem_u32(base + L.dy);
    const uint32_t b_u = mma::smem_u32(base + L.b), c_u = mma::smem_u32(base + L.c);
    const long xrow = static_cast<long>(H) * P, xoff = ((b * Tn + t0) * H + h) * P;
    for (mma::Steps2 it(me, count, Pp / 8); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      const bool ok = t < chunk && 8 * c < P;
      const long off = ok ? xoff + t * xrow + 8 * c : 0;
      mma::cp16(x_u + (t * XS + 8 * c) * 2, x + off, ok);
      mma::cp16(dy_u + (t * XS + 8 * c) * 2, dy + off, ok);
    }
    const long boff = (b * Tn + t0) * N;
    for (mma::Steps2 it(me, count, Np / 8); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      const bool ok = t < chunk && 8 * c < N;
      const long off = ok ? boff + t * N + 8 * c : 0;
      mma::cp16(b_u + (t * NS + 8 * c) * 2, Bm + off, ok);
      mma::cp16(c_u + (t * NS + 8 * c) * 2, Cm + off, ok);
    }
    const uint32_t dt_u = mma::smem_u32(base + L.dt);
    const float* dtb = dt + (b * Tn + t0) * H + h;
    for (int t = me; t < kTile; t += count) {
      const bool ok = t < chunk;
      mma::cp4(dt_u + 4 * t, ok ? dtb + t * H : dt, ok);
    }
    if (L.y_smem) {
      const uint32_t s0_u = mma::smem_u32(base + L.s0);
      const float* S0g = states + (bh * nchunks + ci) * PN;
      for (mma::Steps2 it(me, count, Np / 4); it.r < Pp; it.next()) {
        const int p = it.r, c = it.c;
        const bool ok = p < P && 4 * c < N;
        mma::cp16(s0_u + (p * SS + 4 * c) * 4, ok ? S0g + p * N + 4 * c : S0g, ok);
      }
    }
  };

  // dS's panels: element [ii][nt][2 hf + e] is row p = 16 prow + g + 8 hf,
  // column n = 32 pcol + 8 nt + 2q + e
  const int npc = (Np + 31) / 32, npanels = (Pp / 16) * npc;
  float st[PW][4][4];
#pragma unroll
  for (int ii = 0; ii < PW; ++ii) {
    const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * prow + g + 8 * hf, n = 32 * pcol + 8 * nt + 2 * q;
        float2 v = make_float2(0.f, 0.f);
        if (ds_out && pi < npanels && p < P && n < N)
          v = *reinterpret_cast<const float2*>(ds_out + bh * PN + static_cast<long>(p) * N + n);
        st[ii][nt][2 * hf] = v.x;
        st[ii][nt][2 * hf + 1] = v.y;
      }
  }
  // dS as three bf16 terms in shared memory, rows p, for B.dS^T and x.dS
  auto write_split = [&]() {
#pragma unroll
    for (int ii = 0; ii < PW; ++ii) {
      const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = 32 * pcol + 8 * nt + 2 * q;
        if (n >= Np) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = (16 * prow + g + 8 * hf) * NS + n;
          uint32_t t0, t1, t2;
          mma::split3(st[ii][nt][2 * hf], st[ii][nt][2 * hf + 1], t0, t1, t2);
          *reinterpret_cast<uint32_t*>(dsh + e) = t0;
          *reinterpret_cast<uint32_t*>(dsh + ds_term / 2 + e) = t1;
          *reinterpret_cast<uint32_t*>(dsh + ds_term + e) = t2;
        }
      }
    }
  };

  // a product's sums for rows r0 + g (+ 8) and columns n0.. of dB or dC:
  // into the cluster's exchange, or the head's own partial
  auto put = [&](const float (&acc)[8][4], int n0, int ntiles, int r0, int which, int t0) {
    float* part = which ? dC_part : dB_part;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= ntiles) continue;
      const int n = n0 + 8 * nt + 2 * q;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = r0 + g + 8 * hf;
        const float2 v = make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        if (cl > 1)
          *reinterpret_cast<float2*>(E + (which * kTile + t) * ES + n) = v;
        else if (t < chunk && n < N)
          *reinterpret_cast<float2*>(part + ((b * Tn + t0 + t) * H + h) * N + n) = v;
      }
    }
  };

  // the cluster's exchange of the chunk at t0 (cl > 1): once every peer has
  // written it, this block's rows of dB and dC summed over the heads in head
  // order into the cluster's partial; then this thread is done reading
  auto read_peers = [&](int t0) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();                     // every peer's exchange is written
    const int rows = (kTile + cl - 1) / cl, r0 = static_cast<int>(cluster.block_rank()) * rows;
    const int nq = Np / 4;
    for (int idx = tid; idx < 2 * rows * nq; idx += kBwThreads) {
      const int which = idx / (rows * nq), rem = idx % (rows * nq);
      const int t = r0 + rem / nq, n = 4 * (rem % nq);
      if (t >= chunk || n >= N) continue;
      float* src = E + (which * kTile + t) * ES + n;
      float4 v[8];                      // every peer's load in flight, then the sum in head order
#pragma unroll
      for (int pr = 0; pr < 8; ++pr)
        if (pr < cl) v[pr] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, pr));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int pr = 0; pr < 8; ++pr) {
        if (pr >= cl) continue;
        sum.x += v[pr].x;
        sum.y += v[pr].y;
        sum.z += v[pr].z;
        sum.w += v[pr].w;
      }
      float* part = which ? dC_part : dB_part;
      *reinterpret_cast<float4*>(part + ((b * Tn + t0 + t) * Hc + hc) * N + n) = sum;
    }
    cluster_arrive();                   // this thread's reads are done
  };

  float dA_pairs = 0.f;                 // this thread's share of dA's pair terms
  float dA_rest = 0.f;                  // warp 1's first lane: the other terms
  // warp 1, from a chunk's vectors ``vp``, while the next chunk's products
  // go on: each row's terms (two rows a lane), then one thread walks the
  // rows in reverse for dcum's reverse sum, ddt and dA's terms, the sums in
  // row order
  auto walk = [&](float* vp, int t0) {
    const float* cum = vp;
    const float* Dv = vp + kTile;
    const float* ex = vp + 2 * kTile;
    float* wt = vp + 3 * kTile;         // then wt dwt
    float* rowQ = vp + 5 * kTile;       // then the row's dcum
    float* colR = vp + 6 * kTile;       // then ddt less A revcumsum(dcum)
    float* dcumI = vp + 7 * kTile;      // then the row's dA terms
    const float* dwt = vp + 8 * kTile;
    const float* dtv = vp + 9 * kTile;
    const float* red = vp + 10 * kTile;
    const float Dl = Dv[chunk - 1];
    for (int s = lane; s < kTile; s += 32) {
      const float wd = wt[s] * dwt[s];
      rowQ[s] = rowQ[s] - dtv[s] * colR[s] + dcumI[s] - wd;
      colR[s] = colR[s] + ex[s] * dwt[s];
      dcumI[s] = dcumI[s] * Dv[s] + wd * (Dl - Dv[s]);
      wt[s] = wd;
    }
    __syncwarp();
    if (lane != 0) return;
    float dtot = 0.f;
    for (int w = 0; w < kBwThreads / 32; ++w) dtot += red[w];
    dtot *= expf(cum[chunk - 1]);
    float swd = 0.f;
    for (int s = 0; s < chunk; ++s) swd += wt[s];
    float run = 0.f, rest = dtot * Dl;
    for (int s = chunk - 1; s >= 0; --s) {
      float dc = rowQ[s];
      if (s == chunk - 1) dc += dtot + swd;
      run += dc;
      ddt[(b * Tn + t0 + s) * H + h] = colR[s] + a * run;
      rest += dcumI[s];
    }
    dA_rest += rest;
  };
  write_split();
  if (L.stages == 2) {
    load(0, (nchunks - 1) * chunk, nchunks - 1, tid, kBwThreads);
    mma::cp_commit();
  }
  for (int kk = 0; kk < nchunks; ++kk) {
    const int ci = nchunks - 1 - kk, t0 = ci * chunk, st_i = L.stages == 2 ? kk & 1 : 0;
    unsigned char* base = smem + st_i * L.stage;
    const uint32_t x_u = mma::smem_u32(base + L.x), dy_u = mma::smem_u32(base + L.dy);
    const uint32_t b_u = mma::smem_u32(base + L.b), c_u = mma::smem_u32(base + L.c);
    const __nv_bfloat16* Bs = reinterpret_cast<const __nv_bfloat16*>(base + L.b);
    const __nv_bfloat16* Cs = reinterpret_cast<const __nv_bfloat16*>(base + L.c);
    const float* dts = reinterpret_cast<const float*>(base + L.dt);
    const float* S0s = reinterpret_cast<const float*>(base + L.s0);
    const float* S0 = states + (bh * nchunks + ci) * PN;
    float* const vp = vec0 + (kk & 1) * kVecs * kTile;      // this chunk's vectors
    float* cum = vp;                    // inclusive sums of dt.A
    float* Dv = vp + kTile;             // inclusive sums of dt
    float* ex = vp + 2 * kTile;         // exp(min(total - cum, 0))
    float* wt = vp + 3 * kTile;         // the state update's weights dt ex
    float* ec = vp + 4 * kTile;         // exp(cum)
    float* rowQ = vp + 5 * kTile;       // sum_s Q[t, s]
    float* colR = vp + 6 * kTile;       // sum_t R[t, s]
    float* dcumI = vp + 7 * kTile;      // the carried state's term of dcum
    float* dwt = vp + 8 * kTile;        // w's cotangent
    float* dtv = vp + 9 * kTile;        // dt (the stage is refilled before the walk)
    float* red = vp + 10 * kTile;       // [8] the warps' sum dS S0
    // S0[p, n]: from the staged tile, or from global memory
    auto s0v = [&](int p, int n) {
      return L.y_smem ? *reinterpret_cast<const float2*>(S0s + p * SS + n)
                      : *reinterpret_cast<const float2*>(S0 + static_cast<long>(p) * N + n);
    };
    __syncthreads();                    // the last chunk's readers are done
    if (L.stages == 1) {
      load(0, t0, ci, tid, kBwThreads);
      mma::cp_commit();
    }
    mma::cp_wait<0>();                  // this chunk's copies (warps 0 and 3 issued them a chunk ago)
    __syncthreads();
    if (L.y_smem) {                     // S0 as three bf16 terms, rows p, for dy.S0
      for (mma::Steps2 it(tid, kBwThreads, Np / 2); it.r < Pp; it.next()) {
        const int p = it.r, n = 2 * it.c;
        const float2 v = s0v(p, n);
        uint32_t y0, y1, y2;
        mma::split3(v.x, v.y, y0, y1, y2);
        const int e = p * NS + n;
        *reinterpret_cast<uint32_t*>(ysh + e) = y0;
        *reinterpret_cast<uint32_t*>(ysh + ds_term / 2 + e) = y1;
        *reinterpret_cast<uint32_t*>(ysh + ds_term + e) = y2;
      }
    }
    if (tid == 0) {                     // cum and D in row order
      float4 d[kTile / 4];              // every load in flight before the sums
#pragma unroll
      for (int t = 0; t < kTile / 4; ++t) d[t] = reinterpret_cast<const float4*>(dts)[t];
      float run = 0.f, rd = 0.f;
#pragma unroll
      for (int t = 0; t < kTile / 4; ++t) {
        float4 c4, d4;
        c4.x = run += d[t].x * a;
        d4.x = rd += d[t].x;
        c4.y = run += d[t].y * a;
        d4.y = rd += d[t].y;
        c4.z = run += d[t].z * a;
        d4.z = rd += d[t].z;
        c4.w = run += d[t].w * a;
        d4.w = rd += d[t].w;
        reinterpret_cast<float4*>(cum)[t] = c4;
        reinterpret_cast<float4*>(Dv)[t] = d4;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1], Dl = Dv[chunk - 1];
    if (tid < kTile) {
      const float e = expf(fminf(total - cum[tid], 0.f));
      ex[tid] = e;
      wt[tid] = dts[tid] * e;
      ec[tid] = expf(cum[tid]);
      dtv[tid] = dts[tid];
    }
    __syncthreads();

    if (warp < 4) {
      // the row form, rows t of block i: C.B^T and dy.x^T over the blocks s
      // <= t, one block at a time; Q, R; d(C.B^T)'s split A fragments; then
      // dC
      const int t_lo = 16 * i + g, t_hi = t_lo + 8;
      const float cml = cum[t_lo], cmh = cum[t_hi], Dlo = Dv[t_lo], Dhi = Dv[t_hi];
      uint32_t dca[4][3][4];
      {
        float rql = 0.f, rqh = 0.f;
#pragma unroll 1
        for (int j = 0; j <= i; ++j) {   // block j of C.B^T and dy.x^T, then its Q, R, d(C.B^T)
          float cb[2][4] = {}, dg[2][4] = {};
#pragma unroll 2
          for (int kn = 0; kn < Np / 16; ++kn) {
            uint32_t af[4], bf[4];
            mma::frag_a(af, c_u, NS, 16 * i, 16 * kn);
            mma::frag_b(bf, b_u, NS, 16 * j, 16 * kn);
            mma::mma16816(cb[0], af, bf[0], bf[1]);
            mma::mma16816(cb[1], af, bf[2], bf[3]);
          }
#pragma unroll 2
          for (int kp = 0; kp < Pp / 16; ++kp) {
            uint32_t af[4], bf[4];
            mma::frag_a(af, dy_u, XS, 16 * i, 16 * kp);
            mma::frag_b(bf, x_u, XS, 16 * j, 16 * kp);
            mma::mma16816(dg[0], af, bf[0], bf[1]);
            mma::mma16816(dg[1], af, bf[2], bf[3]);
          }
          float v[2][4];
#pragma unroll
          for (int hf2 = 0; hf2 < 2; ++hf2)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = 16 * j + 8 * hf2 + 2 * q + (e & 1);
              const int t = e < 2 ? t_lo : t_hi;
              const float l = s <= t ? expf(fminf((e < 2 ? cml : cmh) - cum[s], 0.f)) : 0.f;
              const float d = dts[s], r = dg[hf2][e] * cb[hf2][e] * l, qv = r * d;
              v[hf2][e] = dg[hf2][e] * l * d;
              if (e < 2)
                rql += qv;
              else
                rqh += qv;
              dA_pairs += qv * ((e < 2 ? Dlo : Dhi) - Dv[s]);
            }
          uint32_t a3[3][4];
          mma::c_to_a3(v[0], v[1], a3);
          mma::put3(dca, j, a3);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          rql += __shfl_xor_sync(kFull, rql, off);
          rqh += __shfl_xor_sync(kFull, rqh, off);
        }
        if (q == 0) {
          rowQ[t_lo] = rql;
          rowQ[t_hi] = rqh;
        }
      }
      if (cl > 1 && kk > 0) read_peers(t0 + chunk);   // the last chunk's exchange
      // dC = exp(cum_t) (dy.S0) + d(C.B^T).B, 64 columns of n a pass; the
      // carried state's term of dcum, exp(cum_t) sum_n C (dy.S0)
      float cil = 0.f, cih = 0.f;
      for (int n0 = 0; n0 < Np; n0 += 64) {
        const int npair = min(4, (Np - n0) / 16);
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kp = 0; kp < 8; ++kp) {
          if (16 * kp >= Pp) continue;
          uint32_t af[4];
          mma::frag_a(af, dy_u, XS, 16 * i, 16 * kp);
#pragma unroll
          for (int np2 = 0; np2 < 4; ++np2) {
            if (np2 >= npair) continue;
            // S0 (k = p, n): its split in shared memory, or the forward's
            // f32 chunk state split here
            uint32_t sb[3][4];
            if (L.y_smem) {
#pragma unroll
              for (int term = 0; term < 3; ++term)
                mma::frag_bt(sb[term], ys_u + term * ds_term, NS, 16 * kp, n0 + 16 * np2);
            } else {
#pragma unroll
              for (int xr = 0; xr < 4; ++xr) {
                const int p = 16 * kp + 2 * q + 8 * (xr & 1),
                          n = n0 + 16 * np2 + g + 8 * (xr >> 1);
                const bool ok = p < P && n < N;
                const float v0 = ok ? S0[static_cast<long>(p) * N + n] : 0.f;
                const float v1 = ok ? S0[static_cast<long>(p + 1) * N + n] : 0.f;
                mma::split3(v0, v1, sb[0][xr], sb[1][xr], sb[2][xr]);
              }
            }
#pragma unroll
            for (int term = 2; term >= 0; --term) {
              mma::mma16816(acc[2 * np2], af, sb[term][0], sb[term][1]);
              mma::mma16816(acc[2 * np2 + 1], af, sb[term][2], sb[term][3]);
            }
          }
        }
        const float el = ec[t_lo], eh = ec[t_hi];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= 2 * npair) continue;
          const int n = n0 + 8 * nt + 2 * q;
          const float2 cl2 = mma::unpack(*reinterpret_cast<const uint32_t*>(Cs + t_lo * NS + n));
          const float2 ch2 = mma::unpack(*reinterpret_cast<const uint32_t*>(Cs + t_hi * NS + n));
          cil += cl2.x * acc[nt][0] + cl2.y * acc[nt][1];
          cih += ch2.x * acc[nt][2] + ch2.y * acc[nt][3];
          acc[nt][0] *= el;
          acc[nt][1] *= el;
          acc[nt][2] *= eh;
          acc[nt][3] *= eh;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j > i) continue;
#pragma unroll
          for (int np2 = 0; np2 < 4; ++np2) {
            if (np2 >= npair) continue;
            uint32_t bf[4];
            mma::frag_bt(bf, b_u, NS, 16 * j, n0 + 16 * np2);
            mma::mma3(acc[2 * np2], dca[j], bf[0], bf[1]);
            mma::mma3(acc[2 * np2 + 1], dca[j], bf[2], bf[3]);
          }
        }
        if (cl > 1 && kk > 0 && n0 == 0) cluster_wait();   // every peer has read the last exchange
        put(acc, n0, 2 * npair, 16 * i, 1, t0);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        cil += __shfl_xor_sync(kFull, cil, off);
        cih += __shfl_xor_sync(kFull, cih, off);
      }
      if (q == 0) {
        dcumI[t_lo] = ec[t_lo] * cil;
        dcumI[t_hi] = ec[t_hi] * cih;
      }
      if (kk > 0 && warp == 1) walk(vec0 + ((kk - 1) & 1) * kVecs * kTile, t0 + chunk);
      if (L.stages == 2 && kk + 1 < nchunks && (warp == 0 || warp == 3)) {   // the next chunk's copies
        load(st_i ^ 1, t0 - chunk, ci - 1, (warp & 1) * 32 + lane, 64);
        mma::cp_commit();
      }
    } else {
      // the column form, rows s of block i: B.C^T and x.dy^T over the
      // blocks t >= s, one block at a time; R's row sums; d(C.B^T)^T's and
      // G^T's split A fragments; dB; dx
      const int s_lo = 16 * i + g, s_hi = s_lo + 8;
      const float cml = cum[s_lo], cmh = cum[s_hi], dl = dts[s_lo], dh = dts[s_hi];
      // L[t, s] dt_s at element e of the column-form tiles of block m
      auto gate = [&](int m, int hf2, int e) {
        const int t = 16 * m + 8 * hf2 + 2 * q + (e & 1), s = e < 2 ? s_lo : s_hi;
        return t >= s ? expf(fminf(cum[t] - (e < 2 ? cml : cmh), 0.f)) : 0.f;
      };
      uint32_t dcta[4][3][4], gta[4][3][4];
      {
        float crl = 0.f, crh = 0.f;
#pragma unroll 1
        for (int m = i; m < 4; ++m) {    // block m of B.C^T and x.dy^T, then R, d(C.B^T)^T, G^T
          float bc[2][4] = {}, xd[2][4] = {};
#pragma unroll 2
          for (int kn = 0; kn < Np / 16; ++kn) {
            uint32_t af[4], bf[4];
            mma::frag_a(af, b_u, NS, 16 * i, 16 * kn);
            mma::frag_b(bf, c_u, NS, 16 * m, 16 * kn);
            mma::mma16816(bc[0], af, bf[0], bf[1]);
            mma::mma16816(bc[1], af, bf[2], bf[3]);
          }
#pragma unroll 2
          for (int kp = 0; kp < Pp / 16; ++kp) {
            uint32_t af[4], bf[4];
            mma::frag_a(af, x_u, XS, 16 * i, 16 * kp);
            mma::frag_b(bf, dy_u, XS, 16 * m, 16 * kp);
            mma::mma16816(xd[0], af, bf[0], bf[1]);
            mma::mma16816(xd[1], af, bf[2], bf[3]);
          }
          float v[2][4], vg[2][4];
#pragma unroll
          for (int hf2 = 0; hf2 < 2; ++hf2)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float l = gate(m, hf2, e), d = e < 2 ? dl : dh;
              const float r = xd[hf2][e] * bc[hf2][e] * l;
              v[hf2][e] = xd[hf2][e] * l * d;
              vg[hf2][e] = bc[hf2][e] * l * d;
              if (e < 2)
                crl += r;
              else
                crh += r;
            }
          uint32_t a3[3][4];
          mma::c_to_a3(v[0], v[1], a3);
          mma::put3(dcta, m, a3);
          mma::c_to_a3(vg[0], vg[1], a3);
          mma::put3(gta, m, a3);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          crl += __shfl_xor_sync(kFull, crl, off);
          crh += __shfl_xor_sync(kFull, crh, off);
        }
        if (q == 0) {
          colR[s_lo] = crl;
          colR[s_hi] = crh;
        }
      }
      if (cl > 1 && kk > 0) read_peers(t0 + chunk);   // the last chunk's exchange
      // dB = wt (x.dS) + d(C.B^T)^T.C; w's cotangent sum_n B (x.dS)
      const float wl = wt[s_lo], wh = wt[s_hi];
      float dwl = 0.f, dwh = 0.f;
      for (int n0 = 0; n0 < Np; n0 += 64) {
        const int npair = min(4, (Np - n0) / 16);
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kp = 0; kp < 8; ++kp) {
          if (16 * kp >= Pp) continue;
          uint32_t af[4];
          mma::frag_a(af, x_u, XS, 16 * i, 16 * kp);
#pragma unroll
          for (int np2 = 0; np2 < 4; ++np2) {
            if (np2 >= npair) continue;
#pragma unroll
            for (int term = 2; term >= 0; --term) {
              uint32_t bf[4];
              mma::frag_bt(bf, ds_u + term * ds_term, NS, 16 * kp, n0 + 16 * np2);
              mma::mma16816(acc[2 * np2], af, bf[0], bf[1]);
              mma::mma16816(acc[2 * np2 + 1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= 2 * npair) continue;
          const int n = n0 + 8 * nt + 2 * q;
          const float2 bl = mma::unpack(*reinterpret_cast<const uint32_t*>(Bs + s_lo * NS + n));
          const float2 bh2 = mma::unpack(*reinterpret_cast<const uint32_t*>(Bs + s_hi * NS + n));
          dwl += bl.x * acc[nt][0] + bl.y * acc[nt][1];
          dwh += bh2.x * acc[nt][2] + bh2.y * acc[nt][3];
          acc[nt][0] *= wl;
          acc[nt][1] *= wl;
          acc[nt][2] *= wh;
          acc[nt][3] *= wh;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < i) continue;
#pragma unroll
          for (int np2 = 0; np2 < 4; ++np2) {
            if (np2 >= npair) continue;
            uint32_t bf[4];
            mma::frag_bt(bf, c_u, NS, 16 * m, n0 + 16 * np2);
            mma::mma3(acc[2 * np2], dcta[m], bf[0], bf[1]);
            mma::mma3(acc[2 * np2 + 1], dcta[m], bf[2], bf[3]);
          }
        }
        if (cl > 1 && kk > 0 && n0 == 0) cluster_wait();   // every peer has read the last exchange
        put(acc, n0, 2 * npair, 16 * i, 0, t0);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dwl += __shfl_xor_sync(kFull, dwl, off);
        dwh += __shfl_xor_sync(kFull, dwh, off);
      }
      if (q == 0) {
        dwt[s_lo] = dwl;
        dwt[s_hi] = dwh;
      }
      // dx = wt (B.dS^T) + G^T.dy
      for (int p0 = 0; p0 < Pp; p0 += 64) {
        const int npair = min(4, (Pp - p0) / 16);
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kn = 0; kn < 8; ++kn) {
          if (16 * kn >= Np) continue;
          uint32_t af[4];
          mma::frag_a(af, b_u, NS, 16 * i, 16 * kn);
#pragma unroll
          for (int pp2 = 0; pp2 < 4; ++pp2) {
            if (pp2 >= npair) continue;
#pragma unroll
            for (int term = 2; term >= 0; --term) {
              uint32_t bf[4];
              mma::frag_b(bf, ds_u + term * ds_term, NS, p0 + 16 * pp2, 16 * kn);
              mma::mma16816(acc[2 * pp2], af, bf[0], bf[1]);
              mma::mma16816(acc[2 * pp2 + 1], af, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] *= wl;
          acc[nt][1] *= wl;
          acc[nt][2] *= wh;
          acc[nt][3] *= wh;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < i) continue;
#pragma unroll
          for (int pp2 = 0; pp2 < 4; ++pp2) {
            if (pp2 >= npair) continue;
            uint32_t bf[4];
            mma::frag_bt(bf, dy_u, XS, 16 * m, p0 + 16 * pp2);
            mma::mma3(acc[2 * pp2], gta[m], bf[0], bf[1]);
            mma::mma3(acc[2 * pp2 + 1], gta[m], bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = p0 + 8 * nt + 2 * q;
          if (nt >= 2 * npair || p >= P) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int s = hf ? s_hi : s_lo;
            if (s < chunk)
              *reinterpret_cast<uint32_t*>(dx + ((b * Tn + t0 + s) * H + h) * P + p) =
                  mma::pack(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
          }
        }
      }
    }

    // every warp: its panels' sum dS S0 (for dtotal), then dS <- exp(total)
    // dS + (exp(cum) dy)^T.C: (exp(cum) dy)^T from ldmatrix.trans of the dy
    // tile, scaled and split in registers; C k-major (ldmatrix.trans)
    if (cl > 1) cluster_arrive();       // this thread's exchange writes are done
    {
      float part = 0.f;
#pragma unroll
      for (int ii = 0; ii < PW; ++ii) {
        const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
        if (pi >= npanels) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = 16 * prow + g + 8 * hf, n = 32 * pcol + 8 * nt + 2 * q;
            if (p < P && n < N) {
              const float2 s0 = s0v(p, n);
              part += st[ii][nt][2 * hf] * s0.x + st[ii][nt][2 * hf + 1] * s0.y;
            }
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
      if (lane == 0) red[warp] = part;
    }
    const float decay = expf(total);
#pragma unroll
    for (int ii = 0; ii < PW; ++ii) {
      const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[ii][nt][e] *= decay;
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        uint32_t xr[4], xa[3][4];
        mma::frag_at(xr, dy_u, XS, 16 * prow, 16 * j);
        float lo[4], hi[4];
#pragma unroll
        for (int xq = 0; xq < 4; ++xq) {
          const int t = 16 * j + 2 * q + 8 * (xq >> 1);
          const float2 f = mma::unpack(xr[xq]);
          lo[xq] = f.x * ec[t];
          hi[xq] = f.y * ec[t + 1];
        }
        mma::split3x4(lo, hi, xa);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          if (32 * pcol + 16 * n2 >= Np) continue;
          uint32_t bf[4];
          mma::frag_bt(bf, c_u, NS, 16 * j, 32 * pcol + 16 * n2);
          mma::mma3(st[ii][2 * n2], xa, bf[0], bf[1]);
          mma::mma3(st[ii][2 * n2 + 1], xa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                    // every reader of the split dS, the tiles and the vectors is done
    if (kk + 1 < nchunks) write_split();
  }
  if (warp == 1) walk(vec0 + ((nchunks - 1) & 1) * kVecs * kTile, 0);
  if (cl > 1) {
    read_peers(0);                      // the first chunk's exchange
    cluster_wait();                     // no peer reads this block's exchange any more
  }
#pragma unroll
  for (int ii = 0; ii < PW; ++ii) {
    const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = 16 * prow + g + 8 * hf, n = 32 * pcol + 8 * nt + 2 * q;
        if (pi < npanels && p < P && n < N)
          *reinterpret_cast<float2*>(dstate + bh * PN + static_cast<long>(p) * N + n) =
              make_float2(st[ii][nt][2 * hf], st[ii][nt][2 * hf + 1]);
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dA_pairs += __shfl_xor_sync(kFull, dA_pairs, off);
  if (lane == 0) fin[warp] = dA_pairs;
  __syncthreads();
  if (tid == 32) {                      // warp 1's first lane holds the other terms
    float pairs = 0.f;
    for (int w = 0; w < kBwThreads / 32; ++w) pairs += fin[w];
    dA_part[bh] = pairs + dA_rest;
  }
}

template <int PW>
int launch_bf16(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                const float* states, const void* dy, const float* ds_out, void* dx, float* ddt,
                float* dA_part, float* dB_part, float* dC_part, float* dstate, int B, int T,
                int H, int P, int N, int chunk, cudaStream_t stream) {
  const int Pp = (P + 15) & ~15, Np = (N + 15) & ~15;
  const int cl = bwd_cluster(H, Np);
  const BwdLayout L(Pp, Np, cl > 1);
  auto kernel = ssd_bwd_bf16_kernel<PW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kBwThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using bf = __nv_bfloat16;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf*>(x), dt, A, static_cast<const bf*>(Bm),
      static_cast<const bf*>(Cm), states, static_cast<const bf*>(dy), ds_out,
      static_cast<bf*>(dx), ddt, dA_part, dB_part, dC_part, dstate, T, H, P, N, chunk, cl));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, Bm, Cm, dy and dx bf16 (``bf16``) or f32; dt, A, the chunk states
// (B, H, T / chunk, P, N), ds_out (or null: zeros), ddt, dstate and the
// partials f32: dA_part (B, H); dB_part and dC_part (B, T, H, N) in f32,
// (B, T, H / cluster, N) in bf16, the cluster being the largest divisor of
// H up to 8 where N <= 64, else 1 (``bwd_cluster``; the wrapper's
// ``ssd_bwd_cluster``). P, N <= 128 and chunk <= 64; in bf16 also P and N
// multiples of 8 and every bf16 pointer and the states 16-byte aligned;
// else cudaErrorInvalidValue.
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
  if (!bf16)
    return launch<float>(x, dt, A, Bm, Cm, states, dy, ds_out, dx, ddt, dA_part, dB_part,
                         dC_part, dstate, B, T, H, P, N, chunk, st);
  if (P % 8 || N % 8 || !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(dy) ||
      !aligned16(dx) || !aligned16(states) || !aligned16(ds_out) || !aligned16(dstate))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = ((P + 15) / 16) * (((N + 15) / 16 * 16 + 31) / 32);   // dS's, 8 warps a block
#define SSD_BWD_LAUNCH(PW)                                                                      \
  launch_bf16<PW>(x, dt, A, Bm, Cm, states, dy, ds_out, dx, ddt, dA_part, dB_part, dC_part, \
                  dstate, B, T, H, P, N, chunk, st)
  if (panels <= 8) return SSD_BWD_LAUNCH(1);
  if (panels <= 16) return SSD_BWD_LAUNCH(2);
  return SSD_BWD_LAUNCH(4);
#undef SSD_BWD_LAUNCH
}
