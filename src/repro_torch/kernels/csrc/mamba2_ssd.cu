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
// the state f32; all sums are f32 and y is written in x's type.
//
// Bound on an H100: at zamba2-7b's prefill shape (B 8, T 128, H 112, P = N
// = 64) the kernel moves about 59 MB (x and y in bf16, the f32 state in and
// out) and needs about 2.4 GFLOP, so memory bounds it: about 0.018 ms at
// 3.35 TB/s.
//
// Two paths, chosen by the inputs' type.
//
// bf16, on the tensor cores. One block of 4 warps per (head, slice of Pb
// columns of P, batch), walking the chunks in order; warp w owns rows
// 16w..16w+15 of a chunk. Pb is 64, halved (down to 16) while the blocks
// would leave SMs idle: y's columns and the state's rows p are independent
// given G, which each slice recomputes (1x4096: 224 blocks of 32). Per chunk:
//  - x, B, C and dt arrive by cp.async in a two-stage ring: the next
//    chunk's copies run under this chunk's products. Rows past the chunk and
//    columns past P or N arrive as zeros, so any chunk <= 64 (T = 40, a
//    ragged 32) and any P, N <= 128 take the same 64-row, 16-padded tiles.
//  - cum: one thread sums dt.A in row order (the plain version's order; a
//    tree order moves exp(cum) by an ulp of |cum|, which reaches 700).
//  - C.B^T once per block and chunk (B and C are shared by the heads), only
//    the 16 x 16 blocks with s <= t; G = (C.B^T) exp(min(cum_t - cum_s, 0))
//    dt_s on the product's f32 fragments, which, packed in pairs, are the A
//    fragments of G.x: G never leaves registers.
//  - y = exp(cum_t) (C.S^T) + G.x, S <- exp(total) S + (x w)^T.B, with
//    mma.sync m16n8k16 (bf16 operands, f32 sums) fed by ldmatrix (.trans
//    for x and B, read k-major). The (Pb, N) f32 state lives in registers as
//    the accumulators of the update, panels of 16 x 32 spread over the 4
//    warps; after each update its bf16 split goes to shared memory for the
//    next chunk's C.S^T.
// The split: mma.sync takes bf16 only. x, B and C are bf16 inputs and enter
// exactly, as one term. G, the state and x w are f32: each enters as three
// bf16 terms h = bf16(a), m = bf16(a - h), l = bf16(a - h - m), 24 bits of
// the mantissa, so a product with one split side takes 3 mma (of two split
// sides, the 6 terms with i + j < 3). Each split product goes into a zeroed
// accumulator, smallest term first, and is then added on the CUDA cores.
// Why three: emulated on the CPU (`PYTHONPATH=src python
// tests/test_torch_scan_design.py` prints the table; the inputs of
// chip_smoke.py at 2x128x8x64x64), the output lies beyond the
// card's criterion (one bf16 ulp of the plain value + 2e-4) by 3.1e-2 with
// one term, 1.3e-5 with two (and rwkv6_scan fails with two where the decay
// is close to 1), 0 with three.
// The kernel is compiled per slice width (16, 32, 64), so the loops over
// P's tiles unroll and the accumulators take only the registers they need.
// Shared memory: 82 KiB at the main shape (two blocks an SM).
//
// Training: given ``s_chunks`` (null at inference), both paths also write
// the f32 state that enters each chunk, (B, H, T / chunk, P, N), which the
// backward kernel (mamba2_ssd_bwd.cu) reads; in the bf16 path each warp
// writes the rows of its register panels, as it writes the final state.
//
// float32, on the CUDA cores (the first version, kept for the parity
// phases). The Pallas grid walks (batch, head, chunk) with the chunk axis in
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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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
                  T* __restrict__ y, float* __restrict__ s_out,
                  float* __restrict__ s_chunks, int Tn, int H, int P, int N, int chunk) {
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
    if (s_chunks) {                     // training: the state entering this chunk
      float* dst = s_chunks + ((b * H + h) * (Tn / chunk) + t0 / chunk) * static_cast<long>(P) * N;
      for (int i = tid; i < P * N; i += kThreads) dst[i] = S[(i / N) * NP + i % N];
    }
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
           const float* s_in, void* y, float* s_out, float* s_chunks, int B, int T, int H,
           int P, int N, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mamba2_ssd_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_ssd_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(Bm), static_cast<const E*>(Cm),
      s_in, static_cast<E*>(y), s_out, s_chunks, T, H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBfThreads = 128;   // 4 warps; warp w owns rows 16w..16w+15 of a chunk
constexpr int kTile = 64;         // rows of a chunk's tiles: a chunk <= 64, zeros past it

// Byte offsets into dynamic shared memory. Rows are padded by 8 bf16 (16
// bytes): the 8 rows one ldmatrix reads then start in 8 different 16-byte
// bank groups.
struct SsdLayout {
  int XS, NS;                       // row strides (elements): x tile; B, C, split state
  int x, b, c, dt, stage;           // stage 0 of the ring of a chunk's inputs; stage bytes
  int sh, cum, wts, bytes;          // split state (3 terms), dt.A sums, update weights
  __host__ __device__ SsdLayout(int Pb, int Np) {
    XS = Pb + 8;
    NS = Np + 8;
    x = 0;
    b = x + kTile * XS * 2;
    c = b + kTile * NS * 2;
    dt = c + kTile * NS * 2;
    stage = dt + kTile * 4;
    int off = 2 * stage;
    sh = off;
    off += 3 * Pb * NS * 2;
    cum = off;
    off += kTile * 4;
    wts = off;
    off += kTile * 4;
    bytes = off;
  }
};

// One block per (head, P slice of Pb columns, batch). P and N are
// multiples of 8 (the wrapper pads them), Pb = 16 NP2 is 16, 32 or 64; Np
// is N rounded up to 16. The state's (Pb, Np) slice lives in registers as
// panels of 16 p x 32 n, panel i + 4 j in warp i (PW panels a warp at most).
template <int NP2, int PW>
__global__ void __launch_bounds__(kBfThreads, NP2 <= 2 ? 3 : 2)
ssd_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ s_in,
                __nv_bfloat16* __restrict__ y, float* __restrict__ s_out,
                float* __restrict__ s_chunks, int Tn, int H, int P, int N, int chunk, int Pb) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* smem = smem_bytes;
  const int Np = (N + 15) & ~15;
  const SsdLayout L(Pb, Np);
  const int h = blockIdx.x % H, p0 = (blockIdx.x / H) * Pb;
  const long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const float a = A[h];
  const int nk = Np / 16;               // k16 steps over n
  constexpr int np2 = NP2;              // pairs of 8-wide p tiles: Pb = 16 NP2
  const int npr = (Np + 31) / 32;       // state panels per 16 rows of p
  const int npanels = np2 * npr;
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem + L.sh);
  const int sh_term = Pb * L.NS;        // elements from one split term to the next
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  const uint32_t sh_u = mma::smem_u32(sh);
  const long state0 = (b * H + h) * static_cast<long>(P) * N;

  // a chunk's x (its Pb columns), B, C and dt into ring stage ``stage``;
  // rows past the chunk and columns past P or N arrive as zeros
  auto load = [&](int stage, int t0) {
    const int xp = Pb / 8, np = Np / 8;
    const uint32_t xs = mma::smem_u32(smem + L.x + stage * L.stage);
    for (int i = tid; i < kTile * xp; i += kBfThreads) {
      const int t = i / xp, c = i % xp;
      const bool ok = t < chunk && p0 + 8 * c < P;
      mma::cp16(xs + (t * L.XS + 8 * c) * 2,
                ok ? x + ((b * Tn + t0 + t) * H + h) * P + p0 + 8 * c : x, ok);
    }
    const uint32_t bs = mma::smem_u32(smem + L.b + stage * L.stage), cs = mma::smem_u32(smem + L.c + stage * L.stage);
    for (int i = tid; i < kTile * np; i += kBfThreads) {
      const int t = i / np, c = i % np;
      const bool ok = t < chunk && 8 * c < N;
      const long off = ok ? (b * Tn + t0 + t) * N + 8 * c : 0;
      mma::cp16(bs + (t * L.NS + 8 * c) * 2, Bm + off, ok);
      mma::cp16(cs + (t * L.NS + 8 * c) * 2, Cm + off, ok);
    }
    const uint32_t ds = mma::smem_u32(smem + L.dt + stage * L.stage);
    for (int t = tid; t < kTile; t += kBfThreads) {
      const bool ok = t < chunk;
      mma::cp4(ds + 4 * t, ok ? dt + (b * Tn + t0 + t) * H + h : dt, ok);
    }
  };

  // the state's panels: element [i][nt][2 hf + e] is row p = 16 prow + g +
  // 8 hf of the slice, column n = 32 pcol + 8 nt + 2q + e
  float st[PW][4][4];
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    const int pi = warp + 4 * i, prow = pi / npr, pcol = pi % npr;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + 16 * prow + g + 8 * hf, n = 32 * pcol + 8 * nt + 2 * q;
        float2 v = make_float2(0.f, 0.f);
        if (pi < npanels && p < P && n < N)
          v = *reinterpret_cast<const float2*>(s_in + state0 + static_cast<long>(p) * N + n);
        st[i][nt][2 * hf] = v.x;
        st[i][nt][2 * hf + 1] = v.y;
      }
  }
  // the state as three bf16 terms in shared memory, rows p, for C.S^T
  auto write_split = [&]() {
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 4 * i, prow = pi / npr, pcol = pi % npr;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = 32 * pcol + 8 * nt + 2 * q;
        if (n >= Np) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = (16 * prow + g + 8 * hf) * L.NS + n;
          uint32_t t0, t1, t2;
          mma::split3(st[i][nt][2 * hf], st[i][nt][2 * hf + 1], t0, t1, t2);
          *reinterpret_cast<uint32_t*>(sh + e) = t0;
          *reinterpret_cast<uint32_t*>(sh + sh_term + e) = t1;
          *reinterpret_cast<uint32_t*>(sh + 2 * sh_term + e) = t2;
        }
      }
    }
  };

  // the state's panels to a (P, N) f32 state in global memory
  auto store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 4 * i, prow = pi / npr, pcol = pi % npr;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + 16 * prow + g + 8 * hf, n = 32 * pcol + 8 * nt + 2 * q;
          if (pi < npanels && p < P && n < N)
            *reinterpret_cast<float2*>(dst + static_cast<long>(p) * N + n) =
                make_float2(st[i][nt][2 * hf], st[i][nt][2 * hf + 1]);
        }
    }
  };

  const int nchunks = Tn / chunk;
  load(0, 0);
  mma::cp_commit();
  write_split();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int stage = ci & 1, t0 = ci * chunk;
    if (s_chunks)                       // training: the state entering this chunk
      store(s_chunks + ((b * H + h) * nchunks + ci) * static_cast<long>(P) * N);
    if (ci + 1 < nchunks) load(stage ^ 1, t0 + chunk);
    mma::cp_commit();
    mma::cp_wait<1>();                  // this chunk's copies (this thread's) are in
    __syncthreads();                    // ... and every thread's, and the split state
    const float* dts = reinterpret_cast<const float*>(smem + L.dt + stage * L.stage);
    const uint32_t xs_u = mma::smem_u32(smem + L.x + stage * L.stage);
    const uint32_t bs_u = mma::smem_u32(smem + L.b + stage * L.stage);
    const uint32_t cs_u = mma::smem_u32(smem + L.c + stage * L.stage);
    if (tid == 0) {                     // cum = inclusive sum of dt.A, in row order
      float4 d[kTile / 4];              // every load in flight before the sums
#pragma unroll
      for (int t = 0; t < kTile / 4; ++t) d[t] = reinterpret_cast<const float4*>(dts)[t];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kTile / 4; ++t) {
        float4 c;
        c.x = run += d[t].x * a;
        c.y = run += d[t].y * a;
        c.z = run += d[t].z * a;
        c.w = run += d[t].w * a;
        reinterpret_cast<float4*>(cum)[t] = c;
      }
    }
    __syncthreads();
    if (tid < kTile) {                  // the state update's weights
      const float tot = cum[chunk - 1];
      wts[tid] = dts[tid] * expf(fminf(tot - cum[tid], 0.f));
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    const int t_lo = 16 * warp + g, t_hi = t_lo + 8;
    const float cl = cum[t_lo], ch = cum[t_hi];

    // y = exp(cum_t) (C.S^T) and C.B^T (blocks s <= t only), one pass over n
    float yacc[2 * NP2][4], cb[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * NP2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < 8; ++kn) {
      if (kn >= nk) continue;
      uint32_t af[4];
      mma::ldsm_x4(af, cs_u + ((16 * warp + (lane & 15)) * L.NS + 16 * kn + (lane >> 4) * 8) * 2);
      const int brow = (lane & 7) + (lane >> 4) * 8, bcol = 16 * kn + ((lane >> 3) & 1) * 8;
      uint32_t bf[4][4];                // a step's fragments in flight before its mma
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j <= warp) mma::ldsm_x4(bf[j], bs_u + ((16 * j + brow) * L.NS + bcol) * 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j > warp) continue;
        mma::mma16816(cb[2 * j], af, bf[j][0], bf[j][1]);
        mma::mma16816(cb[2 * j + 1], af, bf[j][2], bf[j][3]);
      }
#pragma unroll
      for (int term = 2; term >= 0; --term) {
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          if (pp < np2)
            mma::ldsm_x4(bf[pp], sh_u + (term * sh_term + (16 * pp + brow) * L.NS + bcol) * 2);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp >= np2) continue;
          mma::mma16816(yacc[2 * pp], af, bf[pp][0], bf[pp][1]);
          mma::mma16816(yacc[2 * pp + 1], af, bf[pp][2], bf[pp][3]);
        }
      }
    }
    {
      const float el = expf(cl), eh = expf(ch);
#pragma unroll
      for (int nt = 0; nt < 2 * NP2; ++nt) {
        yacc[nt][0] *= el;
        yacc[nt][1] *= el;
        yacc[nt][2] *= eh;
        yacc[nt][3] *= eh;
      }
    }

    // G = (C.B^T) exp(min(cum_t - cum_s, 0)) dt_s for s <= t, split in
    // registers into the A fragments of G.x: k step j is n tiles 2j, 2j+1
    uint32_t ga[3][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > warp) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int nt = 2 * j + hf, s = 8 * nt + 2 * q;
        const float d0 = dts[s], d1 = dts[s + 1], c0 = cum[s], c1 = cum[s + 1];
        const float g00 = s <= t_lo ? cb[nt][0] * expf(fminf(cl - c0, 0.f)) * d0 : 0.f;
        const float g01 = s + 1 <= t_lo ? cb[nt][1] * expf(fminf(cl - c1, 0.f)) * d1 : 0.f;
        const float g10 = s <= t_hi ? cb[nt][2] * expf(fminf(ch - c0, 0.f)) * d0 : 0.f;
        const float g11 = s + 1 <= t_hi ? cb[nt][3] * expf(fminf(ch - c1, 0.f)) * d1 : 0.f;
        mma::split3(g00, g01, ga[0][j][2 * hf], ga[1][j][2 * hf], ga[2][j][2 * hf]);
        mma::split3(g10, g11, ga[0][j][2 * hf + 1], ga[1][j][2 * hf + 1], ga[2][j][2 * hf + 1]);
      }
    }
    // y += G.x (x k-major: ldmatrix.trans), G's three terms against bf16 x
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > warp) continue;
      const int xrow = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t bf[4][4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
        if (pp < np2)
          mma::ldsm_x4_trans(bf[pp], xs_u + (xrow * L.XS + 16 * pp + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (pp >= np2) continue;
          mma::mma16816(yacc[2 * pp], ga[term][j], bf[pp][0], bf[pp][1]);
          mma::mma16816(yacc[2 * pp + 1], ga[term][j], bf[pp][2], bf[pp][3]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * NP2; ++nt) {
      const int p = p0 + 8 * nt + 2 * q;
      if (p >= P) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = hf ? t_hi : t_lo;
        if (t < chunk)
          *reinterpret_cast<uint32_t*>(y + ((b * Tn + t0 + t) * H + h) * P + p) =
              mma::pack(yacc[nt][2 * hf], yacc[nt][2 * hf + 1]);
      }
    }

    // S <- exp(total) S + (x w)^T.B: (x w)^T from ldmatrix.trans of the x
    // tile, scaled and split in registers; B k-major (ldmatrix.trans)
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 4 * i, prow = pi / npr, pcol = pi % npr;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][nt][e] *= decay;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mi = lane >> 3;
        uint32_t xr[4], xa[3][4];
        mma::ldsm_x4_trans(xr, xs_u + ((16 * j + (lane & 7) + (mi >> 1) * 8) * L.XS + 16 * prow +
                                       (mi & 1) * 8) * 2);
        const float w0 = wts[16 * j + 2 * q], w1 = wts[16 * j + 2 * q + 1];
        const float w8 = wts[16 * j + 2 * q + 8], w9 = wts[16 * j + 2 * q + 9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = mma::unpack(xr[r]);
          mma::split3(v.x * (r >= 2 ? w8 : w0), v.y * (r >= 2 ? w9 : w1), xa[0][r], xa[1][r],
                      xa[2][r]);
        }
        const int brow = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t bf[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2)
          if (32 * pcol + 16 * n2 < Np)
            mma::ldsm_x4_trans(bf[n2], bs_u + (brow * L.NS + 32 * pcol + 16 * n2 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int term = 2; term >= 0; --term)
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            if (32 * pcol + 16 * n2 >= Np) continue;
            mma::mma16816(st[i][2 * n2], xa[term], bf[n2][0], bf[n2][1]);
            mma::mma16816(st[i][2 * n2 + 1], xa[term], bf[n2][2], bf[n2][3]);
          }
      }
    }
    __syncthreads();                    // every warp is done with the split state and the stage
    if (ci + 1 < nchunks) write_split();
  }
  store(s_out + state0);
}

template <int NP2, int PW>
int launch_bf16(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                const float* s_in, void* y, float* s_out, float* s_chunks, int B, int T, int H,
                int P, int N, int chunk, int Pb, cudaStream_t stream) {
  const SsdLayout L(Pb, (N + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(ssd_bf16_kernel<NP2, PW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (P + Pb - 1) / Pb;
  ssd_bf16_kernel<NP2, PW><<<dim3(H * slices, B), kBfThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), s_in, static_cast<__nv_bfloat16*>(y), s_out,
      s_chunks, T, H, P, N, chunk, Pb);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// bf16 launches the tensor-core kernel, with ``slice`` columns of P a block
// (16, 32 or 64; P and N multiples of 8, every pointer 16-byte
// aligned, else cudaErrorInvalidValue); float32 the CUDA-core kernel, which
// ignores ``slice``. ``s_chunks`` (B, H, T / chunk, P, N) f32, or null,
// takes the state entering each chunk.
extern "C" int memforest_mamba2_ssd(const void* x, const float* dt, const float* A,
                                    const void* Bm, const void* Cm, const float* s_in,
                                    void* y, float* s_out, float* s_chunks, int B, int T,
                                    int H, int P, int N, int chunk, int bf16, int slice,
                                    void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float>(x, dt, A, Bm, Cm, s_in, y, s_out, s_chunks, B, T, H, P, N, chunk, st);
  if ((slice != 16 && slice != 32 && slice != 64) || P % 8 || N % 8 || N > 128 || chunk > kTile ||
      !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y) || !aligned16(s_in) ||
      !aligned16(s_out) || !aligned16(s_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = (slice / 16) * ((N + 31) / 32);   // of the state, 4 warps a block
#define SSD_LAUNCH(NP2, PW) \
  launch_bf16<NP2, PW>(x, dt, A, Bm, Cm, s_in, y, s_out, s_chunks, B, T, H, P, N, chunk, slice, st)
  if (slice == 16) return SSD_LAUNCH(1, 1);
  if (slice == 32) return panels <= 4 ? SSD_LAUNCH(2, 1) : SSD_LAUNCH(2, 2);
  return panels <= 4 ? SSD_LAUNCH(4, 1) : panels <= 8 ? SSD_LAUNCH(4, 2) : SSD_LAUNCH(4, 4);
#undef SSD_LAUNCH
}
