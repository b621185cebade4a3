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
// sums are f32 and o is written in r's type.
//
// Bound on an H100: at rwkv6-1.6b's prefill shape (B 8, T 128, H 32, K = V =
// 64) the kernel moves about 34 MB (r, k, v, o in bf16, w and the state in
// f32) and needs about 1 GFLOP, so memory bounds it: about 0.010 ms at 3.35
// TB/s.
//
// Two paths, chosen by the inputs' type.
//
// bf16, on the tensor cores. One block of 8 warps per (head, slice of Vb =
// 64 or 32 columns of V, batch), walking the chunks in order: o's columns
// and the state's columns v are independent given A, which each slice
// recomputes (Vb = 64 at the main shape, 256 blocks; 32 at 1x4096, and
// wherever K > 64, as shared memory allows). Warp w owns sub-chunk w % 4 of
// a chunk (16 tokens) and half w / 4 of the work on it. Per chunk:
//  - r, k, v and w arrive by cp.async in a two-stage ring; rows past the
//    chunk and columns past K or V arrive as zeros (any chunk <= 64, any K,
//    V <= 128, in 64-row, 16-padded tiles).
//  - the log-decays -exp(w) (all threads), then their sums down each key
//    column in row order, one thread a column, and ce = cum - ld as the
//    reference forms it: where the decay is strong the gate of s = t - 1 is
//    exp of a difference that is 0 up to rounding, so another order of the
//    sums, or ce taken as cum[t - 1], moves the output beyond the card's
//    criterion.
//  - A by sub-chunks of 16 tokens. Only the diagonal 16 x 16 block computes
//    the gate's exponentials, on the CUDA cores (s < t, and the bonus r.u.k
//    at s = t): 4x fewer than the whole lower triangle. The blocks below it,
//    s < 16i <= t, are one product: with b = 16i - 1, exp(ce[t] - cum[s]) =
//    exp(ce[t] - cum[b]) exp(cum[b] - cum[s]), both exponents <= 0, so r and
//    k rescaled by the two factors (each <= 1; one that underflows stands
//    for a product at least as small) give them as r'.k'^T on the tensor
//    cores. The two warps of a sub-chunk take half of the keys each (the
//    diagonal's first and second half, the product's even and odd k16
//    steps) and add their partial A through shared memory, in one order, so
//    both hold the same A.
//  - o = (r exp(ce)).S + A.v, each warp of the pair for half of the slice's
//    columns, and S <- exp(total) S + (k exp(min(total - cum, 0)))^T.v,
//    with mma.sync m16n8k16 fed by ldmatrix (.trans for v, for k^T and for
//    the state, read k-major). A's f32 fragments, packed in pairs, are the A
//    fragments of A.v. The (K, Vb) f32 state lives in registers as the
//    update's accumulators, panels of 16 keys x 32 columns over the 8 warps;
//    its bf16 split goes to shared memory after each update for the next
//    chunk's r'.S.
// The split: mma.sync takes bf16 only. r, k and v are bf16 inputs and enter
// exactly, as one term; A, the state and the rescaled r and k are f32 and
// enter as three bf16 terms h = bf16(a), m = bf16(a - h), l = bf16(a - h -
// m), so a product with one split side takes 3 mma and one with two split
// sides the 6 terms with i + j < 3. Why three: emulated on the CPU
// (`PYTHONPATH=src python tests/test_torch_scan_design.py` prints the
// table; 1x128x4x64x64, chip_smoke.py's inputs), the output lies beyond the
// card's criterion (one bf16 ulp of the plain value + 2e-4) by 9.8e-2 with
// one term; with two by 3.8e-5 at w ~ N(-0.5, 0.5), 7.6e-6 at N(1.5, 0.5)
// and 2.4e-4 at N(-6, 0.5), a decay close to 1 (fails); with three by
// 2.4e-7, 2.4e-7 and 2.3e-5.
// Shared memory: 132 KiB at Vb = 64, K = 64 (one block an SM).
//
// Training: given ``s_chunks`` (null at inference), both paths also write
// the f32 state that enters each chunk, (B, H, T / chunk, K, V), which the
// backward kernel (rwkv6_scan_bwd.cu) reads; in the bf16 path each warp
// writes the rows of its register panels, as it writes the final state.
//
// float32, on the CUDA cores (the first version, kept for the parity
// phases). The Pallas grid walks (batch, head, chunk) with the chunk axis in
// sequence and materialises the (C, C, K) gate, a 1 MB VMEM tile. Here one
// block owns one (head, batch) and a loop inside it walks the chunks in
// order; the (K, V) state stays in shared memory for the whole scan, or,
// where the working set would pass 227 KB (K = V = 128 at a chunk of 64:
// 247 KB), in the final state's output in global memory, one state a block
// (read and written in place through L1 and L2; the wrapper's
// fwd_state_in_global mirrors the choice). Per
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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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

constexpr int kMaxSmem = 227 * 1024;   // the most shared memory a block may take (H100)

// Floats of the float32 kernel's shared memory: the carried (K, V) state,
// then r, k and cum (chunk x (K + 1)), ce, v, A and the bonus. The wrapper's
// ``fwd_smem_floats`` is the same count. Past kMaxSmem (K = V = 128: 247
// KB) the state moves to global memory: it is carried in the final state's
// output itself, one state a block, and shared memory holds the rest.
size_t smem_floats(int K, int V, int chunk) {
  const size_t c = chunk, KP = K + 1;
  return static_cast<size_t>(K) * V + 3 * c * KP + c * K + c * V + c * c + K;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const T* __restrict__ u,
                  const float* __restrict__ s_in, T* __restrict__ o,
                  float* s_out, float* __restrict__ s_chunks, int Tn, int H,
                  int K, int V, int chunk, bool state_in_global) {
  extern __shared__ __align__(16) float smem[];
  // At K = V = 64 and a chunk of 64 this is 28,928 floats (113 KB): two
  // blocks fit on one SM. A and ce are read two rows at a time by a warp
  // and left unpadded for that (a two-way bank conflict on those loads).
  const int KP = K + 1;                 // padded rows of r, k and cum
  const long state0 = (blockIdx.y * static_cast<long>(H) + blockIdx.x) * K * V;
  // K x V, the carried state: in shared memory, or in s_out (global memory)
  float* S = state_in_global ? s_out + state0 : smem;
  float* rs = (state_in_global ? smem : smem + K * V);   // chunk x KP: r, then r * exp(ce)
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

  for (int i = tid; i < K * V; i += kThreads) S[i] = s_in[state0 + i];
  for (int i = tid; i < K; i += kThreads) us[i] = to_f32(u[h * K + i]);

  for (int t0 = 0; t0 < Tn; t0 += chunk) {
    __syncthreads();                    // the last chunk's readers are done
    if (s_chunks) {                     // training: the state entering this chunk
      float* dst = s_chunks + ((b * H + h) * (Tn / chunk) + t0 / chunk) * static_cast<long>(K) * V;
      for (int i = tid; i < K * V; i += kThreads) dst[i] = S[i];
    }
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
  if (!state_in_global)
    for (int i = tid; i < K * V; i += kThreads) s_out[state0 + i] = S[i];
}

template <typename E>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s_in, void* o, float* s_out, float* s_chunks, int B, int T, int H,
           int K, int V, int chunk, cudaStream_t stream) {
  size_t bytes = smem_floats(K, V, chunk) * sizeof(float);
  const bool state_in_global = bytes > static_cast<size_t>(kMaxSmem);
  if (state_in_global) bytes -= static_cast<size_t>(K) * V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(r), static_cast<const E*>(k), static_cast<const E*>(v), w,
      static_cast<const E*>(u), s_in, static_cast<E*>(o), s_out, s_chunks, T, H, K, V, chunk,
      state_in_global);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBfThreads = 256;   // 8 warps: warp w owns sub-chunk w % 4 and half w / 4
constexpr int kTile = 64;         // rows of a chunk's tiles: a chunk <= 64, zeros past it
constexpr int kXchBytes = 8 * 32 * 32 * 4;   // the halves' partial A, 32 floats a lane

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Byte offsets into dynamic shared memory. bf16 rows are padded by 8 (16
// bytes), f32 rows by 4: the rows one ldmatrix (or one warp's column
// read) touches fall in different banks. Once a chunk's ce and split state
// are read, their room carries the halves' partial A.
struct WkvLayout {
  int KS, VS, WS;                   // row strides (elements): r and k; v and the state; w
  int r, k, v, w, stage;            // stage 0 of the ring (w becomes the inclusive sums in
                                    // place); stage bytes
  int u, ce, sh, bytes;             // the bonus, exclusive sums, split state (3 terms)
  __host__ __device__ WkvLayout(int Kp, int Vb) {
    KS = Kp + 8;
    VS = Vb + 8;
    WS = Kp + 4;
    r = 0;
    k = r + kTile * KS * 2;
    v = k + kTile * KS * 2;
    w = v + kTile * VS * 2;
    stage = w + kTile * WS * 4;
    u = 2 * stage;
    ce = u + Kp * 4;
    sh = ce + kTile * WS * 4;
    bytes = sh + 3 * Kp * VS * 2;
    if (bytes < ce + kXchBytes) bytes = ce + kXchBytes;
  }
};

// One block per (head, V slice of Vb = 32 or 64 columns, batch). K and V
// are multiples of 8 (the wrapper pads them); Kp is K rounded up to 16.
// Warp w computes rows 16 (w % 4)..+15 of A over half w / 4 of the keys; the
// two halves add their partial A through shared memory, and then own half
// of the slice's columns for o. The state's (Kp, Vb) slice lives in
// registers as panels of 16 keys x 32 columns, panel w + 8 i in warp w (PW
// panels a warp at most).
template <int PW>
__global__ void __launch_bounds__(kBfThreads)
wkv_bf16_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                const __nv_bfloat16* __restrict__ u, const float* __restrict__ s_in,
                __nv_bfloat16* __restrict__ o, float* __restrict__ s_out,
                float* __restrict__ s_chunks, int Tn, int H, int K, int V, int chunk, int Vb) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* smem = smem_bytes;
  const int Kp = (K + 15) & ~15;
  const WkvLayout L(Kp, Vb);
  const int h = blockIdx.x % H, v0 = (blockIdx.x / H) * Vb;
  const long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int grp = warp & 3, half = warp >> 2;
  const int nkk = Kp / 16;              // k16 steps over keys
  const int ncp = Vb / 32;              // 32-column panels of the state
  const int npanels = (Kp / 16) * ncp;
  const int nvh = Vb / 32;              // pairs of 8-wide v tiles in a half
  const int vh = half * (Vb / 2);       // this warp's first column of o
  float* us = reinterpret_cast<float*>(smem + L.u);
  float* ce = reinterpret_cast<float*>(smem + L.ce);
  float* xch = ce;                      // [warp][32 values][32 lanes]
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem + L.sh);
  const int sh_term = Kp * L.VS;        // elements from one split term to the next
  const uint32_t sh_u = mma::smem_u32(sh);
  const long state0 = (b * H + h) * static_cast<long>(K) * V;

  // a chunk's r, k, w and v (its Vb columns) into ring stage ``stage``;
  // rows past the chunk and columns past K or V arrive as zeros
  auto load = [&](int stage, int t0) {
    const int kp8 = Kp / 8, vp8 = Vb / 8, kp4 = Kp / 4;
    const uint32_t rs = mma::smem_u32(smem + L.r + stage * L.stage);
    const uint32_t ks = mma::smem_u32(smem + L.k + stage * L.stage);
    for (int i = tid; i < kTile * kp8; i += kBfThreads) {
      const int t = i / kp8, c = i % kp8;
      const bool ok = t < chunk && 8 * c < K;
      const long off = ok ? ((b * Tn + t0 + t) * H + h) * K + 8 * c : 0;
      mma::cp16(rs + (t * L.KS + 8 * c) * 2, r + off, ok);
      mma::cp16(ks + (t * L.KS + 8 * c) * 2, k + off, ok);
    }
    const uint32_t vs = mma::smem_u32(smem + L.v + stage * L.stage);
    for (int i = tid; i < kTile * vp8; i += kBfThreads) {
      const int t = i / vp8, c = i % vp8;
      const bool ok = t < chunk && v0 + 8 * c < V;
      mma::cp16(vs + (t * L.VS + 8 * c) * 2,
                ok ? v + ((b * Tn + t0 + t) * H + h) * V + v0 + 8 * c : v, ok);
    }
    const uint32_t ws = mma::smem_u32(smem + L.w + stage * L.stage);
    for (int i = tid; i < kTile * kp4; i += kBfThreads) {
      const int t = i / kp4, c = i % kp4;
      const bool ok = t < chunk && 4 * c < K;
      mma::cp16(ws + (t * L.WS + 4 * c) * 4, ok ? w + ((b * Tn + t0 + t) * H + h) * K + 4 * c : w,
                ok);
    }
  };

  for (int c = tid; c < Kp; c += kBfThreads) us[c] = c < K ? __bfloat162float(u[h * K + c]) : 0.f;
  // the state's panels: element [i][nt][2 hf + e] is key 16 (pi / ncp) + g +
  // 8 hf, column 32 (pi % ncp) + 8 nt + 2q + e of the slice, pi = warp + 8 i
  float st[PW][4][4];
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    const int pi = warp + 8 * i, prow = pi / ncp, pcol = pi % ncp;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = 16 * prow + g + 8 * hf, c = v0 + 32 * pcol + 8 * nt + 2 * q;
        float2 x = make_float2(0.f, 0.f);
        if (pi < npanels && key < K && c < V)
          x = *reinterpret_cast<const float2*>(s_in + state0 + static_cast<long>(key) * V + c);
        st[i][nt][2 * hf] = x.x;
        st[i][nt][2 * hf + 1] = x.y;
      }
  }
  // the state as three bf16 terms in shared memory, rows key, for r'.S
  auto write_split = [&]() {
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 8 * i, prow = pi / ncp, pcol = pi % ncp;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = (16 * prow + g + 8 * hf) * L.VS + 32 * pcol + 8 * nt + 2 * q;
          uint32_t t0, t1, t2;
          mma::split3(st[i][nt][2 * hf], st[i][nt][2 * hf + 1], t0, t1, t2);
          *reinterpret_cast<uint32_t*>(sh + e) = t0;
          *reinterpret_cast<uint32_t*>(sh + sh_term + e) = t1;
          *reinterpret_cast<uint32_t*>(sh + 2 * sh_term + e) = t2;
        }
    }
  };

  // the state's panels to a (K, V) f32 state in global memory
  auto store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 8 * i, prow = pi / ncp, pcol = pi % ncp;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = 16 * prow + g + 8 * hf, c = v0 + 32 * pcol + 8 * nt + 2 * q;
          if (pi < npanels && key < K && c < V)
            *reinterpret_cast<float2*>(dst + static_cast<long>(key) * V + c) =
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
      store(s_chunks + ((b * H + h) * nchunks + ci) * static_cast<long>(K) * V);
    if (ci + 1 < nchunks) load(stage ^ 1, t0 + chunk);
    mma::cp_commit();
    mma::cp_wait<1>();                  // this chunk's copies (this thread's) are in
    __syncthreads();                    // ... and every thread's, and the split state
    float* cum = reinterpret_cast<float*>(smem + L.w + stage * L.stage);
    const uint32_t rs_u = mma::smem_u32(smem + L.r + stage * L.stage);
    const uint32_t ks_u = mma::smem_u32(smem + L.k + stage * L.stage);
    const uint32_t vs_u = mma::smem_u32(smem + L.v + stage * L.stage);
    const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(smem + L.r + stage * L.stage);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(smem + L.k + stage * L.stage);
    // the log-decays -exp(w) and their sums down each column in row order,
    // one thread a column, as the plain version's cumsum takes them (where
    // the decay is strong, the gate of s = t - 1 is exp of ce[t] - cum[t -
    // 1], 0 up to rounding, so another order of the sums moves it by an ulp
    // of |cum|); cum in place of w, and ce = cum - ld as the reference forms it
    if (tid < kBfThreads / Kp * Kp)    // rows t, t + per, ... of column tid % Kp
      for (int c = tid % Kp, t = tid / Kp, per = kBfThreads / Kp; t < kTile; t += per)
        cum[t * L.WS + c] = -expf(cum[t * L.WS + c]);
    __syncthreads();
    for (int c = tid; c < Kp; c += kBfThreads) {
      float run = 0.f;
#pragma unroll
      for (int t0b = 0; t0b < kTile; t0b += 16) {   // 16 loads in flight, then the sums
        float ld[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) ld[t] = cum[(t0b + t) * L.WS + c];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          run += ld[t];
          cum[(t0b + t) * L.WS + c] = run;
          ce[(t0b + t) * L.WS + c] = run - ld[t];
        }
      }
    }
    __syncthreads();
    const float* tot = cum + (chunk - 1) * L.WS;
    const int t_lo = 16 * grp + g, t_hi = t_lo + 8;

    // A, rows of sub-chunk ``grp``, this half's keys: 8 n tiles over s
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    {
      // the diagonal block on the CUDA cores: s < t gated directly, s = t
      // the bonus. This thread's candidates: (t_lo, sa), (t_lo, sa + 1),
      // (t_hi, sa), (t_hi, sa + 1), (t_hi, sa + 8), (t_hi, sa + 9)
      const int sa = 16 * grp + 2 * q, c_lo = half * (Kp / 2);
      float e1 = 0.f, e2 = 0.f, e3 = 0.f, e4 = 0.f, e5 = 0.f, e6 = 0.f, bl = 0.f, bh = 0.f;
      const bool lo_even = g == 2 * q;  // t_lo = sa (else, on the diagonal, sa + 1)
      // four keys a step: 8- and 16-byte loads
      auto bf4 = [](const __nv_bfloat16* p) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo = mma::unpack(raw.x), hi = mma::unpack(raw.y);
        return make_float4(lo.x, lo.y, hi.x, hi.y);
      };
      auto f4 = [](const float* p) { return *reinterpret_cast<const float4*>(p); };
      // sum over four keys of r k exp(min(e - c, 0)), by __expf (2 + 1.2 |x|
      // ulp): a large |x| gives a gate too small to matter
      auto gsum = [](float4 r, float4 k, float4 e, float4 c) {
        return r.x * k.x * __expf(fminf(e.x - c.x, 0.f)) + r.y * k.y * __expf(fminf(e.y - c.y, 0.f)) +
               r.z * k.z * __expf(fminf(e.z - c.z, 0.f)) + r.w * k.w * __expf(fminf(e.w - c.w, 0.f));
      };
      auto dot3 = [](float4 r, float4 u, float4 k) {
        return r.x * u.x * k.x + r.y * u.y * k.y + r.z * u.z * k.z + r.w * u.w * k.w;
      };
      for (int c = c_lo; c < c_lo + Kp / 2; c += 4) {
        const float4 rl = bf4(rs + t_lo * L.KS + c), rh = bf4(rs + t_hi * L.KS + c);
        const float4 cel = f4(ce + t_lo * L.WS + c), ceh = f4(ce + t_hi * L.WS + c);
        const float4 ka = bf4(ks + sa * L.KS + c), kb = bf4(ks + (sa + 1) * L.KS + c);
        const float4 kc = bf4(ks + (sa + 8) * L.KS + c), kd = bf4(ks + (sa + 9) * L.KS + c);
        const float4 ca = f4(cum + sa * L.WS + c), cb = f4(cum + (sa + 1) * L.WS + c);
        const float4 cc = f4(cum + (sa + 8) * L.WS + c), cd = f4(cum + (sa + 9) * L.WS + c);
        const float4 uu = f4(us + c);
        e1 += gsum(rl, ka, cel, ca);
        e2 += gsum(rl, kb, cel, cb);
        e3 += gsum(rh, ka, ceh, ca);
        e4 += gsum(rh, kb, ceh, cb);
        e5 += gsum(rh, kc, ceh, cc);
        e6 += gsum(rh, kd, ceh, cd);
        bl += dot3(rl, uu, lo_even ? ka : kb);
        bh += dot3(rh, uu, lo_even ? kc : kd);
      }
      const int gq = g - 2 * q;         // t - s within the block, less 0 or 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {     // static indices: acc stays in registers
        if (j != grp) continue;
        acc[2 * j][0] = gq > 0 ? e1 : gq == 0 ? bl : 0.f;       // (t_lo, sa)
        acc[2 * j][1] = gq > 1 ? e2 : gq == 1 ? bl : 0.f;       // (t_lo, sa + 1)
        acc[2 * j][2] = e3;                                     // (t_hi, sa): 8 + gq > 0
        acc[2 * j][3] = e4;                                     // (t_hi, sa + 1)
        acc[2 * j + 1][2] = gq > 0 ? e5 : gq == 0 ? bh : 0.f;   // (t_hi, sa + 8)
        acc[2 * j + 1][3] = gq > 1 ? e6 : gq == 1 ? bh : 0.f;   // (t_hi, sa + 9)
      }                                 // (t_lo, sa + 8), (t_lo, sa + 9): above, 0
    }
    // the blocks below the diagonal, s < 16 grp <= t: r and k rescaled
    // about b = 16 grp - 1, the last token before this sub-chunk (s <= b <
    // t), exp(ce_t - cum_s) = exp(ce_t - cum_b) exp(cum_b - cum_s), both
    // factors <= 1 (one that underflows stands for a smaller product); both
    // sides split, one product over the 16 grp columns s; this half's k16
    // steps of keys
    if (grp > 0) {
      const int bref = 16 * grp - 1;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nkk || (kk & 1) != half) continue;
        const int c0 = 16 * kk + 2 * q;
        const float2 cb0 = ld2(cum + bref * L.WS + c0), cb8 = ld2(cum + bref * L.WS + c0 + 8);
        uint32_t ar[4], ra[3][4];
        mma::ldsm_x4(ar, rs_u + ((16 * grp + (lane & 15)) * L.KS + 16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // ar[x]: row t_lo (x even) or t_hi, keys c0 (+8 for x >= 2)
          const int t = x & 1 ? t_hi : t_lo;
          const float2 cb = x >> 1 ? cb8 : cb0, e = ld2(ce + t * L.WS + c0 + (x >> 1) * 8);
          const float2 rv = mma::unpack(ar[x]);
          mma::split3(rv.x * __expf(fminf(e.x - cb.x, 0.f)), rv.y * __expf(fminf(e.y - cb.y, 0.f)),
                      ra[0][x], ra[1][x], ra[2][x]);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j >= grp) continue;
          uint32_t bk[4], kb3[3][4];
          mma::ldsm_x4(bk, ks_u + ((16 * j + (lane & 7) + (lane >> 4) * 8) * L.KS + 16 * kk +
                                   ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            // bk[x]: s = 16j + g (+8 for x >= 2), keys c0 (+8 for odd x)
            const int s = 16 * j + g + (x >> 1) * 8;
            const float2 cb = x & 1 ? cb8 : cb0, cs = ld2(cum + s * L.WS + c0 + (x & 1) * 8);
            const float2 kv = mma::unpack(bk[x]);
            mma::split3(kv.x * __expf(fminf(cb.x - cs.x, 0.f)),
                        kv.y * __expf(fminf(cb.y - cs.y, 0.f)), kb3[0][x], kb3[1][x], kb3[2][x]);
          }
          // the six terms i + j < 3, in two chains a tile
          float part[2][4] = {};
          mma::mma16816(acc[2 * j], ra[0], kb3[2][0], kb3[2][1]);
          mma::mma16816(acc[2 * j + 1], ra[0], kb3[2][2], kb3[2][3]);
          mma::mma16816(part[0], ra[2], kb3[0][0], kb3[0][1]);
          mma::mma16816(part[1], ra[2], kb3[0][2], kb3[0][3]);
          mma::mma16816(acc[2 * j], ra[0], kb3[1][0], kb3[1][1]);
          mma::mma16816(acc[2 * j + 1], ra[0], kb3[1][2], kb3[1][3]);
          mma::mma16816(part[0], ra[1], kb3[1][0], kb3[1][1]);
          mma::mma16816(part[1], ra[1], kb3[1][2], kb3[1][3]);
          mma::mma16816(acc[2 * j], ra[0], kb3[0][0], kb3[0][1]);
          mma::mma16816(acc[2 * j + 1], ra[0], kb3[0][2], kb3[0][3]);
          mma::mma16816(part[0], ra[1], kb3[0][0], kb3[0][1]);
          mma::mma16816(part[1], ra[1], kb3[0][2], kb3[0][3]);
          mma::add(acc[2 * j], part[0]);
          mma::add(acc[2 * j + 1], part[1]);
        }
      }
    }

    // o = (r exp(ce)).S + A.v, this half's columns: r rescaled and the state
    // split first (ce and the split state are then free), A.v once the
    // halves' partial A are added
    float oacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk >= nkk) continue;
      const int c0 = 16 * kk + 2 * q;
      uint32_t ar[4], ra[3][4];
      mma::ldsm_x4(ar, rs_u + ((16 * grp + (lane & 15)) * L.KS + 16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = x & 1 ? t_hi : t_lo, c = c0 + (x >> 1) * 8;
        const float2 rv = mma::unpack(ar[x]);
        const float2 e = ld2(ce + t * L.WS + c);
        mma::split3(rv.x * __expf(e.x), rv.y * __expf(e.y), ra[0][x], ra[1][x], ra[2][x]);
      }
      const int srow = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t bs[3][2][4];
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int vp = 0; vp < 2; ++vp)
          if (vp < nvh)
            mma::ldsm_x4_trans(bs[term][vp], sh_u + (term * sh_term + srow * L.VS + vh + 16 * vp +
                                                     (lane >> 4) * 8) * 2);
#pragma unroll
      for (int ta = 2; ta >= 0; --ta)
#pragma unroll
        for (int tb = 2 - ta; tb >= 0; --tb)
#pragma unroll
          for (int vp = 0; vp < 2; ++vp) {
            if (vp >= nvh) continue;
            mma::mma16816(oacc[2 * vp], ra[ta], bs[tb][vp][0], bs[tb][vp][1]);
            mma::mma16816(oacc[2 * vp + 1], ra[ta], bs[tb][vp][2], bs[tb][vp][3]);
          }
    }
    __syncthreads();                    // ce and the split state are read: their room is free
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(warp * 32 + 4 * nt + e) * 32 + lane] = acc[nt][e];
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)      // A = (first half) + (second half), alike in both
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = xch[((warp ^ 4) * 32 + 4 * nt + e) * 32 + lane];
        acc[nt][e] = half ? other + acc[nt][e] : acc[nt][e] + other;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j > grp) continue;
      uint32_t ga[3][4];
      mma::split3(acc[2 * j][0], acc[2 * j][1], ga[0][0], ga[1][0], ga[2][0]);
      mma::split3(acc[2 * j][2], acc[2 * j][3], ga[0][1], ga[1][1], ga[2][1]);
      mma::split3(acc[2 * j + 1][0], acc[2 * j + 1][1], ga[0][2], ga[1][2], ga[2][2]);
      mma::split3(acc[2 * j + 1][2], acc[2 * j + 1][3], ga[0][3], ga[1][3], ga[2][3]);
      const int vrow = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t bf[2][4];
#pragma unroll
      for (int vp = 0; vp < 2; ++vp)
        if (vp < nvh)
          mma::ldsm_x4_trans(bf[vp], vs_u + (vrow * L.VS + vh + 16 * vp + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int vp = 0; vp < 2; ++vp) {
          if (vp >= nvh) continue;
          mma::mma16816(oacc[2 * vp], ga[term], bf[vp][0], bf[vp][1]);
          mma::mma16816(oacc[2 * vp + 1], ga[term], bf[vp][2], bf[vp][3]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = v0 + vh + 8 * nt + 2 * q;
      if (nt >= 2 * nvh || c >= V) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = hf ? t_hi : t_lo;
        if (t < chunk)
          *reinterpret_cast<uint32_t*>(o + ((b * Tn + t0 + t) * H + h) * V + c) =
              mma::pack(oacc[nt][2 * hf], oacc[nt][2 * hf + 1]);
      }
    }

    // S <- exp(total) S + (k exp(min(total - cum, 0)))^T.v: k^T from
    // ldmatrix.trans of the k tile, rescaled and split in registers
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int pi = warp + 8 * i, prow = pi / ncp, pcol = pi % ncp;
      if (pi >= npanels) continue;
      const int key_lo = 16 * prow + g, key_hi = key_lo + 8;
      const float tl = tot[key_lo], th = tot[key_hi];
      const float dl = expf(tl), dh = expf(th);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        st[i][nt][0] *= dl;
        st[i][nt][1] *= dl;
        st[i][nt][2] *= dh;
        st[i][nt][3] *= dh;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mi = lane >> 3;
        uint32_t kr[4], ka[3][4];
        mma::ldsm_x4_trans(kr, ks_u + ((16 * j + (lane & 7) + (mi >> 1) * 8) * L.KS + 16 * prow +
                                       (mi & 1) * 8) * 2);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // kr[x]: key key_lo (x even) or key_hi, s = 16j + 2q (+8 for x >= 2)
          const int key = x & 1 ? key_hi : key_lo, s = 16 * j + 2 * q + (x >> 1) * 8;
          const float tk = x & 1 ? th : tl;
          const float2 kv = mma::unpack(kr[x]);
          mma::split3(kv.x * __expf(fminf(tk - cum[s * L.WS + key], 0.f)),
                      kv.y * __expf(fminf(tk - cum[(s + 1) * L.WS + key], 0.f)), ka[0][x],
                      ka[1][x], ka[2][x]);
        }
        const int vrow = 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t bf[2][4];
#pragma unroll
        for (int vp = 0; vp < 2; ++vp)
          mma::ldsm_x4_trans(bf[vp], vs_u + (vrow * L.VS + 32 * pcol + 16 * vp + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int term = 2; term >= 0; --term)
#pragma unroll
          for (int vp = 0; vp < 2; ++vp) {
            mma::mma16816(st[i][2 * vp], ka[term], bf[vp][0], bf[vp][1]);
            mma::mma16816(st[i][2 * vp + 1], ka[term], bf[vp][2], bf[vp][3]);
          }
      }
    }
    __syncthreads();                    // every warp is done with the exchange and the stage
    if (ci + 1 < nchunks) write_split();
  }
  store(s_out + state0);
}

template <int PW>
int launch_bf16(const void* r, const void* k, const void* v, const float* w, const void* u,
                const float* s_in, void* o, float* s_out, float* s_chunks, int B, int T, int H,
                int K, int V, int chunk, int Vb, cudaStream_t stream) {
  const WkvLayout L((K + 15) & ~15, Vb);
  cudaError_t err = cudaFuncSetAttribute(wkv_bf16_kernel<PW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (V + Vb - 1) / Vb;
  using bf = __nv_bfloat16;
  wkv_bf16_kernel<PW><<<dim3(H * slices, B), kBfThreads, L.bytes, stream>>>(
      static_cast<const bf*>(r), static_cast<const bf*>(k), static_cast<const bf*>(v), w,
      static_cast<const bf*>(u), s_in, static_cast<bf*>(o), s_out, s_chunks, T, H, K, V, chunk,
      Vb);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// bf16 launches the tensor-core kernel, with ``slice`` columns of V a block
// (32, or 64 where K <= 64; K and V multiples of 8, every pointer but u's
// 16-byte aligned, else cudaErrorInvalidValue); float32 the CUDA-core
// kernel, which ignores ``slice``. ``s_chunks`` (B, H, T / chunk, K, V) f32,
// or null, takes the state entering each chunk.
extern "C" int memforest_rwkv6_scan(const void* r, const void* k, const void* v,
                                    const float* w, const void* u, const float* s_in,
                                    void* o, float* s_out, float* s_chunks, int B, int T,
                                    int H, int K, int V, int chunk, int bf16, int slice,
                                    void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float>(r, k, v, w, u, s_in, o, s_out, s_chunks, B, T, H, K, V, chunk, st);
  if ((slice != 32 && (slice != 64 || K > 64)) || K % 8 || V % 8 || K > 128 || chunk > kTile ||
      !aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) || !aligned16(o) ||
      !aligned16(s_in) || !aligned16(s_out) || !aligned16(s_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = (K + 15) / 16 * (slice / 32);   // of the state, 8 warps a block
  if (panels <= 8)
    return launch_bf16<1>(r, k, v, w, u, s_in, o, s_out, s_chunks, B, T, H, K, V, chunk, slice,
                          st);
  return launch_bf16<2>(r, k, v, w, u, s_in, o, s_out, s_chunks, B, T, H, K, V, chunk, slice, st);
}
