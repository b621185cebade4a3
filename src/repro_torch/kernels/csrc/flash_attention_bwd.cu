// flash_attention_bwd: the gradient of flash_attention, for training.
//
// The JAX package has no Pallas backward: it trains by differentiating its
// jnp attention (src/repro/kernels/ref.py:attention_ref). This kernel
// computes that same gradient. For q (B, S, Hq, D), k and v (B, S, Hkv, D),
// the forward's output o, its log-sum-exp lse (B, Hq, S) and the output's
// gradient dO (B, S, Hq, D), with G = Hq / Hkv, scale = 1 / sqrt(D) and
// s_ij = q_i . k_j (j <= i when causal):
//     P_ij   = exp2(s_ij scale log2(e) - lse_i)   (lse in log2 units, as the
//                                                  forward writes it)
//     Di     = sum_d dO_i . o_i              dP_ij = dO_i . v_j
//     dS_ij  = P_ij (dP_ij - Di)
//     dq_i   = scale sum_j dS_ij k_j
//     dk_j   = scale sum_{h in group, i} dS_ij q_i
//     dv_j   = sum_{h in group, i} P_ij dO_i
// Every sum is float32; the outputs take the inputs' type, as JAX's
// gradients take the parameters'. A causally masked or absent key has P = 0.
// No entry recomputes the log-sum-exp: both read the forward's.
//
// Bound on an H100: per call, bytes (q, k, v, o, dO and lse read once; dq,
// dk, dv written once) against 3.35 TB/s, or operations (the five products
// S, dP, dq, dk and dv of 2 B Hq S^2 D each, halved when causal) against
// 989 TFLOP/s of dense bf16. At the train phase's shape (phi3-mini,
// 8x512x32/32x96 causal) the two are of one order: 0.060 ms of bytes and
// 0.033 ms of products. The design computes seven products (S and dP in
// both entries) and keeps every intermediate on the chip, so what bounds
// it in practice is the sequence inside a warpgroup (copy, products,
// exponentials, product) and the short causal walks; the design overlaps
// the exponentials with the next product and runs two blocks an SM.
//
// bf16 (every training shape): tensor cores, asynchronous copies, two
// launches, deterministic (no atomics; two calls give equal bits):
//  A. bwd_dq_tc, one block per tile of 64 packed rows (position, query head
//     of the GQA group) for one (KV head, batch): the forward kernel's
//     skeleton. TMA copies Q and dO once (the forward's 5-D map, box (64
//     head-dim values, Gc heads, Mp positions)) and each 64-key K/V tile
//     into a two-stage ring, 128-byte swizzled, completion on an mbarrier;
//     the S product is waited for alone, so P's exponentials run under the
//     dP product. In the prologue, under those copies, each row's Di = dO .
//     o (from device memory, 16 bytes a load) and the forward's lse are
//     read, and (lse, Di) is written to scratch in packed-row order for B.
//     Then one sweep over the key tiles: S = Q.K^T and dP = dO.V^T are
//     wgmma m64n64k16 with both operands in shared memory; P = exp2(S
//     scale_log2 - lse) and dS = P (dP - Di) in f32 on the fragments; dS
//     rounded to bf16 in registers is the A fragment of dq += dS.K, a wgmma
//     with K read MN-major (the transpose bit), as the forward runs O +=
//     P.V. Key tiles past the block's last position are never loaded;
//     blocks with the most tiles launch first. dq goes back through the Q
//     panels and a TMA store.
//  B. bwd_dkv_tc, one block per (64 keys, KV head, batch), the transposed
//     products so that keys are the accumulator's rows:
//     S^T = K.Q^T and dP^T = V.dO^T (both operands in shared memory),
//     P^T and dS^T rounded to bf16 in registers as A fragments, dV += P^T.dO
//     and dK += dS^T.Q with dO and Q read MN-major. The query tiles are
//     packed across the group's heads (the same Q map), so the group's sum
//     happens inside the products; each Q and dO tile, with its 64 (lse, Di)
//     pairs (one bulk copy), comes through a two-stage TMA ring under the
//     products. dV's product runs under dP^T's wait and dS^T. When causal,
//     tiles before the block's first key are skipped; the mask of a tile's
//     edge reads each packed row's (position, head) from a table, so the
//     inner loop has no integer division. dk and dv go back through the K
//     and V panels and TMA stores; no two blocks write one row.
//  The register limit decides the split: at D = 128 B's dK and dV
//  accumulators take 128 f32 registers a thread and S^T and dP^T 64 more
//  (ptxas -v: 254 registers for B and 154 for A at D = 128, no spills). So
//  a block is one warpgroup of 64 rows or keys, and two blocks share an SM
//  (at most 100 KB of shared memory each), each with its own ring and its
//  own pace: one block's exponentials run under the other's products. Two
//  warpgroups sharing each tile in one block, as the forward does, were
//  slower on an H100 at the training shapes: they wait for each other at
//  every stage. The rows of a Q or dO panel past Gc * Mp (a group that
//  does not divide 64) are zeroed once: they enter B's products as a k
//  dimension.
//  The tensor maps need 16-byte row strides (D % 8 == 0) and 16-byte
//  aligned bases: the wrapper pads other head dims (the scale keeps the
//  true D) and trims the gradients back.
//
// float32 (the parity phases, held to 1e-4): the CUDA-core kernels below,
// because the tensor cores' TF32 keeps about three decimal digits. A per
// (64-row query tile, query head, batch) sweeps the key tiles once for dq,
// with the forward's lse; B per (64-key tile, KV head, batch) loops over the
// group's heads and the query tiles from the tile's first key. Products
// are 64 x 64 tiles from shared memory: each of 256 threads owns rows ty +
// 16 i and columns tx + 16 j.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kTile = 64;              // rows (A) or keys (B) per block, and per inner tile
constexpr int kCols = kMaxD / 16;      // head-dim values a thread owns: tx + 16 j
constexpr int kSLd = kTile + 1;        // the 64 x 64 score tiles' row stride

// Rows row0 .. row0 + 63 of head h of a (B, S, H, D) tensor into dst (row
// stride ld); rows past S and values past D are zeros.
__device__ void stage(float* dst, int ld, const float* __restrict__ src, long b, int S, int H,
                      int h, int D, int Dp, int row0) {
  for (int e = threadIdx.x; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, d = e - r * Dp;
    const int row = row0 + r;
    dst[r * ld + d] = row < S && d < D ? src[((b * S + row) * H + h) * static_cast<long>(D) + d] : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d], and the same for C, E into
// t: the NT products S = Q K^T and dP = dO V^T in one sweep.
__device__ __forceinline__ void nt_tiles(float s[4][4], float t[4][4], const float* A,
                                         const float* Bm, const float* C, const float* E, int ld,
                                         int Dp, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
  for (int d = 0; d < Dp; ++d) {
    float a[4], bb[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * ld + d];
      bb[i] = Bm[(tx + 16 * i) * ld + d];
      c[i] = C[(ty + 16 * i) * ld + d];
      e[i] = E[(tx + 16 * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bb[j];
        t[i][j] += c[i] * e[j];
      }
  }
}

// A: dq and Di for one (64-row query tile, query head, batch)
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta_out,
          int S, int Hq, int Hkv, int D, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 15) & ~15;
  const int ld = Dp + 1;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;
  float* lse_s = ps + kTile * kSLd;
  float* dl_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const long b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ncol = Dp / 16;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * kLog2e;

  stage(qs, ld, q, b, S, Hq, h, D, Dp, q0);
  stage(dos, ld, dout, b, S, Hq, h, D, Dp, q0);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < S ? lse[(b * Hq + h) * S + row] : 0.f;
  }
  __syncthreads();

  // Di = dO_i . o_i: warp w owns rows 8w .. 8w + 7
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const float* orow = o + ((b * S + row) * Hq + h) * static_cast<long>(D);
      for (int d = lane; d < D; d += 32) acc += dos[r * ld + d] * orow[d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      dl_s[r] = acc;
      if (row < S) delta_out[(b * Hq + h) * S + row] = acc;
    }
  }

  // one sweep: dq = scale sum_j P_ij (dP_ij - Di) k_j
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const int kv_end = causal ? min(S, q0 + kTile) : S;
  float s[4][4], t[4][4];
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // Di is written; the last tile's dS is read
    stage(ks, ld, k, b, S, Hkv, hk, D, Dp, kv0);
    stage(vs, ld, v, b, S, Hkv, hk, D, Dp, kv0);
    __syncthreads();
    nt_tiles(s, t, qs, ks, dos, vs, ld, Dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = ty + 16 * i, row = q0 + rr, key = kv0 + tx + 16 * j;
        const bool ok = key < S && (!causal || key <= row);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[rr]) : 0.f;
        ps[rr * kSLd + tx + 16 * j] = p * (t[i][j] - dl_s[rr]);
      }
    __syncthreads();
    const int jn = min(kTile, kv_end - kv0);
    for (int key = 0; key < jn; ++key) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ps[(ty + 16 * i) * kSLd + key];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (j < ncol) {
          const float kk = ks[key * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += ds[i] * kk;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    float* out = dq + ((b * S + row) * Hq + h) * static_cast<long>(D);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (j < ncol && d < D) out[d] = acc[i][j] * scale;
    }
  }
}

// B: dk and dv for one (64-key tile, KV head, batch)
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
           int Hq, int Hkv, int D, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 15) & ~15;
  const int ld = Dp + 1;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;
  float* dss = ps + kTile * kSLd;
  float* lse_s = dss + kTile * kSLd;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const long b = blockIdx.z;
  const int G = Hq / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int ncol = Dp / 16;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * kLog2e;

  stage(ks, ld, k, b, S, Hkv, hk, D, Dp, k0);
  stage(vs, ld, v, b, S, Hkv, hk, D, Dp, k0);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // rows above the tile's first key see none of its keys when causal
  const int row_begin = causal ? k0 : 0;
  float s[4][4], t[4][4];
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int r0 = row_begin; r0 < S; r0 += kTile) {
      __syncthreads();  // the last tile's P and dS are read
      stage(qs, ld, q, b, S, Hq, h, D, Dp, r0);
      stage(dos, ld, dout, b, S, Hq, h, D, Dp, r0);
      if (threadIdx.x < kTile) {
        const int row = r0 + threadIdx.x;
        const long at = (b * Hq + h) * S + row;
        lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
        dl_s[threadIdx.x] = row < S ? delta[at] : 0.f;
      }
      __syncthreads();
      // rows ty + 16 i of the query tile against keys tx + 16 j
      nt_tiles(s, t, qs, ks, dos, vs, ld, Dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = ty + 16 * i, row = r0 + rr, key = k0 + tx + 16 * j;
          const bool ok = row < S && key < S && (!causal || key <= row);
          const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[rr]) : 0.f;
          ps[rr * kSLd + tx + 16 * j] = p;
          dss[rr * kSLd + tx + 16 * j] = p * (t[i][j] - dl_s[rr]);
        }
      __syncthreads();
      // dv_j += sum_i P_ij dO_i, dk_j += sum_i dS_ij q_i: keys ty + 16 i
      const int rn = min(kTile, S - r0);
      for (int rr = 0; rr < rn; ++rr) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = ps[rr * kSLd + ty + 16 * i];
          ds[i] = dss[rr * kSLd + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (j < ncol) {
            const float gd = dos[rr * ld + tx + 16 * j];
            const float qd = qs[rr * ld + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv_acc[i][j] += p[i] * gd;
              dk_acc[i][j] += ds[i] * qd;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const long off = ((b * S + key) * Hkv + hk) * static_cast<long>(D);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (j < ncol && d < D) {
        dk[off + d] = dk_acc[i][j] * scale;
        dv[off + d] = dv_acc[i][j];
      }
    }
  }
}

size_t dq_smem(int D) {
  const int ld = ((D + 15) & ~15) + 1;
  return sizeof(float) * (4 * kTile * ld + kTile * kSLd + 2 * kTile);
}

size_t dkv_smem(int D) {
  const int ld = ((D + 15) & ~15) + 1;
  return sizeof(float) * (4 * kTile * ld + 2 * kTile * kSLd + 2 * kTile);
}

int launch_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* delta, int B, int S, int Hq,
               int Hkv, int D, int causal, cudaStream_t stream) {
  const size_t a_bytes = dq_smem(D), b_bytes = dkv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(a_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid_a((S + kTile - 1) / kTile, Hq, B);
  dq_kernel<<<grid_a, kThreads, a_bytes, stream>>>(f(q), f(k), f(v), f(o), f(dout), lse,
                                                   static_cast<float*>(dq), delta, S, Hq, Hkv, D,
                                                   causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((S + kTile - 1) / kTile, Hkv, B);
  dkv_kernel<<<grid_b, kThreads, b_bytes, stream>>>(f(q), f(k), f(v), f(dout), lse, delta,
                                                    static_cast<float*>(dk),
                                                    static_cast<float*>(dv), S, Hq, Hkv, D,
                                                    causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA rings
// ---------------------------------------------------------------------------
constexpr int kBN = 64;                    // keys per K/V tile (A), per warpgroup (B)
constexpr int kPanel = tc::kPanel;         // head-dim values per 128-byte panel
constexpr int kPanelBytes = tc::kPanelBytes;
constexpr int kStages = 2;                 // K/V tiles (A) or Q/dO tiles (B) in flight
constexpr int kPairBytes = 64 * 8;         // the (lse, Di) pairs of one 64-row tile

// Packed-row geometry shared by both entries: Gc = min(G, 64) heads of the
// group per tile, Mp = 64 / Gc positions, nc head chunks, nt tiles of Mp
// positions. Row r of a tile is position r / Gc, head r % Gc.
struct Packing {
  int Gc, Mp, nc, nt;
};

__host__ __device__ inline Packing packing(int S, int G) {
  const int Gc = G < 64 ? G : 64;
  return {Gc, 64 / Gc, (G + Gc - 1) / Gc, (S + 64 / Gc - 1) / (64 / Gc)};
}

// The first (lse, Di) pair of tile t of head chunk c of (batch b, KV head hk)
// in the scratch: 64 pairs a tile, packed-row order. A writes each tile's
// pairs, B reads them with one bulk copy.
__device__ __forceinline__ long pair_tile(int b, int hk, int c, int t, int Hkv, const Packing& pk) {
  return (((static_cast<long>(b) * Hkv + hk) * pk.nc + c) * pk.nt + t) * 64;
}

// sum of the products of 8 bf16 pairs (16 bytes each), in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// A. One warpgroup a block, 64 packed rows. KS: head-dim steps of 16 (4 for
// D <= 64, else ceil(D / 16)), so NP = ceil(KS / 4) 64-wide panels. Grid:
// (row tiles, Hkv * head chunks, B).
template <int KS>
__global__ void __launch_bounds__(128)
bwd_dq_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const __grid_constant__ CUtensorMap map_dq, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float2* __restrict__ pairs, int S, int Hkv, int G, int D, int causal, float scale_log2,
          float scale) {
  constexpr int NP = (KS + 3) / 4;
  constexpr int last_n = (KS - 4 * (NP - 1)) * 16;  // columns of the last panel
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // one per K/V stage, one for Q and dO

  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the launch adds 1 KB
  auto q_panel = [&](int p) { return base + p * kPanelBytes; };
  auto do_panel = [&](int p) { return base + (NP + p) * kPanelBytes; };
  auto k_panel = [&](int s, int p) { return base + (2 * NP + s * NP + p) * kPanelBytes; };
  auto v_panel = [&](int s, int p) {
    return base + (2 * NP + kStages * NP + s * NP + p) * kPanelBytes;
  };
  const uint32_t bar_q = tma::smem_u32(&bars[kStages]);
  auto bar_kv = [&](int s) { return tma::smem_u32(&bars[s]); };

  const Packing pk = packing(S, G);
  const int Gc = pk.Gc, Mp = pk.Mp;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = gridDim.x - 1 - blockIdx.x;  // the longest causal walks start first
  const int hk = blockIdx.y % Hkv;
  const int c = blockIdx.y / Hkv;            // head chunk
  const int g0 = c * Gc;
  const int b = blockIdx.z;
  const int pos_t = t * Mp;                  // the tile's first position
  const int last_pos = min(S, pos_t + Mp) - 1;
  const int kv_end = causal ? last_pos + 1 : S;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  const uint32_t q_bytes = 2 * NP * kPanel * Gc * Mp * 2;  // Q and dO
  const uint32_t kv_bytes = 2 * NP * kPanelBytes;

  if (tid == 0) {
    tma::prefetch_map(&map_q);
    tma::prefetch_map(&map_k);
    tma::prefetch_map(&map_v);
    tma::prefetch_map(&map_do);
    tma::prefetch_map(&map_dq);
    for (int s = 0; s <= kStages; ++s) tma::mbar_init(tma::smem_u32(&bars[s]), 1);
    tma::mbar_init_fence();
  }
  __syncthreads();
  auto load_kv = [&](int s, int tile) {
    tma::mbar_expect_tx(bar_kv(s), kv_bytes);
    for (int p = 0; p < NP; ++p) {
      tma::load_4d(k_panel(s, p), &map_k, p * kPanel, hk, tile * kBN, b, bar_kv(s));
      tma::load_4d(v_panel(s, p), &map_v, p * kPanel, hk, tile * kBN, b, bar_kv(s));
    }
  };
  if (tid == 0) {
    tma::mbar_expect_tx(bar_q, q_bytes);
    for (int p = 0; p < NP; ++p) {
      tma::load_5d(q_panel(p), &map_q, p * kPanel, g0, hk, pos_t, b, bar_q);
      tma::load_5d(do_panel(p), &map_do, p * kPanel, g0, hk, pos_t, b, bar_q);
    }
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, s);
  }

  // this thread's two rows of the tile: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  int pos[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // under the copies: the forward's lse and Di = dO . o, each quad of
    // lanes splitting the row's 16-byte chunks
    const int r = r0 + 8 * half, head = g0 + r % Gc;
    pos[half] = pos_t + r / Gc;
    const bool valid = r < Gc * Mp && pos[half] < S && head < G;
    const long at = (static_cast<long>(b) * Hkv + hk) * G + head;  // query head b * Hq + h
    float acc = 0.f;
    if (valid) {
      const long row = ((static_cast<long>(b) * S + pos[half]) * Hkv * G + hk * G + head) * D;
      const uint4* orow = reinterpret_cast<const uint4*>(o + row);
      const uint4* drow = reinterpret_cast<const uint4*>(dout + row);
      for (int c8 = lane % 4; c8 < D / 8; c8 += 4) acc += dot8(orow[c8], drow[c8]);
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    di_r[half] = acc;
    lse_r[half] = valid ? lse[at * S + pos[half]] : 0.f;
  }
  if (lane % 4 == 0) {
    float2* tile = pairs + pair_tile(b, hk, c, t, Hkv, pk);
    tile[r0] = make_float2(lse_r[0], di_r[0]);
    tile[r0 + 8] = make_float2(lse_r[1], di_r[1]);
  }

  float dq[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;

  tma::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int kv0 = it * kBN;
    tma::mbar_wait(bar_kv(s), (it / kStages) & 1);
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    tc::reg_fence(sc);
    tc::reg_fence(dp);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 into the 128-byte row
      tc::ss_n64(sc, tc::sw128_desc(q_panel(kk / 4) + off),
                 tc::sw128_desc(k_panel(s, kk / 4) + off), kk > 0);
    }
    tc::commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      tc::ss_n64(dp, tc::sw128_desc(do_panel(kk / 4) + off),
                 tc::sw128_desc(v_panel(s, kk / 4) + off), kk > 0);
    }
    tc::commit();
    tc::wait<1>();  // S is done; dP runs under P's exponentials
    tc::reg_fence(sc);

    // P on the fragments, 0 for keys past S and, when causal, past the
    // row's position; then dS = P (dP - Di)
    const bool edge = kv0 + kBN > S || (causal && kv0 + kBN - 1 > pos_t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          float p = exp2f(sc[i] * scale_log2 - lse_r[half]);
          if (edge) {
            const int key = kv0 + 8 * j + col + e;
            if (key >= S || (causal && key > pos[half])) p = 0.f;
          }
          sc[i] = p;
        }
    tc::wait<0>();
    tc::reg_fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - di_r[(i / 2) % 2];
    uint32_t da[4][4];
    tc::to_a_frags(sc, da);
#pragma unroll
    for (int p = 0; p < NP; ++p) tc::reg_fence(dq[p]);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)  // K 16 keys down, MN-major
        tc::rs(dq[p], da[kk], tc::sw128_desc(k_panel(s, p) + kk * 16 * 128),
               p < NP - 1 ? 64 : last_n);
    tc::commit();
    tc::wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) tc::reg_fence(dq[p]);
    __syncthreads();  // the warpgroup is done with stage s
    if (tid == 0 && it + kStages < n_tiles) load_kv(s, it + kStages);
  }

  // dq in bf16 through the Q panels (their last read is done), one TMA store
  // per panel; rows, heads and head-dim values outside the tensor are not
  // written
  tc::store_panels<NP, last_n>(dq, q_panel, r0, col, scale, scale);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < NP; ++p) tma::store_5d(&map_dq, q_panel(p), p * kPanel, g0, hk, pos_t, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// B. One warpgroup a block, 64 keys. Grid: (key tiles, Hkv, B).
template <int KS>
__global__ void __launch_bounds__(128)
bwd_dkv_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap map_dk, const __grid_constant__ CUtensorMap map_dv,
           const float2* __restrict__ pairs, int S, int Hkv, int G, int causal, float scale_log2,
           float scale) {
  constexpr int NP = (KS + 3) / 4;
  constexpr int last_n = (KS - 4 * (NP - 1)) * 16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // one per Q/dO stage, one for K and V
  // packed row j of a tile: (j / Gc) | (j % Gc) << 8 | (j < Gc * Mp) << 16,
  // so the mask of a tile's edge needs no division
  __shared__ int row_of[64];

  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  auto k_panel = [&](int p) { return base + p * kPanelBytes; };
  auto v_panel = [&](int p) { return base + (NP + p) * kPanelBytes; };
  const uint32_t ring = base + 2 * NP * kPanelBytes;  // Q stages, then dO stages
  auto q_panel = [&](int s, int p) { return ring + (s * NP + p) * kPanelBytes; };
  auto do_panel = [&](int s, int p) { return ring + ((kStages + s) * NP + p) * kPanelBytes; };
  const uint32_t pair_base = ring + 2 * kStages * NP * kPanelBytes;
  const float2* pair_smem = reinterpret_cast<const float2*>(smem_raw + (pair_base - raw));
  const uint32_t bar_kv = tma::smem_u32(&bars[kStages]);
  auto bar_q = [&](int s) { return tma::smem_u32(&bars[s]); };

  const Packing pk = packing(S, G);
  const int Gc = pk.Gc, Mp = pk.Mp, rows_live = Gc * Mp;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBN;  // the lowest keys, the longest causal walks, first
  const int t_begin = causal ? k0 / Mp : 0;  // the tile of position k0
  const int per_chunk = pk.nt - t_begin;
  const int n_q = pk.nc * per_chunk;
  const uint32_t tile_bytes = 2 * NP * kPanel * rows_live * 2 + kPairBytes;

  // rows past Gc * Mp of the Q and dO stages are never written by a copy:
  // zeros, since they are a k dimension of B's products
  if (rows_live < 64) {
    const int words = (64 - rows_live) * 32;
    for (int i = tid; i < 2 * kStages * NP * words; i += 128) {
      const int panel = i / words, rem = i % words;
      const uint32_t addr = ring + panel * kPanelBytes + (rows_live + rem / 32) * 128 + (rem % 32) * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(0) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid < 64) row_of[tid] = tid / Gc | (tid % Gc) << 8 | (tid < rows_live) << 16;
  if (tid == 0) {
    tma::prefetch_map(&map_q);
    tma::prefetch_map(&map_k);
    tma::prefetch_map(&map_v);
    tma::prefetch_map(&map_do);
    tma::prefetch_map(&map_dk);
    tma::prefetch_map(&map_dv);
    for (int s = 0; s <= kStages; ++s) tma::mbar_init(tma::smem_u32(&bars[s]), 1);
    tma::mbar_init_fence();
  }
  __syncthreads();
  auto load_q = [&](int s, int it) {
    const int c = it / per_chunk, t = t_begin + it % per_chunk;
    tma::mbar_expect_tx(bar_q(s), tile_bytes);
    for (int p = 0; p < NP; ++p) {
      tma::load_5d(q_panel(s, p), &map_q, p * kPanel, c * Gc, hk, t * Mp, b, bar_q(s));
      tma::load_5d(do_panel(s, p), &map_do, p * kPanel, c * Gc, hk, t * Mp, b, bar_q(s));
    }
    tma::bulk_load(pair_base + s * kPairBytes, pairs + pair_tile(b, hk, c, t, Hkv, pk),
                   kPairBytes, bar_q(s));
  };
  if (tid == 0) {
    tma::mbar_expect_tx(bar_kv, 2 * NP * kPanelBytes);
    for (int p = 0; p < NP; ++p) {
      tma::load_4d(k_panel(p), &map_k, p * kPanel, hk, k0, b, bar_kv);
      tma::load_4d(v_panel(p), &map_v, p * kPanel, hk, k0, b, bar_kv);
    }
    for (int s = 0; s < kStages && s < n_q; ++s) load_q(s, s);
  }

  // this thread's two keys of the block's 64: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int key[2] = {k0 + r0, k0 + r0 + 8};

  float dk[NP][32], dv[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.f;

  tma::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % kStages;
    const int c = it / per_chunk;
    const int pos_t = (t_begin + it % per_chunk) * Mp;  // the tile's first position
    tma::mbar_wait(bar_q(s), (it / kStages) & 1);
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    tc::reg_fence(st);
    tc::reg_fence(dpt);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      tc::ss_n64(st, tc::sw128_desc(k_panel(kk / 4) + off),
                 tc::sw128_desc(q_panel(s, kk / 4) + off), kk > 0);
    }
    tc::commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      tc::ss_n64(dpt, tc::sw128_desc(v_panel(kk / 4) + off),
                 tc::sw128_desc(do_panel(s, kk / 4) + off), kk > 0);
    }
    tc::commit();
    tc::wait<1>();  // S^T is done; dP^T runs under P^T's exponentials
    tc::reg_fence(st);

    // columns are the tile's packed rows j: P^T, 0 where the key lies past S
    // or, when causal, past the row's position, and for rows that are no
    // (position < S, head < G) of the tile
    const float2* pr = pair_smem + s * 64;
    float di[16];
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 ld = pr[8 * j8 + col + e];  // (lse, Di)
        di[2 * j8 + e] = ld.y;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j8 + 2 * half + e;
          st[i] = exp2f(st[i] * scale_log2 - ld.x);
        }
      }
    const bool edge = k0 + kBN > S || pos_t + Mp > S || rows_live < 64 || (c + 1) * Gc > G ||
                      (causal && pos_t < k0 + kBN - 1);
    if (edge) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row_of[8 * j8 + col + e];
          const int pos = pos_t + (r & 0xff);
          const bool row_ok = (r >> 16) && pos < S && c * Gc + ((r >> 8) & 0xff) < G;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (!(row_ok && key[half] < S && (!causal || key[half] <= pos)))
              st[4 * j8 + 2 * half + e] = 0.f;
        }
    }
    // dV += P^T.dO under dP^T's wait and dS^T, then dK += dS^T.Q
    uint32_t pa[4][4], da[4][4];
    tc::to_a_frags(st, pa);
#pragma unroll
    for (int p = 0; p < NP; ++p) tc::reg_fence(dv[p]);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)  // dO 16 packed rows down, MN-major
        tc::rs(dv[p], pa[kk], tc::sw128_desc(do_panel(s, p) + kk * 16 * 128),
               p < NP - 1 ? 64 : last_n);
    tc::commit();
    tc::wait<1>();  // dP^T is done
    tc::reg_fence(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - di[2 * (i / 4) + i % 2]);
    tc::to_a_frags(dpt, da);
#pragma unroll
    for (int p = 0; p < NP; ++p) tc::reg_fence(dk[p]);
    tc::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)  // Q 16 packed rows down, MN-major
        tc::rs(dk[p], da[kk], tc::sw128_desc(q_panel(s, p) + kk * 16 * 128),
               p < NP - 1 ? 64 : last_n);
    tc::commit();
    tc::wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tc::reg_fence(dk[p]);
      tc::reg_fence(dv[p]);
    }
    __syncthreads();  // the warpgroup is done with stage s
    if (tid == 0 && it + kStages < n_q) load_q(s, it + kStages);
  }

  // dk and dv in bf16 through the K and V panels, one TMA store per panel;
  // keys past S and head-dim values past D are not written
  tc::store_panels<NP, last_n>(dk, k_panel, r0, col, scale, scale);
  tc::store_panels<NP, last_n>(dv, v_panel, r0, col, 1.f, 1.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < NP; ++p) {
      tma::store_4d(&map_dk, k_panel(p), p * kPanel, hk, k0, b);
      tma::store_4d(&map_dv, v_panel(p), p * kPanel, hk, k0, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// q, dO, dq: (B, S, Hq, D) as (D, G, Hkv, S, B), box (64, Gc, 1, Mp, 1);
// k, v, dk, dv: (B, S, Hkv, D) as (D, Hkv, S, B), box (64, 1, 64, 1)
struct Maps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

struct Args {
  const void* o;
  const void* dout;
  const float* lse;
  float2* pairs;
  int B, S, Hkv, G, D, causal;
  float scale_log2, scale;
};

bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  return tma::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int KS>
int launch_dq(const Maps& m, const Args& a, cudaStream_t stream) {
  constexpr int NP = (KS + 3) / 4;
  const Packing pk = packing(a.S, a.G);
  const int smem = 1024 + 2 * (1 + kStages) * NP * kPanelBytes;  // Q, dO, the K/V ring
  auto kernel = bwd_dq_tc<KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(pk.nt, a.Hkv * pk.nc, a.B);
  kernel<<<grid, 128, smem, stream>>>(m.q, m.k, m.v, m.dout, m.dq,
                                      static_cast<const __nv_bfloat16*>(a.o),
                                      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.pairs,
                                      a.S, a.Hkv, a.G, a.D, a.causal, a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_dkv(const Maps& m, const Args& a, cudaStream_t stream) {
  constexpr int NP = (KS + 3) / 4;
  // K, V, the Q/dO ring and its (lse, Di) pairs
  const int smem = 1024 + 2 * (1 + kStages) * NP * kPanelBytes + kStages * kPairBytes;
  auto kernel = bwd_dkv_tc<KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBN - 1) / kBN, a.Hkv, a.B);
  kernel<<<grid, 128, smem, stream>>>(m.q, m.k, m.v, m.dout, m.dk, m.dv, a.pairs, a.S, a.Hkv,
                                      a.G, a.causal, a.scale_log2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_ks(const Maps& m, const Args& a, cudaStream_t stream) {
  const int err = launch_dq<KS>(m, a, stream);
  return err != 0 ? err : launch_dkv<KS>(m, a, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                void* dv, const Args& a, cudaStream_t stream) {
  const int G = a.G, Hkv = a.Hkv, Hq = G * Hkv, D = a.D, S = a.S, B = a.B;
  const Packing pk = packing(S, G);
  const cuuint64_t e = 2;  // bytes per value
  const cuuint64_t qdims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t qstrides[4] = {D * e, (cuuint64_t)G * D * e, (cuuint64_t)Hq * D * e,
                                  (cuuint64_t)S * Hq * D * e};
  const cuuint32_t qbox[5] = {(cuuint32_t)kPanel, (cuuint32_t)pk.Gc, 1, (cuuint32_t)pk.Mp, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstrides[3] = {D * e, (cuuint64_t)Hkv * D * e, (cuuint64_t)S * Hkv * D * e};
  const cuuint32_t kbox[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)kBN, 1};
  Maps m;
  if (!make_map(&m.q, q, 5, qdims, qstrides, qbox) ||
      !make_map(&m.dout, dout, 5, qdims, qstrides, qbox) ||
      !make_map(&m.dq, dq, 5, qdims, qstrides, qbox) ||
      !make_map(&m.k, k, 4, kdims, kstrides, kbox) || !make_map(&m.v, v, 4, kdims, kstrides, kbox) ||
      !make_map(&m.dk, dk, 4, kdims, kstrides, kbox) ||
      !make_map(&m.dv, dv, 4, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 15) / 16) {
    case 5: return launch_ks<5>(m, a, stream);
    case 6: return launch_ks<6>(m, a, stream);
    case 7: return launch_ks<7>(m, a, stream);
    case 8: return launch_ks<8>(m, a, stream);
    default: return launch_ks<4>(m, a, stream);  // D <= 64
  }
}

// floats of scratch a call needs: bf16, the (lse, Di) pairs of every tile of
// packed rows; f32, Di as (B, Hq, S)
long long scratch_floats(int B, int S, int Hq, int Hkv, int bf16) {
  if (!bf16) return static_cast<long long>(B) * Hq * S;
  const Packing pk = packing(S, Hq / Hkv);
  return static_cast<long long>(B) * Hkv * pk.nc * pk.nt * 64 * 2;
}

}  // namespace

// q, o, dout, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D), all contiguous
// and of one type: bf16 when bf16 != 0, else f32. lse (B, Hq, S) float32:
// the forward kernel's, in log2 units. Scores are scaled by
// 1/sqrt(scale_dim). scratch: at least scratch_floats(...) floats, written
// by the first launch and read by the second. bf16 needs D % 8 == 0 and
// 16-byte aligned tensors and scratch (the copies' rule); f32 needs
// scale_dim == D.
extern "C" int memforest_flash_attention_bwd(const void* q, const void* k, const void* v,
                                             const void* o, const void* lse, const void* dout,
                                             void* dq, void* dk, void* dv, void* scratch,
                                             long long scratch_len, int B, int S, int Hq, int Hkv,
                                             int D, int scale_dim, int causal, int bf16,
                                             void* stream) {
  if (D < 1 || D > kMaxD || scale_dim < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (scratch_len < scratch_floats(B, S, Hq, Hkv, bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const float* l = static_cast<const float*>(lse);
  if (!bf16) {
    if (scale_dim != D) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(q, k, v, o, l, dout, dq, dk, dv, sc, B, S, Hq, Hkv, D, causal, s);
  }
  const auto misaligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 != 0; };
  if (D % 8 != 0 || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o) ||
      misaligned(dout) || misaligned(dq) || misaligned(dk) || misaligned(dv) || misaligned(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  // scale_log2 as the forward kernel computes it, the domain of its lse
  const float scale = 1.0f / sqrtf(static_cast<float>(scale_dim));
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(scale_dim));
  const Args a{o, dout, l, reinterpret_cast<float2*>(sc), B, S, Hkv, Hq / Hkv, D, causal,
               scale_log2, scale};
  return launch_bf16(q, k, v, dout, dq, dk, dv, a, s);
}
