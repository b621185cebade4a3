// flash_attention: GQA attention over one sequence, causal or full, for the
// dense trunk's prefill, zamba2's shared block and the ModelEncoder forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (wrapper flash_attention). For every batch b, query head h and row i:
//     s[j]   = (q[b,i,h,:] . k[b,j,h/G,:]) / sqrt(D)      (j <= i when causal)
//     out    = sum_j softmax(s)[j] * v[b,j,h/G,:]
// with G = Hq / Hkv. Masked scores are -1e30 and the final divide is by
// max(l, 1e-30), as in the Pallas kernel and the reference; the output has
// q's type.
//
// Bound on an H100: at the main path's shapes (S = 28 for the encoder, 128
// for the engine's prefill) bytes: q, k, v and out are read or written once
// for about S/2 operations per byte. At long S (4096) the operations: 4 S^2
// D / 2 per head against 989 TFLOP/s of dense bf16 on the tensor cores.
//
// bf16 (every main-path shape): tensor cores, asynchronous copies.
//  - One block owns a tile of packed rows (position, query head of the GQA
//    group) for one (batch, KV head): 64 rows per consumer warpgroup, one or
//    two warpgroups. Each K/V tile is loaded once for the whole group. Rows
//    are position-major (row = position * Gc + head), so one box of the Q
//    tensor map, (64 head-dim, Gc heads, Mp positions), lands them in place;
//    Gc = min(G, 64) heads at a time and Mp = 64 / Gc positions.
//  - TMA copies Q once and each 64-key K/V tile into a two-stage ring in
//    dynamic shared memory, 128-byte swizzled, completion on an mbarrier.
//    Thread 0 refills a stage as soon as every warpgroup is done with it,
//    so the next tile's copy runs under this tile's products. Out-of-bounds
//    rows and head-dim values arrive as zeros: a head_dim that is not a
//    multiple of 64 is zero-padded in shared memory, and keys past S are
//    masked explicitly (a zero key scores 0, not -1e30).
//  - S = Q.K^T is a wgmma m64n64k16 per 16 head-dim values, both operands
//    K-major in shared memory. The online softmax (exp2, f32) runs on the
//    accumulator fragments; P is rounded to bf16 in registers, where the S
//    fragment of 16 keys is exactly the A fragment of a k16 step, and
//    O += P.V is a wgmma with A from registers and V read MN-major (the
//    transpose bit) from the same swizzled tile, 64 head-dim values (or the
//    last 16/32/48) per instruction.
//  - O, normalised and rounded to bf16, goes back through the warpgroup's Q
//    panels (the same swizzle) and one TMA store per panel: whole 128-byte
//    rows instead of 4-byte pieces from the fragments, and the rows, heads
//    and head-dim values outside the tensor are not written.
//  - The causal mask compares the key with the row's position, never with
//    the packed row index; key tiles past a block's last position are never
//    loaded, and only tiles that cross a position of the block are masked.
//    Blocks with the most key tiles are launched first.
//  - The tensor maps need 16-byte row strides (D % 8 == 0) and 16-byte
//    aligned bases: the wrapper pads other head dims and copies misaligned
//    views before the call.
//  - Training asks for each row's log-sum-exp (lse, (B, Hq, S) float32),
//    written from the online softmax's m and l in its log2 domain: m + log2
//    l on scores scaled by scale_log2 = log2(e) / sqrt(D). The backward
//    (flash_attention_bwd.cu) reads it in that domain, P = exp2(s
//    scale_log2 - lse), and never recomputes it. Inference passes null and
//    the launch is unchanged.
//
// float32 (the parity phases, held to 2e-5 against the CPU): the CUDA-core
// kernel below, because the tensor cores' TF32 keeps about three decimal
// digits; it writes the same lse (its natural m + log l times log2(e)). The
// dispatch is by type, in the C entry point.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: one block per (16-row query tile, head, batch), f32 FMAs on the
// CUDA cores; each warp owns four rows, lane j scores key j of a 32-key tile
// staged in shared memory, and P.V takes p_j from lane j by shuffle.
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kMaxD = 128;                  // a lane owns 4 head-dim values
constexpr int kKStride = kMaxD + 4;         // K rows: 16-byte aligned, no conflicts
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Values d0..d0+3 of one row as floats, zero past D. vec: D % 4 == 0 and the
// tensors 16-byte aligned, so the four values are one aligned 16-byte load.
__device__ __forceinline__ float4 load4(const float* row, int d0, int D, bool vec) {
  if (vec) return d0 < D ? *reinterpret_cast<const float4*>(row + d0) : make_float4(0, 0, 0, 0);
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = d0 + t < D ? row[d0 + t] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int S, int Hq, int Hkv, int D, int causal) {
  __shared__ __align__(16) float qs[kBQ][kMaxD];
  __shared__ __align__(16) float ks[kBK][kKStride];
  __shared__ __align__(16) float vs[kBK][kMaxD];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;
  const int d0 = lane * 4;                   // this lane's head-dim values
  const int D4 = (D + 3) & ~3;               // rows are zero-padded to D4
  const bool vec = (D & 3) == 0 && reinterpret_cast<std::uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(v) % 16 == 0;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  // each warp stages its own rows, one 4-value vector per lane
  for (int r = warp; r < kBQ; r += kWarps) {
    const int row = q0 + r;
    *reinterpret_cast<float4*>(&qs[r][d0]) =
        row < S ? load4(q + ((b * S + row) * Hq + h) * D, d0, D, vec) : make_float4(0, 0, 0, 0);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;
  }

  // keys past the block's last row are above the causal diagonal: skipped
  const int kv_end = causal ? min(S, q0 + kBQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the Q tile is staged; the last K/V tile is consumed
    for (int j = warp; j < kBK; j += kWarps) {
      const int key = kv0 + j;
      float4 kx = make_float4(0, 0, 0, 0), vx = kx;
      if (key < S) {
        const long off = ((b * S + key) * Hkv + hk) * D;
        kx = load4(k + off, d0, D, vec);
        vx = load4(v + off, d0, D, vec);
      }
      *reinterpret_cast<float4*>(&ks[j][d0]) = kx;
      *reinterpret_cast<float4*>(&vs[j][d0]) = vx;
    }
    __syncthreads();

    // scores: lane j scores key kv0 + j against this warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] += dot4(*reinterpret_cast<const float4*>(&qs[r0 + r][d]), kd);
    }

    const int key = kv0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + r0 + r;
      const bool ok = key < S && (!causal || key <= row);
      const float sc = ok ? s[r] * scale : kNegInf;
      float tmax = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sc - m_new);
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(kFull, psum, off);
      l[r] = alpha * l[r] + psum;
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[r][t] *= alpha;
    }

    // P.V: lane l owns head-dim values 4l..4l+3; p_j comes from lane j
    const int jn = min(kBK, kv_end - kv0);
    for (int j = 0; j < jn; ++j) {
      const float4 vj = *reinterpret_cast<const float4*>(&vs[j][d0]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
        acc[r][0] += pj * vj.x;
        acc[r][1] += pj * vj.y;
        acc[r][2] += pj * vj.z;
        acc[r][3] += pj * vj.w;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    // the log-sum-exp in log2 units, as the bf16 kernel writes it
    if (lse != nullptr && lane == 0) lse[(b * Hq + h) * S + row] = (m[r] + logf(l[r])) * kLog2e;
    T* o = out + ((b * S + row) * Hq + h) * D;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (d0 + t < D) o[d0 + t] = from_f32<T>(acc[r][t] / denom);
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA into a two-stage ring
// ---------------------------------------------------------------------------
constexpr int kBN = 64;                    // keys per K/V tile
constexpr int kPanel = tc::kPanel;         // head-dim values per 128-byte panel
constexpr int kPanelBytes = tc::kPanelBytes;
constexpr int kStages = 2;                 // K/V tiles in flight

// KS: head-dim steps of 16 (4 for D <= 64, else ceil(D / 16)), so NP =
// ceil(KS / 4) 64-wide panels; W: consumer warpgroups of 64 packed rows
// each. Grid: (row tiles, Hkv * head chunks, B).
template <int KS, int W>
__global__ void __launch_bounds__(W * 128)
flash_attention_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                   float* __restrict__ lse, int S, int Hkv, int G, int Gc, int Mp, int causal,
                   float scale_log2) {
  constexpr int NP = (KS + 3) / 4;
  constexpr int last_n = (KS - 4 * (NP - 1)) * 16;  // columns of the last panel
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // one per K/V stage, one for Q

  // 128-byte swizzled panels want 1024-byte alignment: the launch adds 1 KB
  const uint32_t raw = tma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  auto q_panel = [&](int w, int p) { return base + (w * NP + p) * kPanelBytes; };
  auto k_panel = [&](int s, int p) { return base + (W * NP + s * NP + p) * kPanelBytes; };
  auto v_panel = [&](int s, int p) {
    return base + (W * NP + kStages * NP + s * NP + p) * kPanelBytes;
  };
  const uint32_t bar_q = tma::smem_u32(&bars[kStages]);
  auto bar_kv = [&](int s) { return tma::smem_u32(&bars[s]); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int mb = gridDim.x - 1 - blockIdx.x;  // the longest causal walks start first
  const int hk = blockIdx.y % Hkv;
  const int g0 = (blockIdx.y / Hkv) * Gc;     // first head of the group chunk
  const int b = blockIdx.z;
  const int pos_block = mb * W * Mp;          // first position of the block
  const int last_pos = min(S, pos_block + W * Mp) - 1;
  const int kv_end = causal ? last_pos + 1 : S;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  const uint32_t q_bytes = W * NP * kPanel * Gc * Mp * 2;
  const uint32_t kv_bytes = 2 * NP * kPanelBytes;

  if (tid == 0) {
    tma::prefetch_map(&map_q);
    tma::prefetch_map(&map_k);
    tma::prefetch_map(&map_v);
    tma::prefetch_map(&map_o);
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
    for (int w = 0; w < W; ++w)
      for (int p = 0; p < NP; ++p)
        tma::load_5d(q_panel(w, p), &map_q, p * kPanel, g0, hk, pos_block + w * Mp, b, bar_q);
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, s);
  }

  // this thread's two rows of its warpgroup's tile: r and r + 8
  const int pos_w = pos_block + wg * Mp;      // first position of this warpgroup
  const int wg_last = min(S, pos_w + Mp) - 1; // its last position (< pos_w: no live row)
  const bool wg_live = pos_w < S;
  const int r0 = warp * 16 + lane / 4;
  const int pos0 = pos_w + r0 / Gc, pos1 = pos_w + (r0 + 8) / Gc;
  const int col = 2 * (lane % 4);             // first column of each 8-column group

  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // log2 units; l per thread

  tma::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int kv0 = it * kBN;
    tma::mbar_wait(bar_kv(s), (it / kStages) & 1);
    if (wg_live && (!causal || kv0 <= wg_last)) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      tc::reg_fence(sc);
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 into the 128-byte row
        tc::ss_n64(sc, tc::sw128_desc(q_panel(wg, kk / 4) + off),
                   tc::sw128_desc(k_panel(s, kk / 4) + off), kk > 0);
      }
      tc::commit();
      tc::wait<0>();
      tc::reg_fence(sc);

      // scores in log2 units; keys past S, and past the row's position when
      // causal, are masked
      const bool edge = kv0 + kBN > S || (causal && kv0 + kBN - 1 > pos_w);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * j + e] * scale_log2, x1 = sc[4 * j + 2 + e] * scale_log2;
          if (edge) {
            const int key = kv0 + 8 * j + col + e;
            if (key >= S || (causal && key > pos0)) x0 = kNegInf;
            if (key >= S || (causal && key > pos1)) x1 = kNegInf;
          }
          sc[4 * j + e] = x0;
          sc[4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - mn0);
          sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn1);
          sum0 += sc[4 * j + e];
          sum1 += sc[4 * j + 2 + e];
        }
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[p][4 * j] *= a0;
          o[p][4 * j + 1] *= a0;
          o[p][4 * j + 2] *= a1;
          o[p][4 * j + 3] *= a1;
        }

      // P in bf16: the accumulator of keys 16kk..16kk+15 is the A fragment
      uint32_t pa[4][4];
      tc::to_a_frags(sc, pa);
#pragma unroll
      for (int p = 0; p < NP; ++p) tc::reg_fence(o[p]);
      tc::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)  // V 16 keys down, MN-major
          tc::rs(o[p], pa[kk], tc::sw128_desc(v_panel(s, p) + kk * 16 * 128),
                 p < NP - 1 ? 64 : last_n);
      tc::commit();
      tc::wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) tc::reg_fence(o[p]);
    }
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && it + kStages < n_tiles) load_kv(s, it + kStages);
  }

  if (!wg_live) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  if (lse != nullptr && lane % 4 == 0) {
    // each live row's log-sum-exp in log2 units: m + log2(l), m the largest
    // score times scale_log2, l = sum_j exp2(score_j scale_log2 - m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half, pos = half ? pos1 : pos0, head = g0 + r % Gc;
      if (r < Gc * Mp && pos < S && head < G)
        lse[((static_cast<long>(b) * Hkv + hk) * G + head) * S + pos] =
            half ? m1 + log2f(l1) : m0 + log2f(l0);
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // O in bf16 into this warpgroup's Q panels (its last read of them is
  // done), in the panels' swizzled layout, then one TMA store per panel.
  // Rows past S, heads past the group and head-dim values past D fall
  // outside the tensor map.
  tc::store_panels<NP, last_n>(o, [&](int p) { return q_panel(wg, p); }, r0, col, inv0, inv1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (tid % 128 == 0) {
    for (int p = 0; p < NP; ++p) tma::store_5d(&map_o, q_panel(wg, p), p * kPanel, g0, hk, pos_w, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// A bf16 tensor map with a box of 64 head-dim values (128 bytes,
// swizzled) by box[1..].
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  return tma::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int KS, int W>
int launch_tc(const CUtensorMap (&maps)[4], float* lse, int B, int S, int Hkv, int G, int Gc,
              int Mp, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int NP = (KS + 3) / 4;
  const int smem = 1024 + (W * NP + 2 * kStages * NP) * kPanelBytes;
  auto kernel = flash_attention_tc<KS, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + W * Mp - 1) / (W * Mp), Hkv * ((G + Gc - 1) / Gc), B);
  kernel<<<grid, W * 128, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, S, Hkv, G, Gc,
                                          Mp, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_ks(const CUtensorMap (&maps)[4], float* lse, int B, int S, int Hkv, int G, int Gc,
              int Mp, int causal, float scale_log2, cudaStream_t stream) {
  return S <= Mp  // every position fits one warpgroup's tile
             ? launch_tc<KS, 1>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream)
             : launch_tc<KS, 2>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
                int Hq, int Hkv, int D, int scale_dim, int causal, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int Gc = G < 64 ? G : 64;  // heads of the group per tile
  const int Mp = 64 / Gc;          // positions per warpgroup tile
  const cuuint64_t e = 2;          // bytes per value
  const cuuint64_t qdims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)Hkv, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t qstrides[4] = {D * e, (cuuint64_t)G * D * e, (cuuint64_t)Hq * D * e,
                                  (cuuint64_t)S * Hq * D * e};
  const cuuint32_t qbox[5] = {(cuuint32_t)kPanel, (cuuint32_t)Gc, 1, (cuuint32_t)Mp, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstrides[3] = {D * e, (cuuint64_t)Hkv * D * e, (cuuint64_t)S * Hkv * D * e};
  const cuuint32_t kbox[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)kBN, 1};
  CUtensorMap maps[4];  // q, k, v, out
  if (!make_map(&maps[0], q, 5, qdims, qstrides, qbox) ||
      !make_map(&maps[1], k, 4, kdims, kstrides, kbox) ||
      !make_map(&maps[2], v, 4, kdims, kstrides, kbox) ||
      !make_map(&maps[3], out, 5, qdims, qstrides, qbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(scale_dim));
  switch ((D + 15) / 16) {
    case 5: return launch_ks<5>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
    case 6: return launch_ks<6>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
    case 7: return launch_ks<7>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
    case 8: return launch_ks<8>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
    default:  // D <= 64
      return launch_ks<4>(maps, lse, B, S, Hkv, G, Gc, Mp, causal, scale_log2, stream);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
               int Hq, int Hkv, int D, int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, S, Hq, Hkv, D, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, D), k and v (B, S, Hkv, D), out (B, S, Hq, D), all contiguous
// and of one type: bf16 when bf16 != 0, else f32. Scores are scaled by
// 1/sqrt(scale_dim). bf16 needs D % 8 == 0 and 16-byte aligned tensors (the
// tensor maps' rule); f32 needs scale_dim == D. lse: null (inference), or
// (B, Hq, S) float32 that receives each row's log-sum-exp in log2 units,
// log2 sum_j exp2(s_j log2(e) / sqrt(scale_dim)) for the row's allowed keys
// j, the domain flash_attention_bwd reads.
extern "C" int memforest_flash_attention(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int S, int Hq, int Hkv, int D,
                                         int scale_dim, int causal, int bf16, void* stream) {
  if (D < 1 || D > kMaxD || scale_dim < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    if (scale_dim != D) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(q, k, v, out, static_cast<float*>(lse), B, S, Hq, Hkv, D, causal, s);
  }
  const auto misaligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 != 0; };
  if (D % 8 != 0 || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(q, k, v, out, static_cast<float*>(lse), B, S, Hq, Hkv, D, scale_dim, causal,
                     s);
}
