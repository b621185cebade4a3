// flash_attention_bwd: the gradient of flash_attention, for training.
//
// The JAX package has no Pallas backward: it trains by differentiating its
// jnp attention (src/repro/kernels/ref.py:attention_ref). This kernel
// computes that same gradient. For q (B, S, Hq, D), k and v (B, S, Hkv, D),
// the forward's output o and its gradient dO (B, S, Hq, D), with G = Hq / Hkv,
// scale = 1 / sqrt(D) and s_ij = scale q_i . k_j (j <= i when causal):
//     lse_i  = log sum_j exp(s_ij)           P_ij = exp(s_ij - lse_i)
//     Di     = sum_d dO_i . o_i              dP_ij = dO_i . v_j
//     dS_ij  = P_ij (dP_ij - Di)
//     dq_i   = scale sum_j dS_ij k_j
//     dk_j   = scale sum_{h in group, i} dS_ij q_i
//     dv_j   = sum_{h in group, i} P_ij dO_i
// Inputs are float32 or bf16, read into float32; every sum is float32; the
// outputs take the inputs' type, as JAX's gradients take the parameters'.
// A causally masked score is -1e30, as in the reference, so its P is 0.
//
// Two entries, one launch each, both deterministic (no atomics):
//  A. dq_kernel, one block per (64-row query tile, query head, batch):
//     stages Q and dO, computes Di from o, recomputes each row's lse over its
//     allowed keys (the forward keeps none), then sweeps the key tiles again
//     for dq. Writes dq, and lse and Di as (B, Hq, S) float32 scratch.
//  B. dkv_kernel, one block per (64-key tile, KV head, batch): stages K and
//     V, then loops over the group's G query heads and over the 64-row query
//     tiles allowed for the tile (rows i >= the tile's first key when
//     causal), reading lse and Di from A's scratch. The group's sum happens
//     inside the block, so no two blocks write one row.
// The products are 64 x 64 tiles from shared memory on the CUDA cores: each
// of the 256 threads owns rows ty + 16 i (i < 4) and columns tx + 16 j, so
// that a warp reads two broadcast rows of one operand and 16 consecutive
// banks of the other (row strides are odd). Rows past S and head-dim values
// past D are staged as zeros and never written.
//
// Bound on an H100, per call: bytes q, k, v, o, dO read and dq, dk, dv
// written once; operations 5 products of 2 B Hq S^2 D (the lse pass, S, dP,
// and the two sums; halved when causal) against the fp32 or bf16 peak.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // rows (A) or keys (B) per block, and per inner tile
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;      // head-dim values a thread owns: tx + 16 j
constexpr int kSLd = kTile + 1;        // the 64 x 64 score tiles' row stride
constexpr float kNegInf = -1e30f;
#define kNoKey __int_as_float(0xff800000)  // -inf: a key past S adds nothing
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows row0 .. row0 + 63 of head h of a (B, S, H, D) tensor into dst (row
// stride ld) as float32; rows past S and values past D are zeros.
template <typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src, long b, int S, int H, int h,
                      int D, int Dp, int row0) {
  for (int e = threadIdx.x; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, d = e - r * Dp;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S && d < D) x = to_f32(src[((b * S + row) * H + h) * static_cast<long>(D) + d]);
    dst[r * ld + d] = x;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d], and the same for C, E into
// t when both: the NT products S = Q K^T and dP = dO V^T in one sweep.
template <bool kTwo>
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
      if (kTwo) {
        c[i] = C[(ty + 16 * i) * ld + d];
        e[i] = E[(tx + 16 * i) * ld + d];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bb[j];
        if (kTwo) t[i][j] += c[i] * e[j];
      }
  }
}

// -------------------------------------------------------------------------
// A: dq, lse and Di for one (64-row query tile, query head, batch)
// -------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ delta_out, int S, int Hq, int Hkv,
          int D, int causal) {
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

  stage(qs, ld, q, b, S, Hq, h, D, Dp, q0);
  stage(dos, ld, dout, b, S, Hq, h, D, Dp, q0);
  __syncthreads();

  // Di = dO_i . o_i: warp w owns rows 8w .. 8w + 7
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const T* orow = o + ((b * S + row) * Hq + h) * static_cast<long>(D);
      for (int d = lane; d < D; d += 32) acc += dos[r * ld + d] * to_f32(orow[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) dl_s[r] = acc;
  }

  // pass 1: each row's running max and sum over the allowed keys
  float m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int kv_end = causal ? min(S, q0 + kTile) : S;
  float s[4][4], t[4][4];
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // the last tile's scores are read
    stage(ks, ld, k, b, S, Hkv, hk, D, Dp, kv0);
    __syncthreads();
    nt_tiles<false>(s, t, qs, ks, nullptr, nullptr, ld, Dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, key = kv0 + tx + 16 * j;
        // a key past S is no key of the row; a causally masked one is -1e30
        ps[(ty + 16 * i) * kSLd + tx + 16 * j] =
            key >= S ? kNoKey : (causal && key > row ? kNegInf : s[i][j] * scale);
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float* srow = ps + (warp * 8 + r) * kSLd;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      float psum = expf(s0 - m_new) + expf(s1 - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(kFull, psum, off);
      l[r] = l[r] * expf(m[r] - m_new) + psum;
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int rr = warp * 8 + r, row = q0 + rr;
    const float lse = m[r] + logf(l[r]);
    if (lane == 0) {
      lse_s[rr] = lse;
      if (row < S) {
        lse_out[(b * Hq + h) * S + row] = lse;
        delta_out[(b * Hq + h) * S + row] = dl_s[rr];
      }
    }
  }

  // pass 2: dq = scale sum_j P_ij (dP_ij - Di) k_j
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // lse_s is written; the last tile's dS is read
    stage(ks, ld, k, b, S, Hkv, hk, D, Dp, kv0);
    stage(vs, ld, v, b, S, Hkv, hk, D, Dp, kv0);
    __syncthreads();
    nt_tiles<true>(s, t, qs, ks, dos, vs, ld, Dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = ty + 16 * i, row = q0 + rr, key = kv0 + tx + 16 * j;
        const bool ok = key < S && (!causal || key <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_s[rr]) : 0.f;
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
    T* out = dq + ((b * S + row) * Hq + h) * static_cast<long>(D);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (j < ncol && d < D) out[d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// -------------------------------------------------------------------------
// B: dk and dv for one (64-key tile, KV head, batch)
// -------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S, int Hq,
           int Hkv, int D, int causal) {
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
      nt_tiles<true>(s, t, qs, ks, dos, vs, ld, Dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = ty + 16 * i, row = r0 + rr, key = k0 + tx + 16 * j;
          const bool ok = row < S && key < S && (!causal || key <= row);
          const float p = ok ? expf(s[i][j] * scale - lse_s[rr]) : 0.f;
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
        dk[off + d] = from_f32<T>(dk_acc[i][j] * scale);
        dv[off + d] = from_f32<T>(dv_acc[i][j]);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
           void* dk, void* dv, float* scratch, int B, int S, int Hq, int Hkv, int D, int causal,
           cudaStream_t stream) {
  const size_t a_bytes = dq_smem(D), b_bytes = dkv_smem(D);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(a_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* lse = scratch;
  float* delta = scratch + static_cast<long>(B) * Hq * S;
  const dim3 grid_a((S + kTile - 1) / kTile, Hq, B);
  dq_kernel<T><<<grid_a, kThreads, a_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, S,
      Hq, Hkv, D, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((S + kTile - 1) / kTile, Hkv, B);
  dkv_kernel<T><<<grid_b, kThreads, b_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Hq,
      Hkv, D, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D), all contiguous
// and of one type: bf16 when bf16 != 0, else f32. scratch: 2 B Hq S floats
// (lse, then Di), written by the first launch and read by the second.
extern "C" int memforest_flash_attention_bwd(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, void* dq, void* dk,
                                             void* dv, void* scratch, int B, int S, int Hq,
                                             int Hkv, int D, int causal, int bf16, void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, sc, B, S, Hq, Hkv, D, causal, s);
  return launch<float>(q, k, v, o, dout, dq, dk, dv, sc, B, S, Hq, Hkv, D, causal, s);
}
