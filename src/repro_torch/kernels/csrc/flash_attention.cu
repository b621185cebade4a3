// flash_attention: GQA attention over one sequence, causal or full, for the
// dense trunk's prefill and for the ModelEncoder forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (wrapper flash_attention). For every batch b, query head h and row i:
//     s[j]   = (q[b,i,h,:] . k[b,j,h/G,:]) / sqrt(D)      (j <= i when causal)
//     out    = sum_j softmax(s)[j] * v[b,j,h/G,:]
// with G = Hq / Hkv. Masked scores are -1e30 and the final divide is by
// max(l, 1e-30), as in the Pallas kernel and the reference. Inputs are bf16
// or f32; every product and the online softmax run in f32; the output has
// q's type.
//
// Bound on an H100: at the main path's shapes (S <= ~30 for the encoder,
// S <= ~40 for the engine's prefill) each (b, h) reads S*D values of q, k and
// v and does about 4*S*S*D/2 operations: memory, a few hundred bytes of
// work per launch of a block. At long S the operations bound it (tensor
// cores: 989 TFLOP/s bf16); this first version runs them on the CUDA cores.
//
// Design: the Pallas grid walks KV blocks in sequence inside one core; here
// one block owns (query tile of 16 rows, head h, batch b) and a loop inside
// it walks the 32-key tiles up to the causal diagonal, so no state carries
// between blocks. The Q tile and each K/V tile are converted to f32 and
// staged in shared memory: each warp loads whole rows, lane l the four
// head-dim values 4l..4l+3 in one 8-byte (bf16) or 16-byte (f32) load. K
// rows are padded to D+4 floats, so lane j reading row j with 16-byte loads
// meets no bank conflict. Warp w owns query rows 4w..4w+3: lane j scores key
// j against them, four head-dim values per shared-memory load; a shuffle
// reduction gives each row its tile max and sum; for P.V lane l keeps the
// four values 4l..4l+3 of each row and takes each p_j from lane j by
// shuffle. Any S is taken: keys and rows past S are masked in the tile, so
// a batch padded only to its longest text wastes at most 15 query rows and
// 31 keys. Any head_dim up to 128 (vector loads when it is a multiple of 4).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kMaxD = 128;                  // a lane owns 4 head-dim values
constexpr int kKStride = kMaxD + 4;         // K rows: 16-byte aligned, no conflicts
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Values d0..d0+3 of one row as floats, zero past D. vec: D % 4 == 0 and the
// tensors 16-byte aligned, so the four values are one aligned 8-byte (bf16)
// or 16-byte (f32) load.
__device__ __forceinline__ float4 load4(const float* row, int d0, int D, bool vec) {
  if (vec) return d0 < D ? *reinterpret_cast<const float4*>(row + d0) : make_float4(0, 0, 0, 0);
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = d0 + t < D ? row[d0 + t] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int d0, int D, bool vec) {
  if (vec) {
    if (d0 >= D) return make_float4(0, 0, 0, 0);
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = d0 + t < D ? __bfloat162float(row[d0 + t]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
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
    T* o = out + ((b * S + row) * Hq + h) * D;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (d0 + t < D) o[d0 + t] = from_f32<T>(acc[r][t] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
           int Hkv, int D, int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Hq, Hkv, D, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, D), k and v (B, S, Hkv, D), out (B, S, Hq, D), all contiguous
// and of one type: bf16 when bf16 != 0, else f32.
extern "C" int memforest_flash_attention(const void* q, const void* k, const void* v, void* out,
                                         int B, int S, int Hq, int Hkv, int D, int causal,
                                         int bf16, void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, causal, s)
              : launch<float>(q, k, v, out, B, S, Hq, Hkv, D, causal, s);
}
