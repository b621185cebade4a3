// decode_attention: one new token per sequence against its KV cache (the
// serve engine's decode step).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_decode_kernel
// (wrapper decode_attention). For every batch b and query head h:
//     s[p]  = (q[b,h,:] . k[b,p,h/G,:]) / sqrt(D)     for p < lengths[b]
//     out   = sum_p softmax(s)[p] * v[b,p,h/G,:]
// with G = Hq / Hkv and caches (B, Smax, Hkv, D). A length past Smax counts
// as Smax; a length of 0 gives zeros, as the Pallas kernel gives. Inputs are
// bf16 or f32; products and the online softmax run in f32; the output has
// q's type.
//
// Bound on an H100: memory. Each valid cache row is read once for 4*G*D
// operations on 4*D bytes (bf16 k and v), about G operations per byte, far
// under the card's ratio of compute to bandwidth.
//
// Design: one block per (KV split, KV head, batch). The block owns the
// GQA group of its KV head (4 query heads at a time), so each K/V row is
// read once for the group, as in the Pallas kernel. Its four warps split
// the positions; a warp takes two rows at once, 16 lanes to a row, each
// lane eight head-dim values in one 16-byte load (bf16), 8 rows per step.
// The next step's rows are loaded into registers before the current step
// is folded in, so the loads of one step overlap the arithmetic of the
// last. A four-step shuffle reduction over the 16 lanes gives the scores;
// each half-warp keeps its own f32 (m, l, acc) per query head, and
// shuffles, then shared memory, merge the halves and the warps at the end.
// Rows at or past the length are never read: the walk stops there, and the
// lengths are read on the device, so the host never waits for them. When
// B * Hkv blocks would leave SMs idle and Smax is long, the wrapper splits
// the positions over blocks; each split writes its (m, l, acc) to scratch
// and a combine kernel merges the splits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kHalf = 16;             // lanes per cache row: a warp takes two rows at once
constexpr int kVals = kMaxD / kHalf;  // head-dim values a lane owns: 8
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight head-dim values of one row, as loaded: one 16-byte load (bf16) or
// two (f32) when vec (D % 8 == 0 and 16-byte aligned tensors); element
// loads, zero past D, otherwise.
template <typename T> union Piece;
template <> union Piece<__nv_bfloat16> {
  uint4 raw;
  unsigned short h[kVals];   // the bf16 bit patterns
};
template <> union Piece<float> {
  float4 raw[2];
  float h[kVals];
};

template <typename T>
__device__ __forceinline__ Piece<T> load_piece(const T* row, int d0, int D, bool vec, bool ok) {
  Piece<T> p;
  if (ok && vec && d0 < D) {
    if constexpr (sizeof(T) == 2) {
      p.raw = *reinterpret_cast<const uint4*>(row + d0);
    } else {
      p.raw[0] = *reinterpret_cast<const float4*>(row + d0);
      p.raw[1] = *reinterpret_cast<const float4*>(row + d0 + 4);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVals; ++j) {
      const bool in = ok && d0 + j < D;
      if constexpr (sizeof(T) == 2) {
        p.h[j] = in ? __bfloat16_as_ushort(row[d0 + j]) : 0;   // 0 is +0.0 in bf16
      } else {
        p.h[j] = in ? row[d0 + j] : 0.f;
      }
    }
  }
  return p;
}

template <typename T>
__device__ __forceinline__ void unpack(const Piece<T>& p, float (&f)[kVals]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&p.raw);
#pragma unroll
    for (int j = 0; j < kVals / 2; ++j) {
      const float2 x = __bfloat1622float2(h2[j]);
      f[2 * j] = x.x;
      f[2 * j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVals; ++j) f[j] = p.h[j];
  }
}

// The online-softmax state of one lane: the rows of its half-warp, for NG
// query heads, over its eight head-dim values.
template <int NG>
struct State {
  float m[NG], l[NG], acc[NG][kVals];
};

// KU row pairs starting at ``base``: row base + 2u + half for pair u.
template <typename T, int KU>
__device__ __forceinline__ void load_rows(Piece<T> (&kp)[KU], Piece<T> (&vp)[KU],
                                          const T* kc, const T* vc, long row0, int stride_row,
                                          int base, int half, int end, int d0, int D, bool vec) {
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int pos = base + 2 * u + half;
    const long off = row0 + (long)pos * stride_row;
    kp[u] = load_piece(kc + off, d0, D, vec, pos < end);
    vp[u] = load_piece(vc + off, d0, D, vec, pos < end);
  }
}

template <typename T, int NG, int KU>
__device__ __forceinline__ void fold_rows(State<NG>& st, const float (&qv)[NG][kVals],
                                          const Piece<T> (&kp)[KU], const Piece<T> (&vp)[KU],
                                          int base, int half, int end, float scale) {
  float s[KU][NG];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    float kf[kVals];
    unpack(kp[u], kf);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kVals; ++j) part += qv[i][j] * kf[j];
#pragma unroll
      for (int off = kHalf / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
      s[u][i] = part * scale;
    }
  }
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    float tmax = kNegInf;
#pragma unroll
    for (int u = 0; u < KU; ++u)
      if (base + 2 * u + half < end) tmax = fmaxf(tmax, s[u][i]);
    const float m_new = fmaxf(st.m[i], tmax);
    const float alpha = expf(st.m[i] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      s[u][i] = base + 2 * u + half < end ? expf(s[u][i] - m_new) : 0.f;
      psum += s[u][i];
    }
    st.l[i] = alpha * st.l[i] + psum;
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < kVals; ++j) st.acc[i][j] *= alpha;
  }
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    float vf[kVals];
    unpack(vp[u], vf);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int j = 0; j < kVals; ++j) st.acc[i][j] += s[u][i] * vf[j];
  }
}

// NG: query heads held at once (a group larger than 4 is taken 4 heads at a
// time); KU: row pairs a warp takes per step.
template <typename T, int NG, int KU>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int Smax, int Hq, int Hkv, int D,
                        int chunk, int splits) {
  __shared__ float sm_m[kWarps][NG];
  __shared__ float sm_l[kWarps][NG];
  __shared__ float sm_acc[kWarps][NG][kMaxD];

  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const long b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half = lane / kHalf;
  const int d0 = (lane % kHalf) * kVals;
  const bool vec = (D % kVals) == 0 && reinterpret_cast<std::uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(kc) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(vc) % 16 == 0;
  const int len = min(max(lengths[b], 0), Smax);
  const int begin = sp * chunk;
  const int end = min(begin + chunk, len);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const long row0 = (b * Smax * Hkv + hk) * (long)D;   // position 0 of this (b, KV head)
  const int stride_row = Hkv * D;
  const int step = kWarps * 2 * KU;

  for (int hc = 0; hc < G; hc += NG) {
    float qv[NG][kVals];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const long h = (long)hk * G + min(hc + i, G - 1);  // a ragged chunk repeats a head
      Piece<T> p = load_piece(q + (b * Hq + h) * D, d0, D, vec, true);
      unpack(p, qv[i]);
    }
    State<NG> st;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      st.m[i] = kNegInf;
      st.l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kVals; ++j) st.acc[i][j] = 0.f;
    }

    // rows stream through registers: the next step's loads are issued
    // before the current step is folded in (two buffers, A and B)
    Piece<T> ka[KU], va[KU], kb[KU], vb[KU];
    int base = begin + warp * 2 * KU;
    if (base < end) load_rows(ka, va, kc, vc, row0, stride_row, base, half, end, d0, D, vec);
    while (base < end) {
      int next = base + step;
      if (next < end) load_rows(kb, vb, kc, vc, row0, stride_row, next, half, end, d0, D, vec);
      fold_rows<T, NG, KU>(st, qv, ka, va, base, half, end, scale);
      base = next;
      if (base >= end) break;
      next = base + step;
      if (next < end) load_rows(ka, va, kc, vc, row0, stride_row, next, half, end, d0, D, vec);
      fold_rows<T, NG, KU>(st, qv, kb, vb, base, half, end, scale);
      base = next;
    }

    // merge the two half-warps, then the warps
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const float mo = __shfl_xor_sync(kFull, st.m[i], kHalf);
      const float lo = __shfl_xor_sync(kFull, st.l[i], kHalf);
      const float M = fmaxf(st.m[i], mo);
      const float e1 = expf(st.m[i] - M), e2 = expf(mo - M);
      st.l[i] = e1 * st.l[i] + e2 * lo;
#pragma unroll
      for (int j = 0; j < kVals; ++j)
        st.acc[i][j] = e1 * st.acc[i][j] + e2 * __shfl_xor_sync(kFull, st.acc[i][j], kHalf);
      st.m[i] = M;
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        sm_m[warp][i] = st.m[i];
        sm_l[warp][i] = st.l[i];
      }
    }
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int j = 0; j < kVals; ++j)
          if (d0 + j < D) sm_acc[warp][i][d0 + j] = st.acc[i][j];
    }
    __syncthreads();
    for (int idx = tid; idx < NG * D; idx += kThreads) {
      const int i = idx / D;
      const int d = idx - i * D;
      if (hc + i >= G) continue;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][i]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(sm_m[w][i] - M);
        L += e * sm_l[w][i];
        A += e * sm_acc[w][i][d];
      }
      const long h = (long)hk * G + hc + i;
      if (splits == 1) {
        out[(b * Hq + h) * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
      } else {
        const long slot = (b * Hq + h) * splits + sp;
        part_acc[slot * D + d] = A;
        if (d == 0) {
          part_ml[2 * slot] = M;
          part_ml[2 * slot + 1] = L;
        }
      }
    }
    __syncthreads();  // shared state is rewritten by the next head chunk
  }
}

// One block per (b, h): merge the splits' (m, l, acc).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      T* __restrict__ out, int splits, int D) {
  const long bh = blockIdx.x;
  const float* ml = part_ml + 2 * bh * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float e = expf(ml[2 * s] - M);
      L += e * ml[2 * s + 1];
      A += e * part_acc[(bh * splits + s) * D + d];
    }
    out[bh * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int NG, int KU>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, void* out,
           float* part_acc, float* part_ml, int B, int Smax, int Hq, int Hkv, int D, int chunk,
           int splits, cudaStream_t stream) {
  const dim3 grid(splits, Hkv, B);
  decode_attention_kernel<T, NG, KU><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      static_cast<T*>(out), part_acc, part_ml, Smax, Hq, Hkv, D, chunk, splits);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  decode_combine_kernel<T><<<(unsigned)(B * Hq), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), splits, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const int* lengths, void* out,
             float* part_acc, float* part_ml, int B, int Smax, int Hq, int Hkv, int D,
             int chunk, int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  constexpr int KU = sizeof(T) == 2 ? 4 : 2;   // row pairs per step: registers
#define MEMFOREST_DECODE(NG)                                                                \
  return launch<T, NG, KU>(q, kc, vc, lengths, out, part_acc, part_ml, B, Smax, Hq, Hkv, D, \
                           chunk, splits, stream)
  if (G == 1) MEMFOREST_DECODE(1);
  if (G == 2) MEMFOREST_DECODE(2);
  MEMFOREST_DECODE(4);
#undef MEMFOREST_DECODE
}

}  // namespace

// q (B, Hq, D), caches (B, Smax, Hkv, D), lengths (B,) int32, out (B, Hq, D),
// all contiguous; q, caches and out of one type (bf16 when bf16 != 0, else
// f32). With splits > 1, chunk * splits >= Smax, part_acc holds
// B*Hq*splits*D floats and part_ml B*Hq*splits*2; with splits == 1 both may
// be null and chunk >= Smax.
extern "C" int memforest_decode_attention(const void* q, const void* kc, const void* vc,
                                          const int* lengths, void* out, void* part_acc,
                                          void* part_ml, int B, int Smax, int Hq, int Hkv, int D,
                                          int chunk, int splits, int bf16, void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv != 0 || splits < 1 || chunk < 1 ||
      (long)chunk * splits < Smax || B > 65535 || Hkv > 65535 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  return bf16 ? dispatch<__nv_bfloat16>(q, kc, vc, lengths, out, pa, pm, B, Smax, Hq, Hkv, D,
                                        chunk, splits, s)
              : dispatch<float>(q, kc, vc, lengths, out, pa, pm, B, Smax, Hq, Hkv, D, chunk,
                                splits, s);
}
