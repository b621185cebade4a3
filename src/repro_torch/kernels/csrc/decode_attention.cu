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
// q's type. On request (a non-null lse) each query head's log-sum-exp of its
// scaled scores is written too, (B, Hq) f32 in log2 units (log2 sum_p
// exp2(s[p] log2 e), flash_attention's training domain), from the final
// (m, l): m + log2 l, after every level of the merge; -inf for a length of
// 0. A shard of a sequence-split cache merges its partial with the other
// shards' by it.
//
// Bound on an H100: bytes. Each valid cache row is read once for 4*G*D
// operations on 4*D bytes (bf16 k and v), about G operations per byte, far
// under the card's ratio of compute to bandwidth. What keeps a kernel from
// that bound is the card left idle: B * Hkv blocks (64 on llama3-8b's
// decode step) on 132 SMs, and each block's walk a chain of dependent loads.
//
// Design: the positions are cut into fixed chunks of kChunk = 128 rows at
// every Smax (the plan reads Smax only). One block of 256 threads per
// (chunk, KV head and group of at most 16 of its query heads, batch), so
// each K/V row is read once for the group; a chunk at or past lengths[b]
// exits at once (the lengths are read on the device, never by the host).
// The chunk's two 64-row tiles of K and V are copied asynchronously, each
// tile completing on its own mbarrier, so all of a block's bytes are in
// flight at once: TMA boxes of 64, 32, 16 and 8 rows (one copy for a full
// tile); the last rows of a sequence that fill no 8-row box are copied by
// the threads. Rows at or past the length are never read. The tensor maps
// want 16-byte rows and bases: the wrapper zero-pads a head dim that is not
// a multiple of 8 (no published config has one) and passes the true one for
// the scale; a map that cannot be built fails the call.
//  - bf16: the tiles land 128-byte swizzled, in 64-wide head-dim panels, and
//    both products run on the tensor cores (mma.sync m16n8k16, f32
//    accumulate), over the whole chunk at once: S^T = K.q^T for 16 rows a
//    warp (q copied in with tile 0); one softmax (f32, exp2) per head over
//    the chunk; then O^T = V^T.P^T for 16 head-dim values a warp, V read
//    transposed by ldmatrix and P rounded to bf16 through shared memory. At
//    G <= 8 most of an mma's 8 columns are idle, but the products cost a
//    few instructions a warp, and the bytes bound the kernel.
//  - float32 (the parity phases, held to 2e-5): dense tiles on the CUDA
//    cores, tile 0 folded while tile 1 lands; four threads score each row
//    against up to four heads at once, a warp per head folds the online
//    softmax (expf), and P.V runs over (head, four head-dim values) units
//    in up to eight row groups.
//
// The splits are combined inside the same launch, in two levels of at most
// 16. A sequence with one live chunk writes its output directly. Otherwise
// each block writes its (acc, m, l) partial to scratch, __threadfence()s
// and takes a ticket from its group's counter with atomicAdd; the block
// that draws the group's last ticket merges the group's partials in
// split-index order (their (m, l) in one round trip, their sums eight at a
// time) into the output, or, with more than one group, into a second-level
// partial, and the last group to finish merges those in group order. The order is fixed, so the
// result is bitwise the same from run to run whichever block came last.
// Each last block sets its counter back to 0, so a call needs no memset
// launch. The wrapper allocates the scratch with torch.empty for each call
// and keeps one zeroed counter buffer per (device, stream): launches on one
// stream run one after another, so no two launches share a counter at
// once, and every launch leaves the counters at zero for the next.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kTile = 64;                   // rows per K/V tile
constexpr int kChunk = 2 * kTile;           // rows per block: two tiles, both in flight
constexpr int kFanIn = 16;                  // partials per merge
constexpr int kBoxes = 4;                   // TMA boxes of 64, 32, 16 and 8 rows
constexpr int kHeads = 16;                  // query heads per block on the tensor cores
constexpr int kPanelBytes = kTile * 128;    // a tile's 64-wide head-dim panel
constexpr int kPsStride = kChunk + 8;       // P^T rows in shared memory: no bank conflicts
constexpr int kQuarters = kThreads / kTile; // float32: threads scoring one row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// the caches' tensor maps, one per box height
struct Maps {
  CUtensorMap k[kBoxes], v[kBoxes];
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& a, float p, float4 v) {
  a.x += p * v.x;
  a.y += p * v.y;
  a.z += p * v.z;
  a.w += p * v.w;
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// C(16 x 8, f32) += A(16 x 16, bf16, row) . B(16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What a block computes and where it keeps it. Gb: query heads per block
// (at most kHeads in bf16); Dp: the head dim rounded up to 16 (bf16) or 8
// (float32), zero-padded; NP: 64-wide panels (bf16).
struct Shape {
  int G, Gb, HC, Dp, NP, RG;
  __host__ __device__ Shape(int Hq, int Hkv, int D, bool bf16) {
    G = Hq / Hkv;
    Gb = bf16 && G > kHeads ? kHeads : G;
    HC = (G + Gb - 1) / Gb;
    Dp = bf16 ? (D + 15) / 16 * 16 : (D + 7) / 8 * 8;
    NP = (Dp + 63) / 64;
    const int units = Gb * (Dp / 4);   // float32 P.V units
    RG = units >= kThreads ? 1 : (kThreads / units < 8 ? kThreads / units : 8);
  }
};

// The merge's scratch, per block row (batch, KV head, head chunk):
// ``splits`` first-level slots, then one second-level slot per group of
// kFanIn; a slot is Gb x Dp acc, Gb m, Gb l and padding. And 1 + groups
// counters per block row: [second level, groups...]. The kernel indexes
// with it and the entry point checks the sizes it is given against it.
struct Scratch {
  int slot, groups;
  long slots_per_row, counters_per_row;
  __host__ __device__ Scratch(const Shape& sh, int splits) {
    slot = sh.Gb * (sh.Dp + 4);
    groups = (splits + kFanIn - 1) / kFanIn;
    slots_per_row = static_cast<long>(splits + groups) * slot;
    counters_per_row = 1 + groups;
  }
};

// Shared memory in bytes from a 128-byte aligned base, sized by the launch:
//   kv    2 tiles x {K, V}: bf16, NP swizzled panels of 64 rows x 128 bytes
//         each; float32, 64 x Dp dense. The merge's (m, l) and weights
//         reuse it.
//   bf16:    qs 16 x Dp bf16 (the block's query rows), ps 16 x kPsStride
//            bf16 (P^T), red 2 x 8 x 16 f32 (per-warp maxima and sums),
//            m, l 16 f32 each
//   float32: qs Gb x Dp, ps kQuarters x Gb x kTile, acc RG x Gb x Dp,
//            st 3 x Gb f32
struct Layout {
  int kv_bytes, a, b, c, d, e, total;
  __host__ __device__ Layout(const Shape& sh, bool bf16, int splits) {
    const int tiles = bf16 ? 4 * sh.NP * kPanelBytes : 4 * kTile * sh.Dp * 4;
    const int groups = (splits + kFanIn - 1) / kFanIn;
    const int weights = 2 * sh.Gb * ((groups > kFanIn ? groups : kFanIn) + 1) * 4;
    kv_bytes = ((tiles > weights ? tiles : weights) + 127) / 128 * 128;
    if (bf16) {
      c = kv_bytes;                      // qs
      a = c + kHeads * sh.Dp * 2;        // ps
      b = a + kHeads * kPsStride * 2;    // red
      d = b + 2 * kWarps * kHeads * 4;   // m
      e = d + kHeads * 4;                // l
      total = e + kHeads * 4;
    } else {
      a = kv_bytes;                      // qs
      b = a + sh.Gb * sh.Dp * 4;         // ps
      c = b + kQuarters * sh.Gb * kTile * 4;   // acc
      d = c + sh.RG * sh.Gb * sh.Dp * 4; // st
      e = d;
      total = d + 3 * sh.Gb * 4;
    }
  }
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: one tile of ``rows`` rows into the online
// softmax of every head of the block
// ---------------------------------------------------------------------------
__device__ __forceinline__ void fold_tile_f32(const float* ks, const float* vs, const float* qs,
                                              float* ps, float* acc, float* st, int rows, int G,
                                              int Dp, int RG, float scale) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* m = st;
  float* l = st + G;
  float* alpha = st + 2 * G;

  // scores: thread (row r, quarter qd) sums its quarter of the four-value
  // chunks, from chunk r % n on, for heads i0..i0+3
  {
    const int r = tid % kTile, qd = tid / kTile;
    const int nc = Dp / 4, per = (nc + kQuarters - 1) / kQuarters;
    const int c0 = qd * per, n = min(per, nc - c0);
    const int rot = n > 0 ? r % n : 0;
    const float* krow = ks + r * Dp;
    for (int i0 = 0; i0 < G; i0 += 4) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        for (int j = 0; j < n; ++j) {
          int jj = j + rot;
          if (jj >= n) jj -= n;
          const int c = 4 * (c0 + jj);
          const float4 kf = load4(krow + c);
#pragma unroll
          for (int h = 0; h < 4; ++h)
            if (i0 + h < G) a[h] += dot4(load4(qs + (i0 + h) * Dp + c), kf);
        }
      }
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (i0 + h < G) ps[(qd * G + i0 + h) * kTile + r] = a[h];
    }
  }
  __syncthreads();

  // a warp per head: the tile's max, the probabilities (into quarter 0's
  // scores), the new (m, l)
  for (int i = warp; i < G; i += kWarps) {
    float s[kTile / 32];
    float tmax = kNegInf;
#pragma unroll
    for (int t = 0; t < kTile / 32; ++t) {
      const int row = lane + 32 * t;
      float x = 0.f;
#pragma unroll
      for (int qd = 0; qd < kQuarters; ++qd) x += ps[(qd * G + i) * kTile + row];
      s[t] = row < rows ? x * scale : kNegInf;
      tmax = fmaxf(tmax, s[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
    const float m_new = fmaxf(m[i], tmax);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kTile / 32; ++t) {
      const int row = lane + 32 * t;
      const float p = row < rows ? expf(s[t] - m_new) : 0.f;
      ps[i * kTile + row] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(kFull, psum, off);
    __syncwarp();
    if (lane == 0) {
      const float a = expf(m[i] - m_new);
      alpha[i] = a;
      l[i] = a * l[i] + psum;
      m[i] = m_new;
    }
  }
  __syncthreads();

  // P.V: unit (head, four head-dim values); row group rg takes rows rg, rg +
  // RG, ..., two at a time into two sums
  const int D4 = Dp / 4;
  const int units = G * D4;
  for (int t = tid; t < units * RG; t += kThreads) {
    const int rg = t / units, u = t - rg * units;
    const int i = u / D4, d = (u - i * D4) * 4;
    float4* a = reinterpret_cast<float4*>(acc + (rg * G + i) * Dp + d);
    float4 s0 = scale4(*a, alpha[i]), s1 = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = ps + i * kTile;
    int row = rg;
    for (; row + RG < rows; row += 2 * RG) {
      fma4(s0, p[row], load4(vs + row * Dp + d));
      fma4(s1, p[row + RG], load4(vs + (row + RG) * Dp + d));
    }
    if (row < rows) fma4(s0, p[row], load4(vs + row * Dp + d));
    *a = make_float4(s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// NT: 8-head columns of the bf16 products (1 for Gb <= 8, else 2; 0 for
// float32). Grid: (splits, Hkv * head chunks, B).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 3)   // three blocks an SM: at most 85 registers
decode_attention_kernel(const __grid_constant__ Maps maps, const T* __restrict__ q,
                        const T* __restrict__ kc, const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part,
                        unsigned* __restrict__ counters, int Smax,
                        int Hq, int Hkv, int D, int splits, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];   // the two tiles
  __shared__ int last;

  const Shape sh(Hq, Hkv, D, kBf16);
  const int G = sh.G, Gb = sh.Gb, Dp = sh.Dp, NP = sh.NP;
  const int sp = blockIdx.x;
  const int y = blockIdx.y;                    // (KV head, head chunk)
  const int hk = y / sh.HC, hc = y % sh.HC;
  const long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), Smax);
  const int g0 = hc * Gb;                              // first head of the block in the group
  const int heads = min(Gb, G - g0);                   // heads this block writes
  const long h0 = b * Hq + static_cast<long>(hk) * G + g0;   // (b, first head of the block)

  if (len == 0) {  // no live chunk: chunk 0 writes the zeros (and -inf)
    if (sp == 0) {
      for (int i = tid; i < heads * D; i += kThreads) out[h0 * D + i] = from_f32<T>(0.f);
      if (lse != nullptr)
        for (int h = tid; h < heads; h += kThreads) lse[h0 + h] = __int_as_float(0xff800000);
    }
    return;
  }
  const int begin = sp * kChunk;
  if (begin >= len) return;
  const int end = min(begin + kChunk, len);
  const int live = (len + kChunk - 1) / kChunk;

  // the 128-byte swizzle repeats every 1024 bytes: the launch adds 1 KB
  uint8_t* smem = smem_raw + ((1024 - tma::smem_u32(smem_raw) % 1024) % 1024);
  const Layout lay(sh, kBf16, splits);
  const long stride_row = static_cast<long>(Hkv) * D;
  const long row0 = (b * Smax * Hkv + hk) * static_cast<long>(D);   // position 0 of (b, hk)
  const int n_tiles = (end - begin + kTile - 1) / kTile;
  const int tile_bytes = kBf16 ? NP * kPanelBytes : kTile * Dp * 4;   // K or V of one tile
  auto k_tile = [&](int t) { return tma::smem_u32(smem + (2 * t) * tile_bytes); };
  auto v_tile = [&](int t) { return tma::smem_u32(smem + (2 * t + 1) * tile_bytes); };
  auto tile_rows = [&](int t) { return min(kTile, end - begin - t * kTile); };
  auto bar = [&](int t) { return tma::smem_u32(&bars[t]); };
  // bf16 tiles: byte offset of the 16-byte chunk c (8 head-dim values) of row r
  auto swz = [](int r, int c) { return (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16); };

  // -- copies: TMA boxes of whole 8-row groups, then the rest by the threads
  if (tid == 0) {
    for (int t = 0; t < 2; ++t) tma::mbar_init(bar(t), 1);
    tma::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < n_tiles; ++t) {
      const int boxed = tile_rows(t) & ~7;
      const int p0 = begin + t * kTile;
      const int row_bytes = kBf16 ? NP * 128 : D * 4;   // a box's bytes per row
      const int q_bytes = kBf16 && t == 0 ? heads * D * 2 : 0;   // the query rows, with tile 0
      tma::mbar_expect_tx(bar(t), 2 * boxed * row_bytes + q_bytes);
      if (q_bytes) tma::bulk_load(tma::smem_u32(smem + lay.c), q + h0 * D, q_bytes, bar(t));
      for (int k = 0, off = 0; k < kBoxes; ++k) {
        const int h = kTile >> k;
        if (!(boxed & h)) continue;
        for (int p = 0; p < (kBf16 ? NP : 1); ++p) {
          const uint32_t dst = kBf16 ? p * kPanelBytes + off * 128 : off * D * 4;
          tma::load_4d(k_tile(t) + dst, &maps.k[k], p * 64, hk, p0 + off, static_cast<int>(b), bar(t));
          tma::load_4d(v_tile(t) + dst, &maps.v[k], p * 64, hk, p0 + off, static_cast<int>(b), bar(t));
        }
        off += h;
      }
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int rows = tile_rows(t), first = rows & ~7;
    const long src0 = row0 + (begin + t * kTile) * stride_row;
    if constexpr (kBf16) {
      // rows [first, rows) by 16-byte chunk, zero from D to Dp; V's rows up
      // to the next 16 zeroed, since P.V reads them (with P = 0)
      const int nch = Dp / 8, top = min(kTile, (rows + 15) / 16 * 16);
      for (int i = tid; i < 2 * (top - first) * nch; i += kThreads) {
        const int which = i & 1, rc = i >> 1;
        const int r = first + rc / nch, c = rc % nch;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < rows && c * 8 < D) {
          v = *reinterpret_cast<const uint4*>((which ? vc : kc) + src0 + r * stride_row + c * 8);
        } else if (which == 0 && r >= rows) {
          continue;   // K rows past the tile are masked, not read
        }
        const uint32_t dst = (which ? v_tile(t) : k_tile(t)) + swz(r, c);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
                     "r"(v.z), "r"(v.w)
                     : "memory");
      }
    } else {
      float* ks = reinterpret_cast<float*>(smem + (2 * t) * tile_bytes);
      float* vs = reinterpret_cast<float*>(smem + (2 * t + 1) * tile_bytes);
      for (int i = tid; i < (rows - first) * Dp; i += kThreads) {
        const int r = first + i / Dp, d = i % Dp;
        const long off = src0 + r * stride_row + d;
        ks[r * Dp + d] = d < D ? to_f32(kc[off]) : 0.f;
        vs[r * Dp + d] = d < D ? to_f32(vc[off]) : 0.f;
      }
    }
  }

  float o[NT > 0 ? NT : 1][4] = {};   // bf16: O^T for head-dim values 16 warp + lane / 4 (+8)
  if constexpr (kBf16) {
    // the whole chunk in one pass: warp w scores rows 16w..16w+15, one
    // softmax over the chunk per head, then warp w takes head-dim values
    // 16w..16w+15 of O^T = V^T.P^T
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.c);
    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
    float* red = reinterpret_cast<float*>(smem + lay.b);      // [2][8 warps][16 heads]
    float* m_s = reinterpret_cast<float*>(smem + lay.d);
    float* l_s = reinterpret_cast<float*>(smem + lay.e);
    const int rows = end - begin;
    // the bulk copy brings rows of D values; the rows past ``heads`` are zeros
    for (int i = heads * D + tid; i < kHeads * D; i += kThreads) qs[i] = from_f32<T>(0.f);
    __syncthreads();   // the threads' rows and the zeros are in
    for (int t = 0; t < n_tiles; ++t) tma::mbar_wait(bar(t), 0);

    // S^T = K.q^T, the even and odd head-dim steps into two sums
    constexpr int KS = kMaxD / 16;
    const int ks_steps = Dp / 16;
    float x[NT][4], x1[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] = x1[nt][i] = 0.f;
    const int r_tile = 16 * (warp % 4) + lane % 16;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ks_steps && 16 * warp < rows) {
        uint32_t a[4];
        ldsm_x4(a, k_tile(warp / 4) + swz(r_tile, 2 * kk + lane / 16));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int h = nt * 8 + lane / 4;
          const int d = 16 * kk + 2 * (lane % 4);
          const uint32_t b0 = d < D ? *reinterpret_cast<const uint32_t*>(qs + h * D + d) : 0u;
          const uint32_t b1 = d + 8 < D ? *reinterpret_cast<const uint32_t*>(qs + h * D + d + 8) : 0u;
          mma_bf16(kk % 2 ? x1[nt] : x[nt], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] += x1[nt][i];
    // the chunk's max per head, in log2 units
    const int r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] = r0 + 8 * (i / 2) < rows ? x[nt][i] * scale * kLog2e : kNegInf;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(x[nt][e], x[nt][2 + e]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        if (lane < 4) red[warp * kHeads + nt * 8 + 2 * lane + e] = mx;
      }
    }
    __syncthreads();
    // P^T in bf16, and each warp's sums of the unrounded p
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = nt * 8 + 2 * (lane % 4) + e;
        float mx = red[h];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * kHeads + h]);
        const float p0 = exp2f(x[nt][e] - mx), p1 = exp2f(x[nt][2 + e] - mx);
        ps[h * kPsStride + r0] = __float2bfloat16(p0);
        ps[h * kPsStride + r0 + 8] = __float2bfloat16(p1);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
        if (lane < 4) {
          red[(kWarps + warp) * kHeads + h] = sum;
          if (warp == 0) m_s[h] = mx;
        }
      }
    __syncthreads();
    for (int h = tid; h < kHeads; h += kThreads) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += red[(kWarps + w) * kHeads + h];
      l_s[h] = l;
    }
    // O^T = V^T.P^T, 16 rows a step
    if (16 * warp < Dp) {
      const int j = lane / 8;
#pragma unroll
      for (int s8 = 0; s8 < kChunk / 16; ++s8) {
        if (16 * s8 < rows) {
          uint32_t a[4];
          ldsm_x4_trans(a, v_tile(s8 / 4) + swz(16 * (s8 % 4) + (j / 2) * 8 + lane % 8, 2 * warp + j % 2));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b0, b1;
            ldsm_x2(b0, b1, tma::smem_u32(ps + (nt * 8 + lane % 8) * kPsStride + 16 * s8 + (j % 2) * 8));
            mma_bf16(o[nt], a, b0, b1);
          }
        }
      }
    }
    __syncthreads();
  } else {
    float* qs = reinterpret_cast<float*>(smem + lay.a);
    float* ps = reinterpret_cast<float*>(smem + lay.b);
    float* acc = reinterpret_cast<float*>(smem + lay.c);
    float* st = reinterpret_cast<float*>(smem + lay.d);
    for (int i = tid; i < Gb * Dp; i += kThreads) {
      const int d = i % Dp;
      qs[i] = d < D ? to_f32(q[h0 * D + (i / Dp) * D + d]) : 0.f;
    }
    for (int i = tid; i < sh.RG * Gb * Dp; i += kThreads) acc[i] = 0.f;
    for (int i = tid; i < Gb; i += kThreads) {
      st[i] = kNegInf;   // m
      st[Gb + i] = 0.f;  // l
    }
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      tma::mbar_wait(bar(t), 0);
      fold_tile_f32(reinterpret_cast<const float*>(smem + (2 * t) * tile_bytes),
                    reinterpret_cast<const float*>(smem + (2 * t + 1) * tile_bytes), qs, ps, acc,
                    st, tile_rows(t), Gb, Dp, sh.RG, scale);
    }
  }

  // this block's (acc, m, l): bf16 holds acc in registers, float32 in
  // shared memory, one sum per row group
  const float* m_final = reinterpret_cast<const float*>(smem + lay.d);
  const float* l_final = kBf16 ? reinterpret_cast<const float*>(smem + lay.e) : m_final + Gb;
  // a head's log-sum-exp in log2 units from its (m, l): bf16 keeps m in
  // log2 units, float32 in natural ones
  auto log2_sum = [](float m, float l) { return (kBf16 ? m : m * kLog2e) + log2f(l); };
  // store(h, d, acc) for the block's heads and d < dmax
  auto emit = [&](auto store, int dmax) {
    if constexpr (kBf16) {
      if (16 * warp < Dp) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 16 * warp + lane / 4 + 8 * (i / 2);
            const int h = nt * 8 + 2 * (lane % 4) + (i % 2);
            if (h < heads && d < dmax) store(h, d, o[nt][i]);
          }
      }
    } else {
      const float* acc = reinterpret_cast<const float*>(smem + lay.c);
      for (int u = tid; u < heads * dmax; u += kThreads) {
        const int h = u / dmax, d = u % dmax;
        float a = 0.f;
        for (int rg = 0; rg < sh.RG; ++rg) a += acc[(rg * Gb + h) * Dp + d];
        store(h, d, a);
      }
    }
  };

  if (live == 1) {
    emit([&](int h, int d, float a) { out[(h0 + h) * D + d] = from_f32<T>(a / fmaxf(l_final[h], 1e-30f)); }, D);
    if (lse != nullptr)
      for (int h = tid; h < heads; h += kThreads) lse[h0 + h] = log2_sum(m_final[h], l_final[h]);
    return;
  }

  // -- the merge: this block row's slots (m in log2 units in bf16) and
  // counters
  const Scratch scr(sh, splits);
  const int slot_size = scr.slot;
  const long by = b * gridDim.y + y;
  float* slots = part + by * scr.slots_per_row;
  unsigned* cnt = counters + by * scr.counters_per_row;
  float* mine = slots + static_cast<long>(sp) * slot_size;
  emit([&](int h, int d, float a) { mine[h * Dp + d] = a; }, Dp);
  for (int h = tid; h < heads; h += kThreads) {
    mine[Gb * Dp + h] = m_final[h];
    mine[Gb * Dp + Gb + h] = l_final[h];
  }

  // after a ticket: merge ``n`` slots from ``src`` in order into the slot
  // ``dst``, or into the output when dst is null. Every slot's (m, l) goes
  // at once into shared memory where the tiles were; per head the max, the
  // weights (in place of m) and the sum follow from there; then a thread per
  // unit (head, four head-dim values) folds the slots' acc in order, loading
  // kBatch of them at a time.
  auto merge = [&](const float* src, int n, float* dst) {
    constexpr int kBatch = 8;
    float* wm = reinterpret_cast<float*>(smem);   // heads x n
    float* wl = wm + heads * n;                   // heads x n
    float* Ls = wl + heads * n;                   // heads
    __syncthreads();
    for (int x = tid; x < heads * n; x += kThreads) {
      const int h = x / n, s = x - h * n;
      const float* sl = src + static_cast<long>(s) * slot_size + Gb * Dp;
      wm[x] = __ldcg(sl + h);
      wl[x] = __ldcg(sl + Gb + h);
    }
    __syncthreads();
    for (int h = warp; h < heads; h += kWarps) {
      float M = kNegInf;
      for (int s = lane; s < n; s += 32) M = fmaxf(M, wm[h * n + s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
      float L = 0.f;
      for (int s = lane; s < n; s += 32) {
        const float dm = wm[h * n + s] - M;
        const float w = kBf16 ? exp2f(dm) : expf(dm);   // bf16 keeps m in log2 units
        wm[h * n + s] = w;
        L += w * wl[h * n + s];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(kFull, L, off);
      if (lane == 0) {
        Ls[h] = L;
        if (dst != nullptr) {
          dst[Gb * Dp + h] = M;
          dst[Gb * Dp + Gb + h] = L;
        } else if (lse != nullptr) {   // the last level: the final (m, l)
          lse[h0 + h] = log2_sum(M, L);
        }
      }
    }
    __syncthreads();
    const int D4 = Dp / 4;
    for (int u = tid; u < heads * D4; u += kThreads) {
      const int h = u / D4, d = (u - h * D4) * 4;
      const float* w = wm + h * n;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < n; s0 += kBatch) {
        float4 as[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (s0 + i < n)
            as[i] = __ldcg(reinterpret_cast<const float4*>(src + static_cast<long>(s0 + i) * slot_size + h * Dp + d));
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (s0 + i < n) fma4(A, w[s0 + i], as[i]);
      }
      if (dst != nullptr) {
        *reinterpret_cast<float4*>(dst + h * Dp + d) = A;
      } else {
        const float inv = 1.f / fmaxf(Ls[h], 1e-30f);
        const float v[4] = {A.x, A.y, A.z, A.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) out[(h0 + h) * D + d + e] = from_f32<T>(v[e] * inv);
      }
    }
  };
  // a ticket from ``counter``: true for the last of ``n`` arrivals, which
  // sets it back to 0
  auto ticket = [&](unsigned* counter, int n) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counter, 1u) == static_cast<unsigned>(n - 1);
      if (last) *counter = 0u;
    }
    __syncthreads();
    if (last) __threadfence();
    return last != 0;
  };

  const int groups = (live + kFanIn - 1) / kFanIn;
  const int g = sp / kFanIn;
  const int in_group = min(kFanIn, live - g * kFanIn);
  if (!ticket(cnt + 1 + g, in_group)) return;
  if (groups == 1) {
    merge(slots, live, nullptr);
    return;
  }
  float* second = slots + static_cast<long>(splits) * slot_size;
  merge(slots + static_cast<long>(g) * kFanIn * slot_size, in_group,
        second + static_cast<long>(g) * slot_size);
  if (!ticket(cnt, groups)) return;
  merge(second, groups, nullptr);
}

template <typename T, int NT>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, void* out,
           float* lse, float* part, unsigned* counters, int B, int Smax, int Hq, int Hkv, int D,
           int scale_dim, int splits, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const Shape sh(Hq, Hkv, D, kBf16);
  const Layout lay(sh, kBf16, splits);
  const int smem = 1024 + lay.total;
  Maps maps;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Smax, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * e, (cuuint64_t)Hkv * D * e, (cuuint64_t)Smax * Hkv * D * e};
  const CUtensorMapDataType type =
      kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle swizzle = kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  for (int k = 0; k < kBoxes; ++k) {
    // bf16: 64-wide swizzled panels; float32: whole dense rows
    const cuuint32_t box[4] = {kBf16 ? 64u : (cuuint32_t)D, 1, (cuuint32_t)(kTile >> k), 1};
    if (!tma::make_map(&maps.k[k], type, kc, 4, dims, strides, box, swizzle) ||
        !tma::make_map(&maps.v[k], type, vc, 4, dims, strides, box, swizzle))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = decode_attention_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, Hkv * sh.HC, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      static_cast<T*>(out), lse, part, counters, Smax, Hq, Hkv, D, splits,
      1.0f / sqrtf(static_cast<float>(scale_dim)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, D), caches (B, Smax, Hkv, D), lengths (B,) int32, out (B, Hq, D),
// lse null or (B, Hq) f32 (each head's log-sum-exp in log2 units, -inf at a
// length of 0), all contiguous and q, caches and out 16-byte aligned, with
// D % 8 == 0 (the tensor maps'
// rule); q, caches and out of one type (bf16 when bf16 != 0, else f32).
// Scores are scaled by 1/sqrt(scale_dim), scale_dim in (D - 8, D]: the
// true head dim of a zero-padded one. chunk must be 128 and splits =
// ceil(Smax / 128) (at least 1). With splits > 1, part holds part_floats
// floats and counters n_counters zeros, which the launch leaves at zero;
// the call fails if either is smaller than Scratch says. With splits == 1
// both may be null.
extern "C" int memforest_decode_attention(const void* q, const void* kc, const void* vc,
                                          const int* lengths, void* out, void* lse,
                                          void* part, void* counters, long long part_floats,
                                          long long n_counters, int B, int Smax, int Hq, int Hkv,
                                          int D, int scale_dim, int chunk, int splits, int bf16,
                                          void* stream) {
  const int want = Smax > kChunk ? (Smax + kChunk - 1) / kChunk : 1;
  const auto misaligned = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 != 0; };
  if (D < 1 || D > kMaxD || D % 8 != 0 || scale_dim > D || scale_dim <= D - 8 || Hkv < 1 ||
      Hq % Hkv != 0 || chunk != kChunk || splits != want || B > 65535 || misaligned(q) ||
      misaligned(kc) || misaligned(vc) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return static_cast<int>(cudaGetLastError());
  const Shape sh(Hq, Hkv, D, bf16 != 0);
  if (static_cast<long>(Hkv) * sh.HC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    const Scratch scr(sh, splits);
    const long long rows = static_cast<long long>(B) * Hkv * sh.HC;
    if (part == nullptr || counters == nullptr || part_floats < rows * scr.slots_per_row ||
        n_counters < rows * scr.counters_per_row)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part);
  unsigned* cn = static_cast<unsigned*>(counters);
  if (!bf16)
    return launch<float, 0>(q, kc, vc, lengths, out, ls, pa, cn, B, Smax, Hq, Hkv, D, scale_dim,
                            splits, s);
  return sh.Gb <= 8
             ? launch<__nv_bfloat16, 1>(q, kc, vc, lengths, out, ls, pa, cn, B, Smax, Hq, Hkv, D,
                                        scale_dim, splits, s)
             : launch<__nv_bfloat16, 2>(q, kc, vc, lengths, out, ls, pa, cn, B, Smax, Hq, Hkv, D,
                                        scale_dim, splits, s);
}
