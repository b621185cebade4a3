// browse_scores: one depth level of MemForest's level-synchronous tree browse.
//
// Replaces the TPU kernel src/repro/kernels/browse_scores.py:_browse_kernel
// (wrapper browse_scores). For every frontier entry f and child slot k:
//     out[f,k] = (sum_d arena[row(f,k),d] * q[lane(f),d]) * mask[f,k]
// Two forms share the kernel and its C entry:
//   - gather: row(f,k) = rows[f*K+k] indexes the forest's node arena on the
//     card and lane(f) = lane_of[f] one query row per browse lane, so a level
//     uploads only indices and the mask;
//   - packed (the TPU kernel's form): rows and lane_of are null, the arena
//     is the (F, K, D) children as F*K rows, row(f,k) = f*K+k, lane(f) = f.
// A slot whose row is negative reads nothing and scores exactly 0. A row id
// >= R or a lane id outside [0, L) scores NaN: the wrappers check the ranges
// of CPU inputs, and on the card a check would cost a round trip.
//
// Bound on an H100: memory. Each gathered row is read for one dot product:
// about (F*K*D + L*D) * 4 bytes for 2*F*K*D operations, far below the
// card's balance point, so the design is about bytes in flight and bytes
// read once:
//   - D <= 512 (team 1 in the wrapper's plan): a warp per entry, four
//     entries a block. A lane owns the float4 columns lane + 32*j of the
//     row; it holds the query's and issues the 16-byte loads of 8 children
//     for two such columns (16 loads) before the first FMA, so at D = 256
//     every child load of an entry of 8 is in flight at once.
//   - D > 512 (team kTeam): a block of 4 warps per entry, warp w owning the
//     w-th slice of the columns, the same loads inside it; the warps' sums
//     meet in shared memory and are added in warp order.
//   - child rows are loaded without allocating in L1 (each is read once);
//     up to 128 registers a thread, four blocks of 4 warps an SM.
//   - each slot's partial is one chain of FMAs over the lane's columns in
//     order (x, y, z, w of a float4, then the next); the 8 slots' partials
//     are reduced across the warp in one reduce-scatter butterfly (three
//     exchange steps, lanes 1, 2, 4 apart, then two sums, 8 and 16 apart):
//     9 shuffles for 8 slots instead of 40, after which lane l holds slot
//     bitrev3(l & 7) and lanes 0-7 store 8 consecutive outputs.
// The chain over d and the butterfly's tree are the same for every slot,
// entry and form at a given D, so two slots that gather the same row against
// the same query score bitwise equal (the beam's tie-break on the lowest
// child id depends on it). Rows of D % 4 != 0 or unaligned pointers take the
// same schedule over single floats.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTeam = 4;         // warps per entry above the wrapper's WARP_MAX_D
constexpr int kSlots = 8;        // child slots reduced together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot_step(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_step(float a, float b, float acc) {
  return __fmaf_rn(a, b, acc);
}

// A child row's 16 bytes: read once, so not allocated in L1 (faster at
// D = 4096 than __ldg, which keeps them there).
__device__ __forceinline__ float4 ld_row(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_row(const float* p) { return __ldg(p); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The partials of kSlots children over the columns [c0, c1) (in units of T)
// that lane owns: c0 + lane + 32 * j. Two columns a pass, every load of the
// pass issued before its first FMA; a null row reads nothing.
template <typename T>
__device__ __forceinline__ void partials(const T* __restrict__ q, const T* const (&row)[kSlots],
                                         int c0, int c1, int lane, float (&acc)[kSlots]) {
  for (int i0 = c0 + lane; i0 < c1; i0 += 64) {
    const int i1 = i0 + 32;
    const bool has1 = i1 < c1;
    const T qa = __ldg(q + i0);
    const T qb = has1 ? __ldg(q + i1) : zero<T>();
    T a[kSlots], b[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      a[c] = row[c] ? ld_row(row[c] + i0) : zero<T>();
      b[c] = row[c] && has1 ? ld_row(row[c] + i1) : zero<T>();
    }
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc[c] = dot_step(b[c], qb, dot_step(a[c], qa, acc[c]));
  }
}

// One exchange step of the reduce-scatter: of the first 2N partials, each
// lane keeps N (the upper half where its bit kOff is set) and adds the
// partner's value for them.
template <int N, int kOff>
__device__ __forceinline__ void exchange(float (&v)[kSlots], int lane) {
  const bool up = lane & kOff;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
}

// Reduce-scatter of 8 per-lane partials: returns the warp's sum of slot
// bitrev3(lane & 7).
__device__ __forceinline__ float reduce_scatter8(float (&v)[kSlots], int lane) {
  exchange<4, 1>(v, lane);
  exchange<2, 2>(v, lane);
  exchange<1, 4>(v, lane);
  float r = v[0];
  r += __shfl_xor_sync(kFull, r, 8);
  r += __shfl_xor_sync(kFull, r, 16);
  return r;
}

__device__ __forceinline__ int bitrev3(int x) {
  return ((x & 1) << 2) | (x & 2) | ((x >> 2) & 1);
}

// One slot's score from its dot product: NaN for an out-of-range row or
// lane, exactly 0 for a padded slot, else the product times the mask.
__device__ __forceinline__ float finish(float s, long r, bool bad_lane, int R, float m) {
  if (bad_lane || r >= R) return __int_as_float(0x7fc00000);
  return r < 0 ? 0.f : s * m;
}

// kTeam warps per entry, kWarps / kTeam entries a block; T = float4 or
// float (columns in units of T).
template <typename T, int kWarps, int kTeam>
__global__ void __launch_bounds__(kWarps * 32, 4)
browse_kernel(const float* __restrict__ arena, const int* __restrict__ rows,
              const float* __restrict__ q, const int* __restrict__ lane_of,
              const float* __restrict__ mask, float* __restrict__ out, int F, int K,
              int D, int R, int L) {
  constexpr int kEntries = kWarps / kTeam;
  __shared__ float red[kTeam][kSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp % kTeam;
  const long f = static_cast<long>(blockIdx.x) * kEntries + warp / kTeam;
  if (f >= F) return;   // a block team shares its entry: the whole block returns
  const int lq = lane_of ? __ldg(lane_of + f) : static_cast<int>(f);
  const bool bad_lane = lq < 0 || lq >= L;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int n = D / kPer;                  // the row in units of T
  const int per = (n + kTeam - 1) / kTeam;
  const int c0 = w * per, c1 = min(c0 + per, n);
  const T* qrow = reinterpret_cast<const T*>(q + static_cast<long>(bad_lane ? 0 : lq) * D);
  const long base = f * K;

  for (int k0 = 0; k0 < K; k0 += kSlots) {
    // the slot this lane stores (lanes 0-7 of a warp entry, of warp 0 of a
    // team): its row id and mask loaded up front, beside the children
    const int mine = k0 + (kTeam == 1 ? bitrev3(lane & 7) : lane);
    const bool stores = lane < kSlots && mine < K && w == 0;
    long r_mine = -1;
    float m_mine = 0.f;
    if (stores) {
      r_mine = rows ? __ldg(rows + base + mine) : base + mine;
      m_mine = __ldg(mask + base + mine);
    }
    const T* row[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int k = k0 + c;
      const long r = k >= K ? -1 : rows ? __ldg(rows + base + k) : base + k;
      row[c] = (r >= 0 && r < R && !bad_lane)
                   ? reinterpret_cast<const T*>(arena + r * D) : nullptr;
    }
    float acc[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots; ++c) acc[c] = 0.f;
    partials<T>(qrow, row, c0, c1, lane, acc);
    const float s = reduce_scatter8(acc, lane);
    if constexpr (kTeam == 1) {
      if (stores) out[base + mine] = finish(s, r_mine, bad_lane, R, m_mine);
    } else {
      if (lane < kSlots) red[w][bitrev3(lane)] = s;
      __syncthreads();
      if (stores) {
        float t = red[0][lane];
#pragma unroll
        for (int v = 1; v < kTeam; ++v) t += red[v][lane];
        out[base + mine] = finish(t, r_mine, bad_lane, R, m_mine);
      }
      __syncthreads();
    }
  }
}

template <typename T>
void launch(const float* arena, const int* rows, const float* q, const int* lane_of,
            const float* mask, float* out, int F, int K, int D, int R, int L, int team,
            cudaStream_t stream) {
  if (team == 1) {
    constexpr int kWarps = 4;
    const unsigned blocks = static_cast<unsigned>((F + kWarps - 1) / kWarps);
    browse_kernel<T, kWarps, 1><<<blocks, kWarps * 32, 0, stream>>>(
        arena, rows, q, lane_of, mask, out, F, K, D, R, L);
  } else {
    browse_kernel<T, kTeam, kTeam><<<static_cast<unsigned>(F), kTeam * 32, 0, stream>>>(
        arena, rows, q, lane_of, mask, out, F, K, D, R, L);
  }
}

}  // namespace

// arena (R, D), rows (F, K) int32 or null (packed: R = F*K), q (L, D),
// lane_of (F,) int32 or null (packed: L = F), mask and out (F, K); all f32
// unless named. team: warps per entry, 1 or kTeam (the wrapper's plan).
// Returns a cudaError_t.
extern "C" int memforest_browse_scores(const float* arena, const int* rows, const float* q,
                                       const int* lane_of, const float* mask, float* out,
                                       int F, int K, int D, int R, int L, int team,
                                       void* stream) {
  if (F < 0 || K < 0 || D < 0 || R < 0 || L < 0 || (team != 1 && team != kTeam))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0 || K == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<std::uintptr_t>(arena) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
  if (vec4) {
    launch<float4>(arena, rows, q, lane_of, mask, out, F, K, D, R, L, team, s);
  } else {
    launch<float>(arena, rows, q, lane_of, mask, out, F, K, D, R, L, team, s);
  }
  return static_cast<int>(cudaGetLastError());
}
