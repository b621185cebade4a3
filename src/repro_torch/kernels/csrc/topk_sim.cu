// topk_sim: fused cosine scores + top-k, MemForest's recall scan.
//
// Replaces the TPU kernel src/repro/kernels/topk_sim.py:_topk_kernel
// (wrapper topk_sim). For each query q: scores s[q,n] = queries[q,:].keys[n,:]
// for n < num_valid (the rows are normalized beforehand when asked for); the
// k best (k <= 32) ordered by (score desc, key index asc); a slot that no
// valid key fills holds -1e30 and index -1.
//
// Bound on an H100: 2*Q*num_valid*D float32 operations on the CUDA cores
// against num_valid*D*4 bytes of keys. At the recall shapes (64 queries over
// about a thousand keys of 256) both bounds are under a microsecond, so the
// time is latency: the launch, one round trip for the keys, the selection
// and the merge of the splits. At D = 4096 the keys' bytes bound it.
// Design (one launch):
//   - A block takes 32 queries and one split of the keys: whole tiles of 64
//     keys, below num_valid only. A thread-block cluster of C blocks (C = 1,
//     2, 4 or 8) splits D into C slices, one per block (its rank). The
//     wrapper's plan picks C and the splits so that the blocks fill the card
//     at every shape, large D or small.
//   - Scores: every product a full f32 FMA, from a ring of 32-deep slices
//     filled by 16-byte cp.async copies (later slices fly while one is used,
//     the next tile's while a tile is selected). Where the block's slice is
//     at most 8 stages deep, its queries stay in shared memory and only keys
//     stream. Two ways to cut the 32 x 64 tile over the 4 warps:
//       shallow slices (under 128 of D): warp w takes rows 8 w .. 8 w + 7,
//         lane l keys l and l + 32, over the whole stage;
//       deep slices (split_k): each warp takes the whole tile over its
//         quarter of every stage, lane (g, h) rows g + 4 i and keys h + 8 j
//         (8 x 8), so each value read from shared memory feeds 8 FMAs.
//   - Each rank owns 32 / C of the 32 rows. After a tile, every warp stores
//     its partial scores of a row into the owner's shared memory
//     (distributed shared memory); after a cluster barrier the owner adds
//     them in (rank, warp) order.
//   - Selection: a warp holds a row's sorted list (lane l: entry l). A ballot
//     finds the keys above the k-th score: a few are inserted one by one,
//     more go through a bitonic sort of the tile's 64 (score, index) pairs
//     under the two-key order and two bitonic merges.
//   - Merge in the same launch: each split writes its lists and takes a
//     ticket; the last block of a (query block, rank) merges the splits'
//     lists in split order and sets its counter back to 0.
// Every score is summed in one order (each warp's columns in d order, the
// partial sums in (rank, warp) order), whatever split or tile the key falls
// in, so duplicated key rows score bitwise equal and tie on index.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kQB = 32;          // queries per block
constexpr int kTK = 64;          // keys per tile
constexpr int kTD = 32;          // depth of one ring stage
constexpr int kStages = 4;       // ring slots: three stages in flight
constexpr int kQSlots = 8;       // query stages a block keeps (a slice of up to 256)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDW = kTD / kWarps;  // split_k: depth of a stage one warp sums
constexpr int kMaxK = 32;
constexpr int kMaxSplits = 256;
constexpr int kInsert = 8;       // at most this many keys above the k-th: insert them one by one
constexpr int kRow = kTD + 4;    // a staged row: 144 bytes, so 8 rows hit 8 bank groups
constexpr int kScRow = kTK + 8;  // a partial-score row: split_k's stores hit 32 banks
constexpr float kNegInf = -1e30f;
constexpr int kDead = 0x7fffffff;  // index of an empty entry: it ranks last
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQB == 32 && kTK == 64 && kWarps == 4 && kDW == 8,
              "the two cuts of the 32 x 64 tile over four warps");

// Dynamic shared memory, laid out alike in every block of a launch (its
// ranks store into each other's partial scores at the same offsets):
//   q   query stages: the slice's (at most kQSlots) kept, else a ring of
//       kStages;
//   k   the keys' ring of kStages;
//   sc  partial scores of this rank's R rows, by source rank and warp: row
//       (src * P + w) * R + r, P = kWarps (split_k) or 1.
struct Layout {
  bool keep_q;  // the slice is at most kQSlots stages deep: its queries stay
  int q_slots, sc_rows;
  __host__ __device__ Layout(int slice, bool split_k)
      : keep_q((slice + kTD - 1) / kTD <= kQSlots),
        q_slots(keep_q ? (slice + kTD - 1) / kTD : kStages),
        sc_rows(kQB * (split_k ? kWarps : 1)) {}
  __host__ __device__ int k_offset() const { return q_slots * kQB * kRow; }
  __host__ __device__ int sc_offset() const { return k_offset() + kStages * kTK * kRow; }
  __host__ __device__ int bytes() const {
    return static_cast<int>(sizeof(float)) * (sc_offset() + sc_rows * kScRow);
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (v, i) ranks before (bv, bi) in the (score desc, index asc) order
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// compare with lane ^ stride: keep the entry that ranks first when
// keep_first, else the other
__device__ __forceinline__ void exchange(float& v, int& i, int stride, bool keep_first) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (before(ov, oi, v, i) == keep_first) {
    v = ov;
    i = oi;
  }
}

// sorted (v, i) <- the best 32 of itself and sorted (w, j): the better of
// v[l] and w[31 - l] form a bitonic sequence, which five steps sort
__device__ __forceinline__ void merge(float& v, int& i, float w, int j, int lane) {
  const float rw = __shfl_sync(kFull, w, 31 - lane);
  const int rj = __shfl_sync(kFull, j, 31 - lane);
  if (before(rw, rj, v, i)) {
    v = rw;
    i = rj;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) exchange(v, i, stride, (lane & stride) == 0);
}

// the list's two lists of 32 (one entry of each per lane) sorted by the
// bitonic network; their chains overlap
__device__ __forceinline__ void sort2(float& a, int& ia, float& b, int& ib, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool first = ((lane & size) == 0) == ((lane & stride) == 0);
      exchange(a, ia, stride, first);
      exchange(b, ib, stride, first);
    }
  }
}

// (cv, ci) into the sorted list at its place; the last entry drops out
__device__ __forceinline__ void insert(float& v, int& i, float cv, int ci, int lane) {
  const int pos = __popc(__ballot_sync(kFull, before(v, i, cv, ci)));
  const float uv = __shfl_up_sync(kFull, v, 1);
  const int ui = __shfl_up_sync(kFull, i, 1);
  if (lane > pos) {
    v = uv;
    i = ui;
  } else if (lane == pos) {
    v = cv;
    i = ci;
  }
}

// fold one tile row (lane l: keys ia = l, ib = l + 32 of the tile) into the
// sorted list. The tile's keys come after every key of the list, so a key
// enters the first k only with a strictly greater score than the k-th: a
// ballot finds those. A few are inserted one by one; more go through the
// network (a bitonic sort of the tile's 64, two bitonic merges), with no
// loop over candidates.
__device__ __forceinline__ void fold(float& lv, int& li, float a, int ia, float b, int ib, int k,
                                     int lane) {
  const float kth = __shfl_sync(kFull, lv, k - 1);
  const unsigned ma = __ballot_sync(kFull, a > kth), mb = __ballot_sync(kFull, b > kth);
  const int n = __popc(ma) + __popc(mb);
  if (n == 0) return;
  if (n <= kInsert) {
    for (unsigned m = ma; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      insert(lv, li, __shfl_sync(kFull, a, src), __shfl_sync(kFull, ia, src), lane);
    }
    for (unsigned m = mb; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      insert(lv, li, __shfl_sync(kFull, b, src), __shfl_sync(kFull, ib, src), lane);
    }
    return;
  }
  sort2(a, ia, b, ib, lane);
  merge(a, ia, b, ib, lane);
  merge(lv, li, a, ia, lane);
}

// merge() in the rows that take it; the rows' chains overlap
template <int N>
__device__ __forceinline__ void merge_rows(float (&v)[N], int (&i)[N], const float (&w)[N],
                                           const int (&j)[N], const bool (&take)[N], int lane) {
  float mv[N];
  int mi[N];
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const float rw = __shfl_sync(kFull, w[s], 31 - lane);
    const int rj = __shfl_sync(kFull, j[s], 31 - lane);
    const bool other = before(rw, rj, v[s], i[s]);
    mv[s] = other ? rw : v[s];
    mi[s] = other ? rj : i[s];
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int s = 0; s < N; ++s) exchange(mv[s], mi[s], stride, (lane & stride) == 0);
#pragma unroll
  for (int s = 0; s < N; ++s)
    if (take[s]) {
      v[s] = mv[s];
      i[s] = mi[s];
    }
}

__device__ __forceinline__ void write_out(float* out_v, int* out_i, long o, float v, int i) {
  const float val = i == kDead ? kNegInf : v;
  out_v[o] = val;
  out_i[o] = val > -1e29f ? i : -1;
}

// C: blocks per cluster, each a slice of D. Rank r owns rows r R .. r R + R - 1
// of the block's 32 and selects them: row warp + kWarps s is a warp's s-th.
template <int C, bool kSplitK>
__global__ void __launch_bounds__(kThreads)
topk_sim_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                float* __restrict__ cand_v, int* __restrict__ cand_i,
                unsigned* __restrict__ counters, float* __restrict__ out_v,
                int* __restrict__ out_i, int Q, int D, int num_valid, int k,
                int keys_per_split, int splits, int slice) {
  constexpr int R = kQB / C;
  constexpr int RPW = R / kWarps;
  constexpr int P = kSplitK ? kWarps : 1;    // partial tiles a rank sends
  constexpr int NJ = kSplitK ? 8 : 2;        // keys a lane scores
  constexpr int kBatch = 16 / RPW;  // splits' lists the merge loads at once
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // its wait comes before the first store to another rank

  const int split = blockIdx.x / C;
  const int q0 = blockIdx.y * kQB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 3, h = lane & 7;
  const int key_begin = split * keys_per_split;
  const int key_end = min(key_begin + keys_per_split, num_valid);
  const int n_tiles = key_end > key_begin ? (key_end - key_begin + kTK - 1) / kTK : 0;
  const int ds = rank * slice, de = min(D, ds + slice);
  const int nd = max(1, (de - ds + kTD - 1) / kTD);
  const int total = n_tiles * nd;
  // the slice's queries stay in slots 0 .. nd - 1; deeper slices stream
  // them through a ring
  const Layout lay(slice, kSplitK);
  const bool keep_q = lay.keep_q;
  float(*sq)[kQB][kRow] = reinterpret_cast<float(*)[kQB][kRow]>(smem);
  float(*sk)[kTK][kRow] = reinterpret_cast<float(*)[kTK][kRow]>(smem + lay.k_offset());
  float(*sc)[kScRow] = reinterpret_cast<float(*)[kScRow]>(smem + lay.sc_offset());

  // stage `it` of the walk (tile it / nd, depth slice it % nd)
  auto load = [&](int it) {
    if (it < total) {
      const int kb = key_begin + (it / nd) * kTK;
      const int c = tid & 7, r = tid >> 3;
      const int d = ds + (it % nd) * kTD + 4 * c;
      const bool dv = d < de;
      if (!keep_q || it < nd) {
        const int slot = keep_q ? it : it % kStages;
#pragma unroll
        for (int u = 0; u < kQB / 16; ++u) {
          const int rr = r + 16 * u;
          const bool qv = dv && q0 + rr < Q;
          mma::cp16(mma::smem_u32(&sq[slot][rr][4 * c]),
                    qv ? queries + static_cast<long>(q0 + rr) * D + d : queries, qv);
        }
      }
#pragma unroll
      for (int u = 0; u < kTK / 16; ++u) {
        const int rr = r + 16 * u;
        const bool kv = dv && kb + rr < key_end;
        mma::cp16(mma::smem_u32(&sk[it % kStages][rr][4 * c]),
                  kv ? keys + static_cast<long>(kb + rr) * D + d : keys, kv);
      }
    }
    mma::cp_commit();
  };

  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  float lv[RPW];
  int li[RPW];
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    lv[s] = -CUDART_INF_F;
    li[s] = kDead;
  }
  // owned row r = warp + kWarps * s: query own0 + kWarps * s
  const int own0 = q0 + rank * R + warp;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int it = 0; it < total; ++it) {
    mma::cp_wait<kStages - 2>();
    __syncthreads();  // stage `it` is in; slot (it - 1) % kStages is consumed
    load(it + kStages - 1);
    const float(*qs)[kRow] = sq[keep_q ? it % nd : it % kStages];
    const float(*ks)[kRow] = sk[it % kStages];
    if constexpr (kSplitK) {
#pragma unroll
      for (int c4 = 0; c4 < kDW / 4; ++c4) {
        const int d = kDW * warp + 4 * c4;
        float4 qa[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) qa[i] = *reinterpret_cast<const float4*>(&qs[g + 4 * i][d]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[h + 8 * j][d]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = __fmaf_rn(qa[i].x, kv.x, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa[i].y, kv.y, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa[i].z, kv.z, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa[i].w, kv.w, acc[i][j]);
          }
        }
      }
    } else {
#pragma unroll
      for (int c4 = 0; c4 < kTD / 4; ++c4) {
        float4 kv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          kv[j] = *reinterpret_cast<const float4*>(&ks[lane + 32 * j][4 * c4]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(&qs[8 * warp + i][4 * c4]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j] = __fmaf_rn(qa.x, kv[j].x, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa.y, kv[j].y, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa.z, kv[j].z, acc[i][j]);
            acc[i][j] = __fmaf_rn(qa.w, kv[j].w, acc[i][j]);
          }
        }
      }
    }
    if (it % nd != nd - 1) continue;

    // the tile's partial scores to their owners, then the owners select
    const int tile = it / nd, kb = key_begin + tile * kTK;
    if (tile == 0)
      cluster_wait();  // every block of the cluster has started
    else
      cluster_sync();  // every owner has read the previous tile's partials
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = kSplitK ? g + 4 * i : 8 * warp + i;
      float* dst = cluster.map_shared_rank(&sc[(rank * P + (kSplitK ? warp : 0)) * R + row % R][0],
                                           row / R);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dst[kSplitK ? h + 8 * j : lane + 32 * j] = acc[i][j];
        acc[i][j] = 0.f;
      }
    }
    cluster_sync();
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      const int r = warp + kWarps * s;
      if (own0 + kWarps * s >= Q) continue;  // warp-uniform
      float pa[C * P], pb[C * P];
#pragma unroll
      for (int src = 0; src < C * P; ++src) {
        pa[src] = sc[src * R + r][lane];
        pb[src] = sc[src * R + r][lane + 32];
      }
      float a = pa[0], bb = pb[0];
#pragma unroll
      for (int src = 1; src < C * P; ++src) {
        a += pa[src];
        bb += pb[src];
      }
      int ia = kb + lane, ib = kb + lane + 32;
      if (ia >= key_end) {
        a = -CUDART_INF_F;
        ia = kDead;
      }
      if (ib >= key_end) {
        bb = -CUDART_INF_F;
        ib = kDead;
      }
      fold(lv[s], li[s], a, ia, bb, ib, k, lane);
    }
  }
  if (n_tiles == 0) cluster_wait();  // pair the arrive: nothing was walked

  // the owned rows' lists: the answer, or this split's candidates
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    const int q = own0 + kWarps * s;
    if (q >= Q || lane >= k) continue;
    if (splits == 1) {
      write_out(out_v, out_i, static_cast<long>(q) * k + lane, lv[s], li[s]);
    } else {
      const long o = (static_cast<long>(q) * splits + split) * k + lane;
      cand_v[o] = lv[s];
      cand_i[o] = li[s];
    }
  }
  if (splits == 1) return;

  // a ticket: the last split of this (query block, rank) merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* counter = counters + blockIdx.y * C + rank;
    last = atomicAdd(counter, 1u) == static_cast<unsigned>(splits - 1);
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the splits' lists in split order, the warp's rows side by side
  float v[RPW];
  int i[RPW];
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    v[s] = -CUDART_INF_F;
    i[s] = kDead;
  }
  for (int s0 = 0; s0 < splits; s0 += kBatch) {
    float w[kBatch][RPW];
    int j[kBatch][RPW];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int s = 0; s < RPW; ++s) {
        const int q = own0 + kWarps * s;
        const bool ok = q < Q && s0 + u < splits && lane < k;
        const long o = (static_cast<long>(q) * splits + s0 + u) * k + lane;
        w[u][s] = ok ? __ldcg(cand_v + o) : -CUDART_INF_F;
        j[u][s] = ok ? __ldcg(cand_i + o) : kDead;
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u >= splits) break;
      // a later split's keys come after every key of the list
      bool take[RPW];
      bool any = false;
#pragma unroll
      for (int s = 0; s < RPW; ++s) {
        take[s] = __shfl_sync(kFull, w[u][s], 0) > __shfl_sync(kFull, v[s], k - 1);
        any = any || take[s];
      }
      if (any) merge_rows<RPW>(v, i, w[u], j[u], take, lane);
    }
  }
#pragma unroll
  for (int s = 0; s < RPW; ++s) {
    const int q = own0 + kWarps * s;
    if (q < Q && lane < k) write_out(out_v, out_i, static_cast<long>(q) * k + lane, v[s], i[s]);
  }
}

template <int C, bool kSplitK>
cudaError_t launch(const float* queries, const float* keys, float* cand_v, int* cand_i,
                   unsigned* counters, float* out_v, int* out_i, int Q, int D, int num_valid,
                   int k, int keys_per_split, int splits, int slice, int q_blocks,
                   cudaStream_t stream) {
  const int smem = Layout(slice, kSplitK).bytes();
  auto kernel = topk_sim_kernel<C, kSplitK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * C, q_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, queries, keys, cand_v, cand_i, counters, out_v, out_i,
                            Q, D, num_valid, k, keys_per_split, splits, slice);
}

template <bool kSplitK>
cudaError_t launch_for(int cluster, const float* queries, const float* keys, float* cand_v,
                       int* cand_i, unsigned* counters, float* out_v, int* out_i, int Q, int D,
                       int num_valid, int k, int keys_per_split, int splits, int slice,
                       int q_blocks, cudaStream_t st) {
#define TOPK_LAUNCH(CL)                                                                        \
  launch<CL, kSplitK>(queries, keys, cand_v, cand_i, counters, out_v, out_i, Q, D, num_valid, \
                      k, keys_per_split, splits, slice, q_blocks, st)
  return cluster == 1 ? TOPK_LAUNCH(1)
         : cluster == 2 ? TOPK_LAUNCH(2)
         : cluster == 4 ? TOPK_LAUNCH(4)
                        : TOPK_LAUNCH(8);
#undef TOPK_LAUNCH
}

}  // namespace

// queries (Q, D) and keys (N, D) f32, contiguous and 16-byte aligned, D % 4
// == 0; out_v (Q, k) f32 and out_i (Q, k) int32. The plan (the wrapper's
// plan_splits): splits of keys_per_split keys (a multiple of 64) cover
// [0, num_valid) with no empty split; a cluster of `cluster` blocks (1, 2, 4
// or 8) splits D into slices of `slice` (a multiple of 4), none empty. With
// splits > 1, cand_v and cand_i hold Q * splits * k entries and counters
// n_counters >= ceil(Q / 32) * cluster zeros, which the launch leaves at
// zero; with one split all three may be null. split_k != 0 cuts each
// 32 x 64 tile over the warps by depth (for slices of 128 or more).
extern "C" int memforest_topk_sim(const float* queries, const float* keys, float* cand_v,
                                  int* cand_i, void* counters, long long n_counters,
                                  float* out_v, int* out_i, int Q, int N, int D, int num_valid,
                                  int k, int keys_per_split, int splits, int cluster, int slice,
                                  int split_k, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 != 0;
  };
  const long q_blocks = (static_cast<long>(Q) + kQB - 1) / kQB;
  if (k < 1 || k > kMaxK || Q < 0 || D < 4 || D % 4 != 0 || num_valid < 0 || num_valid > N ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || slice < 4 ||
      slice % 4 != 0 || static_cast<long>(slice) * cluster < D ||
      static_cast<long>(slice) * (cluster - 1) >= D || keys_per_split < kTK ||
      keys_per_split % kTK != 0 || splits < 1 || splits > kMaxSplits ||
      static_cast<long>(keys_per_split) * splits < num_valid ||
      static_cast<long>(keys_per_split) * (splits - 1) >= (num_valid > 0 ? num_valid : 1) ||
      q_blocks > 65535 || misaligned(queries) || misaligned(keys))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && (cand_v == nullptr || cand_i == nullptr || counters == nullptr ||
                     n_counters < q_blocks * cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  unsigned* cn = static_cast<unsigned*>(counters);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qb = static_cast<int>(q_blocks);
  const cudaError_t err =
      split_k ? launch_for<true>(cluster, queries, keys, cand_v, cand_i, cn, out_v, out_i, Q, D,
                                 num_valid, k, keys_per_split, splits, slice, qb, st)
              : launch_for<false>(cluster, queries, keys, cand_v, cand_i, cn, out_v, out_i, Q, D,
                                  num_valid, k, keys_per_split, splits, slice, qb, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
