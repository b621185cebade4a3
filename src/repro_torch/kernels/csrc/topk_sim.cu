// topk_sim: fused cosine scores + top-k, MemForest's recall scan.
//
// Replaces the TPU kernel src/repro/kernels/topk_sim.py:_topk_kernel
// (wrapper topk_sim). For each query q: scores s[q,n] = queries[q,:].keys[n,:]
// for n < num_valid (the rows are normalized beforehand when asked for); the
// k best (k <= 32) ordered by (score desc, key index asc); a slot that no
// valid key fills holds -1e30 and index -1.
//
// Bound on an H100: 2*Q*N*D float32 operations on the CUDA cores against
// N*D*4 bytes of keys. With Q = 64 the operations bound it (about 128
// operations per byte read); with one query the bytes do.
// Design: the TPU grid walks the keys in sequence for each block of queries,
// which with Q <= 64 would leave most of the 132 SMs idle. Here the keys are
// split across blocks instead:
//   pass 1 (topk_partial_kernel): a block takes 64 queries and one range of
//     keys. It computes 64x64 score tiles like a plain SGEMM (16x16 threads,
//     4x4 outputs each, 32-deep slices of D staged in shared memory, the
//     next slice loaded into registers while the current one is used, every
//     product a full fp32 FMA, no TF32). Each warp then folds the tile into
//     the sorted top-k lists of its 8 queries, held in registers (lane l
//     holds entry l): keys that beat the k-th score are found with a ballot,
//     and every entry's new position is counted in parallel, so no thread
//     walks a list. Keys arrive in ascending order, so a key enters a list
//     only with a strictly greater score. The block writes its lists as
//     candidates (Q, splits, k).
//   pass 2 (topk_merge_kernel): one block per query merges the splits'
//     sorted lists: one thread holds the head of each list (the block has as
//     many warps as the splits need), and each round a block reduction takes
//     the best head by (score desc, index asc).
// Every score is summed over d = 0..D-1 in the same order, so duplicated key
// rows score bitwise equal and tie on index.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQB = 64;       // queries per block
constexpr int kTK = 64;       // keys per tile
constexpr int kTD = 32;       // depth of one staged slice of D
constexpr int kThreads = 256; // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kQB / kWarps;
constexpr int kMaxK = 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQB == kTK, "one staging loop fills the query and the key slice");
static_assert(kTK == 64, "a warp holds a tile row as two keys per lane");

// rows padded by one float: the transposing stores hit 32 different banks
struct StageTiles {
  float q[kTD][kQB + 1];
  float k[kTD][kTK + 1];
};

union TileMem {
  StageTiles stage;
  float scores[kQB][kTK + 1];
};

// (v, i) ranks before (bv, bi) in the (score desc, index asc) order
__device__ __forceinline__ bool ranks_before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
                    float* __restrict__ cand_v, int* __restrict__ cand_i,
                    int Q, int N, int D, int num_valid, int k, int keys_per_split,
                    int splits) {
  __shared__ TileMem tile;
  __shared__ float stage_v[kWarps][kMaxK];
  __shared__ int stage_i[kWarps][kMaxK];

  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int key_begin = split * keys_per_split;
  const int key_end = min(min(key_begin + keys_per_split, N), num_valid);

  // entry `lane` of the sorted top-k list of query row warp + kWarps * s
  float lv[kRowsPerWarp];
  int li[kRowsPerWarp];
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) { lv[s] = kNegInf; li[s] = -1; }

  // this thread's share of one staged slice: rows r0 + kRowStep * it, column c0
  constexpr int kLoads = kQB * kTD / kThreads;
  constexpr int kRowStep = kThreads / kTD;
  const int r0 = tid / kTD, c0 = tid % kTD;
  float pq[kLoads], pk[kLoads];
  // issue all of a slice's loads before any is used, so their latencies
  // overlap; the next slice's loads fly while the current one is computed
  auto load_slice = [&](int kb, int d0) {
    const int dd = d0 + c0;
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int r = r0 + kRowStep * it;
      const int qq = q0 + r, kk = kb + r;
      pq[it] = (qq < Q && dd < D) ? queries[(long)qq * D + dd] : 0.f;
      pk[it] = (kk < key_end && dd < D) ? keys[(long)kk * D + dd] : 0.f;
    }
  };
  if (key_begin < key_end) load_slice(key_begin, 0);

  for (int kb = key_begin; kb < key_end; kb += kTK) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kTD) {
      __syncthreads();  // the previous slice (or the previous scores) is consumed
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        tile.stage.q[c0][r0 + kRowStep * it] = pq[it];
        tile.stage.k[c0][r0 + kRowStep * it] = pk[it];
      }
      __syncthreads();
      if (d0 + kTD < D) {
        load_slice(kb, d0 + kTD);
      } else if (kb + kTK < key_end) {
        load_slice(kb + kTK, 0);
      }
#pragma unroll 8
      for (int c = 0; c < kTD; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = tile.stage.q[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = tile.stage.k[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tile.scores[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();

    const int n_keys = min(kTK, key_end - kb);
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + kWarps * s;
      if (q0 + r >= Q) continue;                      // warp-uniform
      // this row's tile scores: key kb + lane and key kb + lane + 32
      const float a = lane < n_keys ? tile.scores[r][lane] : kNegInf;
      const float b = lane + 32 < n_keys ? tile.scores[r][lane + 32] : kNegInf;
      const float kth = __shfl_sync(kFull, lv[s], k - 1);
      const bool ca = a > kth, cb = b > kth;
      const unsigned ma = __ballot_sync(kFull, ca), mb = __ballot_sync(kFull, cb);
      if ((ma | mb) == 0u) continue;
      // new position of each entry: list entries keep their order and move
      // down past every candidate with a greater score; a candidate counts
      // the list entries with a score >= its own (they have lower indices)
      // and the candidates that rank before it
      int rank_l = lane, rank_a = 0, rank_b = 0;
      for (unsigned m = ma; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float y = __shfl_sync(kFull, a, src);
        rank_l += y > lv[s];
        rank_a += ranks_before(y, src, a, lane);
        rank_b += ranks_before(y, src, b, lane + 32);
      }
      for (unsigned m = mb; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float y = __shfl_sync(kFull, b, src);
        rank_l += y > lv[s];
        rank_a += ranks_before(y, src + 32, a, lane);
        rank_b += ranks_before(y, src + 32, b, lane + 32);
      }
      // live entries form a prefix of the list; dead ones (-1e30) count
      // for no candidate
      const int live = __popc(__ballot_sync(kFull, lane < k && li[s] >= 0));
      for (int e = 0; e < live; ++e) {
        const float y = __shfl_sync(kFull, lv[s], e);
        rank_a += y >= a;
        rank_b += y >= b;
      }
      if (lane < k && rank_l < k) { stage_v[warp][rank_l] = lv[s]; stage_i[warp][rank_l] = li[s]; }
      if (ca && rank_a < k) { stage_v[warp][rank_a] = a; stage_i[warp][rank_a] = kb + lane; }
      if (cb && rank_b < k) { stage_v[warp][rank_b] = b; stage_i[warp][rank_b] = kb + lane + 32; }
      __syncwarp();
      if (lane < k) { lv[s] = stage_v[warp][lane]; li[s] = stage_i[warp][lane]; }
      __syncwarp();
    }
  }
#pragma unroll
  for (int s = 0; s < kRowsPerWarp; ++s) {
    const int r = warp + kWarps * s;
    if (q0 + r < Q && lane < k) {
      const long o = ((long)(q0 + r) * splits + split) * k + lane;
      cand_v[o] = lv[s];
      cand_i[o] = li[s];
    }
  }
}

constexpr int kMergeThreads = 256;   // at most: one list head per thread

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int splits, int k) {
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32];
  __shared__ int pick_i;
  const long q = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* cv = cand_v + (q * splits + t) * k;
  const int* ci = cand_i + (q * splits + t) * k;

  // a list is sorted and its dead entries (index -1) come last; an empty
  // head reads (-inf, -1) and never wins
  int pos = 0;
  float hv = -CUDART_INF_F, nv = -CUDART_INF_F;
  int hi = -1, ni = -1;
  if (t < splits) {
    if (ci[0] >= 0) { hv = cv[0]; hi = ci[0]; }
    if (k > 1 && ci[1] >= 0) { nv = cv[1]; ni = ci[1]; }
  }
  for (int r = 0; r < k; ++r) {
    float bv = hv;
    int bi = hi;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (oi >= 0 && (bi < 0 || ranks_before(ov, oi, bv, bi))) { bv = ov; bi = oi; }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; }
    __syncthreads();
    if (t == 0) {
      float fv = wv[0];
      int fi = wi[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        if (wi[w] >= 0 && (fi < 0 || ranks_before(wv[w], wi[w], fv, fi))) { fv = wv[w]; fi = wi[w]; }
      out_v[q * k + r] = fi >= 0 ? fv : kNegInf;
      out_i[q * k + r] = fi;
      pick_i = fi;
    }
    __syncthreads();
    const int picked = pick_i;
    if (picked < 0) {  // every list is spent: the remaining slots are dead
      for (int rr = r + 1 + t; rr < k; rr += blockDim.x) {
        out_v[q * k + rr] = kNegInf;
        out_i[q * k + rr] = -1;
      }
      return;
    }
    if (hi == picked) {  // key indices are unique across splits: this list won
      hv = nv;
      hi = ni;
      ++pos;
      nv = -CUDART_INF_F;
      ni = -1;
      if (pos + 1 < k && ci[pos + 1] >= 0) { nv = cv[pos + 1]; ni = ci[pos + 1]; }
    }
  }
}

}  // namespace

extern "C" int memforest_topk_sim(const float* queries, const float* keys, float* cand_v,
                                  int* cand_i, float* out_v, int* out_i, int Q, int N, int D,
                                  int num_valid, int k, int keys_per_split, int splits,
                                  void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || splits > kMergeThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 0) {
    dim3 grid(splits, (Q + kQB - 1) / kQB);
    topk_partial_kernel<<<grid, kThreads, 0, s>>>(queries, keys, cand_v, cand_i, Q, N, D,
                                                  num_valid, k, keys_per_split, splits);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int merge_threads = (splits + 31) / 32 * 32;
    topk_merge_kernel<<<Q, merge_threads, 0, s>>>(cand_v, cand_i, out_v, out_i, splits, k);
  }
  return static_cast<int>(cudaGetLastError());
}
