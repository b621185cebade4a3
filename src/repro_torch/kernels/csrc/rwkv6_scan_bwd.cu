// rwkv6_scan_bwd: the gradient of the chunked RWKV6 WKV scan, the backward
// of rwkv6's time-mix in training.
//
// No Pallas kernel has a backward: the reference differentiates its jnp
// chunked scan (src/repro/kernels/ref.py:rwkv6_chunked). The plain version
// is ref.rwkv6_scan_bwd_ref; tests/test_torch_scan_design.py
// (rwkv_bwd_schedule) emulates the bf16 path's schedule step by step. Per
// head h, with S0 the (K, V) state entering a chunk, ld = -exp(w), cum its
// inclusive sums down each key column in row order, ce = cum - ld (as the
// forward forms it), the gate E[t,s,k] = exp(min(ce_t - cum_s, 0)) (s < t),
// A[t,s] = sum_k r k E and A[t,t] = r.u.k, the forward is
//     o = A.v + (r exp(ce)).S0,   S1 = exp(total) S0 + (k ex)^T.v
// (ex = exp(min(total - cum, 0))) and, walking the chunks in reverse with dS
// the cotangent of S1 (ds_out for the last chunk),
//     dA = do.v^T (s <= t),   dv = A^T.do + (k ex).dS
//     dr = dA_tt u k + sum_s dA E k + exp(ce) (do.S0^T)
//     dk = dA_tt u r + sum_t dA E r + ex (v.dS^T),   du = sum_t dA_tt r k
//     dS0 = exp(total) dS + (r exp(ce))^T.do
// with the cotangents of ce (dce = r (dr's gate and carried terms)) and of
// cum (dcum = -k (dk's gate term) - k ex (v.dS^T), plus dtotal on the last
// row), which the reverse sums in row order turn into dw = (sum_{t >= s}
// dcum_t + sum_{t > s} dce_t) ld_s. Every exponent is <= 0, in the
// forward's log-difference form (an exp(+cum) factorisation would overflow).
//
// Two paths, chosen by the inputs' type.
//
// Bound on an H100 at rwkv6-1.6b's training shape (B 8, T 512, H 32, K = V
// = 64, bf16): the kernel reads r, k, v, do (bf16), w and the chunk states
// (f32) and writes dr, dk, dv (bf16), dw and dstate: about 0.21 GB, 0.063
// ms at 3.35 TB/s; chip_smoke.py counts the products and the gate's
// exponentials from the call's shapes.
//
// bf16, on the tensor cores. The first version (kept below for float32) ran
// at 41x that bound: the gate's exponentials pair by pair three times (A, dr
// and dk) over the whole lower triangle x K, every product on the CUDA
// cores, a 155 KB working set (one block an SM), and dS read back from the
// dstate output every chunk. This path:
//  - one block of 8 warps per (head, batch), walking the chunks in reverse
//    from the forward's chunk states. r, k, v, do, and w and S0 (f32) arrive
//    by cp.async; rows past the chunk and columns past K or V arrive as
//    zeros (any chunk <= 64, any K, V <= 128 in 64-row, 16-padded tiles).
//    The log-decays -exp(w) (every thread), then their sums down each key
//    column in row order (one thread a key) and ce = cum - ld as the
//    forward forms them; S0's split written once a chunk;
//  - the gate by 16-token sub-chunks. Only the diagonal 16 x 16 blocks
//    compute the gate's exponentials pair by pair, on the CUDA cores: A's
//    pairs as the forward does (each warp over half of the keys, the halves
//    added in order), and, a lane a key, dr's and dk's gate terms and du's
//    diagonal terms (each pair's exponential once for both). Below the
//    diagonal the gate exp(ce_t - cum_s) is exp(ce_t - cum_b) exp(cum_b -
//    cum_s) for any b with s <= b < t, both exponents <= 0 (the
//    log-difference form; an exp(+cum) form would overflow), so r and k
//    rescaled by the two factors turn each block into one tensor-core
//    product: dr's term is exp(ce_t - cum_b) (dA.k') with b = 16 m - 1,
//    the token before t's sub-chunk m; A^T = k'.r'^T and dk's term
//    exp(cum_b - cum_s) (dA^T.r') with b = 16 (i + 1) - 1, the last token of
//    s's sub-chunk i (k' = k exp(cum_b - cum_s), r' = r exp(ce_t - cum_b)).
//    The factors are per element, not per pair: 4x fewer exponentials than
//    the three sweeps, and the three sweeps are products;
//  - every product is mma.sync m16n8k16 fed by ldmatrix: dA = do.v^T (warps
//    0-3, rows t) and v.do^T (warps 4-7, rows s: dA^T), the blocks below the
//    diagonal above, dv = (k ex).dS + A^T.do, do.S0^T for dr, v.dS^T for dk,
//    and the state's update (r exp(ce))^T.do. Warps 0-3 finish dr and ce's
//    cotangent, warps 4-7 A^T, dv, dk, cum's cotangent and the per-key sums
//    of Y;
//  - dS lives in registers as the accumulators of its own update, panels of
//    16 keys x 32 columns over the 8 warps, its bf16 split in shared memory
//    for the next chunk's (k ex).dS and v.dS^T; dstate is written once;
//  - the key columns' sums and the reverse sums for dw in row order, one
//    thread a key; du per (batch, head), the sub-chunks' sums added in
//    order, the batch rows' partials summed by the wrapper: two calls give
//    equal bits.
// The card is not filled twice: shared memory takes 207 KB at K = V = 64
// (w and S0 staged, cum, ce and the exchange tiles of the diagonal terms
// and the cotangents of ce and cum) and the registers 255 a thread, so one
// block an SM: 256 blocks on 132 SMs, nearly two full waves. Past 227 KB
// (K = V = 128) w and S0 are read from global memory and the f32 tiles
// live in a global scratch of four tiles a block (the wrapper's
// bwd_scratch_floats). The split: r, k, v and do are bf16 inputs and enter
// exactly, as one term; A, dA, dS, S0 and the rescaled r and k are f32 and
// enter as three bf16 terms, of two split sides the six with i + j < 3.
// Why three: emulated on the CPU (`PYTHONPATH=src:. python
// tests/test_torch_scan_design.py`; bf16 inputs at 2x192x3x16x24), the
// gradients lie beyond chip_smoke.SCAN_BWD_TOL (bf16 2e-5, f32 2e-4 of the
// largest value) with one term: bf16 9.95e-4, 4.52e-4 and 1.92e-3, f32
// 4.60e-3, 2.75e-2 and 2.44e-3 at w ~ N(-0.5, 0.5), N(1.5, 0.5) and N(-6,
// 0.5); with two: bf16 8.5e-7, 7.2e-8, 7.1e-7, f32 9.3e-6, 5.3e-5, 3.3e-6;
// with three: 1.5e-7, 1.9e-9, 0 and 1.7e-6, 4.9e-5, 3.1e-7. Two pass this
// criterion; the kernel keeps the forward's three.
//
// float32, on the CUDA cores (the first version, kept for the parity
// phases), all math in f32. One block of 256 threads per (head, batch),
// walking its chunks in reverse. The gate's exponentials are computed pair
// by pair in registers, as in the forward, for A, dr and dk in turn: the
// (C, C, K) tile never exists. The block's working set is the chunk's r, k,
// v, do, cum, ce and dce, A and dA (f32, rows padded to an odd length; k's
// room takes dcum once dk is done): 155 KB at K = V = 64, one block an SM,
// in shared memory up to 227 KB and otherwise in a global scratch of one
// working set a block (K = V = 128). The entering state is read from the
// forward's chunk states and the carried dS lives in the dstate output
// itself (L1 and L2). The products run as register tiles, the 256 threads
// a 16 x 16 grid, each owning a 4 x 4 tile of a 64 x 64 output; the sums
// down key columns run one thread a column, in row order. du is written per
// (batch, head), (B, H, K) f32 partials, and the wrapper sums them over the
// batch. Inside a block du's diagonal terms are summed one thread a key in
// row order and the column sums of Y go through 16 row partials added in
// order.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using tiles::from_f32;
using tiles::kFull;
using tiles::kThreads;
using tiles::row_sum16;
using tiles::tile_prod;
using tiles::to_f32;

constexpr int kMaxChunk = 64;
constexpr int kMaxSmem = 227 * 1024;    // the most a block may opt in to (H100)

// A block's working set, floats: r, k (then dcum), cum, ce and dce (chunk x
// (K + 1)), v and do (chunk x (V + 1)), A and dA (chunk x (chunk + 1)), u,
// du's sums and dtotal (K each), the 16 x 64 column partials. The wrapper's
// ``bwd_block_floats`` is the same count.
struct Layout {
  int KP, VP, CP;
  int rs, ks, cm, ce, dce, vs, dos, am, da, us, du, dtot, colpart, floats;
  __host__ __device__ Layout(int K, int V, int c) {
    KP = K + 1;
    VP = V + 1;
    CP = c + 1;
    rs = 0;
    ks = rs + c * KP;
    cm = ks + c * KP;
    ce = cm + c * KP;
    dce = ce + c * KP;
    vs = dce + c * KP;
    dos = vs + c * VP;
    am = dos + c * VP;
    da = am + c * CP;
    us = da + c * CP;
    du = us + K;
    dtot = du + K;
    colpart = dtot + K;
    floats = colpart + 16 * 64;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const T* __restrict__ u,
               const float* __restrict__ states, const T* __restrict__ dout,
               const float* __restrict__ ds_out, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
               float* dstate, float* scratch, int Tn, int H, int K, int V, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(K, V, chunk);
  const int h = blockIdx.x;
  const long b = blockIdx.y;
  float* ws = scratch ? scratch + (b * H + h) * static_cast<long>(L.floats) : smem;
  const int KP = L.KP, VP = L.VP, CP = L.CP;
  float* rs = ws + L.rs;
  float* ks = ws + L.ks;                // k, then dcum once dk is done
  float* cm = ws + L.cm;                // -exp(w), then its inclusive sums
  float* ce = ws + L.ce;
  float* dce = ws + L.dce;
  float* vs = ws + L.vs;
  float* dos = ws + L.dos;
  float* Am = ws + L.am;
  float* dA = ws + L.da;
  float* us = ws + L.us;
  float* du = ws + L.du;
  float* dtot = ws + L.dtot;
  float* colpart = ws + L.colpart;      // [16][64]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nchunks = Tn / chunk;
  const long KV = static_cast<long>(K) * V;
  float* dS = dstate + (b * H + h) * KV;   // the carried cotangent, in place
  for (long i = tid; i < KV; i += kThreads) dS[i] = ds_out ? ds_out[(b * H + h) * KV + i] : 0.f;
  for (int i = tid; i < K; i += kThreads) {
    us[i] = to_f32(u[h * K + i]);
    du[i] = 0.f;
  }
  const float* tot = cm + (chunk - 1) * KP;   // the chunk's total log-decay

  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int t0 = ci * chunk;
    const float* S0 = states + ((b * H + h) * nchunks + ci) * KV;
    __syncthreads();                    // the last chunk's readers are done
    for (int i = tid; i < chunk * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const long gi = ((b * Tn + t0 + t) * H + h) * K + c;
      rs[t * KP + c] = to_f32(r[gi]);
      ks[t * KP + c] = to_f32(k[gi]);
      cm[t * KP + c] = -expf(w[gi]);
    }
    for (int i = tid; i < chunk * V; i += kThreads) {
      const int t = i / V, c = i % V;
      const long gi = ((b * Tn + t0 + t) * H + h) * V + c;
      vs[t * VP + c] = to_f32(v[gi]);
      dos[t * VP + c] = to_f32(dout[gi]);
    }
    __syncthreads();
    for (int c = tid; c < K; c += kThreads) {   // sums down each key column, in row order
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float ld = cm[t * KP + c];
        run += ld;
        cm[t * KP + c] = run;
        ce[t * KP + c] = run - ld;
      }
    }
    __syncthreads();

    // dA = do.v^T (s <= t) and A: the gate's exponentials pair by pair,
    // blocks above the diagonal skipped at compile time, then the bonus
    {
      float acc[4][4] = {};
      tile_prod(acc, V, 0, 0, chunk, chunk, [&](int m, int j) { return dos[m * VP + j]; },
                [&](int j, int n) { return vs[n * VP + j]; });
      float ag[4][4] = {};
      const bool below = tx < ty;
      for (int c = 0; c < K; ++c) {
        float rt[4], et[4], kk[4], cs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = min(ty + 16 * i, chunk - 1), s = min(tx + 16 * i, chunk - 1);
          rt[i] = rs[t * KP + c];
          et[i] = ce[t * KP + c];
          kk[i] = ks[s * KP + c];
          cs[i] = cm[s * KP + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < i; ++j) ag[i][j] += rt[i] * kk[j] * __expf(fminf(et[i] - cs[j], 0.f));
          if (below) ag[i][i] += rt[i] * kk[i] * __expf(fminf(et[i] - cs[i], 0.f));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          if (t < chunk && s < chunk) {
            dA[t * CP + s] = s <= t ? acc[i][j] : 0.f;
            Am[t * CP + s] = s < t ? ag[i][j] : 0.f;
          }
        }
    }
    __syncthreads();
    for (int t = tid; t < chunk; t += kThreads) {
      float d = 0.f;
      for (int c = 0; c < K; ++c) d += rs[t * KP + c] * us[c] * ks[t * KP + c];
      Am[t * CP + t] = d;
    }
    __syncthreads();

    // dv = A^T.do + (k ex).dS; du's diagonal terms, one thread a key
    for (int j0 = 0; j0 < V; j0 += 64) {
      float acc[4][4] = {}, kd[4][4] = {};
      tile_prod(acc, chunk, 0, j0, chunk, V, [&](int m, int t) { return Am[t * CP + m]; },
                [&](int t, int n) { return dos[t * VP + n]; });
      tile_prod(kd, K, 0, j0, chunk, V,
                [&](int m, int c) {
                  return ks[m * KP + c] * expf(fminf(tot[c] - cm[m * KP + c], 0.f));
                },
                [&](int c, int n) { return dS[static_cast<long>(c) * V + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = ty + 16 * i, n = j0 + tx + 16 * j;
          if (s < chunk && n < V)
            dv[((b * Tn + t0 + s) * H + h) * V + n] = from_f32<T>(acc[i][j] + kd[i][j]);
        }
    }
    for (int c = tid; c < K; c += kThreads) {
      float d = du[c];
      for (int t = 0; t < chunk; ++t) d += dA[t * CP + t] * rs[t * KP + c] * ks[t * KP + c];
      du[c] = d;
    }

    // dr = dA_tt u k + sum_{s < t} dA E k + exp(ce) (do.S0^T), and dce
    for (int c0 = 0; c0 < K; c0 += 64) {
      float gsum[4][4] = {}, ds0[4][4] = {}, et[4][4];
      int tr[4], cc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = min(ty + 16 * i, chunk - 1);
        cc[i] = min(c0 + tx + 16 * i, K - 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) et[i][j] = ce[tr[i] * KP + cc[j]];
      const int s_end = min(chunk, ty + 48);     // s < t <= ty + 48
      for (int s = 0; s < s_end; ++s) {
        float da[4], kk[4], cs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[i] = dA[tr[i] * CP + s];
          kk[i] = ks[s * KP + cc[i]];
          cs[i] = cm[s * KP + cc[i]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (s < ty + 16 * i)
              gsum[i][j] += da[i] * kk[j] * __expf(fminf(et[i][j] - cs[j], 0.f));
      }
      tile_prod(ds0, V, 0, c0, chunk, K, [&](int m, int j) { return dos[m * VP + j]; },
                [&](int j, int n) { return S0[static_cast<long>(n) * V + j]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, c = c0 + tx + 16 * j;
          if (t < chunk && c < K) {
            const float e = expf(et[i][j]) * ds0[i][j];
            dr[((b * Tn + t0 + t) * H + h) * K + c] =
                from_f32<T>(dA[t * CP + t] * us[c] * ks[t * KP + c] + gsum[i][j] + e);
            dce[t * KP + c] = rs[t * KP + c] * (gsum[i][j] + e);
          }
        }
    }
    __syncthreads();                    // every reader of k is done

    // dk = dA_ss u r + sum_{t > s} dA E r + ex (v.dS^T); dcum into k's room
    for (int c0 = 0; c0 < K; c0 += 64) {
      float gsum[4][4] = {}, vds[4][4] = {}, cs[4][4];
      int sr[4], cc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sr[i] = min(ty + 16 * i, chunk - 1);
        cc[i] = min(c0 + tx + 16 * i, K - 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[i][j] = cm[sr[i] * KP + cc[j]];
      for (int t = ty + 1; t < chunk; ++t) {     // t > s >= ty
        float da[4], rr[4], et[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[i] = dA[t * CP + sr[i]];
          rr[i] = rs[t * KP + cc[i]];
          et[i] = ce[t * KP + cc[i]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t > ty + 16 * i)
              gsum[i][j] += da[i] * rr[j] * __expf(fminf(et[j] - cs[i][j], 0.f));
      }
      tile_prod(vds, V, 0, c0, chunk, K, [&](int m, int j) { return vs[m * VP + j]; },
                [&](int j, int n) { return dS[static_cast<long>(n) * V + j]; });
      float cy[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = ty + 16 * i, c = c0 + tx + 16 * j;
          if (s < chunk && c < K) {
            const float kk = ks[s * KP + c];
            const float e = expf(fminf(tot[c] - cs[i][j], 0.f));
            dk[((b * Tn + t0 + s) * H + h) * K + c] =
                from_f32<T>(dA[s * CP + s] * us[c] * rs[s * KP + c] + gsum[i][j] + e * vds[i][j]);
            const float y = kk * e * vds[i][j];
            cy[j] += y;
            ks[s * KP + c] = -kk * gsum[i][j] - y;
          }
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) colpart[ty * 64 + tx + 16 * j] = cy[j];
      __syncthreads();
      if (tid < 64 && c0 + tid < K) {
        float y = 0.f;
        for (int gi = 0; gi < 16; ++gi) y += colpart[gi * 64 + tid];
        dtot[c0 + tid] = y;
      }
      __syncthreads();
    }
    for (int i = tid; i < chunk * K; i += kThreads) {   // r <- r exp(ce)
      const int t = i / K, c = i % K;
      rs[t * KP + c] *= expf(ce[t * KP + c]);
    }
    __syncthreads();

    // dS <- exp(total) dS + (r exp(ce))^T.do, and dtotal += exp(total) sum_v dS S0
    for (int c0 = 0; c0 < K; c0 += 64) {
      float rowp[4] = {};
      for (int j0 = 0; j0 < V; j0 += 64) {
        float acc[4][4] = {};
        tile_prod(acc, chunk, c0, j0, K, V, [&](int m, int t) { return rs[t * KP + m]; },
                  [&](int t, int n) { return dos[t * VP + n]; });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + ty + 16 * i, n = j0 + tx + 16 * j;
            if (c < K && n < V) {
              const long e = static_cast<long>(c) * V + n;
              const float old = dS[e];
              rowp[i] += old * S0[e];
              dS[e] = expf(tot[c]) * old + acc[i][j];
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + ty + 16 * i;
        const float s = row_sum16(rowp[i]);
        if (tx == 0 && c < K) dtot[c] += expf(tot[c]) * s;
      }
    }
    __syncthreads();

    // one thread a key column, rows in reverse: dw = (sum_{t >= s} dcum_t +
    // sum_{t > s} dce_t) ld_s
    for (int c = tid; c < K; c += kThreads) {
      float run_c = dtot[c], run_e = 0.f;
      for (int s = chunk - 1; s >= 0; --s) {
        run_c += ks[s * KP + c];
        const long gi = ((b * Tn + t0 + s) * H + h) * K + c;
        dw[gi] = (run_c + run_e) * -expf(w[gi]);
        run_e += dce[s * KP + c];
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < K; c += kThreads) du_part[(b * H + h) * K + c] = du[c];
}

template <typename E>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* states, const void* dout, const float* ds_out, void* dr, void* dk,
           void* dv, float* dw, float* du_part, float* dstate, float* scratch,
           long long scratch_floats, int B, int T, int H, int K, int V, int chunk,
           cudaStream_t stream) {
  const Layout L(K, V, chunk);
  const size_t need = L.floats * sizeof(float);
  size_t bytes = need;
  float* global = nullptr;
  if (need > static_cast<size_t>(kMaxSmem)) {    // the working sets in global memory
    if (scratch_floats < static_cast<long long>(B) * H * L.floats)
      return static_cast<int>(cudaErrorInvalidValue);
    global = scratch;
    bytes = 0;
  }
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<E><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const E*>(r), static_cast<const E*>(k), static_cast<const E*>(v), w,
      static_cast<const E*>(u), states, static_cast<const E*>(dout), ds_out,
      static_cast<E*>(dr), static_cast<E*>(dk), static_cast<E*>(dv), dw, du_part, dstate,
      global, T, H, K, V, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBwThreads = 256;   // 8 warps: warp w owns sub-chunk w % 4 (16 tokens)
constexpr int kTile = 64;         // rows of a chunk's tiles: a chunk <= 64, zeros past it
constexpr int kSub = 16;          // the sub-chunk

// Byte offsets into dynamic shared memory: the chunk's r, k (kTile x Kp), v
// and do (kTile x Vp), and, where ``staged``, its w (kTile x Kp f32) and f32
// entering state S0 (Kp x Vp); dS and, where ``staged``, S0 as three bf16
// terms (Kp x Vp); u, dA's diagonal and its 16 x 16 blocks, the key halves'
// A there, the per-key partials of dtotal; and, where ``f32_smem``, the
// log-decay sums cum and ce and the exchange tiles Dr and Dk (kTile x Kp
// f32 each), else in the block's global scratch. The first of (staged, in
// shared memory), (not staged, in shared memory), (neither) that fits: the
// first at K = V = 64 (207 KB), the last at K = V = 128. bf16 rows are
// padded by 8 (16 bytes), f32 rows by 4.
struct BwdLayout {
  int KS, VS, WS, SV;
  bool staged, f32_smem;
  int r, k, v, dout, wt, s0, ds, ys, u, dat, dad, apart, dtp, ycol, cum, ce, dr, dk, bytes;
  __host__ __device__ BwdLayout(int Kp, int Vp) {
    KS = Kp + 8;
    VS = Vp + 8;
    WS = Kp + 4;
    SV = Vp + 4;
    for (int form = 0; form < 3; ++form) {
      staged = form == 0;
      f32_smem = form < 2;
      r = 0;
      k = r + kTile * KS * 2;
      v = k + kTile * KS * 2;
      dout = v + kTile * VS * 2;
      wt = dout + kTile * VS * 2;
      s0 = wt + (staged ? kTile * WS * 4 : 0);
      ds = s0 + (staged ? Kp * SV * 4 : 0);
      ys = ds + 3 * Kp * VS * 2;
      u = ys + (staged ? 3 * Kp * VS * 2 : 0);
      dat = u + Kp * 4;
      dad = dat + kTile * 4;
      apart = dad + 4 * kSub * kSub * 4;
      dtp = apart + 2 * 4 * kSub * kSub * 4;
      ycol = dtp + 4 * Kp * 4;
      cum = ycol + 4 * Kp * 4;
      ce = cum + kTile * WS * 4;
      dr = ce + kTile * WS * 4;
      dk = dr + kTile * WS * 4;
      bytes = f32_smem ? dk + kTile * WS * 4 : cum;
      if (bytes <= kMaxSmem) break;
    }
  }
  // floats of a block's global scratch: cum, ce, and dr's and dk's diagonal
  // gate terms (then ce's and cum's cotangents), kTile x WS each, where
  // shared memory does not hold them. The wrapper's ``bwd_scratch_floats``
  // is the same count.
  __host__ __device__ int scratch_floats() const { return f32_smem ? 0 : 4 * kTile * WS; }
};

// One block of 8 warps per (head, batch), walking its chunks in reverse. K
// and V are multiples of 8 (the wrapper pads them); Kp, Vp are K, V rounded
// up to 16. Warp w < 4 takes rows t of sub-chunk w in the row form (dA =
// do.v^T, then dr), warp w >= 4 rows s of sub-chunk w - 4 in the column
// form (v.do^T, A^T, then dv and dk); all 8 sweep the diagonal 16 x 16
// blocks, warp w over sub-chunk w % 4 and half w / 4 of the keys, a lane a
// key. The carried dS lives in registers as panels of 16 keys x 32 columns,
// panel w + 8 i in warp w (PW panels a warp at most), and as its split in
// shared memory.
template <int PW>
__global__ void __launch_bounds__(kBwThreads, 1)
wkv_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                    const __nv_bfloat16* __restrict__ u, const float* __restrict__ states,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ ds_out,
                    __nv_bfloat16* __restrict__ dr, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ du_part, float* __restrict__ dstate, float* scratch,
                    int Tn, int H, int K, int V, int chunk) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* smem = smem_bytes;
  const int Kp = (K + 15) & ~15, Vp = (V + 15) & ~15;
  const BwdLayout L(Kp, Vp);
  const int KS = L.KS, VS = L.VS, WS = L.WS;
  const int h = blockIdx.x;
  const long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int i = warp & 3, half = warp >> 2;
  const int nchunks = Tn / chunk;
  const long KV = static_cast<long>(K) * V, bh = b * H + h;
  const uint32_t r_u = mma::smem_u32(smem + L.r), k_u = mma::smem_u32(smem + L.k);
  const uint32_t v_u = mma::smem_u32(smem + L.v), do_u = mma::smem_u32(smem + L.dout);
  const uint32_t ds_u = mma::smem_u32(smem + L.ds);
  const int ds_term = Kp * VS * 2;      // bytes from one split term to the next
  const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(smem + L.r);
  const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* dsh = reinterpret_cast<__nv_bfloat16*>(smem + L.ds);
  float* ws = scratch + bh * static_cast<long>(L.scratch_floats());
  auto f32_tile = [&](int off, int n) {
    return L.f32_smem ? reinterpret_cast<float*>(smem + off) : ws + n * kTile * WS;
  };
  float* cum = f32_tile(L.cum, 0);
  float* ce = f32_tile(L.ce, 1);
  float* Dr = f32_tile(L.dr, 2);        // dr's diagonal gate term, then dce
  float* Dk = f32_tile(L.dk, 3);        // dk's diagonal gate term, then dcum
  const float* wts = reinterpret_cast<const float*>(smem + L.wt);    // staged w
  const float* S0s = reinterpret_cast<const float*>(smem + L.s0);    // staged S0
  const uint32_t ys_u = mma::smem_u32(smem + L.ys);
  __nv_bfloat16* ysh = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);
  const int SV = L.SV;
  float* us = reinterpret_cast<float*>(smem + L.u);
  float* dAt = reinterpret_cast<float*>(smem + L.dat);  // dA[t, t]
  float* dAd = reinterpret_cast<float*>(smem + L.dad);  // [4][16][16] dA's diagonal blocks
  float* Ap = reinterpret_cast<float*>(smem + L.apart); // [2][4][16][16] the halves' A there
  float* dtp = reinterpret_cast<float*>(smem + L.dtp);  // [4][Kp] sum_v dS S0, by 32 columns
  float* ycol = reinterpret_cast<float*>(smem + L.ycol);// [4][Kp] sum_s Y, by sub-chunk
  const float* tot = cum + (chunk - 1) * WS;

  for (int c = tid; c < Kp; c += kBwThreads) us[c] = c < K ? __bfloat162float(u[h * K + c]) : 0.f;

  // the chunk at t0: r, k, v, do and (where staged) w and S0; rows past the
  // chunk and columns past K or V arrive as zeros
  auto load = [&](int t0, const float* S0g) {
    const long roff = ((b * Tn + t0) * H + h) * K, rrow = static_cast<long>(H) * K;
    for (mma::Steps2 it(tid, kBwThreads, Kp / 8); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      const bool ok = t < chunk && 8 * c < K;
      const long off = ok ? roff + t * rrow + 8 * c : 0;
      mma::cp16(r_u + (t * KS + 8 * c) * 2, r + off, ok);
      mma::cp16(k_u + (t * KS + 8 * c) * 2, k + off, ok);
    }
    const long voff = ((b * Tn + t0) * H + h) * V, vrow = static_cast<long>(H) * V;
    for (mma::Steps2 it(tid, kBwThreads, Vp / 8); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      const bool ok = t < chunk && 8 * c < V;
      const long off = ok ? voff + t * vrow + 8 * c : 0;
      mma::cp16(v_u + (t * VS + 8 * c) * 2, v + off, ok);
      mma::cp16(do_u + (t * VS + 8 * c) * 2, dout + off, ok);
    }
    if (!L.staged) return;
    const uint32_t w_u = mma::smem_u32(smem + L.wt), s0_u = mma::smem_u32(smem + L.s0);
    for (mma::Steps2 it(tid, kBwThreads, Kp / 4); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      const bool ok = t < chunk && 4 * c < K;
      mma::cp16(w_u + (t * WS + 4 * c) * 4, ok ? w + roff + t * rrow + 4 * c : w, ok);
    }
    for (mma::Steps2 it(tid, kBwThreads, Vp / 4); it.r < Kp; it.next()) {
      const int key = it.r, c = it.c;
      const bool ok = key < K && 4 * c < V;
      mma::cp16(s0_u + (key * SV + 4 * c) * 4, ok ? S0g + key * V + 4 * c : S0g, ok);
    }
  };
  auto bf = [](const __nv_bfloat16* p) { return __bfloat162float(*p); };

  // dS's panels: element [ii][nt][2 hf + e] is key 16 prow + g + 8 hf,
  // column 32 pcol + 8 nt + 2q + e
  const int npc = (Vp + 31) / 32, npanels = (Kp / 16) * npc;
  float st[PW][4][4];
#pragma unroll
  for (int ii = 0; ii < PW; ++ii) {
    const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = 16 * prow + g + 8 * hf, c = 32 * pcol + 8 * nt + 2 * q;
        float2 x = make_float2(0.f, 0.f);
        if (ds_out && pi < npanels && key < K && c < V)
          x = *reinterpret_cast<const float2*>(ds_out + bh * KV + static_cast<long>(key) * V + c);
        st[ii][nt][2 * hf] = x.x;
        st[ii][nt][2 * hf + 1] = x.y;
      }
  }
  // dS as three bf16 terms in shared memory, rows key, for (k ex).dS and v.dS^T
  auto write_split = [&]() {
#pragma unroll
    for (int ii = 0; ii < PW; ++ii) {
      const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
      if (pi >= npanels) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * pcol + 8 * nt + 2 * q;
        if (c >= Vp) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = (16 * prow + g + 8 * hf) * VS + c;
          uint32_t t0, t1, t2;
          mma::split3(st[ii][nt][2 * hf], st[ii][nt][2 * hf + 1], t0, t1, t2);
          *reinterpret_cast<uint32_t*>(dsh + e) = t0;
          *reinterpret_cast<uint32_t*>(dsh + ds_term / 2 + e) = t1;
          *reinterpret_cast<uint32_t*>(dsh + ds_term + e) = t2;
        }
      }
    }
  };
  // the three terms of a B fragment pair x (registers 0, 1 or 2, 3)
  auto terms = [](const uint32_t (&t)[3][4], int x, uint32_t (&out)[3]) {
#pragma unroll
    for (int term = 0; term < 3; ++term) out[term] = t[term][x];
  };
  auto mma6p = [&](float (&acc0)[4], float (&acc1)[4], const uint32_t (&a)[3][4],
                   const uint32_t (&bt)[3][4]) {
    uint32_t b0[3], b1[3], b2[3], b3[3];
    terms(bt, 0, b0);
    terms(bt, 1, b1);
    terms(bt, 2, b2);
    terms(bt, 3, b3);
    mma::mma6(acc0, a, b0, b1);
    mma::mma6(acc1, a, b2, b3);
  };

  float du_acc[2] = {0.f, 0.f};         // the sweep's keys: sum dA_tt r_t k_t
  write_split();
  for (int kk = 0; kk < nchunks; ++kk) {
    const int ci = nchunks - 1 - kk, t0 = ci * chunk;
    const float* S0 = states + (bh * nchunks + ci) * KV;
    // w[t, c] of this chunk: the staged tile, or global memory
    auto wv = [&](int t, int c) {
      return L.staged ? wts[t * WS + c] : w[((b * Tn + t0 + t) * H + h) * K + c];
    };
    // S0[key, v..v+1]: the staged tile, or global memory
    auto s0v = [&](int key, int vv) {
      return L.staged ? *reinterpret_cast<const float2*>(S0s + key * SV + vv)
                      : *reinterpret_cast<const float2*>(S0 + static_cast<long>(key) * V + vv);
    };
    __syncthreads();                    // the last chunk's readers are done
    load(t0, S0);
    mma::cp_commit();
    mma::cp_wait<0>();
    __syncthreads();
    if (L.staged)                       // S0 as three bf16 terms, rows key, for do.S0^T
      for (mma::Steps2 it(tid, kBwThreads, Vp / 2); it.r < Kp; it.next()) {
        const int key = it.r, vv = 2 * it.c;
        const float2 x2 = s0v(key, vv);
        uint32_t y0, y1, y2;
        mma::split3(x2.x, x2.y, y0, y1, y2);
        const int e = key * VS + vv;
        *reinterpret_cast<uint32_t*>(ysh + e) = y0;
        *reinterpret_cast<uint32_t*>(ysh + ds_term / 2 + e) = y1;
        *reinterpret_cast<uint32_t*>(ysh + ds_term + e) = y2;
      }
    // the log-decays -exp(w) (every thread), then their sums down each key
    // column in row order, one thread a column, and ce = cum - ld as the
    // forward forms them (cum in place of the log-decays)
    for (mma::Steps2 it(tid, kBwThreads, Kp); it.r < kTile; it.next()) {
      const int t = it.r, c = it.c;
      cum[t * WS + c] = t < chunk && c < K ? -expf(wv(t, c)) : 0.f;
    }
    __syncthreads();
    for (int c = tid; c < Kp; c += kBwThreads) {
      float run = 0.f;
#pragma unroll
      for (int tb = 0; tb < kTile; tb += 16) {   // 16 loads in flight, then the sums
        float ld[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) ld[t] = cum[(tb + t) * WS + c];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          run += ld[t];
          cum[(tb + t) * WS + c] = run;
          ce[(tb + t) * WS + c] = run - ld[t];
        }
      }
    }
    __syncthreads();

    // dA's diagonal blocks (do.v^T, rows t of sub-chunk i, blocks s = t),
    // for the sweep: the row-form warps
    if (half == 0) {
      float dd[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dd[nt][e] = 0.f;
#pragma unroll 1
      for (int kv = 0; kv < 8; ++kv) {
        if (16 * kv >= Vp) continue;
        uint32_t af[4], bfr[4];
        mma::frag_a(af, do_u, VS, 16 * i, 16 * kv);
        mma::frag_b(bfr, v_u, VS, 16 * i, 16 * kv);
        mma::mma16816(dd[0], af, bfr[0], bfr[1]);
        mma::mma16816(dd[1], af, bfr[2], bfr[3]);
      }
#pragma unroll
      for (int hf2 = 0; hf2 < 2; ++hf2)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = g + 8 * (e >> 1), sl = 8 * hf2 + 2 * q + (e & 1);
          dAd[(i * kSub + tl) * kSub + sl] = dd[hf2][e];
          if (tl == sl) dAt[16 * i + tl] = dd[hf2][e];
        }
    }
    __syncthreads();

    // A's diagonal blocks pair by pair, as the forward: warp w over
    // sub-chunk i and half w / 4 of the keys; this thread's candidates
    // (t_lo, sa), (t_lo, sa + 1), (t_hi, sa), (t_hi, sa + 1), (t_hi, sa + 8),
    // (t_hi, sa + 9); the half's partial A to shared memory
    {
      const int t_lo = 16 * i + g, t_hi = t_lo + 8, sa = 16 * i + 2 * q, c_lo = half * (Kp / 2);
      float e1 = 0.f, e2 = 0.f, e3 = 0.f, e4 = 0.f, e5 = 0.f, e6 = 0.f, bl = 0.f, bh = 0.f;
      const bool lo_even = g == 2 * q;  // t_lo = sa (else, on the diagonal, sa + 1)
      auto bf4 = [](const __nv_bfloat16* p) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo = mma::unpack(raw.x), hi = mma::unpack(raw.y);
        return make_float4(lo.x, lo.y, hi.x, hi.y);
      };
      auto f4 = [](const float* p) { return *reinterpret_cast<const float4*>(p); };
      auto gsum = [](float4 r4, float4 k4, float4 e4v, float4 c4) {
        return r4.x * k4.x * __expf(fminf(e4v.x - c4.x, 0.f)) +
               r4.y * k4.y * __expf(fminf(e4v.y - c4.y, 0.f)) +
               r4.z * k4.z * __expf(fminf(e4v.z - c4.z, 0.f)) +
               r4.w * k4.w * __expf(fminf(e4v.w - c4.w, 0.f));
      };
      auto dot3 = [](float4 r4, float4 u4, float4 k4) {
        return r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z + r4.w * u4.w * k4.w;
      };
      for (int c = c_lo; c < c_lo + Kp / 2; c += 4) {
        const float4 rl = bf4(rs + t_lo * KS + c), rh = bf4(rs + t_hi * KS + c);
        const float4 cel = f4(ce + t_lo * WS + c), ceh = f4(ce + t_hi * WS + c);
        const float4 ka = bf4(ks + sa * KS + c), kb = bf4(ks + (sa + 1) * KS + c);
        const float4 kc = bf4(ks + (sa + 8) * KS + c), kd = bf4(ks + (sa + 9) * KS + c);
        const float4 ca = f4(cum + sa * WS + c), cb = f4(cum + (sa + 1) * WS + c);
        const float4 cc = f4(cum + (sa + 8) * WS + c), cd = f4(cum + (sa + 9) * WS + c);
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
      float* ap = Ap + (half * 4 + i) * kSub * kSub;
      ap[g * kSub + 2 * q] = gq > 0 ? e1 : gq == 0 ? bl : 0.f;
      ap[g * kSub + 2 * q + 1] = gq > 1 ? e2 : gq == 1 ? bl : 0.f;
      ap[(g + 8) * kSub + 2 * q] = e3;
      ap[(g + 8) * kSub + 2 * q + 1] = e4;
      ap[(g + 8) * kSub + 2 * q + 8] = gq > 0 ? e5 : gq == 0 ? bh : 0.f;
      ap[(g + 8) * kSub + 2 * q + 9] = gq > 1 ? e6 : gq == 1 ? bh : 0.f;
      ap[g * kSub + 2 * q + 8] = 0.f;   // above the diagonal
      ap[g * kSub + 2 * q + 9] = 0.f;
    }

    // the sweep of the diagonal blocks: warp w over sub-chunk i and half of
    // the keys, a lane a key; the gate's exponentials of the pairs s < t in
    // the block, for dr's and dk's gate terms; du's diagonal terms
    {
      const int hk = Kp / 2, t16 = kSub * i;
#pragma unroll 1
      for (int rep = 0; rep * 32 < hk; ++rep) {   // Kp / 2 <= 64 keys: two a lane at most
        const int c = half * hk + rep * 32 + lane;
        const bool live = rep * 32 + lane < hk;
        const int cc = live ? c : half * hk;
        float rt[kSub], kt[kSub], et[kSub], cm[kSub], drg[kSub], dkg[kSub];
#pragma unroll
        for (int x = 0; x < kSub; ++x) {
          rt[x] = live ? bf(rs + (t16 + x) * KS + cc) : 0.f;
          kt[x] = live ? bf(ks + (t16 + x) * KS + cc) : 0.f;
          et[x] = ce[(t16 + x) * WS + cc];
          cm[x] = cum[(t16 + x) * WS + cc];
          drg[x] = dkg[x] = 0.f;
        }
        float dud = 0.f;
#pragma unroll
        for (int tt = 0; tt < kSub; ++tt) {
          dud += dAt[t16 + tt] * rt[tt] * kt[tt];
#pragma unroll
          for (int ss = 0; ss < tt; ++ss) {
            const float e = __expf(fminf(et[tt] - cm[ss], 0.f));
            const float d = dAd[(i * kSub + tt) * kSub + ss];
            drg[tt] += d * kt[ss] * e;
            dkg[ss] += d * rt[tt] * e;
          }
        }
        if (rep)
          du_acc[1] += dud;
        else
          du_acc[0] += dud;
        if (live)
#pragma unroll
          for (int x = 0; x < kSub; ++x) {
            Dr[(t16 + x) * WS + c] = drg[x];
            Dk[(t16 + x) * WS + c] = dkg[x];
          }
      }
    }
    __syncthreads();

    float dat[8][4];                    // row form: dA[t, s], s < 16 i; column form: v.do^T, t >= 16 (i + 1)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dat[nt][e] = 0.f;
#pragma unroll 1
    for (int kv = 0; kv < 8; ++kv) {
      if (16 * kv >= Vp) continue;
      uint32_t af[4];
      mma::frag_a(af, half ? v_u : do_u, VS, 16 * i, 16 * kv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (half ? j <= i : j >= i) continue;
        uint32_t bfr[4];
        mma::frag_b(bfr, half ? do_u : v_u, VS, 16 * j, 16 * kv);
        mma::mma16816(dat[2 * j], af, bfr[0], bfr[1]);
        mma::mma16816(dat[2 * j + 1], af, bfr[2], bfr[3]);
      }
    }
    if (half == 0) {
      // dr = dA_tt u k + (the sweep's and the blocks below's gate terms) +
      // exp(ce) (do.S0^T); dce = r (dr - dA_tt u k). Below the diagonal, s <
      // 16 i <= t, b = 16 i - 1: the gate term is exp(ce_t - cum_b) times
      // (dA . k'), k' = k exp(cum_b - cum_s), both factors <= 1
      const int t_lo = 16 * i + g, t_hi = t_lo + 8, bref = 16 * i - 1;
      for (int c0 = 0; c0 < Kp; c0 += 32) {   // 32 keys a pass
        const int npair = min(2, (Kp - c0) / 16);
        float acc[4][4], ds0[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = ds0[nt][e] = 0.f;
#pragma unroll 1
        for (int j = 0; j < i; ++j) {
          uint32_t da3[3][4];
          float d0[4], d1[4];
          mma::pick_tiles(d0, d1, dat, j);
          mma::c_to_a3(d0, d1, da3);
#pragma unroll
          for (int kp2 = 0; kp2 < 2; ++kp2) {
            if (kp2 >= npair) continue;
            uint32_t kr[4], kb3[3][4];
            mma::frag_bt(kr, k_u, KS, 16 * j, c0 + 16 * kp2);
            float lo[4], hi[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int s = 16 * j + 2 * q + 8 * (x & 1), key = c0 + 16 * kp2 + g + 8 * (x >> 1);
              const float cb = cum[bref * WS + key];
              const float2 kv = mma::unpack(kr[x]);
              lo[x] = kv.x * __expf(fminf(cb - cum[s * WS + key], 0.f));
              hi[x] = kv.y * __expf(fminf(cb - cum[(s + 1) * WS + key], 0.f));
            }
            mma::split3x4(lo, hi, kb3);
            mma6p(acc[2 * kp2], acc[2 * kp2 + 1], da3, kb3);
          }
        }
        // do.S0^T: S0 (k = v, n = key) from the forward's f32 chunk state, split
#pragma unroll 1
        for (int kv = 0; kv < 8; ++kv) {
          if (16 * kv >= Vp) continue;
          uint32_t af[4];
          mma::frag_a(af, do_u, VS, 16 * i, 16 * kv);
#pragma unroll
          for (int kp2 = 0; kp2 < 2; ++kp2) {
            if (kp2 >= npair) continue;
            uint32_t sb[3][4];
            if (L.staged) {
#pragma unroll
              for (int term = 0; term < 3; ++term)
                mma::frag_b(sb[term], ys_u + term * ds_term, VS, c0 + 16 * kp2, 16 * kv);
            } else {
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int vv = 16 * kv + 2 * q + 8 * (x & 1),
                          key = c0 + 16 * kp2 + g + 8 * (x >> 1);
                float2 s2 = make_float2(0.f, 0.f);
                if (key < K && vv < V) s2 = s0v(key, vv);
                mma::split3(s2.x, s2.y, sb[0][x], sb[1][x], sb[2][x]);
              }
            }
#pragma unroll
            for (int term = 2; term >= 0; --term) {
              mma::mma16816(ds0[2 * kp2], af, sb[term][0], sb[term][1]);
              mma::mma16816(ds0[2 * kp2 + 1], af, sb[term][2], sb[term][3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= 2 * npair) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = hf ? t_hi : t_lo, key = c0 + 8 * nt + 2 * q;
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kc = key + e;
              const float ce_t = ce[t * WS + kc];
              float gterm = acc[nt][2 * hf + e];
              if (i > 0) gterm *= __expf(fminf(ce_t - cum[bref * WS + kc], 0.f));
              const float tr = gterm + expf(ce_t) * ds0[nt][2 * hf + e];
              const float drd = Dr[t * WS + kc];
              o[e] = dAt[t] * us[kc] * bf(ks + t * KS + kc) + drd + tr;
              Dr[t * WS + kc] = bf(rs + t * KS + kc) * (drd + tr);
            }
            if (t < chunk && key < K)
              *reinterpret_cast<uint32_t*>(dr + ((b * Tn + t0 + t) * H + h) * K + key) =
                  mma::pack(o[0], o[1]);
          }
        }
      }
    } else {
      // the column form, rows s of sub-chunk i
      const int s_lo = 16 * i + g, s_hi = s_lo + 8;
      // A^T: the blocks t > s below the diagonal as k'.r'^T about b = 16 (i +
      // 1) - 1, the last token of this sub-chunk (s <= b < t): k' = k
      // exp(cum_b - cum_s) once a key step, r' = r exp(ce_t - cum_b) for each
      // later sub-chunk m; the diagonal block from the sweep's halves
      const int bs = 16 * i + 15;
      float at[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[nt][e] = 0.f;
      if (i < 3) {
#pragma unroll 1
        for (int kq = 0; kq < Kp / 16; ++kq) {
          uint32_t kr[4], ka3[3][4];
          mma::frag_a(kr, k_u, KS, 16 * i, 16 * kq);
          float lo[4], hi[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int s = 16 * i + g + 8 * (x & 1), key = 16 * kq + 2 * q + 8 * (x >> 1);
            const float2 kv = mma::unpack(kr[x]);
            lo[x] = kv.x * __expf(fminf(cum[bs * WS + key] - cum[s * WS + key], 0.f));
            hi[x] = kv.y * __expf(fminf(cum[bs * WS + key + 1] - cum[s * WS + key + 1], 0.f));
          }
          mma::split3x4(lo, hi, ka3);
#pragma unroll
          for (int m = 1; m < 4; ++m) {
            if (m <= i) continue;
            uint32_t rr[4], rb3[3][4];
            mma::frag_b(rr, r_u, KS, 16 * m, 16 * kq);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int key = 16 * kq + 2 * q + 8 * (x & 1), t = 16 * m + g + 8 * (x >> 1);
              const float2 rv = mma::unpack(rr[x]);
              lo[x] = rv.x * __expf(fminf(ce[t * WS + key] - cum[bs * WS + key], 0.f));
              hi[x] = rv.y * __expf(fminf(ce[t * WS + key + 1] - cum[bs * WS + key + 1], 0.f));
            }
            mma::split3x4(lo, hi, rb3);
            mma6p(at[2 * m], at[2 * m + 1], ka3, rb3);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m != i) continue;
#pragma unroll
        for (int hf2 = 0; hf2 < 2; ++hf2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sl = g + 8 * (e >> 1), tl = 8 * hf2 + 2 * q + (e & 1);
            const int o = (i * kSub + tl) * kSub + sl;
            at[2 * m + hf2][e] = tl >= sl ? Ap[o] + Ap[4 * kSub * kSub + o] : 0.f;
          }
      }
      // dv = A^T.do + (k ex).dS, ex = exp(min(total - cum_s, 0))
      for (int v0 = 0; v0 < Vp; v0 += 64) {
        const int npair = min(4, (Vp - v0) / 16);
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
        for (int kq = 0; kq < 8; ++kq) {
          if (16 * kq >= Kp) continue;
          uint32_t kr[4], ka3[3][4];
          mma::frag_a(kr, k_u, KS, 16 * i, 16 * kq);
          float lo[4], hi[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int s = 16 * i + g + 8 * (x & 1), key = 16 * kq + 2 * q + 8 * (x >> 1);
            const float2 kv = mma::unpack(kr[x]);
            lo[x] = kv.x * __expf(fminf(tot[key] - cum[s * WS + key], 0.f));
            hi[x] = kv.y * __expf(fminf(tot[key + 1] - cum[s * WS + key + 1], 0.f));
          }
          mma::split3x4(lo, hi, ka3);
#pragma unroll
          for (int vp2 = 0; vp2 < 4; ++vp2) {
            if (vp2 >= npair) continue;
            uint32_t xb[3][4];
#pragma unroll
            for (int term = 0; term < 3; ++term)
              mma::frag_bt(xb[term], ds_u + term * ds_term, VS, 16 * kq, v0 + 16 * vp2);
            mma6p(acc[2 * vp2], acc[2 * vp2 + 1], ka3, xb);
          }
        }
#pragma unroll 1
        for (int m = i; m < 4; ++m) {
          uint32_t a3[3][4];
          float a0[4], a1[4];
          mma::pick_tiles(a0, a1, at, m);
          mma::c_to_a3(a0, a1, a3);
#pragma unroll
          for (int vp2 = 0; vp2 < 4; ++vp2) {
            if (vp2 >= npair) continue;
            uint32_t bd[4];
            mma::frag_bt(bd, do_u, VS, 16 * m, v0 + 16 * vp2);
            mma::mma3(acc[2 * vp2], a3, bd[0], bd[1]);
            mma::mma3(acc[2 * vp2 + 1], a3, bd[2], bd[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = v0 + 8 * nt + 2 * q;
          if (nt >= 2 * npair || c >= V) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int s = hf ? s_hi : s_lo;
            if (s < chunk)
              *reinterpret_cast<uint32_t*>(dv + ((b * Tn + t0 + s) * H + h) * V + c) =
                  mma::pack(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
          }
        }
      }
      // dk = dA_ss u r + (the sweep's and the blocks below's gate terms) + ex
      // (v.dS^T); Y = k ex (v.dS^T); dcum = -k (gate terms) - Y. Below the
      // diagonal, t in sub-chunk m > i, about b = 16 (i + 1) - 1:
      // exp(cum_b - cum_s) times sum_m (dA^T . r'), r' = r exp(ce_t - cum_b)
      for (int c0 = 0; c0 < Kp; c0 += 32) {   // 32 keys a pass
        const int npair = min(2, (Kp - c0) / 16);
        float gk[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) gk[nt][e] = 0.f;
#pragma unroll 1
        for (int m = i + 1; m < 4; ++m) {
          uint32_t da3[3][4];
          float d0[4], d1[4];
          mma::pick_tiles(d0, d1, dat, m);
          mma::c_to_a3(d0, d1, da3);
#pragma unroll
          for (int kp2 = 0; kp2 < 2; ++kp2) {
            if (kp2 >= npair) continue;
            uint32_t rr[4], rb3[3][4];
            mma::frag_bt(rr, r_u, KS, 16 * m, c0 + 16 * kp2);
            float lo[4], hi[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int t = 16 * m + 2 * q + 8 * (x & 1), key = c0 + 16 * kp2 + g + 8 * (x >> 1);
              const float cb = cum[bs * WS + key];
              const float2 rv = mma::unpack(rr[x]);
              lo[x] = rv.x * __expf(fminf(ce[t * WS + key] - cb, 0.f));
              hi[x] = rv.y * __expf(fminf(ce[(t + 1) * WS + key] - cb, 0.f));
            }
            mma::split3x4(lo, hi, rb3);
            mma6p(gk[2 * kp2], gk[2 * kp2 + 1], da3, rb3);
          }
        }
        if (i < 3)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt >= 2 * npair) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = e < 2 ? s_lo : s_hi, key = c0 + 8 * nt + 2 * q + (e & 1);
              gk[nt][e] *= __expf(fminf(cum[bs * WS + key] - cum[s * WS + key], 0.f));
            }
          }
        // v.dS^T: dS^T (k = v, n = key) from the split dS's rows
        float vds[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) vds[nt][e] = 0.f;
#pragma unroll 1
        for (int kv = 0; kv < 8; ++kv) {
          if (16 * kv >= Vp) continue;
          uint32_t af[4];
          mma::frag_a(af, v_u, VS, 16 * i, 16 * kv);
#pragma unroll
          for (int kp2 = 0; kp2 < 2; ++kp2) {
            if (kp2 >= npair) continue;
#pragma unroll
            for (int term = 2; term >= 0; --term) {
              uint32_t bfr[4];
              mma::frag_b(bfr, ds_u + term * ds_term, VS, c0 + 16 * kp2, 16 * kv);
              mma::mma16816(vds[2 * kp2], af, bfr[0], bfr[1]);
              mma::mma16816(vds[2 * kp2 + 1], af, bfr[2], bfr[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= 2 * npair) continue;
          float ysum[2] = {0.f, 0.f};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int s = hf ? s_hi : s_lo, key = c0 + 8 * nt + 2 * q;
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kc = key + e;
              const float exs = __expf(fminf(tot[kc] - cum[s * WS + kc], 0.f));
              const float kv = bf(ks + s * KS + kc), gate = Dk[s * WS + kc] + gk[nt][2 * hf + e];
              const float y = kv * exs * vds[nt][2 * hf + e];
              o[e] = dAt[s] * us[kc] * bf(rs + s * KS + kc) + gate + exs * vds[nt][2 * hf + e];
              Dk[s * WS + kc] = -kv * gate - y;
              ysum[e] += y;
            }
            if (s < chunk && key < K)
              *reinterpret_cast<uint32_t*>(dk + ((b * Tn + t0 + s) * H + h) * K + key) =
                  mma::pack(o[0], o[1]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) ysum[e] += __shfl_xor_sync(kFull, ysum[e], off);
          }
          if (g == 0) {
            ycol[i * Kp + c0 + 8 * nt + 2 * q] = ysum[0];
            ycol[i * Kp + c0 + 8 * nt + 2 * q + 1] = ysum[1];
          }
        }
      }
    }

    // every warp: its panels' sum_v dS S0 by key, then dS <- exp(total) dS
    // + (r exp(ce))^T.do: (r exp(ce))^T from ldmatrix.trans of the r tile,
    // scaled and split in registers; do k-major (ldmatrix.trans)
#pragma unroll
    for (int ii = 0; ii < PW; ++ii) {
      const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
      if (pi >= npanels) continue;
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = 16 * prow + g + 8 * hf, c = 32 * pcol + 8 * nt + 2 * q;
          if (key < K && c < V) {
            const float2 s0 = s0v(key, c);
            part[hf] += st[ii][nt][2 * hf] * s0.x + st[ii][nt][2 * hf + 1] * s0.y;
          }
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) part[hf] += __shfl_xor_sync(kFull, part[hf], off);
        if (q == 0) dtp[pcol * Kp + 16 * prow + g + 8 * hf] = part[hf];
      }
      const float dl = expf(tot[16 * prow + g]), dh = expf(tot[16 * prow + g + 8]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        st[ii][nt][0] *= dl;
        st[ii][nt][1] *= dl;
        st[ii][nt][2] *= dh;
        st[ii][nt][3] *= dh;
      }
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        uint32_t xr[4], xa[3][4];
        mma::frag_at(xr, r_u, KS, 16 * prow, 16 * j);
        float lo[4], hi[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = 16 * prow + g + 8 * (x & 1), t = 16 * j + 2 * q + 8 * (x >> 1);
          const float2 f = mma::unpack(xr[x]);
          lo[x] = f.x * expf(ce[t * WS + key]);
          hi[x] = f.y * expf(ce[(t + 1) * WS + key]);
        }
        mma::split3x4(lo, hi, xa);
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          if (32 * pcol + 16 * n2 >= Vp) continue;
          uint32_t bd[4];
          mma::frag_bt(bd, do_u, VS, 16 * j, 32 * pcol + 16 * n2);
          mma::mma3(st[ii][2 * n2], xa, bd[0], bd[1]);
          mma::mma3(st[ii][2 * n2 + 1], xa, bd[2], bd[3]);
        }
      }
    }
    __syncthreads();                    // every reader of the split dS, the tiles and the partials is done
    if (kk + 1 < nchunks) write_split();
    // one thread a key column, rows in reverse: dw = (sum_{t >= s} dcum_t +
    // sum_{t > s} dce_t) ld_s, dtotal on the last row
    for (int c = tid; c < K; c += kBwThreads) {
      float dtot = 0.f;
      for (int pc = 0; pc < npc; ++pc) dtot += dtp[pc * Kp + c];
      dtot *= expf(tot[c]);
      for (int ib = 0; ib < 4; ++ib) dtot += ycol[ib * Kp + c];
      float run_c = dtot, run_e = 0.f;
      for (int s = chunk - 1; s >= 0; --s) {
        run_c += Dk[s * WS + c];
        dw[((b * Tn + t0 + s) * H + h) * K + c] = (run_c + run_e) * -expf(wv(s, c));
        run_e += Dr[s * WS + c];
      }
    }
  }
  // du: the sweep's partials, summed over the sub-chunks in order
  __syncthreads();
  {
    const int hk = Kp / 2;
#pragma unroll
    for (int rep = 0; rep < 2; ++rep)
      if (rep * 32 + lane < hk) Ap[i * Kp + half * hk + rep * 32 + lane] = du_acc[rep];
  }
  __syncthreads();
  for (int c = tid; c < K; c += kBwThreads)
    du_part[bh * K + c] = ((Ap[c] + Ap[Kp + c]) + Ap[2 * Kp + c]) + Ap[3 * Kp + c];
#pragma unroll
  for (int ii = 0; ii < PW; ++ii) {
    const int pi = warp + 8 * ii, prow = pi / npc, pcol = pi % npc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = 16 * prow + g + 8 * hf, c = 32 * pcol + 8 * nt + 2 * q;
        if (pi < npanels && key < K && c < V)
          *reinterpret_cast<float2*>(dstate + bh * KV + static_cast<long>(key) * V + c) =
              make_float2(st[ii][nt][2 * hf], st[ii][nt][2 * hf + 1]);
      }
  }
}

template <int PW>
int launch_bf16(const void* r, const void* k, const void* v, const float* w, const void* u,
                const float* states, const void* dout, const float* ds_out, void* dr, void* dk,
                void* dv, float* dw, float* du_part, float* dstate, float* scratch,
                long long scratch_floats, int B, int T, int H, int K, int V, int chunk,
                cudaStream_t stream) {
  const BwdLayout L((K + 15) & ~15, (V + 15) & ~15);
  if (scratch_floats < static_cast<long long>(B) * H * L.scratch_floats() ||
      (L.scratch_floats() && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_bf16_kernel<PW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  wkv_bwd_bf16_kernel<PW><<<dim3(H, B), kBwThreads, L.bytes, stream>>>(
      static_cast<const bf*>(r), static_cast<const bf*>(k), static_cast<const bf*>(v), w,
      static_cast<const bf*>(u), states, static_cast<const bf*>(dout), ds_out,
      static_cast<bf*>(dr), static_cast<bf*>(dk), static_cast<bf*>(dv), dw, du_part, dstate,
      scratch, T, H, K, V, chunk);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// r, k, v, u, do and dr, dk, dv bf16 (``bf16``) or f32; w, the chunk
// states (B, H, T / chunk, K, V), ds_out (or null: zeros), dw, dstate and
// du_part (B, H, K) f32. ``scratch`` holds ``scratch_floats``: in f32 a
// working set a block where one does not fit in shared memory, in bf16 the
// blocks' exchange tiles (and cum and ce where shared memory does not hold
// them); the wrapper's ``bwd_scratch_floats``. K, V <= 128 and chunk <= 64;
// in bf16 also K and V multiples of 8 and r, k, v, do, dr, dk, dv, the
// states and dstate 16-byte aligned; else cudaErrorInvalidValue.
extern "C" int memforest_rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                                        const float* w, const void* u, const float* states,
                                        const void* dout, const float* ds_out, void* dr,
                                        void* dk, void* dv, float* dw, float* du_part,
                                        float* dstate, float* scratch, long long scratch_floats,
                                        int B, int T, int H, int K, int V, int chunk, int bf16,
                                        void* stream) {
  if (B == 0 || H == 0 || T == 0) return static_cast<int>(cudaSuccess);
  if (K > 128 || V > 128 || chunk > kMaxChunk || chunk < 1 || T % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float>(r, k, v, w, u, states, dout, ds_out, dr, dk, dv, dw, du_part, dstate,
                         scratch, scratch_floats, B, T, H, K, V, chunk, st);
  if (K % 8 || V % 8 || !aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dr) || !aligned16(dk) || !aligned16(dv) || !aligned16(states) ||
      !aligned16(ds_out) || !aligned16(dstate))
    return static_cast<int>(cudaErrorInvalidValue);
  const int panels = ((K + 15) / 16) * (((V + 15) / 16 * 16 + 31) / 32);   // dS's, 8 warps
#define WKV_BWD_LAUNCH(PW)                                                                   \
  launch_bf16<PW>(r, k, v, w, u, states, dout, ds_out, dr, dk, dv, dw, du_part, dstate, scratch, \
                  scratch_floats, B, T, H, K, V, chunk, st)
  if (panels <= 8) return WKV_BWD_LAUNCH(1);
  if (panels <= 16) return WKV_BWD_LAUNCH(2);
  return WKV_BWD_LAUNCH(4);
#undef WKV_BWD_LAUNCH
}
