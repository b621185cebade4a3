// rwkv6_scan_bwd: the gradient of the chunked RWKV6 WKV scan, the backward
// of rwkv6's time-mix in training.
//
// No Pallas kernel has a backward: the reference differentiates its jnp
// chunked scan (src/repro/kernels/ref.py:rwkv6_chunked). The plain version
// is ref.rwkv6_scan_bwd_ref; tests/test_torch_scan_design.py
// (rwkv_bwd_schedule) emulates this kernel's schedule step by step. Per
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
// A simple kernel on the CUDA cores, all math in f32: r, k, v, u and do are
// bf16 or f32 (one type) and enter as f32; w and the states are f32. One
// block of 256 threads per (head, batch), walking its chunks in reverse.
// The gate's exponentials are computed pair by pair in registers, as in the
// forward, for A, dr and dk in turn: the (C, C, K) tile never exists. The
// block's working set is the chunk's r, k, v, do, cum, ce and dce, A and dA
// (f32, rows padded to an odd length; k's room takes dcum once dk is done):
// 155 KB at K = V = 64, one block an SM, in shared memory up to 227 KB and
// otherwise in a global scratch of one working set a block (K = V = 128).
// The entering state is read from the forward's chunk states and the
// carried dS lives in the dstate output itself (L1 and L2). The products
// run as register tiles, the 256 threads a 16 x 16 grid, each owning a 4 x
// 4 tile of a 64 x 64 output; the sums down key columns run one thread a
// column, in row order.
//
// Cross-block sums, deterministic (no atomics): du is written per (batch,
// head), (B, H, K) f32 partials, and the wrapper sums them over the batch
// (a torch.sum over the kernel's outputs). Inside a block du's diagonal
// terms are summed one thread a key in row order and the column sums of Y
// go through 16 row partials added in order.
//
// Bound on an H100 at rwkv6-1.6b's training shape (B 8, T 512, H 32, K = V
// = 64, bf16): the kernel reads r, k, v, do (bf16), w and the chunk states
// (f32) and writes dr, dk, dv (bf16), dw and dstate: about 0.22 GB; the
// gate's exponentials (three sweeps of the lower triangle, K each) and the
// products are counted by chip_smoke.py from the call's shapes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// r, k, v, u, do and dr, dk, dv bf16 (``bf16``) or f32; w, the chunk
// states (B, H, T / chunk, K, V), ds_out (or null: zeros), dw, dstate and
// du_part (B, H, K) f32. ``scratch`` holds ``scratch_floats``: a working
// set a block where one does not fit in shared memory (the wrapper's
// ``bwd_scratch_floats``). K, V <= 128 and chunk <= 64, else
// cudaErrorInvalidValue.
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
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, states, dout, ds_out, dr, dk, dv, dw, du_part,
                                 dstate, scratch, scratch_floats, B, T, H, K, V, chunk, st);
  return launch<float>(r, k, v, w, u, states, dout, ds_out, dr, dk, dv, dw, du_part, dstate,
                       scratch, scratch_floats, B, T, H, K, V, chunk, st);
}
