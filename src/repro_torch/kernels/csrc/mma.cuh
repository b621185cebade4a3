// Warp-level tensor-core pieces of the bf16 scans, forward and backward:
// cp.async copies into shared memory, ldmatrix and the fragment loaders,
// mma.sync m16n8k16 (bf16 operands, f32 sums) and the three-term bf16 split
// of f32 values with the products over split operands.
//
// Fragments of mma.m16n8k16 (lane = 4 g + q): A (16 x 16, row-major) a0 =
// (g, 2q..2q+1), a1 = (g + 8, 2q..), a2 = (g, 2q + 8..), a3 = (g + 8, 2q +
// 8..); B (16 x 8) b0 = (k 2q..2q+1, n g), b1 = (k 2q + 8.., n g); C (16 x 8)
// c0, c1 = (g, 2q..2q+1), c2, c3 = (g + 8, 2q..). So the C fragments of
// two neighbouring n tiles are, packed in pairs, the A fragment of one k16
// step: a product's sums feed the next product without leaving registers.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
// (src is then not read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, or 4 zero bytes where !valid
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's groups are in flight
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// C(16 x 8, f32) += A(16 x 16, bf16) . B(16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of bf16 tiles in shared memory (``base`` a shared-memory byte
// address, ``stride`` elements a row), g = lane / 4, q = lane % 4:
//  - frag_a: the A fragment (16 x 16) of M[m][k], rows m0.., columns k0..;
//  - frag_at: the A fragment of M^T, M stored [k][m] (ldmatrix.trans);
//    register x of either holds row m0 + g + 8 (x & 1), columns k0 + 2q +
//    8 (x >> 1) and the next;
//  - frag_b: the B fragments (16 k x 16 n: registers 0, 1 the first 8
//    columns, 2, 3 the next 8) of M stored [n][k];
//  - frag_bt: the same of M stored [k][n] (ldmatrix.trans); register x of
//    either holds rows k0 + 2q + 8 (x & 1) and the next, column n0 + g +
//    8 (x >> 1).
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], uint32_t base, int stride, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, base + ((m0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8) * 2);
}
__device__ __forceinline__ void frag_at(uint32_t (&r)[4], uint32_t base, int stride, int m0,
                                        int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4_trans(r, base + ((k0 + (lane & 7) + (mi >> 1) * 8) * stride + m0 + (mi & 1) * 8) * 2);
}
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], uint32_t base, int stride, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, base + ((n0 + (lane & 7) + (lane >> 4) * 8) * stride + k0 + ((lane >> 3) & 1) * 8) * 2);
}
__device__ __forceinline__ void frag_bt(uint32_t (&r)[4], uint32_t base, int stride, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, base + ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + n0 + (lane >> 4) * 8) *
                             2);
}

// The (row, column) pairs of the flat indices first, first + step, ... of a
// rows x cols grid, in order, with two divisions in all rather than two a
// step: for (Steps2 it(first, step, cols); it.r < rows; it.next()) ...
struct Steps2 {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Steps2(int first, int step, int cols_) : cols(cols_) {
    r = first / cols;
    c = first % cols;
    dr = step / cols;
    dc = step % cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// acc += part: joins two chains of one product's mma, kept apart so that
// they run side by side
__device__ __forceinline__ void add(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// (lo, hi) as one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// The split: t[0] = bf16(x), t[1] = bf16(x - t[0]), t[2] = bf16(x - t[0] -
// t[1]), for the pair (lo, hi). Each residual is exact in f32, so the three
// terms carry 24 bits of x's mantissa.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& t0, uint32_t& t1,
                                       uint32_t& t2) {
  t0 = pack(lo, hi);
  float2 f = unpack(t0);
  lo -= f.x;
  hi -= f.y;
  t1 = pack(lo, hi);
  f = unpack(t1);
  t2 = pack(lo - f.x, hi - f.y);
}

// The split of a fragment's four f32 pairs (lo[x], hi[x]): t[term][x]
__device__ __forceinline__ void split3x4(const float (&lo)[4], const float (&hi)[4],
                                         uint32_t (&t)[3][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) split3(lo[x], hi[x], t[0][x], t[1][x], t[2][x]);
}

// The A fragments of one k16 step from the f32 sums of two neighbouring n
// tiles (c0 the columns 0-7, c1 8-15), split: t[term][reg]
__device__ __forceinline__ void c_to_a3(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&t)[3][4]) {
  split3(c0[0], c0[1], t[0][0], t[1][0], t[2][0]);
  split3(c0[2], c0[3], t[0][1], t[1][1], t[2][1]);
  split3(c1[0], c1[1], t[0][2], t[1][2], t[2][2]);
  split3(c1[2], c1[3], t[0][3], t[1][3], t[2][3]);
}

// Register arrays indexed by a runtime block j < 4 without leaving the
// registers: every index is static, the copies predicated. They let a loop
// over the blocks stay rolled (one copy of its body) while the sums it
// reads or writes stay in registers.
// o0, o1 = the two n tiles 2j, 2j + 1 of acc
__device__ __forceinline__ void pick_tiles(float (&o0)[4], float (&o1)[4], const float (&acc)[8][4],
                                           int j) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (jj == j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o0[e] = acc[2 * jj][e];
        o1[e] = acc[2 * jj + 1][e];
      }
}
// a[j] = v, a block's split A fragments
__device__ __forceinline__ void put3(uint32_t (&a)[4][3][4], int j, const uint32_t (&v)[3][4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (jj == j)
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) a[jj][t][x] = v[t][x];
}

// acc += A.B over a split A (three terms, smallest first) and bf16 B
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&a)[3][4], uint32_t b0,
                                     uint32_t b1) {
  mma16816(acc, a[2], b0, b1);
  mma16816(acc, a[1], b0, b1);
  mma16816(acc, a[0], b0, b1);
}

// acc += A.B over two split sides: the six terms i + j < 3, smallest first
__device__ __forceinline__ void mma6(float (&acc)[4], const uint32_t (&a)[3][4], uint32_t b0[3],
                                     uint32_t b1[3]) {
  mma16816(acc, a[2], b0[0], b1[0]);
  mma16816(acc, a[1], b0[1], b1[1]);
  mma16816(acc, a[0], b0[2], b1[2]);
  mma16816(acc, a[1], b0[0], b1[0]);
  mma16816(acc, a[0], b0[1], b1[1]);
  mma16816(acc, a[0], b0[0], b1[0]);
}

}  // namespace mma
