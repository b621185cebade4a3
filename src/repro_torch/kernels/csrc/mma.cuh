// Warp-level tensor-core pieces of the bf16 scans: cp.async copies into
// shared memory, ldmatrix, mma.sync m16n8k16 (bf16 operands, f32 sums) and
// the three-term bf16 split of f32 values.
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

}  // namespace mma
