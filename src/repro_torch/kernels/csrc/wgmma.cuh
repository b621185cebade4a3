// Hopper's warpgroup products as the attention kernels use them: bf16
// operands, f32 sums, operands in 128-byte swizzled panels of shared memory
// (64 rows of 128 bytes, as a TMA box of 64 bf16 values with
// CU_TENSOR_MAP_SWIZZLE_128B lands them), or A from registers.
//
// A 64 x 64 f32 accumulator lives in 32 registers a thread: thread t of the
// warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, columns
// 8 j + 2 (t % 4) + e (j < 8, e < 2) at d[4 j + 2 half + e]. Those of 16
// columns 16 kk .. 16 kk + 15 are exactly the A fragment of one k16 step
// (``to_a_frags``), so a product's result feeds the next product in
// registers.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

namespace tc {

constexpr int kPanel = 64;             // bf16 values per 128-byte panel row
constexpr int kPanelBytes = 64 * 128;  // one 64-row panel: 8 KB

// Shared-memory matrix descriptor of a 128-byte swizzled panel (rows of 128
// bytes, 8-row groups 1024 bytes apart): start address, leading and stride
// byte offsets (both 1024: for K-major operands the leading offset is
// unused, and an MN-major operand of at most 64 columns, one panel, reads
// the 8-row step from either), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are pending (groups complete in
// order: the older ones are done); wait<0> waits for all
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across a wgmma
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16, shared) . B(64 x 16, bf16, shared)^T,
// both K-major; D is overwritten when accumulate == 0
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 16, f32) += A(64 x 16, bf16, registers) . B(16 x 16, bf16, shared, MN-major)
__device__ __forceinline__ void rs_n16(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D(64 x 32, f32) += A(64 x 16, bf16, registers) . B(16 x 32, bf16, shared, MN-major)
__device__ __forceinline__ void rs_n32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D(64 x 48, f32) += A(64 x 16, bf16, registers) . B(16 x 48, bf16, shared, MN-major)
__device__ __forceinline__ void rs_n48(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D(64 x 64, f32) += A(64 x 16, bf16, registers) . B(16 x 64, bf16, shared, MN-major)
__device__ __forceinline__ void rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D(64 x n) += A(64 x 16, registers) . B(16 x n, MN-major) for the n = 16,
// 32, 48 or 64 columns of one panel (n is a constant once unrolled)
__device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int n) {
  if (n == 64) rs_n64(d, a, b);
  else if (n == 48) rs_n48(d, a, b);
  else if (n == 32) rs_n32(d, a, b);
  else rs_n16(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator rounded to bf16 as four A fragments: a[kk] is
// columns 16 kk .. 16 kk + 15, the k16 step kk of the next product
__device__ __forceinline__ void to_a_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The accumulators of NP panels (the last one LAST_N columns wide), rows r0
// and r0 + 8 times s0 and s1, in bf16 into 128-byte swizzled panels at
// panel(p): 16-byte chunk c of row r sits at chunk c ^ (r % 8), the layout a
// TMA store of the panel reads. col = 2 (lane % 4).
template <int NP, int LAST_N, typename Panel>
__device__ __forceinline__ void store_panels(const float (&acc)[NP][32], Panel panel, int r0,
                                             int col, float s0, float s1) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < (p < NP - 1 ? 8 : LAST_N / 8); ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const float s = half ? s1 : s0;
        const uint32_t addr = panel(p) + r * 128 + ((j ^ (r % 8)) * 16) + col * 2;
        const uint32_t v = pack_bf16(acc[p][4 * j + 2 * half] * s, acc[p][4 * j + 2 * half + 1] * s);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
      }
}

}  // namespace tc
