// Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// 16-byte cp.async copies into 128-byte-swizzled shared-memory tiles,
// wgmma shared-memory descriptors, and the two bf16 wgmma shapes the
// attention kernels issue, as raw PTX.
//
// Tile layout. A tile holds R rows (R a multiple of 8) of D = 128 bf16
// values, stored as two halves of 64 columns ([2][R][64]), each row of a
// half 128 bytes, with the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8): the 128-byte swizzle (Swizzle<3,4,3>) that wgmma's
// layout type 1 reads, given a tile base aligned to 1024 bytes. One
// tile serves as either operand form:
// - K-major (the reduction runs along the row, over D): 8-row groups at
//   1024 bytes (SBO); the k-th 16-column step starts 32 * (k % 4) bytes
//   into half k / 4;
// - MN-major (the reduction runs over rows; wgmma's transposed mode):
//   the two 64-column halves at R * 128 bytes (LBO), 8-row groups at
//   1024 bytes (SBO); the k-th 16-row step starts 2048 * k bytes in.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0..15) of row r in an R-row tile
__device__ __forceinline__ uint32_t tile_chunk(int rows, int r, int chunk) {
  return (chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  // zero-fills the 16 bytes when !valid (src is not read then)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's completed cp.async writes visible to wgmma, which
// reads shared memory through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [row0, row0 + R) of a [rows_valid, 128] bf16 matrix with row
// stride `stride` (elements; base and stride 16-byte aligned) into the
// swizzled R-row tile at `dst`, zero-filling rows past rows_valid. All
// `threads` threads of the block take part.
template <int R, int kThreads>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int row0,
                                                int rows_valid) {
#pragma unroll
  for (int i = 0; i < R * 16 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, chunk = idx & 15;
    const bool valid = row0 + r < rows_valid;
    const __nv_bfloat16* p =
        src + (valid ? static_cast<int64_t>(row0 + r) * stride : 0) +
        chunk * 8;
    cp_async_16(dst + tile_chunk(R, r, chunk), p, valid);
  }
}

// wgmma descriptor of a 128-byte-swizzled operand starting at `addr`
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                        uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64) (or N rows) of an R-row tile, k-th
// 16-column step
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int r0, int k) {
  return desc(tile + (k >> 2) * rows * 128 + r0 * 128 + (k & 3) * 32, 16,
              1024);
}

// MN-major operand: k-th 16-row step of an R-row tile, all 128 columns
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int k) {
  return desc(tile + k * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a wgmma operand
// across the asynchronous instruction's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 accumulator of one warpgroup: thread t (warp w = t / 32,
// lane l) holds rows 16w + l/4 (elements 4j, 4j+1) and 16w + l/4 + 8
// (4j+2, 4j+3) of columns 8j + 2(l%4) + {0, 1}. The bf16 A fragment of
// the k-th 16-column step is elements 8k .. 8k+7 of that accumulator,
// packed in pairs.
template <int NACC>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NACC],
                                         uint32_t (&a)[NACC / 8][4]) {
#pragma unroll
  for (int k = 0; k < NACC / 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[k][i] = pack_bf16(acc[8 * k + 2 * i], acc[8 * k + 2 * i + 1]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs),
// B MN-major in shared memory (wgmma's transposed-B mode)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the rounded-up 1024-byte-aligned start of dynamic shared memory (the
// swizzle is a function of the address; kernels allocate 1 KB extra)
__device__ __forceinline__ uint32_t aligned_smem_base(const void* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

}  // namespace hopper
