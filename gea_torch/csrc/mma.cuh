// Building blocks of the port's bf16 tensor-core kernels (sm_90a):
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads and
// the warp-level mma.sync.m16n8k16 bf16 product with fp32 accumulation (the
// LIS kernel). The seed kernels use the ldmatrix loads for wgmma's A
// operand.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:            b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 fp32:       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Operands are staged in shared memory row-major with rows padded by 8
// elements (16 bytes), so the 8 rows that one ldmatrix matrix reads fall in
// 8 distinct 16-byte bank groups. B tiles are K x N row-major, as the
// weights arrive, and are read with ldmatrix.trans.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gea {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously. With src_bytes = 0 nothing is
// read and the 16 bytes are zero-filled (masked rows and columns).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row (l & 15) of the
// 16x16 tile at column block (l >> 4) * 8, which yields the A fragment
// (a0..a3). The second form takes a shared-memory address.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr));
}
// Two 8x8 matrices transposed: with lane l (l < 16) at row (l & 15) of a
// 16 x 8 K x N tile, the B fragment (b0, b1) of one n8 tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace gea
