// bf16 products on Hopper's tensor cores with float32 sums: the fragment
// loads (ldmatrix) and the mma.sync.m16n8k16 steps that bsr_spmm.cu's and
// bsr_sddmm.cu's bf16 kernels share.
//
// Fragment layouts of mma.m16n8k16 with .bf16 operands (g = lane / 4,
// t = lane % 4; each register holds two consecutive k): A (16 x 16, row)
// a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B (16 x 8, col) b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// ldmatrix.x4 reads four 8 x 8 matrices of 16-bit elements, lane l giving
// the address of row l % 8 of matrix l / 8; lane l receives row l / 4,
// elements 2t and 2t + 1 of each (with .trans: column l / 4, rows 2t and
// 2t + 1). So a K-major operand ([m][k] or [n][k] in shared memory) loads
// without .trans and an N-major one ([k][n]) with it. Rows of 16 bytes
// are read eight at a time: a row stride of 16 (mod 128) bytes puts the
// eight on distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// volatile: the same shared address holds another stage's data after the
// next barrier, so the loads must not be merged or moved across it
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(p)));
}

__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a0 * b0 + a1 * b1 over two k = 16 steps. The product of two bf16
// values is exact in float32; the two mma calls sum the 32 from zero and
// `c` takes the sum on the CUDA cores in IEEE float32, since a float32 sum
// carried through many mma calls drifts by ~1 ulp a call (tf32x3.cuh): two
// calls an add keep the drift at two truncations, whatever the depth.
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&a0)[4], uint32_t b00,
                                     uint32_t b01, const uint32_t (&a1)[4], uint32_t b10,
                                     uint32_t b11) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_acc(s, a0, b00, b01);
  mma_acc(s, a1, b10, b11);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += s[i];
}

}  // namespace bf16mma
