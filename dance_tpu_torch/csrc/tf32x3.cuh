// Float32-accurate products on Hopper's tensor cores ("3xTF32"), and the
// cp.async copies that feed them; shared by bsr_spmm.cu and bsr_gat.cu
// (bsr_spmm_max.cu takes the copies and the feature slabs).
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits, so one TF32 product
// is ~3e-4 off an IEEE float32 one. Each float32 x is split into two TF32
// parts, hi = x truncated to TF32 and lo = x - hi rounded to TF32, and
// a * b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo, at most
// 2^-20 of the product, is dropped), each k = 8 step by mma.sync.m16n8k8 and the
// steps added in float32: the result is as close to the float32 product as
// float32's own rounding (tests/test_torch_schedule.py emulates it). An operand that is
// not finite would poison the correction terms (inf - inf, 0 * inf), so the
// split hands those terms 0 for it and lets only a_hi b_hi carry ±inf and
// NaN, as a plain float32 product would.
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (g = lane / 4,
// t = lane % 4): A (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, col) b0 (k = t, n = g), b1 (k = t + 4, n = g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// ldmatrix takes 16-bit elements only, so fragments are read with plain
// 32-bit shared loads from layouts padded against bank conflicts: row stride
// = 4 (mod 32) words for A read as [m][k], 8 (mod 32) for B read as [k][n].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// The parts of one float32 operand: `big` takes part in the hi * hi product,
// `hi` and `lo` in the two correction products (0 where x is not finite).
struct Split {
  uint32_t big, hi, lo;
};

// hi = x with its 13 low mantissa bits cleared (truncated to TF32: unlike
// rounding, this never carries a finite x near FLT_MAX to ±inf, nor a NaN
// into the sign bit); lo = x - hi, exact in float32, rounded to nearest
// TF32 (add half a TF32 ulp to its bits, clear the 13 low bits) so that the
// mma reads it without a truncation bias. lo is NaN exactly where x is ±inf
// or NaN; there the correction parts are 0 and `big` = hi keeps ±inf, and
// NaN for every NaN with a payload bit among the 10 high mantissa bits (all
// quiet NaNs). Seven instructions, as many as rounding hi would take.
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  const float lo = x - __uint_as_float(hi);
  const bool finite = lo == lo;
  const uint32_t lo_tf32 = (__float_as_uint(lo) + 0x1000u) & 0xffffe000u;
  return {hi, finite ? hi : 0u, finite ? lo_tf32 : 0u};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small terms first, then hi * hi. Inside an
// mma the tensor cores add aligned products truncated, with no guard bits,
// so a float32 sum carried through many mma calls drifts by ~1 ulp per call
// (3e-5 off a 384-term product, measured on the H100); the three products of
// one k = 8 step are therefore summed from zero and added to `c` on the CUDA
// cores, in IEEE float32.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4],
                                           const Split (&b)[2]) {
  float s[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(s[0]), "=f"(s[1]), "=f"(s[2]), "=f"(s[3])
      : "r"(a[0].lo), "r"(a[1].lo), "r"(a[2].lo), "r"(a[3].lo), "r"(b[0].hi), "r"(b[1].hi),
        "f"(0.f));
  mma_tf32(s, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(s, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += s[i];
}

// cp.async: 16 bytes (both addresses 16-byte aligned) or 4 bytes; a source
// size of 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

// Feature columns: d is cut into ceil(d / max_slab) slabs of equal width,
// rounded up to the 8 columns of an mma n-tile, so that d = 200 pays for
// 2 x 104 columns at a 128-column slab and not 2 x 128.
__host__ __device__ __forceinline__ int n_slabs(int d, int max_slab) {
  return (d + max_slab - 1) / max_slab;
}

__host__ __device__ __forceinline__ int slab_width(int d, int max_slab) {
  const int s = n_slabs(d, max_slab);
  return ((d + s - 1) / s + 7) / 8 * 8;
}

}  // namespace tf32x3
