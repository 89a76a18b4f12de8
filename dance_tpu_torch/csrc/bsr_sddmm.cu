// Sampled dense-dense matmul onto a BSR pattern, on Hopper:
// out[k] = g[rows of block_rows[k]] @ b[rows of block_cols[k]]^T for every
// nonzero 128 x 128 tile k, float32. This is the dA term of the SpMM backward.
//
// Replaces the TPU kernel `_sddmm_kernel` / `bsr_sddmm` in
// dance_tpu/ops/pallas_kernels.py:146-204. The TPU kernel accumulates one
// output tile over an inner grid axis of feature tiles; here one thread block
// owns one output tile and loops over d itself, so nothing depends on the
// order in which blocks run, and each output tile is written once.
//
// Bound on this card: at scDeepSort's bench size (3,039 tiles, d = 256) a call
// is 25.5 GFLOP; it reads 2 x 128 x 256 floats per tile (mostly from L2, since
// node tiles repeat across block-rows) and writes the ~200 MB of output tiles,
// ~100 FLOP per byte of HBM traffic, so it too is bounded by float32 CUDA-core
// arithmetic. Each thread keeps an 8 x 8 patch of the output tile in registers
// (64 FMAs per four 16-byte shared-memory loads); the g and b slices are
// staged transposed so those loads broadcast. IEEE float32, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;           // tile edge (pallas_kernels.BLOCK)
constexpr int kBK = 32;               // feature columns staged per step
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kT = 8;                 // 8 x 8 outputs per thread
constexpr int kStride = kBlock + 4;   // padding spreads the transposing stores

static_assert(kBlock == 16 * kT, "thread grid must cover the tile");

__global__ void __launch_bounds__(kThreads)
bsr_sddmm_kernel(const float* __restrict__ g, const float* __restrict__ b,
                 const int* __restrict__ brows, const int* __restrict__ bcols,
                 float* __restrict__ out, int d) {
  __shared__ __align__(16) float gs[kBK][kStride];  // gs[k][m] = g[r * 128 + m][d0 + k]
  __shared__ __align__(16) float bs[kBK][kStride];  // bs[k][n] = b[c * 128 + n][d0 + k]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* gr = g + static_cast<size_t>(brows[t]) * kBlock * d;
  const float* bc = b + static_cast<size_t>(bcols[t]) * kBlock * d;

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kBK) {
    // 128 rows x 32 feature columns of each operand; columns past d read as zero.
#pragma unroll
    for (int i = 0; i < kBlock * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kBK;
      const int k = idx % kBK;
      const int col = d0 + k;
      const bool in = col < d;
      gs[k][m] = in ? gr[static_cast<size_t>(m) * d + col] : 0.f;
      bs[k][m] = in ? bc[static_cast<size_t>(m) * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[k][ty * kT]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gs[k][ty * kT + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * kT]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][tx * kT + 4]);
      const float av[kT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + static_cast<size_t>(t) * kBlock * kBlock;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    float4* row = reinterpret_cast<float4*>(o + (ty * kT + i) * kBlock + tx * kT);
    row[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    row[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// C interface for ctypes. `g` is (n_rows_padded, d), `b` (n_cols_padded, d),
// both row-major; `out` is (nb, 128, 128) and 16-byte aligned. Launches on
// `stream` of CUDA device `device` and returns the first error of selecting
// the device or launching.
extern "C" int dtt_bsr_sddmm_f32(const float* g, const float* b, const int* brows,
                                 const int* bcols, float* out, int nb, int d,
                                 int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsr_sddmm_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, b, brows, bcols, out, d);
  return static_cast<int>(cudaGetLastError());
}
