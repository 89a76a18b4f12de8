// Block-sparse max aggregation on Hopper: out[i, k] = max over j with
// a_ij != 0 of a_ij * h[j, k] (of h[j, k] when unweighted), with A held as
// dense 128 x 128 tiles sorted by block-row (BSR), h dense (n_cols_padded, d),
// all float32. Rows without a nonzero slot give -inf; a NaN message gives NaN.
//
// Replaces the TPU kernel `_spmm_max_kernel` / `bsr_spmm_max` in
// dance_tpu/ops/pallas_kernels.py:804-863. That kernel fills an output
// block-row with -inf on the first of its consecutive same-row tiles and
// folds into it in place, which is only right because the TPU grid runs in
// order. As in bsr_spmm.cu, each thread block here owns one (block-row,
// 64-column feature tile) of the output and walks that block-row's tiles
// itself through the tile-row pointer `rowptr`: the running max stays in
// registers and each output tile is written exactly once. An empty block-row
// writes -inf, the zero pad tiles that bsr_from_scipy adds change nothing (a
// zero slot is "no edge"), no atomics are used and the result is
// deterministic.
//
// Bound on this card: graph-sc's tiling (~13,000 nodes, ~3,900 nonzero
// tiles, d = 200) asks 3,900 * 128 * 128 * 200 = 12.8 G multiply-max pairs
// over ~256 MB of tiles: ~50 pairs per byte, so it is bounded by the FP32
// pipe, not by the 3.35 TB/s of HBM. Max-plus is not a matrix product, so no
// tensor-core form exists. Each pair costs a multiply, a compare and a select
// where the SpMM pays one FMA; the design keeps the SpMM's register tiling
// (an 8 x 4 output patch a thread, 32 pairs for every three 16-byte
// shared-memory loads, A slices staged transposed so the loads broadcast)
// and spends nothing else. fmaxf drops NaN where jnp.maximum keeps it, so
// the fold is written out: take the message when its slot is an edge and it
// is larger than the running max or NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;              // tile edge (pallas_kernels.BLOCK)
constexpr int kBN = 64;                  // output columns per thread block
constexpr int kBK = 32;                  // K-slice of a tile staged per step
constexpr int kThreads = 256;            // 16 x 16 threads
constexpr int kTM = 8;                   // output rows per thread
constexpr int kTN = 4;                   // output columns per thread
constexpr int kAStride = kBlock + 4;     // padding spreads the transposing stores

static_assert(kBlock == 16 * kTM && kBN == 16 * kTN, "thread grid must cover the tile");

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_max_kernel(const float* __restrict__ tiles, const int* __restrict__ bcols,
                    const int* __restrict__ rowptr, const float* __restrict__ b,
                    float* __restrict__ out, int d) {
  __shared__ __align__(16) float as[kBK][kAStride];  // as[k][m] = A_tile[m][k0 + k]
  __shared__ __align__(16) float bs[kBK][kBN];       // bs[k][n] = h[row(k0 + k)][n0 + n]

  const int r = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = __int_as_float(0xff800000);  // -inf

  const int t_end = rowptr[r + 1];
  for (int t = rowptr[r]; t < t_end; ++t) {
    const float* a = tiles + static_cast<size_t>(t) * kBlock * kBlock;
    const float* bt = b + static_cast<size_t>(bcols[t]) * kBlock * d;
    for (int k0 = 0; k0 < kBlock; k0 += kBK) {
      // A slice: 128 rows x 32 columns as float4, stored transposed.
#pragma unroll
      for (int i = 0; i < kBlock * kBK / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int m = idx / (kBK / 4);
        const int q = (idx % (kBK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(a + m * kBlock + k0 + q);
        as[q + 0][m] = v.x;
        as[q + 1][m] = v.y;
        as[q + 2][m] = v.z;
        as[q + 3][m] = v.w;
      }
      // h slice: 32 rows x 64 columns; columns past d read as zero and are
      // never written out.
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int k = idx / kBN;
        const int n = idx % kBN;
        const int col = n0 + n;
        bs[k][n] = col < d ? bt[static_cast<size_t>(k0 + k) * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * kTM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[k][ty * kTM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * kTN]);
        const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const bool edge = av[i] != 0.f;  // NaN slots are edges, as in JAX
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const float msg = kWeighted ? av[i] * bv[j] : bv[j];
            const bool take = edge && (msg > acc[i][j] || msg != msg);
            acc[i][j] = take ? msg : acc[i][j];
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* o = out + static_cast<size_t>(r * kBlock + ty * kTM + i) * d;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < d) o[col] = acc[i][j];
    }
  }
}

}  // namespace

// C interface for ctypes. `tiles` must be 16-byte aligned; `rowptr` has
// n_brows + 1 entries; `b` is (n_cols_padded, d) and `out` (n_brows * 128, d),
// both row-major; `weighted` is 0 or 1. Launches on `stream` of CUDA device
// `device` and returns the first error of selecting the device or launching.
extern "C" int dtt_bsr_spmm_max_f32(const float* tiles, const int* bcols, const int* rowptr,
                                    const float* b, float* out, int n_brows, int d,
                                    int weighted, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_brows, (d + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weighted) {
    bsr_spmm_max_kernel<true><<<grid, kThreads, 0, s>>>(tiles, bcols, rowptr, b, out, d);
  } else {
    bsr_spmm_max_kernel<false><<<grid, kThreads, 0, s>>>(tiles, bcols, rowptr, b, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}
