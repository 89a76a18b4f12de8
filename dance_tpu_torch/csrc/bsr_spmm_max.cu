// Block-sparse max aggregation on Hopper: out[i, k] = max over j with
// a_ij != 0 of a_ij * h[j, k] (of h[j, k] when unweighted), with A held as
// dense 128 x 128 tiles sorted by block-row (BSR), h dense (n_cols_padded, d),
// all float32. Rows without a nonzero slot give -inf; a NaN message gives NaN.
//
// Replaces the TPU kernel `_spmm_max_kernel` / `bsr_spmm_max` in
// dance_tpu/ops/pallas_kernels.py:804-863. That kernel fills an output
// block-row with -inf on the first of its consecutive same-row tiles and folds
// every slot of every tile into it in place (masked), which is only right
// because the TPU grid runs in order.
//
// Bound on this card: graph-sc's tiles hold 9.2 M edges in 3,892 x 16,384
// slots (14.5 %), so a fold over the edges, not the slots, does the work:
// 2 nnz d operations (3.7 GFLOP at d = 200) against the 255 MB of tiles that
// the weighted form reads for a_ij and the edges, so bytes set it (~0.08 ms
// at 3.35 TB/s). Max-plus is not a matrix product: no tensor-core form. What
// the design does about it:
// - Schedule: work items from the host schedule (ops/bsr.py device_schedule,
//   sized from dtt_bsr_spmm_max_info), one thread block per (item, feature
//   slab of <= 128 columns): long block-rows are cut into chunks whose
//   partial maxima a second kernel combines in chunk order.
// - Staging: the item's tiles in turn; each tile's h slab (128 rows of its
//   block-column) goes to shared memory through a 3-stage cp.async ring, as a
//   tile's h_j row serves ~18 of its rows on graph-sc (gathering rows from L2
//   per edge would move ~7.4 GB).
// - Fold: a warp owns 4 rows, a lane 4 columns of the slab. Weighted, the warp
//   reads each of its tile rows once as float4s and finds the edges by ballot
//   (a_ij != 0, NaN included) and a_ij by shuffle; unweighted, it reads the
//   row's 4 words of edge bits (ops/bsr.py bsr_edge_mask), 1/32 of the bytes.
//   Each edge is one 16-byte shared load and 4 (or 8) instructions:
//   `max.NaN.f32` keeps NaN as jnp.maximum does (fmaxf drops it); a warp loads
//   two edges' messages before it folds them, so that the loads overlap.
// What holds it back (PERF.md): the h reads from shared memory (edges x d x 4
// bytes, 7.4 GB on graph-sc: ~0.3 ms at the SMs' 128 B a clock) and the
// shuffles of a_ij share one pipe, and warps wait on it and at each tile's
// barrier; 32 warps an SM (4 rows each) beat 16 (tools/time_max.py).
// No atomics; two runs are bit-equal, and the result equals the plain
// version's (a max of the same float32 products).

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kBlock = 128;                   // tile edge (pallas_kernels.BLOCK)
constexpr int kThreads = 1024;                // 32 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlock / kWarps;        // rows of a warp
constexpr int kSlab = 128;                    // feature columns of a thread block, at most
constexpr int kStages = 3;
constexpr int kStageFloats = kBlock * kSlab;  // h rows of the block-column x slab
constexpr size_t kSmemBytes = size_t(kStages) * kStageFloats * sizeof(float);  // 192 KB
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSlab == 4 * 32, "a lane folds 4 columns of the slab");

// thread blocks of one work item at width d: one per feature slab
int blocks_per_item(int d) { return tf32x3::n_slabs(d, kSlab); }

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void fold(float (&acc)[4], float4 v) {
  acc[0] = max_nan(acc[0], v.x);
  acc[1] = max_nan(acc[1], v.y);
  acc[2] = max_nan(acc[2], v.z);
  acc[3] = max_nan(acc[3], v.w);
}

// Fold the messages of the edges whose bits are set, two at a time so that
// their loads overlap; `message(b)` is the message of bit b. `bits` is the
// same in every lane.
template <typename Message>
__device__ __forceinline__ void fold_edges(float (&acc)[4], unsigned bits, Message message) {
  for (; bits & (bits - 1); bits &= bits - 1) {
    const int b0 = __ffs(bits) - 1;
    bits &= bits - 1;
    const float4 m0 = message(b0), m1 = message(__ffs(bits) - 1);
    fold(acc, m0);
    fold(acc, m1);
  }
  if (bits) fold(acc, message(__ffs(bits) - 1));
}

// items[i] = {block-row, first tile, end tile, scratch slot or -1}; `edges` is
// the tiles (weighted) or the edge bits (nb, 128, 4) int32 (unweighted).
template <bool kWeighted, bool kVec4>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_max_kernel(const void* __restrict__ edges, const int* __restrict__ bcols,
                    const int4* __restrict__ items, const float* __restrict__ b,
                    float* __restrict__ out, float* __restrict__ scratch, int d) {
  extern __shared__ __align__(16) float smem[];
  const int ns = tf32x3::n_slabs(d, kSlab), w = tf32x3::slab_width(d, kSlab);
  const int4 item = items[blockIdx.x / ns];
  const int n0 = (blockIdx.x % ns) * w;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = 4 * lane;        // the lane's first column in the slab
  const int row0 = warp * kRows;  // the warp's first row in the block-row

  // h rows of tile `step`'s block-column, slab columns [n0, n0 + w) (zeros
  // past d; lanes past the slab copy nothing and their results are dropped)
  auto load = [&](int step, int stage) {
    float* hs = smem + stage * kStageFloats;
    const float* bt = b + static_cast<size_t>(bcols[item.y + step]) * kBlock * d + n0 + c;
    if (c >= w) return;
#pragma unroll
    for (int k = warp; k < kBlock; k += kWarps) {
      if (kVec4) {
        const bool in = n0 + c < d;  // d % 4 == 0: all 4 columns or none
        tf32x3::cp_async16(hs + k * kSlab + c, in ? bt + static_cast<size_t>(k) * d : b, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = n0 + c + e < d;
          tf32x3::cp_async4(hs + k * kSlab + c + e, in ? bt + static_cast<size_t>(k) * d + e : b,
                            in);
        }
      }
    }
  };

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = __int_as_float(0xff800000);  // -inf

  const int total = item.z - item.y;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load(i, i);
    tf32x3::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed; stage s - 1 is free for step s + 2
    if (s + kStages - 1 < total) load(s + kStages - 1, (s + kStages - 1) % kStages);
    tf32x3::cp_async_commit();
    const float* hs = smem + (s % kStages) * kStageFloats + c;
    const size_t t = static_cast<size_t>(item.y + s);
    if (kWeighted) {
      // the warp's tile rows, 4 values a lane
      const float* a = static_cast<const float*>(edges) + (t * kBlock + row0) * kBlock + c;
      float4 rows[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        rows[r] = __ldg(reinterpret_cast<const float4*>(a + r * kBlock));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av[4] = {rows[r].x, rows[r].y, rows[r].z, rows[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // bit l: column 4 l + q is an edge (NaN != 0 is one, as in JAX)
          fold_edges(acc[r], __ballot_sync(kFull, av[q] != 0.f), [&](int l) {
            const float aij = __shfl_sync(kFull, av[q], l);
            const float4 hv = *reinterpret_cast<const float4*>(hs + (4 * l + q) * kSlab);
            return make_float4(aij * hv.x, aij * hv.y, aij * hv.z, aij * hv.w);
          });
        }
      }
    } else {
      // lane 4 r + q holds word q of row r (bit j: column 32 q + j)
      const unsigned word = __ldg(static_cast<const int*>(edges) + (t * kBlock + row0) * 4 +
                                  lane % (4 * kRows));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fold_edges(acc[r], __shfl_sync(kFull, word, 4 * r + q), [&](int b) {
            return *reinterpret_cast<const float4*>(hs + (32 * q + b) * kSlab);
          });
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();

  if (c >= w) return;
  float* dst = (item.w < 0 ? out + static_cast<size_t>(item.x) * kBlock * d
                           : scratch + static_cast<size_t>(item.w) * kBlock * d) + n0 + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* o = dst + static_cast<size_t>(row0 + r) * d;
    if (kVec4) {
      if (n0 + c < d)
        *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + c + e < d) o[e] = acc[r][e];
    }
  }
}

// rows[i] = {block-row, first scratch slot, chunks}: out's block-row is the
// max of its chunks' partials, taken in chunk order (NaN kept).
__global__ void __launch_bounds__(256)
bsr_spmm_max_reduce_kernel(const int4* __restrict__ rows, const float* __restrict__ scratch,
                           float* __restrict__ out, int d) {
  const int4 row = rows[blockIdx.x];
  const size_t n = static_cast<size_t>(kBlock) * d;  // floats in a block-row
  const size_t e = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = scratch[row.y * n + e];
  for (int c = 1; c < row.z; ++c) v = max_nan(v, scratch[(row.y + c) * n + e]);
  out[row.x * n + e] = v;
}

using KernelFn = void (*)(const void*, const int*, const int4*, const float*, float*, float*, int);

KernelFn pick(bool weighted, bool vec4) {
  if (weighted) return vec4 ? bsr_spmm_max_kernel<true, true> : bsr_spmm_max_kernel<true, false>;
  return vec4 ? bsr_spmm_max_kernel<false, true> : bsr_spmm_max_kernel<false, false>;
}

}  // namespace

// C interface for ctypes. `edges` is the tiles (nb, 128, 128) float32 when
// `weighted` is 1 and the edge bits (nb, 128, 4) int32 when it is 0, 16-byte
// aligned; `items` (n_items, 4) and `rows` (n_rows, 4) int32 come from the
// host schedule (ops/bsr.py work_schedule), which covers every block-row; `b`
// is (n_cols_padded, d), `out` (n_brows * 128, d) and `scratch` (slots, 128,
// d), row-major float32. Launches on `stream` of CUDA device `device` and
// returns the first error of selecting the device, configuring or launching.
extern "C" int dtt_bsr_spmm_max_f32(const void* edges, const int* bcols, const int* items,
                                    int n_items, const int* rows, int n_rows, const float* b,
                                    float* out, float* scratch, int d, int weighted, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<size_t>(b) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0 &&
                    reinterpret_cast<size_t>(scratch) % 16 == 0;
  const KernelFn kernel = pick(weighted != 0, vec4);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<n_items * blocks_per_item(d), kThreads, kSmemBytes, s>>>(
      edges, bcols, reinterpret_cast<const int4*>(items), b, out, scratch, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
  const dim3 grid(n_rows, (kBlock * d + 255) / 256);
  bsr_spmm_max_reduce_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const int4*>(rows), scratch,
                                                  out, d);
  return static_cast<int>(cudaGetLastError());
}

// What the launch at width `d` looks like on CUDA device `device`:
// info = {threads, dynamic shared memory bytes, blocks resident per SM,
// registers per thread (of the weighted kernel), feature slabs, slab width,
// thread blocks per work item}; the host schedule (ops/bsr.py
// device_schedule) is sized from it. Returns the first error.
extern "C" int dtt_bsr_spmm_max_info(int d, int* info, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || d <= 0) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  const KernelFn kernel = pick(true, d % 4 == 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[7] = {kThreads, static_cast<int>(kSmemBytes), blocks, attr.numRegs,
                       tf32x3::n_slabs(d, kSlab), tf32x3::slab_width(d, kSlab),
                       blocks_per_item(d)};
  for (int i = 0; i < 7; ++i) info[i] = vals[i];
  return static_cast<int>(cudaSuccess);
}
