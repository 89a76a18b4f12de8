// Block-sparse SpMM on Hopper: out = A @ B, with A held as dense 128 x 128
// tiles sorted by block-row (BSR), B dense (n_cols_padded, d), all float32.
//
// Replaces the TPU kernel `_spmm_kernel` / `bsr_spmm` in
// dance_tpu/ops/pallas_kernels.py:91-143. That kernel zeroes an output
// block-row on the first of its consecutive same-row tiles and accumulates in
// place, which is only right because the TPU grid runs in order. Here thread
// blocks run in no order, so each block owns one (work item, feature slab):
// a run of consecutive tiles of one block-row, summed in registers and
// written once.
//
// Bound on this card: scDeepSort's graph (3,039 tiles, d = 256) makes one
// call 25.5 GFLOP over ~200 MB of tiles, ~125 FLOP per byte: arithmetic sets
// the bound, 0.155 ms for float32-accurate products on the tensor cores
// (3xTF32, 165 TFLOP/s of the TF32 peak's 495) against 0.38 ms on the CUDA
// cores. What the design does about it:
// - Tensor cores: mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh), within float32's
//   own rounding of the IEEE product, non-finite inputs included.
// - Balance: the graphs are bipartite, a few gene block-rows hold ~5x the
//   tiles of the cell block-rows. The host schedule (ops/bsr.py
//   work_schedule) cuts long rows into chunks of at most C tiles, longest
//   first; a row cut in k chunks writes k partial sums to `scratch`, and a
//   second kernel adds them in chunk order, so two runs are bit-equal (no
//   float atomics).
// - Each tile read about once from HBM: the slabs of one item are adjacent
//   in launch order (blockIdx.x % n_slabs), so they read its tiles together
//   and the re-reads hit L2.
// - Exact width: d is cut into equal slabs rounded to the 8 columns of an
//   n-tile (d = 200 pays for 208 columns); warps skip n-tiles past the slab.
// - Overlap: a 3-stage cp.async ring of (128 x 32 A slice, 32 x slab B
//   slice) keeps two loads in flight behind the product.
// What still holds it back (PERF.md): the split, the per-step float32 adds
// and the address work cost ~11 instructions per HMMA (tools/sass_mix.py),
// and the dependent mma chains want more warps than 2 blocks of 8 per SM;
// a layout with fewer instructions per HMMA but 1 block per SM ran slower.
// wgmma (both operands K-major in shared memory) is the next step.
//
// bf16 (`dtt_bsr_spmm_bf16`): the `compute_dtype=jnp.bfloat16` branch of the
// same TPU kernel (pallas_kernels.py:118-120), which casts the tiles and B
// and accumulates in float32. Here the wrapper keeps a bf16 copy of the
// tiles and casts B at every call, its rows padded to a multiple of 8
// columns (16 bytes). One mma.sync.m16n8k16 bf16 takes the place of three
// m16n8k8 TF32 products over half the depth, with no split: at the bench
// tiling a call is still 25.5 GFLOP (0.026 ms at the bf16 peak), and the
// tile stream halves to ~100 MB, so bytes set its bound (~0.036 ms with B
// and the float32 output). Same schedule, scratch and chunk-ordered sums
// as the float32 kernel (two runs bit-equal), the same 3-stage cp.async
// ring over (128 x 64 A slice, 64 x slab B slice); A fragments by
// ldmatrix, B fragments by ldmatrix.trans since B is N-major; two k = 16
// steps summed in the mma, then added in float32 on the CUDA cores
// (bf16_mma.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::Split;

constexpr int kBlock = 128;                  // tile edge (pallas_kernels.BLOCK)
constexpr int kBK = 32;                      // K-slice of a tile per pipeline stage
constexpr int kSteps = kBlock / kBK;         // stages per tile
constexpr int kThreads = 256;                // 8 warps
constexpr int kSlab = 128;                   // feature columns of a thread block, at most
constexpr int kWarpsM = 4;                   // warps along the rows
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;                // thread blocks resident per SM
constexpr int kWarpsN = kThreads / 32 / kWarpsM;  // warps along the columns
constexpr int kMT = kBlock / 16 / kWarpsM;        // m-tiles per warp
constexpr int kNT = kSlab / 8 / kWarpsN;          // n-tiles per warp at the widest slab
constexpr int kAStride = kBK + 4;            // = 4 (mod 32): A fragments without conflicts
constexpr int kBStride = kSlab + 8;          // = 8 (mod 32): B fragments likewise
constexpr int kStageFloats = kBlock * kAStride + kBK * kBStride;
constexpr size_t kSmemBytes = size_t(kStages) * kStageFloats * sizeof(float);

// thread blocks of one work item at width d: one per feature slab
int blocks_per_item(int d) { return tf32x3::n_slabs(d, kSlab); }

// items[i] = {block-row, first tile, end tile, scratch slot or -1}
template <bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsr_spmm_kernel(const float* __restrict__ tiles, const int* __restrict__ bcols,
                const int4* __restrict__ items, const float* __restrict__ b,
                float* __restrict__ out, float* __restrict__ scratch, int d) {
  extern __shared__ __align__(16) float smem[];
  const int ns = tf32x3::n_slabs(d, kSlab), w = tf32x3::slab_width(d, kSlab);
  const int4 item = items[blockIdx.x / ns];
  const int n0 = (blockIdx.x % ns) * w;
  const int nnt = (min(w, d - n0) + 7) / 8;  // live n-tiles of this slab
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;

  // each thread's share of a stage: A rows a_row + 32 i at column a_col, B
  // rows b_row + 8 i at column b_col (no division in the loop)
  const int a_row = tid / (kBK / 4), a_col = (tid % (kBK / 4)) * 4;
  const int b_row = tid / (kSlab / 4), b_col = (tid % (kSlab / 4)) * 4;
  const bool b_live = kVec4 && b_col < w, b_in = n0 + b_col < d;
  auto load = [&](int step, int stage) {
    const int t = item.y + step / kSteps, k0 = (step % kSteps) * kBK;
    float* as = smem + stage * kStageFloats;
    float* bs = as + kBlock * kAStride;
    const float* a = tiles + static_cast<size_t>(t) * kBlock * kBlock + k0;
#pragma unroll
    for (int i = 0; i < kBlock * kBK / 4 / kThreads; ++i) {
      const int m = a_row + i * (kThreads / (kBK / 4));
      tf32x3::cp_async16(as + m * kAStride + a_col, a + m * kBlock + a_col, true);
    }
    const float* bt = b + (static_cast<size_t>(bcols[t]) * kBlock + k0) * d + n0;
    if (kVec4) {
      if (b_live) {
#pragma unroll
        for (int i = 0; i < kBK * kSlab / 4 / kThreads; ++i) {
          const int k = b_row + i * (kThreads / (kSlab / 4));
          tf32x3::cp_async16(bs + k * kBStride + b_col, b_in ? bt + k * d + b_col : b, b_in);
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kBK * kSlab / kThreads; ++i) {
        const int idx = tid + i * kThreads, k = idx / kSlab;
        const int c = idx % kSlab, col = n0 + c;
        if (c < w)
          tf32x3::cp_async4(bs + k * kBStride + c, col < d ? bt - n0 + k * d + col : b, col < d);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int total = (item.z - item.y) * kSteps;
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
    const float* as = smem + (s % kStages) * kStageFloats;
    const float* bs = as + kBlock * kAStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      Split af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* ar = as + ((wm * kMT + mt) * 16 + g) * kAStride + kk + t4;
        af[mt][0] = tf32x3::split(ar[0]);
        af[mt][1] = tf32x3::split(ar[8 * kAStride]);
        af[mt][2] = tf32x3::split(ar[4]);
        af[mt][3] = tf32x3::split(ar[8 * kAStride + 4]);
      }
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        const int j = wn + kWarpsN * q;
        if (j < nnt) {
          const float* br = bs + (kk + t4) * kBStride + j * 8 + g;
          const Split bf[2] = {tf32x3::split(br[0]), tf32x3::split(br[4 * kBStride])};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) tf32x3::mma_3xtf32(acc[mt][q], af[mt], bf);
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();

  float* dst = item.w < 0 ? out + static_cast<size_t>(item.x) * kBlock * d
                          : scratch + static_cast<size_t>(item.w) * kBlock * d;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int j = wn + kWarpsN * q, col = n0 + j * 8 + 2 * t4;
      const int row = (wm * kMT + mt) * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e / 2) * 8, c = col + e % 2;
        if (j < nnt && c < d) dst[static_cast<size_t>(r) * d + c] = acc[mt][q][e];
      }
    }
}

// The bf16 kernel's stage: a (128 x 64) slice of a tile and (64 x slab) of B.
constexpr int kBK16 = 64;
constexpr int kSteps16 = kBlock / kBK16;
constexpr int kAStride16 = kBK16 + 8;   // 144 bytes = 16 (mod 128): ldmatrix without conflicts
constexpr int kBStride16 = kSlab + 8;   // 272 bytes, likewise
constexpr int kStageHalves = kBlock * kAStride16 + kBK16 * kBStride16;
constexpr size_t kSmemBytes16 = size_t(kStages) * kStageHalves * sizeof(uint16_t);

// bf16 tiles and B (row stride `ldb`, a multiple of 8, columns d..ldb zero);
// float32 out and scratch as in bsr_spmm_kernel. Warps as there: 4 along the
// rows (2 m-tiles each), 2 along the columns, each taking the n-tile pairs
// wn, wn + 2, ... of the slab (one ldmatrix.x4.trans loads a pair).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsr_spmm_bf16_kernel(const uint16_t* __restrict__ tiles, const int* __restrict__ bcols,
                     const int4* __restrict__ items, const uint16_t* __restrict__ b,
                     float* __restrict__ out, float* __restrict__ scratch, int d, int ldb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);
  const int ns = tf32x3::n_slabs(d, kSlab), w = tf32x3::slab_width(d, kSlab);
  const int4 item = items[blockIdx.x / ns];
  const int n0 = (blockIdx.x % ns) * w;
  const int nnt = (min(w, d - n0) + 7) / 8;  // live n-tiles of this slab
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;

  // 16-byte pieces: A rows a_row + 32 i at column a_col, B rows b_row + 16 i
  // at column b_col
  const int a_row = tid / (kBK16 / 8), a_col = (tid % (kBK16 / 8)) * 8;
  const int b_row = tid / (kSlab / 8), b_col = (tid % (kSlab / 8)) * 8;
  const bool b_live = b_col < w, b_in = n0 + b_col < ldb;
  auto load = [&](int step, int stage) {
    const int t = item.y + step / kSteps16, k0 = (step % kSteps16) * kBK16;
    uint16_t* as = smem + stage * kStageHalves;
    uint16_t* bs = as + kBlock * kAStride16;
    const uint16_t* a = tiles + static_cast<size_t>(t) * kBlock * kBlock + k0;
#pragma unroll
    for (int i = 0; i < kBlock * kBK16 / 8 / kThreads; ++i) {
      const int m = a_row + i * (kThreads / (kBK16 / 8));
      tf32x3::cp_async16(as + m * kAStride16 + a_col, a + m * kBlock + a_col, true);
    }
    const uint16_t* bt = b + (static_cast<size_t>(bcols[t]) * kBlock + k0) * ldb + n0;
    if (b_live) {
#pragma unroll
      for (int i = 0; i < kBK16 * kSlab / 8 / kThreads; ++i) {
        const int k = b_row + i * (kThreads / (kSlab / 8));
        tf32x3::cp_async16(bs + k * kBStride16 + b_col, b_in ? bt + k * ldb + b_col : b, b_in);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int total = (item.z - item.y) * kSteps16;
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
    const uint16_t* as = smem + (s % kStages) * kStageHalves;
    const uint16_t* bs = as + kBlock * kAStride16;
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 32) {  // two k = 16 steps an add
      uint32_t af[2][kMT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          bf16mma::ldmatrix_x4(af[h][mt], as + ((wm * kMT + mt) * 16 + (lane & 15)) * kAStride16 +
                                              kk + 16 * h + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < kNT / 2; ++q) {
        const int p = wn + kWarpsN * q;  // n-tiles 2p and 2p + 1
        if (2 * p < nnt) {
          uint32_t bf[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bf16mma::ldmatrix_x4_trans(bf[h], bs + (kk + 16 * h + (lane & 15)) * kBStride16 +
                                                  (2 * p + (lane >> 4)) * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            bf16mma::mma2(acc[mt][2 * q], af[0][mt], bf[0][0], bf[0][1], af[1][mt], bf[1][0],
                          bf[1][1]);
            bf16mma::mma2(acc[mt][2 * q + 1], af[0][mt], bf[0][2], bf[0][3], af[1][mt],
                          bf[1][2], bf[1][3]);
          }
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();

  float* dst = item.w < 0 ? out + static_cast<size_t>(item.x) * kBlock * d
                          : scratch + static_cast<size_t>(item.w) * kBlock * d;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      const int j = 2 * (wn + kWarpsN * (q / 2)) + q % 2, col = n0 + j * 8 + 2 * t4;
      const int row = (wm * kMT + mt) * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e / 2) * 8, c = col + e % 2;
        if (j < nnt && c < d) dst[static_cast<size_t>(r) * d + c] = acc[mt][q][e];
      }
    }
}

// rows[i] = {block-row, first scratch slot, chunks}: out's block-row is the
// sum of its chunks' partials, added in chunk order.
__global__ void __launch_bounds__(256)
bsr_spmm_reduce_kernel(const int4* __restrict__ rows, const float4* __restrict__ scratch,
                       float4* __restrict__ out, int d) {
  const int4 row = rows[blockIdx.x];
  const size_t n4 = static_cast<size_t>(kBlock) * d / 4;  // float4s in a block-row
  const size_t e = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  float4 s = scratch[row.y * n4 + e];
  for (int c = 1; c < row.z; ++c) {
    const float4 v = scratch[(row.y + c) * n4 + e];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  out[row.x * n4 + e] = s;
}

}  // namespace

// C interface for ctypes. `tiles` (nb, 128, 128) must be 16-byte aligned;
// `items` (n_items, 4) and `rows` (n_rows, 4) int32 come from
// the host schedule (ops/bsr.py work_schedule), which covers every block-row;
// `b` is (n_cols_padded, d), `out` (n_brows * 128, d) and `scratch`
// (slots, 128, d), row-major float32. Launches on `stream` of CUDA device
// `device` and returns the first error of selecting the device, configuring
// or launching.
extern "C" int dtt_bsr_spmm_f32(const float* tiles, const int* bcols, const int* items,
                                int n_items, const int* rows, int n_rows, const float* b,
                                float* out, float* scratch, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<size_t>(b) % 16 == 0;
  const auto kernel = vec4 ? bsr_spmm_kernel<true> : bsr_spmm_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  kernel<<<n_items * blocks_per_item(d), kThreads, kSmemBytes, s>>>(
      tiles, bcols, reinterpret_cast<const int4*>(items), b, out, scratch, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
  const dim3 grid(n_rows, (kBlock / 4 * d + 255) / 256);
  bsr_spmm_reduce_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const int4*>(rows),
                                              reinterpret_cast<const float4*>(scratch),
                                              reinterpret_cast<float4*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

// The same for bf16 `tiles` (nb, 128, 128) and `b` (n_cols_padded, ldb),
// ldb a multiple of 8 at least d, columns d..ldb zero, both 16-byte
// aligned; `out` and `scratch` float32 of width d.
extern "C" int dtt_bsr_spmm_bf16(const void* tiles, const int* bcols, const int* items,
                                 int n_items, const int* rows, int n_rows, const void* b,
                                 float* out, float* scratch, int d, int ldb, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (ldb < d || ldb % 8 || reinterpret_cast<size_t>(b) % 16 ||
      reinterpret_cast<size_t>(tiles) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(bsr_spmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes16));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  bsr_spmm_bf16_kernel<<<n_items * blocks_per_item(d), kThreads, kSmemBytes16, s>>>(
      static_cast<const uint16_t*>(tiles), bcols, reinterpret_cast<const int4*>(items),
      static_cast<const uint16_t*>(b), out, scratch, d, ldb);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
  const dim3 grid(n_rows, (kBlock / 4 * d + 255) / 256);
  bsr_spmm_reduce_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const int4*>(rows),
                                              reinterpret_cast<const float4*>(scratch),
                                              reinterpret_cast<float4*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

// What the launch at width `d` looks like on CUDA device `device`:
// info = {threads, dynamic shared memory bytes, blocks resident per SM,
// registers per thread, feature slabs, slab width, thread blocks per work
// item}; the host schedule (ops/bsr.py device_schedule) is sized from it.
// Returns the first error.
extern "C" int dtt_bsr_spmm_info(int d, int* info, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || d <= 0) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  const auto kernel = d % 4 == 0 ? bsr_spmm_kernel<true> : bsr_spmm_kernel<false>;
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

// The same for the bf16 kernel.
extern "C" int dtt_bsr_spmm_bf16_info(int d, int* info, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || d <= 0) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(bsr_spmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes16));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bsr_spmm_bf16_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bsr_spmm_bf16_kernel, kThreads,
                                                        kSmemBytes16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[7] = {kThreads, static_cast<int>(kSmemBytes16), blocks, attr.numRegs,
                       tf32x3::n_slabs(d, kSlab), tf32x3::slab_width(d, kSlab),
                       blocks_per_item(d)};
  for (int i = 0; i < 7; ++i) info[i] = vals[i];
  return static_cast<int>(cudaSuccess);
}
