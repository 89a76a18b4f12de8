// Sampled dense-dense matmul onto a BSR pattern, on Hopper's tensor cores:
// out[k] = g[rows of block_rows[k]] @ b[rows of block_cols[k]]^T for every
// stored 128 x 128 tile k, summed in float32. This is the dA term of the
// SpMM backward.
//
// Replaces the TPU kernel `_sddmm_kernel` / `bsr_sddmm` in
// dance_tpu/ops/pallas_kernels.py:146-204, in float32 and in its
// `compute_dtype=jnp.bfloat16` branch (:179-182), which casts g and b and
// accumulates in float32. The TPU kernel accumulates one output tile over an
// inner grid axis of feature tiles; here one thread block owns one output
// tile and loops over d itself, so nothing depends on the order in which
// blocks run, and each output tile is written once, without atomics: two
// runs are bit-equal.
//
// What computes: each tile is a 128 x 128 x d product of two K-major
// operands (rows of g and of b are contiguous along d), the layout that
// mma.sync .row.col takes directly (and wgmma would).
// - float32 (`dtt_bsr_sddmm_f32`): 3xTF32 m16n8k8 through tf32x3.cuh, as
//   bsr_spmm.cu does: float32's own rounding, non-finite inputs passed
//   through as a float32 product passes them.
// - bf16 (`dtt_bsr_sddmm_bf16`): m16n8k16 on bf16 g and b (the wrapper
//   casts them), fragments by ldmatrix, two k = 16 steps summed in the mma
//   and then added in float32 (bf16_mma.cuh). Sums carried through every
//   mma ran ~15 % faster but drift with d (tf32x3.cuh); an add a step ran
//   ~3 % slower (tools/time_sddmm.py).
// Staging: a 3-stage cp.async ring of (128 x BK) slices of g and of b
// (BK = 32 float32 or 64 bf16 columns, 128 bytes a row either way), row
// strides padded so that fragment loads have no bank conflicts; the wrapper
// pads d to 16 bytes a row with zero columns, and the slice past d reads as
// zero through the copy's source size. 4 warps, each a 64 x 64 patch of the
// tile: a fragment split (3xTF32) or loaded serves 8 or 4 products, and two
// blocks of 255 registers run on an SM; 8 warps of 32 x 64 took ~8 % longer
// in both types (tools/time_sddmm.py). Epilogue: the 128 x 128
// float32 accumulators go through shared memory, so that each warp writes
// whole 512-byte rows of the tile (streaming stores: the output is read
// later, not here); float2 stores from the registers took ~10 % longer in
// bf16. Tiles run in block-row order (blockIdx = tile), so
// consecutive blocks read one g slab again from L2; b (14 MB in float32 at
// the bench tiling) stays in the 50 MB L2.
//
// Bounds at scDeepSort's bench tiling (3,039 tiles, d = 256): a call is
// 2 x 3,039 x 128^2 x 256 = 25.5 GFLOP over every stored slot, and writes
// ~199 MB of float32 tiles. float32: 25.5 GFLOP at 3xTF32 (495 / 3 TFLOP/s)
// = 0.155 ms, operations set it (the bytes give 0.064 ms). bf16: 0.026 ms
// at 989 TFLOP/s; the 199 MB of output plus ~14 MB of bf16 inputs over
// 3.35 TB/s give ~0.064 ms, so bytes set it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBlock = 128;           // tile edge (pallas_kernels.BLOCK)
constexpr int kThreads = 128;         // 4 warps
constexpr int kWarpsM = 2;            // warps along the tile's rows
constexpr int kWarpsN = kThreads / 32 / kWarpsM;
constexpr int kMT = kBlock / 16 / kWarpsM;  // m16 tiles a warp: 4
constexpr int kNT = kBlock / 8 / kWarpsN;   // n8 tiles a warp: 8
constexpr int kStages = 3;
constexpr int kRowBytes = 128;        // bytes of a row in one stage, both types
constexpr int kOutStride = kBlock + 8;  // = 8 (mod 32) words: float2 stores without conflicts

template <typename T>
struct Stage;

template <>
struct Stage<float> {
  static constexpr int kBK = kRowBytes / 4;  // 32 columns
  static constexpr int kStride = kBK + 4;    // = 4 (mod 32) words: fragments without conflicts
};

template <>
struct Stage<uint16_t> {
  static constexpr int kBK = kRowBytes / 2;  // 64 columns
  static constexpr int kStride = kBK + 8;    // 144 bytes = 16 (mod 128): ldmatrix without conflicts
};

template <typename T>
constexpr size_t smem_bytes() {
  const size_t ring = size_t(kStages) * 2 * kBlock * Stage<T>::kStride * sizeof(T);
  const size_t out = size_t(kBlock) * kOutStride * sizeof(float);
  return ring > out ? ring : out;
}

// One stage's products: acc += gs[rows of this warp] * bs[cols of this warp]^T.
__device__ __forceinline__ void stage_products(const float* gs, const float* bs,
                                               float (&acc)[kMT][kNT][4], int m0, int n0,
                                               int lane) {
  constexpr int kStride = Stage<float>::kStride;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < Stage<float>::kBK; kk += 8) {
    tf32x3::Split af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* ar = gs + (m0 + mt * 16 + g) * kStride + kk + t4;
      af[mt][0] = tf32x3::split(ar[0]);
      af[mt][1] = tf32x3::split(ar[8 * kStride]);
      af[mt][2] = tf32x3::split(ar[4]);
      af[mt][3] = tf32x3::split(ar[8 * kStride + 4]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // b0 (k = t, n = g), b1 (k = t + 4, n = g) of the K-major b slice
      const float* br = bs + (n0 + nt * 8 + g) * kStride + kk + t4;
      const tf32x3::Split bf[2] = {tf32x3::split(br[0]), tf32x3::split(br[4])};
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) tf32x3::mma_3xtf32(acc[mt][nt], af[mt], bf);
    }
  }
}

__device__ __forceinline__ void stage_products(const uint16_t* gs, const uint16_t* bs,
                                               float (&acc)[kMT][kNT][4], int m0, int n0,
                                               int lane) {
  constexpr int kStride = Stage<uint16_t>::kStride;
#pragma unroll
  for (int kk = 0; kk < Stage<uint16_t>::kBK; kk += 32) {  // two k = 16 steps an add
    uint32_t af[2][kMT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        bf16mma::ldmatrix_x4(af[h][mt], gs + (m0 + mt * 16 + (lane & 15)) * kStride + kk +
                                            16 * h + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      // n-tiles 2p (matrices 0, 1: k 0-7, 8-15) and 2p + 1 (matrices 2, 3)
      uint32_t bf[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bf16mma::ldmatrix_x4(bf[h], bs + (n0 + p * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                             kStride + kk + 16 * h + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        bf16mma::mma2(acc[mt][2 * p], af[0][mt], bf[0][0], bf[0][1], af[1][mt], bf[1][0],
                      bf[1][1]);
        bf16mma::mma2(acc[mt][2 * p + 1], af[0][mt], bf[0][2], bf[0][3], af[1][mt],
                      bf[1][2], bf[1][3]);
      }
    }
  }
}

// g (n_rows_padded, d) and b (n_cols_padded, d) of element type T, row
// stride d, d * sizeof(T) a multiple of 16 and both 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bsr_sddmm_kernel(const T* __restrict__ g, const T* __restrict__ b,
                 const int* __restrict__ brows, const int* __restrict__ bcols,
                 float* __restrict__ out, int d) {
  constexpr int kBK = Stage<T>::kBK, kStride = Stage<T>::kStride;
  constexpr int kPerRow = kRowBytes / 16;  // 16-byte pieces of a row in a stage: 8
  constexpr int kEl = 16 / sizeof(T);      // elements of a piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int t = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = (warp % kWarpsM) * kMT * 16, n0 = (warp / kWarpsM) * kNT * 8;
  const T* gr = g + static_cast<size_t>(brows[t]) * kBlock * d;
  const T* bc = b + static_cast<size_t>(bcols[t]) * kBlock * d;
  const int row = tid / kPerRow, piece = (tid % kPerRow) * kEl;
  auto load = [&](int step, int stage) {
    T* gs = ring + stage * 2 * kBlock * kStride;
    T* bs = gs + kBlock * kStride;
    const int col = step * kBK + piece;
    const bool in = col < d;
#pragma unroll
    for (int i = 0; i < kBlock / (kThreads / kPerRow); ++i) {
      const int r = row + i * (kThreads / kPerRow);
      const size_t at = static_cast<size_t>(r) * d + col;
      tf32x3::cp_async16(gs + r * kStride + piece, in ? gr + at : g, in);
      tf32x3::cp_async16(bs + r * kStride + piece, in ? bc + at : b, in);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int total = (d + kBK - 1) / kBK;
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
    const T* gs = ring + (s % kStages) * 2 * kBlock * kStride;
    stage_products(gs, gs + kBlock * kStride, acc, m0, n0, lane);
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the output tile

  float* tile = reinterpret_cast<float*>(smem_raw);
  const int gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float* c = tile + (m0 + mt * 16 + gq) * kOutStride + n0 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(c + 8 * kOutStride) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kBlock * kBlock);
#pragma unroll 4
  for (int i = tid; i < kBlock * kBlock / 4; i += kThreads) {
    const int r = i / (kBlock / 4), c4 = i % (kBlock / 4);
    __stcs(o + i, *reinterpret_cast<const float4*>(tile + r * kOutStride + 4 * c4));
  }
}

template <typename T>
int launch(const void* g, const void* b, const int* brows, const int* bcols, float* out, int nb,
           int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  if (d < 0 || (d * sizeof(T)) % 16 || reinterpret_cast<size_t>(g) % 16 ||
      reinterpret_cast<size_t>(b) % 16 || reinterpret_cast<size_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t kSmem = smem_bytes<T>();
  err = cudaFuncSetAttribute(bsr_sddmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bsr_sddmm_kernel<T><<<nb, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(b), brows, bcols, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. `g` is (n_rows_padded, d) and `b` (n_cols_padded,
// d), row-major, float32 (d a multiple of 4) or bf16 (d a multiple of 8),
// 16-byte aligned; `out` is (nb, 128, 128) float32, 16-byte aligned.
// Launches on `stream` of CUDA device `device` and returns the first error
// of selecting the device, configuring or launching.
extern "C" int dtt_bsr_sddmm_f32(const float* g, const float* b, const int* brows,
                                 const int* bcols, float* out, int nb, int d, int device,
                                 void* stream) {
  return launch<float>(g, b, brows, bcols, out, nb, d, device, stream);
}

extern "C" int dtt_bsr_sddmm_bf16(const void* g, const void* b, const int* brows,
                                  const int* bcols, float* out, int nb, int d, int device,
                                  void* stream) {
  return launch<uint16_t>(g, b, brows, bcols, out, nb, d, device, stream);
}
