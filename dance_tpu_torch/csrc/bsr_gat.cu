// Fused single-head GAT forward on Hopper, over a BSR adjacency of dense
// 128 x 128 tiles sorted by block-row, float32:
//   out_i = sum_j softmax_i(act(er_i + el_j)) h_j   over the edges tile != 0,
// with act leaky-ReLU(slope) or sigmoid. The stats variant also writes the
// per-row softmax max m and normaliser l that the flash backward needs.
//
// Replaces the TPU kernels `_gat_kernel` / `bsr_gat` and `_gat_stats_kernel`
// / `bsr_gat_stats` in dance_tpu/ops/pallas_kernels.py:325-468. Those carry
// the running (m, l, acc) of a block-row in scratch memory from one grid step
// to the next, which is only right because the TPU grid runs in order. Here
// thread blocks run in no order, so each thread block owns one (block-row,
// 64-column feature tile) of the output, as in bsr_spmm.cu, and walks that
// block-row's tiles itself through the tile-row pointer `rowptr`, keeping m
// and l in shared memory and acc in registers; it writes each output tile
// once. A block-row with no tile (or only all-zero pad tiles) gives out = 0,
// m = -1e30 and l = 0, as the TPU kernel does.
//
// Bound on this card: at STAGATE's size (10,000 spots, ~554 nonzero tiles,
// d = 512) the p @ h products are 2 * 554 * 128 * 128 * 512 = 9.3 GFLOP, and
// each tile (64 KB) and h block (128 x 64 floats) is read once per feature
// tile, mostly from L2. So it is bounded by float32 FMA throughput on the CUDA
// cores, with the logits' activation and exp (recomputed for each of the
// d / 64 feature tiles, as the TPU grid does per d-tile) a small extra. Design:
// per tile, each warp builds 16 rows of the masked logits and of p = exp(logit
// - m_new) with one coalesced float4 per lane and warp shuffles for the row
// max and sum, into a 128 x 128 p tile in shared memory; then each thread
// adds an 8 x 4 patch of p @ h_C to its registers, reading p as float4 along
// k. IEEE float32 with expf (no fast math, no TF32), so it agrees with the
// plain PyTorch version to ~1e-6.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;                     // tile edge (pallas_kernels.BLOCK)
constexpr int kBN = 64;                         // output columns per thread block
constexpr int kThreads = 256;                   // 8 warps; 16 x 16 in the product
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBlock / kWarps;   // logit rows each warp builds
constexpr int kTM = 8;                          // output rows per thread
constexpr int kTN = 4;                          // output columns per thread
constexpr int kPStride = kBlock + 4;            // keeps float4 rows 16-byte aligned

static_assert(kBlock == 16 * kTM && kBN == 16 * kTN, "thread grid must cover the tile");
static_assert(kBlock == 32 * 4, "a warp covers a logit row with one float4 per lane");

enum Act { kLeakyRelu = 0, kSigmoid = 1 };  // ops/bsr.py GAT_ACTS

template <int ACT>
__device__ __forceinline__ float activation(float raw, float slope) {
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-raw));
  return raw >= 0.f ? raw : slope * raw;
}

struct Smem {
  float p[kBlock][kPStride];  // this tile's exp(logit - m_new), 0 off the edges
  float h[kBlock][kBN];       // h rows of the tile's block-column, this feature tile
  float er[kBlock];           // destination logits of the block-row
  float el[kBlock];           // source logits of the tile's block-column
  float m[kBlock];            // running row max
  float l[kBlock];            // running row normaliser
  float scale[kBlock];        // exp(m_old - m_new) of the current tile
};

template <bool kStats, int ACT>
__global__ void __launch_bounds__(kThreads)
bsr_gat_kernel(const float* __restrict__ tiles, const int* __restrict__ bcols,
               const int* __restrict__ rowptr, const float* __restrict__ er,
               const float* __restrict__ el, const float* __restrict__ h,
               float* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int d, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int r = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % 16;
  const int ty = tid / 16;

  if (tid < kBlock) {
    s.er[tid] = er[static_cast<size_t>(r) * kBlock + tid];
    s.m[tid] = -1e30f;
    s.l[tid] = 0.f;
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int t_end = rowptr[r + 1];
  for (int t = rowptr[r]; t < t_end; ++t) {
    const int c = bcols[t];
    const float* a = tiles + static_cast<size_t>(t) * kBlock * kBlock;
    const float* hc = h + static_cast<size_t>(c) * kBlock * d;
    if (tid < kBlock) s.el[tid] = el[static_cast<size_t>(c) * kBlock + tid];
    // h block: 128 rows x 64 columns; columns past d read as zero.
#pragma unroll 4
    for (int i = 0; i < kBlock * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / kBN;
      const int n = idx % kBN;
      const int col = n0 + n;
      s.h[k][n] = col < d ? hc[static_cast<size_t>(k) * d + col] : 0.f;
    }
    __syncthreads();

    // Logits and p: warp `warp` takes rows warp * 16 .. +15, lane takes
    // columns 4 * lane .. +3 of each.
    const float4 elv = *reinterpret_cast<const float4*>(&s.el[lane * 4]);
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int i = warp * kRowsPerWarp + q;
      const float4 av = *reinterpret_cast<const float4*>(a + i * kBlock + lane * 4);
      const float eri = s.er[i];
      const bool e0 = av.x != 0.f, e1 = av.y != 0.f, e2 = av.z != 0.f, e3 = av.w != 0.f;
      const float x0 = e0 ? activation<ACT>(eri + elv.x, slope) : -INFINITY;
      const float x1 = e1 ? activation<ACT>(eri + elv.y, slope) : -INFINITY;
      const float x2 = e2 ? activation<ACT>(eri + elv.z, slope) : -INFINITY;
      const float x3 = e3 ? activation<ACT>(eri + elv.w, slope) : -INFINITY;
      float mx = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s.m[i];
      const float m_new = fmaxf(fmaxf(m_old, mx), -1e30f);
      float4 pv;
      pv.x = e0 ? expf(x0 - m_new) : 0.f;
      pv.y = e1 ? expf(x1 - m_new) : 0.f;
      pv.z = e2 ? expf(x2 - m_new) : 0.f;
      pv.w = e3 ? expf(x3 - m_new) : 0.f;
      *reinterpret_cast<float4*>(&s.p[i][lane * 4]) = pv;
      float sum = (pv.x + pv.y) + (pv.z + pv.w);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();  // every lane has read s.m[i] before lane 0 replaces it
      if (lane == 0) {
        const float sc = expf(m_old - m_new);
        s.scale[i] = sc;
        s.l[i] = s.l[i] * sc + sum;
        s.m[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * scale + p @ h_C
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float sc = s.scale[ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] *= sc;
    }
    for (int k = 0; k < kBlock; k += 4) {
      float4 pr[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&s.p[ty * kTM + i][k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 hv = *reinterpret_cast<const float4*>(&s.h[k + kk][tx * kTN]);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float pk = kk == 0 ? pr[i].x : kk == 1 ? pr[i].y : kk == 2 ? pr[i].z : pr[i].w;
          acc[i][0] = fmaf(pk, hv.x, acc[i][0]);
          acc[i][1] = fmaf(pk, hv.y, acc[i][1]);
          acc[i][2] = fmaf(pk, hv.z, acc[i][2]);
          acc[i][3] = fmaf(pk, hv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites el, h, p and scale
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = ty * kTM + i;
    const float denom = fmaxf(s.l[row], 1e-12f);
    float* o = out + (static_cast<size_t>(r) * kBlock + row) * d;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < d) o[col] = acc[i][j] / denom;
    }
  }
  if (kStats && blockIdx.y == 0 && tid < kBlock) {
    m_out[static_cast<size_t>(r) * kBlock + tid] = s.m[tid];
    l_out[static_cast<size_t>(r) * kBlock + tid] = s.l[tid];
  }
}

template <bool kStats>
int launch_gat(const float* tiles, const int* bcols, const int* rowptr, const float* er,
               const float* el, const float* h, float* out, float* m, float* l, int n_brows,
               int d, int act, float slope, int device, void* stream) {
  if (act != kLeakyRelu && act != kSigmoid) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = act == kSigmoid ? bsr_gat_kernel<kStats, kSigmoid>
                                      : bsr_gat_kernel<kStats, kLeakyRelu>;
  // above 48 KB a block's shared memory must be asked for (2 blocks fit an SM)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_brows, (d + kBN - 1) / kBN);
  kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      tiles, bcols, rowptr, er, el, h, out, m, l, d, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. `tiles` (nb, 128, 128) must be 16-byte aligned;
// `rowptr` has n_brows + 1 entries; `er` is (n_brows * 128,), `el`
// (n_cols_padded,), `h` (n_cols_padded, d) and `out` (n_brows * 128, d), all
// row-major float32; `act` is 0 (leaky-ReLU with `slope`) or 1 (sigmoid).
// Launches on `stream` of CUDA device `device` and returns the first error of
// selecting the device, configuring or launching.
extern "C" int dtt_bsr_gat_f32(const float* tiles, const int* bcols, const int* rowptr,
                               const float* er, const float* el, const float* h, float* out,
                               int n_brows, int d, int act, float slope, int device,
                               void* stream) {
  return launch_gat<false>(tiles, bcols, rowptr, er, el, h, out, nullptr, nullptr, n_brows, d,
                           act, slope, device, stream);
}

// As dtt_bsr_gat_f32, and also writes the row max `m` and normaliser `l`,
// each (n_brows * 128,).
extern "C" int dtt_bsr_gat_stats_f32(const float* tiles, const int* bcols, const int* rowptr,
                                     const float* er, const float* el, const float* h,
                                     float* out, float* m, float* l, int n_brows, int d,
                                     int act, float slope, int device, void* stream) {
  return launch_gat<true>(tiles, bcols, rowptr, er, el, h, out, m, l, n_brows, d, act, slope,
                          device, stream);
}
