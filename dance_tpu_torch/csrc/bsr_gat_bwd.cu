// Flash backward of the fused single-head GAT (bsr_gat.cu) on Hopper,
// float32. From the forward's row stats (m, l), the output cotangent g and
// r_i = g_i . out_i (computed by the caller), per nonzero tile (R, C):
//   p  = exp(act(er_i + el_j) - m_i) / max(l_i, 1e-12)   on the edges tile != 0
//   s  = g_R h_C^T
//   da = p * (s - r_i) * act'(er_i + el_j)
// and der sums da over each row, del over each column, dh_C = sum_R p^T g_R.
//
// Replaces the TPU kernel `_gat_bwd_kernel` / `bsr_gat_grads` in
// dance_tpu/ops/pallas_kernels.py:471-566. That kernel makes one pass over
// the row-sorted tiles and accumulates del and dh into output blocks indexed
// by block-column, zeroing them from first-visit flags (:530-535); the visits
// of a column are not consecutive, so the sums rest on the TPU's in-order grid
// (and on its reloading a revisited output block). Thread blocks here run in
// no order and float atomics would make the sums change from run to run, so
// the work is split into three passes whose summation order is fixed:
//   (a) one thread block per nonzero tile computes s (an SDDMM, as in
//       bsr_sddmm.cu), then p and da, and writes both tiles to a scratch
//       buffer (2, nb, 128, 128) that the caller allocates;
//   (b) one thread block per block-row walks its tiles through `rowptr` and
//       sums the da rows into der;
//   (c) one thread block per (block-column, 64-column feature tile) walks the
//       column's tiles through the column order (`colptr`, `colperm`) and
//       accumulates dh_C = sum p^T g_R as the SpMM does; the blocks of
//       feature tile 0 also sum the da columns into del.
// Every output element is written once by one thread, in a fixed order: no
// atomics, and the result is the same on every run.
//
// Bound on this card: at STAGATE's size (~554 tiles, d = 512) passes (a) and
// (c) are each 2 * 554 * 128 * 128 * 512 = 9.3 GFLOP of float32 FMA, so the
// whole is bounded by CUDA-core float32 throughput, as the forward is; the
// scratch round trip (~73 MB written, read back by (b) and (c), largely from
// the 50 MB L2) costs a few tens of microseconds at 3.35 TB/s. Both products
// keep 8 x 8 (a) or 8 x 4 (c) output patches in registers and read shared
// memory as float4. IEEE float32 with expf (no fast math, no TF32).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;           // tile edge (pallas_kernels.BLOCK)
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kBK = 32;               // feature (a) or tile-row (c) slice per step
constexpr int kStride = kBlock + 4;   // padding spreads the transposing stores
constexpr int kBN = 64;               // dh columns per thread block in (c)
constexpr int kT = 8;                 // (a): 8 x 8 entries of s per thread
constexpr int kTM = 8;                // (c): 8 x 4 entries of dh per thread
constexpr int kTN = 4;

static_assert(kBlock == 16 * kT && kBN == 16 * kTN, "thread grid must cover the tile");

enum Act { kLeakyRelu = 0, kSigmoid = 1 };  // ops/bsr.py GAT_ACTS

template <int ACT>
__device__ __forceinline__ float activation(float raw, float slope) {
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-raw));
  return raw >= 0.f ? raw : slope * raw;
}

template <int ACT>
__device__ __forceinline__ float activation_grad(float raw, float slope) {
  if (ACT == kSigmoid) {
    const float sg = 1.f / (1.f + expf(-raw));
    return sg * (1.f - sg);
  }
  return raw >= 0.f ? 1.f : slope;
}

// (a) s = g_R h_C^T, then p and da of tile t into the scratch buffer.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
gat_bwd_tile_kernel(const float* __restrict__ tiles, const int* __restrict__ brows,
                    const int* __restrict__ bcols, const float* __restrict__ er,
                    const float* __restrict__ el, const float* __restrict__ h,
                    const float* __restrict__ g, const float* __restrict__ m,
                    const float* __restrict__ l, const float* __restrict__ r,
                    float* __restrict__ da_out, float* __restrict__ p_out, int d,
                    float slope) {
  __shared__ __align__(16) float gs[kBK][kStride];  // gs[k][i] = g[R * 128 + i][d0 + k]
  __shared__ __align__(16) float hs[kBK][kStride];  // hs[k][j] = h[C * 128 + j][d0 + k]
  __shared__ float er_s[kBlock], m_s[kBlock], l_s[kBlock], r_s[kBlock], el_s[kBlock];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t row0 = static_cast<size_t>(brows[t]) * kBlock;
  const size_t col0 = static_cast<size_t>(bcols[t]) * kBlock;
  if (tid < kBlock) {
    er_s[tid] = er[row0 + tid];
    m_s[tid] = m[row0 + tid];
    l_s[tid] = fmaxf(l[row0 + tid], 1e-12f);
    r_s[tid] = r[row0 + tid];
    el_s[tid] = el[col0 + tid];
  }
  __syncthreads();
  const float* gr = g + row0 * d;
  const float* hc = h + col0 * d;

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
      const int row = idx / kBK;
      const int k = idx % kBK;
      const int col = d0 + k;
      const bool in = col < d;
      gs[k][row] = in ? gr[static_cast<size_t>(row) * d + col] : 0.f;
      hs[k][row] = in ? hc[static_cast<size_t>(row) * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[k][ty * kT]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gs[k][ty * kT + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&hs[k][tx * kT]);
      const float4 b1 = *reinterpret_cast<const float4*>(&hs[k][tx * kT + 4]);
      const float av[kT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* a = tiles + static_cast<size_t>(t) * kBlock * kBlock;
  float* dat = da_out + static_cast<size_t>(t) * kBlock * kBlock;
  float* pt = p_out + static_cast<size_t>(t) * kBlock * kBlock;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = ty * kT + i;
    const float4 t0 = *reinterpret_cast<const float4*>(a + row * kBlock + tx * kT);
    const float4 t1 = *reinterpret_cast<const float4*>(a + row * kBlock + tx * kT + 4);
    const float tv[kT] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    float pv[kT], dv[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float raw = er_s[row] + el_s[tx * kT + j];
      const float p = tv[j] != 0.f
          ? expf(activation<ACT>(raw, slope) - m_s[row]) / l_s[row] : 0.f;
      pv[j] = p;
      dv[j] = p * (acc[i][j] - r_s[row]) * activation_grad<ACT>(raw, slope);
    }
    float4* prow = reinterpret_cast<float4*>(pt + row * kBlock + tx * kT);
    float4* drow = reinterpret_cast<float4*>(dat + row * kBlock + tx * kT);
    prow[0] = make_float4(pv[0], pv[1], pv[2], pv[3]);
    prow[1] = make_float4(pv[4], pv[5], pv[6], pv[7]);
    drow[0] = make_float4(dv[0], dv[1], dv[2], dv[3]);
    drow[1] = make_float4(dv[4], dv[5], dv[6], dv[7]);
  }
}

// (b) der[R * 128 + i] = sum over the block-row's tiles of sum_j da[t][i][j].
__global__ void __launch_bounds__(kThreads)
gat_bwd_row_kernel(const int* __restrict__ rowptr, const float* __restrict__ da,
                   float* __restrict__ der) {
  const int rb = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kRowsPerWarp = kBlock / (kThreads / 32);
  float part[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) part[q] = 0.f;
  const int t_end = rowptr[rb + 1];
  for (int t = rowptr[rb]; t < t_end; ++t) {
    const float* dat = da + static_cast<size_t>(t) * kBlock * kBlock;
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      const int i = warp * kRowsPerWarp + q;
      const float4 v = *reinterpret_cast<const float4*>(dat + i * kBlock + lane * 4);
      part[q] += (v.x + v.y) + (v.z + v.w);
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    float sum = part[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) der[static_cast<size_t>(rb) * kBlock + warp * kRowsPerWarp + q] = sum;
  }
}

// (c) dh_C[:, n0:n0+64] = sum over the column's tiles of p_t^T g_R, and (feature
// tile 0) del[C * 128 + j] = sum over the column's tiles of sum_i da[t][i][j].
__global__ void __launch_bounds__(kThreads)
gat_bwd_col_kernel(const int* __restrict__ brows, const int* __restrict__ colptr,
                   const int* __restrict__ colperm, const float* __restrict__ da,
                   const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ del, float* __restrict__ dh, int d) {
  __shared__ __align__(16) float as[kBK][kStride];  // as[k][j] = p_t[k0 + k][j]
  __shared__ __align__(16) float bs[kBK][kBN];      // bs[k][n] = g[R * 128 + k0 + k][n0 + n]

  const int cb = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const bool sum_del = blockIdx.y == 0;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float col_sum = 0.f;

  const int q_end = colptr[cb + 1];
  for (int q = colptr[cb]; q < q_end; ++q) {
    const int t = colperm[q];
    const float* pt = p + static_cast<size_t>(t) * kBlock * kBlock;
    const float* gr = g + static_cast<size_t>(brows[t]) * kBlock * d;
    if (sum_del && tid < kBlock) {
      const float* dat = da + static_cast<size_t>(t) * kBlock * kBlock;
      float s = 0.f;
      for (int i = 0; i < kBlock; ++i) s += dat[i * kBlock + tid];
      col_sum += s;
    }
    for (int k0 = 0; k0 < kBlock; k0 += kBK) {
      // p rows k0 .. k0 + 31 are A^T's columns: copied as they are.
#pragma unroll
      for (int i = 0; i < kBlock * kBK / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int k = idx / (kBlock / 4);
        const int j = (idx % (kBlock / 4)) * 4;
        *reinterpret_cast<float4*>(&as[k][j]) =
            *reinterpret_cast<const float4*>(pt + (k0 + k) * kBlock + j);
      }
      // g slice: 32 rows x 64 columns; columns past d read as zero.
#pragma unroll
      for (int i = 0; i < kBK * kBN / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int k = idx / kBN;
        const int n = idx % kBN;
        const int col = n0 + n;
        bs[k][n] = col < d ? gr[static_cast<size_t>(k0 + k) * d + col] : 0.f;
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
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* o = dh + (static_cast<size_t>(cb) * kBlock + ty * kTM + i) * d;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < d) o[col] = acc[i][j];
    }
  }
  if (sum_del && tid < kBlock) del[static_cast<size_t>(cb) * kBlock + tid] = col_sum;
}

}  // namespace

// C interface for ctypes. `tiles` (nb, 128, 128) and `scratch` (2, nb, 128,
// 128) must be 16-byte aligned; `brows`, `bcols` (nb,), `rowptr` (n_brows + 1),
// `colptr` (n_bcols + 1) and `colperm` (nb,) int32, the tiles of block-column c
// being colperm[colptr[c]:colptr[c + 1]]; `er`, `m`, `l`, `r`, `der` are
// (n_brows * 128,), `el`, `del` (n_bcols * 128,), `g` (n_brows * 128, d), `h`
// and `dh` (n_bcols * 128, d), all row-major float32; `act` is 0 (leaky-ReLU
// with `slope`) or 1 (sigmoid). Launches the three passes in order on `stream`
// of CUDA device `device` and returns the first error.
extern "C" int dtt_bsr_gat_grads_f32(const float* tiles, const int* brows, const int* bcols,
                                     const int* rowptr, const int* colptr, const int* colperm,
                                     const float* er, const float* el, const float* h,
                                     const float* g, const float* m, const float* l,
                                     const float* r, float* scratch, float* der, float* del,
                                     float* dh, int nb, int n_brows, int n_bcols, int d,
                                     int act, float slope, int device, void* stream) {
  if (act != kLeakyRelu && act != kSigmoid) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* da = scratch;
  float* p = scratch + static_cast<size_t>(nb) * kBlock * kBlock;
  if (nb > 0) {
    if (act == kSigmoid)
      gat_bwd_tile_kernel<kSigmoid><<<nb, kThreads, 0, st>>>(
          tiles, brows, bcols, er, el, h, g, m, l, r, da, p, d, slope);
    else
      gat_bwd_tile_kernel<kLeakyRelu><<<nb, kThreads, 0, st>>>(
          tiles, brows, bcols, er, el, h, g, m, l, r, da, p, d, slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gat_bwd_row_kernel<<<n_brows, kThreads, 0, st>>>(rowptr, da, der);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_bcols, (d + kBN - 1) / kBN);
  gat_bwd_col_kernel<<<grid, kThreads, 0, st>>>(brows, colptr, colperm, da, p, g, del, dh, d);
  return static_cast<int>(cudaGetLastError());
}
