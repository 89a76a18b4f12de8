// Flash backward of the fused single-head GAT (bsr_gat.cu) on Hopper, float32,
// over the edges. From the forward's row stats (m, l), the output cotangent g
// and r_i = g_i . out_i (computed by the caller), for each edge (i, j):
//   p_ij  = exp(act(er_i + el_j) - m_i) / max(l_i, 1e-12)
//   s_ij  = g_i . h_j
//   da_ij = p_ij (s_ij - r_i) act'(er_i + el_j)
// and der_i = sum_j da_ij, del_j = sum_i da_ij, dh_j = sum_i p_ij g_i.
//
// Replaces the TPU kernel `_gat_bwd_kernel` / `bsr_gat_grads` in
// dance_tpu/ops/pallas_kernels.py:471-566. That kernel makes one pass over the
// row-sorted tiles, computing s = g_R h_C^T and p^T g over all 128 x 128 slots
// of each tile, and accumulates del and dh into output blocks zeroed from
// first-visit flags (:530-535), which rests on the TPU's in-order grid.
//
// Bound on this card: the tiles are nearly empty (STAGATE's kNN graph puts
// ~94 edges in each tile's 16,384 slots), so the work is set by the edges:
// 4 nnz d operations (60,000 edges, d = 512: 0.12 GFLOP) against the bytes of
// g, h and dh (20.7 MB each), so bytes set it, ~0.02 ms at 3.35 TB/s. Thread
// blocks run in no order and float atomics would make sums change from run to
// run, so the design is two passes over edge lists built once per matrix
// (ops/bsr.py bsr_edges), each sum in edge order:
//   (1) one warp per row i holds g_i in registers and walks the row's edges:
//       h_j gathered (h stays in the 50 MB L2), s_ij by a warp reduction, then
//       p_ij and da_ij, written per edge (2 nnz floats, not a scratch of
//       (2, nb, 128, 128) slots), and der_i as their sum;
//   (2) one warp per column j walks the column's edges: del_j sums da_ij and
//       dh_j = sum p_ij g_i, g_i gathered from L2, written once.
// Every output element is written once by one warp, in a fixed order: no
// atomics, and the result is the same on every run. IEEE float32 with expf
// (no fast math, no TF32).
//
// Non-finite inputs. The plain version (and the TPU kernel) take s = g h^T and
// p^T g over whole tiles, so an off-edge slot of a stored tile adds
// 0 (s_ij - r_i) act' to der_i and del_j and 0 g_ik to dh_jk: NaN where
// s_ij - r_i is not finite (inf or NaN in g_i or h_j, r_i not finite, an
// overflowing dot), where act' is NaN (sigmoid of NaN logits), where p is NaN
// (l_i NaN, which clamp keeps), or where g_ik is not finite. The passes mark
// every row and column that could do so: g_i, h_j or r_i not finite or huge
// (|g_ik|, |h_jk| >= 2^40 or |r_i| >= 2^126; below those a dot of d < 2^31
// terms and s - r stay under FLT_MAX), l_i NaN, or for the sigmoid er_i,
// el_j not finite; and set a flag. (3) A third kernel always launches, returns
// at once when the flag is clear, and otherwise walks the off-edge slots of
// the marked rows and columns in their stored tiles and writes NaN where the
// plain version has it. It reads no flag on the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;               // tile edge (pallas_kernels.BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;      // rows (1), columns (2), slot pairs (3) at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPer = 16;                   // g_i / dh_j columns a lane holds: one chunk is 512
constexpr float kHuge = 1099511627776.f;   // 2^40: |g_ik|, |h_jk| at or past it are marked
constexpr float kHugeR = 8.507059173023462e37f;  // 2^126: |r_i| at or past it is marked

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

// the butterfly leaves the same bits in every lane (each step adds x + y and
// y + x)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool huge(float x) { return !(fabsf(x) < kHuge); }  // NaN too

// Pass 1: der, da and p per edge, and the row marks. kPer columns of g_i a
// lane: one chunk of 32 kPer columns stays in registers; wider rows reload
// each chunk per edge. Narrower rows leave the lanes' top columns idle.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
gat_bwd_row_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                   const float* __restrict__ er, const float* __restrict__ el,
                   const float* __restrict__ h, const float* __restrict__ g,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ r, float* __restrict__ da_out,
                   float* __restrict__ p_out, float* __restrict__ der, int* __restrict__ marks,
                   int n_rows, int d, float slope) {
  constexpr int kChunk = 32 * kPer;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n_rows) return;
  const float* gi = g + static_cast<size_t>(i) * d;
  float gv[kPer];
  bool big = false;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = c0 + lane + 32 * k;
      const float x = c < d ? gi[c] : 0.f;
      big |= huge(x);
      if (c0 == 0) gv[k] = x;
    }
  }
  const float er_i = er[i], m_i = m[i], l_i = l[i], r_i = r[i];
  const float lc = l_i != l_i ? l_i : fmaxf(l_i, 1e-12f);  // clamp(min=1e-12) keeps NaN
  const bool mark = __any_sync(kFull, big) || !(fabsf(r_i) < kHugeR) || l_i != l_i ||
                    (ACT == kSigmoid && !isfinite(er_i));
  if (lane == 0) {
    marks[1 + i] = mark;
    if (mark) marks[0] = 1;
  }

  const bool resident = d <= kChunk;
  const int e0 = rowptr[i], e1 = rowptr[i + 1];
  float acc = 0.f;
  for (int b0 = e0; b0 < e1; b0 += 32) {
    const int n = min(32, e1 - b0);
    int j_l = 0;
    float el_l = 0.f;
    if (lane < n) {
      j_l = cols[b0 + lane];
      el_l = el[j_l];
    }
    float da_l = 0.f, p_l = 0.f;
    for (int q = 0; q < n; ++q) {
      const int j = __shfl_sync(kFull, j_l, q);
      const float el_j = __shfl_sync(kFull, el_l, q);
      const float* hj = h + static_cast<size_t>(j) * d;
      float s = 0.f;
      for (int c0 = 0; c0 < d; c0 += kChunk) {
        if (!resident) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int c = c0 + lane + 32 * k;
            gv[k] = c < d ? gi[c] : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < d) s = fmaf(gv[k], hj[c], s);
        }
      }
      s = warp_sum(s);
      const float raw = er_i + el_j;
      const float p = expf(activation<ACT>(raw, slope) - m_i) / lc;
      const float da = p * (s - r_i) * activation_grad<ACT>(raw, slope);
      acc += da;
      if (lane == q) {
        da_l = da;
        p_l = p;
      }
    }
    if (lane < n) {
      da_out[b0 + lane] = da_l;
      p_out[b0 + lane] = p_l;
    }
  }
  if (lane == 0) der[i] = acc;
}

// Pass 2: del, dh and the column marks; kPer columns of dh_j a lane per chunk.
__global__ void __launch_bounds__(kThreads)
gat_bwd_col_kernel(const int* __restrict__ colptr, const int* __restrict__ colperm,
                   const int* __restrict__ rows, const float* __restrict__ da,
                   const float* __restrict__ p, const float* __restrict__ g,
                   const float* __restrict__ h, const float* __restrict__ el,
                   float* __restrict__ del, float* __restrict__ dh, int* __restrict__ marks,
                   int n_rows, int n_cols, int d, int sigmoid) {
  constexpr int kChunk = 32 * kPer;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * kWarps + threadIdx.x / 32;
  if (j >= n_cols) return;
  const float* hj = h + static_cast<size_t>(j) * d;
  bool big = false;
  for (int c = lane; c < d; c += 32) big |= huge(hj[c]);
  const bool mark = __any_sync(kFull, big) || (sigmoid && !isfinite(el[j]));
  if (lane == 0) {
    marks[1 + n_rows + j] = mark;
    if (mark) marks[0] = 1;
  }

  const int q0 = colptr[j], q1 = colptr[j + 1];
  float dl = 0.f;
  float* dhj = dh + static_cast<size_t>(j) * d;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
    for (int b0 = q0; b0 < q1; b0 += 32) {
      const int n = min(32, q1 - b0);
      int i_l = 0;
      float p_l = 0.f, da_l = 0.f;
      if (lane < n) {
        const int e = colperm[b0 + lane];
        i_l = rows[e];
        p_l = p[e];
        da_l = da[e];
      }
      if (c0 == 0) dl += warp_sum(da_l);  // lanes past n add 0
      for (int q = 0; q < n; ++q) {
        const int i = __shfl_sync(kFull, i_l, q);
        const float pv = __shfl_sync(kFull, p_l, q);
        const float* gi = g + static_cast<size_t>(i) * d;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < d) acc[k] = fmaf(pv, gi[c], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < d) dhj[c] = acc[k];
    }
  }
  if (lane == 0) del[j] = dl;
}

// Pass 3: NaN where the plain version's off-edge terms are NaN (see the top
// of the file). One thread block per stored tile; returns at once unless a
// row or column of the tile is marked.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
gat_bwd_repair_kernel(const float* __restrict__ tiles, const int* __restrict__ brows,
                      const int* __restrict__ bcols, const float* __restrict__ er,
                      const float* __restrict__ el, const float* __restrict__ h,
                      const float* __restrict__ g, const float* __restrict__ l,
                      const float* __restrict__ r, const int* __restrict__ marks,
                      float* __restrict__ der, float* __restrict__ del, float* __restrict__ dh,
                      int n_rows, int d, float slope) {
  if (marks[0] == 0) return;
  __shared__ int row_mark[kBlock], col_mark[kBlock];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = brows[t] * kBlock, col0 = bcols[t] * kBlock;
  static_assert(kThreads == 2 * kBlock, "one thread per row and column mark");
  const int mk = tid < kBlock ? marks[1 + row0 + tid] : marks[1 + n_rows + col0 + tid - kBlock];
  if (tid < kBlock) row_mark[tid] = mk;
  else col_mark[tid - kBlock] = mk;
  if (!__syncthreads_or(mk)) return;

  const float nan = __int_as_float(0x7fffffff);
  const float* a = tiles + static_cast<size_t>(t) * kBlock * kBlock;
  for (int slot = warp; slot < kBlock * kBlock; slot += kWarps) {
    const int ii = slot / kBlock, jj = slot % kBlock;
    if (!(row_mark[ii] || col_mark[jj]) || a[slot] != 0.f) continue;  // warp-uniform
    const int i = row0 + ii, j = col0 + jj;
    const float* gi = g + static_cast<size_t>(i) * d;
    const float* hj = h + static_cast<size_t>(j) * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(gi[c], hj[c], s);
    s = warp_sum(s);
    const float l_i = l[i];
    const float raw = er[i] + el[j];
    const bool bad = l_i != l_i || !isfinite(s - r[i]) || isnan(activation_grad<ACT>(raw, slope));
    if (bad && lane == 0) {  // 0 (s - r) act' or NaN (s - r) act'
      der[i] = nan;
      del[j] = nan;
    }
    if (row_mark[ii]) {  // 0 g_ik or NaN g_ik
      float* dhj = dh + static_cast<size_t>(j) * d;
      for (int c = lane; c < d; c += 32)
        if (l_i != l_i || !isfinite(gi[c])) dhj[c] = nan;
    }
  }
}

cudaError_t launch_passes(const float* tiles, const int* brows, const int* bcols,
                          const int* rowptr, const int* cols, const int* rows,
                          const int* colptr, const int* colperm, const float* er,
                          const float* el, const float* h, const float* g, const float* m,
                          const float* l, const float* r, float* da, float* p, int* marks,
                          float* der, float* del, float* dh, int nb, int n_rows, int n_cols,
                          int d, int act, float slope, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(marks, 0, sizeof(int), st);  // the flag
  if (err != cudaSuccess) return err;
  const int row_blocks = (n_rows + kWarps - 1) / kWarps;
  const int col_blocks = (n_cols + kWarps - 1) / kWarps;
  if (row_blocks > 0) {
    if (act == kSigmoid)
      gat_bwd_row_kernel<kSigmoid><<<row_blocks, kThreads, 0, st>>>(
          rowptr, cols, er, el, h, g, m, l, r, da, p, der, marks, n_rows, d, slope);
    else
      gat_bwd_row_kernel<kLeakyRelu><<<row_blocks, kThreads, 0, st>>>(
          rowptr, cols, er, el, h, g, m, l, r, da, p, der, marks, n_rows, d, slope);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (col_blocks > 0) {
    gat_bwd_col_kernel<<<col_blocks, kThreads, 0, st>>>(
        colptr, colperm, rows, da, p, g, h, el, del, dh, marks, n_rows, n_cols, d,
        act == kSigmoid);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nb > 0) {
    if (act == kSigmoid)
      gat_bwd_repair_kernel<kSigmoid><<<nb, kThreads, 0, st>>>(
          tiles, brows, bcols, er, el, h, g, l, r, marks, der, del, dh, n_rows, d, slope);
    else
      gat_bwd_repair_kernel<kLeakyRelu><<<nb, kThreads, 0, st>>>(
          tiles, brows, bcols, er, el, h, g, l, r, marks, der, del, dh, n_rows, d, slope);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// C interface for ctypes. `tiles` (nb, 128, 128) with `brows`, `bcols` (nb,);
// the edge lists of ops/bsr.py bsr_edges, int32: `rowptr` (n_rows + 1),
// `cols`, `rows`, `colperm` (nnz,) and `colptr` (n_cols + 1); `er`, `m`, `l`,
// `r`, `der` (n_rows,), `el`, `del` (n_cols,), `g` (n_rows, d), `h` and `dh`
// (n_cols, d), row-major float32; `per_edge` (2, nnz) float32 scratch (da,
// p) and `marks` (1 + n_rows + n_cols) int32 scratch. `act` is 0 (leaky-ReLU
// with `slope`) or 1 (sigmoid). Launches the three passes in order on
// `stream` of CUDA device `device` and returns the first error.
extern "C" int dtt_bsr_gat_grads_f32(const float* tiles, const int* brows, const int* bcols,
                                     const int* rowptr, const int* cols, const int* rows,
                                     const int* colptr, const int* colperm, const float* er,
                                     const float* el, const float* h, const float* g,
                                     const float* m, const float* l, const float* r,
                                     float* per_edge, int* marks, float* der, float* del,
                                     float* dh, int nb, int nnz, int n_rows, int n_cols, int d,
                                     int act, float slope, int device, void* stream) {
  if ((act != kLeakyRelu && act != kSigmoid) || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  float* da = per_edge;
  float* p = per_edge + nnz;
  return static_cast<int>(launch_passes(tiles, brows, bcols, rowptr, cols, rows, colptr,
                                        colperm, er, el, h, g, m, l, r, da, p, marks, der, del,
                                        dh, nb, n_rows, n_cols, d, act, slope, st));
}
