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
// each thread block owns one (work item, 64-row half, feature slab): a run
// of consecutive tiles of one block-row (ops/bsr.py work_schedule), over
// which it keeps m and l in shared memory and acc in registers. A block-row
// with no tile (or only all-zero pad tiles) gives out = 0, m = -1e30 and
// l = 0, as the TPU kernel does.
//
// Bound on this card: at STAGATE's size (639 tiles, d = 512) the p @ h
// products are 10.7 GFLOP over ~83 MB: arithmetic sets the bound, 0.065 ms
// for float32-accurate products on the tensor cores (3xTF32, tf32x3.cuh)
// against 0.16 ms on the CUDA cores; the logits' activation, row max, exp
// and row sum are ~1 % of the FLOPs but run on the CUDA cores once per
// (tile, slab). What the design does about it:
// - p once per tile and slab: a slab is up to 128 columns (d cut into equal
//   slabs rounded to the 8 columns of an n-tile), so at d = 512 the logits
//   and exp are built 4 times per tile, not 8.
// - Balance: STAGATE's RCM tiling has a block-row of 51 tiles beside a mean
//   of 8. Rows longer than the schedule's chunk are cut into chunks; each
//   writes its unnormalised acc and its (m, l) to a scratch slot, and a
//   second kernel combines them in chunk order (no atomics: two runs are
//   bit-equal). With the 64-row halves, ~170 items x 2 x 4 slabs keep 2
//   blocks per SM busy.
// - p @ h on the tensor cores: mma.sync m16n8k8 in 3xTF32; the online
//   softmax rescale acc *= exp(m_old - m_new) runs on the accumulator
//   fragments.
// - Bytes and overlap: the kernel reads the edges as a bit mask
//   (bsr_edge_mask, 2 KB a tile instead of 64 KB), so shared memory holds a
//   4-stage cp.async ring of 32-row h slices, three slices ahead of the
//   product, and the next tile's mask and el land during the current
//   product.
// IEEE float32 logits with expf (no fast math): m and l feed the backward.
// What still holds it back (PERF.md): the logits are rebuilt for each of the
// d / 128 slabs, and with them the kernel issues ~45 instructions per HMMA
// (tools/sass_mix.py), against ~11 in the SpMM.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::Split;

constexpr int kBlock = 128;                     // tile edge (pallas_kernels.BLOCK)
constexpr int kRows = 64;                       // output rows per thread block
constexpr int kHalves = kBlock / kRows;         // thread blocks along a block-row
constexpr int kMinBlocks = 2;                   // thread blocks resident per SM
constexpr int kWords = kBlock / 32;             // edge-mask words per tile row
constexpr int kBK = 32;                         // h rows per pipeline stage
constexpr int kSteps = kBlock / kBK;            // stages per tile
constexpr int kStages = 4;                      // h slices in the ring
constexpr int kThreads = 256;                   // 8 warps: 2 along rows x 4 along columns
constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // logit rows each warp builds
constexpr int kPStride = kBlock + 4;            // = 4 (mod 32): A fragments without conflicts
constexpr int kSlab = 128;                      // feature columns of a thread block, at most
constexpr int kHStride = kSlab + 8;             // = 8 (mod 32): B fragments likewise
constexpr int kNT = kSlab / 8 / 4;              // n-tiles per warp at the widest slab
constexpr int kSmemFloats = kRows * kPStride + kStages * kBK * kHStride + 2 * kRows * kWords +
                            2 * kBlock + 4 * kRows;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

// thread blocks of one work item at width d: the row halves x the feature slabs
int blocks_per_item(int d) { return kHalves * tf32x3::n_slabs(d, kSlab); }

static_assert(kBlock == 32 * 4, "a warp covers a logit row with one float4 per lane");

enum Act { kLeakyRelu = 0, kSigmoid = 1 };  // ops/bsr.py GAT_ACTS

template <int ACT>
__device__ __forceinline__ float activation(float raw, float slope) {
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-raw));
  return raw >= 0.f ? raw : slope * raw;
}

// items[i] = {block-row, first tile, end tile, scratch slot or -1}; block
// blockIdx.x takes item blockIdx.x / (kHalves n_slabs), row half
// (blockIdx.x / n_slabs) % kHalves and feature slab blockIdx.x % n_slabs.
// An item of a split block-row writes its unnormalised acc and its m, l to
// slot `slot`.
template <bool kStats, int ACT, bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bsr_gat_kernel(const unsigned* __restrict__ mask, const int* __restrict__ bcols,
               const int4* __restrict__ items, const float* __restrict__ er,
               const float* __restrict__ el, const float* __restrict__ h,
               float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ part, float* __restrict__ part_m,
               float* __restrict__ part_l, int d, float slope) {
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                                  // [kRows][kPStride] p of the tile
  float* hs = ps + kRows * kPStride;                 // [kStages][kBK][kHStride] h slices
  unsigned* mks = reinterpret_cast<unsigned*>(hs + kStages * kBK * kHStride);  // [2][kRows][kWords]
  float* els = reinterpret_cast<float*>(mks + 2 * kRows * kWords);  // [2][kBlock] el of the tile
  float* ers = els + 2 * kBlock;                     // [kRows] destination logits
  float* ms = ers + kRows;                           // running row max
  float* ls = ms + kRows;                            // running row normaliser
  float* scs = ls + kRows;                           // exp(m_old - m_new) of the current tile

  const int ns = tf32x3::n_slabs(d, kSlab), w = tf32x3::slab_width(d, kSlab);
  const int slab = blockIdx.x % ns, half = (blockIdx.x / ns) % kHalves;
  const int4 item = items[blockIdx.x / (kHalves * ns)];
  const int n0 = slab * w;
  const int nnt = (min(w, d - n0) + 7) / 8;    // live n-tiles of this slab
  const int t_begin = item.y, nt = item.z - item.y;
  const size_t row0 = static_cast<size_t>(item.x) * kBlock + half * kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp % 2, wn = warp / 2;

  // the tile's edge mask (64 rows x 4 words) and el of its block-column
  auto load_mask = [&](int t, int buf) {
    if (tid < kRows)
      tf32x3::cp_async16(mks + (buf * kRows + tid) * kWords,
                         mask + (static_cast<size_t>(t) * kBlock + half * kRows + tid) * kWords,
                         true);
    else if (tid < kRows + kBlock / 4)
      tf32x3::cp_async16(els + buf * kBlock + (tid - kRows) * 4,
                         el + static_cast<size_t>(bcols[t]) * kBlock + (tid - kRows) * 4, true);
  };
  // each thread's share of an h slice: rows h_row + 8 i at column h_col (no
  // division in the loop)
  const int h_row = tid / (kSlab / 4), h_col = (tid % (kSlab / 4)) * 4;
  const bool h_live = kVec4 && h_col < w, h_in = n0 + h_col < d;
  auto load_h = [&](int step, int stage) {
    const int t = t_begin + step / kSteps, k0 = (step % kSteps) * kBK;
    const float* ht = h + (static_cast<size_t>(bcols[t]) * kBlock + k0) * d + n0;
    float* dst = hs + stage * kBK * kHStride;
    if (kVec4) {
      if (h_live) {
#pragma unroll
        for (int i = 0; i < kBK * kSlab / 4 / kThreads; ++i) {
          const int k = h_row + i * (kThreads / (kSlab / 4));
          tf32x3::cp_async16(dst + k * kHStride + h_col, h_in ? ht + k * d + h_col : h, h_in);
        }
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kBK * kSlab / kThreads; ++i) {
        const int idx = tid + i * kThreads, k = idx / kSlab;
        const int c = idx % kSlab, col = n0 + c;
        if (c < w)
          tf32x3::cp_async4(dst + k * kHStride + c, col < d ? ht - n0 + k * d + col : h, col < d);
      }
    }
  };

  if (tid < kRows) {
    ers[tid] = er[row0 + tid];
    ms[tid] = -1e30f;
    ls[tid] = 0.f;
  }
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int total = nt * kSteps;
  if (nt > 0) load_mask(t_begin, 0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_h(i, i);
    tf32x3::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    const int i = s / kSteps, kc = s % kSteps, buf = i & 1;
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s (and tile i's mask) landed; slice s - 1 and p are free
    if (kc == 0) {
      // Logits and p of tile i: warp `warp` takes rows warp * 8 .. +7, lane
      // takes columns 4 * lane .. +3 of each.
      const float4 elv = *reinterpret_cast<const float4*>(els + buf * kBlock + lane * 4);
      const unsigned* mk = mks + buf * kRows * kWords;
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int row = warp * kRowsPerWarp + q;
        const unsigned bits = mk[row * kWords + lane / 8] >> ((lane % 8) * 4);
        const float eri = ers[row];
        const bool e0 = bits & 1u, e1 = bits & 2u, e2 = bits & 4u, e3 = bits & 8u;
        const float x0 = e0 ? activation<ACT>(eri + elv.x, slope) : -INFINITY;
        const float x1 = e1 ? activation<ACT>(eri + elv.y, slope) : -INFINITY;
        const float x2 = e2 ? activation<ACT>(eri + elv.z, slope) : -INFINITY;
        const float x3 = e3 ? activation<ACT>(eri + elv.w, slope) : -INFINITY;
        float mx = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = ms[row];
        const float m_new = fmaxf(fmaxf(m_old, mx), -1e30f);
        float4 pv;
        pv.x = e0 ? expf(x0 - m_new) : 0.f;
        pv.y = e1 ? expf(x1 - m_new) : 0.f;
        pv.z = e2 ? expf(x2 - m_new) : 0.f;
        pv.w = e3 ? expf(x3 - m_new) : 0.f;
        *reinterpret_cast<float4*>(ps + row * kPStride + lane * 4) = pv;
        float sum = (pv.x + pv.y) + (pv.z + pv.w);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();  // every lane has read ms[row] before lane 0 replaces it
        if (lane == 0) {
          const float sc = expf(m_old - m_new);
          scs[row] = sc;
          ls[row] = ls[row] * sc + sum;
          ms[row] = m_new;
        }
      }
      __syncthreads();
      // acc *= exp(m_old - m_new), row by row of the accumulator fragments
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float s0 = scs[wm * 32 + mt * 16 + g], s1 = scs[wm * 32 + mt * 16 + g + 8];
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          acc[mt][q][0] *= s0;
          acc[mt][q][1] *= s0;
          acc[mt][q][2] *= s1;
          acc[mt][q][3] *= s1;
        }
      }
    }
    if (s + kStages - 1 < total) load_h(s + kStages - 1, (s + kStages - 1) % kStages);
    if (kc == 0 && i + 1 < nt) load_mask(t_begin + i + 1, buf ^ 1);
    tf32x3::cp_async_commit();

    // acc += p[:, slice] @ h[slice]
    const float* hb = hs + (s % kStages) * kBK * kHStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      Split af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* pr = ps + (wm * 32 + mt * 16 + g) * kPStride + kc * kBK + kk + t4;
        af[mt][0] = tf32x3::split(pr[0]);
        af[mt][1] = tf32x3::split(pr[8 * kPStride]);
        af[mt][2] = tf32x3::split(pr[4]);
        af[mt][3] = tf32x3::split(pr[8 * kPStride + 4]);
      }
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        const int j = wn + 4 * q;
        if (j < nnt) {
          const float* hr = hb + (kk + t4) * kHStride + j * 8 + g;
          const Split bf[2] = {tf32x3::split(hr[0]), tf32x3::split(hr[4 * kHStride])};
          tf32x3::mma_3xtf32(acc[0][q], af[0], bf);
          tf32x3::mma_3xtf32(acc[1][q], af[1], bf);
        }
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // ms, ls final (also for an item without tiles)

  const bool whole = item.w < 0;
  float* dst = whole ? out + row0 * d
                     : part + (static_cast<size_t>(item.w) * kBlock + half * kRows) * d;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lr = wm * 32 + mt * 16 + g + (e / 2) * 8;
      const float scale = whole ? 1.f / fmaxf(ls[lr], 1e-12f) : 1.f;
      float* o = dst + static_cast<size_t>(lr) * d;
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        const int j = wn + 4 * q, col = n0 + j * 8 + 2 * t4 + e % 2;
        if (j < nnt && col < d) o[col] = whole ? acc[mt][q][e] * scale : acc[mt][q][e];
      }
    }
  if (slab == 0 && tid < kRows) {
    if (!whole) {
      const size_t at = static_cast<size_t>(item.w) * kBlock + half * kRows + tid;
      part_m[at] = ms[tid];
      part_l[at] = ls[tid];
    } else if (kStats) {
      m_out[row0 + tid] = ms[tid];
      l_out[row0 + tid] = ls[tid];
    }
  }
}

// rows[i] = {block-row, first slot, chunks}: the block-row's softmax over all
// its chunks, from their (acc, m, l) in chunk order: M = max m_c,
// L = sum l_c exp(m_c - M), out = sum acc_c exp(m_c - M) / max(L, 1e-12).
template <bool kStats>
__global__ void __launch_bounds__(256)
bsr_gat_combine_kernel(const int4* __restrict__ rows, const float* __restrict__ part,
                       const float* __restrict__ part_m, const float* __restrict__ part_l,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int d) {
  const int4 row = rows[blockIdx.x];
  const size_t n = static_cast<size_t>(kBlock) * d;  // elements of a block-row
  const size_t e = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int i = static_cast<int>(e / d);
  float m = -1e30f;
  for (int c = 0; c < row.z; ++c) m = fmaxf(m, part_m[(row.y + c) * kBlock + i]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < row.z; ++c) {
    const float sc = expf(part_m[(row.y + c) * kBlock + i] - m);
    l += part_l[(row.y + c) * kBlock + i] * sc;
    acc += part[(row.y + c) * n + e] * sc;
  }
  out[row.x * n + e] = acc / fmaxf(l, 1e-12f);
  if (kStats && e % d == 0) {
    m_out[static_cast<size_t>(row.x) * kBlock + i] = m;
    l_out[static_cast<size_t>(row.x) * kBlock + i] = l;
  }
}

struct GatArgs {
  const unsigned* mask;
  const int* bcols;
  const int* items;
  int n_items;
  const int* rows;
  int n_rows;
  const float *er, *el, *h;
  float *out, *m, *l, *part, *part_m, *part_l;
  int d;
  float slope;
};

template <bool kStats, int ACT>
int launch_act(const GatArgs& a, cudaStream_t stream) {
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<size_t>(a.h) % 16 == 0;
  const auto kernel = vec4 ? bsr_gat_kernel<kStats, ACT, true>
                           : bsr_gat_kernel<kStats, ACT, false>;
  // above 48 KB a block's shared memory must be asked for (2 blocks fit an SM)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_items * blocks_per_item(a.d), kThreads, kSmemBytes, stream>>>(
      a.mask, a.bcols, reinterpret_cast<const int4*>(a.items), a.er, a.el, a.h, a.out, a.m, a.l,
      a.part, a.part_m, a.part_l, a.d, a.slope);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_rows == 0) return static_cast<int>(err);
  const dim3 grid(a.n_rows, (kBlock * a.d + 255) / 256);
  bsr_gat_combine_kernel<kStats><<<grid, 256, 0, stream>>>(
      reinterpret_cast<const int4*>(a.rows), a.part, a.part_m, a.part_l, a.out, a.m, a.l, a.d);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStats>
int launch_gat(const GatArgs& a, int act, int device, void* stream) {
  if (act != kLeakyRelu && act != kSigmoid) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_items <= 0 || a.d <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  return act == kSigmoid ? launch_act<kStats, kSigmoid>(a, s)
                         : launch_act<kStats, kLeakyRelu>(a, s);
}

}  // namespace

// C interface for ctypes. `mask` (nb, 128, 4) holds the edges tile != 0 as
// bits (bit j of word w of row i: column 32 w + j; ops/bsr.py bsr_edge_mask);
// `items` (n_items, 4) and `rows` (n_rows, 4) int32 come from the host
// schedule (ops/bsr.py work_schedule), which covers every block-row; `er` is
// (n_brows * 128,), `el` (n_cols_padded,) 16-byte aligned, `h`
// (n_cols_padded, d), `out` (n_brows * 128, d), `part` (slots, 128, d) and
// `part_m`, `part_l` (slots, 128), all row-major float32; `act` is 0
// (leaky-ReLU with `slope`) or 1 (sigmoid). Launches on `stream` of CUDA
// device `device` and returns the first error of selecting the device,
// configuring or launching.
extern "C" int dtt_bsr_gat_f32(const unsigned* mask, const int* bcols, const int* items,
                               int n_items, const int* rows, int n_rows, const float* er,
                               const float* el, const float* h, float* out, float* part,
                               float* part_m, float* part_l, int d, int act, float slope,
                               int device, void* stream) {
  const GatArgs a{mask, bcols, items, n_items, rows, n_rows, er, el, h, out, nullptr, nullptr,
                  part, part_m, part_l, d, slope};
  return launch_gat<false>(a, act, device, stream);
}

// As dtt_bsr_gat_f32, and also writes the row max `m` and normaliser `l`,
// each (n_brows * 128,).
extern "C" int dtt_bsr_gat_stats_f32(const unsigned* mask, const int* bcols, const int* items,
                                     int n_items, const int* rows, int n_rows, const float* er,
                                     const float* el, const float* h, float* out, float* m,
                                     float* l, float* part, float* part_m, float* part_l, int d,
                                     int act, float slope, int device, void* stream) {
  const GatArgs a{mask, bcols, items, n_items, rows, n_rows, er, el, h, out, m, l,
                  part, part_m, part_l, d, slope};
  return launch_gat<true>(a, act, device, stream);
}

// What the launch of the stats variant at width `d` (sigmoid) looks like on
// CUDA device `device`: info = {threads, dynamic shared memory bytes, blocks
// resident per SM, registers per thread, feature slabs, slab width, thread
// blocks per work item}; the host schedule (ops/bsr.py device_schedule) is
// sized from it. Returns the first error.
extern "C" int dtt_bsr_gat_info(int d, int* info, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || d <= 0) return static_cast<int>(err ? err : cudaErrorInvalidValue);
  const auto kernel = d % 4 == 0 ? bsr_gat_kernel<true, kSigmoid, true>
                                 : bsr_gat_kernel<true, kSigmoid, false>;
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
