// Copyright (c) 2026 touchnet_tpu authors.
// K3: fused lm-head + cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of touchnet_tpu/ops/fused_ce.py: _fwd_kernel
// (:86, launched at :144) and _bwd_kernel (:175, launched at :250). Per row n
// of h [N, E] against the head w [V, E], without ever holding the [N, V]
// logits t = h w^T in device memory:
//   forward:  lse = log sum_v exp(t), true_logit = t[label] (0 when the
//             label is outside [0, V)), the row max m (returned as m2 =
//             m * log2(e), base 2, as the JAX kernel does) and argmax, ties
//             to the smallest index. All statistics in f32.
//   backward: dl = dlse * exp(t - lse) + dtl * onehot(label), in f32, then
//             cast to the input dtype (the JAX kernel's .astype(h.dtype));
//             dh = dl w, dw = dl^T h, both accumulated in f32. The logits
//             tile is recomputed from h and w; the chain up to dl stays f32
//             (fused_ce.py:191-199: a bf16 chain cost 2.5 % error).
//
// What bounds it on this card: the products. At N=16384, E=2048, V=128256
// the forward is 8.6 TFLOP and the backward 26 TFLOP (recompute, dh, dw).
//
// Inputs bf16, f16 or f32. Every 16-bit path is one body for bf16 and f16
// (the element type T: wmma fragments, wgmma's operand type, the tensor
// map's data type, the packing of dl and dh). In f16 the kernel rounds to
// f16 only what JAX's kernel rounds (fused_ce.py:216): dl, and the outputs
// dh and (in the wrapper, from the f32 sum) dw. Logits, lse and every row
// statistic stay f32, so no f16 logit can overflow. Over a row, sum_v |dl|
// <= |dlse| + |dtl|, so |dh| <= (|dlse| + |dtl|) max |w|, and |dw| <= sum_r
// (|dlse_r| + |dtl_r|) max |h|: for a loss averaged over the batch's tokens
// the row gradients sum to about 1, so both stay near the scale of w and h,
// far from 65504. At the other end dl = dlse p is ~1/N of p: at N 16384 and
// V 128256 most of it lies below f16's 2^-24 and flushes to 0 where bf16
// keeps it, as it does in JAX; the port follows JAX (no loss scaling).
//
// 16-bit operands with 16-byte aligned rows (E a multiple of 8; the wrapper
// chooses by shape, ops/fused_ce.fwd_plan and bwd_plan) run on one Hopper
// mainloop, ce_gemm, in both directions. A block owns a 128-row tile and a
// run of 256-column tiles (one tile in the backward, a vocab split in the
// forward). Its producer warp keeps TMA loads of 64-deep K slabs in flight
// into a ring of kGemmStages slots of 128-byte-swizzled shared memory
// (mbarriers mark slots full and empty; the ring's position and phase
// follow a slab counter over the block's whole run, so the next tile's
// first slabs load while the consumers run the last tile's epilogue); two
// consumer warpgroups each issue wgmma m64n256k16 on their 64 rows (bf16
// or f16 in, f32 accumulators in registers), keeping one slab's products in
// flight while they wait for the next slab. Operands are read in place in
// either majorness (wgmma transposes through the descriptor, hopper.cuh):
// the logits t = h w^T read h and w K-major; dh = dl w reads dl K-major and
// w MN-major; dw += dl^T h reads dl and h MN-major. TMA zero-fills boxes
// past every edge, so any N, V and row count runs. The mainloop is a kernel
// template over an epilogue class, which works on the f32 accumulators in
// registers after each tile and masks rows and columns past the edge:
//   - RowStatsOp (forward): per row, the tile's max and its first column,
//     one rescale of the running sum-exp to the new max, the tile's exp2
//     sum and the label logit; the running (max, sum, label logit, argmax)
//     of the thread's two rows stay in registers across the split's tiles,
//     and the four lanes holding a row merge once at the end;
//   - DlogitsOp forms dl in f32 and casts it to T once, DhOp stores dh
//     in T, DwOp adds into the f32 dw.
//
// The 64x64 tile kernels stay for the other shapes: f32 operands on FMAs
// (mma_tile, 4x4 per thread; TF32 would round them), the exactness path,
// and bf16 or f16 with E not a multiple of 8, which TMA cannot describe,
// on nvcuda::wmma 16x16x16 fragments (mma_tile_tc<T>).
//
// The choices the TPU kernel's sequential grid does not force on it:
//   - Row tile x vocab split. A block per row tile that walked the whole
//     vocab would re-read W (525 MB in bf16) once per row tile. The forward
//     grid is (row tiles, vocab splits), row tiles fastest within a raster
//     group of row tiles, so the blocks in flight share a few stretches of
//     W and a few megabytes of h through L2; each block folds its split's
//     vocab tiles into per-row partial (max, sum-exp, label logit, argmax),
//     and ce_fwd_combine merges the splits (K4's split-KV pattern). Splits
//     are ordered by vocab index, so "first split holding the max" keeps
//     argmax ties on the smallest index.
//   - dw ownership. No atomics: the backward recomputes dl for a chunk of
//     rows into a scratch buffer [rows, ldl] in the input dtype (ldl = V
//     rounded up to 8 elements, so every row starts on 16 bytes; the
//     wrapper sizes the chunk to a memory budget, in whole row tiles), then
//     dh of those rows is written and the chunk's dl^T h added into an f32
//     dw, each output tile owned by one block. Chunks run in order on one
//     stream, so two runs give the same dw bit for bit.
//   - The vocab tail. V need not be a multiple of the tile; every loader
//     zero-fills beyond the edges and every epilogue masks columns >= V.
//     No shape falls back to the plain version.

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace tn {
namespace {

constexpr int kTile = 64;     // output tile: 64 x 64
constexpr int kKC = 32;       // K chunk per shared-memory stage
constexpr int kLds = kTile + 1;  // padded row of a stage: s[kk * kLds + r]
constexpr int kThreads = 256;    // thread (ty, tx) owns rows ty + 16i, cols tx + 16j
// bf16 / f16 stages of the tensor-core path: a k-contiguous operand is stored
// [64][kKC + 8], an r-contiguous one [kKC][64 + 8] (16-byte row padding,
// as wmma's ldm wants a multiple of 8 halves)
constexpr int kLdK = kKC + 8;
constexpr int kLdR = kTile + 8;
constexpr int kLdC = kTile + 4;  // f32 [64][68] staging of the output tile

// element (r, k) of a matrix stored with k contiguous: X[r * ld + k]
template <typename T>
struct RowLoader {
  const T* x;
  int64_t ld;
  int rows, K;
  __device__ void load(float* s, int r0, int k0) const {
    for (int i = threadIdx.x; i < kTile * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC;
      const int gr = r0 + r, gk = k0 + kk;
      s[kk * kLds + r] = (gr < rows && gk < K) ? to_f32(x[gr * ld + gk]) : 0.f;
    }
  }
  static constexpr bool kKContig = true;
  // 16-bit stage [64][kLdK]; one 16-byte vector per thread when the rows
  // are 16-byte aligned (vec), element by element at the edges
  __device__ void load_lp(T* s, int r0, int k0, bool vec) const {
    const int r = threadIdx.x / 4, kv = (threadIdx.x % 4) * 8;
    const int gr = r0 + r, gk = k0 + kv;
    if (vec && gr < rows && gk + 8 <= K) {
      *reinterpret_cast<int4*>(s + r * kLdK + kv) =
          *reinterpret_cast<const int4*>(x + gr * ld + gk);
      return;
    }
    for (int e = 0; e < 8; ++e)
      s[r * kLdK + kv + e] = (gr < rows && gk + e < K) ? x[gr * ld + gk + e]
                                                       : from_f32<T>(0.f);
  }
};

// element (r, k) of a matrix stored with r contiguous: X[k * ld + r]
template <typename T>
struct ColLoader {
  const T* x;
  int64_t ld;
  int rows, K;
  __device__ void load(float* s, int r0, int k0) const {
    for (int i = threadIdx.x; i < kTile * kKC; i += kThreads) {
      const int kk = i / kTile, r = i % kTile;
      const int gr = r0 + r, gk = k0 + kk;
      s[kk * kLds + r] = (gr < rows && gk < K) ? to_f32(x[(int64_t)gk * ld + gr]) : 0.f;
    }
  }
  static constexpr bool kKContig = false;
  // 16-bit stage [kKC][kLdR], vectors as RowLoader's
  __device__ void load_lp(T* s, int r0, int k0, bool vec) const {
    const int kk = threadIdx.x / 8, rv = (threadIdx.x % 8) * 8;
    const int gr = r0 + rv, gk = k0 + kk;
    if (vec && gk < K && gr + 8 <= rows) {
      *reinterpret_cast<int4*>(s + kk * kLdR + rv) =
          *reinterpret_cast<const int4*>(x + (int64_t)gk * ld + gr);
      return;
    }
    for (int e = 0; e < 8; ++e)
      s[kk * kLdR + rv + e] = (gk < K && gr + e < rows) ? x[(int64_t)gk * ld + gr + e]
                                                        : from_f32<T>(0.f);
  }
};

// 16-byte vector loads need 16-byte aligned rows: an aligned base and a
// leading dimension that is a multiple of 8 halves
__device__ __forceinline__ bool vec_ok(const void* x, int64_t ld) {
  return ld % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// acc[i][j] += sum_k A(m0 + ty + 16i, k) B(n0 + tx + 16j, k) over k < K,
// f32 operands: FMAs from f32 shared-memory stages
template <class LA, class LB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const LA& a, const LB& b,
                                         int m0, int n0, int K) {
  __shared__ float sA[kKC * kLds];
  __shared__ float sB[kKC * kLds];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    a.load(sA, m0, k0);
    b.load(sB, n0, k0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kk * kLds + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk * kLds + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The same product for bf16 or f16 operands (T) on tensor cores: wmma
// 16x16x16 fragments of T with f32 accumulation (bf16 x bf16 and f16 x f16
// products are exact in f32, so this differs from the FMA path only in
// summation order). Warp w owns rows 16 (w / 2) and columns 32 (w % 2) +
// {0, 16}; the tile goes through an f32 shared staging into the same
// acc[i][j] layout as mma_tile.
template <typename T, class LA, class LB>
__device__ __forceinline__ void mma_tile_tc(float (&acc)[4][4], const LA& a, const LB& b,
                                            int m0, int n0, int K) {
  using namespace nvcuda;
  constexpr int kStage = kTile * kLdK > kKC * kLdR ? kTile * kLdK : kKC * kLdR;
  __shared__ __align__(32) T sA[kStage];
  __shared__ __align__(32) T sB[kStage];
  __shared__ __align__(32) float sC[kTile * kLdC];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
  static_assert(kTile * kKC == 8 * kThreads, "one 8-element vector per thread and stage");
  const bool vec = vec_ok(a.x, a.ld) && vec_ok(b.x, b.ld);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    a.load_lp(sA, m0, k0, vec);
    b.load_lp(sB, n0, k0, vec);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      using ALayout = std::conditional_t<LA::kKContig, wmma::row_major, wmma::col_major>;
      using BLayout = std::conditional_t<LB::kKContig, wmma::col_major, wmma::row_major>;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> fa;
      if constexpr (LA::kKContig) wmma::load_matrix_sync(fa, sA + wm * 16 * kLdK + ks, kLdK);
      else wmma::load_matrix_sync(fa, sA + ks * kLdR + wm * 16, kLdR);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> fb;
        if constexpr (LB::kKContig) wmma::load_matrix_sync(fb, sB + n * kLdK + ks, kLdK);
        else wmma::load_matrix_sync(fb, sB + ks * kLdR + n, kLdR);
        wmma::mma_sync(c[j], fa, fb, c[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sC + wm * 16 * kLdC + wn * 32 + j * 16, c[j], kLdC,
                            wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += sC[(ty + 16 * i) * kLdC + tx + 16 * j];
  __syncthreads();  // sC is read before the next tile's store
}

// the tile product for element type T: tensor cores for bf16 and f16, FMAs
// for f32
template <typename T, class LA, class LB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const LA& a, const LB& b,
                                             int m0, int n0, int K) {
  if constexpr (std::is_same<T, float>::value) mma_tile(acc, a, b, m0, n0, K);
  else mma_tile_tc<T>(acc, a, b, m0, n0, K);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdParams {
  const void* h;       // [N, E]
  const void* w;       // [V, E]
  const int* labels;   // [N]
  float* pm;           // [splits, N] partial row max (natural units)
  float* pl;           // [splits, N] partial sum exp(t - pm)
  float* ptl;          // [splits, N] partial label logit
  int* pai;            // [splits, N] partial argmax
  float* lse;          // [N]
  float* tl;           // [N]
  float* m2;           // [N]
  int* ai;             // [N]
  int N, E, V, splits, tiles_per_split;
  int group;           // row tiles of one raster group of the mainloop's grid
};

// fold the row statistics of lane `lane ^ off` into this lane's: the larger
// max, both sums rescaled to it (a side still at -inf adds 0), the label
// logits added (one side holds it, the other 0), and on an equal max the
// smaller index
__device__ __forceinline__ void merge_lane_stats(float& m, float& l, float& tl, int& ai,
                                                 int off) {
  const float mo = __shfl_xor_sync(0xffffffffu, m, off);
  const float lo = __shfl_xor_sync(0xffffffffu, l, off);
  const float to = __shfl_xor_sync(0xffffffffu, tl, off);
  const int ao = __shfl_xor_sync(0xffffffffu, ai, off);
  const float mn = fmaxf(m, mo);
  const float a_self = m == -INFINITY ? 0.f : l * exp2f((m - mn) * kLog2e);
  const float a_other = mo == -INFINITY ? 0.f : lo * exp2f((mo - mn) * kLog2e);
  if (mo > m || (mo == m && ao < ai)) ai = ao;
  l = a_self + a_other;
  m = mn;
  tl += to;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_partial(FwdParams p) {
  __shared__ int sLab[kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * kTile;
  const int split = blockIdx.y;
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    sLab[threadIdx.x] = r < p.N ? p.labels[r] : -1;
  }
  __syncthreads();
  const RowLoader<T> a{static_cast<const T*>(p.h), p.E, p.N, p.E};
  const RowLoader<T> b{static_cast<const T*>(p.w), p.E, p.V, p.E};

  float m[4], l[4], tl[4];
  int ai[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    tl[i] = 0.f;
    ai[i] = INT_MAX;
  }
  const int vt0 = split * p.tiles_per_split;
  const int vt1 = min(vt0 + p.tiles_per_split, (p.V + kTile - 1) / kTile);
  for (int vt = vt0; vt < vt1; ++vt) {
    const int n0 = vt * kTile;
    float acc[4][4];
    zero(acc);
    tile_product<T>(acc, a, b, r0, n0, p.E);
    // online update over this thread's columns, in increasing index order:
    // strict > keeps the first (smallest) index of a tie
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lab = sLab[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col >= p.V) continue;
        const float t = acc[i][j];
        if (t > m[i]) {
          l[i] = l[i] * exp2f((m[i] - t) * kLog2e) + 1.f;
          m[i] = t;
          ai[i] = col;
        } else {
          l[i] += exp2f((t - m[i]) * kLog2e);
        }
        if (col == lab) tl[i] = t;
      }
    }
  }
  // combine the 16 threads of a row (16 consecutive lanes of one warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) merge_lane_stats(m[i], l[i], tl[i], ai[i], off);
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < p.N) {
      const int64_t o = (int64_t)split * p.N + r;
      p.pm[o] = m[i];
      p.pl[o] = l[i];
      p.ptl[o] = tl[i];
      p.pai[o] = ai[i];
    }
  }
}

__global__ void ce_fwd_combine(FwdParams p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.N) return;
  float mx = -INFINITY;
  int arg = 0;
  for (int s = 0; s < p.splits; ++s) {
    const float ms = p.pm[(int64_t)s * p.N + r];
    if (ms > mx) {  // the first split holding the max: the smallest index
      mx = ms;
      arg = p.pai[(int64_t)s * p.N + r];
    }
  }
  float l = 0.f, tl = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const int64_t o = (int64_t)s * p.N + r;
    const float ms = p.pm[o];
    if (ms != -INFINITY) l += p.pl[o] * exp2f((ms - mx) * kLog2e);
    tl += p.ptl[o];
  }
  p.lse[r] = mx + logf(l);
  p.tl[r] = tl;
  p.m2[r] = mx * kLog2e;
  p.ai[r] = arg;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdParams {
  const void* h;        // [N, E]
  const void* w;        // [V, E]
  const int* labels;    // [N]
  const float* lse;     // [N]
  const float* dlse;    // [N]
  const float* dtl;     // [N]
  void* dh;             // [N, E], input dtype
  float* dw;            // [V, E] f32
  void* dl;             // [chunk, ldl] scratch, input dtype
  int N, E, V, ldl;
  int c0, rows;         // this chunk: rows [c0, c0 + rows)
  int accumulate;       // dw += (1) or dw = (0)
};

// dl[r, v] for the chunk's rows, grid (vocab tiles, row tiles)
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dlogits(BwdParams p) {
  __shared__ int sLab[kTile];
  __shared__ float sLse[kTile], sDlse[kTile], sDtl[kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;  // row within the chunk
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    const bool ok = r < p.rows;
    const int g = p.c0 + r;
    sLab[threadIdx.x] = ok ? p.labels[g] : -1;
    sLse[threadIdx.x] = ok ? p.lse[g] * kLog2e : 0.f;
    sDlse[threadIdx.x] = ok ? p.dlse[g] : 0.f;
    sDtl[threadIdx.x] = ok ? p.dtl[g] : 0.f;
  }
  __syncthreads();
  const T* h = static_cast<const T*>(p.h) + (int64_t)p.c0 * p.E;
  const RowLoader<T> a{h, p.E, p.rows, p.E};
  const RowLoader<T> b{static_cast<const T*>(p.w), p.E, p.V, p.E};
  float acc[4][4];
  zero(acc);
  tile_product<T>(acc, a, b, r0, n0, p.E);
  T* dl = static_cast<T*>(p.dl);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i;
    const int r = r0 + rr;
    if (r >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= p.V) continue;
      float g = sDlse[rr] * exp2f(acc[i][j] * kLog2e - sLse[rr]);
      if (col == sLab[rr]) g += sDtl[rr];
      dl[(int64_t)r * p.ldl + col] = from_f32<T>(g);
    }
  }
}

// dh[c0 + r, e] = sum_v dl[r, v] w[v, e], grid (E tiles, row tiles)
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_gemm_dh(BwdParams p) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const RowLoader<T> a{static_cast<const T*>(p.dl), p.ldl, p.rows, p.V};
  const ColLoader<T> b{static_cast<const T*>(p.w), p.E, p.E, p.V};
  float acc[4][4];
  zero(acc);
  tile_product<T>(acc, a, b, m0, n0, p.V);
  T* dh = static_cast<T*>(p.dh) + (int64_t)p.c0 * p.E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = n0 + tx + 16 * j;
      if (e < p.E) dh[(int64_t)r * p.E + e] = from_f32<T>(acc[i][j]);
    }
  }
}

// dw[v, e] (+)= sum_r dl[r, v] h[c0 + r, e], grid (E tiles, vocab tiles)
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_gemm_dw(BwdParams p) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  const T* h = static_cast<const T*>(p.h) + (int64_t)p.c0 * p.E;
  const ColLoader<T> a{static_cast<const T*>(p.dl), p.ldl, p.V, p.rows};
  const ColLoader<T> b{h, p.E, p.E, p.rows};
  float acc[4][4];
  zero(acc);
  tile_product<T>(acc, a, b, m0, n0, p.rows);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = m0 + ty + 16 * i;
    if (v >= p.V) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = n0 + tx + 16 * j;
      if (e >= p.E) continue;
      float* o = p.dw + (int64_t)v * p.E + e;
      *o = p.accumulate ? *o + acc[i][j] : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper: the TMA + wgmma mainloop and its epilogues
// ---------------------------------------------------------------------------

constexpr int kGemmBM = 128, kGemmBN = 256, kGemmBK = 64, kGemmStages = 4;
constexpr int kGemmThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr uint32_t kGemmABytes = kGemmBM * kGemmBK * 2;  // 16 KB
constexpr uint32_t kGemmBBytes = kGemmBN * kGemmBK * 2;  // 32 KB
constexpr uint32_t kGemmStageBytes = kGemmABytes + kGemmBBytes;
constexpr size_t kGemmSmem = kGemmStages * kGemmStageBytes + 2 * kGemmStages * 8 + 1024;

// one k-slab of an operand tile of `rows` M or N indices: K-major as one box
// {64 k, rows}, MN-major as rows / 64 boxes {64 mn, 64 k}, 8 KB apart
template <int MN>
__device__ __forceinline__ void tma_operand(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            int rows, int r0, int k0) {
  if constexpr (MN) {
    for (int i = 0; i < rows / 64; ++i) tma_load_2d(dst + i * 8192, map, bar, r0 + 64 * i, k0);
  } else {
    tma_load_2d(dst, map, bar, k0, r0);
  }
}

// the descriptor of k-step ks (16 deep) of an operand tile (hopper.cuh)
template <int MN>
__device__ __forceinline__ uint64_t operand_desc(const uint8_t* tile, int ks) {
  return MN ? wgmma_desc(tile + ks * 2048, 8192, 1024) : wgmma_desc(tile + ks * 32, 16, 1024);
}

// a block's work: output row tile m and the column tiles [n, n + count)
struct TileRun {
  int m, n, count;
};

// For each column tile of the block's run: C[m, n] = sum_k A[m, k] B[n, k]
// over 128 x 256, then the epilogue on the accumulators. Op gives the
// operands' element type (Elem: bf16 or f16) and majorness (kAmn, kBmn),
// the block's run (tiles), the K extent,
// and an epilogue object per consumer thread: constructed with the thread's
// first row, called after every tile (epilogue) and once after the last
// (finish).
template <class Op>
__global__ void __launch_bounds__(kGemmThreads, 1)
    ce_gemm(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ typename Op::Params p) {
  extern __shared__ uint8_t gemm_smem[];
  uint8_t* base = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGemmStages * kGemmStageBytes);
  uint64_t* empty = full + kGemmStages;
  const int wg = threadIdx.x / 128;
  const TileRun run = Op::tiles(p);
  const int m0 = run.m * kGemmBM;
  const int nk = (Op::k_extent(p) + kGemmBK - 1) / kGemmBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // `it` counts slabs over the whole run: slot it % kGemmStages, lap
  // it / kGemmStages, whose parity each barrier wait names
  if (wg == 0) {  // producer: one thread keeps the ring full, across tiles
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = 0; t < run.count; ++t) {
        const int n0 = (run.n + t) * kGemmBN;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % kGemmStages;
          mbar_wait(&empty[s], ((it / kGemmStages) & 1) ^ 1);  // the first lap passes
          mbar_expect_tx(&full[s], kGemmStageBytes);
          uint8_t* a = base + s * kGemmStageBytes;
          tma_operand<Op::kAmn>(a, &map_a, &full[s], kGemmBM, m0, k * kGemmBK);
          tma_operand<Op::kBmn>(a + kGemmABytes, &map_b, &full[s], kGemmBN, n0, k * kGemmBK);
        }
      }
    }
  } else {  // consumers: warpgroup cw multiplies rows [64 cw, 64 cw + 64) of the tile
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    // accumulator layout: warp w of the warpgroup holds rows 16 w + lane / 4
    // (acc[4j], acc[4j + 1]) and + 8 (acc[4j + 2], acc[4j + 3]), at columns
    // 8 j + 2 (lane % 4) and + 1
    Op op(p, run, m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2));
    float acc[128];
    int it = 0;
    for (int t = 0; t < run.count; ++t) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % kGemmStages;
        mbar_wait(&full[s], (it / kGemmStages) & 1);
        // warpgroup cw's 64 rows: lines 64 cw.. of a K-major A, box cw of an
        // MN-major one; 8 KB in either layout
        const uint8_t* a = base + s * kGemmStageBytes + cw * 8192;
        const uint8_t* b = base + s * kGemmStageBytes + kGemmABytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kGemmBK / 16; ++ks)
          wgmma_m64n256k16<typename Op::Elem, Op::kAmn, Op::kBmn>(
              acc, operand_desc<Op::kAmn>(a, ks), operand_desc<Op::kBmn>(b, ks));
        wgmma_commit();
        wgmma_wait<1>();  // slab it - 1's products are done: its slot is free
        if (k > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kGemmStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      // the tile's last slab is free too: the producer fills it with the
      // next tile's slabs while this epilogue runs
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kGemmStages]);
      op.epilogue(acc, p, (run.n + t) * kGemmBN + 2 * (lane & 3));
    }
    op.finish(p);
  }
}

// Per row of h: the running (max, sum exp, label logit, argmax) over a
// vocab split's tiles, t = h w^T in f32, partials to [splits, N]. The grid
// is one block per (row tile, split): raster groups of `group` row tiles,
// row tiles fastest within a group, so the blocks in flight share a few
// stretches of w and the h rows of one group through L2.
template <typename T>
struct RowStatsOp {
  using Params = FwdParams;
  using Elem = T;
  static constexpr int kAmn = 0, kBmn = 0;
  __device__ static TileRun tiles(const Params& p) {
    const int row_tiles = (p.N + kGemmBM - 1) / kGemmBM;
    const int per_group = p.group * p.splits;
    const int g = blockIdx.x / per_group, in_group = blockIdx.x % per_group;
    const int rows = min(p.group, row_tiles - g * p.group);
    const int split = in_group / rows;
    const int n = split * p.tiles_per_split;
    return {g * p.group + in_group % rows, n,
            min(p.tiles_per_split, (p.V + kGemmBN - 1) / kGemmBN - n)};
  }
  __device__ static int k_extent(const Params& p) { return p.E; }

  int r, split;
  int lab[2];  // the label column, or -1 outside [0, V)
  float m[2], l[2], tl[2];
  int ai[2];

  __device__ RowStatsOp(const Params& p, const TileRun& run, int row)
      : r(row), split(run.n / p.tiles_per_split) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lb = row + 8 * i < p.N ? p.labels[row + 8 * i] : -1;
      lab[i] = lb >= 0 && lb < p.V ? lb : -1;
      m[i] = -INFINITY;
      l[i] = 0.f;
      tl[i] = 0.f;
      ai[i] = INT_MAX;
    }
  }

  // the thread's 64 columns c + 8 j + {0, 1} of rows r and r + 8
  __device__ void epilogue(const float (&acc)[128], const Params& p, int c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the tile's max over the thread's columns and its first index: the
      // scan runs in increasing column order, and strict > keeps the first
      float tmax = -INFINITY;
      int targ = INT_MAX;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c + 8 * j;
        const float t0 = acc[4 * j + 2 * i], t1 = acc[4 * j + 2 * i + 1];
        if (col < p.V && t0 > tmax) {
          tmax = t0;
          targ = col;
        }
        if (col + 1 < p.V && t1 > tmax) {
          tmax = t1;
          targ = col + 1;
        }
        if (col == lab[i]) tl[i] = t0;
        if (col + 1 == lab[i]) tl[i] = t1;
      }
      if (tmax > m[i]) ai[i] = targ;  // an equal max keeps the earlier tile's index
      const float mn = fmaxf(m[i], tmax);
      if (mn == -INFINITY) continue;  // none of the thread's columns is < V yet
      const float mn2 = mn * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c + 8 * j;
        if (col < p.V) sum += exp2f(fmaf(acc[4 * j + 2 * i], kLog2e, -mn2));
        if (col + 1 < p.V) sum += exp2f(fmaf(acc[4 * j + 2 * i + 1], kLog2e, -mn2));
      }
      l[i] = l[i] * exp2f((m[i] - mn) * kLog2e) + sum;  // m = -inf: 0 * 0
      m[i] = mn;
    }
  }

  // the four lanes of a quad hold one row's columns: merge them, then the
  // quad's first lane writes the row's partials of this split
  __device__ void finish(const Params& p) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      merge_lane_stats(m[i], l[i], tl[i], ai[i], 1);
      merge_lane_stats(m[i], l[i], tl[i], ai[i], 2);
      const int row = r + 8 * i;
      if ((threadIdx.x & 3) == 0 && row < p.N) {
        const int64_t o = (int64_t)split * p.N + row;
        p.pm[o] = m[i];
        p.pl[o] = l[i];
        p.ptl[o] = tl[i];
        p.pai[o] = ai[i];
      }
    }
  }
};

// One output tile per block for the backward's three products, in element
// type T.
template <typename T>
struct BwdTileOp {
  using Params = BwdParams;
  using Elem = T;
  int r;
  __device__ BwdTileOp(const Params&, const TileRun&, int row) : r(row) {}
  __device__ void finish(const Params&) {}
};

// dl[r, v] = dlse[r] exp(t[r, v] - lse[r]) + dtl[r] [v == label[r]], in f32,
// cast to T once; t = h w^T of the chunk's rows. Grid (row tiles, vocab
// tiles): the blocks in flight share one stretch of w through L2.
template <typename T>
struct DlogitsOp : BwdTileOp<T> {
  using Params = BwdParams;
  static constexpr int kAmn = 0, kBmn = 0;
  using BwdTileOp<T>::BwdTileOp;
  using BwdTileOp<T>::r;
  __device__ static TileRun tiles(const Params&) { return {(int)blockIdx.x, (int)blockIdx.y, 1}; }
  __device__ static int k_extent(const Params& p) { return p.E; }
  __device__ void epilogue(const float (&acc)[128], const Params& p, int c) const {
    T* dl = static_cast<T*>(p.dl);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      if (row >= p.rows) continue;
      const int gr = p.c0 + row;
      const int lab = p.labels[gr];
      const float lse2 = p.lse[gr] * kLog2e, dlse = p.dlse[gr], dtl = p.dtl[gr];
      T* out = dl + (int64_t)row * p.ldl;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c + 8 * j;  // even; col + 1 <= ldl - 1 whenever col < V
        if (col >= p.V) continue;
        float g0 = dlse * exp2f(acc[4 * j + 2 * i] * kLog2e - lse2);
        float g1 = dlse * exp2f(acc[4 * j + 2 * i + 1] * kLog2e - lse2);
        if (col == lab) g0 += dtl;
        if (col + 1 == lab) g1 += dtl;
        *reinterpret_cast<uint32_t*>(out + col) = pack2<T>(g0, g1);
      }
    }
  }
};

// dh[c0 + r, e] = sum_v dl[r, v] w[v, e]. Grid (E tiles, row tiles).
template <typename T>
struct DhOp : BwdTileOp<T> {
  using Params = BwdParams;
  static constexpr int kAmn = 0, kBmn = 1;
  using BwdTileOp<T>::BwdTileOp;
  using BwdTileOp<T>::r;
  __device__ static TileRun tiles(const Params&) { return {(int)blockIdx.y, (int)blockIdx.x, 1}; }
  __device__ static int k_extent(const Params& p) { return p.V; }
  __device__ void epilogue(const float (&acc)[128], const Params& p, int c) const {
    T* dh = static_cast<T*>(p.dh) + (int64_t)p.c0 * p.E;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c + 8 * j;  // E is a multiple of 8
        if (col < p.E)
          *reinterpret_cast<uint32_t*>(dh + (int64_t)row * p.E + col) =
              pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
};

// dw[v, e] (+)= sum_r dl[r, v] h[c0 + r, e]. Grid (E tiles, vocab tiles).
template <typename T>
struct DwOp : BwdTileOp<T> {
  using Params = BwdParams;
  static constexpr int kAmn = 1, kBmn = 1;
  using BwdTileOp<T>::BwdTileOp;
  using BwdTileOp<T>::r;
  __device__ static TileRun tiles(const Params&) { return {(int)blockIdx.y, (int)blockIdx.x, 1}; }
  __device__ static int k_extent(const Params& p) { return p.rows; }
  __device__ void epilogue(const float (&acc)[128], const Params& p, int c) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = r + 8 * i;
      if (v >= p.V) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c + 8 * j;
        if (col >= p.E) continue;
        float2* o = reinterpret_cast<float2*>(p.dw + (int64_t)v * p.E + col);
        float2 x = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        if (p.accumulate) {
          const float2 y = *o;
          x.x += y.x;
          x.y += y.y;
        }
        *o = x;
      }
    }
  }
};

template <class Op>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const typename Op::Params& p,
                        dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ce_gemm<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  ce_gemm<Op><<<grid, kGemmThreads, kGemmSmem, stream>>>(a, b, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wgmma(BwdParams p, int chunk, cudaStream_t stream) {
  const auto* h = static_cast<const T*>(p.h);
  CUtensorMap w_k, w_mn;  // w read K-major (logits) and MN-major (dh)
  if (!tensor_map<T>(&w_k, p.w, p.E, p.V, p.E, 64, kGemmBN) ||
      !tensor_map<T>(&w_mn, p.w, p.E, p.V, p.E, 64, 64))
    return cudaErrorInvalidValue;
  const int vt_m = (p.V + kGemmBM - 1) / kGemmBM, vt_n = (p.V + kGemmBN - 1) / kGemmBN;
  const int et_n = (p.E + kGemmBN - 1) / kGemmBN;
  for (int c0 = 0; c0 < p.N; c0 += chunk) {
    p.c0 = c0;
    p.rows = min(chunk, p.N - c0);
    p.accumulate = c0 > 0;
    // the chunk's rows only: boxes past them read zeros, never the stale
    // dl rows of an earlier, longer chunk
    CUtensorMap h_k, h_mn, dl_k, dl_mn;
    const T* hc = h + (int64_t)c0 * p.E;
    if (!tensor_map<T>(&h_k, hc, p.E, p.rows, p.E, 64, kGemmBM) ||
        !tensor_map<T>(&h_mn, hc, p.E, p.rows, p.E, 64, 64) ||
        !tensor_map<T>(&dl_k, p.dl, p.V, p.rows, p.ldl, 64, kGemmBM) ||
        !tensor_map<T>(&dl_mn, p.dl, p.V, p.rows, p.ldl, 64, 64))
      return cudaErrorInvalidValue;
    const int rt = (p.rows + kGemmBM - 1) / kGemmBM;
    cudaError_t err = launch_gemm<DlogitsOp<T>>(h_k, w_k, p, dim3(rt, vt_n), stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm<DhOp<T>>(dl_k, w_mn, p, dim3(et_n, rt), stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm<DwOp<T>>(dl_mn, h_mn, p, dim3(et_n, vt_m), stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_fwd_combine(const FwdParams& p, cudaStream_t stream) {
  ce_fwd_combine<<<(p.N + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_wgmma(const FwdParams& p, cudaStream_t stream) {
  CUtensorMap h_k, w_k;
  if (!tensor_map<T>(&h_k, p.h, p.E, p.N, p.E, 64, kGemmBM) ||
      !tensor_map<T>(&w_k, p.w, p.E, p.V, p.E, 64, kGemmBN))
    return cudaErrorInvalidValue;
  const int row_tiles = (p.N + kGemmBM - 1) / kGemmBM;
  cudaError_t err = launch_gemm<RowStatsOp<T>>(h_k, w_k, p, dim3(row_tiles * p.splits), stream);
  if (err != cudaSuccess) return err;
  return launch_fwd_combine(p, stream);
}

template <typename T>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.N + kTile - 1) / kTile, p.splits);
  ce_fwd_partial<T><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fwd_combine(p, stream);
}

template <typename T>
cudaError_t launch_bwd(BwdParams p, int chunk, cudaStream_t stream) {
  const int vtiles = (p.V + kTile - 1) / kTile;
  const int etiles = (p.E + kTile - 1) / kTile;
  for (int c0 = 0; c0 < p.N; c0 += chunk) {
    p.c0 = c0;
    p.rows = min(chunk, p.N - c0);
    p.accumulate = c0 > 0;
    const int rtiles = (p.rows + kTile - 1) / kTile;
    ce_bwd_dlogits<T><<<dim3(vtiles, rtiles), kThreads, 0, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ce_gemm_dh<T><<<dim3(etiles, rtiles), kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ce_gemm_dw<T><<<dim3(etiles, vtiles), kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tn

extern "C" int tn_ce_fwd(const void* h, const void* w, const int* labels,
                         float* pm, float* pl, float* ptl, int* pai,
                         float* lse, float* tl, float* m2, int* ai,
                         int N, int E, int V, int splits, int group, int dtype, int mainloop,
                         void* stream) {
  if (N <= 0 || E <= 0 || V <= 0 || splits <= 0 || group <= 0 || V > INT_MAX - tn::kGemmBN)
    return (int)cudaErrorInvalidValue;
  tn::FwdParams p{h, w, labels, pm, pl, ptl, pai, lse, tl, m2, ai, N, E, V, splits, 0, group};
  const int col_tile = mainloop == 1 ? tn::kGemmBN : tn::kTile;
  const int vtiles = (V + col_tile - 1) / col_tile;
  p.tiles_per_split = (vtiles + splits - 1) / splits;
  if (p.tiles_per_split * (splits - 1) >= vtiles)
    return (int)cudaErrorInvalidValue;  // an empty split would leave rows unset
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mainloop == 1) {  // TMA + wgmma: bf16 or f16, rows of h and w on 16 bytes
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
    const int row_tiles = (N + tn::kGemmBM - 1) / tn::kGemmBM;
    if ((dtype != tn::kBFloat16 && dtype != tn::kFloat16) || E % 8 != 0 || !aligned ||
        (int64_t)row_tiles * splits > INT_MAX)
      return (int)cudaErrorInvalidValue;
    p.group = min(group, row_tiles);
    return (int)(dtype == tn::kBFloat16 ? tn::launch_fwd_wgmma<__nv_bfloat16>(p, st)
                                        : tn::launch_fwd_wgmma<__half>(p, st));
  }
  if (mainloop != 0 || splits > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == tn::kBFloat16) return (int)tn::launch_fwd<__nv_bfloat16>(p, st);
  if (dtype == tn::kFloat16) return (int)tn::launch_fwd<__half>(p, st);
  if (dtype == tn::kFloat32) return (int)tn::launch_fwd<float>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tn_ce_bwd(const void* h, const void* w, const int* labels,
                         const float* lse, const float* dlse, const float* dtl,
                         void* dh, float* dw, void* dl_scratch,
                         int N, int E, int V, int chunk, int ldl, int dtype, int mainloop,
                         void* stream) {
  const int vtiles = (V + tn::kTile - 1) / tn::kTile;
  if (N <= 0 || E <= 0 || V <= 0 || chunk <= 0 || ldl < V || vtiles > 65535 ||
      (chunk + tn::kTile - 1) / tn::kTile > 65535)
    return (int)cudaErrorInvalidValue;
  tn::BwdParams p{h, w, labels, lse, dlse, dtl, dh, dw, dl_scratch, N, E, V, ldl, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mainloop == 1) {  // TMA + wgmma: bf16 or f16, rows of h, w and dl on 16 bytes
    const bool aligned = ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(dl_scratch)) & 15) == 0;
    if ((dtype != tn::kBFloat16 && dtype != tn::kFloat16) || E % 8 != 0 || ldl % 8 != 0 ||
        !aligned)
      return (int)cudaErrorInvalidValue;
    return (int)(dtype == tn::kBFloat16 ? tn::launch_bwd_wgmma<__nv_bfloat16>(p, chunk, st)
                                        : tn::launch_bwd_wgmma<__half>(p, chunk, st));
  }
  if (mainloop != 0) return (int)cudaErrorInvalidValue;
  if (dtype == tn::kBFloat16) return (int)tn::launch_bwd<__nv_bfloat16>(p, chunk, st);
  if (dtype == tn::kFloat16) return (int)tn::launch_bwd<__half>(p, chunk, st);
  if (dtype == tn::kFloat32) return (int)tn::launch_bwd<float>(p, chunk, st);
  return (int)cudaErrorInvalidValue;
}
