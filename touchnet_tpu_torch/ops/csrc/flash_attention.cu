// Copyright (c) 2026 touchnet_tpu authors.
// K1: packed-document flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels of touchnet_tpu/ops/attention.py:
// _fwd_kernel_dyn (:269, launched by _fwd_dyn_core :454) and its
// static-grid twin _fwd_kernel (:159). Same contract: a query row attends
// a key column iff q_seg == kv_seg (segment 0 is padding and only matches
// itself) and, when causal, q_offset + row >= kv_offset + col. Returns out
// in the input dtype and lse in f32, base e.
//
// Two kernels, by input type (inputs bf16, f16 or f32):
//   - bf16 and f16 (every such call): flash_fwd_mma_kernel<T>, one body
//     for both types, on the tensor cores.
//   - f32: flash_fwd_kernel, f32 FMAs from shared memory: the exactness
//     path behind the f32 checks (1e-4), unchanged from the first version.
//
// f16 (the JAX package's float16, which its kernel runs with the f32
// softmax chain, attention.py:343): the only values the kernel rounds to
// f16 are P, for the PV product, and out. P = exp2(s - m) lies in [0, 1],
// so it cannot reach f16's 65504; entries below 2^-24 flush to 0, as JAX's
// p.astype(v.dtype) does. out is the f32 sum of P V over the f32 sum of P,
// a convex combination of rows of v, so |out| <= max |v|, itself an f16
// value. Scores, the running max and sum, and lse stay f32.
//
// What bounds it on this card: the two products QK^T and PV, 4·D flops per
// live (row, column) pair. At the training shape (T 16384, D 64, 10
// documents) that is ~0.2 ms of bf16 tensor-core time against ~0.05 ms of
// bytes, so the kernel is bound by operations, and what matters is how
// close the products come to the tensor cores' rate. The FMA version ran
// at ~15 TFLOP/s, two shared-memory loads per four FMAs.
//
// What the tensor-core design does about it (mma.sync, ldmatrix, cp.async: the
// sm_80 instruction set, which Hopper runs at a fraction of wgmma's peak; a
// wgmma/TMA pipeline is later work):
//   - One block of 4 warps per (batch, kv head, 64 query rows); the rows
//     are the G = H/Hkv query heads of the kv head x (64 / G) positions,
//     so each K/V tile is loaded once for the whole GQA group. Small blocks,
//     four (D 64) or two (D 128) to an SM, because the walk is bound by
//     latency (barrier, copies, exponentials) more than by the products: on
//     an H100 80GB HBM3 (700 W), 4 warps x 4 blocks ran the training shape
//     ~9 % faster than 8 warps x 2 blocks, and 128-column tiles at one
//     block an SM ~20 % slower (chip_smoke.py phase 3 timings).
//   - Warp w owns rows 16w..16w+15 whole. QK^T runs as
//     mma.sync.m16n8k16 (bf16 or f16 in, f32 accumulate) with the warp's Q
//     fragments held in registers for the whole walk and K fragments read
//     by ldmatrix; the online softmax (max, sum, rescale) stays in the
//     accumulator fragments and needs only quad shuffles, no shared memory.
//   - P is rounded to the input type straight from the S accumulators into A
//     fragments (an m16n8 C fragment pair is an m16k16 A fragment) and
//     multiplied with V read by ldmatrix.trans: the JAX reference's own
//     precision chain (p cast to v's dtype for PV). Softmax stays f32,
//     base 2, log2(e) folded into the scale.
//   - K/V tiles of 64 columns and their segment ids arrive by cp.async
//     (16 and 4 bytes a thread) into two stages: the next tile's copy
//     overlaps this tile's products, and the walk has one barrier a tile.
//     Shared rows are padded by 16 bytes so an ldmatrix's 8 rows hit 8
//     different bank groups.
//   - No host-side block map (the TPU kernel's _kv_block_map sort): one
//     coalesced pass over the kv segment ids (live_span) finds the first
//     and last column, up to the causal diagonal, whose segment falls in
//     the range of the block's query segments; the block walks only those
//     tiles. A tile whose pairs are all live (one segment on both sides,
//     wholly below the diagonal) skips the per-element mask; any other tile
//     masks each element after QK^T.
//   - K and V are read through strides, so the chunked-prefill path passes
//     the two halves of the packed [B, Hkv, S, 2D] cache without a copy;
//     cp.async needs 16-byte aligned rows, which the wrapper checks.
//   - Rows with no live key write out = 0 and lse = -inf, never NaN.

#include "common.cuh"

namespace tn {
namespace {

constexpr int kRows = 64;      // query rows per block: G heads x (64 / G) positions
constexpr int kCols = 64;      // kv columns per tile
constexpr int kThreads = 256;  // thread (ty, tx) owns rows ty + 16i, columns tx + 16j

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;   // [B, T] or nullptr (one segment)
  const int* kv_seg;  // [B, S] or nullptr
  void* out;          // [B, T, H, D] contiguous
  float* lse;         // [B, H, T] contiguous
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int B, T, S, H, Hkv, G, BQ;
  int causal, q_offset, kv_offset;
  float scale_log2;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * (D + 1) + kCols * (D + 1) + kCols * D +
                          kRows * (kCols + 1)) +
         sizeof(int) * (2 * kRows + kCols + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                        // [kRows][D+1], scaled to base 2
  float* sK = sQ + kRows * (D + 1);        // [kCols][D+1]
  float* sV = sK + kCols * (D + 1);        // [kCols][D]
  float* sP = sV + kCols * D;              // [kRows][kCols+1]
  int* sRowT = reinterpret_cast<int*>(sP + kRows * (kCols + 1));  // [kRows]
  int* sQseg = sRowT + kRows;              // [kRows]
  int* sKseg = sQseg + kRows;              // [kCols]
  int* sSegRange = sKseg + kCols;          // [2] min, max query segment

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * p.BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kRows) {
    int t = -1, seg = 0;
    if (tid < nrows) {
      const int tt = q0 + tid % p.BQ;
      if (tt < p.T) {
        t = tt;
        seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
        atomicMin(&sSegRange[0], seg);
        atomicMax(&sSegRange[1], seg);
      }
    }
    sRowT[tid] = t;
    sQseg[tid] = seg;
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < nrows) {
      const int t = q0 + r % p.BQ;
      const int h = hk * p.G + r / p.BQ;
      if (t < p.T) val = to_f32(qb[t * p.q_st + h * p.q_sh + d]) * p.scale_log2;
    }
    sQ[r * (D + 1) + d] = val;
  }
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];

  // live kv columns: [0, kv_end); causal cuts at the tile's last query
  int kv_end = p.S;
  if (p.causal) {
    const int t_last = min(q0 + p.BQ, p.T) - 1;
    kv_end = min(kv_end, p.q_offset + t_last - p.kv_offset + 1);
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kCols) {
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    bool live = false;
    if (tid < kCols) {
      const int col = kv0 + tid;
      int seg = INT_MIN;
      if (col < kv_end) {
        seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
        live = seg >= seg_lo && seg <= seg_hi;
      }
      sKseg[tid] = seg;
    }
    if (!__syncthreads_or(live)) continue;  // no segment of this tile meets the rows

    for (int i = tid; i < kCols * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = kv0 + c;
      float kval = 0.f, vval = 0.f;  // zero, not garbage, beyond the live range
      if (col < kv_end) {
        kval = to_f32(kb[col * p.k_ss + d]);
        vval = to_f32(vb[col * p.v_ss + d]);
      }
      sK[c * (D + 1) + d] = kval;
      sV[c * D + d] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int t = sRowT[r];
      const int qseg = sQseg[r];
      const int qpos = p.q_offset + t;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = kv0 + c;
        const bool ok = t >= 0 && col < kv_end && qseg == sKseg[c] &&
                        (!p.causal || qpos >= p.kv_offset + col);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads sharing ty are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
      const float alpha = exp2f(m[i] - m_use);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = exp2f(s[i][j] - m_use);
        sP[r * (kCols + 1) + tx + 16 * j] = pr;
        row_sum += pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty + 16 * i) * (kCols + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = sRowT[r];
    if (t < 0) continue;
    const int h = hk * p.G + r / p.BQ;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      p.lse[((int64_t)b * p.H + h) * p.T + t] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and f16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;   // query rows per block: G heads x (64 / G) positions
constexpr int kMmaCols = 64;   // kv columns per tile
constexpr int kMmaWarps = 4;   // warp w owns rows 16w .. 16w + 15
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
__host__ __device__ constexpr int mma_pitch() { return D + 8; }  // elements per shared row: 16 bytes of padding

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(uint16_t) * (kMmaRows + 4 * kMmaCols) * mma_pitch<D>() +
         sizeof(int) * (2 * kMmaCols + 2 * kMmaRows + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D == 64 ? 4 : 2)
    flash_fwd_mma_kernel(FwdParams p) {
  constexpr int LDS = mma_pitch<D>();
  constexpr int KSTEPS = D / 16;       // k-steps of QK^T
  constexpr int NT = kMmaCols / 8;     // n-tiles of S
  constexpr int DT = D / 8;            // n-tiles of O
  constexpr int CHUNKS = D / 8;        // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);   // [64][LDS]
  T* sK = sQ + kMmaRows * LDS;                  // [2 stages][64][LDS]
  T* sV = sK + 2 * kMmaCols * LDS;              // [2 stages][64][LDS]
  int* sKseg = reinterpret_cast<int*>(sV + 2 * kMmaCols * LDS);  // [2 stages][64]
  int* sRowT = sKseg + 2 * kMmaCols;               // [64] position, -1 if dead
  int* sQseg = sRowT + kMmaRows;                   // [64]
  int* sSegRange = sQseg + kMmaRows;               // [2] min, max query segment
  int* sSpan = sSegRange + 2;                      // [2] first, last live column

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in quad
  const int q0 = blockIdx.x * p.BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQ;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kMmaRows) {
    const int r = tid;
    int t = -1, seg = 0;
    if (r < nrows) {
      const int tt = q0 + r % p.BQ;
      if (tt < p.T) {
        t = tt;
        seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
        atomicMin(&sSegRange[0], seg);
        atomicMax(&sSegRange[1], seg);
      }
    }
    sRowT[r] = t;
    sQseg[r] = seg;
  }
  for (int i = tid; i < kMmaRows * CHUNKS; i += kMmaThreads) {  // Q, zero rows if dead
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int t = q0 + r % p.BQ;
    const bool ok = r < nrows && t < p.T;
    const T* src = ok ? qb + t * p.q_st + (hk * p.G + r / p.BQ) * p.q_sh + c * 8 : qb;
    cp_async_16(sQ + r * LDS + c * 8, src, ok);
  }
  cp_async_commit();
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];

  // live kv columns: [0, kv_end); causal cuts at the block's last query
  int kv_end = p.S;
  if (p.causal) {
    const int t_last = min(q0 + p.BQ, p.T) - 1;
    kv_end = min(kv_end, p.q_offset + t_last - p.kv_offset + 1);
  }
  int first, last;  // the live columns' span: no walk over the tiles before it
  live_span(p.kv_seg ? p.kv_seg + (int64_t)b * p.S : nullptr, 0, kv_end, seg_lo, seg_hi,
            sSpan, first, last);
  const int ntiles = last < 0 ? 0 : last / kMmaCols + 1;
  const int tile0 = last < 0 ? 0 : first / kMmaCols;

  // K, V and the kv segment ids of a tile, all by cp.async, zero beyond the
  // live range (the mask reads col < kv_end, never a zero-filled id)
  auto load_kv = [&](int tile, int stage) {
    T* dk = sK + stage * kMmaCols * LDS;
    T* dv = sV + stage * kMmaCols * LDS;
    for (int i = tid; i < kMmaCols * CHUNKS; i += kMmaThreads) {
      const int c = i / CHUNKS, ch = i % CHUNKS;
      const int col = tile * kMmaCols + c;
      const bool ok = col < kv_end;
      cp_async_16(dk + c * LDS + ch * 8, ok ? kb + col * p.k_ss + ch * 8 : kb, ok);
      cp_async_16(dv + c * LDS + ch * 8, ok ? vb + col * p.v_ss + ch * 8 : vb, ok);
    }
    if (tid < kMmaCols) {
      const int col = tile * kMmaCols + tid;
      int* dst = sKseg + stage * kMmaCols + tid;
      if (p.kv_seg)
        cp_async_4(dst, col < kv_end ? p.kv_seg + (int64_t)b * p.S + col : p.kv_seg,
                   col < kv_end);
      else
        *dst = 1;
    }
  };

  int stage = 0;
  if (tile0 < ntiles) load_kv(tile0, 0);
  cp_async_commit();

  // this warp's Q fragments, for the whole walk
  cp_async_wait<1>();
  __syncthreads();
  const int mi = lane >> 3;  // which 8x8 matrix of an ldmatrix.x4 this lane addresses
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8);

  const int r0 = warp * 16 + g;  // this thread's two rows: r0 and r0 + 8
  const int t_row[2] = {sRowT[r0], sRowT[r0 + 8]};
  const int seg_row[2] = {sQseg[r0], sQseg[r0 + 8]};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // every tile of the live span; a tile of another segment inside it is
  // masked whole (p = 0)
  for (int cur = tile0; cur < ntiles; ++cur) {
    cp_async_wait<0>();  // this tile's group has landed
    const int kv0 = cur * kMmaCols;
    const int* kseg = sKseg + stage * kMmaCols;
    bool whole = true;  // this thread's column is live for every row
    if (tid < kMmaCols) whole = kv0 + tid < kv_end && kseg[tid] == seg_lo && seg_lo == seg_hi;
    // the one barrier of a tile: every warp sees this tile and is done with
    // the previous one (whose stage the next copy refills), and learns
    // whether all of this tile's pairs are live (then no element needs a mask)
    const bool full_cur = __syncthreads_and(whole) &&
        (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + kMmaCols - 1);
    if (cur + 1 < ntiles) load_kv(cur + 1, stage ^ 1);  // overlaps this tile's products
    cp_async_commit();

    const T* tK = sK + stage * kMmaCols * LDS;
    const T* tV = sV + stage * kMmaCols * LDS;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: (n-tile j, k lo), (j, k hi), (j+1, k lo), (j+1, k hi)
        uint32_t kf[4];
        ldmatrix_x4(kf, tK + (j * 8 + (mi >> 1) * 8 + (lane & 7)) * LDS + ks * 16 + (mi & 1) * 8);
        mma_16816<T>(s[j], qf[ks], kf[0], kf[1]);
        mma_16816<T>(s[j + 1], qf[ks], kf[2], kf[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (!full_cur) {
          const int c = j * 8 + 2 * tq + (e & 1);
          const int col = kv0 + c;
          const int t = t_row[e >> 1];
          const bool ok = t >= 0 && col < kv_end && seg_row[e >> 1] == kseg[c] &&
                          (!p.causal || p.q_offset + t >= p.kv_offset + col);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_use[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // no inf - inf
      const float alpha = fast_exp2(m[i] - m_use[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];  // this thread's part; the quad sums at the end
      }
    }

    // O += P V: two S n-tiles are one A fragment of a 16-column k-step
#pragma unroll
    for (int kk = 0; kk < kMmaCols / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < DT; dj += 2) {
        // matrices: (k lo, d-tile dj), (k hi, dj), (k lo, dj+1), (k hi, dj+1)
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, tV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + dj * 8 +
                                  (mi >> 1) * 8);
        mma_16816<T>(acc[dj], pa, vf[0], vf[1]);
        mma_16816<T>(acc[dj + 1], pa, vf[2], vf[3]);
      }
    }
    stage ^= 1;
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = t_row[i];
    if (t < 0) continue;
    const int h = hk * p.G + (r0 + 8 * i) / p.BQ;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int dj = 0; dj < DT; ++dj)
      *reinterpret_cast<uint32_t*>(orow + dj * 8 + 2 * tq) =
          pack2<T>(acc[dj][2 * i] * inv, acc[dj][2 * i + 1] * inv);
    if (tq == 0)
      p.lse[((int64_t)b * p.H + h) * p.T + t] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_mma(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  flash_fwd_mma_kernel<T, D><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tn

extern "C" int tn_flash_fwd(
    const void* q, const void* k, const void* v, const int* q_seg,
    const int* kv_seg, void* out, float* lse,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int B, int T, int S, int H, int Hkv, int D, int dtype,
    int causal, int q_offset, int kv_offset, float scale, void* stream) {
  tn::FwdParams p;
  p.q = q; p.k = k; p.v = v; p.q_seg = q_seg; p.kv_seg = kv_seg;
  p.out = out; p.lse = lse;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.T = T; p.S = S; p.H = H; p.Hkv = Hkv;
  p.G = H / Hkv;
  p.causal = causal; p.q_offset = q_offset; p.kv_offset = kv_offset;
  p.scale_log2 = scale * tn::kLog2e;
  if (H % Hkv != 0 || p.G > tn::kRows || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tn::kBFloat16 || dtype == tn::kFloat16) {
    // cp.async moves 16-byte rows: pointers and row strides in 8-element units
    const int64_t strides[] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (int64_t x : strides)
      if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    p.BQ = tn::kMmaRows / p.G;
    const bool bf = dtype == tn::kBFloat16;
    if (D == 64) return (int)(bf ? tn::launch_mma<__nv_bfloat16, 64>(p, st)
                                 : tn::launch_mma<__half, 64>(p, st));
    if (D == 128) return (int)(bf ? tn::launch_mma<__nv_bfloat16, 128>(p, st)
                                  : tn::launch_mma<__half, 128>(p, st));
    return (int)cudaErrorInvalidValue;
  }
  p.BQ = tn::kRows / p.G;
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
