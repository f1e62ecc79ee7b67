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
// What bounds it on this card: the arithmetic of QK^T and PV (the kernel
// does 4·D flops per (row, live column) and reads each K/V tile once per
// block of 64 rows). This first version computes both products with f32
// FMAs from shared memory rather than tensor cores, so it is bound by
// shared-memory load bandwidth (two loads per four FMAs in the 4x4
// register tile). Later work moves the products to mma/wgmma.
//
// What the design does about it:
//   - One block per (batch, kv head, query tile) processes all G = H/Hkv
//     query heads of the GQA group: the block's 64 rows are G heads x
//     64/G positions, so each K/V tile is loaded once for the whole group.
//   - No host-side block map (the TPU kernel's _kv_block_map sort): each
//     block derives its own live kv range from the causal diagonal, and
//     skips a whole kv tile when none of its segment ids falls in the
//     range of the block's query segment ids (__syncthreads_or).
//   - K and V are read through strides, so the chunked-prefill path passes
//     the two halves of the packed [B, Hkv, S, 2D] cache without a copy.
//   - Softmax and both accumulations are f32 (the TPU kernel's bf16
//     softmax chain, attention.py:326-347, is not ported), base 2 with
//     log2(e) folded into the query scale. Rows with no live key write
//     out = 0 and lse = -inf, never NaN.

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
  p.BQ = tn::kRows / p.G;
  p.causal = causal; p.q_offset = q_offset; p.kv_offset = kv_offset;
  p.scale_log2 = scale * tn::kLog2e;
  if (H % Hkv != 0 || p.G > tn::kRows || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tn::kBFloat16 && D == 64) return (int)tn::launch<__nv_bfloat16, 64>(p, st);
  if (dtype == tn::kBFloat16 && D == 128) return (int)tn::launch<__nv_bfloat16, 128>(p, st);
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
