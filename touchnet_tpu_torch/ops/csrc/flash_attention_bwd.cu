// Copyright (c) 2026 touchnet_tpu authors.
// K2: packed-document flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas backward kernels of touchnet_tpu/ops/attention.py:
// _bwd_dq_kernel_dyn (:900) / _bwd_dq_kernel (:528), _bwd_dkv_kernel_dyn
// (:994) / _bwd_dkv_kernel (:596), and the single-pass fused variants
// _bwd_fused_kernel_dyn (:778) / _bwd_fused_kernel (:675). The fused pass is
// a TPU VMEM trick (dq held whole in VMEM while the sequential grid walks the
// kv tiles); the two kernels below compute the same dq, dk and dv.
//
// Contract: K1's. Row t of query head h attends column s iff q_seg[t] ==
// kv_seg[s] (segment 0 is padding and only matches itself) and, when causal,
// q_offset + t >= kv_offset + s. lse is K1's own f32 base-e output; a row
// with lse = -inf (no live key) gets p = 0 everywhere, so zero gradients.
//   delta = rowsum(dout * out)                     (f32, delta kernel)
//   p     = exp(scale * q.k - lse)
//   ds    = p * (dout.v - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T dout
// dk and dv of a kv head are summed over its G = H / Hkv query heads.
// Inputs q, k, v, out, dout are contiguous [B, T|S, heads, D]; the wrapper
// makes dout (which autograd may hand over strided) contiguous once.
//
// What bounds it on this card: the five D-deep products per (row, live
// column) pair, done as f32 FMAs from shared memory (as K1: two shared loads
// per four FMAs in the 4x4 register tile), not on tensor cores. The whole
// chain is f32; the TPU kernels' bf16 p/ds chain (attention.py:561, 632) is
// not ported.
//
// What the design does about it (blocks run in no order on Hopper, so
// nothing carries across blocks and no atomics are needed):
//   - dkv kernel: one block per (batch, kv head, 64-column kv tile). It holds
//     K and V of its tile and walks the query tiles that can see it: from
//     the causal diagonal on, each tile of 64 rows = G heads x 64/G
//     positions, so the GQA sum happens in the block's dk/dv registers.
//   - dq kernel: one block per (batch, kv head, query tile), K1's grid; it
//     walks the kv tiles up to the causal diagonal.
//   - Both recompute p from lse and skip a whole tile when no segment id of
//     it falls in the range of the block's own segment ids
//     (__syncthreads_or), as K1 does.

#include "common.cuh"

namespace tn {
namespace {

constexpr int kTile = 64;      // rows (G heads x 64/G positions) and columns per tile
constexpr int kThreads = 256;  // thread (ty, tx) owns rows/cols ty + 16i, tx + 16j

struct BwdParams {
  const void* q;       // [B, T, H, D]
  const void* k;       // [B, S, Hkv, D]
  const void* v;       // [B, S, Hkv, D]
  const void* out;     // [B, T, H, D]
  const void* dout;    // [B, T, H, D]
  const float* lse;    // [B, H, T], base e
  const int* q_seg;    // [B, T] or nullptr
  const int* kv_seg;   // [B, S] or nullptr
  float* delta;        // [B, H, T] scratch
  void* dq;            // [B, T, H, D]
  void* dk;            // [B, S, Hkv, D]
  void* dv;            // [B, S, Hkv, D]
  int B, T, S, H, Hkv, G, BQ, D;
  int causal, q_offset, kv_offset;
  float scale, scale_log2;
};

// delta[b, h, t] = sum_d dout * out, one warp per (b, t, h) row
template <typename T>
__global__ void delta_kernel(BwdParams p) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)p.B * p.T * p.H;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(p.out) + row * p.D;
  const T* g = static_cast<const T*>(p.dout) + row * p.D;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const int64_t bt = row / p.H;
    const int t = (int)(bt % p.T);
    const int b = (int)(bt / p.T);
    p.delta[((int64_t)b * p.H + h) * p.T + t] = acc;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (kv tile, kv head, batch)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile) +
         sizeof(int) * (2 * kTile + kTile + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdParams p) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sK = smem;                     // [64][D+1] this block's columns
  float* sV = sK + kTile * LD;          // [64][D+1]
  float* sQ = sV + kTile * LD;          // [64][D+1] current query rows
  float* sDO = sQ + kTile * LD;         // [64][D+1]
  float* sP = sDO + kTile * LD;         // [64 rows][65]
  float* sDS = sP + kTile * (kTile + 1);  // [64 rows][65]
  float* sLse = sDS + kTile * (kTile + 1);  // [64] base 2
  float* sDelta = sLse + kTile;         // [64]
  int* sRowT = reinterpret_cast<int*>(sDelta + kTile);  // [64]
  int* sQseg = sRowT + kTile;           // [64]
  int* sKseg = sQseg + kTile;           // [64]
  int* sSegRange = sKseg + kTile;       // [2] min, max kv segment of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int kv0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = static_cast<const T*>(p.q) + (int64_t)b * p.T * p.H * D;
  const T* gb = static_cast<const T*>(p.dout) + (int64_t)b * p.T * p.H * D;
  const T* kb = static_cast<const T*>(p.k) + ((int64_t)b * p.S * p.Hkv + hk) * D;
  const T* vb = static_cast<const T*>(p.v) + ((int64_t)b * p.S * p.Hkv + hk) * D;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kTile) {
    const int col = kv0 + tid;
    int seg = INT_MIN;  // beyond S: matches no row
    if (col < p.S) {
      seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
      atomicMin(&sSegRange[0], seg);
      atomicMax(&sSegRange[1], seg);
    }
    sKseg[tid] = seg;
  }
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const int col = kv0 + c;
    float kval = 0.f, vval = 0.f;
    if (col < p.S) {
      kval = to_f32(kb[(int64_t)col * p.Hkv * D + d]);
      vval = to_f32(vb[(int64_t)col * p.Hkv * D + d]);
    }
    sK[c * LD + d] = kval;
    sV[c * LD + d] = vval;
  }
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];

  // first query position that can see column kv0 (causal), aligned to a tile
  int t_begin = 0;
  if (p.causal) t_begin = max(0, p.kv_offset + kv0 - p.q_offset);
  t_begin = (t_begin / p.BQ) * p.BQ;

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = t_begin; q0 < p.T; q0 += p.BQ) {
    __syncthreads();  // the previous tile's readers are done
    bool live = false;
    int t = -1;
    if (tid < kTile) {
      int seg = 0;
      const int tt = q0 + tid % p.BQ;
      if (tid < p.G * p.BQ && tt < p.T) {
        t = tt;
        seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
        live = seg >= seg_lo && seg <= seg_hi;
      }
      sRowT[tid] = t;
      sQseg[tid] = seg;
    }
    if (!__syncthreads_or(live)) continue;  // no row of this tile meets the columns
    if (tid < kTile) {  // row statistics only for a tile that is computed
      const int h = hk * p.G + tid / p.BQ;
      const int64_t o = ((int64_t)b * p.H + h) * p.T + t;
      sLse[tid] = t >= 0 ? p.lse[o] * kLog2e : -INFINITY;
      sDelta[tid] = t >= 0 ? p.delta[o] : 0.f;
    }

    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float qv = 0.f, gv = 0.f;
      if (r < p.G * p.BQ) {
        const int t = q0 + r % p.BQ;
        const int h = hk * p.G + r / p.BQ;
        if (t < p.T) {
          const int64_t off = ((int64_t)t * p.H + h) * D + d;
          qv = to_f32(qb[off]);
          gv = to_f32(gb[off]);
        }
      }
      sQ[r * LD + d] = qv;
      sDO[r * LD + d] = gv;
    }
    __syncthreads();

    // s = q.k and dp = dout.v for rows ty + 16i, columns tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + d];
        gv[i] = sDO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int t = sRowT[r];
      const int qpos = p.q_offset + t;
      const float lse2 = sLse[r];
      const float dl = sDelta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = kv0 + c;
        const bool ok = t >= 0 && col < p.S && sQseg[r] == sKseg[c] &&
                        lse2 != -INFINITY &&
                        (!p.causal || qpos >= p.kv_offset + col);
        const float pr = ok ? exp2f(s[i][j] * p.scale_log2 - lse2) : 0.f;
        sP[r * (kTile + 1) + c] = pr;
        sDS[r * (kTile + 1) + c] = pr * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dv[c][d] += sum_r p[r][c] dout[r][d];  dk[c][d] += sum_r ds[r][c] q[r][d]
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pc[4], dsc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = sP[r * (kTile + 1) + ty + 16 * i];
        dsc[i] = sDS[r * (kTile + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = sDO[r * LD + tx + 16 * j];
        const float qv = sQ[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pc[i], g, dv[i][j]);
          dk[i][j] = fmaf(dsc[i], qv, dk[i][j]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + ((int64_t)b * p.S * p.Hkv + hk) * D;
  T* dvb = static_cast<T*>(p.dv) + ((int64_t)b * p.S * p.Hkv + hk) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = kv0 + ty + 16 * i;
    if (col >= p.S) continue;
    const int64_t off = (int64_t)col * p.Hkv * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[off + tx + 16 * j] = from_f32<T>(dk[i][j] * p.scale);
      dvb[off + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query tile, kv head, batch), K1's grid
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile) +
         sizeof(int) * (2 * kTile + kTile + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdParams p) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                     // [64][D+1]
  float* sDO = sQ + kTile * LD;         // [64][D+1]
  float* sK = sDO + kTile * LD;         // [64][D+1]
  float* sV = sK + kTile * LD;          // [64][D+1]
  float* sDS = sV + kTile * LD;         // [64][65]
  float* sLse = sDS + kTile * (kTile + 1);
  float* sDelta = sLse + kTile;
  int* sRowT = reinterpret_cast<int*>(sDelta + kTile);
  int* sQseg = sRowT + kTile;
  int* sKseg = sQseg + kTile;
  int* sSegRange = sKseg + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * p.BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQ;

  const T* qb = static_cast<const T*>(p.q) + (int64_t)b * p.T * p.H * D;
  const T* gb = static_cast<const T*>(p.dout) + (int64_t)b * p.T * p.H * D;
  const T* kb = static_cast<const T*>(p.k) + ((int64_t)b * p.S * p.Hkv + hk) * D;
  const T* vb = static_cast<const T*>(p.v) + ((int64_t)b * p.S * p.Hkv + hk) * D;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kTile) {
    int t = -1, seg = 0;
    float lse2 = -INFINITY, dl = 0.f;
    if (tid < nrows) {
      const int tt = q0 + tid % p.BQ;
      const int h = hk * p.G + tid / p.BQ;
      if (tt < p.T) {
        t = tt;
        seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
        atomicMin(&sSegRange[0], seg);
        atomicMax(&sSegRange[1], seg);
        lse2 = p.lse[((int64_t)b * p.H + h) * p.T + t] * kLog2e;
        dl = p.delta[((int64_t)b * p.H + h) * p.T + t];
      }
    }
    sRowT[tid] = t;
    sQseg[tid] = seg;
    sLse[tid] = lse2;
    sDelta[tid] = dl;
  }
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float qv = 0.f, gv = 0.f;
    if (r < nrows) {
      const int t = q0 + r % p.BQ;
      const int h = hk * p.G + r / p.BQ;
      if (t < p.T) {
        const int64_t off = ((int64_t)t * p.H + h) * D + d;
        qv = to_f32(qb[off]);
        gv = to_f32(gb[off]);
      }
    }
    sQ[r * LD + d] = qv;
    sDO[r * LD + d] = gv;
  }
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];

  int kv_end = p.S;
  if (p.causal) {
    const int t_last = min(q0 + p.BQ, p.T) - 1;
    kv_end = min(kv_end, p.q_offset + t_last - p.kv_offset + 1);
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    bool live = false;
    if (tid < kTile) {
      const int col = kv0 + tid;
      int seg = INT_MIN;
      if (col < kv_end) {
        seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
        live = seg >= seg_lo && seg <= seg_hi;
      }
      sKseg[tid] = seg;
    }
    if (!__syncthreads_or(live)) continue;

    for (int i = tid; i < kTile * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = kv0 + c;
      float kval = 0.f, vval = 0.f;
      if (col < kv_end) {
        kval = to_f32(kb[(int64_t)col * p.Hkv * D + d]);
        vval = to_f32(vb[(int64_t)col * p.Hkv * D + d]);
      }
      sK[c * LD + d] = kval;
      sV[c * LD + d] = vval;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + d];
        gv[i] = sDO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int t = sRowT[r];
      const int qpos = p.q_offset + t;
      const float lse2 = sLse[r];
      const float dl = sDelta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = kv0 + c;
        const bool ok = t >= 0 && col < kv_end && sQseg[r] == sKseg[c] &&
                        lse2 != -INFINITY &&
                        (!p.causal || qpos >= p.kv_offset + col);
        const float pr = ok ? exp2f(s[i][j] * p.scale_log2 - lse2) : 0.f;
        sDS[r * (kTile + 1) + c] = pr * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dq[r][d] += sum_c ds[r][c] k[c][d]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sDS[(ty + 16 * i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sK[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsr[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = sRowT[r];
    if (t < 0) continue;
    const int h = hk * p.G + r / p.BQ;
    T* row = dqb + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.T * p.H;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kTile - 1) / kTile, p.Hkv, p.B);
  dkv_kernel<T, D><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  dq_kernel<T, D><<<grid_q, kThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tn

extern "C" int tn_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* q_seg, const int* kv_seg,
    float* delta, void* dq, void* dk, void* dv,
    int B, int T, int S, int H, int Hkv, int D, int dtype,
    int causal, int q_offset, int kv_offset, float scale, void* stream) {
  tn::BwdParams p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout; p.lse = lse;
  p.q_seg = q_seg; p.kv_seg = kv_seg; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.D = D;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > tn::kTile || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  p.G = H / Hkv;
  p.BQ = tn::kTile / p.G;
  p.causal = causal; p.q_offset = q_offset; p.kv_offset = kv_offset;
  p.scale = scale;
  p.scale_log2 = scale * tn::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tn::kBFloat16 && D == 64) return (int)tn::launch<__nv_bfloat16, 64>(p, st);
  if (dtype == tn::kBFloat16 && D == 128) return (int)tn::launch<__nv_bfloat16, 128>(p, st);
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
