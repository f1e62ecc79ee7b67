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
// Two routes, by input type (inputs bf16, f16 or f32): bf16 and f16 run
// the tensor-core kernels dkv_mma_kernel<T> and dq_mma_kernel<T>, one body
// for both types; f32 keeps the first version's FMA kernels dkv_kernel and
// dq_kernel, the exactness path behind the f32 checks (1e-4). The delta
// kernel serves all three.
//
// What bounds it on this card: the products. The gradients need five
// D-deep products per live (row, column) pair (S, dP, dV, dK, dQ: 10·D
// flops); the two-kernel split recomputes S and dP in the dq kernel, so
// the kernels do seven (14·D flops), 40 % more than the bound counts. At
// the training shape that bound is ~0.5 ms of bf16 tensor-core time
// against ~0.1 ms of bytes: operations bound it. The FMA version ran at
// ~12 TFLOP/s. The split is kept because it needs no atomics: every
// gradient element is written once by one block, in a fixed order, so two
// runs give the same bits.
//
// Precision (both routes): the exponentials and dP - delta stay f32; on
// the tensor-core route P and dS are rounded to the input type only as mma
// operands, as FlashAttention-2 does. The TPU kernels' bf16 p/ds chain,
// whose exp is bf16 (attention.py:561, 632), is not ported; for f16 the
// TPU kernels keep that chain in f32 and round ds to k's dtype
// (attention.py:586, 664), which is what this kernel does.
//
// f16: the values rounded to f16 are P and dS (mma operands) and the
// outputs dq, dk, dv. P lies in [0, 1]. Over a row, sum |dS| <= sum P
// (|dP| + |delta|) <= 2 D max|dout| max|v|, so |dS| and |dq| are bounded
// by the row's dout and v whatever S is; dk and dv sum a column over its
// query rows (at most T G of them, 65536 at the training shape), each
// weighted by P <= 1. With unit-scale activations and dout the gradient of
// a loss averaged over the batch's tokens (|dout| far below 1e-3 at 16384
// tokens) every one of them stays orders of magnitude below 65504. At the
// other end, a |dS| below 2^-24 flushes to 0 in f16 where bf16 keeps it,
// as it does in JAX's ds.astype(k.dtype): the port follows JAX's chain
// (no loss scaling, as JAX has none).
//
// What the tensor-core design does about it (mma.sync m16n8k16 bf16 or
// f16 -> f32,
// ldmatrix and cp.async: the sm_80 instruction set; wgmma/TMA is later
// work). Blocks run in no order on Hopper, so nothing carries across
// blocks:
//   - dkv kernel: one block of 4 warps per (batch, kv head, 64 kv
//     columns), two blocks to an SM; warp w owns columns 16w..16w+15. It
//     computes everything transposed, with its columns as the mma rows:
//     S^T = K Q^T, dP^T = V dO^T, then P^T and dS^T in f32 in the
//     accumulators, and dV += P^T dO, dK += dS^T Q with P^T and dS^T packed
//     to the input type straight from the accumulators into A fragments. So dS never
//     goes through shared memory for a transpose. K and V stay resident in
//     shared memory; Q and dO tiles of 64 rows (G heads x 64/G positions)
//     arrive by cp.async in two stages, from the causal diagonal on, so the
//     GQA sum happens in the block's dk/dv registers.
//   - dq kernel: K1's grid and row packing (4 warps, 64 rows = G heads x
//     64/G positions), two blocks to an SM; Q and dO fragments stay in
//     registers, K and V tiles of 64 columns arrive by cp.async in two
//     stages; dQ += dS K with dS packed from the accumulators and K read by
//     ldmatrix.trans.
//   - Registers (~210 a thread at D 64) hold two blocks of 4 warps to an
//     SM: on an H100 80GB HBM3 (700 W) that ran the training shape ~9 %
//     faster than one block of 8 warps (chip_smoke.py phase 6 timings).
//   - Both walk only the span of tiles whose segment ids fall in the range
//     of the block's own (one coalesced pass, live_span, as K1), bring each
//     tile's segment ids and row statistics by cp.async with its data (one
//     barrier a tile), skip the per-element mask on a tile whose pairs are
//     all live, and give rows with lse = -inf zero gradients.
//   - Shared rows are padded by 16 bytes so an ldmatrix's 8 rows hit 8
//     different bank groups; cp.async needs 16-byte aligned inputs, which
//     the wrapper checks.

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
  int B, T, S, H, Hkv, G, D;
  int BQ;   // query positions per row tile (dq grid; both FMA kernels)
  int BQk;  // query positions per row tile of the tensor-core dkv kernel's walk
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

// ---------------------------------------------------------------------------
// bf16 and f16: tensor cores, one body for both. Fragment layouts and
// helpers in common.cuh.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kDkvCols = 64;   // kv columns per dkv block: warp w owns 16w .. 16w + 15
constexpr int kDkvRows = 64;   // query rows per tile of the dkv walk: G heads x 64/G
constexpr int kDqRows = 64;    // query rows per dq block: warp w owns 16w .. 16w + 15
constexpr int kDqCols = 64;    // kv columns per tile of the dq walk

template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }  // elements per shared row: 16 bytes of padding

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(uint16_t) * (2 * kDkvCols + 4 * kDkvRows) * pitch<D>() +
         sizeof(float) * 4 * kDkvRows + sizeof(int) * (4 * kDkvRows + kDkvCols + 4);
}

// dk, dv: one block per (64 kv columns, kv head, batch). Computed
// transposed, with the block's kv columns as the mma rows, so every
// product takes its A operand from registers (K and V by ldmatrix from the
// resident tile, P^T and dS^T straight from the accumulators) and its B
// operand from the query tile in shared memory:
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp2(S^T - lse), dS^T = P^T (dP^T - delta),
//   dV += P^T dO, dK += dS^T Q.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dkv_mma_kernel(BwdParams p) {
  constexpr int LDS = pitch<D>();
  constexpr int KSTEPS = D / 16;
  constexpr int NR = kDkvRows / 8;  // n-tiles over the query rows
  constexpr int DT = D / 8;
  constexpr int CHUNKS = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [64][LDS]
  T* sV = sK + kDkvCols * LDS;                 // [64][LDS]
  T* sQ = sV + kDkvCols * LDS;                 // [2 stages][64][LDS]
  T* sDO = sQ + 2 * kDkvRows * LDS;            // [2 stages][64][LDS]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kDkvRows * LDS);  // [2][64] base e
  float* sDelta = sLse + 2 * kDkvRows;            // [2][64]
  int* sRowT = reinterpret_cast<int*>(sDelta + 2 * kDkvRows);  // [2][64]
  int* sQseg = sRowT + 2 * kDkvRows;              // [2][64]
  int* sKseg = sQseg + 2 * kDkvRows;              // [64]
  int* sSegRange = sKseg + kDkvCols;              // [2] min, max kv segment
  int* sSpan = sSegRange + 2;                     // [2] first, last live query position

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int kv0 = blockIdx.x * kDkvCols;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQk;
  const int64_t kv_row = (int64_t)p.Hkv * D;  // elements between two kv positions
  const T* qb = static_cast<const T*>(p.q) + (int64_t)b * p.T * p.H * D;
  const T* gb = static_cast<const T*>(p.dout) + (int64_t)b * p.T * p.H * D;
  const T* kb = static_cast<const T*>(p.k) + (int64_t)b * p.S * kv_row + hk * D;
  const T* vb = static_cast<const T*>(p.v) + (int64_t)b * p.S * kv_row + hk * D;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kDkvCols) {
    const int col = kv0 + tid;
    int seg = INT_MIN;  // beyond S: matches no row
    if (col < p.S) {
      seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
      atomicMin(&sSegRange[0], seg);
      atomicMax(&sSegRange[1], seg);
    }
    sKseg[tid] = seg;
  }
  for (int i = tid; i < kDkvCols * CHUNKS; i += kMmaThreads) {
    const int c = i / CHUNKS, ch = i % CHUNKS;
    const int col = kv0 + c;
    const bool ok = col < p.S;
    cp_async_16(sK + c * LDS + ch * 8, ok ? kb + col * kv_row + ch * 8 : kb, ok);
    cp_async_16(sV + c * LDS + ch * 8, ok ? vb + col * kv_row + ch * 8 : vb, ok);
  }
  cp_async_commit();
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];
  const bool cols_whole = kv0 + kDkvCols <= p.S && seg_lo == seg_hi;

  // the query tiles that can see the block's columns: from the causal
  // diagonal on, within the span of positions in the columns' segments, in
  // steps of BQk positions
  int t_first = 0;
  if (p.causal) t_first = max(0, p.kv_offset + kv0 - p.q_offset);
  int first, last;
  live_span(p.q_seg ? p.q_seg + (int64_t)b * p.T : nullptr, t_first, p.T, seg_lo, seg_hi,
            sSpan, first, last);
  const int t_begin = last < 0 ? 0 : (first / p.BQk) * p.BQk;
  const int ntiles = last < 0 ? 0 : (last - t_begin) / p.BQk + 1;

  // Q, dO and the row statistics (segment id, lse, delta) of a query tile,
  // all by cp.async, zero where a row is dead (its position, from sRowT,
  // masks it)
  auto load_rows = [&](int tile, int stage) {
    const int q0 = t_begin + tile * p.BQk;
    T* dq_ = sQ + stage * kDkvRows * LDS;
    T* dg = sDO + stage * kDkvRows * LDS;
    for (int i = tid; i < kDkvRows * CHUNKS; i += kMmaThreads) {
      const int r = i / CHUNKS, ch = i % CHUNKS;
      const int t = q0 + r % p.BQk;
      const bool ok = r < nrows && t < p.T;
      const int64_t off = ((int64_t)t * p.H + hk * p.G + r / p.BQk) * D + ch * 8;
      cp_async_16(dq_ + r * LDS + ch * 8, ok ? qb + off : qb, ok);
      cp_async_16(dg + r * LDS + ch * 8, ok ? gb + off : gb, ok);
    }
    if (tid < kDkvRows) {
      const int r = tid, t = q0 + r % p.BQk;
      const bool ok = r < nrows && t < p.T;
      const int i = stage * kDkvRows + r;
      const int64_t o = ((int64_t)b * p.H + hk * p.G + r / p.BQk) * p.T + t;
      sRowT[i] = ok ? t : -1;
      cp_async_4(sLse + i, ok ? p.lse + o : p.lse, ok);
      cp_async_4(sDelta + i, ok ? p.delta + o : p.delta, ok);
      if (p.q_seg)
        cp_async_4(sQseg + i, ok ? p.q_seg + (int64_t)b * p.T + t : p.q_seg, ok);
      else
        sQseg[i] = 1;
    }
  };

  int stage = 0;
  if (ntiles > 0) load_rows(0, 0);
  cp_async_commit();

  const int c_loc[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's columns
  const int c_seg[2] = {sKseg[c_loc[0]], sKseg[c_loc[1]]};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // every query tile of the live span; a tile of another segment inside it
  // is masked whole (p = 0)
  for (int cur = 0; cur < ntiles; ++cur) {
    cp_async_wait<0>();  // this tile's rows (and, first time, K and V) have landed
    const int q0 = t_begin + cur * p.BQk;
    bool whole = true;  // this thread's row is live for every column
    if (tid < kDkvRows)
      whole = sRowT[stage * kDkvRows + tid] >= 0 && sQseg[stage * kDkvRows + tid] == seg_lo;
    // the one barrier of a tile, as K1's: this tile visible, the previous
    // one done with (its stage is refilled next), all pairs live or not
    const bool full_cur = __syncthreads_and(whole) && cols_whole &&
        (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + kDkvCols - 1);
    if (cur + 1 < ntiles) load_rows(cur + 1, stage ^ 1);  // overlaps this tile's products
    cp_async_commit();

    const T* tQ = sQ + stage * kDkvRows * LDS;
    const T* tG = sDO + stage * kDkvRows * LDS;
    const float* lse = sLse + stage * kDkvRows;  // base e
    const float* dl = sDelta + stage * kDkvRows;
    const int* rowt = sRowT + stage * kDkvRows;
    const int* rseg = sQseg + stage * kDkvRows;

    float st[NR][4], dpt[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, sK + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(va, sV + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NR; j += 2) {
        uint32_t qf[4], gf[4];
        const int off = (j * 8 + (mi >> 1) * 8 + (lane & 7)) * LDS + ks * 16 + (mi & 1) * 8;
        ldmatrix_x4(qf, tQ + off);
        ldmatrix_x4(gf, tG + off);
        mma_16816<T>(st[j], ka, qf[0], qf[1]);
        mma_16816<T>(st[j + 1], ka, qf[2], qf[3]);
        mma_16816<T>(dpt[j], va, gf[0], gf[1]);
        mma_16816<T>(dpt[j + 1], va, gf[2], gf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * tq + (e & 1);  // query row of the tile
        const int ci = e >> 1;                   // which of this thread's columns
        float pr = fast_exp2(fmaf(st[j][e], p.scale_log2, -lse[r] * kLog2e));
        if (!full_cur) {
          const int t = rowt[r];
          const int col = kv0 + c_loc[ci];
          const bool ok = t >= 0 && col < p.S && rseg[r] == c_seg[ci] && lse[r] != -INFINITY &&
                          (!p.causal || p.q_offset + t >= p.kv_offset + col);
          pr = ok ? pr : 0.f;
        }
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - dl[r]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: two n-tiles of rows are one k-step
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(st[2 * kk][0], st[2 * kk][1]),
                              pack2<T>(st[2 * kk][2], st[2 * kk][3]),
                              pack2<T>(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack2<T>(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack2<T>(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack2<T>(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack2<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack2<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < DT; dj += 2) {
        uint32_t gf[4], qf[4];
        const int off = (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + dj * 8 + (mi >> 1) * 8;
        ldmatrix_x4_trans(gf, tG + off);
        ldmatrix_x4_trans(qf, tQ + off);
        mma_16816<T>(dv[dj], pa, gf[0], gf[1]);
        mma_16816<T>(dv[dj + 1], pa, gf[2], gf[3]);
        mma_16816<T>(dk[dj], sa, qf[0], qf[1]);
        mma_16816<T>(dk[dj + 1], sa, qf[2], qf[3]);
      }
    }
    stage ^= 1;
  }
  cp_async_wait<0>();

  T* dkb = static_cast<T*>(p.dk) + (int64_t)b * p.S * kv_row + hk * D;
  T* dvb = static_cast<T*>(p.dv) + (int64_t)b * p.S * kv_row + hk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = kv0 + c_loc[i];
    if (col >= p.S) continue;
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) {
      const int64_t off = col * kv_row + dj * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          pack2<T>(dk[dj][2 * i] * p.scale, dk[dj][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + off) = pack2<T>(dv[dj][2 * i], dv[dj][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(uint16_t) * (2 * kDqRows + 4 * kDqCols) * pitch<D>() +
         sizeof(int) * (2 * kDqCols + 2 * kDqRows + 4);
}

// dq: one block per (64 query rows, kv head, batch), K1's grid and row
// packing. Q and dO fragments stay in registers; per kv tile it recomputes
//   S = Q K^T, dP = dO V^T, P = exp2(S - lse), dS = P (dP - delta), dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, 2) dq_mma_kernel(BwdParams p) {
  constexpr int LDS = pitch<D>();
  constexpr int KSTEPS = D / 16;
  constexpr int NT = kDqCols / 8;
  constexpr int DT = D / 8;
  constexpr int CHUNKS = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][LDS]
  T* sDO = sQ + kDqRows * LDS;                 // [64][LDS]
  T* sK = sDO + kDqRows * LDS;                 // [2 stages][64][LDS]
  T* sV = sK + 2 * kDqCols * LDS;              // [2 stages][64][LDS]
  int* sKseg = reinterpret_cast<int*>(sV + 2 * kDqCols * LDS);  // [2][64]
  int* sRowT = sKseg + 2 * kDqCols;               // [64]
  int* sQseg = sRowT + kDqRows;                   // [64]
  int* sSegRange = sQseg + kDqRows;               // [2]
  int* sSpan = sSegRange + 2;                     // [2] first, last live column

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  const int q0 = blockIdx.x * p.BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQ;
  const int64_t kv_row = (int64_t)p.Hkv * D;
  const T* qb = static_cast<const T*>(p.q) + (int64_t)b * p.T * p.H * D;
  const T* gb = static_cast<const T*>(p.dout) + (int64_t)b * p.T * p.H * D;
  const T* kb = static_cast<const T*>(p.k) + (int64_t)b * p.S * kv_row + hk * D;
  const T* vb = static_cast<const T*>(p.v) + (int64_t)b * p.S * kv_row + hk * D;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kDqRows) {
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
  for (int i = tid; i < kDqRows * CHUNKS; i += kMmaThreads) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const int t = q0 + r % p.BQ;
    const bool ok = r < nrows && t < p.T;
    const int64_t off = ((int64_t)t * p.H + hk * p.G + r / p.BQ) * D + ch * 8;
    cp_async_16(sQ + r * LDS + ch * 8, ok ? qb + off : qb, ok);
    cp_async_16(sDO + r * LDS + ch * 8, ok ? gb + off : gb, ok);
  }
  cp_async_commit();
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];

  int kv_end = p.S;
  if (p.causal) {
    const int t_last = min(q0 + p.BQ, p.T) - 1;
    kv_end = min(kv_end, p.q_offset + t_last - p.kv_offset + 1);
  }
  int first, last;
  live_span(p.kv_seg ? p.kv_seg + (int64_t)b * p.S : nullptr, 0, kv_end, seg_lo, seg_hi,
            sSpan, first, last);
  const int ntiles = last < 0 ? 0 : last / kDqCols + 1;

  const int tile0 = last < 0 ? 0 : first / kDqCols;

  // as K1's: K, V and the kv segment ids of a tile by cp.async
  auto load_kv = [&](int tile, int stage) {
    T* dk_ = sK + stage * kDqCols * LDS;
    T* dv_ = sV + stage * kDqCols * LDS;
    for (int i = tid; i < kDqCols * CHUNKS; i += kMmaThreads) {
      const int c = i / CHUNKS, ch = i % CHUNKS;
      const int col = tile * kDqCols + c;
      const bool ok = col < kv_end;
      cp_async_16(dk_ + c * LDS + ch * 8, ok ? kb + col * kv_row + ch * 8 : kb, ok);
      cp_async_16(dv_ + c * LDS + ch * 8, ok ? vb + col * kv_row + ch * 8 : vb, ok);
    }
    if (tid < kDqCols) {
      const int col = tile * kDqCols + tid;
      int* dst = sKseg + stage * kDqCols + tid;
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

  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qf[KSTEPS][4], gf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int off = (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[ks], sQ + off);
    ldmatrix_x4(gf[ks], sDO + off);
  }
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  int t_row[2], seg_row[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    t_row[i] = sRowT[r];
    seg_row[i] = sQseg[r];
    const int64_t o = ((int64_t)b * p.H + hk * p.G + r / p.BQ) * p.T + t_row[i];
    // a dead row gets +inf, so p = 0 even where a tile skips the mask
    lse2[i] = t_row[i] >= 0 ? p.lse[o] * kLog2e : INFINITY;
    dl[i] = t_row[i] >= 0 ? p.delta[o] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int cur = tile0; cur < ntiles; ++cur) {
    cp_async_wait<0>();
    const int kv0 = cur * kDqCols;
    const int* kseg = sKseg + stage * kDqCols;
    bool whole = true;
    if (tid < kDqCols) whole = kv0 + tid < kv_end && kseg[tid] == seg_lo && seg_lo == seg_hi;
    const bool full_cur = __syncthreads_and(whole) &&  // the one barrier, as K1's
        (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + kDqCols - 1);
    if (cur + 1 < ntiles) load_kv(cur + 1, stage ^ 1);
    cp_async_commit();

    const T* tK = sK + stage * kDqCols * LDS;
    const T* tV = sV + stage * kDqCols * LDS;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4], vf[4];
        const int off = (j * 8 + (mi >> 1) * 8 + (lane & 7)) * LDS + ks * 16 + (mi & 1) * 8;
        ldmatrix_x4(kf, tK + off);
        ldmatrix_x4(vf, tV + off);
        mma_16816<T>(s[j], qf[ks], kf[0], kf[1]);
        mma_16816<T>(s[j + 1], qf[ks], kf[2], kf[3]);
        mma_16816<T>(dp[j], gf[ks], vf[0], vf[1]);
        mma_16816<T>(dp[j + 1], gf[ks], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = fast_exp2(fmaf(s[j][e], p.scale_log2, -lse2[i]));
        if (!full_cur) {
          const int c = j * 8 + 2 * tq + (e & 1);
          const int col = kv0 + c;
          const bool ok = t_row[i] >= 0 && col < kv_end && seg_row[i] == kseg[c] &&
                          lse2[i] != -INFINITY &&
                          (!p.causal || p.q_offset + t_row[i] >= p.kv_offset + col);
          pr = ok ? pr : 0.f;
        }
        s[j][e] = pr * (dp[j][e] - dl[i]);  // dS
      }
    }
    // dQ += dS K: two n-tiles of columns are one k-step
#pragma unroll
    for (int kk = 0; kk < kDqCols / 16; ++kk) {
      const uint32_t sa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < DT; dj += 2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, tK + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDS + dj * 8 +
                                  (mi >> 1) * 8);
        mma_16816<T>(acc[dj], sa, kf[0], kf[1]);
        mma_16816<T>(acc[dj + 1], sa, kf[2], kf[3]);
      }
    }
    stage ^= 1;
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t_row[i];
    if (t < 0) continue;
    const int h = hk * p.G + (r0 + 8 * i) / p.BQ;
    T* row = dqb + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int dj = 0; dj < DT; ++dj)
      *reinterpret_cast<uint32_t*>(row + dj * 8 + 2 * tq) =
          pack2<T>(acc[dj][2 * i] * p.scale, acc[dj][2 * i + 1] * p.scale);
  }
}

// Records events[i] on the stream when the caller passed events (timing of
// the sub-kernels: [0] before delta, [1] after it, [2] after dkv, [3] after dq).
inline cudaError_t mark(cudaEvent_t* events, int i, cudaStream_t stream) {
  return events ? cudaEventRecord(events[i], stream) : cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_mma(const BwdParams& p, cudaStream_t stream, cudaEvent_t* ev) {
  const int64_t rows = (int64_t)p.B * p.T * p.H;
  cudaError_t err = mark(ev, 0, stream);
  if (err != cudaSuccess) return err;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 1, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkv_mma_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kDkvCols - 1) / kDkvCols, p.Hkv, p.B);
  dkv_mma_kernel<T, D><<<grid_kv, kMmaThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 2, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_mma_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  dq_mma_kernel<T, D><<<grid_q, kMmaThreads, smem_q, stream>>>(p);
  err = cudaGetLastError();
  return err == cudaSuccess ? mark(ev, 3, stream) : err;
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream, cudaEvent_t* ev) {
  const int64_t rows = (int64_t)p.B * p.T * p.H;
  cudaError_t err = mark(ev, 0, stream);
  if (err != cudaSuccess) return err;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 1, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kTile - 1) / kTile, p.Hkv, p.B);
  dkv_kernel<T, D><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 2, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  dq_kernel<T, D><<<grid_q, kThreads, smem_q, stream>>>(p);
  err = cudaGetLastError();
  return err == cudaSuccess ? mark(ev, 3, stream) : err;
}

}  // namespace
}  // namespace tn

extern "C" int tn_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int* q_seg, const int* kv_seg,
    float* delta, void* dq, void* dk, void* dv,
    int B, int T, int S, int H, int Hkv, int D, int dtype,
    int causal, int q_offset, int kv_offset, float scale, void* stream, void** events) {
  tn::BwdParams p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.dout = dout; p.lse = lse;
  p.q_seg = q_seg; p.kv_seg = kv_seg; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.H = H; p.Hkv = Hkv; p.D = D;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > tn::kTile || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  p.G = H / Hkv;
  p.causal = causal; p.q_offset = q_offset; p.kv_offset = kv_offset;
  p.scale = scale;
  p.scale_log2 = scale * tn::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaEvent_t* ev = reinterpret_cast<cudaEvent_t*>(events);
  if (dtype == tn::kBFloat16 || dtype == tn::kFloat16) {
    // cp.async moves 16-byte rows of the contiguous inputs
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    p.BQ = tn::kDqRows / p.G;
    p.BQk = tn::kDkvRows / p.G;
    const bool bf = dtype == tn::kBFloat16;
    if (D == 64) return (int)(bf ? tn::launch_mma<__nv_bfloat16, 64>(p, st, ev)
                                 : tn::launch_mma<__half, 64>(p, st, ev));
    if (D == 128) return (int)(bf ? tn::launch_mma<__nv_bfloat16, 128>(p, st, ev)
                                  : tn::launch_mma<__half, 128>(p, st, ev));
    return (int)cudaErrorInvalidValue;
  }
  p.BQ = p.BQk = tn::kTile / p.G;
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st, ev);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st, ev);
  return (int)cudaErrorInvalidValue;
}
