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
// the TMA + wgmma kernels dkv_tc_kernel<T, D> and dq_tc_kernel<T, D> after
// delta16_kernel<T>, one body for both types; f32 keeps the first
// version's FMA kernels delta_kernel, dkv_kernel and dq_kernel, the
// exactness path behind the f32 checks (1e-4).
//
// What bounds it on this card: the products. The gradients need five
// D-deep products per live (row, column) pair (S, dP, dV, dK, dQ: 10·D
// flops); the two-kernel split recomputes S and dP in the dq kernel, so
// the kernels do seven (14·D flops), 40 % more than the bound counts. At
// the training shape that bound is ~0.5 ms of bf16 tensor-core time
// against ~0.1 ms of bytes: operations bound it. The FMA version ran at
// ~12 TFLOP/s. The split is kept because it needs no atomics: every
// gradient element is written once by one block, in a fixed order, so two
// runs give the same bits. As in K1, each tile's exponentials (and masks)
// cost about as much as its products at D 64.
//
// Precision (both routes): the exponentials and dP - delta stay f32; on
// the 16-bit route P and dS are rounded to the input type only as wgmma
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
// The design (TMA + wgmma on sm_90a; blocks run in no order on Hopper, so
// nothing carries across blocks). Both kernels have K1's shape: three
// warpgroups a block, warp 0 of the first (40 registers) a producer that
// keeps a ring of tiles in flight by TMA on mbarriers (128-byte swizzled,
// 4-D tensor maps over the contiguous inputs, zeros past each batch row's
// end) and reads the metadata the consumers need with each tile (segment
// ids, positions, lse, delta, a flag for a wholly live tile); warpgroups
// 1 and 2 (232 registers) compute 64 rows each:
//   - dkv kernel: one block per (batch, kv head, 128 kv columns), computed
//     transposed with the columns as the wgmma rows: S^T = K Q^T and dP^T =
//     V dO^T are SS wgmma (K and V resident, Q and dO K-major), P^T and dS^T
//     are formed in f32 in the accumulators, and dV += P^T dO, dK += dS^T Q
//     are RS wgmma with P^T and dS^T packed straight from the accumulators
//     (dO and Q read MN-major through the transposed descriptor), so dS
//     never goes through shared memory. Q and dO arrive in tiles of 128
//     rows at D 64, 64 at D 128 (G heads x rows / G positions, one 4-D box
//     each, as K1's packing), 3 stages, from the causal diagonal on, so the
//     GQA sum happens in the block's dk/dv accumulators. A warpgroup's
//     tiles run one after another (the two warpgroups interleave): holding
//     a second tile's S^T and dP^T beside dK, dV, P^T and dS^T needs more
//     than its 232 registers at 128 rows, and at 64 rows, where they fit,
//     that overlap ran the training shape slower than this on the card
//     (fewer, wider products win).
//   - dq kernel: K1's grid and 128-row packing; Q and dO resident, K and V
//     tiles of 128 columns (64 at D 128) streamed; S and dP by SS wgmma,
//     dQ += dS K by RS wgmma with K read MN-major; a tile's S and dP run
//     beside the previous tile's dQ product.
//   - Both walk only the span of tiles whose segment ids fall in the range
//     of the block's own (one coalesced pass, live_span, as K1), skip the
//     mask on a tile whose pairs are all live, mask the others
//     branch-free, and give rows with lse = -inf zero gradients (their lse
//     enters as +inf, so p = 0 without a mask).
//   - delta: 8 lanes a row, 16 bytes a lane a step (the f32 route keeps a
//     warp a row).
//   - TMA needs 16-byte aligned bases, which the wrapper checks.
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --tune): at the
// training shape (B1 T16384 H32/8 D64 bf16 causal, 10 documents) delta
// 0.064 ms, dk/dv 1.200 (33 % of its bound), dq 0.890 (33 %): 2.15 ms,
// where the mma.sync bodies this design replaced took 6.952 ms and
// FlashAttention-2 takes 2.470-2.563 (chip_smoke.py phase 6); dq with
// short-circuit masks 1.749-1.762 ms.

#include "common.cuh"
#include "hopper.cuh"

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

// the same for bf16 and f16: 8 lanes a row, each reading 16 bytes (8
// elements) of out and of dout a step, so a warp reads 4 rows in full
// 128-byte lines
template <typename T>
__global__ void delta16_kernel(BwdParams p) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 8;
  const int sub = threadIdx.x & 7;
  const int64_t rows = (int64_t)p.B * p.T * p.H;
  float acc = 0.f;
  if (row < rows) {
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(p.out) + row * p.D);
    const uint4* g = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + row * p.D);
    for (int c = sub; c < p.D / 8; c += 8) {
      const uint4 ov = o[c], gv = g[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(to_f32(oe[k]), to_f32(ge[k]), acc);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const int h = (int)(row % p.H);
    const int64_t bt = row / p.H;
    p.delta[((int64_t)(bt / p.T) * p.H + h) * p.T + bt % p.T] = acc;
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
// bf16 and f16: TMA + wgmma, one body for both. Three warpgroups a block:
// warp 0 of warpgroup 0 loads (TMA for the tiles, plain loads for the row
// and column metadata it hands over with them), warpgroups 1 and 2 compute
// 64 rows each. Every tile is 128-byte swizzled, in 64-column chunks of 128
// lines (hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 384;
constexpr int kDkvCols = 128;  // kv columns per dkv block: two warpgroups of 64
constexpr int kDqRows = 128;   // query rows per dq block: two warpgroups of 64
constexpr int kSegWhole = 1;   // a dq tile's flags, as K1's: its columns all in the rows'
constexpr int kWhole = 2;      // one segment, and every pair of it live

template <int D>
struct DkvTc {
  static constexpr int kChunks = D / 64;
  static constexpr int kRows = D == 64 ? 128 : 64;  // query rows a tile of the walk
  static constexpr int kStages = 3;
  static constexpr uint32_t kKVRegion = kDkvCols * 128;
  static constexpr uint32_t kRowRegion = kRows * 128;
  static constexpr uint32_t kKVBytes = 2 * kChunks * kKVRegion;     // K, V resident
  static constexpr uint32_t kStageBytes = 2 * kChunks * kRowRegion;  // Q, dO
  static constexpr size_t kSmem = 1024 + kKVBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages) +
                                  sizeof(int) * (kStages * (4 * kRows + 1) + kDkvCols + 4);
};

template <int D>
struct DqTc {
  static constexpr int kChunks = D / 64;
  static constexpr int kCols = D == 64 ? 128 : 64;  // kv columns a tile of the walk
  static constexpr int kStages = 3;
  static constexpr uint32_t kRowRegion = kDqRows * 128;
  static constexpr uint32_t kKVRegion = kCols * 128;
  static constexpr uint32_t kQBytes = 2 * kChunks * kRowRegion;      // Q, dO resident
  static constexpr uint32_t kStageBytes = 2 * kChunks * kKVRegion;   // K, V
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages) +
                                  sizeof(int) * (kStages * (kCols + 1) + 4 * kDqRows + 4);
};

// the descriptor of k-step ks of a K-major operand whose rows start at `rows`
// inside 64-column chunks `region` bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* rows, uint32_t region, int ks) {
  return wgmma_desc(rows + (ks / 4) * region + (ks % 4) * 32, 16, 1024);
}

// dk, dv: one block per (128 kv columns, kv head, batch), computed
// transposed with the block's columns as the wgmma rows. K and V stay
// resident; the producer streams Q and dO tiles of kRows query rows (G
// heads x kRows / G positions, one 4-D TMA box each) from the causal
// diagonal on, with each row's position, segment id, lse (base 2) and
// delta. Per tile, warpgroup cw (columns 64 cw ..):
//   S^T = K Q^T, dP^T = V dO^T          (SS wgmma, N = kRows)
//   P^T = exp2(S^T - lse), dS^T = P^T (dP^T - delta)   (f32, in registers)
//   dV += P^T dO, dK += dS^T Q           (RS wgmma, dO and Q read MN-major)
// The G query heads of the kv head pass through the same block, so the GQA
// sum is the accumulation itself.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const BwdParams p) {
  using L = DkvTc<D>;
  constexpr int ST = L::kStages, NR = L::kRows;
  extern __shared__ uint8_t dkv_smem[];
  uint8_t* sKV = dkv_smem + ((1024 - (smem_u32(dkv_smem) & 1023)) & 1023);  // K, then V
  uint8_t* sRows = sKV + L::kKVBytes;  // stage s: Q chunks, then dO chunks
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRows + ST * L::kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  float* sLse2 = reinterpret_cast<float*>(empty + ST);  // [ST][NR] base 2, +inf: p = 0
  float* sDelta = sLse2 + ST * NR;                       // [ST][NR]
  int* sRowT = reinterpret_cast<int*>(sDelta + ST * NR);  // [ST][NR] position, -1 if dead
  int* sQseg = sRowT + ST * NR;                           // [ST][NR]
  int* sWhole = sQseg + ST * NR;                          // [ST]
  int* sKseg = sWhole + ST;                               // [128]
  int* sSegRange = sKseg + kDkvCols;                      // [2] min, max kv segment
  int* sSpan = sSegRange + 2;                             // [2] first, last live position

  const int tid = threadIdx.x;
  const int kv0 = blockIdx.x * kDkvCols;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQk;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
    // K and V at once: their load overlaps the block's set-up and span pass
    mbar_expect_tx(kv_full, L::kKVBytes);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(sKV + c * L::kKVRegion, &map_k, kv_full, c * 64, kv0, hk, b);
      tma_load_4d(sKV + (L::kChunks + c) * L::kKVRegion, &map_v, kv_full, c * 64, kv0, hk, b);
    }
  }
  // rows past the box (G x BQk < kRows) are never loaded: zeros in every stage
  for (int i = nrows * 8 + tid; i < NR * 8; i += kTcThreads)
    for (int c = 0; c < ST * 2 * L::kChunks; ++c)
      reinterpret_cast<int4*>(sRows + c * L::kRowRegion)[i] = make_int4(0, 0, 0, 0);
  fence_proxy_async();
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
  __syncthreads();
  const int seg_lo = sSegRange[0], seg_hi = sSegRange[1];
  const bool cols_whole = kv0 + kDkvCols <= p.S && seg_lo == seg_hi;
  // the query tiles that can see the block's columns: from the causal
  // diagonal on, within the span of positions in the columns' segments
  int t_first = 0;
  if (p.causal) t_first = max(0, p.kv_offset + kv0 - p.q_offset);
  int first, last;
  live_span(p.q_seg ? p.q_seg + (int64_t)b * p.T : nullptr, t_first, p.T, seg_lo, seg_hi,
            sSpan, first, last);
  const int t_begin = last < 0 ? 0 : (first / p.BQk) * p.BQk;
  const int ntiles = last < 0 ? 0 : (last - t_begin) / p.BQk + 1;

  if (tid < 128) {  // producer
    setmaxnreg_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      const int q0 = t_begin + it * p.BQk;
      // every live row of the tile in the columns' one segment (a dead row
      // has zero Q and dO and lse +inf, so it adds nothing unmasked)
      bool whole = true;
      for (int r = lane; r < NR; r += 32) {
        const int t = q0 + r / p.G;
        const bool ok = r < nrows && t < p.T;
        const int64_t o = ((int64_t)b * p.H + hk * p.G + r % p.G) * p.T + t;
        const int seg = ok ? (p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1) : 0;
        const float lse = ok ? p.lse[o] : -INFINITY;
        sLse2[s * NR + r] = lse == -INFINITY ? INFINITY : lse * kLog2e;
        sDelta[s * NR + r] = ok ? p.delta[o] : 0.f;
        sRowT[s * NR + r] = ok ? t : -1;
        sQseg[s * NR + r] = seg;
        whole = whole && (!ok || seg == seg_lo);
      }
      whole = __all_sync(0xffffffffu, whole);
      if (lane == 0)
        sWhole[s] = whole && cols_whole &&
                    (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + kDkvCols - 1);
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = sRows + s * L::kStageBytes;
        mbar_expect_tx(&full[s], 2 * L::kChunks * nrows * 128);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(st + c * L::kRowRegion, &map_q, &full[s], c * 64, hk * p.G, q0, b);
          tma_load_4d(st + (L::kChunks + c) * L::kRowRegion, &map_do, &full[s], c * 64,
                      hk * p.G, q0, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  constexpr int NA = NR / 2;  // S^T and dP^T accumulators a thread
  constexpr int NO = D / 2;   // dK and dV accumulators a thread
  const int cw = tid / 128 - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, tq = lane & 3;
  const int c0 = cw * 64 + warp * 16 + (lane >> 2);  // this thread's columns: c0 and c0 + 8
  const int c_seg[2] = {sKseg[c0], sKseg[c0 + 8]};
  int t_min[2];  // the first query position that sees each of this thread's columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = kv0 + c0 + 8 * i;
    t_min[i] = col >= p.S ? INT_MAX : p.causal ? max(0, p.kv_offset + col - p.q_offset) : 0;
  }
  const uint8_t* tKc = sKV + cw * 8192;                         // this warpgroup's K rows
  const uint8_t* tVc = sKV + L::kChunks * L::kKVRegion + cw * 8192;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint8_t* tQ = sRows + s * L::kStageBytes;
    const uint8_t* tG = tQ + L::kChunks * L::kRowRegion;
    float st[NA], dpt[NA];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<T, NR, 0, 0>(st, kmajor_desc(tKc, L::kKVRegion, ks),
                            kmajor_desc(tQ, L::kRowRegion, ks), ks > 0);
      wgmma_ss<T, NR, 0, 0>(dpt, kmajor_desc(tVc, L::kKVRegion, ks),
                            kmajor_desc(tG, L::kRowRegion, ks), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const float* lse2 = sLse2 + s * NR;
    const float* dl = sDelta + s * NR;
    const int* rowt = sRowT + s * NR;
    const int* rseg = sQseg + s * NR;
    const bool whole = sWhole[s];
    uint32_t pa[NR / 16][4], sa[NR / 16][4];
#pragma unroll
    for (int jn = 0; jn < NR / 8; ++jn) {
      const int r = 8 * jn + 2 * tq;  // this thread's query rows r, r + 1 of block jn
      const float2 lr = *reinterpret_cast<const float2*>(lse2 + r);
      const float2 dr = *reinterpret_cast<const float2*>(dl + r);
      const int2 rt = *reinterpret_cast<const int2*>(rowt + r);
      const int2 rs = *reinterpret_cast<const int2*>(rseg + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;  // which of this thread's columns
        const bool hi = e & 1;
        float pr = fast_exp2(fmaf(st[4 * jn + e], p.scale_log2, -(hi ? lr.y : lr.x)));
        // branch-free: the row's position at or past the column's first
        // visible one (a dead row's -1 never is), and the same segment
        const bool ok = whole | (((hi ? rt.y : rt.x) >= t_min[i]) & ((hi ? rs.y : rs.x) == c_seg[i]));
        pr = ok ? pr : 0.f;
        st[4 * jn + e] = pr;
        dpt[4 * jn + e] = pr * (dpt[4 * jn + e] - (hi ? dr.y : dr.x));
      }
    }
    // query-row blocks 2kk and 2kk + 1 are the A operand of k-step kk
#pragma unroll
    for (int kk = 0; kk < NR / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        pa[kk][h] = pack2<T>(st[8 * kk + 2 * h], st[8 * kk + 2 * h + 1]);
        sa[kk][h] = pack2<T>(dpt[8 * kk + 2 * h], dpt[8 * kk + 2 * h + 1]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NR / 16; ++kk) {
      wgmma_rs<T, D, 1>(dv, pa[kk], wgmma_desc(tG + kk * 2048, L::kRowRegion, 1024), 1);
      wgmma_rs<T, D, 1>(dk, sa[kk], wgmma_desc(tQ + kk * 2048, L::kRowRegion, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(sa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int64_t kv_row = (int64_t)p.Hkv * D;  // elements between two kv positions
  T* dkb = static_cast<T*>(p.dk) + (int64_t)b * p.S * kv_row + hk * D;
  T* dvb = static_cast<T*>(p.dv) + (int64_t)b * p.S * kv_row + hk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = kv0 + c0 + 8 * i;
    if (col >= p.S) continue;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int64_t off = col * kv_row + 8 * jn + 2 * tq;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          pack2<T>(dk[4 * jn + 2 * i] * p.scale, dk[4 * jn + 2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvb + off) = pack2<T>(dv[4 * jn + 2 * i], dv[4 * jn + 2 * i + 1]);
    }
  }
}

// dq: one block per (128 query rows, kv head, batch), K1's grid and row
// packing. Q and dO stay resident; the producer streams K and V tiles of
// kCols columns with their segment ids. Per tile, warpgroup cw (rows 64 cw ..):
//   S = Q K^T, dP = dO V^T (SS wgmma), P = exp2(S - lse), dS = P (dP - delta),
//   dQ += dS K (RS wgmma, K read MN-major).
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const BwdParams p) {
  using L = DqTc<D>;
  constexpr int ST = L::kStages, NC = L::kCols;
  extern __shared__ uint8_t dq_smem[];
  uint8_t* sQG = dq_smem + ((1024 - (smem_u32(dq_smem) & 1023)) & 1023);  // Q, then dO
  uint8_t* sKV = sQG + L::kQBytes;  // stage s: K chunks, then V chunks
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + ST * L::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  int* sKseg = reinterpret_cast<int*>(empty + ST);  // [ST][NC]
  int* sFlags = sKseg + ST * NC;                    // [ST] kSegWhole | kWhole
  int* sRowT = sFlags + ST;                         // [128]
  int* sQseg = sRowT + kDqRows;                     // [128]
  float* sLse2 = reinterpret_cast<float*>(sQseg + kDqRows);  // [128]
  float* sDelta = sLse2 + kDqRows;                           // [128]
  int* sSegRange = reinterpret_cast<int*>(sDelta + kDqRows);  // [2]
  int* sSpan = sSegRange + 2;                                 // [2]

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.BQ;  // the longest causal walks first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = p.G * p.BQ;

  if (tid == 0) {
    sSegRange[0] = INT_MAX;
    sSegRange[1] = INT_MIN;
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
    // Q and dO at once, as K1's Q
    mbar_expect_tx(q_full, 2 * L::kChunks * nrows * 128);
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load_4d(sQG + c * L::kRowRegion, &map_q, q_full, c * 64, hk * p.G, q0, b);
      tma_load_4d(sQG + (L::kChunks + c) * L::kRowRegion, &map_do, q_full, c * 64, hk * p.G,
                  q0, b);
    }
  }
  for (int i = nrows * 8 + tid; i < kDqRows * 8; i += kTcThreads)
    for (int c = 0; c < 2 * L::kChunks; ++c)
      reinterpret_cast<int4*>(sQG + c * L::kRowRegion)[i] = make_int4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (tid < kDqRows) {
    const int r = tid;
    int t = -1, seg = 0;
    float lse2 = INFINITY, dl = 0.f;  // a dead row: p = 0, even where a tile skips the mask
    if (r < nrows && q0 + r / p.G < p.T) {
      t = q0 + r / p.G;
      seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
      atomicMin(&sSegRange[0], seg);
      atomicMax(&sSegRange[1], seg);
      const int64_t o = ((int64_t)b * p.H + hk * p.G + r % p.G) * p.T + t;
      const float lse = p.lse[o];
      lse2 = lse == -INFINITY ? INFINITY : lse * kLog2e;
      dl = p.delta[o];
    }
    sRowT[r] = t;
    sQseg[r] = seg;
    sLse2[r] = lse2;
    sDelta[r] = dl;
  }
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
  const int ntiles = last < 0 ? 0 : last / NC + 1;
  const int tile0 = last < 0 ? 0 : first / NC;

  if (tid < 128) {  // producer, as K1's
    setmaxnreg_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    for (int j = tile0, it = 0; j < ntiles; ++j, ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      const int kv0 = j * NC;
      bool seg_whole = seg_lo == seg_hi;
      for (int c = lane; c < NC; c += 32) {
        const int col = kv0 + c;
        int seg = INT_MIN;
        if (col < kv_end) {
          seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
          seg_whole = seg_whole && seg == seg_lo;
        }
        sKseg[s * NC + c] = seg;
      }
      seg_whole = __all_sync(0xffffffffu, seg_whole);
      if (lane == 0)
        sFlags[s] = (seg_whole ? kSegWhole : 0) |
                    (seg_whole && kv0 + NC <= kv_end &&
                             (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + NC - 1)
                         ? kWhole
                         : 0);
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = sKV + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kStageBytes);
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(st + c * L::kKVRegion, &map_k, &full[s], c * 64, kv0, hk, b);
          tma_load_4d(st + (L::kChunks + c) * L::kKVRegion, &map_v, &full[s], c * 64, kv0, hk,
                      b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  constexpr int NA = NC / 2;  // S and dP accumulators a thread
  constexpr int NO = D / 2;   // dQ accumulators a thread
  const int cw = tid / 128 - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, tq = lane & 3;
  const int r0 = cw * 64 + warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int t_row[2] = {sRowT[r0], sRowT[r0 + 8]};
  const int seg_row[2] = {sQseg[r0], sQseg[r0 + 8]};
  const float lse2[2] = {sLse2[r0], sLse2[r0 + 8]};
  const float dl[2] = {sDelta[r0], sDelta[r0 + 8]};
  const uint8_t* tQc = sQG + cw * 8192;
  const uint8_t* tGc = sQG + L::kChunks * L::kRowRegion + cw * 8192;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  // As K1's loop: tile it's S and dP run beside the previous tile's
  // dQ += dS K, so forming dS overlaps that product; the first tile's
  // products and the last tile's dQ are peeled off the loop.
  float sc[NA], dp[NA];
  uint32_t sa[NC / 16][4];
  const int n = ntiles - tile0;
  auto issue_s = [&](int it) {  // S = Q K^T and dP = dO V^T of tile it, one group
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint8_t* tK = sKV + s * L::kStageBytes;
    const uint8_t* tV = tK + L::kChunks * L::kKVRegion;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<T, NC, 0, 0>(sc, kmajor_desc(tQc, L::kRowRegion, ks),
                            kmajor_desc(tK, L::kKVRegion, ks), ks > 0);
      wgmma_ss<T, NC, 0, 0>(dp, kmajor_desc(tGc, L::kRowRegion, ks),
                            kmajor_desc(tV, L::kKVRegion, ks), ks > 0);
    }
    wgmma_commit();
  };
  auto issue_dq = [&](int it) {  // dQ += dS K of tile it, one group
    const uint8_t* tK = sKV + (it % ST) * L::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
      wgmma_rs<T, D, 1>(acc, sa[kk], wgmma_desc(tK + kk * 2048, L::kKVRegion, 1024), 1);
    wgmma_commit();
  };
  auto form_ds = [&](int it) {  // dS of tile it into sc, in f32
    const int s = it % ST;
    const int kv0 = (tile0 + it) * NC;
    const int* kseg = sKseg + s * NC;
    const int flags = sFlags[s];
    // K1's branch-free mask: columns [0, lim) of the tile in range and
    // visible, the segment ids compared unless the tile is in one segment
    const bool whole = flags & kWhole, seg_check = !(flags & kSegWhole);
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int diag = p.causal ? p.q_offset + t_row[i] - p.kv_offset - kv0 + 1 : NC;
      lim[i] = t_row[i] < 0 ? 0 : min(kv_end - kv0, diag);
    }
#pragma unroll
    for (int jn = 0; jn < NC / 8; ++jn) {
      const int c = 8 * jn + 2 * tq;
      const int2 ks = *reinterpret_cast<const int2*>(kseg + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = fast_exp2(fmaf(sc[4 * jn + e], p.scale_log2, -lse2[i]));
        const bool ok = whole | ((c + (e & 1) < lim[i]) &
                                 (!seg_check | (((e & 1) ? ks.y : ks.x) == seg_row[i])));
        pr = ok ? pr : 0.f;
        sc[4 * jn + e] = pr * (dp[4 * jn + e] - dl[i]);
      }
    }
  };
  auto pack_ds = [&]() {  // column blocks 2kk and 2kk + 1: the A operand of k-step kk
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) sa[kk][h] = pack2<T>(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
  };
  auto release = [&](int it) {  // this warp is done with tile it's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };

  if (n > 0) {
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    form_ds(0);
    pack_ds();
    for (int it = 1; it < n; ++it) {
      wgmma_fence();
      issue_s(it);
      issue_dq(it - 1);
      wgmma_wait<1>();  // S and dP of tile it are done; dQ of tile it - 1 may still run
      fence_regs(sc);
      fence_regs(dp);
      form_ds(it);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sa);
      release(it - 1);
      pack_ds();
    }
    wgmma_fence();
    issue_dq(n - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sa);
    release(n - 1);
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t_row[i];
    if (t < 0) continue;
    const int h = hk * p.G + (r0 + 8 * i) % p.G;
    T* row = dqb + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(row + 8 * jn + 2 * tq) =
          pack2<T>(acc[4 * jn + 2 * i] * p.scale, acc[4 * jn + 2 * i + 1] * p.scale);
  }
}

// Records events[i] on the stream when the caller passed events (timing of
// the sub-kernels: [0] before delta, [1] after it, [2] after dkv, [3] after dq).
inline cudaError_t mark(cudaEvent_t* events, int i, cudaStream_t stream) {
  return events ? cudaEventRecord(events[i], stream) : cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_tc(const BwdParams& p, cudaStream_t stream, cudaEvent_t* ev) {
  using KV = DkvTc<D>;
  using Q = DqTc<D>;
  // q, dout [B, T, H, D] and k, v [B, S, Hkv, D], contiguous
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)p.H, (uint64_t)p.T, (uint64_t)p.B};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)p.S, (uint64_t)p.Hkv, (uint64_t)p.B};
  const int64_t q_st[3] = {D, (int64_t)p.H * D, (int64_t)p.T * p.H * D};
  const int64_t k_st[3] = {(int64_t)p.Hkv * D, D, (int64_t)p.S * p.Hkv * D};
  const uint32_t box_rows_kv[4] = {64u, (uint32_t)p.G, (uint32_t)p.BQk, 1u};
  const uint32_t box_rows_q[4] = {64u, (uint32_t)p.G, (uint32_t)p.BQ, 1u};
  const uint32_t box_cols_kv[4] = {64u, (uint32_t)kDkvCols, 1u, 1u};
  const uint32_t box_cols_q[4] = {64u, (uint32_t)Q::kCols, 1u, 1u};
  CUtensorMap m_q_kv, m_do_kv, m_k_kv, m_v_kv, m_q_q, m_do_q, m_k_q, m_v_q;
  if (!tensor_map_4d<T>(&m_q_kv, p.q, qdims, q_st, box_rows_kv) ||
      !tensor_map_4d<T>(&m_do_kv, p.dout, qdims, q_st, box_rows_kv) ||
      !tensor_map_4d<T>(&m_k_kv, p.k, kdims, k_st, box_cols_kv) ||
      !tensor_map_4d<T>(&m_v_kv, p.v, kdims, k_st, box_cols_kv) ||
      !tensor_map_4d<T>(&m_q_q, p.q, qdims, q_st, box_rows_q) ||
      !tensor_map_4d<T>(&m_do_q, p.dout, qdims, q_st, box_rows_q) ||
      !tensor_map_4d<T>(&m_k_q, p.k, kdims, k_st, box_cols_q) ||
      !tensor_map_4d<T>(&m_v_q, p.v, kdims, k_st, box_cols_q))
    return cudaErrorInvalidValue;

  const int64_t rows = (int64_t)p.B * p.T * p.H;
  cudaError_t err = mark(ev, 0, stream);
  if (err != cudaSuccess) return err;
  delta16_kernel<T><<<(unsigned)((rows + 31) / 32), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 1, stream);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dkv_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KV::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kDkvCols - 1) / kDkvCols, p.Hkv, p.B);
  dkv_tc_kernel<T, D><<<grid_kv, kTcThreads, KV::kSmem, stream>>>(m_q_kv, m_do_kv, m_k_kv,
                                                                   m_v_kv, p);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(ev, 2, stream);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Q::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  dq_tc_kernel<T, D><<<grid_q, kTcThreads, Q::kSmem, stream>>>(m_q_q, m_do_q, m_k_q, m_v_q, p);
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
    // TMA reads the contiguous inputs from 16-byte aligned bases
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)dout) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    p.BQ = tn::kDqRows / p.G;
    const bool bf = dtype == tn::kBFloat16;
    if (D == 64) {
      p.BQk = tn::DkvTc<64>::kRows / p.G;
      return (int)(bf ? tn::launch_tc<__nv_bfloat16, 64>(p, st, ev)
                      : tn::launch_tc<__half, 64>(p, st, ev));
    }
    if (D == 128) {
      p.BQk = tn::DkvTc<128>::kRows / p.G;
      return (int)(bf ? tn::launch_tc<__nv_bfloat16, 128>(p, st, ev)
                      : tn::launch_tc<__half, 128>(p, st, ev));
    }
    return (int)cudaErrorInvalidValue;
  }
  p.BQ = p.BQk = tn::kTile / p.G;
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st, ev);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st, ev);
  return (int)cudaErrorInvalidValue;
}
