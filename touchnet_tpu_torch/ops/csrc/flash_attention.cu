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
//   - bf16 and f16 (every such call): flash_fwd_tc_kernel<T, D>, one body
//     for both types, on TMA and wgmma.
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
// bytes, so the kernel is bound by operations. Beside the products, each
// 128 x 128 tile costs 16K exponentials and, on a masked tile, 16K masks:
// at D 64 about as long as the tile's products on the tensor cores, so the
// design keeps the tensor cores busy while they run, and keeps the mask
// cheap.
//
// The design:
//   - One block of three warpgroups per (batch, kv head, 128 query rows).
//     The rows are BQ = 128 / G positions x the G = H / Hkv query heads of
//     the kv head (row r: position r / G, head r % G), one TMA box {64, G,
//     BQ, 1} of the 4-D map {D, H, T, B} over q, so each K/V tile is loaded
//     once for the whole GQA group; the map's batch dim zero-fills past T
//     inside each batch row. D 128 is two 64-column boxes side by side;
//     rows past G x BQ (G 3, 7: 126 of 128) are zeroed once.
//   - Warp 0 of warpgroup 0 (its registers cut to 40 by setmaxnreg) loads
//     Q once and keeps a ring of 128-column K/V tiles (3 stages at D 64, 2
//     at D 128) in flight by TMA, 128-byte swizzled, completed on
//     mbarriers. It reads each tile's kv segment ids itself and hands them
//     over with the tile, with two flags: every column in the rows' one
//     segment, and every pair live.
//   - Warpgroups 1 and 2 (232 registers each thread) own 64 rows each. S =
//     Q K^T is an SS wgmma m64n128k16 (K read K-major); the online softmax
//     stays in the accumulators (row max and sum by quad shuffles, base 2,
//     log2 e folded into the scale); P is rounded to the input type
//     straight from the S accumulators into the A operand of an RS wgmma
//     for O += P V, V read MN-major through the transposed descriptor: no
//     copy. Tile it's S and tile it - 1's P V are two wgmma groups in
//     flight together, so the softmax of one tile overlaps the other's
//     product; the loop peels its first and last tiles so that every wait
//     completes a known group (ptxas keeps wgmma asynchronous).
//   - No host-side block map (the TPU kernel's _kv_block_map sort): one
//     coalesced pass over the kv segment ids (live_span) finds the first
//     and last column, up to the causal diagonal, whose segment falls in
//     the range of the block's query segments; the block walks only those
//     tiles. A tile whose pairs are all live skips the mask; the others
//     mask branch-free: a column limit per row (range and causal diagonal)
//     and, only where the tile's ids are not all the rows' segment, the
//     segment compare (a mask of && chains branches per element, which
//     costs this kernel half again its time: the times below).
//   - K and V are read through strides, so the chunked-prefill path passes
//     the two halves of the packed [B, Hkv, S, 2D] cache without a copy;
//     TMA needs a 16-byte aligned base and strides in 16-byte units, which
//     the wrapper and the entry check.
//   - Rows with no live key write out = 0 and lse = -inf, never NaN.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --tune): at the
// training shape (B1 T16384 H32/8 D64 bf16 causal, 10 documents) 0.865-
// 0.934 ms, 21-23 % of the bound, where the mma.sync body this design
// replaced took 2.371 ms and FlashAttention-2 takes 0.855-0.888
// (chip_smoke.py phase 3); with short-circuit masks 1.420-1.549 ms, with
// 64-column tiles 0.955-0.998.

#include "common.cuh"
#include "hopper.cuh"

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
// bf16 and f16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int kTcThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kTcCols = 128;     // kv columns per tile
constexpr int kSegWhole = 1;     // a tile's flags: its columns all in the rows' one segment,
constexpr int kWhole = 2;        // and every pair of it live: no mask

template <int D>
struct FwdTc {
  static constexpr int kChunks = D / 64;                    // 64-column chunks of a row
  static constexpr int kStages = D == 64 ? 3 : 2;           // K/V ring
  static constexpr uint32_t kQBytes = kChunks * kTcRows * 128;
  static constexpr uint32_t kKVRegion = kTcCols * 128;      // one chunk of a K or V tile
  static constexpr uint32_t kStageBytes = 2 * kChunks * kKVRegion;  // K then V
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes +
                                  8 * (1 + 2 * kStages) +
                                  sizeof(int) * (kStages * (kTcCols + 1) + 2 * kTcRows + 4);
};

// One block per (128 query rows, kv head, batch): rows (position, head) =
// BQ positions x the G query heads of the kv head, as one TMA box of the
// 4-D map {D, H, T, B}. Thread 0 loads Q first thing; warp 0 of warpgroup
// 0 keeps a ring of K/V tiles in flight (with each tile's kv segment ids
// and flags, which it reads itself); warpgroups 1 and 2 each own 64 rows:
// S = Q K^T (SS wgmma), the online softmax in the accumulators, O += P V
// (RS wgmma, P from the S accumulators, V read MN-major).
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const FwdParams p) {
  using L = FwdTc<D>;
  constexpr int ST = L::kStages;
  extern __shared__ uint8_t fwd_smem[];
  uint8_t* sQ = fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  uint8_t* sKV = sQ + L::kQBytes;  // stage s: K chunks, then V chunks
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + ST * L::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  int* sKseg = reinterpret_cast<int*>(empty + ST);  // [ST][kTcCols]
  int* sFlags = sKseg + ST * kTcCols;               // [ST] kSegWhole | kWhole
  int* sRowT = sFlags + ST;                         // [128] position, -1 if dead
  int* sQseg = sRowT + kTcRows;                     // [128]
  int* sSegRange = sQseg + kTcRows;                 // [2] min, max query segment
  int* sSpan = sSegRange + 2;                       // [2] first, last live column

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
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_fence_init();
    // Q at once: its load overlaps the block's set-up and span pass
    mbar_expect_tx(q_full, L::kChunks * nrows * 128);
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sQ + c * kTcRows * 128, &map_q, q_full, c * 64, hk * p.G, q0, b);
  }
  // rows past the box (G x BQ < 128) are never loaded: zeros, not garbage
  for (int i = nrows * 8 + tid; i < kTcRows * 8; i += kTcThreads)
    for (int c = 0; c < L::kChunks; ++c)
      reinterpret_cast<int4*>(sQ + c * kTcRows * 128)[i] = make_int4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  if (tid < kTcRows) {
    const int r = tid;
    int t = -1, seg = 0;
    if (r < nrows && q0 + r / p.G < p.T) {
      t = q0 + r / p.G;
      seg = p.q_seg ? p.q_seg[(int64_t)b * p.T + t] : 1;
      atomicMin(&sSegRange[0], seg);
      atomicMax(&sSegRange[1], seg);
    }
    sRowT[r] = t;
    sQseg[r] = seg;
  }
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
  const int ntiles = last < 0 ? 0 : last / kTcCols + 1;
  const int tile0 = last < 0 ? 0 : first / kTcCols;

  if (tid < 128) {  // producer
    setmaxnreg_dec<40>();
    if (tid >= 32) return;
    const int lane = tid;
    for (int j = tile0, it = 0; j < ntiles; ++j, ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);  // the first lap passes
      const int kv0 = j * kTcCols;
      // the tile's flags: every column before kv_end in the rows' one
      // segment (kSegWhole), and also every pair live (kWhole)
      bool seg_whole = seg_lo == seg_hi;
      for (int c = lane; c < kTcCols; c += 32) {
        const int col = kv0 + c;
        int seg = INT_MIN;  // beyond the live range: matches no row
        if (col < kv_end) {
          seg = p.kv_seg ? p.kv_seg[(int64_t)b * p.S + col] : 1;
          seg_whole = seg_whole && seg == seg_lo;
        }
        sKseg[s * kTcCols + c] = seg;
      }
      seg_whole = __all_sync(0xffffffffu, seg_whole);
      if (lane == 0)
        sFlags[s] = (seg_whole ? kSegWhole : 0) |
                    (seg_whole && kv0 + kTcCols <= kv_end &&
                             (!p.causal || p.q_offset + q0 >= p.kv_offset + kv0 + kTcCols - 1)
                         ? kWhole
                         : 0);
      __syncwarp();
      if (lane == 0) {  // the arrive releases the ids and the flag with the tile
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

  // consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the block
  setmaxnreg_inc<232>();
  constexpr int NS = kTcCols / 2;  // S accumulators a thread
  constexpr int NO = D / 2;        // O accumulators a thread
  const int cw = tid / 128 - 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5, tq = lane & 3;
  const int r0 = cw * 64 + warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int t_row[2] = {sRowT[r0], sRowT[r0 + 8]};
  const int seg_row[2] = {sQseg[r0], sQseg[r0 + 8]};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);

  // Tile it's S = Q K^T and the previous tile's O += P V run as two wgmma
  // groups in flight at once: the softmax of tile it overlaps the product
  // of tile it - 1, and O is rescaled once that product is done. The first
  // tile's S and the last tile's P V are peeled off the loop, so that every
  // wait in it completes a known group (ptxas then keeps wgmma asynchronous).
  float sc[NS];
  uint32_t pa[kTcCols / 16][4];
  const int n = ntiles - tile0;

  // S = Q K^T of tile it into sc, one committed group
  auto issue_qk = [&](int it) {
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint8_t* tk = sKV + s * L::kStageBytes;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T, kTcCols, 0, 0>(
          sc, wgmma_desc(sQ + (ks / 4) * kTcRows * 128 + cw * 8192 + (ks % 4) * 32, 16, 1024),
          wgmma_desc(tk + (ks / 4) * L::kKVRegion + (ks % 4) * 32, 16, 1024), ks > 0);
    wgmma_commit();
  };
  // O += P V of tile it, one committed group
  auto issue_pv = [&](int it) {
    const uint8_t* tv = sKV + (it % ST) * L::kStageBytes + L::kChunks * L::kKVRegion;
#pragma unroll
    for (int kk = 0; kk < kTcCols / 16; ++kk)
      wgmma_rs<T, D, 1>(o, pa[kk], wgmma_desc(tv + kk * 2048, L::kKVRegion, 1024), 1);
    wgmma_commit();
  };
  // mask, running max and sum of tile it (S in sc); P = exp2(S - max) in
  // sc; returns the rescale of the rows' earlier sums in alpha
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int s = it % ST;
    const int kv0 = (tile0 + it) * kTcCols;
    const int* kseg = sKseg + s * kTcCols;
    const int flags = sFlags[s];
    float mx[2] = {m[0], m[1]};
    if (flags & kWhole) {
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        sc[e] *= p.scale_log2;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      }
    } else {
      // branch-free mask: columns [0, lim) of the tile are in range and,
      // when causal, not past the row's diagonal; the segment ids are
      // compared unless every column of the tile is in the rows' one segment
      const bool seg_check = !(flags & kSegWhole);
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int diag = p.causal ? p.q_offset + t_row[i] - p.kv_offset - kv0 + 1 : kTcCols;
        lim[i] = t_row[i] < 0 ? 0 : min(kv_end - kv0, diag);
      }
#pragma unroll
      for (int jn = 0; jn < kTcCols / 8; ++jn) {
        const int c = 8 * jn + 2 * tq;
        const int2 ks = *reinterpret_cast<const int2*>(kseg + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool ok = (c + (e & 1) < lim[i]) &
                          (!seg_check | (((e & 1) ? ks.y : ks.x) == seg_row[i]));
          const float x = ok ? sc[4 * jn + e] * p.scale_log2 : -INFINITY;
          sc[4 * jn + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_use[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // no inf - inf
      alpha[i] = fast_exp2(m[i] - m_use[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      sc[e] = fast_exp2(sc[e] - m_use[(e >> 1) & 1]);
      l[(e >> 1) & 1] += sc[e];  // this thread's part; the quad sums at the end
    }
  };
  // P in the input type, straight from the accumulators: column blocks 2kk
  // and 2kk + 1 are the A operand of k-step kk of P V
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcCols / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) pa[kk][h] = pack2<T>(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
  };
  auto release = [&](int it) {  // this warp is done with tile it's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };

  if (n > 0) {
    float alpha[2];
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, alpha);
    pack_p();
    for (int it = 1; it < n; ++it) {
      wgmma_fence();
      issue_qk(it);
      issue_pv(it - 1);
      wgmma_wait<1>();  // S of tile it is done; P V of tile it - 1 may still run
      fence_regs(sc);
      softmax(it, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(it - 1);
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        o[4 * jn] *= alpha[0];
        o[4 * jn + 1] *= alpha[0];
        o[4 * jn + 2] *= alpha[1];
        o[4 * jn + 3] *= alpha[1];
      }
      pack_p();
    }
    wgmma_fence();
    issue_pv(n - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(n - 1);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = t_row[i];
    if (t < 0) continue;
    const int h = hk * p.G + (r0 + 8 * i) % p.G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + (((int64_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + 2 * tq) =
          pack2<T>(o[4 * jn + 2 * i] * inv, o[4 * jn + 2 * i + 1] * inv);
    if (tq == 0)
      p.lse[((int64_t)b * p.H + h) * p.T + t] = l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_tc(const FwdParams& p, cudaStream_t stream) {
  using L = FwdTc<D>;
  CUtensorMap map_q, map_k, map_v;
  const int64_t q_st[3] = {p.q_sh, p.q_st, p.q_sb};
  const int64_t k_st[3] = {p.k_ss, p.k_sh, p.k_sb};
  const int64_t v_st[3] = {p.v_ss, p.v_sh, p.v_sb};
  if (!tensor_map_4d<T>(&map_q, p.q, {(uint64_t)D, (uint64_t)p.H, (uint64_t)p.T, (uint64_t)p.B},
                        q_st, {64u, (uint32_t)p.G, (uint32_t)p.BQ, 1u}) ||
      !tensor_map_4d<T>(&map_k, p.k, {(uint64_t)D, (uint64_t)p.S, (uint64_t)p.Hkv, (uint64_t)p.B},
                        k_st, {64u, (uint32_t)kTcCols, 1u, 1u}) ||
      !tensor_map_4d<T>(&map_v, p.v, {(uint64_t)D, (uint64_t)p.S, (uint64_t)p.Hkv, (uint64_t)p.B},
                        v_st, {64u, (uint32_t)kTcCols, 1u, 1u}))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + p.BQ - 1) / p.BQ, p.Hkv, p.B);
  flash_fwd_tc_kernel<T, D><<<grid, kTcThreads, L::kSmem, stream>>>(map_q, map_k, map_v, p);
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
    // TMA needs a 16-byte aligned base and row strides in 16-byte units
    const int64_t strides[] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (int64_t x : strides)
      if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    p.BQ = tn::kTcRows / p.G;
    const bool bf = dtype == tn::kBFloat16;
    if (D == 64) return (int)(bf ? tn::launch_tc<__nv_bfloat16, 64>(p, st)
                                 : tn::launch_tc<__half, 64>(p, st));
    if (D == 128) return (int)(bf ? tn::launch_tc<__nv_bfloat16, 128>(p, st)
                                  : tn::launch_tc<__half, 128>(p, st));
    return (int)cudaErrorInvalidValue;
  }
  p.BQ = tn::kRows / p.G;
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
