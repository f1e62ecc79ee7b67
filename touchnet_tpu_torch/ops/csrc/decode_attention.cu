// Copyright (c) 2026 touchnet_tpu authors.
// K4: ragged flash-decode over the packed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel touchnet_tpu/ops/decode_attention.py:_kernel
// (:85, launched by decode_attention :286). Same contract: one query per
// (row, head) against the packed cache [L, B, Hkv, S, 2D] (K in [0, D), V
// in [D, 2D)) at one layer; column c of row b is live iff c < prompt_len[b]
// or base <= c <= last.
//
// What bounds it on this card: device-memory bandwidth. Each step reads
// every live K/V byte of the layer once and does only G = H/Hkv dot
// products of length D per key (2·G flops per byte in bf16), far below
// the ~295 flops/byte where the tensor cores would become the limit. So the
// design is about keeping enough cache bytes in flight on every SM.
//
// The tensor-core kernel (decode_mma_kernel<T>, one body for bf16 and f16;
// inputs bf16, f16 or f32):
//   - An asynchronous ring. Each block streams its split's live columns
//     through kStages tiles of kCols columns in shared memory, filled by
//     16-byte cp.async.cg copies (16 consecutive lanes read one 256-byte
//     D64 column): tiles t+1 .. t+kStages-1 are in flight while tile t is
//     computed, and one barrier a tile both publishes tile t and frees the
//     slot the next copy refills. The tiles stay in the cache's type (rows
//     padded by 16 bytes so an ldmatrix's 8 rows hit 8 bank groups);
//     nothing is converted to f32 in shared memory.
//   - Products on tensor cores in registers: mma.sync m16n8k16 with the G
//     query heads padded to 16 rows (K1's fragment scheme: Q fragments held
//     for the whole walk, K by ldmatrix, V by ldmatrix.trans, P packed from
//     the score accumulators into A fragments). The kernel is bound by
//     bytes, so the padding costs nothing that shows; the point of the
//     tensor cores is that a warp spends a few instructions a tile and
//     keeps issuing copies. Each of the 4 warps owns 16 columns of every
//     tile with its own online softmax (f32, in registers); the warps'
//     states merge once, at the end of the block.
//   - Balanced splits without a host sync: the wrapper gives every split
//     the same budget of live columns (cols_per_split, a multiple of the
//     tile; ops/decode_attention.split_plan) and sizes the grid from the
//     capacity S. A block whose split starts past its row's live count
//     exits at once, so no block streams more than the budget, whatever
//     the prompt lengths.
//   - The row's live set is one virtual range [0, n): j < plen is column j,
//     j >= plen is column max(base, plen) + (j - plen). A tile is at most
//     two contiguous runs of the cache; the dead [plen, base) gap is never
//     read, and columns past the split's end are zero-filled and masked.
// f16 (the CLIs' --model_dtype float16): the kernel rounds to f16 only P,
// for the PV product, and the output. P = exp2(s - m) lies in [0, 1]; the
// output is a convex combination of the cache's V rows, so |out| <= max
// |v|, an f16 value: neither can reach f16's 65504. Scores, the split
// partials and the combine stay f32.
// f32 keeps the FMA kernel (decode_split_kernel), the 1e-4 exactness path,
// on the same split plan. decode_combine_kernel merges a row's splits in
// split order (the same bits every run) and writes 0 for a row with no
// live column. The layer is selected by the wrapper's pointer offset, so
// the cache is never sliced or copied.

#include <type_traits>

#include "common.cuh"

namespace tn {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // FMA kernel: kv columns per tile, one per lane in the softmax pass
constexpr int kMaxG = 16;  // query heads per kv head
constexpr int kCols = 64;  // tensor-core kernel: kv columns per ring tile, 16 per warp

struct DecodeParams {
  const void* q;     // [B, H, D] contiguous
  const void* kv;    // one layer of the cache, [B, Hkv, S, 2D] contiguous
  const int* plen;   // [B]
  float* part_m;     // [B, H, nsplit], base-2 running max
  float* part_l;     // [B, H, nsplit]
  float* part_acc;   // [B, H, nsplit, D], unnormalised
  int H, Hkv, G, S, base, last, nsplit, cps;
  float scale_log2;
};

// the live set of row b as the virtual range [0, n); see the note above
struct LiveRange {
  int plen, bstart, n;
  __device__ LiveRange(const DecodeParams& p, int b) {
    plen = min(max(p.plen[b], 0), p.S);
    bstart = max(p.base, plen);
    const int bend = min(p.last + 1, p.S);
    n = plen + max(bend - bstart, 0);
  }
  __device__ int col(int j) const { return j < plen ? j : bstart + (j - plen); }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(DecodeParams p) {
  constexpr int kPer = (kMaxG * D + kThreads - 1) / kThreads;
  __shared__ float sKV[kTile][2 * D + 1];
  __shared__ float sQ[kMaxG][D];
  __shared__ float sS[kMaxG][kTile];
  __shared__ float sAlpha[kMaxG];
  __shared__ float sM[kMaxG];
  __shared__ float sL[kMaxG];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G;

  const LiveRange live(p, b);
  const int j0 = split * p.cps;
  if (j0 >= live.n) return;  // past the row's live count: the combine skips it
  const int j1 = min(live.n, j0 + p.cps);

  const T* kvb = static_cast<const T*>(p.kv) +
                 ((int64_t)b * p.Hkv + hk) * (int64_t)p.S * (2 * D);
  const T* qb = static_cast<const T*>(p.q) + ((int64_t)b * p.H + hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    sQ[i / D][i % D] = to_f32(qb[i]) * p.scale_log2;
  if (tid < kMaxG) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t0 = j0; t0 < j1; t0 += kTile) {
    __syncthreads();  // sQ/sM ready; the previous tile's readers are done
    for (int i = tid; i < kTile * 2 * D; i += kThreads) {
      const int kk = i / (2 * D), e = i % (2 * D);
      const int j = t0 + kk;
      sKV[kk][e] = j < j1 ? to_f32(kvb[(int64_t)live.col(j) * (2 * D) + e]) : 0.f;
    }
    __syncthreads();

    for (int pi = tid; pi < G * kTile; pi += kThreads) {
      const int g = pi / kTile, kk = pi % kTile;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g][d], sKV[kk][d], s);
      sS[g][kk] = t0 + kk < j1 ? s : -INFINITY;
    }
    __syncthreads();

    // one warp per query head; column t0 is live, so m_new is finite
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = sS[g][lane];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = exp2f(s - m_new);
      sS[g][lane] = pr;
      const float sum = warp_sum(pr);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int o = tid + i * kThreads;
      if (o < G * D) {
        const int g = o / D, d = o % D;
        float a = acc[i] * sAlpha[g];
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) a = fmaf(sS[g][kk], sKV[kk][D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  const int64_t head0 = (int64_t)b * p.H + hk * G;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) {
      const int g = o / D, d = o % D;
      p.part_acc[((head0 + g) * p.nsplit + split) * D + d] = acc[i];
    }
  }
  if (tid < G) {
    p.part_m[(head0 + tid) * p.nsplit + split] = sM[tid];
    p.part_l[(head0 + tid) * p.nsplit + split] = sL[tid];
  }
}

// ring geometry of the tensor-core kernel (bf16 or f16): rows of 2D + 8
// elements (16 bytes of padding), the 16 query rows after the ring
template <int D>
struct Ring {
  static constexpr int kLds = 2 * D + 8;
  static constexpr int kLdq = D + 8;
  static constexpr int kChunks = 2 * D / 8;  // 16-byte chunks of one cache column
  static constexpr int kStages = 3;  // D64: 54.5 KB, 4 blocks per SM (PERF.md)
  static constexpr int kTileElems = kCols * kLds;
  static constexpr size_t kBytes =
      (size_t)(kStages * kTileElems + kMaxG * kLdq) * sizeof(uint16_t);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(DecodeParams p) {
  using R = Ring<D>;
  constexpr int KSTEPS = D / 16, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sKV = reinterpret_cast<T*>(smem_raw);
  T* sQ = sKV + R::kStages * R::kTileElems;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;

  const LiveRange live(p, b);
  const int j0 = split * p.cps;
  if (j0 >= live.n) return;  // past the row's live count: the combine skips it
  const int j1 = min(live.n, j0 + p.cps);
  const int ntiles = (j1 - j0 + kCols - 1) / kCols;

  const T* kvb = static_cast<const T*>(p.kv) +
                    ((int64_t)b * p.Hkv + hk) * (int64_t)p.S * (2 * D);
  const T* qb = static_cast<const T*>(p.q) + ((int64_t)b * p.H + hk * p.G) * D;

  // the G query rows, zero rows up to 16; they land with tile 0's group
  for (int i = tid; i < kMaxG * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < p.G;
    cp_async_16(sQ + r * R::kLdq + c * 8, ok ? qb + r * D + c * 8 : qb, ok);
  }
  auto load_tile = [&](int t) {
    T* dst = sKV + (t % R::kStages) * R::kTileElems;
    const int jt = j0 + t * kCols;
#pragma unroll
    for (int k = 0; k < kCols * R::kChunks / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int c = i / R::kChunks, ch = i % R::kChunks;
      const int j = jt + c;
      const bool ok = j < j1;
      cp_async_16(dst + c * R::kLds + ch * 8,
                  ok ? kvb + (int64_t)live.col(j) * (2 * D) + ch * 8 : kvb, ok);
    }
  };
  // prologue: kStages - 1 groups in flight (empty groups past the end keep
  // the count uniform)
#pragma unroll
  for (int t = 0; t < R::kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  uint32_t qf[KSTEPS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<R::kStages - 2>();  // tile t (and Q) has landed for this thread
    // the one barrier of a tile: every thread's copies of tile t are
    // visible, and every warp is done with tile t - 1, whose slot the copy
    // below refills
    __syncthreads();
    if (t + R::kStages - 1 < ntiles) load_tile(t + R::kStages - 1);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], sQ + (lane & 15) * R::kLdq + ks * 16 + (lane >> 4) * 8);
    }

    const T* tK = sKV + (t % R::kStages) * R::kTileElems + warp * 16 * R::kLds;
    const T* tV = tK + D;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // matrices: (n-tile 0, k lo), (0, k hi), (1, k lo), (1, k hi)
      uint32_t kf[4];
      ldmatrix_x4(kf, tK + ((mi >> 1) * 8 + (lane & 7)) * R::kLds + ks * 16 + (mi & 1) * 8);
      mma_16816<T>(s[0], qf[ks], kf[0], kf[1]);
      mma_16816<T>(s[1], qf[ks], kf[2], kf[3]);
    }

    // scores in base 2; columns past the split's end (last tile only) masked
    const int jw = j0 + t * kCols + warp * 16;
    const bool tail = jw + 16 > j1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (tail && jw + j * 8 + 2 * tq + (e & 1) >= j1) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
      for (int dj = 0; dj < DT; ++dj) {
        acc[dj][2 * i] *= alpha;
        acc[dj][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];  // this thread's part; the quad sums at the end
      }

    // O += P V over the warp's 16 columns: one k-step
    const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]), pack2<T>(s[0][2], s[0][3]),
                            pack2<T>(s[1][0], s[1][1]), pack2<T>(s[1][2], s[1][3])};
#pragma unroll
    for (int dj = 0; dj < DT; dj += 2) {
      // matrices: (k lo, d-tile dj), (k hi, dj), (k lo, dj+1), (k hi, dj+1)
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, tV + ((mi & 1) * 8 + (lane & 7)) * R::kLds + dj * 8 + (mi >> 1) * 8);
      mma_16816<T>(acc[dj], pa, vf[0], vf[1]);
      mma_16816<T>(acc[dj + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states below

  // merge the 4 warps' (m, l, acc) of each query row, in warp order
  float* sAcc = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
  float* sM = sAcc + 4 * kMaxG * D;                   // [4][16]
  float* sL = sM + 4 * kMaxG;                         // [4][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = g + 8 * i;
    float* row = sAcc + (warp * kMaxG + r) * D;
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) {
      row[dj * 8 + 2 * tq] = acc[dj][2 * i];
      row[dj * 8 + 2 * tq + 1] = acc[dj][2 * i + 1];
    }
    if (tq == 0) {
      sM[warp * kMaxG + r] = m[i];
      sL[warp * kMaxG + r] = l[i];
    }
  }
  __syncthreads();
  const int64_t head0 = (int64_t)b * p.H + hk * p.G;
  for (int o = tid; o < p.G * D; o += kThreads) {
    const int r = o / D, d = o % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, sM[w * kMaxG + r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = sM[w * kMaxG + r];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mm);  // a warp with no live column
      ll += wt * sL[w * kMaxG + r];
      a += wt * sAcc[(w * kMaxG + r) * D + d];
    }
    const int64_t slot = (head0 + r) * p.nsplit + split;
    p.part_acc[slot * D + d] = a;
    if (d == 0) {
      p.part_m[slot] = mm;
      p.part_l[slot] = ll;
    }
  }
}

// one block per (row, head), one thread per output lane; the row's splits
// that hold live columns, merged in split order
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(DecodeParams p, T* out) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const LiveRange live(p, (int)(bh / p.H));
  const int nsp = (live.n + p.cps - 1) / p.cps;
  const float* pm = p.part_m + bh * p.nsplit;
  const float* pl = p.part_l + bh * p.nsplit;
  const float* pa = p.part_acc + bh * p.nsplit * D;
  float m = -INFINITY;
  for (int s = 0; s < nsp; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, a = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < nsp; ++s) {
      const float w = exp2f(pm[s] - m);
      l += w * pl[s];
      a += w * pa[s * D + d];
    }
  }
  out[bh * D + d] = from_f32<T>(l > 0.f ? a / l : 0.f);
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, int B, void* out, cudaStream_t stream) {
  const dim3 grid(p.nsplit, p.Hkv, B);
  if constexpr (!std::is_same<T, float>::value) {
    constexpr size_t smem = Ring<D>::kBytes;
    static_assert(smem >= (size_t)(4 * kMaxG * (D + 2)) * sizeof(float), "merge space");
    cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    decode_mma_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    decode_split_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<B * p.H, D, 0, stream>>>(p, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tn

extern "C" int tn_flash_decode(
    const void* q, const void* kv, const int* plen, void* out,
    float* part_m, float* part_l, float* part_acc,
    int B, int H, int Hkv, int S, int D, int dtype, int base, int last,
    int nsplit, int cols_per_split, float scale, void* stream) {
  tn::DecodeParams p;
  p.q = q; p.kv = kv; p.plen = plen;
  p.part_m = part_m; p.part_l = part_l; p.part_acc = part_acc;
  p.H = H; p.Hkv = Hkv; p.G = H / Hkv; p.S = S;
  p.base = base; p.last = last; p.nsplit = nsplit; p.cps = cols_per_split;
  p.scale_log2 = scale * tn::kLog2e;
  // every live column (at most S) must fall in one of the nsplit splits
  if (H % Hkv != 0 || p.G > tn::kMaxG || B <= 0 || nsplit <= 0 || cols_per_split <= 0 ||
      cols_per_split % tn::kCols != 0 || (int64_t)nsplit * cols_per_split < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tn::kBFloat16 && D == 64) return (int)tn::launch<__nv_bfloat16, 64>(p, B, out, st);
  if (dtype == tn::kBFloat16 && D == 128) return (int)tn::launch<__nv_bfloat16, 128>(p, B, out, st);
  if (dtype == tn::kFloat16 && D == 64) return (int)tn::launch<__half, 64>(p, B, out, st);
  if (dtype == tn::kFloat16 && D == 128) return (int)tn::launch<__half, 128>(p, B, out, st);
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, B, out, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, B, out, st);
  return (int)cudaErrorInvalidValue;
}
