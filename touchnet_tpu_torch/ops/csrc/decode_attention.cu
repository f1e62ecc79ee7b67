// Copyright (c) 2026 touchnet_tpu authors.
// K4: ragged flash-decode over the packed KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel touchnet_tpu/ops/decode_attention.py:_kernel
// (:85, launched by decode_attention :225). Same contract: one query per
// (row, head) against the packed cache [L, B, Hkv, S, 2D] (K in [0, D), V
// in [D, 2D)) at one layer; column c of row b is live iff c < prompt_len[b]
// or base <= c <= last.
//
// What bounds it on this card: device-memory bandwidth. Each step reads
// every live K/V byte of the layer once and does only G = H/Hkv dot
// products of length D per key (2·G flops per byte in bf16), far below
// the ~295 flops/byte where the tensor cores would become the limit. And
// with B·Hkv blocks alone (256 at B=32, Hkv=8) the card's 132 SMs would
// not have enough loads in flight to stream at full bandwidth.
//
// What the design does about it:
//   - Split-KV flash-decode: blocks over (split, kv head, row) each stream
//     one share of the row's live columns and write a partial (m, l, acc)
//     in f32; a second small kernel combines the splits. The split count
//     is chosen by the wrapper to put several blocks on every SM.
//   - No host-side block table (the TPU kernel's live_block_map sort):
//     each block maps its share of the row's live set, the two intervals
//     [0, plen) and [max(base, plen), last], straight onto cache columns,
//     so the dead [plen, base) gap is never read.
//   - All G query heads of a kv head share one block and each K/V row
//     load; the layer is selected by the wrapper's pointer offset, so the
//     cache is never sliced or copied.
//   - A split with no live column leaves m = -inf and is given weight 0 by
//     the combine, which writes 0 (not NaN) for a row with no live column.

#include "common.cuh"

namespace tn {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // kv columns per tile: one per lane in the softmax pass
constexpr int kMaxG = 16;  // query heads per kv head

struct DecodeParams {
  const void* q;     // [B, H, D] contiguous
  const void* kv;    // one layer of the cache, [B, Hkv, S, 2D] contiguous
  const int* plen;   // [B]
  float* part_m;     // [B, H, nsplit], base-2 running max
  float* part_l;     // [B, H, nsplit]
  float* part_acc;   // [B, H, nsplit, D], unnormalised
  int H, Hkv, G, S, base, last, nsplit;
  float scale_log2;
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

  // the row's live set as one virtual range [0, n): j < plen is column j,
  // j >= plen is column bstart + (j - plen)
  const int plen = min(max(p.plen[b], 0), p.S);
  const int bstart = max(p.base, plen);
  const int bend = min(p.last + 1, p.S);
  const int n = plen + max(bend - bstart, 0);
  int per = (n + p.nsplit - 1) / p.nsplit;
  per = (per + kTile - 1) / kTile * kTile;
  const int j0 = split * per;
  const int j1 = min(n, j0 + per);

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
      float val = 0.f;
      if (j < j1) {
        const int col = j < plen ? j : bstart + (j - plen);
        val = to_f32(kvb[(int64_t)col * (2 * D) + e]);
      }
      sKV[kk][e] = val;
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

// one block per (row, head), one thread per output lane
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* part_m, const float* part_l, const float* part_acc, T* out,
    int nsplit) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[bh * nsplit + s]);
  float l = 0.f, a = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float ms = part_m[bh * nsplit + s];
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - m);  // empty split
      l += w * part_l[bh * nsplit + s];
      a += w * part_acc[(bh * nsplit + s) * D + d];
    }
  }
  out[bh * D + d] = from_f32<T>(l > 0.f ? a / l : 0.f);
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, int B, void* out, cudaStream_t stream) {
  const dim3 grid(p.nsplit, p.Hkv, B);
  decode_split_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<B * p.H, D, 0, stream>>>(
      p.part_m, p.part_l, p.part_acc, static_cast<T*>(out), p.nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tn

extern "C" int tn_flash_decode(
    const void* q, const void* kv, const int* plen, void* out,
    float* part_m, float* part_l, float* part_acc,
    int B, int H, int Hkv, int S, int D, int dtype, int base, int last,
    int nsplit, float scale, void* stream) {
  tn::DecodeParams p;
  p.q = q; p.kv = kv; p.plen = plen;
  p.part_m = part_m; p.part_l = part_l; p.part_acc = part_acc;
  p.H = H; p.Hkv = Hkv; p.G = H / Hkv; p.S = S;
  p.base = base; p.last = last; p.nsplit = nsplit;
  p.scale_log2 = scale * tn::kLog2e;
  if (H % Hkv != 0 || p.G > tn::kMaxG || B <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tn::kBFloat16 && D == 64) return (int)tn::launch<__nv_bfloat16, 64>(p, B, out, st);
  if (dtype == tn::kBFloat16 && D == 128) return (int)tn::launch<__nv_bfloat16, 128>(p, B, out, st);
  if (dtype == tn::kFloat32 && D == 64) return (int)tn::launch<float, 64>(p, B, out, st);
  if (dtype == tn::kFloat32 && D == 128) return (int)tn::launch<float, 128>(p, B, out, st);
  return (int)cudaErrorInvalidValue;
}
