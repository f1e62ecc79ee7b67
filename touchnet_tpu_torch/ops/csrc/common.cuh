// Copyright (c) 2026 touchnet_tpu authors.
// Helpers shared by the kernels of touchnet_tpu_torch: the dtype codes,
// conversions and the tensor-core helpers, each for bf16 and f16 (one
// kernel body per element type).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace tn {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes the Python wrappers pass
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The first and last index in [begin, end) whose segment id lies in
// [lo, hi]: (INT_MAX, -1) when there is none. `seg` is the row's ids, or
// nullptr for one segment (id 1). The whole block calls it: one strided,
// coalesced pass of independent 16-byte loads, so a block of a late
// document finds its first live tile without walking the dead ones before
// it. `span` is two ints of shared memory.
__device__ __forceinline__ void live_span(const int* seg, int begin, int end, int lo, int hi,
                                          int* span, int& first, int& last) {
  if (threadIdx.x == 0) {
    span[0] = INT_MAX;
    span[1] = -1;
  }
  __syncthreads();
  int f = INT_MAX, l = -1;
  if (seg == nullptr) {
    if (threadIdx.x == 0 && begin < end && lo <= 1 && 1 <= hi) {
      f = begin;
      l = end - 1;
    }
  } else {
    auto see = [&](int s, int i) {
      if (s >= lo && s <= hi) {
        f = min(f, i);
        l = max(l, i);
      }
    };
    // the ids before the first 16-byte boundary and after the last one one
    // at a time (at most 3 each), the others 4 to a load
    const int mis = (int)((reinterpret_cast<uintptr_t>(seg + begin) >> 2) & 3);
    const int head = min(end - begin, (4 - mis) & 3);
    const int vb = begin + head, nv = max(0, end - vb) / 4, ve = vb + 4 * nv;
    if ((int)threadIdx.x < head) see(seg[begin + threadIdx.x], begin + threadIdx.x);
    if ((int)threadIdx.x < end - ve) see(seg[ve + threadIdx.x], ve + threadIdx.x);
    const int4* v = reinterpret_cast<const int4*>(seg + vb);
#pragma unroll 4
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      const int4 x = v[j];
      see(x.x, vb + 4 * j);
      see(x.y, vb + 4 * j + 1);
      see(x.z, vb + 4 * j + 2);
      see(x.w, vb + 4 * j + 3);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    f = min(f, __shfl_xor_sync(0xffffffffu, f, off));
    l = max(l, __shfl_xor_sync(0xffffffffu, l, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&span[0], f);
    atomicMax(&span[1], l);
  }
  __syncthreads();
  first = span[0];
  last = span[1];
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ instructions, used on sm_90a): the
// warp-wide mma.sync m16n8k16 on bf16 or f16 with f32 accumulation,
// ldmatrix from shared memory, and cp.async copies from global to shared
// memory. ldmatrix and cp.async move 16-bit lanes and bytes whatever the
// type; mma_16816<T> and pack2<T> pick the instruction and the rounding.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g in [0, 8), t in [0, 4)):
//   A 16x16 row-major, 4 registers of 16-bit pairs: a0 (row g, cols 2t..2t+1),
//     a1 (row g+8, same cols), a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B 16x8 "col" (k contiguous per n), 2 registers: b0 (k 2t..2t+1, n g),
//     b1 (k 2t+8.., n g)
//   C/D 16x8 f32, 4 registers: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// So the C fragments of two neighbouring n-tiles are, once packed to the
// element type, the A fragment of one 16-deep k-step: no shuffle, no shared
// memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b (bf16 or f16 operands, f32 accumulators)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 matrices of 16-bit elements; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (through L1); zero-filled when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one MUFU instruction (ex2.approx.ftz: ~2^-22 relative error,
// results below 2^-126 flush to 0); for the bf16 kernels, whose P is
// rounded to bf16 or f16 anyway
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to nearest into one register of the element type
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tn
