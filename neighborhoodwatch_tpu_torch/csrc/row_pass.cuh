// Row passes for the encoders' fused kernels (E1 embed_layernorm.cu, E2
// add_layernorm.cu, E3 masked_softmax.cu): a row of up to a few thousand
// values held in the registers of kLanes threads (a part of a warp for
// short rows, a warp, or a group of warps for wide ones), read once,
// reduced by shuffles, written once.
//
// Layout of a row of n values over kLanes lanes (a power of two), kPer
// values a lane. Vector rows (n % 8 == 0, 16-byte aligned): lane l holds
// the 8-value chunks l, l + kLanes, l + 2 kLanes, ..., each one 16-byte
// load for bf16/fp16 (two for fp32). Scalar rows: lane l holds the values
// l, l + kLanes, .... A slot past the row's end holds `fill` and is left
// out of every sum. Rows of fewer than 32 lanes share a warp, whose
// shuffles every lane joins: a kernel keeps a row past the last one in
// the reductions (with no values) and skips its loads and stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowpass {

constexpr int kThreads = 256;          // a block: eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;              // values a vector chunk
constexpr unsigned kFullMask = 0xffffffffu;

// the activation dtypes, as the wrappers code them
enum DType { kBF16 = 0, kF32 = 1, kF16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

// round to nearest even, as torch's casts on the card
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and widened again
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = to_f<T>(e[i]);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// the row index of slot i of lane `lane` (0 .. kLanes - 1)
template <int kLanes, bool kVec>
__device__ __forceinline__ int slot(int lane, int i) {
  return kVec ? (lane + kLanes * (i / kChunk)) * kChunk + i % kChunk
              : lane + kLanes * i;
}

// a row of n values of T into v[kPer], `fill` past its end
template <typename T, int kLanes, int kPer, bool kVec>
__device__ __forceinline__ void load_row(const T* row, int n, int lane,
                                         float (&v)[kPer], float fill) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < kPer / kChunk; ++c) {
      const int e = (lane + kLanes * c) * kChunk;
      if (e < n) {
        load8<T>(row + e, v + c * kChunk);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[c * kChunk + i] = fill;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + kLanes * i;
      v[i] = e < n ? to_f<T>(row[e]) : fill;
    }
  }
}

// v[kPer] into a row of n values of T
template <typename T, int kLanes, int kPer, bool kVec>
__device__ __forceinline__ void store_row(T* row, int n, int lane,
                                          const float (&v)[kPer]) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < kPer / kChunk; ++c) {
      const int e = (lane + kLanes * c) * kChunk;
      if (e < n) store8<T>(row + e, v + c * kChunk);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + kLanes * i;
      if (e < n) row[e] = from_f<T>(v[i]);
    }
  }
}

// the butterfly over aligned groups of kWidth lanes (<= 32) of a warp
template <int kWidth>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <int kWidth>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// the sum over a row's kLanes lanes (every warp of the block calls it the
// same number of times; `red` holds kWarps floats). The same order on
// every call: each warp's butterfly, then the row's warps in order.
template <int kLanes>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = lanes_sum<(kLanes < 32 ? kLanes : 32)>(v);
  if constexpr (kLanes <= 32) {
    return v;
  } else {
    constexpr int G = kLanes / 32;
    const int warp = threadIdx.x >> 5;
    __syncthreads();                     // the previous call's readers
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / G * G;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < G; ++w) s += red[first + w];
    return s;
  }
}

// the maximum over a row's kLanes lanes, as group_sum
template <int kLanes>
__device__ __forceinline__ float group_max(float v, float* red) {
  v = lanes_max<(kLanes < 32 ? kLanes : 32)>(v);
  if constexpr (kLanes <= 32) {
    return v;
  } else {
    constexpr int G = kLanes / 32;
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / G * G;
    float m = red[first];
#pragma unroll
    for (int w = 1; w < G; ++w) m = fmaxf(m, red[first + w]);
    return m;
  }
}

// LayerNorm of the row in v (n valid slots) in fp32: two passes over the
// registers (mean, then the mean square deviation), then
// (x - mean) * rsqrt(var + eps) * w + b, w and b read as the row is
// written. Returns through v.
template <int kLanes, int kPer, bool kVec>
__device__ __forceinline__ void layer_norm(float (&v)[kPer], int n, int lane,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           float eps, float* red) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (slot<kLanes, kVec>(lane, i) < n) s += v[i];
  const float mean = __fdiv_rn(group_sum<kLanes>(s, red), (float)n);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (slot<kLanes, kVec>(lane, i) < n) {
      const float d = v[i] - mean;
      q = fmaf(d, d, q);
    }
  }
  const float var = __fdiv_rn(group_sum<kLanes>(q, red), (float)n);
  const float rstd = rsqrtf(var + eps);
  float wv[kPer], bv[kPer];
  load_row<float, kLanes, kPer, kVec>(w, n, lane, wv, 0.0f);
  load_row<float, kLanes, kPer, kVec>(b, n, lane, bv, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    v[i] = fmaf((v[i] - mean) * rstd, wv[i], bv[i]);
}

}  // namespace rowpass
