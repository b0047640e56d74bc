// F2: the exact engines' distance epilogue and validity mask in one pass
// over a (Q, T) tile of products, for Hopper (sm_90a).
//
// Replaces the output fusion XLA makes of pairwise_distance and the
// validity mask inside the jitted scan step of
// neighborhoodwatch_tpu/ops/knn.py:112 _knn_scan (:137-146) and in
// _knn_full (:154-163) (not a Pallas kernel). The product itself stays a
// library call (ops/distance.py:products), as the JAX package leaves it to
// XLA. The plain PyTorch version (ops/fused_core.py:distance_tile_plain)
// runs the same function op by op, about six elementwise kernels.
//
// What it computes, per entry (i, j) of the fp32 products `dots`:
//   sqeuclidean: d = max((qn[i] + bn[j]) - 2 * dots, 0), NaN kept;
//   euclidean:   sqrt of that;
//   cosine, dot: d = 1 - dots (cosine's operands come normalized);
//   d = +inf where it is not finite, and where column j lies outside
//   [lo, hi) (the columns an earlier tile covered, the rows past n_valid).
// Every operation is the plain version's, in its order and rounded as it
// rounds (__fadd_rn and friends: no contraction into fma), so for the same
// norms the output equals the plain version's bit for bit.
//
// Bound on this card: bytes. One read of the products and one write of the
// distances (Q*T*4 each: 65.5 MB at 1,000 x 8,192, ~20 us at 3.35 TB/s);
// the norms are a few KB. A thread takes 16 bytes where the rows allow it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

enum Metric { kSquared = 0, kEuclidean = 1, kOneMinus = 2 };

template <int kMetric>
__device__ __forceinline__ float epilogue(float dot, float qn, float bn) {
  float d;
  if (kMetric == kOneMinus) {
    d = __fsub_rn(1.0f, dot);
  } else {
    d = __fsub_rn(__fadd_rn(qn, bn), __fmul_rn(2.0f, dot));
    d = d < 0.0f ? 0.0f : d;               // clamp_min(., 0): NaN stays
    if (kMetric == kEuclidean) d = __fsqrt_rn(d);
  }
  return isfinite(d) ? d : INFINITY;
}

template <int kMetric, bool kVec>
__global__ void __launch_bounds__(kThreads)
distance_tile_kernel(const float* __restrict__ dots,
                     const float* __restrict__ qn,
                     const float* __restrict__ bn, float* __restrict__ out,
                     int Q, int T, int lo, int hi) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  for (int i = blockIdx.y; i < Q; i += gridDim.y) {
    const float q = kMetric == kOneMinus ? 0.0f : __ldg(qn + i);
    const long long rowoff = (long long)i * T;
    if (kVec) {
      const int j = 4 * c;
      if (j >= T) return;
      const float4 p = __ldcs(reinterpret_cast<const float4*>(dots + rowoff + j));
      float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (kMetric != kOneMinus) {
#pragma unroll
        for (int u = 0; u < 4; ++u) b[u] = __ldg(bn + j + u);
      }
      float4 d;
      d.x = epilogue<kMetric>(p.x, q, b[0]);
      d.y = epilogue<kMetric>(p.y, q, b[1]);
      d.z = epilogue<kMetric>(p.z, q, b[2]);
      d.w = epilogue<kMetric>(p.w, q, b[3]);
      if (j < lo || j >= hi) d.x = INFINITY;
      if (j + 1 < lo || j + 1 >= hi) d.y = INFINITY;
      if (j + 2 < lo || j + 2 >= hi) d.z = INFINITY;
      if (j + 3 < lo || j + 3 >= hi) d.w = INFINITY;
      __stcs(reinterpret_cast<float4*>(out + rowoff + j), d);
    } else {
      if (c >= T) return;
      const float b = kMetric == kOneMinus ? 0.0f : __ldg(bn + c);
      float d = epilogue<kMetric>(__ldcs(dots + rowoff + c), q, b);
      if (c < lo || c >= hi) d = INFINITY;
      __stcs(out + rowoff + c, d);
    }
  }
}

template <int kMetric>
cudaError_t launch(const float* dots, const float* qn, const float* bn,
                   float* out, int Q, int T, int lo, int hi, bool vec,
                   cudaStream_t st) {
  const int per_row = vec ? T / 4 : T;
  const dim3 grid((per_row + kThreads - 1) / kThreads,
                  Q < kMaxGridY ? Q : kMaxGridY);
  if (vec)
    distance_tile_kernel<kMetric, true><<<grid, kThreads, 0, st>>>(
        dots, qn, bn, out, Q, T, lo, hi);
  else
    distance_tile_kernel<kMetric, false><<<grid, kThreads, 0, st>>>(
        dots, qn, bn, out, Q, T, lo, hi);
  return cudaGetLastError();
}

}  // namespace

// dots, out: (Q, T) fp32, apart; qn (Q,) and bn (T,) fp32
// squared norms, read for metric 0 (sqeuclidean) and 1 (euclidean) only;
// metric 2 is 1 - dots (cosine, dot). Columns outside [lo, hi) become +inf.
// `vec`: T % 4 == 0 and dots, out 16-byte aligned. Returns a CUDA error
// code, 0 on success.
extern "C" int distance_tile_launch(const void* dots, const void* qn,
                                    const void* bn, void* out, int Q, int T,
                                    int lo, int hi, int metric, int vec,
                                    void* stream) {
  if (Q < 0 || T < 0 || metric < 0 || metric > 2 || (vec && T % 4 != 0) ||
      (metric != kOneMinus && (qn == nullptr || bn == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || T == 0) return 0;
  const float* d = (const float*)dots;
  const float* q = (const float*)qn;
  const float* b = (const float*)bn;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (metric) {
    case kSquared:
      return (int)launch<kSquared>(d, q, b, o, Q, T, lo, hi, vec, st);
    case kEuclidean:
      return (int)launch<kEuclidean>(d, q, b, o, Q, T, lo, hi, vec, st);
    default:
      return (int)launch<kOneMinus>(d, q, b, o, Q, T, lo, hi, vec, st);
  }
}
