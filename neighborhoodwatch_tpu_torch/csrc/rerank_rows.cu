// F3: the screened engine's exact re-rank, gather and fp32 distances in one
// pass over each query's candidate rows, for Hopper (sm_90a).
//
// Replaces neighborhoodwatch_tpu/ops/knn.py:379 _exact_pair_dists as XLA
// compiles it under _screened_select's jax.jit (:404): the gather of the
// candidate rows fused into a HIGHEST-precision fp32 product (not a Pallas
// kernel). The plain PyTorch version (ops/fused_core.py:rerank_plain)
// gathers base[ids] into a (rows, M, dim) fp32 buffer, block by block, and
// multiplies it with torch.bmm; this kernel never materializes the gather.
//
// What it computes, for query row t and its candidate ids[t, 0..M):
//   dots = <q_t, base[id]>, qn = <q_t, q_t>, cn = <base[id], base[id]>,
//   all fp32 with fp32 accumulation on the CUDA cores (no TF32, no bf16),
//   sqeuclidean: max((qn + cn) - 2 dots, 0), NaN kept; euclidean: its sqrt;
//   cosine: 1 - dots / max(sqrt(qn) sqrt(cn), 1e-30); dot: 1 - dots.
// The sums are taken in another order than torch.bmm's, so the distances
// agree with the plain version within the engines' fp32 tolerance, not bit
// for bit. A NaN row gives NaN, as in the plain version (the select drops
// it). An id outside [0, B) gives NaN (the plain version cannot index it).
//
// Bound on this card: bytes. Every distinct candidate row read once, the
// queries, ids and distances: at knn(auto)'s 10,000 x 256 x 1536 over 1M
// random rows, 922,868 distinct rows, 5.7 GB, ~1.7 ms at 3.35 TB/s.
//
// The kernel (rerank_rows_kernel, ops/fused_core.py's "rowwise"): a block
// takes one query and kCands of its candidates: the query row sits in
// shared memory (loaded once a block), each warp walks its candidates a
// row at a time, each lane loading four 16-byte vectors of the row before
// it uses any; lane l takes the float4s c = l, l + 32, ... of a row in
// that order, fmaf for the dot (query x base) and the base norm, then a
// warp butterfly; the query norm is the block's reduction. A base row that
// several queries share is read again by each, far apart in time, so from
// HBM: every candidate row (15.7 GB at the shape above, ~4.7 ms). Any dim
// (single values where dim % 4 != 0 or the base is unaligned).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCands = 64;            // candidates a block
constexpr int kUnroll = 4;
constexpr int kMaxGridY = 65535;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFullMask = 0xffffffffu;

enum Metric { kSquared = 0, kEuclidean = 1, kCosine = 2, kDot = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <int kMetric>
__device__ __forceinline__ float distance(float dot, float qn, float cn) {
  if (kMetric == kDot) return 1.0f - dot;
  if (kMetric == kCosine) {
    float denom = sqrtf(qn) * sqrtf(cn);
    denom = denom < 1e-30f ? 1e-30f : denom;   // clamp_min: NaN stays
    return 1.0f - dot / denom;
  }
  float d = (qn + cn) - 2.0f * dot;
  d = d < 0.0f ? 0.0f : d;
  return kMetric == kEuclidean ? sqrtf(d) : d;
}

template <int kMetric, bool kVec>
__global__ void __launch_bounds__(kThreads)
rerank_rows_kernel(const float* __restrict__ query,
                   const float* __restrict__ base,
                   const long long* __restrict__ ids, float* __restrict__ out,
                   int Q, int M, int dim, long long B) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kCands;
  const int j1 = min(j0 + kCands, M);
  for (int t = blockIdx.y; t < Q; t += gridDim.y) {
    // the query row into shared memory, and its squared norm
    const float* q = query + (long long)t * dim;
    float qq = 0.0f;
    __syncthreads();                       // the previous row's readers
    for (int c = threadIdx.x; c < dim; c += kThreads) {
      const float v = q[c];
      qs[c] = v;
      qq = fmaf(v, v, qq);
    }
    qq = warp_sum(qq);
    if (lane == 0) part[warp] = qq;
    __syncthreads();
    qq = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) qq += part[w];

    for (int j = j0 + warp; j < j1; j += kWarps) {
      const long long id = ids[(long long)t * M + j];
      float* dst = out + (long long)t * M + j;
      if (id < 0 || id >= B) {             // uniform across the warp
        if (lane == 0) *dst = NAN;
        continue;
      }
      const float* row = base + id * dim;
      float dot = 0.0f, cc = 0.0f;
      if (kVec) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const int n4 = dim >> 2;
        for (int c0 = lane; c0 < n4; c0 += 32 * kUnroll) {
          float4 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + 32 * u;
            v[u] = c < n4 ? __ldg(row4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + 32 * u;
            if (c < n4) {
              const float4 a = smem4[c];
              dot = fmaf(a.x, v[u].x, dot);
              dot = fmaf(a.y, v[u].y, dot);
              dot = fmaf(a.z, v[u].z, dot);
              dot = fmaf(a.w, v[u].w, dot);
              cc = fmaf(v[u].x, v[u].x, cc);
              cc = fmaf(v[u].y, v[u].y, cc);
              cc = fmaf(v[u].z, v[u].z, cc);
              cc = fmaf(v[u].w, v[u].w, cc);
            }
          }
        }
      } else {
        for (int c = lane; c < dim; c += 32) {
          const float v = __ldg(row + c);
          dot = fmaf(qs[c], v, dot);
          cc = fmaf(v, v, cc);
        }
      }
      dot = warp_sum(dot);
      cc = warp_sum(cc);
      if (lane == 0) *dst = distance<kMetric>(dot, qq, cc);
    }
  }
}

template <int kMetric>
cudaError_t launch(const float* query, const float* base, const long long* ids,
                   float* out, int Q, int M, int dim, long long B, bool vec,
                   cudaStream_t st) {
  const size_t smem = (size_t)dim * sizeof(float);
  const dim3 grid((M + kCands - 1) / kCands, Q < kMaxGridY ? Q : kMaxGridY);
  if (vec) {
    auto kernel = rerank_rows_kernel<kMetric, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(query, base, ids, out, Q, M, dim, B);
  } else {
    auto kernel = rerank_rows_kernel<kMetric, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(query, base, ids, out, Q, M, dim, B);
  }
  return cudaGetLastError();
}

}  // namespace

// query: (Q, dim) fp32; base: (B, dim) fp32; ids: (Q, M) int64 rows of
// base; out: (Q, M) fp32. metric: 0 sqeuclidean, 1 euclidean, 2 cosine,
// 3 dot. `vec`: dim % 4 == 0 and base 16-byte aligned. Returns a CUDA
// error code, 0 on success.
extern "C" int rerank_rows_launch(const void* query, const void* base,
                                  const void* ids, void* out, int Q, int M,
                                  int dim, long long B, int metric, int vec,
                                  void* stream) {
  if (Q < 0 || M < 0 || dim < 1 || B < 0 || metric < 0 || metric > 3 ||
      (vec && dim % 4 != 0) || (size_t)dim * sizeof(float) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || M == 0) return 0;
  const float* q = (const float*)query;
  const float* b = (const float*)base;
  const long long* i = (const long long*)ids;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (metric) {
    case kSquared:
      return (int)launch<kSquared>(q, b, i, o, Q, M, dim, B, vec, st);
    case kEuclidean:
      return (int)launch<kEuclidean>(q, b, i, o, Q, M, dim, B, vec, st);
    case kCosine:
      return (int)launch<kCosine>(q, b, i, o, Q, M, dim, B, vec, st);
    default:
      return (int)launch<kDot>(q, b, i, o, Q, M, dim, B, vec, st);
  }
}
