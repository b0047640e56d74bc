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
// Two variants, the same sums in the same order for every pair, so the
// same bits (ops/fused_core.py's variants):
//   "rowwise" (rerank_rows_kernel), the first kernel and the default: a
//       block takes one query and kCands of its candidates: the query row
//       sits in shared memory (loaded once a block), each warp walks its
//       candidates a row at a time, each lane loading four 16-byte vectors
//       of the row before it uses any. A base row that several queries
//       share is read again by each, far apart in time, so from HBM: every
//       candidate row (15.7 GB at the shape above, ~4.7 ms). Any dim
//       (single values where dim % 4 != 0 or the base is unaligned).
//   "grouped" (rerank_grouped_kernel and the passes before it), a named
//       variant for dim % 4 == 0 up to 2,048 and aligned rows, on the plan
//       of ops/fused_core.py:rerank_plan: the (query, slot) pairs grouped by
//       candidate id on the card by a counting sort (a histogram of the
//       ids, an exclusive scan, a scatter of the pair indices; ids outside
//       [0, B) in a group of their own), the queries' norms by a pre-pass
//       in the rowwise block's order; then a persistent grid whose warps
//       walk contiguous slices of the sorted pairs, loading a base row into
//       registers once per run of equal ids (streaming, L2 evict-first),
//       its norm once, and for each pair of the run the query row
//       (L2 evict-last: the queries stay in L2; the next pair's row
//       loaded while this pair's dot is taken) and the dot. Each value is
//       written to its pair's place: deterministic, whatever order the
//       scatter's atomics give within a group.
//
// In both, lane l takes the float4s c = l, l + 32, ... of a row in that
// order, fmaf for the dot (query x base) and the base norm, then a warp
// butterfly; the query norm is the rowwise block's reduction.
//
// What bounds "grouped", measured on the card (PERF.md): each pair
// still reads a row from outside the SM, its query's, so the L2 carries
// as many bytes as "rowwise" reads of candidate rows, plus the distinct
// rows from HBM and the sort. It wins where "rowwise" finds its rows in
// HBM and the queries stay in L2 (nw's re-rank, 4 MB of queries), and
// loses where the queries outgrow the L2 (knn(auto)'s 61 MB) or the
// candidate rows repeat close together so that "rowwise" finds them in
// L2 (the class-A repair's bin members); hence not the default.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "row_stream.cuh"  // the SM count and the occupancy query

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

// ---- "grouped"

constexpr int kScanItems = 16;                      // values a thread
constexpr int kScanChunk = kThreads * kScanItems;   // values a block

// the pair's group: its id, or B for an id outside [0, B)
__device__ __forceinline__ int group_of(const long long* __restrict__ ids,
                                        int p, long long B) {
  const long long id = ids[p];
  return (int)(id >= 0 && id < B ? id : B);
}

// The queries' squared norms, each in the rowwise block's order: thread i
// the values i, i + 256, ... by fmaf, a butterfly a warp, the eight warps
// in order.
__global__ void __launch_bounds__(kThreads)
query_norms(const float* __restrict__ query, float* __restrict__ qn, int Q,
            int dim) {
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < Q; t += gridDim.x) {
    const float* q = query + (long long)t * dim;
    float qq = 0.0f;
    __syncthreads();                       // the previous row's readers
    for (int c = threadIdx.x; c < dim; c += kThreads) {
      const float v = q[c];
      qq = fmaf(v, v, qq);
    }
    qq = warp_sum(qq);
    if (lane == 0) part[warp] = qq;
    __syncthreads();
    if (threadIdx.x == 0) {
      qq = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) qq += part[w];
      qn[t] = qq;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
group_count(const long long* __restrict__ ids, int* __restrict__ offs, int P,
            long long B) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < P;
       p += gridDim.x * kThreads)
    atomicAdd(offs + group_of(ids, p, B), 1);
}

// the exclusive prefix of x over the block's threads in order, and the
// block's total
__device__ __forceinline__ int block_scan(int x, int& total) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_total[w];
    total += warp_total[w];
  }
  __syncthreads();                         // warp_total read by all
  return before + inc - x;
}

// thread i holds the values first .. first + kScanItems - 1 of a, 0 past n
__device__ __forceinline__ int load_items(const int* a, int n, int first,
                                          int (&v)[kScanItems]) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = first + j < n ? a[first + j] : 0;
    s += v[j];
  }
  return s;
}

// block k: the total of the counts k kScanChunk .. (k + 1) kScanChunk - 1
__global__ void __launch_bounds__(kThreads)
scan_partials(const int* __restrict__ offs, int* __restrict__ part,
              int groups) {
  int v[kScanItems], total;
  block_scan(load_items(offs, groups, blockIdx.x * kScanChunk +
                                          threadIdx.x * kScanItems, v),
             total);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// one block: the blocks' totals into their exclusive prefix, in place
__global__ void __launch_bounds__(kThreads)
scan_top(int* part, int n) {
  int carry = 0;
  for (int k = 0; k < n; k += kScanChunk) {
    int v[kScanItems], total;
    const int first = k + threadIdx.x * kScanItems;
    int run = block_scan(load_items(part, n, first, v), total) + carry;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (first + j < n) part[first + j] = run;
      run += v[j];
    }
    carry += total;
  }
}

// the counts into each group's first place in the sorted order, in place
__global__ void __launch_bounds__(kThreads)
scan_apply(int* offs, const int* __restrict__ part, int groups) {
  int v[kScanItems], total;
  const int first = blockIdx.x * kScanChunk + threadIdx.x * kScanItems;
  int run = block_scan(load_items(offs, groups, first, v), total) +
            part[blockIdx.x];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < groups) offs[first + j] = run;
    run += v[j];
  }
}

// each pair to its group's next place (offs[g] ends as the group's end)
__global__ void __launch_bounds__(kThreads)
group_scatter(const long long* __restrict__ ids, int* __restrict__ offs,
              int* __restrict__ keys, int* __restrict__ vals, int P,
              long long B) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < P;
       p += gridDim.x * kThreads) {
    const int g = group_of(ids, p, B);
    const int at = atomicAdd(offs + g, 1);
    keys[at] = g;
    vals[at] = p;
  }
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// a query vector, kept in L2 before the streamed base lines
__device__ __forceinline__ float4 load_kept(const float4* p, uint64_t pol) {
  float4 v;
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

// row t's float4s of this lane (c = lane, lane + 32, ...; 0 past dim / 4)
template <int kF4>
__device__ __forceinline__ void load_query(const float* __restrict__ query,
                                           long long t, int dim, int lane,
                                           uint64_t pol, float4 (&a)[kF4]) {
  const float4* q4 = reinterpret_cast<const float4*>(query + t * dim);
#pragma unroll
  for (int u = 0; u < kF4; ++u) {
    const int c4 = lane + 32 * u;
    a[u] = c4 < dim / 4 ? load_kept(q4 + c4, pol)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Warp w of the W in the grid walks the w-th of W slices of the sorted
// pairs, 32 at a time (a lane loads one pair's group, index and query
// norm); kF4 float4s a lane hold a base row (dim <= 128 kF4), and the next
// pair's query row is loaded while this pair's dot is taken.
template <int kMetric, int kF4>
__global__ void __launch_bounds__(kThreads)
rerank_grouped_kernel(const float* __restrict__ query,
                      const float* __restrict__ base,
                      const int* __restrict__ keys,
                      const int* __restrict__ vals,
                      const float* __restrict__ qn, float* __restrict__ out,
                      int P, int M, int dim, long long B) {
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps;
  const int per = (P + W - 1) / W;
  const int s0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * per;
  const int s1 = min(s0 + per, P);
  const int n4 = dim >> 2;
  const uint64_t pol = evict_last_policy();
  int cur = -1;                            // the group in bv
  float cc = 0.0f;
  float4 bv[kF4], a[kF4];
  for (int s = s0; s < s1; s += 32) {
    const bool mine = s + lane < s1;
    const int key_l = mine ? keys[s + lane] : -1;
    const int pair_l = mine ? vals[s + lane] : 0;
    const float qn_l = mine ? qn[pair_l / M] : 0.0f;
    const int count = min(32, s1 - s);
    load_query<kF4>(query, __shfl_sync(kFullMask, pair_l, 0) / M, dim, lane,
                    pol, a);
    for (int i = 0; i < count; ++i) {
      const int key = __shfl_sync(kFullMask, key_l, i);
      const int pair = __shfl_sync(kFullMask, pair_l, i);
      const float qq = __shfl_sync(kFullMask, qn_l, i);
      const int next = __shfl_sync(kFullMask, pair_l, (i + 1) & 31);
      float4 an[kF4];
      if (i + 1 < count) load_query<kF4>(query, next / M, dim, lane, pol, an);
      if (key != cur) {                    // a new run: its base row once
        cur = key;
        if (key < B) {
          const float4* row4 =
              reinterpret_cast<const float4*>(base + (long long)key * dim);
          cc = 0.0f;
#pragma unroll
          for (int u = 0; u < kF4; ++u) {
            const int c4 = lane + 32 * u;
            bv[u] = c4 < n4 ? __ldcs(row4 + c4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kF4; ++u) {
            if (lane + 32 * u < n4) {
              cc = fmaf(bv[u].x, bv[u].x, cc);
              cc = fmaf(bv[u].y, bv[u].y, cc);
              cc = fmaf(bv[u].z, bv[u].z, cc);
              cc = fmaf(bv[u].w, bv[u].w, cc);
            }
          }
          cc = warp_sum(cc);
        }
      }
      float dot = 0.0f;
#pragma unroll
      for (int u = 0; u < kF4; ++u) {
        if (lane + 32 * u < n4) {
          dot = fmaf(a[u].x, bv[u].x, dot);
          dot = fmaf(a[u].y, bv[u].y, dot);
          dot = fmaf(a[u].z, bv[u].z, dot);
          dot = fmaf(a[u].w, bv[u].w, dot);
        }
      }
      dot = warp_sum(dot);
      if (lane == 0) out[pair] = key < B ? distance<kMetric>(dot, qq, cc) : NAN;
#pragma unroll
      for (int u = 0; u < kF4; ++u) a[u] = an[u];
    }
  }
}

int round4(long long n) { return (int)((n + 3) / 4 * 4); }

// The workspace of the grouped variant, in 4-byte words, each part
// 16-byte aligned: the groups' counts, then places (B + 1), the scan
// blocks' totals, the sorted groups and pair indices (P each), the query
// norms (Q). ops/fused_core.py:rerank_workspace computes the same.
struct Workspace {
  int *offs, *part, *keys, *vals;
  float* qn;
  long long groups, blocks, words;
};

Workspace workspace(void* ws, int Q, int M, long long B) {
  Workspace w;
  w.groups = B + 1;
  w.blocks = (w.groups + kScanChunk - 1) / kScanChunk;
  const long long P = (long long)Q * M;
  w.offs = (int*)ws;
  w.part = w.offs + round4(w.groups);
  w.keys = w.part + round4(w.blocks);
  w.vals = w.keys + round4(P);
  w.qn = (float*)(w.vals + round4(P));
  w.words = round4(w.groups) + round4(w.blocks) + 2LL * round4(P) + round4(Q);
  return w;
}

// the counting sort of the pairs by group into w.keys / w.vals
cudaError_t group_pairs(const long long* ids, const Workspace& w, int P,
                        long long B, int sms, cudaStream_t st) {
  cudaError_t err =
      cudaMemsetAsync(w.offs, 0, (size_t)w.groups * sizeof(int), st);
  if (err != cudaSuccess) return err;
  const int grid = (int)std::min<long long>((P + kThreads - 1) / kThreads,
                                            8LL * sms);
  group_count<<<grid, kThreads, 0, st>>>(ids, w.offs, P, B);
  scan_partials<<<(unsigned)w.blocks, kThreads, 0, st>>>(w.offs, w.part,
                                                         (int)w.groups);
  scan_top<<<1, kThreads, 0, st>>>(w.part, (int)w.blocks);
  scan_apply<<<(unsigned)w.blocks, kThreads, 0, st>>>(w.offs, w.part,
                                                      (int)w.groups);
  group_scatter<<<grid, kThreads, 0, st>>>(ids, w.offs, w.keys, w.vals, P,
                                           B);
  return cudaGetLastError();
}

template <int kMetric, int kF4>
cudaError_t walk(const float* query, const float* base, const Workspace& w,
                 float* out, int P, int M, int dim, long long B, int sms,
                 cudaStream_t st) {
  auto kernel = rerank_grouped_kernel<kMetric, kF4>;
  int held = 0;
  cudaError_t err =
      rowstream::resident_blocks((const void*)kernel, kThreads, 0, &held);
  if (err != cudaSuccess) return err;
  if (held < 1) return cudaErrorInvalidConfiguration;
  kernel<<<sms * held, kThreads, 0, st>>>(query, base, w.keys, w.vals, w.qn,
                                          out, P, M, dim, B);
  return cudaGetLastError();
}

template <int kMetric>
cudaError_t walk_dim(const float* query, const float* base,
                     const Workspace& w, float* out, int P, int M, int dim,
                     long long B, int sms, cudaStream_t st) {
  const int per_lane = (dim / 4 + 31) / 32;     // float4s a lane
  if (per_lane <= 4)
    return walk<kMetric, 4>(query, base, w, out, P, M, dim, B, sms, st);
  if (per_lane <= 8)
    return walk<kMetric, 8>(query, base, w, out, P, M, dim, B, sms, st);
  if (per_lane <= 12)
    return walk<kMetric, 12>(query, base, w, out, P, M, dim, B, sms, st);
  return walk<kMetric, 16>(query, base, w, out, P, M, dim, B, sms, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the grouped variant's arguments against its plan: fewer than 2^30 pairs
// and groups, the workspace the layout's size and aligned
bool grouped_args(int Q, int M, long long B, const void* ws,
                  long long ws_bytes) {
  if (Q < 0 || M < 0 || B < 0 || (long long)Q * M >= (1LL << 30) ||
      B >= (1LL << 30) || !aligned16(ws))
    return false;
  return workspace(nullptr, Q, M, B).words * 4 == ws_bytes;
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

// The "grouped" variant on the plan of ops/fused_core.py:rerank_plan:
// `workspace` (ws_bytes, as rerank_workspace computes it; a mismatch is
// refused) for the sort and the query norms. dim % 4 == 0, dim <= 2048,
// query and base 16-byte aligned. Arguments otherwise as
// rerank_rows_launch's; the same bits.
extern "C" int rerank_rows_grouped_launch(const void* query, const void* base,
                                          const void* ids, void* out, int Q,
                                          int M, int dim, long long B,
                                          int metric, void* ws,
                                          long long ws_bytes, void* stream) {
  if (dim < 4 || dim > 2048 || dim % 4 != 0 || metric < 0 || metric > 3 ||
      !aligned16(query) || !aligned16(base) ||
      !grouped_args(Q, M, B, ws, ws_bytes))
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || M == 0) return 0;
  int sms = 0;
  cudaError_t err = rowstream::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Workspace w = workspace(ws, Q, M, B);
  const int P = Q * M;
  cudaStream_t st = (cudaStream_t)stream;
  const float* q = (const float*)query;
  const float* b = (const float*)base;
  query_norms<<<std::min(Q, 4 * sms), kThreads, 0, st>>>(q, w.qn, Q, dim);
  err = group_pairs((const long long*)ids, w, P, B, sms, st);
  if (err != cudaSuccess) return (int)err;
  float* o = (float*)out;
  switch (metric) {
    case kSquared:
      return (int)walk_dim<kSquared>(q, b, w, o, P, M, dim, B, sms, st);
    case kEuclidean:
      return (int)walk_dim<kEuclidean>(q, b, w, o, P, M, dim, B, sms, st);
    case kCosine:
      return (int)walk_dim<kCosine>(q, b, w, o, P, M, dim, B, sms, st);
    default:
      return (int)walk_dim<kDot>(q, b, w, o, P, M, dim, B, sms, st);
  }
}

// The grouped variant's counting sort alone, into the workspace (for the
// card tests: the sorted groups and pair indices at their word offsets,
// rerank_workspace's layout). Arguments as rerank_rows_grouped_launch's.
extern "C" int rerank_rows_group_launch(const void* ids, int Q, int M,
                                        long long B, void* ws,
                                        long long ws_bytes, void* stream) {
  if (!grouped_args(Q, M, B, ws, ws_bytes)) return (int)cudaErrorInvalidValue;
  if (Q == 0 || M == 0) return 0;
  int sms = 0;
  const cudaError_t err = rowstream::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return (int)group_pairs((const long long*)ids, workspace(ws, Q, M, B),
                          Q * M, B, sms, (cudaStream_t)stream);
}
