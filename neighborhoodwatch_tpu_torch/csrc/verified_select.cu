// Exact per-row k smallest with a count proof, for Hopper (sm_90a): the
// select of the exact-kNN "verified" engine.
//
// Replaces neighborhoodwatch_tpu/ops/knn.py:59 _verified_smallest_k, whose
// candidate stage is lax.approx_min_k (XLA's PartialReduce on the TPU, not a
// Pallas kernel), followed there by a small top_k, a count proof and a
// whole-tile lax.cond fallback to the exact top_k.
//
// What it computes, per row r of a (Q, N) fp32 distance tile d (non-finite
// values already +inf; padding and overlap columns +inf):
//   margin = min(N, max(k + 28, 5k / 4))  (the wrapper passes it);
//   1. candidates: the margin smallest entries of the row by (value,
//      position), found exactly: a radix select of the margin-th ordered
//      key (four 8-bit digits), then an in-order compaction that keeps every
//      entry below that key and the lowest positions among the entries equal
//      to it. An exact top-margin is a valid output of approx_min_k;
//   2. the k best candidates: a bitonic sort of (key << 32 | position);
//   3. the proof: with tau the k-th selected value, the row must hold as
//      many values below tau as the selection does;
//   4. a row that fails the proof is selected again, exactly, with the
//      lowest positions among ties (JAX's whole-tile cond becomes per row, so
//      there is no host sync), and the failed-row counter is incremented.
// Out: dist[r, 0..k) ascending (the row's own values, bit for bit),
// pos[r, 0..k) int64 column positions, ok[r] the proof's verdict (1 byte),
// failed += rows that failed. Among entries of equal value the lower
// position comes first, so the result equals a stable sort's first k: the
// exact engine's own selection.
//
// The `exclude` argument (a column, or -1) drops one column from the
// candidate stage only, so a test can plant a candidate set that misses a
// true neighbour and watch the proof fail and the fallback run.
//
// Ordered keys: the fp32 bits with the sign folded (negatives inverted,
// positives with the top bit set) order like the values; -0.0 takes +0.0's
// key and every NaN the largest key, so keys and value comparisons agree.
//
// Bound on this card: one read of d (Q*N*4 bytes: 32.8 MB at 1,000 x 8,192,
// ~10 us at 3.35 TB/s) and a write of Q*k*12 bytes; the operations are a few
// integer ops per element and pass. One block of 512 threads owns a row.
// Where the row's keys fit in shared memory beside the candidates (N up to
// ~40,000 columns) they are read from device memory once and every pass
// runs on shared memory; a wider row is read again from device memory (L2)
// on each of its six passes. Histogram atomics are aggregated per warp over
// lanes with the same digit (__match_any_sync): the top digit of a row of
// similar distances lands in one or two bins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRadix = 256;
constexpr int kMaxCand = 8192;          // candidates sorted in shared memory
constexpr int kSmemLimit = 232448;      // dynamic shared memory of a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ordered_key(float v) {
  uint32_t u = __float_as_uint(v);
  uint32_t mag = u & 0x7fffffffu;
  if (mag > 0x7f800000u) return 0xffffffffu;      // NaN: after +inf
  if (mag == 0) return 0x80000000u;               // -0.0 and +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Row {
  const float* g;       // the row in device memory
  const uint32_t* s;    // its keys in shared memory, or null
  int n;
  __device__ __forceinline__ uint32_t key(int j) const {
    return s ? s[j] : ordered_key(__ldg(g + j));
  }
};

struct Scratch {
  unsigned long long* cand;   // [P]
  uint32_t* hist;             // [kRadix]
  uint32_t* wsum;             // [kWarps]
  uint32_t* scal;             // [8]
};

// Sum of one value per thread, returned to every thread.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  __syncthreads();
  if (lane == 0) sc.wsum[warp] = v;
  __syncthreads();
  uint32_t tot = 0;
  for (int w = 0; w < kWarps; ++w) tot += sc.wsum[w];
  return tot;
}

// Stages 1-2 for one row: leaves the margin best (key << 32 | position),
// ascending, in sc.cand[0..margin) and padding after it up to P.
__device__ void select_candidates(const Row& row, int margin, int P,
                                  int exclude, Scratch& sc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // ---- radix select of the margin-th smallest key (rank margin - 1) ----
  uint32_t prefix = 0, pmask = 0, rank = (uint32_t)(margin - 1);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kRadix; i += kThreads) sc.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < row.n; base += kThreads) {
      const int j = base + tid;
      int bin = kRadix;                              // no count
      if (j < row.n && j != exclude) {
        const uint32_t key = row.key(j);
        if ((key & pmask) == prefix) bin = (key >> shift) & (kRadix - 1);
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < kRadix && lane == __ffs(peers) - 1)
        atomicAdd(&sc.hist[bin], (uint32_t)__popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 8l .. 8l + 7
      uint32_t c[8], s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = sc.hist[lane * 8 + b];
        s += c[b];
      }
      uint32_t incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      uint32_t acc = incl - s;
      if (rank >= acc && rank < incl) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (rank < acc + c[b]) {
            sc.scal[0] = (uint32_t)(lane * 8 + b);
            sc.scal[1] = rank - acc;
            break;
          }
          acc += c[b];
        }
      }
    }
    __syncthreads();
    prefix |= sc.scal[0] << shift;
    pmask |= (uint32_t)(kRadix - 1) << shift;
    rank = sc.scal[1];
    __syncthreads();
  }
  const uint32_t T = prefix;
  const uint32_t need_eq = rank + 1;               // entries equal to T
  const uint32_t c_lt = (uint32_t)margin - need_eq;  // entries below T

  // ---- compaction: every entry below T (any order), the need_eq lowest
  // positions equal to T (in order, by a block-wide count per chunk) ----
  if (tid == 0) sc.scal[2] = 0;
  __syncthreads();
  uint32_t eq_before = 0;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = 0; base < row.n; base += kThreads) {
    const int j = base + tid;
    bool lt = false, eq = false;
    uint32_t key = 0;
    if (j < row.n && j != exclude) {
      key = row.key(j);
      lt = key < T;
      eq = key == T;
    }
    const unsigned long long packed =
        ((unsigned long long)key << 32) | (uint32_t)j;
    if (lt) sc.cand[atomicAdd(&sc.scal[2], 1u)] = packed;
    const unsigned ballot = __ballot_sync(kFull, eq);
    if (eq_before < need_eq) {                     // block-uniform
      if (lane == 0) sc.wsum[warp] = __popc(ballot);
      __syncthreads();
      uint32_t before = eq_before, tot = 0;
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t x = sc.wsum[w];
        before += w < warp ? x : 0;
        tot += x;
      }
      if (eq) {
        const uint32_t r = before + __popc(ballot & lanes_below);
        if (r < need_eq) sc.cand[c_lt + r] = packed;
      }
      eq_before += tot;
      __syncthreads();
    }
  }
  for (int i = margin + tid; i < P; i += kThreads) sc.cand[i] = ~0ull;
  __syncthreads();

  // ---- bitonic sort of the P candidates, ascending ----
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (P >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = sc.cand[lo], b = sc.cand[hi];
        if ((a > b) == up) {
          sc.cand[lo] = b;
          sc.cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ void write_row(const Row& row, int k, float* out_d,
                          long long* out_i, const Scratch& sc) {
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const uint32_t p = (uint32_t)(sc.cand[j] & 0xffffffffull);
    out_d[j] = row.g[p];
    out_i[j] = (long long)p;
  }
}

__global__ void __launch_bounds__(kThreads)
verified_select_kernel(const float* __restrict__ d, int N, int k, int margin,
                       int P, int exclude, int keys_in_smem,
                       float* __restrict__ out_d,
                       long long* __restrict__ out_i,
                       uint8_t* __restrict__ ok,
                       unsigned int* __restrict__ failed) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch sc;
  sc.cand = reinterpret_cast<unsigned long long*>(smem);
  sc.hist = reinterpret_cast<uint32_t*>(smem + (size_t)P * 8);
  sc.wsum = sc.hist + kRadix;
  sc.scal = sc.wsum + kWarps;
  uint32_t* skeys = sc.scal + 8;

  const size_t r = blockIdx.x;
  Row row;
  row.g = d + r * (size_t)N;
  row.n = N;
  row.s = nullptr;
  if (keys_in_smem) {
    for (int j = threadIdx.x; j < N; j += kThreads)
      skeys[j] = ordered_key(__ldg(row.g + j));
    row.s = skeys;
    __syncthreads();
  }
  float* od = out_d + r * (size_t)k;
  long long* oi = out_i + r * (size_t)k;

  select_candidates(row, margin, P, exclude, sc);
  write_row(row, k, od, oi, sc);

  // ---- the proof over the whole row (the excluded column included) ----
  const uint32_t tau = (uint32_t)(sc.cand[k - 1] >> 32);
  uint32_t mine = 0;
  for (int j = threadIdx.x; j < N; j += kThreads) mine += row.key(j) < tau;
  for (int j = threadIdx.x; j < k; j += kThreads)
    mine -= (uint32_t)(sc.cand[j] >> 32) < tau;     // wraps; the sum is exact
  const bool proved = block_sum(mine, sc) == 0;
  if (threadIdx.x == 0) ok[r] = proved ? 1 : 0;
  if (proved) return;                               // block-uniform

  // ---- fallback: the exact selection of the whole row ----
  if (threadIdx.x == 0) atomicAdd(failed, 1u);
  __syncthreads();
  select_candidates(row, margin, P, -1, sc);
  write_row(row, k, od, oi, sc);
}

}  // namespace

extern "C" int verified_select_launch(const void* d, int Q, int N, int k,
                                      int margin, int exclude, void* out_d,
                                      void* out_i, void* ok, void* failed,
                                      void* stream) {
  const int valid = (exclude >= 0 && exclude < N) ? N - 1 : N;
  if (Q < 0 || k < 1 || margin < k || margin > valid || margin > kMaxCand)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  int P = 1;
  while (P < margin) P <<= 1;
  const size_t fixed = (size_t)P * 8 + (kRadix + kWarps + 8) * 4;
  const size_t with_keys = fixed + (size_t)N * 4;
  const int keys_in_smem = with_keys <= (size_t)kSmemLimit;
  const size_t bytes = keys_in_smem ? with_keys : fixed;
  cudaError_t err = cudaFuncSetAttribute(
      verified_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  verified_select_kernel<<<Q, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)d, N, k, margin, P, exclude, keys_in_smem, (float*)out_d,
      (long long*)out_i, (uint8_t*)ok, (unsigned int*)failed);
  return (int)cudaGetLastError();
}
