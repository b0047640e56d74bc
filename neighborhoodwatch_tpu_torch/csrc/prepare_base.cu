// F1: the screened engine's base preparation in one pass over the corpus,
// for Hopper (sm_90a).
//
// Replaces the fusion XLA makes of neighborhoodwatch_tpu/ops/knn.py:251
// _prepare_arrays under jax.jit (not a Pallas kernel): "one fused pass over
// the corpus". The plain PyTorch version (ops/fused_core.py:prepare_plain)
// runs the same function op by op, about eight elementwise and reduction
// passes over each row chunk.
//
// What it computes, per row r of a (n, dim) fp32 base x:
//   bn_row[r] = sum x^2 (fp32; the order of addition is this kernel's:
//               each lane its strided columns, then a butterfly over the
//               warp);
//   bhi[r]    = bf16(x), round to nearest even by the hardware conversion
//               (bit for bit what bf16_round(x).to(bfloat16) and torch's own
//               conversion give on the card, NaN included: every NaN becomes
//               the canonical bf16 NaN);
//   blo_n     = sqrt(sum (x - float(bhi))^2), never written: it only feeds
//               the statistics. A NaN row's residual stays NaN.
// and the maxima, over the rows whose bn_row is finite, of bn_row, blo_n
// and (where bn_row > 0) blo_n * rsqrt(max(bn_row, 1e-30)): each block
// folds its own into three words by an unsigned atomicMax on the float
// bits (every value is >= 0, so the bits order like the values). A second
// launch of one thread turns them into the (4,) certificate statistics
// [bn_max, sqrt(bn_max), blo_max, ratio_max], each maximum times the
// norm guard the wrapper passes, as the plain version does.
//
// Without `full` the kernel writes bn_row alone (the exact engines' base
// norms, ops/distance.py), with the same order of addition.
//
// Bound on this card: bytes. One read of the base (n*dim*4) and one write
// of bhi (n*dim*2) and bn_row: 9.2 GB at 1,000,000 x 1536, ~2.8 ms at
// 3.35 TB/s; a few operations a value. A warp takes a row at a time, a
// grid of a few blocks an SM walks the rows; each lane loads four 16-byte
// vectors before it uses any (evict-first: the rows are read once) and
// stores 8 bytes of bhi for each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// one value: its square into sq; with kFull its bf16 bits (returned) and
// its residual's square into lo
template <bool kFull>
__device__ __forceinline__ uint32_t take(float v, float& sq, float& lo) {
  sq = fmaf(v, v, sq);
  if (!kFull) return 0;
  const uint32_t h = bf16_bits(v);
  const float r = v - __uint_as_float(h << 16);
  lo = fmaf(r, r, lo);
  return h;
}

template <bool kVec, bool kFull>
__global__ void __launch_bounds__(kThreads)
prepare_base_kernel(const float* __restrict__ x, long long n, int dim,
                    float* __restrict__ bn_row, uint16_t* __restrict__ bhi,
                    unsigned int* __restrict__ maxima) {
  __shared__ float part[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m_bn = 0.f, m_lo = 0.f, m_ratio = 0.f;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n;
       r += stride) {
    const float* row = x + r * dim;
    uint16_t* hrow = kFull ? bhi + r * dim : nullptr;
    float sq = 0.f, lo = 0.f;
    if (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      uint2* hrow4 = reinterpret_cast<uint2*>(hrow);
      const int n4 = dim >> 2;
      for (int c0 = lane; c0 < n4; c0 += 32 * kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          v[u] = c < n4 ? __ldcs(row4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          if (c < n4) {
            const uint32_t h0 = take<kFull>(v[u].x, sq, lo);
            const uint32_t h1 = take<kFull>(v[u].y, sq, lo);
            const uint32_t h2 = take<kFull>(v[u].z, sq, lo);
            const uint32_t h3 = take<kFull>(v[u].w, sq, lo);
            if (kFull) __stcs(hrow4 + c, make_uint2(h0 | (h1 << 16),
                                                    h2 | (h3 << 16)));
          }
        }
      }
    } else {
      for (int c = lane; c < dim; c += 32) {
        const uint32_t h = take<kFull>(__ldcs(row + c), sq, lo);
        if (kFull) hrow[c] = (uint16_t)h;
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) bn_row[r] = sq;
    if (kFull) {
      const float blo = __fsqrt_rn(warp_sum(lo));
      if (isfinite(sq)) {
        m_bn = fmaxf(m_bn, sq);
        m_lo = fmaxf(m_lo, blo);
        if (sq > 0.f) m_ratio = fmaxf(m_ratio, blo * rsqrtf(fmaxf(sq, 1e-30f)));
      }
    }
  }
  if (!kFull) return;
  if (lane == 0) {
    part[0][warp] = m_bn;
    part[1][warp] = m_lo;
    part[2][warp] = m_ratio;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[threadIdx.x][w]);
    if (m > 0.f) atomicMax(maxima + threadIdx.x, __float_as_uint(m));
  }
}

// [bn_max, sqrt(bn_max), blo_max, ratio_max], each maximum times `guard`
__global__ void prepare_stats_kernel(const unsigned int* __restrict__ maxima,
                                     float guard, float* __restrict__ stats) {
  if (threadIdx.x != 0) return;
  const float bn_max = __fmul_rn(__uint_as_float(maxima[0]), guard);
  stats[0] = bn_max;
  stats[1] = __fsqrt_rn(bn_max);
  stats[2] = __fmul_rn(__uint_as_float(maxima[1]), guard);
  stats[3] = __fmul_rn(__uint_as_float(maxima[2]), guard);
}

template <bool kVec, bool kFull>
cudaError_t launch(const float* x, long long n, int dim, float* bn_row,
                   uint16_t* bhi, unsigned int* maxima, int grid,
                   cudaStream_t st) {
  prepare_base_kernel<kVec, kFull><<<grid, kThreads, 0, st>>>(
      x, n, dim, bn_row, bhi, maxima);
  return cudaGetLastError();
}

}  // namespace

// x: (n, dim) fp32 rows; bn_row: (n,) fp32. With `full`, also bhi (n, dim)
// bf16, maxima (3 words of scratch) and stats (4 fp32); without, the norms
// alone. `vec`: rows 16-byte aligned and dim % 4 == 0. `grid`: the blocks
// to launch (the wrapper takes a few an SM). Returns a CUDA error code, 0
// on success.
extern "C" int prepare_base_launch(const void* x, long long n, int dim,
                                   int vec, int full, void* bn_row, void* bhi,
                                   void* maxima, void* stats, float guard,
                                   int grid, void* stream) {
  if (n < 0 || dim < 1 || grid < 1 || (vec && dim % 4 != 0) ||
      (full && (maxima == nullptr || stats == nullptr ||
                (n > 0 && bhi == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (full) {
    err = cudaMemsetAsync(maxima, 0, 3 * sizeof(unsigned int), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    const float* xf = (const float*)x;
    float* bn = (float*)bn_row;
    uint16_t* h = (uint16_t*)bhi;
    unsigned int* mx = (unsigned int*)maxima;
    if (vec)
      err = full ? launch<true, true>(xf, n, dim, bn, h, mx, grid, st)
                 : launch<true, false>(xf, n, dim, bn, h, mx, grid, st);
    else
      err = full ? launch<false, true>(xf, n, dim, bn, h, mx, grid, st)
                 : launch<false, false>(xf, n, dim, bn, h, mx, grid, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (full) {
    prepare_stats_kernel<<<1, 32, 0, st>>>((const unsigned int*)maxima,
                                           guard, (float*)stats);
    err = cudaGetLastError();
  }
  return (int)err;
}
