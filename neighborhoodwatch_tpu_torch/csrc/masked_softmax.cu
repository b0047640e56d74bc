// E3: the written-out attention's scale, key mask and softmax in one pass
// over the (B, H, T, T) logits, for Hopper (sm_90a).
//
// Replaces the fusion XLA makes of neighborhoodwatch_tpu/models/
// bert_flax.py:118-130 under the encoders' jax.jit (not a Pallas kernel):
// the logits / sqrt(head_dim), the -1e9 key mask, the round to bf16 and the
// fp32 softmax, the probabilities in the activation dtype. The products
// around it (q k^T before, probs v after) stay library batched matmuls, as
// the JAX package leaves its einsums to XLA. The plain PyTorch version
// (ops/encoder_fused.py:masked_softmax_plain) runs it op by op, about seven
// passes over the logits.
//
// What it computes, per query row of T logits in the activation dtype T_
// (bf16, fp16 or fp32) and the (B, T) key mask of its batch row, in the
// plain version's order:
//   x = float(l) / scale  (a true division, as __fdiv_rn rounds it: scale
//                          = sqrt(d) in fp32, which a reciprocal multiply
//                          alone would round differently for head dims
//                          like 32; see div_by);
//   x = mask ? x : -1e9;
//   x = float(bf16(x))    (under bf16 activations only, as the reference
//                          rounds there only; -1e9 survives, bf16 keeping
//                          fp32's exponent range);
//   p = exp(x - max) / sum exp(x - max), fp32 (div_by), written in T_.
// An all-masked row gives the uniform row 1/T, as the plain version does.
// Deterministic: the row in the registers of 4 to 64 lanes (a chunk of 8
// keys a lane where T % 8 == 0, so that short rows share a warp; else a
// warp, two above 256 keys), no atomics.
//
// Bound on this card: bytes. One read of the logits and one write of the
// probabilities (2 B H T^2 sizeof(T_)) and the mask: at e5-large's 64 x
// 16 heads x 512^2 in bf16, 1.07 GB, ~0.32 ms at 3.35 TB/s. 16-byte loads
// where T % 8 == 0, single values elsewhere (any T up to 512), at most 8
// values a lane.

#include <math.h>

#include <type_traits>

#include "row_pass.cuh"

namespace {

using namespace rowpass;

constexpr float kMasked = -1e9f;

// x / s rounded to nearest for s > 0 normal and r = RN(1/s): the product by
// the reciprocal, corrected once by its exact residual (an fma). It equals
// __fdiv_rn(x, s) for every bf16 and fp16 x of magnitude >= 2^-100 and
// every s = sqrt(d), d = 1 .. 512 (checked exhaustively against exact
// division in tests/test_torch_port_encoder_fused.py), and is within one
// ulp below that, where no softmax output can tell. __fdiv_rn's slow-path
// call made ptxas spill the row's registers.
__device__ __forceinline__ float div_by(float x, float s, float r) {
  const float q = __fmul_rn(x, r);
  const float e = fmaf(-q, s, x);
  return (e != 0.0f && isfinite(e)) ? fmaf(e, r, q) : q;
}

template <typename T, int kLanes, int kPer, bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_softmax_kernel(const T* __restrict__ logits,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      long long rows, int heads, int seq, float scale,
                      float recip) {
  constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % kLanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool active = row < rows;
  if (kLanes == 32 && !active) return;  // other widths meet at shuffles
                                        // or barriers
  const int n = active ? seq : 0;
  const long long off = active ? row * seq : 0;
  const uint8_t* keep = mask + row / ((long long)heads * seq) * seq;
  float v[kPer];
  load_row<T, kLanes, kPer, kVec>(logits + off, n, lane, v, -INFINITY);
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = slot<kLanes, kVec>(lane, i);
    if (e < n) {
      float x = keep[e] ? div_by(v[i], scale, recip) : kMasked;
      if (kRound) x = round_to<T>(x);
      v[i] = x;
      mx = fmaxf(mx, x);
    }
  }
  mx = group_max<kLanes>(mx, red);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = slot<kLanes, kVec>(lane, i) < n ? expf(__fsub_rn(v[i], mx)) : 0.0f;
    s = __fadd_rn(s, v[i]);
  }
  s = group_sum<kLanes>(s, red);
  if (!active) return;
  // s >= 1 (the max's own term): an approximate reciprocal and a Newton
  // step, so each quotient lies within an ulp of the division's
  float rs = __fdividef(1.0f, s);
  rs = fmaf(rs, fmaf(-s, rs, 1.0f), rs);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = div_by(v[i], s, rs);
  store_row<T, kLanes, kPer, kVec>(out + off, seq, lane, v);
}

template <typename T, int kLanes, int kPer, bool kVec>
cudaError_t launch_width(const void* logits, const uint8_t* mask, void* out,
                         long long rows, int heads, int seq, float scale,
                         cudaStream_t st) {
  const float recip = 1.0f / scale;      // IEEE on the host
  const long long per_block = kThreads / kLanes;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  masked_softmax_kernel<T, kLanes, kPer, kVec><<<(unsigned)blocks, kThreads, 0,
                                            st>>>(
      (const T*)logits, mask, (T*)out, rows, heads, seq, scale, recip);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool vec, const void* logits, const uint8_t* mask,
                   void* out, long long rows, int heads, int seq, float scale,
                   cudaStream_t st) {
  // vector rows: a chunk of 8 keys a lane, 4 to 64 lanes a row
  if (vec) {
    if (seq <= 32)
      return launch_width<T, 4, 8, true>(logits, mask, out, rows, heads, seq,
                                         scale, st);
    if (seq <= 64)
      return launch_width<T, 8, 8, true>(logits, mask, out, rows, heads, seq,
                                         scale, st);
    if (seq <= 128)
      return launch_width<T, 16, 8, true>(logits, mask, out, rows, heads,
                                          seq, scale, st);
    if (seq <= 256)
      return launch_width<T, 32, 8, true>(logits, mask, out, rows, heads,
                                          seq, scale, st);
    return launch_width<T, 64, 8, true>(logits, mask, out, rows, heads, seq,
                                        scale, st);
  }
  if (seq <= 32)
    return launch_width<T, 32, 1, false>(logits, mask, out, rows, heads, seq,
                                         scale, st);
  if (seq <= 64)
    return launch_width<T, 32, 2, false>(logits, mask, out, rows, heads, seq,
                                         scale, st);
  if (seq <= 128)
    return launch_width<T, 32, 4, false>(logits, mask, out, rows, heads, seq,
                                         scale, st);
  if (seq <= 256)
    return launch_width<T, 32, 8, false>(logits, mask, out, rows, heads, seq,
                                         scale, st);
  return launch_width<T, 64, 8, false>(logits, mask, out, rows, heads, seq,
                                       scale, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// logits, out: (B, heads, T, T) contiguous of `dtype` 0 bf16, 1 fp32, 2
// fp16; mask: (B, T) bytes, nonzero for a key that is kept; scale =
// sqrt(head_dim) in fp32; 1 <= T <= 512. Returns a CUDA error code, 0 on
// success.
extern "C" int masked_softmax_launch(const void* logits, const void* mask,
                                     void* out, int B, int heads, int T,
                                     int dtype, float scale, void* stream) {
  if (B < 0 || heads < 0 || T < 1 || T > 512 || dtype < 0 || dtype > 2 ||
      !(scale > 0.0f))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * heads * T;
  if (rows == 0) return 0;
  const bool vec =
      T % rowpass::kChunk == 0 && aligned16(logits) && aligned16(out);
  const uint8_t* m = (const uint8_t*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)launch<__nv_bfloat16>(vec, logits, m, out, rows, heads, T,
                                        scale, st);
    case rowpass::kF16:
      return (int)launch<__half>(vec, logits, m, out, rows, heads, T, scale,
                                 st);
    default:
      return (int)launch<float>(vec, logits, m, out, rows, heads, T, scale,
                                st);
  }
}
