// E2: the encoder layer's residual add and LayerNorm in one pass over the
// rows, for Hopper (sm_90a).
//
// Replaces the fusion XLA makes of neighborhoodwatch_tpu/models/
// bert_flax.py:145 and :151-153 under the encoders' jax.jit (not a Pallas
// kernel): `LayerNorm(dtype=float32)(hidden + x)` cast back to the
// activation dtype, twice a layer (after the attention, after the FFN).
// The plain PyTorch version (ops/encoder_fused.py:add_layernorm_plain) runs
// it op by op: the add, the widening, torch's layer_norm, the cast back.
//
// What it computes, per row of the (rows, n) tensors hidden and x in the
// activation dtype T (bf16, fp16 or fp32):
//   s = T(hidden + x), the add rounded to T first, as the JAX package adds
//       in bf16 and the plain version adds in T (bit for bit theirs);
//   mean, var = the fp32 mean and mean square deviation of s (two passes
//       over the row held in registers; the order of addition is this
//       kernel's, so the result may differ from torch's layer_norm in the
//       last fp32 bits, and by one ulp of T after the rounding);
//   out = T((s - mean) * rsqrt(var + eps) * w + b), w and b fp32.
// Deterministic: a warp (a group of four for rows wider than 1,024) a row,
// no atomics, so a graph replay equals the eager forward bit for bit.
//
// Bound on this card: bytes. Two reads of the rows and one write (3 rows *
// n * sizeof(T)) and the weights once: at e5-large's 64 x 512 x 1024 in
// bf16, 201 MB, ~0.060 ms at 3.35 TB/s; a few operations a value.
//
// The kernel (add_layernorm_kernel, ops/encoder_fused.py's "rowpass"): a
// warp a row (a group of four above n = 1,024), one read of the row and of
// x, one write; w and b loaded from device memory after the two
// reductions. Any n up to 4,096: 16-byte vectors where n % 8 == 0 and the
// rows are aligned, single values elsewhere.
// What bounds it, measured on the card: bytes at the long shapes (1.2-1.3x
// the bound at 64 x 512); at nw's 64 x 32 (12 MB) the fixed costs of a
// launch and of a block's start (62 registers, four blocks an SM, one wave
// at 64 x 32).

#include "row_pass.cuh"

namespace {

using namespace rowpass;

template <typename T, int kLanes, int kPer, bool kVec>
__global__ void __launch_bounds__(kThreads)
add_layernorm_kernel(const T* __restrict__ hidden, const T* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ out,
                     long long rows, int n, float eps) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % kLanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool active = row < rows;
  if (kLanes == 32 && !active) return;  // other widths meet at shuffles
                                        // or barriers
  const long long off = active ? row * n : 0;
  const int m = active ? n : 0;
  float v[kPer], u[kPer];
  load_row<T, kLanes, kPer, kVec>(hidden + off, m, lane, v, 0.0f);
  load_row<T, kLanes, kPer, kVec>(x + off, m, lane, u, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = round_to<T>(__fadd_rn(v[i], u[i]));
  layer_norm<kLanes, kPer, kVec>(v, n, lane, w, b, eps, red);
  if (active) store_row<T, kLanes, kPer, kVec>(out + off, n, lane, v);
}

template <typename T, int kLanes, int kPer, bool kVec>
cudaError_t launch_width(const void* hidden, const void* x, const float* w,
                         const float* b, void* out, long long rows, int n,
                         float eps, cudaStream_t st) {
  const long long per_block = kThreads / kLanes;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  add_layernorm_kernel<T, kLanes, kPer, kVec><<<(unsigned)blocks, kThreads, 0,
                                           st>>>(
      (const T*)hidden, (const T*)x, w, b, (T*)out, rows, n, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_layout(const void* hidden, const void* x, const float* w,
                          const float* b, void* out, long long rows, int n,
                          float eps, cudaStream_t st) {
  if (n <= 256)
    return launch_width<T, 32, 8, kVec>(hidden, x, w, b, out, rows, n, eps, st);
  if (n <= 512)
    return launch_width<T, 32, 16, kVec>(hidden, x, w, b, out, rows, n, eps,
                                        st);
  if (n <= 1024)
    return launch_width<T, 32, 32, kVec>(hidden, x, w, b, out, rows, n, eps,
                                        st);
  return launch_width<T, 128, 32, kVec>(hidden, x, w, b, out, rows, n, eps, st);
}

template <typename T>
cudaError_t launch(bool vec, const void* hidden, const void* x,
                   const float* w, const float* b, void* out, long long rows,
                   int n, float eps, cudaStream_t st) {
  return vec ? launch_layout<T, true>(hidden, x, w, b, out, rows, n, eps, st)
             : launch_layout<T, false>(hidden, x, w, b, out, rows, n, eps,
                                       st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// hidden, x, out: (rows, n) contiguous, `dtype` 0 bf16, 1 fp32, 2 fp16;
// w, b: (n,) fp32; 1 <= n <= 4096. Returns a CUDA error code, 0 on success.
extern "C" int add_layernorm_launch(const void* hidden, const void* x,
                                    const void* w, const void* b, void* out,
                                    long long rows, int n, int dtype,
                                    float eps, void* stream) {
  if (rows < 0 || n < 1 || n > 4096 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bool vec = n % rowpass::kChunk == 0 && aligned16(hidden) &&
                   aligned16(x) && aligned16(w) && aligned16(b) &&
                   aligned16(out);
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)launch<__nv_bfloat16>(vec, hidden, x, wf, bf, out, rows, n,
                                        eps, st);
    case rowpass::kF16:
      return (int)launch<__half>(vec, hidden, x, wf, bf, out, rows, n, eps,
                                 st);
    default:
      return (int)launch<float>(vec, hidden, x, wf, bf, out, rows, n, eps,
                                st);
  }
}
