// E1: the encoder's embeddings, their sum and LayerNorm in one pass, for
// Hopper (sm_90a).
//
// Replaces the fusion XLA makes of neighborhoodwatch_tpu/models/
// bert_flax.py:165-172 under the encoders' jax.jit (not a Pallas kernel):
// the word, position and token-type gathers (fp32 tables), their sum,
// `embeddings_ln` (LayerNorm in fp32) and the cast to the activation
// dtype. The plain PyTorch version (ops/encoder_fused.py:
// embed_layernorm_plain) runs it op by op: three gathers, two adds,
// torch's layer_norm, the cast.
//
// What it computes, per token (b, t) of the (B, T) int64 ids:
//   e = (word[id] + position[t]) + type[0], fp32, in the plain version's
//       order (bit for bit its sum; both packages pass token type 0);
//   mean, var, out as E2 (add_layernorm.cu): two fp32 passes over the row
//       held in registers, out = T((e - mean) * rsqrt(var + eps) * w + b).
// An id outside [0, vocab) reads nothing and writes a row of NaN (the
// plain version cannot index it; the tokenizer never emits one). No host
// sync checks the ids. Deterministic: a warp (a group of four for rows
// wider than 1,024) a token, no atomics.
//
// Bound on this card: bytes. The gathered word rows (B*T*n*4), the
// position rows (T*n*4, shared by the batch) and the output (B*T*n*
// sizeof(T)): at e5-large's 64 x 512 x 1024 in bf16, 204 MB, ~0.061 ms at
// 3.35 TB/s. 16-byte loads where n % 8 == 0 and the rows are aligned,
// single values elsewhere (any n up to 4,096).

#include <math.h>

#include "row_pass.cuh"

namespace {

using namespace rowpass;

template <typename T, int kLanes, int kPer, bool kVec>
__global__ void __launch_bounds__(kThreads)
embed_layernorm_kernel(const long long* __restrict__ ids,
                       const float* __restrict__ word,
                       const float* __restrict__ position,
                       const float* __restrict__ type0,
                       const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ out,
                       long long rows, int seq, int n, long long vocab,
                       float eps) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % kLanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool active = row < rows;
  if (kLanes == 32 && !active) return;  // other widths meet at shuffles
                                        // or barriers
  const long long id = active ? ids[row] : 0;
  const bool ok = active && id >= 0 && id < vocab;
  const int m = ok ? n : 0;            // a bad id reads nothing
  const int t = active ? (int)(row % seq) : 0;
  float v[kPer], u[kPer];
  load_row<float, kLanes, kPer, kVec>(word + (ok ? id : 0) * n, m, lane, v, 0.0f);
  load_row<float, kLanes, kPer, kVec>(position + (long long)t * n, m, lane, u,
                                 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = __fadd_rn(v[i], u[i]);
  load_row<float, kLanes, kPer, kVec>(type0, m, lane, u, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = __fadd_rn(v[i], u[i]);
  layer_norm<kLanes, kPer, kVec>(v, n, lane, w, b, eps, red);
  if (!active) return;
  if (!ok) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = NAN;
  }
  store_row<T, kLanes, kPer, kVec>(out + row * n, n, lane, v);
}

struct Args {
  const long long* ids;
  const float *word, *position, *type0, *w, *b;
  void* out;
  long long rows, vocab;
  int seq, n;
  float eps;
};

template <typename T, int kLanes, int kPer, bool kVec>
cudaError_t launch_width(const Args& a, cudaStream_t st) {
  const long long per_block = kThreads / kLanes;
  const long long blocks = (a.rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embed_layernorm_kernel<T, kLanes, kPer, kVec><<<(unsigned)blocks, kThreads, 0,
                                             st>>>(
      a.ids, a.word, a.position, a.type0, a.w, a.b, (T*)a.out, a.rows, a.seq,
      a.n, a.vocab, a.eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_layout(const Args& a, cudaStream_t st) {
  if (a.n <= 256) return launch_width<T, 32, 8, kVec>(a, st);
  if (a.n <= 512) return launch_width<T, 32, 16, kVec>(a, st);
  if (a.n <= 1024) return launch_width<T, 32, 32, kVec>(a, st);
  return launch_width<T, 128, 32, kVec>(a, st);
}

template <typename T>
cudaError_t launch(bool vec, const Args& a, cudaStream_t st) {
  return vec ? launch_layout<T, true>(a, st) : launch_layout<T, false>(a, st);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// ids: (B, T) int64 contiguous; word (vocab, n), position (>= T, n), type0
// (n,) the token-type row 0, w, b (n,): fp32 contiguous; out: (B, T, n) of
// `dtype` 0 bf16, 1 fp32, 2 fp16; 1 <= n <= 4096. Returns a CUDA error
// code, 0 on success.
extern "C" int embed_layernorm_launch(const void* ids, const void* word,
                                      const void* position, const void* type0,
                                      const void* w, const void* b, void* out,
                                      int B, int T, int n, long long vocab,
                                      int dtype, float eps, void* stream) {
  if (B < 0 || T < 1 || n < 1 || n > 4096 || vocab < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool vec = n % rowpass::kChunk == 0 && aligned16(word) &&
                   aligned16(position) && aligned16(type0) && aligned16(w) &&
                   aligned16(b) && aligned16(out);
  const Args a{(const long long*)ids, (const float*)word,
               (const float*)position, (const float*)type0, (const float*)w,
               (const float*)b, out, (long long)B * T, vocab, T, n, eps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)launch<__nv_bfloat16>(vec, a, st);
    case rowpass::kF16:
      return (int)launch<__half>(vec, a, st);
    default:
      return (int)launch<float>(vec, a, st);
  }
}
