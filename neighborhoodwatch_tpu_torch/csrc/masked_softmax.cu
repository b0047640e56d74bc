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
// 16 heads x 512^2 in bf16, 1.07 GB, ~0.32 ms at 3.35 TB/s.
//
// Two kernels, the same lane layout and order of operations, so the same
// bits (ops/encoder_fused.py's variants):
//   "rowpass" (masked_softmax_kernel): a block of 256 / lanes rows, each
//       row loaded by its own lanes, 16-byte loads where T % 8 == 0,
//       single values elsewhere (any T up to 512), at most 8 values a
//       lane; each lane reads its keys' mask as 8 single bytes. Taken
//       where the staged kernel cannot be.
//   "staged" (masked_softmax_staged), the default for T % 8 == 0 and
//       aligned pointers, on the launch plan of ops/encoder_fused.py:
//       row_plan: a grid of at most the blocks the card holds at once,
//       each block `passes` passes of consecutive rows of the flattened
//       (B H T, T) logits. A pass's 16 bytes of logits and 8 mask bytes a
//       lane are loaded before the previous pass's arithmetic, so a
//       thread holds two rows' loads in flight across the reductions
//       (32-34 registers, eight blocks an SM); the batch row of a
//       thread's rows is divided out once a block and then counted on.
// What bounds them, measured on the card: not bytes alone. Each value
// takes some 30 instructions (two corrected divisions, the bf16 round,
// expf) and each row two reductions by shuffles (and barriers above 256
// keys); a row's loads waited behind them in "rowpass" (1.6-1.9x the bytes
// bound at 64 x 128 to 512), and the prefetch takes part of that wait
// away. At nw's 64 x 32 (4 MB) a launch's and a block's fixed costs
// dominate. A ring of bulk-copied logits in shared memory, tried first,
// held fewer blocks an SM and was slower.

#include <math.h>

#include <type_traits>

#include "row_pass.cuh"
#include "row_stream.cuh"  // the grid check

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

// ---- "staged"

// a lane's 8 values as loaded: 16 bytes (bf16, fp16) or 32 (fp32), held
// packed until they are widened
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

// Block i takes the step of rows from i x the step's rows: `passes` x
// kThreads / kLanes consecutive rows of the flattened (B H T, T) logits;
// thread t takes row t / kLanes of each pass. A pass's logits and mask
// bytes are loaded before the previous pass's arithmetic, so they are in
// flight while it reduces.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
masked_softmax_staged(const T* __restrict__ logits,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      int rows, int heads, int seq, float scale,
                      float recip, int passes) {
  constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRows = kThreads / kLanes;    // rows a pass
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % kLanes;
  const int per_batch = heads * seq;          // rows a batch row
  const int e = lane * kChunk;                // the lane's first key
  const bool keys = e < seq;                  // the lane holds 8 keys
  // the thread's row and its batch row: one division a block ("rowpass"
  // divides once a row), then counted on (32-bit rows: the launch
  // function refuses 2^30 rows or more)
  int r = (int)blockIdx.x * passes * kRows + (int)threadIdx.x / kLanes;
  int b = r / per_batch;
  int rem = r - b * per_batch;
  // seq % 8 == 0: a lane's 8 keys are all in the row or all past it
  bool on = keys && r < rows;
  Raw8<T> raw{};
  uint2 keep = make_uint2(0u, 0u);            // the lane's 8 mask bytes
  if (on) {
    raw = load_raw<T>(logits + (size_t)r * seq + e);
    keep = *reinterpret_cast<const uint2*>(mask + (size_t)b * seq + e);
  }
  for (int j = 0; j < passes; ++j) {
    // the next pass's row, its loads issued now
    const int rn = r + kRows;
    int bn = b, remn = rem + kRows;
    while (remn >= per_batch) {
      remn -= per_batch;
      ++bn;
    }
    const bool on_next = j + 1 < passes && keys && rn < rows;
    Raw8<T> raw_next{};
    uint2 keep_next = make_uint2(0u, 0u);
    if (on_next) {
      raw_next = load_raw<T>(logits + (size_t)rn * seq + e);
      keep_next =
          *reinterpret_cast<const uint2*>(mask + (size_t)bn * seq + e);
    }
    float v[kChunk];
    load8<T>(reinterpret_cast<const T*>(raw.w), v);
    // as masked_softmax_kernel, value by value
    float mx = -INFINITY;
    if (on) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const uint32_t word = i < 4 ? keep.x : keep.y;
        float x = word & (0xffu << (8 * (i & 3))) ? div_by(v[i], scale, recip)
                                                  : kMasked;
        if (kRound) x = round_to<T>(x);
        v[i] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = group_max<kLanes>(mx, red);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = on ? expf(__fsub_rn(v[i], mx)) : 0.0f;
      s = __fadd_rn(s, v[i]);
    }
    s = group_sum<kLanes>(s, red);
    if (on) {
      float rs = __fdividef(1.0f, s);
      rs = fmaf(rs, fmaf(-s, rs, 1.0f), rs);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = div_by(v[i], s, rs);
      store8<T>(out + (size_t)r * seq + e, v);
    }
    r = rn;
    b = bn;
    rem = remn;
    on = on_next;
    raw = raw_next;
    keep = keep_next;
  }
}

template <typename T, int kLanes>
cudaError_t staged_width(const void* logits, const uint8_t* mask, void* out,
                         long long rows, int heads, int seq, float scale,
                         int grid, int passes, cudaStream_t st) {
  const void* fn = (const void*)masked_softmax_staged<T, kLanes>;
  cudaError_t err = rowstream::check_grid(fn, kThreads, 0, grid);
  if (err != cudaSuccess) return err;
  const float recip = 1.0f / scale;      // IEEE on the host
  masked_softmax_staged<T, kLanes><<<grid, kThreads, 0, st>>>(
      (const T*)logits, mask, (T*)out, (int)rows, heads, seq, scale, recip,
      passes);
  return cudaGetLastError();
}

// lanes a row of T keys, 8 keys a lane (the "rowpass" vector layout)
int lanes_for(int seq) {
  return seq <= 32 ? 4 : seq <= 64 ? 8 : seq <= 128 ? 16 : seq <= 256 ? 32
                                                                      : 64;
}

template <typename T>
const void* staged_fn(int seq) {
  switch (lanes_for(seq)) {
    case 4: return (const void*)masked_softmax_staged<T, 4>;
    case 8: return (const void*)masked_softmax_staged<T, 8>;
    case 16: return (const void*)masked_softmax_staged<T, 16>;
    case 32: return (const void*)masked_softmax_staged<T, 32>;
    default: return (const void*)masked_softmax_staged<T, 64>;
  }
}

template <typename T>
cudaError_t staged(const void* logits, const uint8_t* mask, void* out,
                   long long rows, int heads, int seq, float scale, int grid,
                   int passes, cudaStream_t st) {
  switch (lanes_for(seq)) {
    case 4:
      return staged_width<T, 4>(logits, mask, out, rows, heads, seq, scale,
                                grid, passes, st);
    case 8:
      return staged_width<T, 8>(logits, mask, out, rows, heads, seq, scale,
                                grid, passes, st);
    case 16:
      return staged_width<T, 16>(logits, mask, out, rows, heads, seq, scale,
                                 grid, passes, st);
    case 32:
      return staged_width<T, 32>(logits, mask, out, rows, heads, seq, scale,
                                 grid, passes, st);
    default:
      return staged_width<T, 64>(logits, mask, out, rows, heads, seq, scale,
                                 grid, passes, st);
  }
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

// The "staged" kernel's limit at this T and dtype: blocks an SM holds at
// `smem_bytes` of dynamic shared memory (>= 0), or minus a CUDA error.
extern "C" int masked_softmax_staged_resident(int T, int dtype,
                                              int smem_bytes) {
  if (T < 8 || T > 512 || T % 8 != 0 || dtype < 0 || dtype > 2 ||
      smem_bytes < 0 || smem_bytes > rowstream::kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  const void* fn = dtype == rowpass::kBF16 ? staged_fn<__nv_bfloat16>(T)
                   : dtype == rowpass::kF16 ? staged_fn<__half>(T)
                                            : staged_fn<float>(T);
  int blocks = 0;
  const cudaError_t err =
      rowstream::resident_blocks(fn, rowpass::kThreads, smem_bytes, &blocks);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The "staged" kernel on the plan of ops/encoder_fused.py:row_plan: `grid`
// blocks of `passes` passes of 256 / lanes rows each, as many blocks as
// the steps the rows fill and at most as many as the card holds at once;
// no dynamic shared memory (`smem_bytes` 0, checked as the plan's). T % 8
// == 0, logits and out 16-byte aligned, the mask 8-byte aligned, fewer
// than 2^30 rows. Arguments otherwise as masked_softmax_launch's.
extern "C" int masked_softmax_staged_launch(const void* logits,
                                            const void* mask, void* out,
                                            int B, int heads, int T,
                                            int dtype, float scale, int grid,
                                            int passes, int smem_bytes,
                                            void* stream) {
  if (B < 0 || heads < 0 || T < 8 || T > 512 || T % 8 != 0 || dtype < 0 ||
      dtype > 2 || !(scale > 0.0f) || passes < 1 || grid < 1 ||
      smem_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * heads * T;
  if (rows >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const long long step_rows =
      (long long)passes * (rowpass::kThreads / lanes_for(T));
  if ((rows + step_rows - 1) / step_rows != grid && rows > 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(logits) || !aligned16(out) || ((uintptr_t)mask & 7) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const uint8_t* m = (const uint8_t*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)staged<__nv_bfloat16>(logits, m, out, rows, heads, T,
                                        scale, grid, passes, st);
    case rowpass::kF16:
      return (int)staged<__half>(logits, m, out, rows, heads, T, scale, grid,
                                 passes, st);
    default:
      return (int)staged<float>(logits, m, out, rows, heads, T, scale, grid,
                                passes, st);
  }
}
