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
// 3.35 TB/s.
//
// Two kernels, the same lane layout (launch_layout's kLanes / kPer) and
// order of operations, so the same bits (ops/encoder_fused.py's variants):
//   "rowpass" (embed_layernorm_kernel), the first kernel and the
//       default: a warp (a group of four above n = 1,024) a token in
//       row-major order; each token reads its word row and the position,
//       type-0, w and b rows again (the four shared rows from L2: 16 KB a
//       token at n = 1,024), w and b after both reductions. Any n up to
//       4,096: 16-byte loads where n % 8 == 0 and the rows are aligned,
//       single values elsewhere.
//   "staged" (embed_layernorm_staged), a named variant for n % 8 == 0
//       and 16-byte aligned pointers, on the launch plan of
//       ops/encoder_fused.py:row_plan: a grid of at most the blocks the
//       card holds at once; block i takes `step` consecutive rows of the
//       position-major order (t, b), so the tokens of a block share one or
//       a few positions. The block stages type0, w, b and its positions'
//       rows in shared memory once, by cp.async issued before the first
//       ids are used; each warp (group) loads the ids of its first 32
//       passes at once and prefetches its next pass's word row into
//       registers while it normalizes this one.
//       The word row is the only read a token makes of L2 or HBM.
// What bounds them, measured on the card (PERF.md): bytes at the long
// shapes ("staged" 1.58-1.72x the bound over distinct word rows,
// "rowpass" 1.74-1.78x; ~2.5-2.6 TB/s counting a word row read a token,
// near E2's ~2.8); the launch and a block's start at nw's
// 64 x 32 and ck's 1 x 32. "staged" holds ~100 registers (two blocks an
// SM); at one full pass a block it was slower than "rowpass" (the
// staging's round trip and barrier with nothing to prefetch), so the plan
// sends that case to "rowpass". Not faster at the main path's shapes (nw's
// 64 x 32 goes to "rowpass", ck's 1 x 32 ran at parity), so not the
// default.

#include <math.h>

#include "row_pass.cuh"
#include "row_stream.cuh"

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

// ---- "staged"

// Position rows a block of `step` consecutive position-major rows touches
// at most (ops/encoder_fused.py:staged_positions computes the same): the
// step's rows split into whole positions where step is a multiple of the
// batch, lie in one where it divides the batch, else span at most
// (step - 1) / batch + 2.
int staged_positions(int step, int batch, int seq) {
  int p = step % batch == 0   ? step / batch
          : batch % step == 0 ? 1
                              : (step - 1) / batch + 2;
  return p < seq ? p : seq;
}

// dynamic shared memory of the staged kernel: type0, w, b and the
// positions' rows (fp32). ops/encoder_fused.py:staged_bytes computes the
// same.
size_t staged_bytes(int n, int positions) {
  return (size_t)(3 + positions) * n * sizeof(float);
}

// Block i takes the position-major rows [i step, (i + 1) step) of the
// (seq, batch) order: row r is token (r % batch, r / batch). Group g (a
// warp, or four warps above n = 1,024) takes rows g, g + kGroups, ... of
// the block's step, one a pass.
template <typename T, int kLanes, int kPer>
__global__ void __launch_bounds__(kThreads)
embed_layernorm_staged(const long long* __restrict__ ids,
                       const float* __restrict__ word,
                       const float* __restrict__ position,
                       const float* __restrict__ type0,
                       const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ out,
                       int batch, int seq, int n, long long vocab, float eps,
                       int step, int passes) {
  using namespace rowstream;
  constexpr int kGroup = kLanes < 32 ? 32 : kLanes;
  constexpr int kGroups = kThreads / kGroup;   // rows a pass
  __shared__ float red[kWarps];
  extern __shared__ __align__(16) float sm[];  // type0, w, b, positions
  const float* ts = sm;
  const float* ws = sm + n;
  const float* bs = sm + 2 * n;
  const float* ps = sm + 3 * n;
  const int rows = batch * seq;                // < 2^30: the launcher
  const int r0 = (int)blockIdx.x * step;
  const int r1 = min(r0 + step, rows);
  const int t_lo = r0 / batch;
  const int group = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kLanes;
  const int wl = threadIdx.x & 31;

  // lane l of each warp holds the id of its group's pass j0 + l
  long long idv = 0;
  auto load_ids = [&](int j0) {
    const int r = r0 + group + (j0 + wl) * kGroups;
    idv = j0 + wl < passes && r < r1
              ? ids[(size_t)(r % batch) * seq + r / batch] : 0;
  };
  // pass j's word row into dst, `fill` 0 past the row (a row past the
  // step or a bad id reads nothing); whether its id is in the table
  auto load_word = [&](int j, float (&dst)[kPer]) {
    const int r = r0 + group + j * kGroups;
    const long long id = __shfl_sync(kFullMask, idv, j & 31);
    const bool ok = r < r1 && id >= 0 && id < vocab;
    load_row<float, kLanes, kPer, true>(word + (ok ? id : 0) * n,
                                        ok ? n : 0, lane, dst, 0.0f);
    return ok;
  };
  load_ids(0);
  // the shared rows, in flight while the ids and first word rows load
  {
    const int n4 = n / 4;
    const int total = (3 + (r1 - 1) / batch - t_lo + 1) * n4;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int s = i / n4, c = 4 * (i - s * n4);
      const float* src = s == 0 ? type0 : s == 1 ? w : s == 2 ? b
                         : position + (size_t)(t_lo + s - 3) * n;
      cp_async16(sm + (size_t)s * n + c, src + c);
    }
  }
  float v[kPer];
  bool ok = load_word(0, v);
  cp_async_wait();
  __syncthreads();

  for (int j = 0; j < passes; ++j) {
    const int r = r0 + group + j * kGroups;
    const bool active = r < r1;
    // the next pass's word row, loaded while this one is normalized
    if (((j + 1) & 31) == 0) load_ids(j + 1);
    float nx[kPer];
    const bool ok_next = load_word(j + 1, nx);
    const int t = active ? r / batch : t_lo;
    // (word + position) + type0, a chunk at a time from shared memory (a
    // slot past the row, or a bad id's, stays 0 as in "rowpass")
    const float* pt = ps + (size_t)(t - t_lo) * n;
#pragma unroll
    for (int c = 0; c < kPer / kChunk; ++c) {
      const int e = (lane + kLanes * c) * kChunk;
      if (ok && e < n) {
        float p8[kChunk], t8[kChunk];
        load8<float>(pt + e, p8);
        load8<float>(ts + e, t8);
        float* x = v + c * kChunk;
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          x[i] = __fadd_rn(__fadd_rn(x[i], p8[i]), t8[i]);
      }
    }
    float mean, rstd;
    row_stats<kLanes, kPer, true>(v, n, lane, eps, red, mean, rstd);
    if (active) {
      T* dst = out + ((size_t)(r % batch) * seq + t) * n;
#pragma unroll
      for (int c = 0; c < kPer / kChunk; ++c) {
        const int e = (lane + kLanes * c) * kChunk;
        if (e < n) {
          float wv[kChunk], bv[kChunk];
          load8<float>(ws + e, wv);
          load8<float>(bs + e, bv);
          float* x = v + c * kChunk;
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            x[i] = ok ? fmaf((x[i] - mean) * rstd, wv[i], bv[i]) : NAN;
          store8<T>(dst + e, x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = nx[i];
    ok = ok_next;
  }
}

// the instantiation for n (the "rowpass" kernel's layout at n), as a
// function pointer for the occupancy query
template <typename T>
const void* staged_fn(int n) {
  if (n <= 256) return (const void*)embed_layernorm_staged<T, 32, 8>;
  if (n <= 512) return (const void*)embed_layernorm_staged<T, 32, 16>;
  if (n <= 1024) return (const void*)embed_layernorm_staged<T, 32, 32>;
  return (const void*)embed_layernorm_staged<T, 128, 32>;
}

template <typename T, int kLanes, int kPer>
cudaError_t staged_width(const Args& a, int grid, int step, int passes,
                         int bytes, cudaStream_t st) {
  const void* fn = (const void*)embed_layernorm_staged<T, kLanes, kPer>;
  cudaError_t err = rowstream::check_grid(fn, kThreads, bytes, grid);
  if (err != cudaSuccess) return err;
  embed_layernorm_staged<T, kLanes, kPer><<<grid, kThreads, bytes, st>>>(
      a.ids, a.word, a.position, a.type0, a.w, a.b, (T*)a.out,
      (int)(a.rows / a.seq), a.seq, a.n, a.vocab, a.eps, step, passes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t staged(const Args& a, int grid, int step, int passes, int bytes,
                   cudaStream_t st) {
  if (a.n <= 256)
    return staged_width<T, 32, 8>(a, grid, step, passes, bytes, st);
  if (a.n <= 512)
    return staged_width<T, 32, 16>(a, grid, step, passes, bytes, st);
  if (a.n <= 1024)
    return staged_width<T, 32, 32>(a, grid, step, passes, bytes, st);
  return staged_width<T, 128, 32>(a, grid, step, passes, bytes, st);
}

// rows a pass of a block
int pass_rows(int n) { return n <= 1024 ? 8 : 2; }

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

// The "staged" kernel's limit at this width and dtype: blocks an SM holds
// at `smem_bytes` of dynamic shared memory (>= 0), or minus a CUDA error.
extern "C" int embed_layernorm_staged_resident(int n, int dtype,
                                               int smem_bytes) {
  if (n < 8 || n > 4096 || n % 8 != 0 || dtype < 0 || dtype > 2 ||
      smem_bytes < 0 || smem_bytes > rowstream::kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  const void* fn = dtype == rowpass::kBF16 ? staged_fn<__nv_bfloat16>(n)
                   : dtype == rowpass::kF16 ? staged_fn<__half>(n)
                                            : staged_fn<float>(n);
  int blocks = 0;
  const cudaError_t err =
      rowstream::resident_blocks(fn, rowpass::kThreads, smem_bytes, &blocks);
  return err != cudaSuccess ? -(int)err : blocks;
}

// The "staged" kernel on the plan of ops/encoder_fused.py:row_plan: `grid`
// blocks of `step` position-major rows in `passes` passes (passes x the
// rows a pass >= step), as many blocks as the steps the B T rows fill and
// at most as many as the card holds at once at these bytes; `smem_bytes`
// the layout's total for the positions a step touches (recomputed here: a
// mismatch is refused). n % 8 == 0, every pointer 16-byte aligned, fewer
// than 2^30 rows. Arguments otherwise as embed_layernorm_launch's.
extern "C" int embed_layernorm_staged_launch(
    const void* ids, const void* word, const void* position,
    const void* type0, const void* w, const void* b, void* out, int B, int T,
    int n, long long vocab, int dtype, float eps, int grid, int step,
    int passes, int smem_bytes, void* stream) {
  const long long rows = (long long)B * T;
  if (B < 1 || T < 1 || rows >= (1LL << 30) || n < 8 || n > 4096 ||
      n % 8 != 0 || vocab < 1 || dtype < 0 || dtype > 2 || step < 1 ||
      passes < 1 || grid < 1 || (long long)passes * pass_rows(n) < step ||
      (rows + step - 1) / step != grid)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(word) && aligned16(position) && aligned16(type0) &&
        aligned16(w) && aligned16(b) && aligned16(out)))
    return (int)cudaErrorInvalidValue;
  if (staged_bytes(n, staged_positions(step, B, T)) != (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  const Args a{(const long long*)ids, (const float*)word,
               (const float*)position, (const float*)type0, (const float*)w,
               (const float*)b, out, rows, vocab, T, n, eps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)staged<__nv_bfloat16>(a, grid, step, passes, smem_bytes,
                                        st);
    case rowpass::kF16:
      return (int)staged<__half>(a, grid, step, passes, smem_bytes, st);
    default:
      return (int)staged<float>(a, grid, step, passes, smem_bytes, st);
  }
}
