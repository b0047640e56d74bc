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
// Two kernels, the same lane layout and order of operations, so the same
// bits (ops/encoder_fused.py's variants):
//   "rowpass" (add_layernorm_kernel), the default: a warp a row, one row
//       and out; w and b loaded from device memory after the two
//       reductions. Any n up to 4,096: 16-byte vectors where n % 8 == 0
//       and the rows are aligned, single values elsewhere.
//   "staged" (add_layernorm_staged), for n % 8 == 0 and 16-byte aligned
//       pointers, on the launch plan of ops/encoder_fused.py:row_plan: one
//       bulk copy a block brings w and b into shared memory on an mbarrier
//       (csrc/row_stream.cuh), in flight beside the first rows, so no
//       global load remains after the reductions; a grid of at most the
//       blocks the card holds at once, each block `passes` passes of
//       consecutive rows, a warp a row (a four-warp group above n =
//       1,024), written out with 16-byte stores.
// What bounds them, measured on the card: bytes at the long shapes
// (1.2-1.3x the bound at 64 x 512 for both); at nw's 64 x 32 (12 MB) the
// fixed costs of a launch and of a block's start. "rowpass" (62
// registers, four blocks an SM, one wave at 64 x 32) never waited on its
// w / b loads as the staged design supposed, and the staged kernel's
// set-up (the barrier, the w / b copy) adds to a block's start: it is no
// faster, so "rowpass" stays the default. A ring of bulk-copied rows in
// shared memory, tried beside it, moved nothing either and was dropped.

#include "row_pass.cuh"
#include "row_stream.cuh"

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

// ---- "staged"

// dynamic shared memory of the staged kernel: w and b (fp32).
// ops/encoder_fused.py:staged_bytes computes the same.
size_t staged_bytes(int n) { return (size_t)8 * n; }

// Block i takes the step of rows from i x the step's rows: `passes` x
// (its rows a pass: a row a warp, or a row a four-warp group above n =
// 1,024), consecutive.
template <typename T, int kLanes, int kPer>
__global__ void __launch_bounds__(kThreads)
add_layernorm_staged(const T* __restrict__ hidden, const T* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ out,
                     int rows, int n, float eps, int passes) {
  using namespace rowstream;
  // a row group: a warp, or the kLanes threads of a row wider than a warp
  constexpr int kGroup = kLanes < 32 ? 32 : kLanes;
  constexpr int kGroups = kThreads / kGroup;  // rows a pass
  __shared__ float red[kWarps];
  __shared__ uint64_t wb_bar;
  extern __shared__ __align__(16) float ws[];   // w, then b
  float* bs = ws + n;
  const int group = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kLanes;
  // 32-bit rows (the launch function refuses 2^30 rows or more)
  const int first = (int)blockIdx.x * passes * kGroups + group;

  // pass j into v: the add, rounded to T
  float v[kPer];
  auto load_pass = [&](int j) {
    const int r = first + j * kGroups;
    const bool active = r < rows;
    const T* hs = hidden + (size_t)r * n;
    const T* xs = x + (size_t)r * n;
#pragma unroll
    for (int c = 0; c < kPer / kChunk; ++c) {
      const int e = (lane + kLanes * c) * kChunk;
      if (active && e < n) {
        float u[kChunk];
        load8<T>(hs + e, v + c * kChunk);
        load8<T>(xs + e, u);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          v[c * kChunk + i] = round_to<T>(__fadd_rn(v[c * kChunk + i], u[i]));
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[c * kChunk + i] = 0.0f;
      }
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&wb_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(&wb_bar, (uint32_t)(n * 8));
    bulk_copy(ws, w, (uint32_t)(n * 4), &wb_bar);
    bulk_copy(bs, b, (uint32_t)(n * 4), &wb_bar);
  }
  // the first rows' loads, while thread 0 sets up the copy: no thread
  // waits on the barrier before the block meets
  load_pass(0);
  __syncthreads();

  for (int j = 0; j < passes; ++j) {
    const int r = first + j * kGroups;
    const bool active = r < rows;
    if (j > 0) load_pass(j);
    // LayerNorm as row_pass.cuh:layer_norm computes it, w and b from
    // shared memory
    float mean, rstd;
    row_stats<kLanes, kPer, true>(v, n, lane, eps, red, mean, rstd);
    if (j == 0) mbar_wait(&wb_bar, 0);   // w and b
    if (active) {
#pragma unroll
      for (int c = 0; c < kPer / kChunk; ++c) {
        const int e = (lane + kLanes * c) * kChunk;
        if (e < n) {
          float wv[kChunk], bv[kChunk];
          load8<float>(ws + e, wv);
          load8<float>(bs + e, bv);
#pragma unroll
          for (int i = 0; i < kChunk; ++i)
            v[c * kChunk + i] =
                fmaf((v[c * kChunk + i] - mean) * rstd, wv[i], bv[i]);
          store8<T>(out + (size_t)r * n + e, v + c * kChunk);
        }
      }
    }
  }
}

template <typename T, int kLanes, int kPer>
cudaError_t staged_width(const void* hidden, const void* x, const float* w,
                         const float* b, void* out, long long rows, int n,
                         float eps, int grid, int passes, int bytes,
                         cudaStream_t st) {
  const void* fn = (const void*)add_layernorm_staged<T, kLanes, kPer>;
  cudaError_t err = rowstream::check_grid(fn, kThreads, bytes, grid);
  if (err != cudaSuccess) return err;
  add_layernorm_staged<T, kLanes, kPer><<<grid, kThreads, bytes, st>>>(
      (const T*)hidden, (const T*)x, w, b, (T*)out, (int)rows, n, eps,
      passes);
  return cudaGetLastError();
}

// the instantiation for n (the "rowpass" kernel's layout at n), as a
// function pointer for the occupancy query
template <typename T>
const void* staged_fn(int n) {
  if (n <= 256) return (const void*)add_layernorm_staged<T, 32, 8>;
  if (n <= 512) return (const void*)add_layernorm_staged<T, 32, 16>;
  if (n <= 1024) return (const void*)add_layernorm_staged<T, 32, 32>;
  return (const void*)add_layernorm_staged<T, 128, 32>;
}

template <typename T>
cudaError_t staged(const void* hidden, const void* x, const float* w,
                   const float* b, void* out, long long rows, int n,
                   float eps, int grid, int passes, int bytes,
                   cudaStream_t st) {
  if (n <= 256)
    return staged_width<T, 32, 8>(hidden, x, w, b, out, rows, n, eps, grid,
                                  passes, bytes, st);
  if (n <= 512)
    return staged_width<T, 32, 16>(hidden, x, w, b, out, rows, n, eps, grid,
                                   passes, bytes, st);
  if (n <= 1024)
    return staged_width<T, 32, 32>(hidden, x, w, b, out, rows, n, eps, grid,
                                   passes, bytes, st);
  return staged_width<T, 128, 32>(hidden, x, w, b, out, rows, n, eps, grid,
                                  passes, bytes, st);
}

// rows a pass of a block
int pass_rows(int n) { return n <= 1024 ? 8 : 2; }

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

// The "staged" kernel's limit at this width and dtype: blocks an SM holds
// at `smem_bytes` of dynamic shared memory (>= 0), or minus a CUDA error.
extern "C" int add_layernorm_staged_resident(int n, int dtype,
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
// blocks of `passes` passes each, as many blocks as the steps the rows
// fill and at most as many as the card holds at once at these bytes;
// `smem_bytes` the layout's total (recomputed here: a mismatch is
// refused). The weights must take a bulk copy: n % 8 == 0, every pointer
// 16-byte aligned; fewer than 2^30 rows. Arguments otherwise as
// add_layernorm_launch's.
extern "C" int add_layernorm_staged_launch(const void* hidden, const void* x,
                                           const void* w, const void* b,
                                           void* out, long long rows, int n,
                                           int dtype, float eps, int grid,
                                           int passes, int smem_bytes,
                                           void* stream) {
  if (rows < 0 || rows >= (1LL << 30) || n < 8 || n > 4096 || n % 8 != 0 ||
      dtype < 0 || dtype > 2 || passes < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const long long step_rows = (long long)passes * pass_rows(n);
  if ((rows + step_rows - 1) / step_rows != grid && rows > 0)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(hidden) && aligned16(x) && aligned16(w) && aligned16(b) &&
        aligned16(out)))
    return (int)cudaErrorInvalidValue;
  if (staged_bytes(n) != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case rowpass::kBF16:
      return (int)staged<__nv_bfloat16>(hidden, x, wf, bf, out, rows, n, eps,
                                        grid, passes, smem_bytes, st);
    case rowpass::kF16:
      return (int)staged<__half>(hidden, x, wf, bf, out, rows, n, eps, grid,
                                 passes, smem_bytes, st);
    default:
      return (int)staged<float>(hidden, x, wf, bf, out, rows, n, eps, grid,
                                passes, smem_bytes, st);
  }
}
