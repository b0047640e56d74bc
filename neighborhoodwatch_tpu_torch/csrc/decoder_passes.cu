// The decoder embedder's row passes (models/decoder.py, a Mistral block),
// for Hopper (sm_90a), on the encoders' row infrastructure
// (csrc/row_pass.cuh):
//
//   D1 add_rmsnorm: the residual add and the RMSNorm that follows it, in
//      one pass: s = T(hidden + x) (the add rounded to T, as the plain
//      version adds in T), written back as the new residual, and out =
//      T(s * rsqrt(mean(s^2) + eps) * w) with the mean square in fp32 and
//      w fp32. Without x (the first layer's norm) s is hidden, not
//      written. Twice a layer, and once more before the first layer.
//   D2 rope: the rotary position embedding, rotate-half convention, on the
//      first `heads` heads of each row of the fused q|k|v projection, in
//      place: with d = head_dim / 2, c, s the fp32 cos / sin of (position,
//      i) from a table the caller computes once,
//        y[i]     = T(x[i] c - x[i + d] s),
//        y[i + d] = T(x[i + d] c + x[i] s),
//      each product rounded to fp32 before the sum, as the plain version's
//      separate multiplies and add (bit for bit theirs). v's heads are
//      left alone.
//   D3 swiglu: out = T(silu(g) * u) over the output of the fused gate|up
//      projection, g the first `inter` values of a row, u the next, silu(g)
//      = g / (1 + exp(-g)) in fp32.
//
// Each is a pure function of its inputs (no atomics, one order of
// operations), so a graph replay equals the eager forward bit for bit.
// Bound on this card: bytes, a few operations a value. At e5-mistral's
// 64 x 512 rows in bf16 (hidden 4,096, 32 + 8 heads of 128 rotated,
// intermediate 14,336): D1 1.07 GB (0.32 ms at 3.35 TB/s), D2 0.67 GB,
// D3 2.82 GB a launch.
//
// Layouts: D1 as E2 (csrc/add_layernorm.cu) lays out a row: a warp a row
// up to 1,024 values, four warps above, 16-byte chunks where n % 8 == 0 and
// the pointers are aligned. D2 and D3: a thread an 8-value chunk (16-byte
// loads and stores where the widths are multiples of 8 and the pointers
// and row strides 16-byte aligned, single values elsewhere), a flat grid
// over the rows' chunks.

#include "row_pass.cuh"

namespace {

using namespace rowpass;

// ---- D1

template <typename T, int kLanes, int kPer, bool kVec>
__global__ void __launch_bounds__(kThreads)
add_rmsnorm_kernel(const T* __restrict__ hidden, const T* __restrict__ x,
                   const float* __restrict__ w, T* __restrict__ sum_out,
                   T* __restrict__ out, long long rows, int n, float eps) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % kLanes;
  const long long row =
      (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool active = row < rows;
  if (kLanes == 32 && !active) return;  // other widths meet at barriers
  const long long off = active ? row * n : 0;
  const int m = active ? n : 0;
  float v[kPer];
  load_row<T, kLanes, kPer, kVec>(hidden + off, m, lane, v, 0.0f);
  if (x != nullptr) {
    float u[kPer];
    load_row<T, kLanes, kPer, kVec>(x + off, m, lane, u, 0.0f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = round_to<T>(__fadd_rn(v[i], u[i]));
    if (active) store_row<T, kLanes, kPer, kVec>(sum_out + off, n, lane, v);
  }
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (slot<kLanes, kVec>(lane, i) < n) q = fmaf(v[i], v[i], q);
  const float ms = __fdiv_rn(group_sum<kLanes>(q, red), (float)n);
  const float r = rsqrtf(ms + eps);
  float wv[kPer];
  load_row<float, kLanes, kPer, kVec>(w, m, lane, wv, 0.0f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = __fmul_rn(__fmul_rn(v[i], r), wv[i]);
  if (active) store_row<T, kLanes, kPer, kVec>(out + off, n, lane, v);
}

template <typename T, int kLanes, int kPer, bool kVec>
cudaError_t rms_width(const void* hidden, const void* x, const float* w,
                      void* sum_out, void* out, long long rows, int n,
                      float eps, cudaStream_t st) {
  const long long per_block = kThreads / kLanes;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  add_rmsnorm_kernel<T, kLanes, kPer, kVec><<<(unsigned)blocks, kThreads, 0,
                                               st>>>(
      (const T*)hidden, (const T*)x, w, (T*)sum_out, (T*)out, rows, n, eps);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t rms_layout(const void* hidden, const void* x, const float* w,
                       void* sum_out, void* out, long long rows, int n,
                       float eps, cudaStream_t st) {
  if (n <= 256)
    return rms_width<T, 32, 8, kVec>(hidden, x, w, sum_out, out, rows, n, eps,
                                     st);
  if (n <= 512)
    return rms_width<T, 32, 16, kVec>(hidden, x, w, sum_out, out, rows, n,
                                      eps, st);
  if (n <= 1024)
    return rms_width<T, 32, 32, kVec>(hidden, x, w, sum_out, out, rows, n,
                                      eps, st);
  return rms_width<T, 128, 32, kVec>(hidden, x, w, sum_out, out, rows, n, eps,
                                     st);
}

template <typename T>
cudaError_t rms(bool vec, const void* hidden, const void* x, const float* w,
                void* sum_out, void* out, long long rows, int n, float eps,
                cudaStream_t st) {
  return vec ? rms_layout<T, true>(hidden, x, w, sum_out, out, rows, n, eps,
                                   st)
             : rms_layout<T, false>(hidden, x, w, sum_out, out, rows, n, eps,
                                    st);
}

// ---- D2

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
rope_kernel(T* __restrict__ x, long long rows, int seq, long long stride,
            int heads, int half, const float* __restrict__ cs,
            const float* __restrict__ sn) {
  const int chunks = half / kPer;
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= rows * heads * chunks) return;
  const int c = (int)(item % chunks);
  const long long rh = item / chunks;
  const int h = (int)(rh % heads);
  const long long row = rh / heads;
  const int pos = (int)(row % seq);
  T* p = x + row * stride + (long long)h * 2 * half + c * kPer;
  const float* cp = cs + (long long)pos * half + c * kPer;
  const float* sp = sn + (long long)pos * half + c * kPer;
  float a[kPer], b[kPer], cv[kPer], sv[kPer];
  if constexpr (kPer == kChunk) {
    load8<T>(p, a);
    load8<T>(p + half, b);
    load8<float>(cp, cv);
    load8<float>(sp, sv);
  } else {
    a[0] = to_f<T>(p[0]);
    b[0] = to_f<T>(p[half]);
    cv[0] = cp[0];
    sv[0] = sp[0];
  }
  float y1[kPer], y2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    y1[i] = __fsub_rn(__fmul_rn(a[i], cv[i]), __fmul_rn(b[i], sv[i]));
    y2[i] = __fadd_rn(__fmul_rn(b[i], cv[i]), __fmul_rn(a[i], sv[i]));
  }
  if constexpr (kPer == kChunk) {
    store8<T>(p, y1);
    store8<T>(p + half, y2);
  } else {
    p[0] = from_f<T>(y1[0]);
    p[half] = from_f<T>(y2[0]);
  }
}

template <typename T>
cudaError_t rope(bool vec, void* x, long long rows, int seq, long long stride,
                 int heads, int half, const float* cs, const float* sn,
                 cudaStream_t st) {
  const int per = vec ? kChunk : 1;
  const long long items = rows * heads * (half / per);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec)
    rope_kernel<T, kChunk><<<(unsigned)blocks, kThreads, 0, st>>>(
        (T*)x, rows, seq, stride, heads, half, cs, sn);
  else
    rope_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, st>>>(
        (T*)x, rows, seq, stride, heads, half, cs, sn);
  return cudaGetLastError();
}

// ---- D3

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ gu, T* __restrict__ out, long long rows,
              int inter) {
  const int chunks = inter / kPer;
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= rows * chunks) return;
  const long long row = item / chunks;
  const int c = (int)(item % chunks);
  const T* g = gu + row * 2 * inter + c * kPer;
  float a[kPer], b[kPer];
  if constexpr (kPer == kChunk) {
    load8<T>(g, a);
    load8<T>(g + inter, b);
  } else {
    a[0] = to_f<T>(g[0]);
    b[0] = to_f<T>(g[inter]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float silu = __fdiv_rn(a[i], __fadd_rn(1.0f, expf(-a[i])));
    a[i] = __fmul_rn(silu, b[i]);
  }
  T* o = out + row * inter + c * kPer;
  if constexpr (kPer == kChunk)
    store8<T>(o, a);
  else
    o[0] = from_f<T>(a[0]);
}

template <typename T>
cudaError_t swiglu(bool vec, const void* gu, void* out, long long rows,
                   int inter, cudaStream_t st) {
  const int per = vec ? kChunk : 1;
  const long long items = rows * (inter / per);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec)
    swiglu_kernel<T, kChunk><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)gu, (T*)out, rows, inter);
  else
    swiglu_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)gu, (T*)out, rows, inter);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// hidden, out, sum_out: (rows, n) contiguous, x too or null (no add, and
// sum_out unused); `dtype` 0 bf16, 1 fp32, 2 fp16; w: (n,) fp32; 1 <= n <=
// 4096. Returns a CUDA error code, 0 on success.
extern "C" int decoder_passes_add_rmsnorm(const void* hidden, const void* x,
                                          const void* w, void* sum_out,
                                          void* out, long long rows, int n,
                                          int dtype, float eps,
                                          void* stream) {
  if (rows < 0 || n < 1 || n > 4096 || dtype < 0 || dtype > 2 ||
      (x != nullptr && sum_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bool vec = n % kChunk == 0 && aligned16(hidden) && aligned16(w) &&
                   aligned16(out) &&
                   (x == nullptr || (aligned16(x) && aligned16(sum_out)));
  const float* wf = (const float*)w;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return (int)rms<__nv_bfloat16>(vec, hidden, x, wf, sum_out, out, rows,
                                     n, eps, st);
    case kF16:
      return (int)rms<__half>(vec, hidden, x, wf, sum_out, out, rows, n, eps,
                              st);
    default:
      return (int)rms<float>(vec, hidden, x, wf, sum_out, out, rows, n, eps,
                             st);
  }
}

// x: rows of `stride` elements (row r at position r % seq), its first
// `heads` heads of head_dim values rotated in place; cos, sin: (>= seq,
// head_dim / 2) fp32 contiguous; head_dim even, heads * head_dim <= stride.
extern "C" int decoder_passes_rope(void* x, long long rows, int seq,
                                   long long stride, int heads, int head_dim,
                                   const void* cos, const void* sin,
                                   int dtype, void* stream) {
  if (rows < 0 || seq < 1 || heads < 1 || head_dim < 2 || head_dim % 2 ||
      (long long)heads * head_dim > stride || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int half = head_dim / 2;
  const int elem = dtype == kF32 ? 4 : 2;
  const bool vec = half % kChunk == 0 && aligned16(x) &&
                   (stride * elem) % 16 == 0 && (half * elem) % 16 == 0 &&
                   aligned16(cos) && aligned16(sin);
  const float* c = (const float*)cos;
  const float* s = (const float*)sin;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return (int)rope<__nv_bfloat16>(vec, x, rows, seq, stride, heads, half,
                                      c, s, st);
    case kF16:
      return (int)rope<__half>(vec, x, rows, seq, stride, heads, half, c, s,
                               st);
    default:
      return (int)rope<float>(vec, x, rows, seq, stride, heads, half, c, s,
                              st);
  }
}

// gu: (rows, 2 inter) contiguous, out: (rows, inter) contiguous.
extern "C" int decoder_passes_swiglu(const void* gu, void* out,
                                     long long rows, int inter, int dtype,
                                     void* stream) {
  if (rows < 0 || inter < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int elem = dtype == kF32 ? 4 : 2;
  const bool vec = inter % kChunk == 0 && (inter * elem) % 16 == 0 &&
                   aligned16(gu) && aligned16(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return (int)swiglu<__nv_bfloat16>(vec, gu, out, rows, inter, st);
    case kF16:
      return (int)swiglu<__half>(vec, gu, out, rows, inter, st);
    default:
      return (int)swiglu<float>(vec, gu, out, rows, inter, st);
  }
}
