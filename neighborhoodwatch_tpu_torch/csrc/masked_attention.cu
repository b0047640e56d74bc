// Masked softmax attention with segment ids for the BERT encoders, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel behind the JAX package's opt-in fused attention
// (neighborhoodwatch_tpu/models/bert_flax.py:102-115, attention_impl =
// "flash"): JAX's library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention with segment ids, forward
// only (nothing in the repository takes a gradient).
//
// What it computes, per batch row b, head h and query i (T positions, head
// dim D):
//   s[j] = (q[i] . k[j]) * scale + (seg[i] == seg[j] ? 0 : MASK),
//          q . k from the operands' dtype with fp32 accumulation, MASK =
//          -0.7 * FLT_MAX (the library's DEFAULT_MASK_VALUE), added, not
//          substituted, as the library does;
//   out[i] = sum_j p[j] v[j] / sum_j p[j], p = exp(s - max s) in fp32,
//          each p cast to v's dtype before its product with v, the sum in
//          fp32 and the output in the operands' dtype.
// q, k, v are read in place as (B, T, H, D) with the strides they come
// with (the encoder's nn.Linear outputs viewed per head, never transposed
// or copied); the output is written (B, T, H, D) contiguous, the layout the
// output projection reads. seg is (B, T) int32 or uint8.
//
// Schedule (a first version: right before fast). One block of 4 warps owns
// 64 queries of one (b, h), 16 per warp, and walks the keys in 64-key tiles
// through a 2-stage cp.async ring of K and V tiles, keeping a running max
// and sum per query row in fp32 (the online softmax): o is rescaled by
// exp(m_old - m_new) whenever the max grows. The bf16 instantiation takes
// both products on the tensor cores (mma.sync m16n8k16 from ldmatrix
// fragments of XOR-swizzled tiles, P fed back from the score accumulators
// as A fragments); the fp32 instantiation takes them in SIMT FMAs in the
// same register layout (its p passes through shared memory on the way to
// the second product), so masking, the online softmax and the epilogue
// are one piece of code for both.
//
// Masking stays finite, as on the TPU: a key tile that a row sees nothing
// of gives p = exp(0) = 1 until a real maximum arrives, and then the
// rescale exp((MASK - m) * log2 e) underflows to exactly 0 (the product
// overflows to -inf, whose exp2 is 0; no inf - inf is ever formed), so o
// and l restart from exactly 0. The same argument makes skipping tiles
// exact: a key tile in which no query of the block can see any key is
// skipped, which changes no bit of the result (every row sees its own key,
// so each row keeps at least one visible tile). Segment sets are compared
// as 32-bit sets of (seg & 31), so the skip is conservative for ids beyond
// 0..31 and exact for the encoders' 0/1 masks.
//
// Bound on this card: 4*B*H*T^2*D FLOP (two products, dense) against
// 4*B*T*H*D*2 bytes of bf16 q, k, v, out: at e5-large's shapes (D = 64,
// 131,072 tokens per forward, T = 512) 2.75e11 FLOP (0.28 ms at 989
// TFLOP/s) against 1.07 GB (0.32 ms at 3.35 TB/s), so the function is
// bound by bytes at T = 512 and below, and exp (one per score, on the SFU)
// comes next. The design reads every operand byte once per query tile (K
// and V are re-read from L2 by the T/64 query tiles of a head) and keeps
// scores and probabilities in registers. wgmma, TMA and a warp-specialized
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kTile = 64;               // query rows per block = keys per step
constexpr int kWarps = 4;               // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 8192;           // segment ids of a row live in smem
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* seg;
  void* out;
  int T, H, seg_bytes;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory tile of 64 rows x D: bf16 rows in 16-byte chunks, chunk c
// of row r stored at c ^ (r & 7), so the 8 rows an ldmatrix reads hit 8
// different bank groups; fp32 rows padded by 16 bytes for the SIMT reads.
template <typename T, int D>
struct Layout;

template <int D>
struct Layout<__nv_bfloat16, D> {
  static constexpr int kChunks = D * 2 / 16;
  static constexpr int kPitch = D;
  __device__ static int offset(int r, int c) {
    return r * kPitch + ((c ^ (r & 7)) * 8);
  }
};

template <int D>
struct Layout<float, D> {
  static constexpr int kChunks = D * 4 / 16;
  static constexpr int kPitch = D + 4;
  __device__ static int offset(int r, int c) { return r * kPitch + c * 4; }
};

// 64 rows from `src` (row stride `st` elements) starting at `row0`, in
// 16-byte cp.async chunks, consecutive threads on consecutive chunks.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int row0) {
  using L = Layout<T, D>;
  constexpr int kPerThread = kTile * L::kChunks / kThreads;
  constexpr int kElems = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    cp_async16(dst + L::offset(r, c), src + (row0 + r) * st + c * kElems);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two products of a step in the register layout of mma.sync's m16n8
// accumulator: thread (g = lane / 4, t = lane % 4) of warp w holds rows
// 16w + g and 16w + g + 8 of the query tile, columns 8n + 2t and 8n + 2t + 1
// of each 8-column tile n: s[n][0..1] row g, s[n][2..3] row g + 8.
template <typename T, int D>
struct Products;

template <int D>
struct Products<__nv_bfloat16, D> {
  using L = Layout<__nv_bfloat16, D>;
  static constexpr int kScratch = 0;  // shared floats per block
  uint32_t qa[D / 16][4];  // the warp's 16 query rows as A fragments

  __device__ void load_q(const __nv_bfloat16* sq, float*, int warp,
                         int lane) {
    const int row = warp * 16 + (lane % 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], sq + L::offset(row, 2 * kk + lane / 16));
  }

  // s = Q K^T: K rows (keys) are the col-major B operand as stored.
  __device__ void scores(const __nv_bfloat16* sk, int lane,
                         float (&s)[8][4]) const {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int key = np * 16 + (lane / 16) * 8 + (lane % 8);
        uint32_t b[4];
        ldmatrix_x4(b, sk + L::offset(key, 2 * kk + (lane / 8) % 2));
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
  }

  // o += bf16(p) V: two 8-key accumulator tiles are one 16-key A fragment;
  // V rows (keys) are transposed into B fragments by ldmatrix.trans.
  __device__ void accumulate(const float (&p)[8][4],
                             const __nv_bfloat16* sv, int lane,
                             float (&o)[D / 8][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + L::offset(key, 2 * np + lane / 16));
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
};

template <int D>
struct Products<float, D> {
  using L = Layout<float, D>;
  static constexpr int kPPitch = kTile + 4;  // a row of p in shared memory
  static constexpr int kScratch = kWarps * 16 * kPPitch;
  const float* q0;  // the thread's two query rows in shared memory
  const float* q1;
  float* sp;        // the warp's 16 rows of p

  __device__ void load_q(const float* sq, float* scratch, int warp,
                         int lane) {
    q0 = sq + (warp * 16 + lane / 4) * L::kPitch;
    q1 = q0 + 8 * L::kPitch;
    sp = scratch + warp * 16 * kPPitch;
  }

  __device__ void scores(const float* sk, int lane, float (&s)[8][4]) const {
    const int t = lane % 4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
      const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 b = *reinterpret_cast<const float4*>(
              sk + (8 * n + 2 * t + e) * L::kPitch + d);
          float x = s[n][e], y = s[n][2 + e];
          x = fmaf(a0.x, b.x, x); x = fmaf(a0.y, b.y, x);
          x = fmaf(a0.z, b.z, x); x = fmaf(a0.w, b.w, x);
          y = fmaf(a1.x, b.x, y); y = fmaf(a1.y, b.y, y);
          y = fmaf(a1.z, b.z, y); y = fmaf(a1.w, b.w, y);
          s[n][e] = x;
          s[n][2 + e] = y;
        }
      }
    }
  }

  // o += p V in key order: the warp's p goes through shared memory (a
  // loop over keys in registers would need every p of the row, and the
  // fully unrolled shuffle form spilled at D = 128), V rows read as float2
  // pairs. The block's barrier at the end of a step keeps the next step's
  // p from overwriting this one's before every lane has read it.
  __device__ void accumulate(const float (&p)[8][4], const float* sv,
                             int lane, float (&o)[D / 8][4]) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sp + (g + 8 * r) * kPPitch + 8 * n +
                                   2 * t) =
            make_float2(p[n][2 * r], p[n][2 * r + 1]);
    __syncwarp();
    const float* p0 = sp + g * kPPitch;
    const float* p1 = p0 + 8 * kPPitch;
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      const float a = p0[key], b = p1[key];
      const float* vrow = sv + key * L::kPitch + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(vrow + 8 * j);
        o[j][0] = fmaf(a, w.x, o[j][0]);
        o[j][1] = fmaf(a, w.y, o[j][1]);
        o[j][2] = fmaf(b, w.x, o[j][2]);
        o[j][3] = fmaf(b, w.y, o[j][3]);
      }
    }
  }
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    masked_attention_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int kTileElems = kTile * L::kPitch;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + kTileElems;  // [stage 0, 1][K, V][64 x pitch]
  float* scratch = reinterpret_cast<float*>(skv + 4 * kTileElems);
  int* sseg = reinterpret_cast<int*>(scratch + Products<T, D>::kScratch);
  int* stiles = sseg + p.T;  // the key tiles this block visits, in order
  __shared__ int n_tiles_sh;

  const int q_start = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T, D>(sq, qb, p.q_st, q_start);
  cp_async_commit();
  for (int i = threadIdx.x; i < p.T; i += kThreads)
    sseg[i] = p.seg_bytes == 1
                  ? static_cast<const uint8_t*>(p.seg)[(long long)b * p.T + i]
                  : static_cast<const int*>(p.seg)[(long long)b * p.T + i];
  __syncthreads();
  if (warp == 0) {
    unsigned qbits = (1u << (sseg[q_start + lane] & 31)) |
                     (1u << (sseg[q_start + 32 + lane] & 31));
    qbits = __reduce_or_sync(0xffffffffu, qbits);
    int n = 0;
    for (int j0 = 0; j0 < p.T; j0 += kTile) {
      unsigned kbits = (1u << (sseg[j0 + lane] & 31)) |
                       (1u << (sseg[j0 + 32 + lane] & 31));
      kbits = __reduce_or_sync(0xffffffffu, kbits);
      if (kbits & qbits) {
        if (lane == 0) stiles[n] = j0;
        ++n;
      }
    }
    if (lane == 0) n_tiles_sh = n;
  }
  __syncthreads();
  const int n_tiles = n_tiles_sh;

  auto load_stage = [&](int i) {
    T* st = skv + (i & 1) * 2 * kTileElems;
    load_tile<T, D>(st, kb, p.k_st, stiles[i]);
    load_tile<T, D>(st + kTileElems, vb, p.v_st, stiles[i]);
    cp_async_commit();
  };
  load_stage(0);

  const int g = lane / 4, t = lane % 4;
  const int row0 = q_start + warp * 16 + g;  // rows row0 and row0 + 8
  const int seg_q[2] = {sseg[row0], sseg[row0 + 8]};
  Products<T, D> prod;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) prod.load_q(sq, scratch, warp, lane);
    const T* sk = skv + (i & 1) * 2 * kTileElems;
    const int* kseg = sseg + stiles[i];
    float s[8][4];
    prod.scores(sk, lane, s);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = kseg[8 * n + 2 * t + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = s[n][2 * r + e] * p.scale;
          x = x + (ks == seg_q[r] ? 0.f : kMaskValue);
          s[n][2 * r + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f((s[n][e] - m[e / 2]) * kLog2e);
        s[n][e] = pv;
        l[e / 2] += pv;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    prod.accumulate(s, skv + (i & 1) * 2 * kTileElems + kTileElems, lane, o);
    __syncthreads();  // the next load_stage() overwrites this stage
  }

  T* ob = static_cast<T*>(p.out) + ((long long)b * p.T * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;  // >= 1: every row sees its own key
    T* orow = ob + (long long)(row0 + 8 * r) * p.H * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j, o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = 5 * kTile * Layout<T, D>::kPitch * sizeof(T) +
                      Products<T, D>::kScratch * sizeof(float) +
                      (p.T + p.T / kTile) * sizeof(int);
  auto kernel = masked_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.T / kTile, p.H, B), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, H, D) with element strides (batch, seq, head) and unit
// stride along D; out: (B, T, H, D) contiguous; seg: (B, T) contiguous,
// seg_bytes 1 (uint8) or 4 (int32); dtype 0 = bf16, 1 = fp32. Returns 0, a
// CUDA error, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int masked_attention_launch(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int B, int T, int H, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, int seg_bytes,
    int dtype, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < kTile ||
      T % kTile || T > kMaxSeq || (seg_bytes != 1 && seg_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    seg,  out,  T,    H,    seg_bytes,
                 q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                 v_sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(p, B, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(p, B, st);
  if (dtype == 1 && D == 64) return launch<float, 64>(p, B, st);
  if (dtype == 1 && D == 128) return launch<float, 128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
