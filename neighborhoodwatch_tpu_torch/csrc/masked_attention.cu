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
// Two variants, chosen by shape in ops/attention_kernel.py:pick_variant.
//
// "mma" (fp32, T % 128 == 64, and rows no tensor map can describe). One
// block of 4 warps owns 64 queries of one (b, h), 16 per warp, and walks
// the keys in 64-key tiles through a 2-stage cp.async ring of K and V
// tiles, keeping a running max and sum per query row in fp32 (the online
// softmax): o is rescaled by exp(m_old - m_new) whenever the max grows.
// The bf16 and fp16 instantiations take both products on the
// tensor cores (mma.sync m16n8k16 from ldmatrix fragments of XOR-swizzled
// tiles, P fed back from the score accumulators as A fragments); the fp32
// instantiation takes them in SIMT FMAs in the same register layout (its p
// passes through shared memory on the way to the second product), so
// masking, the online softmax and the epilogue are one piece of code.
//
// "wgmma" (bf16 and fp16, D 64 or 128, T % 128 == 0 up to 8192): the
// library's own tiling, 128 queries against 128-key tiles. A persistent
// grid of one block per SM (their count prime to the query tiles of a
// head, so that a block's static stride of (b, h, query tile) items cycles
// through tiles of different lengths) of three warpgroups:
//   * a producer warp reads the item's row of segment ids (the loads of
//     four tiles in flight together), decides which key tiles some query
//     of the item sees, and keeps Q (three slots at D = 64, two at 128)
//     and K/V tiles (five or two stages) in flight by TMA through 4-D
//     tensor maps over the strided (B, T, H, D) views, 64-column boxes in
//     128-byte swizzle, behind full/empty mbarriers; each K/V slot carries
//     the tile's ids and whether they are all one id;
//   * two consumer warpgroups (setmaxnreg 224 against the producer's 56)
//     own 64 query rows each: S = Q K^T by wgmma m64n128k16 from shared
//     memory into 64 fp32 registers, the softmax in registers, then O += P
//     V by wgmma with P from those registers (the accumulator layout is the
//     A-fragment layout) and V read MN-major through the transpose-B bit.
//     One commit group holds a tile's scores, the next the previous tile's
//     P V, so the softmax of a tile runs under the P V before it; across
//     two items of several tiles the last P V and the next item's first
//     scores share a turn, and the output is written under those scores.
//     At D = 128 the two warpgroups take turns at the tensor cores (named
//     barriers), so one's softmax runs under the other's products; at D =
//     64 the softmax is twice the products and the turns measured slower.
//   * the output goes through the warpgroup's own rows of its Q slot (its
//     products are done with them) and leaves by TMA in 128-byte rows
//     (stored from registers 4 bytes at a time, as "mma" does, the output
//     took longer than all the kernel's loads).
// A key tile whose ids are all one id (the encoders' tiles away from the
// end of a text) needs no per-key compare: a row sees all of it or none,
// so its logits take one FMA into exp2 and a row that sees none takes the
// same p for every key.
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
// 0..31 and exact for the encoders' 0/1 masks. A masked logit s scale +
// MASK rounds to MASK itself wherever |s scale| < 2^103 (half an ulp of
// MASK), which the uniform-tile path relies on.
//
// Bound on this card, at e5-large's shapes (D = 64, 131,072 ragged tokens
// per forward, lengths T/2+1..T): 4*B*T*H*D*2 bytes of bf16 q, k, v, out
// (1.07 GB, 0.32 ms at 3.35 TB/s) against the products the 128-row tile
// skip leaves, so bytes bound it at T = 128, 256 and 512. Neither variant
// follows the bytes at T = 512 (PERF.md): "mma" (1.35 ms, 4.2x the bound)
// is held by its serial mma.sync-exp-mma.sync chain and re-reads K and V
// from L2 for every 64 queries; "wgmma" by its softmax, run from two
// warps a scheduler at D = 64 (one FMNMX, one FFMA, one MUFU.EX2 and one
// FADD a score on uniform tiles, twice that where ids mix), with too few
// warps to hide its latency.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <numeric>
#include <type_traits>

#include "wgmma_mainloop.cuh"

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
struct Layout {  // bf16, fp16
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

// mma.sync m16n8k16 with fp32 accumulation, and the packing of two fp32
// values into one 32-bit register of 16-bit operands, per operand type
template <typename T>
struct Mma16;

template <>
struct Mma16<__nv_bfloat16> {
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma16<__half> {
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// The two products of a step in the register layout of mma.sync's m16n8
// accumulator: thread (g = lane / 4, t = lane % 4) of warp w holds rows
// 16w + g and 16w + g + 8 of the query tile, columns 8n + 2t and 8n + 2t + 1
// of each 8-column tile n: s[n][0..1] row g, s[n][2..3] row g + 8.
template <typename T, int D>
struct Products {  // bf16, fp16: tensor cores
  using L = Layout<T, D>;
  using M = Mma16<T>;
  static constexpr int kScratch = 0;  // shared floats per block
  uint32_t qa[D / 16][4];  // the warp's 16 query rows as A fragments

  __device__ void load_q(const T* sq, float*, int warp, int lane) {
    const int row = warp * 16 + (lane % 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], sq + L::offset(row, 2 * kk + lane / 16));
  }

  // s = Q K^T: K rows (keys) are the col-major B operand as stored.
  __device__ void scores(const T* sk, int lane, float (&s)[8][4]) const {
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
        M::mma(s[2 * np], qa[kk], b[0], b[1]);
        M::mma(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
  }

  // o += T(p) V: two 8-key accumulator tiles are one 16-key A fragment;
  // V rows (keys) are transposed into B fragments by ldmatrix.trans.
  __device__ void accumulate(const float (&p)[8][4], const T* sv, int lane,
                             float (&o)[D / 8][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {M::pack(p[2 * kk][0], p[2 * kk][1]),
                             M::pack(p[2 * kk][2], p[2 * kk][3]),
                             M::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             M::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + L::offset(key, 2 * np + lane / 16));
        M::mma(o[2 * np], a, b[0], b[1]);
        M::mma(o[2 * np + 1], a, b[2], b[3]);
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

__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
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

// ---------------------------------------------------------------------------
// variant "wgmma": TMA loads, wgmma products, warp-specialized, persistent
// ---------------------------------------------------------------------------
namespace wga {

constexpr int BQ = 128;                  // queries per item (2 x 64 rows)
constexpr int BK = 128;                  // keys per tile
constexpr int BOX_COLS = 64;             // head-dim columns per TMA box
constexpr int BOX_BYTES = 128 * 128;     // a box: 128 rows x 128 bytes
constexpr int THREADS = 3 * wg::WG_THREADS;  // two consumers, one producer
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_MAX = 232448;         // 227 KB a block may use
constexpr int BAR_BYTES = 256;
constexpr int LAST = 1;                  // slot flags: the item's last tile;
constexpr int UNIFORM = 2;               // every key of the tile has one id
constexpr int TURN_BAR = 1;              // named barriers 1, 2: the turns
constexpr int OUT_BAR = 3;               // 3, 4: a warpgroup's epilogue

constexpr int MAX_TILES = 64;            // key tiles of a row (kMaxSeq / BK)
constexpr int SCAN = 4;                  // key tiles whose ids load together

// what the producer hands over with a K/V tile
struct SlotMeta {
  int seg[BK];        // the tile's segment ids
  int flags;
  int id;             // the keys' one id, under UNIFORM
  int pad[2];
};

// the producer's scratch and the item's query ids
struct Meta {
  int4 tiles[MAX_TILES];      // per key tile: set of (id & 31), min, max
  int qseg[3][BQ];            // per Q slot: the item's query ids
};

template <int D>
struct Cfg {
  static constexpr int NB = D / BOX_COLS;           // boxes per tile
  static constexpr int TILE = NB * BOX_BYTES;       // a Q, K or V tile
  static constexpr int KV = 2 * TILE;
  // a Q slot also stages the item's output, so it is held to the item's
  // end: three slots where they fit beside five K/V stages
  static constexpr int Q_STAGES = D == 64 ? 3 : 2;
  static constexpr int FIXED = wg::TILE_ALIGN + Q_STAGES * TILE + BAR_BYTES +
                               (int)sizeof(Meta);
  static constexpr int SLOT = KV + (int)sizeof(SlotMeta);
  static constexpr int FIT = (SMEM_MAX - FIXED) / SLOT;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int SMEM = FIXED + STAGES * SLOT;
  static_assert(D % BOX_COLS == 0 && STAGES >= 2, "ring depth");
  static_assert(16 * (Q_STAGES + STAGES) <= BAR_BYTES, "barriers");
  static_assert(Q_STAGES <= 3, "query id slots");
};

__device__ __forceinline__ int seg_at(const void* seg, int seg_bytes,
                                      long long i) {
  return seg_bytes == 1 ? static_cast<const uint8_t*>(seg)[i]
                        : static_cast<const int*>(seg)[i];
}

// Every key tile of the row at `row` (nkt tiles): its ids as a set of
// (id & 31) and a range, into `tiles` by the producer warp. The loads of
// SCAN tiles are in flight together, so an item waits for one or two
// round trips to memory, not one per tile.
__device__ __forceinline__ void scan_row(const void* seg, int seg_bytes,
                                         long long row, int nkt, int lane,
                                         int4* tiles) {
  for (int j0 = 0; j0 < nkt; j0 += SCAN) {
    int ids[SCAN][BK / 32];
#pragma unroll
    for (int u = 0; u < SCAN; ++u)
#pragma unroll
      for (int i = 0; i < BK / 32; ++i)
        ids[u][i] = j0 + u < nkt ? seg_at(seg, seg_bytes,
                                          row + (j0 + u) * BK + lane + 32 * i)
                                 : 0;
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      if (j0 + u < nkt) {
        uint32_t bits = 0;
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) {
          bits |= 1u << (ids[u][i] & 31);
          lo = min(lo, ids[u][i]);
          hi = max(hi, ids[u][i]);
        }
        bits = __reduce_or_sync(0xffffffffu, bits);
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) tiles[j0 + u] = make_int4((int)bits, lo, hi, 0);
      }
    }
  }
  __syncwarp();
}

// ids start .. start + 127 into shared memory, then published by the
// arrival that follows (lane 0's, after this warp barrier)
__device__ __forceinline__ void stage_ids(const void* seg, int seg_bytes,
                                          long long start, int lane,
                                          int* dst) {
#pragma unroll
  for (int i = 0; i < BK / 32; ++i)
    dst[lane + 32 * i] = seg_at(seg, seg_bytes, start + lane + 32 * i);
  __threadfence_block();
  __syncwarp();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumers' turns at the tensor cores: warpgroup w waits for its turn,
// starts its products and hands the turn to the other one, so that one
// warpgroup's softmax runs under the other's products. That pays where the
// products are as long as a softmax, at D = 128; at D = 64 the softmax is
// twice the products and the turns only made a warpgroup wait (slower at
// T = 512), so there the two run free.
template <int D>
__device__ __forceinline__ void turn_wait(int w) {
  if constexpr (D < 128) return;
  asm volatile("bar.sync %0, %1;\n" :: "r"(TURN_BAR + w),
               "n"(2 * wg::WG_THREADS) : "memory");
}

template <int D>
__device__ __forceinline__ void turn_pass(int w) {
  if constexpr (D < 128) return;
  asm volatile("bar.arrive %0, %1;\n" :: "r"(TURN_BAR + 1 - w),
               "n"(2 * wg::WG_THREADS) : "memory");
}

// the 128 threads of warpgroup w
__device__ __forceinline__ void out_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(OUT_BAR + w),
               "n"(wg::WG_THREADS) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// o += P V over a 128-key tile: P the warpgroup's 64 rows as 8 A fragments
// in registers, V (128 keys x D) MN-major in shared memory
template <typename T, int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pa)[8][4],
                                   uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t db = wg::make_desc_mn128(v_tile + kk * 16 * 128,
                                            BOX_BYTES);
    if constexpr (D == 64)
      wg::wgmma_m64n64k16_rs<T>(o, pa[kk], db);
    else
      wg::wgmma_m64n128k16_rs<T>(o, pa[kk], db);
  }
}

// the warpgroup's 64 x 128 scores of a tile: Q (its 64 rows) . K^T, both
// K-major in 128-byte swizzled boxes of 64 columns
template <typename T, int D>
__device__ __forceinline__ void scores(float (&s)[64], uint32_t q_tile,
                                       uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES;
    wg::wgmma_m64n128k16_ss<T>(
        s, wg::make_desc<128>(q_tile + off) + 2 * (kk % 4),
        wg::make_desc<128>(k_tile + off) + 2 * (kk % 4), kk > 0);
  }
}

// A tile's scores -> unnormalized p in place (thread: rows r0 and r0 + 8,
// columns 8j + 2t + e of the tile, whose segment ids are kseg): the
// running maxima m, this thread's share of the row sums l, and the factors
// a by which o and l (already applied to l) rescale.
__device__ __forceinline__ void softmax(float (&s)[64], const SlotMeta& sm,
                                        int t, int qs0, int qs1, float scale,
                                        float& m0, float& m1, float& l0,
                                        float& l1, float& a0, float& a1) {
  // logits: scaled, plus the finite mask where a key is in another
  // segment; the row maxima, over four partial maxima a row (short
  // dependency chains: two warps a scheduler hide little latency)
  const int flags = sm.flags;
  const bool see0 = qs0 == sm.id, see1 = qs1 == sm.id;
  float r0[4], r1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r0[i] = r1[i] = -FLT_MAX;
  if (flags & UNIFORM) {
    // one id for every key: a row sees all of them or none. Seen: the
    // maximum of the raw scores, scaled after (rounding is monotone);
    // unseen: every logit is s scale + MASK, which rounds to MASK itself
    // (|s scale| < 2^103, half an ulp of MASK)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      r0[j % 4] = fmaxf(r0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
      r1[j % 4] = fmaxf(r1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float x0 = fmaxf(fmaxf(r0[0], r0[1]), fmaxf(r0[2], r0[3]));
    const float x1 = fmaxf(fmaxf(r1[0], r1[1]), fmaxf(r1[2], r1[3]));
    r0[0] = see0 ? x0 * scale : kMaskValue;
    r1[0] = see1 ? x1 * scale : kMaskValue;
    r0[1] = r0[2] = r0[3] = r1[1] = r1[2] = r1[3] = -FLT_MAX;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int2 ks =
          *reinterpret_cast<const int2*>(&sm.seg[8 * j + 2 * t]);
      s[4 * j] = s[4 * j] * scale + (ks.x == qs0 ? 0.f : kMaskValue);
      s[4 * j + 1] =
          s[4 * j + 1] * scale + (ks.y == qs0 ? 0.f : kMaskValue);
      s[4 * j + 2] =
          s[4 * j + 2] * scale + (ks.x == qs1 ? 0.f : kMaskValue);
      s[4 * j + 3] =
          s[4 * j + 3] * scale + (ks.y == qs1 ? 0.f : kMaskValue);
      r0[j % 4] = fmaxf(r0[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
      r1[j % 4] = fmaxf(r1[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  float mx0 = fmaxf(fmaxf(m0, fmaxf(r0[0], r0[1])), fmaxf(r0[2], r0[3]));
  float mx1 = fmaxf(fmaxf(m1, fmaxf(r1[0], r1[1])), fmaxf(r1[2], r1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  a0 = ex2((m0 - mx0) * kLog2e);
  a1 = ex2((m1 - mx1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  l0 *= a0;
  l1 *= a1;
  if (flags & UNIFORM) {
    // p = exp2((s scale - m) log2 e) with the scale folded in: a row that
    // sees the tile has a real m (this tile's logits are in it), so
    // m log2 e is finite; for a row that does not, p is the same for every
    // key, exp2((MASK - m) log2 e): 0 once the row has seen a real logit,
    // 1 while m is MASK itself
    const float sl = scale * kLog2e;
    const float k0 = see0 ? sl : 0.f, k1 = see1 ? sl : 0.f;
    const float b0 = see0 ? -m0 * kLog2e : (kMaskValue - m0) * kLog2e;
    const float b1 = see1 ? -m1 * kLog2e : (kMaskValue - m1) * kLog2e;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], k0, b0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], k0, b0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], k1, b1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], k1, b1));
    }
  } else {
    // (s - m) first: a masked logit times log2 e alone would overflow
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2((s[4 * j] - m0) * kLog2e);
      s[4 * j + 1] = ex2((s[4 * j + 1] - m0) * kLog2e);
      s[4 * j + 2] = ex2((s[4 * j + 2] - m1) * kLog2e);
      s[4 * j + 3] = ex2((s[4 * j + 3] - m1) * kLog2e);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) r0[i] = r1[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    r0[j % 4] += s[4 * j] + s[4 * j + 1];
    r1[j % 4] += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 += (r0[0] + r0[1]) + (r0[2] + r0[3]);
  l1 += (r1[0] + r1[1]) + (r1[2] + r1[3]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float a0,
                                        float a1) {
  // a factor of exactly 1 (the maxima did not grow) changes nothing
  if (__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

// p as the A fragments of P V: the score layout is the A layout, two
// 8-key column blocks to a 16-key fragment
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = Mma16<T>::pack(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = Mma16<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = Mma16<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = Mma16<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
masked_attention_wgmma(const __grid_constant__ CUtensorMap m_q,
                       const __grid_constant__ CUtensorMap m_k,
                       const __grid_constant__ CUtensorMap m_v,
                       const __grid_constant__ CUtensorMap m_o,
                       const void* __restrict__ seg, int seq, int H,
                       int n_items, int seg_bytes, float scale) {
  using C = Cfg<D>;
  constexpr int Q_STAGES = C::Q_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t q_tiles = (raw + wg::TILE_ALIGN - 1) &
                           ~static_cast<uint32_t>(wg::TILE_ALIGN - 1);
  const uint32_t kv_tiles = q_tiles + Q_STAGES * C::TILE;
  const uint32_t q_bars = kv_tiles + C::STAGES * C::KV;
  const uint32_t kv_bars = q_bars + 16 * Q_STAGES;
  Meta& meta = *reinterpret_cast<Meta*>(smem_raw +
                                       (q_bars + BAR_BYTES - raw));
  SlotMeta* metas = reinterpret_cast<SlotMeta*>(&meta + 1);
  const int nqt = seq / BQ;

  if (threadIdx.x == 0) {
    wg::ring_init(q_bars, Q_STAGES, 2, 1);  // one arrival a warpgroup
    wg::ring_init(kv_bars, C::STAGES, CONSUMER_WARPS, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * wg::WG_THREADS) {
    // ===== producer warp: segment sets, tile list, TMA loads =====
    wg::reg_dealloc<56>();
    if (threadIdx.x < 2 * wg::WG_THREADS + 32) {
      const int lane = threadIdx.x % 32;
      const int nkt = seq / BK;
      wg::Ring qr(q_bars, Q_STAGES), kv(kv_bars, C::STAGES);
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int qt = item % nqt, h = (item / nqt) % H, b = item / nqt / H;
        const long long row = (long long)b * seq;
        scan_row(seg, seg_bytes, row, nkt, lane, meta.tiles);
        // key tiles some query of the item sees
        const int qbits = meta.tiles[qt].x;
        uint64_t visible = 0;
        for (int j = 0; j < nkt; ++j)
          if (meta.tiles[j].x & qbits) visible |= 1ull << j;
        wg::mbar_wait(qr.empty(), qr.phase ^ 1);
        stage_ids(seg, seg_bytes, row + qt * BQ, lane, meta.qseg[qr.slot]);
        if (lane == 0) {
          wg::mbar_expect_tx(qr.full(), C::TILE);
          const uint32_t dst = q_tiles + qr.slot * C::TILE;
          for (int c = 0; c < C::NB; ++c)
            wg::tma_load_4d(dst + c * BOX_BYTES, &m_q, qr.full(),
                            c * BOX_COLS, h, qt * BQ, b);
        }
        qr.advance();
        while (visible) {
          const int j = __ffsll(static_cast<long long>(visible)) - 1;
          visible &= visible - 1;
          wg::mbar_wait(kv.empty(), kv.phase ^ 1);
          SlotMeta& sm = metas[kv.slot];
          if (lane == 0) {
            const int4 ki = meta.tiles[j];
            sm.flags = (visible ? 0 : LAST) | (ki.y == ki.z ? UNIFORM : 0);
            sm.id = ki.y;
          }
          stage_ids(seg, seg_bytes, row + j * BK, lane, sm.seg);
          if (lane == 0) {
            // the arrival releases the metadata with the slot's bytes
            wg::mbar_expect_tx(kv.full(), C::KV);
            const uint32_t dst = kv_tiles + kv.slot * C::KV;
            for (int c = 0; c < C::NB; ++c) {
              wg::tma_load_4d(dst + c * BOX_BYTES, &m_k, kv.full(),
                              c * BOX_COLS, h, j * BK, b);
              wg::tma_load_4d(dst + C::TILE + c * BOX_BYTES, &m_v,
                              kv.full(), c * BOX_COLS, h, j * BK, b);
            }
          }
          kv.advance();
        }
      }
    }
  } else {
    // ===== consumer warpgroups: 64 query rows each =====
    wg::reg_alloc<224>();
    const int w = threadIdx.x / wg::WG_THREADS;
    const int tid = threadIdx.x % wg::WG_THREADS;
    const int t = tid % 4;
    const int r0 = w * 64 + (tid / 32) * 16 + (tid % 32) / 4;  // and r0 + 8
    wg::Ring qr(q_bars, Q_STAGES), kv(kv_bars, C::STAGES);
    int q_prev = -1;

    // The output of an item, o / l in T, over this warpgroup's rows of its
    // Q slot (only its own products read them) in the slot's swizzled
    // layout (row r's 16-byte chunk c at c ^ (r % 8)), then stored by TMA
    // in 128-byte rows; a Q slot goes back once its store has read it.
    auto store_out = [&](const float (&o)[D / 2], float l0, float l1,
                         uint32_t q_tile, int item) {
      const int qt = item % nqt, h = (item / nqt) % H, b = item / nqt / H;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      // l >= 1: every row sees its own key
      const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
      const int g = (tid % 32) / 4;                // = row % 8
      const uint32_t row0 = q_tile + ((tid / 32) * 16 + g) * 128;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t at =
            row0 + (j / 8) * BOX_BYTES + (((j % 8) ^ g) * 16 + 4 * t);
        st_shared(at, Mma16<T>::pack(o[4 * j] * i0, o[4 * j + 1] * i0));
        st_shared(at + 8 * 128,
                  Mma16<T>::pack(o[4 * j + 2] * i1, o[4 * j + 3] * i1));
      }
      wg::fence_proxy_async();
      out_sync(w);
      if (tid == 0) {
        for (int c = 0; c < C::NB; ++c)
          wg::tma_store_4d(&m_o, q_tile + c * BOX_BYTES, c * BOX_COLS, h,
                           qt * BQ + 64 * w, b);
        wg::bulk_commit();
        // with three slots the previous item's (long read), with two this
        // one's
        if (Q_STAGES >= 3) {
          wg::bulk_wait_read<1>();
          if (q_prev >= 0) wg::mbar_arrive(qr.empty0 + 8 * q_prev);
        } else {
          wg::bulk_wait_read<0>();
          wg::mbar_arrive(qr.empty());
        }
      }
      q_prev = qr.slot;
      qr.advance();
    };

    // The block's items run as one stream of turns. Each turn starts the
    // scores of a tile and the P V of the tile before it, scores first
    // inside an item (wait_group 1 retires them, the softmax runs under
    // P V), P V first across two items of more than one key tile
    // (wait_group 1 retires it, the output is written under the next
    // item's first scores; with one tile an item, joining the store to the
    // next item's loads measured slower). Every path commits its groups in
    // a fixed order, so ptxas keeps the products asynchronous, and both
    // warpgroups take the same turns.
    if (w == 1) turn_pass<D>(w);  // warpgroup 0 takes the first turn
    const bool chain = nqt > 1;
    int item = blockIdx.x;     // a block has at least one item
    float o[D / 2];
    float m0, m1, l0, l1, a0, a1;
    float s[64];
    uint32_t pa[8][4];  // the previous tile's p, as A fragments
    uint32_t q_tile;
    int qs0, qs1, flags;
    // an item's state, Q, and first scores, alone in a turn
    auto start_item = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = -FLT_MAX;
      l0 = l1 = 0.f;
      qr.wait_full();
      q_tile = q_tiles + qr.slot * C::TILE + w * 64 * 128;
      qs0 = meta.qseg[qr.slot][r0];
      qs1 = meta.qseg[qr.slot][r0 + 8];
      kv.wait_full();
      flags = metas[kv.slot].flags;
      turn_wait<D>(w);
      wg::wgmma_fence();
      scores<T, D>(s, q_tile, kv_tiles + kv.slot * C::KV);
      wg::wgmma_commit();
      turn_pass<D>(w);
      wg::wgmma_wait<0>();
      wg::fence_regs(s);
    };
    start_item();
    for (;;) {
      // s: the scores of the item's first tile
      softmax(s, metas[kv.slot], t, qs0, qs1, scale, m0, m1, l0, l1, a0, a1);
      pack_p<T>(s, pa);
      int prev = kv.slot;
      kv.advance();
      while (!(flags & LAST)) {
        kv.wait_full();
        flags = metas[kv.slot].flags;
        turn_wait<D>(w);
        wg::wgmma_fence();
        scores<T, D>(s, q_tile, kv_tiles + kv.slot * C::KV);
        wg::wgmma_commit();
        pv<T, D>(o, pa, kv_tiles + prev * C::KV + C::TILE);
        wg::wgmma_commit();
        turn_pass<D>(w);
        wg::wgmma_wait<1>();
        wg::fence_regs(s);
        softmax(s, metas[kv.slot], t, qs0, qs1, scale, m0, m1, l0, l1, a0,
                a1);
        // the previous tile's P V has retired: its slot goes back
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
        wg::fence_regs(pa);
        wg::ring_release(kv.empty0, prev, 1);
        rescale<D>(o, a0, a1);
        pack_p<T>(s, pa);
        prev = kv.slot;
        kv.advance();
      }
      const int next = item + gridDim.x;
      if (next >= n_items || !chain) {
        // the item's last P V alone
        turn_wait<D>(w);
        wg::wgmma_fence();
        pv<T, D>(o, pa, kv_tiles + prev * C::KV + C::TILE);
        wg::wgmma_commit();
        turn_pass<D>(w);
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
        wg::fence_regs(pa);
        wg::ring_release(kv.empty0, prev, 1);
        store_out(o, l0, l1, q_tile, item);
        if (next >= n_items) break;
        item = next;
        start_item();
        continue;
      }
      // this item's last P V, then the next item's first scores
      wg::Ring qn = qr;
      qn.advance();
      qn.wait_full();
      const uint32_t q_next = q_tiles + qn.slot * C::TILE + w * 64 * 128;
      kv.wait_full();
      flags = metas[kv.slot].flags;
      turn_wait<D>(w);
      wg::wgmma_fence();
      pv<T, D>(o, pa, kv_tiles + prev * C::KV + C::TILE);
      wg::wgmma_commit();
      scores<T, D>(s, q_next, kv_tiles + kv.slot * C::KV);
      wg::wgmma_commit();
      turn_pass<D>(w);
      wg::wgmma_wait<1>();
      wg::fence_regs(o);
      wg::fence_regs(pa);
      wg::ring_release(kv.empty0, prev, 1);
      store_out(o, l0, l1, q_tile, item);
      item = next;
      q_tile = q_next;
      qs0 = meta.qseg[qr.slot][r0];
      qs1 = meta.qseg[qr.slot][r0 + 8];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = -FLT_MAX;
      l0 = l1 = 0.f;
      wg::wgmma_wait<0>();
      wg::fence_regs(s);
    }
    if (tid == 0) wg::bulk_wait();
    if (w == 0) turn_wait<D>(w);  // the turn warpgroup 1 passed last
  }
}

}  // namespace wga

template <typename T, int D>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  using C = wga::Cfg<D>;
  const CUtensorMapDataType dtype = std::is_same<T, __half>::value
                                        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // (D, H, T, B) over the strided views, one box = 64 columns x 128 rows
  const void* ptrs[3] = {p.q, p.k, p.v};
  const long long str[3][3] = {{p.q_sh, p.q_st, p.q_sb},
                               {p.k_sh, p.k_st, p.k_sb},
                               {p.v_sh, p.v_st, p.v_sb}};
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)p.H, (uint64_t)p.T,
                            (uint64_t)B};
  const uint32_t box[4] = {wga::BOX_COLS, 1, wga::BK, 1};
  CUtensorMap maps[4];
  for (int i = 0; i < 3; ++i) {
    const uint64_t strides[3] = {(uint64_t)str[i][0] * sizeof(T),
                                 (uint64_t)str[i][1] * sizeof(T),
                                 (uint64_t)str[i][2] * sizeof(T)};
    const int e = wg::make_map(&maps[i], ptrs[i], 4, dims, strides, box,
                               dtype);
    if (e != 0) return e;
  }
  // the output, contiguous, in boxes of one warpgroup's 64 rows
  const uint64_t o_strides[3] = {(uint64_t)D * sizeof(T),
                                 (uint64_t)p.H * D * sizeof(T),
                                 (uint64_t)p.T * p.H * D * sizeof(T)};
  const uint32_t o_box[4] = {wga::BOX_COLS, 1, 64, 1};
  const int e = wg::make_map(&maps[3], p.out, 4, dims, o_strides, o_box,
                             dtype);
  if (e != 0) return e;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto kernel = wga::masked_attention_wgmma<T, D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // one block per SM, their count prime to the query tiles of a head: a
  // block's items (a static stride) then cycle through the query tiles,
  // whose key tile counts differ with the padding
  const int nqt = p.T / wga::BQ, n_items = B * p.H * nqt;
  int grid = n_items < sms ? n_items : sms;
  while (grid > 1 && std::gcd(grid, nqt) != 1) --grid;
  kernel<<<grid, wga::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p.seg, p.T, p.H, n_items,
      p.seg_bytes, p.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, H, D) with element strides (batch, seq, head) and unit
// stride along D; out: (B, T, H, D) contiguous; seg: (B, T) contiguous,
// seg_bytes 1 (uint8) or 4 (int32); dtype 0 = bf16, 1 = fp32, 2 = fp16;
// variant 0 = "mma", 1 = "wgmma" (bf16/fp16, T % 128 == 0, rows a tensor
// map can describe: 16-byte aligned base and strides). Returns 0, a CUDA
// error, cudaErrorInvalidValue for arguments the variant does not take, or
// a tensor-map code of csrc/wgmma_mainloop.cuh (2xxxx).
extern "C" int masked_attention_launch(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int B, int T, int H, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, int seg_bytes,
    int dtype, int variant, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < kTile ||
      T % kTile || T > kMaxSeq || (seg_bytes != 1 && seg_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    seg,  out,  T,    H,    seg_bytes,
                 q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                 v_sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    if (T % wga::BQ) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && D == 64) return launch_wgmma<__nv_bfloat16, 64>(p, B, st);
    if (dtype == 0 && D == 128)
      return launch_wgmma<__nv_bfloat16, 128>(p, B, st);
    if (dtype == 2 && D == 64) return launch_wgmma<__half, 64>(p, B, st);
    if (dtype == 2 && D == 128) return launch_wgmma<__half, 128>(p, B, st);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(p, B, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(p, B, st);
  if (dtype == 1 && D == 64) return launch<float, 64>(p, B, st);
  if (dtype == 1 && D == 128) return launch<float, 128>(p, B, st);
  if (dtype == 2 && D == 64) return launch<__half, 64>(p, B, st);
  if (dtype == 2 && D == 128) return launch<__half, 128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
