// Fused ColBERT MaxSim scoring + lane-bin screen, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU schedules of one function in
// neighborhoodwatch_tpu/ops/maxsim_kernel.py: _kernel (K4, with its
// epilogue _screen_scores) and _kernel_pipelined (K5). They differ only in
// how the TPU grid overlaps the epilogue with the products and give
// bit-identical keys; bins are logical, so this kernel picks its own tiles
// and serves both.
//
// What it computes, per query q (Tq tokens) and doc d (Td tokens), from
// host-prepared bf16 operands (masked query tokens zeroed, masked doc tokens
// replaced by the doc's first valid token, so there is no per-token mask):
//   sim[t, s] = qhi[q,t].dhi[d,s] [+ qlo[q,t].dhi[d,s] (passes >= 2)]
//               [+ qhi[q,t].dlo[d,s] (passes == 3)], fp32 accumulation;
//   score     = (sum over t = 0..Tq-1, in that order, of max over s of
//               sim[t, s]) + bias[d]        (bias: 0, or -1e30 on empty docs)
//   neg       = -score, NaN -> +inf (a NaN with its sign bit set would
//               otherwise win every bin);
//   key       = (sign-adjusted bits of neg & ~1023) | pos,
//               pos = (d % 8192) / 128.
// Each bin (mega = d / 8192, lane = d % 128) keeps its 4 smallest keys,
// written to out[q, mega*512 + t*128 + lane], t = 0..3 ascending (t = 3 is
// the certificate slab). Docs at or past D read as zero and take the -1e30
// bias, so the doc tensor is never padded. The max keeps NaN (max.NaN), as
// the reference's jnp.maximum does.
//
// Bound on this card: 2*Q*Tq*D*Td*dim*passes FLOP on the bf16 tensor cores
// (1,000 x 32 query tokens against 200,000 x 16 doc tokens at dim 128 is
// 2.62e13 FLOP per pass, 26.5 ms per pass at 989 TFLOP/s) against one read
// of the bf16 doc tokens (0.82 GB, 0.25 ms at 3.35 TB/s): the function is
// operations-bound, and since the depth is only dim (8 k16 steps at 128)
// every accumulator tile retires after a handful of MMAs, so the epilogue
// has to stay on the chip and cheap. What holds such a kernel back is the
// bytes each SM takes in per FLOP and the drain of the tensor pipe at every
// doc token.
//
// Two variants of the one function live here; the launch function takes
// the one the wrapper chose by shape (ops/maxsim_kernel.py:pick_variant):
//
// "wgmma" (dimp 64 or 128). A block walks one 8192-doc mega in 128-doc
// steps, so every lane bin gets one doc per step (position = step index),
// and inside a step loops over the doc-token index s. Its two consumer
// warpgroups each own qb = min(8, 64 / Tq) queries: 64 token rows, q-major,
// straight from the row-major (Q, Tq, dimp) tensor through a 2-D tensor map
// over (Q*Tq, dimp). The rows of a warpgroup's box between qb*Tq and 64
// then hold the next queries' tokens instead of zeros; that is harmless
// only because the token sum below reads rows < qb*Tq. The query tiles are
// loaded once, before the ring, and stay in shared memory for the whole
// mega: the ring of csrc/wgmma_mainloop.cuh carries doc tiles only, one
// 16 KB slot per (step, s, 64-column chunk) and operand (dhi, then dlo at 3
// passes): token s of 128 consecutive docs is one box {64, 1, 128} of a
// 3-D tensor map {dimp, Td, D}, and docs past D arrive as zeros. Both
// warpgroups multiply their own query tile with the same doc tile (one
// wgmma m64n128k16 per k-step and pass, 64 accumulator registers), and the
// blocks of a cluster (consecutive query blocks of one mega) each load a
// share of the doc tile and multicast it. The max over a doc's tokens is a
// register-wise running max next to the accumulator (64 more registers).
// The sum over a query's Tq rows crosses the rows of the wgmma layout, so
// once per step the maxima go through a 64 x 128 fp32 tile in shared memory
// (one per warpgroup); thread `lane` of the warpgroup then adds its column
// in token order for each of the warpgroup's queries, applies the bias and
// inserts the key into the bin's 4 keys, which live in its registers for
// the whole mega. The grid's block count is rounded up to the cluster size;
// a surplus block runs every ring turn and stores nothing.
//
// "mma" (any dimp that is a multiple of 16: the first version of this
// kernel). One block owns qb queries (<= 64 token rows) x one mega; eight
// warps each own a 32-row x 32-doc tile computed with mma.sync m16n8k16
// from ldmatrix fragments; operands, the query chunk included, stream
// through a cp.async ring of 64-column chunks (6, 4 or 3 stages at 1, 2 or
// 3 passes); the token sum goes through one 64 x 128 fp32 tile.
// Two accumulator sets (to overlap a token's max with the next token's
// products) and a persistent schedule are left to later work.

#include "wgmma_mainloop.cuh"

namespace {

constexpr int BQ = 64;          // query-token rows per block or warpgroup
constexpr int BR = 128;         // docs per step (= lanes)
constexpr int KEEP = 4;
constexpr int POS_MASK = 1023;
constexpr int MEGA_DOCS = 8192;
constexpr int MAX_QB = 8;       // queries per 64 token rows at most
constexpr float NEG_BIAS = -1e30f;

// NaN-propagating max, as jnp.maximum (fmaxf would drop the NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// key of a doc's score `sc` (bias included) at bin position pos, inserted
// into the bin's 4 ascending keys
__device__ __forceinline__ void insert_score(int (&keys)[KEEP], float sc,
                                             int pos) {
  float neg = -sc;
  if (neg != neg) neg = __int_as_float(0x7f800000);
  int bits = __float_as_int(neg);
  bits ^= (bits >> 31) & 0x7fffffff;
  int hi = (bits & ~POS_MASK) | pos;
#pragma unroll
  for (int t = 0; t < KEEP; ++t) {
    const int cur = keys[t];
    keys[t] = min(cur, hi);
    hi = max(cur, hi);
  }
}

// ---------------------------------------------------------------------------
// variant "mma": mma.sync from a cp.async ring, any dimp % 16 == 0
// ---------------------------------------------------------------------------
namespace mma {

constexpr int KC = 64;          // depth chunk per pipeline stage
constexpr int LDS = KC + 8;     // bf16 row stride (144 B: ldmatrix rows hit
                                // distinct bank groups)
constexpr int SMS = BR + 8;     // fp32 row stride of the per-step max tile
constexpr int THREADS = 256;
constexpr int MAXP = MAX_QB * BR / THREADS;   // (query, lane) bins per thread

typedef __nv_bfloat16 QTile[BQ][LDS];
typedef __nv_bfloat16 BTile[BR][LDS];

__host__ __device__ constexpr int stage_bytes(int passes) {
  return ((passes >= 2 ? 2 : 1) * BQ + (passes >= 3 ? 2 : 1) * BR) * LDS *
         2;
}
__host__ __device__ constexpr int stages_for(int passes) {
  return passes == 1 ? 6 : passes == 2 ? 4 : 3;
}
__host__ __device__ constexpr int smem_bytes(int passes) {
  return stages_for(passes) * stage_bytes(passes) + BQ * SMS * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, NROWS) x columns [k0, k0 + KC) of a bf16 matrix whose row r
// starts at src + r * row_stride; rows >= nrows and columns >= width read
// as zero. width % 8 == 0 and 16-byte aligned rows (checked by the wrapper).
template <int NROWS>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* __restrict__ src,
    size_t row_stride, int nrows, int width, int k0) {
  constexpr int PER_ROW = KC / 8;
#pragma unroll
  for (int v = threadIdx.x; v < NROWS * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v % PER_ROW) * 8;
    const bool ok = r < nrows && k0 + c < width;
    const __nv_bfloat16* g = ok ? src + (size_t)r * row_stride + k0 + c : src;
    cp_async16(&dst[r][c], g, ok);
  }
}

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_keys_kernel(const __nv_bfloat16* __restrict__ qhi,
                   const __nv_bfloat16* __restrict__ qlo,
                   const __nv_bfloat16* __restrict__ dhi,
                   const __nv_bfloat16* __restrict__ dlo,
                   const float* __restrict__ bias,
                   int* __restrict__ out,
                   int Q, int Tq, int Dn, int Td, int dimp, int n_mega,
                   int qb) {
  constexpr int passes = PASSES;
  constexpr int STAGES = stages_for(PASSES);
  constexpr int SBYTES = stage_bytes(PASSES);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto q_hi = [&](int st) {
    return reinterpret_cast<QTile*>(smem_raw + st * SBYTES)[0];
  };
  auto q_lo = [&](int st) {
    return reinterpret_cast<QTile*>(smem_raw + st * SBYTES)[1];
  };
  auto b_hi = [&](int st) {
    return reinterpret_cast<BTile*>(
        smem_raw + st * SBYTES + (passes >= 2 ? 2 : 1) * sizeof(QTile))[0];
  };
  auto b_lo = [&](int st) {
    return reinterpret_cast<BTile*>(
        smem_raw + st * SBYTES + (passes >= 2 ? 2 : 1) * sizeof(QTile))[1];
  };
  float (*sm_max)[SMS] =
      reinterpret_cast<float (*)[SMS]>(smem_raw + STAGES * SBYTES);

  const int q0 = blockIdx.x * qb;
  const int mega = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wq = warp / 4;          // token rows 32*wq .. +32
  const int wb = warp % 4;          // docs (lanes) 32*wb .. +32
  const int gid = lane / 4;         // mma group id
  const int tig = lane % 4;         // thread in group
  const int n_pos = MEGA_DOCS / BR;
  const int n_chunks = (dimp + KC - 1) / KC;
  const int per_step = Td * n_chunks;
  const int total = n_pos * per_step;
  const int qcount = min(qb, Q - q0);       // queries of this block
  const int qrows = qcount * Tq;            // their token rows
  const size_t q_off = (size_t)q0 * Tq * dimp;
  const size_t d_stride = (size_t)Td * dimp;

  // the (query, lane) bins this thread owns: query ln_q + 2p, lane ln
  const int ln = threadIdx.x % BR;
  const int ln_q = threadIdx.x / BR;
  int keys[MAXP][KEEP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p)
#pragma unroll
    for (int t = 0; t < KEEP; ++t) keys[p][t] = 0x7fffffff;

  // accumulator of the current (step, s) and the running max over s;
  // element (mi, ni, c): row wq*32 + mi*16 + gid + 8*(c/2),
  //                      doc wb*32 + ni*8 + 2*tig + c%2
  float acc[2][4][4];
  float mx[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mi][ni][c] = 0.0f;
        mx[mi][ni][c] = 0.0f;
      }

  auto fetch = [&](int it) {
    if (it < total) {
      const int step = it / per_step;
      const int rem = it - step * per_step;
      const int s = rem / n_chunks;
      const int k0 = (rem - s * n_chunks) * KC;
      const int d0 = mega * MEGA_DOCS + step * BR;
      const int drows = min(BR, Dn - d0);          // <= 0 past the corpus
      const size_t d_off = (size_t)d0 * d_stride + (size_t)s * dimp;
      const int sg = it % STAGES;
      load_tile<BQ>(q_hi(sg), qhi + q_off, dimp, qrows, dimp, k0);
      load_tile<BR>(b_hi(sg), drows > 0 ? dhi + d_off : dhi, d_stride,
                    drows, dimp, k0);
      if (passes >= 2)
        load_tile<BQ>(q_lo(sg), qlo + q_off, dimp, qrows, dimp, k0);
      if (passes >= 3)
        load_tile<BR>(b_lo(sg), drows > 0 ? dlo + d_off : dlo, d_stride,
                      drows, dimp, k0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int step = 0, s_tok = 0, kc = 0;      // decomposition of `it`
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage every thread finished reading in iteration it-1
    fetch(it + STAGES - 1);

    const int sg = it % STAGES;
    const __nv_bfloat16(*sqh)[LDS] = q_hi(sg);
    const __nv_bfloat16(*sql)[LDS] = q_lo(sg);
    const __nv_bfloat16(*sbh)[LDS] = b_hi(sg);
    const __nv_bfloat16(*sbl)[LDS] = b_lo(sg);
    const int kdepth = min(KC, dimp - kc * KC);    // a multiple of 16
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (kk >= kdepth) break;
      uint32_t a[2][4], b[2][4];
      const int ar = lane % 16, ac = kk + (lane / 16) * 8;
      const int br = (lane % 8) + (lane / 16) * 8;
      const int bc = kk + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &sqh[wq * 32 + mi * 16 + ar][ac]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(b[nj], &sbh[wb * 32 + nj * 16 + br][bc]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni / 2][(ni % 2) * 2],
                   b[ni / 2][(ni % 2) * 2 + 1]);
      if (passes >= 2) {
        uint32_t al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(al[mi], &sql[wq * 32 + mi * 16 + ar][ac]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], al[mi], b[ni / 2][(ni % 2) * 2],
                     b[ni / 2][(ni % 2) * 2 + 1]);
      }
      if (passes >= 3) {
        uint32_t bl[2][4];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4(bl[nj], &sbl[wb * 32 + nj * 16 + br][bc]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], a[mi], bl[ni / 2][(ni % 2) * 2],
                     bl[ni / 2][(ni % 2) * 2 + 1]);
      }
    }

    if (kc == n_chunks - 1) {
      // token s of every doc is complete: fold it into the running max
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            mx[mi][ni][c] = s_tok == 0 ? acc[mi][ni][c]
                                       : max_nan(mx[mi][ni][c],
                                                 acc[mi][ni][c]);
            acc[mi][ni][c] = 0.0f;
          }
      if (s_tok == Td - 1) {
        // the step's docs are complete: per-token maxima to shared memory,
        // then each (query, lane) bin adds its column in token order.
        // The next write of sm_max lies behind the loop's barrier, after
        // every reader below is done.
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = wq * 32 + mi * 16 + gid + 8 * h;
              const int col = wb * 32 + ni * 8 + 2 * tig;
              *reinterpret_cast<float2*>(&sm_max[row][col]) =
                  make_float2(mx[mi][ni][2 * h], mx[mi][ni][2 * h + 1]);
            }
        __syncthreads();
        const int doc = mega * MEGA_DOCS + step * BR + ln;
        const float dbias = doc < Dn ? bias[doc] : NEG_BIAS;
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
          const int qi = ln_q + 2 * p;
          if (qi < qb) {
            const float* col = &sm_max[qi * Tq][ln];
            float sc = col[0];
            for (int t = 1; t < Tq; ++t) sc = __fadd_rn(sc, col[t * SMS]);
            insert_score(keys[p], __fadd_rn(sc, dbias), step);
          }
        }
      }
    }
    if (++kc == n_chunks) {
      kc = 0;
      if (++s_tok == Td) {
        s_tok = 0;
        ++step;
      }
    }
  }
  cp_async_wait<0>();

  const size_t width = (size_t)n_mega * KEEP * BR;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int qi = ln_q + 2 * p;
    if (qi < qcount) {
      int* orow = out + (size_t)(q0 + qi) * width + (size_t)mega * KEEP * BR;
#pragma unroll
      for (int t = 0; t < KEEP; ++t) orow[t * BR + ln] = keys[p][t];
    }
  }
}

template <int PASSES>
int launch(const void* qhi, const void* qlo, const void* dhi, const void* dlo,
           const void* bias, void* out, int Q, int Tq, int Dn, int Td,
           int dimp, int n_mega, cudaStream_t stream) {
  const int smem = smem_bytes(PASSES);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_keys_kernel<PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int qb = BQ / Tq < MAX_QB ? BQ / Tq : MAX_QB;
  dim3 grid((Q + qb - 1) / qb, n_mega);
  maxsim_keys_kernel<PASSES><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)qhi, (const __nv_bfloat16*)qlo,
      (const __nv_bfloat16*)dhi, (const __nv_bfloat16*)dlo,
      (const float*)bias, (int*)out, Q, Tq, Dn, Td, dimp, n_mega, qb);
  return (int)cudaGetLastError();
}


}  // namespace mma

// ---------------------------------------------------------------------------
// variant "wgmma": wgmma from a TMA/mbarrier ring, resident query tiles
// ---------------------------------------------------------------------------
namespace wgk {

constexpr int KC = 64;                 // depth chunk: 128-byte tile rows
constexpr int RB = KC * 2;
constexpr int A_TILE = BQ * RB;        // 64 token rows x one chunk (8 KB)
constexpr int D_TILE = BR * RB;        // 128 docs x one chunk: a ring slot
constexpr int MAX_CHUNKS = 2;          // dimp <= 128
constexpr int SMS = BR + 4;            // fp32 row stride of the max tiles
constexpr int MAX_TILE = BQ * SMS * 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 3 * wg::WG_THREADS;   // two consumers, one producer
constexpr int SMEM_MAX = 232448;       // 227 KB a block may use
constexpr int BAR_BYTES = 256;         // room for the barriers

// Shared memory: the resident query tiles [warpgroup][hi, lo][chunk], the
// ring's slots, the barriers, one max tile per warpgroup.
template <int PASSES>
struct Cfg {
  static constexpr int NA = PASSES >= 2 ? 2 : 1;
  static constexpr int NB = PASSES >= 3 ? 2 : 1;
  static constexpr int A_BYTES = 2 * NA * MAX_CHUNKS * A_TILE;
  static constexpr int FIXED =
      wg::TILE_ALIGN + A_BYTES + BAR_BYTES + 2 * MAX_TILE;
  static constexpr int STAGES = (SMEM_MAX - FIXED) / D_TILE;
  static constexpr int SMEM = FIXED + STAGES * D_TILE;
  static_assert(STAGES >= 4 && 16 * STAGES + 8 <= BAR_BYTES, "ring depth");
};

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_keys_wgmma(const __grid_constant__ CUtensorMap m_qhi,
                  const __grid_constant__ CUtensorMap m_qlo,
                  const __grid_constant__ CUtensorMap m_dhi,
                  const __grid_constant__ CUtensorMap m_dlo,
                  const float* __restrict__ bias,
                  int* __restrict__ out,
                  int Q, int Tq, int Dn, int Td, int n_chunks, int n_mega,
                  int qb) {
  using C = Cfg<PASSES>;
  extern __shared__ unsigned char smem_raw[];
  // the same offsets in every block of the cluster (multicast lands there)
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t tiles = (raw + wg::TILE_ALIGN - 1) &
                         ~static_cast<uint32_t>(wg::TILE_ALIGN - 1);
  const uint32_t ring0 = tiles + C::A_BYTES;
  const uint32_t bars = ring0 + C::STAGES * D_TILE;
  const uint32_t a_full = bars + 16 * C::STAGES;
  const uint32_t cl = wg::cluster_nctarank();
  const uint32_t rank = wg::cluster_ctarank();

  const int q0 = blockIdx.x * 2 * qb;   // may lie past Q in a surplus block
  const int mega = blockIdx.y;
  constexpr int n_pos = MEGA_DOCS / BR;

  if (threadIdx.x == 0) {
    wg::ring_init(bars, C::STAGES, CONSUMER_WARPS, cl);
    wg::mbar_init(a_full, 1);
    wg::fence_barrier_init();
  }
  // no block may multicast into, or arrive on, barriers not yet initialised
  wg::cluster_sync();

  if (threadIdx.x >= 2 * wg::WG_THREADS) {
    // ===== producer warpgroup: one thread starts every TMA load =====
    wg::reg_dealloc<40>();
    if (threadIdx.x == 2 * wg::WG_THREADS) {
      // the query tiles, once: warpgroup w's 64 rows start at its first
      // query's first token; rows past qb*Tq are the next queries' tokens
      // (or zeros past Q*Tq) and never reach a score
      wg::mbar_expect_tx(a_full, 2 * C::NA * n_chunks * A_TILE);
      for (int w = 0; w < 2; ++w)
        for (int op = 0; op < C::NA; ++op)
          for (int kc = 0; kc < n_chunks; ++kc)
            wg::tma_load_2d(
                tiles + ((w * C::NA + op) * MAX_CHUNKS + kc) * A_TILE,
                op ? &m_qlo : &m_qhi, a_full, kc * KC, (q0 + w * qb) * Tq, 0,
                false);
      // the doc tiles: this block's share of each goes to the whole cluster
      wg::Ring ring(bars, C::STAGES);
      const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
      const int slice = BR / cl;
      for (int step = 0; step < n_pos; ++step) {
        const int d0 = mega * MEGA_DOCS + step * BR + rank * slice;
        for (int s = 0; s < Td; ++s)
          for (int kc = 0; kc < n_chunks; ++kc)
            for (int op = 0; op < C::NB; ++op) {
              ring.acquire(D_TILE);
              wg::tma_load_3d(ring0 + ring.slot * D_TILE + rank * slice * RB,
                              op ? &m_dlo : &m_dhi, ring.full(), kc * KC, s,
                              d0, mask, cl > 1);
              ring.advance();
            }
      }
    }
  } else {
    // ===== consumer warpgroups: qb queries (64 token rows) each =====
    wg::reg_alloc<232>();
    const int w = threadIdx.x / wg::WG_THREADS;
    const int tid = threadIdx.x % wg::WG_THREADS;   // = the lane it owns
    const int gid = (tid % 32) / 4;
    const int tig = tid % 4;
    const int row0 = (tid / 32) * 16 + gid;   // accumulator rows row0, +8
    const int qw = q0 + w * qb;               // the warpgroup's first query
    const int qcount = max(0, min(qb, Q - qw));
    float (*sm_max)[SMS] = reinterpret_cast<float (*)[SMS]>(
        smem_raw + (bars - raw) + BAR_BYTES + w * MAX_TILE);
    const uint32_t a_hi = tiles + w * C::NA * MAX_CHUNKS * A_TILE;
    const uint32_t a_lo = a_hi + MAX_CHUNKS * A_TILE;

    // bins (query qw + p, lane tid)
    int keys[MAX_QB][KEEP];
#pragma unroll
    for (int p = 0; p < MAX_QB; ++p)
#pragma unroll
      for (int t = 0; t < KEEP; ++t) keys[p][t] = 0x7fffffff;

    // acc: token s of the step's docs; mx: running max over s. Element
    // 4j + 2h + e is row row0 + 8h, doc 8j + 2 tig + e.
    float acc[64], mx[64];
    wg::mbar_wait(a_full, 0);
    wg::Ring ring(bars, C::STAGES);
    for (int step = 0; step < n_pos; ++step) {
      // fetched now, used at the step's end: the products hide the latency
      const int doc = mega * MEGA_DOCS + step * BR + tid;
      const float dbias = doc < Dn ? __ldg(bias + doc) : NEG_BIAS;
      for (int s = 0; s < Td; ++s) {
        int pending = -1;     // slot whose wgmmas are still in flight
        for (int kc = 0; kc < n_chunks; ++kc) {
          ring.wait_full();
          const uint32_t d_hi = ring0 + ring.slot * D_TILE;
          wg::wgmma_fence();
          wg::wgmma_chunk<KC>(acc, a_hi + kc * A_TILE, d_hi, kc == 0);
          if (PASSES >= 2)
            wg::wgmma_chunk<KC>(acc, a_lo + kc * A_TILE, d_hi, false);
          wg::wgmma_commit();
          if (pending >= 0) {
            wg::wgmma_wait<1>();
            wg::ring_release(ring.empty0, pending, cl);
          }
          pending = ring.slot;
          ring.advance();
          if (PASSES >= 3) {
            ring.wait_full();
            const uint32_t d_lo = ring0 + ring.slot * D_TILE;
            wg::wgmma_fence();
            wg::wgmma_chunk<KC>(acc, a_hi + kc * A_TILE, d_lo, false);
            wg::wgmma_commit();
            wg::wgmma_wait<1>();
            wg::ring_release(ring.empty0, pending, cl);
            pending = ring.slot;
            ring.advance();
          }
        }
        wg::wgmma_wait<0>();
        wg::ring_release(ring.empty0, pending, cl);
        wg::fence_acc(acc);
        // token s of every doc is complete: fold it into the running max
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[i] = s == 0 ? acc[i] : max_nan(mx[i], acc[i]);
      }

      // the step's docs are complete: per-token maxima to shared memory,
      // then thread `tid` adds its doc's column in token order per query
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&sm_max[row0 + 8 * h][8 * j + 2 * tig]) =
              make_float2(mx[4 * j + 2 * h], mx[4 * j + 2 * h + 1]);
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "n"(wg::WG_THREADS)
                   : "memory");
#pragma unroll
      for (int p = 0; p < MAX_QB; ++p) {
        if (p < qb) {
          const float* col = &sm_max[p * Tq][tid];
          float sc = col[0];
          for (int t = 1; t < Tq; ++t) sc = __fadd_rn(sc, col[t * SMS]);
          insert_score(keys[p], __fadd_rn(sc, dbias), step);
        }
      }
      // the next step's maxima are written behind this barrier
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "n"(wg::WG_THREADS)
                   : "memory");
    }

    const size_t width = (size_t)n_mega * KEEP * BR;
#pragma unroll
    for (int p = 0; p < MAX_QB; ++p) {
      if (p < qcount) {
        int* orow = out + (size_t)(qw + p) * width + (size_t)mega * KEEP * BR;
#pragma unroll
        for (int t = 0; t < KEEP; ++t) orow[t * BR + tid] = keys[p][t];
      }
    }
  }
  // no block leaves while a peer may still multicast into it or arrive on
  // its barriers
  wg::cluster_sync();
}

template <int PASSES>
int launch(const void* qhi, const void* qlo, const void* dhi, const void* dlo,
           const void* bias, void* out, int Q, int Tq, int Dn, int Td,
           int dimp, int n_mega, int cluster, cudaStream_t stream) {
  using C = Cfg<PASSES>;
  const int qb = BQ / Tq < MAX_QB ? BQ / Tq : MAX_QB;
  const int nblk = (Q + 2 * qb - 1) / (2 * qb);
  // blocks per cluster: 2 wherever there are two blocks to pair (an odd
  // count adds one surplus block per mega)
  const int cl = cluster > 0 ? cluster : (nblk >= 2 ? 2 : 1);
  CUtensorMap m_qhi, m_qlo, m_dhi, m_dlo;
  const uint64_t ddims[3] = {(uint64_t)dimp, (uint64_t)Td, (uint64_t)Dn};
  const uint64_t dstrides[2] = {(uint64_t)dimp * 2, (uint64_t)Td * dimp * 2};
  const uint32_t dbox[3] = {KC, 1, (uint32_t)(BR / cl)};
  int e = wg::make_map_2d(&m_qhi, qhi, (uint64_t)Q * Tq, dimp, BQ, KC);
  if (e == 0) e = wg::make_map_2d(&m_qlo, qlo, (uint64_t)Q * Tq, dimp, BQ, KC);
  if (e == 0) e = wg::make_map(&m_dhi, dhi, 3, ddims, dstrides, dbox);
  if (e == 0) e = wg::make_map(&m_dlo, dlo, 3, ddims, dstrides, dbox);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_keys_wgmma<PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nblk + cl - 1) / cl * cl, n_mega);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, maxsim_keys_wgmma<PASSES>, m_qhi, m_qlo,
                           m_dhi, m_dlo, (const float*)bias, (int*)out, Q, Tq,
                           Dn, Td, dimp / KC, n_mega, qb);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace wgk

}  // namespace

// qhi/qlo: (Q, Tq, dimp) bf16, dhi/dlo: (Dn, Td, dimp) bf16, bias: (Dn,) f32,
// out: (Q, n_mega*512) int32; 1 <= Tq <= 32, Td >= 1, dimp % 16 == 0,
// n_mega = ceil(Dn / 8192) <= 65535. variant: 0 = "mma", 1 = "wgmma" (dimp
// 64 or 128 only); cluster: blocks per cluster of the wgmma variant (1, 2
// or 4), 0 = chosen from the grid. The unused operands of a pass count (qlo,
// dlo) alias qhi, dhi. Returns 0, a CUDA error, or a tensor-map code of
// wgmma_mainloop.cuh.
extern "C" int maxsim_keys_launch(const void* qhi, const void* qlo,
                                  const void* dhi, const void* dlo,
                                  const void* bias, void* out, int Q, int Tq,
                                  int Dn, int Td, int dimp, int n_mega,
                                  int passes, int variant, int cluster,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq < 1 || Tq > 32 || Td < 1 || dimp < 16 || dimp % 16 != 0 ||
      n_mega < 1 || n_mega > 65535 || passes < 1 || passes > 3 ||
      variant < 0 || variant > 1 ||
      (variant == 1 && dimp != 64 && dimp != 128) ||
      (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4))
    return (int)cudaErrorInvalidValue;
#define NW_LAUNCH(P)                                                        \
  return variant == 1                                                       \
             ? wgk::launch<P>(qhi, qlo, dhi, dlo, bias, out, Q, Tq, Dn, Td, \
                              dimp, n_mega, cluster, st)                    \
             : mma::launch<P>(qhi, qlo, dhi, dlo, bias, out, Q, Tq, Dn, Td, \
                              dimp, n_mega, st)
  if (passes == 1) NW_LAUNCH(1);
  if (passes == 2) NW_LAUNCH(2);
  NW_LAUNCH(3);
#undef NW_LAUNCH
}
