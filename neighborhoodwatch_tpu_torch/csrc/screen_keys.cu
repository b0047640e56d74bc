// Fused distance + lane-bin screen for the exact-kNN screened engine, for
// Hopper (sm_90a).
//
// Replaces the three Pallas TPU schedules of one function in
// neighborhoodwatch_tpu/ops/screen_kernel.py: _kernel_fused (K1),
// _kernel_pipelined (K2) and _kernel (K3). They differ only in how the TPU
// grid walks the base; bins are logical, so this kernel picks its own tiles.
//
// What it computes, per query q and base row r (B rows, D columns):
//   acc  = qhi.bhi [+ qlo.bhi (passes >= 2)] [+ qhi.blo (passes == 3)],
//          bf16 operands, fp32 accumulation;
//   dist = l2:   |qn + bn - 2 acc|            (passes <= 2, fused form)
//                |max(qn + bn - 2 acc, 0)|    (passes == 3), NaN kept
//          dot:  -acc,                 +inf where bn is inf, NaN -> +inf
//          rdot: -acc * rsqrt(max(bn, 1e-30)), same masking;
//   key  = (sign-adjusted dist bits & ~1023) | pos, pos = (r % mega) / 128.
// Each bin (mega, r % 128) keeps its 4 smallest keys, written to
//   out[q, mega*512 + t*128 + lane], t = 0..3 ascending (t = 3 is the
//   certificate slab).
// Rows at or past B read as zero and take bn = +inf, so they never win a
// bin; the host masks rows past n_valid the same way through bn. Columns
// past D read as zero, so no operand is ever padded or copied.
//
// Bound on this card: 2*Q*B*D*passes FLOP on the bf16 tensor cores (the
// headline 10k x 1M x 1536 is 3.07e13 FLOP per pass, ~31 ms per pass at
// 989 TFLOP/s) against a 3.1 GB bf16 base read (~0.9 ms at 3.35 TB/s): the
// function is operations-bound, so every distance stays in registers and
// the design's effort goes into feeding the tensor cores.
//
// What holds such a kernel back is the bytes it pulls from L2 per FLOP: the
// keys (64 queries x 128 lanes x 4 per block) fill half the SM's registers,
// so a block cannot own more than 64 queries and every block of a mega
// re-reads the mega's base rows.
//
// Two variants of the one function live here; the launch function takes
// the one the wrapper chose by shape (ops/screen_kernel.py:pick_variant):
//
// "wgmma" (rows of D % 8 == 0 columns at 16-byte aligned addresses, which is
// what a TMA tensor map can describe). A block owns 64 queries x one mega
// and walks the mega in 256-row steps: rows r and r + 128 of a step fall in
// the same lane bin at positions 2*step and 2*step + 1, so the wider step
// adds no bins. Two consumer warpgroups each take half of the LANES, not
// half of the rows: warpgroup w owns lanes 64w..64w+63 of both 128-row
// halves. The producer lands its two 64-row TMA boxes next to each other in
// shared memory, so each k-step is one wgmma m64n128k16 per pass (A = the
// 64-query tile, B = the warpgroup's 128 rows) with 64 accumulator
// registers per thread, and accumulator columns n and n + 64 (the same
// thread in the wgmma layout) are a lane's two positions: 32 bins x 4 keys
// = 128 key registers per thread, the insert is four min/max pairs, and
// nothing of the epilogue touches shared memory but the step's 128 base
// norms, which each thread fetches one of at the step's start. The epilogue
// is a template parameter, so a step's 64 distances are straight-line code,
// and each of a bin's new keys is computed from the old ones alone, so the
// inserts of a thread's 32 bins overlap. The 2- and 3-pass tiers
// are two or three wgmmas per k-step into the same accumulator. Operands
// come through the TMA/mbarrier ring of csrc/wgmma_mainloop.cuh (5 slots of
// 64-column chunks at 1 pass, 4 at 2; 5 slots of 32-column chunks with the
// 64-byte swizzle at 3 passes, where a 64-column slot would be 80 KB);
// TMA's zero fill replaces every bounds check on operands. The blocks of a
// cluster (consecutive query blocks of one mega) each load a share of the
// step's base boxes and multicast them, so a base tile leaves L2 once per
// cluster. The grid's query-block count is rounded up to the cluster size;
// a surplus block runs every ring turn on zero-filled queries and stores
// nothing. Both warpgroups wait on the same ring slots, so they reach their
// step epilogues together and the tensor cores idle meanwhile: the ring's 5
// slots are too short a lead for one to run ahead through the other's
// epilogue. Shifting one warpgroup half a step measured slower for that
// reason.
//
// "mma" (any D, any alignment: the first version of this kernel). One block
// owns 64 queries x one mega and walks it in 128-row steps; eight warps
// each own a 32-query x 32-lane tile computed with mma.sync m16n8k16 from
// ldmatrix fragments, keys in registers next to the accumulators, operands
// through a cp.async ring of 64-column chunks (6, 4 or 3 stages at 1, 2 or
// 3 passes) with scalar loads where rows are not 16-byte aligned.
// A persistent schedule is left to later work.

#include "wgmma_mainloop.cuh"

namespace {

constexpr int BQ = 64;          // queries per block (both variants)
constexpr int LANES = 128;      // lane bins per mega
constexpr int KEEP = 4;
constexpr int POS_MASK = 1023;

// the three epilogues, shared by both variants
__device__ __forceinline__ float screen_dist(float acc, float qn, float bn,
                                             int passes, int epilogue) {
  const float inf = __int_as_float(0x7f800000);
  if (epilogue == 0) {
    float x = __fsub_rn(__fadd_rn(qn, bn), __fmul_rn(2.0f, acc));
    if (passes >= 3 && x < 0.0f) x = 0.0f;       // NaN stays NaN
    return fabsf(x);
  }
  float d;
  if (isinf(bn)) {
    d = inf;
  } else if (epilogue == 1) {
    d = -acc;
  } else {
    float m = isnan(bn) ? bn : fmaxf(bn, 1e-30f);
    d = __fmul_rn(-acc, rsqrtf(m));
  }
  return isnan(d) ? inf : d;
}

// key of distance d at bin position pos, and its insert into a bin's 4
// ascending keys
__device__ __forceinline__ int screen_key(float d, int epilogue, int pos) {
  int bits = __float_as_int(d);
  if (epilogue != 0) bits ^= (bits >> 31) & 0x7fffffff;
  return (bits & ~POS_MASK) | pos;
}

__device__ __forceinline__ void insert_key(int (&keys)[KEEP], int x) {
  // each new key from the old ones alone (no chain through the four), so
  // the inserts of a thread's many bins overlap
#pragma unroll
  for (int t = KEEP - 1; t > 0; --t) keys[t] = min(keys[t], max(keys[t - 1], x));
  keys[0] = min(keys[0], x);
}

// ---------------------------------------------------------------------------
// variant "mma": mma.sync from a cp.async ring, any D and alignment
// ---------------------------------------------------------------------------
namespace mma {

constexpr int BR = 128;         // base rows per step (= lanes)
constexpr int KC = 64;          // depth chunk per pipeline stage
constexpr int LDS = KC + 8;     // bf16 row stride (144 B: ldmatrix rows hit
                                // distinct bank groups)
constexpr int THREADS = 256;

typedef __nv_bfloat16 QTile[BQ][LDS];
typedef __nv_bfloat16 BTile[BR][LDS];

// one pipeline stage holds the operands the pass count needs: qhi [qlo]
// bhi [blo]; fewer operands leave room for more stages
__host__ __device__ constexpr int stage_bytes(int passes) {
  return ((passes >= 2 ? 2 : 1) * BQ + (passes >= 3 ? 2 : 1) * BR) * LDS *
         2;
}
__host__ __device__ constexpr int stages_for(int passes) {
  return passes == 1 ? 6 : passes == 2 ? 4 : 3;
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

// rows [row0, row0 + nrows_tile) x columns [k0, k0 + KC) of a (rows, D)
// bf16 matrix into a stage tile; rows >= nrows_total and columns >= D read
// as zero. vec: D % 8 == 0 and 16-byte aligned rows (cp.async path).
template <int NROWS>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* __restrict__ src,
    int row0, int nrows_total, int D, int k0, bool vec) {
  if (vec) {
    constexpr int PER_ROW = KC / 8;
#pragma unroll
    for (int v = threadIdx.x; v < NROWS * PER_ROW; v += THREADS) {
      int r = v / PER_ROW, c = (v % PER_ROW) * 8;
      int gr = row0 + r, gc = k0 + c;
      bool ok = gr < nrows_total && gc < D;
      const __nv_bfloat16* g = ok ? src + (size_t)gr * D + gc : src;
      cp_async16(&dst[r][c], g, ok);
    }
  } else {
    for (int v = threadIdx.x; v < NROWS * KC; v += THREADS) {
      int r = v / KC, c = v % KC;
      int gr = row0 + r, gc = k0 + c;
      __nv_bfloat16 val = __float2bfloat16(0.0f);
      if (gr < nrows_total && gc < D) val = src[(size_t)gr * D + gc];
      dst[r][c] = val;
    }
  }
}

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
screen_keys_kernel(const __nv_bfloat16* __restrict__ qhi,
                   const __nv_bfloat16* __restrict__ qlo,
                   const __nv_bfloat16* __restrict__ bhi,
                   const __nv_bfloat16* __restrict__ blo,
                   const float* __restrict__ qn,
                   const float* __restrict__ bn,
                   int* __restrict__ out,
                   int Q, int B, int D, int mega_rows, int n_mega,
                   int epilogue, int vec) {
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

  const int q0 = blockIdx.x * BQ;
  const int mega = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wq = warp / 4;          // query rows 32*wq .. +32
  const int wb = warp % 4;          // lanes 32*wb .. +32
  const int gid = lane / 4;         // mma group id
  const int tig = lane % 4;         // thread in group
  const int n_pos = mega_rows / BR;
  const int n_chunks = (D + KC - 1) / KC;
  const int total = n_pos * n_chunks;
  const int qrows = min(BQ, Q - q0);
  const __nv_bfloat16* qhi_b = qhi + (size_t)q0 * D;
  const __nv_bfloat16* qlo_b = qlo + (size_t)q0 * D;
  const bool use_vec = vec != 0;

  // this thread's accumulator rows: q = wq*32 + mi*16 + gid + 8*h
  float qn_r[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int qq = wq * 32 + mi * 16 + gid + 8 * h;
      qn_r[mi][h] = qq < qrows ? qn[q0 + qq] : 0.0f;
    }

  int keys[2][4][4][KEEP];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int t = 0; t < KEEP; ++t) keys[mi][ni][c][t] = 0x7fffffff;

  float bn_r[4][2];
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;

  auto issue = [&](int it) {
    if (it < total) {
      const int step = it / n_chunks;
      const int k0 = (it % n_chunks) * KC;
      const int r0 = mega * mega_rows + step * BR;
      const int sg = it % STAGES;
      load_tile<BQ>(q_hi(sg), qhi_b, 0, qrows, D, k0, use_vec);
      load_tile<BR>(b_hi(sg), bhi, r0, B, D, k0, use_vec);
      if (passes >= 2) load_tile<BQ>(q_lo(sg), qlo_b, 0, qrows, D, k0, use_vec);
      if (passes >= 3) load_tile<BR>(b_lo(sg), blo, r0, B, D, k0, use_vec);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage every thread finished reading in iteration it-1
    issue(it + STAGES - 1);

    const int sg = it % STAGES;
    if (it % n_chunks == 0) {
      // this step's base norms, fetched while its product runs
      const int r0 = mega * mega_rows + (it / n_chunks) * BR;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + wb * 32 + ni * 8 + 2 * tig + e;
          bn_r[ni][e] = row < B ? bn[row] : __int_as_float(0x7f800000);
        }
    }
    const __nv_bfloat16(*sqh)[LDS] = q_hi(sg);
    const __nv_bfloat16(*sql)[LDS] = q_lo(sg);
    const __nv_bfloat16(*sbh)[LDS] = b_hi(sg);
    const __nv_bfloat16(*sbl)[LDS] = b_lo(sg);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
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

    if (it % n_chunks == n_chunks - 1) {
      // epilogue: the step's row for each of this thread's lane bins
      const int step = it / n_chunks;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bnv = bn_r[ni][e];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 2 * h + e;
              float d = screen_dist(acc[mi][ni][c], qn_r[mi][h], bnv,
                                    passes, epilogue);
              insert_key(keys[mi][ni][c], screen_key(d, epilogue, step));
              acc[mi][ni][c] = 0.0f;
            }
        }
    }
  }
  cp_async_wait<0>();

  const size_t width = (size_t)n_mega * KEEP * BR;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qq = wq * 32 + mi * 16 + gid + 8 * h;
      if (qq >= qrows) continue;
      int* orow = out + (size_t)(q0 + qq) * width + (size_t)mega * KEEP * BR;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ln = wb * 32 + ni * 8 + 2 * tig + e;
#pragma unroll
          for (int t = 0; t < KEEP; ++t)
            orow[t * BR + ln] = keys[mi][ni][2 * h + e][t];
        }
    }
}

template <int PASSES>
int launch(const void* qhi, const void* qlo, const void* bhi, const void* blo,
           const void* qn, const void* bn, void* out, int Q, int B, int D,
           int mega_rows, int n_mega, int epilogue, int vec,
           cudaStream_t stream) {
  const int smem = stages_for(PASSES) * stage_bytes(PASSES);
  cudaError_t err = cudaFuncSetAttribute(
      screen_keys_kernel<PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, n_mega);
  screen_keys_kernel<PASSES><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)qhi, (const __nv_bfloat16*)qlo,
      (const __nv_bfloat16*)bhi, (const __nv_bfloat16*)blo,
      (const float*)qn, (const float*)bn, (int*)out, Q, B, D, mega_rows,
      n_mega, epilogue, vec);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// variant "wgmma": wgmma from a TMA/mbarrier ring, rows TMA can describe
// ---------------------------------------------------------------------------
namespace wgk {

constexpr int STEP = 2 * LANES;   // base rows per step: two positions a lane
constexpr int BOX = 64;           // rows per TMA box (queries, or base rows)
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 3 * wg::WG_THREADS;   // two consumers, one producer
constexpr int SMEM_MAX = 232448;  // 227 KB a block may use
constexpr int BAR_BYTES = 256;    // room for the ring's barriers
constexpr int BN_BYTES = 2 * 2 * LANES * 4;   // staged base norms, see below

// A ring slot holds one depth chunk of the operands the pass count reads:
// qhi [qlo] (64 rows each), bhi [blo] (256 rows each: warpgroup 0's two
// boxes, then warpgroup 1's). At 3 passes the chunk is 32 columns, so that
// five slots fit as they do at 1 pass.
template <int PASSES>
struct Cfg {
  static constexpr int KC = PASSES == 3 ? 32 : 64;
  static constexpr int RB = KC * 2;                   // bytes per tile row
  static constexpr int NA = PASSES >= 2 ? 2 : 1;
  static constexpr int NB = PASSES >= 3 ? 2 : 1;
  static constexpr int A_BYTES = BQ * RB;
  static constexpr int B_BYTES = STEP * RB;
  static constexpr int STAGE = NA * A_BYTES + NB * B_BYTES;
  static constexpr int STAGES =
      (SMEM_MAX - wg::TILE_ALIGN - BAR_BYTES - BN_BYTES) / STAGE;
  static constexpr int SMEM =
      STAGES * STAGE + wg::TILE_ALIGN + BAR_BYTES + BN_BYTES;
  static_assert(STAGES >= 3 && 16 * STAGES <= BAR_BYTES, "ring depth");
};

template <int PASSES, int EPILOGUE>
__global__ void __launch_bounds__(THREADS, 1)
screen_keys_wgmma(const __grid_constant__ CUtensorMap m_qhi,
                  const __grid_constant__ CUtensorMap m_qlo,
                  const __grid_constant__ CUtensorMap m_bhi,
                  const __grid_constant__ CUtensorMap m_blo,
                  const float* __restrict__ qn,
                  const float* __restrict__ bn,
                  int* __restrict__ out,
                  int Q, int B, int D, int mega_rows, int n_mega) {
  using C = Cfg<PASSES>;
  constexpr int epilogue = EPILOGUE;
  extern __shared__ unsigned char smem_raw[];
  // the same offset in every block of the cluster (multicast lands there)
  const uint32_t tiles = (wg::smem_u32(smem_raw) + wg::TILE_ALIGN - 1) &
                         ~static_cast<uint32_t>(wg::TILE_ALIGN - 1);
  const uint32_t bars = tiles + C::STAGES * C::STAGE;
  const uint32_t cl = wg::cluster_nctarank();
  const uint32_t rank = wg::cluster_ctarank();

  const int q0 = blockIdx.x * BQ;     // may lie past Q in a surplus block
  const int mega = blockIdx.y;
  const int n_pos = mega_rows / LANES;
  const int n_steps = (n_pos + 1) / 2;
  const int n_chunks = (D + C::KC - 1) / C::KC;

  if (threadIdx.x == 0) {
    wg::ring_init(bars, C::STAGES, CONSUMER_WARPS, cl);
    wg::fence_barrier_init();
  }
  // no block may multicast into, or arrive on, barriers not yet initialised
  wg::cluster_sync();

  if (threadIdx.x >= 2 * wg::WG_THREADS) {
    // ===== producer warpgroup: one thread starts every TMA load =====
    wg::reg_dealloc<40>();
    if (threadIdx.x == 2 * wg::WG_THREADS) {
      wg::Ring ring(bars, C::STAGES);
      const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
      for (int step = 0; step < n_steps; ++step) {
        const int r0 = mega * mega_rows + step * STEP;
        for (int kc = 0; kc < n_chunks; ++kc) {
          ring.acquire(C::STAGE);
          const uint32_t tile = tiles + ring.slot * C::STAGE;
          const int k0 = kc * C::KC;
          wg::tma_load_2d(tile, &m_qhi, ring.full(), k0, q0, 0, false);
          if (PASSES >= 2)
            wg::tma_load_2d(tile + C::A_BYTES, &m_qlo, ring.full(), k0, q0,
                            0, false);
          // box b: operand b / 4 (hi, lo), warpgroup (b / 2) % 2, 128-row
          // half b % 2; this block's share goes to every block of the cluster
          for (int b = rank; b < 4 * C::NB; b += cl) {
            const uint32_t dst = tile + C::NA * C::A_BYTES +
                                 (b >> 2) * C::B_BYTES +
                                 (b & 3) * BOX * C::RB;
            const int row = r0 + (b & 1) * LANES + ((b >> 1) & 1) * BOX;
            wg::tma_load_2d(dst, (b >> 2) ? &m_blo : &m_bhi, ring.full(), k0,
                            row, mask, cl > 1);
          }
          ring.advance();
        }
      }
    }
  } else {
    // ===== consumer warpgroups: lanes 64w .. 64w+63 of both halves =====
    wg::reg_alloc<232>();
    const int w = threadIdx.x / wg::WG_THREADS;
    const int tid = threadIdx.x % wg::WG_THREADS;
    const int gid = (tid % 32) / 4;       // row within the warp's 8-row group
    const int tig = tid % 4;              // column pair within an 8-column block
    const int qrow = (tid / 32) * 16 + gid;   // this thread's rows: qrow, +8
    const int qrows = min(BQ, Q - q0);        // <= 0 in a surplus block

    float qn_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qn_r[h] = qrow + 8 * h < qrows ? qn[q0 + qrow + 8 * h] : 0.0f;

    // bins (query row half h, lane 64w + 8j + 2 tig + e)
    int keys[2][8][2][KEEP];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int t = 0; t < KEEP; ++t) keys[h][j][e][t] = 0x7fffffff;

    // acc[4 (j + 8 half) + 2h + e]: columns 0..63 are the step's first
    // 128-row half, 64..127 the second
    float acc[64];
    wg::Ring ring(bars, C::STAGES);
    int prev_slot = 0;
    // The step's 128 base norms of this warpgroup's lanes: each thread
    // fetches one at the step's start (the products hide the latency) and
    // hands it to the others through shared memory at the epilogue; the
    // buffers alternate, and the next write of a buffer lies behind the
    // next step's barrier, after every reader of this one is done.
    float* bn_s = reinterpret_cast<float*>(
                      smem_raw + (bars - wg::smem_u32(smem_raw)) + BAR_BYTES) +
                  w * 2 * LANES;
    for (int step = 0; step < n_steps; ++step) {
      const int bn_row = mega * mega_rows + step * STEP + (tid >> 6) * LANES +
                         w * BOX + (tid & 63);
      const float bn_mine =
          bn_row < B ? __ldg(bn + bn_row) : __int_as_float(0x7f800000);
      for (int kc = 0; kc < n_chunks; ++kc) {
        ring.wait_full();
        const uint32_t tile = tiles + ring.slot * C::STAGE;
        const uint32_t a_hi = tile, a_lo = tile + C::A_BYTES;
        const uint32_t b_hi = tile + C::NA * C::A_BYTES + w * LANES * C::RB;
        const uint32_t b_lo = b_hi + C::B_BYTES;
        wg::wgmma_fence();
        wg::wgmma_chunk<C::KC>(acc, a_hi, b_hi, kc == 0);
        if (PASSES >= 2) wg::wgmma_chunk<C::KC>(acc, a_lo, b_hi, false);
        if (PASSES >= 3) wg::wgmma_chunk<C::KC>(acc, a_hi, b_lo, false);
        wg::wgmma_commit();
        if (kc > 0) {
          // the chunk before this one has retired: give its slot back
          wg::wgmma_wait<1>();
          wg::ring_release(ring.empty0, prev_slot, cl);
        }
        prev_slot = ring.slot;
        ring.advance();
      }
      wg::wgmma_wait<0>();
      wg::ring_release(ring.empty0, prev_slot, cl);
      wg::fence_acc(acc);

      // epilogue: two rows for each of this thread's lane bins
      float* bn_step = bn_s + (step & 1) * LANES;
      bn_step[tid] = bn_mine;
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "n"(wg::WG_THREADS)
                   : "memory");
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = 2 * step + half;
        if (pos < n_pos) {      // an odd n_pos ends inside the last step
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 bn2 = *reinterpret_cast<const float2*>(
                bn_step + half * BOX + 8 * j + 2 * tig);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float d =
                    screen_dist(acc[4 * (j + 8 * half) + 2 * h + e], qn_r[h],
                                e ? bn2.y : bn2.x, PASSES, epilogue);
                insert_key(keys[h][j][e], screen_key(d, epilogue, pos));
              }
          }
        }
      }
    }

    const size_t width = (size_t)n_mega * KEEP * LANES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qq = qrow + 8 * h;
      if (qq < qrows) {
        int* orow = out + (size_t)(q0 + qq) * width +
                    (size_t)mega * KEEP * LANES + w * BOX + 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < KEEP; ++t)
            *reinterpret_cast<int2*>(orow + t * LANES + 8 * j) =
                make_int2(keys[h][j][0][t], keys[h][j][1][t]);
      }
    }
  }
  // no block leaves while a peer may still multicast into it or arrive on
  // its barriers
  wg::cluster_sync();
}

// Blocks per cluster for nqb query blocks x n_mega megas: the larger of 4
// and 2 whose rounding of the grid adds at most 1/16 of surplus blocks, or
// whose grid fits the card's SMs at once anyway (surplus blocks then cost
// no time).
inline int pick_cluster(int nqb, int n_mega) {
  for (int cl = 4; cl >= 2; cl /= 2) {
    const int up = (nqb + cl - 1) / cl * cl;
    if ((up - nqb) * 16 <= nqb || (cl <= nqb && (long long)up * n_mega <= 128))
      return cl;
  }
  return 1;
}

template <int PASSES, int EPILOGUE>
int launch_epilogue(const void* qhi, const void* qlo, const void* bhi,
                    const void* blo, const void* qn, const void* bn,
                    void* out, int Q, int B, int D, int mega_rows, int n_mega,
                    int cluster, cudaStream_t stream) {
  using C = Cfg<PASSES>;
  CUtensorMap m_qhi, m_qlo, m_bhi, m_blo;
  int e = wg::make_map_2d(&m_qhi, qhi, Q, D, BOX, C::KC);
  if (e == 0) e = wg::make_map_2d(&m_qlo, qlo, Q, D, BOX, C::KC);
  if (e == 0) e = wg::make_map_2d(&m_bhi, bhi, B, D, BOX, C::KC);
  if (e == 0) e = wg::make_map_2d(&m_blo, blo, B, D, BOX, C::KC);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      screen_keys_wgmma<PASSES, EPILOGUE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (Q + BQ - 1) / BQ;
  const int cl = cluster > 0 ? cluster : pick_cluster(nqb, n_mega);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nqb + cl - 1) / cl * cl, n_mega);
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
  err = cudaLaunchKernelEx(&cfg, screen_keys_wgmma<PASSES, EPILOGUE>, m_qhi,
                           m_qlo, m_bhi, m_blo, (const float*)qn,
                           (const float*)bn, (int*)out, Q, B, D, mega_rows,
                           n_mega);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the epilogue is a template parameter of this variant: its 64 distances a
// step are straight-line code without a branch or a select per element
template <int PASSES>
int launch(const void* qhi, const void* qlo, const void* bhi, const void* blo,
           const void* qn, const void* bn, void* out, int Q, int B, int D,
           int mega_rows, int n_mega, int epilogue, int cluster,
           cudaStream_t stream) {
#define NW_EPILOGUE(E)                                                     \
  return launch_epilogue<PASSES, E>(qhi, qlo, bhi, blo, qn, bn, out, Q, B, \
                                    D, mega_rows, n_mega, cluster, stream)
  if (epilogue == 0) NW_EPILOGUE(0);
  if (epilogue == 1) NW_EPILOGUE(1);
  NW_EPILOGUE(2);
#undef NW_EPILOGUE
}

}  // namespace wgk

}  // namespace

// variant: 0 = "mma", 1 = "wgmma" (needs vec: D % 8 == 0 and 16-byte aligned
// operands); cluster: blocks per cluster of the wgmma variant (1, 2 or 4),
// 0 = chosen from the grid. The unused operands of a pass count (qlo, blo)
// alias qhi, bhi. Returns 0, a CUDA error, or a tensor-map code of
// wgmma_mainloop.cuh.
extern "C" int screen_keys_launch(const void* qhi, const void* qlo,
                                  const void* bhi, const void* blo,
                                  const void* qn, const void* bn, void* out,
                                  int Q, int B, int D, int mega_rows,
                                  int n_mega, int passes, int epilogue,
                                  int vec, int variant, int cluster,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (passes < 1 || passes > 3 || epilogue < 0 || epilogue > 2 ||
      variant < 0 || variant > 1 ||
      (variant == 1 && !vec) ||
      (cluster != 0 && cluster != 1 && cluster != 2 && cluster != 4))
    return (int)cudaErrorInvalidValue;
#define NW_LAUNCH(NS, P, LAST)                                              \
  return NS::launch<P>(qhi, qlo, bhi, blo, qn, bn, out, Q, B, D, mega_rows, \
                       n_mega, epilogue, LAST, st)
  if (variant == 1) {
    if (passes == 1) NW_LAUNCH(wgk, 1, cluster);
    if (passes == 2) NW_LAUNCH(wgk, 2, cluster);
    NW_LAUNCH(wgk, 3, cluster);
  }
  if (passes == 1) NW_LAUNCH(mma, 1, vec);
  if (passes == 2) NW_LAUNCH(mma, 2, vec);
  NW_LAUNCH(mma, 3, vec);
#undef NW_LAUNCH
}
