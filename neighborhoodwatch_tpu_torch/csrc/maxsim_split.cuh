// The MaxSim engines' tensor-core tile, variant "split", shared by M1
// (csrc/maxsim_dense.cu) and M2 (csrc/maxsim_pairs.cu), for Hopper
// (sm_90a). The fp32 FFMA tile (csrc/maxsim_tile.cuh) stays beside it as
// the variant "ffma"; both compute the same function:
//   sim(t, s)  = <q_t, d_s>
//   tok(t)     = max over doc tokens s of (dm ? sim(t, s) : -1e30), NaN if
//                any selected value is NaN (max.NaN)
//   score(p,e) = sum over query tokens t of (qm ? tok(t) : 0)
// The masks select, never multiply: a masked token may hold NaN or inf.
//
// ---- The arithmetic: fp32-exact products on the bf16 tensor cores ----
// Split: bf16x6. Each fp32 operand x becomes three bf16 pieces by
// truncation: x0 = x with its low 16 bits cleared, x1 the same of
// r1 = x - x0, x2 = r1 - x1 (r1 and r1 - x1 are exact, so x = x0 + x1 + x2
// for every finite x whose last bit lies at or above 2^-133); |x1| < 2^-7
// |x|, |x2| < 2^-14 |x|. Truncation never rounds a finite value up to inf,
// and the split is bit masks and subtractions. Taken over 3xTF32 because
// it runs on the bf16 wgmma that csrc/wgmma_mainloop.cuh already drives,
// moves 6 bytes an element where 3xTF32 moves 8, and drops less: the six
// products of order <= 2 (x2 y0, x1 y1, x0 y2, x1 y0, x0 y1, x0 y0), each
// exact in fp32, leave out x1 y2 + x2 y1 + x2 y2 < 16.0625 2^-24 |x y|.
// At precision "default" and "high" the operands are bf16 values already
// (ops/maxsim_fused.py:maxsim_operands): one piece, one exact product.
//
// Promotion: the tensor cores sum x0 y0 over a chunk of KC = 16 dim
// elements (one wgmma k-step) into an accumulator `main` zeroed by the
// chunk's wgmma (scale-d = 0), which is then added into an fp32 register
// total with a round-to-nearest add. The five small products, order 2
// (x2 y0, x1 y1, x0 y2) then order 1 (x1 y0, x0 y1) in every chunk, sum in
// a second accumulator `small` over the whole dim: its terms are under
// 2^-6 of A, so its long chain of adds stays inside the budget, and it
// joins the total with one more round-to-nearest add at the end. Two
// independent chains also keep the tensor cores busier than one.
//
// Error model, relative to A = sum_k |q_k d_k|, assuming every add inside
// the tensor cores truncates (relative error < 2^-23 an add; the
// hardware's exact model is not documented) and bounding each add by the
// absolute sum of the terms added before it (|x1| < 2^-7 |x|, |x2| <
// 2^-14 |x|, so small's terms sum to < (2^-6 + 3 2^-14) A):
//   dropped terms                  16.0625 2^-24            (1 piece: 0)
//   main, KC adds a chunk          2 KC 2^-24
//   small, 5 dim adds              dim (10/64 + 30/16384) 2^-24
//                                                       (1 piece: none)
//   promotion, dim/KC adds         dim/KC (1 + 2^-16) 2^-24
// The plan (ops/maxsim_fused.py:plan) admits a dim only where this total
// stays at or below dim 2^-24, the dot budget of ops/maxsim_kernel.py:
// maxsim_acc_rel: pieces = 3 at dim 128 gives 16.06 + 32 + 20.2 + 8.0 =
// 76.3 (dims 64 and up are admitted), pieces = 1 at 128 gives 40 (48 and
// up). error_bound() below is the same formula, and the launchers refuse a
// dim it does not admit. A chunk of 32 would halve the promotions but
// needs 24 fragment registers where at most 168 a thread are to be had
// (see Layout). The sum over query tokens stays an fp32 round-to-nearest
// sum in a fixed order. No atomics, every reduction in a fixed order: two
// launches give equal bits.
//
// Non-finite values: where inf meets a zero piece of the other side in a
// cross product, inf * 0 = NaN where the plain product has inf. So small
// joins the total only where the sum is not NaN: a NaN there comes from a
// non-finite x0 or y0 (a residual piece of inf is NaN too), and then x0
// y0 alone, summed, holds the plain version's inf or NaN (the truncated x0
// keeps x's sign and is 0 only for x = 0 or |x| < 2^-133; a NaN is made
// canonical before it is cut: a payload in its low bits alone would
// truncate to inf). So NaN, +-inf and -1e30 land where the plain version
// puts them.
//
// ---- Layout ----
// Doc tokens on M, query tokens on N. A block has two consumer warpgroups
// and a producer warp. The query side is the wgmma B operand, N = 64
// columns a warpgroup: M1's block holds 128 query-token columns (128 /
// tq_p passages of tq_p tokens, tq_p the power of two >= Tq, 8 to 64),
// warpgroup w the columns 64 w ..; M2's block one passage's tq_p columns
// (16 to 64), both warpgroups. The consumers load it once, split it into
// three K-major bf16 tiles in 128-byte swizzled rows (the layout wgmma's
// descriptor reads) and keep it resident. The doc side streams through a
// ring of slots of 32 fp32 columns loaded by TMA with 128-byte swizzle:
// M1's slot is 64 doc-token rows (one box of 64 / td_p consecutive docs),
// which both warpgroups read, so a doc byte from L2 meets 128 query
// columns; M2's is 128 rows, one box a candidate read by id (TMA has no
// gather, but a candidate's tokens are contiguous), warpgroup w the rows
// 64 w ..; td_p is the power of two >= Td, 8 to 64. Beside each M1 tile's
// first slot the producer writes its rows' states (the doc mask,
// padding), so that epilogue reads no device memory. Each consumer thread
// reads the eight fp32 values of its m16n8k16 fragment of the slot's
// rows, splits them in registers into the wgmma A operand (no split copy
// of any operand is ever written) and releases the slot before its last
// wgmmas. A doc's td_p tokens are then rows of one warp (td_p <= 16) or of
// two or four warps, and both reductions are register and shuffle work:
// the max over a doc's tokens across the rows' lanes (and warps, through
// 1 KB of shared memory a warp), the sum over a passage's tokens across
// the columns. Registers at N = 64: 32 for the total, 64 for the two
// accumulators, 12 for the fragments. ptxas gives a thread at most 168
// (a block of 9 warps puts 3 on one SM partition; with a producer
// warpgroup instead it ignored setmaxnreg here), which leaves no room for a second set to overlap a
// chunk's promotion with the next one's wgmmas: the kernel waits for
// each chunk (measured: both a pipelined and a single-accumulator
// version, which ptxas serialized, ran slower). One block an SM (up to
// 200 KB of shared memory: the query tiles, up to 12 slots).
//
// Bound on this card: operations, six bf16 products (three at 1 piece) of
// 2 Q Tq D Td dim FLOP at 989 TFLOP/s: 1.168 ms at M1's stream fallback
// step (718 x 32 x 128 against 2,048 x 16), 0.204 ms at M2's re-rank
// (1,000 x 256 candidates over 8,192 x 16).

#pragma once

#include <math.h>

#include "wgmma_mainloop.cuh"

namespace msplit {

constexpr int kConsumers = 2 * wg::WG_THREADS;  // two warpgroups
constexpr int kThreads = kConsumers + 32;        // and a producer warp
constexpr int kConsumerWarps = 8;
constexpr int kSlotCols = 32;                  // fp32 columns a slot
constexpr int kBarBytes = 256;
constexpr int kMaxStages = 12;
constexpr int kMaxBBytes = 96 * 1024;          // the resident query tiles
constexpr int kSmemBlock = 232448;             // a block's at most
constexpr int kErrPlan = 22001;                // a plan the launcher refuses
constexpr int kKC = 16;                        // dims a tensor-core chunk
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---- the plan's arithmetic, mirrored by ops/maxsim_fused.py ----

// doc-token rows a ring slot: M1's 64 are read by both warpgroups, M2's
// 128 are two warpgroups' 64
__host__ __device__ constexpr int slot_rows(bool pairs) {
  return pairs ? 128 : 64;
}

// the dot's error bound in units of 2^-24 sum_k |q_k d_k| (see the top)
inline double error_bound(int dim, int kc, int pieces) {
  const double chunks = (double)((dim + kc - 1) / kc) * (1.0 + 1.0 / 65536);
  if (pieces == 1) return 2.0 * kc + chunks;
  return 16.0625 + 2.0 * kc + dim * (10.0 / 64 + 30.0 / 16384) + chunks;
}

// the dims the plan admits: whole k-steps, the model's bound within dim
// 2^-24
inline bool admits(int dim, int pieces) {
  return dim % kKC == 0 && error_bound(dim, kKC, pieces) <= dim;
}

// the resident query tiles: pieces x 64-column tiles x bc rows of 128 B
inline int b_bytes(int bc, int dim, int pieces) {
  return pieces * ((dim + 63) / 64) * bc * 128;
}

// dynamic shared memory of a block: alignment slack, the resident query
// tiles (bc columns), barriers, the cross-warp max tiles (n columns a
// warpgroup), the column masks, M1's row states (a byte a row of a
// slot); then as many ring slots as fit (at most kMaxStages)
inline int fixed_bytes(int n, int bc, int dim, int pieces) {
  return wg::TILE_ALIGN + b_bytes(bc, dim, pieces) + kBarBytes +
         2 * 4 * n * 4 + bc + kMaxStages * 64;
}

inline int stages_for(bool pairs, int n, int bc, int dim, int pieces) {
  const int s = (kSmemBlock - fixed_bytes(n, bc, dim, pieces)) /
                (slot_rows(pairs) * kSlotCols * 4);
  return s < kMaxStages ? s : kMaxStages;
}

inline int smem_bytes(bool pairs, int n, int bc, int dim, int pieces) {
  return fixed_bytes(n, bc, dim, pieces) +
         stages_for(pairs, n, bc, dim, pieces) * slot_rows(pairs) *
             kSlotCols * 4;
}

inline int pow2_at_least(int x, int lo) {
  int p = lo;
  while (p < x) p <<= 1;
  return p;
}

// ---- device pieces ----

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the upper halves of a (low half of the result) and b: two bf16 by
// truncation, a in the lower column
__device__ __forceinline__ uint32_t hi_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// the pieces of two neighbouring values, packed as bf16 pairs (a in the
// lower column). A NaN is made canonical first: a payload in its low bits
// alone would truncate to inf. An inf's residual pieces are NaN; they
// reach only the small products, which the total leaves out where x0 y0
// is not finite.
template <int PIECES>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&p)[PIECES]) {
  a = a != a ? __int_as_float(0x7fffffff) : a;
  b = b != b ? __int_as_float(0x7fffffff) : b;
  p[0] = hi_pair(a, b);
  if constexpr (PIECES == 3) {
    const float ra = __fsub_rn(a, trunc_bf16(a));
    const float rb = __fsub_rn(b, trunc_bf16(b));
    p[1] = hi_pair(ra, rb);
    p[2] = hi_pair(__fsub_rn(ra, trunc_bf16(ra)),
                   __fsub_rn(rb, trunc_bf16(rb)));
  }
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// an mbarrier wait that traps after ~2^34 cycles (seconds) instead of
// spinning forever: a broken ring fails the launch rather than the card
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

// named barriers: 1 the consumers', 2 and 3 a warpgroup's epilogue
constexpr int kEpiBar = 2;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- wgmma with A from registers, B K-major in shared memory ----
// d (64 x N fp32) (+)= A (64 x 16 bf16: the m16n8k16 fragment of the
// warp's 16 rows) . B (N x 16)^T; d[4j + 2h + e] is row half h, column
// 8j + 2 (t % 4) + e; scale_d = 0 overwrites d.

#define MS_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_rs<16>(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : MS_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : MS_ACC8(d, 0), MS_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MS_ACC8(d, 0), MS_ACC8(d, 8), MS_ACC8(d, 16), MS_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef MS_ACC8

// the six products' pieces in the order they go in: order 2, 1, 0
__host__ __device__ constexpr int phase_a(int ph) {
  return ph == 0 ? 2 : ph == 1 || ph == 3 ? 1 : 0;
}
__host__ __device__ constexpr int phase_b(int ph) {
  return ph == 2 ? 2 : ph == 1 || ph == 4 ? 1 : 0;
}

// keeps the fragment registers live, and unmoved, until after the wait
// that retires the wgmmas reading them
template <int P>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile("" : "+r"(f[p][r]) :: "memory");
}

// ---- the kernel ----

struct Args {
  const float* q;            // (Q, Tq, dim) query tokens
  const uint8_t* qm;         // (Q, Tq)
  const float* d;            // (D, Td, dim) doc tokens
  const uint8_t* dm;         // (D, Td)
  const long long* ids;      // M2: (Q, M) candidate ids
  float* out;                // M1 (Q, D), M2 (Q, M)
  long long D;               // docs
  int Q, Tq, Td, dim, M;
  int tq_p, td_p;            // query / doc tokens a passage / doc slot
  int qpt;                   // M1: passages a block's query tile
  int n_tiles;               // M1: doc tiles of a slot's rows
  int cand_block;            // M2: candidates a block (blockIdx.y)
  int stages;
};

// PAIRS = false (M1): block (x, y) takes query tile x (qpt passages of
//   tq_p columns, 2 N in all: warpgroup w the columns N w .. N w + N - 1)
//   and the 64-row doc tiles y, y + gridDim.y, ... (both warpgroups read
//   every row); out (Q, D), a NaN score -1e30.
// PAIRS = true (M2): block (x, y) takes query x (N columns, both
//   warpgroups) and its candidates y * cand_block .. in 128-row tiles
//   (warpgroup w the rows 64 w ..); out (Q, M), NaN kept, an id outside
//   [0, D) NaN.
template <int N, int PIECES, bool PAIRS>
__global__ void __launch_bounds__(kThreads)
maxsim_split_kernel(const __grid_constant__ CUtensorMap m_doc,
                    const Args g) {
  constexpr int NJ = N / 8;                 // column groups a thread
  constexpr int NACC = N / 2;
  constexpr int BC = PAIRS ? N : 2 * N;     // the block's query columns
  constexpr int ROWS = slot_rows(PAIRS);    // doc-token rows a slot
  constexpr int SLOT = ROWS * kSlotCols * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + wg::TILE_ALIGN - 1) &
                        ~static_cast<uint32_t>(wg::TILE_ALIGN - 1);
  const int nkt = (g.dim + 63) / 64;        // 64-column B tiles a piece
  const int nslots = (g.dim + kSlotCols - 1) / kSlotCols;
  const uint32_t b_tiles = base;
  const uint32_t ring0 = b_tiles + PIECES * nkt * BC * 128;
  const uint32_t bars = ring0 + g.stages * SLOT;
  unsigned char* const gen =
      smem_raw + (bars - raw) + kBarBytes;  // generic view past the bars
  float* const red = reinterpret_cast<float*>(gen);   // [2][4][N]
  uint8_t* const col_on = gen + 2 * 4 * N * 4;        // [BC]
  // M1: the state of each row of a tile, written by the producer beside
  // the tile's first slot: 2 a value, 1 masked (-1e30), 0 no token
  uint8_t* const row_state = col_on + BC;             // [stages][64]

  const int tid = threadIdx.x;
  const long long qx = blockIdx.x;
  // M1: passages q0 .. q0 + qpt of this tile; M2: query qx alone
  const long long q0 = PAIRS ? qx : qx * g.qpt;
  const long long cand0 = PAIRS ? (long long)blockIdx.y * g.cand_block : 0;
  const long long cand_end =
      PAIRS ? min((long long)g.M, cand0 + g.cand_block) : 0;
  const int dpt = ROWS / g.td_p;            // docs (candidates) a tile
  const int tiles =
      PAIRS ? (int)((cand_end - cand0 + dpt - 1) / dpt)
            : (g.n_tiles - (int)blockIdx.y + (int)gridDim.y - 1) /
                  (int)gridDim.y;

  if (tid == 0) {
    wg::ring_init(bars, g.stages, kConsumerWarps, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ===== producer: warp 8 starts every TMA load =====
    const int lane = tid % 32;
    wg::Ring ring(bars, g.stages);
    for (int i = 0; i < tiles; ++i) {
      long long id = 0;
      if constexpr (PAIRS) {
        const long long j = cand0 + (long long)i * dpt + lane;
        if (lane < dpt && j < cand_end) {
          id = __ldg(g.ids + qx * g.M + j);
          if (id < 0 || id >= g.D) id = 0;    // loaded, never scored
        }
      }
      const int c2 = ((int)blockIdx.y + i * (int)gridDim.y) * dpt;
      for (int c = 0; c < nslots; ++c) {
        if (lane == 0) wait_or_trap(ring.empty(), ring.phase ^ 1);
        __syncwarp();
        if (!PAIRS && c == 0) {
          // the tile's row states, before the slot's arrival releases
          // them: both loads first, then the stores
          int st[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = lane + 32 * u;
            const long long e = (long long)c2 + r / g.td_p;
            const int s = r % g.td_p;
            st[u] = e >= g.D || s >= g.Td ? 0
                    : __ldg(g.dm + e * g.Td + s) ? 2 : 1;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            row_state[ring.slot * 64 + lane + 32 * u] = (uint8_t)st[u];
          __threadfence_block();
          __syncwarp();
        }
        if (lane == 0) wg::mbar_expect_tx(ring.full(), SLOT);
        __syncwarp();
        const uint32_t slot = ring0 + ring.slot * SLOT;
        if constexpr (PAIRS) {
          if (lane < dpt)
            wg::tma_load_3d(slot + lane * g.td_p * 128, &m_doc, ring.full(),
                            c * kSlotCols, 0, (int)id, 1, false);
        } else if (lane == 0) {
          wg::tma_load_3d(slot, &m_doc, ring.full(), c * kSlotCols, 0, c2,
                          1, false);
        }
        ring.advance();
      }
    }
    return;
  }

  // ===== consumers =====
  const int w = tid / wg::WG_THREADS;        // warpgroup
  const int warp = (tid % wg::WG_THREADS) / 32;   // warp in the warpgroup
  const int lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  // -- the query tiles, once: split into PIECES K-major bf16 tiles --
  for (int f = tid; f < BC * nkt * 8; f += kConsumers) {
    const int n = f / (nkt * 8), rem = f % (nkt * 8);
    const int kt = rem / 8, ch = rem % 8, k = kt * 64 + ch * 8;
    const long long p = PAIRS ? q0 : q0 + n / g.tq_p;
    const int t = PAIRS ? n : n % g.tq_p;
    const bool valid = p < g.Q && t < g.Tq && (PAIRS || n / g.tq_p < g.qpt);
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (valid && k < g.dim) {
      const float4* src = reinterpret_cast<const float4*>(
          g.q + (p * g.Tq + t) * g.dim + k);
      x0 = __ldg(src);
      x1 = __ldg(src + 1);
    }
    if (ch == 0 && kt == 0)
      col_on[n] = valid && g.qm[p * g.Tq + t] ? 1 : 0;
    uint32_t pc[4][PIECES];
    split_pair<PIECES>(x0.x, x0.y, pc[0]);
    split_pair<PIECES>(x0.z, x0.w, pc[1]);
    split_pair<PIECES>(x1.x, x1.y, pc[2]);
    split_pair<PIECES>(x1.z, x1.w, pc[3]);
#pragma unroll
    for (int pi = 0; pi < PIECES; ++pi)
      sts_v4(b_tiles + (pi * nkt + kt) * BC * 128 + n * 128 +
                 ((ch ^ (n & 7)) << 4),
             make_uint4(pc[0][pi], pc[1][pi], pc[2][pi], pc[3][pi]));
  }
  wg::fence_proxy_async();
  bar_sync(1, kConsumers);
  // this warpgroup's B columns
  const int col0 = PAIRS ? 0 : N * w;
  const uint32_t b_mine = b_tiles + col0 * 128;
  const uint32_t piece = nkt * BC * 128;     // bytes a B piece

  // tot: the dots' x0 y0 so far; main: a chunk's x0 y0; small: the other
  // five products over the whole dim
  float tot[NACC], main_acc[NACC], small_acc[NACC];
  wg::Ring ring(bars, g.stages);
  // this thread's slot rows row_lo and row_lo + 8
  const int row_lo = (PAIRS ? 64 * w : 0) + 16 * warp + gid;
  for (int i = 0; i < tiles; ++i) {
    int rs = 0;     // M1: the two rows' states, a byte each
    // the slot's two 16-column k-steps, a chunk each: the A fragments
    // split in registers, the products smallest first, then the promotion
    for (int c = 0; c < nslots; ++c) {
      wait_or_trap(ring.full(), ring.phase);
      const uint32_t slot = ring0 + ring.slot * SLOT;
      if (!PAIRS && c == 0)
        rs = row_state[ring.slot * 64 + row_lo] |
             (row_state[ring.slot * 64 + row_lo + 8] << 8);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t fa[PIECES][4];              // [piece][register]
        // rows row_lo, +8 (the same 16-byte chunk swizzle: gid), columns
        // ks 16 + 2 tig (+1) and + 8
        const uint32_t rb = slot + row_lo * 128 + (tig & 1) * 8;
        const uint32_t ca = (((4 * ks + (tig >> 1)) ^ gid) << 4);
        const uint32_t cb = (((4 * ks + 2 + (tig >> 1)) ^ gid) << 4);
        const float2 v00 = lds_f2(rb + ca);
        const float2 v10 = lds_f2(rb + 1024 + ca);
        const float2 v01 = lds_f2(rb + cb);
        const float2 v11 = lds_f2(rb + 1024 + cb);
        uint32_t p[PIECES];
        split_pair<PIECES>(v00.x, v00.y, p);
#pragma unroll
        for (int pi = 0; pi < PIECES; ++pi) fa[pi][0] = p[pi];
        split_pair<PIECES>(v10.x, v10.y, p);
#pragma unroll
        for (int pi = 0; pi < PIECES; ++pi) fa[pi][1] = p[pi];
        split_pair<PIECES>(v01.x, v01.y, p);
#pragma unroll
        for (int pi = 0; pi < PIECES; ++pi) fa[pi][2] = p[pi];
        split_pair<PIECES>(v11.x, v11.y, p);
#pragma unroll
        for (int pi = 0; pi < PIECES; ++pi) fa[pi][3] = p[pi];
        if (ks == 1) {
          // the slot's values are in registers: it goes back
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(ring.empty());
          ring.advance();
        }
        const int kcol = c * kSlotCols + ks * 16;
        const uint32_t kb =
            b_mine + (kcol / 64) * BC * 128;       // piece 0's tile
        const uint64_t koff = (uint64_t)((kcol % 64) / 8);
        const bool start = c == 0 && ks == 0;
        wg::wgmma_fence();
        if constexpr (PIECES == 3) {
          // order 2 (x2 y0, x1 y1, x0 y2), then order 1 (x1 y0, x0 y1)
#pragma unroll
          for (int ph = 0; ph < 5; ++ph)
            mma_rs<N>(small_acc, fa[phase_a(ph)],
                      wg::make_desc<128>(kb + phase_b(ph) * piece) + koff,
                      start && ph == 0 ? 0 : 1);
        }
        mma_rs<N>(main_acc, fa[0], wg::make_desc<128>(kb) + koff, 0);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(main_acc);
        if constexpr (PIECES == 3) wg::fence_regs(small_acc);
        fence_frags(fa);   // no register of a fragment reused before here
        // promotion: a round-to-nearest fp32 add into the total
#pragma unroll
        for (int x = 0; x < NACC; ++x)
          tot[x] = start ? main_acc[x] : __fadd_rn(tot[x], main_acc[x]);
      }
    }
    // the small products join with one more round-to-nearest add, where
    // they leave the dot a number: a NaN there comes from a non-finite x0
    // or y0, and x0 y0 alone holds the plain value (a cross product may be
    // inf * 0)
    if constexpr (PIECES == 3) {
#pragma unroll
      for (int x = 0; x < NACC; ++x) {
        const float t = __fadd_rn(tot[x], small_acc[x]);
        tot[x] = t != t ? tot[x] : t;
      }
    }

    // -- epilogue: the tile's 64 rows x N columns of dots are in tot --
    // the thread's two rows: state 2 a value, 1 masked (-1e30), 0 no
    // token, 5 an M2 id outside [0, D)
    int st[2];
    if constexpr (PAIRS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_lo + 8 * h;
        const int di = r / g.td_p, s = r % g.td_p;
        const long long j = cand0 + (long long)i * dpt + di;
        const bool valid = j < cand_end && s < g.Td;
        const long long e = valid ? __ldg(g.ids + qx * g.M + j) : 0;
        st[h] = !valid ? 0 : e < 0 || e >= g.D ? 5
                : __ldg(g.dm + e * g.Td + s) ? 2 : 1;
      }
    } else {
      st[0] = rs & 0xff;
      st[1] = rs >> 8;
    }
    // the doc mask selects: a value, -1e30, or nothing (-inf)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = tot[4 * j + 2 * h + e];
          v = st[h] == 2 ? v : st[h] != 0 ? kNeg : -INFINITY;
        }
    // the max over each doc's tokens: the rows of a half warp (td_p 8),
    // of a warp (16), of two or four warps (32, 64)
    const int halves = g.td_p == 8 ? 2 : 1;
    if (halves == 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tot[4 * j + e] = max_nan(tot[4 * j + e], tot[4 * j + 2 + e]);
    }
#pragma unroll
    for (int x = 0; x < NACC; ++x) {
      if (halves == 1 && (x & 2)) continue;
      float v = tot[x];
      v = max_nan(v, __shfl_xor_sync(kFull, v, 4));
      v = max_nan(v, __shfl_xor_sync(kFull, v, 8));
      v = max_nan(v, __shfl_xor_sync(kFull, v, 16));
      tot[x] = v;
    }
    const int group = g.td_p / 16;          // warps a doc (td_p >= 32)
    const bool writer_warp = group <= 1 || warp % group == 0;
    if (group > 1) {
      // the doc's other warps hand their maxima to its first warp, which
      // alone writes the scores
      float* rw = red + (w * 4 + warp) * N;
      if (gid == 0 && !writer_warp) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<float2*>(rw + 8 * j + 2 * tig) =
              make_float2(tot[4 * j], tot[4 * j + 1]);
      }
      bar_sync(kEpiBar + w, wg::WG_THREADS);
      if (writer_warp) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          for (int u = warp + 1; u < warp + group; ++u) {
            const float2 o = *reinterpret_cast<const float2*>(
                red + (w * 4 + u) * N + 8 * j + 2 * tig);
            tot[4 * j] = max_nan(tot[4 * j], o.x);
            tot[4 * j + 1] = max_nan(tot[4 * j + 1], o.y);
          }
      }
      bar_sync(kEpiBar + w, wg::WG_THREADS);
    }
    // the sum over each passage's valid tokens, columns in a fixed order
    // (j, e, then the four column lanes as a tree); lane 0 writes
    uint32_t on_bits = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        on_bits |= (uint32_t)col_on[col0 + 8 * j + 2 * tig + e]
                   << (2 * j + e);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && halves == 1) break;
      const int di = (row_lo - gid + 8 * h) / g.td_p;   // the row's doc
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if ((on_bits >> (2 * j + e)) & 1)
            s = __fadd_rn(s, tot[4 * j + 2 * h + e]);
        if (PAIRS ? j == NJ - 1 : ((8 * (j + 1)) % g.tq_p) == 0) {
          s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
          s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 2));
          if (lane == 0 && writer_warp) {
            if constexpr (PAIRS) {
              const long long jj = cand0 + (long long)i * dpt + di;
              if (jj < cand_end)
                g.out[qx * g.M + jj] = st[h] == 5 ? NAN : s;
            } else {
              const int pl = (col0 + 8 * j) / g.tq_p;
              const long long p = q0 + pl;
              const long long dd =
                  (long long)((int)blockIdx.y + i * (int)gridDim.y) * dpt +
                  di;
              if (p < g.Q && pl < g.qpt && dd < g.D)
                g.out[p * g.D + dd] = s != s ? kNeg : s;
            }
          }
          s = 0.0f;
        }
      }
    }
  }
}

// ---- host ----

// a 3-D fp32 tensor (d0 innermost) read in boxes of b0 x b1 x b2 with
// 128-byte swizzle (b0 = 32 floats)
inline int make_map_f32(CUtensorMap* map, const void* ptr, uint64_t d0,
                        uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1,
                        uint32_t b2) {
  wg::EncodeTiledFn fn = wg::encode_tiled_fn();
  if (fn == nullptr) return wg::ERR_NO_ENCODE_FN;
  cuuint64_t gdim[3] = {d0, d1, d2};
  cuuint64_t gstr[2] = {d0 * 4, d0 * d1 * 4};
  cuuint32_t gbox[3] = {b0, b1, b2};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<void*>(ptr), gdim, gstr, gbox, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wg::ERR_ENCODE_BASE + static_cast<int>(r);
}

template <int N, int PIECES, bool PAIRS>
int launch(const Args& g, int gx, int gy, int smem, cudaStream_t st) {
  CUtensorMap map;
  int e = make_map_f32(&map, g.d, (uint64_t)g.dim, (uint64_t)g.Td,
                       (uint64_t)g.D, kSlotCols, (uint32_t)g.td_p,
                       PAIRS ? 1u : (uint32_t)(slot_rows(false) / g.td_p));
  if (e != 0) return e;
  auto kernel = maxsim_split_kernel<N, PIECES, PAIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem, st>>>(map, g);
  return (int)cudaGetLastError();
}

}  // namespace msplit
