// F4: the exact engines' fp32 tile of distances on Hopper's tensor cores
// (sm_90a): the products of the query rows with a tile of base rows as an
// fp32-exact bf16x6 split, with F2's distance epilogue and mask fused in.
//
// Replaces, on the card at precision "highest", the library product
// `query @ tile.T` (cuBLAS's fp32 GEMM on the CUDA cores) followed by F2
// (csrc/distance_tile.cu), which read its (Q, T) products back and wrote
// them again as distances: pairwise_distance and the validity mask inside
// the jitted scan step of neighborhoodwatch_tpu/ops/knn.py:112 _knn_scan
// (:137-146) and in _knn_full (:154-163), whose "highest" the JAX package
// defines as bf16x6, "full fp32 accuracy" (neighborhoodwatch_tpu/ops/
// distance.py:30). The plain PyTorch version is ops/fused_core.py:
// split_distance_plain (the same split and chunks, op by op in fp32).
//
// What it computes, per query row i and base row j of the tile:
//   dot = <q_i, b_j> as below;
//   sqeuclidean: d = max((qn[i] + bn[j]) - 2 dot, 0), NaN kept;
//   euclidean:   sqrt of that;
//   cosine, dot: d = 1 - dot (cosine's rows come normalized);
//   d = +inf where it is not finite, and where j lies outside [lo, hi).
// F2's epilogue, operation for operation (no contraction into fma).
//
// ---- The arithmetic (csrc/maxsim_split.cuh's, with a longer chunk) ----
// Each fp32 operand is cut into three bf16 pieces by truncation, x = x0 + x1
// + x2 exactly (msplit::split_pair), by split_pieces_kernel below: the query
// rows once a scan (ops/knn.py:_knn_scan passes their pieces to every tile),
// the tile's rows once a tile. The six products of order <= 2 (x2 y0, x1 y1,
// x0 y2, x1 y0, x0 y1, x0 y0) are each exact in fp32. x0 y0 sums on the
// tensor cores over a chunk of KC dims in an accumulator `main` that the
// chunk's first k-step zeroes, then joins an fp32 register total with one
// round-to-nearest add; the five small products sum over the whole dim in a
// second accumulator `small`, which joins the total at the end.
// Error model, relative to A = sum_k |q_k b_k| and in units of 2^-24, with
// every tensor-core add taken to truncate (msplit::error_bound):
//   dropped terms x1 y2 + x2 y1 + x2 y2    16.0625
//   main, KC adds a chunk                  2 KC
//   small, 5 dim adds on terms < 2^-6 A    dim (10/64 + 30/16384)
//   promotions, dim/KC adds                ceil(dim / KC) (1 + 2^-16)
// The plan (ops/fused_core.py:split_plan) takes the largest KC of 128, 64
// and 32 whose total stays within dim 2^-24, the budget ops/knn.py:_acc_rel
// grants an fp32 dot, and sends a dim where none does to the fp32 path: at
// 1,536 dims KC = 128 gives 527 units, at 1,024 442; dims from 100 up are
// admitted (KC = 64 from 176, 128 from 328). The plan also asks for 160
// query rows from 1,024 dims and 1,000 below, where F4 beat the fp32 path on
// the card. A chunk of KC dims is KC / 32 whole ring slots, so the
// promotion, which must wait for the chunk's last wgmma, comes once every
// KC / 32 slots. Non-finite inputs: a non-finite x0 keeps x0 y0, and so the
// dot, non-finite (an inf's residual pieces are NaN, a NaN is made canonical
// before it is cut), and every non-finite distance is +inf, as in the fp32
// path. No atomics, every sum in a fixed order: two launches give equal
// bits.
//
// ---- Layout ----
// A block owns 128 query rows x 128 base rows: two warpgroups, warpgroup w
// the query rows 64 w .. 64 w + 63 against all 128 base rows (wgmma
// m64n128k16 from shared memory, both operands K-major). A thread holds
// three 64-register accumulators (total, main, small): ~220 registers,
// which a block of 8 warps leaves it (with a producer warp or warpgroup
// beside them ptxas caps a thread at 168, spills and serializes the
// wgmmas). So thread 0 starts the TMA loads itself, the ring's first
// slots at the start and each later one as soon as every consumer warp of
// the cluster has released the slot it reuses. The operands come through
// csrc/wgmma_mainloop.cuh's ring: a slot is one 32-column chunk of the six
// piece tiles (query rows x 3 pieces, base rows x 3 pieces; 64-byte
// swizzled rows, 48 KB), four slots; TMA's zero fill covers the ragged
// edges (rows past Q or T, columns past dim), so no operand is padded.
// Blocks of a cluster of two take consecutive query blocks of the same
// base rows and each loads half of the base boxes, multicast to both.
// Blocks run in groups of 8 query blocks, so a wave's operands stay in L2.
// The epilogue writes each distance once, from the accumulator registers.
//
// Bound on this card: operations, six bf16 products of 2 Q T dim FLOP at
// 989 TFLOP/s: 1.527 ms at 10,000 x 8,192 x 1,536, 1.018 ms at x 1,024,
// 0.102 ms at 1,000 x 8,192 x 1,024. Bytes bind far less: at 10,000 x
// 8,192 x 1,536 the distances' write (Q T 4 bytes), the tile's split pass
// and one read of every piece are ~0.62 GB, 0.19 ms at 3.35 TB/s.

#include <math.h>

#include "maxsim_split.cuh"

namespace {

constexpr int BM = 128;                     // query rows a block
constexpr int BN = 128;                     // base rows a block
constexpr int BOX = 64;                     // rows a TMA box
constexpr int KS = 32;                      // columns a ring slot
constexpr int ROWB = KS * 2;                // bytes a swizzled piece row
constexpr int PIECE_A = BM * ROWB;          // a query piece tile of a slot
constexpr int PIECE_B = BN * ROWB;          // a base piece tile of a slot
constexpr int SLOT = 3 * (PIECE_A + PIECE_B);
constexpr int STAGES = 4;
constexpr int BAR_BYTES = 16 * STAGES;
constexpr int SMEM = wg::TILE_ALIGN + STAGES * SLOT + BAR_BYTES;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 2 * wg::WG_THREADS;  // two consumer warpgroups
constexpr int GROUP_M = 8;                  // query blocks a raster group
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_MAX_GRID = 8192;

enum Metric { kSquared = 0, kEuclidean = 1, kOneMinus = 2 };

// ---- the plan's arithmetic, mirrored by ops/fused_core.py:split_plan ----

// the largest chunk of 128, 64, 32 dims whose error bound stays within dim
// 2^-24 (msplit::error_bound, three pieces), else 0
inline int chunk_for(int dim) {
  for (int kc = 128; kc >= KS; kc /= 2)
    if (msplit::error_bound(dim, kc, 3) <= dim) return kc;
  return 0;
}

// the pieces' row stride in elements: 16-byte rows for TMA
inline int piece_ld(int dim) { return (dim + 7) / 8 * 8; }

// F2's epilogue (csrc/distance_tile.cu), operation for operation
template <int kMetric>
__device__ __forceinline__ float epilogue(float dot, float qn, float bn) {
  float d;
  if (kMetric == kOneMinus) {
    d = __fsub_rn(1.0f, dot);
  } else {
    d = __fsub_rn(__fadd_rn(qn, bn), __fmul_rn(2.0f, dot));
    d = d < 0.0f ? 0.0f : d;               // clamp_min(., 0): NaN stays
    if (kMetric == kEuclidean) d = __fsqrt_rn(d);
  }
  return isfinite(d) ? d : INFINITY;
}

// ---- the split pass: (n, dim) fp32 rows -> (3, n, ld) bf16 pieces ----

__global__ void __launch_bounds__(SPLIT_THREADS)
split_pieces_kernel(const float4* __restrict__ x, uint2* __restrict__ out,
                    long long n, int dim, int ld) {
  const int quads = dim / 4;
  const long long total = n * quads;
  const long long piece = n * (long long)ld / 4;   // uint2 a piece
  for (long long i = blockIdx.x * (long long)SPLIT_THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * SPLIT_THREADS) {
    const long long row = i / quads;
    const int c = (int)(i - row * quads);
    const float4 v = __ldcs(x + i);
    uint32_t lo[3], hi[3];
    msplit::split_pair<3>(v.x, v.y, lo);
    msplit::split_pair<3>(v.z, v.w, hi);
    const long long at = row * (ld / 4) + c;
#pragma unroll
    for (int p = 0; p < 3; ++p) out[p * piece + at] = make_uint2(lo[p], hi[p]);
  }
}

// ---- the product and the epilogue ----

struct Args {
  const float* qn;      // (Q,) squared norms, (sq)euclidean only
  const float* bn;      // (T,)
  float* out;           // (Q, T)
  int Q, T, dim, lo, hi;
  int kc_slots;         // ring slots a promotion chunk
  int nbq;              // query blocks, rounded up to the cluster
};

// the six products of one 16-column k-step: the small ones (order 2, then
// 1) into `small`, then x0 y0 into `main` (overwritten where `fresh`)
__device__ __forceinline__ void kstep(float (&small)[64], float (&main)[64],
                                      uint32_t a, uint32_t b, int k,
                                      bool fresh) {
  uint64_t da[3], db[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    da[p] = wg::make_desc<ROWB>(a + p * PIECE_A) + 2 * k;
    db[p] = wg::make_desc<ROWB>(b + p * PIECE_B) + 2 * k;
  }
  wg::wgmma_m64n128k16(small, da[2], db[0], 1);
  wg::wgmma_m64n128k16(small, da[1], db[1], 1);
  wg::wgmma_m64n128k16(small, da[0], db[2], 1);
  wg::wgmma_m64n128k16(small, da[1], db[0], 1);
  wg::wgmma_m64n128k16(small, da[0], db[1], 1);
  wg::wgmma_m64n128k16(main, da[0], db[0], fresh ? 0 : 1);
}

// thread 0's loads of ring slot `s`: the query boxes (piece b / 2, rows
// half b % 2), then this block's share of the base boxes, multicast to
// every block of the cluster
__device__ __forceinline__ void load_slot(wg::Ring& ring, uint32_t tiles,
                                          const CUtensorMap* m_q,
                                          const CUtensorMap* m_b, int s,
                                          int q0, int t0, uint32_t rank,
                                          uint32_t cl) {
  ring.acquire(SLOT);
  const uint32_t slot = tiles + ring.slot * SLOT;
  const int k0 = s * KS;
#pragma unroll
  for (int b = 0; b < 6; ++b)
    wg::tma_load_3d(slot + (b >> 1) * PIECE_A + (b & 1) * BOX * ROWB, m_q,
                    ring.full(), k0, q0 + (b & 1) * BOX, b >> 1, 0, false);
  const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
  for (int b = (int)rank; b < 6; b += (int)cl)
    wg::tma_load_3d(slot + 3 * PIECE_A + (b >> 1) * PIECE_B +
                        (b & 1) * BOX * ROWB,
                    m_b, ring.full(), k0, t0 + (b & 1) * BOX, b >> 1, mask,
                    cl > 1);
  ring.advance();
}

template <int kMetric>
__global__ void __launch_bounds__(THREADS, 1)
split_distance_kernel(const __grid_constant__ CUtensorMap m_q,
                      const __grid_constant__ CUtensorMap m_b,
                      const Args g) {
  extern __shared__ unsigned char smem_raw[];
  // the same offset in every block of the cluster (multicast lands there)
  const uint32_t tiles = (wg::smem_u32(smem_raw) + wg::TILE_ALIGN - 1) &
                         ~static_cast<uint32_t>(wg::TILE_ALIGN - 1);
  const uint32_t bars = tiles + STAGES * SLOT;
  const uint32_t cl = wg::cluster_nctarank();
  const uint32_t rank = wg::cluster_ctarank();

  // raster: groups of GROUP_M query blocks (a multiple of the cluster),
  // query blocks fastest, so a cluster's blocks share their base rows
  const int nbt = (g.T + BN - 1) / BN;
  const int per_group = GROUP_M * nbt;
  const int group = (int)blockIdx.x / per_group;
  const int r = (int)blockIdx.x % per_group;
  const int first = group * GROUP_M;
  const int gm = min(GROUP_M, g.nbq - first);
  const int q0 = (first + r % gm) * BM;
  const int t0 = (r / gm) * BN;
  const int nslots = (g.dim + KS - 1) / KS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    wg::ring_init(bars, STAGES, CONSUMER_WARPS, cl);
    wg::fence_barrier_init();
  }
  // no block may multicast into, or arrive on, barriers not yet initialised
  wg::cluster_sync();

  // thread 0 also starts every TMA load: the ring's first STAGES slots now,
  // each later one as soon as every consumer warp of the cluster has
  // released the slot it reuses (a producer warp beside the consumers
  // would leave each thread 168 registers, and a consumer needs ~220)
  wg::Ring loads(bars, STAGES);
  int loaded = 0;
  // thread 0: start every load whose slot the first `released` slots free
  auto refill = [&](int released) {
    for (; loaded < nslots && loaded < released + STAGES; ++loaded)
      load_slot(loads, tiles, &m_q, &m_b, loaded, q0, t0, rank, cl);
  };
  if (tid == 0) refill(0);

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // warp-uniform (the wgmmas below then stay unserialized)
  const int w = __shfl_sync(msplit::kFull, tid / wg::WG_THREADS, 0);
  const int lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int row0 = q0 + 64 * w + 16 * ((tid % wg::WG_THREADS) / 32) + gid;

  float tot[64], main_acc[64], small_acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) tot[x] = small_acc[x] = main_acc[x] = 0.0f;
  wg::Ring ring(bars, STAGES);
  const uint32_t a_off = w * BOX * ROWB;
  // a chunk of kc_slots slots: x0 y0 summed in main, then promoted. The
  // promotion is the chunk loop's unconditional tail, after the wait for
  // every group: behind a branch the compiler may hoist its adds to where
  // a group still writes main, and ptxas then serializes the wgmmas
  for (int c0 = 0; c0 < nslots; c0 += g.kc_slots) {
    const int c1 = min(c0 + g.kc_slots, nslots);
    int prev = -1;           // the slot before, whose group may still run
    for (int s = c0; s < c1; ++s) {
      // a plain spin: a timed wait that may trap is a divergent path,
      // which made ptxas serialize the wgmmas (2.5 ms against 3.4 at
      // 10,000 x 8,192 x 1,536)
      ring.wait_full();
      const uint32_t slot = tiles + ring.slot * SLOT;
      wg::wgmma_fence();
      kstep(small_acc, main_acc, slot + a_off, slot + 3 * PIECE_A, 0,
            s == c0);
      kstep(small_acc, main_acc, slot + a_off, slot + 3 * PIECE_A, 1,
            false);
      wg::wgmma_commit();
      if (prev >= 0) {
        wg::wgmma_wait<1>();     // the slot before this one has retired
        wg::ring_release(ring.empty0, prev, cl);
        if (tid == 0) refill(s);
        __syncwarp();
      }
      prev = ring.slot;
      ring.advance();
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(small_acc);
    wg::fence_regs(main_acc);
    wg::ring_release(ring.empty0, prev, cl);
    if (tid == 0) refill(c1);
    __syncwarp();
    // the chunk's x0 y0 joins the total: a round-to-nearest add
#pragma unroll
    for (int x = 0; x < 64; ++x) tot[x] = __fadd_rn(tot[x], main_acc[x]);
  }

  // -- epilogue: distances of rows row0, row0 + 8 and this thread's columns
  // t0 + 8 j + 2 tig + e; a warpgroup whose rows all lie past Q (a surplus
  // block that rounds the grid up to the cluster, the last block's second
  // half) computed zeros and writes nothing --
  if (q0 + 64 * w < g.Q) {
    float qv[2] = {0.0f, 0.0f};
    if (kMetric != kOneMinus) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + 8 * h < g.Q) qv[h] = __ldg(g.qn + row0 + 8 * h);
    }
    const bool pairs = (g.T & 1) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = t0 + 8 * j + 2 * tig;
      float bv[2] = {0.0f, 0.0f};
      if (kMetric != kOneMinus) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < g.T) bv[e] = __ldg(g.bn + c + e);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= g.Q || c >= g.T) continue;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e;
          d[e] = epilogue<kMetric>(__fadd_rn(tot[x], small_acc[x]), qv[h],
                                   bv[e]);
          if (c + e < g.lo || c + e >= g.hi) d[e] = INFINITY;
        }
        float* o = g.out + (long long)row * g.T + c;
        if (pairs) {
          __stcs(reinterpret_cast<float2*>(o), make_float2(d[0], d[1]));
        } else {
          __stcs(o, d[0]);
          if (c + 1 < g.T) __stcs(o + 1, d[1]);
        }
      }
    }
  }
  // no block leaves while a peer may still multicast into it or arrive on
  // its barriers
  wg::cluster_sync();
}

// the pieces (3, n, ld) bf16 as a 3-D map (dim, n, 3) read in boxes of 32
// columns x 64 rows of one piece, 64-byte swizzle; columns past dim and
// rows past n arrive as zeros
inline int make_pieces_map(CUtensorMap* map, const void* ptr, long long n,
                           int dim, int ld) {
  const uint64_t dims[3] = {(uint64_t)dim, (uint64_t)n, 3};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)ld * 2 * n};
  const uint32_t box[3] = {KS, BOX, 1};
  return wg::make_map(map, ptr, 3, dims, strides, box);
}

template <int kMetric>
int launch(const void* qp, const void* bp, const Args& g, int cl,
           cudaStream_t st) {
  CUtensorMap m_q, m_b;
  const int ld = piece_ld(g.dim);
  int e = make_pieces_map(&m_q, qp, g.Q, g.dim, ld);
  if (e == 0) e = make_pieces_map(&m_b, bp, g.T, g.dim, ld);
  if (e != 0) return e;
  auto kernel = split_distance_kernel<kMetric>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.nbq * ((g.T + BN - 1) / BN)));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m_q, m_b, g);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// x: (n, dim) fp32 rows, dim % 4 == 0, 16-byte aligned; pieces: (3, n, ld)
// bf16, ld = dim rounded up to 8 (the columns past dim are not written).
// Returns a CUDA error code, 0 on success.
extern "C" int split_distance_pieces_launch(const void* x, long long n,
                                            int dim, int ld, void* pieces,
                                            void* stream) {
  if (n < 0 || dim <= 0 || dim % 4 != 0 || ld != piece_ld(dim) ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)pieces % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long quads = n * (dim / 4);
  long long grid = (quads + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (grid > SPLIT_MAX_GRID) grid = SPLIT_MAX_GRID;
  split_pieces_kernel<<<(unsigned)grid, SPLIT_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const float4*)x, (uint2*)pieces, n, dim, ld);
  return (int)cudaGetLastError();
}

// qp: (3, Q, ld), bp: (3, T, ld) bf16 pieces from split_distance_pieces;
// qn (Q,), bn (T,) fp32 squared norms, read for metric 0 (sqeuclidean) and
// 1 (euclidean) only; metric 2 is 1 - dot (cosine, dot); out (Q, T) fp32.
// Columns outside [lo, hi) become +inf. kc, cluster and smem are the plan's
// (ops/fused_core.py:split_plan): a plan this function would not make is
// refused with 22001. Returns 0, a CUDA error, or a tensor-map code of
// wgmma_mainloop.cuh.
extern "C" int split_distance_launch(const void* qp, const void* bp,
                                     const void* qn, const void* bn,
                                     void* out, int Q, int T, int dim, int lo,
                                     int hi, int metric, int kc, int cluster,
                                     int smem, void* stream) {
  if (Q < 0 || T < 0 || metric < 0 || metric > 2 ||
      (metric != kOneMinus && (qn == nullptr || bn == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (kc != chunk_for(dim) || kc == 0 ||
      (cluster != 1 && cluster != 2) ||
      smem != SMEM)
    return msplit::kErrPlan;
  if (Q == 0 || T == 0) return 0;
  const int nbq = ((Q + BM - 1) / BM + cluster - 1) / cluster * cluster;
  if ((long long)nbq * ((T + BN - 1) / BN) > 0x7fffffffLL)
    return msplit::kErrPlan;
  Args g;
  g.qn = (const float*)qn;
  g.bn = (const float*)bn;
  g.out = (float*)out;
  g.Q = Q;
  g.T = T;
  g.dim = dim;
  g.lo = lo;
  g.hi = hi;
  g.kc_slots = kc / KS;
  g.nbq = nbq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (metric) {
    case kSquared:
      return launch<kSquared>(qp, bp, g, cluster, st);
    case kEuclidean:
      return launch<kEuclidean>(qp, bp, g, cluster, st);
    default:
      return launch<kOneMinus>(qp, bp, g, cluster, st);
  }
}
