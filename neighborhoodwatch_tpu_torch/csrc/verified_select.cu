// Exact per-row k smallest with a count proof, for Hopper (sm_90a): the
// select of the exact-kNN "verified" engine.
//
// Replaces neighborhoodwatch_tpu/ops/knn.py:59 _verified_smallest_k, whose
// candidate stage is lax.approx_min_k (XLA's PartialReduce on the TPU, not a
// Pallas kernel), followed there by a small top_k, a count proof and a
// whole-tile lax.cond fallback to the exact top_k.
//
// What it computes, per row r of a (Q, N) fp32 distance tile d (non-finite
// values already +inf; padding and overlap columns +inf):
//   margin = min(N, max(k + 28, 5k / 4))  (the wrapper passes it);
//   1. candidates: the margin smallest entries of the row by (value,
//      position), found exactly. An exact top-margin is a valid output of
//      approx_min_k;
//   2. the k best candidates: a sort of (key << 32 | position);
//   3. the proof: with tau the k-th selected value, the row must hold as
//      many values below tau as the selection does;
//   4. a row that fails the proof is selected again, exactly, with the
//      lowest positions among ties (JAX's whole-tile cond becomes per row, so
//      there is no host sync), and the failed-row counter is incremented.
// Out: dist[r, 0..k) ascending (the row's own values, bit for bit),
// pos[r, 0..k) int64 column positions, ok[r] the proof's verdict (1 byte),
// failed += rows that failed. Among entries of equal value the lower
// position comes first, so the result equals a stable sort's first k: the
// exact engine's own selection.
//
// The `exclude` argument (a column, or -1) drops one column from the
// candidate stage only, so a test can plant a candidate set that misses a
// true neighbour and watch the proof fail and the fallback run.
//
// Ordered keys: the fp32 bits with the sign folded (negatives inverted,
// positives with the top bit set) order like the values; -0.0 takes +0.0's
// key and every NaN the largest key, so keys and value comparisons agree.
//
// Bound on this card: one read of d (Q*N*4 bytes: 32.8 MB at 1,000 x 8,192,
// ~10 us at 3.35 TB/s) and a write of Q*k*12 bytes; the operations are a few
// integer ops per element and pass.
//
// The kernel ("adaptive"):
//   * Keys in registers. A block of 256 threads owns a slice of the row;
//     each warp owns a contiguous stretch of it, lane-strided (column base +
//     32 i + lane in slot i), so loads are coalesced and shared-memory reads
//     free of bank conflicts. A slice of up to 8,192 columns is held in
//     registers (32 keys a thread) from its load to the proof; a wider slice
//     is read again, 1,024 columns a warp at a time, from shared memory (or
//     from L2 where it does not fit) on each sweep.
//   * An adaptive first digit. The first sweep takes the smallest and
//     largest finite key; the histogram then bins (key - min) >> s over
//     2,048 bins, s chosen so the row's finite range spans them, so crowded
//     rows spread out instead of landing in one bin; +inf and NaN go to an
//     overflow bin above the range. The bin that holds rank margin - 1 is
//     the boundary. If it and the bins below hold at most capacity()
//     entries, they are all candidates (each thread counts its own, one
//     atomic a warp places them), and the sort puts the margin best first;
//     otherwise a further digit bins the boundary bin alone, until it fits
//     or holds a single key. Then the entries below that key are
//     candidates, and the ones equal to it are taken in position order
//     (per-warp ballots and one exclusive scan of per-warp counts, then of
//     per-block counts in cluster rank order). A typical row takes five
//     sweeps of its registers after the load: range, histogram, count,
//     candidates, proof. Every sweep is free of branches but the
//     candidates' (one atomic a slot for the histogram, what no bin counts
//     going to a discard bin: the hardware merges a warp's increments of
//     one address).
//   * The sort of the candidates: a counting sort by bins of their keys'
//     range (one atomic a candidate), then each one's place among the few
//     of its own bin; no comparison network, four block barriers.
//   * A persistent grid: about two blocks an SM walk the rows; where rows
//     are 16-byte aligned and a multiple of 16 bytes long (N % 4 == 0), one
//     thread brings the next row's slice into a second shared buffer with a
//     1-D bulk async copy (cp.async.bulk, completion on an mbarrier) while
//     the block selects the current one. Other rows are loaded by the
//     threads themselves.
//   * Clusters for wide rows or few rows: a row takes C blocks (2-8) of a
//     thread-block cluster, each a slice of N / C columns. Each block adds
//     its histogram into the leader's through distributed shared memory
//     (one remote atomic a non-empty bin), the leader picks the bin and
//     publishes it, the candidates are gathered into the leader's shared
//     memory, ties taken across blocks in rank order, and the proof's count
//     summed over the cluster. Cluster barriers and remote reads cost
//     microseconds, so the plan takes the fewest blocks that fill the card.
// The launch plan (path, cluster size, grid, slice, buffers, shared bytes)
// is computed by ops/verified_kernel.py:plan; the launch function checks it
// and refuses what it cannot run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;      // dynamic shared memory of a block
constexpr unsigned kFull = 0xffffffffu;

// branch-free: negatives inverted, positives with the top bit set
__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t mag = u & 0x7fffffffu;
  const uint32_t k = u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
  const uint32_t z = mag == 0 ? 0x80000000u : k;  // -0.0 and +0.0
  return mag > 0x7f800000u ? 0xffffffffu : z;     // NaN: after +inf
}

namespace adaptive {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKpt = 32;                   // keys a thread holds
constexpr int kWarpTile = 32 * kKpt;       // columns a warp holds at once
constexpr int kTile = kWarps * kWarpTile;  // a slice this wide stays resident
constexpr int kBins = 2048;                // the adaptive digit's bins
constexpr int kPerThread = kBins / kThreads;
constexpr int kHistWords = kBins + 4;      // + the overflow bin (+inf, NaN)
constexpr int kDiscard = kBins + 1;        // counts nothing anyone reads
constexpr int kMaxCluster = 8;
constexpr int kMaxBuffers = 2;
constexpr int kCopyChunk = 16384;          // bytes per bulk copy instruction
constexpr uint32_t kInfKey = 0xff800000u;  // ordered_key(+inf)
constexpr int kScratchWords = 64;          // see Shared

// Shared memory: the row buffers, the candidates, the histogram, the
// mbarriers and a few words of scratch. plan() in ops/verified_kernel.py
// computes the same total.
struct Layout {
  size_t cand, hist, mbar, scratch, total;
};

// The candidates a block gathers at most: with P the power of two >=
// max(margin, 32), 2P up to P = 256, P + 512 above (the bins below the
// boundary bin and the boundary bin itself then fit without a further digit
// on all but crowded rows, and k = 1024 keeps two blocks an SM). The sort
// goes through a second buffer of as many.
__host__ __device__ inline int capacity(int margin) {
  int P = 32;
  while (P < margin) P <<= 1;
  return P <= 256 ? 2 * P : P + 512;
}

__host__ __device__ inline Layout layout(int slice, int nbuf, int cap) {
  Layout L;
  size_t off = ((size_t)nbuf * slice * 4 + 15) & ~(size_t)15;
  L.cand = off;
  off += (size_t)cap * 16;
  L.hist = off;
  off += kHistWords * 4;
  L.mbar = off;
  off += kMaxBuffers * 8;
  L.scratch = off;
  off += kScratchWords * 4;
  L.total = off;
  return L;
}

struct Params {
  const float* d;
  // cap: the candidates the leader's shared memory holds (capacity())
  int Q, N, k, margin, exclude, slice, nbuf, cap;
  float* out_d;
  long long* out_i;
  uint8_t* ok;
  unsigned int* failed;
};

struct Shared {
  float* buf;                  // nbuf row slices
  unsigned long long* cand;    // cap candidates (key << 32 | column), and
                               // cap more for the sort
  uint32_t* hist;              // kHistWords
  uint64_t* mbar;              // one per buffer
  // per-warp partials, one area per reduction of a row, so that each needs
  // one barrier (write, barrier, read) and none is overwritten before all
  // have read it: wsum (the range; the rare paths), wscan (the bins'
  // scan), wadd (the proof's sum)
  uint32_t* wsum;              // [16]
  uint32_t* wscan;             // [8]
  uint32_t* wadd;              // [8]
  uint32_t* pick;              // [4] the boundary bin
  uint32_t* xch;               // [16] words other blocks of the cluster read
};

// xch slots
constexpr int kXMin = 0, kXMax = 1, kXCount = 2, kXEq = 3, kXProof = 4,
              kXTau = 5, kXPick = 8;   // kXPick .. + 2: the leader's pick

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every function below that touches shared memory is inlined into the
// kernel and takes the cluster case as a template argument (CL: a row takes
// a cluster of blocks), so that the compiler sees where each pointer points
// and issues shared-memory loads, stores and atomics, not generic ones.

// every thread of every block of the cluster (a block barrier without one)
template <bool CL>
__device__ __forceinline__ void csync() {
  if constexpr (CL) {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// the same shared-memory object in block `rank` of the cluster
template <bool CL, class T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  if constexpr (CL) return cg::this_cluster().map_shared_rank(p, rank);
  else return p;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One thread: `bytes` (a multiple of 16) from device memory into this
// block's shared memory, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  if (bytes == 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_expect_tx(bar, bytes);
  for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
    const uint32_t n = bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32((char*)dst + off)),
           "l"((const char*)src + off), "r"(n), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ int bitlen(uint32_t x) { return 32 - __clz(x); }

// The block's view of one row: its slice [c0, c0 + len) and this warp's
// stretch [wlo, whi) of it, relative to c0; the slice's values are in a
// shared buffer (smem) or read from device memory.
struct View {
  const float* sm;     // the slice in shared memory
  const float* gl;     // the slice in device memory
  bool smem;
  int c0, wlo, whi;
};

struct FromShared {};
struct FromDevice {};
__device__ __forceinline__ float load(FromShared, const float* p, int i) {
  return p[i];
}
__device__ __forceinline__ float load(FromDevice, const float* p, int i) {
  return __ldg(p + i);
}

// f(source pointer, tag) on the slice's shared buffer or device memory,
// each with its own copy of f
template <class F>
__device__ __forceinline__ void with_source(const View& v, F&& f) {
  if (v.smem) f(v.sm, FromShared{});
  else f(v.gl, FromDevice{});
}

// Slots i of this lane hold columns base + 32 i + lane: bit i of *valid
// says the column lies in the warp's stretch, bit i of *take also that it
// is not column `excl` (relative to the slice; negative: none).
__device__ __forceinline__ void slot_masks(int base, int whi, int excl,
                                           uint32_t* valid, uint32_t* take) {
  const int lane = threadIdx.x & 31;
  const int span = whi - base - lane;
  const int n = span <= 0 ? 0 : min(kKpt, (span + 31) >> 5);
  *valid = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
  const int d = excl - base - lane;
  *take = *valid & ~(d >= 0 && (d & 31) == 0 && (d >> 5) < kKpt
                         ? 1u << (d >> 5) : 0u);
}

// f(key, local column, valid, take) for every slot of this warp's stretch,
// in position order, every lane in step (f may use warp votes); take: valid
// and not column `excl`. RES: the keys are the registers `keys`; otherwise
// they are read 1,024 columns at a time.
template <bool RES, class F>
__device__ __forceinline__ void sweep(const uint32_t (&keys)[kKpt],
                                      const View& v, int excl, F&& f) {
  const int lane = threadIdx.x & 31;
  if constexpr (RES) {
    uint32_t vm, tm;
    slot_masks(v.wlo, v.whi, excl, &vm, &tm);
#pragma unroll
    for (int i = 0; i < kKpt; ++i)
      f(keys[i], v.wlo + i * 32 + lane, ((vm >> i) & 1) != 0,
        ((tm >> i) & 1) != 0);
  } else {
    with_source(v, [&](const float* src, auto from) {
      for (int base = v.wlo; base < v.whi; base += kWarpTile) {
        uint32_t vm, tm, kk[kKpt];
        slot_masks(base, v.whi, excl, &vm, &tm);
        // every load in bounds (the last column again past the end), so
        // that none waits on a branch
#pragma unroll
        for (int i = 0; i < kKpt; ++i)
          kk[i] = ordered_key(
              load(from, src, min(base + i * 32 + lane, v.whi - 1)));
#pragma unroll
        for (int i = 0; i < kKpt; ++i)
          f(kk[i], base + i * 32 + lane, ((vm >> i) & 1) != 0,
            ((tm >> i) & 1) != 0);
      }
    });
  }
}

// sum over the block, returned to every thread
__device__ __forceinline__ uint32_t block_add(uint32_t v, const Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) sh.wadd[warp] = v;
  __syncthreads();
  uint32_t t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sh.wadd[w];
  return t;
}

struct Pick {
  uint32_t bin, below, cnt;
};

// This block's histogram (complete): the bin that holds rank R, the entries
// below it and in it. Clears the histogram for the next digit. Thread t owns
// bins 8t .. 8t + 7, the last thread also the overflow bin; each reads and
// clears only its own.
__device__ __forceinline__ Pick scan_bins(const Shared& sh, uint32_t R) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool last = tid == kThreads - 1;   // also owns the overflow bin
  uint32_t c[kPerThread + 1], s = 0;
  uint32_t* own = sh.hist + tid * kPerThread;
#pragma unroll
  for (int b = 0; b <= kPerThread; ++b) {
    c[b] = b < kPerThread || last ? own[b] : 0u;
    if (b < kPerThread || last) own[b] = 0;
    s += c[b];
  }
  uint32_t incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sh.wscan[warp] = incl;
  __syncthreads();
  uint32_t acc = incl - s;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc += w < warp ? sh.wscan[w] : 0u;
  if (R >= acc && R < acc + s) {
#pragma unroll
    for (int b = 0; b <= kPerThread; ++b) {
      if (R < acc + c[b]) {
        sh.pick[0] = (uint32_t)(tid * kPerThread + b);
        sh.pick[1] = acc;
        sh.pick[2] = c[b];
        break;
      }
      acc += c[b];
    }
  }
  __syncthreads();
  return {sh.pick[0], sh.pick[1], sh.pick[2]};
}

// The bin of rank R of the cluster's histogram, once every block's own is
// complete. In a cluster each block adds its bins into the leader's (one
// remote atomic a non-empty bin, no reply awaited) and clears its own; the
// leader picks on the sum and publishes the pick.
template <bool CL>
__device__ __forceinline__ Pick pick_bin(const Shared& sh, uint32_t R,
                                         int rank) {
  if constexpr (CL) {
    if (rank != 0) {
      const int tid = threadIdx.x;
      uint32_t* own = sh.hist + tid * kPerThread;
      uint32_t* lead = at_rank<CL>(sh.hist, 0) + tid * kPerThread;
#pragma unroll
      for (int b = 0; b <= kPerThread; ++b) {
        if (b < kPerThread || tid == kThreads - 1) {
          const uint32_t x = own[b];
          if (x) {
            atomicAdd(lead + b, x);
            own[b] = 0;
          }
        }
      }
    }
    csync<CL>();
    if (rank == 0) {
      const Pick pk = scan_bins(sh, R);
      if (threadIdx.x == 0) {
        sh.xch[kXPick] = pk.bin;
        sh.xch[kXPick + 1] = pk.below;
        sh.xch[kXPick + 2] = pk.cnt;
      }
    }
    csync<CL>();
    const uint32_t* x = at_rank<CL>(sh.xch, 0) + kXPick;
    return {x[0], x[1], x[2]};
  } else {
    return scan_bins(sh, R);
  }
}

// ---- the sort: ascending (key << 32 | column), in the leader ----
// A counting sort by bins of the keys' range (2,048 bins, one atomic an
// entry), then each entry's place among the entries of its own bin (keys
// with their columns are distinct). Sorts cand[0 .. M) through tmp[0 ..
// M); the histogram is zero on entry and on return.
__device__ __forceinline__ void bucket_sort(unsigned long long* cand,
                                            unsigned long long* tmp, int M,
                                            const Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t lo = 0xffffffffu, hi = 0;
  for (int j = tid; j < M; j += kThreads) {
    const uint32_t key = (uint32_t)(cand[j] >> 32);
    lo = min(lo, key);
    hi = max(hi, key);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {   // the row's range in wsum was read barriers ago
    sh.wsum[warp] = lo;
    sh.wsum[kWarps + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, sh.wsum[w]);
    hi = max(hi, sh.wsum[kWarps + w]);
  }
  const int shift = max(0, bitlen(hi - lo) - 11);
  auto bin = [&](unsigned long long e) {
    return ((uint32_t)(e >> 32) - lo) >> shift;
  };
  for (int j = tid; j < M; j += kThreads)
    atomicAdd(&sh.hist[bin(cand[j])], 1u);
  __syncthreads();
  // each bin's first place: an exclusive scan, in place
  uint32_t* own = sh.hist + tid * kPerThread;
  uint32_t c[kPerThread], sum = 0;
#pragma unroll
  for (int b = 0; b < kPerThread; ++b) {
    c[b] = own[b];
    sum += c[b];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sh.wsum[warp] = incl;
  __syncthreads();
  uint32_t acc = incl - sum;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) acc += w < warp ? sh.wsum[w] : 0u;
#pragma unroll
  for (int b = 0; b < kPerThread; ++b) {
    own[b] = acc;
    acc += c[b];
  }
  __syncthreads();
  for (int j = tid; j < M; j += kThreads) {
    const unsigned long long e = cand[j];
    tmp[atomicAdd(&sh.hist[bin(e)], 1u)] = e;
  }
  __syncthreads();
  // an entry's bin holds the places from its first left neighbour of
  // another bin on; its place among them is the count of smaller ones
  for (int x = tid; x < M; x += kThreads) {
    const unsigned long long e = tmp[x];
    const uint32_t be = bin(e);
    int left = 0, less = 0;
    for (int j = x - 1; j >= 0 && bin(tmp[j]) == be; --j) {
      ++left;
      less += tmp[j] < e;
    }
    for (int j = x + 1; j < M && bin(tmp[j]) == be; ++j) less += tmp[j] < e;
    cand[x - left + less] = e;
  }
#pragma unroll
  for (int b = 0; b < kPerThread; ++b) own[b] = 0;
  __syncthreads();
}

// ---- stage 1 for one row, across the cluster ----
// Leaves M candidates in the leader block's cand[0 .. M), the first
// `unordered` in no order and the rest (entries equal to the boundary key,
// in column order) after them; by (key, column) their margin best are the
// row's margin best among the columns the candidate stage may take (all
// but column `exclude`, or all).
struct Gathered {
  int M, unordered;
};

template <bool RES, bool CL>
__device__ __forceinline__ Gathered select_candidates(
    const uint32_t (&keys)[kKpt], const View& v, const Params& p,
    int exclude, int C, int rank, const Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int excl = exclude < 0 ? -1 : exclude - v.c0;
  if (rank == 0 && tid == 0) sh.xch[kXCount] = 0;

  // ---- the range of the finite keys ----
  uint32_t mn = 0xffffffffu, mx = 0;
  sweep<RES>(keys, v, excl, [&](uint32_t key, int, bool, bool take) {
    const bool fin = take && key < kInfKey;
    mn = min(mn, fin ? key : 0xffffffffu);
    mx = max(mx, fin ? key : 0u);
  });
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if (lane == 0) {
    sh.wsum[warp] = mn;
    sh.wsum[kWarps + warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mn = min(mn, sh.wsum[w]);
    mx = max(mx, sh.wsum[kWarps + w]);
  }
  if constexpr (CL) {
    if (tid == 0) {
      sh.xch[kXMin] = mn;
      sh.xch[kXMax] = mx;
    }
    csync<CL>();
    for (int q = 0; q < C; ++q) {
      mn = min(mn, at_rank<CL>(sh.xch, q)[kXMin]);
      mx = max(mx, at_rank<CL>(sh.xch, q)[kXMax]);
    }
  }

  // ---- the adaptive first digit, then digits over the boundary bin ----
  // The first digit bins [mn, mx] (+inf and NaN to the overflow bin); each
  // further one bins the boundary bin [lo, hi] alone, until the bins up to
  // the boundary hold at most cap entries or the boundary bin one key.
  const uint32_t R = (uint32_t)p.margin - 1;
  uint32_t base = mn, top = mx, below = 0, lo, hi, cnt;
  int shift = mn <= mx ? max(0, bitlen(mx - mn) - 11) : 0;
  for (bool first = true;; first = false) {
    // one atomic a slot, no branch: what no bin counts goes to kDiscard
    // (the hardware merges a warp's increments of one address)
    sweep<RES>(keys, v, excl, [&](uint32_t key, int, bool, bool take) {
      const bool in = take && key >= base && key <= top;
      const bool over = take && first && key > top;
      atomicAdd(&sh.hist[in ? (key - base) >> shift
                            : over ? (uint32_t)kBins : (uint32_t)kDiscard],
                1u);
    });
    __syncthreads();   // this block's histogram is complete
    const Pick pk = pick_bin<CL>(sh, R - below, rank);
    if (pk.bin == (uint32_t)kBins) {
      lo = kInfKey;
      hi = 0xffffffffu;
    } else {
      lo = base + (pk.bin << shift);
      const unsigned long long end =
          base + ((unsigned long long)(pk.bin + 1) << shift);
      hi = end - 1 < top ? (uint32_t)(end - 1) : top;
    }
    below += pk.below;
    cnt = pk.cnt;
    if (below + cnt <= (uint32_t)p.cap || lo == hi) break;
    base = lo;
    top = hi;
    shift = max(0, bitlen(hi - lo) - 11);
  }

  // ---- the candidates, into the leader's shared memory ----
  const uint32_t lanes_below = (1u << lane) - 1u;
  uint32_t* counter = at_rank<CL>(sh.xch + kXCount, 0);
  unsigned long long* dst = at_rank<CL>(sh.cand, 0);
  const bool ordered = below + cnt > (uint32_t)p.cap;   // lo == hi
  const uint32_t T = hi;
  Gathered gc;
  if (!ordered) {
    // every entry up to the boundary bin's top, in any order: each thread
    // counts its own, one atomic a warp places them
    gc.M = gc.unordered = (int)(below + cnt);
    uint32_t mine = 0;
    sweep<RES>(keys, v, excl, [&](uint32_t key, int, bool, bool take) {
      mine += take && key <= T;
    });
    uint32_t incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    uint32_t slot = 0;
    if (lane == 31 && incl) slot = atomicAdd(counter, incl);
    slot = __shfl_sync(kFull, slot, 31) + incl - mine;
    if (__any_sync(kFull, mine)) {
      sweep<RES>(keys, v, excl, [&](uint32_t key, int local, bool, bool take) {
        const bool t = take && key <= T;
        if (t)
          dst[slot] = ((unsigned long long)key << 32) |
                      (uint32_t)(v.c0 + local);
        slot += t;
      });
    }
  } else {
    // entries below T in any order; of the entries equal to T, the
    // need_eq lowest columns, by their rank in position order
    gc.M = p.margin;
    gc.unordered = (int)below;
    const uint32_t need_eq = R - below + 1;
    uint32_t e = 0;
    sweep<RES>(keys, v, excl, [&](uint32_t key, int, bool, bool take) {
      e += take && key == T;
    });
    e = __reduce_add_sync(kFull, e);
    __syncthreads();
    if (lane == 0) sh.wsum[warp] = e;
    __syncthreads();
    uint32_t run = 0, mine = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      run += w < warp ? sh.wsum[w] : 0u;
      mine += sh.wsum[w];
    }
    if constexpr (CL) {
      if (tid == 0) sh.xch[kXEq] = mine;
      csync<CL>();
      for (int q = 0; q < rank; ++q) run += at_rank<CL>(sh.xch, q)[kXEq];
    }
    sweep<RES>(keys, v, excl, [&](uint32_t key, int local, bool, bool take) {
      const bool lt = take && key < T, eq = take && key == T;
      const unsigned long long packed =
          ((unsigned long long)key << 32) | (uint32_t)(v.c0 + local);
      const unsigned b = __ballot_sync(kFull, lt);
      if (b) {
        uint32_t slot = 0;
        if (lane == __ffs(b) - 1)
          slot = atomicAdd(counter, (uint32_t)__popc(b));
        slot = __shfl_sync(kFull, slot, __ffs(b) - 1);
        if (lt) dst[slot + __popc(b & lanes_below)] = packed;
      }
      const unsigned be = __ballot_sync(kFull, eq);
      if (eq) {
        const uint32_t r = run + __popc(be & lanes_below);
        if (r < need_eq) dst[below + r] = packed;
      }
      run += __popc(be);
    });
  }
  csync<CL>();
  return gc;
}

// ---- stage 2, in the leader: the k best of the M candidates ----
// Sorts the candidates not yet in order, writes the row's first k (the
// row's own values, ascending, and their columns) and puts the k-th key in
// xch[kXTau].
// A key's value; +-0.0 and NaN, whose keys do not keep their bits, are
// read from the row.
__device__ __forceinline__ float key_value(uint32_t key, const float* g,
                                           uint32_t c) {
  if (key == 0x80000000u || key == 0xffffffffu) return g[c];
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}

__device__ __forceinline__ void order_candidates(const Params& p, int r,
                                                 const Gathered& gc,
                                                 const Shared& sh) {
  if (gc.unordered > 1)
    bucket_sort(sh.cand, sh.cand + p.cap, gc.unordered, sh);
  const float* g = p.d + (size_t)r * p.N;
  for (int j = threadIdx.x; j < p.k; j += kThreads) {
    const unsigned long long e = sh.cand[j];
    const uint32_t key = (uint32_t)(e >> 32), c = (uint32_t)e;
    p.out_d[(size_t)r * p.k + j] = key_value(key, g, c);
    p.out_i[(size_t)r * p.k + j] = (long long)c;
  }
  if (threadIdx.x == 0) sh.xch[kXTau] = (uint32_t)(sh.cand[p.k - 1] >> 32);
}

template <bool RES, bool CL>
__global__ void __launch_bounds__(kThreads, 2)
verified_select_adaptive(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(p.slice, p.nbuf, p.cap);
  Shared sh;
  sh.buf = reinterpret_cast<float*>(smem);
  sh.cand = reinterpret_cast<unsigned long long*>(smem + L.cand);
  sh.hist = reinterpret_cast<uint32_t*>(smem + L.hist);
  sh.mbar = reinterpret_cast<uint64_t*>(smem + L.mbar);
  sh.wsum = reinterpret_cast<uint32_t*>(smem + L.scratch);
  sh.wscan = sh.wsum + 16;
  sh.wadd = sh.wsum + 24;
  sh.pick = sh.wsum + 32;
  sh.xch = sh.wsum + 40;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = CL ? (int)cluster_nctarank() : 1;
  const int rank = CL ? (int)cluster_ctarank() : 0;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int c0 = min(p.N, rank * p.slice);
  const int len = min(p.N, c0 + p.slice) - c0;
  // this warp's stretch of the slice, lane-strided
  const int wspan = ((len + kWarps - 1) / kWarps + 31) & ~31;
  View v;
  v.c0 = c0;
  v.wlo = min(len, warp * wspan);
  v.whi = min(len, v.wlo + wspan);

  for (int i = tid; i < kHistWords; i += kThreads) sh.hist[i] = 0;
  if (tid == 0) {
    for (int b = 0; b < p.nbuf; ++b) mbar_init(smem_u32(sh.mbar + b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL) csync<CL>();

  // the slice of the it-th row this cluster takes, into buffer it % nbuf
  auto issue = [&](int it) {
    const int r = cid + it * ncl;
    if (r >= p.Q) return;
    const int b = it % p.nbuf;
    bulk_load(sh.buf + (size_t)b * p.slice, p.d + (size_t)r * p.N + c0,
              (uint32_t)len * 4, smem_u32(sh.mbar + b));
  };
  if (tid == 0)
    for (int it = 0; it < p.nbuf - 1; ++it) issue(it);

  for (int it = 0, r = cid; r < p.Q; ++it, r += ncl) {
    if (p.nbuf > 0) {
      if (tid == 0) issue(it + p.nbuf - 1);
      const int b = it % p.nbuf;
      mbar_wait(smem_u32(sh.mbar + b), (uint32_t)((it / p.nbuf) & 1));
      v.sm = sh.buf + (size_t)b * p.slice;
    }
    v.smem = p.nbuf > 0;
    v.gl = p.d + (size_t)r * p.N + c0;
    uint32_t keys[kKpt];
    if constexpr (RES) {
      // every load in bounds (the last column again past the stretch's
      // end; the sweeps' masks leave those slots out), none behind a branch
      if (v.whi > v.wlo) {
        with_source(v, [&](const float* src, auto from) {
#pragma unroll
          for (int i = 0; i < kKpt; ++i)
            keys[i] = ordered_key(
                load(from, src, min(v.wlo + i * 32 + lane, v.whi - 1)));
        });
      }
    }

    // the first attempt leaves out `exclude`; a row that fails the proof is
    // selected again over every column (the fallback)
    for (int attempt = 0;; ++attempt) {
      const Gathered gc = select_candidates<RES, CL>(
          keys, v, p, attempt ? -1 : p.exclude, C, rank, sh);
      if (rank == 0) order_candidates(p, r, gc, sh);
      csync<CL>();
      if (attempt) break;   // the fallback's selection is exact

      // ---- the proof over the whole row (the excluded column included):
      // the selection's entries below tau are the candidates below it ----
      const uint32_t tau = at_rank<CL>(sh.xch, 0)[kXTau];
      uint32_t mine = 0;
      sweep<RES>(keys, v, -1, [&](uint32_t key, int, bool valid, bool) {
        mine += valid && key < tau;
      });
      if (rank == 0)
        for (int j = tid; j < gc.M; j += kThreads)
          mine -= (uint32_t)(sh.cand[j] >> 32) < tau;   // wraps; sum exact
      uint32_t total = block_add(mine, sh);
      if constexpr (CL) {
        if (tid == 0) sh.xch[kXProof] = total;
        csync<CL>();
        total = 0;
        for (int q = 0; q < C; ++q) total += at_rank<CL>(sh.xch, q)[kXProof];
      }
      const bool proved = total == 0;
      if (rank == 0 && tid == 0) {
        p.ok[r] = proved ? 1 : 0;
        if (!proved) atomicAdd(p.failed, 1u);
      }
      if (proved) break;
      __syncthreads();
    }
    __syncthreads();   // the buffer and the candidates are free again
  }
  // no block leaves while another block of its cluster may still read its
  // shared memory
  if constexpr (CL) csync<CL>();
}

// Clusters of `cluster` blocks the card holds at once at `bytes` of shared
// memory a block, by device and cluster size (the occupancy query costs
// more than the launch).
struct Active {
  int device = -1, clusters = 0;
  size_t bytes = 0;
};

// Launches one instantiation: sets its shared-memory limit, asks how many
// clusters the card holds at this size (0 refuses the launch; *active
// reports it) and launches at most that many, since they walk the rows.
template <bool RES, bool CL>
int launch(const Params& p, int cluster, int clusters, size_t bytes,
           int* active, cudaStream_t stream) {
  static Active cache[8][kMaxCluster + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(verified_select_adaptive<RES, CL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Active& a = cache[dev & 7][cluster];
  if (a.device != dev || a.bytes != bytes) {
    cfg.gridDim = dim3(cluster);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, verified_select_adaptive<RES, CL>,
                                         &cfg);
    if (err != cudaSuccess) return (int)err;
    a.device = dev;
    a.bytes = bytes;
    a.clusters = n;
  }
  *active = a.clusters;
  if (*active < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((clusters < *active ? clusters : *active) * cluster);
  err = cudaLaunchKernelEx(&cfg, verified_select_adaptive<RES, CL>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace adaptive


}  // namespace

// d: (Q, N) fp32 contiguous; out_d (Q, k) fp32, out_i (Q, k) int64, ok (Q,)
// bytes, failed one uint32 counter. margin = min(N, max(k + 28, 5k / 4)).
// On the plan of ops/verified_kernel.py:plan: `cluster` blocks a row (1-8),
// `clusters` clusters walking the rows (at most as many as the card holds
// at once, *active; 0 refuses the launch), `slice` columns a block, `nbuf`
// shared row buffers filled by bulk copies (0: the threads load from device
// memory), `smem_bytes` the layout's total (checked here). Returns 0 or a
// CUDA error; a launch it refuses never runs.
extern "C" int verified_select_adaptive_launch(
    const void* d, int Q, int N, int k, int margin, int exclude, void* out_d,
    void* out_i, void* ok, void* failed, int cluster, int clusters, int slice,
    int nbuf, int smem_bytes, int* active, void* stream) {
  using namespace adaptive;
  const bool excl = exclude >= 0 && exclude < N;
  const int valid = excl ? N - 1 : N;
  *active = 0;
  if (Q < 0 || k < 1 || margin < k || margin > valid || margin > 8192)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int cap = capacity(margin);
  if (cluster < 1 || cluster > kMaxCluster || clusters < 1 || slice < 1 ||
      nbuf < 0 || nbuf > kMaxBuffers ||
      (long long)slice * cluster < N ||
      (long long)slice * (cluster - 1) >= N ||
      (slice > kTile && cluster == 1))   // wider slices take a cluster
    return (int)cudaErrorInvalidValue;
  if (nbuf > 0 && (N % 4 != 0 || slice % 4 != 0 ||
                   reinterpret_cast<uintptr_t>(d) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = layout(slice, nbuf, cap).total;
  if (bytes != (size_t)smem_bytes || bytes > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const Params p = {(const float*)d, Q, N, k, margin, excl ? exclude : -1,
                    slice, nbuf, cap, (float*)out_d, (long long*)out_i,
                    (uint8_t*)ok, (unsigned int*)failed};
  cudaStream_t st = (cudaStream_t)stream;
  if (slice > kTile)
    return launch<false, true>(p, cluster, clusters, bytes, active, st);
  return cluster > 1
             ? launch<true, true>(p, cluster, clusters, bytes, active, st)
             : launch<true, false>(p, cluster, clusters, bytes, active, st);
}
