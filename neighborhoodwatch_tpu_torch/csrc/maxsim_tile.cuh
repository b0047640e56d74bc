// The MaxSim engines' tile, shared by M1 (csrc/maxsim_dense.cu) and M2
// (csrc/maxsim_pairs.cu), for Hopper (sm_90a): query tokens against doc
// tokens in fp32 on the CUDA cores, with the max over each doc's tokens
// and the sum over each query's tokens folded into the tile, so the
// (query tokens x doc tokens) similarity matrix is never written.
//
// What a launch computes, for query passage p (Tq tokens, mask qm) and doc
// e (Td tokens, mask dm), every operand fp32:
//   sim(t, s)  = sum_k q[p, t, k] * d[e, s, k]    (fmaf, k ascending)
//   tok(t)     = max over s < Td of (dm[e, s] ? sim(t, s) : -1e30),
//                NaN if any selected value is NaN (max.NaN, as torch.amax)
//   score(p,e) = sum over t < Tq of (qm[p, t] ? tok(t) : 0)
// The masks select, never multiply: a masked token may hold NaN or inf.
//
// Layout, as an SGEMM tiles its registers: a block of 256 threads holds a
// BM x BN tile of (query-token slot, doc-token slot) products, a thread an
// 8 x 8 micro-tile. A passage's tokens take tq_p slots (the power of two
// >= Tq, at least 8, at most BM; longer passages loop over chunks of BM
// tokens) and a doc's td_p (the power of two >= Td, at least 8, at most
// 8 x 32 lanes' worth; longer docs loop over chunks). So a thread's 8 rows
// are tokens of one passage and its 8 columns tokens of one doc: the max
// over a doc's tokens is 8 registers, then a butterfly of td_p / 8 lanes
// of one warp (max.NaN), and the sum over a passage's tokens is 8
// registers, then a fixed-order sum of tq_p / 8 partial sums through
// shared memory. No atomics: two launches give equal bits.
//
// The dim axis streams through shared memory 32 floats a stage, two
// stages, by cp.async (16 bytes a copy where rows are 16-byte aligned and
// dim % 4 == 0, else 4; zero fill past dim and for padding slots). A row
// of a stage is 128 bytes, its eight 16-byte chunks stored at chunk ^
// (row / 8 % 8), so the float4 reads of eight threads with neighbouring
// columns (rows tx * 8 + j) hit eight distinct bank groups. Each chunk of
// a block (slots x one range of tokens) first writes its slots' token rows
// to shared memory; the masks are read while the first stage is in
// flight. A k-chunk of 4 is eight float4 of A and eight of B from shared
// memory, then four 8 x 8 outer products (each FMA of one independent of
// the next). One block an SM: the compiler takes 254 registers; capped at
// 128 for two blocks an SM it spilled and ran slower.
//
// Bound on this card: operations (fp32 FMA on the CUDA cores; 67 TFLOP/s):
// at the stream's fallback, 718 x 32 x 128 against 2,048 x 16, a step is
// 1.93e11 FLOP (2.9 ms) and reads 28 MB. Tensor cores are left out on
// purpose: a 3xTF32 or bf16x3 split changes the rounding model the
// certificate's re-rank accuracy is stated for.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace maxsim {


constexpr int kThreads = 256;
constexpr int kTM = 8;             // query-token slots a thread
constexpr int kTN = 8;             // doc-token slots a thread
constexpr int kBK = 32;            // dim a stage
constexpr int kChunks = kBK / 4;   // 16-byte chunks a row of a stage
constexpr int kStages = 2;
constexpr int kMaxGridY = 65535;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int BM>
struct Tile {
  static constexpr int BN = kThreads * kTM * kTN / BM;
  static constexpr int RY = BM / kTM;    // thread rows
  static constexpr int RX = BN / kTN;    // thread columns
  static constexpr int kSmemBytes = kStages * (BM + BN) * kBK * 4;
  // a doc's slots span at most one warp's columns
  static constexpr int kMaxDocSlots = kTN * (RX < 32 ? RX : 32);
};

// slots and chunks of one launch (host-computed)
struct Geometry {
  int Q, Tq, dim, Td, M;   // M: candidates a query (M2), else 0
  long long N;             // docs in the array
  int tq_p, tq_shift, nq;  // query-token slots a passage, log2, chunks
  int qb;                  // passages a block
  int td_p, td_shift, nd;  // doc-token slots a doc, log2, chunks
  int db;                  // docs a block
};

inline int slots_for(int tokens, int cap, int* shift) {
  int p = 8, s = 3;
  while (p < tokens && p < cap) {
    p <<= 1;
    ++s;
  }
  *shift = s;
  return p;
}

template <int BM>
Geometry geometry(int Q, int Tq, long long N, int Td, int dim, int M,
                  bool pairs) {
  Geometry g;
  g.Q = Q;
  g.Tq = Tq;
  g.dim = dim;
  g.Td = Td;
  g.M = M;
  g.N = N;
  g.tq_p = slots_for(Tq, BM, &g.tq_shift);
  g.nq = (Tq + g.tq_p - 1) / g.tq_p;
  g.qb = pairs ? 1 : BM / g.tq_p;
  g.td_p = slots_for(Td, Tile<BM>::kMaxDocSlots, &g.td_shift);
  g.nd = (Td + g.td_p - 1) / g.td_p;
  g.db = Tile<BM>::BN / g.td_p;
  return g;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one 16-byte chunk of a stage: floats k .. k+3 of token row `row` (-1: a
// padding slot), zero past dim
template <bool kVec>
__device__ __forceinline__ void copy_chunk(float* dst, const float* base,
                                           long long row, int k, int dim) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (kVec) {
    const bool ok = row >= 0 && k < dim;
    cp_async16(s, ok ? base + row * dim + k : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row >= 0 && k + e < dim;
      cp_async4(s + 4 * e, ok ? base + row * dim + k + e : base, ok ? 4 : 0);
    }
  }
}

// kPairs = false (M1): block (x, y) takes docs x*db .. and passages y*qb ..,
//   out (Q, N), a NaN score written as -1e30.
// kPairs = true (M2): block (x, y) takes query y and its candidates
//   ids[y, x*db ..], out (Q, M), NaN kept; an id outside [0, N) gives NaN.
template <int BM, bool kPairs, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_tile_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qm,
                   const float* __restrict__ d,
                   const uint8_t* __restrict__ dm,
                   const long long* __restrict__ ids, float* __restrict__ out,
                   const Geometry g) {
  using T = Tile<BM>;
  constexpr int BN = T::BN, RX = T::RX;
  constexpr int kBPer = (BN + kThreads - 1) / kThreads;  // columns a thread
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                        // [kStages][BM][kBK]
  float* const Bs = smem + kStages * BM * kBK;   // [kStages][BN][kBK]
  // the block's docs: row of d, -1 past the docs / candidates, -2 an id
  // outside [0, N)
  __shared__ long long doc_of[RX];
  // the current chunk's slots: token row (-1: a padding slot), and what
  // the masks make of it (rows: 1 a valid query token; columns: 2 a
  // value, 1 a masked doc token (-1e30), 0 a padding slot)
  __shared__ long long a_row[BM], b_row[BN];
  __shared__ uint8_t a_on[BM], b_state[BN];
  __shared__ float part[T::RY * RX];             // [thread row][doc]

  const int tid = threadIdx.x;
  const int tx = tid % RX, ty = tid / RX;
  const long long col0 = (long long)blockIdx.x * g.db;
  const long long row_blocks =
      kPairs ? g.Q : (g.Q + g.qb - 1) / (long long)g.qb;
  const int nk = (g.dim + kBK - 1) / kBK;
  const int lanes_a_doc = g.td_p / kTN;
  const int rows_a_passage = g.tq_p / kTM;
  const int outputs = (kPairs ? 1 : g.qb) * g.db;

  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * BM * kBK;
    float* bs = Bs + stage * BN * kBK;
    for (int f = tid; f < BM * kChunks; f += kThreads) {
      const int r = f / kChunks, c = f % kChunks;
      copy_chunk<kVec>(as + r * kBK + ((c ^ ((r >> 3) & 7)) << 2), q,
                       a_row[r], k0 + c * 4, g.dim);
    }
    for (int f = tid; f < BN * kChunks; f += kThreads) {
      const int n = f / kChunks, c = f % kChunks;
      copy_chunk<kVec>(bs + n * kBK + ((c ^ ((n >> 3) & 7)) << 2), d,
                       b_row[n], k0 + c * 4, g.dim);
    }
  };

  for (long long yb = blockIdx.y; yb < row_blocks; yb += gridDim.y) {
    __syncthreads();                   // the previous block row's readers
    for (int dl = tid; dl < g.db; dl += kThreads) {
      const long long c = col0 + dl;
      long long doc = -1;
      if (kPairs) {
        if (c < g.M) {
          const long long id = ids[yb * g.M + c];
          doc = (id >= 0 && id < g.N) ? id : -2;
        }
      } else if (c < g.N) {
        doc = c;
      }
      doc_of[dl] = doc;
    }

    float total = 0.0f;                // the score of output `tid`
    for (int qc = 0; qc < g.nq; ++qc) {
      float mx[kTM];                   // running max over the doc's tokens
#pragma unroll
      for (int i = 0; i < kTM; ++i) mx[i] = -INFINITY;
      for (int dc = 0; dc < g.nd; ++dc) {
        __syncthreads();               // doc_of; the last chunk's readers
        if (dc == 0) {
          for (int r = tid; r < BM; r += kThreads) {
            const int ql = r >> g.tq_shift;
            const int t = qc * g.tq_p + (r & (g.tq_p - 1));
            const long long p =
                kPairs ? (ql == 0 ? yb : -1) : yb * g.qb + ql;
            a_row[r] = p >= 0 && p < g.Q && t < g.Tq ? p * g.Tq + t : -1;
          }
        }
        for (int n = tid; n < BN; n += kThreads) {
          const long long doc = doc_of[n >> g.td_shift];
          const int s = dc * g.td_p + (n & (g.td_p - 1));
          b_row[n] = doc >= 0 && s < g.Td ? doc * g.Td + s : -1;
        }
        __syncthreads();

        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

        load_stage(0, 0);
        cp_commit();
        // the masks, read while the first stage is in flight and stored
        // after its products (the epilogue reads them)
        uint8_t a_pend = 0, b_pend[kBPer];
        if (dc == 0 && tid < BM) {
          const long long row = a_row[tid];
          a_pend = row >= 0 && qm[row];
        }
#pragma unroll
        for (int u = 0; u < kBPer; ++u) {
          const int n = tid + u * kThreads;
          const long long row = n < BN ? b_row[n] : -1;
          b_pend[u] = row < 0 ? 0 : (dm[row] ? 2 : 1);
        }
        for (int kt = 0; kt < nk; ++kt) {
          if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kBK);
          cp_commit();
          cp_wait_one();
          __syncthreads();
          const float* as = As + (kt & 1) * BM * kBK + ty * kTM * kBK;
          const float* bs = Bs + (kt & 1) * BN * kBK + tx * kTN * kBK;
          const int sa = ty & 7, sb = tx & 7;
          // a k-chunk: 8 float4 of A and of B, four outer products
#pragma unroll
          for (int kc = 0; kc < kChunks; ++kc) {
            float4 a[kTM], b[kTN];
#pragma unroll
            for (int i = 0; i < kTM; ++i)
              a[i] = *reinterpret_cast<const float4*>(
                  as + i * kBK + ((kc ^ sa) << 2));
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              b[j] = *reinterpret_cast<const float4*>(
                  bs + j * kBK + ((kc ^ sb) << 2));
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
          if (kt == 0) {
            if (dc == 0 && tid < BM) a_on[tid] = a_pend;
#pragma unroll
            for (int u = 0; u < kBPer; ++u)
              if (tid + u * kThreads < BN)
                b_state[tid + u * kThreads] = b_pend[u];
          }
          __syncthreads();
        }

        // the doc mask selects: a value, -1e30, or nothing
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int st = b_state[tx * kTN + j];
          if (st == 0) continue;
#pragma unroll
          for (int i = 0; i < kTM; ++i)
            mx[i] = max_nan(mx[i], st == 2 ? acc[i][j] : kNeg);
        }
      }
      // the max over the doc's tokens across its lanes
      for (int off = 1; off < lanes_a_doc; off <<= 1) {
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          mx[i] = max_nan(mx[i], __shfl_xor_sync(kFull, mx[i], off));
      }
      // the sum over this thread's query tokens, in token order
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        psum += a_on[ty * kTM + i] ? mx[i] : 0.0f;
      if ((tx & (lanes_a_doc - 1)) == 0)
        part[ty * RX + tx / lanes_a_doc] = psum;
      __syncthreads();
      // output `tid` = (passage ql, doc dl): its thread rows in order
      if (tid < outputs) {
        const int ql = tid / g.db, dl = tid % g.db;
        for (int r = ql * rows_a_passage; r < (ql + 1) * rows_a_passage; ++r)
          total += part[r * RX + dl];
      }
    }
    if (tid < outputs) {
      const int ql = tid / g.db, dl = tid % g.db;
      const long long doc = doc_of[dl];
      if (kPairs) {
        if (doc != -1)
          out[yb * g.M + col0 + dl] = doc >= 0 ? total : NAN;
      } else {
        const long long p = yb * g.qb + ql;
        if (doc >= 0 && p < g.Q)
          out[p * g.N + doc] = isnan(total) ? kNeg : total;
      }
    }
  }
}

template <int BM, bool kPairs>
cudaError_t launch(const float* q, const uint8_t* qm, const float* d,
                   const uint8_t* dm, const long long* ids, float* out,
                   int Q, int Tq, long long N, int Td, int dim, int M,
                   bool vec, cudaStream_t st) {
  const Geometry g = geometry<BM>(Q, Tq, N, Td, dim, M, kPairs);
  const long long cols = kPairs ? (long long)M : N;
  const long long gx = (cols + g.db - 1) / g.db;
  const long long rows = kPairs ? Q : (Q + g.qb - 1) / (long long)g.qb;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const int smem = Tile<BM>::kSmemBytes;
  auto kernel = vec ? maxsim_tile_kernel<BM, kPairs, true>
                    : maxsim_tile_kernel<BM, kPairs, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(q, qm, d, dm, ids, out, g);
  return cudaGetLastError();
}

}  // namespace maxsim
