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
// function is compute-bound, so the design keeps every distance in
// registers and spends its effort on feeding the tensor cores.
//
// Design: one block owns 64 queries x one mega-tile and walks the mega in
// 128-row steps. A step gives every lane bin exactly one row (position =
// step index). Eight warps each own a fixed 32-query x 32-lane tile of the
// step's 64 x 128 product, computed with mma.sync m16n8k16 (bf16 in, fp32
// accumulate) from ldmatrix fragments; since a warp's tile covers the same
// (query, lane) pairs in every step, each accumulator element's 4 running
// keys live in registers next to it and the insert is one compare-swap
// chain, with no shared-memory traffic. Operands stream through a cp.async
// ring of 64-column chunks (6, 4 or 3 stages at 1, 2 or 3 passes: a stage
// holds only the operands the pass count reads) that runs across step
// boundaries, so the loads of later chunks overlap the products of this
// one; the step's base norms are fetched at its first chunk. Blocks
// share no state; consecutive blocks take consecutive query blocks of one
// mega, so concurrent blocks read the same base rows from L2.
// wgmma, TMA and a persistent schedule are left to later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BR = 128;         // base rows per step (= lanes)
constexpr int KC = 64;          // depth chunk per pipeline stage
constexpr int LDS = KC + 8;     // bf16 row stride (144 B: ldmatrix rows hit
                                // distinct bank groups)
constexpr int KEEP = 4;
constexpr int POS_MASK = 1023;
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
              int bits = __float_as_int(d);
              if (epilogue != 0) bits ^= (bits >> 31) & 0x7fffffff;
              int hi = (bits & ~POS_MASK) | step;
#pragma unroll
              for (int t = 0; t < KEEP; ++t) {
                const int cur = keys[mi][ni][c][t];
                keys[mi][ni][c][t] = min(cur, hi);
                hi = max(cur, hi);
              }
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

}  // namespace

extern "C" int screen_keys_launch(const void* qhi, const void* qlo,
                                  const void* bhi, const void* blo,
                                  const void* qn, const void* bn, void* out,
                                  int Q, int B, int D, int mega_rows,
                                  int n_mega, int passes, int epilogue,
                                  int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (passes == 1)
    return launch<1>(qhi, qlo, bhi, blo, qn, bn, out, Q, B, D, mega_rows,
                     n_mega, epilogue, vec, st);
  if (passes == 2)
    return launch<2>(qhi, qlo, bhi, blo, qn, bn, out, Q, B, D, mega_rows,
                     n_mega, epilogue, vec, st);
  if (passes == 3)
    return launch<3>(qhi, qlo, bhi, blo, qn, bn, out, Q, B, D, mega_rows,
                     n_mega, epilogue, vec, st);
  return (int)cudaErrorInvalidValue;
}
