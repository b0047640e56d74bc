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
// has to stay on the chip and cheap.
//
// Design: one block owns qb = min(8, 64 / Tq) queries (their qb*Tq <= 64
// token rows, q-major, straight from the row-major (Q, Tq, dim) tensor) x
// one 8192-doc mega, and walks the mega in 128-doc steps, so every lane bin
// gets exactly one doc per step (position = step index). Inside a step the
// block loops over the doc-token index s: the B tile of iteration (step, s)
// is token s of each of the step's 128 docs (a strided read of the
// row-major (D, Td, dim) tensor, no td-major copy). Eight warps each own a
// fixed 32-row x 32-doc tile of the 64 x 128 product (mma.sync m16n8k16
// from ldmatrix fragments), so the max over a doc's tokens is a
// register-wise running max next to the accumulator: token s of a doc lands
// in the same accumulator element for every s. The sum over a query's Tq
// rows crosses the row groups of a warp and the two row-warps, so once per
// step the running maxima go through a 64 x 128 fp32 tile in shared memory;
// thread (query, lane) then adds its column in token order, applies the
// bias and inserts the key into the bin's 4 keys, which live in its
// registers for the whole mega. Operands stream through the same cp.async
// ring of 64-column chunks as csrc/screen_keys.cu (6, 4 or 3 stages at 1, 2
// or 3 passes); the query chunk is re-fetched with every doc chunk (it
// stays in L1/L2). Blocks share nothing; consecutive blocks take
// consecutive query blocks of one mega, so concurrent blocks read the same
// doc rows from L2. One block per SM (about 200 KB of shared memory).
// wgmma, TMA, a resident query tile and taller query blocks are left to
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query-token rows per block
constexpr int BR = 128;         // docs per step (= lanes)
constexpr int KC = 64;          // depth chunk per pipeline stage
constexpr int LDS = KC + 8;     // bf16 row stride (144 B: ldmatrix rows hit
                                // distinct bank groups)
constexpr int SMS = BR + 8;     // fp32 row stride of the per-step max tile
constexpr int KEEP = 4;
constexpr int POS_MASK = 1023;
constexpr int MEGA_DOCS = 8192;
constexpr int THREADS = 256;
constexpr int MAX_QB = 8;       // queries per block at most
constexpr int MAXP = MAX_QB * BR / THREADS;   // (query, lane) bins per thread
constexpr float NEG_BIAS = -1e30f;

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

// NaN-propagating max, as jnp.maximum (fmaxf would drop the NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
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
            sc = __fadd_rn(sc, dbias);
            float neg = -sc;
            if (neg != neg) neg = __int_as_float(0x7f800000);
            int bits = __float_as_int(neg);
            bits ^= (bits >> 31) & 0x7fffffff;
            int hi = (bits & ~POS_MASK) | step;
#pragma unroll
            for (int t = 0; t < KEEP; ++t) {
              const int cur = keys[p][t];
              keys[p][t] = min(cur, hi);
              hi = max(cur, hi);
            }
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

}  // namespace

// qhi/qlo: (Q, Tq, dimp) bf16, dhi/dlo: (Dn, Td, dimp) bf16, bias: (Dn,) f32,
// out: (Q, n_mega*512) int32; 1 <= Tq <= 32, Td >= 1, dimp % 16 == 0,
// n_mega = ceil(Dn / 8192) <= 65535. Returns the CUDA error code (0 = ok).
extern "C" int maxsim_keys_launch(const void* qhi, const void* qlo,
                                  const void* dhi, const void* dlo,
                                  const void* bias, void* out, int Q, int Tq,
                                  int Dn, int Td, int dimp, int n_mega,
                                  int passes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Tq < 1 || Tq > 32 || Td < 1 || dimp < 16 || dimp % 16 != 0 ||
      n_mega < 1 || n_mega > 65535)
    return (int)cudaErrorInvalidValue;
  if (passes == 1)
    return launch<1>(qhi, qlo, dhi, dlo, bias, out, Q, Tq, Dn, Td, dimp,
                     n_mega, st);
  if (passes == 2)
    return launch<2>(qhi, qlo, dhi, dlo, bias, out, Q, Tq, Dn, Td, dimp,
                     n_mega, st);
  if (passes == 3)
    return launch<3>(qhi, qlo, dhi, dlo, bias, out, Q, Tq, Dn, Td, dimp,
                     n_mega, st);
  return (int)cudaErrorInvalidValue;
}
