// M1: the MaxSim engines' dense scores, products and reductions in one
// pass, for Hopper (sm_90a).
//
// Replaces neighborhoodwatch_tpu/ops/maxsim.py:33 maxsim_scores as XLA
// compiles it under jax.jit (one product of (Q*Tq, D*Td) token rows, "with
// the max/sum reductions fused by XLA"; not a Pallas kernel), as
// _maxsim_tile_step (:76-88) runs it for the exact engine, the screened
// engine's exact fallbacks and the stream's tail tiles. The plain PyTorch
// version (ops/maxsim_fused.py:maxsim_dense_plain) writes the fp32
// similarity matrix with a library product and makes four more passes over
// it (mask, max, mask, sum): 3.0 GB a 2,048-doc step at the stream's
// fallback. This kernel keeps it in registers (csrc/maxsim_tile.cuh).
//
// score[p, e] = sum_t (q_mask ? max_s (d_mask ? <q_t, d_s> : -1e30) : 0),
// a NaN score written as -1e30 (so a garbage doc loses in every engine).
// The wrapper passes fp32 operands: the inputs at precision "highest",
// their bf16 roundings at "default", and at "high" the bf16 hi/lo split
// concatenated along dim (ops/distance.py:bf16_operands), whose products
// are exact in fp32, so only the order of the sums differs from the plain
// version.
//
// Tile: 128 query-token slots x 128 doc-token slots a block (4 passages of
// 32 tokens x 8 docs of 16 at the main shapes), one block an SM. Bound:
// operations, 2 Q Tq D Td dim FLOP at 67 TFLOP/s (2.9 ms at the stream's
// fallback step, whose 28 MB of operands L2 serves after the first read).

#include "maxsim_tile.cuh"

// q: (Q, Tq, dim) fp32; qm: (Q, Tq) bool; d: (D, Td, dim) fp32; dm: (D, Td)
// bool; out: (Q, D) fp32. `vec`: dim % 4 == 0 and q, d 16-byte aligned.
// Returns a CUDA error code, 0 on success.
extern "C" int maxsim_dense_launch(const void* q, const void* qm,
                                   const void* d, const void* dm, void* out,
                                   int Q, int Tq, long long D, int Td,
                                   int dim, int vec, void* stream) {
  if (Q < 0 || D < 0 || Tq < 1 || Td < 1 || dim < 1 || (vec && dim % 4))
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || D == 0) return 0;
  return (int)maxsim::launch<128, false>(
      (const float*)q, (const uint8_t*)qm, (const float*)d,
      (const uint8_t*)dm, nullptr, (float*)out, Q, Tq, D, Td, dim, 0,
      vec != 0, (cudaStream_t)stream);
}

// ---- variant "split" (csrc/maxsim_split.cuh) ----

#include "maxsim_split.cuh"

// The "split" variant on the plan of ops/maxsim_fused.py:plan, which this
// function recomputes: pieces 3 (fp32 operands) or 1 (bf16-valued
// operands), kc its chunk (16), tq_p / td_p the padded passage / doc
// lengths, grid_y the doc tiles' stride, smem the dynamic shared memory. A
// plan it would not make returns msplit::kErrPlan; q and d 16-byte
// aligned.
extern "C" int maxsim_dense_split_launch(
    const void* q, const void* qm, const void* d, const void* dm, void* out,
    int Q, int Tq, long long D, int Td, int dim, int pieces, int kc,
    int tq_p, int td_p, int grid_y, int smem, void* stream) {
  if (Q < 1 || D < 1 || D > 0x7fffffffLL || Tq < 1 || Tq > 64 || Td < 1 ||
      Td > 64 || dim < 16 || (pieces != 1 && pieces != 3) ||
      (uintptr_t)q % 16 || (uintptr_t)d % 16)
    return (int)cudaErrorInvalidValue;
  constexpr int N = 64, BC = 128;
  const int dpt = msplit::slot_rows(false) / td_p;
  const long long n_tiles = (D + dpt - 1) / dpt;
  const int qpt = BC / tq_p;
  const long long gx = (Q + qpt - 1) / qpt;
  if (tq_p != msplit::pow2_at_least(Tq, 8) ||
      td_p != msplit::pow2_at_least(Td, 8) ||
      kc != msplit::kKC || !msplit::admits(dim, pieces) ||
      msplit::b_bytes(BC, dim, pieces) > msplit::kMaxBBytes ||
      msplit::stages_for(false, N, BC, dim, pieces) < 2 ||
      smem != msplit::smem_bytes(false, N, BC, dim, pieces) || grid_y < 1 ||
      grid_y > n_tiles || grid_y > 65535 || gx > 0x7fffffffLL)
    return msplit::kErrPlan;
  msplit::Args g = {};
  g.q = (const float*)q;
  g.qm = (const uint8_t*)qm;
  g.d = (const float*)d;
  g.dm = (const uint8_t*)dm;
  g.out = (float*)out;
  g.D = D;
  g.Q = Q;
  g.Tq = Tq;
  g.Td = Td;
  g.dim = dim;
  g.tq_p = tq_p;
  g.td_p = td_p;
  g.qpt = qpt;
  g.n_tiles = (int)n_tiles;
  g.stages = msplit::stages_for(false, N, BC, dim, pieces);
  cudaStream_t st = (cudaStream_t)stream;
  return pieces == 3
             ? msplit::launch<N, 3, false>(g, (int)gx, grid_y, smem, st)
             : msplit::launch<N, 1, false>(g, (int)gx, grid_y, smem, st);
}
