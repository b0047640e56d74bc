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
