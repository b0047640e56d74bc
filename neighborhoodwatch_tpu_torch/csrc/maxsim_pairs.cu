// M2: the screened MaxSim engine's exact re-rank, each query passage
// against its own candidate docs read by id, for Hopper (sm_90a).
//
// Replaces the fusions XLA makes under jax.jit of
// neighborhoodwatch_tpu/ops/maxsim.py _maxsim_select's `refine` (:260-270:
// the candidates' re-rank) and _bin_repair's `block_s` (:386-397: the
// class-A repair's bin members): a gather docs[ids] fused into a HIGHEST
// precision einsum and the max / sum reductions (not Pallas kernels). The
// plain PyTorch version (ops/maxsim_fused.py:maxsim_pairs_plain) gathers a
// (rows, M, Td, dim) fp32 copy of the candidates, 268 MB for 128 queries x
// 256 candidates x 16 x 128, and einsums it; this kernel reads each
// candidate's tokens where they lie.
//
// score[b, j] = sum_t (q_mask ? max_s (d_mask ? <q_t, d_s> : -1e30) : 0)
// for doc ids[b, j], fp32; NaN passes through (the callers decide what it
// means), and an id outside [0, N) gives NaN (the plain version cannot
// index it).
//
// Tile (csrc/maxsim_tile.cuh): one query passage's 32 token slots x 512
// doc-token slots a block (32 candidates of 16 tokens, 8 of 64); one block
// an SM (139 KB of stages). Bound: operations, 2 B M Tq Td dim FLOP at 67
// TFLOP/s, against the bytes of the candidates' tokens, each read once a
// query (B M Td dim 4; L2 serves the queries that share candidates).

#include "maxsim_tile.cuh"

// q: (B, Tq, dim) fp32; qm: (B, Tq) bool; d: (N, Td, dim) fp32; dm: (N, Td)
// bool; ids: (B, M) int64; out: (B, M) fp32. `vec`: dim % 4 == 0 and q, d
// 16-byte aligned. Returns a CUDA error code, 0 on success.
extern "C" int maxsim_pairs_launch(const void* q, const void* qm,
                                   const void* d, const void* dm,
                                   const void* ids, void* out, int B, int Tq,
                                   long long N, int Td, int dim, int M,
                                   int vec, void* stream) {
  if (B < 0 || M < 0 || N < 0 || Tq < 1 || Td < 1 || dim < 1 ||
      (vec && dim % 4))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  return (int)maxsim::launch<32, true>(
      (const float*)q, (const uint8_t*)qm, (const float*)d,
      (const uint8_t*)dm, (const long long*)ids, (float*)out, B, Tq, N, Td,
      dim, M, vec != 0, (cudaStream_t)stream);
}

// ---- variant "split" (csrc/maxsim_split.cuh) ----

#include "maxsim_split.cuh"

// The "split" variant on the plan of ops/maxsim_fused.py:plan, which this
// function recomputes: n the passage's padded length (the wgmma's N: 16,
// 32 or 64), kc its chunk (16), td_p the padded doc length, cand_block the
// candidates a block (blockIdx.y), smem the dynamic shared memory. A plan
// it would not make returns msplit::kErrPlan; q and d 16-byte aligned.
extern "C" int maxsim_pairs_split_launch(
    const void* q, const void* qm, const void* d, const void* dm,
    const void* ids, void* out, int B, int Tq, long long N, int Td, int dim,
    int M, int kc, int n, int td_p, int cand_block, int smem,
    void* stream) {
  if (B < 1 || M < 1 || N < 1 || N > 0x7fffffffLL || Tq < 1 || Tq > 64 ||
      Td < 1 || Td > 64 || dim < 16 || (uintptr_t)q % 16 ||
      (uintptr_t)d % 16)
    return (int)cudaErrorInvalidValue;
  const int dpt = msplit::slot_rows(true) / td_p;
  const long long grid_y =
      cand_block > 0 ? (M + (long long)cand_block - 1) / cand_block : 0;
  if (n != msplit::pow2_at_least(Tq, 16) ||
      td_p != msplit::pow2_at_least(Td, 8) ||
      kc != msplit::kKC || !msplit::admits(dim, 3) ||
      msplit::b_bytes(n, dim, 3) > msplit::kMaxBBytes ||
      msplit::stages_for(true, n, n, dim, 3) < 2 ||
      smem != msplit::smem_bytes(true, n, n, dim, 3) || cand_block < dpt ||
      cand_block % dpt || grid_y > 65535)
    return msplit::kErrPlan;
  msplit::Args g = {};
  g.q = (const float*)q;
  g.qm = (const uint8_t*)qm;
  g.d = (const float*)d;
  g.dm = (const uint8_t*)dm;
  g.ids = (const long long*)ids;
  g.out = (float*)out;
  g.D = N;
  g.Q = B;
  g.Tq = Tq;
  g.Td = Td;
  g.dim = dim;
  g.M = M;
  g.tq_p = n;
  g.td_p = td_p;
  g.qpt = 1;
  g.cand_block = cand_block;
  g.stages = msplit::stages_for(true, n, n, dim, 3);
  cudaStream_t st = (cudaStream_t)stream;
  const int gy = (int)grid_y;
  if (n == 16) return msplit::launch<16, 3, true>(g, B, gy, smem, st);
  if (n == 32) return msplit::launch<32, 3, true>(g, B, gy, smem, st);
  return msplit::launch<64, 3, true>(g, B, gy, smem, st);
}
