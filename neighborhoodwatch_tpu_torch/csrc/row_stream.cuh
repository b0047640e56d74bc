// Async copies for the encoders' "staged" kernels: E2 (add_layernorm.cu)
// brings a block's w and b into shared memory by 1-D bulk async copies
// (cp.async.bulk, the Tensor Memory Accelerator's copy without a tensor
// map), their arrival counted on an mbarrier, in flight while the block's
// threads load their first rows. Thread 0 issues the copies; every
// thread waits on the barrier before it first reads w and b.
//
// Bulk copies need 16-byte aligned addresses and lengths that are
// multiples of 16 bytes: the plan (ops/encoder_fused.py:row_plan) sends
// other rows to the "rowpass" kernels.
//
// E1 (embed_layernorm.cu) stages its shared rows by cp.async, 16 bytes a
// thread at a time (cp_async16).
//
// The host side: the SM count and the occupancy query behind the check
// that a plan's grid fits on the card (E1-E3; F3 rerank_rows.cu sizes its
// persistent grid with them).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace rowstream {

constexpr uint32_t kCopyChunk = 16384;   // bytes a bulk copy instruction
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// every barrier initialised: visible to the async proxy (the copies'
// completions) and, after a block barrier, to the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completion counted on `bar`;
// the caller has announced the bytes (mbar_expect_tx)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
    const uint32_t n = bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32((char*)dst + off)),
           "l"((const char*)src + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

// 16 bytes from device memory into this block's shared memory by the
// asynchronous copy (cp.async, Ampere's: no registers held while it flies,
// cached in L2 only); both addresses 16-byte aligned. E1's "staged" kernel
// brings its shared rows in so, in flight beside its first id and word
// loads. cp_async_wait: every copy this thread issued has landed (a block
// barrier after it makes them visible to the other threads).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// ---- host side: what the launch functions check a plan against

// The SM count of the current device, asked once per device.
inline cudaError_t sm_count(int* n) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *n = cache[dev];
  return cudaSuccess;
}

// Blocks of `threads` threads of kernel `fn` an SM of the current device
// holds at `bytes` of dynamic shared memory: the occupancy query, asked
// once per device, kernel and size (it costs more than a launch; a launch
// inside a graph capture finds the answer its warm-up asked for). Lifts
// the kernel's dynamic shared-memory limit to the largest size asked for
// first.
inline cudaError_t resident_blocks(const void* fn, int threads, int bytes,
                                   int* blocks) {
  struct Entry {
    const void* fn;
    int device, bytes, blocks;
  };
  static Entry cache[512];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  int lifted = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn != fn || cache[i].device != dev) continue;
    if (cache[i].bytes == bytes) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
    if (cache[i].bytes > lifted) lifted = cache[i].bytes;
  }
  if (bytes > lifted) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
  }
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                      (size_t)bytes);
  if (err != cudaSuccess) return err;
  if (used < 512) cache[used++] = {fn, dev, bytes, n};
  *blocks = n;
  return cudaSuccess;
}

// A plan's grid against the card: at least one block, no more than the
// card holds at once at these bytes (the plan gives blocks more passes
// instead of a second wave).
inline cudaError_t check_grid(const void* fn, int threads, int bytes,
                              int grid) {
  int sms = 0, blocks = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = resident_blocks(fn, threads, bytes, &blocks);
  if (err != cudaSuccess) return err;
  if (grid < 1 || blocks < 1 || (long long)grid > (long long)sms * blocks)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace rowstream
