// The host side of E3's "staged" launch (masked_softmax.cu): the SM count
// and the occupancy query behind the check that a plan's grid
// (ops/encoder_fused.py:row_plan) fits on the card.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace rowstream {

constexpr int kSmemLimit = 232448;       // dynamic shared memory a block

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
