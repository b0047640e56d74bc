// The product loop shared by csrc/screen_keys.cu and csrc/maxsim_keys.cu on
// Hopper (sm_90a): tiles that TMA loads into a shared-memory ring behind
// mbarriers, multiplied by wgmma.mma_async with the sum in registers.
//
// Both kernels are bound by bf16 tensor-core operations and both lost their
// time feeding mma.sync from small cp.async tiles that every block re-read
// from L2. The pieces here are what the two redesigned kernels are built
// from; their epilogues (distance + key insert; running max, token sum, key
// insert) stay in their own sources.
//
//   * Ring: `stages` slots of shared memory, a full and an empty mbarrier per
//     slot. One producer thread waits for a slot to be empty, announces the
//     slot's bytes (arrive.expect_tx) and starts the TMA loads; the hardware
//     completes the full barrier when the bytes have landed. Consumer warps
//     wait on the full barrier, start their wgmmas, and release the slot once
//     the wgmmas that read it have retired (wait_group), one chunk behind the
//     one they start, so the tensor cores always have a chunk queued.
//   * Tiles are K-major rows of 128 bytes (64 bf16 columns, SWIZZLE_128B) or
//     64 bytes (32 columns, SWIZZLE_64B), 8-row swizzle atoms back to back:
//     exactly what cuTensorMapEncodeTiled writes and what a wgmma shared-
//     memory descriptor with the matching layout type reads. Rows and
//     columns past the tensor's extent arrive as zeros (TMA's out-of-bounds
//     fill), which is the kernels' ragged-edge contract: no operand is ever
//     padded or copied. A tile's base is 1024-byte aligned; advancing a
//     descriptor by 16 columns is then +32 bytes inside the swizzled row.
//   * Cluster multicast: the blocks of a cluster take consecutive row blocks
//     of the A side against the same B tiles, so each block loads 1/CL of a
//     B tile and multicasts it to all; a B tile leaves L2 once per cluster.
//     A slot may then be refilled only when every block's consumers have
//     released it, so a consumer warp arrives on the empty barrier of every
//     block of the cluster (count = consumer warps x CL).
//   * Roles live in one if/else per kernel and never reconverge before the
//     closing cluster barrier, so that setmaxnreg moves registers from the
//     producer warpgroup to the consumers. Every role runs the same number
//     of ring turns; a surplus block of a rounded-up grid runs them too.
//   * Tensor maps are encoded on the host at launch by
//     cuTensorMapEncodeTiled, looked up at run time (no -lcuda at link), and
//     passed by value as __grid_constant__ parameters.
//   * csrc/masked_attention.cu takes the same pieces and a few of its own,
//     kept beside them: 4-D tensor-map loads and stores with their bulk
//     groups, fp16 as well as bf16 wgmma, and wgmma with A from registers
//     against an MN-major B (the transpose-B bit and its descriptor).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int WG_THREADS = 128;      // one warpgroup
constexpr int TILE_ALIGN = 1024;     // swizzle atom: 8 rows x 128 bytes
// launch-function codes beside CUDA's own (the wrappers raise on any)
constexpr int ERR_NO_ENCODE_FN = 20001;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE_BASE = 21000;    // + CUresult of the encode call

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cluster -------------------------------------------------------------

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

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival plus the announcement of `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive on the barrier at the same shared-memory offset in block `cta` of
// the cluster. No cluster-scope release: what the arrival orders is the
// wgmmas' reads of the slot, which have retired, and a cluster-scope fence
// on every release costs microseconds of ring latency.
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

// ---- TMA loads -------------------------------------------------------------
// `mask` names the blocks of the cluster that receive the box (at the same
// offsets, signalling the barrier at the same offset in each); a mask of
// one block takes the plain form.

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint16_t mask, bool multicast) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (multicast) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], "
        "%5;\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1) : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, uint16_t mask,
                                            bool multicast) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (multicast) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], "
        "[%2], %6;\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  }
}

// one box of a 4-D map into this block only
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from this block's shared memory to a 4-D map; the bulk group's
// commit and waits below (read: the shared memory may be reused)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(m), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N committed groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ordinary shared-memory writes before an async-proxy (TMA) read of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- registers between the roles --------------------------------------------

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator above the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory descriptor of a K-major tile whose rows are ROW_BYTES wide
// (128: SWIZZLE_128B, 64: SWIZZLE_64B), 8-row atoms back to back: start
// address >> 4, leading offset unused (1), stride between atoms, layout type.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "swizzle width");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * ROW_BYTES) >> 4) << 32) | (layout << 62);
}

// d (64 x 128 fp32, in the warpgroup's registers) = or += A (64 x 16) .
// B (128 x 16)^T, both bf16 K-major in shared memory; scale_d = 0 overwrites.
// Thread t holds rows (t/32)*16 + (t%32)/4 and +8; d[4j + 2h + e] is row
// half h, column 8j + 2*(t%4) + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The products of one chunk: d (+)= A (64 x KC) . B (128 x KC)^T from two
// tiles of KC*2-byte rows. `fresh` makes the first k-step overwrite d (the
// first chunk of a new output tile), so the accumulator is never zeroed by
// ordinary code.
template <int KC>
__device__ __forceinline__ void wgmma_chunk(float (&d)[64], uint32_t a_tile,
                                            uint32_t b_tile, bool fresh) {
  const uint64_t da = make_desc<KC * 2>(a_tile);
  const uint64_t db = make_desc<KC * 2>(b_tile);
#pragma unroll
  for (int k = 0; k < KC / 16; ++k)
    wgmma_m64n128k16(d, da + 2 * k, db + 2 * k, (fresh && k == 0) ? 0 : 1);
}

// ---- wgmma for 16-bit types other than bf16, and with A from registers ------
// (csrc/masked_attention.cu: scores Q K^T from shared memory, then P V with
// P from the score registers and V MN-major in shared memory)

// keeps a register array live, and unmoved, across an asynchronous wgmma
// that reads or writes it (until the wait that follows)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Shared-memory descriptor of an MN-major tile in 128-byte swizzle, the
// layout TMA writes for a box of 64 16-bit columns (the N dimension) by K
// rows: an atom is 8 K rows x 128 bytes, atoms along K back to back (stride
// 1024 B), the next 64 N columns `lbo_bytes` further on. Used with the
// transpose-B bit, which exists for 16-bit types only.
__device__ __forceinline__ uint64_t make_desc_mn128(uint32_t addr,
                                                    uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define WG_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32(d) WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
#define WG_ACC64(d)                                                     \
  WG_ACC32(d), WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                    \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                              \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                            \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                    \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                              \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                            \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                            \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                            \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                            \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                            \
  " %56, %57, %58, %59, %60, %61, %62, %63}"
// the instruction's operand type for an element type
#define WG_TYPE(T) (std::is_same<T, __half>::value ? 1 : 0)

// d (64 x 128 fp32) = or += A (64 x 16) . B (128 x 16)^T, both K-major in
// shared memory, T = __nv_bfloat16 or __half; the layout of d as for
// wgmma_m64n128k16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
#define WG_SS(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
               " " WG_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"               \
               : WG_ACC64(d)                                             \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (WG_TYPE(T)) {
    WG_SS("f16");
  } else {
    WG_SS("bf16");
  }
#undef WG_SS
}

// d (64 x N fp32, N = 64 or 128) += A (64 x 16, four registers a thread:
// the m16n8k16 A fragment of the warp's 16 rows) . B (16 x N), B MN-major
// in shared memory (descriptor from make_desc_mn128). The layout of d:
// d[4j + 2h + e] is row half h, column 8j + 2 (t % 4) + e.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
#define WG_RS(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY   \
               " " WG_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : WG_ACC32(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(1))
  if constexpr (WG_TYPE(T)) {
    WG_RS("f16");
  } else {
    WG_RS("bf16");
  }
#undef WG_RS
}

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
#define WG_RS(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY  \
               " " WG_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : WG_ACC64(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(1))
  if constexpr (WG_TYPE(T)) {
    WG_RS("f16");
  } else {
    WG_RS("bf16");
  }
#undef WG_RS
}

#undef WG_TYPE
#undef WG_R64
#undef WG_R32
#undef WG_ACC64
#undef WG_ACC32
#undef WG_ACC8

// ---- the ring ------------------------------------------------------------------

// Slot and phase bookkeeping, the same on the producer's and the consumers'
// side: slot s's full barrier is at full0 + 8 s, its empty barrier at
// empty0 + 8 s.
struct Ring {
  uint32_t full0, empty0;
  int stages;
  int slot = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ Ring(uint32_t bars, int n)
      : full0(bars), empty0(bars + 8 * n), stages(n) {}
  __device__ __forceinline__ uint32_t full() const { return full0 + 8 * slot; }
  __device__ __forceinline__ uint32_t empty() const {
    return empty0 + 8 * slot;
  }
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  // producer: wait until every block's consumers have released the slot
  // (passes at once in the first round), then announce its bytes
  __device__ __forceinline__ void acquire(uint32_t bytes) const {
    mbar_wait(empty(), phase ^ 1);
    mbar_expect_tx(full(), bytes);
  }
  // consumer: wait until the slot's bytes have landed
  __device__ __forceinline__ void wait_full() const {
    mbar_wait(full(), phase);
  }
};

// one thread, before any other use: `consumer_warps` arrivals from each of
// the cluster's `cl` blocks empty a slot; the producer's one arrival plus
// the announced bytes fill it
__device__ __forceinline__ void ring_init(uint32_t bars, int stages,
                                          int consumer_warps, uint32_t cl) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (stages + s), consumer_warps * cl);
  }
}

// a consumer warp gives slot `slot` back to the producers of all `cl`
// blocks (all 32 lanes call it after the wgmmas that read the slot retired)
__device__ __forceinline__ void ring_release(uint32_t empty0, int slot,
                                             uint32_t cl) {
  const uint32_t lane = threadIdx.x % 32;
  if (cl == 1) {
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  } else if (lane < cl) {
    mbar_arrive_cta(empty0 + 8 * slot, lane);
  }
}

// ---- tensor maps (host) ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// 16-bit tensor (bf16 unless `dtype` says otherwise) of `rank` <= 5 dims
// (innermost first; strides in bytes for dims 1..rank-1), box of the same
// rank; the swizzle follows the box's inner width (64 columns: 128 B, 32
// columns: 64 B). Returns 0 or an error code.
inline int make_map(CUtensorMap* map, const void* ptr, int rank,
                    const uint64_t* dims, const uint64_t* strides,
                    const uint32_t* box,
                    CUtensorMapDataType dtype =
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return ERR_NO_ENCODE_FN;
  cuuint64_t gdim[5], gstr[4];
  cuuint32_t gbox[5], estr[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    if (i > 0) gstr[i - 1] = strides[i - 1];
  }
  const CUtensorMapSwizzle sw =
      box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B;
  CUresult r = fn(map, dtype, rank,
                  const_cast<void*>(ptr), gdim, gstr, gbox, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE + static_cast<int>(r);
}

// (rows, cols) row-major bf16 matrix, box of box_rows x box_cols
inline int make_map_2d(CUtensorMap* map, const void* ptr, uint64_t rows,
                       uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const uint32_t box[2] = {box_cols, box_rows};
  return make_map(map, ptr, 2, dims, strides, box);
}

}  // namespace wg
