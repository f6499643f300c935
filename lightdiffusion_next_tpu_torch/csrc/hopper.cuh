// Hopper (sm_90a) building blocks shared by the wgmma kernels
// (quant_matmul.cu, fused_qkv_attention.cu, sage_attention.cu,
// flash_attention.cu, packed_flash_attention.cu, w8a8_matmul.cu,
// w8a8_matmul_bf16.cu): cp.async, bulk and tensor-map (TMA) copies,
// mbarriers and named barriers, the proxy fence, wgmma's synchronisation
// and its shared-memory descriptors, and the exact int8 -> bf16 conversion
// of the bf16-rate products. The products themselves (m64nNk16 bf16 with
// f32 accumulators, m64nNk32 s8 with s32 accumulators, all in registers)
// are generated into wgmma_forms.cuh by wgmma_forms.py.
//
// The bf16 operands use the 128-byte swizzle: an atom is 8 rows of 128 bytes
// (1024 bytes), and 16-byte chunk j of row r lies at chunk j ^ (r & 7). A
// K-major operand (tnsp = 0) holds 64 K values per 128-byte row; an MN-major
// one (tnsp = 1) holds 64 M or N values per row, one row per K index. The s8
// operands (both K-major: 8-bit wgmma has no transpose) use the 32-byte
// swizzle: a k32 step of an R-row operand is R rows of 32 bytes (8-row atoms
// of 256 bytes), and the two 16-byte chunks of a row swap in rows 4-7 of
// each atom (chunk j of row r at j ^ ((r >> 2) & 1)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_forms.cuh"

namespace hopper {

constexpr int kAtom = 1024;  // one 128-byte-swizzle atom: 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copy (the TMA without a tensor map): `bytes` (a multiple of 16)
// contiguous bytes from global to shared memory, both 16-byte aligned; the
// copy counts its bytes off the transaction count of the mbarrier at `mbar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// TMA: the box of the 2-D tensor map `map` (a __grid_constant__ kernel
// parameter) at element coordinates (c0 innermost, c1) into shared memory at
// dst, with the map's swizzle; the copy counts its bytes (the whole box, rows
// past the tensor's end zero-filled) off the transaction count of the
// mbarrier at `mbar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar)
      : "memory");
}

// As tma_load_2d, the box landing at the same offset `dst` in every CTA of
// the cluster named by `mask` (bit r: rank r), each counting its bytes off
// its own mbarrier at offset `mbar`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const void* map, int c0,
                                                      int c1, uint32_t mbar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA store: the box of `map` at (c0, c1) from shared memory at src, with the
// map's swizzle (rows past the tensor's end are not written), in this
// thread's bulk group; bulk_commit closes the group, bulk_wait_read<N> waits
// until at most N groups still read their shared memory, bulk_wait<N> until
// at most N groups are still writing
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :
      : "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global memory into L2,
// asynchronously
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

// mbarriers in shared memory: initialised by one thread, then
// mbar_init_fence() and a barrier before any thread uses them
__device__ __forceinline__ void mbar_init(uint32_t mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar) : "memory");
}

// arrive, and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
               "r"(bytes)
               : "memory");
}

// arrive on the mbarrier at offset `mbar` of CTA `rank` of the cluster
// (this CTA's own, or another's), as CUTLASS's ClusterBarrier does: with the
// default (CTA-scope) release; the cluster-scope release halved the W8A8
// kernel's rate (csrc/w8a8_matmul.cu)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t mbar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(mbar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// this CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: wait for all of them
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// wait until the phase of parity `parity` has completed (no bound on the
// wait: a trap here would make ptxas ignore setmaxnreg)
__device__ __forceinline__ void mbar_wait(uint32_t mbar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  } while (!done);
}

// barrier `id` (1-15; 0 is __syncthreads') among `count` threads: wait for
// all of them, or (arrive) count this thread and go on
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the wgmmas
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory descriptor of a K-major s8 operand with the 32-byte
// swizzle: start address and the 256-byte stride of 8-row atoms (SBO)
__device__ __forceinline__ uint64_t make_desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// Four int8 codes (bytes 0..3 of x) as two bf16 pairs, exactly: a code b is
// m - 128 s (m its low 7 bits, s its sign bit), and (128 + m) - (128 + 128 s)
// has both operands exact in bf16 (0x43 followed by m is 128 + m: exponent
// 7, step 1), so two bf16x2 subtractions give it exactly; no I2F. lo holds
// bytes 0, 1; hi bytes 2, 3. Read at k offsets 4t..4t+3 of a k16 group, they
// are the bf16 A fragment's pairs of logical k (2t, 2t+1) and (2t+8, 2t+9):
// a permutation of the 16 k of a step, which the bf16-rate kernels give
// both operands alike.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t k128 = 0x43434343u;
  const uint32_t m = x & 0x7f7f7f7fu, s = x & 0x80808080u;
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(lo)
      : "r"(__byte_perm(m, k128, 0x4140)), "r"(__byte_perm(s, k128, 0x4140)));
  asm("sub.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(hi)
      : "r"(__byte_perm(m, k128, 0x4342)), "r"(__byte_perm(s, k128, 0x4342)));
}

}  // namespace hopper
