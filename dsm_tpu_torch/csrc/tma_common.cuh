// Device helpers shared by the kernels that stage tiles in shared memory
// with TMA copies and hand them from a copy warp to the warps that compute
// through mbarriers (decode_attn.cu: decode_attend_staged_kernel; qmm.cu:
// qmm_kernel), that launch as programmatic dependents (decode_attn.cu's
// fold), and that hand partials between the blocks of a cluster (qmm.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dsm_tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A copy that never
// lands traps after some seconds (a launch error the wrapper raises) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory; completes on `bar`.
// (A block's own shared-memory address is also its address in the cluster
// window, so this serves blocks launched in clusters too.)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA 2-D tile copy: the box of the tensor map `map` (a __grid_constant__
// kernel parameter) at element coordinates (c0 innermost, c1) into this
// block's shared memory; parts of the box outside the tensor are zero filled,
// and the whole box's bytes complete on `bar`.
__device__ __forceinline__ void tile_copy_2d(void* dst, const void* map, int c0, int c1,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Programmatic dependent launch: let the next kernel of the stream (launched
// with programmatic stream serialization) start now; and wait until the
// kernel before this one has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The global nanosecond timer.
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Warm the TMA unit's copy of a tensor map (a __grid_constant__ parameter).
__device__ __forceinline__ void prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(map) : "memory");
}

// The address of this block's shared-memory location `p` in the shared
// memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Make this thread's writes to shared memory visible to the async proxy
// (a bulk copy that reads them next).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// this block's shared memory to the shared memory of another block of the
// cluster (`dst` and `bar` from cluster_addr); completes on that block's
// `bar`.
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barrier 1 over the first `threads` threads of the block (a multiple
// of 32), leaving the others free.
__device__ __forceinline__ void bar_sync_1(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The cluster barrier, split: every thread of the cluster arrives, then
// waits; what a thread does between the two overlaps the others' arrival.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

}  // namespace dsm_tma
