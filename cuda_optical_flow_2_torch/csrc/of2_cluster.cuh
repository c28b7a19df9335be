// Thread-block clusters (sm_90): the CTAs of a cluster run at once on SMs
// of one GPC, and each can read the others' shared memory (distributed
// shared memory, DSMEM).  A cluster of CX x CY CTAs launched over a grid
// holds blocks (CX i + rx, CY j + ry), rx < CX, ry < CY, and block (rx, ry)
// has rank rx + CX ry in it.  Used by tvl1_sweep.cu's clustered tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The address, in the cluster's shared window, of what lies at `p` (a
// pointer into this CTA's shared memory) in the shared memory of the
// cluster's CTA `rank`: the same offset in the peer's buffer.
__device__ __forceinline__ unsigned of2_peer_addr(const void* p, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(out)
      : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

// The cluster barrier split in two, each executed by every thread of every
// CTA of the cluster: the wait returns once all have arrived.  The arrive
// orders nothing (relaxed): a fence before it (of2_mbar_init_fence) makes
// the mbarrier inits visible to the peers after the wait.
__device__ __forceinline__ void of2_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void of2_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// mbarriers for point-to-point signals between the CTAs of a cluster: a
// CTA's barrier completes a phase when its own `count` arrivals and the
// bytes they expect (peers' st.async stores) are in, and its threads wait
// for a phase by its parity.

// One thread of the CTA, before the cluster barrier that precedes any
// peer's store into it: the barrier at `mb` (8-byte aligned shared memory)
// counts `count` arrivals per phase.
__device__ __forceinline__ void of2_mbar_init(uint64_t* mb, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(mb)),
               "r"(count));
}

// After of2_mbar_init: the inits are visible to the cluster's CTAs after
// the next cluster barrier (of2_cluster_arrive_relaxed, of2_cluster_wait).
__device__ __forceinline__ void of2_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This CTA's barrier at `mb` takes one arrival and expects `bytes` more
// bytes of st.async stores in the phase that arrival belongs to.
__device__ __forceinline__ void of2_mbar_expect(uint64_t* mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(mb)),
               "r"(bytes)
               : "memory");
}

// Store (a, b) at `addr` in a peer's shared memory without waiting for it;
// the peer's barrier at `mb` (both of2_peer_addr addresses of that peer)
// counts the 8 bytes when they have landed, and a thread that waits for
// that barrier's phase then sees them.
__device__ __forceinline__ void of2_st_async2(unsigned addr, float a, float b, unsigned mb) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(a), "f"(b), "r"(mb)
      : "memory");
}

// Wait until the phase of parity `parity` of this CTA's barrier at `mb` has
// completed.
__device__ __forceinline__ void of2_mbar_wait(uint64_t* mb, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"((unsigned)__cvta_generic_to_shared(mb)),
      "r"(parity)
      : "memory");
}
