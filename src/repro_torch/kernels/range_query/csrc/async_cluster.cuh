// Asynchronous copies into shared memory and the split cluster barrier,
// shared by the kernels that run a thread block cluster per query tile
// (fused_serve.cu, leaf_scan.cu) on Hopper (sm_90a).
//
// cp.async copies global memory into shared memory without passing
// through registers; a thread commits its copies in groups and waits
// until at most N of its latest groups are still in flight.  The wait
// makes the copies visible to the thread that issued them only: a block
// that reads another thread's copies needs a __syncthreads() as well.
//
// barrier.cluster.arrive / barrier.cluster.wait are the two halves of
// cluster.sync(): every thread of every CTA of the cluster arrives
// (release), and a wait returns once all have (acquire).  Splitting them
// lets a CTA work between its own arrival and the point where it needs
// the other CTAs' writes, for instance rank 0's zeroed accumulators.

#pragma once

namespace async_cluster {

// 16 bytes, bypassing L1 (.cg); dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 4 bytes (.ca: the only size below 16 that cp.async takes through L1);
// dst and src 4-byte aligned.  The "memory" clobber keeps the compiler
// from moving it above an earlier read of the same shared word.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the "memory" clobber keeps the compiler from moving a read of the
// copied words above the wait
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two halves of cluster.sync(): arrive (release), then wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

// an arrival that orders no memory access: for a wait whose only purpose
// is that every CTA of the cluster has started
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

}  // namespace async_cluster
