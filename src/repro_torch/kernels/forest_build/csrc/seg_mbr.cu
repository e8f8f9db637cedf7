// Segmented-MBR reduction for Hopper (sm_90a): one level of the device
// R-tree bulk load, or one plane of the serving tile pyramid.
//
// Input: (fan * 2*dim, N) float32, slot-major,
//     children[(k * 2*dim + a) * N + j] = axis a of child slot k of node j,
// inert slots +inf (low axes) / -inf (high axes).  Output: (2*dim, N),
// the min over the fan slots of each low axis and the max of each high
// axis.
//
// Replaces repro/kernels/forest_build/kernel.py::seg_mbr_pallas
// (_seg_mbr_kernel): 128 nodes per block along the lanes, a static unroll
// over the slots along the sublanes.
//
// Bound: bytes.  Each input float is read once and each output written
// once, (fan + 1) * 2*dim * N * 4 bytes, against one compare per input
// float.  Reading node-major input, as the bulk load produces it, would
// skip the slot-major transpose that precedes this kernel (as many bytes
// again, read and written); that is later work.
//
// Design: one thread per (node j, axis a); blockIdx.y is the axis, so
// neighbouring threads read neighbouring j of one slot row: every load
// is coalesced.  Each thread loops over the fan slots with fminf / fmaxf
// in a register and writes its node's value once.  Nothing carries
// across blocks; min and max are exact, so the kernel equals its plain
// version bit for bit.  The ragged edge j >= N is masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
seg_mbr_kernel(const float* __restrict__ children,   // (fan * 2*dim, N)
               float* __restrict__ out,               // (2*dim, N)
               int n, int dim, int fan) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int a = blockIdx.y;
  if (j >= n) return;
  const size_t stride = (size_t)2 * dim * n;          // one slot's rows
  const float* p = children + (size_t)a * n + j;
  float v = p[0];
  if (a < dim) {
    for (int k = 1; k < fan; ++k) v = fminf(v, p[k * stride]);
  } else {
    for (int k = 1; k < fan; ++k) v = fmaxf(v, p[k * stride]);
  }
  out[(size_t)a * n + j] = v;
}

}  // namespace

// Plain C entry for ctypes: launches on `stream`, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int seg_mbr_launch(const void* children, void* out, int n, int dim,
                              int fan, void* stream) {
  const dim3 grid((n + THREADS - 1) / THREADS, 2 * dim);
  seg_mbr_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(children), static_cast<float*>(out), n, dim,
      fan);
  return static_cast<int>(cudaGetLastError());
}
