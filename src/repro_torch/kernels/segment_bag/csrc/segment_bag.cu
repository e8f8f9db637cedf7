// Fused EmbeddingBag for Hopper (sm_90a): gather plus weighted segment sum,
//
//   out[s, :] = sum over k with seg[k] == s of w[k] * table[idx[k], :]
//
// for s in [0, n_segments), with a (V, D) float32 or bfloat16 table,
// (L,) int32 idx, (L,) int32 seg sorted ascending (padding carries
// seg == n_segments) and (L,) float32 w; out is (n_segments, D) float32.
//
// Replaces repro/kernels/segment_bag/kernel.py::segment_bag_pallas
// (_segment_bag_kernel).  It computes that kernel's function, not its grid:
// the TPU walks the lookups in order, 8 per grid step, and read-modify-
// writes the output row of each one in a VMEM block that spans the whole
// output.  Blocks here run in no order, so each output row has one owner:
// since seg is sorted, segment s is the contiguous run [lower_bound(s),
// lower_bound(s + 1)) of k, found by binary search, and its owner sums the
// run itself.  No atomics; the result does not depend on scheduling.
//
// Numbers: like repro/kernels/segment_bag/ref.py (the reference's
// production path), a bf16 row is widened to float32 and the sum is kept
// and returned in float32.  Each term is w * x rounded, added in ascending
// k (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA):
// the same operations in the same order as the plain PyTorch version run
// on the CPU (gather, scale, index_add_), so the two agree bit for bit.
//
// Bound: bytes.  The distinct table rows the lookups name, plus 12 B of
// idx, seg and w per lookup, plus the output, against one multiply-add
// per lookup and column.
//
// Design: one warp per segment, 8 warps (256 threads) per block.  The
// lanes stride the row's D columns (D = 18: one 72-byte row per lookup,
// lanes 0..17; D = 128: four columns a lane), each accumulating its column
// in a register; idx[k] and w[k] are one address for the whole warp.  The
// loads stay scalar: a row of 18 floats is not 16-byte aligned.  The run
// is unrolled by 4 so four rows are in flight.  An empty segment writes
// zeros; padding (seg == n_segments) is never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // segments per block
constexpr int UNROLL = 4;    // lookups in flight per lane

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// First k in [lo, hi) with seg[k] >= s (hi where there is none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg,
                                           int lo, int hi, int s) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
segment_bag_kernel(const T* __restrict__ table,     // (V, D)
                   const int* __restrict__ idx,     // (L,)
                   const int* __restrict__ seg,     // (L,) sorted
                   const float* __restrict__ w,     // (L,)
                   float* __restrict__ out,         // (n_segments, D)
                   int L, int D, int n_segments) {
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= n_segments) return;
  const int lane = threadIdx.x & 31;
  const int k0 = lower_bound(seg, 0, L, s);
  const int k1 = lower_bound(seg, k0, L, s + 1);
  float* row_out = out + (size_t)s * D;
  for (int c = lane; c < D; c += 32) {
    const T* col = table + c;
    float acc = 0.f;
    int k = k0;
    for (; k + UNROLL <= k1; k += UNROLL) {
      float x[UNROLL], wk[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        x[u] = widen(col[(size_t)idx[k + u] * D]);
        wk[u] = w[k + u];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc = __fadd_rn(acc, __fmul_rn(wk[u], x[u]));
    }
    for (; k < k1; ++k)
      acc = __fadd_rn(acc, __fmul_rn(w[k], widen(col[(size_t)idx[k] * D])));
    row_out[c] = acc;
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* seg,
           const void* w, void* out, int L, int D, int n_segments,
           void* stream) {
  const int grid = (n_segments + WARPS - 1) / WARPS;
  segment_bag_kernel<T><<<grid, WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(w),
      static_cast<float*>(out), L, D, n_segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one per table type: each launches on
// `stream`, never synchronises, and returns cudaGetLastError() so a
// refused launch is reported to the caller.  n_segments >= 1.
extern "C" int segment_bag_f32_launch(const void* table, const void* idx,
                                      const void* seg, const void* w,
                                      void* out, int L, int D,
                                      int n_segments, void* stream) {
  return launch<float>(table, idx, seg, w, out, L, D, n_segments, stream);
}

extern "C" int segment_bag_bf16_launch(const void* table, const void* idx,
                                       const void* seg, const void* w,
                                       void* out, int L, int D,
                                       int n_segments, void* stream) {
  return launch<__nv_bfloat16>(table, idx, seg, w, out, L, D, n_segments,
                               stream);
}
