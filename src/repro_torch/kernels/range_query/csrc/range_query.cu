// Full-arena leaf scan for Hopper (sm_90a): the leaf-scan RangeReach
// engine's probe.
//
//   out[b] = OR over p in [qstart[b], qend[b]) of box(p) intersects rect(b)
//
// for boxes held as (2*dim, P) float32 SoA planes [mins..., maxs...] and
// rects as (2*dim, B); (B,) int32 0/1.  Templated on DIM in {2, 3}.
//
// Replaces repro/kernels/range_query/kernel.py::range_query_pallas
// (_range_query_kernel).  It computes that kernel's function, not its grid:
// the TPU visits every (8-query tile, 128-entry tile) pair and masks the
// entries outside each query's slice, carrying the OR in VMEM across the
// sequential entry axis.  Here each query reads only its own slice, so a
// batch reads the entries of its slices and not the whole arena per query
// tile.  A slice is clipped to [0, P), as the plain version's index test
// clips it.
//
// Bound: bytes, the distinct slice entries (2*dim * 4 B each) plus the
// rects and slices read once and the output written once, against
// 2*dim float32 compares per slice entry per query.  Compares only, with
// no arithmetic, so the kernel equals its plain PyTorch version exactly.
//
// Design: one warp per query, 8 warps (256 threads) per block.  The lanes
// stride the slice over the coalesced SoA planes, four 32-entry steps per
// iteration so that four loads per plane are in flight; after each
// iteration __any_sync tells the warp whether a lane hit, and the warp
// leaves at its first hit.  An empty slice (tree id -1, a padded query)
// writes 0 without reading an entry.  Nothing carries across warps or
// blocks; the ragged batch (B not a multiple of 8) is masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // queries per block
constexpr int UNROLL = 4;    // 32-entry steps per iteration

template <int DIM>
__global__ void __launch_bounds__(WARPS * 32)
range_query_kernel(const float* __restrict__ entries,   // (2*DIM, P)
                   const float* __restrict__ rects,     // (2*DIM, B)
                   const int32_t* __restrict__ qstart,  // (B,)
                   const int32_t* __restrict__ qend,    // (B,)
                   int32_t* __restrict__ out,           // (B,)
                   int P, int B) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= B) return;
  const int lo = max(qstart[q], 0);
  const int hi = min(qend[q], P);
  float rlo[DIM], rhi[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    rlo[a] = rects[(size_t)a * B + q];
    rhi[a] = rects[(size_t)(DIM + a) * B + q];
  }
  bool found = false;
  for (int base = lo; base < hi && !found; base += 32 * UNROLL) {
    bool hit = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int g = base + u * 32 + lane;
      if (g < hi) {
        bool ok = true;
#pragma unroll
        for (int a = 0; a < DIM; ++a) {
          ok &= entries[(size_t)a * P + g] <= rhi[a];
          ok &= entries[(size_t)(DIM + a) * P + g] >= rlo[a];
        }
        hit |= ok;
      }
    }
    found = __any_sync(0xffffffffu, hit);
  }
  if (lane == 0) out[q] = found ? 1 : 0;
}

template <int DIM>
int launch(const void* entries, const void* rects, const void* qstart,
           const void* qend, void* out, int P, int B, void* stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  range_query_kernel<DIM><<<blocks, WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entries), static_cast<const float*>(rects),
      static_cast<const int32_t*>(qstart), static_cast<const int32_t*>(qend),
      static_cast<int32_t*>(out), P, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported to the caller;
// a dim other than 2 or 3 returns cudaErrorInvalidValue without a launch.
extern "C" int range_query_launch(const void* entries, const void* rects,
                                  const void* qstart, const void* qend,
                                  void* out, int P, int B, int dim,
                                  void* stream) {
  if (dim == 2)
    return launch<2>(entries, rects, qstart, qend, out, P, B, stream);
  if (dim == 3)
    return launch<3>(entries, rects, qstart, qend, out, P, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
