// Hierarchical tile prune for Hopper (sm_90a): phase 1 of the two-phase
// RangeReach descent.
//
// Replaces repro/kernels/range_query/descent.py::prune_tiles_pallas (the
// TPU kernel _prune_kernel) and computes what prune_tiles_ref computes, bit
// for bit: for each 8-query tile and each leaf tile g, whether any of the 8
// queries passes the float32 coarse MBR test of g's group of 8 leaf tiles,
// the float32 fine MBR test of g, and the arena-slice overlap
// [g*128, g*128 + 128) with [qs, qe).  Every test is a float32 or int32
// compare with no arithmetic, so the kernel equals the plain PyTorch
// version exactly.
//
// Bound: bytes.  The int32 mask (B/8 x NTp) is written whole, 4 bytes per
// (query tile, leaf tile); the pyramid is needed only inside the query
// tile's slice spans (16 bytes per leaf tile and per coarse node), a few
// compares per byte.  So the mask store is the work, and the design
// writes it at the memory rate.
//
// Design: a grid of (B/8) x X blocks of 256 threads, X chosen on the host
// so that the grid is one wave at 4 resident blocks per SM; the blocks of
// one query tile stride over its mask row, with its 8 rects, slices and
// the slices' tile spans (slice_span.cuh) in shared memory.  Each thread
// owns 4 consecutive leaf tiles per step: one 16-byte int4 store of the
// mask, one coarse node (4 divides 8) and a float4 load per fine plane
// (rows of NTp floats, NTp a multiple of 128, so aligned).  A quad outside
// every span stores zeros and reads nothing; inside, its coarse node and
// fine MBRs load together (the spans already bound the loads; the TPU
// kernel's coarse gate would add a round trip).  The mask keeps the
// default caching, so the compaction that reads it next finds it in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slice_span.cuh"

namespace {

constexpr int TB = 8;       // queries per query tile
constexpr int TP = 128;     // arena entries per leaf tile
constexpr int GROUP = 8;    // leaf tiles per coarse pyramid node
constexpr int QUAD = 4;     // leaf tiles per thread and step
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // resident per SM: one wave of the grid

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
prune_tiles_kernel(const float* __restrict__ fine,      // (4, ntp)
                   const float* __restrict__ coarse,    // (4, ntp / GROUP)
                   const float* __restrict__ rects,     // (4, B)
                   const int32_t* __restrict__ qstart,  // (B,)
                   const int32_t* __restrict__ qend,    // (B,)
                   int32_t* __restrict__ mask,          // (B / TB, ntp)
                   int ntp, int B) {
  __shared__ float s_rect[4][TB];
  __shared__ int s_qs[TB], s_qe[TB];
  __shared__ int s_lo[TB], s_hi[TB];  // tile spans, [0, 0) when empty

  const int i = blockIdx.x;  // query tile
  const int t = threadIdx.x;
  const int q0 = i * TB;
  if (t < TB) {
    const int qs = qstart[q0 + t], qe = qend[q0 + t];
    int lo, hi;
    slice_span::tile_span(qs, qe, TP, ntp, lo, hi);
    const bool empty = hi <= lo;
    s_qs[t] = qs;
    s_qe[t] = qe;
    s_lo[t] = empty ? 0 : lo;
    s_hi[t] = empty ? 0 : hi;
  } else if (t >= 32 && t < 32 + 4 * TB) {
    const int a = (t - 32) / TB, q = (t - 32) % TB;
    s_rect[a][q] = rects[a * B + q0 + q];
  }
  __syncthreads();

  const int ncp = ntp / GROUP;
  const int nquad = ntp / QUAD;
  int4* row = reinterpret_cast<int4*>(mask + (size_t)i * ntp);
  for (int quad = blockIdx.y * THREADS + t; quad < nquad;
       quad += gridDim.y * THREADS) {
    const int g0 = quad * QUAD;
    bool near = false;
#pragma unroll
    for (int q = 0; q < TB; ++q)
      near |= (g0 < s_hi[q]) & (g0 + QUAD > s_lo[q]);
    int act[QUAD] = {0, 0, 0, 0};
    if (near) {
      // the quad's coarse node and its 4 fine MBRs, loaded together
      const int cg = g0 / GROUP;
      const float c0 = coarse[cg], c1 = coarse[ncp + cg];
      const float c2 = coarse[2 * ncp + cg], c3 = coarse[3 * ncp + cg];
      const float4 f0 = *reinterpret_cast<const float4*>(fine + g0);
      const float4 f1 = *reinterpret_cast<const float4*>(fine + ntp + g0);
      const float4 f2 = *reinterpret_cast<const float4*>(fine + 2 * ntp + g0);
      const float4 f3 = *reinterpret_cast<const float4*>(fine + 3 * ntp + g0);
      const float fa[QUAD][4] = {{f0.x, f1.x, f2.x, f3.x},
                                 {f0.y, f1.y, f2.y, f3.y},
                                 {f0.z, f1.z, f2.z, f3.z},
                                 {f0.w, f1.w, f2.w, f3.w}};
#pragma unroll
      for (int q = 0; q < TB; ++q) {
        const bool cok = (c0 <= s_rect[2][q]) & (c1 <= s_rect[3][q])
                         & (c2 >= s_rect[0][q]) & (c3 >= s_rect[1][q]);
#pragma unroll
        for (int u = 0; u < QUAD; ++u) {
          const int lo = (g0 + u) * TP;
          act[u] |= (int32_t)(cok & (lo < s_qe[q]) & (lo + TP > s_qs[q])
                              & (fa[u][0] <= s_rect[2][q])
                              & (fa[u][1] <= s_rect[3][q])
                              & (fa[u][2] >= s_rect[0][q])
                              & (fa[u][3] >= s_rect[1][q]));
        }
      }
    }
    row[quad] = make_int4(act[0], act[1], act[2], act[3]);
  }
}

}  // namespace

// Plain C entry for ctypes.  Launches a (B / 8) x stripes grid on `stream`,
// never synchronises, and returns cudaGetLastError() so a refused launch is
// reported to the caller.  fine and mask must be 16-byte aligned.
extern "C" int prune_tiles_launch(const void* fine, const void* coarse,
                                  const void* rects, const void* qstart,
                                  const void* qend, void* mask, int ntp,
                                  int B, int stripes, void* stream) {
  const dim3 grid(B / TB, stripes), block(THREADS);
  prune_tiles_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fine), static_cast<const float*>(coarse),
      static_cast<const float*>(rects), static_cast<const int32_t*>(qstart),
      static_cast<const int32_t*>(qend), static_cast<int32_t*>(mask), ntp, B);
  return static_cast<int>(cudaGetLastError());
}
