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
// (query tile, leaf tile), against 20 bytes of pyramid per leaf tile that
// every query tile reads (and L2 serves after the first); a few compares
// per byte.  The TPU kernel skips the fine test of a block whose coarse
// nodes miss every query (pl.when); here one __syncthreads_or over the
// block's 16 coarse nodes skips the fine loads the same way.  The answer
// does not depend on the gate: each tile's own coarse bit is ANDed in.
//
// Design: one block of 128 threads per (8-query tile, block of 128 leaf
// tiles), the TPU grid (B/8, NTp/128) flattened into one grid dimension.
// Each thread owns one leaf tile; the 8 rects and slices sit in shared
// memory; the mask row segment is written coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;       // queries per query tile
constexpr int TP = 128;     // arena entries per leaf tile
constexpr int TPT = 128;    // leaf tiles per block
constexpr int GROUP = 8;    // leaf tiles per coarse pyramid node

__global__ void __launch_bounds__(TPT)
prune_tiles_kernel(const float* __restrict__ fine,      // (4, ntp)
                   const float* __restrict__ coarse,    // (4, ntp / GROUP)
                   const float* __restrict__ rects,     // (4, B)
                   const int32_t* __restrict__ qstart,  // (B,)
                   const int32_t* __restrict__ qend,    // (B,)
                   int32_t* __restrict__ mask,          // (B / TB, ntp)
                   int ntp, int B) {
  __shared__ float s_rect[4][TB];
  __shared__ int s_qs[TB], s_qe[TB];

  const int nblk = ntp / TPT;
  const int i = blockIdx.x / nblk;   // query tile
  const int j = blockIdx.x % nblk;   // block of leaf tiles
  const int t = threadIdx.x;
  const int q0 = i * TB;
  if (t < 4 * TB) {
    const int a = t / TB, q = t % TB;
    s_rect[a][q] = rects[a * B + q0 + q];
  }
  if (t < TB) {
    s_qs[t] = qstart[q0 + t];
    s_qe[t] = qend[q0 + t];
  }
  __syncthreads();

  // ---- coarse level: this tile's group MBR against each query ----------
  const int ncp = ntp / GROUP;
  const int g = j * TPT + t;
  const int cg = g / GROUP;
  const float c0 = coarse[cg], c1 = coarse[ncp + cg];
  const float c2 = coarse[2 * ncp + cg], c3 = coarse[3 * ncp + cg];
  unsigned cbits = 0u;
#pragma unroll
  for (int q = 0; q < TB; ++q) {
    const bool ok = (c0 <= s_rect[2][q]) & (c1 <= s_rect[3][q])
                    & (c2 >= s_rect[0][q]) & (c3 >= s_rect[1][q]);
    cbits |= (unsigned)ok << q;
  }

  // ---- fine level and slice overlap, unless the block is pruned whole ----
  int32_t act = 0;
  if (__syncthreads_or(cbits != 0u)) {
    const float f0 = fine[g], f1 = fine[ntp + g];
    const float f2 = fine[2 * ntp + g], f3 = fine[3 * ntp + g];
    const int lo = g * TP, hi = lo + TP;
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      act |= (int32_t)(((cbits >> q) & 1u) != 0u)
             & (lo < s_qe[q]) & (hi > s_qs[q])
             & (f0 <= s_rect[2][q]) & (f1 <= s_rect[3][q])
             & (f2 >= s_rect[0][q]) & (f3 >= s_rect[1][q]);
    }
  }
  mask[(size_t)i * ntp + g] = act;
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int prune_tiles_launch(const void* fine, const void* coarse,
                                  const void* rects, const void* qstart,
                                  const void* qend, void* mask, int ntp,
                                  int B, void* stream) {
  const dim3 grid((B / TB) * (ntp / TPT)), block(TPT);
  prune_tiles_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fine), static_cast<const float*>(coarse),
      static_cast<const float*>(rects), static_cast<const int32_t*>(qstart),
      static_cast<const int32_t*>(qend), static_cast<int32_t*>(mask), ntp, B);
  return static_cast<int>(cudaGetLastError());
}
