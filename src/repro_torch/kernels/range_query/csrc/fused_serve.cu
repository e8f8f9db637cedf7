// Fused RangeReach serve kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/range_query/fused.py::fused_serve_pallas, the TPU
// megakernel, and computes what its XLA twin fused_serve_xla computes, bit
// for bit: per 8-query tile, the quantized coarse AND fine AND arena-slice
// prune of every leaf tile, an ascending worklist of the surviving tiles,
// and the exact float32 box-and-slice test over at most kcap of them, with
// a reach (OR), count (sum) or collect (id or sentinel per slot) epilogue.
// Every comparison is integer or float32 with no arithmetic, so the kernel
// and the plain PyTorch version agree exactly.
//
// Bound: bytes, not operations.  Each query tile reads the quantized
// pyramid (12 bytes per leaf tile) and 2 KB per scanned leaf tile (512 B
// more for the ids in collect mode), and does a few integer compares per
// byte.  At small batches the launch itself is the floor.
//
// Design: one block of 256 threads per 8-query tile.  The pyramid planes
// are read straight from global memory (they stay L2-resident across
// blocks and need not fit in shared memory).  Compaction is a warp ballot
// plus __popc, a scan of the 8 warp totals in shared memory and a running
// base, so tile ids land in the worklist in ascending order; the true
// candidate count is kept even where it passes kcap.  The scan covers two
// leaf tiles per step, one per 128 threads, and reduces with warp
// intrinsics and shared-memory atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;         // queries per query tile
constexpr int TP = 128;       // arena entries per leaf tile
constexpr int GROUP = 8;      // leaf tiles per coarse pyramid node
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int32_t ID_SENTINEL = 0x7fffffff;

enum Mode { REACH = 0, COUNT = 1, COLLECT = 2 };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
fused_serve_kernel(const int16_t* __restrict__ qfine,    // (4, ntp)
                   const int32_t* __restrict__ qcoarse,  // (4, ntp / GROUP)
                   const float* __restrict__ entries,    // (4, P)
                   const int32_t* __restrict__ ids,      // (P,)
                   const int16_t* __restrict__ r16,      // (4, B)
                   const int32_t* __restrict__ r32,      // (4, B)
                   const float* __restrict__ rects,      // (4, B)
                   const int32_t* __restrict__ qstart,   // (B,)
                   const int32_t* __restrict__ qend,     // (B,)
                   int32_t* __restrict__ out,            // (B,) | (B, kcap*TP)
                   int32_t* __restrict__ cnt,            // (B / TB,)
                   int32_t* worklist,                    // (B / TB, kcap)
                   int ntp, int nt, int P, int B, int kcap) {
  __shared__ int s_qs[TB], s_qe[TB];
  __shared__ int s_r16[4][TB], s_r32[4][TB];
  __shared__ float s_rect[4][TB];
  __shared__ int s_warp[WARPS];
  __shared__ int s_acc[TB];
  __shared__ unsigned s_or;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blk * TB;
  const int ncp = ntp / GROUP;

  if (tid < TB) {
    s_qs[tid] = qstart[q0 + tid];
    s_qe[tid] = qend[q0 + tid];
    s_acc[tid] = 0;
  }
  if (tid == 0) s_or = 0u;
  if (tid < 4 * TB) {
    const int a = tid / TB, q = tid % TB;
    s_r16[a][q] = r16[a * B + q0 + q];
    s_r32[a][q] = r32[a * B + q0 + q];
    s_rect[a][q] = rects[a * B + q0 + q];
  }
  __syncthreads();

  // ---- prune every leaf tile, compact the active ones ascending --------
  int32_t* wl = worklist + (size_t)blk * kcap;
  int base = 0;
  for (int c0 = 0; c0 < nt; c0 += THREADS) {
    const int g = c0 + tid;
    bool act = false;
    if (g < nt) {
      const int f0 = qfine[g], f1 = qfine[ntp + g];
      const int f2 = qfine[2 * ntp + g], f3 = qfine[3 * ntp + g];
      const int cg = g / GROUP;
      const int c0v = qcoarse[cg], c1v = qcoarse[ncp + cg];
      const int c2v = qcoarse[2 * ncp + cg], c3v = qcoarse[3 * ncp + cg];
      const int lo = g * TP, hi = lo + TP;
#pragma unroll
      for (int q = 0; q < TB; ++q) {
        act |= (lo < s_qe[q]) & (hi > s_qs[q])
               & (f0 <= s_r16[2][q]) & (f1 <= s_r16[3][q])
               & (f2 >= s_r16[0][q]) & (f3 >= s_r16[1][q])
               & (c0v <= s_r32[2][q]) & (c1v <= s_r32[3][q])
               & (c2v >= s_r32[0][q]) & (c3v >= s_r32[1][q]);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_warp[w];
      before += (w < warp) ? c : 0;
      total += c;
    }
    if (act) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      if (slot < kcap) wl[slot] = g;
    }
    base += total;
    __syncthreads();  // s_warp is rewritten next chunk; worklist is visible
  }
  if (tid == 0) cnt[blk] = base;
  const int n = min(base, kcap);

  // ---- exact scan of the worklist: two leaf tiles per step -------------
  const int half = tid >> 7;
  const int l = tid & (TP - 1);
  if (MODE == COLLECT) {
    const size_t row = (size_t)kcap * TP;
    for (int k = half; k < kcap; k += 2) {
      int32_t v[TB];
#pragma unroll
      for (int q = 0; q < TB; ++q) v[q] = ID_SENTINEL;
      if (k < n) {
        const int g = wl[k] * TP + l;
        const float e0 = entries[g], e1 = entries[P + g];
        const float e2 = entries[2 * P + g], e3 = entries[3 * P + g];
        const int32_t id = ids[g];
#pragma unroll
        for (int q = 0; q < TB; ++q) {
          const bool hit = (g >= s_qs[q]) & (g < s_qe[q])
                           & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                           & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
          v[q] = hit ? id : ID_SENTINEL;
        }
      }
#pragma unroll
      for (int q = 0; q < TB; ++q)
        out[(size_t)(q0 + q) * row + (size_t)k * TP + l] = v[q];
    }
    return;
  }

  unsigned bits = 0u;
  int c[TB];
#pragma unroll
  for (int q = 0; q < TB; ++q) c[q] = 0;
  for (int k = half; k < n; k += 2) {
    const int g = wl[k] * TP + l;
    const float e0 = entries[g], e1 = entries[P + g];
    const float e2 = entries[2 * P + g], e3 = entries[3 * P + g];
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      const bool hit = (g >= s_qs[q]) & (g < s_qe[q])
                       & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                       & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
      if (MODE == REACH) bits |= (unsigned)hit << q;
      else c[q] += hit;
    }
  }
  if (MODE == REACH) {
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(&s_or, bits);
  } else {
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      const int s = __reduce_add_sync(0xffffffffu, c[q]);
      if (lane == 0 && s) atomicAdd(&s_acc[q], s);
    }
  }
  __syncthreads();
  if (tid < TB)
    out[q0 + tid] = (MODE == REACH) ? (int)((s_or >> tid) & 1u) : s_acc[tid];
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream`, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int fused_serve_launch(int mode, const void* qfine,
                                  const void* qcoarse, const void* entries,
                                  const void* ids, const void* r16,
                                  const void* r32, const void* rects,
                                  const void* qstart, const void* qend,
                                  void* out, void* cnt, void* worklist,
                                  int ntp, int nt, int P, int B, int kcap,
                                  void* stream) {
  const dim3 grid(B / TB), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_SERVE_ARGS                                                    \
  static_cast<const int16_t*>(qfine), static_cast<const int32_t*>(qcoarse), \
      static_cast<const float*>(entries), static_cast<const int32_t*>(ids), \
      static_cast<const int16_t*>(r16), static_cast<const int32_t*>(r32),   \
      static_cast<const float*>(rects), static_cast<const int32_t*>(qstart), \
      static_cast<const int32_t*>(qend), static_cast<int32_t*>(out),        \
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(worklist), ntp, nt, \
      P, B, kcap
  switch (mode) {
    case REACH:
      fused_serve_kernel<REACH><<<grid, block, 0, s>>>(FUSED_SERVE_ARGS);
      break;
    case COUNT:
      fused_serve_kernel<COUNT><<<grid, block, 0, s>>>(FUSED_SERVE_ARGS);
      break;
    case COLLECT:
      fused_serve_kernel<COLLECT><<<grid, block, 0, s>>>(FUSED_SERVE_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_SERVE_ARGS
  return static_cast<int>(cudaGetLastError());
}
