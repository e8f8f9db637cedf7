// Leaf scans over compacted candidate tiles for Hopper (sm_90a): phase 2
// of the two-phase RangeReach descent, and the RangeCount and RangeCollect
// scans over the same candidate lists.
//
// Replaces three TPU kernels, one template instantiation each:
//   REACH    repro/kernels/range_query/descent.py::descent_scan_pallas
//            (_scan_kernel): OR over the K candidate tiles of the exact
//            slice and box test, (B,) int32 0/1;
//   COUNT    repro/kernels/range_query/analytics.py::count_scan_pallas
//            (_count_kernel): exact hit counts, (B,) int32;
//   COLLECT  repro/kernels/range_query/analytics.py::collect_scan_pallas
//            (_collect_kernel): the hit payload id or the sentinel per
//            (query, slot lane), (B, K*128) int32.
// COUNT and COLLECT treat slot k > 0 whose tile is not above slot k-1's as
// padding (the reference's _dup_slot): compacted lists hold the active
// tiles strictly ascending, then the last one repeated.  The test is taken
// from cand alone, the same for every thread of the block.  Every test is a
// float32 or int32 compare with no arithmetic, so the kernels equal their
// plain PyTorch versions exactly.
//
// Bound: bytes, those of the distinct leaf tiles the lists name (2 KB of
// entries each, 512 B more of ids for COLLECT) plus, for COLLECT, the
// (B, K*128) id matrix it writes; 4 compares per entry and query.
//
// Design: one block of 128 threads per 8-query tile; a loop over the K
// slots inside the block takes the place of the TPU's sequential grid
// axis, and nothing carries across blocks.  Each thread owns one lane of
// the tile: it loads the lane's four float32 planes (coalesced) and tests
// the 8 queries, whose rects and slices sit in shared memory.  REACH ORs
// bits and skips a slot that repeats the previous tile (an idempotent OR);
// COUNT sums per thread.  Both reduce with warp intrinsics, then shared
// atomics.  COLLECT writes one coalesced 512-byte row per query and slot.
// A tile outside [0, P/128) is never read: the slot counts as a miss.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;      // queries per query tile
constexpr int TP = 128;    // arena entries per leaf tile = threads per block
constexpr int32_t ID_SENTINEL = 0x7fffffff;

enum Mode { REACH = 0, COUNT = 1, COLLECT = 2 };

template <int MODE>
__global__ void __launch_bounds__(TP)
leaf_scan_kernel(const int32_t* __restrict__ cand,     // (B / TB, K)
                 const float* __restrict__ entries,    // (4, P)
                 const int32_t* __restrict__ ids,      // (P,), COLLECT only
                 const float* __restrict__ rects,      // (4, B)
                 const int32_t* __restrict__ qstart,   // (B,)
                 const int32_t* __restrict__ qend,     // (B,)
                 int32_t* __restrict__ out,            // (B,) | (B, K*TP)
                 int K, int P, int B) {
  __shared__ float s_rect[4][TB];
  __shared__ int s_qs[TB], s_qe[TB];
  __shared__ int s_acc[TB];
  __shared__ unsigned s_or;

  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int q0 = i * TB;
  if (lane < 4 * TB) {
    const int a = lane / TB, q = lane % TB;
    s_rect[a][q] = rects[a * B + q0 + q];
  }
  if (lane < TB) {
    s_qs[lane] = qstart[q0 + lane];
    s_qe[lane] = qend[q0 + lane];
    s_acc[lane] = 0;
  }
  if (lane == 0) s_or = 0u;
  __syncthreads();

  const int32_t* c = cand + (size_t)i * K;
  const int ntiles = P / TP;
  const size_t row = (size_t)K * TP;
  unsigned bits = 0u;
  int cnt[TB];
#pragma unroll
  for (int q = 0; q < TB; ++q) cnt[q] = 0;

  int prev = 0;
  for (int k = 0; k < K; ++k) {
    const int tile = c[k];
    const bool repeat = (k > 0) && (tile == prev);
    const bool dup = (k > 0) && (tile <= prev);
    prev = tile;
    const bool valid = (unsigned)tile < (unsigned)ntiles;
    bool scan = valid;
    if (MODE == REACH) scan &= !repeat;
    else scan &= !dup;

    int32_t v[TB];
#pragma unroll
    for (int q = 0; q < TB; ++q) v[q] = ID_SENTINEL;
    if (scan) {
      const int g = tile * TP + lane;
      const float e0 = entries[g], e1 = entries[P + g];
      const float e2 = entries[2 * P + g], e3 = entries[3 * P + g];
      const int32_t id = (MODE == COLLECT) ? ids[g] : 0;
#pragma unroll
      for (int q = 0; q < TB; ++q) {
        const bool hit = (g >= s_qs[q]) & (g < s_qe[q])
                         & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                         & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
        if (MODE == REACH) bits |= (unsigned)hit << q;
        else if (MODE == COUNT) cnt[q] += hit;
        else v[q] = hit ? id : ID_SENTINEL;
      }
    }
    if (MODE == COLLECT) {
#pragma unroll
      for (int q = 0; q < TB; ++q)
        out[(size_t)(q0 + q) * row + (size_t)k * TP + lane] = v[q];
    }
  }
  if (MODE == COLLECT) return;

  if (MODE == REACH) {
    bits = __reduce_or_sync(0xffffffffu, bits);
    if ((lane & 31) == 0 && bits) atomicOr(&s_or, bits);
  } else {
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      const int s = __reduce_add_sync(0xffffffffu, cnt[q]);
      if ((lane & 31) == 0 && s) atomicAdd(&s_acc[q], s);
    }
  }
  __syncthreads();
  if (lane < TB)
    out[q0 + lane] = (MODE == REACH) ? (int)((s_or >> lane) & 1u) : s_acc[lane];
}

template <int MODE>
int launch(const void* cand, const void* entries, const void* ids,
           const void* rects, const void* qstart, const void* qend, void* out,
           int K, int P, int B, void* stream) {
  leaf_scan_kernel<MODE><<<B / TB, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(entries),
      static_cast<const int32_t*>(ids), static_cast<const float*>(rects),
      static_cast<const int32_t*>(qstart), static_cast<const int32_t*>(qend),
      static_cast<int32_t*>(out), K, P, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one per kernel.  Each launches on `stream`,
// never synchronises, and returns cudaGetLastError() so a refused launch is
// reported to the caller.
extern "C" int descent_scan_launch(const void* cand, const void* entries,
                                   const void* rects, const void* qstart,
                                   const void* qend, void* out, int K, int P,
                                   int B, void* stream) {
  return launch<REACH>(cand, entries, nullptr, rects, qstart, qend, out, K, P,
                       B, stream);
}

extern "C" int count_scan_launch(const void* cand, const void* entries,
                                 const void* rects, const void* qstart,
                                 const void* qend, void* out, int K, int P,
                                 int B, void* stream) {
  return launch<COUNT>(cand, entries, nullptr, rects, qstart, qend, out, K, P,
                       B, stream);
}

extern "C" int collect_scan_launch(const void* cand, const void* entries,
                                   const void* ids, const void* rects,
                                   const void* qstart, const void* qend,
                                   void* out, int K, int P, int B,
                                   void* stream) {
  return launch<COLLECT>(cand, entries, ids, rects, qstart, qend, out, K, P, B,
                         stream);
}
