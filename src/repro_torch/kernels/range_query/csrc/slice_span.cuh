// The leaf tiles a query tile's arena slices can reach, shared by the two
// pyramid-prune kernels (fused_serve.cu, prune_tiles.cu).
//
// A leaf tile g holds the arena entries [g*TP, g*TP + TP).  Both prunes AND
// the slice test (g*TP < qe) & (g*TP + TP > qs) into every tile's verdict,
// so a tile can pass only inside [floor(qs/TP), ceil(qe/TP)) for one of the
// query tile's queries.  The span is read off that inequality, not off
// "the slice is non-empty": [5, 5) still passes tile 0, [0, 0) passes none.
// The union of the TB spans, merged into at most TB disjoint ascending
// intervals, bounds what a prune must read; every tile outside it fails the
// slice test for every query, so its verdict is 0 without a load.
//
// The plain mirror is layout.py::slice_tile_spans, held against the plain
// prunes on the CPU; fused_serve.cu merges the spans (merge_warp) to walk
// their union in ascending order, prune_tiles.cu tests a quad of tiles
// against the 8 spans as they are.

#pragma once

#include <stdint.h>

namespace slice_span {

// [lo, hi) of the tiles below `limit` that can pass the slice test of
// [qs, qe); lo >= hi when none can.
__device__ __forceinline__ void tile_span(int qs, int qe, int tp, int limit,
                                          int& lo, int& hi) {
  lo = qs > 0 ? qs / tp : 0;            // floor(qs / tp), clipped at 0
  hi = qe > 0 ? (qe - 1) / tp + 1 : 0;  // ceil(qe / tp), no overflow
  hi = hi < limit ? hi : limit;
}

// Merge the spans (lo, hi) that lanes 0..N-1 of a warp hold into disjoint
// ascending intervals [mlo[k], mhi[k]), overlapping and touching spans
// joined, empty ones (lo >= hi) dropped, and write the running sum of
// their lengths to `mpre` (mpre[0] = 0, mpre[k] = the tiles in intervals
// 0..k-1).  Every lane of the warp calls it (lanes >= N pass anything);
// it returns the number of intervals on every lane.  Warp shuffles only:
// each span's rank in (lo, lane) order places it, a running max of hi
// over the sorted spans starts a new interval wherever lo passes it, and
// the last span of each interval writes that running max as its end.
template <int N>
__device__ __forceinline__ int merge_warp(int lo, int hi, int* mlo, int* mhi,
                                          int* mpre) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int BIG = 0x7fffffff, SMALL = -0x7fffffff - 1;
  const int lane = threadIdx.x & 31;
  const bool valid = lane < N && lo < hi;
  const int key = valid ? lo : BIG;  // empty spans sort last
  int rank = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int kj = __shfl_sync(FULL, key, j);
    rank += (kj < key) | ((kj == key) & (j < lane));
  }
  int slo = 0, shi = 0;  // the span of rank `lane`
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int rj = __shfl_sync(FULL, rank, j);
    const int lj = __shfl_sync(FULL, lo, j);
    const int hj = __shfl_sync(FULL, hi, j);
    if (rj == lane) {
      slo = lj;
      shi = hj;
    }
  }
  const int nvalid = __popc(__ballot_sync(FULL, valid));
  const bool live = lane < nvalid;
  int run = live ? shi : SMALL;  // running max of hi, inclusive
#pragma unroll
  for (int d = 1; d < N; d <<= 1) {
    const int o = __shfl_up_sync(FULL, run, d);
    if (lane >= d) run = max(run, o);
  }
  const int before = __shfl_up_sync(FULL, run, 1);
  const bool start = live && (lane == 0 || slo > before);
  const unsigned starts = __ballot_sync(FULL, start);
  const int m = __popc(starts);
  const int k = __popc(starts & (lane < 31 ? (2u << lane) - 1u : FULL)) - 1;
  const bool last = live && (lane + 1 == nvalid ||
                             (lane < 31 && ((starts >> (lane + 1)) & 1u)));
  if (start) mlo[k] = slo;
  if (last) mhi[k] = run;
  __syncwarp();
  int len = lane < m ? mhi[lane] - mlo[lane] : 0;  // inclusive prefix sum
#pragma unroll
  for (int d = 1; d < N; d <<= 1) {
    const int o = __shfl_up_sync(FULL, len, d);
    if (lane >= d) len += o;
  }
  if (lane < m) mpre[lane + 1] = len;
  if (lane == 0) mpre[0] = 0;
  return m;
}

// The tile at position v of the concatenated intervals (v < mpre[m]).
__device__ __forceinline__ int tile_at(int v, const int* mlo, const int* mpre,
                                       int m) {
  int k = 0;
  while (k + 1 < m && v >= mpre[k + 1]) ++k;
  return mlo[k] + (v - mpre[k]);
}

}  // namespace slice_span
