// Leaf scans over compacted candidate tiles for Hopper (sm_90a): phase 2
// of the two-phase RangeReach descent, and the RangeCount, RangeCollect
// and convex-polygon RangeReach scans over the same candidate lists.
//
// Replaces four TPU kernels, one template instantiation each:
//   REACH    repro/kernels/range_query/descent.py::descent_scan_pallas
//            (_scan_kernel): OR over the K candidate tiles of the exact
//            slice and box test, (B,) int32 0/1;
//   COUNT    repro/kernels/range_query/analytics.py::count_scan_pallas
//            (_count_kernel): exact hit counts, (B,) int32;
//   COLLECT  repro/kernels/range_query/analytics.py::collect_scan_pallas
//            (_collect_kernel): the hit payload id or the sentinel per
//            (query, slot lane), (B, K*128) int32;
//   POLYGON  repro/kernels/range_query/analytics.py::polygon_scan_pallas
//            (_polygon_kernel): REACH's test ANDed with the query's `ne`
//            half-planes A*x + B*y <= C on the entry's min corner, (B,)
//            int32 0/1.  The products and the sum are __fmul_rn /
//            __fadd_rn, each rounded on its own: nvcc would otherwise
//            contract them into an FMA, which rounds once and can flip
//            the answer for a point on a polygon edge, where the
//            reference (points_in_polygon_region) rounds three times.
// COUNT and COLLECT treat slot k > 0 whose tile is not above slot k-1's as
// padding (the reference's _dup_slot): compacted lists hold the active
// tiles strictly ascending, then the last one repeated.  The test is taken
// from cand alone, the same for every thread of the block.  Every test is a
// float32 or int32 compare with no arithmetic (POLYGON's arithmetic rounds
// as its plain version's separate tensor operations do), so the kernels
// equal their plain PyTorch versions exactly.
//
// Bound: bytes, those of the distinct leaf tiles the lists name (2 KB of
// entries each, 512 B more of ids for COLLECT) plus, for COLLECT, the
// (B, K*128) id matrix it writes; 4 compares per entry and query, and
// for POLYGON `ne` x (2 multiplies, 1 add, 1 compare) more.
//
// Design: one block of 128 threads per 8-query tile; a loop over the K
// slots inside the block takes the place of the TPU's sequential grid
// axis, and nothing carries across blocks.  Each thread owns one lane of
// the tile: it loads the lane's four float32 planes (coalesced) and tests
// the 8 queries, whose rects and slices sit in shared memory.  REACH and
// POLYGON OR bits and skip a slot that repeats the previous tile (an
// idempotent OR); POLYGON tests the half-planes only where the box test
// hit, reading the query's lines from global memory (one address across
// the block: a broadcast from L1).  COUNT sums per thread.  All three
// reduce with warp intrinsics, then shared atomics.  COLLECT writes one
// coalesced 512-byte row per query and slot.  A tile outside [0, P/128)
// is never read: the slot counts as a miss.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 8;      // queries per query tile
constexpr int TP = 128;    // arena entries per leaf tile = threads per block
constexpr int32_t ID_SENTINEL = 0x7fffffff;

enum Mode { REACH = 0, COUNT = 1, COLLECT = 2, POLYGON = 3 };

template <int MODE>
__global__ void __launch_bounds__(TP)
leaf_scan_kernel(const int32_t* __restrict__ cand,     // (B / TB, K)
                 const float* __restrict__ entries,    // (4, P)
                 const int32_t* __restrict__ ids,      // (P,), COLLECT only
                 const float* __restrict__ rects,      // (4, B)
                 const float* __restrict__ lines,      // (3*ne, B), POLYGON
                 const int32_t* __restrict__ qstart,   // (B,)
                 const int32_t* __restrict__ qend,     // (B,)
                 int32_t* __restrict__ out,            // (B,) | (B, K*TP)
                 int K, int P, int B, int ne) {
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
    if (MODE == REACH || MODE == POLYGON) scan &= !repeat;
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
        bool hit = (g >= s_qs[q]) & (g < s_qe[q])
                   & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                   & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
        if (MODE == POLYGON && hit) {
          const int col = q0 + q;
          for (int h = 0; h < ne && hit; ++h) {
            const float a = __ldg(lines + (size_t)h * B + col);
            const float b = __ldg(lines + (size_t)(ne + h) * B + col);
            const float c = __ldg(lines + (size_t)(2 * ne + h) * B + col);
            hit = __fadd_rn(__fmul_rn(a, e0), __fmul_rn(b, e1)) <= c;
          }
        }
        if (MODE == REACH || MODE == POLYGON) bits |= (unsigned)hit << q;
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

  if (MODE == REACH || MODE == POLYGON) {
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
    out[q0 + lane] =
        (MODE == COUNT) ? s_acc[lane] : (int)((s_or >> lane) & 1u);
}

template <int MODE>
int launch(const void* cand, const void* entries, const void* ids,
           const void* rects, const void* lines, const void* qstart,
           const void* qend, void* out, int K, int P, int B, int ne,
           void* stream) {
  leaf_scan_kernel<MODE><<<B / TB, TP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(entries),
      static_cast<const int32_t*>(ids), static_cast<const float*>(rects),
      static_cast<const float*>(lines), static_cast<const int32_t*>(qstart),
      static_cast<const int32_t*>(qend), static_cast<int32_t*>(out), K, P, B,
      ne);
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
  return launch<REACH>(cand, entries, nullptr, rects, nullptr, qstart, qend,
                       out, K, P, B, 0, stream);
}

extern "C" int count_scan_launch(const void* cand, const void* entries,
                                 const void* rects, const void* qstart,
                                 const void* qend, void* out, int K, int P,
                                 int B, void* stream) {
  return launch<COUNT>(cand, entries, nullptr, rects, nullptr, qstart, qend,
                       out, K, P, B, 0, stream);
}

extern "C" int collect_scan_launch(const void* cand, const void* entries,
                                   const void* ids, const void* rects,
                                   const void* qstart, const void* qend,
                                   void* out, int K, int P, int B,
                                   void* stream) {
  return launch<COLLECT>(cand, entries, ids, rects, nullptr, qstart, qend, out,
                         K, P, B, 0, stream);
}

extern "C" int polygon_scan_launch(const void* cand, const void* entries,
                                   const void* rects, const void* lines,
                                   const void* qstart, const void* qend,
                                   void* out, int K, int P, int B, int ne,
                                   void* stream) {
  return launch<POLYGON>(cand, entries, nullptr, rects, lines, qstart, qend,
                         out, K, P, B, ne, stream);
}
