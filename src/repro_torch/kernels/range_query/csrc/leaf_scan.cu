// Leaf scans over compacted candidate tiles for Hopper (sm_90a): phase 2
// of the two-phase RangeReach descent, and the RangeCount, RangeCollect
// and convex-polygon RangeReach scans over the same candidate lists.
//
// Replaces four TPU kernels:
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
// tiles strictly ascending, then the last one repeated.  REACH and POLYGON
// skip a slot that repeats slot k-1's tile (an idempotent OR).  The test
// is taken from cand alone, the same for every thread that reads the
// slot.  Every test is a float32 or int32 compare with no arithmetic
// (POLYGON's arithmetic rounds as its plain version's separate tensor
// operations do), so the kernels equal their plain PyTorch versions
// exactly.  A tile outside [0, P/128) is never read: the slot counts as a
// miss (COLLECT writes its row as sentinels).
//
// Bound: bytes, those of the distinct leaf tiles the lists name (2 KB of
// entries each, 512 B more of ids for COLLECT) plus, for COLLECT, the
// (B, K*128) id matrix it writes; 4 compares per entry and query, and
// for POLYGON `ne` x (2 multiplies, 1 add, 1 compare) more.  At the
// serving batch (K = 16) the launch and a few dependent memory round
// trips set the time, not the bytes.
//
// Two designs.
// * REACH, COUNT and POLYGON (leaf_scan_cluster_kernel): a thread block
//   cluster of C CTAs of 128 threads per query tile (C from the host, so
//   that (B/8)*C covers the SMs at small batches, and at most K), CTA r
//   taking slots k = r (mod C).  The prologue loads, behind one
//   __syncthreads(), the query tile's candidate row (in chunks of CHUNK
//   slots, with slot c0-1 before each, so the padding rule compares slot
//   k with slot k-1 and not with the CTA's own previous slot), its 8
//   rects and slices and, for POLYGON, its (3*ne, 8) half-plane block
//   where ne <= NE_SMEM (a larger polygon's instantiation, LINES =
//   GLOBAL, reads them by broadcast loads from global memory).  Then each
//   thread stages its own lane of every slot it owns, four 4-byte
//   cp.async per slot, in a ring of STAGES slots: a CTA owning at most
//   STAGES slots (2 at K = 16, C = 8) issues all its plane loads before
//   it tests any, one memory round trip.  Each thread reads back only
//   what it copied, so the ring needs no block barrier.  POLYGON tests
//   the `ne` half-planes in a loop the whole warp takes, for each query
//   that some lane's box test hit and that no lane of the warp has
//   answered yet: the answer is an OR over entries, so a query once hit
//   stays hit, and the AND over all `ne` half-planes has no trip count
//   that hangs on a global load.  Each warp reduces its counts (or hit
//   bits) by warp intrinsics and writes them once into its own row of
//   rank 0's shared memory through distributed shared memory: no
//   atomics, so nothing is zeroed first, and the cluster barrier is split
//   around the scan (a relaxed arrival after the prologue, the wait
//   before the writes: every CTA has started).  Then every CTA arrives
//   (release) and only rank 0 waits: one warp of it reads the C*4 rows, a
//   lane each, sums (ORs) them by warp reductions and writes the 8
//   outputs.  An integer sum and an OR do not depend on the order.
//   REACH does not stop early once its 8 queries have hit: a CTA issues
//   the plane loads of all its slots (up to STAGES) before it tests any,
//   so at the serving batch there is nothing left to skip.
// * COLLECT (collect_scan_kernel): each (query, slot) row of 512 bytes
//   has one writer, so no combine and no cluster: a warp per (query
//   tile, slot), W warps a CTA on W consecutive slots of one query tile
//   (W from the host), (B/8) * ceil(K/W) CTAs.  Warp 0 loads the 8 rects
//   and slices and the CTA's W slots with the slot before them, two
//   independent loads a lane, behind one __syncthreads().  Then lane l
//   owns entries 4l .. 4l+3 of its warp's tile: one float4 of each plane
//   and one int4 of ids, all issued before any compare (the second and
//   last round trip), and one int4 store into each of the 8 query rows,
//   a coalesced 512-byte row per query.  A padding slot or a tile
//   outside the arena loads nothing and stores sentinels.  The planes,
//   the ids and the output start on 16-byte boundaries (the wrapper
//   checks; P % 128 == 0 keeps every tile and row aligned).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_cluster.cuh"

namespace cg = cooperative_groups;
using namespace async_cluster;

namespace {

constexpr int TB = 8;      // queries per query tile
constexpr int TP = 128;    // arena entries per leaf tile = threads per block
constexpr int32_t ID_SENTINEL = 0x7fffffff;
constexpr int CHUNK = 1024;      // candidate slots staged at a time
constexpr int STAGES = 8;        // slots of plane loads in flight per CTA
constexpr int MAX_CLUSTER = 8;
// POLYGON: the most half-planes a query keeps in shared memory.  Their
// 12 KB and the kernel's static 21.7 KB stay under the 48 KB a launch
// takes without opting in to more.
constexpr int NE_SMEM = 128;
constexpr int WARPS = TP / 32;
constexpr int COLLECT_MAX_WARPS = 8;  // COLLECT: slots (warps) per CTA

enum Mode { REACH = 0, COUNT = 1, POLYGON = 3 };
enum Lines { SHARED = 0, GLOBAL = 1 };  // where POLYGON reads half-planes

// ---- REACH (K3), COUNT (K4) and POLYGON (K6): a cluster per query tile

template <int MODE, int LINES>
__global__ void __launch_bounds__(TP)
leaf_scan_cluster_kernel(const int32_t* __restrict__ cand,    // (B / TB, K)
                         const float* __restrict__ entries,   // (4, P)
                         const float* __restrict__ rects,     // (4, B)
                         const float* __restrict__ lines,     // (3*ne, B)
                         const int32_t* __restrict__ qstart,  // (B,)
                         const int32_t* __restrict__ qend,    // (B,)
                         int32_t* __restrict__ out,           // (B,)
                         int K, int P, int B, int ne) {
  __shared__ float s_rect[4][TB];
  __shared__ int s_qs[TB], s_qe[TB];
  // rank 0's: one partial per warp of the cluster, each written once by
  // its warp (COUNT: 8 sums; REACH, POLYGON: the hit bits in s_part[w][0])
  __shared__ __align__(16) int s_part[MAX_CLUSTER * WARPS][TB];
  __shared__ int s_cand[CHUNK + 1];  // slot c0-1 (0 at c0 = 0), then
                                     // slots [c0, c0 + CHUNK)
  __shared__ float s_ent[STAGES][4][TP];
  extern __shared__ float s_line[];  // SHARED: (3*ne, TB), row j*ne + h

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / C;  // query tile
  const int lane = threadIdx.x;
  const int q0 = blk * TB;
  const int32_t* c = cand + (size_t)blk * K;

  auto stage_cand = [&](int c0) {
    const int n = min(CHUNK, K - c0);
    for (int j = lane; j <= n; j += TP)
      s_cand[j] = (c0 + j > 0) ? c[c0 + j - 1] : 0;
  };

  // the prologue: every load independent of the others, one round trip
  if (lane < 4 * TB) {
    const int a = lane / TB, q = lane % TB;
    s_rect[a][q] = rects[a * B + q0 + q];
  } else if (lane < 5 * TB) {
    const int q = lane - 4 * TB;
    s_qs[q] = qstart[q0 + q];
    s_qe[q] = qend[q0 + q];
  }
  stage_cand(0);
  if (MODE == POLYGON && LINES == SHARED) {
    for (int j = lane; j < 3 * ne * TB; j += TP)
      s_line[j] = lines[(size_t)(j / TB) * B + q0 + j % TB];
  }
  // every CTA of the cluster has started before any writes into rank
  // 0's shared memory: arrive now, wait just before the writes
  cluster_arrive_relaxed();
  __syncthreads();

  const int ntiles = P / TP;
  unsigned bits = 0u;   // REACH, POLYGON: this thread's hit bits
  unsigned wbits = 0u;  // POLYGON: its warp's, the same in every lane
  int cnt[TB];          // COUNT: this thread's hits
#pragma unroll
  for (int q = 0; q < TB; ++q) cnt[q] = 0;

  for (int c0 = 0; c0 < K; c0 += CHUNK) {
    if (c0 > 0) {
      __syncthreads();  // every thread is done with the last chunk
      stage_cand(c0);
      __syncthreads();
    }
    // this CTA's slots of the chunk: k0 + j*C < ce
    const int ce = min(c0 + CHUNK, K);
    const int k0 = c0 + ((rank - c0 % C) + C) % C;
    const int nown = k0 < ce ? (ce - 1 - k0) / C + 1 : 0;
    // the tile of owned slot j, or -1 where it is not scanned: out of
    // range, or padding (COUNT) / a repeat (REACH, POLYGON) of slot k-1
    auto tile_of = [&](int j) -> int {
      const int k = k0 + j * C;
      const int t = s_cand[k - c0 + 1], prev = s_cand[k - c0];
      const bool skip = (k > 0) && (MODE == COUNT ? t <= prev : t == prev);
      return ((unsigned)t < (unsigned)ntiles && !skip) ? t : -1;
    };
    // one commit group per owned slot, empty past the last or where the
    // slot is not scanned
    auto issue = [&](int j) {
      if (j < nown) {
        const int t = tile_of(j);
        if (t >= 0) {
          const size_t g = (size_t)t * TP + lane;
#pragma unroll
          for (int a = 0; a < 4; ++a)
            cp_async4(&s_ent[j % STAGES][a][lane],
                      entries + a * (size_t)P + g);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < STAGES; ++j) issue(j);
    for (int j = 0; j < nown; ++j) {
      cp_async_wait<STAGES - 1>();  // slot j's copies, for this thread
      const int t = tile_of(j);
      if (t >= 0) {  // the same in every thread
        const int g = t * TP + lane;
        const int st = j % STAGES;
        const float e0 = s_ent[st][0][lane], e1 = s_ent[st][1][lane];
        const float e2 = s_ent[st][2][lane], e3 = s_ent[st][3][lane];
        unsigned box = 0u;  // slice and box test, per query
#pragma unroll
        for (int q = 0; q < TB; ++q) {
          const bool hit = (g >= s_qs[q]) & (g < s_qe[q])
                           & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                           & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
          if (MODE == COUNT) cnt[q] += hit;
          box |= (unsigned)hit << q;
        }
        if (MODE == REACH) bits |= box;
        if (MODE == POLYGON) {
          // the half-planes of each query that some lane's box test hit
          // and no lane of the warp has answered yet (an OR: a query
          // already hit stays hit), in a loop the whole warp takes
          unsigned todo = __reduce_or_sync(0xffffffffu, box) & ~wbits;
          while (todo) {
            const int q = __ffs(todo) - 1;
            todo &= todo - 1u;
            bool in = (box >> q) & 1u;
#pragma unroll 4
            for (int h = 0; h < ne; ++h) {
              float a, b, cc;
              if (LINES == SHARED) {
                a = s_line[h * TB + q];
                b = s_line[(ne + h) * TB + q];
                cc = s_line[(2 * ne + h) * TB + q];
              } else {
                const float* l = lines + q0 + q;
                a = __ldg(l + (size_t)h * B);
                b = __ldg(l + (size_t)(ne + h) * B);
                cc = __ldg(l + (size_t)(2 * ne + h) * B);
              }
              in &= __fadd_rn(__fmul_rn(a, e0), __fmul_rn(b, e1)) <= cc;
            }
            bits |= (unsigned)in << q;
          }
          wbits = __reduce_or_sync(0xffffffffu, bits);
        }
      }
      issue(j + STAGES);  // into the stage just read, by this thread only
    }
  }

  // ---- one partial per warp into rank 0's shared memory -----------------
  const int w = rank * WARPS + (lane >> 5);
  const int wl = lane & 31;
  int(*part0)[TB] = reinterpret_cast<int(*)[TB]>(
      cluster.map_shared_rank(&s_part[0][0], 0));
  int mine = 0;  // lane q: the warp's sum for query q; lane 0: its bits
  if (MODE != COUNT) {
    mine = static_cast<int>(__reduce_or_sync(0xffffffffu, bits));
  } else {
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      const int s = __reduce_add_sync(0xffffffffu, cnt[q]);
      if (wl == q) mine = s;
    }
  }
  cluster_wait();
  if (wl < (MODE == COUNT ? TB : 1)) part0[w][wl] = mine;
  // the writes are visible to rank 0 once its wait returns; no other
  // CTA's shared memory is read, so the others leave after arriving
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();
  if (lane < 32) {  // warp 0: lane v reads row v, then one reduction
    const bool row = lane < C * WARPS;
    if (MODE != COUNT) {
      const unsigned all = __reduce_or_sync(
          0xffffffffu, row ? static_cast<unsigned>(s_part[lane][0]) : 0u);
      if (lane < TB) out[q0 + lane] = static_cast<int>((all >> lane) & 1u);
    } else {
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 lo = row ? *reinterpret_cast<const int4*>(&s_part[lane][0])
                          : zero;
      const int4 hi = row ? *reinterpret_cast<const int4*>(&s_part[lane][4])
                          : zero;
      const int v[TB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      int sum = 0;
#pragma unroll
      for (int q = 0; q < TB; ++q) {
        const int s = __reduce_add_sync(0xffffffffu, v[q]);
        if (lane == q) sum = s;
      }
      if (lane < TB) out[q0 + lane] = sum;
    }
  }
}

template <int MODE, int LINES>
int launch_cluster(const void* cand, const void* entries, const void* rects,
                   const void* lines, const void* qstart, const void* qend,
                   void* out, int K, int P, int B, int ne, int cluster,
                   void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || ne < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.dynamicSmemBytes =
      LINES == SHARED ? (size_t)3 * ne * TB * sizeof(float) : 0;
  cfg.gridDim = dim3((B / TB) * cluster);
  cfg.blockDim = dim3(TP);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, leaf_scan_cluster_kernel<MODE, LINES>,
      static_cast<const int32_t*>(cand),
      static_cast<const float*>(entries), static_cast<const float*>(rects),
      static_cast<const float*>(lines), static_cast<const int32_t*>(qstart),
      static_cast<const int32_t*>(qend), static_cast<int32_t*>(out), K, P, B,
      ne);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- COLLECT (K5): a warp per (query tile, slot) ------------------------

__global__ void __launch_bounds__(COLLECT_MAX_WARPS * 32)
collect_scan_kernel(const int32_t* __restrict__ cand,     // (B / TB, K)
                    const float* __restrict__ entries,    // (4, P)
                    const int32_t* __restrict__ ids,      // (P,)
                    const float* __restrict__ rects,      // (4, B)
                    const int32_t* __restrict__ qstart,   // (B,)
                    const int32_t* __restrict__ qend,     // (B,)
                    int32_t* __restrict__ out,            // (B, K*TP)
                    int K, int P, int B, int groups) {
  __shared__ float s_rect[4][TB];
  __shared__ int s_qs[TB], s_qe[TB];
  __shared__ int s_cand[COLLECT_MAX_WARPS + 1];  // slot k0-1, then k0 ..

  const int W = static_cast<int>(blockDim.x) / 32;
  const int blk = blockIdx.x / groups;       // query tile
  const int k0 = (blockIdx.x % groups) * W;  // the CTA's first slot
  const int t = threadIdx.x;
  const int q0 = blk * TB;

  // the prologue, in warp 0: a rect word and one of a slice bound or a
  // candidate slot per lane, independent loads, one round trip
  if (t < 32) {
    const float r = rects[(t / TB) * B + q0 + t % TB];
    const int j = t - 2 * TB;  // s_cand[j] holds slot k0 + j - 1
    int v = 0;
    if (t < TB) {
      v = qstart[q0 + t];
    } else if (t < 2 * TB) {
      v = qend[q0 + t - TB];
    } else if (j <= W) {
      const int k = k0 + j - 1;
      if (k >= 0 && k < K) v = cand[(size_t)blk * K + k];
    }
    s_rect[t / TB][t % TB] = r;
    if (t < TB) s_qs[t] = v;
    else if (t < 2 * TB) s_qe[t - TB] = v;
    else if (j <= W) s_cand[j] = v;
  }
  __syncthreads();

  const int w = t >> 5, lane = t & 31;
  const int k = k0 + w;
  if (k >= K) return;
  const int tile = s_cand[w + 1], prev = s_cand[w];
  const bool scan = (unsigned)tile < (unsigned)(P / TP)
                    && !(k > 0 && tile <= prev);
  // lane l's int4 of slot k in query q0's row; the next query's is
  // K*TP/4 int4s further
  const size_t qstride = (size_t)K * (TP / 4);
  int4* dst = reinterpret_cast<int4*>(out) + (size_t)q0 * qstride
              + (size_t)k * (TP / 4) + lane;
  if (!scan) {
    const int4 none = make_int4(ID_SENTINEL, ID_SENTINEL, ID_SENTINEL,
                                ID_SENTINEL);
#pragma unroll
    for (int q = 0; q < TB; ++q) dst[q * qstride] = none;
    return;
  }
  const int g = tile * TP + 4 * lane;
  const float4 e0 = __ldg(reinterpret_cast<const float4*>(entries + g));
  const float4 e1 =
      __ldg(reinterpret_cast<const float4*>(entries + (size_t)P + g));
  const float4 e2 =
      __ldg(reinterpret_cast<const float4*>(entries + 2 * (size_t)P + g));
  const float4 e3 =
      __ldg(reinterpret_cast<const float4*>(entries + 3 * (size_t)P + g));
  const int4 id = __ldg(reinterpret_cast<const int4*>(ids + g));
#pragma unroll
  for (int q = 0; q < TB; ++q) {
    const int qs = s_qs[q], qe = s_qe[q];
    const float x0 = s_rect[0][q], y0 = s_rect[1][q];
    const float x1 = s_rect[2][q], y1 = s_rect[3][q];
    auto pick = [&](int i, float a, float b, float c, float d, int v) {
      const bool hit = (g + i >= qs) & (g + i < qe) & (a <= x1) & (b <= y1)
                       & (c >= x0) & (d >= y0);
      return hit ? v : ID_SENTINEL;
    };
    dst[q * qstride] = make_int4(pick(0, e0.x, e1.x, e2.x, e3.x, id.x),
                                 pick(1, e0.y, e1.y, e2.y, e3.y, id.y),
                                 pick(2, e0.z, e1.z, e2.z, e3.z, id.z),
                                 pick(3, e0.w, e1.w, e2.w, e3.w, id.w));
  }
}

}  // namespace

// Plain C entries for ctypes, one per kernel.  Each launches on `stream`,
// never synchronises, and returns the launch's error or
// cudaGetLastError(), so a refused launch is reported to the caller.
// descent_scan_launch, count_scan_launch and polygon_scan_launch launch
// (B / 8) clusters of `cluster` CTAs (1 to 8); polygon_scan_launch keeps
// the half-planes in shared memory up to NE_SMEM of them.
// collect_scan_launch launches (B / 8) * ceil(K / warps) CTAs of `warps`
// warps (1 to 8), one slot a warp.
extern "C" int descent_scan_launch(const void* cand, const void* entries,
                                   const void* rects, const void* qstart,
                                   const void* qend, void* out, int K, int P,
                                   int B, int cluster, void* stream) {
  return launch_cluster<REACH, SHARED>(cand, entries, rects, nullptr, qstart,
                                       qend, out, K, P, B, 0, cluster,
                                       stream);
}

extern "C" int count_scan_launch(const void* cand, const void* entries,
                                 const void* rects, const void* qstart,
                                 const void* qend, void* out, int K, int P,
                                 int B, int cluster, void* stream) {
  return launch_cluster<COUNT, SHARED>(cand, entries, rects, nullptr, qstart,
                                       qend, out, K, P, B, 0, cluster,
                                       stream);
}

extern "C" int collect_scan_launch(const void* cand, const void* entries,
                                   const void* ids, const void* rects,
                                   const void* qstart, const void* qend,
                                   void* out, int K, int P, int B, int warps,
                                   void* stream) {
  if (warps < 1 || warps > COLLECT_MAX_WARPS || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (K + warps - 1) / warps;
  const long long grid = (long long)(B / TB) * groups;
  if (grid < 1 || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  collect_scan_kernel<<<static_cast<unsigned>(grid), 32 * warps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(entries),
      static_cast<const int32_t*>(ids), static_cast<const float*>(rects),
      static_cast<const int32_t*>(qstart), static_cast<const int32_t*>(qend),
      static_cast<int32_t*>(out), K, P, B, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int polygon_scan_launch(const void* cand, const void* entries,
                                   const void* rects, const void* lines,
                                   const void* qstart, const void* qend,
                                   void* out, int K, int P, int B, int ne,
                                   int cluster, void* stream) {
  return ne <= NE_SMEM
             ? launch_cluster<POLYGON, SHARED>(cand, entries, rects, lines,
                                               qstart, qend, out, K, P, B, ne,
                                               cluster, stream)
             : launch_cluster<POLYGON, GLOBAL>(cand, entries, rects, lines,
                                               qstart, qend, out, K, P, B, ne,
                                               cluster, stream);
}
