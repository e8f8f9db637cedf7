// Fused RangeReach serve kernel for Hopper (sm_90a).
//
// Replaces repro/kernels/range_query/fused.py::fused_serve_pallas, the TPU
// megakernel, and computes what its XLA twin fused_serve_xla computes, bit
// for bit: per 8-query tile, the quantized coarse AND fine AND arena-slice
// prune of every leaf tile, an ascending worklist of the surviving tiles
// (its true length kept past kcap: the engine's ratchet reads it), and the
// exact float32 box-and-slice test over at most kcap of them, with a reach
// (OR), count (sum) or collect (id or sentinel per slot) epilogue.  Every
// comparison is integer or float32 with no arithmetic, so the kernel and
// the plain PyTorch version agree exactly.
//
// Bound: bytes.  A query tile needs the pyramid only inside its slices'
// tile spans (12 bytes per leaf tile), 2 KB per scanned leaf tile (512 B
// more for the ids in collect mode) and the outputs; a few integer
// compares per byte.  At the serving batch the launch itself is the floor.
//
// Design.
// * Slice-bounded prune.  A tile outside every query's span
//   [floor(qs/128), ceil(qe/128)) fails the slice test for all 8 queries
//   (slice_span.cuh), so the block walks only the union of the 8 spans,
//   merged by warp shuffles into at most 8 disjoint ascending intervals,
//   instead of all nt tiles; the worklist and its count are those of the
//   full walk.  A tile's coarse and fine codes load together, in one
//   round trip.  Compaction is a warp ballot plus __popc and a scan of the 8 warp
//   totals, so tile ids land in ascending order.
// * A thread block cluster of C CTAs per query tile (C from the host, so
//   that (B/8)*C covers the SMs at small batches; C = 1 at large ones).
//   Every CTA walks the (cheap) spans itself and scans the worklist slots
//   k = rank (mod C); reach bits and counts reduce into rank 0's shared
//   memory through distributed shared memory (the cluster barrier split
//   around the prune and scan), and rank 0 writes out and cnt after
//   cluster.sync().  In collect mode each CTA writes its own
//   slots.  Nothing is zeroed beforehand and there is no second launch.
// * The scan stages each worklist tile's four 512-byte plane segments
//   (and its ids in collect mode) into shared memory with cp.async, two
//   tiles a step, in a ring of STAGES steps, so the loads of later tiles
//   are in flight while the compares of earlier ones run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_cluster.cuh"
#include "slice_span.cuh"

namespace cg = cooperative_groups;
using namespace async_cluster;

namespace {

constexpr int TB = 8;         // queries per query tile
constexpr int TP = 128;       // arena entries per leaf tile
constexpr int GROUP = 8;      // leaf tiles per coarse pyramid node
constexpr int THREADS = 256;  // two leaf tiles of 128 lanes per scan step
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;     // scan steps in flight
constexpr int MAX_CLUSTER = 8;
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
                   int ntp, int nt, int P, int B, int kcap) {
  __shared__ int s_qs[TB], s_qe[TB];
  __shared__ int s_r16[4][TB], s_r32[4][TB];
  __shared__ float s_rect[4][TB];
  __shared__ int s_nspan, s_mlo[TB], s_mhi[TB], s_mpre[TB + 1];
  __shared__ int s_warp[WARPS];
  __shared__ int s_wl[THREADS];  // this chunk's worklist tiles, ascending
  __shared__ int s_acc[TB];      // count: rank 0's per-query sums
  __shared__ unsigned s_or;      // reach: rank 0's hit bits
  __shared__ __align__(16) float s_ent[STAGES][2][4][TP];
  __shared__ __align__(16) int32_t s_ids[MODE == COLLECT ? STAGES : 1][2][TP];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / C;  // query tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blk * TB;
  const int ncp = ntp / GROUP;

  // warp 0: the 8 slices, their tile spans merged by shuffles; warp 1:
  // the rects, in parallel
  if (warp == 0) {
    int lo = 0, hi = 0;
    if (lane < TB) {
      const int qs = qstart[q0 + lane], qe = qend[q0 + lane];
      s_qs[lane] = qs;
      s_qe[lane] = qe;
      s_acc[lane] = 0;
      slice_span::tile_span(qs, qe, TP, nt, lo, hi);
    }
    const int m = slice_span::merge_warp<TB>(lo, hi, s_mlo, s_mhi, s_mpre);
    if (lane == 0) {
      s_nspan = m;
      s_or = 0u;
    }
  } else if (tid < 32 + 4 * TB) {
    const int a = (tid - 32) / TB, q = (tid - 32) % TB;
    s_r16[a][q] = r16[a * B + q0 + q];
    s_r32[a][q] = r32[a * B + q0 + q];
    s_rect[a][q] = rects[a * B + q0 + q];
  }
  // rank 0's accumulators are zero before any CTA of the cluster adds
  // into them: arrive now, wait just before the adds
  if (MODE != COLLECT) cluster_arrive();
  __syncthreads();

  const int nspan = s_nspan;
  const int span_tiles = s_mpre[nspan];
  const int half = tid >> 7;  // which tile of a scan step
  const int l = tid & (TP - 1);
  const size_t row = (size_t)kcap * TP;
  unsigned bits = 0u;
  int c[TB];
#pragma unroll
  for (int q = 0; q < TB; ++q) c[q] = 0;

  // ---- prune the span tiles, compact, scan this CTA's slots ------------
  int base = 0;  // worklist slots filled by earlier chunks
  for (int v0 = 0; v0 < span_tiles; v0 += THREADS) {
    const int v = v0 + tid;
    bool act = false;
    int g = 0;
    if (v < span_tiles) {
      g = slice_span::tile_at(v, s_mlo, s_mpre, nspan);
      const int cgi = g / GROUP;
      const int c0v = qcoarse[cgi], c1v = qcoarse[ncp + cgi];
      const int c2v = qcoarse[2 * ncp + cgi], c3v = qcoarse[3 * ncp + cgi];
      const int f0 = qfine[g], f1 = qfine[ntp + g];
      const int f2 = qfine[2 * ntp + g], f3 = qfine[3 * ntp + g];
      const int lo = g * TP, hi = lo + TP;
      unsigned pass = 0u;  // slice and coarse node, per query
#pragma unroll
      for (int q = 0; q < TB; ++q) {
        const bool ok = (lo < s_qe[q]) & (hi > s_qs[q])
                        & (c0v <= s_r32[2][q]) & (c1v <= s_r32[3][q])
                        & (c2v >= s_r32[0][q]) & (c3v >= s_r32[1][q]);
        pass |= (unsigned)ok << q;
      }
#pragma unroll
      for (int q = 0; q < TB; ++q)
        act |= (((pass >> q) & 1u) != 0u)
               & (f0 <= s_r16[2][q]) & (f1 <= s_r16[3][q])
               & (f2 >= s_r16[0][q]) & (f3 >= s_r16[1][q]);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int cw = s_warp[w];
      before += (w < warp) ? cw : 0;
      total += cw;
    }
    if (act) s_wl[before + __popc(ballot & ((1u << lane) - 1u))] = g;
    __syncthreads();

    // live slots of this chunk, [base, ke), that this CTA owns: k0 + j*C
    const int ke = min(base + total, kcap);
    const int k0 = base + ((rank - base % C) + C) % C;
    const int nown = k0 < ke ? (ke - 1 - k0) / C + 1 : 0;
    const int steps = (nown + 1) / 2;
    auto issue = [&](int step) {  // stage step's two tiles
      const int pair = tid >> 7;
      const int j = 2 * step + pair;
      if (j < nown) {
        const int gt = s_wl[k0 + j * C - base] * TP;
        const int a = (tid >> 5) & 3, ch = (tid & 31) * 4;
        cp_async16(&s_ent[step % STAGES][pair][a][ch],
                   entries + (size_t)a * P + gt + ch);
        if (MODE == COLLECT && a == 0)
          cp_async16(&s_ids[MODE == COLLECT ? step % STAGES : 0][pair][ch],
                     ids + gt + ch);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // step s has landed, for this thread
      __syncthreads();              // ... and for every thread
      const int j = 2 * s + half;
      if (j < nown) {
        const int k = k0 + j * C;
        const int ge = s_wl[k - base] * TP + l;
        const int st = s % STAGES;
        const float e0 = s_ent[st][half][0][l], e1 = s_ent[st][half][1][l];
        const float e2 = s_ent[st][half][2][l], e3 = s_ent[st][half][3][l];
        if (MODE == COLLECT) {
          const int32_t id = s_ids[MODE == COLLECT ? st : 0][half][l];
#pragma unroll
          for (int q = 0; q < TB; ++q) {
            const bool hit = (ge >= s_qs[q]) & (ge < s_qe[q])
                             & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                             & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
            out[(size_t)(q0 + q) * row + (size_t)k * TP + l] =
                hit ? id : ID_SENTINEL;
          }
        } else {
#pragma unroll
          for (int q = 0; q < TB; ++q) {
            const bool hit = (ge >= s_qs[q]) & (ge < s_qe[q])
                             & (e0 <= s_rect[2][q]) & (e1 <= s_rect[3][q])
                             & (e2 >= s_rect[0][q]) & (e3 >= s_rect[1][q]);
            if (MODE == REACH) bits |= (unsigned)hit << q;
            else c[q] += hit;
          }
        }
      }
      __syncthreads();  // stage s % STAGES is refilled by the next issue
    }
    base += total;
    __syncthreads();    // s_warp and s_wl are rewritten by the next chunk
  }

  if (MODE == COLLECT) {
    // the dead slots [min(cnt, kcap), kcap) this CTA owns hold sentinels
    const int n = min(base, kcap);
    const int k0 = n + ((rank - n % C) + C) % C;
    for (int k = k0 + half * C; k < kcap; k += 2 * C) {
#pragma unroll
      for (int q = 0; q < TB; ++q)
        out[(size_t)(q0 + q) * row + (size_t)k * TP + l] = ID_SENTINEL;
    }
    if (rank == 0 && tid == 0) cnt[blk] = base;
    return;
  }

  // ---- reduce into rank 0 through distributed shared memory -------------
  cluster_wait();
  if (MODE == REACH) {
    unsigned* or0 = cluster.map_shared_rank(&s_or, 0);
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(or0, bits);
  } else {
    int* acc0 = cluster.map_shared_rank(s_acc, 0);
#pragma unroll
    for (int q = 0; q < TB; ++q) {
      const int s = __reduce_add_sync(0xffffffffu, c[q]);
      if (lane == 0 && s) atomicAdd(acc0 + q, s);
    }
  }
  cluster.sync();
  if (rank == 0) {
    if (tid < TB)
      out[q0 + tid] = (MODE == REACH) ? (int)((s_or >> tid) & 1u) : s_acc[tid];
    if (tid == 0) cnt[blk] = base;
  }
}

template <int MODE>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const void* qfine,
                   const void* qcoarse, const void* entries, const void* ids,
                   const void* r16, const void* r32, const void* rects,
                   const void* qstart, const void* qend, void* out, void* cnt,
                   int ntp, int nt, int P, int B, int kcap) {
  return cudaLaunchKernelEx(
      &cfg, fused_serve_kernel<MODE>, static_cast<const int16_t*>(qfine),
      static_cast<const int32_t*>(qcoarse), static_cast<const float*>(entries),
      static_cast<const int32_t*>(ids), static_cast<const int16_t*>(r16),
      static_cast<const int32_t*>(r32), static_cast<const float*>(rects),
      static_cast<const int32_t*>(qstart), static_cast<const int32_t*>(qend),
      static_cast<int32_t*>(out), static_cast<int32_t*>(cnt), ntp, nt, P, B,
      kcap);
}

}  // namespace

// Plain C entry for ctypes.  Launches (B / 8) clusters of `cluster` CTAs
// (1, 2, 4 or 8) on `stream`, never synchronises, and returns the launch's
// error or cudaGetLastError(), so a refused launch is reported to the
// caller.  entries and ids must be 16-byte aligned (cp.async).
extern "C" int fused_serve_launch(int mode, const void* qfine,
                                  const void* qcoarse, const void* entries,
                                  const void* ids, const void* r16,
                                  const void* r32, const void* rects,
                                  const void* qstart, const void* qend,
                                  void* out, void* cnt, int ntp, int nt, int P,
                                  int B, int kcap, int cluster, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B / TB) * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (mode) {
    case REACH:
      err = launch<REACH>(cfg, qfine, qcoarse, entries, ids, r16, r32, rects,
                          qstart, qend, out, cnt, ntp, nt, P, B, kcap);
      break;
    case COUNT:
      err = launch<COUNT>(cfg, qfine, qcoarse, entries, ids, r16, r32, rects,
                          qstart, qend, out, cnt, ntp, nt, P, B, kcap);
      break;
    case COLLECT:
      err = launch<COLLECT>(cfg, qfine, qcoarse, entries, ids, r16, r32, rects,
                            qstart, qend, out, cnt, ntp, nt, P, B, kcap);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
