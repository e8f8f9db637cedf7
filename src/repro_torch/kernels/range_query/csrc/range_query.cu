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
// On the main path every query of a batch reads one tree's slice of
// about 1,800 entries, which sits in L2: the time is the launch and the
// dependent round trips, not bytes.
//
// Design: one 256-thread block per query, so a batch of 256 is 256
// blocks on the card's 132 SMs.  A round covers 2,048 entries of the
// slice: each thread issues all its loads of the round (two 16-byte
// loads of each plane in the VEC instantiation, eight 4-byte loads in
// the scalar one) before it compares any, so a slice of up to 2,048
// entries costs one round trip after the slice bounds.  The VEC
// instantiation reads the aligned middle of the slice as float4s and
// the up to 3 entries before its first 4-entry boundary (the head) and
// after its last (the tail) as scalars in the first round; the launcher
// chooses it where every plane starts on a 16-byte boundary (P % 4 == 0
// and an aligned base: the engines pad P to a multiple of 128), and the
// scalar instantiation elsewhere.  After each round __syncthreads_or
// ORs the block's hits and the block leaves at its first hit, so a
// longer slice (a large tree, the whole arena) stops early.  An empty or
// clipped-away slice (tree id -1, a padded query) writes 0 without
// reading an entry.  Nothing carries across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                 // one block per query
constexpr int GROUPS = 2;                    // float4 groups a thread a round
constexpr int ROUND = THREADS * GROUPS * 4;  // entries a round: 2,048

template <int DIM>
__device__ __forceinline__ bool box_hit(const float (&e)[2 * DIM],
                                        const float (&rlo)[DIM],
                                        const float (&rhi)[DIM]) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    ok &= e[a] <= rhi[a];
    ok &= e[DIM + a] >= rlo[a];
  }
  return ok;
}

template <int DIM, bool VEC>
__global__ void __launch_bounds__(THREADS)
range_query_kernel(const float* __restrict__ entries,   // (2*DIM, P)
                   const float* __restrict__ rects,     // (2*DIM, B)
                   const int32_t* __restrict__ qstart,  // (B,)
                   const int32_t* __restrict__ qend,    // (B,)
                   int32_t* __restrict__ out,           // (B,)
                   int P, int B) {
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int lo = max(__ldg(qstart + q), 0);
  const int hi = min(__ldg(qend + q), P);
  float rlo[DIM], rhi[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    rlo[a] = __ldg(rects + (size_t)a * B + q);
    rhi[a] = __ldg(rects + (size_t)(DIM + a) * B + q);
  }
  if (hi <= lo) {                            // block-uniform
    if (t == 0) out[q] = 0;
    return;
  }
  bool found = false;
  if (VEC) {
    // [lo, a0) head, [a0, a1) float4 groups, [a1, hi) tail
    const int a0 = min((lo + 3) & ~3, hi);
    const int a1 = max(hi & ~3, a0);
    // the head's and the tail's entries, one a thread, in the first round
    const int hg = t < 3 ? lo + t : a1 + t - 3;
    const bool hlive = t < 3 ? hg < a0 : (t < 6 && hg < hi);
    float he[2 * DIM];
#pragma unroll
    for (int p = 0; p < 2 * DIM; ++p)
      he[p] = hlive ? __ldg(entries + (size_t)p * P + hg) : 0.f;
    bool hit = hlive && box_hit<DIM>(he, rlo, rhi);
    for (int base = a0;; base += ROUND) {
      float4 v[GROUPS][2 * DIM];
      bool live[GROUPS];
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        const int g = base + 4 * (t + THREADS * u);
        live[u] = g < a1;
#pragma unroll
        for (int p = 0; p < 2 * DIM; ++p)
          v[u][p] = live[u] ? __ldg(reinterpret_cast<const float4*>(
                                  entries + (size_t)p * P + g))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        if (!live[u]) continue;
        float e[4][2 * DIM];
#pragma unroll
        for (int p = 0; p < 2 * DIM; ++p) {
          e[0][p] = v[u][p].x;
          e[1][p] = v[u][p].y;
          e[2][p] = v[u][p].z;
          e[3][p] = v[u][p].w;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) hit |= box_hit<DIM>(e[s], rlo, rhi);
      }
      found = __syncthreads_or(hit);
      if (found || base + ROUND >= a1) break;
    }
  } else {
    for (int base = lo;; base += ROUND) {
      float e[GROUPS * 4][2 * DIM];
      bool live[GROUPS * 4];
#pragma unroll
      for (int u = 0; u < GROUPS * 4; ++u) {
        const int g = base + t + THREADS * u;
        live[u] = g < hi;
#pragma unroll
        for (int p = 0; p < 2 * DIM; ++p)
          e[u][p] = live[u] ? __ldg(entries + (size_t)p * P + g) : 0.f;
      }
      bool hit = false;
#pragma unroll
      for (int u = 0; u < GROUPS * 4; ++u)
        hit |= live[u] && box_hit<DIM>(e[u], rlo, rhi);
      found = __syncthreads_or(hit);
      if (found || base + ROUND >= hi) break;
    }
  }
  if (t == 0) out[q] = found ? 1 : 0;
}

template <int DIM>
int launch(const void* entries, const void* rects, const void* qstart,
           const void* qend, void* out, int P, int B, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto e = static_cast<const float*>(entries);
  const auto r = static_cast<const float*>(rects);
  const auto qs = static_cast<const int32_t*>(qstart);
  const auto qe = static_cast<const int32_t*>(qend);
  const auto o = static_cast<int32_t*>(out);
  if (vec)
    range_query_kernel<DIM, true><<<B, THREADS, 0, s>>>(e, r, qs, qe, o, P, B);
  else
    range_query_kernel<DIM, false><<<B, THREADS, 0, s>>>(e, r, qs, qe, o, P,
                                                         B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  `vec` != 0 takes the float4 instantiation,
// which needs every plane on a 16-byte boundary (the wrapper checks).
// Launches on `stream`, never synchronises, and returns cudaGetLastError()
// so a refused launch is reported to the caller; a dim other than 2 or 3
// returns cudaErrorInvalidValue without a launch.
extern "C" int range_query_launch(const void* entries, const void* rects,
                                  const void* qstart, const void* qend,
                                  void* out, int P, int B, int dim, int vec,
                                  void* stream) {
  if (dim == 2)
    return launch<2>(entries, rects, qstart, qend, out, P, B, vec, stream);
  if (dim == 3)
    return launch<3>(entries, rects, qstart, qend, out, P, B, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
