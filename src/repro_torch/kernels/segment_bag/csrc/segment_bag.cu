// Fused EmbeddingBag for Hopper (sm_90a): gather plus weighted segment sum,
//
//   out[s, :] = sum over k with seg[k] == s of w[k] * table[idx[k], :]
//
// for s in [0, n_segments), with a (V, D) float32 or bfloat16 table,
// (L,) int32 idx, (L,) int32 seg sorted ascending (padding carries
// seg == n_segments) and (L,) float32 w; out is (n_segments, D) float32.
//
// Replaces repro/kernels/segment_bag/kernel.py::segment_bag_pallas
// (_segment_bag_kernel).  It computes that kernel's function, not its grid:
// the TPU walks the lookups in order, 8 per grid step, and read-modify-
// writes the output row of each one in a VMEM block that spans the whole
// output.  Blocks here run in no order, so each output row has one owner,
// which sums its run of lookups itself.  No atomics; the result does not
// depend on scheduling.
//
// Numbers: like repro/kernels/segment_bag/ref.py (the reference's
// production path), a bf16 row is widened to float32 and the sum is kept
// and returned in float32.  Each term is w * x rounded, added in ascending
// k (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA):
// the same operations in the same order as the plain PyTorch version run
// on the CPU (gather, scale, index_add_), so the two agree bit for bit.
// Loads go in any order; the adds of a column never do.
//
// Bound: bytes.  The distinct table rows the lookups name, plus 12 B of
// idx, seg and w per lookup, plus the output, against one multiply-add
// per lookup and column.  The gather really moves whole 32-byte sectors:
// a 72-byte float32 row at D = 18 spans three, so its traffic through L2
// is 96 B a lookup, and a table larger than L2 sends much of it to HBM.
// On an H100 the time grows with the table's rows on the same lookups
// (`chip_smoke.py --ab`, `by_table_rows`): the L2's sector rate bounds it
// while the table fits in L2, the misses to HBM add to it beyond.
//
// Design: a warp owns `spw` consecutive segments [s0, s1), whose lookups
// are one contiguous window of k because seg is sorted.
//   * Bounds: the warp finds the window's start with one 32-ary search
//     (each round the 32 lanes probe seg at 32 evenly spaced points and a
//     ballot narrows the range 32-fold: 5 rounds at L = 16.4M).  The end
//     is not searched: the walk stops at the first seg >= s1.
//   * Walk: batches of up to 32 lookups, one a lane: idx, seg and w in
//     one coalesced load each.  A batch's rows are copied into shared
//     memory with cp.async, the rows cut into vectors of `VB` bytes handed
//     out flat over the lanes (D = 18 float32: 9 float2 a row, 288 for 32
//     rows, 9 a lane, all lanes busy), each lane taking the row index
//     from its owner by shuffle, four at a time.  Two batches are in
//     flight: batch b + 1's rows and b + 2's indices are issued before
//     batch b is summed.
//   * Sum: lane c owns column c (and c + 32, ...).  A ballot of seg marks
//     where a new segment starts inside the batch; each run of one segment
//     is added in ascending k from shared memory into the column's
//     partial sum, kept in shared memory across batches.  When the segment
//     changes, the partial sum goes to out, and empty segments in between
//     get zeros; at the window's end so do the segments left.  Padding
//     (seg == n_segments >= s1) ends the walk and is never read.
//   * Columns: a row chunk of at most 4 KB is staged at once; a wider
//     table walks the window again for each further chunk.
//   * VB is the widest of 16, 8, 4 (and 2 for bf16) bytes that divides the
//     row's bytes and the table's base address (ops.py::copy_bytes); 2
//     bytes takes plain loads, since cp.async copies no less than 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // warps a block, independent
constexpr int STAGE_BYTES = 4096;    // the most of a row chunk per batch
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {   // bf16 bits
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <int VB>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 ::"r"(s), "l"(src), "n"(VB) : "memory");
}

template <>
__device__ __forceinline__ void copy_vec<2>(void* dst, const void* src) {
  *static_cast<unsigned short*>(dst) =
      __ldg(static_cast<const unsigned short*>(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's shared memory: two stages of rows, two of w and seg, and
// the column partial sums.  The host sizes the launch with it.
struct Layout {
  int dc;          // columns of the first (widest) chunk
  int stage;       // bytes of one stage
  int warp_bytes;  // everything, a multiple of 16
};

__host__ __device__ inline Layout make_layout(int D, int esz) {
  Layout l;
  l.dc = D < STAGE_BYTES / esz ? D : STAGE_BYTES / esz;
  const int rows = STAGE_BYTES / (l.dc * esz);
  l.stage = ((rows < 32 ? rows : 32) * l.dc * esz + 15) & ~15;
  l.warp_bytes = 2 * l.stage + 4 * 32 * 4 + ((l.dc * 4 + 15) & ~15);
  return l;
}

// First k in [0, L) with seg[k] >= t (L where there is none), for the
// whole warp: each round splits [lo, hi] into 32 steps and probes the
// last k of each.
__device__ __forceinline__ int search(const int* __restrict__ seg, int L,
                                      int t, int lane) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const long long p = lo + (long long)(lane + 1) * step - 1;
    const bool below = p < hi && seg[p] < t;
    const int c = __popc(__ballot_sync(FULL, below));
    const long long top = lo + (long long)(c + 1) * step - 1;
    lo += c * step;
    hi = top < hi ? (int)top : hi;
  }
  return lo;
}

template <typename S, int VB>
__global__ void __launch_bounds__(WARPS * 32)
segment_bag_kernel(const S* __restrict__ table,     // (V, D)
                   const int* __restrict__ idx,     // (L,)
                   const int* __restrict__ seg,     // (L,) sorted
                   const float* __restrict__ w,     // (L,)
                   float* __restrict__ out,         // (n_segments, D)
                   int L, int D, int n_segments, int spw) {
  constexpr int VW = VB / (int)sizeof(S);           // elements a vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (wid * spw >= n_segments) return;
  const int s0 = (int)(wid * spw);
  const int s1 = n_segments - s0 < spw ? n_segments : s0 + spw;

  const Layout lay = make_layout(D, sizeof(S));
  // this warp's stages (buf 0, 1), then w[2][32], seg[2][32], carry[dc]
  unsigned char* const stage = smem + (threadIdx.x >> 5) * lay.warp_bytes;
  float* const sw = reinterpret_cast<float*>(stage + 2 * lay.stage);
  int* const ss = reinterpret_cast<int*>(sw + 64);
  float* const carry = reinterpret_cast<float*>(ss + 64);

  const int k0 = search(seg, L, s0, lane);
  const size_t row_bytes = (size_t)D * sizeof(S);
  const unsigned char* tbytes = reinterpret_cast<const unsigned char*>(table);

  for (int c0 = 0; c0 < D; c0 += lay.dc) {
    const int dc = D - c0 < lay.dc ? D - c0 : lay.dc;
    const int vr = dc / VW;                       // vectors a row
    const int rmax = lay.stage / (dc * (int)sizeof(S));
    const int R = rmax < 32 ? rmax : 32;          // lookups a batch
    const int dr = 32 / vr, de = 32 - dr * vr;    // a lane's step in (r, e)
    const unsigned char* tchunk = tbytes + (size_t)c0 * sizeof(S);

    // This lane's lookup of the batch at kb; rows past the window or L
    // carry seg = s1 and are not counted.
    int bi = 0, bs = s1;
    float bw = 0.f;
    auto fetch = [&](int at) {
      const long long k = (long long)at + lane;
      bi = 0; bs = s1; bw = 0.f;
      if (lane < R && k < L) { bi = idx[k]; bs = seg[k]; bw = w[k]; }
    };
    // Issue the fetched batch into stage `buf`: its rows by cp.async,
    // w and seg by plain stores.  Returns its lookups; `starts` gets the
    // rows (after the first) where a new segment begins.
    auto issue = [&](int buf, unsigned& starts) {
      const bool in = bs < s1;
      const int n = __popc(__ballot_sync(FULL, in));
      const int prev = __shfl_up_sync(FULL, bs, 1);
      starts = __ballot_sync(FULL, in && lane > 0 && bs != prev);
      if (in) { sw[buf * 32 + lane] = bw; ss[buf * 32 + lane] = bs; }
      const int nv = n * vr;
      const int nj = (nv + 31) >> 5;              // vectors a lane, at most
      int r = lane / vr, e = lane - (lane / vr) * vr;
      unsigned char* dst = stage + buf * lay.stage + lane * VB;
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const int row = __shfl_sync(FULL, bi, r < 31 ? r : 31);
        if (lane + 32 * j < nv)
          copy_vec<VB>(dst, tchunk + (size_t)row * row_bytes + e * VB);
        dst += 32 * VB;
        r += dr; e += de;
        if (e >= vr) { e -= vr; ++r; }
      }
      commit();
      return n;
    };

    int cur = s0 - 1;                 // the open segment (none yet)
    // Sum stage `buf`'s n lookups, run by run, into the partial sums.
    auto sum = [&](int buf, int n, unsigned starts) {
      const S* st = reinterpret_cast<const S*>(stage + buf * lay.stage);
      const float* wb = sw + buf * 32;
      int r = 0;
      while (r < n) {
        const unsigned later = r < 31 ? starts & (FULL << (r + 1)) : 0u;
        const int r_end = later ? __ffs(later) - 1 : n;
        const int s = ss[buf * 32 + r];
        const bool fresh = s != cur;
        for (int c = lane; c < dc; c += 32) {
          float acc = 0.f;
          if (fresh) {
            if (cur >= s0) out[(size_t)cur * D + c0 + c] = carry[c];
            for (int z = cur + 1; z < s; ++z)
              out[(size_t)z * D + c0 + c] = 0.f;
          } else {
            acc = carry[c];
          }
          // not unrolled: with this loop and the copy loop both unrolled,
          // DIN's serve_bulk bags ran slower on an H100, not faster
          for (int q = r; q < r_end; ++q)
            acc = __fadd_rn(acc, __fmul_rn(wb[q], widen(st[q * dc + c])));
          carry[c] = acc;
        }
        cur = s;
        r = r_end;
      }
    };

    int kb = k0;
    fetch(kb);
    unsigned starts;
    int n = issue(0, starts);
    bool more = n == R;
    if (more) fetch(kb += R);
    for (int b = 0;; ++b) {
      unsigned starts_next = 0;
      int n_next = 0;
      const bool issued = more;
      if (issued) {
        n_next = issue((b + 1) & 1, starts_next);
        more = n_next == R;
        if (more) fetch(kb += R);
        wait_groups<1>();
      } else {
        wait_groups<0>();
      }
      __syncwarp();
      sum(b & 1, n, starts);
      __syncwarp();
      if (!issued) break;
      n = n_next;
      starts = starts_next;
    }
    for (int c = lane; c < dc; c += 32) {
      if (cur >= s0) out[(size_t)cur * D + c0 + c] = carry[c];
      for (int z = cur + 1; z < s1; ++z) out[(size_t)z * D + c0 + c] = 0.f;
    }
    __syncwarp();
  }
}

template <typename S, int VB>
int launch_vb(const void* table, const void* idx, const void* seg,
              const void* w, void* out, int L, int D, int n_segments,
              int spw, cudaStream_t stream) {
  const Layout lay = make_layout(D, sizeof(S));
  const size_t smem = (size_t)WARPS * lay.warp_bytes;
  auto kernel = segment_bag_kernel<S, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = ((long long)n_segments + spw - 1) / spw;
  const unsigned grid = (unsigned)((warps + WARPS - 1) / WARPS);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const S*>(table), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(w),
      static_cast<float*>(out), L, D, n_segments, spw);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const void* table, const void* idx, const void* seg,
           const void* w, void* out, int L, int D, int n_segments,
           int vector_bytes, int spw, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (spw < 1 || vector_bytes < (int)sizeof(S) ||
      D % (vector_bytes / (int)sizeof(S)) != 0 ||
      reinterpret_cast<uintptr_t>(table) % vector_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vector_bytes) {
    case 16: return launch_vb<S, 16>(table, idx, seg, w, out, L, D,
                                     n_segments, spw, st);
    case 8: return launch_vb<S, 8>(table, idx, seg, w, out, L, D,
                                   n_segments, spw, st);
    case 4: return launch_vb<S, 4>(table, idx, seg, w, out, L, D,
                                   n_segments, spw, st);
    case 2:
      if constexpr (sizeof(S) == 2)
        return launch_vb<S, 2>(table, idx, seg, w, out, L, D, n_segments,
                               spw, st);
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entries for ctypes, one per table type: each launches on
// `stream`, never synchronises, and returns cudaGetLastError() so a
// refused launch is reported to the caller.  n_segments >= 1, D >= 1,
// vector_bytes divides D's bytes and the table's base address (4, 8 or
// 16 for float32; 2, 4, 8 or 16 for bf16), segs_per_warp >= 1.
extern "C" int segment_bag_f32_launch(const void* table, const void* idx,
                                      const void* seg, const void* w,
                                      void* out, int L, int D,
                                      int n_segments, int vector_bytes,
                                      int segs_per_warp, void* stream) {
  return launch<float>(table, idx, seg, w, out, L, D, n_segments,
                       vector_bytes, segs_per_warp, stream);
}

extern "C" int segment_bag_bf16_launch(const void* table, const void* idx,
                                       const void* seg, const void* w,
                                       void* out, int L, int D,
                                       int n_segments, int vector_bytes,
                                       int segs_per_warp, void* stream) {
  return launch<unsigned short>(table, idx, seg, w, out, L, D, n_segments,
                                vector_bytes, segs_per_warp, stream);
}
