// Packed boolean OR-AND matrix product for Hopper (sm_90a): one level of
// the device closure of paper Alg. 1,
//
//     out[i, w] = OR_j ( A[i, j] AND R[j, w] ),
//
// A (f, Wm) packed along j (bit k of word jw is column 32*jw + k), R
// (m, W) packed along its columns, m <= 32*Wm, out (f, W); all uint32.
//
// Replaces repro/kernels/bitset_mm/kernel.py::bitset_mm_pallas
// (_bitset_mm_kernel), which walks one word of A per grid step and
// unrolls 32 masked ORs of a (32, 128) tile of R.
//
// Bound: bytes on this card at the closure's shapes.  A frontier row has
// few set bits (its out-degree), so the work is one OR per set bit of A
// and output word, and the bytes are those of A, of the rows of R that A
// names and of out.
//
// Design: a block of 8 warps owns 8 rows of A and up to 128 words of out
// (grid.y walks W in steps of 128, so at the closure's W <= 128 each row
// of A is read by one block only).  Warp r loads row r of A coalesced,
// 128 words (4 a lane) in flight at once, finds the nonzero words with
// __ballot_sync and lists their set columns j < m in its own shared list
// (a warp prefix sum of the lanes' popcounts gives each lane its slots);
// bits at columns >= m are masked here.  A row with more set columns
// than a list holds (a hub, a dense or very wide A) goes on listing where
// it stopped once the list is used, so any row fits in bounded shared
// memory and registers.  Then the R rows of the lists are ORed, in one of
// two instantiations that the launcher picks from f and m:
//   ROWWISE (the closure's levels: about one set column a row).  Each
//      warp ORs the R rows of its own list into its registers, 4 words a
//      lane, 2 rows of R in flight (coalesced 128-byte segments), and
//      stores its row.  32 registers a thread, so 8 blocks (64 warps)
//      are resident on an SM and the dependent round trips of A's row,
//      then R's rows, of many rows overlap.
//   SPREAD (a hub: f rows over m >= 64 f columns, such as one row with
//      977 out-edges).  The block's threads share the set columns of all
//      8 lists: thread t keeps output word t % span and ORs every G-th
//      listed column's R word (G = 256 / span groups) into a register, 8
//      loads in flight, and into the row's accumulator in shared memory
//      once per row (atomicOr).  Where the rows are too few to fill the
//      card, a thread block cluster of up to 8 CTAs shares the columns of
//      the same 8 rows round robin, each CTA ORs its accumulators into
//      rank 0's through distributed shared memory, and rank 0 stores.
// Words past W and rows past f are masked here: the operands are not
// padded.  The result is exact (bitwise OR, in any order).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 8;            // rows of A per block, one warp each
constexpr int THREADS = 32 * ROWS;
constexpr int WORDS = 4;           // words of out per lane (ROWWISE)
constexpr int SPAN = 32 * WORDS;   // words of out per block (grid.y step)
constexpr int AHEAD = 4;           // 32-word chunks of A's row in flight
constexpr int ROW_CAP = 128;       // set columns a warp lists (ROWWISE)
constexpr int CAP = 1024;          // set columns a warp lists (SPREAD)
constexpr int JROWS = 2;           // rows of R in flight per lane (ROWWISE)
constexpr int MIN_BLOCKS = 8;      // resident blocks per SM (ROWWISE)
constexpr int LOADS = 8;           // loads of R in flight per thread (SPREAD)
constexpr int MAX_CLUSTER = 8;

// the two halves of cluster.sync(): every thread of every CTA arrives
// (release); a wait returns once all have (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Lists the set columns (< m) of one row of A, from 32-word chunk `c`
// on, skipping the first `done` set columns of chunk c, into `list`, at
// most LIST; advances (c, done) past what it listed.  Warp-uniform.
template <int LIST>
__device__ __forceinline__ int list_row(const uint32_t* __restrict__ a_row,
                                        int Wm, int m, int lane, int* list,
                                        int& c, int& done) {
  const int nch = (Wm + 31) / 32;
  int n = 0;
  while (c < nch) {
    uint32_t word[AHEAD];
#pragma unroll
    for (int q = 0; q < AHEAD; ++q) {
      const int jw = 32 * (c + q) + lane;
      word[q] = jw < Wm ? __ldg(a_row + jw) : 0u;
    }
#pragma unroll
    for (int q = 0; q < AHEAD; ++q) {
      const int cc = c + q;
      if (cc >= nch) break;
      const int col0 = 32 * (32 * cc + lane);
      uint32_t v = word[q];
      if (col0 + 32 > m) v &= col0 >= m ? 0u : (1u << (m - col0)) - 1u;
      if (__ballot_sync(FULL, v != 0u) != 0u) {
        const int cnt = __popc(v);
        int incl = cnt;                     // inclusive prefix sum
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        const int excl = incl - cnt;
        const int take = min(LIST - n, total - done);
        if (excl < done + take && excl + cnt > done) {
          uint32_t b = v;
          for (int rank = excl; b; ++rank, b &= b - 1u)
            if (rank >= done && rank < done + take)
              list[n + rank - done] = col0 + __ffs(static_cast<int>(b)) - 1;
        }
        n += take;
        done += take;
        if (done < total) {                 // the list is full
          c = cc;
          return n;
        }
      }
      done = 0;
      if (n == LIST) {
        c = cc + 1;
        return n;
      }
    }
    c += AHEAD;
  }
  return n;
}

// ROWWISE: warp r lists row r and ORs the R rows of its own list into
// its own registers, 4 words a lane, JROWS rows of R in flight
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bitset_mm_rows_kernel(const uint32_t* __restrict__ a,   // (f, Wm)
                      const uint32_t* __restrict__ r,   // (m, W)
                      uint32_t* __restrict__ out,       // (f, W)
                      int f, int Wm, int m, int W) {
  __shared__ int lists[ROWS][ROW_CAP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * ROWS + warp;
  if (i >= f) return;                       // the whole warp
  int* list = lists[warp];
  const int w0 = blockIdx.y * SPAN + lane;
  const uint32_t* a_row = a + (size_t)i * Wm;
  uint32_t acc[WORDS] = {};
  int c = 0, done = 0;
  const int nch = (Wm + 31) / 32;
  do {
    const int n = list_row<ROW_CAP>(a_row, Wm, m, lane, list, c, done);
    __syncwarp();
    for (int t = 0; t < n; t += JROWS) {
      uint32_t v[JROWS][WORDS];
#pragma unroll
      for (int u = 0; u < JROWS; ++u) {
        const int j = t + u < n ? list[t + u] : -1;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
          const int w = w0 + 32 * k;
          v[u][k] = (j >= 0 && w < W) ? __ldg(r + (size_t)j * W + w) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < JROWS; ++u)
#pragma unroll
        for (int k = 0; k < WORDS; ++k) acc[k] |= v[u][k];
    }
    __syncwarp();                           // the list is read
  } while (c < nch);
  uint32_t* o = out + (size_t)i * W;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int w = w0 + 32 * k;
    if (w < W) o[w] = acc[k];
  }
}

// SPREAD: the block's threads share the items of its 8 rows, and a
// cluster of C CTAs shares them round robin
__global__ void __launch_bounds__(THREADS)
bitset_mm_spread_kernel(const uint32_t* __restrict__ a,   // (f, Wm)
                        const uint32_t* __restrict__ r,   // (m, W)
                        uint32_t* __restrict__ out,       // (f, W)
                        int f, int Wm, int m, int W) {
  __shared__ int lists[ROWS][CAP];
  __shared__ int counts[ROWS];
  __shared__ uint32_t acc[ROWS * SPAN];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = (blockIdx.x / C) * ROWS + warp;
  const int w0 = blockIdx.y * SPAN;
  const int span = min(SPAN, W - w0);
  for (int k = tid; k < ROWS * SPAN; k += THREADS) acc[k] = 0u;
  // rank 0's accumulators are zero before any CTA ORs into them
  if (C > 1) cluster_arrive();
  const uint32_t* a_row = a + (size_t)min(i, f - 1) * Wm;
  int c = 0, done = 0;                      // where row i's listing stands
  bool more = i < f;
  for (;;) {
    const int n =
        more ? list_row<CAP>(a_row, Wm, m, lane, lists[warp], c, done) : 0;
    more = more && c < (Wm + 31) / 32;
    if (lane == 0) counts[warp] = n;
    __syncthreads();
    int off[ROWS + 1];
    off[0] = 0;
#pragma unroll
    for (int q = 0; q < ROWS; ++q) off[q + 1] = off[q] + counts[q];
    // entry e of the concatenated lists and output word w: thread tid
    // keeps word w = tid % span and takes the entries e = g, g + G, ...
    // (g = tid / span of the G groups) of this CTA's share, ORs them in
    // a register and into the row's accumulator once per row
    const int total = off[ROWS];
    const int G = THREADS / span;
    const int g = tid / span;
    const int w = tid - g * span;
    int cur_row = 0;
    uint32_t cur = 0u;
    if (g < G)
      for (int e0 = rank * G + g; e0 < total; e0 += C * G * LOADS) {
        uint32_t v[LOADS];
        int rw[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int e = e0 + u * C * G;
          rw[u] = -1;
          v[u] = 0u;
          if (e < total) {
            int row = 0, first = 0;         // e's row, its first entry
#pragma unroll
            for (int q = 1; q < ROWS; ++q)
              if (e >= off[q]) {
                row = q;
                first = off[q];
              }
            v[u] = __ldg(r + (size_t)lists[row][e - first] * W + w0 + w);
            rw[u] = row;
          }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          if (rw[u] < 0) break;
          if (rw[u] != cur_row) {           // rows only grow along e
            if (cur) atomicOr(&acc[cur_row * SPAN + w], cur);
            cur_row = rw[u];
            cur = 0u;
          }
          cur |= v[u];
        }
      }
    if (cur) atomicOr(&acc[cur_row * SPAN + w], cur);
    // every thread is done with the lists before they are refilled
    if (!__syncthreads_or(more)) break;
  }
  if (C > 1) {
    cluster_wait();                         // rank 0's zeros are in place
    if (rank != 0) {
      uint32_t* acc0 = cluster.map_shared_rank(acc, 0);
      for (int k = tid; k < ROWS * SPAN; k += THREADS)
        if (acc[k]) atomicOr(&acc0[k], acc[k]);
    }
    cluster_arrive();                       // this CTA's ORs are done
    if (rank != 0) return;
    cluster_wait();
  }
  if (i < f) {
    uint32_t* o = out + (size_t)i * W + w0;
    for (int w = lane; w < span; w += 32) o[w] = acc[warp * SPAN + w];
  }
}

}  // namespace

// Plain C entry for ctypes.  `cluster` 0 launches ROWWISE, ceil(f / 8)
// by ceil(W / 128) blocks; 1 to 8 launches SPREAD, ceil(f / 8) clusters
// of `cluster` CTAs by ceil(W / 128).  Launches on `stream`, never
// synchronises, and returns the launch's error or cudaGetLastError(), so
// a refused launch is reported to the caller.
extern "C" int bitset_mm_launch(const void* a, const void* r, void* out,
                                int f, int Wm, int m, int W, int cluster,
                                void* stream) {
  if (cluster < 0 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto a_ = static_cast<const uint32_t*>(a);
  const auto r_ = static_cast<const uint32_t*>(r);
  const auto o_ = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (f + ROWS - 1) / ROWS;
  const int cols = (W + SPAN - 1) / SPAN;
  if (cluster == 0) {
    bitset_mm_rows_kernel<<<dim3(blocks, cols), THREADS, 0, s>>>(
        a_, r_, o_, f, Wm, m, W);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * cluster, cols);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bitset_mm_spread_kernel, a_, r_, o_, f, Wm, m, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
