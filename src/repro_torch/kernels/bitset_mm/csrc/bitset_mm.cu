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
// Design: one thread per output word (i, w).  A block is 32 x 8 threads:
// each warp owns one row i and 32 neighbouring words w, so every load of
// R is one coalesced 128-byte row segment, and the warp's loads of A's
// row are the same address for all its threads (a broadcast).  A thread
// skips a zero word of A and walks its set bits with __ffs, so the cost
// follows the set bits and not 32*Wm.  Bits at columns >= m and words
// past W or rows past f are masked here: the operands are not padded.
// Nothing carries across blocks; the result is exact (bitwise OR).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;   // words of out per warp
constexpr int ROWS = 8;    // rows of out per block (one per warp)

__global__ void __launch_bounds__(WARP * ROWS)
bitset_mm_kernel(const uint32_t* __restrict__ a,   // (f, Wm)
                 const uint32_t* __restrict__ r,   // (m, W)
                 uint32_t* __restrict__ out,       // (f, W)
                 int f, int Wm, int m, int W) {
  const int i = blockIdx.x * ROWS + threadIdx.y;
  const int w = blockIdx.y * WARP + threadIdx.x;
  if (i >= f || w >= W) return;
  const uint32_t* a_row = a + (size_t)i * Wm;
  uint32_t acc = 0u;
  for (int jw = 0; jw < Wm; ++jw) {
    uint32_t bits = __ldg(a_row + jw);
    while (bits) {
      const int j = jw * 32 + __ffs(static_cast<int>(bits)) - 1;
      bits &= bits - 1u;
      if (j < m) acc |= __ldg(r + (size_t)j * W + w);
    }
  }
  out[(size_t)i * W + w] = acc;
}

}  // namespace

// Plain C entry for ctypes: launches on `stream`, never synchronises, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int bitset_mm_launch(const void* a, const void* r, void* out,
                                int f, int Wm, int m, int W, void* stream) {
  const dim3 grid((f + ROWS - 1) / ROWS, (W + WARP - 1) / WARP);
  const dim3 block(WARP, ROWS);
  bitset_mm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(r),
      static_cast<uint32_t*>(out), f, Wm, m, W);
  return static_cast<int>(cudaGetLastError());
}
