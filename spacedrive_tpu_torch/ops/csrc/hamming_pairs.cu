// Near pairs of 64-bit hashes on Hopper (sm_90a): one row block of
// phash_torch.near_pairs, XOR-popcount over the upper triangle, with the
// threshold and the compaction in registers.
//
// Replaces no Pallas kernel: the JAX package's near_pairs
// (spacedrive_tpu/ops/phash_jax.py) is a +-1 matrix product that it
// leaves to XLA. It was added because the port's torch-op chain for a
// block (a bf16 gram of the whole square, a bool mask, an 8-pass bit
// pack, nonzero) was 52% of a full-library duplicates pass at 2^20
// hashes, at 0.45% of the benchmark's roofline (sdbench/core/roofline.py):
// about 3 TB of device traffic a pass, to return under 1 MB of pairs.
//
// What bounds it: the POPC pipe, at 16 a clock on an SM. The kernel
// spends at least one POPC on a pair (the filter below rejects most
// pairs after the popcount of one 32-bit half; a pair it passes takes a
// second), so the bound is one a pair: N(N-1)/2 = 5.4976e11 pairs at
// N = 2^20, over 132 SMs at the card's maximum SM clock of 1,980 MHz,
// is 5.4976e11 / (132 * 16 * 1.98e9) = 0.1315 s a pass, and 1.0251 ms
// for a 2^20 library's first block (4096 rows against every later
// column, 4.2866e9 pairs), the figure chip_smoke.py prints beside the
// kernel's time. The hashes take 8 MiB at 2^20 and stay in the 50 MB L2
// all pass; ~60k pairs a pass are written. Neither memory nor the
// tensor cores come near their limits.
//
// Design, for that bound:
// - a thread keeps kRowsPerThread row hashes in registers; a thread
//   block stages kCols column hashes in shared memory with coalesced
//   16-byte loads, and every lane of a warp reads the same column (a
//   broadcast), two columns a 16-byte read;
// - a filter on half the bits: a pair's distance is at least the
//   popcount of the XOR of its first 32-bit halves, so a pair whose
//   first halves already differ in more than `threshold` bits is out
//   after one XOR and one POPC. A warp takes the second halves only when
//   one of its lanes keeps a pair (__any_sync). At threshold 8 over
//   uniform hashes a lane keeps 0.35% of pairs, so a warp goes on for
//   ~11% of its steps and issues ~1.1 POPCs a pair, near the bound.
//   The distance stays exact: every pair the filter passes is counted
//   in full;
// - the upper triangle only: row and column tiles are both kCols wide
//   and aligned, so a thread block whose columns all lie at or left of
//   its rows returns at once; the diagonal tile and the pad columns
//   past n are masked when a pair is emitted;
// - compaction in registers: a warp ballots its hits, one lane takes
//   the warp's slots with one atomicAdd on a 64-bit device counter, and
//   each hitting lane writes its pair as (i << 32) | j. No N x N gram,
//   mask or bitmap reaches device memory.
//
// Output capacity: the caller gives a buffer of 1 + capacity 64-bit
// words. Word 0 counts every pair within the threshold, those past the
// capacity included (the launcher zeroes it on the stream first); the
// first `capacity` pairs land after it, in no set order. The host reads
// the count with the pairs at the block's one sync; when the count
// passes the capacity it launches the block once more with the exact
// count as capacity, then sorts the block's pairs into row-major order
// (phash_torch.block_pairs).
//
// Plain C interface: this file includes no PyTorch header, and nvcc
// builds it alone into a shared library that ops/hamming_cuda.py loads
// with ctypes. The wrapper there checks the tensors, allocates the
// buffer, and raises when the launch returns an error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRows = kThreads * kRowsPerThread;  // rows of a thread block
constexpr int kCols = kRows;                      // columns of a thread block
constexpr unsigned kFull = 0xffffffffu;

// Appends the warp's hits: one atomicAdd a warp, then each hit in its
// lane's slot, if the slot lies inside the capacity. Every lane calls it.
__device__ __forceinline__ void emit(bool hit, int64_t i, int64_t j,
                                     unsigned long long* __restrict__ buf,
                                     unsigned long long capacity) {
  const unsigned hits = __ballot_sync(kFull, hit);
  if (hits == 0) return;
  const unsigned lane = threadIdx.x & 31u;
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(buf, static_cast<unsigned long long>(__popc(hits)));
  base = __shfl_sync(kFull, base, 0);
  if (hit) {
    const unsigned long long slot = base + __popc(hits & ((1u << lane) - 1u));
    if (slot < capacity)
      buf[1 + slot] = (static_cast<unsigned long long>(i) << 32) |
                      static_cast<unsigned long long>(j);
  }
}

// Grid: x over column tiles from `off`, y over row tiles from `off`.
// hashes holds at least ceil(n / kCols) * kCols words and every row
// tile of the grid; off is a multiple of kCols.
__global__ void __launch_bounds__(kThreads)
hamming_pairs_kernel(const uint2* __restrict__ hashes, int64_t n, int64_t off, int threshold,
                     unsigned long long* __restrict__ buf, unsigned long long capacity) {
  __shared__ uint4 cols[kCols / 2];  // two column hashes a 16-byte word
  const int64_t r0 = off + static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t c0 = off + static_cast<int64_t>(blockIdx.x) * kCols;
  if (c0 < r0) return;  // aligned tiles: every column at or left of every row

  const uint4* src = reinterpret_cast<const uint4*>(hashes + c0);
  for (int k = threadIdx.x; k < kCols / 2; k += kThreads) cols[k] = src[k];
  uint32_t ax[kRowsPerThread], ay[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const uint2 a = hashes[r0 + threadIdx.x + r * kThreads];
    ax[r] = a.x;
    ay[r] = a.y;
  }
  __syncthreads();

  const int64_t left = n - c0;
  const int words = static_cast<int>(((left < kCols ? left : kCols) + 1) / 2);
  for (int w = 0; w < words; ++w) {
    const uint4 b = cols[w];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t bx = half ? b.z : b.x;
      const uint32_t by = half ? b.w : b.y;
      const int64_t j = c0 + 2 * w + half;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int h = __popc(ax[r] ^ bx);
        if (__any_sync(kFull, h <= threshold)) {
          const int64_t i = r0 + threadIdx.x + r * kThreads;
          emit(h + __popc(ay[r] ^ by) <= threshold && i < j && j < n, i, j, buf, capacity);
        }
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t) on the calling thread's current
// device: zero the count, then search rows [off, off + rows) against the
// columns after each row, up to n. Returns the first CUDA error of the
// two (0: both were queued). Preconditions, checked by the wrapper:
// 0 <= off < n; off and rows multiples of kCols; hashes 16-byte aligned,
// holding at least off + rows and ceil(n / kCols) * kCols words;
// buf holds 1 + capacity words.
extern "C" int sd_hamming_pairs(const void* hashes, int64_t n, int64_t off, int64_t rows,
                                int threshold, void* buf, int64_t capacity, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(buf, 0, sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const int64_t live = rows < n - off ? rows : n - off;
  const dim3 grid(static_cast<unsigned int>((n - off + kCols - 1) / kCols),
                  static_cast<unsigned int>((live + kRows - 1) / kRows));
  hamming_pairs_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint2*>(hashes), n, off, threshold,
      static_cast<unsigned long long*>(buf), static_cast<unsigned long long>(capacity));
  return static_cast<int>(cudaGetLastError());
}
