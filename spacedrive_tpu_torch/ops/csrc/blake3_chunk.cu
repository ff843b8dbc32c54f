// BLAKE3 chunk chaining values on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spacedrive_tpu/ops/blake3_pallas.py
// (_build_kernel / _chunk_cvs_call / chunk_cvs): every 1 KiB chunk lane
// of a hash batch compresses its blocks independently, starting from the
// IV with only its chunk counter, so one thread owns one lane.
//
// What bounds it: integer issue. One lane is up to 16 blocks x 7 rounds
// x 8 G functions of 32-bit add/xor/rotate (about 14 operations a G),
// against 1 KiB of input, so the card's INT32 lanes run out long before
// HBM does (about 45 us of issue against 18 us of reads for the
// 1024-row x 57-chunk hot bucket on an H100 SXM).
//
// Design, for that bound:
// - the 8 chaining-value words, the 16-word working state and the 16
//   message words of a block live in registers; the seven rounds are
//   fully unrolled with the message schedules as compile-time constants
//   (the permutation applied r times, blake3_pallas._schedules), so no
//   word is ever gathered at run time;
// - rotates are single funnel shifts;
// - the block loop runs only over the lane's active blocks (the Pallas
//   kernel masks all 16), which changes no output bit: an inactive
//   block leaves the chaining value as it was;
// - each block is read as four 16-byte vector loads from the natural
//   chunk-major [N, 256] layout the host packs (the counterpart of the
//   in-VMEM transpose at blake3_pallas.py:83-89). Neighbouring lanes sit
//   1 KiB apart, so a warp's load touches 32 separate 64-byte pieces;
//   every fetched sector is used, and the kernel is issue-bound anyway.
//
// Plain C interface: this file includes no PyTorch header. The binding
// (blake3_binding.cpp) checks the tensors, allocates the output, and
// checks the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kRoot = 1u << 3;

constexpr uint32_t kIV0 = 0x6A09E667u, kIV1 = 0xBB67AE85u, kIV2 = 0x3C6EF372u,
                   kIV3 = 0xA54FF53Au, kIV4 = 0x510E527Fu, kIV5 = 0x9B05688Cu,
                   kIV6 = 0x1F83D9ABu, kIV7 = 0x5BE0CD19u;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define SD_G(a, b, c, d, mx, my)       \
  do {                                 \
    v[a] = v[a] + v[b] + (mx);         \
    v[d] = rotr(v[d] ^ v[a], 16);      \
    v[c] = v[c] + v[d];                \
    v[b] = rotr(v[b] ^ v[c], 12);      \
    v[a] = v[a] + v[b] + (my);         \
    v[d] = rotr(v[d] ^ v[a], 8);       \
    v[c] = v[c] + v[d];                \
    v[b] = rotr(v[b] ^ v[c], 7);       \
  } while (0)

// One round with schedule s: slot k of the round reads message word s_k.
#define SD_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                               \
    SD_G(0, 4, 8, 12, m[s0], m[s1]);                                                 \
    SD_G(1, 5, 9, 13, m[s2], m[s3]);                                                 \
    SD_G(2, 6, 10, 14, m[s4], m[s5]);                                                \
    SD_G(3, 7, 11, 15, m[s6], m[s7]);                                                \
    SD_G(0, 5, 10, 15, m[s8], m[s9]);                                                \
    SD_G(1, 6, 11, 12, m[s10], m[s11]);                                              \
    SD_G(2, 7, 8, 13, m[s12], m[s13]);                                               \
    SD_G(3, 4, 9, 14, m[s14], m[s15]);                                               \
  } while (0)

__global__ void __launch_bounds__(64)
blake3_chunk_cvs_kernel(const uint4* __restrict__ words,  // [n, 64] = [n, 256] u32
                        const int32_t* __restrict__ chunk_len,
                        const int32_t* __restrict__ is_root,
                        const int32_t* __restrict__ t_lo,
                        uint32_t* __restrict__ out,  // [8, n]
                        int64_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const int len = chunk_len[lane];
  const int n_blocks = len <= 64 ? 1 : (len + 63) >> 6;
  const uint32_t root = is_root[lane] ? kRoot : 0u;
  const uint32_t t = static_cast<uint32_t>(t_lo[lane]);
  const uint4* row = words + lane * 64;

  uint32_t h[8] = {kIV0, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};

  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 w = __ldg(row + b * 4 + q);
      m[4 * q + 0] = w.x;
      m[4 * q + 1] = w.y;
      m[4 * q + 2] = w.z;
      m[4 * q + 3] = w.w;
    }
    const int rest = len - b * 64;
    const uint32_t block_len = static_cast<uint32_t>(rest < 0 ? 0 : (rest > 64 ? 64 : rest));
    uint32_t flags = (b == 0) ? kChunkStart : 0u;
    if (b == n_blocks - 1) flags |= kChunkEnd | root;

    uint32_t v[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                      kIV0, kIV1, kIV2, kIV3, t, 0u, block_len, flags};

    SD_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    SD_ROUND(2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8);
    SD_ROUND(3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1);
    SD_ROUND(10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6);
    SD_ROUND(12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4);
    SD_ROUND(9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7);
    SD_ROUND(11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13);

#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = v[i] ^ v[i + 8];
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * n + lane] = h[i];
}

#undef SD_ROUND
#undef SD_G

}  // namespace

// Launch on `stream`; the caller checks cudaGetLastError() right after.
// n > 0; words 16-byte aligned, every array contiguous.
void sd_blake3_chunk_cvs_launch(const void* words, const void* chunk_len,
                                const void* is_root, const void* t_lo, void* out,
                                int64_t n, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  blake3_chunk_cvs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint4*>(words), static_cast<const int32_t*>(chunk_len),
      static_cast<const int32_t*>(is_root), static_cast<const int32_t*>(t_lo),
      static_cast<uint32_t*>(out), n);
}
