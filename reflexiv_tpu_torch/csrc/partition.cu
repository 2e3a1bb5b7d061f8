// The two primitives of a radix partition pass: the padded run-copy
// exchange and the aligned-tile gather. Both only copy 32-bit words.
//
// rfx_padded_exchange replaces the TPU kernel
// reflexiv_tpu/partition_kernels.py:67 `_exchange_kernel_factory` (via
// `padded_exchange`). Input: `hi`, `lo` block-grouped (each `block`-sized
// chunk holds its elements grouped by an 8-bit digit), with maxrun + 1024
// words of slack appended, and `starts`, the (nb, 256) table of each
// (block b, digit d) run's start within its block. Run (b, d) is copied to
// the padded slot (d * nb + b) * slot, slot = maxrun + 1024: the copy starts
// at the run's source position rounded down to a multiple of 1024 and spans
// exactly `slot` words, so the payload lands src % 1024 into its slot and
// the slots tile the output. The 1024-word alignment is the TPU's tiling
// law, not Hopper's; it is kept because it is the layout contract that
// `compact_buckets` reads.
//
// rfx_tile_gather replaces reflexiv_tpu/partition_kernels.py:260
// `_tile_gather_kernel_factory` (via `tile_gather_probe`):
// out[t * 1024 : (t + 1) * 1024] = src[starts[t] : starts[t] + 1024] for
// 1024-aligned starts (the wrapper checks them).
//
// Bound: device-memory bytes, both. The exchange reads 2 * 4 * nb * 256 *
// slot bytes (each word of a slot once, runs overlapping only by their
// alignment heads) and writes as many; counted as the input read once and
// the padded output written once, at N = 2^24 pairs, nb = 256, maxrun =
// 1024 that is 134 MB + 1,074 MB. The tile gather moves 4 KB in and 4 KB out
// per tile (16.8 MB each way at 4096 tiles: launch-bound on an H100).
// Design: one CTA per run (resp. tile), 256 threads, each moving 16 bytes
// (uint4) per step; neighbouring threads touch neighbouring addresses on
// both sides. Every source run starts 4096-byte aligned, and a slot is
// 16-byte aligned whenever slot % 4 == 0; otherwise the exchange copies one
// word per thread per step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDigits = 256;
constexpr int64_t kTile = 1024;
constexpr unsigned kMaxGrid = 1u << 20;   // grid-stride beyond this

__device__ __forceinline__ void copy_words(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           int64_t n, bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < n / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

__global__ void padded_exchange_kernel(const uint32_t* __restrict__ hi,
                                       const uint32_t* __restrict__ lo,
                                       const int32_t* __restrict__ starts,
                                       uint32_t* __restrict__ out_hi,
                                       uint32_t* __restrict__ out_lo,
                                       int64_t nb, int64_t block,
                                       int64_t slot) {
  const bool vec = slot % 4 == 0;
  for (int64_t run = blockIdx.x; run < nb * kDigits; run += gridDim.x) {
    const int64_t b = run / kDigits;
    const int64_t d = run - b * kDigits;
    const int64_t src = b * block + starts[run];
    const int64_t src_t = (src / kTile) * kTile;
    const int64_t dst = (d * nb + b) * slot;
    copy_words(hi + src_t, out_hi + dst, slot, vec);
    copy_words(lo + src_t, out_lo + dst, slot, vec);
  }
}

__global__ void tile_gather_kernel(const uint32_t* __restrict__ src,
                                   const int32_t* __restrict__ tile_starts,
                                   uint32_t* __restrict__ out,
                                   int64_t n_tiles) {
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    copy_words(src + tile_starts[t], out + t * kTile, kTile, true);
  }
}

unsigned grid_for(int64_t n) {
  return (unsigned)(n < (int64_t)kMaxGrid ? n : (int64_t)kMaxGrid);
}

}  // namespace

// hi, lo: (nb * block + maxrun + 1024,) words; starts: (nb * 256,) int32,
// each in [0, block]; out_hi, out_lo: (256 * nb * slot,) words.
extern "C" int rfx_padded_exchange(const void* hi, const void* lo,
                                   const void* starts, void* out_hi,
                                   void* out_lo, int64_t nb, int64_t block,
                                   int64_t slot, void* stream) {
  if (nb <= 0) return 0;
  padded_exchange_kernel<<<grid_for(nb * kDigits), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)hi, (const uint32_t*)lo, (const int32_t*)starts,
      (uint32_t*)out_hi, (uint32_t*)out_lo, nb, block, slot);
  return (int)cudaGetLastError();
}

// src: words; tile_starts: (n_tiles,) int32, multiples of 1024 with
// start + 1024 <= len(src); out: (n_tiles * 1024,) words.
extern "C" int rfx_tile_gather(const void* src, const void* tile_starts,
                               void* out, int64_t n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  tile_gather_kernel<<<grid_for(n_tiles), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)src, (const int32_t*)tile_starts, (uint32_t*)out,
      n_tiles);
  return (int)cudaGetLastError();
}
