// LSD radix sort of non-negative int64 keys, or of rows of W such words
// compared word by word, ascending.
//
// Replaces the TPU sort kernels of reflexiv_tpu/sort_kernels.py that
// `sort_pairs` / `sort_pairs_padded` run: `_local_sort_kernel` (bitonic
// rounds inside each 65,536-element VMEM block), `_merge_block_kernel_factory`
// (the in-block tail of each cross-block merge round) and their static-stride
// twins `_round_kernel_factory` / `_merge_block_kernel_static_factory`. The
// TPU had no fast scatter, so it sorted by compare-exchange networks; a GPU
// scatters, so the counting sort becomes a radix sort. The contract is
// `sort_pairs_padded`'s on one int64 key per element: keys ascending, and the
// invalid-window sentinel (1 << 2k) - 1 from the extraction kernel, which has
// every significant bit set, sorts to the tail. Only the `bits` low bits are
// sorted (keys must lie in [0, 2^bits)), in ceil(bits / 8) passes of 8 bits,
// so k = 31 takes 8 passes.
//
// Rows (k >= 32, W = ceil(k / 31) words of at most 62 bits each): the
// passes run over the words from the last to the first, each pass stable,
// and every pass moves whole rows. A full word takes 8 passes and the last
// word ceil(2 r / 8), r its base count, so k = 95 (31 + 31 + 31 + 2 bases)
// takes 8 + 8 + 8 + 1 = 25 passes. W is a template argument; W = 1 is the
// key sort above.
//
// One pass = three kernels:
//   1. histogram: per tile of kTile keys, the count of each 8-bit digit,
//      stored digit-major (counts[d * nblocks + b]);
//   2. scan: one block per digit turns its row into exclusive offsets over
//      the tiles and writes the digit's total;
//   3. scatter: each tile ranks its keys STABLY and writes each to
//      digit_start[d] + counts[d * nblocks + b] + rank.
// LSD radix is only correct if every pass is a stable partition, so the
// scatter never takes a slot with a global atomic. Within a tile, keys are
// taken in rounds of kThreads in index order; inside a warp
// `__match_any_sync` groups lanes by digit and the rank is the popcount of
// the lower lanes in the group; warps are ordered by a per-round table of
// digit counts per warp in shared memory, and rounds by a running digit
// offset. So equal digits keep index order across lanes, warps, rounds and
// (by the scan) tiles.
//
// Bound: device-memory bytes (per pass, 2 reads of the digit's word and 1
// read + 1 write of the 8W-byte row per element, plus the scattered writes'
// partial-sector waste). The tile histogram lives in shared memory; the
// scatter's writes for one digit within a warp round are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kThreads = 256;            // == kRadix: one thread per digit
constexpr int kItems = 16;               // keys per thread per tile
constexpr int kTile = kThreads * kItems; // 4096 keys per tile
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kThreads == kRadix, "scatter assigns one digit per thread");

__device__ __forceinline__ unsigned digit_of(int64_t key, int shift) {
  return (unsigned)(((unsigned long long)key >> shift) & (kRadix - 1));
}

// W: words per row; `word` is the word whose digit this pass sorts by
template <int W>
__global__ void histogram_kernel(const int64_t* __restrict__ keys, int64_t n,
                                 int word, int shift,
                                 uint32_t* __restrict__ counts, int nblocks) {
  __shared__ uint32_t hist[kRadix];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t idx = base + i;
    if (idx < n) atomicAdd(&hist[digit_of(keys[idx * W + word], shift)], 1u);
  }
  __syncthreads();
  counts[(int64_t)threadIdx.x * nblocks + blockIdx.x] = hist[threadIdx.x];
}

// One block per digit: exclusive scan of counts[d * nblocks .. + nblocks)
// in place; totals[d] = the row's sum.
__global__ void scan_kernel(uint32_t* __restrict__ counts, int nblocks,
                            uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t carry;
  uint32_t* row = counts + (int64_t)blockIdx.x * nblocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = kScanThreads / 32;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int start = 0; start < nblocks; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const uint32_t v = i < nblocks ? row[i] : 0u;
    uint32_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = lane < nwarps ? warp_sums[lane] : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
    if (i < nblocks) row[i] = carry + before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <int W>
__global__ void scatter_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out, int64_t n, int word,
                               int shift, const uint32_t* __restrict__ counts,
                               const uint32_t* __restrict__ totals,
                               int nblocks) {
  __shared__ uint32_t scan_buf[kRadix];
  __shared__ uint32_t base[kRadix];          // next output slot per digit
  __shared__ uint32_t warp_cnt[kWarps][kRadix];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // exclusive scan of the 256 digit totals (Hillis-Steele, inclusive, then
  // shift by one) -> where each digit starts in the output
  scan_buf[t] = totals[t];
  __syncthreads();
  for (int o = 1; o < kRadix; o <<= 1) {
    const uint32_t add = t >= o ? scan_buf[t - o] : 0u;
    __syncthreads();
    scan_buf[t] += add;
    __syncthreads();
  }
  const uint32_t digit_start = scan_buf[t] - totals[t];
  base[t] = digit_start + counts[(int64_t)t * nblocks + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_cnt[w][t] = 0;
  __syncthreads();

  const unsigned lower_lanes = (1u << lane) - 1u;
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  for (int round = 0; round < kItems; ++round) {
    const int64_t idx = tile + (int64_t)round * kThreads + t;
    const bool valid = idx < n;
    const int64_t key = valid ? in[idx * W + word] : 0;
    // out-of-range lanes get a digit no real key has, so they never join
    // a real key's group
    const unsigned d = valid ? digit_of(key, shift) : 0xFFFFFFFFu;
    const unsigned group = __match_any_sync(kFull, d);
    const unsigned rank = __popc(group & lower_lanes);
    if (valid && rank == 0) warp_cnt[warp][d] = __popc(group);
    __syncthreads();
    if (valid) {
      uint32_t pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][d];
      if (W == 1) {
        out[pos] = key;
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) out[(int64_t)pos * W + i] = in[idx * W + i];
      }
    }
    __syncthreads();
    // thread t owns digit t: advance its slot past this round, clear counts
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      sum += warp_cnt[w][t];
      warp_cnt[w][t] = 0;
    }
    base[t] += sum;
    __syncthreads();
  }
}

// One 8-bit pass over digit `shift` of word `word`: src -> dst.
template <int W>
int radix_pass(const int64_t* src, int64_t* dst, uint32_t* counts,
               uint32_t* totals, int64_t n, int nblocks, int word, int shift,
               cudaStream_t s) {
  histogram_kernel<W><<<nblocks, kThreads, 0, s>>>(src, n, word, shift,
                                                   counts, nblocks);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<kRadix, kScanThreads, 0, s>>>(counts, nblocks, totals);
  err = (int)cudaGetLastError();
  if (err) return err;
  scatter_kernel<W><<<nblocks, kThreads, 0, s>>>(src, dst, n, word, shift,
                                                 counts, totals, nblocks);
  return (int)cudaGetLastError();
}

// Passes over the words from the last to the first: `last_bits` bits of
// the last word, 62 of every other one. Pass p writes buf0 (p even) or
// buf1 (p odd).
template <int W>
int sort_rows(const void* keys_in, void* buf0, void* buf1, void* counts,
              void* totals, int64_t n, int last_bits, cudaStream_t s) {
  const int nblocks = (int)((n + kTile - 1) / kTile);
  const int64_t* src = (const int64_t*)keys_in;
  int p = 0;
  for (int word = W - 1; word >= 0; --word) {
    const int bits = word == W - 1 ? last_bits : 62;
    const int passes = (bits + kRadixBits - 1) / kRadixBits;
    for (int q = 0; q < passes; ++q, ++p) {
      int64_t* dst = (int64_t*)((p % 2 == 0) ? buf0 : buf1);
      const int err = radix_pass<W>(src, dst, (uint32_t*)counts,
                                    (uint32_t*)totals, n, nblocks, word,
                                    q * kRadixBits, s);
      if (err) return err;
      src = dst;
    }
  }
  return 0;
}

}  // namespace

extern "C" int rfx_radix_sort_blocks(int64_t n) {
  return (int)((n + kTile - 1) / kTile);
}

// (n, W) int64 rows, 2 <= W <= 4, sorted lexicographically over the words;
// `last_bits` significant bits in the last word, 62 in the others. The
// sorted rows end in buf[(P - 1) % 2], P the total pass count; scratch as
// for rfx_radix_sort_keys.
extern "C" int rfx_radix_sort_rows(const void* keys_in, void* buf0, void* buf1,
                                   void* counts, void* totals, int64_t n,
                                   int W, int last_bits, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 2:
      return sort_rows<2>(keys_in, buf0, buf1, counts, totals, n, last_bits, s);
    case 3:
      return sort_rows<3>(keys_in, buf0, buf1, counts, totals, n, last_bits, s);
    case 4:
      return sort_rows<4>(keys_in, buf0, buf1, counts, totals, n, last_bits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// keys_in is read only; pass p writes buf0 (p even) or buf1 (p odd), so the
// sorted keys end in buf[(passes - 1) % 2]. counts holds 256 * nblocks and
// totals 256 uint32 of scratch.
extern "C" int rfx_radix_sort_keys(const void* keys_in, void* buf0, void* buf1,
                                   void* counts, void* totals, int64_t n,
                                   int bits, void* stream) {
  if (n <= 0) return 0;
  return sort_rows<1>(keys_in, buf0, buf1, counts, totals, n, bits,
                      (cudaStream_t)stream);
}
