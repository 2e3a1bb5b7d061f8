// Onesweep LSD radix sort of non-negative int64 keys, or of rows of W such
// words compared word by word, ascending (after Adinets & Merrill, "Onesweep:
// A Faster Least Significant Digit Radix Sort for GPUs", 2022).
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
// every significant bit set, sorts to the tail.
//
// The pass plan comes from the caller (kernels/radix_sort.py `pass_plan`),
// one row of kPlanCols ints per 8-bit pass: (word, shift, key_src, idx_src,
// dst, flags). Passes run over the words from the last to the first, each
// word in ceil(bits / 8) passes. key_src / idx_src name the buffer (0 or 1)
// the previous pass wrote, or -1: the key is fetched from the input through
// the current index, and the index is the identity. dst names the buffer
// this pass writes; flags say whether it writes keys (kWriteKeys) and, in the
// last pass of a row sort, the whole rows (kWriteRows).
//
// Keys (W = 1): the key is its own payload; the last pass writes buffer 0.
// Rows (W = 2-4): every pass sorts (word, 32-bit index) pairs, so it moves
// 12 bytes per element each way and never the 8W-byte row. A word's first
// pass fetches its value through the index; the last pass writes the rows.
//
// One sort:
//   1. histogram: one read of the input builds every pass's 256-bin digit
//      count (block histograms in shared memory, added to global ones);
//   2. scan: one block per pass turns its counts into digit start offsets;
//   3. one onesweep kernel per pass. Each CTA takes its tile number from a
//      global counter, so every tile it waits on has started. It loads
//      kItems keys per thread (warp-striped: each warp instruction reads 256
//      contiguous bytes), ranks them STABLY in shared memory (warps in turn
//      over their items, `__match_any_sync` groups of equal digits, per-warp
//      digit counters: rank = earlier items + lower lanes), publishes its
//      per-digit counts ("aggregate") to a status array, reorders the tile in
//      shared memory by digit, and looks back over earlier tiles for its
//      exclusive prefix per digit ("prefix"). It then writes each digit's
//      run from shared memory, neighbouring threads on neighbouring
//      addresses.
// LSD radix is correct only if every pass is a stable partition: within a
// tile the rank follows the index, and across tiles the look-back prefix
// follows the tile number, which is also the position in the input.
//
// Status words are 64 bits: a flag in bit 62 (aggregate) or bit 63 (prefix)
// and a count of up to 2^31 - 1 in the low 32 bits; 0 means "not yet
// published". The count travels inside the word, so volatile loads (eight
// predecessors per step of the look-back) and relaxed stores suffice; the
// array and the tile counter are zeroed on the stream before each pass.
//
// Bound: device-memory bytes. Design traffic per element: the histogram's
// read (8W bytes), then per pass 8 bytes of key in and out (keys), or 12 in
// and 12 out (word + index), less the key writes a word's last pass skips,
// plus the final pass's row gather. The status array adds 2 KB per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kThreads = 256;            // == kRadix: one thread per digit
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = 32;           // 4 words x 8 passes
constexpr int kPlanCols = 6;
constexpr int kWriteKeys = 1;
constexpr int kWriteRows = 2;
constexpr int kHistBlocksPerSM = 4;
constexpr int kHistRows = 4;           // rows per thread per histogram step
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kCountMask = 0xFFFFFFFFull;
constexpr int kMaxSpins = 1 << 26;
constexpr int kLookBack = 8;          // status words read per look-back step

static_assert(kThreads == kRadix, "one thread per digit");

// Tile geometry of the onesweep kernel: keys alone, or (key, index) pairs.
template <bool PAIRS>
struct Tile {
  static constexpr int kItems = PAIRS ? 16 : 24;     // per thread
  static constexpr int kSize = kThreads * kItems;
  static constexpr int kKeyBytes = kSize * 8;
  static constexpr int kIdxBytes = PAIRS ? kSize * 4 : 0;
  static constexpr int kSmem = kKeyBytes + kIdxBytes + kWarps * kRadix * 4;
};

__device__ __forceinline__ unsigned digit_of(int64_t key, int shift) {
  return (unsigned)(((unsigned long long)key >> shift) & (kRadix - 1));
}

// Status words. A word carries its count itself: no other memory is
// published through it, and an aligned 64-bit store is seen whole or not at
// all. So a volatile load reads all it needs (a batch of them may be in
// flight at once), and a relaxed store at device scope is enough; a release
// store or a __threadfence() would only order memory that nobody reads
// through the flag, and costs the publishing thread a wait.
__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.volatile.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Exclusive sum of v over the block's threads (kThreads of them, all
// calling); `sums` holds kWarps words of shared scratch, free again after
// the caller's next __syncthreads.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? sums[w] : 0u;
  return before + x - v;
}

// The (word, shift) of every pass, for the histogram kernel.
struct Digits {
  int passes;
  unsigned char word[kMaxPasses];
  unsigned char shift[kMaxPasses];
};

// 1. Every pass's digit counts in one read of the (n, W) input.
template <int W>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const int64_t* __restrict__ rows, int64_t n, Digits digits,
    uint32_t* __restrict__ hist) {
  __shared__ uint32_t s_hist[kMaxPasses * kRadix];
  __shared__ int s_word[kMaxPasses];
  __shared__ int s_shift[kMaxPasses];
  const int t = threadIdx.x;
  const int passes = digits.passes;
  if (t < passes) {
    s_word[t] = digits.word[t];
    s_shift[t] = digits.shift[t];
  }
  for (int i = t; i < passes * kRadix; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  // kHistRows rows per thread per step, all loaded before their counts
  const int64_t stride = (int64_t)gridDim.x * kThreads * kHistRows;
  for (int64_t r0 = (int64_t)blockIdx.x * kThreads * kHistRows + t; r0 < n;
       r0 += stride) {
    int64_t v[kHistRows][W];
#pragma unroll
    for (int u = 0; u < kHistRows; ++u) {
      const int64_t r = r0 + u * kThreads;
#pragma unroll
      for (int c = 0; c < W; ++c) v[u][c] = r < n ? rows[r * W + c] : 0;
    }
    for (int p = 0; p < passes; ++p) {
      const int word = s_word[p];
      const int shift = s_shift[p];
#pragma unroll
      for (int u = 0; u < kHistRows; ++u) {
        int64_t x = v[u][0];
#pragma unroll
        for (int c = 1; c < W; ++c) x = word == c ? v[u][c] : x;
        if (r0 + u * kThreads < n) {
          atomicAdd(&s_hist[p * kRadix + digit_of(x, shift)], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < passes * kRadix; i += kThreads) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

// 2. One block per pass: counts -> exclusive digit start offsets, in place.
__global__ void __launch_bounds__(kThreads) scan_kernel(uint32_t* hist) {
  __shared__ uint32_t sums[kWarps];
  uint32_t* row = hist + blockIdx.x * kRadix;
  row[threadIdx.x] = block_exclusive_scan(row[threadIdx.x], sums);
}

// 3. One stable 8-bit pass over digit `shift` of the key.
//    keys_in == nullptr: key = rows[id * W + word], id the index (idx_in[i],
//    or i where idx_in == nullptr). keys_out / idx_out may be nullptr (not
//    written); rows_out != nullptr writes the whole rows instead.
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads, 2) onesweep_kernel(
    const int64_t* __restrict__ rows, int W, int word,
    const int64_t* __restrict__ keys_in, const uint32_t* __restrict__ idx_in,
    int64_t* __restrict__ keys_out, uint32_t* __restrict__ idx_out,
    int64_t* __restrict__ rows_out, int64_t n, int shift,
    const uint32_t* __restrict__ digit_start,
    unsigned long long* __restrict__ status,
    uint32_t* __restrict__ tile_counter) {
  using T = Tile<PAIRS>;
  constexpr int kItems = T::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_keys = reinterpret_cast<int64_t*>(smem);
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(smem + T::kKeyBytes);
  // [kWarps][kRadix]: digit counts per warp, then each warp's first
  // position per digit in the reordered tile
  uint32_t* s_warp =
      reinterpret_cast<uint32_t*>(smem + T::kKeyBytes + T::kIdxBytes);
  __shared__ int s_tile;
  __shared__ int s_gbase[kRadix];   // output position of tile slot 0, by digit
  __shared__ uint32_t s_sums[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w * kRadix + t] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int64_t tile_base = (int64_t)tile * T::kSize;
  const int valid = (int)(n - tile_base < T::kSize ? n - tile_base : T::kSize);

  // load: item i of this lane is tile slot first + 32 i
  const int first = warp * 32 * kItems + lane;
  int64_t key[kItems];
  uint32_t idx[PAIRS ? kItems : 1];
  if (keys_in) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int s = first + 32 * i;
      key[i] = s < valid ? keys_in[tile_base + s] : 0;
      if constexpr (PAIRS) idx[i] = s < valid ? idx_in[tile_base + s] : 0u;
    }
  } else {
    uint32_t id[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int s = first + 32 * i;
      id[i] = (uint32_t)(tile_base + s);
      if (idx_in && s < valid) id[i] = idx_in[tile_base + s];
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int s = first + 32 * i;
      key[i] = s < valid ? rows[(int64_t)id[i] * W + word] : 0;
      if constexpr (PAIRS) idx[i] = id[i];
    }
  }

  // stable rank within the warp: earlier items, then lower lanes
  uint32_t rank[kItems];
  uint32_t* my_warp = s_warp + warp * kRadix;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool ok = first + 32 * i < valid;
    // slots past the end get a digit no key has, so they join no group
    const unsigned d = ok ? digit_of(key[i], shift) : (unsigned)kRadix;
    const unsigned group = __match_any_sync(kFull, d);
    const uint32_t base = ok ? my_warp[d] : 0u;
    __syncwarp();
    rank[i] = base + __popc(group & lower);
    if (ok && (group & lower) == 0) my_warp[d] = base + __popc(group);
    __syncwarp();
  }
  __syncthreads();

  // thread t owns digit t: the tile's count, published at once
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w * kRadix + t];
    s_warp[w * kRadix + t] = count;
    count += c;
  }
  unsigned long long* my_status = status + (int64_t)tile * kRadix + t;
  store_relaxed(my_status, (tile == 0 ? kPrefix : kAggregate) | count);
  const uint32_t local_start = block_exclusive_scan(count, s_sums);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w * kRadix + t] += local_start;
  __syncthreads();

  // reorder the tile in shared memory by digit (stable)
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + 32 * i < valid) {
      const uint32_t pos = my_warp[digit_of(key[i], shift)] + rank[i];
      s_keys[pos] = key[i];
      if constexpr (PAIRS) s_idx[pos] = idx[i];
    }
  }

  // decoupled look-back for this digit's prefix over the earlier tiles,
  // kLookBack status words in flight per step: tiles j, j - 1, ... in
  // order, summing aggregates up to the first prefix; an unpublished word
  // restarts the step there
  uint32_t excl = 0;
  if (tile > 0) {
    for (int j = tile - 1, spins = 0;;) {
      unsigned long long s[kLookBack];
#pragma unroll
      for (int u = 0; u < kLookBack; ++u) {
        s[u] = j - u >= 0
                   ? load_volatile(status + (int64_t)(j - u) * kRadix + t)
                   : 0ull;
      }
      int u = 0;
      bool done = false;
#pragma unroll
      for (; u < kLookBack; ++u) {
        if (s[u] == 0) break;          // tile j - u has not published yet
        excl += (uint32_t)(s[u] & kCountMask);
        if (s[u] & kPrefix) {
          done = true;
          break;
        }
      }
      if (done) break;
      j -= u;
      // every earlier tile is running, so a wait ends in microseconds; a
      // fault that breaks that traps (a launch error) instead of hanging
      if (u == 0 && ++spins > kMaxSpins) __trap();
    }
    store_relaxed(my_status, kPrefix | (excl + count));
  }
  s_gbase[t] = (int)(digit_start[t] + excl) - (int)local_start;
  __syncthreads();

  // write each digit's run from shared memory; slot s < kSize always, so
  // the unrolled reads may all be issued before the guards resolve
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int s = t + i * kThreads;
    const int64_t k = s_keys[s];
    const int64_t g = (int64_t)s_gbase[digit_of(k, shift)] + s;
    if constexpr (PAIRS) {
      const uint32_t id = s_idx[s];
      if (s < valid) {
        if (rows_out) {
          for (int c = 0; c < W; ++c) {
            rows_out[g * W + c] = c == word ? k : rows[(int64_t)id * W + c];
          }
        } else {
          if (keys_out) keys_out[g] = k;
          idx_out[g] = id;
        }
      }
    } else {
      if (s < valid) keys_out[g] = k;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

int64_t tiles_of(int64_t n, bool pairs) {
  const int64_t size = pairs ? Tile<true>::kSize : Tile<false>::kSize;
  return (n + size - 1) / size;
}

// Steps 1 and 2 on `rows` ((n, W), W = 1 for keys).
template <int W>
int histograms(const int64_t* rows, int64_t n, const int* plan, int passes,
               uint32_t* hist, cudaStream_t s) {
  Digits digits;
  digits.passes = passes;
  for (int p = 0; p < passes; ++p) {
    digits.word[p] = (unsigned char)plan[p * kPlanCols];
    digits.shift[p] = (unsigned char)plan[p * kPlanCols + 1];
  }
  int err = (int)cudaMemsetAsync(hist, 0, sizeof(uint32_t) * passes * kRadix,
                                 s);
  if (err) return err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int64_t want = (n + kThreads * kHistRows - 1) / (kThreads * kHistRows);
  const int64_t most = (int64_t)sms * kHistBlocksPerSM;
  const int grid = (int)(want < most ? want : most);
  histogram_kernel<W><<<grid, kThreads, 0, s>>>(rows, n, digits, hist);
  err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<passes, kThreads, 0, s>>>(hist);
  return (int)cudaGetLastError();
}

// The whole sort. `plan` is the pass plan in host memory; `keys` / `idx`
// are the two ping-pong buffers of each (idx unused for keys).
template <bool PAIRS, int W>
int sort(const int64_t* rows, int64_t n, const int* plan, int passes,
         int64_t* const keys[2], uint32_t* const idx[2],
         int64_t* rows_out, uint32_t* hist, unsigned long long* status,
         cudaStream_t s) {
  if (passes < 1 || passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  int err = histograms<W>(rows, n, plan, passes, hist, s);
  if (err) return err;
  using T = Tile<PAIRS>;
  err = (int)cudaFuncSetAttribute(onesweep_kernel<PAIRS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  T::kSmem);
  if (err) return err;
  const int64_t tiles = tiles_of(n, PAIRS);
  // the tile counter sits after the status words
  uint32_t* counter = reinterpret_cast<uint32_t*>(status + tiles * kRadix);
  const size_t status_bytes =
      sizeof(unsigned long long) * (tiles * kRadix + 1);
  for (int p = 0; p < passes; ++p) {
    const int* row = plan + p * kPlanCols;
    const int word = row[0], shift = row[1], key_src = row[2];
    const int idx_src = row[3], dst = row[4], flags = row[5];
    err = (int)cudaMemsetAsync(status, 0, status_bytes, s);
    if (err) return err;
    onesweep_kernel<PAIRS><<<(unsigned)tiles, kThreads, T::kSmem, s>>>(
        rows, W, word, key_src < 0 ? nullptr : keys[key_src],
        PAIRS && idx_src >= 0 ? idx[idx_src] : nullptr,
        flags & kWriteKeys ? keys[dst] : nullptr,
        PAIRS && !(flags & kWriteRows) ? idx[dst] : nullptr,
        flags & kWriteRows ? rows_out : nullptr, n, shift,
        hist + p * kRadix, status, counter);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// Elements per onesweep tile (pairs != 0: the row sort's (key, index)
// tiles); the status scratch holds ceil(n / tile) * 256 + 1 int64.
extern "C" int rfx_radix_sort_tile(int pairs) {
  return pairs ? Tile<true>::kSize : Tile<false>::kSize;
}

// keys_in: (n,) int64, read only. plan: the pass plan, `passes` rows of
// kPlanCols int32 in host memory. buf0, buf1: (n,)
// int64; the sorted keys end in buf0. hist: passes * 256 uint32; status:
// ceil(n / rfx_radix_sort_tile(0)) * 256 + 1 int64.
extern "C" int rfx_radix_sort_keys(const void* keys_in, void* buf0, void* buf1,
                                   void* hist, void* status, int64_t n,
                                   const void* plan, int passes,
                                   void* stream) {
  if (n <= 0) return 0;
  int64_t* const keys[2] = {(int64_t*)buf0, (int64_t*)buf1};
  uint32_t* const idx[2] = {nullptr, nullptr};
  return sort<false, 1>((const int64_t*)keys_in, n, (const int*)plan,
                        passes, keys, idx, nullptr,
                        (uint32_t*)hist, (unsigned long long*)status,
                        (cudaStream_t)stream);
}

// rows_in: (n, W) int64, 2 <= W <= 4, read only. keys0/keys1: (n,) int64,
// idx0/idx1: (n,) uint32 scratch; out: (n, W) int64, the sorted rows. hist:
// passes * 256 uint32; status: ceil(n / rfx_radix_sort_tile(1)) * 256 + 1
// int64.
extern "C" int rfx_radix_sort_rows(const void* rows_in, void* keys0,
                                   void* keys1, void* idx0, void* idx1,
                                   void* out, void* hist, void* status,
                                   int64_t n, int W, const void* plan,
                                   int passes, void* stream) {
  if (n <= 0) return 0;
  int64_t* const keys[2] = {(int64_t*)keys0, (int64_t*)keys1};
  uint32_t* const idx[2] = {(uint32_t*)idx0, (uint32_t*)idx1};
  const int64_t* rows = (const int64_t*)rows_in;
  const int* p = (const int*)plan;
  uint32_t* h = (uint32_t*)hist;
  unsigned long long* st = (unsigned long long*)status;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 2:
      return sort<true, 2>(rows, n, p, passes, keys, idx, (int64_t*)out,
                           h, st, s);
    case 3:
      return sort<true, 3>(rows, n, p, passes, keys, idx, (int64_t*)out,
                           h, st, s);
    case 4:
      return sort<true, 4>(rows, n, p, passes, keys, idx, (int64_t*)out,
                           h, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
