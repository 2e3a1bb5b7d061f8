// Onesweep LSD radix sort of non-negative int64 keys (after Adinets &
// Merrill, "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs",
// 2022), and a sort of rows of W such words compared word by word, ascending,
// built on it: one onesweep over the leading word, then a tie pass inside
// the runs of equal leading words.
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
// Pass plans come from the caller (kernels/radix_sort.py `pass_plan` and
// `lead_plan`), one row of kPlanCols ints per 8-bit pass: (word, shift,
// key_src, idx_src, dst, flags). key_src / idx_src name the buffer (0 or 1)
// the previous pass wrote, or -1: the key is fetched from the input through
// the current index, and the index is the identity (or the caller's list of
// row ids). dst names the buffer this pass writes; flags say whether it
// writes keys (kWriteKeys) and, in the last pass of a row plan, the whole
// rows (kWriteRows).
//
// Keys (W = 1): the key is its own payload; the last pass writes buffer 0.
//
// Rows (W = 2-4), in four steps:
//   1. lead: the onesweep over (word 0, 32-bit index) pairs, 8 passes of the
//      62-bit leading word (`lead_plan`); keys and index end in buffer 0.
//      Word 0 holds the first 31 bases of a canonical window, so rows that
//      share it form short runs, most of them copies of one k-mer.
//   2. runs: the tie kernel's warps mark where word 0 changes (each warp
//      sees 128 positions around its 32) and list the starts of the runs of
//      more than kWarpCap rows; for the rows of those runs they set a bit
//      where the row differs from its predecessor.
//   3. ties: a warp sorts the runs of at most kWarpCap rows that start in its
//      32 positions (at most 63 rows, one or two a lane) by words 1..W-1 in
//      registers: a bitonic network over (run, words), 64-bit words through
//      two 32-bit shuffles. A CTA takes each listed run: a run whose
//      difference bits are all clear (identical rows: the poly-T sentinel
//      tail, a high-coverage k-mer) is written straight out; a run of at
//      most kCtaCap rows is sorted in shared memory, a bitonic network over
//      its words 1..W-1 that moves word 1 (and a 16-bit slot for the
//      others); a longer run goes to step 4.
//   4. oversized runs (more than kCtaCap rows): the host reads their list
//      (one wait per sort, for the counts), writes identical ones straight
//      out, and runs the full row plan (`pass_plan`, 8 passes a word) on
//      the compacted row ids of the mixed ones only. Those runs are disjoint
//      and ascending in word 0, so the plan's sorted rows fill their output
//      slots in position order; the last pass maps each to its slot.
//   Every row is written once, by the step that owns its run. After step 1
//   a row of a short run is read once; a row of a longer run once more,
//   for its difference bit.
//
// Onesweep, one sort:
//   a. histogram: one read of the input builds every pass's 256-bin digit
//      count (block histograms in shared memory, added to global ones);
//   b. scan: one block per pass turns its counts into digit start offsets;
//   c. one onesweep kernel per pass. Each CTA takes its tile number from a
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
// follows the tile number, which is also the position in the input. Step 3
// needs only that each run of word 0 is contiguous after step 1; the order
// among identical rows cannot be seen.
//
// Status words are 64 bits: a flag in bit 62 (aggregate) or bit 63 (prefix)
// and a count of up to 2^31 - 1 in the low 32 bits; 0 means "not yet
// published". The count travels inside the word, so volatile loads (eight
// predecessors per step of the look-back) and relaxed stores suffice; the
// array and the tile counter are zeroed on the stream before each pass.
//
// Bound: device-memory bytes. Design traffic per element: keys, the
// histogram's read and per pass 8 bytes of key in and out. Rows: word 0 read
// by the histogram and by the first pass (8 + 8 bytes), 12 bytes out of the
// first pass and 12 in and 12 out of each of the other seven, then the tie
// pass's 8 bytes of word 0 and 4 of index, the row's other words (8 (W - 1)
// bytes) and the written row (8 W bytes): 232 bytes a row at W = 2 against
// 400 for 8 passes a word. Oversized mixed runs add the row plan's traffic
// on their rows. The status array adds 2 KB per tile.
//
// Scratch (the caller's): two key buffers, two index buffers, the digit
// tables and the status words, all sized for the whole input. After step 1
// the second key buffer holds the difference bits, the long-run starts and
// the oversized-run list, and the status words the two run counters; step 4
// puts its run tables in the first key buffer, its row ids in the second
// index buffer, and runs the row plan in the same four buffers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

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

// Tie pass. A warp sorts runs of up to kWarpCap rows (the warp's width). A
// CTA sorts a run of up to kCtaCap rows in shared memory: (W - 1) words a
// row and, for W > 2, a 16-bit slot (kCtaCap is a power of two, the
// network's largest size):
//   8192 rows x (3 words x 8 B + 2 B) = 212,992 B at W = 4,
// within the 232,448 B (227 KB) a block may take of an H100 SM's 228 KB;
// twice the rows would need 425,984 B. radix_sort.WARP_CAP and CTA_CAP
// repeat both caps (rfx_radix_sort_tie_cap).
constexpr int kWarpCap = 32;
constexpr int kTieWarps = 8;          // warps per CTA of the warp tie kernel
constexpr int kCtaThreads = 512;
constexpr int kCtaCap = 8192;
constexpr int kBlockSmemMax = 232448;
constexpr uint32_t kNoRun = 0xFFFFFFFFu;

static_assert(kThreads == kRadix, "one thread per digit");
static_assert(kCtaCap * (3 * 8 + 2) <= kBlockSmemMax, "cap fits a block");
static_assert(kCtaCap <= 0xFFFF, "slots are 16-bit");
static_assert((kCtaCap & (kCtaCap - 1)) == 0 && kCtaCap > 2 * kWarpCap,
              "the network pads a run to a power of two up to kCtaCap");

// Shared memory of the CTA tie kernel at W words a row.
constexpr int cta_smem(int W) {
  return (int)(sizeof(uint64_t) * (W - 1) * kCtaCap +
               (W > 2 ? sizeof(uint16_t) * kCtaCap : 0));
}

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

// Run table lookup (step 4): `table` holds runs + 1 pairs (start, offset),
// offsets ascending from 0; element j of the flattened runs lies in the
// last run whose offset is <= j, at that run's start + j - offset.
__device__ __forceinline__ int run_of(const uint32_t* table, int runs,
                                      int64_t j) {
  int lo = 0, hi = runs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)table[2 * mid + 1] <= j) lo = mid;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t run_position(const uint32_t* table,
                                                int runs, int64_t j) {
  const int r = run_of(table, runs, j);
  return (int64_t)table[2 * r] + j - (int64_t)table[2 * r + 1];
}

// The (word, shift) of every pass, for the histogram kernel.
struct Digits {
  int passes;
  int words;                     // leading words any pass reads
  unsigned char word[kMaxPasses];
  unsigned char shift[kMaxPasses];
};

// a. Every pass's digit counts in one read of the (n, W) input (row r, or
//    row ids[r] where ids is given).
template <int W>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const int64_t* __restrict__ rows, const uint32_t* __restrict__ ids,
    int64_t n, Digits digits, uint32_t* __restrict__ hist) {
  __shared__ uint32_t s_hist[kMaxPasses * kRadix];
  __shared__ int s_word[kMaxPasses];
  __shared__ int s_shift[kMaxPasses];
  const int t = threadIdx.x;
  const int passes = digits.passes;
  const int words = digits.words;
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
      const int64_t row = r < n ? (ids ? (int64_t)ids[r] : r) : 0;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        v[u][c] = r < n && c < words ? rows[row * W + c] : 0;
      }
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

// b. One block per pass: counts -> exclusive digit start offsets, in place.
__global__ void __launch_bounds__(kThreads) scan_kernel(uint32_t* hist) {
  __shared__ uint32_t sums[kWarps];
  uint32_t* row = hist + blockIdx.x * kRadix;
  row[threadIdx.x] = block_exclusive_scan(row[threadIdx.x], sums);
}

// c. One stable 8-bit pass over digit `shift` of the key.
//    keys_in == nullptr: key = rows[id * W + word], id the index (idx_in[i],
//    or i where idx_in == nullptr). keys_out / idx_out may be nullptr (not
//    written); rows_out != nullptr writes the whole rows instead, element g
//    to row g, or to run_position(out_map, map_runs, g) where out_map is
//    given.
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads, 2) onesweep_kernel(
    const int64_t* __restrict__ rows, int W, int word,
    const int64_t* __restrict__ keys_in, const uint32_t* __restrict__ idx_in,
    int64_t* __restrict__ keys_out, uint32_t* __restrict__ idx_out,
    int64_t* __restrict__ rows_out, const uint32_t* __restrict__ out_map,
    int map_runs, int64_t n, int shift,
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
          const int64_t dst = out_map ? run_position(out_map, map_runs, g) : g;
          for (int c = 0; c < W; ++c) {
            rows_out[dst * W + c] = c == word ? k : rows[(int64_t)id * W + c];
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

// ---- the tie pass (steps 2 and 3) ----

// Head flags of 128 positions, bit i for position base - 32 + i: set where
// word 0 differs from the position before (or at 0, and at n and beyond).
struct Heads {
  unsigned long long lo, hi;

  // highest set bit <= i (0 <= i < 128), or -1
  __device__ __forceinline__ int prev(int i) const {
    if (i >= 64) {
      const unsigned long long m = hi & ((2ull << (i - 64)) - 1);
      if (m) return 127 - __clzll(m);
      return lo ? 63 - __clzll(lo) : -1;
    }
    const unsigned long long m = lo & ((2ull << i) - 1);
    return m ? 63 - __clzll(m) : -1;
  }

  // lowest set bit > i (0 <= i < 128), or 128
  __device__ __forceinline__ int next(int i) const {
    if (i < 63) {
      const unsigned long long m = lo & ~((2ull << i) - 1);
      if (m) return __ffsll(m) - 1;
      return hi ? 63 + __ffsll(hi) : 128;
    }
    const unsigned long long m =
        i == 63 ? hi : hi & ~((2ull << (i - 64)) - 1);
    return m ? 63 + __ffsll(m) : 128;
  }
};

// Row order on (run tag, words 1..W-1): a before b?
template <int W>
__device__ __forceinline__ bool tie_less(uint32_t ta, const uint64_t* a,
                                         uint32_t tb, const uint64_t* b) {
  if (ta != tb) return ta < tb;
#pragma unroll
  for (int c = 0; c < W - 1; ++c) {
    if (a[c] != b[c]) return a[c] < b[c];
  }
  return false;
}

// Bitonic network over the warp's 32 R elements, element e = 32 r + lane:
// (tag, words) ascending. Equal elements are identical rows, so which one
// a lane keeps cannot be seen. (Two comparisons a step, one each way, cost
// 0.9-1.3 ms more at k = 61-81 on an H100: scripts/sort_rows_forms.py.)
template <int W, int R>
__device__ __forceinline__ void warp_bitonic(uint32_t (&tag)[R],
                                             uint64_t (&tl)[R][W - 1]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {                 // R == 2, k == 64: e against e + 32
        if constexpr (R == 2) {
          if (tie_less<W>(tag[1], tl[1], tag[0], tl[0])) {
            const uint32_t x = tag[0];
            tag[0] = tag[1];
            tag[1] = x;
#pragma unroll
            for (int c = 0; c < W - 1; ++c) {
              const uint64_t y = tl[0][c];
              tl[0][c] = tl[1][c];
              tl[1][c] = y;
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = 32 * r + lane;
        const uint32_t ptag = __shfl_xor_sync(kFull, tag[r], j);
        uint64_t pt[W - 1];
#pragma unroll
        for (int c = 0; c < W - 1; ++c) {
          pt[c] = __shfl_xor_sync(kFull, (unsigned long long)tl[r][c], j);
        }
        // the lower element of an ascending pair keeps the smaller: it
        // takes the partner unless it is smaller itself (on a tie either
        // is right), and the upper one takes it only if it is smaller
        // itself; one comparison
        const bool keep_min = ((e & k) == 0) == ((e & j) == 0);
        const bool take =
            keep_min != tie_less<W>(tag[r], tl[r], ptag, pt);
        if (take) {
          tag[r] = ptag;
#pragma unroll
          for (int c = 0; c < W - 1; ++c) tl[r][c] = pt[c];
        }
      }
    }
  }
}

// The warp's own runs: slots a .. a + span - 1 of its view (slot t is
// position base + t), R elements a lane. Gathers words 1..W-1 of each row,
// sorts, and writes the rows. (Testing first whether the rows are already
// in order saved no time on an H100: scripts/sort_rows_forms.py.)
template <int W, int R>
__device__ __forceinline__ void warp_ties(
    const int64_t* __restrict__ rows, const int64_t* __restrict__ keys,
    const uint32_t* __restrict__ idx, int64_t base, int a, int span,
    const Heads& heads, int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  uint32_t tag[R];
  uint64_t tl[R][W - 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    tag[r] = kNoRun;
#pragma unroll
    for (int c = 0; c < W - 1; ++c) tl[r][c] = ~0ull;
    if (e < span) {
      const int slot = a + e;
      tag[r] = (uint32_t)heads.prev(slot + 32);   // its run's first slot
      const int64_t id = idx[base + slot];
#pragma unroll
      for (int c = 0; c < W - 1; ++c) tl[r][c] = rows[id * W + 1 + c];
    }
  }
  warp_bitonic<W, R>(tag, tl);
  // sorted element e goes to slot a + e; word 0 is the run's own
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = 32 * r + lane;
    if (e < span) {
      const int64_t pos = base + a + e;
      out[pos * W] = keys[pos];
#pragma unroll
      for (int c = 0; c < W - 1; ++c) out[pos * W + 1 + c] = (int64_t)tl[r][c];
    }
  }
}

// Steps 2 and 3 for runs of at most kWarpCap rows. Warp w owns positions
// base = 32 w .. base + 31 as run starts, and sees base - 32 .. base + 95.
// It sorts and writes the runs that start in its 32 positions and hold at
// most kWarpCap rows (their rows lie in base .. base + 62). Of its starts,
// only the last can begin a longer run: that start goes to `long_starts`.
// For its positions in longer runs it writes bit t of diff[w]: the row
// differs from its predecessor in the same run.
template <int W>
__global__ void __launch_bounds__(kTieWarps * 32) tie_warp_kernel(
    const int64_t* __restrict__ rows, const int64_t* __restrict__ keys,
    const uint32_t* __restrict__ idx, int64_t n, int64_t* __restrict__ out,
    uint32_t* __restrict__ diff, uint32_t* __restrict__ long_starts,
    uint32_t* __restrict__ counters) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kTieWarps + (threadIdx.x >> 5);
  const int64_t base = 32 * w;
  if (base >= n) return;                       // warp-uniform
  unsigned hm[4];
  int64_t before = 0;                          // word 0 at the chunk's start - 1
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int64_t p = base - 32 + 32 * c + lane;
    const int64_t x = p >= 0 && p < n ? keys[p] : 0;
    int64_t up = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) up = before;
    before = __shfl_sync(kFull, x, 31);
    // chunk 0's lane 0 (base - 32) is never asked for: a run's start is
    // looked for at most 31 positions back
    const bool h = p >= n || p == 0 || (p > 0 && (c > 0 || lane > 0) &&
                                        x != up);
    hm[c] = __ballot_sync(kFull, h);
  }
  const Heads heads{hm[0] | ((unsigned long long)hm[1] << 32),
                    hm[2] | ((unsigned long long)hm[3] << 32)};

  // difference bits of this warp's positions in runs longer than kWarpCap
  const int64_t p = base + lane;
  bool in_long = false;
  if (p < n) {
    const int start = heads.prev(lane + 32);
    in_long = start < lane + 1 ||
              heads.next(lane + 32) - start > kWarpCap;
  }
  const bool is_head = (hm[1] >> lane) & 1u;
  uint64_t mine[W - 1];
#pragma unroll
  for (int c = 0; c < W - 1; ++c) mine[c] = 0;
  if (in_long) {
    const int64_t id = idx[p];
#pragma unroll
    for (int c = 0; c < W - 1; ++c) mine[c] = rows[id * W + 1 + c];
  }
  uint64_t pred[W - 1];
#pragma unroll
  for (int c = 0; c < W - 1; ++c) {
    pred[c] = __shfl_up_sync(kFull, (unsigned long long)mine[c], 1);
  }
  if (lane == 0 && in_long && !is_head) {      // base - 1, the same run
    const int64_t id = idx[base - 1];
#pragma unroll
    for (int c = 0; c < W - 1; ++c) pred[c] = rows[id * W + 1 + c];
  }
  bool differs = false;
  if (in_long && !is_head) {
#pragma unroll
    for (int c = 0; c < W - 1; ++c) differs |= mine[c] != pred[c];
  }
  const unsigned bits = __ballot_sync(kFull, differs);
  if (lane == 0) diff[w] = bits;

  // the runs starting here (positions n and beyond are heads, not
  // starts): all but the last are short; the last is short when the next
  // head comes within kWarpCap rows
  const unsigned starts =
      hm[1] & (n - base >= 32 ? kFull : (1u << (n - base)) - 1u);
  if (starts == 0) return;                     // warp-uniform
  const int a = __ffs(starts) - 1;
  const int last = 31 - __clz(starts);
  const int after = heads.next(last + 32) - 32;
  int b = after;
  if (after - last > kWarpCap) {
    b = last;
    if (lane == 0) {
      long_starts[atomicAdd(&counters[0], 1u)] = (uint32_t)(base + last);
    }
  }
  const int span = b - a;
  if (span > 32) {
    warp_ties<W, 2>(rows, keys, idx, base, a, span, heads, out);
  } else if (span > 0) {
    warp_ties<W, 1>(rows, keys, idx, base, a, span, heads, out);
  }
}

// First position after the run that starts at s, of more than kWarpCap
// rows, found by one warp (every lane calling): rounds of 32 probes of the
// sorted word 0 at a stride that grows 32-fold while every probe is in the
// run, then shrinks 32-fold inside the stride that holds the end. A round
// is one load a lane; keys[s + kWarpCap] is in the run.
__device__ int64_t run_end(const int64_t* __restrict__ keys, int64_t n,
                           int64_t s, int64_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = s + kWarpCap;            // in the run
  int64_t stride = 1;
  bool grow = true;
  for (;;) {
    const int64_t p = lo + stride * (lane + 1);
    const unsigned past = __ballot_sync(kFull, p >= n || keys[p] != key);
    if (past == 0) {                    // all 32 probes in the run
      lo += 32 * stride;
      if (grow) stride *= 32;
      continue;
    }
    grow = false;
    lo += stride * (__ffs(past) - 1);   // the last probe in the run
    if (stride == 1) return lo + 1;
    stride /= 32;
  }
}

// Order of elements x and y of the CTA network. Element q holds its row's
// word 1 at w1[q] and, for W > 2, the slot its row was loaded into, whose
// words 2..W-1 stay there: word c + 2 at rest[c * kCtaCap + slot[q]]. The
// network moves word 1 and the slot; it reads the other words only where
// words 1 are equal.
template <int W>
__device__ __forceinline__ bool elem_less(const uint64_t* w1,
                                          const uint16_t* slot,
                                          const uint64_t* rest, int x, int y) {
  const uint64_t a = w1[x], b = w1[y];
  if (W == 2 || a != b) return a < b;
  const int sx = slot[x], sy = slot[y];
#pragma unroll
  for (int c = 0; c < W - 2; ++c) {
    const uint64_t u = rest[c * kCtaCap + sx], v = rest[c * kCtaCap + sy];
    if (u != v) return u < v;
  }
  return false;
}

// Step 3 for the runs of more than kWarpCap rows, one run per CTA at a
// time: identical rows are written straight out; a run of at most kCtaCap
// rows is sorted in shared memory by a bitonic network over its words
// 1..W-1 (elem_less), padded to a power of two with rows of all-ones words
// (they sort after every row, and a row equal to them is the same words);
// a longer one is listed for step 4 as (start, length, mixed).
template <int W>
__global__ void __launch_bounds__(kCtaThreads) tie_cta_kernel(
    const int64_t* __restrict__ rows, const int64_t* __restrict__ keys,
    const uint32_t* __restrict__ idx, int64_t n,
    const uint32_t* __restrict__ diff,
    const uint32_t* __restrict__ long_starts, uint32_t* __restrict__ counters,
    uint32_t* __restrict__ oversized, int64_t* __restrict__ out) {
  // [kCtaCap] words 1, [W - 2][kCtaCap] words 2.., [kCtaCap] slots (W > 2)
  extern __shared__ __align__(16) uint64_t s_w1[];
  uint64_t* s_rest = s_w1 + kCtaCap;
  uint16_t* s_slot = reinterpret_cast<uint16_t*>(s_rest + (W - 2) * kCtaCap);
  __shared__ int64_t s_end;
  const int t = threadIdx.x;
  const uint32_t runs = counters[0];
  for (uint32_t i = blockIdx.x; i < runs; i += gridDim.x) {
    const int64_t s = long_starts[i];
    const int64_t key = keys[s];
    if (t < 32) {
      const int64_t e = run_end(keys, n, s, key);
      if (t == 0) s_end = e;
    }
    __syncthreads();
    const int64_t e = s_end;
    const int64_t len = e - s;
    // any difference bit in s + 1 .. e - 1?
    bool mixed = false;
    for (int64_t wi = (s + 1) / 32 + t; wi <= (e - 1) / 32;
         wi += kCtaThreads) {
      unsigned m = diff[wi];
      const int64_t lo = 32 * wi;
      if (lo < s + 1) m &= kFull << (s + 1 - lo);
      if (e - lo < 32) m &= (1u << (e - lo)) - 1u;
      mixed |= m != 0;
    }
    mixed = __syncthreads_or(mixed);
    if (len > kCtaCap) {
      if (t == 0) {
        const uint32_t j = atomicAdd(&counters[1], 1u);
        oversized[3 * j] = (uint32_t)s;
        oversized[3 * j + 1] = (uint32_t)len;
        oversized[3 * j + 2] = mixed;
      }
      continue;
    }
    if (!mixed) {
      const int64_t* src = rows + (int64_t)idx[s] * W;
      for (int64_t q = s + t; q < e; q += kCtaThreads) {
#pragma unroll
        for (int c = 0; c < W; ++c) out[q * W + c] = src[c];
      }
      continue;
    }
    const int m = (int)len;
    int size = 2 * kWarpCap;
    while (size < m) size *= 2;
    for (int q = t; q < size; q += kCtaThreads) {
      const int64_t* src = rows + (int64_t)idx[s + (q < m ? q : 0)] * W;
      s_w1[q] = q < m ? (uint64_t)src[1] : ~0ull;
      if constexpr (W > 2) {
        s_slot[q] = (uint16_t)q;
#pragma unroll
        for (int c = 0; c < W - 2; ++c) {
          s_rest[c * kCtaCap + q] = q < m ? (uint64_t)src[2 + c] : ~0ull;
        }
      }
    }
    __syncthreads();
    for (int k = 2; k <= size; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = t; q < size / 2; q += kCtaThreads) {
          const int lo = 2 * q - (q & (j - 1)), hi = lo + j;
          if ((lo & k) == 0 ? elem_less<W>(s_w1, s_slot, s_rest, hi, lo)
                            : elem_less<W>(s_w1, s_slot, s_rest, lo, hi)) {
            const uint64_t x = s_w1[lo];
            s_w1[lo] = s_w1[hi];
            s_w1[hi] = x;
            if constexpr (W > 2) {
              const uint16_t y = s_slot[lo];
              s_slot[lo] = s_slot[hi];
              s_slot[hi] = y;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int q = t; q < m; q += kCtaThreads) {
      out[(s + q) * W] = key;
      out[(s + q) * W + 1] = (int64_t)s_w1[q];
      if constexpr (W > 2) {
        const int sl = s_slot[q];
#pragma unroll
        for (int c = 0; c < W - 2; ++c) {
          out[(s + q) * W + 2 + c] = (int64_t)s_rest[c * kCtaCap + sl];
        }
      }
    }
    __syncthreads();                 // the next run reuses shared memory
  }
}

// Step 4: identical oversized runs, every row the run's first.
template <int W>
__global__ void fill_kernel(const int64_t* __restrict__ rows,
                            const uint32_t* __restrict__ idx,
                            const uint32_t* __restrict__ table, int runs,
                            int64_t total, int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    const int r = run_of(table, runs, j);
    const int64_t p = (int64_t)table[2 * r] + j - (int64_t)table[2 * r + 1];
    const int64_t* first = rows + (int64_t)idx[table[2 * r]] * W;
#pragma unroll
    for (int c = 0; c < W; ++c) out[p * W + c] = first[c];
  }
}

// Step 4: the row ids of the mixed oversized runs, in position order.
__global__ void compact_kernel(const uint32_t* __restrict__ idx,
                               const uint32_t* __restrict__ table, int runs,
                               int64_t total, uint32_t* __restrict__ ids) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    ids[j] = idx[run_position(table, runs, j)];
  }
}

// ---- host side ----

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

// a grid of at most `want` blocks, no more than `per_sm` on each SM
int grid_of(int64_t want, int per_sm) {
  const int64_t most = (int64_t)sm_count() * per_sm;
  return (int)std::max<int64_t>(1, std::min(want, most));
}

// Steps a and b on `rows` ((n, W), W = 1 for keys; row ids[r] where given).
template <int W>
int histograms(const int64_t* rows, const uint32_t* ids, int64_t n,
               const int* plan, int passes, uint32_t* hist, cudaStream_t s) {
  Digits digits;
  digits.passes = passes;
  digits.words = 1;
  for (int p = 0; p < passes; ++p) {
    digits.word[p] = (unsigned char)plan[p * kPlanCols];
    digits.shift[p] = (unsigned char)plan[p * kPlanCols + 1];
    digits.words = std::max(digits.words, (int)digits.word[p] + 1);
  }
  int err = (int)cudaMemsetAsync(hist, 0, sizeof(uint32_t) * passes * kRadix,
                                 s);
  if (err) return err;
  if (sm_count() <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = grid_of(
      (n + kThreads * kHistRows - 1) / (kThreads * kHistRows),
      kHistBlocksPerSM);
  histogram_kernel<W><<<grid, kThreads, 0, s>>>(rows, ids, n, digits, hist);
  err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<passes, kThreads, 0, s>>>(hist);
  return (int)cudaGetLastError();
}

// A whole onesweep sort by `plan` (in host memory) of n elements; `keys` /
// `idx` are the two ping-pong buffers of each (idx unused for keys). The
// first pass fetches keys through `ids` (row ids) where given. A pass that
// writes rows writes them to `rows_out`, through the run table `out_map`
// (in host memory, map_runs + 1 pairs) where given: it is copied to
// keys[0], which the last pass does not read.
template <bool PAIRS, int W>
int run_plan(const int64_t* rows, const uint32_t* ids, int64_t n,
             const int* plan, int passes, int64_t* const keys[2],
             uint32_t* const idx[2], int64_t* rows_out,
             const std::vector<uint32_t>* out_map, uint32_t* hist,
             unsigned long long* status, cudaStream_t s) {
  if (passes < 1 || passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  int err = histograms<W>(rows, ids, n, plan, passes, hist, s);
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
    const uint32_t* map = nullptr;
    int map_runs = 0;
    if ((flags & kWriteRows) && out_map) {
      if (key_src != 1) return (int)cudaErrorInvalidValue;
      err = (int)cudaMemcpyAsync(keys[0], out_map->data(),
                                 sizeof(uint32_t) * out_map->size(),
                                 cudaMemcpyHostToDevice, s);
      if (err) return err;
      map = reinterpret_cast<const uint32_t*>(keys[0]);
      map_runs = (int)(out_map->size() / 2) - 1;
    }
    err = (int)cudaMemsetAsync(status, 0, status_bytes, s);
    if (err) return err;
    onesweep_kernel<PAIRS><<<(unsigned)tiles, kThreads, T::kSmem, s>>>(
        rows, W, word, key_src < 0 ? nullptr : keys[key_src],
        PAIRS ? (idx_src >= 0 ? idx[idx_src] : ids) : nullptr,
        flags & kWriteKeys ? keys[dst] : nullptr,
        PAIRS && !(flags & kWriteRows) ? idx[dst] : nullptr,
        flags & kWriteRows ? rows_out : nullptr, map, map_runs, n, shift,
        hist + p * kRadix, status, counter);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// (start, offset) pairs of `runs` ((start, length) each) and the closing
// (0, total) pair.
std::vector<uint32_t> run_table(const std::vector<uint32_t>& runs,
                                int64_t* total) {
  std::vector<uint32_t> table;
  int64_t off = 0;
  for (size_t r = 0; r < runs.size(); r += 2) {
    table.push_back(runs[r]);
    table.push_back((uint32_t)off);
    off += runs[r + 1];
  }
  table.push_back(0);
  table.push_back((uint32_t)off);
  *total = off;
  return table;
}

// The row sort, steps 1-4 (see the header).
template <int W>
int sort_rows(const int64_t* rows, int64_t n, const int* lead, int lead_passes,
              const int* plan, int passes, int64_t* const keys[2],
              uint32_t* const idx[2], int64_t* out, uint32_t* hist,
              unsigned long long* status, cudaStream_t s) {
  if (lead_passes < 1 || lead[(lead_passes - 1) * kPlanCols + 4] != 0 ||
      !(lead[(lead_passes - 1) * kPlanCols + 5] & kWriteKeys))
    return (int)cudaErrorInvalidValue;
  // 1. word 0 and the order: keys[0], idx[0]
  int err = run_plan<true, W>(rows, nullptr, n, lead, lead_passes, keys, idx,
                              nullptr, nullptr, hist, status, s);
  if (err) return err;
  const int64_t* k0 = keys[0];
  const uint32_t* i0 = idx[0];
  // 2-3. keys[1] holds the difference bits, then the long-run starts (at
  // most n / 33), then the oversized-run list (at most n / (kCtaCap + 1)
  // triples); status the two counters
  const int64_t windows = (n + 31) / 32;
  uint32_t* diff = reinterpret_cast<uint32_t*>(keys[1]);
  uint32_t* long_starts = diff + windows;
  uint32_t* oversized = long_starts + n / (kWarpCap + 1);
  uint32_t* counters = reinterpret_cast<uint32_t*>(status);
  err = (int)cudaMemsetAsync(counters, 0, 2 * sizeof(uint32_t), s);
  if (err) return err;
  tie_warp_kernel<W>
      <<<(unsigned)((windows + kTieWarps - 1) / kTieWarps), kTieWarps * 32, 0,
         s>>>(rows, k0, i0, n, out, diff, long_starts, counters);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = cta_smem(W);
  err = (int)cudaFuncSetAttribute(tie_cta_kernel<W>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tie_cta_kernel<W>, kCtaThreads, smem);
  if (err) return err;
  tie_cta_kernel<W>
      <<<grid_of(n / (kWarpCap + 1), std::max(per_sm, 1)), kCtaThreads, smem,
         s>>>(rows, k0, i0, n, diff, long_starts, counters, oversized, out);
  err = (int)cudaGetLastError();
  if (err) return err;
  // the one wait: how many runs are oversized
  uint32_t counts[2];
  err = (int)cudaMemcpyAsync(counts, counters, sizeof(counts),
                             cudaMemcpyDeviceToHost, s);
  if (!err) err = (int)cudaStreamSynchronize(s);
  if (err || counts[1] == 0) return err;
  // 4. oversized runs, in position order
  std::vector<uint32_t> list(3 * (size_t)counts[1]);
  err = (int)cudaMemcpyAsync(list.data(), oversized,
                             sizeof(uint32_t) * list.size(),
                             cudaMemcpyDeviceToHost, s);
  if (!err) err = (int)cudaStreamSynchronize(s);
  if (err) return err;
  std::vector<size_t> order(counts[1]);
  for (size_t r = 0; r < order.size(); ++r) order[r] = r;
  std::sort(order.begin(), order.end(),
            [&](size_t x, size_t y) { return list[3 * x] < list[3 * y]; });
  std::vector<uint32_t> same, mixed;
  for (size_t r : order) {
    std::vector<uint32_t>& to = list[3 * r + 2] ? mixed : same;
    to.push_back(list[3 * r]);
    to.push_back(list[3 * r + 1]);
  }
  int64_t n_same = 0, n_mixed = 0;
  const std::vector<uint32_t> same_table = run_table(same, &n_same);
  const std::vector<uint32_t> mixed_table = run_table(mixed, &n_mixed);
  // both tables in keys[0] (word 0 is no longer read)
  uint32_t* tables = reinterpret_cast<uint32_t*>(keys[0]);
  uint32_t* mixed_at = tables + same_table.size();
  err = (int)cudaMemcpyAsync(tables, same_table.data(),
                             sizeof(uint32_t) * same_table.size(),
                             cudaMemcpyHostToDevice, s);
  if (!err) {
    err = (int)cudaMemcpyAsync(mixed_at, mixed_table.data(),
                               sizeof(uint32_t) * mixed_table.size(),
                               cudaMemcpyHostToDevice, s);
  }
  if (err) return err;
  if (n_same > 0) {
    fill_kernel<W><<<grid_of((n_same + 255) / 256, 8), 256, 0, s>>>(
        rows, i0, tables, (int)same.size() / 2, n_same, out);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_mixed == 0) return 0;
  uint32_t* ids = idx[1];
  compact_kernel<<<grid_of((n_mixed + 255) / 256, 8), 256, 0, s>>>(
      i0, mixed_at, (int)mixed.size() / 2, n_mixed, ids);
  err = (int)cudaGetLastError();
  if (err) return err;
  // the row plan on the mixed rows; its first pass reads `ids` and writes
  // idx[(passes - 1) % 2], so `ids` takes the other index buffer
  uint32_t* const plan_idx[2] = {passes % 2 ? idx[0] : idx[1],
                                 passes % 2 ? idx[1] : idx[0]};
  return run_plan<true, W>(rows, ids, n_mixed, plan, passes, keys, plan_idx,
                           out, &mixed_table, hist, status, s);
}

}  // namespace

// Elements per onesweep tile (pairs != 0: the row sort's (key, index)
// tiles); the status scratch holds ceil(n / tile) * 256 + 1 int64.
extern "C" int rfx_radix_sort_tile(int pairs) {
  return pairs ? Tile<true>::kSize : Tile<false>::kSize;
}

// Rows of the longest run the row sort's tie pass sorts by a warp (cta ==
// 0) or by a CTA in shared memory (cta != 0).
extern "C" int rfx_radix_sort_tie_cap(int cta) {
  return cta ? kCtaCap : kWarpCap;
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
  return run_plan<false, 1>((const int64_t*)keys_in, nullptr, n,
                            (const int*)plan, passes, keys, idx, nullptr,
                            nullptr, (uint32_t*)hist,
                            (unsigned long long*)status,
                            (cudaStream_t)stream);
}

// rows_in: (n, W) int64, 2 <= W <= 4, read only. keys0/keys1: (n,) int64,
// idx0/idx1: (n,) uint32 scratch; out: (n, W) int64, the sorted rows. hist:
// passes * 256 uint32 (passes >= lead_passes); status: ceil(n /
// rfx_radix_sort_tile(1)) * 256 + 1 int64. lead / plan: `lead_plan` and
// `pass_plan` in host memory.
// Waits on the stream once, for the count of oversized runs.
extern "C" int rfx_radix_sort_rows(const void* rows_in, void* keys0,
                                   void* keys1, void* idx0, void* idx1,
                                   void* out, void* hist, void* status,
                                   int64_t n, int W, const void* lead,
                                   int lead_passes, const void* plan,
                                   int passes, void* stream) {
  if (n <= 0) return 0;
  int64_t* const keys[2] = {(int64_t*)keys0, (int64_t*)keys1};
  uint32_t* const idx[2] = {(uint32_t*)idx0, (uint32_t*)idx1};
  const int64_t* rows = (const int64_t*)rows_in;
  const int* l = (const int*)lead;
  const int* p = (const int*)plan;
  int64_t* o = (int64_t*)out;
  uint32_t* h = (uint32_t*)hist;
  unsigned long long* st = (unsigned long long*)status;
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 2:
      return sort_rows<2>(rows, n, l, lead_passes, p, passes, keys, idx,
                          o, h, st, s);
    case 3:
      return sort_rows<3>(rows, n, l, lead_passes, p, passes, keys, idx,
                          o, h, st, s);
    case 4:
      return sort_rows<4>(rows, n, l, lead_passes, p, passes, keys, idx,
                          o, h, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
