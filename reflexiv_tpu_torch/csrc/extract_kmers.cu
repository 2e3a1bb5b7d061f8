// Canonical k-mer extraction: one key of W int64 words per window of a
// (R, L) read matrix of 2-bit codes.
//
// Replaces the TPU kernel reflexiv_tpu/pallas_kernels.py `_extract_kernel`
// (via `extract_canonical_kmers_pallas`), which rolled a (hi, lo) uint32
// forward / reverse-complement state down a transposed read block in VMEM,
// for 17 <= k <= 31 only (the JAX package used XLA for every other k and
// for clips, count.py:97-147). Here a key is W = ceil(k / 31) words; word
// w holds bases [31w, min(31w + 31, k)) with the first base in the high
// bits, so lexicographic order over the words is the base order. The
// canonical key is min(fwd, rc) over the words (ties take fwd). k <= 31 is
// one word, the 2k-bit integer itself. An invalid window gets poly-T in
// every word (never canonical, because its reverse complement poly-A is
// smaller), so the sort that follows needs no validity payload.
//
// Validity (count.py `count_pass_fused`, ReflexivDSMain.java:3968):
//   len - k - end_clip > 1  and  front_clip <= len  and
//   front_clip <= w <= len - end_clip - k.
//
// Bound: device-memory bytes. Each window writes 8W bytes and its read's
// bytes are read once from DRAM (L bytes per read against 8W (L - k + 1)
// bytes written), so the output stream sets the time. Design: one thread
// per window in row-major (read, window) order, so a warp's 32 threads read
// 32 neighbouring byte windows (the k-byte re-reads hit L1) and write 32
// neighbouring keys. The words are packed in registers (W is a template
// argument, so the word arrays stay in registers); nothing is staged in
// shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBasesPerWord = 31;
constexpr int64_t kMaxBlocks = 1 << 16;   // grid-stride beyond this

__device__ __forceinline__ int word_len(int k, int w) {
  const int rest = k - kBasesPerWord * w;
  return rest < kBasesPerWord ? rest : kBasesPerWord;
}

template <int W>
__global__ void extract_canonical_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    int64_t* __restrict__ out, int64_t R, int64_t L, int k, int front_clip,
    int end_clip) {
  const int64_t wn = L - k + 1;
  const int64_t total = R * wn;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const int64_t r = g / wn;
    const int64_t w = g - r * wn;
    const int64_t len = lengths[r];
    const bool ok = (len - k - end_clip > 1) && (front_clip <= len) &&
                    (w >= front_clip) && (w + k <= len - end_clip);
    uint64_t key[W];
    if (ok) {
      const uint8_t* p = bases + r * L + w;
      uint64_t fwd[W], rc[W];
      if (W == 1) {
        // one pass over the k bytes: base j at bit 2 (k - 1 - j) of fwd,
        // its complement at bit 2 j of rc
        uint64_t f = 0, c = 0;
#pragma unroll 4
        for (int j = 0; j < k; ++j) {
          const uint64_t b = p[j];
          f = (f << 2) | b;
          c |= (b ^ 3ULL) << (2 * j);
        }
        fwd[0] = f;
        rc[0] = c;
      } else {
        // word i: forward bases [lo, lo + n) and reverse-complement bases
        // [lo, lo + n), the complements of bytes k - 1 - lo down
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int n = word_len(k, i);
          const int lo = kBasesPerWord * i;
          uint64_t f = 0, c = 0;
          for (int j = 0; j < n; ++j) {
            f = (f << 2) | p[lo + j];
            c = (c << 2) | (p[k - 1 - lo - j] ^ 3u);
          }
          fwd[i] = f;
          rc[i] = c;
        }
      }
      // lexicographic fwd <= rc over the words
      bool le = true, decided = false;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (!decided && fwd[i] != rc[i]) {
          le = fwd[i] < rc[i];
          decided = true;
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) key[i] = le ? fwd[i] : rc[i];
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        key[i] = (1ULL << (2 * word_len(k, i))) - 1ULL;
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) out[g * W + i] = (int64_t)key[i];
  }
}

template <int W>
int launch(const void* bases, const void* lengths, void* out, int64_t R,
           int64_t L, int k, int front_clip, int end_clip, void* stream) {
  const int64_t total = R * (L - k + 1);
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  extract_canonical_kernel<W><<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, (int64_t*)out, R, L, k,
      front_clip, end_clip);
  return (int)cudaGetLastError();
}

}  // namespace

// One word per window (1 <= k <= 31): out is (R * (L - k + 1),) int64.
extern "C" int rfx_extract_canonical_keys(const void* bases,
                                          const void* lengths, void* out,
                                          int64_t R, int64_t L, int k,
                                          int front_clip, int end_clip,
                                          void* stream) {
  if (k < 1 || k > kBasesPerWord) return (int)cudaErrorInvalidValue;
  return launch<1>(bases, lengths, out, R, L, k, front_clip, end_clip,
                   stream);
}

// W = ceil(k / 31) words per window (32 <= k <= 124): out is
// (R * (L - k + 1), W) int64, row-major.
extern "C" int rfx_extract_canonical_rows(const void* bases,
                                          const void* lengths, void* out,
                                          int64_t R, int64_t L, int k,
                                          int front_clip, int end_clip,
                                          void* stream) {
  switch ((k + kBasesPerWord - 1) / kBasesPerWord) {
    case 2:
      return launch<2>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       stream);
    case 3:
      return launch<3>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       stream);
    case 4:
      return launch<4>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
