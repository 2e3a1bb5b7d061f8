// Canonical k-mer extraction: one key of W int64 words per window of a
// (R, L) read matrix of 2-bit codes.
//
// Replaces the TPU kernel reflexiv_tpu/pallas_kernels.py `_extract_kernel`
// (via `extract_canonical_kmers_pallas`), which rolled a (hi, lo) uint32
// forward / reverse-complement state down a transposed read block in VMEM,
// for 17 <= k <= 31 only (the JAX package used XLA for every other k and
// for clips, count.py:97-147). Here a key is W = ceil(k / 31) words; word
// i holds bases [31i, min(31i + 31, k)) with the first base in the high
// bits, so lexicographic order over the words is the base order. The
// canonical key is min(fwd, rc) over the words (ties take fwd). k <= 31 is
// one word, the 2k-bit integer itself. An invalid window gets poly-T in
// every word, (1 << 2n) - 1 for a word of n bases (never canonical, because
// its reverse complement poly-A is smaller), so the sort that follows needs
// no validity payload.
//
// Validity (count.py `count_pass_fused`, ReflexivDSMain.java:3968):
//   len - k - end_clip > 1  and  front_clip <= len  and
//   front_clip <= w <= len - end_clip - k.
//
// Bound: device-memory bytes. The kernel reads each read's L code bytes
// and its 4-byte length once and writes 8W bytes per window, R (L + 4) +
// 8 W R (L - k + 1) bytes in all; the output stream sets the time. The
// work per window has to stay a few dozen instructions for the card's
// integer rate not to bind first.
//
// Derivation. Every word the kernel writes is n <= 31 consecutive bases of
// a packed stream, first base high. With n = word_len(k, i):
//   forward word i of window w = row bases [w + 31i, w + 31i + n);
//   reverse-complement word i  = RC bases [L - w - k + 31i, ... + n), where
//     RC[q] = row[L - 1 - q] ^ 3 is the row's reverse-complement stream
//     (rc word i reads row bases w + k - 1 - 31i down to w + k - 31i - n,
//     complemented);
//   k <= 31 is the same with i = 0 and n = k.
// So each word is a funnel shift of three adjacent 32-bit words (16 bases
// each, first base high) of one packed stream, then a shift to 2n bits.
//
// Design: pack once, then cut every key from the packed streams. A CTA
// takes `reads` whole reads (rows longer than the stage take a CTA per
// `windows` windows of one read). Its bytes are one contiguous span of the
// row-major matrix, from the first base of its first window to the last
// base of its last window.
//  1. Stage and pack: the span's 16-byte chunks, from the chunk that holds
//     its first byte (the span need not be 16-byte aligned: a row slice
//     such as mat[1:] at odd L is not), are loaded with 16-byte streaming
//     loads (the partial head and tail chunks byte by byte, so nothing
//     outside the span is read) and packed to one uint32 each in shared
//     memory (`fwd`, codes masked with & 3). The same thread writes the
//     chunk's reverse complement at the mirrored place of a second stream
//     (`rc`), so RC of the whole span is one stream too: chunk c of `fwd`
//     is chunk nch - 1 - c of `rc`. Each read's window bounds go beside
//     them. About L / 2 bytes of shared memory per read.
//  2. Emit: the CTA's windows are one contiguous output span, walked with
//     one thread per window in row-major (read, window) order. A window at
//     span position p cuts forward word i at p + 31i and rc word i at
//     (16 nch - k - p) + 31i: 3 shared loads and 2 funnel shifts per word,
//     whatever k is. The (read, window) pair of a thread's next window is
//     advanced by a step divided once per thread, never per window; offsets
//     inside the CTA are 32-bit, into the output 64-bit. Stores are
//     streaming (the output is larger than the L2), and each warp's 32
//     windows start on a 32-window boundary of the whole output, so its
//     stores fill whole 32-byte sectors (on an H100, 4% faster at k = 31
//     than warps counted from the CTA's first window; measured by
//     scripts/extract_forms.py). For
//     W >= 2 each warp stages its 32 W words in shared memory and writes
//     them as one contiguous run, lane e the words e, e + 32, ...
// `reads` and `windows` come from the wrapper (kernels/extract.py
// `launch_geometry`), which also sizes the shared memory; the launcher
// recomputes the size and refuses a launch that it would not hold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBasesPerWord = 31;
constexpr int kLoadsInFlight = 4;   // 16-byte chunks per thread per round

__device__ __forceinline__ int word_len(int k, int i) {
  const int rest = k - kBasesPerWord * i;
  return rest < kBasesPerWord ? rest : kBasesPerWord;
}

// shared memory a CTA needs: the two packed streams of a span of `span`
// bases at any 16-byte offset, with two zero words after each; the window
// bounds of `reads` reads; for W >= 2, the warps' output stages.
// kernels/extract.py `launch_geometry` computes the same.
int64_t smem_bytes_for(int64_t span, int64_t reads, int W) {
  return 8 * ((span + 30) / 16 + 2) + 8 * reads +
         (W > 1 ? 8LL * kThreads * W : 0);
}

// 4 code bytes (first base in the low byte) -> 8 bits, first base high
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  v = __byte_perm(v & 0x03030303u, 0, 0x0123);   // first base in the top byte
  v |= v >> 6;
  v |= v >> 12;
  return v & 0xFFu;
}

// 16 code bytes -> 16 packed bases, first base high
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return (pack4(v.x) << 24) | (pack4(v.y) << 16) | (pack4(v.z) << 8) |
         pack4(v.w);
}

// reverse complement of 16 packed bases: reverse the 2-bit groups, then
// complement (code ^ 3)
__device__ __forceinline__ uint32_t revcomp16(uint32_t f) {
  uint32_t r = __brev(f);
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return ~r;
}

// the 16-byte chunk at p, bytes outside [lo, hi) read as 0
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p,
                                            const uint8_t* lo,
                                            const uint8_t* hi) {
  if (p >= lo && p + 16 <= hi) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (p + b >= lo && p + b < hi) w[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// n (1..31) bases of a packed stream from base position p, first base high
__device__ __forceinline__ uint64_t cut(const uint32_t* s, uint32_t p, int n) {
  const uint32_t c = p >> 4, sh = 2 * (p & 15);
  const uint32_t a = s[c], b = s[c + 1], d = s[c + 2];
  const uint64_t x = ((uint64_t)__funnelshift_l(b, a, sh) << 32) |
                     __funnelshift_l(d, b, sh);
  return x >> (64 - 2 * n);
}

template <int W>
__global__ void __launch_bounds__(kThreads) extract_canonical_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    int64_t* __restrict__ out, int64_t R, int L, int k, int front_clip,
    int end_clip, int reads_per_cta, int windows_per_cta, int ctas_per_read) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* stage = reinterpret_cast<int64_t*>(smem);
  int2* bounds = reinterpret_cast<int2*>(smem + (W > 1 ? 8 * kThreads * W : 0));
  uint32_t* fwd = reinterpret_cast<uint32_t*>(bounds + reads_per_cta);

  const int wn = L - k + 1;
  int64_t r0;
  int nr, w0, nw;   // reads, first window, windows per read of this CTA
  if (ctas_per_read == 1) {
    r0 = (int64_t)blockIdx.x * reads_per_cta;
    nr = R - r0 < reads_per_cta ? (int)(R - r0) : reads_per_cta;
    w0 = 0;
    nw = wn;
  } else {
    r0 = blockIdx.x / ctas_per_read;
    w0 = (int)(blockIdx.x % ctas_per_read) * windows_per_cta;
    nr = 1;
    nw = wn - w0 < windows_per_cta ? wn - w0 : windows_per_cta;
  }

  // 1. stage and pack the span
  const uint8_t* first = bases + r0 * L + w0;
  const int span = (nr - 1) * L + nw + k - 1;
  const int off = (int)(reinterpret_cast<uintptr_t>(first) & 15);
  const uint8_t* a0 = first - off;
  const int nch = (off + span + 15) >> 4;
  uint32_t* rc = fwd + nch + 2;
  for (int c0 = threadIdx.x; c0 < nch; c0 += kLoadsInFlight * kThreads) {
    uint4 v[kLoadsInFlight];
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) {
      const int c = c0 + j * kThreads;
      v[j] = c < nch ? load_chunk(a0 + 16 * c, first, first + span)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kLoadsInFlight; ++j) {
      const int c = c0 + j * kThreads;
      if (c < nch) {
        const uint32_t f = pack16(v[j]);
        fwd[c] = f;
        rc[nch - 1 - c] = revcomp16(f);
      }
    }
  }
  if (threadIdx.x < 2) {
    fwd[nch + threadIdx.x] = 0;
    rc[nch + threadIdx.x] = 0;
  }
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const int64_t len = lengths[r0 + i];
    int2 b = make_int2(1, 0);   // no valid window
    if (len - k - end_clip > 1 && front_clip <= len) {
      b = make_int2(front_clip,
                    (int)min(len - end_clip - k, (int64_t)wn - 1));
    }
    bounds[i] = b;
  }
  __syncthreads();

  // 2. emit: thread t takes the CTA's windows t - lead, t - lead +
  // kThreads, ...; `lead` puts every warp's 32 windows on a 32-window
  // boundary of the whole output, so its stores fill whole sectors
  const int total = nr * nw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t first_window = (int64_t)r0 * wn + w0;
  const int lead = (int)(first_window & 31);
  const int rc0 = 16 * nch - k;   // rc stream position of span position 0
  // a read's stride in the span; a CTA of one read never steps past it
  const int row = nr > 1 ? L : 0;
  // (read, window) of this thread's first window at or after the CTA's
  // first; a lane whose first window lies before it sits out one round
  bool sit_out = (int)threadIdx.x < lead;
  const int g0 = threadIdx.x - lead + (sit_out ? kThreads : 0);
  int rl = g0 / nw, wl = g0 % nw;
  int p = off + rl * row + wl;    // span position of the window's first base
  const int step_r = kThreads / nw, step_w = kThreads % nw;
  const int step_p = step_r * row + step_w;
  int64_t* const dst = out + first_window * W;
  int64_t* const my_stage = stage + warp * 32 * W;
  for (int base = warp * 32 - lead; base < total; base += kThreads) {
    const int g = base + lane;
    const bool live = !sit_out && g < total;
    int64_t key[W];
    if (live) {
      const int2 b = bounds[rl];
      const int w = w0 + wl;
      if (w >= b.x && w <= b.y) {
        uint64_t f[W], c[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int n = W == 1 ? k : word_len(k, i);
          f[i] = cut(fwd, p + kBasesPerWord * i, n);
          c[i] = cut(rc, rc0 - p + kBasesPerWord * i, n);
        }
        // lexicographic fwd <= rc over the words
        bool le = true, decided = false;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (!decided && f[i] != c[i]) {
            le = f[i] < c[i];
            decided = true;
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i) key[i] = (int64_t)(le ? f[i] : c[i]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int n = W == 1 ? k : word_len(k, i);
          key[i] = (int64_t)((1ULL << (2 * n)) - 1ULL);
        }
      }
    }
    if (W == 1) {
      if (live) __stcs(reinterpret_cast<long long*>(dst) + g,
                       (long long)key[0]);
    } else {
      if (live) {
#pragma unroll
        for (int i = 0; i < W; ++i) my_stage[lane * W + i] = key[i];
      }
      __syncwarp();
      // the warp's words [lo, hi) of its 32 W, as one contiguous run
      const int lo = (base < 0 ? -base : 0) * W;
      const int hi = min(32, total - base) * W;
      long long* run = reinterpret_cast<long long*>(dst) + (int64_t)base * W;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int j = lane + 32 * i;
        if (j >= lo && j < hi) __stcs(run + j, (long long)my_stage[j]);
      }
      __syncwarp();
    }
    if (sit_out) {
      sit_out = false;
      continue;
    }
    wl += step_w;
    rl += step_r;
    p += step_p;
    if (wl >= nw) {
      wl -= nw;
      ++rl;
      p += row - nw;
    }
  }
}

template <int W>
int launch(const void* bases, const void* lengths, void* out, int64_t R,
           int64_t L, int k, int front_clip, int end_clip, int reads,
           int windows, int smem_bytes, void* stream) {
  const int64_t wn = L - k + 1;
  if (R <= 0 || wn <= 0) return 0;
  if (L >= (1LL << 30) || reads < 1 || windows < 1 || front_clip < 0 ||
      end_clip < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t ctas_per_read = (wn + windows - 1) / windows;
  // a CTA takes whole reads (all wn windows each), or one read's windows
  if (ctas_per_read == 1 ? windows != wn : reads != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t span = ctas_per_read == 1 ? reads * L : windows + k - 1;
  if (span > (1LL << 22) ||
      smem_bytes_for(span, reads, W) > (int64_t)smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t grid =
      ctas_per_read == 1 ? (R + reads - 1) / reads : R * ctas_per_read;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extract_canonical_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  extract_canonical_kernel<W><<<(unsigned)grid, kThreads, smem_bytes,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, (int64_t*)out, R,
      (int)L, k, front_clip, end_clip, reads, windows, (int)ctas_per_read);
  return (int)cudaGetLastError();
}

}  // namespace

// One word per window (1 <= k <= 31): out is (R * (L - k + 1),) int64.
// reads / windows / smem_bytes: the launch geometry of kernels/extract.py.
extern "C" int rfx_extract_canonical_keys(const void* bases,
                                          const void* lengths, void* out,
                                          int64_t R, int64_t L, int k,
                                          int front_clip, int end_clip,
                                          int reads, int windows,
                                          int smem_bytes, void* stream) {
  if (k < 1 || k > kBasesPerWord) return (int)cudaErrorInvalidValue;
  return launch<1>(bases, lengths, out, R, L, k, front_clip, end_clip, reads,
                   windows, smem_bytes, stream);
}

// W = ceil(k / 31) words per window (32 <= k <= 124): out is
// (R * (L - k + 1), W) int64, row-major.
extern "C" int rfx_extract_canonical_rows(const void* bases,
                                          const void* lengths, void* out,
                                          int64_t R, int64_t L, int k,
                                          int front_clip, int end_clip,
                                          int reads, int windows,
                                          int smem_bytes, void* stream) {
  switch ((k + kBasesPerWord - 1) / kBasesPerWord) {
    case 2:
      return launch<2>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       reads, windows, smem_bytes, stream);
    case 3:
      return launch<3>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       reads, windows, smem_bytes, stream);
    case 4:
      return launch<4>(bases, lengths, out, R, L, k, front_clip, end_clip,
                       reads, windows, smem_bytes, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
