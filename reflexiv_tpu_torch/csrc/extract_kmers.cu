// Canonical k-mer extraction: one int64 key per window of a (R, L) read
// matrix of 2-bit codes.
//
// Replaces the TPU kernel reflexiv_tpu/pallas_kernels.py `_extract_kernel`
// (via `extract_canonical_kmers_pallas`), which rolled a (hi, lo) uint32
// forward / reverse-complement state down a transposed read block in VMEM.
// Here a key is the 2k-bit integer min(fwd, rc) (ties take fwd), held in one
// int64, so 1 <= k <= 31 and the XLA fallback for other k and for clips
// disappears. An invalid window gets the sentinel (1 << 2k) - 1 (poly-T,
// never canonical because its reverse complement poly-A is 0), so the sort
// that follows needs no validity payload.
//
// Validity (count.py `count_pass_fused`, ReflexivDSMain.java:3968):
//   len - k - end_clip > 1  and  front_clip <= len  and
//   front_clip <= w <= len - end_clip - k.
//
// Bound: device-memory bytes. Each window writes 8 bytes and its read's
// bytes are read once from DRAM (L bytes per read against 8 * (L - k + 1)
// bytes written), so the output stream sets the time. Design: one thread
// per window in row-major (read, window) order, so a warp's 32 threads read
// 32 neighbouring byte windows (the k-byte re-reads hit L1) and write 32
// neighbouring int64 keys (one 256-byte coalesced store). The packing is
// done in registers; nothing is staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;   // grid-stride beyond this

__global__ void extract_canonical_keys_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    int64_t* __restrict__ out, int64_t R, int64_t L, int k, int front_clip,
    int end_clip) {
  const int64_t wn = L - k + 1;
  const int64_t total = R * wn;
  const uint64_t sentinel = (1ULL << (2 * k)) - 1ULL;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const int64_t r = g / wn;
    const int64_t w = g - r * wn;
    const int64_t len = lengths[r];
    const bool ok = (len - k - end_clip > 1) && (front_clip <= len) &&
                    (w >= front_clip) && (w + k <= len - end_clip);
    uint64_t key = sentinel;
    if (ok) {
      const uint8_t* p = bases + r * L + w;
      uint64_t fwd = 0, rc = 0;
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const uint64_t c = p[j];
        fwd = (fwd << 2) | c;               // base j at bit 2 * (k - 1 - j)
        rc |= (c ^ 3ULL) << (2 * j);        // its complement at bit 2 * j
      }
      key = fwd <= rc ? fwd : rc;
    }
    out[g] = (int64_t)key;
  }
}

}  // namespace

extern "C" int rfx_extract_canonical_keys(const void* bases,
                                          const void* lengths, void* out,
                                          int64_t R, int64_t L, int k,
                                          int front_clip, int end_clip,
                                          void* stream) {
  const int64_t total = R * (L - k + 1);
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  extract_canonical_keys_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)bases, (const int32_t*)lengths, (int64_t*)out, R, L, k,
      front_clip, end_clip);
  return (int)cudaGetLastError();
}
