// The three designs tried for the port's tile gather, timed side by side
// on one NVIDIA card: out[t * 1024 : +1024] = src[starts[t] : +1024] for
// random 1024-aligned starts.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tile_gather_forms scripts/tile_gather_forms.cu
//   build/tile_gather_forms
//
// Forms:
//   tile: one 256-thread CTA per tile, one 16-byte load and store per
//     thread, streaming stores, and streaming loads where the tiles exceed
//     the L2: the kernel that reflexiv_tpu_torch/csrc/partition.cu keeps;
//   bulk: one wave of 32-thread CTAs (SMs x resident CTAs per SM), tiles
//     dealt out in turn; one thread keeps a ring of kRing 4 KB shared-memory
//     buffers in flight with Hopper's 1-D bulk copies (TMA), global ->
//     shared completing on an mbarrier, shared -> global in bulk groups;
//     the shape of the TPU kernel's ring of DMAs
//     (reflexiv_tpu/partition_kernels.py:269-311);
//   regs: the same wave and dealing with 256-thread CTAs, each thread
//     issuing kDepth 16-byte loads, from kDepth tiles, before its first
//     store.
// Shapes: 4096 tiles from 2^24 words (chip_smoke.py phase 6's probe) and
// 65,536 tiles from 2^26 words (256 MB each way). Each form's output is
// checked against a host copy; times are the median of 5 interleaved trains
// of 200 launches (CUDA events), device time only: chip_smoke.py times the
// kept form from Python against index_select.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include <algorithm>
#include <functional>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTile = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kRing = 8;             // bulk form: 4 KB buffers per CTA
constexpr int kGatherWarp = 32;      // bulk form: one warp per CTA
constexpr int kDepth = 8;            // register form: tiles in flight
constexpr unsigned kTileBytes = kTile * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The tiles of one CTA, in groups of `group` consecutive tiles dealt out
// to the CTAs in turn, so that all CTAs write near one front: its j-th tile
// is (blockIdx.x + (j / group) * gridDim.x) * group + j % group. The warp
// walks j upwards in step and reads the starts 32 at a time, one load.
struct StartCursor {
  const int32_t* starts;
  int64_t n_tiles, batch;
  int group;
  int32_t held;
  __device__ void init(const int32_t* s, int64_t n, int g) {
    starts = s;
    n_tiles = n;
    group = g;
    batch = -1;
  }
  __device__ int64_t tile(int64_t j) const {
    return ((int64_t)blockIdx.x + j / group * gridDim.x) * group + j % group;
  }
  __device__ int64_t start(int64_t j) {
    if (j / 32 != batch) {
      batch = j / 32;
      const int64_t t = tile(batch * 32 + (threadIdx.x & 31));
      held = t < n_tiles ? starts[t] : 0;
    }
    return __shfl_sync(kFull, held, (int)(j % 32));
  }
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(smem_addr(bar)), "r"(kTileBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(kTileBytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  int spins = 0;
  do {
    // a copy that never lands traps (a launch error) instead of hanging
    if (++spins > (1 << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(kTileBytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// form "tile": the kernel of reflexiv_tpu_torch/csrc/partition.cu, copied
template <bool STREAM_LOADS>
__global__ void __launch_bounds__(kThreads) tile_gather_kernel(
    const uint32_t* __restrict__ src, const int32_t* __restrict__ tile_starts,
    uint32_t* __restrict__ out, int64_t n_tiles) {
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const uint4* from =
        reinterpret_cast<const uint4*>(src + tile_starts[t]) + threadIdx.x;
    __stcs(reinterpret_cast<uint4*>(out + t * kTile) + threadIdx.x,
           STREAM_LOADS ? __ldcs(from) : *from);
  }
}

__global__ void __launch_bounds__(kGatherWarp) tile_gather_bulk_kernel(
    const uint32_t* __restrict__ src, const int32_t* __restrict__ tile_starts,
    uint32_t* __restrict__ out, int64_t n_tiles) {
  __shared__ __align__(128) uint32_t ring[kRing][kTile];
  __shared__ __align__(8) uint64_t bar[kRing];
  StartCursor cur;
  cur.init(tile_starts, n_tiles, 1);
  if (cur.tile(0) >= n_tiles) return;
  const int64_t count = (n_tiles - 1 - cur.tile(0)) / gridDim.x + 1;
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int i = 0; i < kRing; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bar[i])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int64_t j = 0; j < count && j < kRing; ++j) {
    const int64_t start = cur.start(j);
    if (leader) bulk_load(ring[j], src + start, &bar[j]);
  }
  for (int64_t j = 0; j < count; ++j) {
    // the refill below reads the start of the CTA's tile j - 1 + kRing;
    // every lane walks the cursor so its shuffles stay converged
    const int64_t next = j - 1 + kRing;
    const int64_t start = j >= 1 && next < count ? cur.start(next) : 0;
    if (leader) {
      const int slot = (int)(j % kRing);
      bulk_wait(&bar[slot], (uint32_t)((j / kRing) & 1));
      bulk_store(out + cur.tile(j) * kTile, ring[slot]);
      if (j >= 1 && next < count) {
        // the store of tile j - 1 has read its buffer: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const int refill = (int)(next % kRing);
        bulk_load(ring[refill], src + start, &bar[refill]);
      }
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) tile_gather_regs_kernel(
    const uint32_t* __restrict__ src, const int32_t* __restrict__ tile_starts,
    uint32_t* __restrict__ out, int64_t n_tiles) {
  StartCursor cur;
  cur.init(tile_starts, n_tiles, kDepth);
  for (int64_t j = 0; cur.tile(j) < n_tiles; j += kDepth) {
    int64_t start[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) start[u] = cur.start(j + u);
    const int64_t first = cur.tile(j);
    uint4 v[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (first + u < n_tiles) {
        v[u] = reinterpret_cast<const uint4*>(src + start[u])[threadIdx.x];
      }
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (first + u < n_tiles) {
        reinterpret_cast<uint4*>(out + (first + u) * kTile)[threadIdx.x] =
            v[u];
      }
    }
  }
}

int check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(e));
    exit(1);
  }
  return 0;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  check(cudaGetDeviceProperties(&prop, 0), "device");
  if (FILE* smi = popen("nvidia-smi --query-gpu=name,power.limit "
                        "--format=csv,noheader", "r")) {
    char line[256];
    if (fgets(line, sizeof line, smi)) printf("nvidia-smi: %s", line);
    pclose(smi);
  }
  int bulk_per_sm = 0, regs_per_sm = 0;
  check(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &bulk_per_sm, tile_gather_bulk_kernel, kGatherWarp, 0), "occ");
  check(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &regs_per_sm, tile_gather_regs_kernel, kThreads, 0), "occ");
  const int64_t sms = prop.multiProcessorCount;
  const int64_t shapes[2][2] = {{1 << 24, 4096}, {1 << 26, 65536}};
  for (const auto& shape : shapes) {
    const int64_t n_src = shape[0], n = shape[1];
    std::vector<uint32_t> h_src(n_src);
    std::vector<int32_t> h_starts(n);
    srand(1);
    for (auto& w : h_src) w = (uint32_t)rand();
    for (auto& s : h_starts) s = (int32_t)((rand() % (n_src / kTile)) * kTile);
    uint32_t *src, *out;
    int32_t* starts;
    check(cudaMalloc(&src, n_src * 4), "malloc");
    check(cudaMalloc(&starts, n * 4), "malloc");
    check(cudaMalloc(&out, n * kTile * 4), "malloc");
    cudaMemcpy(src, h_src.data(), n_src * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(starts, h_starts.data(), n * 4, cudaMemcpyHostToDevice);
    const bool stream_loads = n * (int64_t)kTileBytes > prop.l2CacheSize;
    const int64_t bulk_grid = std::min(n, sms * bulk_per_sm);
    const int64_t regs_grid = std::min((n + kDepth - 1) / kDepth,
                                       sms * regs_per_sm);
    const char* names[3] = {"tile", "bulk", "regs"};
    std::function<void()> launch[3] = {
        [&] {
          if (stream_loads) {
            tile_gather_kernel<true><<<n, kThreads>>>(src, starts, out, n);
          } else {
            tile_gather_kernel<false><<<n, kThreads>>>(src, starts, out, n);
          }
        },
        [&] {
          tile_gather_bulk_kernel<<<bulk_grid, kGatherWarp>>>(src, starts,
                                                             out, n);
        },
        [&] {
          tile_gather_regs_kernel<<<regs_grid, kThreads>>>(src, starts, out,
                                                          n);
        }};
    std::vector<uint32_t> got(n * kTile);
    for (int f = 0; f < 3; ++f) {
      cudaMemset(out, 0, n * kTile * 4);
      launch[f]();
      check(cudaDeviceSynchronize(), names[f]);
      cudaMemcpy(got.data(), out, n * kTile * 4, cudaMemcpyDeviceToHost);
      for (int64_t t = 0; t < n; ++t) {
        if (!std::equal(got.begin() + t * kTile, got.begin() + (t + 1) * kTile,
                        h_src.begin() + h_starts[t])) {
          fprintf(stderr, "%s: tile %ld differs\n", names[f], (long)t);
          return 1;
        }
      }
    }
    std::vector<float> ms[3];
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    for (int train = 0; train < 5; ++train) {
      for (int f = 0; f < 3; ++f) {
        cudaEventRecord(a);
        for (int i = 0; i < 200; ++i) launch[f]();
        cudaEventRecord(b);
        check(cudaEventSynchronize(b), names[f]);
        float t;
        cudaEventElapsedTime(&t, a, b);
        ms[f].push_back(t / 200);
      }
    }
    printf("%ld tiles from %ld words (bound %.4f ms at 3.35 TB/s):", (long)n,
           (long)n_src, 2.0 * n * kTileBytes / 3.35e12 * 1e3);
    for (int f = 0; f < 3; ++f) {
      std::sort(ms[f].begin(), ms[f].end());
      printf(" %s %.4f ms%s", names[f], ms[f][2], f < 2 ? "," : "\n");
    }
    cudaFree(src);
    cudaFree(starts);
    cudaFree(out);
  }
  return 0;
}
