// K1 — rank-select trimmed mean / median over the client axis, for Hopper.
//
// Replaces the Pallas kernel `_trimmed_kernel` of
// fedml_tpu/ops/robust_stats.py (called through `_trimmed_mean_2d`). For
// x [C, D] fp32 (C clients, D flattened coordinates), per coordinate d:
//
//     rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}     (stable rank)
//            = #{j < i : x_j <= x_i} + #{j > i : x_j < x_i}
//     out[d] = (sum over i = 0..C-1 of (trim_k <= rank_i < C - trim_k ? x_i : 0)) / (C - 2*trim_k)
//
// The stable tie-break keeps exactly the multiset a stable sort's
// s[trim_k : C - trim_k] window keeps. The sum runs in index order
// i = 0..C-1, adding 0 for a dropped value, and divides once — the order of
// the TPU kernel and of the plain PyTorch version in robust_stats.py, so
// the result is bit-identical to that plain version (build without
// --use_fast_math: the division must be IEEE). Any C >= 1 is taken.
//
// Bound on the H100: each coordinate reads C floats and writes one,
// (C + 1) * 4 bytes, against ~C^2 compares. At C = 10 that is 44 bytes for
// ~110 simple operations, below the card's ~20 fp32 operations per byte:
// bytes bind. From C of about 80 up the compares bind (C = 128: 516 bytes
// for ~16,400 compares a coordinate). One thread per coordinate, a
// grid-stride loop over D: the loads of a column are coalesced across the
// warp (neighbouring threads read neighbouring d). Three paths:
//   - 1 <= C <= 16 (the cohorts of a round; 10 on the north-star path):
//     the column lives in registers, `trimmed_mean_reg_kernel<C>`, one
//     instantiation per C with the compares fully unrolled, all C loads of
//     a thread in flight before the first compare;
//   - 16 < C with C * 128 * 4 bytes within the card's opt-in shared memory
//     a block (C <= 454 on the H100's 227 KB): the thread's column is
//     copied once into dynamic shared memory, a tile [C][128] private to
//     its thread (column t at tile[i * 128 + t]: a warp reads 32
//     consecutive words, no bank conflicts, no __syncthreads);
//   - any larger C: the same loop reads x_j straight from device memory
//     (through L1/L2) instead of the tile. A smaller block would let the
//     tile hold larger columns, but leaves one or two warps an SM.
//   The two paths above 16 share `trimmed_mean_chunk_kernel`: a chunk of
//   kChunk consecutive i and their ranks sit in registers, every x_j of
//   the column is compared with the whole chunk (j before the chunk with
//   <=, after it with <, inside it unrolled pair by pair), then the chunk's
//   kept values are added to acc in index order. So each x_j is read
//   C / kChunk times, not C times, and the sum order is the plain one.
//   - no padding of D: the tail is guarded. Loads are 4 bytes: a row of
//     [C, D] starts 16-byte aligned only when D is a multiple of 4, which
//     the CNN's D = 1,690,046 is not.

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kThreads = 128;
constexpr int kRegMaxClients = 16;
constexpr int kChunk = 16;
// blocks a SM for the register kernel's grid (16 x 128 threads fill an SM)
constexpr int kRegBlocksPerSm = 16;

template <int C>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_reg_kernel(const float* __restrict__ x, float* __restrict__ out, long long D,
                        int trim_k) {
  const float keep_n = static_cast<float>(C - 2 * trim_k);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; d < D;
       d += stride) {
    float v[C];
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = __ldg(x + i * D + d);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      int rank = 0;
#pragma unroll
      for (int j = 0; j < i; ++j) rank += v[j] <= v[i];
#pragma unroll
      for (int j = i + 1; j < C; ++j) rank += v[j] < v[i];
      const bool keep = rank >= trim_k && rank < C - trim_k;
      acc = acc + (keep ? v[i] : 0.0f);
    }
    out[d] = acc / keep_n;
  }
}

// kTile: the column is held in the dynamic shared-memory tile (else read
// from device memory on every pass).
template <bool kTile>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_chunk_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                          long long D, int trim_k) {
  extern __shared__ float tile[];
  const int t = threadIdx.x;
  const float keep_n = static_cast<float>(C - 2 * trim_k);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads + t; d < D;
       d += stride) {
    const float* col = x + d;  // x_j of this column at col[j * D]
    if (kTile)
      for (int i = 0; i < C; ++i) tile[i * kThreads + t] = __ldg(col + i * D);
    auto xj = [&](int j) -> float {
      return kTile ? tile[j * kThreads + t] : __ldg(col + j * D);
    };
    float acc = 0.0f;
    for (int i0 = 0; i0 < C; i0 += kChunk) {
      float v[kChunk];
      int rank[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        v[c] = i0 + c < C ? xj(i0 + c) : 0.0f;
        rank[c] = 0;
      }
      for (int j = 0; j < i0; ++j) {  // j < i: ties count
        const float w = xj(j);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) rank[c] += w <= v[c];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int c2 = 0; c2 < kChunk; ++c2) {
          if (c2 < c) rank[c] += v[c2] <= v[c];
          if (c2 > c) rank[c] += i0 + c2 < C && v[c2] < v[c];
        }
      }
      for (int j = i0 + kChunk; j < C; ++j) {  // j > i: ties do not count
        const float w = xj(j);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) rank[c] += w < v[c];
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (i0 + c < C) {  // no add at all past C (acc + 0 would turn -0 into +0)
          const bool keep = rank[c] >= trim_k && rank[c] < C - trim_k;
          acc = acc + (keep ? v[c] : 0.0f);
        }
      }
    }
    out[d] = acc / keep_n;
  }
}

using RegKernel = void (*)(const float*, float*, long long, int);
using ChunkKernel = void (*)(const float*, float*, int, long long, int);

// The register kernel for a cohort of C = 1..16, or nullptr above.
RegKernel reg_kernel(int C) {
  switch (C) {
#define FEDML_K1_REG(N) \
  case N:               \
    return trimmed_mean_reg_kernel<N>;
    FEDML_K1_REG(1) FEDML_K1_REG(2) FEDML_K1_REG(3) FEDML_K1_REG(4) FEDML_K1_REG(5)
    FEDML_K1_REG(6) FEDML_K1_REG(7) FEDML_K1_REG(8) FEDML_K1_REG(9) FEDML_K1_REG(10)
    FEDML_K1_REG(11) FEDML_K1_REG(12) FEDML_K1_REG(13) FEDML_K1_REG(14) FEDML_K1_REG(15)
    FEDML_K1_REG(16)
#undef FEDML_K1_REG
    default:
      return nullptr;
  }
}

// How a cohort of C > 16 launches on one device: the chunk kernel, its
// dynamic shared memory (0 when the column does not fit the tile and is read
// from device memory) and the blocks that fit one SM.
struct ChunkLaunch {
  ChunkKernel kernel;
  size_t smem;
  int blocks_per_sm;
};

// Works out the ChunkLaunch of (current device, C) once and keeps it: the
// attribute, opt-in and occupancy queries would otherwise be host time on
// every launch. Client actors launch from several threads, hence the lock.
int chunk_launch(int C, ChunkLaunch* out) {
  static std::mutex mu;
  static std::unordered_map<long long, ChunkLaunch> known;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  const long long key = (static_cast<long long>(dev) << 32) | static_cast<unsigned>(C);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return 0;
  }
  int optin = 0;
  err = static_cast<int>(
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (err != 0) return err;
  ChunkLaunch launch{trimmed_mean_chunk_kernel<false>, 0, 0};
  const size_t bytes = static_cast<size_t>(C) * kThreads * sizeof(float);
  if (bytes <= static_cast<size_t>(optin)) {
    launch.kernel = trimmed_mean_chunk_kernel<true>;
    launch.smem = bytes;
    // above 48 KB a block's dynamic shared memory must be opted into
    err = static_cast<int>(cudaFuncSetAttribute(
        trimmed_mean_chunk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
  }
  if (err == 0)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &launch.blocks_per_sm, launch.kernel, kThreads, launch.smem));
  if (err != 0) return err;
  known.emplace(key, launch);
  *out = launch;
  return 0;
}

// out[5] = threads a block, registers a thread, local memory bytes a thread
// (spills), dynamic shared memory bytes a block, blocks resident on one SM
template <typename Kernel>
int kernel_info(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  int blocks = 0;
  if (err == 0)
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem));
  if (err != 0) return err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  return 0;
}

int grid_for(long long D, int sm_count, int blocks_per_sm) {
  const long long need = (D + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count) * (blocks_per_sm > 0 ? blocks_per_sm : 1);
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns the launch's cudaError_t (0 = launched).
// The caller guarantees: x, out device pointers to C*D and D fp32 on the
// current device, C >= 1, 0 <= 2*trim_k < C, D >= 1, sm_count >= 1.
int fedml_trimmed_mean_f32(const float* x, float* out, int C, long long D, int trim_k,
                           int sm_count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const RegKernel kernel = reg_kernel(C)) {
    kernel<<<grid_for(D, sm_count, kRegBlocksPerSm), kThreads, 0, s>>>(x, out, D, trim_k);
    return static_cast<int>(cudaGetLastError());
  }
  ChunkLaunch launch;
  const int err = chunk_launch(C, &launch);
  if (err != 0) return err;
  const ChunkKernel kernel = launch.kernel;
  kernel<<<grid_for(D, sm_count, launch.blocks_per_sm), kThreads, launch.smem, s>>>(x, out, C, D,
                                                                                   trim_k);
  return static_cast<int>(cudaGetLastError());
}

// The kernel that takes a cohort of C and what the compiler made of it
// (out[5] as kernel_info fills it); returns a cudaError_t.
int fedml_robust_stats_kernel_info(int C, int* out) {
  if (const RegKernel kernel = reg_kernel(C)) return kernel_info(kernel, 0, out);
  ChunkLaunch launch;
  const int err = chunk_launch(C, &launch);
  return err != 0 ? err : kernel_info(launch.kernel, launch.smem, out);
}

}  // extern "C"
