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
// --use_fast_math: the division must be IEEE).
//
// Bound on the H100: bytes. Each coordinate reads C floats and writes one,
// (C + 1) * 4 bytes, against ~C^2 compares; at C = 10 that is 44 bytes for
// ~110 simple operations, far below the card's ~20 operations per byte
// of fp32 balance. Design for that:
//   - one thread per coordinate, grid-stride loop over D: the C loads of a
//     column are coalesced across the warp (neighbouring threads read
//     neighbouring d), and each thread issues all C loads of its column
//     before the first compare, so C loads a thread are in flight;
//   - for 2 <= C <= 16 the column lives in registers
//     (`trimmed_mean_reg_kernel<C>`, one instantiation per C, the compares
//     fully unrolled); the cohorts of a round (10 clients on the north-star
//     path) take this kernel;
//   - a larger C, known only at run time, cannot index registers: its column
//     is held in a shared-memory tile [C][blockDim.x], private to its thread
//     (column t at tile[i * blockDim.x + t]: a warp reads 32 consecutive
//     words, no bank conflicts, no __syncthreads), in `trimmed_mean_kernel`;
//   - no padding of D: the tail is guarded. Loads are 4 bytes: a row of
//     [C, D] starts 16-byte aligned only when D is a multiple of 4, which
//     the CNN's D = 1,690,046 is not.
// C is capped at kMaxClients (the wrapper raises above it), which bounds
// the tile at 64 * 128 * 4 = 32 KB, under the 48 KB static limit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxClients = 64;
constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
trimmed_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int C, long long D, int trim_k) {
  extern __shared__ float tile[];
  const int t = threadIdx.x;
  const float keep_n = static_cast<float>(C - 2 * trim_k);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long d = static_cast<long long>(blockIdx.x) * kThreads + t; d < D;
       d += stride) {
    for (int i = 0; i < C; ++i) tile[i * kThreads + t] = x[i * D + d];
    float acc = 0.0f;
    for (int i = 0; i < C; ++i) {
      const float xi = tile[i * kThreads + t];
      int rank = 0;
      for (int j = 0; j < i; ++j) rank += tile[j * kThreads + t] <= xi;
      for (int j = i + 1; j < C; ++j) rank += tile[j * kThreads + t] < xi;
      const bool keep = rank >= trim_k && rank < C - trim_k;
      acc = acc + (keep ? xi : 0.0f);
    }
    out[d] = acc / keep_n;
  }
}

using RegKernel = void (*)(const float*, float*, long long, int);

// The register kernel for a cohort of C = 2..16, or nullptr where C takes
// the shared-memory kernel.
RegKernel reg_kernel(int C) {
  switch (C) {
#define FEDML_K1_REG(N) \
  case N:               \
    return trimmed_mean_reg_kernel<N>;
    FEDML_K1_REG(2) FEDML_K1_REG(3) FEDML_K1_REG(4) FEDML_K1_REG(5) FEDML_K1_REG(6)
    FEDML_K1_REG(7) FEDML_K1_REG(8) FEDML_K1_REG(9) FEDML_K1_REG(10) FEDML_K1_REG(11)
    FEDML_K1_REG(12) FEDML_K1_REG(13) FEDML_K1_REG(14) FEDML_K1_REG(15) FEDML_K1_REG(16)
#undef FEDML_K1_REG
    default:
      return nullptr;
  }
}

size_t tile_bytes(int C) { return static_cast<size_t>(C) * kThreads * sizeof(float); }

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

}  // namespace

extern "C" {

int fedml_robust_stats_max_clients() { return kMaxClients; }

// Launches K1 on `stream`; returns the launch's cudaError_t (0 = launched).
// The caller guarantees: x, out device pointers to C*D and D fp32,
// 1 <= C <= kMaxClients, 0 <= 2*trim_k < C, D >= 1, grid >= 1.
int fedml_trimmed_mean_f32(const float* x, float* out, int C, long long D,
                           int trim_k, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const RegKernel kernel = reg_kernel(C))
    kernel<<<grid, kThreads, 0, s>>>(x, out, D, trim_k);
  else
    trimmed_mean_kernel<<<grid, kThreads, tile_bytes(C), s>>>(x, out, C, D, trim_k);
  return static_cast<int>(cudaGetLastError());
}

// The kernel that takes a cohort of C and what the compiler made of it
// (out[5] as kernel_info fills it); returns a cudaError_t.
int fedml_robust_stats_kernel_info(int C, int* out) {
  if (const RegKernel kernel = reg_kernel(C)) return kernel_info(kernel, 0, out);
  return kernel_info(trimmed_mean_kernel, tile_bytes(C), out);
}

}  // extern "C"
