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
//     neighbouring d) and each thread loads its whole column before using it;
//   - the column is held in a shared-memory tile [C][blockDim.x], private
//     to its thread (column t at tile[i * blockDim.x + t]: a warp reads 32
//     consecutive words, no bank conflicts, no __syncthreads), because a
//     runtime C cannot index registers;
//   - no padding of D: the tail is guarded.
// C is capped at kMaxClients (the wrapper raises above it), which bounds
// the tile at 64 * 128 * 4 = 32 KB, under the 48 KB static limit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxClients = 64;
constexpr int kThreads = 128;

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

}  // namespace

extern "C" {

int fedml_robust_stats_max_clients() { return kMaxClients; }

// Launches K1 on `stream`; returns the launch's cudaError_t (0 = launched).
// The caller guarantees: x, out device pointers to C*D and D fp32,
// 1 <= C <= kMaxClients, 0 <= 2*trim_k < C, D >= 1, grid >= 1.
int fedml_trimmed_mean_f32(const float* x, float* out, int C, long long D,
                           int trim_k, int grid, void* stream) {
  const size_t smem = static_cast<size_t>(C) * kThreads * sizeof(float);
  trimmed_mean_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(x, out, C, D,
                                                             trim_k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
