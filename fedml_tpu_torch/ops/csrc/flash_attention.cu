// K2, K3, K4 — blockwise (flash) attention forward and backward, for Hopper.
//
// Replaces the Pallas kernels of fedml_tpu/ops/flash_attention.py:
//   K2 `_fwd_kernel`     (called by `_flash_forward`, pallas_call :133)
//        O = softmax(Q K^T * scale [causal]) V by online softmax; saves LSE
//   K3 `_bwd_dq_kernel`  (called by `_flash_bwd`, pallas_call :293)
//        dQ = sum_k dS K,  P = exp(S - LSE),  dS = P * (dO V^T - delta) * scale
//   K4 `_bwd_dkv_kernel` (called by `_flash_bwd`, pallas_call :314)
//        dV = sum_q P^T dO,  dK = sum_q dS^T Q
// on q, k, v [BH, S, D] (float32 or bfloat16, row-major, contiguous), LSE and
// delta [BH, S] float32 (the TPU kernel's [BH, 8, S] sublane replication is
// a TPU tiling artifact and is not kept). The mask value is -1e30, not -inf,
// and l > 0 guards the final division, as in the TPU kernel.
//
// The casts that decide the bfloat16 numbers are the TPU kernel's: K2 rounds
// P to the inputs' type before P V; K3 takes dO V^T in float32 and rounds dS
// to the inputs' type before dS K; K4 is float32 throughout; every output is
// rounded to the inputs' type once at the end. All products are float32
// multiply-adds of the (exactly widened) inputs, so a bfloat16 product is what
// a tensor core with float32 accumulation would give, summed in another order.
//
// What bounds it on the H100: at the LM's shapes (S = 256, D = 96, bfloat16,
// causal) the ideal kernel is bound by bytes (~64-85 FLOP per byte moved,
// under the card's ~295 FLOP/byte bf16 ridge). This first version is bound by
// neither: it does its products with float32 FMA on the CUDA cores (67 TFLOP/s
// peak, not the tensor cores' 989) out of shared memory, so it is bound by
// the FMA pipe and by shared-memory loads. Its design, simple first:
//   - the TPU grid's sequential K axis becomes a loop inside a block: one block
//     per (batch*head, 64-row tile) of the output, 256 threads; blocks are
//     independent, so nothing carries over between them;
//   - tiles of 64 rows are widened to float32 in shared memory with rows
//     padded by 4 floats, so float4 loads along D are aligned and a
//     quarter-warp's 8 rows fall in distinct banks;
//   - each thread owns a 4 x 4 register tile of a 64 x 64 score block (rows
//     ty + 16 i, columns tx + 16 j) and 4 x D/16 outputs (rows ty + 16 i,
//     columns tx + 16 j);
//   - under the causal mask only the tiles it leaves live are visited (about
//     half the work), and the heaviest query tiles are scheduled first;
//   - ragged edges (S not a multiple of 64) are guarded: rows past the end
//     load as zeros and are never stored, columns past the end are masked.
// Shared memory: up to 172.5 KB (K4 at D = 128), under the 227 KB a block can
// have; above 48 KB it is opted into with cudaFuncSetAttribute.
// Built without --use_fast_math: expf, logf and the divisions are IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;         // rows of a query tile and of a key tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kPad = 4;           // row padding of a [64][D] tile (floats)
constexpr int kPLd = kTile + 16;  // row stride of a [64][64] score tile
constexpr float kMaskValue = -1e30f;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Round to T and widen back: the cast the TPU kernel makes before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D> constexpr int tile_floats() { return kTile * (D + kPad); }

// dst[r][c] = src[row0 + r][c] widened to float, zeros past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int gr = row0 + r;
    dst[r * (D + kPad) + c] = gr < rows ? to_f(src[static_cast<size_t>(gr) * D + c]) : 0.0f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int rows) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < rows ? src[row0 + r] : 0.0f;
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over [64][D + kPad] tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float acc[4][4]) {
  constexpr int ld = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// The scaled, masked score of query row r and key column c (global indices):
// the one definition shared by the three kernels, as `_masked_scores` is.
__device__ __forceinline__ float masked_score(float dot, float scale, int r, int c,
                                              int sk, bool causal) {
  const float s = dot * scale;
  return (c >= sk || (causal && r < c)) ? kMaskValue : s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------------ K2

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s_len, int sk_len,
                 int causal, float scale) {
  constexpr int ld = D + kPad;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* Ps = Vs + tile_floats<D>();  // [64][kPLd]: scores, then P
  float* m_s = Ps + kTile * kPLd;
  float* l_s = m_s + kTile;
  float* c_s = l_s + kTile;

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t q_off = static_cast<size_t>(bh) * s_len * D;
  const size_t k_off = static_cast<size_t>(bh) * sk_len * D;

  load_tile<T, D>(Qs, q + q_off, q0, s_len);
  for (int r = tid; r < kTile; r += kThreads) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int nk = (sk_len + kTile - 1) / kTile;
  // a key tile is live unless every (row, col) pair in it has col > row
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, D>(Ks, k + k_off, k0, sk_len);
    load_tile<T, D>(Vs, v + k_off, k0, sk_len);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] =
            masked_score(s[i][j], scale, q0 + ty + 16 * i, k0 + tx + 16 * j, sk_len, causal != 0);
    __syncthreads();

    // online softmax: one warp per 8 rows, two columns a lane
    for (int rr = 0; rr < kTile / 8; ++rr) {
      const int r = warp * (kTile / 8) + rr;
      const float s0 = Ps[r * kPLd + lane], s1 = Ps[r * kPLd + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      Ps[r * kPLd + lane] = round_to<T>(p0);
      Ps[r * kPLd + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + row_sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPLd + kk);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float v0 = Vs[(kk + 0) * ld + c], v1 = Vs[(kk + 1) * ld + c];
        const float v2 = Vs[(kk + 2) * ld + c], v3 = Vs[(kk + 3) * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(p[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(p[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(p[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(p[i].w, v3, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s_len) continue;
    const float l = l_s[r];
    const float safe_l = l > 0.0f ? l : 1.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[q_off + static_cast<size_t>(q0 + r) * D + tx + 16 * j] = from_f<T>(acc[i][j] / safe_l);
  }
  for (int r = tid; r < kTile; r += kThreads) {
    if (q0 + r >= s_len) continue;
    const float l = l_s[r];
    const float safe_l = l > 0.0f ? l : 1.0f;
    lse[static_cast<size_t>(bh) * s_len + q0 + r] = m_s[r] + logf(safe_l);
  }
}

// ------------------------------------------------------------------ K3

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s_len,
                    int sk_len, int causal, float scale) {
  constexpr int ld = D + kPad;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + tile_floats<D>();
  float* Ks = dOs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* dSs = Vs + tile_floats<D>();  // [64][kPLd]
  float* lse_s = dSs + kTile * kPLd;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_off = static_cast<size_t>(bh) * s_len * D;
  const size_t k_off = static_cast<size_t>(bh) * sk_len * D;
  const size_t row_off = static_cast<size_t>(bh) * s_len;

  load_tile<T, D>(Qs, q + q_off, q0, s_len);
  load_tile<T, D>(dOs, dout + q_off, q0, s_len);
  load_rows(lse_s, lse + row_off, q0, s_len);
  load_rows(delta_s, delta + row_off, q0, s_len);
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int nk = (sk_len + kTile - 1) / kTile;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, D>(Ks, k + k_off, k0, sk_len);
    load_tile<T, D>(Vs, v + k_off, k0, sk_len);
    __syncthreads();

    float s[4][4], dov[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dov);  // float32, as the TPU kernel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sc = masked_score(s[i][j], scale, q0 + r, k0 + c, sk_len, causal != 0);
        const float p = expf(sc - lse_s[r]);
        const float ds = p * (dov[i][j] - delta_s[r]) * scale;
        dSs[r * kPLd + c] = round_to<T>(ds);  // dS in k's type before dS K
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; kk += 4) {
      float4 ds4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds4[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * kPLd + kk);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float k0v = Ks[(kk + 0) * ld + c], k1v = Ks[(kk + 1) * ld + c];
        const float k2v = Ks[(kk + 2) * ld + c], k3v = Ks[(kk + 3) * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(ds4[i].x, k0v, acc[i][j]);
          acc[i][j] = fmaf(ds4[i].y, k1v, acc[i][j]);
          acc[i][j] = fmaf(ds4[i].z, k2v, acc[i][j]);
          acc[i][j] = fmaf(ds4[i].w, k3v, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s_len) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      dq[q_off + static_cast<size_t>(q0 + r) * D + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ------------------------------------------------------------------ K4

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int s_len, int sk_len, int causal, float scale) {
  constexpr int ld = D + kPad;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + tile_floats<D>();
  float* Qs = Vs + tile_floats<D>();
  float* dOs = Qs + tile_floats<D>();
  float* Ps = dOs + tile_floats<D>();   // [q][k], stride kPLd
  float* dSs = Ps + kTile * kPLd;       // [q][k], stride kPLd
  float* lse_s = dSs + kTile * kPLd;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles: first
  const int k0 = kt * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_off = static_cast<size_t>(bh) * s_len * D;
  const size_t k_off = static_cast<size_t>(bh) * sk_len * D;
  const size_t row_off = static_cast<size_t>(bh) * s_len;

  load_tile<T, D>(Ks, k + k_off, k0, sk_len);
  load_tile<T, D>(Vs, v + k_off, k0, sk_len);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const int nq = (s_len + kTile - 1) / kTile;
  // a query tile is live unless every (row, col) pair in it has col > row
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    load_tile<T, D>(Qs, q + q_off, q0, s_len);
    load_tile<T, D>(dOs, dout + q_off, q0, s_len);
    load_rows(lse_s, lse + row_off, q0, s_len);
    load_rows(delta_s, delta + row_off, q0, s_len);
    __syncthreads();

    float s[4][4], dov[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sc = masked_score(s[i][j], scale, q0 + r, k0 + c, sk_len, causal != 0);
        // query rows past the end hold zeros, not a softmax row: no weight
        const float p = q0 + r < s_len ? expf(sc - lse_s[r]) : 0.0f;
        Ps[r * kPLd + c] = p;
        dSs[r * kPLd + c] = p * (dov[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // this thread's key rows: ty + 16 i; its head-dim columns: tx + 16 j
    for (int qq = 0; qq < kTile; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[qq * kPLd + ty + 16 * i];
        ds[i] = dSs[qq * kPLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const float dov_c = dOs[qq * ld + c], q_c = Qs[qq * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], dov_c, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], q_c, dk_acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (k0 + r >= sk_len) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const size_t at = k_off + static_cast<size_t>(k0 + r) * D + tx + 16 * j;
      dk[at] = from_f<T>(dk_acc[i][j]);
      dv[at] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D> constexpr size_t fwd_smem() {
  return (3 * tile_floats<D>() + kTile * kPLd + 3 * kTile) * sizeof(float);
}
template <int D> constexpr size_t dq_smem() {
  return (4 * tile_floats<D>() + kTile * kPLd + 2 * kTile) * sizeof(float);
}
template <int D> constexpr size_t dkv_smem() {
  return (4 * tile_floats<D>() + 2 * kTile * kPLd + 2 * kTile) * sizeof(float);
}
static_assert(dkv_smem<kMaxHeadDim>() <= 232448, "K4 tile exceeds a block's shared memory");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* o;  // K2: O; K3: dQ; K4: dK
  void* dv;
  float* lse_out;
  int bh, s_len, sk_len, causal;
  float scale;
  cudaStream_t stream;
};

enum class Which { kFwd, kDq, kDkv };

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int D>
int launch(Which which, const Args& a) {
  const dim3 grid(a.bh, which == Which::kDkv ? (a.sk_len + kTile - 1) / kTile
                                             : (a.s_len + kTile - 1) / kTile);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int err = 0;
  if (which == Which::kFwd) {
    if ((err = opt_in(flash_fwd_kernel<T, D>, fwd_smem<D>())) != 0) return err;
    flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), a.stream>>>(
        q, k, v, static_cast<T*>(a.o), a.lse_out, a.s_len, a.sk_len, a.causal, a.scale);
  } else if (which == Which::kDq) {
    if ((err = opt_in(flash_bwd_dq_kernel<T, D>, dq_smem<D>())) != 0) return err;
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o),
        a.s_len, a.sk_len, a.causal, a.scale);
  } else {
    if ((err = opt_in(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>())) != 0) return err;
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.o),
        static_cast<T*>(a.dv), a.s_len, a.sk_len, a.causal, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int head_dim, Which which, const Args& a) {
  switch (head_dim) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 96: return launch<T, 96>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (0 = launched) or -1 for a (dtype, head_dim) with no kernel.
int dispatch(int dtype, int head_dim, Which which, const Args& a) {
  if (a.bh <= 0 || a.s_len <= 0 || a.sk_len <= 0) return 0;
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, which, a);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(head_dim, which, a);
  return -1;
}

}  // namespace

extern "C" {

int fedml_flash_max_head_dim() { return kMaxHeadDim; }
int fedml_flash_tile() { return kTile; }

// The caller guarantees: device pointers to contiguous [bh, s_len, head_dim]
// q, o, dout, dq; [bh, sk_len, head_dim] k, v, dk, dv; [bh, s_len] float32
// lse and delta; causal only with s_len == sk_len.
int fedml_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                    void* o, float* lse, int bh, int s_len, int sk_len, int causal,
                    float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, Which::kFwd, a);
}

int fedml_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta, void* dq,
                       int bh, int s_len, int sk_len, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, Which::kDq, a);
}

int fedml_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, void* dk,
                        void* dv, int bh, int s_len, int sk_len, int causal, float scale,
                        void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, Which::kDkv, a);
}

}  // extern "C"
