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
// rounded to the inputs' type once at the end.
//
// What bounds them on the H100: at the LM's shapes (S = 256, D = 96, bfloat16,
// causal) the ideal kernels are bound by bytes (~64-85 FLOP per byte moved,
// under the card's ~295 FLOP/byte bf16 ridge). Every kernel here runs its
// products on the tensor cores (mma.sync, float32 sums); two designs.
//
// Split-TF32 kernels, for float32 (`flash_fwd_f32tc_kernel`,
// `flash_bwd_dq_f32tc_kernel`, `flash_bwd_dkv_f32tc_kernel`): TF32 products
// alone keep 11 significant bits, but a float32 x splits into hi = tf32(x),
// rounded to nearest, and the exact remainder lo = x - hi (which the tensor
// core reads to TF32's 11 bits, so x - hi - lo stays within ~2^-21 |x|), and
// a product a b is then hi·lo + lo·hi + hi·hi: three mma.sync m16n8k8 TF32
// products with float32 sums ("3xTF32"), good to about 2^-20 relative
// against TF32's 2^-11. Every operand is split so, P and dS included (they
// are never rounded). At the H100's 495 TFLOP/s dense TF32, three products
// over the causal half take less than the functions' bytes, so the bound is
// the bytes; what holds the kernels back is the splits, integer and float
// instructions that every warp redoes on the operands it reads. Their
// layouts are the bf16 kernels' below with float32 tiles, which take twice
// the bytes: the loop's tiles are 32 rows (K2 and K3 walk 32-key K and V
// tiles, K4 32-query Q and dO tiles), so that two blocks share an SM up to
// D = 96 (see the kernels' notes).
//
// Tensor-core kernels, for bfloat16: K2 (`flash_fwd_tc_kernel`), K3 and K4
// (`flash_bwd_*_tc_kernel`). Same blocks and loops, but the products are
// mma.sync m16n8k16 (bf16 operands, float32 accumulation) fed by ldmatrix,
// and the row operations run on the accumulator fragments in registers
// (FlashAttention-2's layout):
//   - 4 warps a block, each owning 16 rows of the 64-row tile; K4 computes
//     S^T = K Q^T so that its rows are keys, and P^T, dS^T then sit in
//     registers as the A operand of dV += P^T dO and dK += dS^T Q;
//   - K2 keeps its warp's Q rows as A fragments in registers, and its online
//     softmax in registers too: a row's scores sit in the 4 lanes of a quad,
//     so its max and sum take two shuffles; P, rounded to bf16, is the A
//     operand of O += P V straight from the score accumulators;
//   - tiles stay bf16 in shared memory, rows padded by 16 bytes so ldmatrix's
//     8 rows fall in distinct banks for every D; K2's 5 tiles (~66 KB at
//     D = 96) let three blocks share an SM, K3's and K4's 6 tiles two;
//   - cp.async copies 16 bytes a thread (zero-filled past the end), double-
//     buffered: K2 and K3 prefetch the next K and V tiles, K4 the next Q and
//     dO tiles with their LSE and delta rows, while the block computes on the
//     current ones; O, dQ, dK, dV are staged through shared memory and stored
//     16 bytes a thread.
// Their numbers keep the reference's rounding points: S = Q K^T and dO V^T
// are products of bf16 inputs, which a bf16 mma computes exactly before its
// float32 sums. K2 sums l over the float32 p and rounds P to bf16 only for
// the P V mma; K3 rounds dS to bf16 for the dS K mma, as the reference does.
// K4 must not round P or dS: each is split into hi = bf16(x) and
// lo = bf16(x - hi) (|x - hi - lo| <= 2^-16 |x|) and multiplied as hi B + lo B,
// B (dO, Q) being exact in bf16. Tensor-core accumulation is not IEEE-order
// float32 (the sums run in another order, and within an mma the hardware's
// own), so the results agree with the float32 plain versions to one bf16
// ulp of the rounded values, not bit for bit.
//
// Both designs: under the causal mask only the tiles it leaves live are
// visited (about half the work), and the heaviest tiles are scheduled first;
// ragged edges (S not a multiple of the tile) are guarded: rows past the end load
// as zeros and are never stored, columns past the end are masked, and K4
// gives padded query rows no weight. Shared memory above 48 KB is opted into
// with cudaFuncSetAttribute. Built without --use_fast_math: expf, logf and
// the divisions are IEEE.
//
// Head dims: every kernel is instantiated for D in {16, 32, 64, 96, 128};
// above 128, the chunked kernels (`flash_*_wide_*`, see their section) take
// any multiple of 128, the output's head dim split over blocks (whole-d
// tiles would not fit: a 64-row float32 K4 tile of D = 256 alone takes
// ~67 KB); the float32 K3 and K4 up to d = 1024 are cluster kernels
// instead (`flash_bwd_*_cluster_f32tc_kernel`, see their section). The
// wrappers (ops/flash_attention.py `at_built_head_dim`) zero-pad any other
// d to the next of these and pass the true 1/sqrt(d) as `scale`: zero
// columns add nothing to Q K^T or dO V^T, so P, LSE and delta are the
// unpadded ones, and O, dQ, dK, dV are sliced back to d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;         // rows of a query tile and of a key tile
constexpr float kMaskValue = -1e30f;
constexpr int kMaxHeadDim = 128;

// The scaled, masked score of query row r and key column c (global indices):
// the one definition shared by the kernels, as `_masked_scores` is.
__device__ __forceinline__ float masked_score(float dot, float scale, int r, int c,
                                              int sk, bool causal) {
  const float s = dot * scale;
  return (c >= sk || (causal && r < c)) ? kMaskValue : s;
}

// Row operations on a warp's [16 x 8J] block held as mma accumulators, shared
// by every kernel below: lane l holds rows r0 = l / 4 (entries 0, 1) and
// r0 + 8 (2, 3) of the block at columns 8j + t2 + {0, 1}, t2 = 2 (l % 4); a
// row's entries sit in the 4 lanes of a quad.
template <int J>
__device__ __forceinline__ void zero_frags(float (&x)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

// s = Q K^T (query rows r0, r1; keys k0 + column) scaled, and masked where
// `edge` says the block holds masked pairs (the diagonal, the ragged end).
template <int J>
__device__ __forceinline__ void scale_scores(float (&s)[J][4], bool edge, float scale, int r0,
                                             int r1, int k0, int t2, int sk_len, bool causal) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = edge ? masked_score(s[j][e], scale, (e >> 1) ? r1 : r0, k0 + 8 * j + t2 + (e & 1),
                                    sk_len, causal)
                     : s[j][e] * scale;
}

// One online-softmax step: the scores s become p = exp(s - m_new), l sums
// the float32 p, and the running output acc is rescaled by exp(m - m_new).
template <int J, int N>
__device__ __forceinline__ void online_softmax(float (&s)[J][4], float (&m_run)[2],
                                               float (&l_run)[2], float (&acc)[N][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < J; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    const float corr = expf(m_run[h] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      s[j][2 * h] = expf(s[j][2 * h] - m_new);
      s[j][2 * h + 1] = expf(s[j][2 * h + 1] - m_new);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run[h] = l_run[h] * corr + sum;
    m_run[h] = m_new;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      acc[n][2 * h] *= corr;
      acc[n][2 * h + 1] *= corr;
    }
  }
}

// acc / l for the rows whose l > 0, and the rows' LSE (m + log l) through
// one lane of the quad.
template <int N>
__device__ __forceinline__ void finish_softmax(float (&acc)[N][4], const float (&m_run)[2],
                                               const float (&l_run)[2], float* lse_b, int r0,
                                               int r1, int s_len, bool write_lse, int t2) {
  float safe_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) safe_l[h] = l_run[h] > 0.0f ? l_run[h] : 1.0f;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] / safe_l[e >> 1];
  if (write_lse && t2 == 0) {
    if (r0 < s_len) lse_b[r0] = m_run[0] + logf(safe_l[0]);
    if (r1 < s_len) lse_b[r1] = m_run[1] + logf(safe_l[1]);
  }
}

// K3's dS = P (dO V^T - delta) scale with P = exp(S - LSE), written over
// dp = dO V^T, for query rows r0, r1 and keys k0 + column.
template <int J>
__device__ __forceinline__ void dq_scores(const float (&s)[J][4], float (&dp)[J][4],
                                          const float (&lse_r)[2], const float (&delta_r)[2],
                                          int r0, int r1, int k0, int t2, int sk_len, bool causal,
                                          float scale) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;  // 0: row r0, 1: row r1
      const float sc = masked_score(s[j][e], scale, h ? r1 : r0, k0 + 8 * j + t2 + (e & 1),
                                    sk_len, causal);
      const float p = expf(sc - lse_r[h]);
      dp[j][e] = p * (dp[j][e] - delta_r[h]) * scale;
    }
}

// K4's P^T and dS^T over S^T = K Q^T and V dO^T (rows: keys kr0, kr0 + 8;
// columns: queries q0 + column, whose LSE and delta rows are lse_s, delta_s).
// Query rows past the end hold zeros, not a softmax row: no weight.
template <int J>
__device__ __forceinline__ void dkv_scores(float (&p)[J][4], float (&ds)[J][4],
                                           const float* lse_s, const float* delta_s, int q0,
                                           int kr0, int t2, int s_len, int sk_len, bool causal,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + t2 + (e & 1);  // query column in the tile
      const float sc = masked_score(p[j][e], scale, q0 + c, kr0 + (e >> 1) * 8, sk_len, causal);
      const float pe = q0 + c < s_len ? expf(sc - lse_s[c]) : 0.0f;
      p[j][e] = pe;
      ds[j][e] = pe * (ds[j][e] - delta_s[c]) * scale;
    }
}

// ------------------------------------------------------------------ K2, K3, K4 (bf16): tensor cores

constexpr int kTcWarps = 4;                // a warp owns 16 rows of a 64-row tile
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcPad = 8;                  // row padding of a bf16 tile: 16 bytes
static_assert(kTcWarps * 16 == kTile, "a tile's rows are split across the warps");
static_assert(kTcThreads == 2 * kTile, "K4 copies its LSE and delta rows one thread a row");

template <int D> constexpr int tc_ld() { return D + kTcPad; }  // row stride, elements
template <int D> constexpr int tc_tile_bytes() { return kTile * tc_ld<D>() * 2; }

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zeros if !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and gets (row l / 4, columns 2 (l % 4) + {0, 1})
// of each (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8]: bf16 products, float32 sums. Lane l
// holds c at rows l / 4 (c0, c1) and l / 4 + 8 (c2, c3), columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) rounded to bf16 (nearest even), x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}
// x = hi + lo to within 2^-16 |x| (x normal): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Lane addresses of the x4 ldmatrix loads over a bf16 tile [64][tc_ld<D>]:
// the A operand (rows m0.., columns k0..k0+15) of one mma ...
template <int D>
__device__ __forceinline__ uint32_t a_frag(uint32_t tile, int m0, int k0, int lane) {
  return tile + ((m0 + (lane & 15)) * tc_ld<D>() + k0 + (lane >> 4) * 8) * 2;
}
// ... the B operands of two mmas (n0.., n0 + 8..) from a tile stored [n][k] ...
template <int D>
__device__ __forceinline__ uint32_t b_frag(uint32_t tile, int n0, int k0, int lane) {
  return tile + ((n0 + (lane & 7) + (lane >> 4) * 8) * tc_ld<D>() + k0 + ((lane >> 3) & 1) * 8) * 2;
}
// ... and from a tile stored [k][n] (loaded with .trans).
template <int D>
__device__ __forceinline__ uint32_t bt_frag(uint32_t tile, int k0, int n0, int lane) {
  return tile + ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * tc_ld<D>() + n0 + (lane >> 4) * 8) * 2;
}

// dst[r][:] = src[row0 + r][:D] for the 64 rows of a tile (src rows `ld`
// elements apart), 16 bytes a thread; rows past `rows` are zero-filled and
// read nothing.
template <int D>
__device__ __forceinline__ void cp_tile(uint32_t dst, const bf16* __restrict__ src, int row0,
                                        int rows, int ld = D) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kTile * kChunks % kTcThreads == 0, "a tile's chunks split evenly");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < rows;
    cp_async16(dst + (r * tc_ld<D>() + c * 8) * 2,
               src + static_cast<size_t>(valid ? row0 + r : 0) * ld + c * 8, valid);
  }
}

// The warp's [16 x 64] score blocks s = A1 B1^T and dp = A2 B2^T (added to
// s and dp with kAdd): A1, A2 [64][D] tiles of which the warp takes rows
// m0..m0+15, B1, B2 [64][D] tiles.
template <int D, bool kAdd = false>
__device__ __forceinline__ void score_pair(uint32_t a1, uint32_t b1, uint32_t a2, uint32_t b2,
                                           int m0, int lane, float (&s)[8][4],
                                           float (&dp)[8][4]) {
  if (!kAdd) zero_frags(s), zero_frags(dp);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t fa1[4], fa2[4], fb[4];
    ldsm_x4(fa1, a_frag<D>(a1, m0, kk, lane));
    ldsm_x4(fa2, a_frag<D>(a2, m0, kk, lane));
#pragma unroll
    for (int n = 0; n < kTile; n += 16) {
      ldsm_x4(fb, b_frag<D>(b1, n, kk, lane));
      mma_bf16(s[n / 8], fa1, fb[0], fb[1]);
      mma_bf16(s[n / 8 + 1], fa1, fb[2], fb[3]);
      ldsm_x4(fb, b_frag<D>(b2, n, kk, lane));
      mma_bf16(dp[n / 8], fa2, fb[0], fb[1]);
      mma_bf16(dp[n / 8 + 1], fa2, fb[2], fb[3]);
    }
  }
}

// The A operand of keys (or queries) k0..k0+15 of a [16 x 64] block held as
// mma accumulators: two adjacent n8 accumulators are one k16 A fragment.
__device__ __forceinline__ void a_from_acc(const float (&x)[8][4], int k0, uint32_t a[4]) {
  const int j = k0 / 8;
  a[0] = pack_bf16(x[j][0], x[j][1]);
  a[1] = pack_bf16(x[j][2], x[j][3]);
  a[2] = pack_bf16(x[j + 1][0], x[j + 1][1]);
  a[3] = pack_bf16(x[j + 1][2], x[j + 1][3]);
}
__device__ __forceinline__ void split_from_acc(const float (&x)[8][4], int k0, uint32_t hi[4],
                                               uint32_t lo[4]) {
  const int j = k0 / 8;
  split_bf16(x[j][0], x[j][1], hi[0], lo[0]);
  split_bf16(x[j][2], x[j][3], hi[1], lo[1]);
  split_bf16(x[j + 1][0], x[j + 1][1], hi[2], lo[2]);
  split_bf16(x[j + 1][2], x[j + 1][3], hi[3], lo[3]);
}

// acc[16 x D] += sum over the kParts A fragments of A [16 x 16] B, B rows
// k0..k0+15 of a [64][D] tile stored [k][n].
template <int D, int kParts>
__device__ __forceinline__ void acc_product(const uint32_t (&a)[kParts][4], uint32_t b, int k0,
                                            int lane, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D; n += 16) {
    uint32_t fb[4];
    ldsm_x4_trans(fb, bt_frag<D>(b, k0, n, lane));
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      mma_bf16(acc[n / 8], a[p], fb[0], fb[1]);
      mma_bf16(acc[n / 8 + 1], a[p], fb[2], fb[3]);
    }
  }
}

// Round the warp's [16 x D] accumulators to bf16 into its rows m0.. of a
// shared tile that only this warp reads, then store the rows below `rows`
// to out[row0 + m0 + r][:D] (out rows `out_ld` elements apart), 16 bytes a
// thread.
template <int D>
__device__ __forceinline__ void store_rows(bf16* tile, const float (&acc)[D / 8][4], int m0,
                                           int lane, bf16* __restrict__ out, int row0, int rows,
                                           int out_ld = D) {
  constexpr int ld = tc_ld<D>(), kChunks = D / 8;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(tile + (m0 + g) * ld + 8 * j + t2) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (m0 + g + 8) * ld + 8 * j + t2) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32, r = i / kChunks, c = i % kChunks;
    if (row0 + m0 + r < rows)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + m0 + r) * out_ld + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (m0 + r) * ld + c * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int s_len, int sk_len, int causal, float scale) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // Q, dO, then K and V double-buffered
  const uint32_t qs = smem_addr(tc_smem), dos = qs + kTileBytes;
  const uint32_t ks0 = dos + kTileBytes, vs0 = ks0 + 2 * kTileBytes;

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * D;
  const bf16* dob = dout + static_cast<size_t>(bh) * s_len * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * D;

  cp_tile<D>(qs, qb, q0, s_len);
  cp_tile<D>(dos, dob, q0, s_len);
  cp_tile<D>(ks0, kb, 0, sk_len);
  cp_tile<D>(vs0, vb, 0, sk_len);
  cp_async_commit();

  // this lane's query rows r0 (accumulators 0, 1) and r0 + 8 (2, 3)
  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;
  const float lse_r[2] = {r0 < s_len ? lse_b[r0] : 0.0f, r1 < s_len ? lse_b[r1] : 0.0f};
  const float delta_r[2] = {r0 < s_len ? delta_b[r0] : 0.0f, r1 < s_len ? delta_b[r1] : 0.0f};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int nk = (sk_len + kTile - 1) / kTile;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_end) {  // the next pair lands while this one is used
      cp_tile<D>(ks0 + (buf ^ 1) * kTileBytes, kb, (kt + 1) * kTile, sk_len);
      cp_tile<D>(vs0 + (buf ^ 1) * kTileBytes, vb, (kt + 1) * kTile, sk_len);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const uint32_t ks = ks0 + buf * kTileBytes, vs = vs0 + buf * kTileBytes;

    float s[8][4], ds[8][4];  // S, then dO V^T, then dS
    score_pair<D>(qs, ks, dos, vs, m0, lane, s, ds);
    dq_scores<8>(s, ds, lse_r, delta_r, r0, r1, kt * kTile, t2, sk_len, causal != 0, scale);
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t a[1][4];
      a_from_acc(ds, kk, a[0]);  // dS in k's type before dS K
      acc_product<D, 1>(a, ks, kk, lane, acc);
    }
    __syncthreads();
  }
  store_rows<D>(reinterpret_cast<bf16*>(tc_smem), acc, m0, lane,
                dq + static_cast<size_t>(bh) * s_len * D, q0, s_len);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len, int sk_len,
                        int causal, float scale) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // K, V, then Q, dO and the LSE and delta rows double-buffered
  const uint32_t ks = smem_addr(tc_smem), vs = ks + kTileBytes;
  const uint32_t qs0 = vs + kTileBytes, dos0 = qs0 + 2 * kTileBytes;
  float* rows_s = reinterpret_cast<float*>(tc_smem + 6 * kTileBytes);  // [2][lse, delta][64]
  const uint32_t rows0 = smem_addr(rows_s);

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles: first
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * D;
  const bf16* dob = dout + static_cast<size_t>(bh) * s_len * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * D;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;

  // query tile qt into buffer buf: Q, dO, and one LSE or delta row a thread
  auto load_q_tile = [&](int qt, int buf) {
    cp_tile<D>(qs0 + buf * kTileBytes, qb, qt * kTile, s_len);
    cp_tile<D>(dos0 + buf * kTileBytes, dob, qt * kTile, s_len);
    const int r = threadIdx.x % kTile, which = threadIdx.x / kTile;  // 0: LSE, 1: delta
    const bool valid = qt * kTile + r < s_len;
    cp_async4(rows0 + ((buf * 2 + which) * kTile + r) * 4,
              (which ? delta_b : lse_b) + (valid ? qt * kTile + r : 0), valid);
  };

  cp_tile<D>(ks, kb, k0, sk_len);
  cp_tile<D>(vs, vb, k0, sk_len);
  const int nq = (s_len + kTile - 1) / kTile;
  // a query tile is live unless every (row, col) pair in it has col > row
  const int qt_begin = causal ? kt : 0;
  load_q_tile(qt_begin, 0);
  cp_async_commit();

  // this lane's key rows kr0 (accumulators 0, 1) and kr0 + 8 (2, 3)
  const int kr0 = k0 + m0 + g;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int qt = qt_begin; qt < nq; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    if (qt + 1 < nq) load_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const uint32_t qs = qs0 + buf * kTileBytes, dos = dos0 + buf * kTileBytes;
    const float* lse_s = rows_s + buf * 2 * kTile;
    const float* delta_s = lse_s + kTile;

    float p[8][4], ds[8][4];  // S^T then P^T; V dO^T then dS^T
    score_pair<D>(ks, qs, vs, dos, m0, lane, p, ds);
    dkv_scores<8>(p, ds, lse_s, delta_s, qt * kTile, kr0, t2, s_len, sk_len, causal != 0, scale);
    // float32 P and dS, each as bf16 hi + lo: two mmas a product
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t a[2][4];
      split_from_acc(p, kk, a[0], a[1]);
      acc_product<D, 2>(a, dos, kk, lane, dv_acc);
      split_from_acc(ds, kk, a[0], a[1]);
      acc_product<D, 2>(a, qs, kk, lane, dk_acc);
    }
    __syncthreads();
  }
  bf16* tiles = reinterpret_cast<bf16*>(tc_smem);
  store_rows<D>(tiles, dk_acc, m0, lane, dk + static_cast<size_t>(bh) * sk_len * D, k0, sk_len);
  store_rows<D>(tiles + kTile * tc_ld<D>(), dv_acc, m0, lane,
                dv + static_cast<size_t>(bh) * sk_len * D, k0, sk_len);
}

// ------------------------------------------------------------------ K2 (bf16): tensor cores

// Three blocks an SM up to D = 96 (5 tiles, ~66 KB at D = 96, and at most
// 168 registers a thread); two at D = 128.
template <int D> constexpr int fwd_tc_blocks() { return D <= 96 ? 3 : 2; }

template <int D>
__global__ void __launch_bounds__(kTcThreads, fwd_tc_blocks<D>())
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int s_len, int sk_len, int causal, float scale) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // Q, then K and V double-buffered
  const uint32_t qs = smem_addr(tc_smem);
  const uint32_t ks0 = qs + kTileBytes, vs0 = ks0 + 2 * kTileBytes;

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * D;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * D;

  cp_tile<D>(qs, qb, q0, s_len);
  cp_tile<D>(ks0, kb, 0, sk_len);
  cp_tile<D>(vs0, vb, 0, sk_len);
  cp_async_commit();

  // this lane's query rows r0 (accumulators 0, 1) and r0 + 8 (2, 3); the
  // running max starts at the mask value, so the first correction is 0
  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.0f, 0.0f};
  uint32_t qf[D / 16][4];  // the warp's Q rows as A fragments, loaded once
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int nk = (sk_len + kTile - 1) / kTile;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_end) {  // the next pair lands while this one is used
      cp_tile<D>(ks0 + (buf ^ 1) * kTileBytes, kb, (kt + 1) * kTile, sk_len);
      cp_tile<D>(vs0 + (buf ^ 1) * kTileBytes, vb, (kt + 1) * kTile, sk_len);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const uint32_t ks = ks0 + buf * kTileBytes, vs = vs0 + buf * kTileBytes;
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) ldsm_x4(qf[kk / 16], a_frag<D>(qs, m0, kk, lane));
    }

    float s[8][4];  // S, then P
    zero_frags(s);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int n = 0; n < kTile; n += 16) {
        uint32_t fb[4];
        ldsm_x4(fb, b_frag<D>(ks, n, kk, lane));
        mma_bf16(s[n / 8], qf[kk / 16], fb[0], fb[1]);
        mma_bf16(s[n / 8 + 1], qf[kk / 16], fb[2], fb[3]);
      }
    const int k0 = kt * kTile;
    // only the diagonal tile and the ragged end hold masked (row, col) pairs
    const bool edge = k0 + kTile > sk_len || (causal && k0 + kTile - 1 > q0);
    scale_scores<8>(s, edge, scale, r0, r1, k0, t2, sk_len, causal != 0);
    online_softmax<8, D / 8>(s, m_run, l_run, acc);  // l sums the float32 p
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      uint32_t a[1][4];
      a_from_acc(s, kk, a[0]);  // P in v's type before P V
      acc_product<D, 1>(a, vs, kk, lane, acc);
    }
    __syncthreads();
  }

  finish_softmax<D / 8>(acc, m_run, l_run, lse + static_cast<size_t>(bh) * s_len, r0, r1, s_len,
                        true, t2);
  // the warp's own rows of the Q tile, whose fragments it already holds
  store_rows<D>(reinterpret_cast<bf16*>(tc_smem), acc, m0, lane,
                o + static_cast<size_t>(bh) * s_len * D, q0, s_len);
}

// ------------------------------------------------------------------ K2, K3, K4 (float32): split-TF32 tensor cores

constexpr int kF32Keys = 32;   // K2, K3: keys of a K or V tile; K4: queries of a Q or dO tile
constexpr int kF32QkPad = 8;   // rows read as 8-byte pairs: D + 8 floats
constexpr int kF32VPad = 4;    // K2's V rows: D + 4 floats

// Row strides (floats). A lane reads A and B fragments of a product over the
// head dim as 8-byte pairs at row g, column 2t (g = lane / 4, t = lane % 4):
// a stride of 8 mod 32 words puts a half-warp's 16 pairs in distinct banks.
// It reads the B operand of a product over keys (K2's V, K3's K, K4's Q and
// dO) at rows 2t and 2t + 1, column g: a stride of 4 mod 32 does the same
// for those 4-byte loads. K2's V is read only so; K3's K and K4's Q and dO
// are read both ways and take D + 8, whose 2-way conflicts on the second
// cost as many shared-memory wavefronts as D + 4's on the first.
template <int D> constexpr int f32_qk_ld() { return D + kF32QkPad; }
template <int D> constexpr int f32_v_ld() { return D + kF32VPad; }
template <int D> constexpr size_t fwd_f32_smem() {  // Q, K double-buffered, V
  return (static_cast<size_t>(kTile) * f32_qk_ld<D>() +
          kF32Keys * (2 * f32_qk_ld<D>() + f32_v_ld<D>())) * sizeof(float);
}
template <int D> constexpr size_t dq_f32_smem() {  // Q, dO; K and V double-buffered
  return static_cast<size_t>(2 * kTile + 4 * kF32Keys) * f32_qk_ld<D>() * sizeof(float);
}
template <int D> constexpr size_t dkv_f32_smem() {  // K, V; Q, dO, LSE, delta double-buffered
  return (static_cast<size_t>(2 * kTile + 4 * kF32Keys) * f32_qk_ld<D>() + 4 * kF32Keys) *
         sizeof(float);
}

// x = hi + lo. hi is x rounded to TF32 (10 mantissa bits) to nearest, ties
// away, as cvt.rna.tf32.f32 rounds it, in two integer instructions (the
// conversion takes a slower pipe: 0.123 ms against 0.093 for this K2 at
// [256, 256, 96] causal, NVIDIA H100 80GB HBM3). lo = x - hi is exact, at
// most 2^-11 |x|, and goes to the tensor core as it is: the mma reads the
// top 19 bits of a TF32 operand, so lo loses at most 2^-10 of itself.
// Rounding hi matters: truncated, x - hi could reach 2^-10 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] b[8 x 8]: TF32 products, float32 sums. Lane l
// holds a at (row g, k-slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and b
// at (k-slot t, column g), (t + 4, g), g = l / 4, t = l % 4; c as mma_bf16.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for float32 a and b split into TF32 pairs (3xTF32): the two small
// cross terms first, then hi·hi; lo·lo (~2^-22 relative) is dropped.
__device__ __forceinline__ void mma_split(float c[4], const uint32_t ahi[4], const uint32_t alo[4],
                                          const uint32_t bhi[2], const uint32_t blo[2]) {
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

// c += a b as mma_split, the product summed apart from c, from zero, and
// added to c by float32 adds, rounded to nearest: the scores of the chunked
// kernels, summed over d deep. Summed into c by the tensor core, their
// error grew with d: K3's dQ took 0.93 of FLASH_TOL at d = 256 and 1.09 to
// 1.23 at 384 and 512, K4's dK 1.04 at 512; summed apart, no output takes
// more than 0.42 at any of them (NVIDIA H100 80GB HBM3). A step's own sum
// is 8 products deep. The adds cost the float32 chunked kernels 40-75% of
// their time at [256, 256, 256] causal.
__device__ __forceinline__ void mma_split_rn(float c[4], const uint32_t ahi[4],
                                             const uint32_t alo[4], const uint32_t bhi[2],
                                             const uint32_t blo[2]) {
  float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_split(u, ahi, alo, bhi, blo);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += u[r];
}

// The operands of a product over the head dim, k8 step kk: k-slots t and
// t + 4 are columns kk + 2t and kk + 2t + 1, read as one 8-byte pair a row
// (the permutation only reorders a sum). The split A fragment of rows
// m0 + g and m0 + g + 8 of a float32 tile ...
template <int kLd>
__device__ __forceinline__ void a_split(const float* tile, int m0, int kk, int g, int t,
                                        uint32_t hi[4], uint32_t lo[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(tile + (m0 + g) * kLd + kk + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(tile + (m0 + g + 8) * kLd + kk + 2 * t);
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}
// ... and the split B fragment of row n0 + g of a tile stored [n][k].
template <int kLd>
__device__ __forceinline__ void b_split(const float* tile, int n0, int kk, int g, int t,
                                        uint32_t hi[2], uint32_t lo[2]) {
  const float2 x = *reinterpret_cast<const float2*>(tile + (n0 + g) * kLd + kk + 2 * t);
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
}

// The split A fragment of a product over the columns of a [16 x 8j..] block
// held as accumulators: accumulator x holds columns 8j + 2t and 8j + 2t + 1
// of rows g, g + 8, which become k-slots t and t + 4 with no shuffle.
__device__ __forceinline__ void a_split_acc(const float x[4], uint32_t hi[4], uint32_t lo[4]) {
  split_tf32(x[0], hi[0], lo[0]);
  split_tf32(x[2], hi[1], lo[1]);
  split_tf32(x[1], hi[2], lo[2]);
  split_tf32(x[3], hi[3], lo[3]);
}

// acc[16 x D] += A B for that A (k8 step k0) and B rows k0 + 2t, k0 + 2t + 1
// (its k-slots t, t + 4) of a float32 tile stored [k][n], column 8n + g.
template <int D, int kLd>
__device__ __forceinline__ void acc_split_product(const uint32_t ahi[4], const uint32_t alo[4],
                                                  const float* tile, int k0, int g, int t,
                                                  float (&acc)[D / 8][4]) {
  const float* row = tile + (k0 + 2 * t) * kLd + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    uint32_t bhi[2], blo[2];
    split_tf32(row[8 * n], bhi[0], blo[0]);
    split_tf32(row[kLd + 8 * n], bhi[1], blo[1]);
    mma_split(acc[n], ahi, alo, bhi, blo);
  }
}

// The warp's [16 x 32] blocks s = A1 B1^T and dp = A2 B2^T over the head
// dim (dp left alone without kPair): A1, A2 float32 tiles of which the warp
// takes rows m0..m0+15, B1, B2 [32][D] tiles, all at row stride kLd. With
// kChunk (the chunked kernels: one d-chunk of the scores) added to s and
// dp, each k8 step by mma_split_rn.
template <int D, int kLd, bool kChunk = false, bool kPair = true>
__device__ __forceinline__ void score_pair_f32(const float* a1, const float* b1, const float* a2,
                                               const float* b2, int m0, int g, int t,
                                               float (&s)[kF32Keys / 8][4],
                                               float (&dp)[kF32Keys / 8][4]) {
  if (!kChunk) zero_frags(s), zero_frags(dp);
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ahi[4], alo[4], bhi[2], blo[2];
    a_split<kLd>(a1, m0, kk, g, t, ahi, alo);
#pragma unroll
    for (int j = 0; j < kF32Keys / 8; ++j) {
      b_split<kLd>(b1, 8 * j, kk, g, t, bhi, blo);
      if (kChunk) mma_split_rn(s[j], ahi, alo, bhi, blo);
      else mma_split(s[j], ahi, alo, bhi, blo);
    }
    if (!kPair) continue;
    a_split<kLd>(a2, m0, kk, g, t, ahi, alo);
#pragma unroll
    for (int j = 0; j < kF32Keys / 8; ++j) {
      b_split<kLd>(b2, 8 * j, kk, g, t, bhi, blo);
      if (kChunk) mma_split_rn(dp[j], ahi, alo, bhi, blo);
      else mma_split(dp[j], ahi, alo, bhi, blo);
    }
  }
}

// dst[r][:] = src[row0 + r][:D] for kRows rows of D floats at a row stride
// of kLd floats (src rows `ld` floats apart), 16 bytes a thread; rows past
// `rows` are zero-filled.
template <int D, int kRows, int kLd>
__device__ __forceinline__ void cp_tile_f32(uint32_t dst, const float* __restrict__ src, int row0,
                                            int rows, int ld = D) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static_assert(kRows * kChunks % kTcThreads == 0, "a tile's chunks split evenly");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < rows;
    cp_async16(dst + (r * kLd + c * 4) * 4,
               src + static_cast<size_t>(valid ? row0 + r : 0) * ld + c * 4, valid);
  }
}

// The warp's [16 x D] accumulators, rows row0 + g (0, 1) and row0 + g + 8
// (2, 3), columns 8n + 2t, + 1, stored as 8-byte pairs to out (rows
// `out_ld` floats apart) where the row lies below `rows`.
template <int D>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 8][4],
                                               float* __restrict__ out, int row0, int rows,
                                               int g, int t, int out_ld = D) {
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < rows)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r0) * out_ld + 8 * n + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
    if (r1 < rows)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r1) * out_ld + 8 * n + 2 * t) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// K2 for float32. The bf16 kernel's layout (4 warps of 16 query rows, the
// online softmax on the accumulator fragments) with m16n8k8 TF32 products,
// each operand split into hi + lo and multiplied as three products. Keys come
// in tiles of 32, K double-buffered and V single: Q, K and V, all float32,
// then take 66 KB at D = 96, and three blocks share an SM (double-buffered
// V: 79 KB, two blocks, 0.092 ms against 0.087 at [256, 256, 96] causal on
// NVIDIA H100 80GB HBM3). The next V tile is copied once every warp is
// done with this one and lands during the next tile's Q·K^T. Q stays in
// shared memory and its fragments are split again at every k-step (held in
// registers they would take D registers a thread). P·V takes P straight
// from the score accumulators (`a_split_acc`) and reads V's keys in the
// lane's slot order.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 3)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int s_len, int sk_len, int causal, float scale) {
  constexpr int kQkLd = f32_qk_ld<D>(), kVLd = f32_v_ld<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const float* q_sh = reinterpret_cast<const float*>(tc_smem);
  const float* k_sh0 = q_sh + kTile * kQkLd;
  const float* v_sh = k_sh0 + 2 * kF32Keys * kQkLd;
  const uint32_t qs = smem_addr(q_sh), ks0 = smem_addr(k_sh0), vs = smem_addr(v_sh);

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<size_t>(bh) * s_len * D;
  const float* kb = k + static_cast<size_t>(bh) * sk_len * D;
  const float* vb = v + static_cast<size_t>(bh) * sk_len * D;

  cp_tile_f32<D, kTile, kQkLd>(qs, qb, q0, s_len);
  cp_tile_f32<D, kF32Keys, kQkLd>(ks0, kb, 0, sk_len);
  cp_async_commit();
  cp_tile_f32<D, kF32Keys, kVLd>(vs, vb, 0, sk_len);
  cp_async_commit();

  // this lane's query rows r0 (accumulators 0, 1) and r0 + 8 (2, 3); the
  // running max starts at the mask value, so the first correction is 0
  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int nk = (sk_len + kF32Keys - 1) / kF32Keys;
  // a key tile is live unless every (row, col) pair of the query tile has col > row
  const int k_end = causal ? min(nk, (q0 + kTile - 1) / kF32Keys + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_end)  // the next K lands while this one is used
      cp_tile_f32<D, kF32Keys, kQkLd>(ks0 + (buf ^ 1) * kF32Keys * kQkLd * 4, kb,
                                      (kt + 1) * kF32Keys, sk_len);
    cp_async_commit();
    // copies in flight, oldest first: this K, this V, the next K
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");  // this K has landed
    __syncthreads();
    const int k0 = kt * kF32Keys;
    // A warp whose 16 rows all lie above the tile's keys under the causal
    // mask would add p = 0 with a correction of 1: it skips the tile. Its
    // rows have seen key 0 already, so their running max is finite.
    const bool live = !causal || k0 <= q0 + m0 + 15;
    const float* ksh = k_sh0 + buf * kF32Keys * kQkLd;
    float s[kF32Keys / 8][4];  // S, then P
    if (live) {
      zero_frags(s);
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        a_split<kQkLd>(q_sh, m0, kk, g, t, ahi, alo);
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          b_split<kQkLd>(ksh, 8 * j, kk, g, t, bhi, blo);
          mma_split(s[j], ahi, alo, bhi, blo);
        }
      }
      // only tiles on the diagonal and the ragged end hold masked pairs
      const bool edge = k0 + kF32Keys > sk_len || (causal && k0 + kF32Keys - 1 > q0 + m0);
      scale_scores<kF32Keys / 8>(s, edge, scale, r0, r1, k0, 2 * t, sk_len, causal != 0);
      online_softmax<kF32Keys / 8, D / 8>(s, m_run, l_run, acc);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this V has landed
    __syncthreads();
    if (live) {
      // O += P V, P kept in float32 (as hi + lo)
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        uint32_t phi[4], plo[4];
        a_split_acc(s[j], phi, plo);
        acc_split_product<D, kVLd>(phi, plo, v_sh, 8 * j, g, t, acc);
      }
    }
    __syncthreads();  // every warp is done with V and with this K
    if (kt + 1 < k_end) cp_tile_f32<D, kF32Keys, kVLd>(vs, vb, (kt + 1) * kF32Keys, sk_len);
    cp_async_commit();
  }

  finish_softmax<D / 8>(acc, m_run, l_run, lse + static_cast<size_t>(bh) * s_len, r0, r1, s_len,
                        true, 2 * t);
  store_rows_f32<D>(acc, o + static_cast<size_t>(bh) * s_len * D, q0 + m0, s_len, g, t);
}

// K3 for float32: the bf16 K3's layout (4 warps of 16 query rows, the row
// operations on the accumulator fragments) on split-TF32 products. Keys come
// in tiles of 32, K and V double-buffered: Q, dO and four 32-key tiles take
// 104 KB at D = 96, two blocks an SM (139 KB and one at D = 128). A warp
// computes S = Q K^T and dO V^T (`score_pair_f32`), P = exp(S - LSE) and
// dS = P (dO V^T - delta) scale on its fragments, and dQ += dS K with dS,
// kept in float32 (the reference rounds it to k's type, float32 here), as
// the A operand straight from the accumulators. A warp whose rows all lie
// above a tile's keys under the causal mask has P = 0 there and skips it.
// Its time follows its mma.sync count, not its splits or its mma chains
// (NVIDIA H100 80GB HBM3, [256, 256, 96] causal, against 0.1198-0.1208 ms
// for this kernel and 0.1683-0.1694 for K4 in the same calls): K and V (K4:
// Q and dO) split once a tile by the threads that copied them, hi in place
// and lo beside it, single-buffered for room, 0.1228 (K4 0.1728); the cross
// terms summed in accumulators of their own, 0.1213 (K4 0.1699).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int s_len, int sk_len, int causal,
                          float scale) {
  constexpr int kLd = f32_qk_ld<D>(), kKvFloats = kF32Keys * kLd;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // Q, dO, then K and V double-buffered
  const float* q_sh = reinterpret_cast<const float*>(tc_smem);
  const float* do_sh = q_sh + kTile * kLd;
  const float* k_sh0 = do_sh + kTile * kLd;
  const float* v_sh0 = k_sh0 + 2 * kKvFloats;

  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + static_cast<size_t>(bh) * sk_len * D;
  const float* vb = v + static_cast<size_t>(bh) * sk_len * D;

  cp_tile_f32<D, kTile, kLd>(smem_addr(q_sh), q + static_cast<size_t>(bh) * s_len * D, q0, s_len);
  cp_tile_f32<D, kTile, kLd>(smem_addr(do_sh), dout + static_cast<size_t>(bh) * s_len * D, q0,
                             s_len);
  cp_tile_f32<D, kF32Keys, kLd>(smem_addr(k_sh0), kb, 0, sk_len);
  cp_tile_f32<D, kF32Keys, kLd>(smem_addr(v_sh0), vb, 0, sk_len);
  cp_async_commit();

  // this lane's query rows r0 (accumulators 0, 1) and r0 + 8 (2, 3)
  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;
  const float lse_r[2] = {r0 < s_len ? lse_b[r0] : 0.0f, r1 < s_len ? lse_b[r1] : 0.0f};
  const float delta_r[2] = {r0 < s_len ? delta_b[r0] : 0.0f, r1 < s_len ? delta_b[r1] : 0.0f};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int nk = (sk_len + kF32Keys - 1) / kF32Keys;
  // a key tile is live unless every (row, col) pair of the query tile has col > row
  const int k_end = causal ? min(nk, (q0 + kTile - 1) / kF32Keys + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_end) {  // the next pair lands while this one is used
      cp_tile_f32<D, kF32Keys, kLd>(smem_addr(k_sh0 + (buf ^ 1) * kKvFloats), kb,
                                    (kt + 1) * kF32Keys, sk_len);
      cp_tile_f32<D, kF32Keys, kLd>(smem_addr(v_sh0 + (buf ^ 1) * kKvFloats), vb,
                                    (kt + 1) * kF32Keys, sk_len);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const int k0 = kt * kF32Keys;
    if (!causal || k0 <= q0 + m0 + 15) {
      const float* ksh = k_sh0 + buf * kKvFloats;
      float s[kF32Keys / 8][4], ds[kF32Keys / 8][4];  // S; dO V^T, then dS
      score_pair_f32<D, kLd>(q_sh, ksh, do_sh, v_sh0 + buf * kKvFloats, m0, g, t, s, ds);
      dq_scores<kF32Keys / 8>(s, ds, lse_r, delta_r, r0, r1, k0, 2 * t, sk_len, causal != 0,
                              scale);
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        uint32_t hi[4], lo[4];
        a_split_acc(ds[j], hi, lo);
        acc_split_product<D, kLd>(hi, lo, ksh, 8 * j, g, t, acc);
      }
    }
    __syncthreads();
  }
  store_rows_f32<D>(acc, dq + static_cast<size_t>(bh) * s_len * D, q0 + m0, s_len, g, t);
}

// K4 for float32: the bf16 K4's layout (4 warps of 16 keys of a 64-key
// tile, S^T = K Q^T so that P^T and dS^T sit in registers as the A operand
// of dV += P^T dO and dK += dS^T Q) on split-TF32 products. Queries come in
// tiles of 32, Q and dO double-buffered with their LSE and delta rows: K,
// V and four 32-row tiles take 105 KB at D = 96, two blocks an SM (137 KB
// and one at D = 128); 32-row tiles also halve the P and dS accumulators
// beside dK's and dV's D floats a lane each. P and dS stay float32 and are
// split like any operand. A warp whose keys all lie past a tile's queries
// under the causal mask has P = 0 there and skips it.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int s_len, int sk_len,
                           int causal, float scale) {
  constexpr int kLd = f32_qk_ld<D>(), kQFloats = kF32Keys * kLd;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // K, V, then Q, dO and the LSE and delta rows double-buffered
  const float* k_sh = reinterpret_cast<const float*>(tc_smem);
  const float* v_sh = k_sh + kTile * kLd;
  const float* q_sh0 = v_sh + kTile * kLd;
  const float* do_sh0 = q_sh0 + 2 * kQFloats;
  const float* rows_sh = do_sh0 + 2 * kQFloats;  // [2][lse, delta][32]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles: first
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<size_t>(bh) * s_len * D;
  const float* dob = dout + static_cast<size_t>(bh) * s_len * D;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;

  // query tile qt into buffer buf: Q, dO, and one LSE or delta row a thread
  auto load_q_tile = [&](int qt, int buf) {
    cp_tile_f32<D, kF32Keys, kLd>(smem_addr(q_sh0 + buf * kQFloats), qb, qt * kF32Keys, s_len);
    cp_tile_f32<D, kF32Keys, kLd>(smem_addr(do_sh0 + buf * kQFloats), dob, qt * kF32Keys, s_len);
    if (threadIdx.x < 2 * kF32Keys) {
      const int r = threadIdx.x % kF32Keys, which = threadIdx.x / kF32Keys;  // 0: LSE, 1: delta
      const bool valid = qt * kF32Keys + r < s_len;
      cp_async4(smem_addr(rows_sh + (buf * 2 + which) * kF32Keys + r),
                (which ? delta_b : lse_b) + (valid ? qt * kF32Keys + r : 0), valid);
    }
  };

  cp_tile_f32<D, kTile, kLd>(smem_addr(k_sh), k + static_cast<size_t>(bh) * sk_len * D, k0,
                             sk_len);
  cp_tile_f32<D, kTile, kLd>(smem_addr(v_sh), v + static_cast<size_t>(bh) * sk_len * D, k0,
                             sk_len);
  const int nq = (s_len + kF32Keys - 1) / kF32Keys;
  // a query tile is live unless every (row, col) pair in it has col > row
  const int qt_begin = causal ? k0 / kF32Keys : 0;
  load_q_tile(qt_begin, 0);
  cp_async_commit();

  // this lane's keys kr0 (accumulators 0, 1) and kr0 + 8 (2, 3)
  const int kr0 = k0 + m0 + g;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int qt = qt_begin; qt < nq; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    if (qt + 1 < nq) load_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const int q0 = qt * kF32Keys;
    if (!causal || q0 + kF32Keys - 1 >= k0 + m0) {
      const float* qsh = q_sh0 + buf * kQFloats;
      const float* dosh = do_sh0 + buf * kQFloats;
      const float* lse_s = rows_sh + buf * 2 * kF32Keys;
      const float* delta_s = lse_s + kF32Keys;
      float p[kF32Keys / 8][4], ds[kF32Keys / 8][4];  // S^T then P^T; V dO^T then dS^T
      score_pair_f32<D, kLd>(k_sh, qsh, v_sh, dosh, m0, g, t, p, ds);
      dkv_scores<kF32Keys / 8>(p, ds, lse_s, delta_s, q0, kr0, 2 * t, s_len, sk_len, causal != 0,
                               scale);
#pragma unroll
      for (int j = 0; j < kF32Keys / 8; ++j) {
        uint32_t hi[4], lo[4];
        a_split_acc(p[j], hi, lo);
        acc_split_product<D, kLd>(hi, lo, dosh, 8 * j, g, t, dv_acc);
        a_split_acc(ds[j], hi, lo);
        acc_split_product<D, kLd>(hi, lo, qsh, 8 * j, g, t, dk_acc);
      }
    }
    __syncthreads();
  }
  store_rows_f32<D>(dk_acc, dk + static_cast<size_t>(bh) * sk_len * D, k0 + m0, sk_len, g, t);
  store_rows_f32<D>(dv_acc, dv + static_cast<size_t>(bh) * sk_len * D, k0 + m0, sk_len, g, t);
}

// ------------------------------------------------------------------ K2, K3, K4 above D = 128: head-dim chunks

// For a head dim d above kMaxHeadDim (d a multiple of kWide; the wrappers
// zero-pad any other d), each output is split by columns into d / kWide
// chunks and grid dimension z names the block's chunk cc: K2 computes
// O[:, cc], K3 dQ[:, cc], K4 dK[:, cc] and dV[:, cc] (float32: one of the
// two, see its kernel). Every block forms its
// scores over the whole d, by a loop over the d-chunks of its score
// operands (Q and K; K3, K4 also dO and V) through shared memory, one step a
// (tile, chunk) pair, double-buffered, the chunks in order 0, 1, ...: every
// chunk block of a tile sums the same products in the same order, so their
// S (and dO V^T) are equal bit for bit, and so are their P, l and dS. The B
// operands of the output products, the block's own chunk cc of V (K2), K
// (K3), or Q and dO (K4), are loaded with the tile's last chunk, into an
// own slot beside the two buffers where chunk nc - 1 is not theirs. The
// tiles, registers and products are those of the kernels above at
// D = kWide, and each block recomputes the scores: the score products cost
// d / kWide times theirs. K2's chunk-0 block writes the LSE.
constexpr int kWide = 128;

// step i of a loop over (tile, chunk) pairs, the chunks of a tile in order
struct WideStep {
  int tile, chunk;
  bool last;  // the tile's last chunk: its scores are whole
  __device__ __forceinline__ WideStep(int i, int nc)
      : tile(i / nc), chunk(i % nc), last(i % nc == nc - 1) {}
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int s_len, int sk_len, int causal, float scale,
                         int d) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t smem0 = smem_addr(tc_smem);  // two buffers of Q, K, V chunks

  const int bh = blockIdx.x, nc = d / D, cc = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * d;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * d + cc * D;

  const int nk = (sk_len + kTile - 1) / kTile;
  const int steps = (causal ? min(nk, qt + 1) : nk) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    const uint32_t base = smem0 + buf * 3 * kTileBytes;
    cp_tile<D>(base, qb + st.chunk * D, q0, s_len, d);
    cp_tile<D>(base + kTileBytes, kb + st.chunk * D, st.tile * kTile, sk_len, d);
    if (st.last) cp_tile<D>(base + 2 * kTileBytes, vb, st.tile * kTile, sk_len, d);
  };
  load(0, 0);
  cp_async_commit();

  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.0f, 0.0f};
  float acc[D / 8][4], s[8][4];  // s: S over the chunks so far, then P
  zero_frags(acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const uint32_t qs = smem0 + buf * 3 * kTileBytes, ks = qs + kTileBytes, vs = ks + kTileBytes;
    if (st.chunk == 0) zero_frags(s);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qf[4];
      ldsm_x4(qf, a_frag<D>(qs, m0, kk, lane));
#pragma unroll
      for (int n = 0; n < kTile; n += 16) {
        uint32_t fb[4];
        ldsm_x4(fb, b_frag<D>(ks, n, kk, lane));
        mma_bf16(s[n / 8], qf, fb[0], fb[1]);
        mma_bf16(s[n / 8 + 1], qf, fb[2], fb[3]);
      }
    }
    if (st.last) {
      const int k0 = st.tile * kTile;
      const bool edge = k0 + kTile > sk_len || (causal && k0 + kTile - 1 > q0);
      scale_scores<8>(s, edge, scale, r0, r1, k0, t2, sk_len, causal != 0);
      online_softmax<8, D / 8>(s, m_run, l_run, acc);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t a[1][4];
        a_from_acc(s, kk, a[0]);  // P in v's type before P V
        acc_product<D, 1>(a, vs, kk, lane, acc);
      }
    }
    __syncthreads();
  }
  finish_softmax<D / 8>(acc, m_run, l_run, lse + static_cast<size_t>(bh) * s_len, r0, r1, s_len,
                        cc == 0, t2);
  store_rows<D>(reinterpret_cast<bf16*>(tc_smem), acc, m0, lane,
                o + static_cast<size_t>(bh) * s_len * d + cc * D, q0, s_len, d);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int s_len, int sk_len, int causal, float scale,
                            int d) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // two buffers of Q, dO, K, V chunks; then the own slot, K's chunk cc
  const uint32_t smem0 = smem_addr(tc_smem), own = smem0 + 8 * kTileBytes;

  const int bh = blockIdx.x, nc = d / D, cc = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * d;
  const bf16* dob = dout + static_cast<size_t>(bh) * s_len * d;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * d;

  const int nk = (sk_len + kTile - 1) / kTile;
  const int steps = (causal ? min(nk, qt + 1) : nk) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    const uint32_t base = smem0 + buf * 4 * kTileBytes;
    cp_tile<D>(base, qb + st.chunk * D, q0, s_len, d);
    cp_tile<D>(base + kTileBytes, dob + st.chunk * D, q0, s_len, d);
    cp_tile<D>(base + 2 * kTileBytes, kb + st.chunk * D, st.tile * kTile, sk_len, d);
    cp_tile<D>(base + 3 * kTileBytes, vb + st.chunk * D, st.tile * kTile, sk_len, d);
    if (st.last && cc != nc - 1) cp_tile<D>(own, kb + cc * D, st.tile * kTile, sk_len, d);
  };
  load(0, 0);
  cp_async_commit();

  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;
  const float lse_r[2] = {r0 < s_len ? lse_b[r0] : 0.0f, r1 < s_len ? lse_b[r1] : 0.0f};
  const float delta_r[2] = {r0 < s_len ? delta_b[r0] : 0.0f, r1 < s_len ? delta_b[r1] : 0.0f};
  float acc[D / 8][4], s[8][4], ds[8][4];  // S; dO V^T, then dS
  zero_frags(acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const uint32_t qs = smem0 + buf * 4 * kTileBytes, dos = qs + kTileBytes;
    const uint32_t ks = dos + kTileBytes, vs = ks + kTileBytes;
    if (st.chunk == 0) zero_frags(s), zero_frags(ds);
    score_pair<D, true>(qs, ks, dos, vs, m0, lane, s, ds);
    if (st.last) {
      dq_scores<8>(s, ds, lse_r, delta_r, r0, r1, st.tile * kTile, t2, sk_len, causal != 0, scale);
      const uint32_t k_cc = cc == nc - 1 ? ks : own;
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t a[1][4];
        a_from_acc(ds, kk, a[0]);  // dS in k's type before dS K
        acc_product<D, 1>(a, k_cc, kk, lane, acc);
      }
    }
    __syncthreads();
  }
  store_rows<D>(reinterpret_cast<bf16*>(tc_smem), acc, m0, lane,
                dq + static_cast<size_t>(bh) * s_len * d + cc * D, q0, s_len, d);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len, int sk_len,
                             int causal, float scale, int d) {
  constexpr int kTileBytes = tc_tile_bytes<D>();
  constexpr int kBufBytes = 4 * kTileBytes + 2 * kTile * 4;  // K, V, Q, dO chunks; LSE, delta
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // two buffers; then the own slot, Q's and dO's chunk cc
  const uint32_t smem0 = smem_addr(tc_smem), own = smem0 + 2 * kBufBytes;

  const int bh = blockIdx.x, nc = d / D, cc = blockIdx.z;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles: first
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bf16* qb = q + static_cast<size_t>(bh) * s_len * d;
  const bf16* dob = dout + static_cast<size_t>(bh) * s_len * d;
  const bf16* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const bf16* vb = v + static_cast<size_t>(bh) * sk_len * d;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;

  const int nq = (s_len + kTile - 1) / kTile;
  // a query tile is live unless every (row, col) pair in it has col > row
  const int qt_begin = causal ? kt : 0;
  const int steps = (nq - qt_begin) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    const int q0 = (qt_begin + st.tile) * kTile;
    const uint32_t base = smem0 + buf * kBufBytes;
    cp_tile<D>(base, kb + st.chunk * D, k0, sk_len, d);
    cp_tile<D>(base + kTileBytes, vb + st.chunk * D, k0, sk_len, d);
    cp_tile<D>(base + 2 * kTileBytes, qb + st.chunk * D, q0, s_len, d);
    cp_tile<D>(base + 3 * kTileBytes, dob + st.chunk * D, q0, s_len, d);
    if (st.last && cc != nc - 1) {
      cp_tile<D>(own, qb + cc * D, q0, s_len, d);
      cp_tile<D>(own + kTileBytes, dob + cc * D, q0, s_len, d);
    }
    if (st.last) {  // one LSE or delta row a thread
      const int r = threadIdx.x % kTile, which = threadIdx.x / kTile;  // 0: LSE, 1: delta
      const bool valid = q0 + r < s_len;
      cp_async4(base + 4 * kTileBytes + (which * kTile + r) * 4,
                (which ? delta_b : lse_b) + (valid ? q0 + r : 0), valid);
    }
  };
  load(0, 0);
  cp_async_commit();

  const int kr0 = k0 + m0 + g;
  float dk_acc[D / 8][4], dv_acc[D / 8][4], p[8][4], ds[8][4];  // S^T, P^T; V dO^T, dS^T
  zero_frags(dk_acc);
  zero_frags(dv_acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const uint32_t ks = smem0 + buf * kBufBytes, vs = ks + kTileBytes;
    const uint32_t qs = vs + kTileBytes, dos = qs + kTileBytes;
    if (st.chunk == 0) zero_frags(p), zero_frags(ds);
    score_pair<D, true>(ks, qs, vs, dos, m0, lane, p, ds);
    if (st.last) {
      const float* lse_s = reinterpret_cast<const float*>(tc_smem + buf * kBufBytes +
                                                          4 * kTileBytes);
      dkv_scores<8>(p, ds, lse_s, lse_s + kTile, (qt_begin + st.tile) * kTile, kr0, t2, s_len,
                    sk_len, causal != 0, scale);
      const uint32_t q_cc = cc == nc - 1 ? qs : own;
      const uint32_t do_cc = cc == nc - 1 ? dos : own + kTileBytes;
      // float32 P and dS, each as bf16 hi + lo: two mmas a product
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t a[2][4];
        split_from_acc(p, kk, a[0], a[1]);
        acc_product<D, 2>(a, do_cc, kk, lane, dv_acc);
        split_from_acc(ds, kk, a[0], a[1]);
        acc_product<D, 2>(a, q_cc, kk, lane, dk_acc);
      }
    }
    __syncthreads();
  }
  bf16* tiles = reinterpret_cast<bf16*>(tc_smem);
  store_rows<D>(tiles, dk_acc, m0, lane, dk + static_cast<size_t>(bh) * sk_len * d + cc * D, k0,
                sk_len, d);
  store_rows<D>(tiles + kTile * tc_ld<D>(), dv_acc, m0, lane,
                dv + static_cast<size_t>(bh) * sk_len * d + cc * D, k0, sk_len, d);
}

// The float32 forms: the split-TF32 kernels' 32-row loop tiles and
// products at D = kWide.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wide_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int s_len, int sk_len, int causal,
                            float scale, int d) {
  constexpr int kQkLd = f32_qk_ld<D>(), kVLd = f32_v_ld<D>();
  constexpr int kBufFloats = kTile * kQkLd + kF32Keys * (kQkLd + kVLd);  // Q, K, V chunks
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* sh = reinterpret_cast<float*>(tc_smem);

  const int bh = blockIdx.x, nc = d / D, cc = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<size_t>(bh) * s_len * d;
  const float* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const float* vb = v + static_cast<size_t>(bh) * sk_len * d + cc * D;

  const int nk = (sk_len + kF32Keys - 1) / kF32Keys;
  // a key tile is live unless every (row, col) pair of the query tile has col > row
  const int steps = (causal ? min(nk, (q0 + kTile - 1) / kF32Keys + 1) : nk) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    float* base = sh + buf * kBufFloats;
    cp_tile_f32<D, kTile, kQkLd>(smem_addr(base), qb + st.chunk * D, q0, s_len, d);
    cp_tile_f32<D, kF32Keys, kQkLd>(smem_addr(base + kTile * kQkLd), kb + st.chunk * D,
                                    st.tile * kF32Keys, sk_len, d);
    if (st.last)
      cp_tile_f32<D, kF32Keys, kVLd>(smem_addr(base + (kTile + kF32Keys) * kQkLd), vb,
                                     st.tile * kF32Keys, sk_len, d);
  };
  load(0, 0);
  cp_async_commit();

  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.0f, 0.0f};
  float acc[D / 8][4], s[kF32Keys / 8][4];  // s: S over the chunks so far, then P
  zero_frags(acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const float* q_sh = sh + buf * kBufFloats;
    const float* k_sh = q_sh + kTile * kQkLd;
    const int k0 = st.tile * kF32Keys;
    // a warp whose 16 rows all lie above the tile's keys skips it (as K2 f32)
    if (!causal || k0 <= q0 + m0 + 15) {
      if (st.chunk == 0) zero_frags(s);
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        a_split<kQkLd>(q_sh, m0, kk, g, t, ahi, alo);
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          b_split<kQkLd>(k_sh, 8 * j, kk, g, t, bhi, blo);
          mma_split_rn(s[j], ahi, alo, bhi, blo);
        }
      }
      if (st.last) {
        const bool edge = k0 + kF32Keys > sk_len || (causal && k0 + kF32Keys - 1 > q0 + m0);
        scale_scores<kF32Keys / 8>(s, edge, scale, r0, r1, k0, 2 * t, sk_len, causal != 0);
        online_softmax<kF32Keys / 8, D / 8>(s, m_run, l_run, acc);
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {  // O += P V, P kept in float32 (as hi + lo)
          uint32_t phi[4], plo[4];
          a_split_acc(s[j], phi, plo);
          acc_split_product<D, kVLd>(phi, plo, k_sh + kF32Keys * kQkLd, 8 * j, g, t, acc);
        }
      }
    }
    __syncthreads();
  }
  finish_softmax<D / 8>(acc, m_run, l_run, lse + static_cast<size_t>(bh) * s_len, r0, r1, s_len,
                        cc == 0, 2 * t);
  store_rows_f32<D>(acc, o + static_cast<size_t>(bh) * s_len * d + cc * D, q0 + m0, s_len, g, t,
                    d);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wide_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq, int s_len, int sk_len, int causal,
                               float scale, int d) {
  constexpr int kLd = f32_qk_ld<D>();
  constexpr int kBufFloats = (2 * kTile + 2 * kF32Keys) * kLd;  // Q, dO, K, V chunks
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* sh = reinterpret_cast<float*>(tc_smem);
  float* own = sh + 2 * kBufFloats;  // K's chunk cc

  const int bh = blockIdx.x, nc = d / D, cc = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<size_t>(bh) * s_len * d;
  const float* dob = dout + static_cast<size_t>(bh) * s_len * d;
  const float* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const float* vb = v + static_cast<size_t>(bh) * sk_len * d;

  const int nk = (sk_len + kF32Keys - 1) / kF32Keys;
  const int steps = (causal ? min(nk, (q0 + kTile - 1) / kF32Keys + 1) : nk) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    float* base = sh + buf * kBufFloats;
    cp_tile_f32<D, kTile, kLd>(smem_addr(base), qb + st.chunk * D, q0, s_len, d);
    cp_tile_f32<D, kTile, kLd>(smem_addr(base + kTile * kLd), dob + st.chunk * D, q0, s_len, d);
    cp_tile_f32<D, kF32Keys, kLd>(smem_addr(base + 2 * kTile * kLd), kb + st.chunk * D,
                                  st.tile * kF32Keys, sk_len, d);
    cp_tile_f32<D, kF32Keys, kLd>(smem_addr(base + (2 * kTile + kF32Keys) * kLd),
                                  vb + st.chunk * D, st.tile * kF32Keys, sk_len, d);
    if (st.last && cc != nc - 1)
      cp_tile_f32<D, kF32Keys, kLd>(smem_addr(own), kb + cc * D, st.tile * kF32Keys, sk_len, d);
  };
  load(0, 0);
  cp_async_commit();

  const int r0 = q0 + m0 + g, r1 = r0 + 8;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;
  const float lse_r[2] = {r0 < s_len ? lse_b[r0] : 0.0f, r1 < s_len ? lse_b[r1] : 0.0f};
  const float delta_r[2] = {r0 < s_len ? delta_b[r0] : 0.0f, r1 < s_len ? delta_b[r1] : 0.0f};
  float acc[D / 8][4], s[kF32Keys / 8][4], ds[kF32Keys / 8][4];  // S; dO V^T, then dS
  zero_frags(acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const float* q_sh = sh + buf * kBufFloats;
    const float* do_sh = q_sh + kTile * kLd;
    const float* k_sh = do_sh + kTile * kLd;
    const int k0 = st.tile * kF32Keys;
    if (!causal || k0 <= q0 + m0 + 15) {
      if (st.chunk == 0) zero_frags(s), zero_frags(ds);
      score_pair_f32<D, kLd, true>(q_sh, k_sh, do_sh, k_sh + kF32Keys * kLd, m0, g, t, s, ds);
      if (st.last) {
        dq_scores<kF32Keys / 8>(s, ds, lse_r, delta_r, r0, r1, k0, 2 * t, sk_len, causal != 0,
                                scale);
        const float* k_cc = cc == nc - 1 ? k_sh : own;
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          uint32_t hi[4], lo[4];
          a_split_acc(ds[j], hi, lo);
          acc_split_product<D, kLd>(hi, lo, k_cc, 8 * j, g, t, acc);
        }
      }
    }
    __syncthreads();
  }
  store_rows_f32<D>(acc, dq + static_cast<size_t>(bh) * s_len * d + cc * D, q0 + m0, s_len, g, t,
                    d);
}

// K4 for float32 above D = 128 (the float32 chunked K3 and K4 serve only
// above the cluster kernels' d = 1024). Its two outputs go to separate
// blocks (grid z: dV's chunks, then dK's), so a block holds one [16 x D]
// accumulator: both in one block spill (255 registers and 128 bytes of
// local memory a thread: 1.846 ms against this form's 1.217 at [256, 256,
// 256] causal, NVIDIA H100 80GB HBM3). A dV block needs only S = K Q^T for
// P, and skips V; a dK block also dO V^T for dS. The bf16 K4 above keeps
// both outputs in a block: its split form ran 0.474 ms against 0.375 (its
// spill is small, and the split recomputes S once more a key tile).
template <int D, bool kDk>
__device__ __forceinline__ void dkv_wide_f32tc(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* __restrict__ out, int s_len, int sk_len,
                                               int causal, float scale, int d, int cc) {
  constexpr int kLd = f32_qk_ld<D>();
  // K, V, Q, dO chunks; the LSE and delta rows
  constexpr int kBufFloats = (2 * kTile + 2 * kF32Keys) * kLd + 2 * kF32Keys;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* sh = reinterpret_cast<float*>(tc_smem);
  float* own = sh + 2 * kBufFloats;  // a dK block's Q chunk cc

  const int bh = blockIdx.x, nc = d / D;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles: first
  const int k0 = kt * kTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + static_cast<size_t>(bh) * s_len * d;
  const float* dob = dout + static_cast<size_t>(bh) * s_len * d;
  const float* kb = k + static_cast<size_t>(bh) * sk_len * d;
  const float* vb = v + static_cast<size_t>(bh) * sk_len * d;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;

  const int nq = (s_len + kF32Keys - 1) / kF32Keys;
  // a query tile is live unless every (row, col) pair in it has col > row
  const int qt_begin = causal ? k0 / kF32Keys : 0;
  const int steps = (nq - qt_begin) * nc;
  auto load = [&](int i, int buf) {
    const WideStep st(i, nc);
    const int q0 = (qt_begin + st.tile) * kF32Keys;
    float* base = sh + buf * kBufFloats;
    cp_tile_f32<D, kTile, kLd>(smem_addr(base), kb + st.chunk * D, k0, sk_len, d);
    if (kDk)
      cp_tile_f32<D, kTile, kLd>(smem_addr(base + kTile * kLd), vb + st.chunk * D, k0, sk_len,
                                 d);
    cp_tile_f32<D, kF32Keys, kLd>(smem_addr(base + 2 * kTile * kLd), qb + st.chunk * D, q0,
                                  s_len, d);
    // a dK block's dO chunks feed dO V^T; a dV block's dO feeds only P^T dO: chunk cc
    if (kDk || st.last)
      cp_tile_f32<D, kF32Keys, kLd>(smem_addr(base + (2 * kTile + kF32Keys) * kLd),
                                    dob + (kDk ? st.chunk : cc) * D, q0, s_len, d);
    if (kDk && st.last && cc != nc - 1)
      cp_tile_f32<D, kF32Keys, kLd>(smem_addr(own), qb + cc * D, q0, s_len, d);
    if (st.last && threadIdx.x < 2 * kF32Keys) {  // one LSE or delta row a thread
      const int r = threadIdx.x % kF32Keys, which = threadIdx.x / kF32Keys;  // 0: LSE, 1: delta
      const bool valid = q0 + r < s_len;
      cp_async4(smem_addr(base + (2 * kTile + 2 * kF32Keys) * kLd + which * kF32Keys + r),
                (which ? delta_b : lse_b) + (valid ? q0 + r : 0), valid);
    }
  };
  load(0, 0);
  cp_async_commit();

  const int kr0 = k0 + m0 + g;
  float acc[D / 8][4];
  float p[kF32Keys / 8][4], ds[kF32Keys / 8][4];  // S^T then P^T; V dO^T then dS^T
  zero_frags(acc);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    if (i + 1 < steps) load(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const WideStep st(i, nc);
    const float* k_sh = sh + buf * kBufFloats;
    const float* v_sh = k_sh + kTile * kLd;
    const float* q_sh = v_sh + kTile * kLd;
    const float* do_sh = q_sh + kF32Keys * kLd;
    const int q0 = (qt_begin + st.tile) * kF32Keys;
    if (!causal || q0 + kF32Keys - 1 >= k0 + m0) {
      if (st.chunk == 0) zero_frags(p), zero_frags(ds);
      score_pair_f32<D, kLd, true, kDk>(k_sh, q_sh, v_sh, do_sh, m0, g, t, p, ds);
      if (st.last) {
        const float* lse_s = do_sh + kF32Keys * kLd;
        dkv_scores<kF32Keys / 8>(p, ds, lse_s, lse_s + kF32Keys, q0, kr0, 2 * t, s_len, sk_len,
                                 causal != 0, scale);
        const float* b_cc = !kDk ? do_sh : cc == nc - 1 ? q_sh : own;  // dO's or Q's chunk cc
#pragma unroll
        for (int j = 0; j < kF32Keys / 8; ++j) {
          uint32_t hi[4], lo[4];
          a_split_acc(kDk ? ds[j] : p[j], hi, lo);
          acc_split_product<D, kLd>(hi, lo, b_cc, 8 * j, g, t, acc);
        }
      }
    }
    __syncthreads();
  }
  store_rows_f32<D>(acc, out + static_cast<size_t>(bh) * sk_len * d + cc * D, k0 + m0, sk_len,
                    g, t, d);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_wide_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int s_len,
                                int sk_len, int causal, float scale, int d) {
  const int nc = d / D;
  if (static_cast<int>(blockIdx.z) < nc)
    dkv_wide_f32tc<D, false>(q, k, v, dout, lse, delta, dv, s_len, sk_len, causal, scale, d,
                             blockIdx.z);
  else
    dkv_wide_f32tc<D, true>(q, k, v, dout, lse, delta, dk, s_len, sk_len, causal, scale, d,
                            blockIdx.z - nc);
}

// ------------------------------------------------------------------ K3, K4 (float32) above D = 128: clusters
//
// The float32 K3 and K4 for d = nc·kWide up to kMaxCluster chunks (d ≤ 1024;
// above it the chunked kernels above). The nc blocks of one 64-row tile
// (K3: queries, K4: keys) form a thread-block cluster, and block c, the
// cluster rank, owns the output's head-dim chunk c. Each score is formed
// once: block c sums its chunk's share of S and of dO·Vᵀ (K4: their
// transposes) over its 128 columns, the blocks read each other's shares
// through distributed shared memory, and each adds the nc shares in rank
// order, so every block holds the same S and dS bit for bit. The chunked
// kernels above formed every score in every chunk's block (K4: in 2·nc
// blocks): 2 and 6 products over the whole d a (key tile, query tile) pair
// where this design takes 2.
//
// A block is two warpgroups (8 warps, one block an SM). Its shared memory:
// - the resident 64-row tiles of its chunk (K3: Q and dO; K4: K and V),
//   copied once and split once into TF32 hi and lo: 128 KB;
// - the streamed 32-row tiles (K3: K and V; K4: Q and dO, with their LSE
//   and δ rows), split once when they land: 64 KB, single-buffered; the
//   next pair's rows are loaded into registers while the block computes on
//   this one (their loads issued after the scores' wgmma, whose fence
//   would wait for them), and split into place after it;
// - the shares of S and dP, double-buffered by step: 32 KB.
// Split tiles are kept in wgmma's 128-byte-swizzled K-major layout (`sw`):
// warpgroup 0 forms S (K4: Sᵀ = K Qᵀ) and warpgroup 1 dP = dO Vᵀ (K4: V dOᵀ)
// with wgmma m64n32k8 TF32 products straight from them, three a k8 step
// (hi·lo, lo·hi, hi·hi). The tensor core sums kClGroup such steps from
// zero, and each group is added to the float32 share rounded to nearest:
// summed 128 to 512 deep inside the tensor core, the chunked kernels' dQ
// drifted to 0.93-1.23 of FLASH_TOL (see mma_split_rn).
// The output products run over keys (K4: queries), and TF32 wgmma takes B
// only K-major: the streamed tile would need a transposed copy, 32 KB more
// than the 227 KB a block may hold. They stay on mma.sync m16n8k8, their
// A operand split from the score accumulators in registers and their B
// fragments read already split from the swizzled tiles, conflict free.
// K3: warpgroup w holds dQ's columns 64w.. of the chunk; K4: warpgroup 0
// holds dV's chunk, warpgroup 1 dK's. The pair is bound by its bytes on
// this card and runs at 5-6 times that bound at [256, 256, 256] causal: a
// step is serial (scores, the cluster barrier and the shares' reads, the
// output products, the next tiles' landing), with one streamed buffer and
// no room for a second (PERF.md §6).
constexpr int kClThreads = 256;   // two warpgroups
constexpr int kClStream = 32;     // rows of a streamed tile: K3's keys, K4's queries
constexpr int kMaxCluster = 8;    // the portable cluster size: d up to 1024
constexpr int kClGroup = 4;       // k8 steps the tensor core sums a nearest add
static_assert(kWide / 8 % kClGroup == 0, "the groups split a chunk's k8 steps");
constexpr int kResFloats = kTile * kWide;        // a resident split half (hi or lo)
constexpr int kStrFloats = kClStream * kWide;    // a streamed split half
constexpr int kXchFloats = kTile * kClStream;    // a warpgroup's share of one step
constexpr size_t kClusterSmem =
    (4 * kResFloats + 4 * kStrFloats + 4 * kXchFloats + 2 * kClStream) * sizeof(float) + 1024;
static_assert(kClusterSmem <= 232448, "a block's shared memory");

// Float offset of element (r, c) of an R x 128 split tile: wgmma's K-major
// layout with the 128-byte swizzle, in 32-column atoms of R rows, each row
// 128 bytes whose 16-byte chunks are XOR-ed with r % 8 (8-row groups 1024
// bytes apart, the tile 1024-byte aligned).
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 5) * (R * 32) + (r >> 3) * 256 + (r & 7) * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
}

// wgmma's shared-memory descriptor of k8 step s of an R-row split tile:
// start address, stride 1024 bytes between 8-row groups, 128-byte swizzle.
template <int R>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t tile, int s) {
  const uint32_t addr = tile + ((s >> 2) * R * 32 + (s & 3) * 8) * 4;
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps reads of x after the wgmma.wait before them
__device__ __forceinline__ void fence_frags(float (&x)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[j][e])::"memory");
}

// x[64 x 32] = (scale_d ? x : 0) + A[64 x 8] B[32 x 8]^T in TF32, float32
// sums, A and B from shared memory. Warp w of the warpgroup gets rows
// 16w.. in mma.sync's accumulator layout (x[j]: columns 8j..).
__device__ __forceinline__ void wgmma_tf32_m64n32(float (&x)[4][4], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1;\n}\n"
      : "+f"(x[0][0]), "+f"(x[0][1]), "+f"(x[0][2]), "+f"(x[0][3]), "+f"(x[1][0]),
        "+f"(x[1][1]), "+f"(x[1][2]), "+f"(x[1][3]), "+f"(x[2][0]), "+f"(x[2][1]),
        "+f"(x[2][2]), "+f"(x[2][3]), "+f"(x[3][0]), "+f"(x[3][1]), "+f"(x[3][2]), "+f"(x[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The warpgroup's [64 x 32] share of the scores over one 128-column chunk,
// A (64 rows) and B (32 rows) both split: each group of kClGroup k8 steps
// summed by the tensor core from zero into one of two buffers (the next
// group runs while the last is added), and added to c rounded to nearest.
__device__ __forceinline__ void chunk_scores(uint32_t ahi, uint32_t alo, uint32_t bhi,
                                             uint32_t blo, float (&c)[4][4]) {
  constexpr int kGroups = kWide / 8 / kClGroup;
  float u[2][4][4];
  zero_frags(c), zero_frags(u[0]), zero_frags(u[1]);
#pragma unroll
  for (int gi = 0; gi <= kGroups; ++gi) {
    if (gi < kGroups) {
      fence_frags(u[gi & 1]);
      wgmma_fence();
#pragma unroll
      for (int s = gi * kClGroup; s < (gi + 1) * kClGroup; ++s) {
        wgmma_tf32_m64n32(u[gi & 1], wgmma_desc<kTile>(ahi, s), wgmma_desc<kClStream>(blo, s),
                          s != gi * kClGroup);
        wgmma_tf32_m64n32(u[gi & 1], wgmma_desc<kTile>(alo, s), wgmma_desc<kClStream>(bhi, s), 1);
        wgmma_tf32_m64n32(u[gi & 1], wgmma_desc<kTile>(ahi, s), wgmma_desc<kClStream>(bhi, s), 1);
      }
      wgmma_commit();
    }
    if (gi == 0) continue;
    if (gi < kGroups) wgmma_wait<1>();
    else wgmma_wait<0>();
    float (&v)[4][4] = u[(gi - 1) & 1];
    fence_frags(v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += v[j][e];
  }
}

// R rows from row0 of a [len][d] float32 tensor's 128-column chunk (src at
// the chunk's first column) into registers, 16 bytes a thread, zeros past
// `len` ...
template <int R>
__device__ __forceinline__ void load_chunk_rows(float4 (&x)[R / 8], const float* __restrict__ src,
                                                int row0, int len, int d) {
#pragma unroll
  for (int it = 0; it < R / 8; ++it) {
    const int i = threadIdx.x + it * kClThreads, r = i >> 5, c4 = i & 31;
    x[it] = row0 + r < len
                ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * d) + c4)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}
// ... and split into hi and lo at their places in a split tile: a quarter
// warp stores one row's 128 swizzled bytes, conflict free.
template <int R>
__device__ __forceinline__ void store_split(const float4 (&x)[R / 8], float* hi, float* lo) {
#pragma unroll
  for (int it = 0; it < R / 8; ++it) {
    const int i = threadIdx.x + it * kClThreads, r = i >> 5, c4 = i & 31;
    const int off = sw<R>(r, 4 * c4);
    uint32_t h[4], l[4];
    split_tf32(x[it].x, h[0], l[0]);
    split_tf32(x[it].y, h[1], l[1]);
    split_tf32(x[it].z, h[2], l[2]);
    split_tf32(x[it].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// acc[16 x 8N] += A B for the split A fragment of k8 step j (keys, K4:
// queries 8j + 2t, + 1 in its slots t, t + 4) and B the streamed tile's
// rows there, columns col0 + 8n + g, read split.
template <int N>
__device__ __forceinline__ void acc_split_streamed(const uint32_t ahi[4], const uint32_t alo[4],
                                                   const float* hi, const float* lo, int j,
                                                   int col0, int g, int t, float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int o0 = sw<kClStream>(8 * j + 2 * t, col0 + 8 * n + g);
    const int o1 = sw<kClStream>(8 * j + 2 * t + 1, col0 + 8 * n + g);
    const uint32_t bhi[2] = {__float_as_uint(hi[o0]), __float_as_uint(hi[o1])};
    const uint32_t blo[2] = {__float_as_uint(lo[o0]), __float_as_uint(lo[o1])};
    mma_split(acc[n], ahi, alo, bhi, blo);
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// after cluster_wait, every block of the cluster has passed cluster_arrive:
// its shared-memory writes before that are visible to the cluster's reads
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this block's shared `addr` in cluster block `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// this thread's shared-memory writes are visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K3 (kDkv false: out0 = dQ) or K4 (out0 = dK, out1 = dV); see above.
template <bool kDkv>
__device__ __forceinline__ void bwd_cluster_f32tc(const float* __restrict__ q,
                                                  const float* __restrict__ k,
                                                  const float* __restrict__ v,
                                                  const float* __restrict__ dout,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  float* __restrict__ out0,
                                                  float* __restrict__ out1, int s_len,
                                                  int sk_len, int causal, float scale, int d) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = smem_addr(tc_smem), base = (raw + 1023) & ~1023u;
  float* res = reinterpret_cast<float*>(tc_smem + (base - raw));  // A1 hi, lo, A2 hi, lo
  float* str = res + 4 * kResFloats;                              // B1 hi, lo, B2 hi, lo
  float* xch = str + 4 * kStrFloats;                              // [step & 1][S, dP] shares
  float* rows = xch + 4 * kXchFloats;                             // K4: the tile's LSE, delta

  const int c = cluster_rank(), nc = d / kWide, bh = blockIdx.x;
  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, m0 = (t128 >> 5) * 16, g = lane >> 2, t = lane & 3;
  // K3: resident queries (Q, dO), streamed keys (K, V); K4 the other way
  const int res_len = kDkv ? sk_len : s_len, str_len = kDkv ? s_len : sk_len;
  const int tile = kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int r0 = tile * kTile;
  const size_t res_off = static_cast<size_t>(bh) * res_len * d + c * kWide;
  const size_t str_off = static_cast<size_t>(bh) * str_len * d + c * kWide;
  const float* a1 = (kDkv ? k : q) + res_off;
  const float* a2 = (kDkv ? v : dout) + res_off;
  const float* b1 = (kDkv ? q : k) + str_off;
  const float* b2 = (kDkv ? dout : v) + str_off;
  const float* lse_b = lse + static_cast<size_t>(bh) * s_len;
  const float* delta_b = delta + static_cast<size_t>(bh) * s_len;

  {
    float4 x[kTile / 8];
    load_chunk_rows<kTile>(x, a1, r0, res_len, d);
    store_split<kTile>(x, res, res + kResFloats);
    load_chunk_rows<kTile>(x, a2, r0, res_len, d);
    store_split<kTile>(x, res + 2 * kResFloats, res + 3 * kResFloats);
  }
  const int n_str = (str_len + kClStream - 1) / kClStream;
  // a streamed tile is live unless every (row, col) pair with the resident one has col > row
  const int it0 = kDkv && causal ? r0 / kClStream : 0;
  const int it_end = !kDkv && causal ? min(n_str, (r0 + kTile - 1) / kClStream + 1) : n_str;
  float4 pre1[kClStream / 8], pre2[kClStream / 8];  // the next streamed pair, in flight
  float pre_row = 0.0f;                             // K4: its LSE or delta row
  auto prefetch = [&](int it) {
    load_chunk_rows<kClStream>(pre1, b1, it * kClStream, str_len, d);
    load_chunk_rows<kClStream>(pre2, b2, it * kClStream, str_len, d);
    if (kDkv && threadIdx.x < 2 * kClStream) {
      const int r = it * kClStream + (threadIdx.x & (kClStream - 1));
      pre_row = r < s_len ? (threadIdx.x < kClStream ? lse_b : delta_b)[r] : 0.0f;
    }
  };
  auto land = [&]() {
    store_split<kClStream>(pre1, str, str + kStrFloats);
    store_split<kClStream>(pre2, str + 2 * kStrFloats, str + 3 * kStrFloats);
    if (kDkv && threadIdx.x < 2 * kClStream) rows[threadIdx.x] = pre_row;
    fence_async_smem();
  };
  prefetch(it0);
  land();
  __syncthreads();

  // K3: this lane's query rows ra (accumulators 0, 1) and ra + 8 (2, 3);
  // K4: its keys
  const int ra = r0 + m0 + g, rb = ra + 8;
  float lse_r[2] = {0.0f, 0.0f}, delta_r[2] = {0.0f, 0.0f};
  if (!kDkv) {
    lse_r[0] = ra < s_len ? lse_b[ra] : 0.0f;
    lse_r[1] = rb < s_len ? lse_b[rb] : 0.0f;
    delta_r[0] = ra < s_len ? delta_b[ra] : 0.0f;
    delta_r[1] = rb < s_len ? delta_b[rb] : 0.0f;
  }
  constexpr int kN = kDkv ? kWide / 8 : kWide / 16;  // the warpgroup's output columns / 8
  float acc[kN][4];
  zero_frags(acc);
  const uint32_t res_a = smem_addr(res + 2 * wg * kResFloats);
  const uint32_t str_a = smem_addr(str + 2 * wg * kStrFloats);
  for (int it = it0; it < it_end; ++it) {
    const int step = it - it0;
    // warpgroup 0: this chunk's share of S (K4: S^T); warpgroup 1: of dP (dP^T)
    float part[4][4];
    chunk_scores(res_a, res_a + 4 * kResFloats, str_a, str_a + 4 * kStrFloats, part);
    float* mine = xch + ((step & 1) * 2 + wg) * kXchFloats;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(mine + (j * 128 + t128) * 4) =
          make_float4(part[j][0], part[j][1], part[j][2], part[j][3]);
    cluster_arrive();
    // the next streamed pair's loads fly while the shares are traded and the
    // outputs summed
    if (it + 1 < it_end) prefetch(it + 1);
    cluster_wait();
    // the nc shares added in rank order: every block gets the same S and dP
    float s[4][4], dp[4][4];
    const uint32_t shares = smem_addr(xch + (step & 1) * 2 * kXchFloats) + t128 * 16;
    for (int r = 0; r < nc; ++r) {
      const uint32_t at = cluster_addr(shares, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 a = ld_cluster(at + j * 128 * 16);
        const float4 b = ld_cluster(at + kXchFloats * 4 + j * 128 * 16);
        if (r == 0) {
          s[j][0] = a.x, s[j][1] = a.y, s[j][2] = a.z, s[j][3] = a.w;
          dp[j][0] = b.x, dp[j][1] = b.y, dp[j][2] = b.z, dp[j][3] = b.w;
        } else {
          s[j][0] += a.x, s[j][1] += a.y, s[j][2] += a.z, s[j][3] += a.w;
          dp[j][0] += b.x, dp[j][1] += b.y, dp[j][2] += b.z, dp[j][3] += b.w;
        }
      }
    }
    const int j0 = it * kClStream;  // the streamed tile's first key (K4: query)
    const float* bhi = str + (kDkv && wg == 0 ? 2 : 0) * kStrFloats;  // K3: K; K4: dO or Q
    if constexpr (!kDkv) {
      dq_scores<4>(s, dp, lse_r, delta_r, ra, rb, j0, 2 * t, sk_len, causal != 0, scale);
      if (!causal || j0 <= r0 + m0 + 15) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi[4], lo[4];
          a_split_acc(dp[j], hi, lo);
          acc_split_streamed<kN>(hi, lo, bhi, bhi + kStrFloats, j, wg * (kWide / 2), g, t, acc);
        }
      }
    } else {
      dkv_scores<4>(s, dp, rows, rows + kClStream, j0, ra, 2 * t, s_len, sk_len, causal != 0,
                    scale);
      if (!causal || j0 + kClStream - 1 >= r0 + m0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // dV += P^T dO, dK += dS^T Q
          uint32_t hi[4], lo[4];
          float x[4];  // chosen a value at a time: a pointer to either would put both in memory
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = wg == 0 ? s[j][e] : dp[j][e];
          a_split_acc(x, hi, lo);
          acc_split_streamed<kN>(hi, lo, bhi, bhi + kStrFloats, j, 0, g, t, acc);
        }
      }
    }
    __syncthreads();  // every warp is done with the streamed tiles
    if (it + 1 < it_end) land();
    __syncthreads();
  }
  cluster_arrive();  // no block leaves while another may read its shares
  cluster_wait();
  const size_t out_off = static_cast<size_t>(bh) * res_len * d + c * kWide;
  if constexpr (!kDkv)
    store_rows_f32<kWide / 2>(acc, out0 + out_off + wg * (kWide / 2), r0 + m0, s_len, g, t, d);
  else
    store_rows_f32<kWide>(acc, (wg == 0 ? out1 : out0) + out_off, r0 + m0, sk_len, g, t, d);
}

template <int D>
__global__ void __launch_bounds__(kClThreads, 1)
flash_bwd_dq_cluster_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  float* __restrict__ dq, int s_len, int sk_len, int causal,
                                  float scale, int d) {
  static_assert(D == kWide, "the cluster kernels' chunk");
  bwd_cluster_f32tc<false>(q, k, v, dout, lse, delta, dq, nullptr, s_len, sk_len, causal, scale,
                           d);
}

template <int D>
__global__ void __launch_bounds__(kClThreads, 1)
flash_bwd_dkv_cluster_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   float* __restrict__ dk, float* __restrict__ dv, int s_len,
                                   int sk_len, int causal, float scale, int d) {
  static_assert(D == kWide, "the cluster kernels' chunk");
  bwd_cluster_f32tc<true>(q, k, v, dout, lse, delta, dk, dv, s_len, sk_len, causal, scale, d);
}

// ------------------------------------------------------------------ launch

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
  int head_dim, bh, s_len, sk_len, causal;
  float scale;
  cudaStream_t stream;
};

enum class Which { kFwd, kDq, kDkv };

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// The kernel families, as kernel_info reports them: built for the head dim,
// chunked (above kMaxHeadDim), or the float32 K3/K4 cluster kernels
enum Family { kPerDim = 0, kChunked = 1, kCluster = 2 };

// out: threads a block, registers a thread, local memory bytes a thread,
// dynamic shared memory bytes a block, blocks resident on one SM, and the
// kernel's Family
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, size_t smem, int* out, Family family = kPerDim) {
  int err = opt_in(kernel, smem);
  cudaFuncAttributes attr;
  if (err == 0) err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  int blocks = 0;
  if (err == 0)
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem));
  if (err != 0) return err;
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  out[5] = family;
  return 0;
}

// K2: the split-TF32 tensor-core kernel for float32 ...
template <typename T, int D>
struct Forward;

template <int D>
struct Forward<float, D> {
  static constexpr size_t kSmem = fwd_f32_smem<D>();
  static_assert(2 * (kSmem + 1024) <= 233472, "two float32 K2 blocks or more share an SM");
  static int run(dim3 grid, const Args& a) {
    const int err = opt_in(flash_fwd_f32tc_kernel<D>, kSmem);
    if (err != 0) return err;
    flash_fwd_f32tc_kernel<D><<<grid, kTcThreads, kSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse_out, a.s_len, a.sk_len,
        a.causal, a.scale);
    return 0;
  }
  static int info(int* out) {
    return kernel_info(flash_fwd_f32tc_kernel<D>, kTcThreads, kSmem, out);
  }
};

// ... and the tensor-core kernel for bfloat16
template <int D>
struct Forward<bf16, D> {
  static constexpr size_t kSmem = 5 * tc_tile_bytes<D>();
  static_assert(fwd_tc_blocks<D>() * (kSmem + 1024) <= 233472,
                "the K2 blocks an SM is built for fit its shared memory");
  static int run(dim3 grid, const Args& a) {
    const int err = opt_in(flash_fwd_tc_kernel<D>, kSmem);
    if (err != 0) return err;
    flash_fwd_tc_kernel<D><<<grid, kTcThreads, kSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse_out, a.s_len, a.sk_len,
        a.causal, a.scale);
    return 0;
  }
  static int info(int* out) {
    return kernel_info(flash_fwd_tc_kernel<D>, kTcThreads, kSmem, out);
  }
};

// K3 and K4: the split-TF32 tensor-core kernels for float32 ...
template <typename T, int D>
struct Backward;

template <int D>
struct Backward<float, D> {
  static constexpr size_t kDqSmem = dq_f32_smem<D>(), kDkvSmem = dkv_f32_smem<D>();
  static_assert(D > 96 || 2 * (kDkvSmem + 1024) <= 233472, "two K4 blocks share an SM");
  static_assert(D > 96 || 2 * (kDqSmem + 1024) <= 233472, "two K3 blocks share an SM");
  static_assert(kDkvSmem <= 232448 && kDqSmem <= 232448, "a block's shared memory");
  static int dq(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dq_f32tc_kernel<D>, kDqSmem);
    if (err != 0) return err;
    flash_bwd_dq_f32tc_kernel<D><<<grid, kTcThreads, kDqSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.o), a.s_len, a.sk_len, a.causal, a.scale);
    return 0;
  }
  static int dkv(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dkv_f32tc_kernel<D>, kDkvSmem);
    if (err != 0) return err;
    flash_bwd_dkv_f32tc_kernel<D><<<grid, kTcThreads, kDkvSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.o), static_cast<float*>(a.dv), a.s_len, a.sk_len, a.causal,
        a.scale);
    return 0;
  }
  static int info(Which which, int* out) {
    return which == Which::kDq
               ? kernel_info(flash_bwd_dq_f32tc_kernel<D>, kTcThreads, kDqSmem, out)
               : kernel_info(flash_bwd_dkv_f32tc_kernel<D>, kTcThreads, kDkvSmem, out);
  }
};

// ... and the tensor-core kernels for bfloat16
template <int D>
struct Backward<bf16, D> {
  static constexpr size_t kDqSmem = 6 * tc_tile_bytes<D>();
  static constexpr size_t kDkvSmem = 6 * tc_tile_bytes<D>() + 4 * kTile * sizeof(float);
  static_assert(kDkvSmem <= 232448 / 2, "two K4 blocks share an SM");
  static int dq(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dq_tc_kernel<D>, kDqSmem);
    if (err != 0) return err;
    flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, kDqSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.o), a.s_len, a.sk_len, a.causal, a.scale);
    return 0;
  }
  static int dkv(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dkv_tc_kernel<D>, kDkvSmem);
    if (err != 0) return err;
    flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, kDkvSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.o), static_cast<bf16*>(a.dv), a.s_len, a.sk_len, a.causal,
        a.scale);
    return 0;
  }
  static int info(Which which, int* out) {
    return which == Which::kDq
               ? kernel_info(flash_bwd_dq_tc_kernel<D>, kTcThreads, kDqSmem, out)
               : kernel_info(flash_bwd_dkv_tc_kernel<D>, kTcThreads, kDkvSmem, out);
  }
};

// The chunked kernels of a head dim above kMaxHeadDim ...
template <typename T>
struct Wide;

// a cluster of `cluster` blocks along grid z (cudaLaunchKernelEx)
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), dim3 grid, int cluster, size_t smem,
                   cudaStream_t stream, A... args) {
  const int err = opt_in(kernel, smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...));
}

template <>
struct Wide<float> {
  static constexpr int kDkvBlocks = 2;  // the chunked K4: dV's and dK's blocks a chunk
  static constexpr size_t kFwdSmem =
      2 * (kTile * f32_qk_ld<kWide>() + kF32Keys * (f32_qk_ld<kWide>() + f32_v_ld<kWide>())) *
      sizeof(float);
  // two buffers; then the own slot (K3: K's chunk cc; K4: Q's)
  static constexpr size_t kDqSmem = (2 * (2 * kTile + 2 * kF32Keys) + kF32Keys) *
                                    f32_qk_ld<kWide>() * sizeof(float);
  static constexpr size_t kDkvSmem = kDqSmem + 4 * kF32Keys * sizeof(float);
  static_assert(kDkvSmem <= 232448, "a block's shared memory");
  static int fwd(dim3 grid, const Args& a) {
    const int err = opt_in(flash_fwd_wide_f32tc_kernel<kWide>, kFwdSmem);
    if (err != 0) return err;
    flash_fwd_wide_f32tc_kernel<kWide><<<grid, kTcThreads, kFwdSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse_out, a.s_len, a.sk_len,
        a.causal, a.scale, a.head_dim);
    return 0;
  }
  // K3 and K4 up to kMaxCluster chunks: one cluster a tile, a block a chunk
  static bool clustered(int head_dim) { return head_dim / kWide <= kMaxCluster; }
  static int dq(dim3 grid, const Args& a) {
    const int nc = a.head_dim / kWide;
    if (clustered(a.head_dim))
      return launch_cluster(flash_bwd_dq_cluster_f32tc_kernel<kWide>, dim3(grid.x, grid.y, nc),
                            nc, kClusterSmem, a.stream, a.q, a.k, a.v, a.dout, a.lse_in,
                            a.delta, a.o, a.s_len, a.sk_len, a.causal, a.scale, a.head_dim);
    const int err = opt_in(flash_bwd_dq_wide_f32tc_kernel<kWide>, kDqSmem);
    if (err != 0) return err;
    flash_bwd_dq_wide_f32tc_kernel<kWide><<<grid, kTcThreads, kDqSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.o), a.s_len, a.sk_len, a.causal, a.scale, a.head_dim);
    return 0;
  }
  static int dkv(dim3 grid, const Args& a) {
    const int nc = a.head_dim / kWide;
    if (clustered(a.head_dim))
      return launch_cluster(flash_bwd_dkv_cluster_f32tc_kernel<kWide>, dim3(grid.x, grid.y, nc),
                            nc, kClusterSmem, a.stream, a.q, a.k, a.v, a.dout, a.lse_in,
                            a.delta, a.o, a.dv, a.s_len, a.sk_len, a.causal, a.scale,
                            a.head_dim);
    const int err = opt_in(flash_bwd_dkv_wide_f32tc_kernel<kWide>, kDkvSmem);
    if (err != 0) return err;
    flash_bwd_dkv_wide_f32tc_kernel<kWide><<<dim3(grid.x, grid.y, kDkvBlocks * nc), kTcThreads,
                                             kDkvSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse_in, a.delta,
        static_cast<float*>(a.o), static_cast<float*>(a.dv), a.s_len, a.sk_len, a.causal,
        a.scale, a.head_dim);
    return 0;
  }
  static int info(Which which, int head_dim, int* out) {
    if (which == Which::kFwd)
      return kernel_info(flash_fwd_wide_f32tc_kernel<kWide>, kTcThreads, kFwdSmem, out,
                         kChunked);
    if (clustered(head_dim))
      return which == Which::kDq
                 ? kernel_info(flash_bwd_dq_cluster_f32tc_kernel<kWide>, kClThreads,
                               kClusterSmem, out, kCluster)
                 : kernel_info(flash_bwd_dkv_cluster_f32tc_kernel<kWide>, kClThreads,
                               kClusterSmem, out, kCluster);
    return which == Which::kDq
               ? kernel_info(flash_bwd_dq_wide_f32tc_kernel<kWide>, kTcThreads, kDqSmem, out,
                             kChunked)
               : kernel_info(flash_bwd_dkv_wide_f32tc_kernel<kWide>, kTcThreads, kDkvSmem, out,
                             kChunked);
  }
};

template <>
struct Wide<bf16> {
  static constexpr size_t kFwdSmem = 2 * 3 * tc_tile_bytes<kWide>();
  // two buffers; then the own slot (K3: K's chunk cc; K4: Q's and dO's)
  static constexpr size_t kDqSmem = (2 * 4 + 1) * tc_tile_bytes<kWide>();
  static constexpr size_t kDkvSmem = (2 * 4 + 2) * tc_tile_bytes<kWide>() +
                                     2 * 2 * kTile * sizeof(float);
  static_assert(kDkvSmem <= 232448, "a block's shared memory");
  static int fwd(dim3 grid, const Args& a) {
    const int err = opt_in(flash_fwd_wide_tc_kernel<kWide>, kFwdSmem);
    if (err != 0) return err;
    flash_fwd_wide_tc_kernel<kWide><<<grid, kTcThreads, kFwdSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse_out, a.s_len, a.sk_len,
        a.causal, a.scale, a.head_dim);
    return 0;
  }
  static int dq(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dq_wide_tc_kernel<kWide>, kDqSmem);
    if (err != 0) return err;
    flash_bwd_dq_wide_tc_kernel<kWide><<<grid, kTcThreads, kDqSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.o), a.s_len, a.sk_len, a.causal, a.scale, a.head_dim);
    return 0;
  }
  static int dkv(dim3 grid, const Args& a) {
    const int err = opt_in(flash_bwd_dkv_wide_tc_kernel<kWide>, kDkvSmem);
    if (err != 0) return err;
    flash_bwd_dkv_wide_tc_kernel<kWide><<<grid, kTcThreads, kDkvSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.o), static_cast<bf16*>(a.dv), a.s_len, a.sk_len, a.causal,
        a.scale, a.head_dim);
    return 0;
  }
  static int info(Which which, int, int* out) {
    if (which == Which::kFwd)
      return kernel_info(flash_fwd_wide_tc_kernel<kWide>, kTcThreads, kFwdSmem, out, kChunked);
    return which == Which::kDq
               ? kernel_info(flash_bwd_dq_wide_tc_kernel<kWide>, kTcThreads, kDqSmem, out,
                             kChunked)
               : kernel_info(flash_bwd_dkv_wide_tc_kernel<kWide>, kTcThreads, kDkvSmem, out,
                             kChunked);
  }
};

// ... launched over a third grid dimension, the output's head-dim chunks
template <typename T>
int launch_wide(Which which, const Args& a) {
  const dim3 grid(a.bh, which == Which::kDkv ? (a.sk_len + kTile - 1) / kTile
                                             : (a.s_len + kTile - 1) / kTile,
                  a.head_dim / kWide);
  int err = which == Which::kFwd ? Wide<T>::fwd(grid, a)
            : which == Which::kDq ? Wide<T>::dq(grid, a)
                                  : Wide<T>::dkv(grid, a);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(Which which, const Args& a) {
  const dim3 grid(a.bh, which == Which::kDkv ? (a.sk_len + kTile - 1) / kTile
                                             : (a.s_len + kTile - 1) / kTile);
  int err = 0;
  if (which == Which::kFwd) {
    if ((err = Forward<T, D>::run(grid, a)) != 0) return err;
  } else if (which == Which::kDq) {
    if ((err = Backward<T, D>::dq(grid, a)) != 0) return err;
  } else {
    if ((err = Backward<T, D>::dkv(grid, a)) != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int info(Which which, int* out) {
  if (which == Which::kFwd) return Forward<T, D>::info(out);
  return Backward<T, D>::info(which, out);
}

// Calls Op<T, D>::run(args...) for the (dtype, head_dim) pair, D = 0 for the
// chunked kernels of a head dim above kMaxHeadDim; -1 for a pair with no
// kernel. dtype: 0 = float32, 1 = bfloat16.
template <template <typename, int> class Op, typename... A>
int dispatch(int dtype, int head_dim, A... args) {
  if (dtype != 0 && dtype != 1) return -1;
#define FEDML_FLASH_HEAD_DIM(D)                                                   \
  case D:                                                                         \
    return dtype == 0 ? Op<float, D>::run(args...) : Op<bf16, D>::run(args...);
  switch (head_dim) {
    FEDML_FLASH_HEAD_DIM(16)
    FEDML_FLASH_HEAD_DIM(32)
    FEDML_FLASH_HEAD_DIM(64)
    FEDML_FLASH_HEAD_DIM(96)
    FEDML_FLASH_HEAD_DIM(128)
    default: break;
  }
#undef FEDML_FLASH_HEAD_DIM
  if (head_dim > kMaxHeadDim && head_dim % kWide == 0)
    return dtype == 0 ? Op<float, 0>::run(args...) : Op<bf16, 0>::run(args...);
  return -1;
}

template <typename T, int D>
struct Launch {
  static int run(Which which, const Args& a) {
    if (a.bh <= 0 || a.s_len <= 0 || a.sk_len <= 0) return 0;
    if constexpr (D == 0) return launch_wide<T>(which, a);
    else return launch<T, D>(which, a);
  }
};

template <typename T, int D>
struct Info {
  static int run(Which which, int head_dim, int* out) {
    if constexpr (D == 0) return Wide<T>::info(which, head_dim, out);
    else return info<T, D>(which, out);
  }
};

}  // namespace

extern "C" {

int fedml_flash_max_head_dim() { return kMaxHeadDim; }
int fedml_flash_wide_chunk() { return kWide; }
int fedml_flash_tile() { return kTile; }

// The caller guarantees: device pointers to contiguous [bh, s_len, head_dim]
// q, o, dout, dq; [bh, sk_len, head_dim] k, v, dk, dv; [bh, s_len] float32
// lse and delta; causal only with s_len == sk_len. head_dim is one of the
// built dims up to kMaxHeadDim, or above it a multiple of kWide.
int fedml_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                    void* o, float* lse, int bh, int s_len, int sk_len, int causal,
                    float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, head_dim,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Launch>(dtype, head_dim, Which::kFwd, a);
}

int fedml_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta, void* dq,
                       int bh, int s_len, int sk_len, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, head_dim,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Launch>(dtype, head_dim, Which::kDq, a);
}

int fedml_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, void* dk,
                        void* dv, int bh, int s_len, int sk_len, int causal, float scale,
                        void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, head_dim,
         bh, s_len, sk_len, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Launch>(dtype, head_dim, Which::kDkv, a);
}

// The launch configuration of one kernel and what the compiler made of it:
// which 0 = K2, 1 = K3, 2 = K4; out[6] as kernel_info fills it. Returns a
// cudaError_t, or -1 for a (dtype, head_dim, which) with no kernel.
int fedml_flash_kernel_info(int dtype, int head_dim, int which, int* out) {
  if (which < 0 || which > 2) return -1;
  return dispatch<Info>(dtype, head_dim, static_cast<Which>(which), head_dim, out);
}

}  // extern "C"
