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
// (C + 1) * 4 bytes. Two kernels, both bound by those bytes by design:
//   - 1 <= C <= 16 (the cohorts of a round; 10 on the north-star path):
//     `trimmed_mean_reg_kernel<C>`, one thread a coordinate, the column in
//     registers, the stable ranks by the formula above with the compares
//     fully unrolled (~C^2 of them: 110 at C = 10 for 44 bytes), all C
//     loads of a thread in flight before the first compare; a grid-stride
//     loop over D, neighbouring threads on neighbouring d;
//   - C > 16: `trimmed_mean_select_kernel`, whose work on a coordinate
//     grows with C, not C^2. Only two order statistics of a column decide
//     the kept window, so they are found by radix select and the kept
//     values summed in one pass in index order, a thread a column:
//       keys   an order-preserving 32-bit key of each float (flip every bit
//              of a negative, set the sign bit of a non-negative; -0 takes
//              +0's key), so keys compare as the floats' < and == do; a NaN
//              compares false with everything, so it is in no rank and its
//              own rank is 0 (kept only when trim_k = 0): it takes key 0,
//              which no float has, and is left out of every count;
//       bounds the values of stable rank k = trim_k and min(C - k - 1,
//              n - 1) among the n non-NaN values, each a (key, index) pair;
//              x_i is kept iff (key_i, i) lies between them in
//              lexicographic order (none is kept if k >= n);
//       select radix select from the top, both bounds at once (they share
//              their bins until their prefixes differ): for C <= 255 the
//              top 8 bits are counted while the column is turned into keys,
//              in 256 byte counters of the thread's in shared memory; then
//              4 bits a pass, a 16-bin histogram counted in registers (4-bit
//              counts packed in a 64-bit word: a shift and an add a key, no
//              branch). A bin holding one key settles its bound (its prefix
//              alone then decides); once the bounds' bins hold 32 keys or
//              fewer, those are copied to a list of the thread's and later
//              passes read only it; equal keys left after the last pass are
//              told apart by index;
//       sum    the same thread then adds its column's kept values in index
//              order, acc = acc + (keep ? x_i : 0) for i = 0..C-1, and
//              divides once: the plain version's order, so bit-equal.
//     Nothing is shared between threads: a warp owns 32 consecutive
//     columns, and each lane copies its own with cp.async into the warp's
//     [C][33] tile (4 bytes a lane, so one copy instruction moves a row of
//     the 32 columns, coalesced), turns it into keys in place and then
//     reads only that column, one bank per lane. The block holds 1, 2 or 4
//     such warps, whichever lets most warps share an SM; a tile too large
//     for a block's shared memory (C above ~1,700) is read from device
//     memory instead, through L1/L2, and its keys made on every read.
//     The tiles bound the warps an SM holds (8 at C = 128), and a warp runs
//     until its slowest lane's column is settled, so the kernel is bound by
//     latency and divergence, not by bytes: 1.46 ms for the median of
//     [128, 1,690,046] against 0.260 ms of bytes (NVIDIA H100 80GB HBM3).
//     Tried before it (the same card): a warp a column, counting across
//     its lanes with shuffles, ballots and shared atomics, 3.1 ms (each
//     step waits on the one before); a thread a column counting in shared
//     memory, 17 ms with atomics, 3.1 ms with plain increments; branchy
//     counts in registers, 1.9 ms.
//   - no padding of D: the tail is guarded. Loads are 4 bytes: a row of
//     [C, D] starts 16-byte aligned only when D is a multiple of 4, which
//     the CNN's D = 1,690,046 is not.

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kThreads = 128;
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

// ---------------------------------------------------------------- C > 16

constexpr int kDigitBits = 4;
constexpr int kBins = 1 << kDigitBits;  // bins of one digit
constexpr int kTileLd = 33;             // row stride (words) of a warp's [C][32] column tile
// the candidates a thread copies out of its column once its passes have
// narrowed them to this many: later passes read only them
constexpr int kListMax = 32;
// the key every NaN takes: no float's order key (it would be a NaN's)
constexpr unsigned kNanKey = 0u;

// The order-preserving key of a float: unsigned order of keys is the floats'
// order, -0 takes +0's key (the two compare equal), and a NaN takes kNanKey.
__device__ __forceinline__ unsigned order_key(float x) {
  if (x != x) return kNanKey;
  const unsigned u = x == 0.0f ? 0u : __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
// The float of a key; -0's key gives +0 (see trimmed_mean_select_kernel)
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
}

// One boundary of the kept window: x_i is at or above a lower bound iff
// (key_i & mask, i) >= (prefix, index) lexicographically, at or below an
// upper bound iff (key_i & mask, i) <= (prefix, index). A bound found before
// its last digit has a prefix that one value alone holds, so its index does
// not matter (0 for a lower bound, C for an upper one).
struct Bound {
  unsigned mask, prefix;
  int index;
};

// (bitwise & and |, not && and ||: the tests run on every key of a column,
// and short-circuit branches would cost more than the tests)
__device__ __forceinline__ bool at_or_above(const Bound& b, unsigned key, int i) {
  const unsigned k = key & b.mask;
  return (k > b.prefix) | ((k == b.prefix) & (i >= b.index));
}
__device__ __forceinline__ bool at_or_below(const Bound& b, unsigned key, int i) {
  const unsigned k = key & b.mask;
  return (k < b.prefix) | ((k == b.prefix) & (i <= b.index));
}

// One key's count in a histogram of its 4-bit digit at `shift`, held in
// registers as 16 counts of 4 bits in a 64-bit word: 1 in the digit's
// nibble if the key's masked bits equal prefix p, else 0. Counting a key is
// then a shift and an add, with no branch: a count in shared memory waits
// on its own load, a shared atomic on the atomic unit, and a branch a key
// costs more than the count.
__device__ __forceinline__ unsigned long long nibble_count(unsigned key, unsigned mask, unsigned p,
                                                           int shift) {
  const unsigned long long one = (key & mask) == p ? 1ull : 0ull;
  return one << (((key >> shift) & (kBins - 1)) * 4u);
}

// 15 keys' nibble counts moved into 8-bit counts: even bins in `even`, odd
// bins in `odd` (byte b holds bin 2b or 2b + 1), which hold 17 such moves.
__device__ __forceinline__ void widen(unsigned long long c, unsigned long long& even,
                                      unsigned long long& odd) {
  even += c & 0x0f0f0f0f0f0f0f0full;
  odd += (c >> 4) & 0x0f0f0f0f0f0f0f0full;
}
__device__ __forceinline__ void add_bytes(unsigned long long even, unsigned long long odd,
                                          unsigned (&n)[kBins]) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    n[2 * b] += static_cast<unsigned>(even >> (8 * b)) & 0xffu;
    n[2 * b + 1] += static_cast<unsigned>(odd >> (8 * b)) & 0xffu;
  }
}

// The digit at `shift` of the keys key_at(0 .. len-1) with prefix p0 counted
// into n0, and of those with prefix p1 into n1 (p1 may be a prefix no key
// has: ~mask, with bits outside the mask, when one histogram serves).
template <typename Keys>
__device__ __forceinline__ void count_pass(const Keys& key_at, int len, unsigned mask, int shift,
                                           unsigned p0, unsigned p1, unsigned (&n0)[kBins],
                                           unsigned (&n1)[kBins]) {
#pragma unroll
  for (int b = 0; b < kBins; ++b) n0[b] = n1[b] = 0u;
  for (int base = 0; base < len; base += 255) {  // 8-bit counts: 255 keys
    unsigned long long e0 = 0, o0 = 0, e1 = 0, o1 = 0;
    const int end = min(len, base + 255);
    int i = base;
    for (; i + 15 <= end; i += 15) {  // 4-bit counts: 15 keys
      unsigned long long c0 = 0, c1 = 0;
#pragma unroll
      for (int u = 0; u < 15; ++u) {
        const unsigned key = key_at(i + u);
        c0 += nibble_count(key, mask, p0, shift);
        c1 += nibble_count(key, mask, p1, shift);
      }
      widen(c0, e0, o0);
      widen(c1, e1, o1);
    }
    unsigned long long c0 = 0, c1 = 0;
    for (; i < end; ++i) {
      const unsigned key = key_at(i);
      c0 += nibble_count(key, mask, p0, shift);
      c1 += nibble_count(key, mask, p1, shift);
    }
    widen(c0, e0, o0);
    widen(c1, e1, o1);
    add_bytes(e0, o0, n0);
    add_bytes(e1, o1, n1);
  }
}

// The bin that holds rank r (0-based) of a histogram: its digit, the count
// in the bins below it and its own count.
struct Pick {
  unsigned digit, below, count;
};

__device__ __forceinline__ Pick pick_bin(const unsigned (&n)[kBins], unsigned r) {
  Pick p{0u, 0u, 0u};
  unsigned below = 0;
  bool found = false;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    if (!found && below + n[b] > r) {
      found = true;
      p = Pick{static_cast<unsigned>(b), below, n[b]};
    }
    below += n[b];
  }
  return p;
}

// The index of the r-th (0-based) key equal to `key`, in index order, over
// the column's keys key_at(0 .. C-1).
template <typename Keys>
__device__ __forceinline__ int nth_equal(const Keys& key_at, int C, unsigned key, unsigned r) {
  for (int i = 0; i < C; ++i) {
    if (key_at(i) == key) {
      if (r == 0) return i;
      --r;
    }
  }
  return C;  // not reached: the caller's r counts such keys
}

// The first pass of a column of at most kByteMaxC keys: the top 8 bits of
// each non-NaN key counted while the keys are made, in 256 byte counters
// of the thread's in shared memory (bins 4w .. 4w + 3 in word w, at
// bytes[w * 32]). One pass of the column then decides 8 bits, not 4. An
// increment waits on its own load, so keys are counted two at a time: both
// words are read, then both written (the same word takes both increments).
constexpr int kByteMaxC = 255;
constexpr int kByteWords = 64;
static_assert(kListMax <= kByteWords, "the list reuses the histogram's words");
// a warp's scratch, [kByteWords][32]: lane l's word j at j * 32 + l, so the
// lanes' words never share a bank
constexpr int kWarpScratchWords = kByteWords * 32;

__device__ __forceinline__ unsigned top_byte_word(unsigned key) { return (key >> 26) * 32; }
__device__ __forceinline__ unsigned top_byte_one(unsigned key) {
  return static_cast<unsigned>(key != kNanKey) << ((key >> 21) & 0x18u);
}
__device__ __forceinline__ void count_top_byte(unsigned* __restrict__ bytes, unsigned k0,
                                               unsigned k1) {
  const unsigned w0 = top_byte_word(k0), w1 = top_byte_word(k1);
  const unsigned one0 = top_byte_one(k0), one1 = top_byte_one(k1);
  const unsigned v0 = bytes[w0], v1 = bytes[w1];
  const bool same = w0 == w1;
  bytes[w0] = v0 + one0 + (same ? one1 : 0u);
  bytes[w1] = v1 + one1 + (same ? one0 : 0u);
}

// The bin of the top-byte histogram that holds rank r, given the word w
// that holds it, its bytes v and the count `below` of the words before it.
__device__ __forceinline__ Pick pick_in_word(unsigned w, unsigned v, unsigned below, unsigned r) {
  Pick p{0u, 0u, 0u};
  bool found = false;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const unsigned n = (v >> (8 * b)) & 0xffu;
    if (!found && below + n > r) {
      found = true;
      p = Pick{4u * w + b, below, n};
    }
    below += n;
  }
  return p;
}

// Of kN words of the top-byte histogram whose counts are sums[0 .. kN-1],
// the one that holds rank r: its place, and the count before it.
template <int kN>
__device__ __forceinline__ void find_word(const unsigned (&sums)[kN], unsigned r, unsigned& at,
                                          unsigned& before) {
  unsigned below = 0;
  bool found = false;
  at = 0;
  before = 0;
#pragma unroll
  for (int w = 0; w < kN; ++w) {
    const bool here = !found & (below + sums[w] > r);
    at = here ? w : at;
    before = here ? below : before;
    found |= here;
    below += sums[w];
  }
}

// The bins of the top-byte histogram that hold ranks r_lo and r_hi, found
// through the counts of its 8 groups of 8 words (8 short sums that run side
// by side, not one long one).
__device__ __forceinline__ void pick_top_byte(const unsigned* __restrict__ bytes, unsigned r_lo,
                                              unsigned r_hi, Pick& lo, Pick& hi) {
  unsigned group[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += bytes[(8 * g + w) * 32];
    group[g] = (sum * 0x01010101u) >> 24;  // the bytes' sum: at most 255 in all
  }
  const auto pick = [&](unsigned r) -> Pick {
    unsigned g, before;
    find_word(group, r, g, before);
    unsigned words[8], v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      v[w] = bytes[(8 * g + w) * 32];
      words[w] = (v[w] * 0x01010101u) >> 24;
    }
    unsigned at, below;
    find_word(words, r - before, at, below);
    unsigned word = v[0];
#pragma unroll
    for (int w = 1; w < 8; ++w) word = at == w ? v[w] : word;
    return pick_in_word(8 * g + at, word, before + below, r);
  };
  lo = pick(r_lo);
  hi = pick(r_hi);
}

// The search for a column's two bounds, as a thread holds it in registers.
struct Search {
  unsigned mask;        // the key bits decided so far
  unsigned p_lo, p_hi;  // each bound's prefix
  unsigned r_lo, r_hi;  // each bound's rank among its prefix's keys
  bool act_lo, act_hi;  // not yet settled
  int listed;           // keys in the candidate list, once it is used; else -1
};

// The bins just picked for the active bounds at `shift` (hi's from another
// histogram than lo's if `two`): their digits join the prefixes, a bin of
// one key settles its bound, and once the bins hold kListMax keys or fewer
// those keys are copied to the list (without a branch: a key that is not a
// candidate is written where the next one will go). False once both
// bounds are settled.
template <typename Keys>
__device__ __forceinline__ bool settle(Search& st, const Pick& b_lo, const Pick& b_hi, int shift,
                                       bool two, const Keys& key_at, int C,
                                       unsigned* __restrict__ list, Bound& lo, Bound& hi) {
  unsigned left = 0;  // the keys the active bounds' bins hold
  if (st.act_lo) {
    st.p_lo |= b_lo.digit << shift;
    st.r_lo -= b_lo.below;
    left += b_lo.count;
    if (b_lo.count == 1) {
      st.act_lo = false;
      lo = Bound{st.mask, st.p_lo, 0};
    }
  }
  if (st.act_hi) {
    st.p_hi |= b_hi.digit << shift;
    st.r_hi -= b_hi.below;
    if (!st.act_lo || two || st.p_hi != st.p_lo) left += b_hi.count;  // else the same bin
    if (b_hi.count == 1) {
      st.act_hi = false;
      hi = Bound{st.mask, st.p_hi, C};
    }
  }
  if (!st.act_lo && !st.act_hi) return false;
  if (st.listed < 0 && left <= kListMax) {
    const auto candidate = [&](unsigned key) -> int {
      const unsigned high = key & st.mask;
      return (key != kNanKey) & ((st.act_lo & (high == st.p_lo)) | (st.act_hi & (high == st.p_hi)));
    };
    // 4 keys at a time, so that the count the stores wait on grows once a
    // step; n + 3 <= kListMax + 3 < kByteWords: inside the scratch
    int n = 0, i = 0;
    for (; i + 4 <= C; i += 4) {
      unsigned key[4];
      int at[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) key[u] = key_at(i + u);
      at[0] = n;
#pragma unroll
      for (int u = 1; u < 4; ++u) at[u] = at[u - 1] + candidate(key[u - 1]);
#pragma unroll
      for (int u = 0; u < 4; ++u) list[at[u] * 32] = key[u];
      n = at[3] + candidate(key[3]);
    }
    for (; i < C; ++i) {
      const unsigned key = key_at(i);
      list[n * 32] = key;
      n += candidate(key);
    }
    st.listed = n;
  }
  return true;
}

// Both bounds of one column, found by the thread that owns it, from its keys
// key_at(0 .. C-1) of which `valid` are not NaN; trim_k >= 1. scratch: the
// thread's kByteWords words (entry j at [j * 32]): the top-byte histogram
// if `top_byte` (C <= kByteMaxC: count_top_byte has counted every key),
// then its candidate list. Each pass counts the next digit of the keys that
// share a bound's prefix; once the bounds' bins hold kListMax keys or fewer,
// those keys are copied to the list and later passes read only them.
template <typename Keys>
__device__ __forceinline__ void select_bounds(const Keys& key_at, int C, int trim_k, int valid, bool top_byte,
                              unsigned* __restrict__ scratch, Bound& lo, Bound& hi) {
  if (trim_k >= valid) {  // no rank reaches the window: nothing is kept
    lo = Bound{0u, 1u, 0};
    hi = Bound{0xffffffffu, 0u, C};
    return;
  }
  unsigned* list = scratch;
  const auto list_at = [list](int j) -> unsigned { return list[j * 32]; };
  Search st{0u, 0u, 0u, static_cast<unsigned>(trim_k),
            static_cast<unsigned>(min(C - trim_k - 1, valid - 1)), true, true, -1};
  int shift = 32 - kDigitBits;
  if (top_byte) {
    Pick b_lo, b_hi;
    pick_top_byte(scratch, st.r_lo, st.r_hi, b_lo, b_hi);
    st.mask = 0xff000000u;
    if (!settle(st, b_lo, b_hi, 24, false, key_at, C, list, lo, hi)) return;
    shift = 24 - kDigitBits;
  }
  for (; shift >= 0; shift -= kDigitBits) {
    // one histogram while the bounds share a prefix, two once they differ
    const bool two = st.act_lo && st.act_hi && st.p_lo != st.p_hi;
    const unsigned p0 = st.act_lo ? st.p_lo : st.p_hi;
    const unsigned p1 = two ? st.p_hi : ~st.mask;
    unsigned n0[kBins], n1[kBins];
    if (st.listed >= 0) {
      count_pass(list_at, st.listed, st.mask, shift, p0, p1, n0, n1);
    } else {
      count_pass(key_at, C, st.mask, shift, p0, p1, n0, n1);
      // the NaN keys (0) fell in bin 0 wherever the prefix is all zeros
      if (p0 == 0u) n0[0] -= C - valid;
      if (two && st.p_hi == 0u) n1[0] -= C - valid;
    }
    st.mask |= static_cast<unsigned>(kBins - 1) << shift;
    const Pick b_lo = pick_bin(n0, st.r_lo);
    // each call names its array, so that none is chosen at run time
    const Pick b_hi = two ? pick_bin(n1, st.r_hi) : pick_bin(n0, st.r_hi);
    if (!settle(st, b_lo, b_hi, shift, two, key_at, C, list, lo, hi)) return;
  }
  // every key bit decided and the key held more than once: the tie-break is
  // the index among its equals
  if (st.act_lo) lo = Bound{0xffffffffu, st.p_lo, nth_equal(key_at, C, st.p_lo, st.r_lo)};
  if (st.act_hi) hi = Bound{0xffffffffu, st.p_hi, nth_equal(key_at, C, st.p_hi, st.r_hi)};
}

// 4 bytes global -> shared without passing through registers; zero if !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0));
}

// kTile: each warp's columns are copied into its shared-memory tile and,
// for trim_k >= 1, turned into their keys in place (else read from device
// memory and turned into keys on every pass). Dynamic shared memory: each
// warp's scratch, then (kTile) each warp's [C][kTileLd] tile. The sum
// adds key_value(key_i), which is x_i but for -0, which it gives as +0:
// acc starts at +0 and no IEEE sum of it and further values is -0, so
// adding +0 or -0 to it gives the same bits.
template <bool kTile>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_select_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                           long long D, int trim_k) {
  extern __shared__ __align__(16) unsigned select_smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned* scratch = select_smem + warp * kWarpScratchWords + lane;  // this thread's
  float* tile = reinterpret_cast<float*>(select_smem + warps * kWarpScratchWords) +
                static_cast<size_t>(warp) * C * kTileLd + lane;  // this lane's column
  unsigned* tile_keys = reinterpret_cast<unsigned*>(tile);
  const float keep_n = static_cast<float>(C - 2 * trim_k);
  const long long groups = (D + 31) / 32;
  for (long long grp = static_cast<long long>(blockIdx.x) * warps + warp; grp < groups;
       grp += static_cast<long long>(gridDim.x) * warps) {
    const long long d0 = grp * 32;
    const bool mine = d0 + lane < D;  // this lane's column exists
    const float* xg = x + d0 + lane;  // x_i of this lane's column at xg[i * D]
    if (kTile) {
      for (int i = 0; i < C; ++i) cp_async4(tile + i * kTileLd, mine ? xg + i * D : x, mine);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    if (!mine) continue;
    float acc = 0.0f;  // the kept values in index order
    if (trim_k == 0) {  // everything is kept, NaN included
      for (int i = 0; i < C; ++i) acc = acc + (kTile ? tile[i * kTileLd] : __ldg(xg + i * D));
    } else {
      int valid = 0;
      const bool top_byte = C <= kByteMaxC;
      if (top_byte)
        for (int j = 0; j < kByteWords; ++j) scratch[j * 32] = 0u;
      for (int i = 0; i < C; i += 2) {  // keys in pairs; a lone last one pairs with NaN
        const unsigned k0 = order_key(kTile ? tile[i * kTileLd] : __ldg(xg + i * D));
        const unsigned k1 = i + 1 < C
                                ? order_key(kTile ? tile[(i + 1) * kTileLd] : __ldg(xg + (i + 1) * D))
                                : kNanKey;
        if (kTile) {
          tile_keys[i * kTileLd] = k0;
          if (i + 1 < C) tile_keys[(i + 1) * kTileLd] = k1;
        }
        if (top_byte) count_top_byte(scratch, k0, k1);
        valid += (k0 != kNanKey) + (k1 != kNanKey);
      }
      const auto key_at = [&](int i) -> unsigned {
        return kTile ? tile_keys[i * kTileLd] : order_key(__ldg(xg + i * D));
      };
      Bound lo, hi;
      select_bounds(key_at, C, trim_k, valid, top_byte, scratch, lo, hi);
      for (int i = 0; i < C; ++i) {
        const unsigned key = key_at(i);
        const bool keep = (key != kNanKey) & at_or_above(lo, key, i) & at_or_below(hi, key, i);
        acc = acc + (keep ? key_value(key) : 0.0f);
      }
    }
    out[d0 + lane] = acc / keep_n;
  }
}

using RegKernel = void (*)(const float*, float*, long long, int);
using SelectKernel = void (*)(const float*, float*, int, long long, int);

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

// How a cohort of C > 16 launches on one device: the select kernel, its
// threads a block (1, 2 or 4 warps), its dynamic shared memory and the
// blocks that fit one SM.
struct SelectLaunch {
  SelectKernel kernel;
  int threads;
  size_t smem;
  int blocks_per_sm;
};

// Works out the SelectLaunch of (current device, C) once and keeps it: the
// attribute, opt-in and occupancy queries would otherwise be host time on
// every launch. Client actors launch from several threads, hence the lock.
int select_launch(int C, SelectLaunch* out) {
  static std::mutex mu;
  static std::unordered_map<long long, SelectLaunch> known;
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
  const size_t scratch_bytes = kWarpScratchWords * sizeof(unsigned);
  const size_t warp_bytes = scratch_bytes + static_cast<size_t>(C) * kTileLd * sizeof(float);
  // the column tile: the block size that lets most warps share an SM
  SelectLaunch best{trimmed_mean_select_kernel<true>, 0, 0, 0};
  err = static_cast<int>(cudaFuncSetAttribute(
      trimmed_mean_select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
  for (int warps = kThreads / 32; err == 0 && warps >= 1; warps /= 2) {
    const size_t smem = warps * warp_bytes;
    if (smem > static_cast<size_t>(optin)) continue;
    int blocks = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, trimmed_mean_select_kernel<true>, warps * 32, smem));
    if (err == 0 && blocks * warps > best.blocks_per_sm * best.threads / 32)
      best = SelectLaunch{trimmed_mean_select_kernel<true>, warps * 32, smem, blocks};
  }
  if (err == 0 && best.threads == 0) {  // no tile fits: columns from device memory
    best = SelectLaunch{trimmed_mean_select_kernel<false>, kThreads, (kThreads / 32) * scratch_bytes, 0};
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &best.blocks_per_sm, best.kernel, best.threads, best.smem));
  }
  if (err != 0) return err;
  known.emplace(key, best);
  *out = best;
  return 0;
}

// out[5] = threads a block, registers a thread, local memory bytes a thread
// (spills), dynamic shared memory bytes a block, blocks resident on one SM
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
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
  return 0;
}

// blocks of a grid-stride launch over `work` items of `per_block` each: as
// many as the work needs, at most the blocks the SMs hold at once
int grid_for(long long work, long long per_block, int sm_count, int blocks_per_sm) {
  const long long need = (work + per_block - 1) / per_block;
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
    kernel<<<grid_for(D, kThreads, sm_count, kRegBlocksPerSm), kThreads, 0, s>>>(x, out, D,
                                                                                 trim_k);
    return static_cast<int>(cudaGetLastError());
  }
  SelectLaunch launch;
  const int err = select_launch(C, &launch);
  if (err != 0) return err;
  // a warp takes 32 columns at a time
  const int grid = grid_for((D + 31) / 32, launch.threads / 32, sm_count, launch.blocks_per_sm);
  launch.kernel<<<grid, launch.threads, launch.smem, s>>>(x, out, C, D, trim_k);
  return static_cast<int>(cudaGetLastError());
}

// The kernel that takes a cohort of C and what the compiler made of it
// (out[5] as kernel_info fills it); returns a cudaError_t.
int fedml_robust_stats_kernel_info(int C, int* out) {
  if (const RegKernel kernel = reg_kernel(C)) return kernel_info(kernel, kThreads, 0, out);
  SelectLaunch launch;
  const int err = select_launch(C, &launch);
  return err != 0 ? err : kernel_info(launch.kernel, launch.threads, launch.smem, out);
}

}  // extern "C"
