"""K1 above 16 clients: a numpy emulation of the selection kernel
(``trimmed_mean_select_kernel`` in fedml_tpu_torch/ops/csrc/robust_stats.cu)
held bit-equal to the port's plain version, and the plain version held to
the reference's Pallas kernel (interpret mode) on special values.

The kernel runs only on the card; this file shows on the CPU that its
algorithm keeps exactly the values the stable-rank definition keeps. What
the emulation does, as the kernel does:

- keys: each non-NaN float maps to an order-preserving 32-bit key (every
  bit of a negative flipped, the sign bit of a non-negative set; -0 takes
  +0's key); a NaN has none and is in no rank;
- bounds: the values of stable rank k and min(C - k - 1, n - 1) among the
  n non-NaN values, found by radix select from the top: the top 8 bits in
  one pass when C <= 255 (a 256-bin histogram), then 4-bit digits (a
  16-bin histogram a pass); a bin holding one value ends that bound's
  passes, and its prefix alone decides; equal keys left after the last
  pass are told apart by index (the kernel's candidate list, which later
  passes read instead of the column, holds the same keys and is not
  emulated);
- keep: x_i is kept iff (key_i, i) lies between the two bounds in
  lexicographic order; nothing is kept when k >= n, and everything (NaN
  included) when k = 0;
- sum: acc = acc + (keep ? x_i : 0) in index order in float32, then one
  IEEE division by C - 2k; for k >= 1 the kernel adds the float of the
  kept key, which is x_i but for -0, which comes back as +0 (the same bits
  in the sum, which starts at +0 and is never -0).

Results are compared bit for bit (NaN with NaN)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fedml_tpu.ops.robust_stats import _trimmed_mean_2d  # noqa: E402

from fedml_tpu_torch.ops import robust_stats as rs  # noqa: E402
from torch_parity import torch_threads  # noqa: E402

ALL = 0xFFFFFFFF
BYTE_MAX_C = 255  # the kernel's kByteMaxC


def digits(C):
    """(shift, bits) of each radix pass, from the top."""
    first = [(24, 8)] if C <= BYTE_MAX_C else [(28, 4)]
    return first + [(shift, 4) for shift in range(first[0][0] - 4, -1, -4)]


def order_keys(x: np.ndarray) -> np.ndarray:
    """int64 keys of float32 x (NaN positions get a key too; callers mask them)."""
    u = x.view(np.uint32).astype(np.int64)
    u[x == 0] = 0
    return np.where(u >> 31 == 1, ~u & ALL, u | 0x80000000)


def key_values(keys: np.ndarray) -> np.ndarray:
    """The floats of int64 keys (-0's key gives +0)."""
    u = np.where(keys >> 31 == 1, keys ^ 0x80000000, keys ^ ALL)
    return u.astype(np.uint32).view(np.float32)


def select_bounds(keys, valid, k):
    """Per column: the lower and upper bound as (mask, prefix, index) and
    the columns where nothing is kept, by the kernel's radix select."""
    C, D = keys.shape
    cols = np.arange(D)
    n = valid.sum(axis=0)
    none = k >= n
    rank = {"lo": np.full(D, k), "hi": np.minimum(C - k - 1, n - 1)}
    prefix = {b: np.zeros(D, np.int64) for b in rank}
    active = {b: ~none for b in rank}
    mask_of = {b: np.full(D, ALL, np.int64) for b in rank}
    index_of = {"lo": np.zeros(D, np.int64), "hi": np.full(D, C, np.int64)}
    mask = 0
    for shift, bits in digits(C):
        bins = 1 << bits
        digit = (keys >> shift) & (bins - 1)
        for b in ("lo", "hi"):
            cand = valid & ((keys & mask) == prefix[b][None, :])
            flat = (cols[None, :] * bins + digit)[cand]
            hist = np.bincount(flat, minlength=D * bins).reshape(D, bins)
            cum = hist.cumsum(axis=1)
            dig = (cum > rank[b][:, None]).argmax(axis=1)
            count = hist[cols, dig]
            act = active[b]
            prefix[b] = np.where(act, prefix[b] | (dig << shift), prefix[b])
            rank[b] = np.where(act, rank[b] - (cum[cols, dig] - count), rank[b])
            done = act & (count == 1)
            mask_of[b] = np.where(done, mask | ((bins - 1) << shift), mask_of[b])
            active[b] = act & ~done
        mask |= (bins - 1) << shift
    for b in ("lo", "hi"):  # ties on the whole key: the index among its equals
        eq = valid & (keys == prefix[b][None, :])
        nth = (eq.cumsum(axis=0) - 1 == rank[b][None, :]) & eq
        index_of[b] = np.where(active[b], nth.argmax(axis=0), index_of[b])
    return ({b: (mask_of[b], prefix[b], index_of[b]) for b in rank}, none)


def select_trimmed_mean(x: np.ndarray, k: int) -> np.ndarray:
    """The selection kernel's result on x [C, D] float32."""
    C, D = x.shape
    idx = np.arange(C)[:, None]
    if k == 0:
        keep, vals = np.ones((C, D), bool), x
    else:
        keys, valid = order_keys(x), ~np.isnan(x)
        bounds, none = select_bounds(keys, valid, k)
        m, p, i = bounds["lo"]
        km = keys & m[None, :]
        above = (km > p[None, :]) | ((km == p[None, :]) & (idx >= i[None, :]))
        m, p, i = bounds["hi"]
        km = keys & m[None, :]
        below = (km < p[None, :]) | ((km == p[None, :]) & (idx <= i[None, :]))
        keep = valid & above & below & ~none[None, :]
        vals = key_values(keys)
    acc = np.zeros(D, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for r in range(C):
            acc = acc + np.where(keep[r], vals[r], np.float32(0))
        return acc / np.float32(C - 2 * k)


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    nan = np.isnan(got)
    return bool((nan == np.isnan(want)).all()
                and (got[~nan].view(np.uint32) == want[~nan].view(np.uint32)).all())


D = 32
KINDS = ("randn", "int_ties", "signed_zeros", "infs", "one_nan", "nans")


def _column_block(kind: str, C: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, D)).astype(np.float32)
    if kind == "int_ties":
        x = rng.integers(-3, 4, size=(C, D)).astype(np.float32)
    elif kind == "signed_zeros":  # half the values ±0, the rest ±1 or randn
        pick = rng.integers(0, 4, size=(C, D))
        x = np.where(pick == 0, np.float32(0.0), x)
        x = np.where(pick == 1, np.float32(-0.0), x)
        x = np.where((pick == 2) & (rng.random((C, D)) < 0.5), np.sign(x), x).astype(np.float32)
    elif kind == "infs":
        pick = rng.random((C, D))
        x[pick < 0.1] = np.inf
        x[pick > 0.9] = -np.inf
    elif kind == "one_nan":
        x[rng.integers(0, C, size=D), np.arange(D)] = np.nan
    elif kind == "nans":  # a few NaNs a column, many in some, all in the last two
        x[rng.random((C, D)) < 0.05] = np.nan
        x[:, -6:-2][rng.random((C, 4)) < 0.6] = np.nan
        x[:, -2:] = np.nan
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("C", [17, 33, 100, 128, 200, 455, 1000])
def test_selection_is_bit_equal_to_the_plain_version(C, kind):
    x = _column_block(kind, C, seed=C * 7 + KINDS.index(kind))
    xt = torch.from_numpy(x)
    for k in sorted({0, 1, C // 4, rs.median_trim_k(C)}):
        with torch_threads(1):  # C small ops a call: threads only contend
            want = rs.trimmed_mean_plain(xt, k).numpy()
        got = select_trimmed_mean(x, k)
        assert _same_bits(got, want), f"C={C} {kind} k={k}"


def test_special_value_columns_keep_what_the_definition_keeps():
    """Hand-made columns: a lone NaN is dropped once k >= 1 and the rest keep
    their ranks; an all-NaN column keeps nothing; -0 and +0 tie by index;
    ±inf are ordinary values."""
    C = 17
    cols = np.stack([
        np.r_[np.nan, np.arange(16, dtype=np.float32)],
        np.full(C, np.nan, np.float32),
        np.r_[[-0.0, 0.0] * 8, 1.0].astype(np.float32),
        np.r_[np.inf, -np.inf, np.zeros(15, np.float32)],
    ], axis=1).astype(np.float32)
    k = rs.median_trim_k(C)  # 8: one value kept
    got = select_trimmed_mean(cols, k)
    want = rs.trimmed_mean_plain(torch.from_numpy(cols), k).numpy()
    assert _same_bits(got, want)
    # 16 non-NaN values of ranks 0..15: rank 8 is the value 8
    assert got[0] == 8.0 and got[1] == 0.0 and got[3] == 0.0
    assert got[2] == 0.0
    assert np.isnan(select_trimmed_mean(cols, 0)[0])


@pytest.mark.parametrize("C", [5, 17])
def test_plain_version_pins_the_reference_kernel_on_special_values(C):
    """The port's plain version against the reference's Pallas kernel
    (interpret mode) on integer values with ±0, ±inf and NaN, D = 256.
    XLA:CPU divides by C - 2k as a multiply by its float32 reciprocal, so
    the reference's result is fl(S · fl(1/n)) where the port's is fl(S / n)
    for the same index-order sum S. On integer values S is exact and is
    read back from the port's result as round(out · n); it must give the
    reference's result bit for bit, and the port's through the division."""
    rng = np.random.default_rng(C)
    x = rng.integers(-3, 4, size=(C, 256)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    pick = rng.random((C, 256)) < 0.3
    x[pick] = special[rng.integers(0, 5, size=int(pick.sum()))]
    x[:, :4] = np.nan  # all-NaN columns
    for k in sorted({0, 1, C // 4, rs.median_trim_k(C)}):
        n = C - 2 * k
        port = rs.trimmed_mean_plain(torch.from_numpy(x), k).numpy()
        ref = np.asarray(_trimmed_mean_2d(jnp.asarray(x), k, 256, True))
        with np.errstate(invalid="ignore"):
            s = np.round(port.astype(np.float64) * n).astype(np.float32)
            assert _same_bits(s / np.float32(n), port), f"C={C} k={k}: the sum read back"
            assert _same_bits(s * np.float32(1.0 / n), ref), f"C={C} k={k}"
        assert _same_bits(select_trimmed_mean(x, k), port), f"C={C} k={k}"
