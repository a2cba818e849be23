"""Finite-field MPC primitives for secure aggregation (a copy of
``fedml_tpu/secagg/mpc.py``; numpy and the stdlib only; ref:
fedml_api/distributed/turboaggregate/mpc_function.py:4-271 — Shamir/BGW
secret sharing, Lagrange-coded computing (LCC), additive shares, DH key
agreement).

The reference computes share-by-share with Python ints and np.object math;
here everything is vectorized int64 over a Mersenne-prime field
p = 2^31 − 1 (products of two residues stay < 2^62, exact in int64 — safe on
accelerators too, where uint64 multiplies would overflow silently). Batched
polynomial evaluation is a Vandermonde matmul."""

from __future__ import annotations

import numpy as np

FIELD_PRIME = 2**31 - 1  # Mersenne prime; fits int64 products


def modular_inv(a, p: int = FIELD_PRIME):
    """a^(p-2) mod p (Fermat; ref modular_inv:4-18 uses extended Euclid)."""
    return pow(int(a) % p, p - 2, p)


def _mod(a, p):
    return np.mod(a, p).astype(np.int64)


def _matmul_mod(A, B, p):
    """Exact modular matmul: int64 with object fallback for big shapes.
    Row-blocked to keep intermediate sums < 2^63."""
    A = _mod(A, p)
    B = _mod(B, p)
    # sum of k products each < p^2 ≈ 4.6e18; block k so k*p^2 < 9.2e18
    k = A.shape[-1]
    block = max(1, int((2**63 - 1) // (int(p) ** 2)))
    out = np.zeros((A.shape[0], B.shape[1]), np.int64)
    for s in range(0, k, block):
        out = _mod(out + A[:, s : s + block] @ B[s : s + block, :], p)
    return out


def gen_lagrange_coeffs(alpha_s, beta_s, p: int = FIELD_PRIME):
    """U[i][j]: Lagrange basis l_j(alpha_i) over the field
    (ref gen_Lagrange_coeffs:39-59)."""
    alpha_s = [int(a) % p for a in alpha_s]
    beta_s = [int(b) % p for b in beta_s]
    U = np.zeros((len(alpha_s), len(beta_s)), np.int64)
    for i, a in enumerate(alpha_s):
        for j, b in enumerate(beta_s):
            num, den = 1, 1
            for l, bl in enumerate(beta_s):
                if l == j:
                    continue
                num = num * ((a - bl) % p) % p
                den = den * ((b - bl) % p) % p
            U[i, j] = num * modular_inv(den, p) % p
    return U


def bgw_encode(X: np.ndarray, N: int, T: int, p: int = FIELD_PRIME, rng=None):
    """Shamir/BGW: share secret matrix X [m, d] to N workers with threshold
    T — evaluate the degree-T polynomial X + Σ R_t z^t at α_i = i+1
    (ref BGW_encoding:62-76). Returns [N, m, d]."""
    rng = rng or np.random.default_rng()
    m, d = X.shape
    coeffs = np.concatenate(
        [
            _mod(X, p)[None],
            rng.integers(0, p, size=(T, m, d), dtype=np.int64),
        ]
    )  # [T+1, m, d]
    alphas = np.arange(1, N + 1, dtype=np.int64)
    # Vandermonde [N, T+1] @ coeffs [T+1, m*d]. Columns built iteratively
    # mod p: np.power(alphas, t) wraps int64 once N^T >= 2^63 and silently
    # corrupts the shares; col[t-1]*alphas keeps intermediates < p^2 < 2^62.
    V = np.empty((N, T + 1), np.int64)
    V[:, 0] = 1
    for t in range(1, T + 1):
        V[:, t] = V[:, t - 1] * alphas % p
    flat = coeffs.reshape(T + 1, m * d)
    return _matmul_mod(V, flat, p).reshape(N, m, d)


def bgw_decode(shares: np.ndarray, worker_idx, p: int = FIELD_PRIME):
    """Reconstruct the secret from ≥T+1 shares via Lagrange at z=0
    (ref gen_BGW_lambda_s:78-88 + BGW_decoding:90-108)."""
    alphas = [int(i) + 1 for i in worker_idx]
    lam = gen_lagrange_coeffs([0], alphas, p)[0]  # [K]
    K, m, d = shares.shape
    flat = shares.reshape(K, m * d)
    return _matmul_mod(lam[None, :], flat, p).reshape(m, d)


def lcc_encode_with_points(X, alpha_s, beta_s, p: int = FIELD_PRIME):
    """LCC: encode data blocks X [K, m, d] at evaluation points alpha_s via
    Lagrange interpolation through (beta_j, X_j)
    (ref LCC_encoding_with_points:227-247)."""
    X = np.asarray(X, np.int64)
    K, m, d = X.shape
    U = gen_lagrange_coeffs(alpha_s, beta_s, p)  # [N, K]
    return _matmul_mod(U, X.reshape(K, m * d), p).reshape(len(alpha_s), m, d)


def lcc_decode_with_points(f_eval, eval_points, target_points, p: int = FIELD_PRIME):
    """Decode targets from evaluations (ref LCC_decoding_with_points:249-260)."""
    f_eval = np.asarray(f_eval, np.int64)
    N, m, d = f_eval.shape
    U = gen_lagrange_coeffs(target_points, eval_points, p)
    return _matmul_mod(U, f_eval.reshape(N, m * d), p).reshape(len(target_points), m, d)


def gen_additive_shares(x: np.ndarray, n_out: int, p: int = FIELD_PRIME, rng=None):
    """Split x into n_out additive shares summing to x mod p
    (ref Gen_Additive_SS:214-224)."""
    rng = rng or np.random.default_rng()
    parts = rng.integers(0, p, size=(n_out - 1,) + x.shape, dtype=np.int64)
    last = _mod(_mod(x, p) - parts.sum(axis=0), p)
    return np.concatenate([parts, last[None]], axis=0)


# ---- key agreement: 2048-bit MODP group + SHA-256/SHAKE KDF ----
# Supersedes the reference's my_pk_gen/my_key_agreement
# (mpc_function.py:263-271+), which run DH in the toy aggregation field.
# The aggregation FIELD stays the 31-bit Mersenne prime above — field size
# is about exact int64 share arithmetic, not secrecy. Mask secrecy rests on
# this group and KDF: RFC 3526 group-14 DH with 256-bit secrets-sourced
# exponents (>= 128-bit security), SHA-256 extract + SHAKE-256 expand into
# field elements. The reference's my_key_agreement runs DH in the toy field
# itself (mpc_function.py:271) — brute-forceable by Pohlig-Hellman; this
# replaces it at zero dependency cost (all stdlib).

MODP_2048_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
MODP_2048_G = 2
DH_SECRET_BITS = 256


def dh_secret(rng=None) -> int:
    """256-bit DH exponent. ``rng=None`` (production) draws from OS
    entropy via ``secrets``; a caller-supplied numpy Generator keeps
    simulations/tests reproducible. The top bit is pinned so the secret
    space is exactly 2^255 — comfortably past 128-bit security for a
    2048-bit group."""
    if rng is None:
        import secrets

        v = secrets.randbits(DH_SECRET_BITS)
    else:
        v = int.from_bytes(rng.bytes(DH_SECRET_BITS // 8), "big")
    return v | (1 << (DH_SECRET_BITS - 1))


def dh_public(sk: int) -> int:
    return pow(MODP_2048_G, int(sk), MODP_2048_P)


def dh_shared(my_sk: int, their_pk: int) -> int:
    """their_pk^my_sk in the 2048-bit group. Degenerate public keys
    (0, ±1 mod p — which would force a known shared key) are rejected."""
    pk = int(their_pk) % MODP_2048_P
    if pk in (0, 1, MODP_2048_P - 1):
        raise ValueError("degenerate DH public key")
    return pow(pk, int(my_sk), MODP_2048_P)


def derive_pair_mask(
    shared_key: int, lo: int, hi: int, dim: int, p: int = FIELD_PRIME
) -> np.ndarray:
    """Expand a DH shared secret into ``dim`` field elements — the pair
    mask both endpoints compute identically (the context is the ORDERED
    pair (lo, hi), so each unordered pair has one mask).

    Extract: SHA-256 over a domain tag, the pair context, and the
    fixed-width shared secret. Expand: SHAKE-256 XOF, 8 bytes per
    element, reduced mod p (statistical distance from uniform is
    <= p/2^64 ~ 2^-33 per element)."""
    import hashlib
    import struct

    ikm = hashlib.sha256(
        b"fedml-tpu-secagg-v1"
        + struct.pack(">II", int(lo), int(hi))
        + int(shared_key).to_bytes(MODP_2048_P.bit_length() // 8, "big")
    ).digest()
    raw = hashlib.shake_256(ikm).digest(8 * int(dim))
    vals = np.frombuffer(raw, dtype=np.dtype(">u8"))
    return (vals % np.uint64(p)).astype(np.int64)
