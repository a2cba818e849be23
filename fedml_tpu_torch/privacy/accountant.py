"""Rényi-DP accountant for the subsampled Gaussian mechanism (a copy of
``fedml_tpu/privacy/accountant.py``, which is pure ``math``: float64 host
arithmetic, so the port's epsilon is the reference's).

For integer order alpha >= 2, sampling ratio q and noise multiplier
sigma, one round of the Poisson-subsampled Gaussian mechanism satisfies

    RDP(alpha) <= 1/(alpha-1) * log( sum_{k=0..alpha}
        C(alpha,k) (1-q)^(alpha-k) q^k * exp(k(k-1)/(2 sigma^2)) )

(Mironov's integer-order bound; at q = 1 the plain Gaussian
alpha/(2 sigma^2)). RDP composes additively over rounds; epsilon =
min over orders of RDP(alpha) + log(1/delta)/(alpha-1)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

_DEFAULT_ORDERS = tuple(range(2, 129)) + (160, 192, 224, 256, 320, 384, 448, 512)


def _log_comb(a: int, k: int) -> float:
    return (
        math.lgamma(a + 1) - math.lgamma(k + 1) - math.lgamma(a - k + 1)
    )


def _logsumexp(xs) -> float:
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_subsampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """RDP of order ``alpha`` for one subsampled-Gaussian round."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling ratio q must be in [0, 1], got {q}")
    if sigma <= 0:
        raise ValueError(f"noise multiplier must be > 0, got {sigma}")
    if alpha < 2 or int(alpha) != alpha:
        raise ValueError(f"integer alpha >= 2 required, got {alpha}")
    if q == 0.0:
        return 0.0
    if q == 1.0:
        return alpha / (2.0 * sigma * sigma)
    log_terms = [
        _log_comb(alpha, k)
        + (alpha - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + (k * (k - 1)) / (2.0 * sigma * sigma)
        for k in range(alpha + 1)
    ]
    return _logsumexp(log_terms) / (alpha - 1)


class RdpAccountant:
    """Additive RDP ledger over training rounds.

    >>> acct = RdpAccountant()
    >>> acct.step(q=10/128, noise_multiplier=1.0)   # one round
    >>> eps, order = acct.epsilon(delta=1e-5)
    """

    def __init__(self, orders: Sequence[int] = _DEFAULT_ORDERS):
        self.orders = tuple(int(a) for a in orders)
        self._rdp = [0.0] * len(self.orders)
        self.rounds = 0
        # (q, sigma) -> per-round RDP vector. A training run steps with
        # the same mechanism every round; without this cache each round
        # re-evaluates ~1e4 lgamma/exp terms on the host.
        self._per_round: dict = {}

    def step(self, q: float, noise_multiplier: float, rounds: int = 1) -> None:
        key = (float(q), float(noise_multiplier))
        vec = self._per_round.get(key)
        if vec is None:
            vec = tuple(
                rdp_subsampled_gaussian(q, noise_multiplier, a)
                for a in self.orders
            )
            self._per_round[key] = vec
        self._rdp = [r + rounds * v for r, v in zip(self._rdp, vec)]
        self.rounds += rounds

    def epsilon(self, delta: float) -> Tuple[float, int]:
        """(epsilon, best_order) for the composed mechanism at ``delta``."""
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        best = (math.inf, self.orders[0])
        log_inv_delta = math.log(1.0 / delta)
        for a, r in zip(self.orders, self._rdp):
            eps = r + log_inv_delta / (a - 1)
            if eps < best[0]:
                best = (eps, a)
        return best
