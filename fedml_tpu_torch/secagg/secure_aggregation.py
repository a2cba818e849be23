"""Secure aggregation protocol (the transport's part of
``fedml_tpu/secagg/secure_aggregation.py``; numpy and the stdlib only; the
reference's seed-derived ``SecureAggregator`` simulation and its
``round_aggregator``/``mask_round_update``/``unmask_round_average``
helpers, which no ported caller reaches, wait in ROADMAP.md):
pairwise-masked sums with DH-agreed seeds —
the TurboAggregate capability (ref fedml_api/distributed/turboaggregate/
TA_decentralized_worker.py + mpc_function.py) as a complete, testable
protocol: in the aggregation path the server only ever combines masked
uploads, so the protocol *structure* reveals only the sum of client updates.

Key agreement runs in the RFC 3526 2048-bit MODP group with 256-bit
``secrets``-sourced exponents, and pair masks are expanded from the shared
secret by SHA-256 extract + SHAKE-256 XOF into the aggregation field
(mpc.dh_secret/dh_shared/derive_pair_mask) — ≥128-bit secret space, no
brute-forceable parameter anywhere (the reference's my_key_agreement runs
DH in its toy field, mpc_function.py:271). The 31-bit Mersenne FIELD is
kept for exact int64 share arithmetic; field size is about arithmetic
range, not secrecy. HONESTY NOTE — the protocol assumes an
honest-but-curious server and non-colluding parties: there are no
signatures or consistency checks against a MALICIOUS server (who could
partition parties into singleton "registries"), and the BGW seed-share
round of full SecAgg (Bonawitz et al.) is elided to the pair-key registry
(the share math itself is mpc.bgw_encode/decode, tested independently).

Fixed-point encode → field; client i's upload is
``x_i + Σ_{j>i} PRG(k_ij) − Σ_{j<i} PRG(k_ij)  (mod p)``
with k_ij the DH-agreed pair key, so every mask cancels in the sum. Dropout
tolerance (the reference has none — its barrier waits forever,
FedAVGAggregator.py:43-49 / SURVEY §5) comes from BGW-sharing each client's
mask seed to the others: if a client drops after masks were applied, the
survivors reconstruct its pairwise masks from T+1 shares and the server
removes them."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from fedml_tpu_torch.core import compression as CZ
from fedml_tpu_torch.secagg import mpc
from fedml_tpu_torch.secagg.mpc import FIELD_PRIME

_SCALE = 1 << 16  # fixed-point fraction bits


def encode_fixed(x: np.ndarray, p: int = FIELD_PRIME) -> np.ndarray:
    """float → field: round(x * 2^16) mod p (two's-complement style)."""
    return np.mod(np.round(np.asarray(x, np.float64) * _SCALE).astype(np.int64), p)


def decode_fixed(v: np.ndarray, n_summed: int, p: int = FIELD_PRIME) -> np.ndarray:
    """field → float, recentring values above p/2 as negatives."""
    v = np.asarray(v, np.int64)
    half = p // 2
    signed = np.where(v > half, v - p, v)
    return signed.astype(np.float64) / _SCALE


# ---- round-loop integration (transport FedAvg, CommConfig.secure_agg) ----
# The reference's turboaggregate is a DISTRIBUTED algorithm (MPI workers,
# TA_decentralized_worker.py); these helpers put the masked-sum protocol on
# this framework's transport round: each sampled client is a party for ONE
# round, uploads encode(n_i · Δ_i) masked pairwise, and the server
# reconstructs only the weighted SUM. Party registries are re-derived per
# round from (seed, round_idx) so pair masks are never reused across rounds
# (mask reuse would leak update differences).


def flatten_tree(tree):
    """tree of arrays -> (flat float64 [D], spec for :func:`unflatten_like`),
    leaves in ``jax.tree_util``'s order (core/compression.py): a reference
    peer's flattening, so the two packages' masks cancel against each other.
    Each leaf keeps its dtype through the float64 field math."""
    leaves, structure = CZ.tree_flatten(tree)
    leaves = [np.asarray(l) for l in leaves]
    flat = np.concatenate([l.reshape(-1).astype(np.float64) for l in leaves])
    return flat, (structure, [(l.shape, l.dtype) for l in leaves])


def tree_dim(tree) -> int:
    """Total flattened element count — the ONE definition both wire ends
    use to size the per-round mask registry."""
    return int(sum(np.asarray(l).size for l in CZ.tree_leaves(tree)))


def unflatten_like(spec, flat: np.ndarray):
    structure, meta = spec
    out, off = [], 0
    for shape, dtype in meta:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append(flat[off : off + n].reshape(shape).astype(dtype))
        off += n
    return CZ.tree_unflatten(structure, out)


def _field_bound_check(update: np.ndarray, p: int, n_parties: int) -> None:
    """The fixed-point field has finite range: |value| must stay below
    (p/2)/2^16/N ≈ 16383/N so even the SUM over N parties cannot wrap.
    Exceeding it would silently corrupt the aggregate (mod-p wraparound),
    so it raises instead — rescale (smaller lr, fewer samples per upload)
    or use the plain path for such magnitudes."""
    bound = (p // 2) / _SCALE / max(n_parties, 1)
    worst = float(np.max(np.abs(update))) if update.size else 0.0
    if worst >= bound:
        raise ValueError(
            f"secure-agg update magnitude {worst:.1f} exceeds the fixed-"
            f"point field bound {bound:.1f} (p=2^31, 2^16 fraction bits, "
            f"{n_parties} parties) — the masked sum would wrap mod p"
        )


class ClientParty:
    """One round-party with a LOCALLY generated DH keypair.

    A secret key derived from a shared seed would let the server recompute
    every client's masks, and the protocol structure would hide nothing.
    Here the secret key is
    drawn from client-local entropy (``secrets`` OS entropy when ``rng``
    is None) and NEVER leaves this object; only the 2048-bit-group public
    key goes on the wire (contrast ref turboaggregate my_key_agreement,
    mpc_function.py:271, toy-field DH). Fresh party = fresh keys each
    round, so masks are never reused across rounds."""

    def __init__(self, party: int, dim: int, p: int = FIELD_PRIME, rng=None):
        self.party = party
        self.dim = dim
        self.p = p
        self._sk = mpc.dh_secret(rng)
        self.pk = mpc.dh_public(self._sk)
        self._pair_keys: Dict[int, int] = {}
        self.active: List[int] = []

    def set_registry(self, pks: Dict[int, int]) -> None:
        """Learn the other parties' public keys (broadcast by the server —
        public material only) and agree pairwise keys with OWN secret."""
        self.active = sorted(int(j) for j in pks)
        self._pair_keys = {
            int(j): mpc.dh_shared(self._sk, int(pk))
            for j, pk in pks.items()
            if int(j) != self.party
        }

    def _mask(self, j: int) -> np.ndarray:
        lo, hi = min(self.party, j), max(self.party, j)
        return mpc.derive_pair_mask(self._pair_keys[j], lo, hi, self.dim, self.p)

    def masked_update(self, w_local, w_round, n_samples: float) -> np.ndarray:
        """Masked field vector of n_i · (w_i − w_round), masks vs every
        OTHER registry party (cancel in the sum of active uploads)."""
        flat_local, _ = flatten_tree(w_local)
        flat_round, _ = flatten_tree(w_round)
        update = float(n_samples) * (flat_local - flat_round)
        _field_bound_check(update, self.p, len(self.active))
        v = encode_fixed(update, self.p)
        for j in self.active:
            if j == self.party:
                continue
            m = self._mask(j)
            v = np.mod(v + (m if self.party < j else -m), self.p)
        return v

    def recovery_mask(self, dropped: Sequence[int]) -> np.ndarray:
        """Survivor's unmasking contribution for parties that dropped after
        keys were agreed but before uploading: Σ_d ±PRG(k_{self,d}) with
        the sign THIS party applied in its own upload. (Stand-in for the
        BGW seed-share reconstruction round of the full protocol —
        mpc.bgw_encode/decode hold the share math.)"""
        total = np.zeros(self.dim, np.int64)
        for d in dropped:
            m = self._mask(int(d))
            total = np.mod(total + (m if self.party < int(d) else -m), self.p)
        return total


class ServerAggregator:
    """Server side of the client-held-key protocol: holds ONLY public
    material (the pk registry it relayed) and masked vectors — at no point
    does any party secret enter this object, so everything the server
    observes is the masked uploads plus their sum."""

    def __init__(self, dim: int, p: int = FIELD_PRIME):
        self.dim = dim
        self.p = p

    def masked_sum(self, uploads: Dict[int, np.ndarray]) -> np.ndarray:
        total = np.zeros(self.dim, np.int64)
        for i in sorted(uploads):
            total = np.mod(total + uploads[i], self.p)
        return total

    def remove_dropout_masks(
        self, total: np.ndarray, recovery: Dict[int, np.ndarray]
    ) -> np.ndarray:
        """Subtract the survivors' recovery contributions (each survivor
        reports the masks it shared with the dropped parties)."""
        for i in sorted(recovery):
            total = np.mod(total - recovery[i], self.p)
        return total

    def decode_average(self, total: np.ndarray, ns: Dict[int, float], w_round):
        """Σ_received n_i·Δ_i / Σ_received n_i applied to w_round."""
        decoded = decode_fixed(total, len(ns), self.p)
        total_n = float(sum(ns.values()))
        flat_round, spec = flatten_tree(w_round)
        return unflatten_like(spec, flat_round + decoded / max(total_n, 1e-9))
