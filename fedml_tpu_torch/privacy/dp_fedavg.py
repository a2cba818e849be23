"""DP-FedAvg — client-level differential privacy with an RDP ledger (port
of ``fedml_tpu/privacy/dp_fedavg.py``).

The recipe of McMahan et al. ("Learning Differentially Private Recurrent
Language Models"), on the round hooks the robust defenses use:

1. the round's cohort is Poisson-sampled: every client independently with
   probability q = m̂/N, from a per-round stream seeded by a secret (128
   bits of OS entropy unless ``DpConfig.sample_secret`` is given), never
   by the public ``config.seed``: amplification by subsampling needs the
   adversary not to know who took part. The secret rides in
   :meth:`DPFedAvgAPI.checkpoint_state`, so a resume continues the stream;
2. each client's update w_i − w_t is clipped to L2 norm S over EVERY leaf
   (the running statistics too: everything uploaded is covered);
3. the aggregate is w_t + (1/m̂)·Σ clip_S(Δ_i) with the fixed denominator
   m̂ = ``client_num_per_round`` (the sum's sensitivity is S whatever the
   realized cohort; sample counts are an inclusion mask, never weights);
4. Gaussian noise N(0, (z·S/m̂)²) goes on every coordinate;
5. the RDP accountant (privacy/accountant.py) composes the rounds; the
   executed sampler and the accounted mechanism are the same object.

The reference pads a Poisson cohort to a bucketed client axis for XLA's
static shapes; the port's sequential loop trains the realized cohort as it
is (a padded row would be an all-padding no-op the aggregate leaves out).
An empty cohort is a legal round: one all-padding client, and the model
moves by noise alone."""

from __future__ import annotations

import dataclasses
import secrets
import warnings

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, make_fedavg_round
from fedml_tpu_torch.data.base import ClientBatch, bucket_steps, size_class
from fedml_tpu_torch.privacy.accountant import RdpAccountant

# the domain tag of the participation stream's SeedSequence ("DP_S")
_DP_SAMPLE_TAG = 0x44505F53


def poisson_client_sampling(
    run_seed: int, round_idx: int, client_num_in_total: int, q: float
) -> np.ndarray:
    """One Poisson cohort: every client independently with probability
    ``q``, from a per-round stream of ``run_seed`` (the API's secret)."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling probability q must be in (0, 1], got {q}")
    rng = np.random.default_rng(
        np.random.SeedSequence((int(run_seed), _DP_SAMPLE_TAG, int(round_idx)))
    )
    return np.flatnonzero(rng.random(client_num_in_total) < q)


def bucket_cohort(m: int) -> int:
    """The reference's static client axis for a Poisson cohort of ``m``
    (data/base.size_class): it splits the round's client keys over this
    many slots."""
    return size_class(max(int(m), 1))


@dataclasses.dataclass(frozen=True)
class DpConfig:
    """Client-level DP-FedAvg knobs."""

    clip_norm: float = 1.0  # S: per-client update L2 bound
    noise_multiplier: float = 1.0  # z: noise stddev in units of S (on the sum)
    delta: float = 1e-5  # the delta at which epsilon is reported
    # the secret of the participation stream: None draws 128 bits of OS
    # entropy; an explicit value is for tests and reproduction (under 64
    # bits warns that the amplification does not hold)
    sample_secret: int | None = None


def fresh_sample_secret() -> int:
    """128 bits of OS entropy for the participation stream."""
    return secrets.randbits(128)


def _secret_to_words(secret: int, n_words: int = 8) -> np.ndarray:
    """Secret → uint32 words, little-endian (the checkpoint's encoding)."""
    if secret.bit_length() > 32 * n_words:
        raise ValueError(f"secret exceeds {32 * n_words} bits")
    return np.asarray([(secret >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)], np.uint32)


def _words_to_secret(words) -> int:
    """Inverse of :func:`_secret_to_words`, by the array's own word width."""
    words = np.asarray(words)
    bits = words.dtype.itemsize * 8
    return sum(int(w) << (bits * i) for i, w in enumerate(words.tolist()))


def clip_update_tree(local_tree, global_tree, clip_norm: float):
    """w_t + clip_S(w_l − w_t), the L2 norm over EVERY leaf of the update."""
    sq = sum(
        torch.sum(torch.square((local_tree[k] - global_tree[k]).float())) for k in local_tree
    )
    scale = torch.clamp(clip_norm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
    return {
        k: (global_tree[k] + (leaf - global_tree[k]) * scale).to(leaf.dtype)
        for k, leaf in local_tree.items()
    }


def make_dp_hooks(dp: DpConfig, expected_cohort: int):
    """(post_train, aggregate_fn, post_aggregate) of the DP round: clip
    each client's update, the fixed-denominator mean of the included
    (``num_samples > 0``) clients' clipped updates, then noise of stddev
    z·S/m̂ on every leaf. The round's extra argument is its noise draw."""

    def post_train(client_vars, global_vars, noise_draw):
        return torch.func.vmap(lambda cv: clip_update_tree(cv, global_vars, dp.clip_norm))(client_vars)

    def aggregate_fn(client_vars, num_samples, g):
        incl = (num_samples > 0).float()

        def mean_delta(s, gl):
            base = gl.float()
            return base + torch.tensordot(incl, s.float() - base[None], dims=1) / float(expected_cohort)

        return {k: mean_delta(s, g[k]) for k, s in client_vars.items()}

    stddev = dp.noise_multiplier * dp.clip_norm / expected_cohort

    def post_aggregate(new_global, noise_draw):
        names = list(new_global)
        noise = noise_draw(names, [tuple(new_global[k].shape) for k in names])
        return {k: new_global[k] + z.to(new_global[k].device) * stddev for k, z in zip(names, noise)}

    return post_train, aggregate_fn, post_aggregate


class DPFedAvgAPI(FedAvgAPI):
    """FedAvg simulator with client-level DP and per-round accounting.
    ``client_num_per_round`` is the EXPECTED cohort size m̂: cohorts are
    Poisson(q = m̂/N) draws (:func:`poisson_client_sampling`).

    The reference splits a round's client keys over ``bucket_cohort(m)``
    slots; a ``perm_fn`` that reproduces its shuffles must split the same
    way."""

    def __init__(self, config, data, model, dp: DpConfig = DpConfig(), **kw):
        self.dp = dp
        super().__init__(config, data, model, **kw)
        if dp.sample_secret is None:
            self._sample_secret = fresh_sample_secret()
            self._secret_provenance = "128-bit OS entropy"
        else:
            self._sample_secret = int(dp.sample_secret)
            if self._sample_secret < 0:
                raise ValueError(
                    "DpConfig.sample_secret must be a non-negative integer "
                    f"(got {self._sample_secret}); SeedSequence rejects negative entropy"
                )
            if self._sample_secret.bit_length() > 256:
                # checkpoint_state keeps the secret in 8 uint32 words
                raise ValueError(
                    "DpConfig.sample_secret wider than 256 bits cannot be checkpointed; "
                    "128 bits is already full strength"
                )
            self._secret_provenance = (
                f"explicit DpConfig.sample_secret ({self._sample_secret.bit_length()} bits — "
                "amplification holds only if this value is secret and high-entropy)"
            )
            if self._sample_secret.bit_length() < 64:
                warnings.warn(
                    "DpConfig.sample_secret has <64 bits of entropy: the Poisson cohorts are "
                    "predictable and the reported epsilon's amplification-by-subsampling does "
                    "not hold. Use this only for tests/reproduction.",
                    stacklevel=2,
                )
        self.accountant = RdpAccountant()
        # q from the population actually sampled: the accounted q is the
        # executed one
        self._q = config.fed.client_num_per_round / data.num_clients
        if not 0.0 < self._q <= 1.0:
            raise ValueError(
                f"fed.client_num_per_round={config.fed.client_num_per_round} with "
                f"{data.num_clients} clients gives DP sampling probability q={self._q:.4g}; "
                "need 0 < q <= 1"
            )

    def _sample_clients(self, round_idx: int) -> np.ndarray:
        return poisson_client_sampling(self._sample_secret, round_idx, self.data.num_clients, self._q)

    def _round_batch(self, sampled, round_idx: int):
        if len(sampled):
            return super()._round_batch(sampled, round_idx)
        # an empty cohort: one all-padding client at the shape class of one
        # notional sample; its local train is a no-op the aggregate leaves
        # out, so the model moves by the noise alone
        cfg = self.config
        steps, bs, _ = bucket_steps([1], cfg.data.batch_size, cfg.data.pad_bucket)
        x0, y0 = self.data.client_x[0], self.data.client_y[0]
        return ClientBatch(
            x=np.zeros((1, steps, bs) + x0.shape[1:], x0.dtype),
            y=np.zeros((1, steps, bs) + y0.shape[1:], y0.dtype),
            mask=np.zeros((1, steps, bs), np.float32),
            num_samples=np.zeros((1,), np.float32),
        )

    def _build_round_fn(self, local_train_fn):
        post_train, aggregate_fn, post_aggregate = make_dp_hooks(
            self.dp, self.config.fed.client_num_per_round
        )
        return make_fedavg_round(
            self.model, self.config, task=self.task, local_train_fn=local_train_fn,
            post_train=post_train, aggregate_fn=aggregate_fn, post_aggregate=post_aggregate,
        )

    def _place_batch(self, batch, round_idx: int):
        return super()._place_batch(batch, round_idx) + (self._noise_draw(round_idx),)

    def train_round(self, round_idx: int):
        out = super().train_round(round_idx)
        self.accountant.step(self._q, self.dp.noise_multiplier)
        return out

    def checkpoint_state(self):
        """The ledger and the participation secret (as 8 uint32 words): a
        resume without them would under-claim the privacy spent and fork
        the participation stream. A checkpoint holding the secret reveals
        every cohort, so it is itself a secret."""
        return {
            "dp_rdp": np.asarray(self.accountant._rdp, np.float64),
            "dp_rounds": np.asarray(self.accountant.rounds, np.int64),
            "dp_sample_secret": _secret_to_words(self._sample_secret),
        }

    def restore_state(self, tree):
        self.accountant._rdp = [float(v) for v in np.asarray(tree["dp_rdp"])]
        self.accountant.rounds = int(np.asarray(tree["dp_rounds"]))
        if "dp_sample_secret" in tree:
            self._sample_secret = _words_to_secret(tree["dp_sample_secret"])
        else:
            warnings.warn(
                "checkpoint predates dp_sample_secret: it was written by a build whose "
                "cohorts derived from the public config.seed (amplification-by-subsampling "
                "did not hold for those rounds). The participation stream forks here — "
                "continuing with this API's constructed secret (fresh OS entropy unless "
                "DpConfig.sample_secret was set); the ledger's epsilon is honest only from "
                "this round on.",
                stacklevel=2,
            )
            self._secret_provenance += (
                " (resumed from a pre-secret checkpoint: earlier cohorts derived from the "
                "public config.seed)"
            )

    def privacy_spent(self):
        eps, order = self.accountant.epsilon(self.dp.delta)
        return {
            "DP/epsilon": round(float(eps), 4),
            "DP/delta": self.dp.delta,
            "DP/rdp_order": order,
            "DP/rounds_accounted": self.accountant.rounds,
            "DP/sampling_note": (
                f"Poisson-sampled cohorts executed at q={self._q:.4g} — the accounted "
                "mechanism and the run sampler are the same object; participation stream "
                f"seeded from {self._secret_provenance} (epsilon assumes the seed stays secret)"
            ),
        }

    def train(self):
        final = dict(super().train() or {})
        spent = self.privacy_spent()
        final.update(spent)
        self.log_fn(spent)
        return final
