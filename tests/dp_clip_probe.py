"""Does DP-FedAvg on the FEMNIST north star diverge at a given update clip S
in the reference as it does in the port? A CPU probe, not a test.

The north star of ``chip_smoke.py`` (``femnist_synthetic(128)``, the 62-class
CNN at full width, 10 clients a round by Poisson sampling, batch 20, E = 1,
SGD lr 0.1, seed 0) runs DP-FedAvg at z = 1, δ = 1e-5 and an explicit
secret through ``fedml_tpu`` and through ``fedml_tpu_torch``, both on the
CPU, from the reference's init, with the reference's shuffles and noise
(``torch_parity``). For each clip it prints one JSON line: each package's
train loss a round, the realized cohort sizes, and the largest parameter
difference after the last round when both are finite.

    JAX_PLATFORMS=cpu python tests/dp_clip_probe.py --clips 1.0 0.1 --rounds 3
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

SECRET = (1 << 100) + 12345  # chip_smoke.py's DP_SECRET
NUM_CLIENTS, PER_ROUND, SEED = 128, 10, 0


def _config(cfg_mod, rounds):
    return cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=20),
        fed=cfg_mod.FedConfig(client_num_in_total=NUM_CLIENTS, client_num_per_round=PER_ROUND,
                              comm_round=rounds, epochs=1),
        train=cfg_mod.TrainConfig(lr=0.1),
        model="cnn",
        seed=SEED,
    )


def probe(clip: float, rounds: int) -> dict:
    import jax

    import fedml_tpu.config as jcfg
    from fedml_tpu.data.femnist_synth import femnist_synthetic as jax_femnist
    from fedml_tpu.models import create_model as jax_create_model
    from fedml_tpu.privacy import DpConfig as JaxDp
    from fedml_tpu.privacy import DPFedAvgAPI as JaxDPFedAvg

    import fedml_tpu_torch.config as tcfg
    from fedml_tpu_torch.bridge import to_flax
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.privacy import DpConfig, DPFedAvgAPI
    from fedml_tpu_torch.privacy import dp_fedavg as tdp
    from torch_parity import flat_params, jax_noise_fn, jax_round_perm_fn, share_init

    dp = dict(clip_norm=clip, noise_multiplier=1.0, delta=1e-5, sample_secret=SECRET)
    q = PER_ROUND / NUM_CLIENTS
    perm_fn = jax_round_perm_fn(SEED, lambda r: tdp.bucket_cohort(
        len(tdp.poisson_client_sampling(SECRET, r, NUM_CLIENTS, q))))
    jrows, trows = [], []
    japi = JaxDPFedAvg(_config(jcfg, rounds), jax_femnist(num_clients=NUM_CLIENTS, seed=SEED),
                       jax_create_model("cnn", "femnist", (28, 28, 1), 62), dp=JaxDp(**dp),
                       log_fn=jrows.append)
    tapi = DPFedAvgAPI(_config(tcfg, rounds), femnist_synthetic(num_clients=NUM_CLIENTS, seed=SEED),
                       create_model("cnn", "femnist", (28, 28, 1), 62), dp=DpConfig(**dp),
                       device="cpu", log_fn=trows.append, perm_fn=perm_fn,
                       noise_fn=jax_noise_fn(SEED))
    share_init(japi, tapi)
    japi.train()
    tapi.train()
    loss = lambda rows: [r["Train/Loss"] for r in rows if "Train/Loss" in r]  # noqa: E731
    out = {
        "clip": clip, "noise_multiplier": 1.0, "m_hat": PER_ROUND, "rounds": rounds,
        "noise_std_a_coordinate": clip / PER_ROUND,
        "cohorts": [len(tapi._round_plan(r)) for r in range(rounds)],
        "reference_train_loss": loss(jrows), "port_train_loss": loss(trows),
    }
    got = flat_params(to_flax(tapi.global_vars))
    want = flat_params(jax.device_get(japi.global_vars)["params"])
    finite = all(np.isfinite(v).all() for v in list(got.values()) + list(want.values()))
    out["params_finite"] = {"reference": bool(all(np.isfinite(v).all() for v in want.values())),
                            "port": bool(all(np.isfinite(v).all() for v in got.values()))}
    out["max_abs_param_diff"] = (max(float(np.abs(got[k] - want[k]).max()) for k in want)
                                 if finite else None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=float, nargs="+", default=[1.0, 0.1])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    for clip in args.clips:
        print(json.dumps(probe(clip, args.rounds)), flush=True)


if __name__ == "__main__":
    main()
