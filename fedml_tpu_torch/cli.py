"""The single-run command line (port of ``fedml_tpu/cli.py``):
``python -m fedml_tpu_torch --algorithm ... --runtime ...``.

The parser (argparse; the reference's is a ``click`` command) knows every
option of the reference's ``main`` under the same name, default, type and
choices, and the same invocation trains the same way:

- ``--runtime vmap`` (the port's sequential simulator; the flag keeps the
  reference's name) with ``fedavg``, ``fedprox``, ``fedopt``, ``fednova``,
  ``qfedavg`` (``--qffl_q``), ``hierarchical`` (``--group_num``,
  ``--group_comm_round``), ``scaffold`` and ``ditto`` (``--ditto_lambda``;
  both keep per-client state on the card, in the mmap spill tier or in
  the sharded record-major tier, ``--state_store``, ``--state_dir``), ``dp_fedavg`` and ``fedavg_robust`` (``median`` and
  ``trimmed_mean`` on kernel K1, ``krum``, ``multi_krum``,
  ``norm_diff_clipping``, ``weak_dp``, ``no_defense``; ``--attack
  backdoor`` adds the boosted attackers and ``Backdoor/ASR``), with the
  ``uniform``, ``weighted`` and ``power_of_choice`` policies,
  ``--overprovision_factor``, fault plans and ``--eval_on_clients``;
- ``centralized`` (the pooled data, ``--comm_round`` epochs),
  ``decentralized`` (DSGD or push-sum, ``--variant``, over the clients'
  streams) and the model-bound algorithms ``fedseg`` (with
  ``--checkpoint_path``, its best-mIoU model), ``fedgkt``, ``fedgan`` and
  ``fednas`` (``--variant first|second``, the architect), which run loops
  of their own;
- ``--runtime loopback|shm|mqtt`` with ``fedavg``, ``fedprox`` and
  ``fedopt`` through ``run_*_federation``, with deadlines and quorum, fault
  plans, overprovisioning, codecs, secure aggregation and send retries;
  and with ``fedbuff``, the async buffered federation
  (``--async_buffer_k``, ``--staleness_exp``, ``--async_server_lr``),
  through ``run_fedbuff_*``, whose final row is its last server step.

Every policy of the reference runs, ``straggler_aware`` included: it reads
the client health registry the simulator and every federation build.

The rows go to ``--log_dir`` (``metrics.jsonl``, ``summary.json``), and the
last line printed is the final row as JSON. ``--checkpoint_path`` writes a
checkpoint on every row with ``Test/Acc`` and at the end, in the
reference's format (utils/checkpoint.py), and ``--resume`` continues from
one written by either package (DP-FedAvg's ledger and participation
secret in its ``algo`` slot).

The reference's usage errors are usage errors here (exit code 2). An
option whose feature is not ported is accepted at its default and raises
NotImplementedError naming its ROADMAP.md item when set otherwise, and so
do the other algorithms and runtimes. ``--pipeline`` is accepted with every
value and the rounds run serially — the reference documents its pipeline
as byte-identical to serial — so the port logs no ``fed/pipeline_rounds``;
it logs no ``compile/*`` row either (ROADMAP.md §1 item 4).

The command has no device flag, as the reference has none: it runs on the
card, and exits non-zero without one. :func:`main` and :func:`run` take a
``device`` keyword that no flag exposes (the tests pass ``"cpu"``)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from fedml_tpu_torch.config import (
    AdminConfig,
    CommConfig,
    CompileConfig,
    DataConfig,
    FedConfig,
    MeshConfig,
    RunConfig,
    ServerConfig,
    TrainConfig,
)
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.robustness.robust_aggregation import BYZANTINE_AGGREGATORS, CLIP_DEFENSES

ALGORITHMS = (
    "centralized",
    "fedavg",
    "fedopt",
    "fedprox",
    "fednova",
    "scaffold",
    "fedbuff",
    "ditto",
    "dp_fedavg",
    "qfedavg",
    "hierarchical",
    "fedavg_robust",
    "fedgkt",
    "fedgan",
    "fedseg",
    "fednas",
    "split_nn",
    "vertical_fl",
    "decentralized",
    "secagg",
)
RUNTIMES = ("vmap", "mesh", "loopback", "mqtt", "shm", "grpc")
TRANSPORTS = ("loopback", "mqtt", "shm")

# the reference's algorithms that run training loops of their own, outside the
# FedAvg family
_LONGTAIL = (
    "centralized", "fedgkt", "fedgan", "fedseg", "fednas", "split_nn", "vertical_fl",
    "decentralized", "secagg",
)
_VARIANTS = {"decentralized": ("dsgd", "pushsum"), "fednas": ("first", "second")}


class UsageError(Exception):
    """A refused combination of options; :func:`main` exits with code 2."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch",
        description="Train a federated model on the GPU (the port of python -m fedml_tpu).",
    )
    a = p.add_argument

    def flag(name, help):
        a(name, action="store_true", default=False, help=help)

    a("--model", default="lr", help="model name (models/registry.py)")
    a("--dataset", dest="dataset_name", default="synthetic", help="dataset name (data/registry.py)")
    a("--data_dir", type=Path, default=Path("./data"))
    a("--partition_method", choices=("hetero", "homo", "hetero-fix"), default="hetero")
    a("--partition_alpha", type=float, default=0.5)
    a("--client_num_in_total", type=int, default=10)
    a("--client_num_per_round", type=int, default=10)
    a("--batch_size", type=int, default=32, help="-1 = full batch")
    a("--pad_bucket", type=int, default=1,
      help="round per-client step counts up to multiples of this")
    a("--client_optimizer", choices=("sgd", "adam"), default="sgd")
    a("--lr", type=float, default=0.03)
    a("--wd", type=float, default=0.0)
    a("--momentum", type=float, default=0.0)
    a("--epochs", type=int, default=1)
    a("--comm_round", type=int, default=10)
    a("--frequency_of_the_test", type=int, default=1)
    flag("--eval_on_clients", "eval on every client's local shards (the reference's "
         "_local_test_on_all_clients) instead of the central test set")
    a("--algorithm", choices=ALGORITHMS, default="fedavg")
    a("--runtime", choices=RUNTIMES, default="vmap")
    a("--client_shards", type=int, default=None, help="mesh shards (runtime=mesh)")
    a("--server_optimizer", default="sgd", help="FedOpt server optimizer")
    a("--server_lr", type=float, default=1.0)
    a("--server_momentum", type=float, default=0.0)
    a("--prox_mu", type=float, default=0.01, help="FedProx proximal term (algorithm=fedprox)")
    a("--defense", choices=CLIP_DEFENSES + BYZANTINE_AGGREGATORS, default="norm_diff_clipping",
      help="fedavg_robust: clip/noise or Byzantine aggregator")
    a("--norm_bound", type=float, default=5.0,
      help="norm_diff_clipping/weak_dp: clip ||w_i - w_g|| to this")
    a("--noise_stddev", type=float, default=0.025,
      help="weak_dp: Gaussian noise stddev after averaging")
    a("--num_byzantine", type=int, default=1,
      help="assumed Byzantine client count (trimmed_mean trim-k, krum f)")
    a("--multi_krum_m", type=int, default=3, help="multi_krum: average the m best-scored clients")
    a("--attack", choices=("none", "backdoor"), default="none",
      help="fedavg_robust: simulate attackers (poisoned shards + boosted uploads) and report "
           "Backdoor/ASR")
    a("--num_attackers", type=int, default=1, help="attack=backdoor: clients 0..k-1 are attackers")
    a("--attack_boost", type=float, default=10.0,
      help="model-replacement boost γ on attacker uploads")
    a("--poison_frac", type=float, default=0.5,
      help="fraction of each attacker shard triggered+relabeled")
    a("--target_label", type=int, default=0, help="backdoor target class")
    a("--group_num", type=int, default=2, help="hierarchical: number of groups")
    a("--group_comm_round", type=int, default=1)
    a("--compute_dtype", choices=("float32", "bfloat16"), default="float32",
      help="forward/backward dtype; params stay float32")
    a("--augment", choices=("none", "cifar", "crop_flip"), default="none")
    a("--variant", default=None)
    a("--seed", type=int, default=0)
    a("--log_dir", type=Path, default=None)
    a("--checkpoint_path", type=Path, default=None,
      help="save a checkpoint here on every test round and at the end")
    flag("--resume", "restore from --checkpoint_path and continue from its round")
    a("--profile_dir", type=Path, default=None,
      help="write a torch.profiler trace of the run here")
    a("--telemetry_dir", type=Path, default=None)
    a("--prom_port", type=int, default=None)
    flag("--no_device_cache", "stack the rounds on the host instead of the device store")
    a("--fused_rounds", type=int, default=1)
    a("--fused_plan", choices=("static", "measured"), default="static")
    a("--pipeline", choices=("off", "auto", "on"), default="auto",
      help="accepted; the port runs the rounds serially")
    a("--client_parallelism", choices=("auto", "vmap", "scan"), default="auto")
    a("--state_store", choices=("auto", "device", "mmap", "sharded"), default="auto")
    a("--state_budget_bytes", type=int, default=8 << 30)
    a("--state_dir", type=str, default="")
    a("--straggle_ms", type=float, default=0.0)
    a("--qffl_q", type=float, default=1.0)
    a("--dp_clip", type=float, default=1.0,
      help="algorithm=dp_fedavg: per-client update L2 clip S")
    a("--dp_noise_multiplier", type=float, default=1.0,
      help="algorithm=dp_fedavg: noise multiplier z (stddev z*S on the clipped-update sum)")
    a("--dp_delta", type=float, default=1e-5,
      help="algorithm=dp_fedavg: report epsilon at this delta")
    a("--ditto_lambda", type=float, default=0.1)
    a("--async_buffer_k", type=int, default=10)
    a("--staleness_exp", type=float, default=0.5)
    a("--async_server_lr", type=float, default=1.0)
    flag("--enable_wandb", "mirror the rows to wandb when it is importable")
    a("--selection", choices=("uniform", "weighted", "power_of_choice", "straggler_aware"),
      default="uniform", help="client selection policy (scheduler/policies.py)")
    a("--overprovision_factor", type=float, default=1.0,
      help="select ceil(k * factor) clients a round so deadline/quorum rounds still close "
           "with ~k useful uploads; transport runtimes spawn one worker per slot (1.0 = off)")
    a("--fault_plan", type=str, default=None,
      help="fault-injection plan: inline JSON or a path to a JSON file")
    a("--send_retries", type=int, default=0)
    a("--send_backoff_s", type=float, default=0.05)
    a("--send_timeout_s", type=float, default=30.0)
    a("--send_fault_p", type=float, default=0.0)
    a("--deadline_s", type=float, default=0.0, help="transport runtimes: straggler deadline")
    a("--min_clients", type=int, default=1, help="minimum uploads to close a deadline round")
    a("--compression", choices=("none", "int8", "int4", "topk", "topk8"), default="none")
    a("--downlink_compression", choices=("none", "int8"), default="none")
    a("--topk_frac", type=float, default=0.01)
    flag("--error_feedback", "residual memory for the lossy codecs")
    flag("--secure_agg", "transport runtimes: pairwise-masked uploads")
    a("--beacons", dest="beacons", action="store_true", default=True,
      help="transport runtimes: piggyback a client telemetry beacon on each upload")
    a("--no_beacons", dest="beacons", action="store_false")
    flag("--warmup", "AOT warmup (not ported: ROADMAP.md §1 item 4)")
    a("--compile_cache_dir", type=Path, default=None)
    a("--executable_cache", type=Path, default=None)
    a("--compile_cache_min_s", type=float, default=2.0)
    a("--recompile_budget", type=int, default=None)
    a("--device_slice", type=int, default=-1, help="serve layer only; single runs ignore it")
    a("--admit_min_headroom_mb", type=float, default=0.0, help="serve layer only")
    a("--admit_cost_cap_gflops", type=float, default=0.0, help="serve layer only")
    a("--rank", type=int, default=None, help="runtime=grpc: this process's rank")
    a("--ip_config", type=Path, default=None)
    a("--base_port", type=int, default=8890)
    flag("--ci", "CI short-circuit (1 round)")
    return p


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run. A usage error
    exits with code 2; no card (with ``device=None``) exits with code 1."""
    parser = build_parser()
    opt = vars(parser.parse_args(argv))
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        parser.exit(1, f"{parser.prog}: error: {e}\n")
    try:
        return run(device=dev, **opt)
    except UsageError as e:
        parser.error(str(e))


def _checked_buffer_k(opt) -> int:
    """fedbuff's buffer size, validated at parse time; 0 for every
    synchronous algorithm."""
    if opt["algorithm"] != "fedbuff":
        return 0
    k = opt["async_buffer_k"]
    if k <= 0:
        raise UsageError("--algorithm fedbuff needs --async_buffer_k > 0")
    return k


def build_config(opt) -> RunConfig:
    return RunConfig(
        data=DataConfig(
            dataset=opt["dataset_name"],
            data_dir=str(opt["data_dir"]),
            partition_method=opt["partition_method"],
            partition_alpha=opt["partition_alpha"],
            batch_size=opt["batch_size"],
            pad_bucket=opt["pad_bucket"],
            device_cache=not opt["no_device_cache"],
        ),
        fed=FedConfig(
            client_num_in_total=opt["client_num_in_total"],
            client_num_per_round=opt["client_num_per_round"],
            comm_round=1 if opt["ci"] else opt["comm_round"],
            epochs=opt["epochs"],
            frequency_of_the_test=opt["frequency_of_the_test"],
            ci=opt["ci"],
            group_num=opt["group_num"],
            group_comm_round=opt["group_comm_round"],
            fused_rounds=opt["fused_rounds"],
            fused_plan=opt["fused_plan"],
            eval_on_clients=opt["eval_on_clients"],
            deadline_s=opt["deadline_s"],
            min_clients=opt["min_clients"],
            selection=opt["selection"],
            overprovision_factor=opt["overprovision_factor"],
            fault_plan=opt["fault_plan"] or "",
            client_parallelism=opt["client_parallelism"],
            async_buffer_k=_checked_buffer_k(opt),
            async_staleness_exp=opt["staleness_exp"],
            async_server_lr=opt["async_server_lr"],
            state_store=opt["state_store"],
            state_budget_bytes=opt["state_budget_bytes"],
            state_dir=opt["state_dir"],
            pipeline=opt["pipeline"],
        ),
        train=TrainConfig(
            client_optimizer=opt["client_optimizer"],
            lr=opt["lr"],
            wd=opt["wd"],
            momentum=opt["momentum"],
            prox_mu=opt["prox_mu"] if opt["algorithm"] == "fedprox" else 0.0,
            compute_dtype=opt["compute_dtype"],
            augment=opt["augment"],
        ),
        server=ServerConfig(
            server_optimizer=opt["server_optimizer"],
            server_lr=opt["server_lr"],
            server_momentum=opt["server_momentum"],
        ),
        comm=CommConfig(
            compression=opt["compression"],
            downlink_compression=opt["downlink_compression"],
            topk_frac=opt["topk_frac"],
            error_feedback=opt["error_feedback"],
            secure_agg=opt["secure_agg"],
            send_retries=opt["send_retries"] or 0,
            send_backoff_s=opt["send_backoff_s"],
            send_timeout_s=opt["send_timeout_s"],
            send_fault_p=opt["send_fault_p"] or 0.0,
            beacons=opt["beacons"],
        ),
        mesh=MeshConfig(client_shards=opt["client_shards"]),
        compile=CompileConfig(
            warmup=opt["warmup"],
            cache_dir=str(opt["compile_cache_dir"] or ""),
            min_compile_time_s=opt["compile_cache_min_s"],
            executable_cache=str(opt["executable_cache"] or ""),
            recompile_budget=opt["recompile_budget"],
        ),
        admin=AdminConfig(
            device_slice=int(opt["device_slice"] if opt["device_slice"] is not None else -1),
            admit_min_headroom_mb=float(opt["admit_min_headroom_mb"] or 0.0),
            admit_cost_cap_gflops=float(opt["admit_cost_cap_gflops"] or 0.0),
        ),
        model=opt["model"],
        seed=opt["seed"],
    )


def _dp_cfg(opt):
    """DP-FedAvg's config from the flags (None for other algorithms),
    refused before any setup when it cannot be a DP run."""
    if opt["algorithm"] != "dp_fedavg":
        return None
    from fedml_tpu_torch.privacy import DpConfig

    clip, z, delta = opt["dp_clip"], opt["dp_noise_multiplier"], opt["dp_delta"]
    # a negative clip would invert every client update (scale = clip/norm)
    if clip <= 0:
        raise UsageError("--dp_clip must be > 0")
    if z <= 0:
        raise UsageError(
            "--dp_noise_multiplier must be > 0 (no-noise runs are not DP; use --algorithm "
            "fedavg instead)"
        )
    if not 0.0 < delta < 1.0:
        raise UsageError("--dp_delta must be in (0, 1)")
    return DpConfig(clip_norm=clip, noise_multiplier=z, delta=delta)


def _validate_scheduler(config: RunConfig, opt) -> None:
    """The scheduler and fault-plan usage errors, before any setup."""
    from fedml_tpu_torch.scheduler import FaultPlan

    if config.fed.overprovision_factor < 1.0:
        raise UsageError("--overprovision_factor must be >= 1.0")
    try:
        plan = FaultPlan.from_config(config)
    except ValueError as e:
        raise UsageError(f"--fault_plan: {e}")
    engaged = (
        config.fed.selection != "uniform" or config.fed.overprovision_factor != 1.0
        or plan is not None
    )
    if engaged and opt["algorithm"] == "dp_fedavg":
        raise UsageError(
            "--selection/--overprovision_factor/--fault_plan cannot be combined with "
            "algorithm=dp_fedavg: its cohort is the run-seeded secret Poisson draw (privacy "
            "amplification by subsampling), which bypasses the scheduler — the flags would be "
            "silently ignored"
        )
    if engaged and opt["algorithm"] in _LONGTAIL:
        raise UsageError(
            "--selection/--overprovision_factor/--fault_plan have no effect for "
            f"algorithm={opt['algorithm']}: it draws its cohorts outside the scheduler"
        )
    if config.fed.overprovision_factor != 1.0 and config.comm.secure_agg:
        raise UsageError(
            "--overprovision_factor and --secure_agg are incompatible: clients size the mask "
            "registry from client_num_per_round"
        )
    if config.fed.overprovision_factor != 1.0 and opt["algorithm"] == "fedbuff":
        raise UsageError("--overprovision_factor is a synchronous quorum-round concept")
    if (
        plan is not None and plan.has_participation_faults()
        and opt["runtime"] in TRANSPORTS + ("grpc",) and opt["algorithm"] != "fedbuff"
        and not config.fed.deadline_s
    ):
        raise UsageError(
            "--fault_plan with dropout_p/crash_at_round on a synchronous transport requires "
            "--deadline_s: the all-received barrier would wait forever for the dropped upload"
        )


def _validate_comm(config: RunConfig, opt) -> None:
    """The transport usage errors: retries and chaos, and the flags that
    only the transport runtimes act on."""
    from fedml_tpu_torch.core.compression import EF_METHODS

    comm, fed, runtime = config.comm, config.fed, opt["runtime"]
    if not 0.0 <= comm.send_fault_p < 1.0:
        raise UsageError("--send_fault_p must be in [0, 1)")
    if comm.send_retries < 0:
        raise UsageError("--send_retries must be >= 0")
    if comm.send_fault_p > 0 and comm.send_retries < 1:
        raise UsageError(
            "--send_fault_p injects transient send failures; it needs --send_retries >= 1"
        )
    if comm.send_timeout_s <= 0:
        raise UsageError("--send_timeout_s must be > 0")
    in_sim = runtime in ("vmap", "mesh")
    if (comm.send_retries or comm.send_fault_p) and in_sim:
        raise UsageError(
            "--send_retries/--send_fault_p apply to the transport runtimes; vmap/mesh rounds "
            "exchange no messages"
        )
    if in_sim:
        if comm.compression != "none":
            raise UsageError("--compression applies to the transport runtimes (loopback/shm/grpc/mqtt)")
        if comm.downlink_compression != "none":
            raise UsageError(
                "--downlink_compression applies to the transport runtimes (loopback/shm/grpc/mqtt)"
            )
        if fed.deadline_s or fed.min_clients != 1:
            raise UsageError(
                "--deadline_s/--min_clients apply to the transport runtimes (loopback/shm/grpc/mqtt)"
            )
    elif fed.min_clients != 1 and not fed.deadline_s:
        raise UsageError(
            "--min_clients only takes effect after a --deadline_s deadline passes"
        )
    if comm.secure_agg:
        if in_sim:
            raise UsageError("--secure_agg applies to the transport runtimes (loopback/shm/grpc/mqtt)")
        if comm.compression != "none":
            raise UsageError("--secure_agg and --compression are mutually exclusive")
        if comm.downlink_compression != "none":
            raise UsageError("--secure_agg and --downlink_compression are mutually exclusive")
    if comm.error_feedback:
        if comm.compression not in EF_METHODS:
            raise UsageError(
                f"--error_feedback is a residual memory for lossy codecs; it requires "
                f"--compression in {EF_METHODS}"
            )
        if fed.deadline_s:
            raise UsageError(
                "--error_feedback assumes every upload is aggregated, but --deadline_s quorum "
                "rounds can discard late uploads"
            )
        if runtime == "grpc" and fed.client_num_per_round != fed.client_num_in_total:
            raise UsageError("--error_feedback under runtime=grpc requires full participation")


def _validate_variant(opt) -> None:
    v = opt["variant"]
    if v is None:
        return
    allowed = _VARIANTS.get(opt["algorithm"])
    if allowed is None:
        raise UsageError(f"--variant has no meaning for algorithm={opt['algorithm']}")
    if v not in allowed:
        raise UsageError(f"--variant for {opt['algorithm']} must be one of {allowed}, got {v!r}")


# option -> (its value where the feature is off, the ROADMAP.md §1 item
# that ports it)
_UNPORTED_OPTIONS = {
    "telemetry_dir": (None, 1),
    "prom_port": (None, 1),
    "straggle_ms": (0.0, 1),
    "warmup": (False, 4),
    "compile_cache_dir": (None, 4),
    "executable_cache": (None, 4),
    "recompile_budget": (None, 4),
    "fused_rounds": (1, 8),
    "fused_plan": ("static", 8),
}
_PORTED_ALGORITHMS = (
    "fedavg", "fedprox", "fedopt", "fedavg_robust", "dp_fedavg", "fednova", "scaffold", "ditto",
    "qfedavg", "hierarchical", "centralized", "decentralized", "fedbuff", "fedseg", "fedgkt",
    "fedgan", "fednas", "split_nn", "vertical_fl",
)
# the ROADMAP.md §1 item of each algorithm still to port (8 where unnamed)
_ALGORITHM_ITEMS = {"secagg": 1}


def _check_ported(opt) -> None:
    """NotImplementedError, naming the ROADMAP.md item, for what the port
    does not run yet."""
    algo, runtime = opt["algorithm"], opt["runtime"]
    if runtime == "mesh":
        raise NotImplementedError("--runtime mesh is not ported yet (ROADMAP.md §1 item 11)")
    if runtime == "grpc":
        raise NotImplementedError(
            "--runtime grpc (one process per participant) is not ported yet (ROADMAP.md §1 "
            "item 1); the port's gRPC transport runs in process"
        )
    if algo not in _PORTED_ALGORITHMS:
        item = _ALGORITHM_ITEMS.get(algo, 8)
        raise NotImplementedError(f"--algorithm {algo} is not ported yet (ROADMAP.md §1 item {item})")
    for name, (off, item) in _UNPORTED_OPTIONS.items():
        if opt[name] != off:
            flag = "--" + name
            raise NotImplementedError(
                f"{flag} {opt[name]} is not ported yet (ROADMAP.md §1 item {item}); "
                f"it is accepted only at {off!r}"
            )


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _sched_state(api):
    """The scheduler's selection memo and loss map, for the checkpoint's
    sched slot."""
    sched = getattr(api, "scheduler", None)
    return sched.state_dict() if sched is not None else None


def run(device: DeviceLike = None, **opt):
    """One run from the parsed options (``vars`` of :func:`build_parser`'s
    namespace). Returns the API (its ``global_vars``, ``history``)."""
    from fedml_tpu_torch.data import registry as data_registry
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils import MetricsLogger, save_checkpoint
    from fedml_tpu_torch.utils.metrics import wandb_init
    from fedml_tpu_torch.utils.profiling import trace

    dev = resolve_device(device)
    config = build_config(opt)
    _dp_cfg(opt)  # refused before any setup
    _validate_scheduler(config, opt)
    _validate_comm(config, opt)
    _validate_variant(opt)
    _check_ported(opt)
    runner = _LONGTAIL_RUNNERS.get(opt["algorithm"])
    if runner is not None:
        _validate_longtail(opt)
    elif opt["runtime"] in TRANSPORTS and opt["algorithm"] not in (
        "fedavg", "fedprox", "fedopt", "fedbuff",
    ):
        raise UsageError(f"runtime={opt['runtime']} supports fedavg/fedprox/fedopt/fedbuff")
    elif opt["algorithm"] == "fedbuff" and opt["runtime"] not in TRANSPORTS:
        raise UsageError(
            "algorithm=fedbuff is an async TRANSPORT protocol — run it with --runtime loopback, "
            "shm, or mqtt"
        )
    if opt["resume"] and opt["runtime"] in TRANSPORTS:
        raise UsageError(f"--resume is not supported for runtime={opt['runtime']}")

    data = data_registry.load(config)
    task = data_registry.task_for_dataset(config.data.dataset)
    sample_shape = tuple(data.client_x[0].shape[1:])
    model = create_model(config.model, config.data.dataset, sample_shape, data.num_classes)
    poison_spec, attack_cfg, data = _attack(opt, config, data)
    if opt["enable_wandb"]:
        wandb_init(
            name=f"{opt['algorithm']}-r{opt['comm_round']}-e{opt['epochs']}-lr{opt['lr']}",
            config={k: str(v) for k, v in opt.items()},
        )
    logger = MetricsLogger(
        str(opt["log_dir"]) if opt["log_dir"] else None, use_wandb=opt["enable_wandb"]
    )
    if runner is not None:
        try:
            with trace(str(opt["profile_dir"]) if opt["profile_dir"] else None):
                api, final = runner(config, data, model, task, logger.log, opt, dev)
        finally:
            logger.close()
        print(json.dumps({k: _jsonable(v) for k, v in (final or {}).items()}), flush=True)
        return api
    checkpoint_path = str(opt["checkpoint_path"]) if opt["checkpoint_path"] else None
    api_cell = []

    def checkpoint(api, round_idx: int) -> None:
        save_checkpoint(
            checkpoint_path, api.global_vars, round_idx=round_idx,
            server_opt_state=getattr(api, "server_opt_state", None),
            algo_state=getattr(api, "checkpoint_state", lambda: None)(),
            sched_state=_sched_state(api),
        )

    def log_fn(row):
        logger.log(row)
        # crash-resumable: a checkpoint on every test round; round_idx is the
        # next round to run
        if checkpoint_path and "Test/Acc" in row and api_cell:
            if getattr(api_cell[0], "global_vars", None) is not None:
                checkpoint(api_cell[0], row["round"] + 1)

    try:
        api = _build_api(opt, config, data, model, task, log_fn, dev, attack_cfg)
        api_cell.append(api)
        if opt["resume"]:
            _restore(api, opt)
        with trace(str(opt["profile_dir"]) if opt["profile_dir"] else None):
            final = api.train()
        if getattr(api, "faults", None) is not None:
            # the simulator's fault counts (a federation logs its own)
            log_fn(api.faults.summary_row())
        if poison_spec is not None:
            from fedml_tpu_torch.data.edge_cases import attack_success_rate

            final = dict(final or {})
            final["Backdoor/ASR"] = attack_success_rate(
                model, api.global_vars, data, poison_spec, eval_fn=api.eval_fn
            )
            log_fn({"round": config.fed.comm_round - 1, "Backdoor/ASR": final["Backdoor/ASR"]})
        if checkpoint_path:
            checkpoint(api, config.fed.comm_round)
    finally:
        logger.close()
    print(json.dumps({k: _jsonable(v) for k, v in (final or {}).items()}), flush=True)
    return api


def _validate_longtail(opt) -> None:
    """The reference's refusals for the algorithms that run loops of their
    own."""
    algo = opt["algorithm"]
    if opt["resume"]:
        raise UsageError(f"--resume is not supported for algorithm={algo}")
    allowed = ("vmap", "mesh") if algo == "centralized" else ("vmap",)
    if opt["runtime"] not in allowed:
        raise UsageError(f"algorithm={algo} supports only --runtime {'|'.join(allowed)}")
    if opt["checkpoint_path"] and algo != "fedseg":
        raise UsageError(
            f"--checkpoint_path is not supported for algorithm={algo} (supported: the FedAvg "
            "family and fedseg)"
        )


def _run_centralized(config, data, model, task, log_fn, opt, device):
    """The pooled-data baseline; ``--comm_round`` is the epoch count."""
    from fedml_tpu_torch.train.centralized import CentralizedTrainer

    trainer = CentralizedTrainer(config, data, model, task=task, log_fn=log_fn, device=device)
    return trainer, trainer.train()


def _run_decentralized(config, data, model, task, log_fn, opt, device):
    """Decentralized online learning over the clients' topology: each
    client's shard (its first T samples, T the smallest shard, labels mod
    2) is its stream; a logistic regression of one output."""
    from fedml_tpu_torch.algorithms.decentralized import DecentralizedAPI
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.partition.topology import SymmetricTopologyManager

    N = data.num_clients
    T = min(len(cy) for cy in data.client_y)
    x = np.stack([cx[:T].reshape(T, -1) for cx in data.client_x])
    y = np.stack([(cy[:T] % 2).astype(np.float32) for cy in data.client_y])
    topo = SymmetricTopologyManager(N, neighbor_num=min(4, N - 1))
    topo.generate_topology()
    api = DecentralizedAPI(create_model("lr", "synthetic", (x.shape[-1],), 1), topo,
                           lr=config.train.lr, variant=opt["variant"] or "dsgd", seed=config.seed,
                           device=device)
    out = api.run(x, y)
    final = {"iterations": int(len(out["losses"])), "final_regret": float(out["regret"][-1])}
    log_fn(final)
    return api, final


def _client_shards_list(data, limit=None):
    ids = range(data.num_clients if limit is None else min(limit, data.num_clients))
    return [(data.client_x[i], data.client_y[i]) for i in ids]


def _run_fedgkt(config, data, model, task, log_fn, opt, device):
    """The first ``client_num_per_round`` clients exchange features and
    logits with the server each round; the row is client 0's end-to-end
    test accuracy."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI

    api = FedGKTAPI(num_classes=data.num_classes, input_shape=tuple(data.client_x[0].shape[1:]),
                    lr=config.train.lr, seed=config.seed, device=device)
    clients = _client_shards_list(data, config.fed.client_num_per_round)
    cache, final = None, {}
    for r in range(config.fed.comm_round):
        cache = api.train_round(clients, local_epochs=config.fed.epochs,
                                server_epochs=config.fed.epochs,
                                batch_size=config.data.batch_size, server_logits_cache=cache)
        final = {"round": r, "Test/Acc": float(api.evaluate(data.test_x, data.test_y, client_id=0))}
        log_fn(final)
    return api, final


def _run_fedgan(config, data, model, task, log_fn, opt, device):
    from fedml_tpu_torch.algorithms.fedgan import FedGANAPI

    api = FedGANAPI(config, data, log_fn=log_fn, device=device)
    return api, api.train()


def _run_fedseg(config, data, model, task, log_fn, opt, device):
    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI

    api = FedSegAPI(config, data, model, log_fn=log_fn, device=device,
                    checkpoint_path=str(opt["checkpoint_path"]) if opt["checkpoint_path"] else None)
    return api, api.train()


def _run_fednas(config, data, model, task, log_fn, opt, device):
    """The search at FedNASAPI's default space; each row has the test
    accuracy and the round's genotype."""
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI

    api = FedNASAPI(data, num_classes=data.num_classes,
                    input_shape=tuple(data.client_x[0].shape[1:]),
                    batch_size=config.data.batch_size, seed=config.seed,
                    arch_grad=opt["variant"] or "first", device=device)
    final = {}
    for r in range(config.fed.comm_round):
        geno = api.train_round(r, client_num_per_round=config.fed.client_num_per_round,
                               epochs=config.fed.epochs)
        final = {"round": r, "Test/Acc": float(api.evaluate(data.test_x, data.test_y)),
                 "genotype": str(geno)}
        log_fn(final)
    return api, final


def _run_split_nn(config, data, model, task, log_fn, opt, device):
    """The default cut of ``default_split_models`` on the data's geometry;
    the first ``client_num_per_round`` clients relay the bottom around the
    ring each round; the row is the test accuracy."""
    from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, default_split_models

    bottom, top = default_split_models(tuple(data.client_x[0].shape[1:]), data.num_classes)
    api = SplitNNAPI(bottom, top, lr=config.train.lr, momentum=config.train.momentum,
                     wd=config.train.wd, seed=config.seed, device=device)
    clients = _client_shards_list(data, config.fed.client_num_per_round)
    final = {}
    for r in range(config.fed.comm_round):
        api.train_ring(clients, batch_size=config.data.batch_size,
                       epochs_per_client=config.fed.epochs)
        final = {"round": r, "Test/Acc": float(api.evaluate(data.test_x, data.test_y))}
        log_fn(final)
    return api, final


def _vertical_parties(data):
    """The pooled clients' flattened features split by columns into three
    parties (D//3, D//3, the rest), and the labels mod 2 (party 0, the
    guest, holds them): ``(xs, y)``."""
    x = np.concatenate([cx.reshape(len(cx), -1) for cx in data.client_x], axis=0)
    y = (np.concatenate(data.client_y, axis=0) % 2).astype(np.float32)
    D = x.shape[1]
    return np.split(x, [D // 3, 2 * (D // 3)], axis=1), y


def _run_vertical_fl(config, data, model, task, log_fn, opt, device):
    """VFL over :func:`_vertical_parties`' three-party split;
    ``--comm_round`` is the epoch count."""
    from fedml_tpu_torch.algorithms.vertical_fl import VFLAPI

    xs, y = _vertical_parties(data)
    api = VFLAPI(feature_splits=[x.shape[1] for x in xs], lr=config.train.lr, seed=config.seed,
                 device=device)
    final = {}
    for r in range(config.fed.comm_round):
        stats = api.train_epoch(xs, y, batch_size=config.data.batch_size)
        final = {"round": r, "Train/Loss": stats["loss"], "Train/Acc": stats["acc"]}
        log_fn(final)
    return api, final


_LONGTAIL_RUNNERS = {
    "centralized": _run_centralized,
    "decentralized": _run_decentralized,
    "fedgkt": _run_fedgkt,
    "fedgan": _run_fedgan,
    "fedseg": _run_fedseg,
    "fednas": _run_fednas,
    "split_nn": _run_split_nn,
    "vertical_fl": _run_vertical_fl,
}


def _attack(opt, config, data):
    """``--attack backdoor``: (poison spec, AttackConfig, the data with
    clients 0..k-1's shards poisoned); (None, None, data) otherwise."""
    if opt["attack"] != "backdoor":
        return None, None, data
    if opt["algorithm"] != "fedavg_robust" or opt["runtime"] != "vmap":
        raise UsageError("--attack backdoor requires --algorithm fedavg_robust --runtime vmap")
    from fedml_tpu_torch.data.edge_cases import PoisonSpec, poison_clients
    from fedml_tpu_torch.robustness.backdoor import AttackConfig

    k = opt["num_attackers"]
    if not 0 < k < data.num_clients:
        raise UsageError(f"--num_attackers must be in [1, {data.num_clients - 1}]")
    spec = PoisonSpec(target_label=opt["target_label"], poison_frac=opt["poison_frac"])
    # one set of attacker ids for the poisoned shards and the boosted uploads
    attack = AttackConfig(attacker_ids=tuple(range(k)), boost=opt["attack_boost"])
    return spec, attack, poison_clients(data, attacker_ids=attack.attacker_ids, spec=spec,
                                        seed=config.seed)


def _restore(api, opt) -> None:
    """--resume: pour the checkpoint into the API and continue from its
    round (round-keyed selection and shuffles make the continuation equal
    to the uninterrupted run)."""
    from fedml_tpu_torch.utils.checkpoint import load_checkpoint, restore_like

    if not opt["checkpoint_path"]:
        raise UsageError("--resume requires --checkpoint_path")
    loaded_vars, round_idx, _, opt_state, algo_state, sched_state = load_checkpoint(
        str(opt["checkpoint_path"])
    )
    api.global_vars = restore_like(api.global_vars, loaded_vars)
    api.start_round = int(round_idx)
    if opt_state is not None and getattr(api, "server_opt_state", None) is not None:
        api.server_opt_state = restore_like(api.server_opt_state, opt_state)
    if sched_state is not None:
        api.scheduler.load_state_dict(sched_state)
    # an algorithm's own state (DP-FedAvg's ledger and secret)
    if hasattr(api, "restore_state"):
        if algo_state is None:
            raise UsageError(
                f"checkpoint has no algorithm state but {type(api).__name__} needs it to resume "
                "faithfully — it was written by an older version or a different algorithm; "
                "restarting from round 0 is the only sound continuation"
            )
        api.restore_state(algo_state)


class _Runner:
    """A transport federation behind the simulator's surface: ``train()``
    runs every round (FedBuff: every server step) and returns the last
    row, then ``global_vars``, ``server_opt_state`` (so the end-of-run
    checkpoint holds the FedOpt moments) and ``health`` are the server's."""

    global_vars = None
    server_opt_state = None
    health = None

    def __init__(self, runner_fn, config, data, model, task, log_fn, device, **kw):
        self._run = lambda: runner_fn(config, data, model, task=task, log_fn=log_fn, device=device,
                                      **kw)

    def train(self):
        server = self._run()
        self.global_vars = server.global_vars
        self.server_opt_state = getattr(server, "_server_opt_state", None)
        self.health = server.health
        return server.history[-1] if server.history else {}


def _build_api(opt, config, data, model, task, log_fn, device, attack_cfg=None):
    algorithm, runtime = opt["algorithm"], opt["runtime"]
    if runtime in TRANSPORTS and algorithm == "fedbuff":
        from fedml_tpu_torch.algorithms import fedbuff as FB

        runner_fn = {
            "loopback": FB.run_fedbuff_loopback,
            "shm": FB.run_fedbuff_shm,
            "mqtt": FB.run_fedbuff_mqtt,
        }[runtime]
        return _Runner(runner_fn, config, data, model, task, log_fn, device)
    if runtime in TRANSPORTS:
        from fedml_tpu_torch.algorithms import fedavg_transport as T

        runner_fn = {
            "loopback": T.run_loopback_federation,
            "shm": T.run_shm_federation,
            "mqtt": T.run_mqtt_federation,
        }[runtime]
        return _Runner(runner_fn, config, data, model, task, log_fn, device,
                       server_opt=algorithm == "fedopt")
    kw = dict(task=task, log_fn=log_fn, device=device)
    if algorithm in ("fedavg", "fedprox"):
        from fedml_tpu_torch.algorithms import FedAvgAPI

        return FedAvgAPI(config, data, model, **kw)
    if algorithm == "fedopt":
        from fedml_tpu_torch.algorithms import FedOptAPI

        return FedOptAPI(config, data, model, **kw)
    if algorithm == "dp_fedavg":
        from fedml_tpu_torch.privacy import DPFedAvgAPI

        return DPFedAvgAPI(config, data, model, dp=_dp_cfg(opt), **kw)
    if algorithm == "fednova":
        from fedml_tpu_torch.algorithms import FedNovaAPI

        return FedNovaAPI(config, data, model, **kw)
    if algorithm == "scaffold":
        from fedml_tpu_torch.algorithms import ScaffoldAPI

        return ScaffoldAPI(config, data, model, **kw)
    if algorithm == "ditto":
        from fedml_tpu_torch.algorithms import DittoAPI

        return DittoAPI(config, data, model, lam=opt["ditto_lambda"], **kw)
    if algorithm == "qfedavg":
        from fedml_tpu_torch.algorithms import QFedAvgAPI

        return QFedAvgAPI(config, data, model, q=opt["qffl_q"], **kw)
    if algorithm == "hierarchical":
        from fedml_tpu_torch.algorithms import HierarchicalFedAvgAPI

        return HierarchicalFedAvgAPI(config, data, model, **kw)
    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.robustness import RobustConfig

    robust = RobustConfig(
        defense_type=opt["defense"], norm_bound=opt["norm_bound"], stddev=opt["noise_stddev"],
        num_byzantine=opt["num_byzantine"], multi_krum_m=opt["multi_krum_m"],
    )
    if attack_cfg is not None:
        from fedml_tpu_torch.robustness.backdoor import BackdoorFedAvgAPI

        return BackdoorFedAvgAPI(config, data, model, robust=robust, attack=attack_cfg, **kw)
    return RobustFedAvgAPI(config, data, model, robust=robust, **kw)
