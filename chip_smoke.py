#!/usr/bin/env python3
"""Drive the PyTorch port (``fedml_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (``nvidia-smi``);
2. build: compile every kernel of the main path from the sources in this
   checkout (``fedml_tpu_torch/ops/csrc``);
3. K1 (the rank-select trimmed mean / median) against its plain PyTorch
   version on the card: bit-equal over a grid of cohort sizes, widths and
   trim windows, with integer ties, and at the per-leaf shapes of a round;
   then its time beside the plain version, ``torch.quantile``, the
   sort-and-window path, ``torch.median`` and the memory bound;
4. the main path: RobustFedAvgAPI on the FEMNIST north-star configuration
   (128 synthetic clients, 10 per round, batch 20, E=1, SGD lr 0.1, the
   62-class CNN at full width): 3 rounds with the coordinate median, 2 with
   the trimmed mean; the K1 launch count is zeroed just before and read just
   after, and must be 8 per round;
5. where a warm median round's time goes (torch.profiler: device kernel
   time by name against the round's wall time);
6. one median round on the card against the same round on the CPU, from
   the same init with the same shuffles, with one full-batch step per
   client (a tight bound) and at the north-star batch of 20.

Then it prints the kernels' JSON line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

C_GRID = (3, 4, 10, 16, 33, 64)
D_GRID = (1, 700, 1_690_046)
COHORT = 10
FULL_D = 1_690_046  # parameters of the 62-class CNN
MEDIAN_ROUNDS, TRIMMED_ROUNDS = 3, 2
# card vs CPU after one median round, by batch size: (rtol, atol). The
# card's cuDNN/cuBLAS sum in another order than the CPU's kernels (both in
# full fp32), and any such rounding flips a few ReLU and max-pool decisions,
# whose gradients then differ by whole terms. On the CPU alone a 1e-7
# relative nudge of the init moves the round's params by up to 4.9e-6 with
# one full-batch step per client (batch -1) and by 1.6e-3 after the
# north-star's 24 steps of batch 20 at lr 0.1; each bound is ~10x its own.
CARD_VS_CPU = {-1: (1e-4, 5e-5), 20: (1e-3, 1e-2)}

# data-sheet HBM bandwidth (bytes/s) and fp32 non-tensor peak (FLOP/s)
CARDS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM5, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return key, rates
    raise RuntimeError(f"no data-sheet rates for {name!r}; add it to CARDS")


def device_ms(fn, iters: int = 30) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``iters`` calls
    queued behind a spin kernel, so the host's launch cost overlaps the spin
    and the events time the device's back-to-back work."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from fedml_tpu_torch.ops import robust_stats as rs

    t0 = time.perf_counter()
    rs._kernel_fn()
    log(json.dumps({"built": [rs.KERNEL_NAME], "build_s": round(time.perf_counter() - t0, 3)}))


def _check_equal(got, want, what) -> float:
    """Raise unless bit-equal; return the max |got - want| (0.0)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"K1 shape {tuple(got.shape)} != {tuple(want.shape)} at {what}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"K1 differs from its reference at {what}: max |err| {err}")
    return err


def phase_k1_parity(device="cuda", c_grid=C_GRID, d_grid=D_GRID):
    """K1 bit-equal to its plain version; returns the max |kernel - plain|."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import robust_stats as rs

    gen = torch.Generator(device=device).manual_seed(0)
    errs = []
    for C in c_grid:
        for D in d_grid:
            x = torch.randn(C, D, generator=gen, device=device)
            for k in range((C - 1) // 2 + 1):
                errs.append(_check_equal(
                    rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k), f"C={C} D={D} k={k}"
                ))
    # integer-valued ties: only the kept multiset decides the result
    for C in (6, COHORT):
        x = torch.randint(-3, 4, (C, d_grid[-1]), generator=gen, device=device).float()
        for k in range((C - 1) // 2 + 1):
            got = rs.trimmed_mean_1d(x, k)
            errs.append(_check_equal(got, rs.trimmed_mean_plain(x, k), f"ties C={C} k={k}"))
            _check_equal(got, rs.trimmed_mean_sort(x, k), f"ties vs sort C={C} k={k}")
    # the per-leaf shapes of a round: [cohort, *leaf] for each weight leaf
    model = create_model("cnn", "femnist", (28, 28, 1), 62)
    for name, p in model.module.named_parameters():
        x = torch.randn((COHORT,) + tuple(p.shape), generator=gen, device=device).reshape(COHORT, -1)
        for k in (1, rs.median_trim_k(COHORT)):
            errs.append(_check_equal(
                rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k), f"{name} k={k}"
            ))
    log(f"[k1] bit-equal to the plain version in {len(errs)} cases "
        f"(C in {list(c_grid)}, D in {list(d_grid)}, every k; integer ties; round leaf shapes)")
    return max(errs)


def phase_k1_timing(name: str, smi: str):
    """K1 at the round's shapes: the median of a [10, *leaf] stack for each
    of the CNN's 8 weight leaves (what one robust round aggregates), and one
    launch over the whole flattened model."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import coordinate_median, trimmed_mean

    card, (bw, fp32_peak) = card_rates(name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = create_model("cnn", "femnist", (28, 28, 1), 62)
    stack = {
        n: torch.randn((COHORT,) + tuple(p.shape), generator=gen, device="cuda")
        for n, p in model.module.named_parameters()
    }
    D = sum(v[0].numel() for v in stack.values())
    assert D == FULL_D, D
    k_med = rs.median_trim_k(COHORT)
    flat = {n: v.reshape(COHORT, -1) for n, v in stack.items()}

    def quantile_all():
        for v in flat.values():
            torch.quantile(v, 0.5, dim=0, interpolation="midpoint")

    def sort_window_all(k):
        for v in flat.values():
            torch.sort(v, dim=0).values[k : COHORT - k].mean(dim=0)

    def plain_all(k):
        for v in flat.values():
            rs.trimmed_mean_plain(v, k)

    # the function agrees with the library's, too
    for n, v in flat.items():
        lib = torch.quantile(v, 0.5, dim=0, interpolation="midpoint")
        torch.testing.assert_close(rs.median_1d(v), lib, rtol=1e-6, atol=1e-6)

    t = {
        "k1_median_round": device_ms(lambda: coordinate_median(stack)),
        "plain_median_round": device_ms(lambda: plain_all(k_med), iters=5),
        "quantile_round": device_ms(quantile_all, iters=10),
        "sort_window_median_round": device_ms(lambda: sort_window_all(k_med), iters=10),
        "k1_trimmed_round": device_ms(lambda: trimmed_mean(stack, trim_k=1)),
        "sort_window_trimmed_round": device_ms(lambda: sort_window_all(1), iters=10),
    }
    x = torch.randn(COHORT, FULL_D, generator=gen, device="cuda")
    t["k1_median_flat"] = device_ms(lambda: rs.trimmed_mean_1d(x, k_med))
    t["k1_trimmed_flat"] = device_ms(lambda: rs.trimmed_mean_1d(x, 1))
    t["sort_window_median_flat"] = device_ms(
        lambda: torch.sort(x, dim=0).values[k_med : COHORT - k_med].mean(dim=0), iters=10
    )
    t["torch_median_flat_lower"] = device_ms(lambda: torch.median(x, dim=0), iters=10)
    x11 = torch.randn(COHORT + 1, FULL_D, generator=gen, device="cuda")
    _check_equal(rs.median_1d(x11), torch.median(x11, dim=0).values, "odd C=11 vs torch.median")
    t["k1_median_flat_c11"] = device_ms(lambda: rs.median_1d(x11))
    t["torch_median_flat_c11"] = device_ms(lambda: torch.median(x11, dim=0), iters=10)

    nbytes = (COHORT * D + D) * 4  # each input read once, each output written once
    ops = COHORT * (COHORT - 1) * D + COHORT * D + D  # compares, adds, one divide
    bound_ms = max(nbytes / bw, ops / fp32_peak) * 1e3
    bound_by = "bytes" if nbytes / bw >= ops / fp32_peak else "operations"
    log(json.dumps({
        "k1_timing_ms": t, "C": COHORT, "D": D, "bytes": nbytes, "ops": ops,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "rates": f"{card} data sheet: {bw / 1e12} TB/s, {fp32_peak / 1e12} TFLOP/s fp32",
        "card": smi,
        "notes": "torch.median is the lower median at even C (not the same function); "
                 "quantile(midpoint) and sort+window are the same function",
    }))
    return t, bound_ms, bound_by


def _north_star(rounds: int, num_clients: int = 128, per_round: int = COHORT):
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.models import create_model

    data = femnist_synthetic(num_clients=num_clients, seed=0)
    cfg = RunConfig(
        data=DataConfig(batch_size=20),
        fed=FedConfig(client_num_in_total=num_clients, client_num_per_round=per_round,
                      comm_round=rounds, epochs=1),
        train=TrainConfig(lr=0.1),
        model="cnn",
        seed=0,
    )
    return cfg, data, create_model("cnn", "femnist", (28, 28, 1), 62)


def phase_main_path(device="cuda", num_clients=128, per_round=COHORT):
    """RobustFedAvgAPI on the north-star config; returns the K1 launches."""
    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import RobustConfig

    runs = (("median", MEDIAN_ROUNDS, {}), ("trimmed_mean", TRIMMED_ROUNDS, {"num_byzantine": 1}))
    launches_per_run = {}
    rs.LAUNCHES[rs.KERNEL_NAME] = 0  # zeroed just before the main path
    for defense, rounds, extra in runs:
        cfg, data, model = _north_star(rounds, num_clients, per_round)
        robust = RobustConfig(defense_type=defense, **extra)
        before = rs.LAUNCHES[rs.KERNEL_NAME]
        api = RobustFedAvgAPI(cfg, data, model, robust=robust, device=device,
                              log_fn=lambda row, d=defense: log(f"[main:{d}] " + json.dumps(row)))
        api.train()
        launches_per_run[defense] = rs.LAUNCHES[rs.KERNEL_NAME] - before
        rows = api.history
        for row in rows:
            for key in ("Train/Loss", "Test/Loss"):
                if not math.isfinite(row[key]):
                    raise AssertionError(f"{defense}: non-finite {key} in {row}")
        if defense == "median" and not rows[-1]["Train/Acc"] > 1.0 / 62:
            raise AssertionError(f"median: Train/Acc {rows[-1]['Train/Acc']} not above chance")
        want = 8 * rounds if device == "cuda" else 0
        if launches_per_run[defense] != want:
            raise AssertionError(f"{defense}: {launches_per_run[defense]} K1 launches, want {want}")
    launches = rs.LAUNCHES[rs.KERNEL_NAME]  # read just after
    log(json.dumps({"main_path_k1_launches": launches, "per_run": launches_per_run}))
    return launches


def phase_profile_round():
    """Where a median round's time goes: one warm round under
    torch.profiler; device kernel time by name against the round's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.robustness import RobustConfig

    cfg, data, model = _north_star(2)
    api = RobustFedAvgAPI(cfg, data, model, robust=RobustConfig(defense_type="median"), device="cuda")
    api.train_round(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.train_round(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (an operator's entry repeats its kernels' time)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(json.dumps({"profile_median_round": {
        "wall_ms_profiled": wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "top_kernels_ms_calls": {
            e.key[:70]: [e.self_device_time_total / 1e3, e.count] for e in top
        },
    }}))


def phase_card_vs_cpu(num_clients=128, per_round=COHORT):
    """One median round on the card and on the CPU from the same init with
    the same shuffles, at two batch sizes (see CARD_VS_CPU)."""
    import dataclasses

    import torch

    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.robustness import RobustConfig

    with fp32_math():
        inside = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    log(f"[card-vs-cpu] TF32 inside float32 rounds: cudnn.allow_tf32={inside[0]} "
        f"matmul.allow_tf32={inside[1]} (outside: cudnn {torch.backends.cudnn.allow_tf32})")
    if any(inside):
        raise AssertionError("TF32 is on inside a float32 round")
    for batch_size, (rtol, atol) in CARD_VS_CPU.items():
        out = {}
        for device in ("cpu", "cuda"):
            cfg, data, model = _north_star(1, num_clients, per_round)
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch_size))
            api = RobustFedAvgAPI(cfg, data, model, robust=RobustConfig(defense_type="median"),
                                  device=device)
            t0 = time.perf_counter()
            api.train()
            out[device] = ({k: v.cpu() for k, v in api.global_vars.items()}, time.perf_counter() - t0)
        (cpu, cpu_s), (card, card_s) = out["cpu"], out["cuda"]
        err = max((card[k] - cpu[k]).abs().max().item() for k in cpu)
        log(json.dumps({"card_vs_cpu": {"batch_size": batch_size, "max_abs_err": err, "rtol": rtol,
                                        "atol": atol, "cpu_round_s": cpu_s, "cuda_round_s": card_s}}))
        for k in cpu:
            torch.testing.assert_close(card[k], cpu[k], rtol=rtol, atol=atol, msg=lambda m: f"{k}: {m}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    name, smi = phase_device()
    phase_build()
    max_err = phase_k1_parity()
    t, bound_ms, bound_by = phase_k1_timing(name, smi)
    launches = phase_main_path()
    phase_profile_round()
    phase_card_vs_cpu()

    from fedml_tpu_torch.ops import robust_stats as rs

    log(json.dumps({"kernels": [{
        "name": rs.KERNEL_NAME,
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/robust_stats.cu",
        "replaces": "fedml_tpu/ops/robust_stats.py:53",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["k1_median_round"],
        "plain_ms": t["plain_median_round"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": t["sort_window_median_round"],
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
