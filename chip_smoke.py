#!/usr/bin/env python3
"""Drive the PyTorch port (``fedml_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (``nvidia-smi``);
2. build: compile every kernel of both paths from the sources in this
   checkout (``fedml_tpu_torch/ops/csrc``), one ``nvcc`` per source, all
   started together;
3. K1 (the rank-select trimmed mean / median) against its plain PyTorch
   version on the card: bit-equal over a grid of cohort sizes, widths and
   trim windows (every cohort of the register kernel, C = 2..16, and the
   select kernel above it, up to C = 1000: radix select on warp tiles in
   opted-in shared memory), with integer ties, at the per-leaf shapes of a
   round, and with ±0, ±inf and NaN (one a column, several, NaN only) at
   C in {17, 100, 128, 455, 1000}, NaN with NaN; then its time for a
   round's 8 leaves and for one flat launch beside the plain version,
   ``torch.quantile``, the sort-and-window path, ``torch.median`` and the
   bound (the function's bytes), each time's share of the bound, the
   100-client round's 8 leaves at C = 100 and the median of a [128,
   1690046] stack, each beside ``torch.sort`` and its bound, and each
   path's registers, local memory, shared memory and blocks an SM;
4. the main path: RobustFedAvgAPI on the FEMNIST north-star configuration
   (128 synthetic clients, 10 per round, batch 20, E=1, SGD lr 0.1, the
   62-class CNN at full width): 3 rounds with the coordinate median, 2 with
   the trimmed mean; the K1 launch count is zeroed just before and read just
   after, and must be 8 per round; then one median round with 100 clients
   a round (K1's select kernel), which must launch K1 exactly 8 times;
5. where a warm median round's time goes (torch.profiler: device kernel
   time by name against the round's wall time);
6. one median round on the card against the same round on the CPU, from
   the same init with the same shuffles, with one full-batch step per
   client (a tight bound) and at the north-star batch of 20;
7. K2, K3, K4 (flash attention forward, backward dQ, backward dK/dV)
   against their plain PyTorch versions on the card: causal and not,
   S in {32, 128, 192, 512}, head dim in {16, 32, 48, 64, 80, 96, 128,
   160, 256} (48 and 80 through the wrappers' zero-padding to 64 and 96;
   160 and 256 through the chunked kernels, 160 padded to 256), float32
   and bfloat16, d = 384 and 512 at S = 128 (three and four chunks,
   causal, both types), d = 256 at S = 128 over 192 keys (not causal,
   both types), and the LM's [256, 256, 96] causal shape in both; O, LSE,
   dQ, dK and dV each within the tolerance stated at FLASH_TOL, the
   largest share of the bound logged by type, by head dim above 128, and
   by type, head dim and output;
8. their times at the LM's shapes beside the plain versions, the bound and
   ``scaled_dot_product_attention`` (forward; backward as forward+backward
   minus forward), with each kernel's achieved TFLOP/s, share of its bound,
   registers, local memory and blocks resident on an SM, and K3 + K4 over
   SDPA's backward, and the float32 kernels beside float32 SDPA and their
   float32 bounds (bytes, or three TF32 products a product), with K3 + K4
   over SDPA's float32 backward; the same at [256, 256, 256] causal
   (the chunked kernels), both types, beside SDPA and the backend it
   picked; then the SASS of the built library (``cuobjdump``): every
   K2/K3/K4 instantiation, bfloat16 and float32 (split TF32), the chunked
   ones included, must hold tensor-core (HMMA) instructions, and no
   float32 CUDA-core (SIMT) flash kernel may be left;
9. the LM path: FedAvgAPI(task="nwp") on the flagship LM (6 layers, 8
   heads, 768 wide, vocab 1024, windows of 256; 8 synthetic-Shakespeare
   clients all in every round, batch 32, E=1, AMSGrad lr 1e-3, bfloat16
   compute) with flash attention, 3 rounds; the K2/K3/K4 launch counts are
   zeroed just before and read just after, and must equal the counts the
   data's shard sizes give (6 a step each, 6 more K2 an eval batch); the
   losses finite and Train/Loss falling from round 0 to round 2. Then its
   float32 leg (``phase_lm_float32``): the same width (head dim 96) at
   LM_F32's depth, float32 compute, one round, whose K2/K3/K4 launches
   under "float32" must equal the shard sizes' count (none under
   "bfloat16"), with finite losses and its update (params − init) within
   LM_F32_VS_FULL of the same round's on the model's default
   ``causal_full_attention`` (TF32 off), and two faults planted in K3/K4
   (dQ zeroed; their inputs rounded to TF32) each breaking that bound.
   Then both legs again at head dim 256 (``phase_lm_wide``, LM_WIDE: 3
   heads, 1 layer; the bf16 leg 2 rounds), through the chunked kernels,
   whose launches count under their own keys;
10. where a warm LM round's time goes (torch.profiler);
11. one LM round on the card against the same round on the CPU (2 layers,
    128 wide, windows of 64, float32 SGD) from the same init with the same
    shuffles;
12. the cross-silo transport (``phase_transport``): on the north-star CNN
    at batch 20, FedOptAPI (FedAdam, server lr 0.05) trained on the client
    actors' own minibatches (``actor_order_perm_fn``) against the same
    2 rounds as a loopback federation of 10 client actors in threads
    (TRANSPORT_SIM_TOL), and one round over shared memory bit-equal to one
    over loopback, and the same 2 FedAdam rounds over MQTT (``phase_mqtt``:
    the embedded broker, then TCP to the port's MiniMqttBroker), each
    bit-equal to loopback with the same model payload bytes and messages,
    all with cuDNN's deterministic algorithms; then 2 rounds of the
    flagship LM over loopback, 8 client actors on the card, with the
    K2/K3/K4 launch counts zeroed just before and read just after (they
    must equal the counts the clients' shards give) and the servers' train
    loss finite and falling; and a ``[transport]`` JSON line with each
    run's warm round time (MQTT's beside loopback's), wire bytes up and
    down a round (the port's CommMeter), the seconds a round spends in
    to_bytes/from_bytes and its other host spans, beside the card's name
    and power limit. gRPC is not run here: the card's machine has no
    grpcio (tests/test_torch_grpc.py holds it on the CPU);
13. secure aggregation and fault plans (``phase_faults_secagg``): the
    north-star CNN over loopback with ``secure_agg`` for 2 rounds of one
    full-batch step a client, within SECAGG_TOL of the same rounds plain,
    with the masking and unmasking host seconds a round; then 2 rounds at
    batch 20 under a plan that drops one client of each cohort, with a
    deadline and min_clients = 9: each round closes on 9 uploads, the
    faults/* counters are exact and the losses finite;
14. the command line (``phase_cli``): ``python -m fedml_tpu_torch`` on the
    north-star robust configuration (median, 2 rounds) as a subprocess,
    exiting 0 with Test/Acc above chance, summary.json and the
    checkpoint; then through ``cli.main`` in process, with cuDNN's
    deterministic algorithms, 4 rounds straight against 2 rounds and
    ``--resume`` to 4 — the resumed rows and final vars bit-equal, K1
    launched exactly 8 times a round in each call (the count zeroed just
    before the call and read just after); and a FedAdam loopback
    federation through the CLI with finite losses. A ``[cli]`` JSON line
    gives each run's warm round time beside phase 4's, a checkpoint
    write's seconds and ``registry.load``'s;
15. the CIFAR model family (``phase_resnet``) on the cross-silo row
    (synthetic CIFAR geometry, 10 silos of 512, batch 64, E=1, SGD lr
    0.1): FedAvgAPI on ResNet-56 (591,322 params, 8,992 running
    statistics) in float32 then bfloat16, 3 rounds each without eval
    (round 0 the warm-up; bfloat16's round 2 under the profiler, tracing
    the device only); RobustFedAvgAPI median, 2
    rounds, with K1's launches zeroed just before and read just after
    (one a parameter leaf a round: 176; the running statistics take the
    sample-weighted mean, as in the reference) and the last aggregate
    bit-equal to K1's plain version; one float32 round on the card
    against the CPU (RESNET_CARD_VS_CPU); the trained ResNet-56 fixture's
    eval logits on the card against the CPU and its test accuracy (1.0);
    and a warm bfloat16 round of ResNet-18-GN (4 silos of 512, 100
    classes, batch 256). A ``[resnet]`` JSON line gives the readings;
16. the defended and private rounds (``phase_defenses``) on the north
    star: BackdoorFedAvgAPI with one attacker of round 0's cohort boosted
    γ = 10, 2 median rounds and 1 trimmed-mean round, K1's launches
    zeroed just before each run and read just after (8 a round), the
    last aggregate bit-equal to K1's plain version on the round's boosted
    stack, and the attack success rate; Krum (f = 1) and Multi-Krum
    (m = 3), 2 rounds each, then one round of one full-batch step a
    client on the card and on the CPU, whose captured stacks must select
    the same client ids (the score gap to the next-best client and
    Krum's device ms reported); weak DP for 2 rounds with one fixed noise
    stream (CPU draws) on both devices, its full-batch round on the card
    within CARD_VS_CPU of the CPU's; DPFedAvgAPI for 3 rounds with an
    explicit secret, its cohorts equal to ``poisson_client_sampling``'s
    and its epsilon to a fresh host accountant's; power-of-choice
    overprovisioned ×1.4 under a dropout plan with eval on every client,
    3 rounds, its cohorts equal to a replay of the policy on the losses
    the run reported and its ``faults/*`` counters to the plan's, the
    eval timed apart from ``round_time_s`` (which ends before it). Every
    loss finite; a ``[defenses]`` JSON line gives the readings;
17. the stateful and drift-correcting algorithms (``phase_longtail``) on
    the north star, 2 rounds each: FedNova, q-FedAvg (q = 1) and
    hierarchical FedAvg (2 groups) with warm round times beside phase 4's;
    SCAFFOLD and Ditto (λ = 0.1) with their per-client state on the device
    and spilled to the mmap tier, bit-equal between the two, with the
    stack's bytes, the peak device memory and the gather/scatter ms a
    round, and Ditto's Personalized/Acc; a full-batch FedNova and SCAFFOLD
    round on the card against the CPU (CARD_VS_CPU; SCAFFOLD's control
    variates STATE_CARD_VS_CPU); a SCAFFOLD
    ``--resume`` through ``cli.main`` bit-equal to the straight run; one
    epoch of centralized training; DSGD and push-sum with finite losses
    and a falling regret. A ``[longtail]`` JSON line gives the readings;
18. FedBuff, the async buffered federation (``phase_fedbuff``), on the
    north star at full width (10 workers, ``async_buffer_k`` 10, η_g 1,
    staleness exponent 0.5): (a) 6 server steps over loopback, then the
    same under the profiler (the device's busy share); (b) 3 steps over
    shared memory and over the embedded MQTT broker — each run with its
    step count, finite losses, one staleness entry a buffered upload, a
    staleness histogram summing to them, and the health registry's
    participations covering them; seconds a step, uploads a second and
    bytes a dispatch and an upload; (c) one worker, k = 1, 3 full-batch
    steps on the card against the CPU from one init (CARD_VS_CPU); (d)
    the buffer step alone, k = 10 over the whole model, τ = 0..9, within
    FEDBUFF_STEP_TOL of float64 numpy, its device ms beside its bytes
    bound; (e) a dropout 0.2 / flaky 0.1 plan: declines re-dispatched and
    the flaky copies dropped by the tag dedupe, as the injector counted
    them, the steps completed; (f) ``straggler_aware`` on the sync
    loopback transport with a fixed set of slow clients: the cohorts
    equal a replay of the policy over the run's ``local_train`` spans,
    no cohort holds a flagged client while ten unflagged ones exist, and
    a slow client gets flagged. A ``[fedbuff]`` JSON line gives the
    readings;
19. the population tier (``phase_population``) on the reference's two
    scale rows at full width: (a) the StackOverflow RNN (10,004 symbols,
    LSTM 670) under FedAvgAPI over 100,000 clients read from a disk mmap
    store (~1.2 GB, written first), 10 a round, against the same
    generator's 2,000 clients in RAM — round times, the time of a
    client's step, cohort reads, a profiled round, peak memory; (b)
    SCAFFOLD on ``lr`` at 1,000,000 clients with ``weighted`` selection
    drawn from the population index's alias table and the sharded
    record-major state tier, against the same at 100,000 — the ratio of
    their round times, the spill's gather and scatter ms, a synchronous
    gather beside the prefetched one; (c) SCAFFOLD at 100,000 on the
    device, mmap and sharded tiers, bit-equal; (d) every cohort equal to
    a host replay of the draw; (e) one full-width RNN round, card against
    CPU (RNN_CARD_VS_CPU). A ``[population]`` JSON line gives the
    readings. It needs ~4 GB free under the temporary directory;
20. the model-bound algorithms (``phase_modelbound``) at the reference's
    full widths, none of which launches K1-K4: (a) FedSeg, the width-32
    encoder-decoder on ``synthetic_segmentation`` (21 classes, 128×128,
    10 clients of 32, batch 8, lr 0.05), 3 rounds with eval each round —
    round and eval seconds, mIoU and FWIoU in [0, 1], a profiled round,
    the best-mIoU checkpoint's round, and one full-batch round of 2
    clients on the card against the CPU (SEG_CARD_VS_CPU); (b) FedGKT, the
    ResNet-56 cut (client blocks 2, server (6, 6)) on the cross-silo CIFAR
    geometry (10 × 512, batch 64, lr 0.01), 2 rounds — the clients', the
    server's and the logit return's seconds, finite losses, the features'
    bytes a client, the accuracy; (c) FedGAN on the north star's
    ``femnist_synthetic(128)``, 10 a round, batch 20, lr 2e-4, 3 rounds —
    round seconds, finite G and D losses, ``generate(64)`` inside tanh's
    range, and one full-batch round on the card against the CPU with the
    same latents (GAN_CARD_VS_CPU); (d) FedNAS, ``DARTSNetwork`` at ch 16,
    3 cells, 4 steps on CIFAR geometry (10 clients of 64, 4 a round, batch
    16), 2 rounds with each architect — round seconds, peak device memory,
    the genotype — and the second-order α-gradient of one step on the card
    against the CPU (NAS_GRAD_CARD_VS_CPU); (e) each of the four through
    ``cli.main`` for 1 round, its row's keys those of the reference's
    ``_run_*`` function. A ``[modelbound]`` JSON line gives the readings.

21. the batched client schedule and the ImageNet-size models
    (``phase_batched_and_zoo``): (a) the flagship LM under
    ``client_parallelism="vmap"`` beside the loop, 2 rounds each, with
    the K2/K3/K4 launches exact (one a layer a batched step: the cohort
    folded into BH), no plain-version or SDPA call, warm round time and
    peak memory of each, launches a step and busy share of a profiled
    vmap round (the loop's are phase 10's), the two runs
    within BATCHED_LM_TOL, and the folded launch on [8·32·8, 256, 96]
    bit-equal to per-client launches; (b) VGG-11 (1000 classes) over a
    written ImageNet tree through ``load_imagenet_streaming`` (10 clients,
    batch 32, 2 rounds) and (c) EfficientNet-B0 over a written gld23k
    tree through ``load_landmarks`` (203 classes, 10 users × 32), each
    with round times, launches, busy share, peak memory and one step on 2
    images on the card against the CPU (ZOO_CARD_VS_CPU). A ``[batched]``
    JSON line gives the readings.

22. split learning and vertical FL (``phase_split_vertical``), none of
    which launches K1-K4, under float32 with TF32 off: (a) SplitNN through
    the CLI's runner on ``femnist_synthetic(128)``, a ring of 10, batch
    20, SGD lr 0.1, momentum 0.9, wd 5e-4, 2 rounds — its rows, finite
    params, round seconds, and a round of one batch a client (a whole
    round is chaotic) on the card within SPLIT_CARD_VS_CPU of the same
    round on the CPU, and that round with TF32 convolutions and matmuls
    (a planted fault) outside it; (b) the loopback
    split federation on the card bit-equal to the fused simulator on the
    card (cuDNN's deterministic algorithms), its bytes up and down a
    round, and each boundary codec's cut factor; (c) the CLI's VFL runner
    for 2 epochs and the loopback vertical federation over the runner's
    party split on the card, bit-equal, finite losses; (d) a fault plan that drops one client's turns: each run
    skips it, and two runs agree bit for bit. A ``[split_vertical]`` JSON
    line gives the readings and ``phase_s``.

Then it prints each phase's seconds (``phase_s``), the kernels' JSON line,
the ``nvidia-smi`` line, and as its last line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result."""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

C_GRID = (3, 4, 10, 16, 17, 33, 64, 65, 128, 200, 1000, 2000)
D_GRID = (1, 700, 1_690_046)
COHORT = 10
FULL_D = 1_690_046  # parameters of the 62-class CNN
# K1 above 64 clients: every k is 33-500 windows, so a few of them; and at
# C = 1000 and 2000 narrower D (the [1000, 100003] input is 0.4 GB; 2000 is
# past the select kernel's shared-memory tile: the column from device memory)
K1_LARGE_C = 64
K1_D_AT_C = {1000: (100_003,), 2000: (20_011,)}
LARGE_C = 128  # K1's time beside torch.sort at a cohort above the register kernel's
# special values at cohorts of the select kernel (C > 16), its tile's widest
# C (455) and a column read from device memory (1000), at D = K1_SPECIAL_D
K1_SPECIAL_C = (17, 100, 128, 455, 1000)
K1_SPECIAL_KINDS = ("int_ties", "signed_zeros", "infs", "one_nan", "nans")
K1_SPECIAL_D = 100_003
# the robust round at a cohort above 64: 128 clients, 100 a round
LARGE_COHORT = 100
MEDIAN_ROUNDS, TRIMMED_ROUNDS = 3, 2
# card vs CPU after one median round, by batch size: (rtol, atol). The
# card's cuDNN/cuBLAS sum in another order than the CPU's kernels (both in
# full fp32), and any such rounding flips a few ReLU and max-pool decisions,
# whose gradients then differ by whole terms. On the CPU alone a 1e-7
# relative nudge of the init moves the round's params by up to 4.9e-6 with
# one full-batch step per client (batch -1) and by 1.6e-3 after the
# north-star's 24 steps of batch 20 at lr 0.1; each bound is ~10x its own.
CARD_VS_CPU = {-1: (1e-4, 5e-5), 20: (1e-3, 1e-2)}
# SCAFFOLD's control variates after the same full-batch round: c_i⁺ holds
# (x − y_i)/(K·lr), one client's model (its ReLU and max-pool flips are not
# averaged away) times 1/(K·lr) = 10. On the CPU alone the 1e-7 nudge moves
# the cohort's rows by 5.3e-5 and c by 4.5e-7; 1e-3 is ~20x the rows'.
STATE_CARD_VS_CPU = (1e-3, 1e-3)

# card vs CPU after one LM round (float32 SGD): the same float32 arithmetic
# summed in another order; on the CPU alone a 1e-7 relative nudge of the
# init moves this round's params by 3.6e-7 (the LM is not chaotic here,
# unlike the CNN), so 1e-5 is ~30x that.
LM_CARD_VS_CPU = (1e-4, 1e-5)

# K2-K4 against their plain versions, by input type: |err| <= rtol·|ref| +
# atol·max|ref|. float32: only the order of the float32 sums differs (the
# plain versions run at the kernels' own 64-row tiles). bfloat16: one
# rounding of P (K2), dS (K3) or an output to bf16 may go the other way
# when the float32 sums before it differ in their last bits — one bf16 ulp
# (2^-8 relative) of that value.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0**-7, 2.0**-8)}

# FedOptAPI against the loopback federation after 2 FedAdam rounds at batch
# 20, (rtol, atol): bit-equal. The simulator trains each client on its
# actor's minibatches (actor_order_perm_fn), so both runtimes take the same
# float32 steps on the same batches at the same shapes, with cuDNN's
# deterministic algorithms, and average and step the server alike. Measured
# 0.0 on the H100 and on the CPU.
TRANSPORT_SIM_TOL = (0.0, 0.0)
TRANSPORT_ROUNDS = 2
# secure against plain aggregation after 2 rounds, (rtol, atol): the
# reference's own bound (tests/test_secure_transport.py), the 2^-16
# fixed-point grid of the masked sums
SECAGG_TOL = (1e-3, 5e-4)
SECAGG_ROUNDS = 2
FAULT_ROUNDS = 2
FAULT_DEADLINE_S = 1.0
FLASH_S_GRID = (32, 128, 192, 512)
# 48 and 80: zero-padded to 64 and 96; 160 and 256: the chunked kernels (160
# zero-padded to 256), two 128-wide chunks of the output's head dim
FLASH_D_GRID = (16, 32, 48, 64, 80, 96, 128, 160, 256)
# (S, Sk, d, causal), both types: three and four chunks; two chunks over
# more keys than queries; five and eight chunks, the float32 cluster
# kernels' K3 and K4 at clusters of 5 and of the largest size; nine chunks,
# above it (their K3 and K4 are the chunked kernels there)
FLASH_WIDE_CASES = ((128, 128, 384, True), (128, 128, 512, True), (128, 192, 256, False),
                    (64, 64, 640, True), (64, 64, 1024, True), (64, 64, 1152, True))
FLASH_WIDE_TIMING = dict(B=32, H=8, S=256, d=256)  # the LM's [256, 256, ·] causal at d = 256
FLASH_BH = 3
# the flagship LM (bench.py _flagship_lm_row): attention at B=32, H=8
LM = dict(layers=6, heads=8, width=768, vocab=1024, seq=256, clients=8,
          samples=512, batch=32, lr=1e-3)
LM_ROUNDS = 3
# the LM path's float32 leg (phase 9): LM's width, heads and window (head
# dim 96) at 2 layers, 2 clients of 64, batch 32, one round, float32
# compute. SGD, not LM's AMSGrad: Adam's first steps move every weight by
# about ±lr whatever its gradient's size, so the round's parameters would
# not show a wrong gradient; SGD moves them by lr times it.
LM_F32 = dict(layers=2, clients=2, samples=64, batch=32, lr=0.1)
# that round against the same round on causal_full_attention (torch
# matmuls and softmax, TF32 off), tensor by tensor: the round's update
# (vars − init) within LM_F32_VS_FULL of the full round's largest in that
# tensor, after LM_F32_ULPS units of 2⁻²³·max|vars| (the params' float32
# stores: 2 steps and the average, half an ulp each, in each run). The
# faults of LM_F32_FAULTS planted in the flash round (_lm_f32_fault) must
# break it. NVIDIA H100 80GB HBM3, 700 W: flash 2.4e-6, K3/K4 on
# TF32-rounded inputs 8.7e-5, dQ zeroed 0.66, at max |update| 3.1e-3.
LM_F32_VS_FULL = 1e-5
LM_F32_ULPS = 4
LM_F32_FAULTS = ("dq_zero", "inputs_tf32")
# the LM path at head dim 256 (phase_lm_wide): LM's width over 3 heads, so
# its attention runs the chunked kernels; 1 layer, 2 clients of 64. The
# bf16 leg trains 2 rounds with LM's AMSGrad (its loss must fall), the
# float32 leg is LM_F32's round, held to causal_full_attention as there
LM_WIDE = dict(heads=3, layers=1, clients=2, samples=64)

# the cross-silo ResNet-56 row (bench.py:617-690) and the ResNet-18-GN row
# (bench.py:895-938)
RESNET = dict(clients=10, classes=10, shape=(32, 32, 3), samples=512, batch=64, lr=0.1)
RESNET_ROUNDS = 3
RESNET_GN = dict(clients=4, classes=100, samples=512, batch=256)
RESNET_FIXTURE = "fedml_tpu/models/pretrained_weights/resnet56_cifar10_synth.npz"
# card vs CPU after one fp32 ResNet-56 round of one full-batch step (512
# samples) for each of RESNET_CPU_CLIENTS clients, by kind: (rtol, atol).
# A round at batch 64 cannot be held: on the CPU alone a 1e-7 relative
# nudge of the init moves the mean loss of a 2-client round from 9.78 to
# 8.65. One full-batch step is tighter but still steep: the nudge moves
# the params by up to 1.6e-3 (lr 0.1 times the gradient of 56 layers of
# BatchNorm and ReLU), the running statistics (the EMA of the one forward
# at the init) by 1.2e-6, 9.3e-7 of their scale; each bound is ~6-10x
# its own.
RESNET_CPU_CLIENTS = 1
RESNET_CARD_VS_CPU = {"params": (0.0, 1e-2), "stats": (1e-5, 1e-5)}
# the fixture's eval logits, card vs CPU: |err| <= tol * max(1, max|logit|);
# the two float32 forwards sum in other orders (port vs reference on the
# CPU: 2.3e-7 of the scale)
RESNET_FIXTURE_TOL = 1e-5

# data-sheet HBM bandwidth (bytes/s), fp32 non-tensor peak, dense bf16
# tensor-core peak and dense TF32 tensor-core peak (FLOP/s)
CARDS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 835e12, 417.5e12),
    "H100": (3.35e12, 67e12, 989e12, 495e12),  # SXM5, "NVIDIA H100 80GB HBM3"
    "H200": (4.8e12, 67e12, 989e12, 495e12),
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
    """Both kernel sources at once (each ``load`` runs its own nvcc)."""
    from concurrent.futures import ThreadPoolExecutor

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import robust_stats as rs

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(rs._lib), pool.submit(fa._lib)]:
            f.result()  # raises a build failure
    log(json.dumps({"built": [rs.KERNEL_NAME, *fa.KERNEL_NAMES],
                    "build_s": round(time.perf_counter() - t0, 3)}))


def _check_equal(got, want, what) -> float:
    """Raise unless bit-equal; return the max |got - want| (0.0)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"K1 shape {tuple(got.shape)} != {tuple(want.shape)} at {what}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"K1 differs from its reference at {what}: max |err| {err}")
    return err


def _check_bits(got, want, what) -> float:
    """Raise unless bit-equal where the plain version is not NaN and NaN
    where it is; return the max |got - want| (0.0)."""
    import torch

    nan = torch.isnan(want)
    if (got.shape != want.shape or not torch.equal(torch.isnan(got), nan)
            or not torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
        raise AssertionError(f"K1 differs from its reference at {what}")
    return 0.0


def k1_special_block(kind: str, C: int, D: int, gen, device):
    """[C, D] float32 of one special-value kind: small integers (ties); a
    quarter +0 and a quarter -0 among randn and ±1; 10% +inf and 10% -inf;
    one NaN a column; ~5% NaN, 60% in 4 columns and NaN only in the last 2."""
    import torch

    x = torch.randn(C, D, generator=gen, device=device)
    if kind == "int_ties":
        return torch.randint(-3, 4, (C, D), generator=gen, device=device).float()
    if kind == "signed_zeros":
        pick = torch.randint(0, 4, (C, D), generator=gen, device=device)
        x = torch.where(pick == 0, torch.zeros_like(x), x)
        x = torch.where(pick == 1, torch.full_like(x, -0.0), x)
        return torch.where(pick == 2, torch.sign(x), x)
    u = torch.rand(C, D, generator=gen, device=device)
    if kind == "infs":
        x[u < 0.1] = math.inf
        x[u > 0.9] = -math.inf
    elif kind == "one_nan":
        rows = torch.randint(0, C, (D,), generator=gen, device=device)
        x[rows, torch.arange(D, device=device)] = math.nan
    elif kind == "nans":
        x[u < 0.05] = math.nan
        x[:, -6:-2][u[:, -6:-2] < 0.6] = math.nan
        x[:, -2:] = math.nan
    return x


def phase_k1_parity(device="cuda", c_grid=C_GRID, d_grid=D_GRID, special_c=K1_SPECIAL_C,
                    special_d=K1_SPECIAL_D):
    """K1 bit-equal to its plain version; returns the max |kernel - plain|."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import robust_stats as rs

    gen = torch.Generator(device=device).manual_seed(0)
    errs = []
    for C in c_grid:
        ks = (range((C - 1) // 2 + 1) if C <= K1_LARGE_C
              else sorted({0, 1, C // 4, rs.median_trim_k(C)}))
        for D in K1_D_AT_C.get(C, d_grid):
            x = torch.randn(C, D, generator=gen, device=device)
            for k in ks:
                errs.append(_check_equal(
                    rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k), f"C={C} D={D} k={k}"
                ))
            del x
    # every cohort of the register kernel (C = 2..16) and the first C above it
    for C in range(2, 18):
        x = torch.randn(C, 700, generator=gen, device=device)
        for k in range((C - 1) // 2 + 1):
            errs.append(_check_equal(
                rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k), f"C={C} D=700 k={k}"
            ))
    # integer-valued ties: only the kept multiset decides the result
    for C in (6, COHORT, LARGE_C):
        x = torch.randint(-3, 4, (C, d_grid[-1]), generator=gen, device=device).float()
        for k in (range((C - 1) // 2 + 1) if C <= K1_LARGE_C else (0, 1, rs.median_trim_k(C))):
            got = rs.trimmed_mean_1d(x, k)
            errs.append(_check_equal(got, rs.trimmed_mean_plain(x, k), f"ties C={C} k={k}"))
            _check_equal(got, rs.trimmed_mean_sort(x, k), f"ties vs sort C={C} k={k}")
    # special values: ±0, ±inf, NaN (a NaN is in no rank and kept only at k = 0)
    for C in special_c:
        for kind in K1_SPECIAL_KINDS:
            x = k1_special_block(kind, C, special_d, gen, device)
            for k in sorted({0, 1, C // 4, rs.median_trim_k(C)}):
                errs.append(_check_bits(rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k),
                                        f"{kind} C={C} D={special_d} k={k}"))
            del x
    # the per-leaf shapes of a round: [cohort, *leaf] for each weight leaf
    model = create_model("cnn", "femnist", (28, 28, 1), 62)
    for name, p in model.module.named_parameters():
        x = torch.randn((COHORT,) + tuple(p.shape), generator=gen, device=device).reshape(COHORT, -1)
        for k in (1, rs.median_trim_k(COHORT)):
            errs.append(_check_equal(
                rs.trimmed_mean_1d(x, k), rs.trimmed_mean_plain(x, k), f"{name} k={k}"
            ))
    log(f"[k1] bit-equal to the plain version in {len(errs)} cases "
        f"(C in {list(c_grid)}, D in {list(d_grid)} (C = 1000: D = 100003; C = 2000: D = "
        f"20011), every k up to "
        f"C = {K1_LARGE_C}, four k above; C = 2..17 at D = 700; integer ties; round leaf shapes; "
        f"{', '.join(K1_SPECIAL_KINDS)} at C in {list(special_c)}, D = {special_d})")
    return max(errs)


def phase_k1_timing(name: str, smi: str):
    """K1 at the round's shapes: the median of a [10, *leaf] stack for each
    of the CNN's 8 weight leaves (what one robust round aggregates), and one
    launch over the whole flattened model; then the select kernel at the
    100-client round's own shape (the 8 leaves at C = 100) and over
    [128, whole model]. Bounds: the function's bytes."""
    import torch

    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import coordinate_median, trimmed_mean

    card, (bw, *_) = card_rates(name)
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

    def sort_window_all(k, leaves=flat):
        for v in leaves.values():
            C = v.shape[0]
            torch.sort(v, dim=0).values[k : C - k].mean(dim=0)

    def plain_all(k, leaves=flat):
        for v in leaves.values():
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

    def bound(C, D):
        """The function's bytes (each input read once, each output written
        once) over the card's rate, and beside them the C(C-1) compares a
        coordinate of the stable-rank formula (the register kernel's work,
        and that of the O(C^2) kernel C > 16 took before the select
        kernel)."""
        nbytes = (C * D + D) * 4
        return nbytes, C * (C - 1) * D, nbytes / bw * 1e3, "bytes"

    nbytes, ops, bound_ms, bound_by = bound(COHORT, D)
    # a cohort above the register kernel's: the median of [128, D]
    xl = torch.randn(LARGE_C, FULL_D, generator=gen, device="cuda")
    k_l = rs.median_trim_k(LARGE_C)
    torch.testing.assert_close(rs.median_1d(xl), rs.trimmed_mean_sort(xl, k_l), rtol=1e-6, atol=1e-6)
    large = {
        "C": LARGE_C, "D": FULL_D,
        "k1_median_ms": device_ms(lambda: rs.median_1d(xl), iters=10),
        "sort_window_median_ms": device_ms(
            lambda: torch.sort(xl, dim=0).values[k_l : LARGE_C - k_l].mean(dim=0), iters=5),
        "plain_median_ms": device_ms(lambda: rs.trimmed_mean_plain(xl, k_l), iters=2),
    }
    (large["bytes"], large["rank_compares"], large["bound_ms"], large["bound_by"]) = bound(
        LARGE_C, FULL_D)
    large["bound_share"] = large["bound_ms"] / large["k1_median_ms"]
    del xl
    # the 100-client median round's own launches: the 8 leaves at C = 100
    stack_c = {n: torch.randn((LARGE_COHORT,) + tuple(p.shape), generator=gen, device="cuda")
               for n, p in model.module.named_parameters()}
    flat_c = {n: v.reshape(LARGE_COHORT, -1) for n, v in stack_c.items()}
    k_c = rs.median_trim_k(LARGE_COHORT)
    for n, v in flat_c.items():
        _check_equal(rs.median_1d(v), rs.trimmed_mean_plain(v, k_c), f"{n} at C={LARGE_COHORT}")
    path = {
        "C": LARGE_COHORT, "D": FULL_D, "launches": len(flat_c),
        "k1_median_round_ms": device_ms(lambda: coordinate_median(stack_c), iters=10),
        "sort_window_median_round_ms": device_ms(lambda: sort_window_all(k_c, flat_c), iters=5),
        "plain_median_round_ms": device_ms(lambda: plain_all(k_c, flat_c), iters=2),
    }
    (path["bytes"], path["rank_compares"], path["bound_ms"], path["bound_by"]) = bound(
        LARGE_COHORT, FULL_D)
    path["bound_share"] = path["bound_ms"] / path["k1_median_round_ms"]
    large["path_c100"] = path
    del stack_c, flat_c

    def launch_host_us(C, calls=200):
        """Host microseconds a call of the wrapper takes to enqueue its
        launch (fewer calls than the launch queue holds, timed before the
        card is waited for): the register kernel sets nothing up, the
        select kernel's setup is worked out on its first call and kept."""
        xs = torch.randn(C, 128, generator=gen, device="cuda")
        k = rs.median_trim_k(C)
        rs.trimmed_mean_1d(xs, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            rs.trimmed_mean_1d(xs, k)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host_s / calls * 1e6

    large["launch_host_us"] = {f"C={c}": launch_host_us(c) for c in (COHORT, LARGE_COHORT)}
    log(json.dumps({
        "k1_timing_ms": t, "C": COHORT, "D": D, "bytes": nbytes, "rank_compares": ops,
        "bound_ms": bound_ms, "bound_by": bound_by,
        # a round's 8 leaves read and write the same bytes as one flat launch
        "bound_share": {key: bound_ms / t[key] for key in
                        ("k1_median_round", "k1_trimmed_round", "k1_median_flat", "k1_trimmed_flat")},
        "large_c": large,
        # the register kernel; the select kernel on its warps' shared-memory
        # tiles (opted in above 48 KB), 1 warp a block at C = 1000, and with
        # the columns read from device memory at C = 2000
        "kernel_info": {f"C={c}": rs.kernel_info(c) for c in (COHORT, 33, LARGE_COHORT,
                                                              LARGE_C, 455, 1000, 2000)},
        "rates": f"{card} data sheet: {bw / 1e12} TB/s",
        "card": smi,
        "notes": "torch.median is the lower median at even C (not the same function); "
                 "quantile(midpoint) and sort+window are the same function",
    }))
    return t, bound_ms, bound_by, large


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
    """RobustFedAvgAPI on the north-star config; returns the K1 launches
    and each defense's warm round times (rounds after the first)."""
    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import RobustConfig

    runs = (("median", MEDIAN_ROUNDS, {}), ("trimmed_mean", TRIMMED_ROUNDS, {"num_byzantine": 1}))
    launches_per_run, warm_round_s = {}, {}
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
        warm_round_s[defense] = [row["round_time_s"] for row in rows[1:]]
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
    log(json.dumps({"main_path_k1_launches": launches, "per_run": launches_per_run,
                    "warm_round_s": warm_round_s}))
    return launches, warm_round_s


def phase_large_cohort(device="cuda", num_clients=128, per_round=LARGE_COHORT):
    """RobustFedAvgAPI median on the north-star CNN with 100 clients a
    round, 1 round: K1 on a cohort above the register kernel's (its
    select kernel, the columns in opted-in shared memory). Returns the
    launches."""
    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import RobustConfig

    cfg, data, model = _north_star(1, num_clients, per_round)
    api = RobustFedAvgAPI(cfg, data, model, robust=RobustConfig(defense_type="median"),
                          device=device)
    rs.LAUNCHES[rs.KERNEL_NAME] = 0  # zeroed just before
    t0 = time.perf_counter()
    api.train()
    wall_s = time.perf_counter() - t0
    launches = rs.LAUNCHES[rs.KERNEL_NAME]  # read just after
    row = api.history[-1]
    if not all(math.isfinite(row[k]) for k in ("Train/Loss", "Test/Loss")):
        raise AssertionError(f"large cohort: non-finite loss in {row}")
    want = 8 if device == "cuda" else 0
    if launches != want:
        raise AssertionError(f"large cohort: {launches} K1 launches, want {want}")
    log(json.dumps({"large_cohort": {"clients_per_round": per_round, "k1_launches": launches,
                                     "round_s": wall_s, "row": row}}))
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# ---------------------------------------------------------------- K2-K4


def _flash_case(fa, gen, device, BH, S, Sk, d, dtype, causal):
    """Kernels (through the wrappers) and plain versions on the same
    inputs; returns {what: (kernel, plain)}. The plain versions run at the
    kernels' own tiles (KERNEL_TILE rows, clamped to S)."""
    import torch

    q = torch.randn(BH, S, d, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(BH, Sk, d, generator=gen, device=device).to(dtype) for _ in range(2))
    do = torch.randn(BH, S, d, generator=gen, device=device).to(dtype)
    scale, bq, bk = d**-0.5, min(fa.KERNEL_TILE, S), min(fa.KERNEL_TILE, Sk)
    o, lse = fa.flash_forward(q, k, v, scale, causal, bq, bk)
    po, plse = fa.flash_forward_plain(q, k, v, scale, causal, bq, bk)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal, bq, bk)
    dq, pdq = fa.flash_backward_dq(*args), fa.flash_backward_dq_plain(*args)
    (dk, dv), (pdk, pdv) = fa.flash_backward_dkv(*args), fa.flash_backward_dkv_plain(*args)
    return {"O": (o, po), "LSE": (lse, plse), "dQ": (dq, pdq), "dK": (dk, pdk), "dV": (dv, pdv)}


def _flash_check(got, want, dtype_name, what) -> tuple:
    """|got - want| against rtol·|want| + atol·max|want| (FLASH_TOL):
    (the max |got - want|, the largest share of the bound it takes, and
    None, or what broke the bound)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    rtol, atol = FLASH_TOL["float32" if want.dtype == torch.float32 else dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = rtol * w.abs() + atol * w.abs().max()
    broken = None
    if not torch.isfinite(g).all() or (err > bound).any():
        broken = (f"{what}: max |err| {err.max().item()} above rtol {rtol}, "
                  f"atol {atol}·max|ref| ({w.abs().max().item()})")
    return err.max().item(), (err / bound.clamp_min(1e-30)).max().item(), broken


def phase_flash_parity(device="cuda", s_grid=FLASH_S_GRID, d_grid=FLASH_D_GRID, flagship=True):
    """K2/K3/K4 against their plain versions; returns {kernel: max |err|}."""
    import torch

    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(2)
    cases = [(FLASH_BH, S, S, d, dt, causal) for S in s_grid for d in d_grid
             for dt in (torch.float32, torch.bfloat16) for causal in (False, True)]
    cases.append((FLASH_BH, 128, 192, 64, torch.bfloat16, False))  # Sk != S
    cases += [(FLASH_BH, S, Sk, d, dt, causal) for S, Sk, d, causal in FLASH_WIDE_CASES
              for dt in (torch.float32, torch.bfloat16)]
    if flagship:  # the LM path's shapes (phase 9, and phase_lm_wide's), in both legs' types
        cases += [(LM["batch"] * heads, LM["seq"], LM["seq"], LM["width"] // heads, dt, True)
                  for heads in (LM["heads"], LM_WIDE["heads"])
                  for dt in (torch.bfloat16, torch.float32)]
    owner = {"O": fa.FWD, "LSE": fa.FWD, "dQ": fa.BWD_DQ, "dK": fa.BWD_DKV, "dV": fa.BWD_DKV}
    errs = {name: 0.0 for name in fa.KERNEL_NAMES}
    by_output = {what: 0.0 for what in owner}
    share = {}  # the largest share of the bound, by type and by the LM's own cases
    share_by_output = {}  # ... by type and head dim, then by output
    broken = []
    with fp32_math():
        for BH, S, Sk, d, dt, causal in cases:
            out = _flash_case(fa, gen, device, BH, S, Sk, d, dt, causal)
            dt_name = str(dt).split(".")[-1]
            for what, (got, want) in out.items():
                e, sh, bad = _flash_check(got, want, dt_name,
                                          f"{what} BH={BH} S={S} Sk={Sk} d={d} {dt_name} "
                                          f"causal={causal}")
                broken += [bad] if bad else []
                errs[owner[what]] = max(errs[owner[what]], e)
                by_output[what] = max(by_output[what], e)
                outs = share_by_output.setdefault(f"{dt_name}_d{d}", {})
                outs[what] = max(outs.get(what, 0.0), sh)
                lm = {LM["batch"] * LM["heads"]: "lm", LM["batch"] * LM_WIDE["heads"]: "lm_wide"}
                for key in (dt_name, f"{lm[BH]}_{dt_name}" if BH in lm else None,
                            f"wide_{dt_name}_d{d}" if d > max(fa.HEAD_DIMS) else None):
                    if key:
                        share[key] = max(share.get(key, 0.0), sh)
    if device == "cuda":
        torch.cuda.synchronize()
    log(json.dumps({"flash_parity": {"cases": len(cases), "max_abs_err": errs,
                                     "max_abs_err_by_output": by_output,
                                     "max_share_of_bound": share,
                                     "max_share_of_bound_by_output": share_by_output,
                                     "tolerance": {k: list(v) for k, v in FLASH_TOL.items()},
                                     "broken": broken}}))
    if broken:  # after the log, which shows every case's share
        raise AssertionError(f"{len(broken)} outputs outside FLASH_TOL: {broken}")
    return errs


def phase_flash_timing(name: str, smi: str):
    """K2/K3/K4 at the LM's attention shapes (q, k, v [256, 256, 96] bf16,
    causal) beside their plain versions, their bounds and SDPA on the same
    tensors as [32, 8, 256, 96]."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import flash_attention as fa

    card, (bw, _, bf16_peak, _) = card_rates(name)
    B, H, S, d = LM["batch"], LM["heads"], LM["seq"], LM["width"] // LM["heads"]
    BH, scale, blk = B * H, d**-0.5, fa.KERNEL_TILE
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(BH, S, d, generator=gen, device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, scale, True, blk, blk)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bwd = (q, k, v, do, lse, delta, scale, True, blk, blk)
    before = dict(fa.LAUNCHES)
    t = {
        fa.FWD: device_ms(lambda: fa.flash_forward(q, k, v, scale, True, blk, blk)),
        fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq(*bwd)),
        fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv(*bwd)),
    }
    # the same shapes unmasked: every block visits all the key tiles, so the
    # per-block prologue and epilogue weigh less than under the causal mask
    k2_full = device_ms(lambda: fa.flash_forward(q, k, v, scale, False, blk, blk))
    fa.LAUNCHES.update(before)  # timing launches are not the main path's
    plain = {
        fa.FWD: device_ms(lambda: fa.flash_forward_plain(q, k, v, scale, True, blk, blk), iters=5),
        fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq_plain(*bwd), iters=5),
        fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv_plain(*bwd), iters=5),
    }
    qs, ks, vs = (x.view(B, H, S, d).detach().clone().requires_grad_(True) for x in (q, k, v))
    dos = do.view(B, H, S, d)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(out, (qs, ks, vs), dos)

    sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    sdpa_fwd_full = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
    sdpa_bwd = device_ms(sdpa_fwd_bwd) - sdpa_fwd
    # the function's work: each input read once, each output written once;
    # matmul FLOPs over the S(S+1)/2 causal (query, key) pairs
    tensor, row = BH * S * d * 2, BH * S * 4
    pairs = BH * S * (S + 1) // 2
    work = {
        fa.FWD: (4 * tensor + row, 4 * d * pairs),              # q k v -> o, lse
        fa.BWD_DQ: (5 * tensor + 2 * row, 6 * d * pairs),       # q k v do lse delta -> dq
        fa.BWD_DKV: (6 * tensor + 2 * row, 8 * d * pairs),      # ... -> dk dv
    }
    bounds = {}
    for kname, (nbytes, flops) in work.items():
        tb, tf = nbytes / bw * 1e3, flops / bf16_peak * 1e3
        bounds[kname] = (max(tb, tf), "bytes" if tb >= tf else "operations", nbytes, flops)
    library = {fa.FWD: sdpa_fwd, fa.BWD_DQ: sdpa_bwd, fa.BWD_DKV: sdpa_bwd}
    info = {kn: fa.kernel_info(kn, torch.bfloat16, d) for kn in fa.KERNEL_NAMES}
    f32 = _flash_timing_f32(fa, q, k, v, do, scale, blk, work, bw)
    log(json.dumps({
        "flash_timing_ms": {kn: {"kernel": t[kn], "plain": plain[kn], "bound": bounds[kn][0],
                                 "bound_by": bounds[kn][1], "bytes": bounds[kn][2],
                                 "flops": bounds[kn][3], "library": library[kn],
                                 "tflops": bounds[kn][3] / t[kn] / 1e9,
                                 "bound_share": bounds[kn][0] / t[kn], **info[kn]}
                            for kn in fa.KERNEL_NAMES},
        "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
        "k2_over_sdpa_fwd": t[fa.FWD] / sdpa_fwd,
        "not_causal_ms": {"k2": k2_full, "sdpa_fwd": sdpa_fwd_full,
                          "k2_over_sdpa_fwd": k2_full / sdpa_fwd_full},
        "k3_plus_k4_over_sdpa_bwd": (t[fa.BWD_DQ] + t[fa.BWD_DKV]) / sdpa_bwd,
        "float32": f32,
        "shape": {"B": B, "H": H, "S": S, "d": d, "dtype": "bfloat16", "causal": True},
        "rates": f"{card} data sheet: {bw / 1e12} TB/s, {bf16_peak / 1e12} TFLOP/s dense bf16",
        "card": smi,
        "notes": "library = F.scaled_dot_product_attention(is_causal=True); its backward "
                 "(forward+backward minus forward) computes dQ, dK and dV together, so it is "
                 "the yardstick of K3 and K4 together; tflops = the causal half's matmul "
                 "FLOPs over the kernel's time; registers, local_bytes (spills), smem_bytes "
                 "and blocks_per_sm from the CUDA runtime for the bfloat16 kernels",
    }))
    wide = _flash_timing_wide(name, smi)
    return t, plain, bounds, library, f32, wide


def _sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these causal
    inputs (flash, efficient, cuDNN or math)."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name
    except (ImportError, AttributeError, RuntimeError, ValueError) as e:
        return f"not read ({type(e).__name__}: {e})"


def _kernel_facts(fa, kname, dt, d) -> dict:
    """The CUDA function kernel ``kname`` launches for (dt, d), its launch
    configuration and what the compiler made of it (``fa.kernel_info``),
    and the warps one SM holds at once."""
    info = fa.kernel_info(kname, dt, d)
    return {**info, "warps_per_sm": info["threads"] // 32 * info["blocks_per_sm"]}


def _flash_timing_wide(name: str, smi: str) -> dict:
    """K2/K3/K4 at a head dim above 128 (FLASH_WIDE_TIMING: [256, 256, 256]
    causal: the chunked kernels, two 128-wide chunks of the output's head
    dim, and for float32 K3/K4 the cluster kernels), bfloat16 and float32
    (TF32 off). Each is held to its plain version on the timed inputs
    (FLASH_TOL; its largest share logged) and timed beside it, its bound
    (bf16: bytes or FLOPs at the bf16 peak; float32: bytes or three TF32
    products a product, by the LM shape's rules), SDPA (the backend it
    used) and the kernel's CUDA function, registers, local memory, shared
    memory, and blocks and warps an SM."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.ops import flash_attention as fa

    card, (bw, _, bf16_peak, tf32_peak) = card_rates(name)
    B, H, S, d = (FLASH_WIDE_TIMING[k] for k in ("B", "H", "S", "d"))
    BH, scale, blk = B * H, d**-0.5, fa.KERNEL_TILE
    gen = torch.Generator(device="cuda").manual_seed(4)
    base = [torch.randn(BH, S, d, generator=gen, device="cuda") for _ in range(4)]
    before = dict(fa.LAUNCHES)
    pairs = BH * S * (S + 1) // 2
    out = {"shape": {"B": B, "H": H, "S": S, "d": d, "causal": True}, "card": smi}
    for dt in (torch.bfloat16, torch.float32):
        dt_name = str(dt).split(".")[-1]
        q, k, v, do = (x.to(dt) for x in base)
        esize = q.element_size()
        tensor, row = BH * S * d * esize, BH * S * 4
        work = {fa.FWD: (4 * tensor + row, 4 * d * pairs),
                fa.BWD_DQ: (5 * tensor + 2 * row, 6 * d * pairs),
                fa.BWD_DKV: (6 * tensor + 2 * row, 8 * d * pairs)}
        with fp32_math():
            o, lse = fa.flash_forward(q, k, v, scale, True, blk, blk)
            bwd = (q, k, v, do, lse, torch.sum(do.float() * o.float(), dim=-1), scale, True,
                   blk, blk)
            t = {fa.FWD: device_ms(lambda: fa.flash_forward(q, k, v, scale, True, blk, blk)),
                 fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq(*bwd)),
                 fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv(*bwd))}
            plain = {
                fa.FWD: device_ms(lambda: fa.flash_forward_plain(q, k, v, scale, True, blk, blk),
                                  iters=5),
                fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq_plain(*bwd), iters=5),
                fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv_plain(*bwd), iters=5),
            }
            # the timed kernels against their plain versions on these inputs
            held = {fa.FWD: zip(("O", "LSE"), (o, lse),
                                fa.flash_forward_plain(q, k, v, scale, True, blk, blk)),
                    fa.BWD_DQ: [("dQ", fa.flash_backward_dq(*bwd),
                                 fa.flash_backward_dq_plain(*bwd))],
                    fa.BWD_DKV: zip(("dK", "dV"), fa.flash_backward_dkv(*bwd),
                                    fa.flash_backward_dkv_plain(*bwd))}
            share = {}
            for kname, outs in held.items():
                for what, got, want in outs:
                    _, sh, bad = _flash_check(got, want, dt_name,
                                              f"{what} {dt_name} at FLASH_WIDE_TIMING")
                    if bad:
                        raise AssertionError(bad)
                    share[kname] = max(share.get(kname, 0.0), sh)
            qs, ks, vs = (x.view(B, H, S, d).detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            dos = do.view(B, H, S, d)

            def sdpa_fwd_bwd():
                res = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
                torch.autograd.grad(res, (qs, ks, vs), dos)

            sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                         is_causal=True))
            sdpa_bwd = device_ms(sdpa_fwd_bwd) - sdpa_fwd
            backend = _sdpa_backend(qs, ks, vs)
        rows = {}
        for kname, (nbytes, flops) in work.items():
            tb = nbytes / bw * 1e3
            tf = (flops / bf16_peak if dt == torch.bfloat16 else 3 * flops / tf32_peak) * 1e3
            rows[kname] = {"kernel": t[kname], "plain": plain[kname], "bound": max(tb, tf),
                           "bound_by": "bytes" if tb >= tf else "operations", "bytes": nbytes,
                           "flops": flops, "bound_share": max(tb, tf) / t[kname],
                           "max_share_of_tol": share[kname],
                           "library": sdpa_fwd if kname == fa.FWD else sdpa_bwd,
                           **_kernel_facts(fa, kname, dt, d)}
        rows["sdpa_fwd_ms"], rows["sdpa_bwd_ms"], rows["sdpa_backend"] = sdpa_fwd, sdpa_bwd, backend
        rows["k3_plus_k4_over_sdpa_bwd"] = (t[fa.BWD_DQ] + t[fa.BWD_DKV]) / sdpa_bwd
        out[dt_name] = rows
    fa.LAUNCHES.update(before)  # timing launches are not a path's
    out["rates"] = (f"{card} data sheet: {bw / 1e12} TB/s, {bf16_peak / 1e12} TFLOP/s dense bf16, "
                    f"{tf32_peak / 1e12} TF32")
    log(json.dumps({"flash_timing_d256_ms": out}))
    return out


def _flash_timing_f32(fa, q, k, v, do, scale, blk, work, bw) -> dict:
    """The float32 K2/K3/K4 (on split-TF32 tensor cores; the flagship LM's
    eval forward and the LM path's float32 leg launch them) at the same
    shape beside float32 SDPA, forward and backward, all with TF32 off.
    Bounds: the same work at 4 bytes an element over the card's rate, or
    its FLOPs three times over (a float32 product at float32 accuracy is
    three TF32 products) at the dense TF32 peak, whichever is longer.
    {kernel: {kernel, plain, bound, bound_by, bytes, flops, sdpa_fwd,
    sdpa_bwd, registers, local_bytes, smem_bytes, blocks_per_sm}, and
    k3_plus_k4_over_sdpa_bwd}."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.device import fp32_math

    _, (*_, tf32_peak) = card_rates(torch.cuda.get_device_name(0))
    B, H, S, d = LM["batch"], LM["heads"], LM["seq"], LM["width"] // LM["heads"]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    before = dict(fa.LAUNCHES)
    with fp32_math():
        of, lsef = fa.flash_forward(qf, kf, vf, scale, True, blk, blk)
        bwd = (qf, kf, vf, dof, lsef, torch.sum(dof * of, dim=-1), scale, True, blk, blk)
        t = {
            fa.FWD: device_ms(lambda: fa.flash_forward(qf, kf, vf, scale, True, blk, blk)),
            fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq(*bwd)),
            fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv(*bwd)),
        }
        plain = {
            fa.FWD: device_ms(lambda: fa.flash_forward_plain(qf, kf, vf, scale, True, blk, blk),
                              iters=5),
            fa.BWD_DQ: device_ms(lambda: fa.flash_backward_dq_plain(*bwd), iters=5),
            fa.BWD_DKV: device_ms(lambda: fa.flash_backward_dkv_plain(*bwd), iters=5),
        }
        qs, ks, vs = (x.view(B, H, S, d).detach().clone().requires_grad_(True)
                      for x in (qf, kf, vf))
        dos = dof.view(B, H, S, d)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            torch.autograd.grad(out, (qs, ks, vs), dos)

        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        sdpa_bwd = device_ms(sdpa_fwd_bwd) - sdpa_fwd
    fa.LAUNCHES.update(before)  # timing launches are not a path's
    # each input read once, each output written once, at 4 bytes an element
    tensor, row = B * H * S * d * 4, B * H * S * 4
    nbytes_of = {fa.FWD: 4 * tensor + row, fa.BWD_DQ: 5 * tensor + 2 * row,
                 fa.BWD_DKV: 6 * tensor + 2 * row}
    out = {}
    for kname, (_, flops) in work.items():
        nbytes = nbytes_of[kname]
        tb, tf = nbytes / bw * 1e3, 3 * flops / tf32_peak * 1e3
        info = fa.kernel_info(kname, torch.float32, d)
        out[kname] = {"kernel": t[kname], "plain": plain[kname], "bound": max(tb, tf),
                      "bound_by": "bytes" if tb >= tf else "operations", "bytes": nbytes,
                      "flops": flops, "bound_share": max(tb, tf) / t[kname],
                      "sdpa_fwd": sdpa_fwd, "sdpa_bwd": sdpa_bwd,
                      "registers": info["registers"], "local_bytes": info["local_bytes"],
                      "smem_bytes": info["smem_bytes"], "blocks_per_sm": info["blocks_per_sm"]}
    out["k3_plus_k4_over_sdpa_bwd"] = (t[fa.BWD_DQ] + t[fa.BWD_DKV]) / sdpa_bwd
    return out


def _cuobjdump():
    """The toolkit's cuobjdump, or the copy Triton ships; None if neither."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("cuobjdump")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "cuobjdump"))
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.access(c, os.X_OK)), None)


def sass_counts(sass: str) -> dict:
    """{kernel<type, D>: {opcode: count}} of the flash kernels in a
    ``cuobjdump -sass`` listing: HMMA (mma.sync tensor-core products), HGMMA
    (wgmma warpgroup products), FFMA (float32 FMA), LDSM (ldmatrix), LDL/STL
    (local memory: spills)."""
    counts, label = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : \S*?(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_wide|_cluster)?"
                         r"(?:_tc|_f32tc)?_kernel)"
                         r"I(\w*?)Li(\d+)E", line)
        if head:
            kern, typ, d = head.groups()
            label = f"{kern}<{'float' if typ == 'f' or '_f32tc' in kern else 'bf16'}, {d}>"
            counts[label] = {op: 0 for op in ("HMMA", "HGMMA", "FFMA", "LDSM", "LDL", "STL")}
            continue
        if "Function : " in line:
            label = None
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if label and op and op.group(1) in counts[label]:
            counts[label][op.group(1)] += 1
    return counts


def phase_sass():
    """Disassemble the built flash library; raise unless every K2/K3/K4
    instantiation, bfloat16 and float32 (split TF32), the chunked ones for
    head dims above 128 included, holds tensor-core instructions (HMMA or
    HGMMA), the float32 cluster kernels (K3, K4 up to d = 1024) both their
    wgmma score products (HGMMA) and their mma.sync output products
    (HMMA), none spills to local memory, and no float32 CUDA-core (SIMT)
    flash kernel is left."""
    from fedml_tpu_torch.ops import flash_attention as fa

    tool = _cuobjdump()
    if tool is None:
        log("[sass] cuobjdump not available")
        return
    listing = subprocess.run([tool, "-sass", fa._lib()._name], capture_output=True, text=True,
                             timeout=300, check=True).stdout
    counts = sass_counts(listing)
    tc = {k: v for k, v in counts.items() if "_tc_kernel<bf16" in k}
    log(json.dumps({"sass": counts, "tool": tool}))
    # every built head dim, and the chunked kernel of each of K2, K3, K4
    want = 3 * len(fa.HEAD_DIMS) + 3
    if len(tc) != want or any(v["HMMA"] + v["HGMMA"] == 0 for v in tc.values()):
        raise AssertionError(f"bf16 K2/K3/K4 instantiations without tensor cores: {tc}")
    f32 = {k: v for k, v in counts.items() if "_f32tc_kernel<float" in k}
    cluster = {k: v for k, v in f32.items() if "_cluster_" in k}
    if (len(f32) != want + 2 or any(v["HMMA"] + v["HGMMA"] == 0 for v in f32.values())
            or len(cluster) != 2 or any(v["HGMMA"] == 0 or v["HMMA"] == 0
                                        for v in cluster.values())):
        raise AssertionError(f"float32 K2/K3/K4 instantiations without tensor cores, or "
                             f"cluster kernels without HGMMA and HMMA: {f32}")
    spills = {k: v for k, v in cluster.items() if v["LDL"] or v["STL"]}
    if spills:
        raise AssertionError(f"float32 cluster kernels spill to local memory: {spills}")
    simt = [k for k in counts if "_tc_kernel<" not in k and "_f32tc_kernel<" not in k]
    if simt:
        raise AssertionError(f"float32 CUDA-core flash kernels left: {simt}")


# ---------------------------------------------------------------- the LM path


def _flagship_lm(rounds: int, layers: int = LM["layers"], compute_dtype: str = "bfloat16",
                 optimizer: str = "adam", attn_fn=None, **smaller):
    """The flagship LM row (bench.py _flagship_lm_row) with flash attention
    (``attn_fn`` None; else that attention); ``smaller`` overrides LM's
    entries for a rehearsal on the CPU or a leg at another depth."""
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig
    from fedml_tpu_torch.data.synthetic import synthetic_shakespeare
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bthd

    lm = {**LM, **smaller}
    data = synthetic_shakespeare(num_clients=lm["clients"], samples_per_client=lm["samples"],
                                 seq_len=lm["seq"], vocab_size=lm["vocab"], seed=0,
                                 seq_targets=True)
    model = create_model("transformer", "shakespeare_synth", (lm["seq"],), lm["vocab"],
                         num_layers=layers, num_heads=lm["heads"], embed_dim=lm["width"],
                         attn_fn=attn_fn or flash_attention_bthd)
    cfg = RunConfig(
        data=DataConfig(batch_size=lm["batch"], pad_bucket=1),
        fed=FedConfig(client_num_in_total=lm["clients"], client_num_per_round=lm["clients"],
                      comm_round=rounds, epochs=1, frequency_of_the_test=10_000,
                      client_parallelism="scan"),
        train=TrainConfig(client_optimizer=optimizer, lr=lm["lr"], compute_dtype=compute_dtype),
        seed=0,
    )
    return cfg, data, model


def expected_flash_launches(api, layers: int) -> dict:
    """K2/K3/K4 launches of ``api.train()`` from the rounds' cohorts on the
    host: one launch per layer of each kernel for every local step that
    holds data — ceil(n / batch) a client of n samples an epoch, since the
    shuffle puts the valid samples first and all-padding steps are skipped
    — and one K2 per layer for every eval batch."""
    from fedml_tpu_torch.ops import flash_attention as fa

    cfg = api.config
    B, steps = cfg.data.batch_size, 0
    for r in range(cfg.fed.comm_round):
        counts = api.data.train_sample_counts[api.scheduler.select(r)]
        steps += sum(-(-int(n) // B) for n in counts) * cfg.fed.epochs
    evals = sum(api._is_eval_round(r) for r in range(cfg.fed.comm_round))
    eval_batches = evals * api._eval_batches()[0].shape[0]
    return {fa.FWD: layers * (steps + eval_batches), fa.BWD_DQ: layers * steps,
            fa.BWD_DKV: layers * steps, "steps": steps, "eval_batches": eval_batches}


def _lm_head_dim(smaller: dict) -> int:
    return smaller.get("width", LM["width"]) // smaller.get("heads", LM["heads"])


def _lm_launch_key(fa, dtype: str, head_dim: int) -> str:
    """The launch key an LM of ``head_dim`` counts its flash kernels under."""
    return fa.CHUNKED[dtype] if head_dim > max(fa.HEAD_DIMS) else dtype


def phase_lm_path(device="cuda", rounds=LM_ROUNDS, layers=LM["layers"], **smaller):
    """FedAvgAPI(task="nwp") on the flagship LM with flash attention;
    returns the K2/K3/K4 launches of the run."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.ops import flash_attention as fa

    cfg, data, model = _flagship_lm(rounds, layers, **smaller)
    head_dim = _lm_head_dim(smaller)
    tag = "[lm]" if head_dim == LM["width"] // LM["heads"] else f"[lm d={head_dim}]"
    api = FedAvgAPI(cfg, data, model, task="nwp", device=None if device == "cuda" else device,
                    log_fn=lambda row: log(f"{tag} " + json.dumps(row)))
    want = expected_flash_launches(api, layers)
    fa.reset_launches()  # zeroed just before the main path
    api.train()
    by_key = dict(fa.LAUNCHES)  # read just after
    launches = fa.launch_totals()
    rows = api.history
    for row in rows:
        for key in ("Train/Loss", "Train/Acc"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"LM: non-finite {key} in {row}")
    for key in ("Test/Loss", "Test/Acc"):
        if not all(math.isfinite(r[key]) for r in rows if key in r):
            raise AssertionError(f"LM: non-finite {key}")
    if not rows[-1]["Train/Loss"] < rows[0]["Train/Loss"]:
        raise AssertionError(f"LM: Train/Loss did not fall: {[r['Train/Loss'] for r in rows]}")
    # bf16 steps; the eval forward runs float32
    keys = [_lm_launch_key(fa, t, head_dim) for t in fa.OPERAND_TYPES]
    for name in fa.KERNEL_NAMES:
        expect = want[name] if device == "cuda" else 0
        got = sum(by_key[(name, k)] for k in keys)
        if got != expect or launches[name] != expect:
            raise AssertionError(f"LM: {got} {name} launches under {keys} "
                                 f"({launches[name]} in all), want {expect}")
    log(json.dumps({"lm_path": {"head_dim": head_dim, "launches": launches, "expected": want,
                                "round_time_s": [r["round_time_s"] for r in rows],
                                "train_loss": [r["Train/Loss"] for r in rows]}}))
    return launches


def phase_lm_wide(device="cuda") -> dict:
    """The LM path's two legs at head dim 256 (LM_WIDE): FedAvgAPI(task=
    "nwp") through the chunked K2/K3/K4, their launches counted under
    fa.CHUNKED's keys, zeroed just before each leg and read just after.
    Returns {type: the chunked kernels' launches of that type by kernel}."""
    from fedml_tpu_torch.ops import flash_attention as fa

    sizes = {k: v for k, v in LM_WIDE.items() if k != "layers"}
    phase_lm_path(device, 2, LM_WIDE["layers"], **sizes)
    bf16_leg = dict(fa.LAUNCHES)  # its api.train() launched last, after the counts were zeroed
    f32_leg = phase_lm_float32(device, LM_WIDE["layers"], **sizes)
    return {"bfloat16": {n: bf16_leg[(n, fa.CHUNKED["bfloat16"])] for n in fa.KERNEL_NAMES},
            # the float32 leg's, and the bf16 leg's float32 eval forward
            "float32": {n: f32_leg[n] + bf16_leg[(n, fa.CHUNKED["float32"])]
                        for n in fa.KERNEL_NAMES}}


def _tf32(x):
    """x rounded to TF32 as the kernels round their hi (to nearest on the
    int32 view)."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(x.dtype)


@contextlib.contextmanager
def _lm_f32_fault(fa, kind: str):
    """Plant a fault in the float32 K3/K4 the LM's backward calls: "dq_zero"
    zeroes K3's dQ; "inputs_tf32" hands K3 and K4 their Q, K, V and dO
    rounded to TF32 (a single TF32 product where the kernels take three, for
    S, dO·Vᵀ and the K, Q, dO operands). The kernels still launch."""
    dq, dkv = fa.flash_backward_dq, fa.flash_backward_dkv
    if kind == "dq_zero":
        fa.flash_backward_dq = lambda *a: dq(*a).zero_()
    elif kind == "inputs_tf32":
        fa.flash_backward_dq = lambda *a: dq(*map(_tf32, a[:4]), *a[4:])
        fa.flash_backward_dkv = lambda *a: dkv(*map(_tf32, a[:4]), *a[4:])
    try:
        yield
    finally:
        fa.flash_backward_dq, fa.flash_backward_dkv = dq, dkv


def _update_err(got: dict, want: dict, init: dict) -> dict:
    """A round's update Δ = vars − init against another's (``want``), by
    tensor: max |Δgot − Δwant| less LM_F32_ULPS units 2⁻²³·max|vars| (the
    rounding of storing the params), over max |Δwant|. {"rel": the worst
    tensor's, "tensor", "max_abs_err", "max_update"}."""
    worst = (-1.0, "")
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        floor = LM_F32_ULPS * 2.0**-23 * want[k].abs().max().item()
        size = max((want[k] - init[k]).abs().max().item(), 1e-30)
        worst = max(worst, (max(err - floor, 0.0) / size, k))
    return {"rel": worst[0], "tensor": worst[1],
            "max_abs_err": max((got[k] - want[k]).abs().max().item() for k in want),
            "max_update": max((want[k] - init[k]).abs().max().item() for k in want)}


def phase_lm_float32(device="cuda", layers=LM_F32["layers"], **smaller):
    """The float32 leg of the LM path (see LM_F32): one round with flash
    attention, its K2/K3/K4 launches under "float32" (above head dim 128
    the chunked kernels' key) zeroed just before and read just after; then the same round on ``causal_full_attention``, all
    under ``fp32_math()``. The rounds' updates (vars − init) must agree
    tensor by tensor as LM_F32_VS_FULL says (:func:`_update_err`); each
    fault of LM_F32_FAULTS planted in a flash round must break that bound.
    Returns the float32 launches by kernel."""
    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.models.transformer import causal_full_attention
    from fedml_tpu_torch.ops import flash_attention as fa

    sizes = {**{k: v for k, v in LM_F32.items() if k != "layers"}, **smaller}
    runs = [("flash", None, None), ("full", causal_full_attention, None)]
    runs += [(f"fault_{f}", None, f) for f in LM_F32_FAULTS]
    out = {}
    for run, attn_fn, fault in runs:
        cfg, data, model = _flagship_lm(1, layers, compute_dtype="float32", optimizer="sgd",
                                        attn_fn=attn_fn, **sizes)
        api = FedAvgAPI(cfg, data, model, task="nwp",
                        device=None if device == "cuda" else device)
        init = {k: v.detach().cpu().clone() for k, v in api.global_vars.items()}
        want = expected_flash_launches(api, layers)
        with fp32_math(), (_lm_f32_fault(fa, fault) if fault else contextlib.nullcontext()):
            fa.reset_launches()  # zeroed just before the leg
            t0 = time.perf_counter()
            api.train()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)  # read just after
        out[run] = {"init": init, "vars": {k: v.detach().cpu() for k, v in api.global_vars.items()},
                    "rows": api.history, "wall_s": wall, "want": want, "launches": launches}
    flash, full = out["flash"], out["full"]
    for row in flash["rows"]:
        for key in ("Train/Loss", "Test/Loss"):
            if key in row and not math.isfinite(row[key]):
                raise AssertionError(f"LM float32: non-finite {key} in {row}")
    head_dim = _lm_head_dim(sizes)
    key = _lm_launch_key(fa, "float32", head_dim)
    for run in (r for r in out if r != "full"):  # the faulted runs go through the kernels too
        for name in fa.KERNEL_NAMES:
            got = out[run]["launches"][(name, key)]
            other = sum(n for (kn, t), n in out[run]["launches"].items()
                        if kn == name and t != key)
            expect = out[run]["want"][name] if device == "cuda" else 0
            if got != expect or other != 0:
                raise AssertionError(f"LM float32 ({run}): {got} {name} launches under {key} "
                                     f"(+{other} under other keys), want {expect}")
    init = full["init"]
    if any(not torch.equal(out[r]["init"][k], init[k]) for r in out for k in init):
        raise AssertionError("LM float32: the runs start apart")
    errs = {r: _update_err(out[r]["vars"], full["vars"], init) for r in out if r != "full"}
    launches = {name: flash["launches"][(name, key)] for name in fa.KERNEL_NAMES}
    log(json.dumps({"lm_float32": {"head_dim": head_dim,
        "launches": launches, "expected": flash["want"], "update_vs_full": errs,
        "tolerance_rel": LM_F32_VS_FULL, "ulps": LM_F32_ULPS,
        "train_loss": {r: out[r]["rows"][-1]["Train/Loss"] for r in out},
        "round_s": {r: out[r]["wall_s"] for r in out}, "layers": layers, **sizes}}))
    if not errs["flash"]["rel"] <= LM_F32_VS_FULL:
        raise AssertionError(f"LM float32 flash vs full: {errs['flash']['tensor']}'s update "
                             f"off by {errs['flash']['rel']} of its max, above {LM_F32_VS_FULL}")
    for f in LM_F32_FAULTS:
        if not errs[f"fault_{f}"]["rel"] > LM_F32_VS_FULL:
            raise AssertionError(f"LM float32: the planted fault {f} passes the bound "
                                 f"({errs[f'fault_{f}']['rel']} <= {LM_F32_VS_FULL})")
    return launches


def phase_profile_lm_round():
    """Where a warm LM round's time goes: round 1 under torch.profiler
    after round 0; device kernel time by name against the round's wall.
    The profiler traces the device only: collecting the host-side events
    of the round's ~200k launches took over two minutes of the script."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.algorithms import FedAvgAPI

    cfg, data, model = _flagship_lm(2)
    api = FedAvgAPI(cfg, data, model, task="nwp", device="cuda")
    api.train_round(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.train_round(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    flash = {"fwd": "flash_fwd", "bwd_dq": "flash_bwd_dq", "bwd_dkv": "flash_bwd_dkv"}
    log(json.dumps({"profile_lm_round": {
        "wall_ms_profiled": wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_ms": dev_ms if kernels else "not measured",
        "device_busy_share": dev_ms / wall_ms if kernels else "not measured",
        "flash_kernels_ms_calls": {
            short: [sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3,
                    sum(e.count for e in kernels if key in e.key)]
            for short, key in flash.items()
        },
        "top_kernels_ms_calls": {e.key[:70]: [e.self_device_time_total / 1e3, e.count] for e in top},
    }}))


def _small_lm(device):
    """A CPU-sized LM round: 2 layers, 128 wide (head dim 64), windows of
    64, 4 clients, batch 16, float32 SGD lr 0.1, flash attention."""
    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig
    from fedml_tpu_torch.data.synthetic import synthetic_shakespeare
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bthd

    data = synthetic_shakespeare(num_clients=4, samples_per_client=32, seq_len=64,
                                 vocab_size=LM["vocab"], seed=0, seq_targets=True)
    model = create_model("transformer", "shakespeare_synth", (64,), LM["vocab"], num_layers=2,
                         num_heads=2, embed_dim=128, attn_fn=flash_attention_bthd)
    cfg = RunConfig(data=DataConfig(batch_size=16),
                    fed=FedConfig(client_num_in_total=4, client_num_per_round=4, comm_round=1,
                                  epochs=1),
                    train=TrainConfig(lr=0.1), seed=0)
    return FedAvgAPI(cfg, data, model, task="nwp", device=device)


def phase_lm_card_vs_cpu():
    """One small LM round on the card and on the CPU from the same init
    with the same shuffles (see LM_CARD_VS_CPU)."""
    import torch

    rtol, atol = LM_CARD_VS_CPU
    out = {}
    for device in ("cpu", "cuda"):
        api = _small_lm(device)
        t0 = time.perf_counter()
        api.train()
        out[device] = ({k: v.cpu() for k, v in api.global_vars.items()}, time.perf_counter() - t0,
                       api.history[-1]["Train/Loss"])
    (cpu, cpu_s, cpu_loss), (card, card_s, card_loss) = out["cpu"], out["cuda"]
    err = max((card[k] - cpu[k]).abs().max().item() for k in cpu)
    log(json.dumps({"lm_card_vs_cpu": {"max_abs_err": err, "rtol": rtol, "atol": atol,
                                       "train_loss": [cpu_loss, card_loss],
                                       "cpu_round_s": cpu_s, "cuda_round_s": card_s}}))
    for k in cpu:
        torch.testing.assert_close(card[k], cpu[k], rtol=rtol, atol=atol, msg=lambda m: f"{k}: {m}")


# ---------------------------------------------------------------- the transport


def _transport_report(fed, rounds: int, wall_s: float) -> dict:
    """Warm round time (broadcast, local training, uploads and aggregate;
    no eval), wire bytes and host seconds a round of a finished federation,
    from its history, the port's CommMeter and the spans of the process
    tracer (reset before the run)."""
    from fedml_tpu_torch.core.message import MessageType as MT
    from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer

    snap = get_comm_meter().snapshot()
    sent = snap["bytes_sent"]
    spans, eval_s = {}, {}
    for ev in get_tracer().events():
        spans[ev.name] = spans.get(ev.name, 0.0) + ev.dur_us / 1e6
        if ev.name == "eval":
            eval_s[ev.attrs["round"]] = ev.dur_us / 1e6
    # a history row's t_s is taken after the round's aggregate and before its
    # eval, so the span between the last two rows holds the eval of the one
    # before: take it out, as the simulator's round_time_s leaves eval out
    t_s = [row["t_s"] for row in fed.history]
    return {
        "rounds": rounds,
        "wall_s": wall_s,
        "warm_round_s": t_s[-1] - t_s[-2] - eval_s.get(rounds - 2, 0.0) if rounds > 1 else None,
        "round_t_s": t_s,
        "wire_bytes_up_per_round": sent.get(MT.C2S_SEND_MODEL, 0) / rounds,
        "wire_bytes_down_per_round": (sent.get(MT.S2C_INIT_CONFIG, 0)
                                      + sent.get(MT.S2C_SYNC_MODEL, 0)) / rounds,
        # the model payloads as shipped, without the envelopes' trace stamps
        # and beacons (whose JSON carries clock times and so varies in length)
        "payload_bytes": {"up": snap["uplink_payload_bytes"], "down": snap["downlink_payload_bytes"]},
        "messages_sent": snap["messages_sent"],
        "host_s_per_round": {name: spans.get(name, 0.0) / rounds for name in
                             ("to_bytes", "from_bytes", "local_train", "broadcast", "aggregate",
                              "eval", "mask")},
        "notes": "to_bytes/from_bytes: every message's encode and decode; local_train sums the "
                 "client actors' concurrent spans; broadcast holds the server's to_bytes",
    }


def _traced_federation(run, *args, **kw):
    """``run(*args, **kw)`` with the comm meter and tracer reset before;
    returns (server, report)."""
    from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer

    get_comm_meter().reset()
    get_tracer().reset()
    t0 = time.perf_counter()
    fed = run(*args, **kw)
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return fed, _transport_report(fed, len(fed.history), time.perf_counter() - t0)


def phase_mqtt(cnn, loop, loop_report, dev) -> dict:
    """The CNN's FedAdam federation of ``phase_transport`` over MQTT: the
    embedded broker, then TCP to the port's MiniMqttBroker on 127.0.0.1.
    Each must be bit-equal to the loopback run ``loop`` and ship the same
    model payloads in the same messages. Returns their reports."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg_transport import run_mqtt_federation
    from fedml_tpu_torch.core.mqtt_broker import MiniMqttBroker

    report = {}
    broker = MiniMqttBroker()
    try:
        for name, kw in (("cnn_mqtt_embedded", {}),
                         ("cnn_mqtt_tcp", {"host": "127.0.0.1", "port": broker.port})):
            fed, report[name] = _traced_federation(
                run_mqtt_federation, *cnn(TRANSPORT_ROUNDS), server_opt=True, device=dev, **kw)
            for k in loop.global_vars:
                if not torch.equal(fed.global_vars[k].cpu(), loop.global_vars[k].cpu()):
                    raise AssertionError(f"{name} differs from the loopback federation at {k}")
            if fed.train_losses != loop.train_losses:
                raise AssertionError(f"{name}: train losses {fed.train_losses} != loopback's")
            for key in ("payload_bytes", "messages_sent"):
                if report[name][key] != loop_report[key]:
                    raise AssertionError(f"{name}: {key} {report[name][key]} != loopback's "
                                         f"{loop_report[key]}")
            report[name]["vs_loopback"] = "bit-equal, same payload bytes and messages"
    finally:
        broker.close()
    return report


def expected_transport_flash_launches(cfg, data, layers: int) -> dict:
    """K2/K3/K4 launches of a transport federation: each sampled client's
    local steps that hold data (ceil(n / batch) an epoch), and one K2 a
    layer for each batch of 256 the server evaluates."""
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.scheduler import ClientScheduler

    fed, B = cfg.fed, cfg.data.batch_size
    sched = ClientScheduler.from_config(cfg, num_clients=fed.client_num_in_total)
    steps = sum(-(-int(data.train_sample_counts[c]) // B) * fed.epochs
                for r in range(fed.comm_round) for c in sched.select(r))
    evals = sum(r % fed.frequency_of_the_test == 0 or r == fed.comm_round - 1
                for r in range(fed.comm_round))
    eval_batches = evals * -(-len(data.test_y) // 256)
    return {fa.FWD: layers * (steps + eval_batches), fa.BWD_DQ: layers * steps,
            fa.BWD_DKV: layers * steps, "steps": steps, "eval_batches": eval_batches}


def phase_transport(smi: str, device="cuda", num_clients=128, per_round=COHORT,
                    lm_layers=LM["layers"], **lm_smaller):
    """The cross-silo transport on the north-star CNN and the flagship LM
    (see the module docstring, phase 12); returns the LM run's K2/K3/K4
    launches. ``device="cpu"`` with smaller sizes rehearses it."""
    import torch

    from fedml_tpu_torch.algorithms import FedOptAPI
    from fedml_tpu_torch.algorithms.fedavg_transport import (
        actor_order_perm_fn, run_loopback_federation, run_shm_federation,
    )
    from fedml_tpu_torch.config import ServerConfig
    from fedml_tpu_torch.ops import flash_attention as fa

    dev = None if device == "cuda" else device
    server = ServerConfig(server_optimizer="adam", server_lr=0.05)

    def cnn(rounds):
        cfg, data, model = _north_star(rounds, num_clients, per_round)
        return cfg.replace(server=server), data, model

    def host(vars_):
        return {k: v.cpu() for k, v in vars_.items()}

    report = {}
    # cuDNN's deterministic algorithms for the CNN runs, so that the same
    # steps on the same batches give the same bits in either runtime
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        # 1. FedAdam at batch 20: the simulator, trained on the actors'
        # minibatches, against the loopback federation
        cfg, data, model = cnn(TRANSPORT_ROUNDS)
        t0 = time.perf_counter()
        sim = FedOptAPI(cfg, data, model, device=dev, perm_fn=actor_order_perm_fn(cfg, data))
        sim.train()
        report["cnn_sim"] = {
            "rounds": TRANSPORT_ROUNDS, "wall_s": time.perf_counter() - t0,
            "warm_round_s": sim.history[-1]["round_time_s"],
            "round_time_s": [r["round_time_s"] for r in sim.history]}
        fed, report["cnn_loopback"] = _traced_federation(
            run_loopback_federation, *cnn(TRANSPORT_ROUNDS), server_opt=True, device=dev)
        for row, loss in zip(fed.history, fed.train_losses, strict=True):
            if not (math.isfinite(loss) and math.isfinite(row.get("Test/Loss", 0.0))):
                raise AssertionError(f"transport CNN: non-finite loss in {row}, train {loss}")
        rtol, atol = TRANSPORT_SIM_TOL
        want, got = host(sim.global_vars), host(fed.global_vars)
        err = max((got[k] - want[k]).abs().max().item() for k in want)
        report["cnn_sim_vs_loopback"] = {"max_abs_err": err, "rtol": rtol, "atol": atol}
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol,
                                       msg=lambda m: f"sim vs loopback {k}: {m}")
        # the same federation over MQTT, embedded and over TCP
        report.update(phase_mqtt(cnn, fed, report["cnn_loopback"], dev))
        # one round over shared memory, bit-equal to one over loopback
        loop, _ = _traced_federation(run_loopback_federation, *cnn(1), server_opt=True,
                                     device=dev)
        shm, report["cnn_shm"] = _traced_federation(run_shm_federation, *cnn(1),
                                                    server_opt=True, device=dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    a, b = host(loop.global_vars), host(shm.global_vars)
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("shm round differs from the loopback round")
    report["cnn_shm_vs_loopback"] = "bit-equal"

    # 2. the flagship LM over loopback, K2-K4 in the client actors
    cfg, data, model = _flagship_lm(TRANSPORT_ROUNDS, lm_layers, **lm_smaller)
    want = expected_transport_flash_launches(cfg, data, lm_layers)
    fa.reset_launches()  # zeroed just before the transport's LM run
    fed, report["lm_loopback"] = _traced_federation(
        run_loopback_federation, cfg, data, model, task="nwp", device=dev,
        log_fn=lambda row: log("[transport:lm] " + json.dumps(row)))
    launches = fa.launch_totals()  # read just after
    losses = fed.train_losses
    if not all(x is not None and math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"transport LM: Train/Loss not finite and falling: {losses}")
    for name in fa.KERNEL_NAMES:
        expect = want[name] if device == "cuda" else 0
        if launches[name] != expect:
            raise AssertionError(f"transport LM: {launches[name]} {name} launches, want {expect}")
    report["lm_loopback"].update(launches=launches, expected=want, train_loss=losses)
    report["warm_round_s"] = {name: report[name]["warm_round_s"] for name in
                              ("cnn_loopback", "cnn_mqtt_embedded", "cnn_mqtt_tcp", "lm_loopback")}
    report["warm_round_s"]["cnn_sim"] = report["cnn_sim"]["warm_round_s"]
    report["grpc"] = ("not run on the card: its machine has no grpcio; held on the CPU in "
                      "tests/test_torch_grpc.py")
    log("[transport] " + json.dumps({**report, "device": device, "card": smi}))
    return launches


def phase_faults_secagg(smi: str, device="cuda", num_clients=128, per_round=COHORT) -> dict:
    """The north-star CNN over loopback (FedAvg, cuDNN deterministic):

    1. with secure aggregation, 2 rounds, against the same 2 rounds plain,
       within SECAGG_TOL; one full-batch step a client, since a batch-20
       round is chaotic enough to blow the 2^-16 grid's error up past it;
       the masking (key agreement and masks, summed over the client actors)
       and unmasking (the server's secure aggregate) host seconds a round;
    2. at the north star's batch 20 under a scripted plan that drops the
       first client of each round's cohort, with a deadline and
       min_clients = 9: every round closes on 9 uploads, the faults/*
       counters are exact and the losses finite."""
    import dataclasses

    import torch

    from fedml_tpu_torch.algorithms.fedavg_transport import run_loopback_federation
    from fedml_tpu_torch.scheduler import ClientScheduler
    from fedml_tpu_torch.telemetry import get_tracer

    dev = None if device == "cuda" else device
    report = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for secure in (False, True):
            cfg, data, model = _north_star(SECAGG_ROUNDS, num_clients, per_round)
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=-1),
                              comm=dataclasses.replace(cfg.comm, secure_agg=secure))
            name = "secure" if secure else "plain"
            runs[name], report[name] = _traced_federation(run_loopback_federation, cfg, data,
                                                          model, device=dev)
        rtol, atol = SECAGG_TOL
        want, got = runs["plain"].global_vars, runs["secure"].global_vars
        err = max((got[k] - want[k]).abs().max().item() for k in want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=atol,
                                       msg=lambda m: f"secure vs plain {k}: {m}")
        sec = report["secure"]["host_s_per_round"]
        report["secure_vs_plain"] = {"max_abs_err": err, "rtol": rtol, "atol": atol,
                                     "mask_s_per_round": sec["mask"],
                                     "unmask_s_per_round": sec["aggregate"]}

        cfg, data, model = _north_star(FAULT_ROUNDS, num_clients, per_round)
        sched = ClientScheduler.from_config(cfg, num_clients=num_clients)
        dropped = {int(sched.select(r)[0]): r for r in range(FAULT_ROUNDS)}
        if len(dropped) != FAULT_ROUNDS:
            raise AssertionError(f"a client is first in two rounds' cohorts: {dropped}")
        plan = {"scripted": {str(c): {str(r): {"drop": True}} for c, r in dropped.items()}}
        cfg = cfg.replace(fed=dataclasses.replace(
            cfg.fed, deadline_s=FAULT_DEADLINE_S, min_clients=per_round - 1,
            fault_plan=json.dumps(plan)))
        rows = []
        fed, report["faults"] = _traced_federation(run_loopback_federation, cfg, data, model,
                                                   device=dev, log_fn=rows.append)
        uploads = [ev.attrs["n_uploads"] for ev in get_tracer().events() if ev.name == "aggregate"]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    if uploads != [per_round - 1] * FAULT_ROUNDS:
        raise AssertionError(f"faults: rounds closed on {uploads} uploads, want {per_round - 1}")
    faults = rows[-1]
    want_row = {"faults/dropouts": FAULT_ROUNDS, "faults/total": FAULT_ROUNDS,
                "faults/crashes": 0, "faults/slowdowns": 0, "faults/flaky_uploads": 0}
    if {k: faults.get(k) for k in want_row} != want_row:
        raise AssertionError(f"faults: counters {faults}, want {want_row}")
    if not all(x is not None and math.isfinite(x) for x in fed.train_losses) or not all(
            math.isfinite(r["Test/Loss"]) for r in fed.history if "Test/Loss" in r):
        raise AssertionError(f"faults: non-finite loss {fed.train_losses} {fed.history}")
    report["faults"].update(uploads_per_round=uploads, counters=faults,
                            dropped_uploads=fed.dropped_uploads, train_loss=fed.train_losses)
    log("[faults_secagg] " + json.dumps({**report, "device": device, "card": smi}))
    return report


def _cli_argv(log_dir, checkpoint_path, rounds: int, num_clients: int, per_round: int,
              *extra) -> list:
    """python -m fedml_tpu_torch's options for the north-star robust run."""
    return ["--algorithm", "fedavg_robust", "--defense", "median", "--model", "cnn",
            "--dataset", "femnist_synth", "--client_num_in_total", str(num_clients),
            "--client_num_per_round", str(per_round), "--batch_size", "20", "--epochs", "1",
            "--lr", "0.1", "--comm_round", str(rounds), "--log_dir", str(log_dir),
            "--checkpoint_path", str(checkpoint_path), *extra]


def _rows(log_dir) -> list:
    """The round rows of a run's metrics.jsonl."""
    lines = (Path(log_dir) / "metrics.jsonl").read_text().splitlines()
    return [row for row in map(json.loads, lines) if "Test/Acc" in row or "Train/Loss" in row]


def phase_cli(smi: str, main_warm_s=None, device="cuda", num_clients=128,
              per_round=COHORT) -> dict:
    """python -m fedml_tpu_torch, the port's command line (phase 14):

    1. the north-star robust run (median, 2 rounds) as a subprocess: exit
       0, the final row as JSON on its last line, summary.json and the
       checkpoint written, Test/Acc above chance;
    2. in process through ``cli.main``, with cuDNN's deterministic
       algorithms: 4 rounds straight, then 2 rounds and ``--resume`` to 4
       from their checkpoint; the resumed rows of rounds 2-3 and final
       vars bit-equal to the straight run's, and each call launching K1
       exactly 8 times a round (the count zeroed just before each call and
       read just after); the straight run's rows and final vars bit-equal
       to phase 4's RobustFedAvgAPI built without the CLI for the same 4
       rounds, so the entry point's defaults drive the same computation;
    3. a FedAdam loopback federation through the CLI (server lr 0.05, the
       same cohort, batch 20, 2 rounds), its losses finite.

    Prints the ``[cli]`` line: each run's warm round time beside phase 4's,
    a checkpoint write's seconds and registry.load's for femnist_synth.
    ``device="cpu"`` rehearses it (step 1 in process, no K1 launches).
    Returns the K1 launches of step 2's calls."""
    import tempfile

    import torch

    from fedml_tpu_torch import cli
    from fedml_tpu_torch.algorithms import RobustFedAvgAPI
    from fedml_tpu_torch.data import registry
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import RobustConfig
    from fedml_tpu_torch.utils import save_checkpoint

    per_round_k1 = 8 if device == "cuda" else 0
    report = {}
    with tempfile.TemporaryDirectory(prefix="fedml_cli_") as tmp:
        tmp = Path(tmp)
        argv = _cli_argv(tmp / "logs", tmp / "ck", 2, num_clients, per_round)
        t0 = time.perf_counter()
        if device == "cuda":
            out = subprocess.run([sys.executable, "-m", "fedml_tpu_torch", *argv],
                                 cwd=Path(__file__).resolve().parent, capture_output=True,
                                 text=True, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"python -m fedml_tpu_torch exited {out.returncode}: "
                                     f"{out.stderr[-3000:]}")
            final = json.loads(out.stdout.strip().splitlines()[-1])
        else:
            cli.main(argv, device=device)
            final = _rows(tmp / "logs")[-1]
        report["subprocess_s"] = time.perf_counter() - t0
        if not ((tmp / "logs" / "summary.json").is_file() and (tmp / "ck.npz").is_file()):
            raise AssertionError("python -m fedml_tpu_torch left no summary.json or ck.npz")
        if not final.get("Test/Acc", 0.0) > 1.0 / 62:
            raise AssertionError(f"python -m fedml_tpu_torch: Test/Acc not above chance: {final}")
        report["subprocess_final_row"] = final

        dev = None if device == "cuda" else device
        launches, apis = {}, {}
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            for name, rounds, ck, extra in (("straight", 4, "ck_straight", ()),
                                            ("first_2", 2, "ck_resume", ()),
                                            ("resumed", 4, "ck_resume", ("--resume",))):
                args = _cli_argv(tmp / name, tmp / ck, rounds, num_clients, per_round, *extra)
                rs.LAUNCHES[rs.KERNEL_NAME] = 0  # zeroed just before the call
                apis[name] = cli.main(args, device=dev)
                launches[name] = rs.LAUNCHES[rs.KERNEL_NAME]  # read just after
                want = per_round_k1 * (2 if name == "resumed" else rounds)
                if launches[name] != want:
                    raise AssertionError(f"cli {name}: {launches[name]} K1 launches, want {want}")
            # phase 4's run, built without the CLI, for the same 4 rounds
            cfg, data, model = _north_star(4, num_clients, per_round)
            robust = RobustConfig(defense_type="median")
            apis["api"] = RobustFedAvgAPI(cfg, data, model, robust=robust, device=dev)
            apis["api"].train()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        strip = lambda row: {k: v for k, v in row.items() if k != "round_time_s"}  # noqa: E731
        straight, resumed, direct = apis["straight"], apis["resumed"], apis["api"]
        # the entry point drives the computation phase 4 drives: its
        # defaults build the north-star config, data, model and seed
        if [strip(r) for r in straight.history] != [strip(r) for r in direct.history]:
            raise AssertionError(f"cli: straight rows {straight.history} != RobustFedAvgAPI "
                                 f"rows {direct.history}")
        for k, v in direct.global_vars.items():
            if not torch.equal(straight.global_vars[k], v):
                raise AssertionError(f"cli: straight vars differ from RobustFedAvgAPI's at {k}")
        report["cli_vs_api"] = "rows and final vars of 4 rounds bit-equal to RobustFedAvgAPI's"
        if [strip(r) for r in resumed.history] != [strip(r) for r in straight.history[2:]]:
            raise AssertionError(f"cli: resumed rows {resumed.history} != straight rows "
                                 f"{straight.history[2:]}")
        for k, v in straight.global_vars.items():
            if not torch.equal(resumed.global_vars[k], v):
                raise AssertionError(f"cli: resumed vars differ from the straight run's at {k}")
        report["resume"] = "rows of rounds 2-3 and final vars bit-equal to 4 straight rounds"
        report["k1_launches"] = launches

        t0 = time.perf_counter()
        cli.main(["--algorithm", "fedopt", "--server_optimizer", "adam", "--server_lr", "0.05",
                  "--runtime", "loopback", "--model", "cnn", "--dataset", "femnist_synth",
                  "--client_num_in_total", str(num_clients), "--client_num_per_round",
                  str(per_round), "--batch_size", "20", "--lr", "0.1", "--comm_round", "2",
                  "--log_dir", str(tmp / "loopback")], device=dev)
        loop_s = time.perf_counter() - t0
        loop_rows = _rows(tmp / "loopback")
        if len(loop_rows) != 2 or not all(math.isfinite(r["Test/Loss"]) for r in loop_rows):
            raise AssertionError(f"cli loopback: rows {loop_rows}")

        cfg = straight.config
        save_s = []
        for i in range(3):
            t0 = time.perf_counter()
            save_checkpoint(str(tmp / f"timed_{i}"), straight.global_vars, round_idx=4,
                            sched_state=straight.scheduler.state_dict())
            save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        registry.load(cfg)
        load_s = time.perf_counter() - t0
        ck_bytes = (tmp / "timed_0.npz").stat().st_size

    report.update({
        "warm_round_s": {
            "cli_straight": [r["round_time_s"] for r in straight.history[1:]],
            "cli_resumed": [r["round_time_s"] for r in resumed.history],
            "phase4_median_api": main_warm_s,
            "cli_loopback_fedadam": loop_rows[1]["t_s"] - loop_rows[0]["t_s"],
        },
        "notes": "cli_loopback_fedadam is t_s of round 1 less round 0's: it holds round 0's "
                 "eval; the other round times leave eval out",
        "loopback_rows": loop_rows,
        "loopback_wall_s": loop_s,
        "checkpoint_write_s": save_s,
        "checkpoint_bytes": ck_bytes,
        "registry_load_femnist_synth_s": load_s,
        "registry_clients": num_clients,
        "device": device,
        "card": smi,
    })
    log("[cli] " + json.dumps(report))
    return launches


# ------------------------------------------------------- the CIFAR family


@functools.lru_cache(maxsize=2)
def _cifar_geometry(clients: int, classes: int, samples: int):
    from fedml_tpu_torch.data.synthetic import synthetic_classification

    return synthetic_classification(num_clients=clients, num_classes=classes,
                                    feat_shape=RESNET["shape"], samples_per_client=samples,
                                    partition_method="homo", ragged=False, seed=0)


def _cross_silo(rounds: int, dtype: str = "float32", clients: int = RESNET["clients"],
                per_round=None, samples: int = RESNET["samples"], batch: int = RESNET["batch"],
                model: str = "resnet56", classes: int = RESNET["classes"], pad_bucket=None):
    """The cross-silo row (bench.py:617-690): synthetic CIFAR-geometry data,
    ``clients`` silos of ``samples`` each, all in every round, batch 64,
    E=1, SGD lr 0.1, ``dtype`` compute, eval left out of the rounds."""
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig
    from fedml_tpu_torch.models import create_model

    data = _cifar_geometry(clients, classes, samples)
    dkw = {} if pad_bucket is None else {"pad_bucket": pad_bucket}
    cfg = RunConfig(
        data=DataConfig(batch_size=batch, **dkw),
        fed=FedConfig(client_num_in_total=clients, client_num_per_round=per_round or clients,
                      comm_round=rounds, epochs=1, frequency_of_the_test=10_000),
        train=TrainConfig(client_optimizer="sgd", lr=RESNET["lr"], compute_dtype=dtype),
        model=model,
        seed=0,
    )
    return cfg, data, create_model(model, "cifar10", RESNET["shape"], classes)


def _profile_round(api, round_idx: int) -> dict:
    """One warm round under torch.profiler, tracing the device only (the
    host-side events of ~300k launches would cost minutes to collect):
    device kernel time against the round's wall time, launches, the top
    kernels, and the round's train loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, mets = api.train_round(round_idx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "train_loss": float(mets["loss_sum"]) / float(mets["count"]),
        "wall_ms_profiled": wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "top_kernels_ms_calls": {e.key[:70]: [e.self_device_time_total / 1e3, e.count] for e in top},
    }


def _timed_rounds(api, rounds) -> tuple:
    """(train losses, seconds) of ``api.train_round`` over ``rounds``; each
    round's loss comes to the host, which waits for the device."""
    losses, secs = [], []
    for r in rounds:
        t0 = time.perf_counter()
        _, mets = api.train_round(r)
        losses.append(float(mets["loss_sum"]) / float(mets["count"]))
        secs.append(time.perf_counter() - t0)
    return losses, secs


def phase_resnet(smi: str, device="cuda", rounds=RESNET_ROUNDS, **smaller) -> int:
    """The CIFAR model family on the cross-silo ResNet-56 row (phase 15);
    returns K1's launches in the robust ResNet-56 run. ``smaller`` cuts
    the data and the ResNet-18-GN cell for a rehearsal on the CPU
    (``clients``, ``samples``, ``gn_clients``, ``gn_samples``,
    ``cpu_clients``)."""
    import dataclasses

    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI, RobustFedAvgAPI
    from fedml_tpu_torch.algorithms.fedavg import make_fedavg_round
    from fedml_tpu_torch.algorithms.fedavg_robust import make_defense_hooks
    from fedml_tpu_torch.models import create_model, split_stats
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.robustness import RobustConfig

    data_kw = {k: smaller[k] for k in ("clients", "samples") if k in smaller}
    report = {"device": device, "card": smi}

    # 1. FedAvgAPI, fp32 then bf16: 3 rounds each without eval (as the
    # bench row times them), round 0 the warm-up; on the card, bf16's round
    # 2 under the profiler (the row's headline dtype; collecting a
    # profile of ~300k launches takes ~50 s, so one)
    for dtype in ("float32", "bfloat16"):
        cfg, data, model = _cross_silo(rounds, dtype, **data_kw)
        api = FedAvgAPI(cfg, data, model, device=device)
        profiled = device == "cuda" and rounds > 2 and dtype == "bfloat16"
        losses, secs = _timed_rounds(api, range(rounds - 1 if profiled else rounds))
        if profiled:
            prof = _profile_round(api, rounds - 1)
            losses.append(prof.pop("train_loss"))
            # busy share also against the unprofiled warm round
            prof["device_busy_share_of_round_1"] = prof["device_kernel_ms"] / (secs[1] * 1e3)
            report[f"profile_{dtype}_round_2"] = prof
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"resnet56 {dtype}: train loss {losses}")
        report[f"{dtype}_train_loss"] = losses
        report[f"{dtype}_round_s"] = secs
    params, stats = split_stats(api.global_vars)
    report["params_stats"] = [sum(v.numel() for v in params.values()),
                              sum(v.numel() for v in stats.values())]
    if report["params_stats"] != [591_322, 8_992]:
        raise AssertionError(f"resnet56 has {report['params_stats']} params and stats")

    # 3. RobustFedAvgAPI median, 2 rounds: K1 over every parameter leaf (the
    # statistics take the sample-weighted mean, as the reference's
    # _byzantine_reduce gives them); the last round's aggregate held
    # bit-equal to K1's plain version on the same stack
    class Captured(RobustFedAvgAPI):
        def _build_round_fn(self, local_train_fn):
            post_train, _, aggregate = make_defense_hooks(self.robust)

            def capture(cv, ns, g=None):
                self.stack = ({k: v.clone() for k, v in cv.items()}, ns.clone())
                return aggregate(cv, ns, g)

            return make_fedavg_round(self.model, self.config, task=self.task,
                                     local_train_fn=local_train_fn, post_train=post_train,
                                     aggregate_fn=capture)

    cfg, data, model = _cross_silo(2, **data_kw)
    robust = Captured(cfg, data, model, robust=RobustConfig(defense_type="median"), device=device)
    leaves = len(split_stats(robust.global_vars)[0])
    rs.LAUNCHES[rs.KERNEL_NAME] = 0  # zeroed just before
    robust.train()
    launches = rs.LAUNCHES[rs.KERNEL_NAME]  # read just after
    for row in robust.history:
        if not all(math.isfinite(row[k]) for k in ("Train/Loss", "Test/Loss")):
            raise AssertionError(f"resnet56 median: non-finite loss in {row}")
    want = 2 * leaves if device == "cuda" else 0
    if launches != want:
        raise AssertionError(f"resnet56 median: {launches} K1 launches, want {want}")
    stack, ns = robust.stack
    C = ns.shape[0]
    for k, v in stack.items():
        if k.startswith("batch_stats."):
            plain = torch.tensordot(ns / torch.clamp(ns.sum(), min=1e-12), v.float(), dims=1)
        else:
            plain = rs.trimmed_mean_plain(v.float().reshape(C, -1), rs.median_trim_k(C)).reshape(v.shape[1:])
        if not torch.equal(robust.global_vars[k], plain):
            err = (robust.global_vars[k] - plain).abs().max().item()
            raise AssertionError(f"resnet56 median: {k} differs from the plain aggregate by {err}")
    report["median"] = {"k1_launches": launches, "k1_launches_per_round": launches // 2,
                        "param_leaves": leaves, "stat_leaves": len(stack) - leaves,
                        "warm_round_s": [r["round_time_s"] for r in robust.history[1:]],
                        "bit_equal_to_plain": True}
    if device == "cuda":
        report["median"]["k1_ms_a_round"] = device_ms(
            lambda: [rs.median_1d(v.reshape(C, -1)) for k, v in stack.items()
                     if not k.startswith("batch_stats.")], iters=10)
        rs.LAUNCHES[rs.KERNEL_NAME] = launches  # the timing's launches do not count

    # 4. one fp32 round on the card against the CPU, TF32 off, cuDNN
    # deterministic: one full-batch step a client (RESNET_CARD_VS_CPU)
    if device == "cuda":
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            out = {}
            per = smaller.get("cpu_clients", RESNET_CPU_CLIENTS)
            for dev in ("cpu", "cuda"):
                cfg, data, model = _cross_silo(1, per_round=per, batch=-1, **data_kw)
                api = FedAvgAPI(cfg, data, model, device=dev)
                t0 = time.perf_counter()
                api.train_round(0)
                out[dev] = ({k: v.cpu() for k, v in api.global_vars.items()}, time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        (cpu, cpu_s), (card, card_s) = out["cpu"], out["cuda"]
        errs = {"params": 0.0, "stats": 0.0}
        for k in cpu:
            kind = "stats" if k.startswith("batch_stats.") else "params"
            errs[kind] = max(errs[kind], (card[k] - cpu[k]).abs().max().item())
            rtol, atol = RESNET_CARD_VS_CPU[kind]
            torch.testing.assert_close(card[k], cpu[k], rtol=rtol, atol=atol,
                                       msg=lambda m, k=k: f"resnet56 card vs cpu, {k}: {m}")
        report["card_vs_cpu"] = {"clients": per, "max_abs_err": errs, "tol": RESNET_CARD_VS_CPU,
                                 "cpu_round_s": cpu_s, "cuda_round_s": card_s}

    # 5. the trained fixture: eval logits on the card against the CPU's,
    # and its test accuracy on the row's data (at the row's size: the test
    # set is drawn after the clients' shards)
    cfg, data, _ = _cross_silo(1)
    fixture = create_model("resnet56", "cifar10", RESNET["shape"], RESNET["classes"],
                           pretrained=RESNET_FIXTURE)
    fvars = fixture.init(torch.Generator())
    x = torch.from_numpy(data.test_x[:8])
    from fedml_tpu_torch.device import fp32_math

    with torch.no_grad(), fp32_math():
        cpu_logits = fixture.apply(fvars, x, train=False)[0]
        card_logits = fixture.apply({k: v.to(device) for k, v in fvars.items()}, x.to(device),
                                    train=False)[0].cpu()
    ferr = (card_logits - cpu_logits).abs().max().item()
    scale = cpu_logits.abs().max().item()
    if ferr > RESNET_FIXTURE_TOL * max(1.0, scale):
        raise AssertionError(f"fixture logits: card vs cpu max |err| {ferr} at scale {scale}")
    fapi = FedAvgAPI(cfg, data, fixture, device=device)
    _, facc = fapi.evaluate_global()
    if facc != 1.0:
        raise AssertionError(f"fixture Test/Acc {facc} on its own data, want 1.0")
    report["fixture"] = {"max_abs_err": ferr, "logit_scale": scale, "tol": RESNET_FIXTURE_TOL,
                         "test_acc": facc}

    # 6. ResNet-18-GN in bf16 (bench.py:931-938): a warm-up round and a
    # warm one, without eval, as the bench row times them. (Its eval after
    # a round at lr 0.1 gives NaN in both packages: E[x²]−E[x]² of a group
    # of a zero-padded eval row cancels below −eps.)
    gn = dict(clients=smaller.get("gn_clients", RESNET_GN["clients"]),
              samples=smaller.get("gn_samples", RESNET_GN["samples"]))
    cfg, data, model = _cross_silo(2, "bfloat16", model="resnet18_gn", classes=RESNET_GN["classes"],
                                   batch=RESNET_GN["batch"], pad_bucket=1, **gn)
    gapi = FedAvgAPI(cfg, data, model, device=device)
    gn_s, gn_loss = [], []
    for r in range(2):
        t0 = time.perf_counter()
        _, mets = gapi.train_round(r)
        gn_loss.append(float(mets["loss_sum"]) / float(mets["count"]))  # waits for the device
        gn_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in gn_loss):
        raise AssertionError(f"resnet18_gn bf16: train loss {gn_loss}")
    report["resnet18_gn_bf16"] = {"params": model.num_params(), "round_s": gn_s,
                                  "train_loss": gn_loss}
    log("[resnet] " + json.dumps(report))
    return launches


# ---------------------------------------------------------------- phase 16

# the defended and private rounds on the north star (phase_defenses)
ATTACK_BOOST = 10.0
KRUM_M = 3
DP_SECRET = (1 << 100) + 12345  # explicit, so the cohorts can be checked
DP_ROUNDS = 3
# the update clip S: noise z·S/m̂ = 0.01 a coordinate at z = 1, m̂ = 10 (at
# S = 1 the 0.1 a coordinate on the CNN's 1.69M weights sends the next
# round's loss to NaN, in the reference as in the port: tests/dp_clip_probe.py)
DP_CLIP = 0.1
POC_ROUNDS = 3
POC_OVERPROVISION = 1.4
POC_PLAN = {"seed": 7, "default": {"dropout_p": 0.2}}
WEAK_DP_NOISE_SEED = 5


def _with_fed(cfg, **fed):
    import dataclasses

    return cfg.replace(fed=dataclasses.replace(cfg.fed, **fed))


def _full_batch(cfg):
    import dataclasses

    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=-1))


def _finite_rows(rows, what):
    for row in rows:
        for key in ("Train/Loss", "Test/Loss"):
            if key in row and not math.isfinite(row[key]):
                raise AssertionError(f"{what}: non-finite {key} in {row}")


def _capturing(api_cls, hooks):
    """``api_cls`` whose round keeps the stack its aggregate is given
    (``self.stack``); ``hooks(api)`` gives the API's hook triple."""
    from fedml_tpu_torch.algorithms.fedavg import make_fedavg_round

    class Captured(api_cls):
        def _build_round_fn(self, local_train_fn):
            post_train, post_aggregate, aggregate = hooks(self)

            def capture(cv, ns, g=None):
                self.stack = {k: v.clone() for k, v in cv.items()}
                return aggregate(cv, ns, g)

            return make_fedavg_round(self.model, self.config, task=self.task,
                                     local_train_fn=local_train_fn, post_train=post_train,
                                     post_aggregate=post_aggregate, aggregate_fn=capture)

    return Captured


def phase_defenses(smi: str, device="cuda", num_clients=128, per_round=COHORT) -> int:
    """The defended and private rounds on the north star (phase 16);
    returns K1's launches in the attacked median and trimmed-mean runs."""
    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI, RobustFedAvgAPI
    from fedml_tpu_torch.algorithms.fedavg import seeded_noise_fn
    from fedml_tpu_torch.algorithms.fedavg_robust import make_defense_hooks
    from fedml_tpu_torch.data.edge_cases import PoisonSpec, attack_success_rate, poison_clients
    from fedml_tpu_torch.ops import robust_stats as rs
    from fedml_tpu_torch.privacy import DpConfig, DPFedAvgAPI, RdpAccountant
    from fedml_tpu_torch.privacy.dp_fedavg import poisson_client_sampling
    from fedml_tpu_torch.robustness import RobustConfig, krum_aggregate, krum_scores, krum_select
    from fedml_tpu_torch.robustness.backdoor import (
        AttackConfig, BackdoorFedAvgAPI, make_attack_hooks,
    )
    from fedml_tpu_torch.scheduler import ClientScheduler, FaultPlan, select_clients

    on_card = device == "cuda"
    cfg0, data, model = _north_star(1, num_clients, per_round)
    report = {"device": device, "card": smi}
    round_s = lambda api: [r["round_time_s"] for r in api.history]  # noqa: E731

    # (a) the backdoor harness: one attacker of round 0's cohort, boost γ;
    # K1 once a weight leaf a round, the last aggregate bit-equal to K1's
    # plain version on the round's boosted stack
    attacker = int(select_clients(0, num_clients, per_round)[0])
    spec = PoisonSpec()
    poisoned = poison_clients(data, [attacker], spec, seed=0)
    attack = AttackConfig(attacker_ids=(attacker,), boost=ATTACK_BOOST)
    Backdoor = _capturing(BackdoorFedAvgAPI, lambda api: make_attack_hooks(api.robust, api.attack))
    launches, report["backdoor"] = 0, {"attacker": attacker, "boost": ATTACK_BOOST}
    for defense, rounds, trim_k in (("median", 2, None), ("trimmed_mean", 1, 1)):
        api = Backdoor(_with_fed(cfg0, comm_round=rounds), poisoned, model, attack=attack,
                       robust=RobustConfig(defense_type=defense, num_byzantine=1), device=device)
        rs.LAUNCHES[rs.KERNEL_NAME] = 0  # zeroed just before
        api.train()
        n = rs.LAUNCHES[rs.KERNEL_NAME]  # read just after
        if n != (8 * rounds if on_card else 0):
            raise AssertionError(f"backdoor {defense}: {n} K1 launches, want {8 * rounds}")
        launches += n
        _finite_rows(api.history, f"backdoor {defense}")
        if attacker not in api._round_plan(0):
            raise AssertionError(f"attacker {attacker} not in round 0's cohort")
        C = len(api._round_plan(rounds - 1))
        k = rs.median_trim_k(C) if trim_k is None else trim_k
        for name, v in api.stack.items():
            plain = rs.trimmed_mean_plain(v.float().reshape(C, -1), k).reshape(v.shape[1:])
            if not torch.equal(api.global_vars[name], plain):
                err = (api.global_vars[name] - plain).abs().max().item()
                raise AssertionError(f"backdoor {defense}: {name} differs from the plain "
                                     f"aggregate by {err}")
        report["backdoor"][defense] = {
            "k1_launches": n, "round_s": round_s(api), "bit_equal_to_plain": True,
            "Backdoor/ASR": attack_success_rate(model, api.global_vars, poisoned, spec,
                                                eval_fn=api.eval_fn),
        }

    # (b) Krum (f = 1) and Multi-Krum (m = 3), 2 rounds each; then the
    # selection after one full-batch step a client, card against CPU
    report["krum"] = {}
    for defense in ("krum", "multi_krum"):
        robust = RobustConfig(defense_type=defense, num_byzantine=1, multi_krum_m=KRUM_M)
        api = RobustFedAvgAPI(_with_fed(cfg0, comm_round=2), data, model, robust=robust,
                              device=device)
        api.train()
        _finite_rows(api.history, defense)
        report["krum"][defense] = {"round_s": round_s(api)}
    Krum = _capturing(RobustFedAvgAPI, lambda api: make_defense_hooks(api.robust))
    stacks = {}
    for dev in dict.fromkeys(("cpu", device)):
        api = Krum(_full_batch(cfg0), data, model, device=dev,
                   robust=RobustConfig(defense_type="krum", num_byzantine=1))
        api.train_round(0)
        stacks[dev] = api.stack
    for defense, m in (("krum", 1), ("multi_krum", KRUM_M)):
        picked = {dev: krum_select(stacks[dev], 1, m).tolist() for dev in stacks}
        if picked[device] != picked["cpu"]:
            raise AssertionError(f"{defense}: the card selects {picked[device]}, "
                                 f"the CPU {picked['cpu']}")
        scores = torch.sort(krum_scores(stacks[device], 1)).values.tolist()
        entry = report["krum"][defense]
        entry.update(selected=picked[device], cpu_selected=picked["cpu"],
                     score_gap_rel=(scores[m] - scores[m - 1]) / scores[m - 1])
        if on_card:
            entry["ms_a_round"] = device_ms(lambda m=m: krum_aggregate(stacks[device], 1, m),
                                            iters=10)

    # (c) weak DP, 2 rounds, with one fixed noise stream (CPU draws) on both
    # devices; a full-batch round on the card within CARD_VS_CPU of the CPU's
    noise = seeded_noise_fn(WEAK_DP_NOISE_SEED, torch.device("cpu"))
    robust = RobustConfig(defense_type="weak_dp", norm_bound=5.0, stddev=0.025)
    api = RobustFedAvgAPI(_with_fed(cfg0, comm_round=2), data, model, robust=robust,
                          device=device, noise_fn=noise)
    api.train()
    _finite_rows(api.history, "weak_dp")
    out = {}
    for dev in dict.fromkeys(("cpu", device)):
        one = RobustFedAvgAPI(_full_batch(cfg0), data, model, robust=robust, device=dev,
                              noise_fn=noise)
        one.train_round(0)
        out[dev] = {k: v.cpu() for k, v in one.global_vars.items()}
    rtol, atol = CARD_VS_CPU[-1]
    for k in out["cpu"]:
        torch.testing.assert_close(out[device][k], out["cpu"][k], rtol=rtol, atol=atol,
                                   msg=lambda msg, k=k: f"weak_dp card vs cpu, {k}: {msg}")
    report["weak_dp"] = {"round_s": round_s(api), "card_vs_cpu_max_abs_err": max(
        (out[device][k] - out["cpu"][k]).abs().max().item() for k in out["cpu"]),
        "tol": [rtol, atol]}

    # (d) DP-FedAvg, 3 rounds, explicit secret: the Poisson cohorts and the
    # epsilon of a fresh host accountant
    dp = DpConfig(clip_norm=DP_CLIP, noise_multiplier=1.0, delta=1e-5, sample_secret=DP_SECRET)
    api = DPFedAvgAPI(_with_fed(cfg0, comm_round=DP_ROUNDS), data, model, dp=dp, device=device)
    final = api.train()
    _finite_rows(api.history, "dp_fedavg")
    q = per_round / num_clients
    cohorts = [api._round_plan(r).tolist() for r in range(DP_ROUNDS)]
    want = [poisson_client_sampling(DP_SECRET, r, num_clients, q).tolist() for r in range(DP_ROUNDS)]
    if cohorts != want:
        raise AssertionError(f"dp cohorts {cohorts}, poisson_client_sampling gives {want}")
    acct = RdpAccountant()
    for _ in range(DP_ROUNDS):
        acct.step(q, dp.noise_multiplier)
    if api.accountant.epsilon(dp.delta) != acct.epsilon(dp.delta):
        raise AssertionError(f"dp epsilon {api.accountant.epsilon(dp.delta)}, "
                             f"host accountant {acct.epsilon(dp.delta)}")
    report["dp_fedavg"] = {"round_s": round_s(api), "cohort_sizes": [len(c) for c in cohorts],
                           "epsilon": final["DP/epsilon"], "rdp_order": final["DP/rdp_order"]}

    # (e) power-of-choice, overprovisioned, under a dropout plan, evaluated
    # on every client: the cohorts replayed from the losses the run
    # reported, the faults/* counters from the plan
    cfg = _with_fed(cfg0, comm_round=POC_ROUNDS, selection="power_of_choice",
                    overprovision_factor=POC_OVERPROVISION, fault_plan=json.dumps(POC_PLAN),
                    eval_on_clients=True)
    api = FedAvgAPI(cfg, data, model, device=device)
    reported, marks = [], []
    report_loss, log_round = api.scheduler.report_loss, api._log_round
    api.scheduler.report_loss = lambda cid, loss: (reported.append((cid, loss)),
                                                   report_loss(cid, loss))
    api._log_round = lambda *a: (log_round(*a), marks.append(len(reported)))[0]
    # round_time_s ends before the round's eval: the eval over every
    # client's shards is timed on its own (its metrics come to the host)
    eval_s, local_test = [], api.local_test_on_all_clients

    def timed_local_test(*a):
        t0 = time.perf_counter()
        row = local_test(*a)
        eval_s.append(time.perf_counter() - t0)
        return row

    api.local_test_on_all_clients = timed_local_test
    api.train()
    _finite_rows(api.history, "power_of_choice")
    replay = ClientScheduler.from_config(cfg, num_clients=num_clients, data=data)
    plan, counts, crashed, start = FaultPlan.from_config(cfg), {"dropout": 0, "crash": 0}, set(), 0
    for r in range(POC_ROUNDS):
        sel = [int(c) for c in replay.select(r)]
        if sel != api.scheduler.select(r).tolist() or len(sel) != replay.cohort_size():
            raise AssertionError(f"round {r}: cohort {api.scheduler.select(r)}, replay {sel}")
        decisions = [(c, plan.decide(c, r)) for c in sel]
        survivors = [c for c, d in decisions if d.participates] or sel[:1]
        if survivors != api._round_plan(r).tolist():
            raise AssertionError(f"round {r}: survivors {api._round_plan(r)}, replay {survivors}")
        for c, d in decisions:
            if c in survivors:
                continue
            if d.crashed:
                counts["crash"] += c not in crashed
                crashed.add(c)
            else:
                counts["dropout"] += 1
        for cid, loss in reported[start:marks[r]]:
            replay.report_loss(cid, loss)
        start = marks[r]
    want_row = {"faults/dropouts": counts["dropout"], "faults/crashes": counts["crash"],
                "faults/slowdowns": 0, "faults/flaky_uploads": 0,
                "faults/total": counts["dropout"] + counts["crash"]}
    if api.faults.summary_row() != want_row:
        raise AssertionError(f"faults row {api.faults.summary_row()}, want {want_row}")
    keys = {"round", "Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc", "round_time_s"}
    if any(set(row) != keys for row in api.history):
        raise AssertionError(f"power_of_choice rows {[sorted(r) for r in api.history]}")
    if len(eval_s) != POC_ROUNDS:
        raise AssertionError(f"power_of_choice: {len(eval_s)} evals on all clients in "
                             f"{POC_ROUNDS} rounds")
    report["power_of_choice"] = {"round_s": round_s(api), "eval_s": eval_s,
                                 "cohort": replay.cohort_size(),
                                 "survivors": [len(api._round_plan(r)) for r in range(POC_ROUNDS)],
                                 "faults": want_row, "last_row": api.history[-1]}
    report["k1_launches"] = launches
    log("[defenses] " + json.dumps(report))
    return launches


# ----------------------------------------- the stateful and drift-correcting rounds

LONGTAIL_ROUNDS = 2
DITTO_LAMBDA = 0.1
QFFL_Q = 1.0
# the decentralized runs' step: the north star's 0.1 diverges on the 784
# standardized pixels a sample (mean |x|_1 ~ 873): regret 0.99 -> 3.96 over
# the 89 samples of the shortest stream, 0.57 at 0.003
DECENTRALIZED_LR = 0.003


@contextlib.contextmanager
def _deterministic_convs():
    """cuDNN's deterministic algorithms within the block, for the
    bit-equality checks."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _host(tree) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def _assert_bit_equal(got: dict, want: dict, what: str) -> None:
    import torch

    for k, v in want.items():
        if not torch.equal(got[k], v):
            err = (got[k].float() - v.float()).abs().max().item()
            raise AssertionError(f"{what}: {k} differs by {err}")


def _stateful_snapshot(api, touched) -> dict:
    """A stateful run's model, server state and touched rows on the host."""
    snap = {"global": _host(api.global_vars)}
    if hasattr(api, "c_server"):
        snap["c_server"] = _host(api.c_server)
    rows = api.state.gather(-1, touched)
    snap["rows"] = _host(rows)
    return snap


def _stack_copy_ms(stack: dict, ids) -> tuple:
    """Device ms of one cohort's gather (``index_select``) from the
    [N, ...] stack and its write-back (``index_copy_`` of the same rows)."""
    import torch

    idx = torch.as_tensor(ids, device=next(iter(stack.values())).device)
    rows = {k: s.index_select(0, idx) for k, s in stack.items()}
    gather = device_ms(lambda: [s.index_select(0, idx) for s in stack.values()])
    scatter = device_ms(lambda: [s.index_copy_(0, idx, rows[k]) for k, s in stack.items()])
    return gather, scatter


def _scaffold_argv(log_dir, rounds: int, num_clients: int, per_round: int, *extra) -> list:
    """python -m fedml_tpu_torch's options for SCAFFOLD on the north star."""
    return ["--algorithm", "scaffold", "--model", "cnn", "--dataset", "femnist_synth",
            "--client_num_in_total", str(num_clients), "--client_num_per_round", str(per_round),
            "--batch_size", "20", "--epochs", "1", "--lr", "0.1", "--comm_round", str(rounds),
            "--log_dir", str(log_dir), *extra]


def phase_longtail(smi: str, main_warm_s=None, device="cuda", num_clients=128,
                   per_round=COHORT) -> dict:
    """The stateful and drift-correcting algorithms on the north star
    (phase 17), 2 rounds each:

    (a) FedNovaAPI, QFedAvgAPI (q = 1) and HierarchicalFedAvgAPI (2 groups,
        group_comm_round 1): warm round times beside phase 4's, finite
        losses;
    (b) ScaffoldAPI and DittoAPI (λ = 0.1), each with its state on the
        device and forced to the mmap tier, under cuDNN's deterministic
        algorithms: params, c and every touched row bit-equal between the
        modes; the stack's bytes, the peak device memory of each run, the
        spill tier's gather/scatter ms a round, the device stack's
        index_select/index_copy_ ms at the cohort, Ditto's
        Personalized/Acc;
    (c) one full-batch round of FedNova and of SCAFFOLD on the card against
        the CPU: the params within CARD_VS_CPU, SCAFFOLD's c and touched
        rows within STATE_CARD_VS_CPU;
    (d) SCAFFOLD through ``cli.main``: 2 rounds straight on the device
        stack, and 1 round spilled then ``--resume`` to 2 from its
        checkpoint (the touched rows' form): rows, params and c bit-equal;
    (e) CentralizedTrainer for 1 epoch of the pooled data; DSGD over the
        symmetric topology and push-sum over a directed one, the clients'
        streams (128 workers, step DECENTRALIZED_LR): finite losses and the
        regret falling.

    Prints the ``[longtail]`` line. ``device="cpu"`` rehearses it (device
    times and memory "not measured")."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch import cli
    from fedml_tpu_torch.algorithms import (
        DittoAPI, FedNovaAPI, HierarchicalFedAvgAPI, QFedAvgAPI, ScaffoldAPI,
    )
    from fedml_tpu_torch.algorithms.decentralized import DecentralizedAPI
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.partition import AsymmetricTopologyManager, SymmetricTopologyManager
    from fedml_tpu_torch.train.centralized import CentralizedTrainer

    on_card = device == "cuda"
    rounds = LONGTAIL_ROUNDS
    cfg0, data, model = _north_star(rounds, num_clients, per_round)
    report = {"device": device, "card": smi, "phase4_median_warm_round_s": main_warm_s}
    round_s = lambda api: [r["round_time_s"] for r in api.history]  # noqa: E731

    # (a) the algorithms whose state is the global model alone
    for name, cls, cfg, kw in (
        ("fednova", FedNovaAPI, cfg0, {}),
        ("qfedavg", QFedAvgAPI, cfg0, {"q": QFFL_Q}),
        ("hierarchical", HierarchicalFedAvgAPI, _with_fed(cfg0, group_num=2, group_comm_round=1),
         {}),
    ):
        api = cls(cfg, data, model, device=device, **kw)
        api.train()
        _finite_rows(api.history, name)
        report[name] = {"round_s": round_s(api), "last_row": api.history[-1]}
        log(f"[longtail] {name}: " + json.dumps(report[name]))
        del api

    # (b) SCAFFOLD and Ditto: the device stack against the mmap tier
    with tempfile.TemporaryDirectory(prefix="fedml_state_") as tmp, _deterministic_convs():
        for name, cls, kw in (("scaffold", ScaffoldAPI, {}), ("ditto", DittoAPI,
                                                             {"lam": DITTO_LAMBDA})):
            entry, snaps = {"round_s": {}, "peak_mem_bytes": {}, "allocated_before_bytes": {}}, {}
            for mode in ("device", "mmap"):
                state_dir = str(Path(tmp) / name) if mode == "mmap" else ""
                cfg = _with_fed(cfg0, state_store=mode, state_dir=state_dir)
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                # what earlier work still holds on the device, inside the peak
                entry["allocated_before_bytes"][mode] = (torch.cuda.memory_allocated() if on_card
                                                         else "not measured")
                api = cls(cfg, data, model, device=device, **kw)
                final = api.train()
                if api.state.mode != mode:
                    raise AssertionError(f"{name}: state in {api.state.mode}, asked for {mode}")
                _finite_rows(api.history, f"{name} {mode}")
                entry["peak_mem_bytes"][mode] = (torch.cuda.max_memory_allocated() if on_card
                                                 else "not measured")
                entry["round_s"][mode] = round_s(api)
                touched = sorted({int(c) for r in range(rounds) for c in api._round_plan(r)})
                snaps[mode] = _stateful_snapshot(api, touched)
                if mode == "device":
                    entry["stack_bytes"] = api.state.stack_bytes
                    entry["device_gather_ms"], entry["device_scatter_ms"] = (
                        _stack_copy_ms(api.state.stack, touched[:per_round]) if on_card
                        else ("not measured", "not measured"))
                else:
                    entry["spill_ms"] = api.state.spill_ms
                    entry["store_rows_written"] = api.state.store.initialized_count()
                if name == "ditto":
                    entry[f"final_{mode}"] = {k: final[k] for k in
                                              ("Personalized/Acc", "Global/Acc",
                                               "num_clients_evaluated")}
                del api, final
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
            for part in snaps["device"]:
                _assert_bit_equal(snaps["mmap"][part], snaps["device"][part],
                                  f"{name} mmap vs device, {part}")
            if entry.get("final_mmap") != entry.get("final_device"):
                raise AssertionError(f"{name}: personalized rows differ between the modes")
            entry["mmap_bit_equal_to_device"] = True
            entry["touched_rows"] = len(touched)
            report[name] = entry
            log(f"[longtail] {name}: " + json.dumps(entry))

    # (c) one full-batch round, card against the CPU: the params within
    # CARD_VS_CPU, SCAFFOLD's c and rows within STATE_CARD_VS_CPU
    tols = {"global": CARD_VS_CPU[-1], "c_server": STATE_CARD_VS_CPU,
            "rows": STATE_CARD_VS_CPU}
    for name, cls in (("fednova", FedNovaAPI), ("scaffold", ScaffoldAPI)):
        out = {}
        for dev in dict.fromkeys(("cpu", device)):
            api = cls(_full_batch(_with_fed(cfg0, comm_round=1)), data, model, device=dev)
            api.train_round(0)
            touched = [int(c) for c in api._round_plan(0)]
            out[dev] = ({"global": _host(api.global_vars)} if name == "fednova"
                        else _stateful_snapshot(api, touched))
            del api
        errs = {}
        for part, want in out["cpu"].items():
            for k, v in want.items():
                rtol, atol = tols[part]
                torch.testing.assert_close(out[device][part][k], v, rtol=rtol, atol=atol,
                                           msg=lambda m, k=k: f"{name} card vs cpu, {k}: {m}")
                errs[part] = max(errs.get(part, 0.0),
                                 (out[device][part][k] - v).abs().max().item())
        report[name]["card_vs_cpu_max_abs_err"] = errs
        report[name]["card_vs_cpu_tol"] = {part: tols[part] for part in out["cpu"]}
        log(f"[longtail] {name} card vs cpu: {json.dumps(errs)}")
        gc.collect()

    # (d) SCAFFOLD --resume through the command line
    dev = None if on_card else device
    with tempfile.TemporaryDirectory(prefix="fedml_scaffold_cli_") as tmp, \
            _deterministic_convs():
        tmp = Path(tmp)
        straight = cli.main(_scaffold_argv(tmp / "straight", 2, num_clients, per_round),
                            device=dev)
        spilled = ("--state_store", "mmap", "--checkpoint_path", str(tmp / "ck"))
        cli.main(_scaffold_argv(tmp / "first", 1, num_clients, per_round, *spilled), device=dev)
        resumed = cli.main(_scaffold_argv(tmp / "resumed", 2, num_clients, per_round, *spilled,
                                          "--resume"), device=dev)
        strip = lambda row: {k: v for k, v in row.items() if k != "round_time_s"}  # noqa: E731
        if [strip(r) for r in resumed.history] != [strip(r) for r in straight.history[1:]]:
            raise AssertionError(f"scaffold cli: resumed rows {resumed.history} != straight "
                                 f"{straight.history[1:]}")
        touched = sorted({int(c) for r in range(2) for c in straight._round_plan(r)})
        a, b = _stateful_snapshot(straight, touched), _stateful_snapshot(resumed, touched)
        for part in a:
            _assert_bit_equal(b[part], a[part], f"scaffold cli resume, {part}")
        report["scaffold"]["cli_resume"] = {
            "bit_equal": True, "resumed_mode": resumed.state.mode,
            "checkpoint_bytes": (tmp / "ck.npz").stat().st_size,
            "round_s_straight": round_s(straight), "round_s_resumed": round_s(resumed),
        }
        del straight, resumed
        gc.collect()

    # (e) centralized training and decentralized DSGD / push-sum
    t0 = time.perf_counter()
    trainer = CentralizedTrainer(_with_fed(cfg0, comm_round=1), data, model, device=device)
    row = trainer.train()
    _finite_rows([row], "centralized")
    report["centralized"] = {"epoch_s": time.perf_counter() - t0, "row": row,
                             "steps": -(-len(trainer._x) // trainer.batch_size)}
    T = min(len(cy) for cy in data.client_y)
    x = np.stack([cx[:T].reshape(T, -1) for cx in data.client_x])
    y = np.stack([(cy[:T] % 2).astype(np.float32) for cy in data.client_y])
    topologies = {"dsgd": SymmetricTopologyManager(num_clients, neighbor_num=4),
                  "pushsum": AsymmetricTopologyManager(num_clients, 3, 3, seed=0)}
    for variant, topo in topologies.items():
        topo.generate_topology()
        t0 = time.perf_counter()
        api = DecentralizedAPI(create_model("lr", "synthetic", (x.shape[-1],), 1), topo,
                               lr=DECENTRALIZED_LR, variant=variant, seed=0, device=device)
        out = api.run(x, y)
        regret = out["regret"]
        if not (np.isfinite(out["losses"]).all() and regret[-1] < regret[0]):
            raise AssertionError(f"{variant}: regret {regret[0]} -> {regret[-1]}, losses "
                                 f"finite {np.isfinite(out['losses']).all()}")
        report[variant] = {"workers": num_clients, "topology": type(topo).__name__,
                           "lr": DECENTRALIZED_LR, "iterations": int(len(out["losses"])),
                           "regret_first_last": [float(regret[0]), float(regret[-1])],
                           "run_s": time.perf_counter() - t0}
    log("[longtail] " + json.dumps(report))
    return report



# ---------------------------------------------------------------- FedBuff

FEDBUFF = dict(workers=10, k=10, steps=6, other_steps=3, card_cpu_steps=3, exp=0.5, eta=1.0)
FEDBUFF_PLAN = {"seed": 11, "default": {"dropout_p": 0.2, "flaky_upload_p": 0.1}}
FEDBUFF_STEP_TOL = 1e-6  # the buffer step on the card against float64 numpy
STRAGGLER_ROUNDS = 6
STRAGGLER_SLOW_S = 1.0  # the slow clients' extra train time, inside their local_train span
STRAGGLER_SLOW = 3  # of round 0's cohort


def _fedbuff_cfg(steps: int, num_clients: int, workers: int, k: int, **fed):
    cfg, data, model = _north_star(steps, num_clients, workers)
    cfg = _with_fed(cfg, async_buffer_k=k, async_staleness_exp=FEDBUFF["exp"],
                    async_server_lr=FEDBUFF["eta"], **fed)
    return cfg, data, model


def _fedbuff_checks(server, what: str, workers: int, steps: int, trainers, rows) -> dict:
    """The gates every FedBuff run holds: its step count, finite losses,
    one staleness entry a buffered upload and a histogram summing to them,
    and the health registry's participations (the buffered uploads, plus at
    most one train a worker that ended before the last step while its
    upload arrived after it)."""
    k = server.config.fed.async_buffer_k
    if server.server_steps != steps:
        raise AssertionError(f"{what}: {server.server_steps} server steps, want {steps}")
    _finite_rows(server.history, what)
    losses = [t.last_loss for t in trainers if t.last_loss is not None]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: client train losses {losses}")
    uploads = len(server.staleness_seen)
    if uploads != steps * k:
        raise AssertionError(f"{what}: {uploads} buffered uploads, want {steps * k}")
    final = [r for r in rows if r.get("async_final")]
    if len(final) != 1 or sum(final[0]["staleness_hist"].values()) != uploads:
        raise AssertionError(f"{what}: staleness histogram {final} against {uploads} uploads")
    seen = sum(server.health.rounds_participated(c)
               for c in range(server.config.fed.client_num_in_total))
    if not uploads <= seen <= uploads + workers:
        raise AssertionError(f"{what}: the registry saw {seen} trains for {uploads} uploads")
    return {"server_steps": server.server_steps, "buffered_uploads": uploads,
            "registry_participations": seen, "staleness_hist": final[0]["staleness_hist"],
            "final_row": server.history[-1]}


def _fedbuff_run(runner, cfg, data, model, device, **kw):
    """``runner`` with the comm meter and tracer reset before; (server,
    trainers, rows, wall seconds)."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg_transport import LocalTrainer
    from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer

    trainers, rows = [], []

    def make_trainer(rank):
        trainers.append(LocalTrainer(cfg, data, model, device=device))
        return trainers[-1]

    get_comm_meter().reset()
    get_tracer().reset()
    t0 = time.perf_counter()
    server = runner(cfg, data, model, device=device, log_fn=rows.append,
                    trainer_factory=make_trainer, orphan_deadline_s=120.0, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return server, trainers, rows, time.perf_counter() - t0


def _fedbuff_report(server, wall_s: float) -> dict:
    """Seconds a server step (the rows' ``t_s`` deltas, and net of the
    previous step's eval), uploads a second, and bytes a dispatch and an
    upload from the port's CommMeter."""
    from fedml_tpu_torch.core.message import MessageType as MT
    from fedml_tpu_torch.telemetry import get_comm_meter, get_tracer

    snap = get_comm_meter().snapshot()
    t_s = [row["t_s"] for row in server.history]
    evals = {ev.attrs["round"]: ev.dur_us / 1e6 for ev in get_tracer().events() if ev.name == "eval"}
    steps = [b - a for a, b in zip(t_s, t_s[1:])]
    net = [d - evals.get(i, 0.0) for i, d in enumerate(steps)]
    k = server.config.fed.async_buffer_k
    ups = snap["messages_sent"].get(MT.C2S_SEND_MODEL, 0)
    return {
        "wall_s": wall_s,
        "t_s": t_s,
        "step_s": steps,
        "step_s_net_of_eval": net,
        "uploads_per_s": k * len(steps) / (t_s[-1] - t_s[0]) if len(t_s) > 1 else None,
        "bytes_per_dispatch": snap["downlink_payload_bytes"] / max(snap["downlink_updates"], 1),
        "wire_bytes_per_upload": snap["bytes_sent"].get(MT.C2S_SEND_MODEL, 0) / max(ups, 1),
        "eval_s": sorted(evals.values()),
    }


class _SlowClientsTrainer:
    """A LocalTrainer factory whose trainers sleep ``slow_s`` inside their
    ``local_train`` span for the clients in ``slow`` (the reference's
    per-trainer ``straggle_ms``, keyed by client here): the health
    registry sees the span, so these clients' train times are the slow
    ones. A fault plan's slowdown sleeps after the span in both packages,
    where the registry's span stream does not see it."""

    def __init__(self, cfg, data, model, device, slow, slow_s):
        from fedml_tpu_torch.algorithms.fedavg_transport import LocalTrainer

        class Slow(LocalTrainer):
            def _train(self, round_idx, variables):
                out = super()._train(round_idx, variables)
                if self.client_index in slow:
                    time.sleep(slow_s)
                return out

        self.make = lambda rank: Slow(cfg, data, model, device=device)


def phase_fedbuff(smi: str, device="cuda", num_clients=128, workers=FEDBUFF["workers"],
                  k=FEDBUFF["k"], steps=FEDBUFF["steps"], other_steps=FEDBUFF["other_steps"],
                  straggler_rounds=STRAGGLER_ROUNDS) -> dict:
    """FedBuff on the north star at full width (phase 18); see the module
    docstring. Returns the ``[fedbuff]`` readings."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.algorithms import fedbuff as fb
    from fedml_tpu_torch.algorithms.fedavg_transport import run_loopback_federation
    from fedml_tpu_torch.scheduler.policies import SelectionContext, StragglerAwarePolicy
    from fedml_tpu_torch.telemetry import ClientHealthRegistry, MetricsRegistry, get_tracer

    report = {"card": smi, "workers": workers, "async_buffer_k": k}

    # (a) loopback: timed, then again under the profiler for the busy share
    cfg, data, model = _fedbuff_cfg(steps, num_clients, workers, k)
    server, trainers, rows, wall = _fedbuff_run(fb.run_fedbuff_loopback, cfg, data, model, device)
    report["loopback"] = {**_fedbuff_checks(server, "loopback", workers, steps, trainers, rows),
                          **_fedbuff_report(server, wall)}
    if device == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            server, trainers, rows, wall = _fedbuff_run(fb.run_fedbuff_loopback, cfg, data, model,
                                                        device)
        _fedbuff_checks(server, "loopback (profiled)", workers, steps, trainers, rows)
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        report["loopback_profiled"] = {
            "wall_s": wall, "kernel_launches": sum(e.count for e in kernels),
            "device_kernel_ms": kernel_ms if kernels else "not measured",
            "device_busy_share": kernel_ms / (wall * 1e3) if kernels else "not measured",
            "top_kernels_ms_calls": {e.key[:60]: [e.self_device_time_total / 1e3, e.count]
                                     for e in top},
        }

    # the yardstick in this call: synchronous FedAvg rounds of the same
    # cohort size over loopback
    sync, sync_report = _traced_federation(run_loopback_federation,
                                           *_north_star(3, num_clients, workers), device=device)
    _finite_rows(sync.history, "sync loopback")
    report["sync_loopback"] = {k: sync_report[k] for k in ("warm_round_s", "round_t_s", "wall_s")}

    # (b) shared memory and the embedded MQTT broker
    cfg_b, _, _ = _fedbuff_cfg(other_steps, num_clients, workers, k)
    for name, runner in (("shm", fb.run_fedbuff_shm), ("mqtt", fb.run_fedbuff_mqtt)):
        server, trainers, rows, wall = _fedbuff_run(runner, cfg_b, data, model, device)
        report[name] = {**_fedbuff_checks(server, name, workers, other_steps, trainers, rows),
                        **_fedbuff_report(server, wall)}

    # (c) the fixed arrival order (one worker, k = 1, one full-batch step a
    # client) on the card against the CPU, from one init
    cfg_c, _, _ = _fedbuff_cfg(FEDBUFF["card_cpu_steps"], num_clients, 1, 1,
                               frequency_of_the_test=FEDBUFF["card_cpu_steps"])
    cfg_c = _full_batch(cfg_c)
    init = model.init(torch.Generator().manual_seed(cfg_c.seed))
    out = {}
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        srv = fb.run_fedbuff_loopback(cfg_c, data, model, device=dev, init_vars=init,
                                      orphan_deadline_s=120.0)
        out[dev] = ({n: v.cpu() for n, v in srv.global_vars.items()}, srv.history,
                    time.perf_counter() - t0)
        if srv.staleness_seen != [0] * FEDBUFF["card_cpu_steps"]:
            raise AssertionError(f"card vs cpu ({dev}): staleness {srv.staleness_seen}")
    rtol, atol = CARD_VS_CPU[-1]
    (cpu, cpu_rows, cpu_s), (card, card_rows, card_s) = out["cpu"], out[device]
    err = max((card[n] - cpu[n]).abs().max().item() for n in cpu)
    for n in cpu:
        torch.testing.assert_close(card[n], cpu[n], rtol=rtol, atol=atol,
                                   msg=lambda m, n=n: f"fedbuff card vs cpu {n}: {m}")
    report["card_vs_cpu"] = {"steps": FEDBUFF["card_cpu_steps"], "max_abs_err": err, "rtol": rtol,
                             "atol": atol, "cpu_s": cpu_s, "card_s": card_s,
                             "test_loss": [card_rows[-1]["Test/Loss"], cpu_rows[-1]["Test/Loss"]]}

    # (d) the buffer step alone: k deltas over the whole model, tau = 0..k-1,
    # against float64 numpy
    gen = torch.Generator().manual_seed(1)
    g = {n: v.to(device) for n, v in model.init(gen).items()}
    deltas = [{n: (0.01 * torch.randn(v.shape, generator=gen)).to(device) for n, v in g.items()}
              for _ in range(k)]
    taus = list(range(k))
    got = fb.apply_buffered_update(g, deltas, taus, FEDBUFF["eta"], FEDBUFF["exp"])
    w = (1.0 + np.arange(k, dtype=np.float64)) ** -FEDBUFF["exp"]
    w /= w.sum()
    step_err = 0.0
    for n, v in g.items():
        want = v.double().cpu().numpy() + FEDBUFF["eta"] * np.tensordot(
            w, np.stack([d[n].double().cpu().numpy() for d in deltas]), axes=1)
        step_err = max(step_err, float(np.abs(got[n].double().cpu().numpy() - want).max()))
    if step_err > FEDBUFF_STEP_TOL:
        raise AssertionError(f"buffer step: {step_err} from float64, tolerance {FEDBUFF_STEP_TOL}")
    model_bytes = 4 * sum(v.numel() for v in g.values())
    step = {"k": k, "max_abs_err_vs_float64": step_err, "tol": FEDBUFF_STEP_TOL,
            "model_bytes": model_bytes}
    if device == "cuda":
        _, (rate, *_) = card_rates(torch.cuda.get_device_name(0))
        step["ms"] = device_ms(lambda: fb.apply_buffered_update(g, deltas, taus, FEDBUFF["eta"],
                                                                FEDBUFF["exp"]))
        # each delta read once, the model read once and written once
        step["bound_ms"] = (k + 2) * model_bytes / rate * 1e3
        step["bound_by"] = "bytes"
    report["buffer_step"] = step

    # (e) a fault plan over loopback: declines re-dispatched, the flaky
    # second copies dropped by the tag dedupe
    cfg_e, _, _ = _fedbuff_cfg(other_steps, num_clients, workers, k,
                               fault_plan=json.dumps(FEDBUFF_PLAN))
    server, trainers, rows, wall = _fedbuff_run(fb.run_fedbuff_loopback, cfg_e, data, model, device)
    checks = _fedbuff_checks(server, "fault plan", workers, other_steps, trainers, rows)
    summary = [r for r in rows if "faults/total" in r]
    if len(summary) != 1:
        raise AssertionError(f"fault plan: summary rows {summary}")
    summary = summary[0]
    dropouts, flaky = summary["faults/dropouts"], summary["faults/flaky_uploads"]
    # a decline or flaky pair in flight when the last step closed the run is
    # never read by the server: at most one a worker
    if not (0 < dropouts and server.declines <= dropouts <= server.declines + workers):
        raise AssertionError(f"fault plan: {server.declines} declines read of {dropouts} dropouts")
    if not server.duplicates <= flaky <= server.duplicates + workers:
        raise AssertionError(f"fault plan: {server.duplicates} duplicates dropped of {flaky} "
                             "flaky sends")
    report["fault_plan"] = {**checks, "plan": FEDBUFF_PLAN, "summary": summary,
                            "declines_redispatched": server.declines,
                            "duplicates_dropped": server.duplicates,
                            "dispatches": server._dispatch_counter,
                            **_fedbuff_report(server, wall)}

    # (f) straggler_aware on the sync loopback transport: a fixed set of
    # slow clients (from round 0's cohort), the cohorts replayed from the
    # run's local_train spans
    cfg_f, _, _ = _north_star(straggler_rounds, num_clients, COHORT)
    cfg_f = _with_fed(cfg_f, selection="straggler_aware", frequency_of_the_test=straggler_rounds)
    first = StragglerAwarePolicy().select(0, COHORT, SelectionContext(seed=cfg_f.seed,
                                                                      num_clients=num_clients))
    slow = {int(c) for c in first[:STRAGGLER_SLOW]}
    rows = []
    get_tracer().reset()
    t0 = time.perf_counter()
    fed = run_loopback_federation(
        cfg_f, data, model, device=device, log_fn=rows.append,
        trainer_factory=_SlowClientsTrainer(cfg_f, data, model, device, slow, STRAGGLER_SLOW_S).make,
    )
    wall = time.perf_counter() - t0
    _finite_rows(fed.history, "straggler_aware")
    cohorts = {r["round"]: r["scheduler/selected"] for r in rows if "scheduler/selected" in r}
    spans = {}
    for ev in get_tracer().events():
        if ev.name == "local_train":
            spans.setdefault(int(ev.attrs["round"]), []).append(
                (int(ev.attrs["client"]), ev.dur_us / 1e6))
    replay = ClientHealthRegistry(registry=MetricsRegistry())
    ctx = SelectionContext(seed=cfg_f.seed, num_clients=num_clients, health=replay)
    flagged_by_round, slow_flagged = {}, set()
    for r in range(straggler_rounds):
        flagged = replay.straggler_ids()
        want = StragglerAwarePolicy().select(r, COHORT, ctx).tolist()
        if cohorts[r] != want:
            raise AssertionError(f"straggler_aware round {r}: cohort {cohorts[r]}, replay {want}")
        if num_clients - len(flagged) >= COHORT and set(cohorts[r]) & set(flagged):
            raise AssertionError(f"straggler_aware round {r}: flagged {flagged} in {cohorts[r]}")
        flagged_by_round[r] = flagged
        slow_flagged |= slow & set(flagged)
        for cid, dur in spans.get(r, []):
            replay.observe_train(cid, r, dur)
    if not slow_flagged:
        raise AssertionError(f"straggler_aware: no slow client of {sorted(slow)} was ever flagged")
    if replay.snapshot() != fed.health.snapshot():
        raise AssertionError("straggler_aware: the server's registry is not the spans' replay")
    report["straggler_aware"] = {"rounds": straggler_rounds, "slow": sorted(slow),
                                 "slow_s": STRAGGLER_SLOW_S, "flagged_by_round": flagged_by_round,
                                 "cohorts": cohorts, "wall_s": wall,
                                 "round_t_s": [row["t_s"] for row in fed.history]}
    log("[fedbuff] " + json.dumps(report))
    return report


# phase 19: the population tier, the reference's two scale rows at full width
SCALE_100K = dict(num_clients=100_000, mean_samples=64, vocab=10_000, seq_len=20, seed=0)
SCALE_RAM_CLIENTS = 2_000  # the in-RAM partner of the 100k row
SCALE_1M, SCALE_MID = 1_000_000, 100_000  # the 1M row and its 100k partner
SCALE_WARM, SCALE_TIMED = 3, 5  # rounds; the reference times 15 (100k) and 10 (1M)
SCALE_TIERS_ROUNDS = 2
SCALE_MIN_FREE_BYTES = 4 << 30  # the 100k store (~1.2 GB) and the state tiers' rows
# one full-width StackOverflow RNN round, 2 clients, full batch, card against
# CPU: cuDNN's LSTM and the CPU's sum the gates in other orders, one step at
# lr 0.1 (the CNN's full-batch bound, CARD_VS_CPU[-1])
RNN_CARD_VS_CPU = CARD_VS_CPU[-1]


def _scale_config(n: int, rounds: int, batch_size: int = 16, pad_bucket: int = 1, **fed):
    """The scale rows' RunConfig: ``n`` clients, 10 a round, E = 1, SGD lr
    0.1, no device cache, no eval inside ``rounds``."""
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig

    return RunConfig(
        data=DataConfig(batch_size=batch_size, pad_bucket=pad_bucket, device_cache=False),
        fed=FedConfig(client_num_in_total=n, client_num_per_round=COHORT, comm_round=rounds,
                      epochs=1, frequency_of_the_test=10_000, **fed),
        train=TrainConfig(client_optimizer="sgd", lr=0.1),
        seed=0,
    )


def _sync_rounds(api, rounds) -> list:
    """Seconds of each ``api.train_round`` (its loss read on the host,
    which waits for the device); raises on a non-finite loss."""
    secs = []
    for r in rounds:
        t0 = time.perf_counter()
        _, mets = api.train_round(r)
        loss = float(mets["loss_sum"]) / max(float(mets["count"]), 1e-9)
        secs.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"round {r}: non-finite train loss {loss}")
    return secs


def _cohort_replay(api, policy: str, counts, rounds) -> None:
    """The run's cohorts against a host replay: ``uniform`` is
    ``np.random.seed(round)`` then ``choice``; ``weighted`` at population
    scale an AliasSampler over the counts drawn from the (seed, round, 1)
    generator."""
    import numpy as np

    from fedml_tpu_torch.population import AliasSampler

    seen = api.scheduler.selections()
    alias = AliasSampler(np.asarray(counts, np.float64)) if policy == "weighted" else None
    n = len(counts)
    for r in rounds:
        if policy == "uniform":
            np.random.seed(r)
            want = np.random.choice(range(n), COHORT, replace=False)
        else:
            want = alias.draw_distinct(np.random.default_rng([api.config.seed & 0x7FFFFFFF, r, 1]),
                                       COHORT)
        if seen[r] != [int(c) for c in want]:
            raise AssertionError(f"{policy} round {r}: cohort {seen[r]}, replay {want.tolist()}")


def _tiled(base, n: int):
    """``base``'s shards tiled over ``n`` client ids (the 1M row's data)."""
    import dataclasses

    k = base.num_clients
    return dataclasses.replace(base, client_x=[base.client_x[i % k] for i in range(n)],
                               client_y=[base.client_y[i % k] for i in range(n)])


def phase_population(smi: str, device="cuda", so=SCALE_100K, ram_clients=SCALE_RAM_CLIENTS,
                     big_n=SCALE_1M, mid_n=SCALE_MID, warm=SCALE_WARM, timed=SCALE_TIMED,
                     rnn_kw=None) -> dict:
    """The population tier on the reference's two scale rows (phase 19):

    (a) the StackOverflow next-word RNN (``RNNStackOverFlow`` at full
        width: 10,004 symbols, embed 96, LSTM 670) under FedAvgAPI(task
        "nwp") over ``so`` clients written to a disk mmap store
        (``synth_stackoverflow_mmap``, ~77 windows of 20 a client),
        batch 16, pad_bucket 4, no device cache, 10 clients a round:
        ``warm`` rounds, then ``timed``; the in-RAM partner (the same
        generator at ``ram_clients`` clients, as lists) the same; the
        store's build seconds, each round's bucketed steps and cohort
        read (host ms), the time of one client's step (the two
        populations' cohorts bucket to other step counts), one profiled
        round's launches and busy share, the peak device memory;
    (b) ScaffoldAPI on ``lr`` over 64 synthetic shards (10 classes, 32
        features) tiled over ``big_n`` ids, ``weighted`` selection (the
        population index's alias table engaged) and the sharded state
        tier in a fresh directory: ``warm`` then ``timed`` rounds, then
        the same at ``mid_n``; the ratio of the round times (the
        reference's gate: within about 2×), the API's build seconds, the
        state's logical bytes and rows touched, the spill's gather and
        scatter ms, and a synchronous gather of a cohort beside the
        prefetched one;
    (c) SCAFFOLD at ``mid_n`` for SCALE_TIERS_ROUNDS rounds with the state
        on the device, in the mmap tier and in the sharded tier: params,
        c and every touched row bit-equal;
    (d) each run's cohorts equal a host replay (``_cohort_replay``);
    (e) one RNN round at full width, 2 clients, full batch, on the card
        against the CPU (RNN_CARD_VS_CPU).

    Every temporary directory is removed at the end. Prints the
    ``[population]`` line. ``device="cpu"`` rehearses it at the sizes
    given (``rnn_kw`` narrows the RNN; device readings "not measured")."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI, ScaffoldAPI
    from fedml_tpu_torch.data.base import FederatedDataset
    from fedml_tpu_torch.data.mmap_store import synth_stackoverflow_mmap
    from fedml_tpu_torch.data.synthetic import synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.population.state_tier import ShardedClientState

    on_card = device == "cuda"
    rnn_kw = dict(vocab_size=so["vocab"], **(rnn_kw or {}))
    report = {"card": smi, "device": device}
    with tempfile.TemporaryDirectory(prefix="fedml_population_") as tmp:
        free = shutil.disk_usage(tmp).free
        report["tmp_free_bytes"] = free
        if on_card and free < SCALE_MIN_FREE_BYTES:
            raise AssertionError(f"phase 19 needs {SCALE_MIN_FREE_BYTES} B free under {tmp}, "
                                 f"has {free}")

        # (a) the 100k StackOverflow row off the disk store, and its partner
        t0 = time.perf_counter()
        store = synth_stackoverflow_mmap(str(Path(tmp) / "so"), **so)
        row = {"clients": store.num_clients, "store_build_s": time.perf_counter() - t0,
               "store_bytes": store.total_train_bytes}
        small = synth_stackoverflow_mmap(str(Path(tmp) / "so_ram"), **{**so,
                                                                        "num_clients": ram_clients})
        ram = FederatedDataset(name="so_ram", client_x=[np.asarray(c) for c in small.client_x],
                               client_y=[np.asarray(c) for c in small.client_y],
                               test_x=small.test_x, test_y=small.test_y,
                               num_classes=small.num_classes)
        rounds = warm + timed
        for name, data in (("mmap", store), ("ram", ram)):
            model = create_model("rnn", "stackoverflow", (so["seq_len"],), so["vocab"], **rnn_kw)
            cfg = _scale_config(data.num_clients, rounds + 1, pad_bucket=4)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            api = FedAvgAPI(cfg, data, model, task="nwp", device=device)
            if api._store is not None:
                raise AssertionError(f"{name}: the device cache is on")
            read_ms, steps, stack = [], [], api._stack

            def timed_stack(ids, seed, stack=stack, read_ms=read_ms, steps=steps):
                t = time.perf_counter()
                batch = stack(ids, seed)
                read_ms.append((time.perf_counter() - t) * 1e3)
                steps.append(int(batch.x.shape[1]))
                return batch

            api._stack = timed_stack
            secs = _sync_rounds(api, range(rounds))
            _cohort_replay(api, "uniform", data.train_sample_counts, range(rounds))
            # a round's time follows its cohort's bucketed step count (the
            # largest shard's), which differs between the two populations'
            # cohorts: the time of one client's step compares them
            step_ms = [s * 1e3 / (COHORT * k) for s, k in zip(secs[warm:], steps[warm:])]
            entry = {"round_s": secs, "warm_round_s": float(np.mean(secs[warm:])),
                     "steps": steps, "ms_per_client_step": float(np.mean(step_ms)),
                     "cohort_read_ms": read_ms[warm:],
                     "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card
                     else "not measured"}
            if on_card and name == "mmap":
                entry["profiled"] = _profile_round(api, rounds)
            row[name] = entry
            log(f"[population] so {name}: " + json.dumps(entry))
            del api
            gc.collect()
        row["mmap_over_ram_slowdown"] = row["mmap"]["warm_round_s"] / row["ram"]["warm_round_s"]
        row["mmap_over_ram_per_step"] = (row["mmap"]["ms_per_client_step"]
                                         / row["ram"]["ms_per_client_step"])
        report["so_100k"] = row
        del store, small, ram

        # (e) one full-width RNN round on the card against the CPU
        pair = synth_stackoverflow_mmap(str(Path(tmp) / "so_pair"), **{**so, "num_clients": 2})
        outs = {}
        for dev in ((device, "cpu") if on_card else ("cpu",)):
            model = create_model("rnn", "stackoverflow", (so["seq_len"],), so["vocab"], **rnn_kw)
            cfg = _scale_config(2, 1, batch_size=-1)
            cfg = _with_fed(cfg, client_num_per_round=2)
            api = FedAvgAPI(cfg, pair, model, task="nwp", device=dev)
            with _deterministic_convs():
                _sync_rounds(api, range(1))
            outs[dev] = _host(api.global_vars)
        rtol, atol = RNN_CARD_VS_CPU
        err = max(float((outs[device][k] - v).abs().max()) for k, v in outs["cpu"].items())
        for k, v in outs["cpu"].items():
            if not torch.allclose(outs[device][k], v, rtol=rtol, atol=atol):
                raise AssertionError(f"RNN card vs CPU: {k} off by "
                                     f"{float((outs[device][k] - v).abs().max())}")
        report["rnn_card_vs_cpu"] = {"max_abs_err": err, "rtol": rtol, "atol": atol}
        log("[population] rnn card vs cpu: " + json.dumps(report["rnn_card_vs_cpu"]))

        # (b) SCAFFOLD at 1M clients on the sharded tier, weighted, and at 100k
        base = synthetic_classification(num_clients=64, num_classes=10, feat_shape=(32,),
                                        samples_per_client=32, partition_method="hetero", seed=0)
        model = create_model("lr", "synthetic", (32,), 10)
        scale = {}
        for n in (big_n, mid_n):
            data = _tiled(base, n)
            cfg = _scale_config(n, rounds + 1, selection="weighted", state_store="sharded",
                                state_dir=str(Path(tmp) / f"state_{n}"))
            t0 = time.perf_counter()
            api = ScaffoldAPI(cfg, data, model, device=device)
            build_s = time.perf_counter() - t0
            if api.state.mode != "sharded" or not isinstance(api.state.store, ShardedClientState):
                raise AssertionError(f"scaffold at {n}: state in {api.state.mode}")
            if api.scheduler._ctx.index is None:
                raise AssertionError(f"scaffold at {n}: the O(cohort) draw is off")
            secs = _sync_rounds(api, range(rounds))
            _cohort_replay(api, "weighted", data.train_sample_counts, range(rounds))
            spill = api.state.spill_ms[warm:]
            # a synchronous read of a cohort no round has read (the pending
            # prefetch joined first), beside the rounds' prefetched takes
            api.state.close()
            store = api.state.store
            ids = api.scheduler.select(rounds + 7)
            t0 = time.perf_counter()
            store.gather(ids)
            sync_gather_ms = (time.perf_counter() - t0) * 1e3
            scale[n] = {"api_build_s": build_s, "round_s": secs,
                        "warm_round_s": float(np.mean(secs[warm:])),
                        "state_bytes_logical": store.state_bytes_total,
                        "state_rows_touched": store.initialized_count(),
                        "shards": len(store._shards),
                        "gather_ms": [s["gather_ms"] for s in spill],
                        "scatter_ms": [s["scatter_ms"] for s in spill],
                        "sync_gather_ms": sync_gather_ms}
            log(f"[population] scaffold {n}: " + json.dumps(scale[n]))
            del api, data, store
            gc.collect()
        big, mid = scale[big_n], scale[mid_n]
        report["scaffold_scale"] = {
            "by_clients": scale,
            "ratio_1m_over_100k": big["warm_round_s"] / mid["warm_round_s"],
            # the prefetch hides the gather when the round's take() waits
            # less than a synchronous read of a cohort
            "prefetch_hides_gather": float(np.median(big["gather_ms"])) < big["sync_gather_ms"],
        }

        # (c) the three tiers bit-equal at mid_n
        tiers = {}
        data = _tiled(base, mid_n)
        with _deterministic_convs():
            for mode in ("device", "mmap", "sharded"):
                cfg = _scale_config(mid_n, SCALE_TIERS_ROUNDS, selection="weighted",
                                    state_store=mode, state_dir=str(Path(tmp) / f"tier_{mode}"))
                api = ScaffoldAPI(cfg, data, model, device=device)
                if api.state.mode != mode:
                    raise AssertionError(f"tiers: state in {api.state.mode}, asked for {mode}")
                _sync_rounds(api, range(SCALE_TIERS_ROUNDS))
                touched = sorted({c for r in range(SCALE_TIERS_ROUNDS)
                                  for c in api.scheduler.select(r).tolist()})
                tiers[mode] = _stateful_snapshot(api, touched)
                api.state.close()
                del api
        for mode in ("mmap", "sharded"):
            for part in ("global", "c_server", "rows"):
                _assert_bit_equal(tiers[mode][part], tiers["device"][part], f"tiers {mode} {part}")
        report["tiers_bit_equal"] = {"clients": mid_n, "rounds": SCALE_TIERS_ROUNDS,
                                     "rows_compared": len(touched)}
    report["tmp_removed"] = not Path(tmp).exists()
    log("[population] " + json.dumps(report, default=str))
    return report


# phase 20: the model-bound algorithms at the reference's full widths
MODELBOUND = dict(
    # FedSeg: Pascal VOC's 21 classes at 128×128, 10 clients of 32 images,
    # all in every round, batch 8, lr 0.05, 3 rounds, eval every round
    seg=dict(classes=21, image=128, clients=10, samples=32, batch=8, lr=0.05, rounds=3,
             width=32, cpu_clients=2),
    # FedGKT: ResNet-56 cut after its stem (client blocks 2, server (6, 6))
    # on the cross-silo CIFAR geometry, batch 64, lr 0.01, 2 rounds
    gkt=dict(clients=10, samples=512, batch=64, lr=0.01, rounds=2, blocks=2, layers=(6, 6)),
    # FedGAN: MNISTGan on the north star's femnist_synthetic(128), 10 a
    # round, batch 20, lr 2e-4, 3 rounds
    gan=dict(clients=128, per_round=10, batch=20, lr=2e-4, rounds=3, generate=64),
    # FedNAS: DARTSNetwork at its class defaults on CIFAR geometry, 10
    # clients of 64, 4 a round, batch 16
    nas=dict(clients=10, samples=64, per_round=4, batch=16, ch=16, cells=3, steps=4),
    cli=dict(clients=3, per_round=2),
)
# card vs CPU after one FedSeg round of one full-batch step (32 images) for
# each of 2 clients, (rtol, atol) on the params and the running statistics:
# the encoder-decoder's float32 convolutions sum in other orders on the
# card, and BatchNorm divides by the batch's σ. On the CPU alone a 1e-7
# relative nudge of the init moves this round's params by 3.6e-7 and its
# running statistics by 6.2e-6; an NVIDIA H100 80GB HBM3 (700 W) moved the
# params by 1.34e-5; the bound is 7x that.
SEG_CARD_VS_CPU = (1e-5, 1e-4)
# card vs CPU after one FedGAN round of one full-batch step a client with
# the same latent draws. Adam's first step is lr·g/(|g| + 1e-8): an element
# whose gradient is near 1e-8 (G's pre-BN biases, whose gradient BatchNorm
# cancels, and others) moves by a share of lr that the gradient's rounding
# sets. On the CPU alone a 1e-7 relative nudge of the init moves this
# round's params by up to 4.5e-5 (G) and 2.0e-6 (D), its running
# statistics by 1.2e-7 and its loss sums by < 1e-6; the params are held to
# one step's lr, the statistics and loss sums to ~100x their nudge.
GAN_CARD_VS_CPU = {"params": (0.0, MODELBOUND["gan"]["lr"]), "stats": (1e-5, 1e-5),
                   "loss_rtol": 1e-5}
# the second-order α-gradient of one step, card vs CPU: |err| <= tol ·
# max|grad|. Two backward passes through 14 mixed edges of 6 ops in float32,
# each summing in another order on the card
NAS_GRAD_CARD_VS_CPU = 1e-3
# the rows of the reference's runners (fedml_tpu/cli.py _run_fedseg,
# _run_fedgkt, _run_fedgan, _run_fednas)
MODELBOUND_ROW_KEYS = {
    "fedseg": ["Test/Acc", "Test/Acc_class", "Test/FWIoU", "Test/mIoU", "Train/Acc",
               "Train/Loss", "round"],
    "fedgkt": ["Test/Acc", "round"],
    "fedgan": ["Train/D_Loss", "Train/G_Loss", "round"],
    "fednas": ["Test/Acc", "genotype", "round"],
}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_vars(variables) -> dict:
    return {k: v.detach().float().cpu() for k, v in variables.items()}


def _assert_close_vars(got: dict, want: dict, tol, what: str) -> float:
    """max |got − want| over the variables, each within rtol·|want| + atol."""
    rtol, atol = tol
    worst = 0.0
    for k, w in want.items():
        err = (got[k] - w).abs()
        bound = rtol * w.abs() + atol
        if bool((err > bound).any()):
            raise AssertionError(f"{what}: {k} off by {float(err.max())} (> its bound)")
        worst = max(worst, float(err.max()))
    return worst


def _profile_fn(fn) -> dict:
    """One call of ``fn`` under torch.profiler, tracing the device only:
    its wall ms, kernel launches, device kernel ms, busy share and top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "wall_ms_profiled": wall_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "top_kernels_ms_calls": {e.key[:60]: [e.self_device_time_total / 1e3, e.count]
                                 for e in top},
    }


def _modelbound_seg(report, device, cfg_mod, seg, tmp):
    import dataclasses

    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
    from fedml_tpu_torch.data.synthetic import synthetic_segmentation
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    data = synthetic_segmentation(num_clients=seg["clients"], num_classes=seg["classes"],
                                  image_size=seg["image"], samples_per_client=seg["samples"],
                                  seed=0)
    shape = (seg["image"], seg["image"], 3)
    model = create_model("segnet", "seg_synth", shape, seg["classes"], width=seg["width"])
    cfg = cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=seg["batch"]),
        fed=cfg_mod.FedConfig(client_num_in_total=seg["clients"],
                              client_num_per_round=seg["clients"], comm_round=seg["rounds"],
                              epochs=1, frequency_of_the_test=1),
        train=cfg_mod.TrainConfig(lr=seg["lr"]), seed=0)
    ckpt = str(Path(tmp) / "seg_best")
    api = FedSegAPI(cfg, data, model, checkpoint_path=ckpt, device=device)
    round_s, eval_s = [], []
    orig_eval = api.evaluate_seg

    def timed_eval(*a, **kw):
        _sync(device)
        t = time.perf_counter()
        out = orig_eval(*a, **kw)
        eval_s.append(time.perf_counter() - t)
        return out

    api.evaluate_seg = timed_eval
    orig_round = api.train_round

    def timed_round(r):
        _sync(device)
        t = time.perf_counter()
        out = orig_round(r)
        float(out[1]["count"])
        round_s.append(time.perf_counter() - t)
        return out

    api.train_round = timed_round
    api.train()
    rows = api.history
    _finite_rows(rows, "fedseg")
    for row in rows:
        for key in ("Test/mIoU", "Test/FWIoU", "Test/Acc", "Test/Acc_class"):
            if not 0.0 <= row[key] <= 1.0:
                raise AssertionError(f"fedseg: {key} = {row[key]} outside [0, 1]")
        if sorted(row) != MODELBOUND_ROW_KEYS["fedseg"]:
            raise AssertionError(f"fedseg: row keys {sorted(row)}")
    mious = [row["Test/mIoU"] for row in rows]
    best = int(np.argmax(mious))  # the first maximum, as the strict '>' promotes
    _, ckpt_round, *_ = load_checkpoint(ckpt)
    meta = json.load(open(ckpt + ".json"))
    if ckpt_round != best or meta["best_miou"] != mious[best]:
        raise AssertionError(f"fedseg: checkpoint of round {ckpt_round} ({meta}), best is {best}")
    entry = {
        "rows": rows, "round_s": round_s, "warm_round_s": round_s[1:], "eval_s": eval_s,
        "best_round": best, "checkpoint_round": ckpt_round,
        "params": model.num_params(),
    }
    if torch.device(device).type == "cuda":
        entry["profile_round"] = _profile_round(api, seg["rounds"])
    # one round of one full-batch step for each of 2 clients, card vs CPU
    cpu_cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=-1),
        fed=dataclasses.replace(cfg.fed, client_num_per_round=seg["cpu_clients"], comm_round=1))
    init = model.init(torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", device):
        a = FedSegAPI(cpu_cfg, data, model, device=dev)
        a.global_vars = {k: v.to(a.device) for k, v in init.items()}
        a.train_round(0)
        out[dev] = _host_vars(a.global_vars)
    entry["card_vs_cpu_max_abs"] = _assert_close_vars(out[device], out["cpu"], SEG_CARD_VS_CPU,
                                                      "fedseg card vs CPU")
    entry["card_vs_cpu_tol"] = SEG_CARD_VS_CPU
    entry["phase_s"] = time.perf_counter() - t0
    report["fedseg"] = entry


def _modelbound_gkt(report, device, gkt, profile):
    import numpy as np

    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI

    t0 = time.perf_counter()
    data = _cifar_geometry(gkt["clients"], RESNET["classes"], gkt["samples"])
    clients = [(data.client_x[i], data.client_y[i]) for i in range(gkt["clients"])]
    api = FedGKTAPI(num_classes=RESNET["classes"], input_shape=RESNET["shape"],
                    client_blocks=gkt["blocks"], server_layers=gkt["layers"], lr=gkt["lr"],
                    device=device)
    cache, rounds = None, []
    for r in range(gkt["rounds"]):
        t = time.perf_counter()
        cache = api.train_round(clients, batch_size=gkt["batch"], server_logits_cache=cache)
        rounds.append({"round_s": time.perf_counter() - t, "stage_s": api.stage_s,
                       "mean_loss": api.losses})
        if not all(np.isfinite(v) for v in api.losses.values()):
            raise AssertionError(f"fedgkt: round {r} losses {api.losses}")
    if sorted(cache) != list(range(gkt["clients"])) or any(
            c.shape != (gkt["samples"], RESNET["classes"]) for c in cache.values()):
        raise AssertionError("fedgkt: the server-logit cache")
    h, w, _ = RESNET["shape"]
    acc = api.evaluate(data.test_x, data.test_y, client_id=0)
    profiled = None
    if profile:
        profiled = _profile_fn(lambda: api.train_round(clients, batch_size=gkt["batch"],
                                                       server_logits_cache=cache))
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"fedgkt: accuracy {acc}")
    report["fedgkt"] = {
        "rounds": rounds, "test_acc": acc, "profile_round": profiled,
        "upload_feature_bytes_a_client": gkt["samples"] * h * w * 16 * 4,
        "client_params": api.client_model.num_params(),
        "server_params": api.server_model.num_params(),
        "phase_s": time.perf_counter() - t0,
    }


def _modelbound_gan(report, device, cfg_mod, gan, profile):
    import numpy as np
    import torch

    from fedml_tpu_torch.algorithms.fedgan import FedGANAPI, make_gan_model_def
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic

    t0 = time.perf_counter()
    data = femnist_synthetic(num_clients=gan["clients"], seed=0)
    cfg = cfg_mod.RunConfig(
        data=cfg_mod.DataConfig(batch_size=gan["batch"]),
        fed=cfg_mod.FedConfig(client_num_in_total=gan["clients"],
                              client_num_per_round=gan["per_round"], comm_round=gan["rounds"],
                              epochs=1),
        train=cfg_mod.TrainConfig(lr=gan["lr"]), seed=0)
    api = FedGANAPI(cfg, data, device=device)
    losses, secs = [], []
    for r in range(gan["rounds"]):
        _sync(device)
        t = time.perf_counter()
        _, mets = api.train_round(r)
        count = float(mets["count"])
        secs.append(time.perf_counter() - t)
        losses.append([float(mets["loss_sum"]) / count, float(mets["correct"]) / count])
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"fedgan: losses {losses}")
    profiled = None
    if profile:
        profiled = _profile_fn(lambda: float(api.train_round(gan["rounds"])[1]["count"]))
    fake = api.generate(gan["generate"])
    if tuple(fake.shape) != (gan["generate"], 28, 28, 1) or float(fake.abs().max()) > 1.0:
        raise AssertionError("fedgan: generate() outside tanh's range")
    # one round of one full-batch step a client on the card against the
    # CPU, the same latent draws (a CPU generator), from one init
    init = make_gan_model_def().init(torch.Generator().manual_seed(1))

    def z_fn(r, slot, step, shape):
        key = int(np.random.SeedSequence([7, r, slot, step]).generate_state(1)[0])
        return torch.randn(shape, generator=torch.Generator().manual_seed(key))

    out = {}
    for dev in ("cpu", device):
        a = FedGANAPI(_full_batch(cfg), data, device=dev, z_fn=lambda *z: z_fn(*z).to(dev))
        a.global_vars = {k: v.to(a.device) for k, v in init.items()}
        _, mets = a.train_round(0)
        out[dev] = (_host_vars(a.global_vars), float(mets["loss_sum"]), float(mets["correct"]))
    errs = {}
    for kind in ("params", "stats"):
        pick = lambda t: {k: v for k, v in t.items() if k.startswith("batch_stats.") == (
            kind == "stats")}
        errs[kind] = _assert_close_vars(pick(out[device][0]), pick(out["cpu"][0]),
                                        GAN_CARD_VS_CPU[kind], f"fedgan card vs CPU {kind}")
    for i in (1, 2):
        if not math.isclose(out[device][i], out["cpu"][i], rel_tol=GAN_CARD_VS_CPU["loss_rtol"]):
            raise AssertionError(f"fedgan card vs CPU: loss sums {out[device][i]} {out['cpu'][i]}")
    report["fedgan"] = {
        "round_s": secs, "warm_round_s": secs[1:], "G_D_loss": losses,
        "profile_round": profiled,
        "generate_max_abs": float(fake.abs().max()), "card_vs_cpu_max_abs": errs,
        "card_vs_cpu_tol": GAN_CARD_VS_CPU,
        "params": make_gan_model_def().num_params(), "phase_s": time.perf_counter() - t0,
    }


def _modelbound_nas(report, device, nas, profile):
    import torch

    from fedml_tpu_torch.algorithms.fednas import FedNASAPI
    from fedml_tpu_torch.device import fp32_math

    t0 = time.perf_counter()
    data = _cifar_geometry(nas["clients"], RESNET["classes"], nas["samples"])
    kw = dict(num_classes=RESNET["classes"], input_shape=RESNET["shape"], ch=nas["ch"],
              cells=nas["cells"], steps=nas["steps"], batch_size=nas["batch"])
    on_card = torch.device(device).type == "cuda"
    entry = {}
    for arch_grad in ("first", "second"):
        api = FedNASAPI(data, arch_grad=arch_grad, device=device, **kw)
        if on_card:  # the peak above what earlier phases still hold
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        secs = []
        for r in range(2):  # round 0 the warm-up
            _sync(device)
            t = time.perf_counter()
            geno = api.train_round(r, client_num_per_round=nas["per_round"])
            _sync(device)
            secs.append(time.perf_counter() - t)
        alpha = api.variables["alpha_normal"]
        if not bool(torch.isfinite(alpha).all()) or len(geno) != 2 * nas["steps"]:
            raise AssertionError(f"fednas {arch_grad}: α or genotype {geno}")
        entry[arch_grad] = {
            "round_s": secs, "genotype": [list(g) for g in geno],
            "peak_mem_bytes": (torch.cuda.max_memory_allocated() - base) if on_card
            else "not measured",
            "profile_round": _profile_fn(lambda: api.train_round(
                2, client_num_per_round=nas["per_round"])) if profile else None,
            "test_acc": api.evaluate(data.test_x, data.test_y),
        }
    entry["params"] = api.model.num_params()
    # the unrolled α-gradient of one step, card vs CPU, from one init
    x = torch.from_numpy(data.client_x[0][: 2 * nas["batch"]])
    y = torch.from_numpy(data.client_y[0][: 2 * nas["batch"]]).long()
    grads = {}
    for dev in ("cpu", device):
        a = FedNASAPI(data, arch_grad="second", device=dev, init_vars=api.model.init(
            torch.Generator().manual_seed(2)), **kw)
        B = nas["batch"]
        xd, yd = x.to(a.device), y.to(a.device)
        with fp32_math():
            _, g = a.unrolled_arch_grads(a.variables, xd[B:], yd[B:], xd[:B], yd[:B])
        grads[dev] = _host_vars(g)
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    err = max(float((grads[device][k] - grads["cpu"][k]).abs().max()) for k in grads["cpu"])
    if not err <= NAS_GRAD_CARD_VS_CPU * scale:
        raise AssertionError(f"fednas: second-order α-gradient card vs CPU {err} (scale {scale})")
    entry.update(second_order_grad_card_vs_cpu=err, grad_scale=scale,
                 tol=NAS_GRAD_CARD_VS_CPU, phase_s=time.perf_counter() - t0)
    report["fednas"] = entry


def _modelbound_cli(report, device, tmp, cli_sizes):
    from fedml_tpu_torch import cli

    t0 = time.perf_counter()
    small = ["--comm_round", "1", "--client_num_in_total", str(cli_sizes["clients"]),
             "--client_num_per_round", str(cli_sizes["per_round"])]
    runs = {
        "fedseg": ["--model", "segnet", "--dataset", "seg_synth", "--batch_size", "8"],
        "fedgkt": ["--dataset", "femnist_synth", "--batch_size", "16"],
        "fedgan": ["--model", "mnistgan", "--dataset", "femnist_synth", "--batch_size", "16",
                   "--lr", "2e-4"],
        "fednas": ["--dataset", "synthetic", "--batch_size", "16", "--variant", "second"],
    }
    out = {}
    for algo, extra in runs.items():
        log_dir = Path(tmp) / f"cli_{algo}"
        t = time.perf_counter()
        cli.main(["--algorithm", algo, "--log_dir", str(log_dir)] + small + extra, device=device)
        lines = (log_dir / "metrics.jsonl").read_text().splitlines()
        rows = [{k: v for k, v in json.loads(line).items() if not k.startswith("_")}
                for line in lines]
        want = MODELBOUND_ROW_KEYS[algo]
        final = [r for r in rows if set(want) <= set(r)]
        if not final or sorted(final[-1]) != want:
            raise AssertionError(f"cli {algo}: rows {rows}")
        out[algo] = {"s": time.perf_counter() - t, "row": final[-1]}
    out["phase_s"] = time.perf_counter() - t0
    report["cli"] = out


def phase_modelbound(smi: str, device="cuda", profile=False, **smaller) -> dict:
    """FedSeg, FedGKT, FedGAN and FedNAS at the reference's full widths
    (phase 20); see the module docstring. ``smaller`` overrides entries of
    MODELBOUND for a rehearsal on the CPU. ``profile`` also traces a warm
    round of FedGKT, FedGAN and each FedNAS architect on the card (their
    80k-360k launches take ~3 min of host time to collect, so the
    whole-script run leaves them out; FedSeg's round is always traced).
    This phase launches none of K1-K4: its models compute with
    cuDNN/cuBLAS and PyTorch's own kernels."""
    import tempfile

    import fedml_tpu_torch.config as cfg_mod

    sizes = {k: {**v, **smaller.get(k, {})} for k, v in MODELBOUND.items()}
    report = {"card": smi, "kernels": "none: slice 11's path runs no kernel of K1-K4"}
    with tempfile.TemporaryDirectory() as tmp:
        _modelbound_seg(report, device, cfg_mod, sizes["seg"], tmp)
        _modelbound_gkt(report, device, sizes["gkt"], profile)
        _modelbound_gan(report, device, cfg_mod, sizes["gan"], profile)
        _modelbound_nas(report, device, sizes["nas"], profile)
        _modelbound_cli(report, device, tmp, sizes["cli"])
    log("[modelbound] " + json.dumps(report, default=str))
    return report


# ---------------------------------------------------------------- phase 21

# (a) the flagship LM under the batched schedule beside the loop, 2 rounds
# each (round 0 the warm-up), then one profiled round each
BATCHED_LM_ROUNDS = 2
# vmap against the loop after those rounds (bf16 compute, AMSGrad lr 1e-3,
# 16 steps a client a round). Batched and single bf16 matmuls round at
# different places (~1 bf16 ulp, 2^-8), and AMSGrad divides each gradient
# by its own running magnitude, so a near-zero coordinate's rounding noise
# becomes a step of up to ~lr in either direction: no elementwise bound
# below lr·steps holds. What must hold is that both schedules move the
# model the same way and report the same losses: the two global updates'
# cosine over every parameter, and each round's Train/Loss within the
# relative bound, which is ~4 bf16 ulps of a loss averaged over 131,072
# tokens.
BATCHED_LM_TOL = {"cosine": 0.95, "loss_rtol": 2.0**-6}
# a cohort the card cannot hold at once: the LM's geometry with 24
# clients of 64 samples (2 steps each), 2 rounds: the first's full
# cohort runs out of memory and is retried in halves, the second runs in
# the groups that fit (BatchedLocalTrain.max_clients)
BATCHED_LM_COHORT = dict(clients=24, samples=64)
# (b) VGG-11 on an ImageNet-format tree: 1000 classes, one 224×224 image a
# class (the tree ~602 MB, the store as much again), 10 homo clients,
# batch 32, SGD lr 0.01, 2 rounds; (c) EfficientNet-B0 on a gld23k-format
# tree: 203 classes over the train and test mappings, 10 users × 32
# images, 32 test images, batch 32, SGD lr 0.01, 2 rounds
ZOO = dict(image=224, vgg_classes=1000, clients=10, batch=32, lr=0.01, rounds=2,
           gld_classes=203, gld_users=10, gld_per_user=32, gld_test=32, cpu_images=2)
ZOO_MIN_FREE_BYTES = 2 << 30
# card vs CPU after one full-batch SGD step on 2 images at 224, every
# dropout rate 0 (the two devices' generators draw different masks), with
# TF32 off: the float32 convolutions sum in other orders on the card, and
# one step moves a parameter by lr·g, so the bound is on lr·|Δg|; the
# running statistics (EfficientNet) are batch moments of 2 images
ZOO_CARD_VS_CPU = {"params": (1e-4, 1e-6), "stats": (1e-4, 1e-5)}


def expected_batched_flash_launches(api, layers: int) -> dict:
    """K2/K3/K4 launches of ``api.train()`` under the batched schedule:
    one launch per layer of each kernel for every batched step that holds
    data for some client (the longest shard's ceil(n / batch) an epoch:
    the shuffle puts each client's valid samples first), whatever the
    cohort's size; and one K2 per layer for every eval batch."""
    from fedml_tpu_torch.ops import flash_attention as fa

    cfg = api.config
    B, steps = cfg.data.batch_size, 0
    for r in range(cfg.fed.comm_round):
        counts = api.data.train_sample_counts[api.scheduler.select(r)]
        steps += max(-(-int(n) // B) for n in counts) * cfg.fed.epochs
    evals = sum(api._is_eval_round(r) for r in range(cfg.fed.comm_round))
    eval_batches = evals * api._eval_batches()[0].shape[0]
    return {fa.FWD: layers * (steps + eval_batches), fa.BWD_DQ: layers * steps,
            fa.BWD_DKV: layers * steps, "steps": steps, "eval_batches": eval_batches}


@contextlib.contextmanager
def _counting_fallbacks(counts: dict):
    """Count calls of the flash kernels' plain versions and of SDPA within
    the block (the batched path must make none on the card)."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import flash_attention as fa

    def counted(owner, name):
        real = getattr(owner, name)

        def fn(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **k)

        setattr(owner, name, fn)
        return real

    names = [(fa, n) for n in ("flash_forward_plain", "flash_backward_dq_plain",
                               "flash_backward_dkv_plain")] + [(F, "scaled_dot_product_attention")]
    saved = [(owner, n, counted(owner, n)) for owner, n in names]
    try:
        yield
    finally:
        for owner, n, real in saved:
            setattr(owner, n, real)


def _fold_bit_equality(device) -> dict:
    """K2, K3 and K4 on the batched LM's folded shape [C·B·H, S, d] =
    [8·32·8, 256, 96] bf16 causal, bit-equal to the same kernels launched
    per client on [B·H, S, d]; then ``torch.func.vmap`` of flash attention
    and of its gradient, which fold through the Functions' vmap rules,
    bit-equal on the card to the per-client autograd path (one launch of
    each kernel for the cohort against C). The launches are restored
    after: they are no path's."""
    import torch

    from fedml_tpu_torch.ops import flash_attention as fa

    C, BH, S, d = LM["clients"], LM["batch"] * LM["heads"], LM["seq"], LM["width"] // LM["heads"]
    gen = torch.Generator(device=device).manual_seed(21)
    q, k, v, do = (torch.randn(C * BH, S, d, generator=gen, device=device).bfloat16()
                   for _ in range(4))
    scale, blk = d**-0.5, fa.KERNEL_TILE
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward(q, k, v, scale, True, blk, blk)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, scale, True, blk, blk)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, scale, True, blk, blk)
    for c in range(C):
        sl = slice(c * BH, (c + 1) * BH)
        args = (q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], scale, True, blk, blk)
        oc, lc = fa.flash_forward(q[sl], k[sl], v[sl], scale, True, blk, blk)
        dqc = fa.flash_backward_dq(*args)
        dkc, dvc = fa.flash_backward_dkv(*args)
        for what, got, want in (("O", o[sl], oc), ("LSE", lse[sl], lc), ("dQ", dq[sl], dqc),
                                ("dK", dk[sl], dkc), ("dV", dv[sl], dvc)):
            if not torch.equal(got, want):
                raise AssertionError(f"folded {what} of client {c} differs from its own launch "
                                     f"by {(got.float() - want.float()).abs().max().item()}")
    # through the vmap rules: [C, BH, S, d] with the client axis vmapped
    qc, kc, vc, doc = (t.view(C, BH, S, d) for t in (q, k, v, do))

    def attn(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, block_q=blk, block_k=blk)

    def loss(q, k, v, do):
        return torch.sum(attn(q, k, v).float() * do.float())

    mark = fa.launch_totals()
    out_v = torch.func.vmap(attn)(qc, kc, vc)
    grads_v = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(qc, kc, vc, doc)
    vmap_launches = {kn: n - mark[kn] for kn, n in fa.launch_totals().items()}
    mark = fa.launch_totals()
    err = 0.0
    for c in range(C):
        qi, ki, vi = (t[c].clone().requires_grad_(True) for t in (qc, kc, vc))
        out_c = attn(qi, ki, vi)
        grads_c = torch.autograd.grad(torch.sum(out_c.float() * doc[c].float()), (qi, ki, vi))
        for got, want in [(out_v[c], out_c)] + [(g[c], w) for g, w in zip(grads_v, grads_c)]:
            err = max(err, (got.float() - want.float()).abs().max().item())
    loop_launches = {kn: n - mark[kn] for kn, n in fa.launch_totals().items()}
    fa.LAUNCHES.update(before)
    want_v = {fa.FWD: 2, fa.BWD_DQ: 1, fa.BWD_DKV: 1}  # vmap(attn), then vmap(grad)'s forward
    want_l = {kn: C for kn in fa.KERNEL_NAMES}  # one forward a client serves both
    if device == "cuda" and (vmap_launches != want_v or loop_launches != want_l):
        raise AssertionError(f"vmap rules launched {vmap_launches} (want {want_v}), the loop "
                             f"{loop_launches} (want {want_l})")
    if device == "cuda" and err != 0.0:
        raise AssertionError(f"vmap through the Functions' rules differs from the per-client "
                             f"autograd path by {err}")
    return {"folded_shape": [C * BH, S, d], "bit_equal": err == 0.0,
            "vmap_rule_launches": vmap_launches, "per_client_launches": loop_launches,
            "vmap_rule_vs_per_client_max_abs_err": err}


def _batched_lm_run(schedule: str, device, rounds: int, profile: bool = True,
                    **smaller) -> dict:
    """The flagship LM under ``schedule`` ("vmap" or "scan"): ``rounds``
    rounds with K2-K4 counted exactly (zeroed just before, read just
    after), fallback calls counted, peak memory; then, with ``profile``,
    one profiled round."""
    import dataclasses

    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.ops import flash_attention as fa

    layers = smaller.pop("layers", LM["layers"])
    cfg, data, model = _flagship_lm(rounds, layers, **smaller)
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, client_parallelism=schedule))
    api = FedAvgAPI(cfg, data, model, task="nwp", device=device)
    batched = api._client_schedule == "vmap"
    if batched != (schedule == "vmap"):
        raise AssertionError(f"client_parallelism={schedule} ran the {api._client_schedule}")
    init = _host(api.global_vars)
    want = (expected_batched_flash_launches if batched else expected_flash_launches)(api, layers)
    fallbacks = {}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated() if on_card else "not measured"
    fa.reset_launches()  # zeroed just before the path
    with _counting_fallbacks(fallbacks):
        api.train()
    launches = fa.launch_totals()  # read just after
    by_dtype = {f"{kn}:{t}": n for (kn, t), n in fa.LAUNCHES.items()}
    rows = api.history
    for row in rows:
        if not all(math.isfinite(row[k]) for k in ("Train/Loss", "Train/Acc")):
            raise AssertionError(f"LM {schedule}: non-finite row {row}")
    for name in fa.KERNEL_NAMES:
        expect = want[name] if on_card else 0
        if launches[name] != expect:
            raise AssertionError(f"LM {schedule}: {launches[name]} {name} launches, want {expect}")
    if on_card and fallbacks:
        raise AssertionError(f"LM {schedule}: plain or SDPA calls on the card's path: {fallbacks}")
    out = {"schedule": api._client_schedule, "launches": launches,
           "launches_by_dtype": by_dtype, "expected": want, "fallback_calls": fallbacks,
           "round_time_s": [r["round_time_s"] for r in rows],
           "train_loss": [r["Train/Loss"] for r in rows],
           "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else "not measured",
           "base_mem_bytes": base_mem}
    # the model after the counted rounds (a profiled round trains a third)
    out["vars"], out["init"] = _host(api.global_vars), init
    steps_a_round = want["steps"] // rounds
    if on_card and profile:
        prof = _profile_round(api, rounds)
        prof["launches_a_step"] = prof["kernel_launches"] / steps_a_round
        out["profile"] = prof
    out["steps_a_round"] = steps_a_round
    return out


def _write_imagenet_tree(root, classes: int, image: int, seed: int = 0) -> None:
    """An ImageFolder train/ tree, one ``.npy`` image a class (float32 in
    [0, 1), as a decoded image), no val/: the loader holds out a tenth."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, "train", f"n{c:08d}")
        os.makedirs(d)
        np.save(os.path.join(d, "img0.npy"), rng.random((image, image, 3), dtype=np.float32))


def _write_gld_tree(root, classes: int, users: int, per_user: int, test: int, image: int,
                    seed: int = 0) -> None:
    """gld23k's mapping files (``mini_gld_train_split.csv`` with user_id,
    image_id, class; ``mini_gld_test.csv``) and ``images/<id>.npy``: the
    train rows cover classes 0..classes-4, the test rows the last three
    and others, so the class index needs both files."""
    import csv

    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    train_classes = classes - 3
    train = [{"user_id": f"u{u:03d}", "image_id": f"t{u:03d}_{i:03d}",
              "class": str((u * per_user + i) % train_classes)}
             for u in range(users) for i in range(per_user)]
    tests = [{"image_id": f"v{i:03d}", "class": str(train_classes + i if i < 3
                                                    else i % train_classes)}
             for i in range(test)]
    for row in train + tests:
        np.save(os.path.join(root, "images", row["image_id"] + ".npy"),
                (rng.random((image, image, 3), dtype=np.float32) - 0.5) / 0.5)
    for name, rows, fields in (("mini_gld_train_split.csv", train, ["user_id", "image_id", "class"]),
                               ("mini_gld_test.csv", tests, ["image_id", "class"])):
        with open(os.path.join(root, name), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)


def _zoo_run(model, data, device, rounds: int, lr: float, batch: int, clients: int) -> dict:
    """FedAvgAPI of ``model`` on ``data``, all ``clients`` every round:
    round times, losses, peak memory, then a profiled warm round."""
    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig

    cfg = RunConfig(data=DataConfig(batch_size=batch),
                    fed=FedConfig(client_num_in_total=clients, client_num_per_round=clients,
                                  comm_round=rounds, epochs=1, frequency_of_the_test=10_000),
                    train=TrainConfig(client_optimizer="sgd", lr=lr), seed=0)
    api = FedAvgAPI(cfg, data, model, device=device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    api.train()
    rows = api.history
    for row in rows:
        if not all(math.isfinite(row[k]) for k in ("Train/Loss", "Test/Loss")
                   if k in row):
            raise AssertionError(f"{model.name}: non-finite row {row}")
    steps = sum(-(-int(n) // batch) for n in data.train_sample_counts[:clients])
    out = {"schedule": api._client_schedule, "client_mode": api._client_mode,
           "params": model.num_params(), "round_time_s": [r["round_time_s"] for r in rows],
           "train_loss": [r["Train/Loss"] for r in rows],
           "test_acc": [r["Test/Acc"] for r in rows if "Test/Acc" in r],
           "client_steps_a_round": steps,
           "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else "not measured"}
    if on_card:
        prof = _profile_round(api, rounds)
        prof["launches_a_step"] = prof["kernel_launches"] / steps
        out["profile"] = prof
    return out


def _zoo_card_vs_cpu(make_model, x, y, device) -> dict:
    """One full-batch SGD step of a one-client round on ``x`` (2 images) on
    the card and on the CPU from the same init (ZOO_CARD_VS_CPU)."""
    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI
    from fedml_tpu_torch.config import DataConfig, FedConfig, RunConfig, TrainConfig
    from fedml_tpu_torch.data.base import FederatedDataset

    data = FederatedDataset(name="two", client_x=[x], client_y=[y], test_x=x, test_y=y,
                            num_classes=int(y.max()) + 1)
    cfg = RunConfig(data=DataConfig(batch_size=-1),
                    fed=FedConfig(client_num_in_total=1, client_num_per_round=1, comm_round=1,
                                  epochs=1, frequency_of_the_test=10_000),
                    train=TrainConfig(client_optimizer="sgd", lr=ZOO["lr"]), seed=0)
    out, secs = {}, {}
    model = make_model()
    init = model.init(torch.Generator().manual_seed(cfg.seed))  # once, for both devices
    model.init = lambda generator: {k: v.clone() for k, v in init.items()}
    for dev in ("cpu", device):
        api = FedAvgAPI(cfg, data, model, device=dev)
        t0 = time.perf_counter()
        api.train_round(0)
        _sync(dev)
        secs[dev] = time.perf_counter() - t0
        out[dev] = _host_vars(api.global_vars)
    from fedml_tpu_torch.models import split_stats

    (cpu_p, cpu_s), (card_p, card_s) = split_stats(out["cpu"]), split_stats(out[device])
    return {"params_max_abs_err": _assert_close_vars(card_p, cpu_p, ZOO_CARD_VS_CPU["params"],
                                                     "card vs CPU params"),
            "stats_max_abs_err": _assert_close_vars(card_s, cpu_s, ZOO_CARD_VS_CPU["stats"],
                                                    "card vs CPU stats") if cpu_s else None,
            "cpu_step_s": secs["cpu"], "card_step_s": secs[device]}


@contextlib.contextmanager
def _no_dropout_b0():
    """EfficientNet-B0 with its head's dropout at 0, for the card-vs-CPU
    step."""
    from fedml_tpu_torch.models import efficientnet

    saved = efficientnet.COEFFS["b0"]
    efficientnet.COEFFS["b0"] = saved[:2] + (0.0,)
    try:
        yield
    finally:
        efficientnet.COEFFS["b0"] = saved


def _batched_lm_report(device, lm: dict) -> dict:
    """Phase 21 (a): the LM's vmap and loop runs, their agreement and the
    fold's bit-equality."""
    import numpy as np

    t0 = time.perf_counter()
    # the loop's profile is phase 10's (the same configuration): tracing
    # its ~200k launches a round costs ~40 s of the script
    runs = {s: _batched_lm_run(s, device, BATCHED_LM_ROUNDS, profile=s == "vmap", **lm)
            for s in ("scan", "vmap")}
    vm, lp = runs["vmap"], runs["scan"]
    du = np.concatenate([(vm["vars"][k] - vm["init"][k]).double().numpy().ravel()
                         for k in sorted(vm["init"])])
    dw = np.concatenate([(lp["vars"][k] - lp["init"][k]).double().numpy().ravel()
                         for k in sorted(lp["init"])])
    cosine = float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(vm["train_loss"], lp["train_loss"]))
    max_abs = max((vm["vars"][k] - lp["vars"][k]).abs().max().item() for k in lp["vars"])
    for r in runs.values():
        del r["vars"], r["init"]
    on_card = device == "cuda"
    out = {"vmap": vm, "loop": lp, "update_cosine": cosine, "loss_max_rel": loss_rel,
           "params_max_abs_diff": max_abs, "tol": BATCHED_LM_TOL,
           # the batched schedule's device memory a client: the vmap run's
           # peak above what was allocated before it, over its cohort
           "vmap_bytes_a_client": ((vm["peak_mem_bytes"] - vm["base_mem_bytes"])
                                   / lm.get("clients", LM["clients"]) if on_card
                                   else "not measured"),
           "fold": _fold_bit_equality(device) if on_card else None,
           "groups": _batched_lm_groups(device, lm) if on_card else None,
           "seconds": time.perf_counter() - t0}
    log("[batched] " + json.dumps({"lm": out}))
    if cosine < BATCHED_LM_TOL["cosine"] or loss_rel > BATCHED_LM_TOL["loss_rtol"]:
        raise AssertionError(f"LM vmap vs loop: update cosine {cosine}, loss rel {loss_rel} "
                             f"outside {BATCHED_LM_TOL}")
    return out


def _batched_lm_groups(device, lm: dict) -> dict:
    """BATCHED_LM_COHORT's two rounds under vmap: the first round's full
    cohort runs out of device memory and BatchedLocalTrain retries it in
    groups half its size (its round time holds the failed attempt); the
    second round runs in the groups that fit. Its peak memory is read
    over the second round alone."""
    import dataclasses

    import torch

    from fedml_tpu_torch.algorithms import FedAvgAPI

    clients = BATCHED_LM_COHORT["clients"]
    cfg, data, model = _flagship_lm(2, **{**lm, **BATCHED_LM_COHORT})
    cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, client_parallelism="vmap"))
    api = FedAvgAPI(cfg, data, model, task="nwp", device=device)
    batched = api.round_fn.batched_train
    times, losses, base = [], [], None
    for r in range(2):
        if r == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, mets = api.train_round(r)
        loss = float(mets["loss_sum"]) / float(mets["count"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    if batched.max_clients is None or batched.max_clients >= clients:
        raise AssertionError(f"a cohort of {clients} LM clients ran in one group: the card was "
                             "expected not to hold it")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"grouped LM cohort: non-finite losses {losses}")
    return {"clients": clients, "samples": BATCHED_LM_COHORT["samples"],
            "group": batched.max_clients, "round_time_s": times, "train_loss": losses,
            "second_round_peak_bytes": peak, "second_round_base_bytes": base,
            "bytes_a_client": (peak - base) / batched.max_clients}


def _zoo_report(device, z: dict) -> dict:
    """Phase 21 (b) and (c): VGG-11 over an ImageNet tree, EfficientNet-B0
    over a gld23k tree."""
    import tempfile

    import numpy as np

    from fedml_tpu_torch.data.imagenet import load_imagenet_streaming
    from fedml_tpu_torch.data.landmarks import load_landmarks
    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.models import ModelDef, create_model
    from fedml_tpu_torch.models import vgg as vgg_mod

    report = {}
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    if free < ZOO_MIN_FREE_BYTES:
        raise RuntimeError(f"phase 21 needs {ZOO_MIN_FREE_BYTES} bytes free under {tmp_root}; "
                           f"{free} are")
    img = z["image"]
    rng = np.random.default_rng(5)
    x2 = rng.random((z["cpu_images"], img, img, 3), dtype=np.float32)
    y2 = np.arange(z["cpu_images"], dtype=np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_imagenet_tree(os.path.join(tmp, "imagenet"), z["vgg_classes"], img)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = load_imagenet_streaming(os.path.join(tmp, "imagenet"), os.path.join(tmp, "store"),
                                       num_clients=z["clients"], image_size=img)
        store_s = time.perf_counter() - t0
        if data.num_classes != z["vgg_classes"] or data.num_clients != z["clients"]:
            raise AssertionError(f"imagenet store: {data.num_classes} classes, "
                                 f"{data.num_clients} clients")
        model = create_model("vgg11", "imagenet", (img, img, 3), z["vgg_classes"])
        vgg = _zoo_run(model, data, device, z["rounds"], z["lr"], z["batch"], z["clients"])
        vgg.update(tree_write_s=write_s, store_build_s=store_s,
                   store_bytes=sum(os.path.getsize(os.path.join(tmp, "store", f))
                                   for f in os.listdir(os.path.join(tmp, "store"))))
        del data, model
        with fp32_math():
            vgg["card_vs_cpu"] = _zoo_card_vs_cpu(
                lambda: ModelDef(vgg_mod.VGG(vgg_mod.CFGS["A"], z["vgg_classes"], dropout=0.0),
                                 (img, img, 3), z["vgg_classes"], has_dropout=True, name="vgg11"),
                x2, y2, device)
        report["vgg11"] = vgg
        log("[batched] " + json.dumps({"vgg11": vgg}))
        shutil.rmtree(os.path.join(tmp, "imagenet"))
        shutil.rmtree(os.path.join(tmp, "store"))
        t0 = time.perf_counter()
        _write_gld_tree(os.path.join(tmp, "gld"), z["gld_classes"], z["gld_users"],
                        z["gld_per_user"], z["gld_test"], img)
        data = load_landmarks(os.path.join(tmp, "gld"))
        load_s = time.perf_counter() - t0
        if data.num_classes != z["gld_classes"] or data.num_clients != z["gld_users"]:
            raise AssertionError(f"gld tree: {data.num_classes} classes, "
                                 f"{data.num_clients} clients")
        model = create_model("efficientnet", "landmarks", (img, img, 3), z["gld_classes"])
        eff = _zoo_run(model, data, device, z["rounds"], z["lr"], z["batch"], z["gld_users"])
        eff["write_and_load_s"] = load_s
        with fp32_math(), _no_dropout_b0():
            eff["card_vs_cpu"] = _zoo_card_vs_cpu(
                lambda: create_model("efficientnet", "landmarks", (img, img, 3), z["gld_classes"],
                                     drop_connect_rate=0.0), x2, y2, device)
        report["efficientnet_b0"] = eff
        log("[batched] " + json.dumps({"efficientnet_b0": eff}))
    return report


def phase_batched_and_zoo(smi: str, device="cuda", lm=None, zoo=None) -> dict:
    """The batched client schedule and the ImageNet-size models (phase 21):

    (a) the flagship LM (LM's geometry, bf16, AMSGrad) with
        ``client_parallelism="vmap"`` beside ``"scan"`` (the loop), 2
        rounds each: warm round time, peak memory, launches a step and
        busy share (a profiled vmap round; the loop's is phase 10's),
        the exact K2/K3/K4 launches (one a layer a batched step against
        one a layer a client step), no plain-version or SDPA call; vmap
        against the loop within BATCHED_LM_TOL; the folded K2-K4 launch
        on [8·32·8, 256, 96] bit-equal to per-client launches
        (:func:`_fold_bit_equality`);
    (b) VGG-11 (~133M params) over an ImageNet tree loaded through
        ``load_imagenet_streaming`` into the mmap store, 10 homo clients,
        2 rounds: round times, launches, busy, peak memory; one step on 2
        images, card against CPU;
    (c) EfficientNet-B0 over a gld23k tree through ``load_landmarks``,
        2 rounds, the same readings.

    ``lm`` and ``zoo`` override LM's and ZOO's entries for a rehearsal on
    the CPU. Returns the K2-K4 launches of (a)'s vmap and loop runs, and
    of their float32 kernels ("vmap_float32", "loop_float32")."""
    lm_report = _batched_lm_report(device, dict(lm or {}))
    _zoo_report(device, {**ZOO, **(zoo or {})})
    log("[batched] " + json.dumps({"card": smi}))
    out = {s: lm_report[s]["launches"] for s in ("vmap", "loop")}
    for s in ("vmap", "loop"):  # the float32 kernels' share: the eval's K2
        by_dtype = lm_report[s]["launches_by_dtype"]
        out[s + "_float32"] = {kn: by_dtype[f"{kn}:float32"] for kn in out[s]}
    return out


# ---------------------------------------------------------------- phase 22

# split learning on the north star's data: the reference's recipe
# (algorithms/split_nn.py: SGD lr 0.1, momentum 0.9, wd 5e-4), a ring of 10
# of femnist_synthetic(128)'s clients, batch 20, 2 rounds; the cut
# default_split_models gives at width 32 (two 3x3 stride-2 convs, then
# dense 64 and 62)
SPLIT = dict(num_clients=128, ring=10, batch=20, lr=0.1, momentum=0.9, wd=5e-4, rounds=2)
# the card's ring round against the CPU's on the same seed, (rtol, atol) on
# every tensor, for a round of one batch of 20 a client (10 steps). A whole
# round (~110 steps at lr 0.1, momentum 0.9) is chaotic: on the CPU a 1e-7
# nudge of the init moves its params by 2.19 (their largest is ~0.75), so
# cuDNN's and the CPU's float32 roundings (other summation orders) cannot
# be told from a fault there. Over one batch a client the same nudge moves
# them by 6.2e-6; the card's roundings are of that order, and the bound is
# 16x it
SPLIT_CARD_VS_CPU = (1e-4, 1e-4)
# vertical FL: the CLI's three-party split of the flattened 28x28 images
# (261, 261, 262 features), hidden 16, out 1, y = label mod 2, SGD lr 0.05
# with momentum 0.9, batch 20, over the first VFL_CLIENTS clients' samples,
# 2 epochs
VFL = dict(clients=10, batch=20, lr=0.05, epochs=2)
SPLIT_FAULT_PLAN_CLIENT_POS = 1  # the ring position whose client the plan drops


def _split_config(rounds: int, num_clients: int, ring: int, batch: int, lr: float,
                  momentum: float, wd: float, comm=None):
    from fedml_tpu_torch.config import CommConfig, DataConfig, FedConfig, RunConfig, TrainConfig

    return RunConfig(
        data=DataConfig(batch_size=batch),
        fed=FedConfig(client_num_in_total=num_clients, client_num_per_round=ring,
                      comm_round=rounds, epochs=1),
        train=TrainConfig(client_optimizer="sgd", lr=lr, momentum=momentum, wd=wd),
        comm=comm or CommConfig(), seed=0,
    )


def _split_vars(server_or_api) -> dict:
    if hasattr(server_or_api, "global_vars"):
        g = server_or_api.global_vars["params"]
        return {**{"bottom." + k: v for k, v in g["bottom"].items()},
                **{"top." + k: v for k, v in g["top"].items()}}
    return {**{"bottom." + k: v for k, v in server_or_api.bottom_vars.items()},
            **{"top." + k: v for k, v in server_or_api.top_vars.items()}}


def _split_fused(cfg, data, device, rounds: int):
    """SplitNNAPI over the cohorts the transport's server draws."""
    from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, default_split_models
    from fedml_tpu_torch.scheduler import ClientScheduler

    bottom, top = default_split_models(tuple(data.client_x[0].shape[1:]), data.num_classes)
    api = SplitNNAPI(bottom, top, lr=cfg.train.lr, momentum=cfg.train.momentum,
                     wd=cfg.train.wd, seed=cfg.seed, device=device)
    sched = ClientScheduler.from_config(cfg, num_clients=cfg.fed.client_num_in_total, data=data)
    for r in range(rounds):
        cohort = sched.select(r, k=cfg.fed.client_num_per_round)
        api.train_ring([(data.client_x[c], data.client_y[c]) for c in cohort],
                       batch_size=cfg.data.batch_size)
    return api


def phase_split_vertical(smi: str, device="cuda", split=None, vfl=None) -> dict:
    """Split learning and vertical FL (phase 22); see the module docstring.
    ``split`` and ``vfl`` override entries of SPLIT and VFL for a rehearsal
    on the CPU. No kernel of K1-K4 runs on this path: the cut's convs and
    dense layers and the parties' dense layers run on cuDNN/cuBLAS and
    PyTorch's own kernels."""
    import dataclasses
    import time

    import torch

    from fedml_tpu_torch import cli
    from fedml_tpu_torch.config import CommConfig
    from fedml_tpu_torch.data.femnist_synth import femnist_synthetic
    from fedml_tpu_torch.device import fp32_math
    from fedml_tpu_torch.scheduler import ClientScheduler, FaultInjector, FaultPlan
    from fedml_tpu_torch.splitfed import BOUNDARY_CODECS, run_loopback_splitnn, run_loopback_vfl
    from fedml_tpu_torch.telemetry import get_comm_meter

    t_phase = time.perf_counter()
    s = {**SPLIT, **(split or {})}
    v = {**VFL, **(vfl or {})}
    data = femnist_synthetic(num_clients=s["num_clients"], seed=0)
    kw = {k: s[k] for k in ("num_clients", "ring", "batch", "lr", "momentum", "wd")}
    report = {"card": smi, "device": device,
              "kernels": "none: split learning and vertical FL run no kernel of K1-K4"}
    with fp32_math():
        # (a) the CLI's runner in process, and its first round against the CPU's
        stamps = [time.perf_counter()]
        rows = []

        def log_fn(row):
            rows.append(row)
            stamps.append(time.perf_counter())

        api, final = cli._run_split_nn(_split_config(s["rounds"], **kw), data, None,
                                       "classification", log_fn, {}, device)
        if device == "cuda":
            torch.cuda.synchronize()
        params = _split_vars(api)
        if not all(torch.isfinite(t).all() for t in params.values()):
            raise AssertionError("split_nn: non-finite params")
        # one batch a client: the round that is not chaotic (SPLIT_CARD_VS_CPU)
        short = dataclasses.replace(data, client_x=[x[: s["batch"]] for x in data.client_x],
                                    client_y=[y[: s["batch"]] for y in data.client_y])
        def short_round(dev):
            api1, _ = cli._run_split_nn(_split_config(1, **kw), short, None, "classification",
                                        lambda r: None, {}, dev)
            return {k: t.cpu() for k, t in _split_vars(api1).items()}

        def against_cpu(card_p):
            """(max |card − CPU|, within SPLIT_CARD_VS_CPU on every tensor)"""
            rtol, atol = SPLIT_CARD_VS_CPU
            err = max((card_p[k] - cpu_p[k]).abs().max().item() for k in cpu_p)
            ok = all(((card_p[k] - cpu_p[k]).abs() <= atol + rtol * cpu_p[k].abs()).all()
                     for k in cpu_p)
            return err, ok

        cpu_p = short_round("cpu")
        err, ok = against_cpu(short_round(device))
        if not ok:
            raise AssertionError(f"split card vs CPU: max |err| {err} outside "
                                 f"SPLIT_CARD_VS_CPU {SPLIT_CARD_VS_CPU}")
        # the planted fault: the same card round with TF32 convolutions and
        # matmuls must break the bound
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            fault_err, fault_ok = against_cpu(short_round(device))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        if device == "cuda" and fault_ok:
            raise AssertionError(f"split card vs CPU: the TF32 round passes SPLIT_CARD_VS_CPU "
                                 f"(max |err| {fault_err})")
        report["split_nn"] = {
            "rows": rows, "final": final,
            "round_s_with_eval": [b - a for a, b in zip(stamps, stamps[1:])],
            "card_vs_cpu_max_abs": err, "card_vs_cpu_tol": list(SPLIT_CARD_VS_CPU),
            "tf32_fault_vs_cpu_max_abs": fault_err, "losses_finite": True,
        }

        # (b) the loopback federation against the fused simulator, both on the card
        with _deterministic_convs():
            cfg = _split_config(s["rounds"], **kw)
            meter = get_comm_meter()
            meter.reset()
            t0 = time.perf_counter()
            server = run_loopback_splitnn(cfg, data, device=device)
            wall = time.perf_counter() - t0
            snap = meter.snapshot()
            fused = _split_fused(cfg, data, device, s["rounds"])
            _assert_bit_equal(_split_vars(server), _split_vars(fused), "split transport vs fused")
            if not all(math.isfinite(r["Train/Loss"]) for r in server.history):
                raise AssertionError(f"split transport: non-finite loss {server.history}")
            codecs = {}
            for method in BOUNDARY_CODECS:
                comm = CommConfig(activation_compression=method,
                                  activation_error_feedback=method != "none")
                meter.reset()
                run_loopback_splitnn(_split_config(1, **kw, comm=comm), data, device=device)
                c = meter.snapshot()
                codecs[method] = {
                    "up_raw_bytes": c["uplink_raw_bytes"], "up_payload_bytes": c["uplink_payload_bytes"],
                    "down_raw_bytes": c["downlink_raw_bytes"],
                    "down_payload_bytes": c["downlink_payload_bytes"],
                    "up_cut": c["uplink_raw_bytes"] / max(c["uplink_payload_bytes"], 1),
                    "down_cut": c["downlink_raw_bytes"] / max(c["downlink_payload_bytes"], 1),
                }
            report["split_transport"] = {
                "rounds": server.round_idx, "bit_equal_to_fused": True,
                "history": server.history, "wall_s": wall,
                "round_s": [b["t_s"] - a["t_s"] for a, b in
                            zip([{"t_s": 0.0}] + server.history[:-1], server.history)],
                "bytes_a_round": {k: snap[k] / s["rounds"] for k in (
                    "uplink_raw_bytes", "uplink_payload_bytes", "downlink_raw_bytes",
                    "downlink_payload_bytes")},
                "codecs": codecs,
            }

            # (c) vertical FL: the CLI's runner and the loopback federation over
            # the runner's own party split, both on the card
            vdata = dataclasses.replace(data, client_x=data.client_x[: v["clients"]],
                                        client_y=data.client_y[: v["clients"]])
            vcfg = _split_config(v["epochs"], num_clients=s["num_clients"], ring=2,
                                 batch=v["batch"], lr=v["lr"], momentum=0.9, wd=0.0)
            vrows = []
            t0 = time.perf_counter()
            vapi, _ = cli._run_vertical_fl(vcfg, vdata, None, "classification", vrows.append,
                                           {}, device)
            fused_s = time.perf_counter() - t0
            xs, y = cli._vertical_parties(vdata)
            t0 = time.perf_counter()
            guest, hosts = run_loopback_vfl(vcfg, xs, y, device=device)
            wire_s = time.perf_counter() - t0
            _assert_bit_equal(guest.params, vapi.params[0], "vfl guest vs fused")
            for h, pp in zip(hosts, vapi.params[1:]):
                _assert_bit_equal(h.params, pp, f"vfl host {h.rank} vs fused")
            if not all(math.isfinite(r["Train/Loss"]) for r in vrows):
                raise AssertionError(f"vfl: non-finite loss {vrows}")
            report["vertical_fl"] = {
                "feature_splits": [x.shape[1] for x in xs], "samples": len(y), "rows": vrows,
                "history": guest.history, "fused_s": fused_s, "transport_s": wire_s,
                "bit_equal_to_fused": True,
            }

            # (d) a fault plan dropping one client's boundary messages, twice
            sched = ClientScheduler.from_config(cfg, num_clients=s["num_clients"], data=data)
            victim = int(sched.select(0, k=s["ring"])[SPLIT_FAULT_PLAN_CLIENT_POS])
            plan = {"clients": {str(victim): {"dropout_p": 1.0}}}
            runs = []
            for _ in range(2):
                faults = FaultInjector(FaultPlan.from_json(plan))
                runs.append(run_loopback_splitnn(_split_config(1, **kw), data, device=device,
                                                 faults=faults))
            a, b = runs
            if a.skipped_turns < 1 or a.skipped_turns != b.skipped_turns:
                raise AssertionError(f"fault plan: skipped turns {a.skipped_turns}, "
                                     f"{b.skipped_turns}")
            _assert_bit_equal(_split_vars(a), _split_vars(b), "faulted runs")
            report["fault_plan"] = {"victim": victim, "skipped_turns": a.skipped_turns,
                                    "rows": a.history, "repeat_bit_equal": True}
    report["phase_s"] = time.perf_counter() - t_phase
    log("[split_vertical] " + json.dumps(report, default=str))
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    phase_s = {}  # each phase's seconds, where the script's time goes

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__] = round(time.perf_counter() - t0, 3)
        return out

    name, smi = timed(phase_device)
    timed(phase_build)
    max_err = timed(phase_k1_parity)
    t, bound_ms, bound_by, large = timed(phase_k1_timing, name, smi)
    launches, main_warm_s = timed(phase_main_path)
    large_cohort_launches = timed(phase_large_cohort)
    timed(phase_profile_round)
    timed(phase_card_vs_cpu)
    flash_err = timed(phase_flash_parity)
    ft, fplain, fbounds, flib, f32, wide = timed(phase_flash_timing, name, smi)
    timed(phase_sass)
    flash_launches = timed(phase_lm_path)
    lm_f32_launches = timed(phase_lm_float32)
    wide_launches = timed(phase_lm_wide)
    timed(phase_profile_lm_round)
    timed(phase_lm_card_vs_cpu)
    transport_launches = timed(phase_transport, smi)
    timed(phase_faults_secagg, smi)
    cli_launches = timed(phase_cli, smi, main_warm_s["median"])
    resnet_launches = timed(phase_resnet, smi)
    defense_launches = timed(phase_defenses, smi)
    timed(phase_longtail, smi, main_warm_s["median"])
    timed(phase_fedbuff, smi)
    timed(phase_population, smi)
    timed(phase_modelbound, smi)
    batched_launches = timed(phase_batched_and_zoo, smi)
    timed(phase_split_vertical, smi)
    log(json.dumps({"phase_s": phase_s}))

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import robust_stats as rs

    replaces = {fa.FWD: "fedml_tpu/ops/flash_attention.py:133",
                fa.BWD_DQ: "fedml_tpu/ops/flash_attention.py:293",
                fa.BWD_DKV: "fedml_tpu/ops/flash_attention.py:314"}
    flash_rows = [{
        "name": kn,
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": replaces[kn],
        "launches": flash_launches[kn],
        "transport_launches": transport_launches[kn],
        # the flagship LM's 2 rounds under the batched schedule (phase 21
        # (a)): one launch a layer a batched step; and its loop beside it
        "vmap_launches": batched_launches["vmap"][kn],
        "vmap_loop_launches": batched_launches["loop"][kn],
        "max_abs_err": flash_err[kn],
        "ms": ft[kn],
        "plain_ms": fplain[kn],
        "bound_ms": fbounds[kn][0],
        "bound_by": fbounds[kn][1],
        "library_ms": flib[kn],
        # the float32 kernel at the same shape (split-TF32 tensor cores);
        # the LM path's float32 leg launches all three, the LM's eval
        # forward (phase 21's runs) the float32 K2
        "float32": {"ms": f32[kn]["kernel"], "plain_ms": f32[kn]["plain"],
                    "launches": {"lm": lm_f32_launches[kn],
                                 "vmap": batched_launches["vmap_float32"][kn],
                                 "loop": batched_launches["loop_float32"][kn]},
                    "bound_ms": f32[kn]["bound"],
                    "bound_by": f32[kn]["bound_by"],
                    "library_ms": f32[kn]["sdpa_fwd" if kn == fa.FWD else "sdpa_bwd"]},
        # the chunked kernels at [256, 256, 256] causal (head dims above
        # 128; the float32 K3 and K4 there are the cluster kernels, named by
        # "function"), and their launches on the LM path at head dim 256
        # (phase_lm_wide), counted under their own keys
        "d256": {dt: {"function": wide[dt][kn]["function"],
                      "ms": wide[dt][kn]["kernel"], "plain_ms": wide[dt][kn]["plain"],
                      "bound_ms": wide[dt][kn]["bound"], "bound_by": wide[dt][kn]["bound_by"],
                      "library_ms": wide[dt][kn]["library"],
                      "launches": wide_launches[dt][kn]}
                 for dt in ("bfloat16", "float32")},
    } for kn in fa.KERNEL_NAMES]
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
        # the select kernel (C > 16): a cohort of 128 over the whole model;
        # the robust round at 100 clients, its 8 leaves timed at their own
        # shapes, and its launches
        "c128_ms": large["k1_median_ms"],
        "c128_bound_ms": large["bound_ms"],
        "c128_bound_by": large["bound_by"],
        "c128_library_ms": large["sort_window_median_ms"],
        "c100_round_ms": large["path_c100"]["k1_median_round_ms"],
        "c100_round_plain_ms": large["path_c100"]["plain_median_round_ms"],
        "c100_round_bound_ms": large["path_c100"]["bound_ms"],
        "c100_round_library_ms": large["path_c100"]["sort_window_median_round_ms"],
        "large_cohort_launches": large_cohort_launches,
        # launches through python -m fedml_tpu_torch's cli.main (phase 14)
        "cli_launches": cli_launches,
        # launches of 2 robust median rounds of the cross-silo ResNet-56
        # (phase 15): one a parameter leaf a round
        "resnet_launches": resnet_launches,
        # launches of the attacked median (2 rounds) and trimmed-mean (1)
        # runs of phase 16: 8 a round
        "defense_launches": defense_launches,
    }] + flash_rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
