#!/usr/bin/env python3
"""Drive the PyTorch port of PipeSim on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. Setup: torch/CUDA versions, the card's name and power limit, the
   build of the kernels (one nvcc each, in parallel; ptxas's registers,
   shared memory and spills of each kernel), the counts of ``HGMMA`` and
   ``UTMALDG`` instructions in the flash and SSD kernels' SASS (where the
   toolkit has ``cuobjdump``; the bf16 flash kernels and the SSD scan's
   tensor-core kernel must have HGMMA), and the workloads of phase 3.
2. The admission kernel against its plain PyTorch version on the card,
   exactly, over a grid of shapes, ties, sentinel shares and negative free
   slots, and on one queued row in a 32 x 2,673 input.
3. The main path: a 32-replica Monte-Carlo ensemble of one-day ground-truth
   workloads (the paper's 44 s mean interarrival; the default 48 compute /
   32 learning nodes, the learning cluster cycling over 16/24/32/48; FIFO /
   PRIORITY / SJF; failures with retries and backoff everywhere,
   maintenance windows on half, resampled retry durations on a quarter)
   through ``simulate_ensemble`` on the card. Checks: every pipeline done,
   start >= ready, finish >= start, no resource ever runs more attempts
   than the largest capacity its schedule grants, the kernel was launched,
   and 4 replicas re-run through the plain admission are bit-identical.
   Every ``KEEP_EVERY``-th admission input of the run is kept; on those
   real inputs the kernel, its plain version and a library yardstick are
   compared and timed with CUDA events over calls one after another (the
   kernel also on the device alone, in a CUDA graph), beside each input's
   bound.
4. The single-replica path: ``simulate_to_trace`` -> ``flatten_trace`` ->
   ``summarize`` with a schedule, an SLO and cost rates, equal to the
   ensemble's replica.
5. The flash-attention kernels against their plain PyTorch version on the
   card over a grid: B, S (ragged 200 included), (H, Hkv), D, f32 and bf16,
   causal and not, plus S = 4,096 at 32 query and KV heads; to
   ``tests/test_kernels.py``'s tolerances on the largest difference
   (``FLASH_TOL``), and in bf16 to ``FLASH_ROW_REL_TOL`` on each output
   row's relative difference.
6. The serving path: ``run_serving("llama3.2-1b", batch=4,
   prompt_len=1024, new_tokens=32, smoke=False)`` at full width in bf16
   with random weights. Checks: tokens in the vocab, finite logits, one
   kernel launch per layer (prefill only). Prints the time to first token
   and the decode and total tokens/s. Twin: the same weights in f32 (no
   TF32), prefill and 32 teacher-forced decode steps through the kernel
   and through the plain path, held to ``TWIN_ATOL``. On the kernel's
   inputs from layer 0 of the bf16 prefill, the kernel, its plain version
   and ``scaled_dot_product_attention`` are timed with CUDA events, beside
   the bound.
7. The GMM kernel against its plain PyTorch version on the card over a
   grid of N, D and K, to ``GMM_ATOL`` plus ``GMM_RTOL`` of |logpdf|.
8. The paper's fit -> synthesize -> simulate path (§V-A, the path of
   ``repro.launch.simulate`` and of ``benchmarks/common.py``'s
   ``fitted_params``): 14 days of ground truth (seed 123, 27,948
   pipelines) fitted on the card by ``fit_simulation_params`` with its
   defaults, then ``run_experiment`` of 32 synthesized one-day replicas as
   one ensemble. Checks: 550 kernel launches in the fit (one per EM
   iteration of its 12 GMMs), no NaN in any GMM, the asset GMM's mean
   log-likelihood on the ground truth not below the committed
   ``artifacts/pipesim_params.npz`` GMM's by more than ``FIT_LL_MARGIN``,
   every synthesized pipeline finished, and the reference CLI's summary
   keys. Prints the fit's wall split into EM on the card and the host, the
   synthesis wall per replica, and the ensemble's wall and pipelines/s. On
   the asset E-step inputs kept from the fit, the kernel, its plain version
   and ``MultivariateNormal.log_prob`` are timed with CUDA events (the
   kernel also on the device alone, in a CUDA graph), beside the bound.
9. The SSD kernel (``mamba2_scan``) against its plain PyTorch version on
   the card over a grid of S, H, P, N, chunk, f32/bf16 and B, to
   ``SSD_ATOL`` plus ``SSD_RTOL`` of |y|, and against the O(S) recurrence
   on the small cases.
10. The hybrid's full-sequence forward: ``loss_fn`` of zamba2-1.2b at full
    width in bf16 (random weights from a seed) on 2 x 4,096 tokens, through
    the SSD kernel in all 38 Mamba blocks and the flash kernel in the 6
    shared-attention applications, cold then warm. Checks: a finite loss
    and exactly 38 + 6 launches per forward, the 38 on the SSD kernel's
    tensor-core route. Twin: the same
    model in f32 (no TF32) on 1 x 1,024 tokens through the kernel and
    through the plain chunked scan, logits within ``HYB_TWIN_LOGIT_ATOL``
    and loss within ``HYB_TWIN_LOSS_ATOL``. On layer 0's inputs the SSD
    kernel and its plain version are timed with CUDA events, beside the
    bound (no single PyTorch call computes the scan); on the first
    shared-attention inputs the flash kernel and
    ``scaled_dot_product_attention`` are held against the plain version
    and the three timed, beside the bound; each kernel's share of the warm
    forward is printed.
11. Serving zamba2-1.2b at full width (batch 4, 1,024-token prompts, 32 new
    tokens): the prefill runs the chunked scan from a zero state and the
    flash kernel 6 times, decode the recurrence. Checks: tokens in the
    vocab, finite logits, 6 flash launches and no SSD launch, and the
    flash kernel on the first shared-attention inputs of the prefill
    within ``FLASH_TOL`` and ``FLASH_ROW_REL_TOL`` of the plain version.
12. ``ops.queue_scan`` on a capacity sweep: 4,096 stations of 4,096 jobs
    (Poisson arrivals, exponential service at loads 0.5-1.1), capacities
    1, 2, 7, 32, 64, one launch each. Checks: bit for bit equal to the
    plain version with finite outputs, and a subsample of rows within
    ``QUEUE_ORACLE_ATOL`` of the f64 oracle. Each launch is timed with CUDA
    events beside its bound and the plain version (no single PyTorch call
    computes it), and logged with its route (S slots per lane, G lanes per
    station) as the C entry point reports it. Then a tie-heavy sweep
    (``QUEUE_TIE_R`` x 4,096 jobs at integer ready times with zero
    services among the integer ones, capacities ``QUEUE_TIE_CAPS``), bit
    for bit against the plain version.
13. The card's engine against the CPU path, which the CPU twins hold bit
    for bit against the reference's numpy engine (so card == CPU ==
    oracle): a 4-replica one-tenth-day ensemble with whole-second times,
    mixed policies, retries with backoff, a partial-progress replica, a
    resampled-attempt replica and drains below the busy count, through
    ``simulate_ensemble`` on the card and with ``device="cpu"``. Checks:
    every replica retried, then every output key equal bit for bit; prints
    ``engine_card_vs_cpu: identical, ...`` on a line of its own.
14. The full stack: (a) ``run_experiment`` of ``examples/observability.py``'s
    spec (a closed-loop controller, 6 drifting models with a drift
    trigger, a probe every 30 min) with ``examples/reliability_frontier.py``'s
    reliability scaled to one day (2 zones x 4 racks, zone MTBF 12 h,
    rack MTBF 6 h, MTTR 1 h, 2 repair crews, a 20 % spot slice), 32
    replicas of one day from the committed ``artifacts/pipesim_params.npz``.
    Checks: one ``simulate_ensemble`` call, the admission kernel and no
    other launched, the stages acted (each replica's controller moves,
    reliability events, triggers and redeploys printed), every replica's
    probe ran its whole grid, and phase 3's invariants (every pipeline
    that entered done, start >= ready, finish >= start, no resource above
    its schedule's largest capacity plus the controller's largest move).
    As in phase 3, every ``KEEP_EVERY``-th admission input of the run is
    kept, and on those the kernel is held exactly against its plain
    version and timed beside its bound; ``FS_DENSE_N`` replicas (those on
    which the most stages acted) are re-run with the plain admission on
    the card, every output key equal bit for bit. The same replicas run
    with no stage on beside it; both print their wall, waves/s and
    pipelines/s with the card's name and power limit.
    (b) The full-stack oracle ensemble (``fullstack_oracle_ensemble``: 4
    whole-second one-tenth days, every stage on under the reference's
    parity conditions, padding rows on one replica whose model redeploys
    three times in one wave) on the card and through the CPU path, every
    output key equal bit for bit; prints ``fullstack_card_vs_cpu:
    identical, ...`` on a line of its own.
15. Segments, compaction and streaming: (a) phase 3's ensemble through
    ``simulate_ensemble_compacted`` on the card (the wave loop in windowed
    segments over the live rows), every output key equal to phase 3's bit
    for bit; prints its wall, waves/s and pipelines/s beside phase 3's, the
    segments, gathers, distinct shapes, working widths and the admission
    launches, and on every ``KEEP_EVERY``-th admission input of the run
    holds the kernel exactly against its plain version and times it at the
    compacted widths. (b) One synthesized day (``SyntheticSource`` from the
    committed ``artifacts/pipesim_params.npz``, blocks of 256, the default
    platform) streamed by ``stream_simulate`` in 3 h windows with phase
    14(a)'s stages but reliability (which streaming refuses) and failures
    with retries, against ``oneshot_reference`` of the same stream:
    ``parity_drift`` 0.0, the waves and the controller, fleet and probe
    timelines equal; then its first 6 h with ``overlap`` on and off,
    bit-identical; the kernel held and timed on the stream's kept
    admission inputs. (c) Phase 13's replica 0 streamed from a pinned
    source on the card and through the CPU path, records equal bit for
    bit, and the card's stream equal to its one-shot run; prints
    ``stream_card_vs_cpu: identical, ...`` on a line of its own.
16. Training (no kernel: none has a backward, so training runs the plain
    attention and SSD routes). (a) ``run_training`` of llama3.2-1b at full
    width (bf16 parameters, f32 moments, remat per block) for 8 steps of
    8 x 1,024 tokens, its final checkpoint (~12.4 GB) in a temporary
    directory (it raises if the disk has less than twice that free), then
    restored: every loss finite, the last below the first, no kernel
    launched, the restored state equal to the in-memory one bit for bit;
    ``attn_impl="flash"`` under autograd raises the kernel's guard. (b)
    zamba2-1.2b at full width, 4 steps of 2 x 2,048 tokens through the
    trainer, the same checks without a checkpoint;
    ``ssm_impl="mamba_kernel"`` under autograd raises. Both print the
    warm step time, tokens/s, model FLOP/s (6 N tokens), peak memory and
    (a) the checkpoint's bytes and save/restore seconds, beside the card's
    name and power limit. (c) The smoke llama (f32) with a fault at step 6
    and checkpoints every 4 steps against an uninterrupted run, under
    ``torch.use_deterministic_algorithms(True)``: final checkpoints and
    states equal bit for bit. (d) Phase 14(a)'s reliability compiled with
    a ``CheckpointSpec`` whose stride puts 2–4 outages inside 40 steps;
    its ``injector`` drives 40 steps of the smoke llama: one restart per
    fault step, the final state equal to an uninterrupted run's bit for
    bit. (e) The smoke llama and zamba2 (f32, no TF32) from one CPU init
    on the card and the CPU: step 1's gradients within 1e-5 (hybrid 5e-5)
    of their norm, and the card's no farther from the same step's gradient
    in f64 (on the CPU) than twice the CPU's f32 one is; 3 losses within
    1e-4; and ``run_feedback_simulation``
    of one pinned whole-second day on the card (the engine, then the
    compaction driver) and on the CPU (the compaction driver), equal bit
    for bit, the admission kernel launched on the card's run.

17. The cost-model link, within ``COST_BUDGET_S``: (a) ``launch/dryrun.py``'s
    writer counts the five ported archs x the four shapes on the meta
    device (no card; ``DRYRUN_WORKERS`` processes, while (c) and (d) run)
    into a temporary root: every dense ``long_500k`` a skip, the other 16
    cells counted; each cell's FLOPs, bytes, dominant term and roofline
    step on ``costmodel.H100``. (b) ``accelerator_workload_catalog`` of
    those cells, its medians, and ``examples/accelerator_platform.py``'s
    workload drawn from it (whole seconds) through ``run_experiment`` on
    the ``"torch"`` engine at 2/4/8 pods, on the card (the admission
    kernel launched) and the CPU, equal bit for bit; the queue waits. (c)
    16(a)'s step counted on the meta device and priced on the H100 spec,
    beside 16(a)'s measured warm step, and their ratio (a reading). (d)
    ``run_serving`` of granite-3-8b, stablelm-3b (head dim 80, which the
    flash kernel runs zero-padded to 128) and granite-20b at full width in
    bf16 (random weights from seed 0, batch 2, 512-token prompts, 16 new
    tokens) through the flash kernel, one launch per layer; layer 0's q/k/v
    held against the plain version at the bf16 gates and, at head dim 80,
    in f32 at 1e-5; each model freed before the next. (e)
    ``obs.profile.profile_compile_execute`` and ``stage_attribution``
    (base, + control, + fleet, + probe) on 14(a)'s spec for one replica
    over ``PROFILE_HORIZON_S``, ``repeats=1``: each stage's us per wave.

The last lines are the kernels' JSON record (a kernel launched on two
main paths, as flash in the llama prefill, the hybrid forward and the
three dense configs' prefills, has its
launches summed, its times launch-weighted, and each path's numbers under
``paths``), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# phase 16's crash-restart twins run cuBLAS deterministically, which needs
# this set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HORIZON_S = 86400.0
N_REPLICAS = 32
LEARNING_CAPS = (16, 24, 32, 48)
DENSE_REPLICAS = (4, 9, 11, 14)     # every capacity, policy and scenario kind
KEEP_EVERY = 500     # keep every 500th admission input of the main path
# the kernel-vs-plain grid: replicas, rows, resources, sentinel shares
CHECK_R, CHECK_N = (1, 32), (1, 127, 128, 2500, 17000)
CHECK_NRES, CHECK_SENTINELS = (1, 2, 5), (0.0, 0.5, 0.9)
ONE_QUEUED_N = 2673     # the wave loop's N_max, with a single queued row
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, the f32 / int32
# rate of the CUDA cores (the admission kernel does no tensor-core work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# attention's products at their type's peak: bf16 on the tensor cores,
# f32 (no TF32) on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": PEAK_OPS_S}
KERNELS = ("fused_admission", "flash_attention", "gmm_logpdf", "mamba2_scan",
           "queue_scan")
# the flash kernel-vs-plain grid, and tests/test_kernels.py's tolerances
FLASH_B, FLASH_S = (1, 4), (1, 64, 128, 256, 1024, 2048, 200)
FLASH_HEADS = ((4, 4), (4, 2), (8, 1), (32, 8), (32, 32))
FLASH_D = (64, 128)
# beside the grid: the hybrid forward's length at 32 query and KV heads
FLASH_EXTRA = ((1, 4096, 32, 32, 64),)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# beside it in bf16, ||got - want|| / ||want|| of each output row (one
# query position and head): the largest |diff| comes from the early causal
# rows, where |o| is largest, so it alone would miss a fault confined to
# the late key tiles, where |o| is small (about 0.03 at S = 4,096). One bf16
# step is 0.4-0.8 % of a value, so rounding alone stays below 1e-2. (f32's
# 1e-5 is already tight at the smallest |o|.)
FLASH_ROW_REL_TOL = 1e-2
# the serving main path: llama3.2-1b at full width, 4 prompts of 1024 tokens
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_SEED = (
    "llama3.2-1b", 4, 1024, 32, 0)
# f32 flash-vs-plain twin of the whole model on the logits (|logits| ~ 1-5):
# the two paths differ only in attention's summation order (~1e-6 relative
# per layer in f32); a wrong mask, head or scale moves logits by O(0.1)
TWIN_ATOL = 1e-3
# the GMM kernel-vs-plain grid; tests/test_kernels.py's atol, plus a
# relative part for |logpdf| far above 1 (about 5e5 at D = 128 with far
# components): the two sum the D terms of each row in another order, about
# D f32 roundings of the larger terms
GMM_N, GMM_D, GMM_K = (1, 255, 1024, 27948), (1, 3, 8, 32, 128), \
    (1, 3, 6, 50, 64)
GMM_ATOL, GMM_RTOL = 5e-4, 2e-5
# the fit path: benchmarks/common.py's fitted_params(days=14, seed=123)
FIT_DAYS, FIT_SEED, FIT_LAUNCHES = 14.0, 123, 550
ARTIFACT = ROOT / "artifacts" / "pipesim_params.npz"
# EM from other k-means++ draws ends in other local optima; the CPU twins
# see up to 0.05 nats between the packages' fits
FIT_LL_MARGIN = 0.1
SYN_REPLICAS, SYN_SEED = 32, 0
# the reference CLI's summary keys for a replica ensemble without a
# scenario (repro/core/engines.py::_aggregate_replicas)
REF_ENSEMBLE_KEYS = {"mean_wait_s", "p95_wait_s", "wait_ci95_halfwidth",
                     "wall_s", "n_replicas"}
GMM_KEEP_EVERY = 10      # keep every 10th asset E-step input of the fit
# the SSD kernel-vs-plain grid (S % chunk != 0 is skipped: the wrapper
# refuses it, as the reference asserts)
SSD_S, SSD_H, SSD_P, SSD_N = (128, 192, 256, 1024, 4096), (1, 4, 64), \
    (32, 64), (32, 64)
SSD_CHUNK, SSD_B = (64, 128), (1, 2)
# tests/test_kernels.py's atol, plus a relative part: the kernel sums each
# chunk's Q-term products in another order than the einsums, and |y|
# reaches tens at S = 4096 where slowly decaying heads pile up the state
SSD_ATOL, SSD_RTOL = 2e-4, 1e-4
SSD_RECURRENT_MAX_S = 256    # the O(S) recurrence is held on S <= 256
# the hybrid's full-sequence forward: train_4k's length, batch 2
HYB_ARCH, HYB_B, HYB_S, HYB_SEED = "zamba2-1.2b", 2, 4096, 0
HYB_CHUNK, HYB_N_SUPER = 128, 6      # the config's ssd_chunk; 38 // 6
# its f32 twin at full width, kernel vs plain SSD: the two differ in the
# scan's summation order (~1e-6 relative per layer); a wrong decay, mask or
# state order moves the logits (|logits| ~ 1-10) by O(0.1)
HYB_TWIN_B, HYB_TWIN_S = 1, 1024
HYB_TWIN_LOGIT_ATOL, HYB_TWIN_LOSS_ATOL = 1e-3, 1e-4
# the capacity sweep: R stations of N jobs each, one launch per capacity
QUEUE_R, QUEUE_N, QUEUE_CAPS = 4096, 4096, (1, 2, 7, 32, 64)
QUEUE_LOADS = (0.5, 1.1)     # per-station utilisation, uniform in between
QUEUE_ORACLE_ROWS = 8        # rows per capacity held against the f64 oracle
QUEUE_ORACLE_ATOL = 1e-2     # tests/test_kernels.py's
QUEUE_TIE_R, QUEUE_TIE_CAPS = 512, (7, 64)   # the tie-heavy sweep
# the card's engine against the CPU path: whole-second one-tenth days
ORACLE_R, ORACLE_HORIZON_S, ORACLE_SEED = 4, 0.1 * 86400.0, 100
ORACLE_LEARNING_CAP = 8      # small, so queues form and the drain bites
ORACLE_DRAIN = (1800.0, 5400.0, 1, 0.0)    # the learning cluster to zero
ORACLE_DRAINED = (0, 3)
ORACLE_KEYS = ("start", "finish", "ready", "attempts", "done", "waves",
               "att_start", "att_finish")
# the full stack at width: examples/observability.py's spec (controller,
# fleet + trigger, probe) with 32 replicas of one day, plus
# examples/reliability_frontier.py's reliability scaled to the day
FS_SEED = 3
FS_DENSE_N = 2    # replicas re-run through the plain admission
# the full-stack oracle ensemble: whole-second one-tenth days, every stage
FSO_SEED, FSO_LEARNING_CAP = 300, 8
FSO_BURST = 3     # this replica's one model redeploys three times in a wave
FSO_BURST_DRAIN = (1000.0, 3000.0, 0, 0.0)   # compute to zero meanwhile
# three redeploy gains whose f32 sum depends on the order of the adds,
# by one ulp of the model's performance (the reference adds in slot order)
FSO_BURST_GAINS = (0.008586719632148743, 0.018224574625492096,
                   0.004860853310674429)
FSO_BURST_PERF0 = 0.88772327
# phase 15(b): one synthesized day streamed in 3 h windows, blocks of 256
STREAM_WINDOW_S = 3 * 3600.0
STREAM_BLOCK = 256
STREAM_TWIN_S = 6 * 3600.0     # the overlap on/off twin's horizon
# phase 16: llama3.2-1b trains at full width for 8 steps of 8 x 1,024
# tokens (its final checkpoint, ~12.4 GB, is the phase's longest part), the
# hybrid for 4 steps of 2 x 2,048; crash-restart on the smoke llama; the
# simulator's outages as the launcher's faults over 40 steps; the card
# against the CPU on the smoke models (f32, no TF32) and one feedback day
TRAIN_LLAMA = dict(steps=8, batch=8, seq=1024, lr=3e-4)
TRAIN_HYBRID = dict(steps=4, batch=2, seq=2048, lr=3e-4)
RESUME = dict(steps=12, ckpt_every=4, fault_at=(6,))
INJECT_STEPS = 40
TRAIN_TWIN_STEPS = 3
# step 1's gradients, card against CPU, relative to their global norm: the
# two sum in other orders. The smoke llama's f32 gradient lies ~4e-7 from
# the same step in f64 (on the CPU), the smoke hybrid's ~4e-5 (its chunked
# scan's backward): two f32 devices differ by up to about that much. So the
# card must also be no farther from the f64 gradient than
# TRAIN_GRAD_F64_FACTOR times the CPU's f32 one is. The losses of three
# steps, after which Adam's sign-like first step may have moved a
# rounding-level gradient's parameter by 2 lr on one device only
TRAIN_GRAD_REL_TOL = {"llama3.2-1b": 1e-5, "zamba2-1.2b": 5e-5}
TRAIN_GRAD_F64_FACTOR = 2.0
TRAIN_LOSS_TOL = 1e-4
FB_SEED = 5
# phase 17, the cost-model link, within its own budget on the card: (a)
# the five ported archs x the four shapes counted on the meta device by
# DRYRUN_WORKERS processes while (c) and (d) run; (b) the catalog's
# train_4k tasks (examples/accelerator_platform.py's 300 retraining jobs
# of 2,000 steps over a week) through the engine at 2/4/8 pods; (c) the
# roofline of 16(a)'s step; (d) the three remaining dense configs served at
# full width through the flash kernel; (e) the profiler on 14(a)'s spec for
# one replica, its horizon cut to about 1,000 waves
COST_BUDGET_S = 180.0
DRYRUN_WORKERS = 4
CATALOG_JOBS, CATALOG_STEPS, CATALOG_DAYS = 300, 2000, 7
CATALOG_PODS = (2, 4, 8)
DENSE_SERVE = ("granite-3-8b", "stablelm-3b", "granite-20b")
DENSE_B, DENSE_PROMPT, DENSE_NEW, DENSE_SEED = 2, 512, 16, 0
PROFILE_HORIZON_S = 18000.0
FSO_KEYS = ORACLE_KEYS + (
    "ctrl_act", "ctrl_n", "rel_act", "rel_n", "fleet_perf", "fleet_stale",
    "fleet_act", "fleet_n", "pool_arr", "pool_model", "pool_next",
    "probe_vals", "probe_n")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean time of one call on the card, by CUDA events over many calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, iters=100, warmup=3) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, the graph replayed between CUDA events. For calls whose host
    side (checks, allocation, the launch itself) outlasts their kernels,
    where ``cuda_ms`` would time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    e1.synchronize()
    del g
    return e0.elapsed_time(e1) / iters


def same_bits(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


# ------------------------------------------------------------ phase 2

def admission_case(rng, R, N, nres, sentinel_frac, float_keys, device):
    """Heavy ties in pkey and enq_wave (-0.0 beside 0.0 unless float keys),
    free from negative to about the segment size, a share of sentinels."""
    import torch
    res = rng.integers(0, nres, (R, N)).astype(np.int32)
    res[rng.random((R, N)) < sentinel_frac] = nres
    if float_keys:
        pkey = rng.choice(rng.exponential(50.0, 64), (R, N)).astype(np.float32)
    else:
        pkey = rng.integers(-2, 3, (R, N)).astype(np.float32)
        pkey[rng.random((R, N)) < 0.2] = -0.0
    wave = rng.integers(0, 4, (R, N)).astype(np.int32)
    free = rng.integers(-3, max(6, N // nres), (R, nres)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (res, pkey, wave, free)]


def sorted_admission(res_q, pkey, enq_wave, free):
    """The library yardstick: the admission mask from three chained stable
    ``torch.sort``s, a segmented seat count and an unsort scatter (the
    reference's ``"chained"`` ranking). Timed only; the port never calls
    it."""
    import torch
    R, N = res_q.shape
    o = torch.sort(enq_wave, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(pkey.gather(1, o), dim=1, stable=True).indices)
    o = o.gather(1, torch.sort(res_q.gather(1, o), dim=1, stable=True).indices)
    r_s = res_q.gather(1, o)
    pos = torch.arange(N, device=res_q.device).expand(R, N)
    is_start = torch.ones_like(r_s, dtype=torch.bool)
    is_start[:, 1:] = r_s[:, 1:] != r_s[:, :-1]
    seat = pos - torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    free_ext = torch.cat([free, torch.zeros_like(free[:, :1])], 1)
    adm = seat < free_ext.gather(1, r_s.long())
    return torch.zeros_like(adm).scatter_(1, o, adm) & (res_q < free.shape[1])


def admission_bound(res_q, free):
    """Least time for one admission round on this input, as ``(bytes_ms,
    ops_ms)``; the bound is the larger. Bytes: each input read once, the
    mask written once, over the memory rate. Operations: what the function
    needs, over the CUDA cores' rate — for each ordered pair of queued rows
    on one resource of one replica, a lexicographic (pkey, wave, id) test
    and a count (5 operations). Rows that are not queued need none; the
    kernel's compare of each queued row against every column is its own
    way, not the function's work."""
    R, N = res_q.shape
    nres = free.shape[1]
    nbytes = R * N * (4 + 4 + 4 + 1) + R * nres * 4
    res = res_q.cpu().numpy()
    q_by_res = np.stack([(res == r).sum(1) for r in range(nres)], 1)
    ops = 5.0 * (q_by_res.astype(np.float64) ** 2).sum()
    return nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3


def mask_err(got, want) -> int:
    """max |got - want| over two admission masks, as an integer (0 or 1)."""
    return int((got.int() - want.int()).abs().max())


def phase_kernels(torch, fused_admission, dense):
    """The kernel against its plain version over the grid; returns the
    largest difference (0, or it raises)."""
    rng = np.random.default_rng(11)
    n_cases = err = 0
    for R in CHECK_R:
        for N in CHECK_N:
            for nres in CHECK_NRES:
                for sent in CHECK_SENTINELS:
                    args = admission_case(rng, R, N, nres, sent,
                                          float_keys=(N + nres) % 2 == 1,
                                          device="cuda")
                    got = fused_admission(*args)
                    want = dense(*args)
                    err = max(err, mask_err(got, want))
                    if err:
                        raise AssertionError(
                            f"fused_admission differs from its plain version "
                            f"in {int((got != want).sum())} rows at R={R} "
                            f"N={N} nres={nres} sentinels={sent}")
                    n_cases += 1
    # one queued row in an input of the wave loop's width
    args = admission_case(rng, N_REPLICAS, ONE_QUEUED_N, 2, 1.0,
                          float_keys=True, device="cuda")
    args[0][N_REPLICAS // 2, ONE_QUEUED_N // 2] = 1
    args[3][N_REPLICAS // 2, 1] = 1
    got, want = fused_admission(*args), dense(*args)
    if mask_err(got, want) or int(got.sum()) != 1:
        raise AssertionError("fused_admission differs from its plain version "
                             "with one queued row")
    n_cases += 1
    log(f"[2] fused_admission == admission_mask_dense exactly on {n_cases} "
        f"cases (R in {CHECK_R}, N in {CHECK_N}, nres in {CHECK_NRES}, "
        f"sentinel shares {CHECK_SENTINELS}; tied keys; negative free; and "
        f"one queued row in {N_REPLICAS} x {ONE_QUEUED_N})")
    return err


class InputTap:
    """Stands in for ``fused_admission`` inside the engine: launches it and
    keeps a copy of every ``every``-th call's inputs."""

    def __init__(self, kernel, every):
        self.kernel, self.every = kernel, every
        self.calls, self.kept = 0, []

    def __call__(self, *args):
        if self.calls % self.every == 0:
            self.kept.append([a.clone() for a in args])
        self.calls += 1
        return self.kernel(*args)


def time_admission(torch, fused_admission, dense, kept, phase="3",
                   where="the main path"):
    """On each kept input of a path (``where``, logged under ``phase``):
    the kernel and the
    ``torch.sort`` yardstick against the plain version, then the three
    timed call after call (``cuda_ms``, as every kernel's ``ms``), the
    kernel also on the device alone (``graph_ms``: the wrapper's host side
    outlasts the kernel, so ``cuda_ms`` times the host), and the input's
    bound. Returns
    the means over the inputs (the mean launch of the run) and the largest
    difference."""
    rows, err = [], 0
    for a in kept:
        want = dense(*a)
        got = fused_admission(*a)
        err = max(err, mask_err(got, want))
        if err:
            raise AssertionError(
                f"fused_admission differs from its plain version in "
                f"{int((got != want).sum())} rows on an input of {where}")
        if not bool(torch.equal(sorted_admission(*a), want)):
            raise AssertionError("the torch.sort yardstick differs on an "
                                 f"input of {where}")
        bytes_ms, ops_ms = admission_bound(a[0], a[3])
        rows.append(dict(
            queued=int((a[0] < a[3].shape[1]).sum()),
            ms=cuda_ms(lambda: fused_admission(*a), iters=100),
            device_ms=graph_ms(lambda: fused_admission(*a), iters=100),
            plain_ms=cuda_ms(lambda: dense(*a), iters=20, warmup=3),
            library_ms=cuda_ms(lambda: sorted_admission(*a), iters=50),
            bytes_ms=bytes_ms, ops_ms=ops_ms))
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms",
                      "ops_ms")}
    bound_ms = float(np.mean([max(r["bytes_ms"], r["ops_ms"]) for r in rows]))
    kms = [r["device_ms"] for r in rows]
    q = [r["queued"] for r in rows]
    shapes = sorted({tuple(a[0].shape) for a in kept}, key=np.prod)
    shape = f"[R={shapes[0][0]}, N={shapes[0][1]}]"
    if len(shapes) > 1:
        shape = (f"{len(shapes)} shapes, {shape} to "
                 f"[R={shapes[-1][0]}, N={shapes[-1][1]}]")
    log(f"[{phase}] admission on {len(rows)} inputs kept from {where} "
        f"({shape}, queued rows per input "
        f"{min(q)}-{max(q)}, mean {np.mean(q):.1f}): kernel mean "
        f"{mean['ms']:.6f} ms per call, one after another; on the device "
        f"alone {mean['device_ms']:.6f} ms (min {min(kms):.6f}, median "
        f"{np.median(kms):.6f}, max {max(kms):.6f}); plain "
        f"{mean['plain_ms']:.6f} ms, chained torch.sort "
        f"{mean['library_ms']:.6f} ms, bound {bound_ms:.6f} ms (bytes "
        f"{mean['bytes_ms']:.6f}, operations {mean['ops_ms']:.6f}); equal "
        "to the plain version on every input")
    return dict(max_abs_err=err, ms=mean["ms"], device_ms=mean["device_ms"],
                plain_ms=mean["plain_ms"], bound_ms=bound_ms,
                bound_by=("bytes" if mean["bytes_ms"] >= mean["ops_ms"]
                          else "operations"),
                library_ms=mean["library_ms"])


# ------------------------------------------------------------ phase 3

def build_ensemble():
    """The main path's inputs, on the host: R one-day workloads with their
    compiled scenarios, padded and stacked."""
    from repro_torch.core import batching, des
    from repro_torch.core import model as M
    from repro_torch.core.workload import generate_empirical_workload
    from repro_torch.ops.capacity import MaintenanceWindows
    from repro_torch.ops.failures import FailureModel
    from repro_torch.ops.scenario import Scenario

    base = M.PlatformConfig()
    maint = MaintenanceWindows(((6 * 3600.0, 10 * 3600.0, 1, 0.5),
                                (14 * 3600.0, 16 * 3600.0, 0, 0.75)))
    plats, wls, comps, pols = [], [], [], []
    for i in range(N_REPLICAS):
        plat = base.with_capacity("learning_cluster",
                                  LEARNING_CAPS[i % len(LEARNING_CAPS)])
        pol = (des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF)[i % 3]
        wl = generate_empirical_workload(i, HORIZON_S)
        scen = Scenario(capacity=maint if i % 2 else None,
                        failures=FailureModel(resample_service=i % 4 == 3))
        plats.append(plat)
        wls.append(wl)
        pols.append(pol)
        comps.append(scen.compile(wl, plat, HORIZON_S, seed=i, policy=pol))
    cols = batching.pad_workloads(wls, plats)
    cols.update(batching.stack_scenarios(
        comps, cols["n_max"], HORIZON_S,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)]))
    caps = np.stack([p.capacities for p in plats]).astype(np.int32)
    return plats, wls, comps, np.array(pols, np.int32), cols, caps


def check_invariants(out, wls, comps):
    start = out["start"].cpu().numpy()
    finish = out["finish"].cpu().numpy()
    ready = out["ready"].cpu().numpy()
    done = out["done"].cpu().numpy()
    a_s = out["att_start"].cpu().numpy()
    a_f = out["att_finish"].cpu().numpy()
    for i, (wl, comp) in enumerate(zip(wls, comps)):
        n = wl.n
        if not done[i, :n].all():
            raise AssertionError(f"replica {i}: {int((~done[i, :n]).sum())} "
                                 "pipelines not done")
        live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
        s, f, r = start[i, :n][live], finish[i, :n][live], ready[i, :n][live]
        if np.isnan(s).any() or not ((s >= r).all() and (f >= s).all()):
            raise AssertionError(f"replica {i}: start < ready or finish < "
                                 "start, or a live task never ran")
        for res in range(comp.cap_vals.shape[1]):
            m = live & (wl.task_res == res)
            st, fi = a_s[i, :n][m].ravel(), a_f[i, :n][m].ravel()
            ran = ~np.isnan(st)
            t = np.concatenate([st[ran], fi[ran]])
            d = np.concatenate([np.ones(ran.sum()), -np.ones(ran.sum())])
            order = np.lexsort((d, t))          # a finish frees its slot first
            peak = int(np.cumsum(d[order]).max())
            cap = int(comp.cap_vals[:, res].max())
            if peak > cap:
                raise AssertionError(f"replica {i} resource {res}: {peak} "
                                     f"attempts ran at once, capacity {cap}")


def phase_main_path(torch, fused_admission, inputs):
    from repro_torch.core import batching, vdes
    plats, wls, comps, pols, cols, caps = inputs
    t = batching.to_tensors(cols, "cuda")
    n_pipes = sum(w.n for w in wls)
    log(f"[3] {N_REPLICAS} replicas x 1 day: {n_pipes} pipelines, "
        f"{sum(int(w.n_tasks.sum()) for w in wls)} tasks (seed 0: "
        f"{wls[0].n} / {int(wls[0].n_tasks.sum())}), N_max={cols['n_max']}, "
        f"T={cols['task_res'].shape[2]}, K={cols['cap_times'].shape[1]}, "
        f"attempt slots={cols['n_attempt_slots']}")
    tap = InputTap(fused_admission, KEEP_EVERY)
    vdes.fused_admission = tap
    torch.cuda.synchronize()
    fused_admission.launches = 0
    try:
        t0 = time.perf_counter()
        out = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        vdes.fused_admission = fused_admission
    launches = fused_admission.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_admission")
    waves = out["waves"].cpu().numpy()
    log(f"[3] simulate_ensemble on the card: wall {wall:.3f} s, waves max "
        f"{int(waves.max())} (min {int(waves.min())}), "
        f"{waves.max() / wall:.1f} waves/s, {n_pipes / wall:.1f} pipelines/s, "
        f"fused_admission launches {launches}")
    check_invariants(out, wls, comps)
    log("[3] invariants hold: all pipelines done, start >= ready, "
        "finish >= start, capacity never exceeded")

    idx = list(DENSE_REPLICAS)
    sub = {k: v[idx] if torch.is_tensor(v) else v for k, v in t.items()}
    t0 = time.perf_counter()
    ref = vdes.simulate_ensemble(**sub, capacities=caps[idx],
                                 policies=pols[idx], admission_sort="dense",
                                 device="cuda")
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    for k in ref:
        if not same_bits(out[k][idx], ref[k]):
            raise AssertionError(f"kernel run != dense run on replicas {idx}: "
                                 f"{k}")
    log(f"[3] replicas {idx} re-run with the plain admission on the card "
        f"({dense_wall:.3f} s): bit-identical start/finish/ready/attempts/"
        "done/waves/att_start/att_finish")
    return out, launches, wall, tap.kept


# ------------------------------------------------------------ phase 4

def phase_single(torch, fused_admission, inputs, ens):
    from repro_torch.core import trace, vdes
    from repro_torch.ops.accounting import SLOConfig
    plats, wls, comps, pols, cols, caps = inputs
    wl, plat, comp = wls[0], plats[0], comps[0]
    fused_admission.launches = 0
    t0 = time.perf_counter()
    tr = vdes.simulate_to_trace(wl, plat, int(pols[0]), scenario=comp,
                                device="cuda")
    wall = time.perf_counter() - t0
    if fused_admission.launches <= 0:
        raise AssertionError("simulate_to_trace never launched the kernel")
    n = wl.n
    for k in ("start", "finish", "ready"):
        want = ens[k][0, :n].cpu().numpy().astype(np.float64)
        if not np.array_equal(getattr(tr, k), want, equal_nan=True):
            raise AssertionError(f"simulate_to_trace != ensemble replica 0: {k}")
    rec = trace.flatten_trace(tr, wl)
    summ = trace.summarize(rec, plat.capacities, HORIZON_S,
                           schedule=comp.schedule,
                           cost_rates=np.array([0.5, 3.0]),
                           slo=SLOConfig())
    for k in ("mean_wait_s", "p95_wait_s", "total_cost",
              "deadline_miss_rate"):
        if not np.isfinite(summ[k]):
            raise AssertionError(f"summary {k} = {summ[k]}")
    if summ["n_pipelines"] != n:
        raise AssertionError("summary lost pipelines")
    log(f"[4] simulate_to_trace (wall {wall:.3f} s, {tr.waves} waves, "
        f"{fused_admission.launches} launches) == ensemble replica 0; "
        f"summary: mean_wait_s {summ['mean_wait_s']:.3f}, p95_wait_s "
        f"{summ['p95_wait_s']:.3f}, utilization "
        f"{json.dumps(summ['utilization'])}, total_cost "
        f"{summ['total_cost']:.2f}, deadline_miss_rate "
        f"{summ['deadline_miss_rate']:.4f}")


# ------------------------------------------------------------ phase 1

def build_kernels(_build):
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()

    def one(name):
        t = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(KERNELS)) as ex:
        secs = list(ex.map(one, KERNELS))
    log(f"[1] built {', '.join(f'{n} ({s:.2f} s)' for n, s in zip(KERNELS, secs))}"
        f" in parallel: {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if ("ptxas info" in line and ("Used" in line or "entry" in line)
                    or "spill" in line):
                log(f"[1]   {name}: {line.strip()}")
    kernel_sass(_build)


# the libraries whose tensor-core kernels must show HGMMA in their SASS:
# library -> (the tensor-core kernels' name part, the other kernels')
TC_KERNELS = {"flash_attention": ("flash_bf16", "flash_f32"),
              "mamba2_scan": ("mamba2_tc", "mamba2_scan_kernel")}


def kernel_sass(_build):
    """Counts of tensor-core (``HGMMA``) and TMA-load (``UTMALDG``)
    instructions in each kernel of the flash and SSD libraries, from
    ``cuobjdump -sass`` where the toolkit has it; fails if a tensor-core
    kernel (bf16 flash, the SSD scan's bf16 route) has no HGMMA."""
    import os
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        log("[1] no cuobjdump in the toolkit: SASS not counted")
        return
    for lib, (tc, other) in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build.build(lib))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
            elif fn is not None:
                for op in counts[fn]:
                    counts[fn][op] += op in line
        for fn, c in counts.items():
            kind = ("tensor cores" if tc in fn else
                    "CUDA cores" if other in fn else "?")
            tmpl = fn.split("ILi")[1].split("E")[0] if "ILi" in fn else "-"
            log(f"[1]   {lib} {kind} (template {tmpl}): {c['HGMMA']} HGMMA, "
                f"{c['UTMALDG']} UTMALDG in the SASS")
            if tc in fn and not c["HGMMA"]:
                raise AssertionError(f"no HGMMA in {fn}")
        if not any(tc in fn for fn in counts):
            raise AssertionError(f"no {tc} kernel in the {lib} library")


# ------------------------------------------------------------ phase 5

def flash_errs(got, want, where):
    """max |got - want| and the largest ||got - want|| / ||want|| over the
    output's rows ([..., D]); raises past FLASH_TOL of want's type, or in
    bf16 past FLASH_ROW_REL_TOL."""
    dt = str(want.dtype)[6:]
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    rel = float((diff.norm(dim=-1)
                 / want.float().norm(dim=-1).clamp_min(1e-30)).max())
    rel_tol = FLASH_ROW_REL_TOL if dt == "bfloat16" else float("inf")
    if not (err <= FLASH_TOL[dt] and rel <= rel_tol):
        raise AssertionError(
            f"flash_attention differs from its plain version {where}: max "
            f"|diff| {err} (tol {FLASH_TOL[dt]}), largest row-relative "
            f"difference {rel} (tol {rel_tol})")
    return err, rel


def phase_flash_grid(torch, flash_attention):
    """The flash kernel against its plain version over the grid; returns
    the largest difference (within tolerance, or it raises)."""
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {dt: 0.0 for dt in FLASH_TOL}
    worst_rel = {dt: 0.0 for dt in FLASH_TOL}
    n_cases = 0
    t0 = time.perf_counter()
    shapes = [(B, S, H, Hkv, D) for B in FLASH_B for S in FLASH_S
              for H, Hkv in FLASH_HEADS for D in FLASH_D]
    for B, S, H, Hkv, D in shapes + list(FLASH_EXTRA):
        for dt in FLASH_TOL:
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                       .to(getattr(torch, dt)) for h in (H, Hkv, Hkv))
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = flash_attention_ref(q, k, v, causal=causal)
                err, rel = flash_errs(
                    got, want, f"at B={B} S={S} H={H} Hkv={Hkv} D={D} {dt} "
                    f"causal={causal}")
                worst[dt] = max(worst[dt], err)
                worst_rel[dt] = max(worst_rel[dt], rel)
                n_cases += 1
    log(f"[5] flash_attention == flash_attention_ref on {n_cases} cases "
        f"(B in {FLASH_B}, S in {FLASH_S}, (H, Hkv) in {FLASH_HEADS}, D in "
        f"{FLASH_D}, and (B, S, H, Hkv, D) in {FLASH_EXTRA}; f32/bf16, "
        f"causal/not) in {time.perf_counter() - t0:.2f} "
        f"s: max |diff| f32 {worst['float32']:.3g} (tol "
        f"{FLASH_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol "
        f"{FLASH_TOL['bfloat16']}); largest row-relative difference f32 "
        f"{worst_rel['float32']:.3g}, bf16 {worst_rel['bfloat16']:.3g} (tol "
        f"{FLASH_ROW_REL_TOL})")
    return max(worst.values())


# ------------------------------------------------------------ phase 6

class CallTap:
    """Stands in for a kernel wrapper inside the model: launches it and
    keeps a copy of the first call's tensor arguments (layer 0)."""

    def __init__(self, kernel):
        self.kernel, self.kept = kernel, None

    def __call__(self, *args, **kw):
        if self.kept is None:
            self.kept = [a.clone() for a in args]
        return self.kernel(*args, **kw)


def phase_serving(torch, flash_attention):
    """The serving main path at full width in bf16, through the kernel."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import attention
    cfg = configs.get_config(SERVE_ARCH)
    tap = CallTap(flash_attention)
    attention.flash_attention = tap
    torch.cuda.synchronize()
    flash_attention.launches = 0
    try:
        out = serve.run_serving(SERVE_ARCH, batch=SERVE_B,
                                prompt_len=SERVE_PROMPT,
                                new_tokens=SERVE_NEW, smoke=False,
                                attn_impl="flash", device="cuda",
                                seed=SERVE_SEED)
    finally:
        attention.flash_attention = flash_attention
    launches = flash_attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"not once per layer ({cfg.n_layers})")
    if not (out["all_in_vocab"] and out["logits_finite"]
            and out["generated_shape"] == [SERVE_B, SERVE_NEW]):
        raise AssertionError(f"serving run failed its checks: {out}")
    log(f"[6] run_serving({SERVE_ARCH}, batch={SERVE_B}, prompt_len="
        f"{SERVE_PROMPT}, new_tokens={SERVE_NEW}, bf16, flash) on the card: "
        f"{out['n_params']:,} parameters; time to first token "
        f"{out['prefill_s']:.4f} s; decode {out['decode_tokens_per_s']:.1f} "
        f"tokens/s; total {out['tokens_per_s']:.1f} tokens/s (wall "
        f"{out['wall_s']:.4f} s); flash_attention launches {launches}; tokens "
        "in vocab, logits finite")
    return out, launches, tap.kept


def phase_serving_twin(torch):
    """The same weights in f32: prefill and teacher-forced decode through
    the kernel and through the plain path agree within TWIN_ATOL."""
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    cfgs = {impl: configs.get_config(SERVE_ARCH, attn_impl=impl, **f32)
            for impl in ("flash", "xla")}
    params = get_model(cfgs["flash"]).init(SERVE_SEED, "cuda")
    scfg = ServeConfig(batch=SERVE_B, max_len=SERVE_PROMPT + SERVE_NEW + 1)
    eng = {impl: ServingEngine(c, scfg, params=params, device="cuda")
           for impl, c in cfgs.items()}
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    prompts = random_prompts(cfgs["flash"].vocab_size, SERVE_B, SERVE_PROMPT,
                             gen)
    logits, caches = {}, {}
    for impl, e in eng.items():
        logits[impl], caches[impl] = e.prefill(prompts)
    prefill_err = float((logits["flash"] - logits["xla"]).abs().max())
    scale = float(logits["xla"].abs().max())
    decode_err = 0.0
    for i in range(SERVE_NEW):
        tok = logits["flash"][:, -1].argmax(-1)[:, None].to(torch.int32)
        for impl, e in eng.items():
            logits[impl], caches[impl] = e.decode(tok, caches[impl],
                                                  SERVE_PROMPT + i)
        decode_err = max(decode_err,
                         float((logits["flash"] - logits["xla"]).abs().max()))
    if not (prefill_err <= TWIN_ATOL and decode_err <= TWIN_ATOL):
        raise AssertionError(f"f32 flash vs plain: prefill logits differ by "
                             f"{prefill_err}, decode logits by {decode_err} "
                             f"(tol {TWIN_ATOL})")
    log(f"[6] f32 twin (same weights, no TF32), flash vs plain: prefill "
        f"logits max |diff| {prefill_err:.3g}, {SERVE_NEW} teacher-forced "
        f"decode steps {decode_err:.3g} (tol {TWIN_ATOL}; max |logit| "
        f"{scale:.3g}) in {time.perf_counter() - t0:.2f} s")


def flash_bound(q, k):
    """Least time for one causal call on these inputs, as ``(bytes_ms,
    ops_ms)``. Bytes: q, k, v read and o written once. Operations: the
    pairs (query, key <= query) the causal softmax needs, 2 D FLOPs each for
    q.k and for p.v, at the card's peak rate for the input type."""
    B, S, H, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 2 * 2 * B * H * D * S * (S + 1) // 2
    dt = "bfloat16" if q.element_size() == 2 else "float32"
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[dt] * 1e3


def check_flash(torch, flash_attention, kept, where):
    """The kernel and ``scaled_dot_product_attention`` against the plain
    version on kept causal inputs, each within FLASH_TOL (the kernel in
    bf16 also within FLASH_ROW_REL_TOL); returns the kernel's largest and
    row-relative differences, the library's largest, and the library
    call."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = kept
    want = flash_attention_ref(q, k, v, causal=True)
    got = flash_attention(q, k, v, causal=True)
    tol = FLASH_TOL[str(q.dtype)[6:]]
    err, rel = flash_errs(got, want, where)
    del got
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - want.float())
                    .abs().max())
    if not lib_err <= tol:
        raise AssertionError(f"scaled_dot_product_attention differs from the "
                             f"plain version by {lib_err} {where}")
    return err, rel, lib_err, library


def time_flash(torch, flash_attention, kept, tag, where):
    """On kept causal inputs of a path: the kernel and
    ``scaled_dot_product_attention`` against the plain version, then the
    three timed with CUDA events, and the bound."""
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = kept
    err, rel, lib_err, library = check_flash(torch, flash_attention, kept,
                                             where)
    ms = cuda_ms(lambda: flash_attention(q, k, v), iters=100)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), iters=10,
                       warmup=2)
    library_ms = cuda_ms(library, iters=100)
    bytes_ms, ops_ms = flash_bound(q, k)
    bound_ms = max(bytes_ms, ops_ms)
    B, S, H, D = q.shape
    tflop = 2 * 2 * B * H * D * S * (S + 1) / 2 / 1e12
    log(f"[{tag}] flash_attention {where} (q {list(q.shape)}, k/v "
        f"{list(k.shape)}, {str(q.dtype)[6:]}, causal): "
        f"kernel {ms:.6f} ms ({tflop / ms * 1e3:.1f} TFLOP/s effective), "
        f"plain {plain_ms:.6f} ms, scaled_dot_product_attention "
        f"{library_ms:.6f} ms ({tflop / library_ms * 1e3:.1f} TFLOP/s), "
        f"bound {bound_ms:.6f} ms (bytes {bytes_ms:.6f}, operations "
        f"{ops_ms:.6f}); max |diff| to plain: kernel {err:.3g} (row-relative "
        f"{rel:.3g}), sdpa {lib_err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms)


# ------------------------------------------------------------ phase 7

def gmm_case(torch, gen, N, D, K):
    """Log-scale-like data and well-conditioned factors (diagonal in
    [0.5, 2]), so |logpdf| reaches about 5e5 at D = 128."""
    from repro_torch.core.gmm import inverse_chol
    x = torch.randn(N, D, generator=gen, device="cuda") * 2.0 + 1.0
    mu = torch.randn(K, D, generator=gen, device="cuda") * 2.0
    L = torch.randn(K, D, D, generator=gen, device="cuda").tril(-1) * 0.2
    L = L + torch.diag_embed(
        torch.rand(K, D, generator=gen, device="cuda") * 1.5 + 0.5)
    lw = torch.log_softmax(torch.randn(K, generator=gen, device="cuda"), 0)
    return x, mu, inverse_chol(L).contiguous(), lw


def gmm_err(torch, got, want, where):
    """max |got - want|; raises past GMM_ATOL + GMM_RTOL |want|."""
    diff = (got - want).abs()
    if not bool((diff <= GMM_ATOL + GMM_RTOL * want.abs()).all()):
        raise AssertionError(f"gmm_logpdf differs from its plain version by "
                             f"{float(diff.max())} {where}")
    return float(diff.max())


def phase_gmm_grid(torch, gmm_logpdf):
    from repro_torch.kernels.ref import gmm_logpdf_ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst, top, n_cases = 0.0, 0.0, 0
    t0 = time.perf_counter()
    for N in GMM_N:
        for D in GMM_D:
            for K in GMM_K:
                args = gmm_case(torch, gen, N, D, K)
                want = gmm_logpdf_ref(*args)
                worst = max(worst, gmm_err(
                    torch, gmm_logpdf(*args), want,
                    f"at N={N} D={D} K={K}"))
                top = max(top, float(want.abs().max()))
                n_cases += 1
    torch.cuda.synchronize()
    log(f"[7] gmm_logpdf == gmm_logpdf_ref on {n_cases} cases (N in {GMM_N}, "
        f"D in {GMM_D}, K in {GMM_K}) in {time.perf_counter() - t0:.2f} s: "
        f"max |diff| {worst:.3g} (tol {GMM_ATOL} + {GMM_RTOL} |logpdf|; "
        f"max |logpdf| {top:.4g})")
    return worst


# ------------------------------------------------------------ phase 8

class GmmTap:
    """Stands in for ``gmm_logpdf`` inside ``core/gmm.py``: launches it and
    keeps a copy of every ``every``-th asset E-step's inputs (D = 3)."""

    def __init__(self, kernel, every):
        self.kernel, self.every = kernel, every
        self.asset_calls, self.kept = 0, []

    def __call__(self, x, means, inv_chol, log_w):
        if x.shape[1] == 3:
            if self.asset_calls % self.every == 0:
                self.kept.append([t.clone() for t in
                                  (x, means, inv_chol, log_w)])
            self.asset_calls += 1
        return self.kernel(x, means, inv_chol, log_w)


class Stopwatch:
    """Wraps a function: accumulates its wall time, synchronizing the card
    before and after so the time is the call's own; given a ``keep`` list,
    also appends each call's keywords and result to it."""

    def __init__(self, torch, fn, keep=None):
        self.torch, self.fn, self.s, self.calls = torch, fn, 0.0, 0
        self.keep = keep

    def __call__(self, *a, **k):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        self.torch.cuda.synchronize()
        self.s += time.perf_counter() - t0
        self.calls += 1
        if self.keep is not None:
            self.keep.append((k, out))
        return out


def gmm_finite(torch, g) -> bool:
    return all(bool(torch.isfinite(t).all())
               for t in (g.log_weights, g.means, g.chol))


def phase_fit_path(torch, gmm_logpdf, fused_admission, flash_attention):
    """fit -> synthesize -> simulate on the card, through the kernels."""
    from repro_torch.core import engines, experiment, fitting
    from repro_torch.core import gmm as gmm_mod
    from repro_torch.core import vdes
    from repro_torch.core.workload import generate_empirical_workload
    t0 = time.perf_counter()
    wl = generate_empirical_workload(seed=FIT_SEED,
                                     horizon_s=FIT_DAYS * 86400.0)
    gen_s = time.perf_counter() - t0
    tap = GmmTap(gmm_logpdf, GMM_KEEP_EVERY)
    em = Stopwatch(torch, fitting.fit_gmm)
    syn = Stopwatch(torch, engines.synthesize_workload)
    ens = Stopwatch(torch, vdes.simulate_ensemble)
    gmm_mod.gmm_logpdf, fitting.fit_gmm = tap, em
    engines.synthesize_workload, vdes.simulate_ensemble = syn, ens
    torch.cuda.synchronize()
    gmm_logpdf.launches = fused_admission.launches = 0
    flash_attention.launches = 0
    try:
        t0 = time.perf_counter()
        params = fitting.fit_simulation_params(wl, device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = gmm_logpdf.launches
        spec = experiment.ExperimentSpec(
            name="chip", horizon_s=86400.0, n_replicas=SYN_REPLICAS,
            seed=SYN_SEED)
        t0 = time.perf_counter()
        res = experiment.run_experiment(spec, params, device="cuda")
        run_s = time.perf_counter() - t0
    finally:
        gmm_mod.gmm_logpdf, fitting.fit_gmm = gmm_logpdf, em.fn
        engines.synthesize_workload, vdes.simulate_ensemble = syn.fn, ens.fn
    launches = gmm_logpdf.launches
    adm_launches = fused_admission.launches
    if fit_launches != FIT_LAUNCHES or launches != FIT_LAUNCHES:
        raise AssertionError(f"gmm_logpdf launched {fit_launches} times in "
                             f"the fit ({launches} on the whole path), not "
                             f"{FIT_LAUNCHES}")
    if adm_launches <= 0 or flash_attention.launches:
        raise AssertionError(f"the ensemble launched fused_admission "
                             f"{adm_launches} and flash_attention "
                             f"{flash_attention.launches} times")
    bad = [k for k, g in params.gmms().items() if not gmm_finite(torch, g)]
    if bad:
        raise AssertionError(f"NaN or inf in the fitted GMMs {bad}")
    X = torch.as_tensor(fitting.asset_matrix(wl), dtype=torch.float32,
                        device="cuda")
    art = fitting.SimulationParams.load(str(ARTIFACT), device="cuda")
    ll = float(params.asset_gmm.log_prob(X).mean())
    ll_art = float(art.asset_gmm.log_prob(X).mean())
    if not ll >= ll_art - FIT_LL_MARGIN:
        raise AssertionError(f"asset GMM mean log-likelihood {ll} is below "
                             f"the committed fit's {ll_art} by more than "
                             f"{FIT_LL_MARGIN}")
    log(f"[8] fit on {FIT_DAYS:g} days of ground truth (seed {FIT_SEED}: "
        f"{wl.n} pipelines, {X.shape[0]} assets kept; generated in "
        f"{gen_s:.2f} s): wall {fit_s:.3f} s = EM on the card {em.s:.3f} s "
        f"({em.calls} GMMs) + host {fit_s - em.s:.3f} s; gmm_logpdf "
        f"launches {fit_launches}; no NaN in the 12 GMMs; asset GMM (K="
        f"{params.asset_gmm.n_components}) mean log-likelihood {ll:.6f} vs "
        f"the committed fit's {ll_art:.6f} (margin {FIT_LL_MARGIN})")

    n_syn = sum(s["n_pipelines"] for s in res.replica_summaries)
    if set(res.summary) != REF_ENSEMBLE_KEYS:
        raise AssertionError(f"summary keys {sorted(res.summary)} != the "
                             f"reference CLI's {sorted(REF_ENSEMBLE_KEYS)}")
    rec = res.records
    if not (np.isfinite(rec.finish).all() and np.isfinite(rec.start).all()
            and (rec.finish >= rec.start).all()):
        raise AssertionError("a synthesized pipeline did not finish")
    if syn.calls != SYN_REPLICAS or ens.calls != 1:
        raise AssertionError(f"{syn.calls} syntheses and {ens.calls} "
                             "ensemble calls")
    log(f"[8] run_experiment({SYN_REPLICAS} synthesized one-day replicas, "
        f"seed {SYN_SEED}) on the card: {n_syn} pipelines, {len(rec.start)} "
        f"tasks, all finished; synthesis {syn.s:.3f} s ({syn.s / syn.calls:.4f}"
        f" s per replica-day); ensemble {ens.s:.3f} s ({n_syn / ens.s:.1f} "
        f"pipelines/s; fused_admission launches {adm_launches}); "
        f"run_experiment wall {run_s:.3f} s; summary: "
        f"{json.dumps(res.summary)}")
    return dict(launches=launches, fit_s=fit_s, em_s=em.s, syn_s=syn.s,
                ens_s=ens.s, n_syn=n_syn), tap.kept


def gmm_bound(x, means):
    """Least time for one call on these inputs, as ``(bytes_ms, ops_ms)``.
    Bytes: x, the means, factors and weights read once, the [N, K] output
    written once. Operations: per (row, component) D subtractions, the
    D x D product (2 D^2), D squares and adds, and 4 for the weight, the
    constant and the log-determinant, on the CUDA cores' f32 rate."""
    N, D = x.shape
    K = means.shape[0]
    nbytes = 4 * (N * D + K * D + K * D * D + K + N * K)
    ops = N * K * (2 * D * D + 3 * D + 4)
    return nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3


def time_gmm(torch, gmm_logpdf, kept):
    """On each kept asset E-step input of the fit: the kernel and the
    ``MultivariateNormal`` yardstick against the plain version, then the
    three timed call after call (``cuda_ms``), the kernel also on the
    device alone (``graph_ms``), and the bound. Returns the means over the
    inputs and the largest difference."""
    from repro_torch.kernels.ref import gmm_logpdf_ref
    rows, err, lib_err = [], 0.0, 0.0
    for x, means, inv, lw in kept:
        eye = torch.eye(x.shape[1], device="cuda").expand_as(inv)
        chol = torch.linalg.solve_triangular(inv, eye, upper=False)

        def library():
            mvn = torch.distributions.MultivariateNormal(
                means, scale_tril=chol, validate_args=False)
            return mvn.log_prob(x[:, None]) + lw

        want = gmm_logpdf_ref(x, means, inv, lw)
        err = max(err, gmm_err(torch, gmm_logpdf(x, means, inv, lw), want,
                               "on a kept asset E-step input"))
        lib_err = max(lib_err, float((library() - want).abs().max()))
        bytes_ms, ops_ms = gmm_bound(x, means)
        rows.append(dict(
            ms=cuda_ms(lambda: gmm_logpdf(x, means, inv, lw), iters=200),
            device_ms=graph_ms(lambda: gmm_logpdf(x, means, inv, lw),
                               iters=200),
            plain_ms=cuda_ms(lambda: gmm_logpdf_ref(x, means, inv, lw),
                             iters=100),
            library_ms=cuda_ms(library, iters=100),
            bytes_ms=bytes_ms, ops_ms=ops_ms))
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms",
                      "ops_ms")}
    bound_ms = max(mean["bytes_ms"], mean["ops_ms"])
    x, means = kept[0][0], kept[0][1]
    log(f"[8] gmm_logpdf on {len(rows)} asset E-step inputs kept from the "
        f"fit (x {list(x.shape)}, K={means.shape[0]}): kernel "
        f"{mean['ms']:.6f} ms per call, one after another (on the device "
        f"alone {mean['device_ms']:.6f} ms), plain "
        f"{mean['plain_ms']:.6f} ms, "
        f"MultivariateNormal.log_prob {mean['library_ms']:.6f} ms, bound "
        f"{bound_ms:.6f} ms (bytes {mean['bytes_ms']:.6f}, operations "
        f"{mean['ops_ms']:.6f}); max |diff| to plain: kernel {err:.3g}, "
        f"MultivariateNormal {lib_err:.3g}")
    return dict(max_abs_err=err, ms=mean["ms"], device_ms=mean["device_ms"],
                plain_ms=mean["plain_ms"], bound_ms=bound_ms,
                bound_by="bytes" if mean["bytes_ms"] >= mean["ops_ms"]
                else "operations",
                library_ms=mean["library_ms"])


# ------------------------------------------------------------ phase 9

def ssd_case(torch, gen, B, S, H, P, N, dtype):
    """The reference kernel test's scales: x * 0.5, B/C * 0.3,
    dt = softplus(.) * 0.1, A = -exp(. * 0.3)."""
    r = lambda *sh: torch.randn(*sh, generator=gen, device="cuda")
    x = (r(B, S, H, P) * 0.5).to(dtype)
    dt = (torch.nn.functional.softplus(r(B, S, H)) * 0.1).to(dtype)
    A = -torch.exp(r(H) * 0.3)
    Bm, Cm = ((r(B, S, N) * 0.3).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def ssd_err(got, want, where):
    """max |got - want| over y and h_last; raises past SSD_ATOL + SSD_RTOL
    |want|."""
    worst = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        if g.dtype != w.dtype or g.shape != w.shape or not bool(
                (diff <= SSD_ATOL + SSD_RTOL * w.abs()).all()):
            raise AssertionError(f"mamba2_scan differs from its plain "
                                 f"version by {float(diff.max())} {where}")
        worst = max(worst, float(diff.max()))
    return worst


def phase_ssd_grid(torch, mamba2_scan):
    """The SSD kernel against its plain version (and, on the small cases,
    against the O(S) recurrence) over the grid; returns the largest
    difference (within tolerance, or it raises)."""
    from repro_torch.kernels.ref import mamba2_recurrent_ref, mamba2_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = worst_rec = top = 0.0
    n_cases = n_rec = 0
    routes = dict(mamba2_scan.route_launches)
    t0 = time.perf_counter()
    for S in SSD_S:
        for H in SSD_H:
            for P in SSD_P:
                for N in SSD_N:
                    for chunk in SSD_CHUNK:
                        if S % chunk:
                            continue
                        for dt in ("float32", "bfloat16"):
                            for B in SSD_B:
                                args = ssd_case(torch, gen, B, S, H, P, N,
                                                getattr(torch, dt))
                                got = mamba2_scan(*args, chunk=chunk)
                                want = mamba2_scan_ref(*args, chunk=chunk)
                                where = (f"at B={B} S={S} H={H} P={P} N={N} "
                                         f"chunk={chunk} {dt}")
                                worst = max(worst, ssd_err(got, want, where))
                                top = max(top, float(want[0].abs().max()))
                                n_cases += 1
                                if S <= SSD_RECURRENT_MAX_S and H <= 4:
                                    rec = mamba2_recurrent_ref(*args)
                                    worst_rec = max(worst_rec, ssd_err(
                                        got, rec, where + " (recurrence)"))
                                    n_rec += 1
    torch.cuda.synchronize()
    routes = {k: n - routes[k] for k, n in mamba2_scan.route_launches.items()}
    log(f"[9] mamba2_scan == mamba2_scan_ref on {n_cases} cases (S in "
        f"{SSD_S}, H in {SSD_H}, P in {SSD_P}, N in {SSD_N}, chunk in "
        f"{SSD_CHUNK}, f32/bf16, B in {SSD_B}; S % chunk == 0; launches by "
        f"route {routes}) in "
        f"{time.perf_counter() - t0:.2f} s: max |diff| {worst:.3g} (tol "
        f"{SSD_ATOL} + {SSD_RTOL} |y|; max |y| {top:.4g}); against the O(S) "
        f"recurrence on {n_rec} cases (S <= {SSD_RECURRENT_MAX_S}, H <= 4): "
        f"max |diff| {worst_rec:.3g}")
    return max(worst, worst_rec)


# ------------------------------------------------------------ phase 10

def hybrid_batch(torch, cfg, B, S, seed):
    """Tokens and next-token labels from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                      device="cuda")
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def phase_hybrid_forward(torch, mamba2_scan, flash_attention, counts):
    """The full-sequence forward and loss of zamba2-1.2b at full width in
    bf16, through both kernels: a cold call, then a warm one timed."""
    from repro_torch import configs
    from repro_torch.models import attention, ssm
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import get_model
    cfg = configs.get_config(HYB_ARCH, ssm_impl="mamba_kernel",
                             attn_impl="flash")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(HYB_SEED, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = hybrid_batch(torch, cfg, HYB_B, HYB_S, HYB_SEED + 1)
    ssd_tap, attn_tap = CallTap(mamba2_scan), CallTap(flash_attention)
    ssm.mamba2_scan, attention.flash_attention = ssd_tap, attn_tap
    walls, losses = [], []
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            for k in counts:
                k.launches = 0
            routes = dict(mamba2_scan.route_launches)
            t0 = time.perf_counter()
            with torch.inference_mode():
                loss, _ = model.loss_fn(params, batch)
            loss = float(loss)
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            launched = {k.__name__: k.launches for k in counts}
            want = {k.__name__: 0 for k in counts}
            want.update(mamba2_scan=cfg.n_layers,
                        flash_attention=model.n_super)
            if launched != want:
                raise AssertionError(f"the hybrid forward launched "
                                     f"{launched}, not {want}")
            routes = {k: n - routes[k]
                      for k, n in mamba2_scan.route_launches.items()}
            if routes["tensor_cores"] != cfg.n_layers:
                raise AssertionError(f"the hybrid forward's SSD launches took "
                                     f"the routes {routes}")
    finally:
        ssm.mamba2_scan, attention.flash_attention = mamba2_scan, \
            flash_attention
    if not np.isfinite(losses).all():
        raise AssertionError(f"hybrid losses {losses}")
    log(f"[10] {HYB_ARCH} loss_fn at full width (bf16, {n_params:,} "
        f"parameters from seed {HYB_SEED}, drawn on the card in "
        f"{init_s:.2f} s; batch {HYB_B} x {HYB_S} tokens, ssm_impl="
        f"mamba_kernel, attn_impl=flash): loss {losses[0]:.6f} and "
        f"{losses[1]:.6f} (finite); wall cold {walls[0]:.4f} s, warm {walls[1]:.4f} s "
        f"({HYB_B * HYB_S / walls[1]:.0f} tokens/s); launches per forward: "
        f"mamba2_scan {launched['mamba2_scan']} (all on the tensor cores), "
        f"flash_attention {launched['flash_attention']}, others 0")
    del params
    torch.cuda.empty_cache()
    return (dict(wall_s=walls[1], ssd_launches=launched["mamba2_scan"],
                 flash_launches=launched["flash_attention"], loss=losses[0]),
            ssd_tap.kept, attn_tap.kept)


def phase_hybrid_twin(torch, mamba2_scan):
    """The full-width model in f32 (no TF32), batch 1 x 1024: logits and
    loss through the SSD kernel against the plain chunked scan."""
    from repro_torch import configs
    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.models.transformer import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               attn_impl="flash")
    models = {impl: get_model(configs.get_config(HYB_ARCH, ssm_impl=impl,
                                                 **f32))
              for impl in ("mamba_kernel", "xla")}
    params = models["xla"].init(HYB_SEED, "cuda")
    batch = hybrid_batch(torch, models["xla"].cfg, HYB_TWIN_B, HYB_TWIN_S,
                         HYB_SEED + 2)
    logits, loss = {}, {}
    for impl, m in models.items():
        before = mamba2_scan.launches
        with torch.inference_mode():
            logits[impl] = m._forward(params, batch["tokens"])
            loss[impl] = float(cross_entropy_loss(logits[impl],
                                                  batch["labels"]))
        want = m.cfg.n_layers if impl == "mamba_kernel" else 0
        if mamba2_scan.launches - before != want:
            raise AssertionError(f"{impl}: mamba2_scan launched "
                                 f"{mamba2_scan.launches - before} times")
    v = models["xla"].cfg.vocab_size
    lerr = float((logits["mamba_kernel"][..., :v] - logits["xla"][..., :v])
                 .abs().max())
    scale = float(logits["xla"][..., :v].abs().max())
    loss_err = abs(loss["mamba_kernel"] - loss["xla"])
    if not (lerr <= HYB_TWIN_LOGIT_ATOL and loss_err <= HYB_TWIN_LOSS_ATOL):
        raise AssertionError(f"f32 SSD kernel vs plain: logits differ by "
                             f"{lerr}, loss by {loss_err}")
    log(f"[10] f32 twin at full width (batch {HYB_TWIN_B} x {HYB_TWIN_S}, "
        f"no TF32), mamba2_scan vs plain ssd_chunked: logits max |diff| "
        f"{lerr:.3g} (tol {HYB_TWIN_LOGIT_ATOL}; max |logit| {scale:.3g}), "
        f"loss {loss['xla']:.6f} vs {loss['mamba_kernel']:.6f}, |diff| "
        f"{loss_err:.3g} (tol {HYB_TWIN_LOSS_ATOL}) in "
        f"{time.perf_counter() - t0:.2f} s")
    del params, logits
    torch.cuda.empty_cache()


def ssd_bound(x, Bm, chunk):
    """Least time for one call on these inputs, as ``(bytes_ms, ops_ms)``.
    Bytes: x, dt, A, B, C read once, y (f32) and h_last (f32) written once.
    Operations: per (b, h, chunk) the masked C Bᵀ and M x over the Q(Q+1)/2
    pairs j <= i (N and P multiply-adds each), the readout C stateᵀ and the
    update xᵀ(B w) (Q P N each), 2 FLOPs per multiply-add, at the card's
    peak rate for the input type."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    esz = x.element_size()
    nbytes = (esz * (B * S * H * P + B * S * H + 2 * B * S * N) + 4 * H
              + 4 * B * S * H * P + 4 * B * H * P * N)
    pairs = chunk * (chunk + 1) // 2
    flops = 2 * B * H * (S // chunk) * (pairs * (N + P) + 2 * chunk * P * N)
    dt = "bfloat16" if esz == 2 else "float32"
    return nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[dt] * 1e3


def cuda_core_ssd(torch, x, dt, A, Bm, Cm, chunk):
    """The SSD source's CUDA-core kernel on bf16 inputs that the wrapper
    sends to the tensor cores: called through the library directly, for a
    comparison of the two kernels in one run only (no path launches it so,
    and it adds nothing to the wrapper's counts)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as ms
    B, S, H, P = x.shape
    N = Bm.shape[2]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = _build.load("mamba2_scan", ms._SIGNATURES).mamba2_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, P, N, chunk,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the CUDA-core SSD kernel failed with error {err}")
    return y, h


def time_ssd(torch, mamba2_scan, kept):
    """On layer 0's inputs of the bf16 forward: the kernel (its tensor-core
    route) and the source's CUDA-core kernel against the plain version,
    then the three timed with CUDA events, and the bound. No single
    PyTorch call computes the SSD scan: no library yardstick."""
    from repro_torch.kernels.ref import mamba2_scan_ref
    x, dt, A, Bm, Cm = kept
    chunk = HYB_CHUNK
    want = mamba2_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    where = "on layer 0's inputs of the forward"
    err = ssd_err(mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk), want, where)
    core_err = ssd_err(cuda_core_ssd(torch, x, dt, A, Bm, Cm, chunk), want,
                       where + " (CUDA-core kernel)")
    ms = cuda_ms(lambda: mamba2_scan(x, dt, A, Bm, Cm, chunk=chunk), iters=50,
                 warmup=5)
    core_ms = cuda_ms(lambda: cuda_core_ssd(torch, x, dt, A, Bm, Cm, chunk),
                      iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: mamba2_scan_ref(x, dt, A, Bm, Cm, chunk=chunk),
                       iters=3, warmup=1)
    bytes_ms, ops_ms = ssd_bound(x, Bm, chunk)
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[10] mamba2_scan on layer 0's inputs of the forward (x "
        f"{list(x.shape)}, B/C {list(Bm.shape)}, {str(x.dtype)[6:]}, chunk "
        f"{chunk}): kernel (tensor cores) {ms:.6f} ms, the CUDA-core kernel "
        f"on the same inputs {core_ms:.6f} ms, plain {plain_ms:.6f} ms, no "
        f"single PyTorch call computes it; bound {bound_ms:.6f} ms (bytes "
        f"{bytes_ms:.6f}, operations {ops_ms:.6f}); max |diff| to plain "
        f"{err:.3g} (CUDA-core kernel {core_err:.3g})")
    return dict(max_abs_err=err, ms=ms, cuda_core_ms=core_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# ------------------------------------------------------------ phase 11

def phase_hybrid_serving(torch, flash_attention, counts):
    """zamba2-1.2b served at full width in bf16: the prefill runs the
    chunked scan from a zero state (as the reference) and the flash kernel
    in the shared block's 6 applications; decode runs the recurrence. The
    first flash call's inputs are then held against the plain version;
    returns the kernel's difference."""
    from repro_torch.launch import serve
    from repro_torch.models import attention
    tap = CallTap(flash_attention)
    attention.flash_attention = tap
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    try:
        out = serve.run_serving(HYB_ARCH, batch=SERVE_B,
                                prompt_len=SERVE_PROMPT,
                                new_tokens=SERVE_NEW, smoke=False,
                                attn_impl="flash", device="cuda",
                                seed=HYB_SEED)
    finally:
        attention.flash_attention = flash_attention
    launched = {k.__name__: k.launches for k in counts}
    want = {k.__name__: 0 for k in counts}
    want.update(flash_attention=HYB_N_SUPER)
    if launched != want:
        raise AssertionError(f"hybrid serving launched {launched}, not {want}")
    if not (out["all_in_vocab"] and out["logits_finite"]
            and out["generated_shape"] == [SERVE_B, SERVE_NEW]):
        raise AssertionError(f"hybrid serving failed its checks: {out}")
    log(f"[11] run_serving({HYB_ARCH}, batch={SERVE_B}, prompt_len="
        f"{SERVE_PROMPT}, new_tokens={SERVE_NEW}, bf16, flash) on the card: "
        f"{out['n_params']:,} parameters; time to first token "
        f"{out['prefill_s']:.4f} s; decode {out['decode_tokens_per_s']:.1f} "
        f"tokens/s; total {out['tokens_per_s']:.1f} tokens/s (wall "
        f"{out['wall_s']:.4f} s); flash_attention launches "
        f"{launched['flash_attention']}, mamba2_scan 0 (the prefill passes a "
        "zero state); tokens in vocab, logits finite")
    q, k, _ = tap.kept
    err, rel, lib_err, _ = check_flash(torch, flash_attention, tap.kept,
                                       "on the first shared-attention "
                                       "inputs of the hybrid prefill")
    log(f"[11] flash_attention on the first shared-attention inputs of the "
        f"prefill (q {list(q.shape)}, k/v {list(k.shape)}, "
        f"{str(q.dtype)[6:]}, causal): max |diff| to plain: kernel "
        f"{err:.3g} (row-relative {rel:.3g}), sdpa {lib_err:.3g} (tol "
        f"{FLASH_TOL[str(q.dtype)[6:]]})")
    del tap
    torch.cuda.empty_cache()
    return err


# ------------------------------------------------------------ phase 12

def queue_jobs(torch, gen, cap):
    """QUEUE_R stations of QUEUE_N jobs: Poisson arrivals at rate 1,
    exponential service at a per-station load uniform in QUEUE_LOADS (mean
    service load * cap); each row's ready times are sorted by
    construction."""
    R, N = QUEUE_R, QUEUE_N
    inter = torch.empty(R, N, device="cuda").exponential_(generator=gen)
    ready = torch.cumsum(inter, dim=1)
    lo, hi = QUEUE_LOADS
    load = lo + (hi - lo) * torch.rand(R, 1, generator=gen, device="cuda")
    service = torch.empty(R, N, device="cuda").exponential_(generator=gen)
    return ready, service * load * cap


def queue_bound(R, N, cap):
    """Least time for one call, as ``(bytes_ms, ops_ms)``. Bytes: ready and
    service read once, start and finish written once (f32). Operations: per
    job, the c - 1 comparisons of the arg-min, a max and an add, on the
    CUDA cores' rate."""
    return (16 * R * N / PEAK_BYTES_S * 1e3,
            R * N * (cap + 1) / PEAK_OPS_S * 1e3)


def queue_ties(torch, queue_scan):
    """QUEUE_TIE_R stations of QUEUE_N jobs whose ready times take a few
    distinct integers and whose services are integers in {0, 1, 2, 3}
    (scaled with the capacity): equal slots and finishes equal to the slot
    they free everywhere. Bit for bit against the plain version."""
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels.ref import queue_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(17)
    for c in QUEUE_TIE_CAPS:
        ready = torch.randint(0, QUEUE_N // 2, (QUEUE_TIE_R, QUEUE_N),
                              generator=gen, device="cuda")
        ready = ready.sort(dim=1).values.float()
        service = torch.randint(0, 4, (QUEUE_TIE_R, QUEUE_N), generator=gen,
                                device="cuda").float() * (1 + c // 8)
        st, fi = queue_scan(ready, service, capacity=c)
        pst, pfi = queue_scan_ref(ready, service, capacity=c)
        if not (same_bits(st, pst) and same_bits(fi, pfi)
                and bool(torch.isfinite(fi).all())):
            raise AssertionError(f"queue_scan differs from its plain version "
                                 f"on the tie-heavy sweep at capacity {c}")
        log(f"[12] tie-heavy sweep, {QUEUE_TIE_R} x {QUEUE_N} jobs at "
            f"capacity {c}, route {qs.kernel_route(c)}: equal to the plain "
            f"version bit for bit ({int((service == 0).sum())} zero services, "
            f"{int((st[:, 1:] == st[:, :-1]).sum())} starts equal to the "
            f"one before)")


def phase_queue_sweep(torch, queue_scan, counts):
    """``ops.queue_scan`` on a capacity sweep, one launch per capacity, then
    each launch's inputs held bit for bit against the plain version (and a
    subsample of rows against the f64 oracle) and timed."""
    from repro_torch.core.des import single_station_fifo
    from repro_torch.kernels import ops
    from repro_torch.kernels import queue_scan as qs
    from repro_torch.kernels.ref import queue_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = [(c, *queue_jobs(torch, gen, c)) for c in QUEUE_CAPS]
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    t0 = time.perf_counter()
    outs = [ops.queue_scan(r, s, capacity=c) for c, r, s in cases]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in counts}
    want = {k.__name__: 0 for k in counts}
    want.update(queue_scan=len(QUEUE_CAPS))
    if launched != want:
        raise AssertionError(f"the capacity sweep launched {launched}, not "
                             f"{want}")
    rng = np.random.default_rng(15)
    rows, oracle_err, plain_err = [], 0.0, 0.0
    for (c, r, s), (st, fi) in zip(cases, outs):
        pst, pfi = queue_scan_ref(r, s, capacity=c)
        err = max(float((st - pst).abs().max()), float((fi - pfi).abs().max()))
        if not (np.isfinite(err) and same_bits(st, pst)
                and same_bits(fi, pfi)):
            raise AssertionError(f"queue_scan differs from its plain version "
                                 f"at capacity {c} (max |diff| {err})")
        plain_err = max(plain_err, err)
        rn, sn, stn, fin = (a.cpu().numpy() for a in (r, s, st, fi))
        for i in rng.choice(QUEUE_R, QUEUE_ORACLE_ROWS, replace=False):
            ost, ofi = single_station_fifo(rn[i], sn[i], c)
            e = max(float(np.abs(stn[i] - ost).max()),
                    float(np.abs(fin[i] - ofi).max()))
            if not e <= QUEUE_ORACLE_ATOL:
                raise AssertionError(f"queue_scan row {i} at capacity {c} "
                                     f"differs from the f64 oracle by {e}")
            oracle_err = max(oracle_err, e)
        wait = float((st - r).mean())
        bytes_ms, ops_ms = queue_bound(QUEUE_R, QUEUE_N, c)
        rows.append(dict(
            c=c, wait=wait, route=qs.kernel_route(c),
            ms=cuda_ms(lambda: queue_scan(r, s, capacity=c), iters=10,
                       warmup=2),
            plain_ms=cuda_ms(lambda: queue_scan_ref(r, s, capacity=c),
                             iters=2, warmup=1),
            bytes_ms=bytes_ms, ops_ms=ops_ms))
    for row in rows:
        bound = max(row["bytes_ms"], row["ops_ms"])
        log(f"[12] capacity {row['c']}, route (S, G) = {row['route']}: kernel "
            f"{row['ms']:.6f} ms beside its bound {bound:.6f} ms "
            f"({row['ms'] / bound:.2f}x), plain {row['plain_ms']:.6f} ms; "
            f"mean wait {row['wait']:.3f}")
    queue_ties(torch, queue_scan)
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    bound_ms = float(np.mean([max(r["bytes_ms"], r["ops_ms"]) for r in rows]))
    log(f"[12] ops.queue_scan on {QUEUE_R} stations x {QUEUE_N} jobs (loads "
        f"{QUEUE_LOADS[0]}-{QUEUE_LOADS[1]}), capacities {QUEUE_CAPS}: "
        f"{launched['queue_scan']} launches in {wall:.4f} s; equal to the "
        f"plain version bit for bit at every capacity (max |diff| "
        f"{plain_err:.3g}, outputs finite); {QUEUE_ORACLE_ROWS} rows per "
        f"capacity within {oracle_err:.3g} of the f64 oracle (tol "
        f"{QUEUE_ORACLE_ATOL}); kernel mean {mean['ms']:.6f} ms, plain "
        f"{mean['plain_ms']:.6f} ms, no single PyTorch call computes it; "
        f"bound {bound_ms:.6f} ms (bytes {mean['bytes_ms']:.6f}, operations "
        f"{mean['ops_ms']:.6f})")
    return launched["queue_scan"], dict(
        max_abs_err=plain_err, ms=mean["ms"], plain_ms=mean["plain_ms"],
        bound_ms=bound_ms,
        bound_by="bytes" if mean["bytes_ms"] >= mean["ops_ms"]
        else "operations")


# ------------------------------------------------------------ phase 13

def oracle_ensemble():
    """Phase 13's host side (also ``tests/test_torch_cuda.py``'s): ORACLE_R
    one-tenth-day ground-truth workloads with every time rounded up to whole
    seconds (``whole_seconds``) and integer priorities; FIFO / PRIORITY /
    SJF / PRIORITY; every replica fails 35 % of its attempts and retries
    them after the (30, 2, 1800) backoff; replica 1's failing attempts hold
    their slot for half the service time, replica 2 resamples its attempt
    durations (rounded up to whole seconds), and replicas 0 and 3 drain the
    learning cluster to zero for an hour, below its busy count. Returns the
    stacked columns, capacities and policies, and each replica's workload,
    compiled scenario and platform."""
    import dataclasses
    from repro_torch.core import batching, des
    from repro_torch.core import model as M
    from repro_torch.core.workload import (generate_empirical_workload,
                                           whole_seconds)
    from repro_torch.ops.capacity import MaintenanceWindows
    from repro_torch.ops.failures import FailureModel
    from repro_torch.ops.scenario import CompiledScenario, Scenario
    flaky = dict(p_fail_by_type=(0.35,) * 6)
    drain = MaintenanceWindows((ORACLE_DRAIN,))
    scens = [Scenario(capacity=drain if i in ORACLE_DRAINED else None,
                      failures=FailureModel(**flaky, **extra))
             for i, extra in enumerate(({}, {"fail_holds_frac": 0.5},
                                        {"resample_service": True}, {}))]
    pols = np.array([des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF,
                     des.POLICY_PRIORITY], np.int32)
    plat = M.PlatformConfig().with_capacity("learning_cluster",
                                            ORACLE_LEARNING_CAP)
    rng = np.random.default_rng(ORACLE_SEED)
    wls, comps = [], []
    for i in range(ORACLE_R):
        wl = whole_seconds(generate_empirical_workload(
            ORACLE_SEED + i, ORACLE_HORIZON_S), plat.datastore)
        wl = dataclasses.replace(wl, priority=rng.integers(
            0, 4, wl.n).astype(np.float32))
        c = scens[i].compile(wl, plat, ORACLE_HORIZON_S, seed=i,
                             policy=int(pols[i]))
        if c.attempt_service is not None:
            c = CompiledScenario(schedule=c.schedule, attempts=c.attempts,
                                 backoff=c.backoff,
                                 attempt_service=np.ceil(c.attempt_service),
                                 fail_holds_frac=c.fail_holds_frac)
        wls.append(wl)
        comps.append(c)
    plats = [plat] * ORACLE_R
    cols = batching.pad_workloads(wls, plats)
    cols.update(batching.stack_scenarios(
        comps, cols["n_max"], ORACLE_HORIZON_S,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)]))
    caps = np.stack([p.capacities for p in plats]).astype(np.int32)
    return cols, caps, pols, wls, comps, plat


def engine_card_vs_cpu(torch, counts):
    """``simulate_ensemble`` on the oracle ensemble, on the card (kernel
    admission) and with ``device="cpu"`` (the plain admission: the path the
    CPU twins hold bit for bit against the reference's ``des.simulate``).
    Checks first that every replica retried, that the drains pushed free
    slots below zero and that the card run launched the admission kernel
    only; then that every output key is equal bit for bit. Returns the
    number of keys and the largest wave count."""
    from repro_torch.core import batching, vdes
    cols, caps, pols = oracle_ensemble()[:3]
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    card = vdes.simulate_ensemble(**batching.to_tensors(cols, "cuda"),
                                  capacities=caps, policies=pols,
                                  device="cuda")
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the card's engine launched {launched}")
    cpu = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                 capacities=caps, policies=pols,
                                 device="cpu")
    if set(cpu) != set(ORACLE_KEYS) or set(card) != set(ORACLE_KEYS):
        raise AssertionError(f"output keys {sorted(card)} / {sorted(cpu)}")
    att = cpu["attempts"].numpy()
    if not (att.max(axis=(1, 2)) > 1).all():
        raise AssertionError("a replica of the oracle ensemble never retried")
    a_s, a_f = cpu["att_start"].numpy(), cpu["att_finish"].numpy()
    t0_drain, t1_drain = ORACLE_DRAIN[:2]
    for i in ORACLE_DRAINED:
        on = (cols["task_res"][i] == ORACLE_DRAIN[2])[..., None]
        busy = int((on & (a_s[i] < t0_drain) & (a_f[i] > t0_drain)).sum())
        started = int((on & (a_s[i] >= t0_drain) & (a_s[i] < t1_drain)).sum())
        if busy < 1 or started:
            raise AssertionError(f"replica {i}: {busy} attempts ran when the "
                                 f"drain began and {started} started in it")
    for k in ORACLE_KEYS:
        if not same_bits(card[k].cpu(), cpu[k]):
            diff = card[k].cpu() != cpu[k]
            raise AssertionError(f"the card's engine differs from the CPU path "
                                 f"in {k}: {int(diff.sum())} entries")
    return len(ORACLE_KEYS), int(cpu["waves"].max()), launched


def phase_engine_oracle(torch, counts):
    t0 = time.perf_counter()
    n_keys, waves, launched = engine_card_vs_cpu(torch, counts)
    log(f"[13] the oracle ensemble ({ORACLE_R} replicas x "
        f"{ORACLE_HORIZON_S / 86400:g} day, whole-second times; retries with "
        f"backoff, fail_holds_frac 0.5, resampled attempts, drains below the "
        f"busy count) on the card (fused_admission launches "
        f"{launched['fused_admission']}) and through the CPU path in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"engine_card_vs_cpu: identical, {n_keys} keys, {ORACLE_R} replicas, "
        f"{waves} waves")


# ------------------------------------------------------------ phase 14

def fullstack_oracle_ensemble():
    """Phase 14(b)'s host side (also ``tests/test_torch_cuda.py``'s and
    ``tests/test_torch_engine_oracle.py``'s): ORACLE_R one-tenth-day
    ground-truth workloads with whole-second times on the learning cluster
    of FSO_LEARNING_CAP, with every stage on and the reference's parity
    conditions (seasonal amplitude 0, pinned retrain durations,
    ``time_quantum_s = 1``):

    - replicas 0-2: a closed-loop controller (replica 1 with a cooldown),
      a 4-model fleet under fast drift with a trigger, a probe, failures
      with retries and FIFO / PRIORITY / SJF; replicas 0 and 1 a
      reliability timeline (2 zones x 2 racks, one repair crew), replica 2
      none (its ``INF`` padding row);
    - replica FSO_BURST: the controller's and the probe's all-zero padding
      rows, no reliability, no failures, and one model (padded to four)
      whose drift crosses the zero threshold at every tick until its pool
      of three is spent, while the compute cluster is drained
      (``FSO_BURST_DRAIN``), so the three retrains redeploy in one wave
      with gains ``FSO_BURST_GAINS``, whose f32 sum the order of the adds
      changes.

    Returns the stacked columns, capacities and policies, and each
    replica's workload, compiled scenario, fleet, probe and reliability
    (None where off) and the platform."""
    import dataclasses
    from repro_torch.core import batching, des
    from repro_torch.core import model as M
    from repro_torch.core.runtime import FleetSpec, TriggerSpec, fleet_tensor
    from repro_torch.core.workload import (generate_empirical_workload,
                                           whole_seconds)
    from repro_torch.obs.probes import ProbeSpec, compile_probe
    from repro_torch.ops.capacity import MaintenanceWindows, ReactiveController
    from repro_torch.ops.failures import FailureModel
    from repro_torch.ops.scenario import Scenario, compile_fleet
    from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                         RepairSpec, TopologySpec,
                                         compile_reliability)
    H = ORACLE_HORIZON_S
    plat = M.PlatformConfig().with_capacity("learning_cluster",
                                            FSO_LEARNING_CAP)
    pols = np.array([des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF,
                     des.POLICY_FIFO], np.int32)
    rel_spec = ReliabilitySpec(
        topology=TopologySpec(zones=2, racks_per_zone=2),
        outages=DomainOutageModel(zone_mtbf_s=H / 2.0, rack_mtbf_s=H / 4.0,
                                  mttr_s=H / 24.0),
        repair=RepairSpec(crews=1), time_quantum_s=1.0)
    wls, comps, fleets, rels = [], [], [], []
    for i in range(ORACLE_R):
        wl = whole_seconds(generate_empirical_workload(FSO_SEED + i, H),
                           plat.datastore)
        if i == FSO_BURST:
            fl = np.array([[FSO_BURST_PERF0, 1e-6, 0.0, 0.05, 0.0,
                            7 * 86400.0]], np.float32)
            trig = TriggerSpec(drift_threshold=0.0, cooldown_s=0.0,
                               obs_noise=0.0, interval_s=600.0,
                               max_retrains=len(FSO_BURST_GAINS),
                               retrain_durations=(1000.0, 50.0, 20.0))
            scen = Scenario(capacity=MaintenanceWindows((FSO_BURST_DRAIN,)))
        else:
            fl = fleet_tensor(FleetSpec(n_models=4, drift_scale=200.0),
                              FSO_SEED + i)
            fl[:, 4] = 0.0                       # seasonal amplitude 0
            trig = TriggerSpec(drift_threshold=0.03, cooldown_s=1800.0,
                               obs_noise=0.005, interval_s=900.0,
                               retrain_durations=(300.0, 60.0, 30.0))
            scen = Scenario(
                failures=FailureModel(p_fail_by_type=(0.2,) * 6),
                controller=ReactiveController(
                    high_watermark=0.3, step=0.5, max_scale=3.0,
                    interval_s=600.0, cooldown_s=1200.0 if i == 1 else 0.0))
        cf, wl = compile_fleet(FleetSpec(params=fl), trig, wl, plat, H,
                               seed=FSO_SEED + i)
        if i == FSO_BURST:
            cf = dataclasses.replace(
                cf, pool_gain=np.array(FSO_BURST_GAINS, np.float32))
        rel = (compile_reliability(rel_spec, wl, plat, H, seed=FSO_SEED + i)
               if i < 2 else None)
        wls.append(wl)
        fleets.append(cf)
        rels.append(rel)
        comps.append(scen.compile(wl, plat, H, seed=FSO_SEED + i,
                                  policy=int(pols[i]), device="cpu"))
    probe = compile_probe(ProbeSpec(interval_s=900.0), H)
    probes = [probe] * (ORACLE_R - 1) + [None]
    plats = [plat] * ORACLE_R
    cols = batching.pad_workloads(wls, plats)
    n_max = cols["n_max"]
    cols.update(batching.stack_scenarios(
        comps, n_max, H,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)]))
    cols.update(batching.stack_fleets(fleets, n_max))
    cols.update(batching.stack_probes(probes, fleets))
    cols.update(batching.stack_reliability(rels))
    caps = np.stack([p.capacities for p in plats]).astype(np.int32)
    return cols, caps, pols, wls, comps, fleets, probes, rels, plat


def fullstack_card_vs_cpu(torch, counts):
    """``simulate_ensemble`` on the full-stack oracle ensemble, on the card
    (kernel admission) and with ``device="cpu"``. Checks first that the
    card run launched the admission kernel only, that the stages acted
    (controller moves, reliability events, triggers and redeploys, probe
    ticks on the probed replicas and none on the padded one) and that
    FSO_BURST's three redeploys share one wave; then that every output key
    is equal bit for bit. Returns the keys, the largest wave count and the
    launches."""
    from repro_torch.core import batching, des, vdes
    cols, caps, pols = fullstack_oracle_ensemble()[:3]
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    card = vdes.simulate_ensemble(**batching.to_tensors(cols, "cuda"),
                                  capacities=caps, policies=pols,
                                  device="cuda")
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the card's engine launched {launched}")
    cpu = vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                 capacities=caps, policies=pols,
                                 device="cpu")
    if set(cpu) != set(FSO_KEYS) or set(card) != set(FSO_KEYS):
        raise AssertionError(f"output keys {sorted(card)} / {sorted(cpu)}")
    counts_of = fullstack_counts(cpu)
    for i, c in enumerate(counts_of):
        want_probe = 0 if i == FSO_BURST else cols["n_probe_slots"]
        if c["probe_ticks"] != want_probe or c["redeploys"] < 1 or (
                i != FSO_BURST and c["ctrl_actions"] < 1) or (
                i < 2 and c["rel_events"] < 1):
            raise AssertionError(f"replica {i}: the stages did not act: {c}")
    acts = cpu["fleet_act"][FSO_BURST].numpy()[:int(cpu["fleet_n"][FSO_BURST])]
    times = acts[acts[:, 1] == des.FLEET_ACT_REDEPLOY, 0]
    if times.shape[0] != 3 or len(set(times.tolist())) != 1:
        raise AssertionError(f"replica {FSO_BURST} redeployed at {times}")
    for k in FSO_KEYS:
        if not same_bits(card[k].cpu(), cpu[k]):
            diff = card[k].cpu() != cpu[k]
            raise AssertionError(f"the card's engine differs from the CPU path "
                                 f"in {k}: {int(diff.sum())} entries")
    return len(FSO_KEYS), int(cpu["waves"].max()), launched, counts_of


def fullstack_counts(out):
    """Per replica: controller moves, reliability events, triggers,
    redeploys and probe ticks recorded by a full-stack run."""
    rows = []
    for i in range(out["waves"].shape[0]):
        acts = out["fleet_act"][i].cpu().numpy()[:int(out["fleet_n"][i])]
        kind = np.rint(acts[:, 1])
        rows.append(dict(
            ctrl_actions=int(out["ctrl_n"][i]), rel_events=int(out["rel_n"][i]),
            triggers=int((kind == 0).sum()), redeploys=int((kind == 1).sum()),
            probe_ticks=int(out["probe_n"][i])))
    return rows


def fullstack_spec(full: bool):
    """Phase 14(a)'s spec: every stage on (``full``), or none."""
    from repro_torch.core.experiment import ExperimentSpec
    from repro_torch.core.runtime import FleetSpec, TriggerSpec
    from repro_torch.obs.probes import ProbeSpec
    from repro_torch.ops.capacity import ReactiveController
    from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                         RepairSpec, SpotPoolSpec,
                                         TopologySpec)
    H = HORIZON_S
    spec = ExperimentSpec(name="full-stack", horizon_s=H, seed=FS_SEED,
                          n_replicas=N_REPLICAS)
    if not full:
        return spec
    return ExperimentSpec(
        name="full-stack", horizon_s=H, seed=FS_SEED, n_replicas=N_REPLICAS,
        fleet=FleetSpec(n_models=6, drift_scale=60.0),
        trigger=TriggerSpec(interval_s=3600.0, obs_noise=0.005,
                            cooldown_s=4 * 3600.0, drift_threshold=0.06),
        probe=ProbeSpec(interval_s=1800.0),
        reliability=ReliabilitySpec(
            topology=TopologySpec(zones=2, racks_per_zone=4),
            outages=DomainOutageModel(zone_mtbf_s=H / 2.0,
                                      rack_mtbf_s=H / 4.0, mttr_s=H / 24.0),
            repair=RepairSpec(crews=2),
            spot=SpotPoolSpec(frac=0.2, evict_mtbe_s=H / 3.0,
                              reclaim_s=H / 48.0),
            time_quantum_s=1.0),
    ).with_(controller=ReactiveController(high_watermark=0.3, step=0.5,
                                          max_scale=3.0, interval_s=3600.0))


def check_fullstack_invariants(kw, out):
    """Phase 3's invariants on a full-stack run, from the engine's own
    inputs and outputs: no resource running more attempts at once than its
    schedule's largest capacity plus the controller's largest move (outages
    only take capacity away); every pipeline that entered the platform
    (the exogenous ones and the activated retraining pipelines) done,
    unless its current task waits on a resource left with no effective
    capacity at the end (schedule + controller delta + reliability delta
    <= 0: an outage still open at the horizon, whose repair falls after
    it, under a controller that last scaled down, strands its queue, as in
    the reference engines); and start >= ready, finish >= start on every
    task that completed. Returns the pipelines that entered and the
    stranded ones."""
    from repro_torch.core.des import unpack_controller
    host = {k: v.cpu().numpy() for k, v in kw.items() if hasattr(v, "cpu")}
    res_of, n_tasks, arrival, cap_vals, pbase = (
        host[k] for k in ("task_res", "n_tasks", "arrival", "cap_vals",
                          "pool_base"))
    need = np.maximum(host["attempts"], 1) if "attempts" in host \
        else np.ones_like(res_of)
    ctrl = unpack_controller(host["controllers"])
    base = np.rint(ctrl[9]).astype(np.int64)
    move = np.rint(ctrl[8]).astype(np.int64) - base
    o = {k: v.cpu().numpy() for k, v in out.items()}
    entered = stranded = 0
    T = res_of.shape[2]
    for i in range(res_of.shape[0]):
        P = o["pool_arr"].shape[1]
        live_row = np.isfinite(arrival[i]) & (arrival[i] < 1e30)
        live_row[pbase[i]:pbase[i] + P] = ~np.isnan(o["pool_arr"][i])
        entered += int(live_row.sum())
        live = live_row[:, None] & (np.arange(T)[None, :]
                                    < n_tasks[i][:, None])
        complete = live & (o["attempts"][i] >= need[i])
        s, f, r = (o[k][i][complete] for k in ("start", "finish", "ready"))
        if np.isnan(s).any() or not ((s >= r).all() and (f >= s).all()):
            raise AssertionError(f"replica {i}: a completed task never ran, "
                                 "or start < ready, or finish < start")
        cap_end = (cap_vals[i, -1] - base[i]
                   + (np.rint(o["ctrl_act"][i, o["ctrl_n"][i] - 1, 1:])
                      .astype(np.int64) if o["ctrl_n"][i] else base[i])
                   + (np.rint(o["rel_act"][i, o["rel_n"][i] - 1, 1:])
                      .astype(np.int64) if o["rel_n"][i] else 0))
        for row in np.nonzero(live_row & ~o["done"][i])[0]:
            cur = int(np.argmin(complete[row]))   # its first open task
            r_cur = o["ready"][i, row, cur]
            queued = not np.isnan(r_cur) and not (
                o["start"][i, row, cur] >= r_cur)
            if not queued or cap_end[res_of[i, row, cur]] > 0:
                raise AssertionError(
                    f"replica {i}: pipeline {row} is not done and its task "
                    f"{cur} does not wait on a resource left with no "
                    f"capacity (end capacity {cap_end.tolist()})")
            stranded += 1
        for res in range(cap_vals.shape[2]):
            m = live & (res_of[i] == res)
            st = o.get("att_start", o["start"][..., None])[i][m].ravel()
            fi = o.get("att_finish", o["finish"][..., None])[i][m].ravel()
            did = ~np.isnan(st)
            t = np.concatenate([st[did], fi[did]])
            d = np.concatenate([np.ones(did.sum()), -np.ones(did.sum())])
            order = np.lexsort((d, t))          # a finish frees its slot first
            peak = int(np.cumsum(d[order]).max()) if t.size else 0
            cap = int(cap_vals[i, :, res].max()) + max(int(move[i, res]), 0)
            if peak > cap:
                raise AssertionError(f"replica {i} resource {res}: {peak} "
                                     f"attempts ran at once, bound {cap}")
    return entered, stranded


def run_fullstack(torch, fused_admission, params, full):
    """``run_experiment`` of phase 14(a)'s spec on the card, keeping every
    ``KEEP_EVERY``-th admission input as phase 3 does; returns the result,
    the engine call's keywords, outputs and wall, the total wall and the
    kept admission inputs."""
    from repro_torch.core import vdes
    from repro_torch.core.experiment import run_experiment
    calls = []
    ens = Stopwatch(torch, vdes.simulate_ensemble, keep=calls)
    tap = InputTap(fused_admission, KEEP_EVERY)
    vdes.simulate_ensemble, vdes.fused_admission = ens, tap
    try:
        t0 = time.perf_counter()
        res = run_experiment(fullstack_spec(full), params, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        vdes.simulate_ensemble, vdes.fused_admission = ens.fn, fused_admission
    if ens.calls != 1:
        raise AssertionError(f"run_experiment made {ens.calls} "
                             "simulate_ensemble calls")
    kw, out = calls[0]
    return res, kw, out, ens.s, wall, tap.kept


def fullstack_dense_twin(torch, kw, out, per):
    """Re-runs ``FS_DENSE_N`` replicas of the full-stack run, those on which
    the most stages acted, with the plain admission on the card (every
    stage input is per replica and drawn before the loop, so a replica's
    run does not depend on the others'); every output key must be equal
    bit for bit. Returns the replicas and the re-run's wall."""
    from repro_torch.core import vdes
    acted = ("ctrl_actions", "rel_events", "triggers", "redeploys")
    idx = sorted(range(len(per)), key=lambda i: (
        -sum(per[i][k] > 0 for k in acted), -per[i]["redeploys"],
        -per[i]["rel_events"], i))[:FS_DENSE_N]
    sub = {k: v[idx] if torch.is_tensor(v) or isinstance(v, np.ndarray)
           else v for k, v in kw.items()}
    sub["admission_sort"] = "dense"
    t0 = time.perf_counter()
    ref = vdes.simulate_ensemble(**sub)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if set(ref) != set(out):
        raise AssertionError(f"the plain-admission re-run returned "
                             f"{sorted(ref)}, the full-stack run {sorted(out)}")
    for k in ref:
        if not same_bits(out[k][idx], ref[k]):
            raise AssertionError(f"full-stack kernel run != plain-admission "
                                 f"run on replicas {idx}: {k}")
    return idx, len(ref), wall


def phase_fullstack(torch, fused_admission, dense, counts):
    """Phase 14: (a) the full stack at width, timed beside the same replicas
    with no stage on; (b) the full-stack oracle ensemble, card against CPU.
    Returns the full-stack run's admission launches and the kernel's
    record on that run's inputs."""
    t0 = time.perf_counter()
    n_keys, max_waves, launched_b, per_b = fullstack_card_vs_cpu(torch, counts)
    log(f"[14] the full-stack oracle ensemble ({ORACLE_R} replicas x "
        f"{ORACLE_HORIZON_S / 86400:g} day, whole-second times, every stage, "
        f"padding rows on replica {FSO_BURST}, three redeploys of one model "
        f"in one wave) on the card (fused_admission launches "
        f"{launched_b['fused_admission']}) and through the CPU path in "
        f"{time.perf_counter() - t0:.2f} s; per replica " + " ".join(
            f"{c['ctrl_actions']}/{c['rel_events']}/{c['triggers']}/"
            f"{c['redeploys']}/{c['probe_ticks']}" for c in per_b))
    log(f"fullstack_card_vs_cpu: identical, {n_keys} keys, {ORACLE_R} "
        f"replicas, {max_waves} waves")
    from repro_torch.core.fitting import SimulationParams
    params = SimulationParams.load(str(ARTIFACT), device="cuda")
    card = card_line()
    runs = {}
    for full in (True, False):
        for k in counts:
            k.launches = 0
        res, kw, out, ens_wall, wall, kept = run_fullstack(
            torch, fused_admission, params, full)
        launched = {k.__name__: k.launches for k in counts}
        if launched["fused_admission"] <= 0 or any(
                n for name, n in launched.items()
                if name != "fused_admission"):
            raise AssertionError(f"the full-stack path launched {launched}")
        waves = out["waves"].cpu().numpy()
        runs[full] = (res, kw, out, ens_wall, wall, launched, waves, kept)
    res, kw, out, ens_wall, wall, launched, waves, kept = runs[True]
    entered, stranded = check_fullstack_invariants(kw, out)
    n_ticks = int(kw["n_probe_slots"])
    if not (out["probe_n"].cpu().numpy() == n_ticks).all() or bool(
            out["probe_vals"][:, :, 0].isnan().any()):
        raise AssertionError("the probe ticks do not cover the grid")
    per = fullstack_counts(out)
    for key in ("ctrl_actions", "rel_events", "triggers", "redeploys"):
        if sum(c[key] for c in per) < 1:
            raise AssertionError(f"the ensemble recorded no {key}")
    log(f"[14] full stack (controller, fleet {res.experiment.fleet.name}, "
        f"trigger {res.experiment.trigger.name}, probe every "
        f"{res.experiment.probe.interval_s:g} s, reliability "
        f"{res.experiment.reliability.name}), {N_REPLICAS} replicas x 1 day: "
        f"invariants hold ({stranded} of {entered} pipelines stranded behind "
        f"a resource left with no capacity at the end), every replica's probe "
        f"ran its {n_ticks} ticks")
    log("[14] per replica (controller moves / reliability events / triggers "
        "/ redeploys): " + " ".join(
            f"{c['ctrl_actions']}/{c['rel_events']}/{c['triggers']}/"
            f"{c['redeploys']}" for c in per))
    idx, n_dense_keys, dense_wall = fullstack_dense_twin(torch, kw, out, per)
    log(f"[14] replicas {idx} re-run with the plain admission on the card "
        f"({dense_wall:.3f} s): all {n_dense_keys} output keys bit-identical")
    base = runs[False]
    n_exo = int(sum(w for w in (np.isfinite(base[1]["arrival"].cpu().numpy())
                                & (base[1]["arrival"].cpu().numpy() < 1e30)
                                ).sum(1)))
    for name, (r, _, o, ew, w, l, wv, _), n in (("every stage on", runs[True],
                                               entered),
                                              ("no stage on", base, n_exo)):
        log(f"[14] {name}: run_experiment wall {w:.3f} s, simulate_ensemble "
            f"{ew:.3f} s, waves max {int(wv.max())} (min {int(wv.min())}), "
            f"{wv.max() / ew:.1f} waves/s, {n} pipelines, {n / ew:.1f} "
            f"pipelines/s, fused_admission launches "
            f"{l['fused_admission']} ({card})")
    log(f"[14] the stages' cost: {1e3 * ens_wall / waves.max():.4f} ms per "
        f"wave on, {1e3 * base[3] / base[6].max():.4f} ms per wave off")
    rec = time_admission(torch, fused_admission, dense, kept, phase="14",
                         where="the full-stack run")
    n = launched["fused_admission"]
    log(f"[14] fused_admission: {n} launches x {rec['ms']:.6f} ms = "
        f"{100 * n * rec['ms'] / (ens_wall * 1e3):.2f} % of the full-stack "
        f"simulate_ensemble's wall "
        f"({100 * n * rec['device_ms'] / (ens_wall * 1e3):.2f} % on the "
        "device alone)")
    return n, rec


# ------------------------------------------------------------ phase 15

class PinnedSource:
    """A pinned workload served as arrival-ordered blocks of ``block``
    rows (a ``TraceSource``)."""

    def __init__(self, wl, block=STREAM_BLOCK, name="pinned"):
        self.wl, self.block, self.name = wl, block, name

    def blocks(self):
        import dataclasses
        from repro_torch.core import model as M
        for lo in range(0, self.wl.n, self.block):
            yield M.Workload(**{
                f.name: (v[lo:lo + self.block] if isinstance(
                    v := getattr(self.wl, f.name), np.ndarray) else v)
                for f in dataclasses.fields(M.Workload)})


def compacted_vs_uncompacted(torch, counts, cols, caps, pols, want=None):
    """``simulate_ensemble_compacted`` on the card against the one call
    (``want``, or run here), every output key bit for bit; checks that only
    the admission kernel launched. Returns the output, the log, the wall,
    the launches and the number of keys."""
    from repro_torch.core import batching, compaction, vdes
    t = batching.to_tensors(cols, "cuda")
    if want is None:
        want = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                      device="cuda")
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    clog = compaction.CompactionLog()
    t0 = time.perf_counter()
    out = compaction.simulate_ensemble_compacted(
        **t, capacities=caps, policies=pols, log=clog, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the compacted run launched {launched}")
    if set(out) != set(want):
        raise AssertionError(f"compacted keys {sorted(out)}, one call's "
                             f"{sorted(want)}")
    for k in want:
        if not same_bits(out[k], want[k]):
            raise AssertionError(f"the compacted run differs from the one "
                                 f"call in {k}: "
                                 f"{int((out[k] != want[k]).sum())} entries")
    return out, clog, wall, launched["fused_admission"], len(want)


def phase_compaction(torch, fused_admission, dense, counts, inputs, ens,
                     main_wall):
    """15(a): phase 3's ensemble through the compaction driver on the card,
    equal to phase 3's outputs bit for bit; the kernel held against its
    plain version and timed on every ``KEEP_EVERY``-th admission input of
    the run (the compacted widths)."""
    from repro_torch.core import vdes
    plats, wls, comps, pols, cols, caps = inputs
    tap = InputTap(fused_admission, KEEP_EVERY)
    vdes.fused_admission = tap
    try:
        out, clog, wall, launches, n_keys = compacted_vs_uncompacted(
            torch, counts, cols, caps, pols, want=ens)
    finally:
        vdes.fused_admission = fused_admission
    waves = int(out["waves"].max())
    n_pipes = sum(w.n for w in wls)
    widths = [w for _, w in clog.shapes[1:]]
    card = card_line()
    log(
        f"[15] (a) compacted wave loop: all {n_keys} output keys equal to "
        f"phase 3's bit for bit")
    log(
        f"[15] (a) compacted: wall {wall:.3f} s, {waves / wall:.1f} waves/s, "
        f"{n_pipes / wall:.1f} pipelines/s; phase 3 in this call "
        f"{main_wall:.3f} s, {waves / main_wall:.1f} waves/s, "
        f"{n_pipes / main_wall:.1f} pipelines/s ({card})")
    log(
        f"[15] (a) n_segments {clog.n_segments}, n_compactions "
        f"{clog.n_compactions}, distinct_shapes {clog.distinct_shapes}, "
        f"working width mean {np.mean(widths):.1f} largest {max(widths)} of "
        f"{cols['n_max']}, replicas mean "
        f"{np.mean([r for r, _ in clog.shapes[1:]]):.1f}, live rows largest "
        f"{max(clog.live_rows)}; fused_admission launches {launches}")
    rec = time_admission(torch, fused_admission, dense, tap.kept, phase="15",
                         where="the compacted run")
    return launches, rec, wall


def stream_kwargs(horizon_s):
    """Phase 15(b)'s scenario: phase 14(a)'s stages without reliability
    (which streaming refuses), plus failures with retries."""
    from repro_torch.core.runtime import FleetSpec, TriggerSpec
    from repro_torch.obs.probes import ProbeSpec
    from repro_torch.ops.capacity import ReactiveController
    from repro_torch.ops.failures import FailureModel
    from repro_torch.ops.scenario import Scenario
    return dict(
        scenario=Scenario(name="stream", failures=FailureModel(),
                          controller=ReactiveController(
                              high_watermark=0.3, step=0.5, max_scale=3.0,
                              interval_s=3600.0)),
        fleet=FleetSpec(n_models=6, drift_scale=60.0),
        trigger=TriggerSpec(interval_s=3600.0, obs_noise=0.005,
                            cooldown_s=4 * 3600.0, drift_threshold=0.06),
        probe=ProbeSpec(interval_s=1800.0), horizon_s=horizon_s,
        window_s=STREAM_WINDOW_S, seed=FS_SEED)


def same_stream(a, b):
    """Two ``StreamResult``s equal bit for bit: records, waves, windows and
    the controller, fleet and probe timelines where the run has them.
    Returns the fields compared."""
    import dataclasses
    pairs = [(f"records.{f.name}", getattr(a.records, f.name),
              getattr(b.records, f.name))
             for f in dataclasses.fields(a.records)]
    pairs += [(k, getattr(a, k), getattr(b, k))
              for k in ("ctrl_times", "ctrl_caps", "probe_vals")]
    pairs += [(f"fleet.{k}", v, (b.fleet_cols or {}).get(k))
              for k, v in (a.fleet_cols or {}).items()]
    for name, x, y in pairs:
        if (x is None) != (y is None) or (x is not None and not np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f")):
            raise AssertionError(f"the streams differ in {name}")
    if (a.waves, a.n_windows) != (b.waves, b.n_windows):
        raise AssertionError(f"waves/windows {a.waves}/{a.n_windows} vs "
                             f"{b.waves}/{b.n_windows}")
    return sum(x is not None for _, x, _ in pairs)


def phase_stream(torch, fused_admission, dense, counts):
    """15(b): a synthesized day streamed on the card with the full stack
    but reliability, against the one-shot run of the same stream
    (``parity_drift`` 0.0, the waves and every timeline equal); the first
    6 h with ``overlap`` on and off, bit-identical; the kernel held and
    timed on the stream's kept admission inputs."""
    from repro_torch import stream
    from repro_torch.core import vdes
    from repro_torch.core.fitting import SimulationParams
    params = SimulationParams.load(str(ARTIFACT), device="cuda")

    def source(until):
        return stream.SyntheticSource(params, seed=FS_SEED,
                                      block_size=STREAM_BLOCK, until_s=until,
                                      device="cuda")

    kw = stream_kwargs(HORIZON_S)
    tap = InputTap(fused_admission, KEEP_EVERY)
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    vdes.fused_admission = tap
    try:
        t0 = time.perf_counter()
        sr = stream.stream_simulate(source(HORIZON_S), params=params,
                                    device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        vdes.fused_admission = fused_admission
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the streamed run launched {launched}")
    t0 = time.perf_counter()
    ref = stream.oneshot_reference(
        source(HORIZON_S), params=params, device="cuda",
        **{k: v for k, v in kw.items() if k != "window_s"})
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    drift = stream.parity_drift(sr, ref)
    if drift != 0.0:
        raise AssertionError(f"stream parity_drift {drift}")
    if sr.waves != int(ref["trace"].waves):
        raise AssertionError(f"stream waves {sr.waves}, one-shot "
                             f"{int(ref['trace'].waves)}")
    for key in ("ctrl_times", "ctrl_caps", "probe_vals"):
        if not np.array_equal(getattr(sr, key), ref[key], equal_nan=True):
            raise AssertionError(f"stream {key} != one-shot")
    for key, v in sr.fleet_cols.items():
        if not np.array_equal(v, ref["fleet_cols"][key], equal_nan=True):
            raise AssertionError(f"stream fleet {key} != one-shot")
    kinds = sr.fleet_cols["fleet_kind"]
    acted = dict(ctrl=len(sr.ctrl_times), retried=int(
        (sr.records.attempts > 1).sum()), fleet_ticks=int(
        (~np.isnan(sr.fleet_cols["fleet_perf"][:, 0])).sum()),
        probe_ticks=int((~np.isnan(sr.probe_vals[:, 0])).sum()))
    if min(acted.values()) < 1:
        raise AssertionError(f"a stage of the stream never acted: {acted}")
    acted.update(triggers=int((kinds == 0).sum()),
                 redeploys=int((kinds == 1).sum()))
    card = card_line()
    n_rows = sr.n_pipelines + len(sr.fleet_cols["pool_arr"])
    log(f"[15] (b) streamed day: parity_drift 0.0 against the one-shot run, "
        f"{sr.waves} waves both, controller/fleet/probe timelines equal; "
        f"stages acted {acted}")
    log(f"[15] (b) streamed wall {wall:.3f} s ({sr.waves / wall:.1f} waves/s,"
        f" {sr.n_pipelines / wall:.1f} pipelines/s), one-shot "
        f"{ref_wall:.3f} s ({sr.waves / ref_wall:.1f} waves/s, "
        f"{sr.n_pipelines / ref_wall:.1f} pipelines/s); {sr.n_windows} "
        f"windows, {sr.n_blocks} blocks, ingest {sr.ingest_s:.3f} s; working "
        f"rows at most {sr.peak_rows} of the stream's {n_rows} "
        f"({sr.n_pipelines} pipelines + the retraining pool); "
        f"fused_admission launches {launched['fused_admission']} ({card})")

    kw6 = stream_kwargs(STREAM_TWIN_S)
    t0 = time.perf_counter()
    on = stream.stream_simulate(source(STREAM_TWIN_S), params=params,
                                device="cuda", overlap=True, **kw6)
    off = stream.stream_simulate(source(STREAM_TWIN_S), params=params,
                                 device="cuda", overlap=False, **kw6)
    n = same_stream(on, off)
    log(f"[15] (b) the first {STREAM_TWIN_S / 3600:g} h with overlap on and "
        f"off: bit-identical on {n} fields ({on.n_windows} windows, "
        f"{on.waves} waves; walls {on.wall_s:.3f} / {off.wall_s:.3f} s; "
        f"{time.perf_counter() - t0:.2f} s both)")
    rec = time_admission(torch, fused_admission, dense, tap.kept, phase="15",
                         where="the streamed run")
    return launched["fused_admission"], rec, wall


def stream_card_vs_cpu(torch, counts):
    """15(c) (also ``tests/test_torch_cuda.py``'s): phase 13's replica 0
    (whole-second times, retries, a drain below the busy count) streamed
    from a pinned source in 8 windows on the card and with
    ``device="cpu"``, records and timelines equal bit for bit; and the
    card's stream against its one-shot run, drift 0.0. Returns the fields
    compared, the waves and the launches."""
    from repro_torch import stream
    cols, caps, pols, wls, comps, plat = oracle_ensemble()
    kw = dict(scenario=comps[0], policy=int(pols[0]),
              horizon_s=ORACLE_HORIZON_S, window_s=ORACLE_HORIZON_S / 8,
              min_rows=64)
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    card = stream.stream_simulate(PinnedSource(wls[0]), plat,
                                  device="cuda", **kw)
    torch.cuda.synchronize()
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the card's stream launched {launched}")
    cpu = stream.stream_simulate(PinnedSource(wls[0]), plat, device="cpu",
                                 **kw)
    n = same_stream(card, cpu)
    if card.n_windows < 2:
        raise AssertionError(f"{card.n_windows} windows")
    if not (card.records.attempts > 1).any():
        raise AssertionError("the pinned stream never retried")
    one = stream.oneshot_reference(
        PinnedSource(wls[0]), plat, device="cuda",
        **{k: v for k, v in kw.items() if k not in ("window_s", "min_rows")})
    if stream.parity_drift(card, one) != 0.0:
        raise AssertionError("the card's stream differs from its one-shot "
                             "run")
    return n, card.waves, launched


def phase_stream_oracle(torch, counts):
    t0 = time.perf_counter()
    n, waves, launched = stream_card_vs_cpu(torch, counts)
    log(f"[15] (c) phase 13's replica 0 streamed from a pinned source in 8 "
        f"windows on the card (fused_admission launches "
        f"{launched['fused_admission']}) and through the CPU path in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"stream_card_vs_cpu: identical, {n} fields, {waves} waves")


# ------------------------------------------------------------ phase 16

def same_tree_bits(torch, a, b) -> bool:
    """Two nested-dict trees of tensors equal bit for bit, leaf by leaf."""
    from repro_torch.models.common import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                x.element_size()]
            x, y = x.view(bits), y.view(bits)
        if not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def train_stats(cfg, losses, secs, batch, seq, peak):
    """The training metrics of one run: warm step time (the median over
    the steps after the first, which holds the allocator's warm-up),
    tokens/s, model FLOP/s from 6 N tokens and peak memory. Checks that
    every loss is finite and the last below the first."""
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: losses {losses}")
    n = cfg.active_param_count()
    warm = float(np.median(secs[1:]))
    return dict(params=n, warm_step_s=warm, tokens_per_s=batch * seq / warm,
                model_flops_s=6.0 * n * batch * seq / warm,
                peak_gib=peak / 2 ** 30, first_step_s=secs[0],
                losses=losses)


def log_train(tag, arch, batch, seq, st, card):
    log(f"[16] {tag} {arch}: {st['params'] / 1e9:.4f} B params, "
        f"batch {batch} x {seq}; losses "
        + " ".join(f"{x:.4f}" for x in st["losses"])
        + f"; first step {st['first_step_s']:.3f} s, warm step "
        f"{st['warm_step_s']:.4f} s, {st['tokens_per_s']:.0f} tokens/s, "
        f"{st['model_flops_s'] / 1e12:.2f} model TFLOP/s (6 N tokens), "
        f"peak memory {st['peak_gib']:.2f} GiB; card: {card}")


def refuses_kernel_under_grad(torch, cfg, params, batch, kernel, plain):
    """``loss_fn`` of ``cfg`` with trainable ``params`` raises the kernel's
    guard (naming the plain route) before any launch."""
    from repro_torch.models.transformer import get_model
    before = kernel.launches
    try:
        get_model(cfg).loss_fn(params, batch)
    except RuntimeError as e:
        if "requires grad" not in str(e) or plain not in str(e):
            raise
    else:
        raise AssertionError(f"{cfg.name}: {kernel.__name__} ran under "
                             "autograd")
    if kernel.launches != before:
        raise AssertionError(f"{kernel.__name__} launched under autograd")


def phase_train_llama(torch, counts, flash_attention, card):
    """16(a): ``run_training`` of llama3.2-1b at full width (bf16
    parameters, f32 moments, remat per block) for ``TRAIN_LLAMA`` steps on
    the card, with its final checkpoint written to a temporary directory;
    no kernel launched; the checkpoint, restored, equal to the launcher's
    in-memory state bit for bit; then the flash route refused under
    autograd."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.train import run_training
    arch, kw = "llama3.2-1b", TRAIN_LLAMA
    cfg = configs.get_config(arch)
    need = cfg.param_count() * (2 + 4 + 4)     # bf16 params, f32 m and v
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        free = shutil.disk_usage(d).free
        if free < 2 * need:
            raise RuntimeError(
                f"16(a) writes a {need / 1e9:.1f} GB checkpoint to {d}, "
                f"which has {free / 1e9:.1f} GB free (needs twice that); "
                "point TMPDIR at a larger disk")
        before = [k.launches for k in counts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run_training(arch, smoke=False, ckpt_dir=d, ckpt_every=0,
                           log_every=1, resume=False, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if [k.launches for k in counts] != before:
            raise AssertionError("training launched a kernel")
        st = train_stats(cfg, [h["loss"] for h in out["history"]],
                         [h["sec"] for h in out["history"]], kw["batch"],
                         kw["seq"], peak)
        mgr = CheckpointManager(d)
        path = mgr.path(kw["steps"])
        st["ckpt_bytes"] = os.path.getsize(path)
        st["save_s"] = out["save_s"]
        t0 = time.perf_counter()
        back = mgr.restore(kw["steps"], out["state"])
        torch.cuda.synchronize()
        st["restore_s"] = time.perf_counter() - t0
        if not same_tree_bits(torch, back, out["state"]):
            raise AssertionError("16(a): the restored checkpoint differs "
                                 "from the in-memory state")
        del back
    log_train("(a)", arch, kw["batch"], kw["seq"], st, card)
    log(f"[16] (a) checkpoint: {st['ckpt_bytes'] / 1e9:.3f} GB, save "
        f"{st['save_s']:.2f} s, restore {st['restore_s']:.2f} s, restored "
        f"== in memory bit for bit; card: {card}")
    batch = synth_batch(DataConfig(cfg.vocab_size, 1, 128), 0, "cuda")
    refuses_kernel_under_grad(
        torch, dataclasses.replace(cfg, attn_impl="flash"),
        out["state"]["params"], batch, flash_attention, 'attn_impl="xla"')
    log("[16] (a) attn_impl=\"flash\" under autograd: refused, no launch")
    return st


def phase_train_hybrid(torch, counts, mamba2_scan, card):
    """16(b): zamba2-1.2b at full width for ``TRAIN_HYBRID`` steps through
    the trainer (the plain ``ssd_chunked`` under autograd), no checkpoint;
    no kernel launched; then ``ssm_impl="mamba_kernel"`` refused under
    autograd."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    arch, kw = "zamba2-1.2b", TRAIN_HYBRID
    cfg = configs.get_config(arch)
    opt_cfg = adamw.AdamWConfig(lr=kw["lr"], total_steps=kw["steps"],
                                warmup_steps=max(kw["steps"] // 20, 5))
    dcfg = DataConfig(cfg.vocab_size, kw["batch"], kw["seq"])
    before = [k.launches for k in counts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_train_state(cfg, opt_cfg, 0, "cuda")
    params, opt = state.params, state.opt_state
    step = trainer.make_train_step(cfg, opt_cfg)
    losses, secs = [], []
    for s in range(kw["steps"]):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, synth_batch(dcfg, s, "cuda"))
        losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if [k.launches for k in counts] != before:
        raise AssertionError("training launched a kernel")
    st = train_stats(cfg, losses, secs, kw["batch"], kw["seq"], peak)
    log_train("(b)", arch, kw["batch"], kw["seq"], st, card)
    batch = synth_batch(DataConfig(cfg.vocab_size, 1, 256), 0, "cuda")
    refuses_kernel_under_grad(
        torch, dataclasses.replace(cfg, ssm_impl="mamba_kernel"), params,
        batch, mamba2_scan, 'ssm_impl="xla"')
    log("[16] (b) ssm_impl=\"mamba_kernel\" under autograd: refused, no "
        "launch")
    return st


def resume_twin(torch, steps, ckpt_every, fault_at=(), injector=None):
    """Smoke llama (f32) on the card for ``steps`` steps with faults
    (``fault_at`` or an ``injector``) against an uninterrupted run, both
    under ``torch.use_deterministic_algorithms(True)`` (restored after):
    each restart must resume from the checkpoint written last before its
    fault, and the final checkpoints and states must be equal bit for bit.
    Returns the two runs' restarts and the faulted run's restored steps."""
    import tempfile
    from repro_torch.launch.train import run_training
    kw = dict(steps=steps, batch=4, seq=32, ckpt_every=ckpt_every,
              log_every=steps)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
            a = run_training("llama3.2-1b", ckpt_dir=os.path.join(d, "a"),
                             fault_at=fault_at, injector=injector, **kw)
            b = run_training("llama3.2-1b", ckpt_dir=os.path.join(d, "b"),
                             **kw)
            za, zb = (dict(np.load(os.path.join(d, x,
                                                f"ckpt_{steps:08d}.npz")))
                      for x in "ab")
    finally:
        torch.use_deterministic_algorithms(prev)
    faults = sorted(fault_at if injector is None else
                    (s for s in injector.fail_at if s < steps))
    want = [f // ckpt_every * ckpt_every for f in faults]
    if a["restored_from"] != want or b["restored_from"]:
        raise AssertionError(f"faults at {faults} resumed from "
                             f"{a['restored_from']}, not {want}")
    if set(za) != set(zb) or any(not np.array_equal(za[k], zb[k])
                                 for k in za):
        raise AssertionError("the resumed run's final checkpoint differs")
    if not same_tree_bits(torch, a["state"], b["state"]):
        raise AssertionError("the resumed run's final state differs")
    return a["restarts"], b["restarts"], a["restored_from"]


def injected_faults():
    """16(d): phase 14(a)'s reliability (``examples/reliability_frontier.
    py``'s, scaled to one day) compiled on the default platform, with a
    ``CheckpointSpec`` whose step stride puts three outage starts inside
    ``INJECT_STEPS`` steps. Returns the injector and its steps."""
    import dataclasses
    from repro_torch.core import model as M
    from repro_torch.reliability import CheckpointSpec, compile_reliability
    rel = fullstack_spec(True).reliability
    downs = sorted({ev.t_down for ev in compile_reliability(
        rel, None, M.PlatformConfig(), HORIZON_S, seed=FS_SEED).events})
    if len(downs) < 4:
        raise AssertionError(f"the scenario has {len(downs)} outages")
    stride = (downs[2] + downs[3]) / 2.0 / INJECT_STEPS
    rel = dataclasses.replace(
        rel, checkpoint=CheckpointSpec(fault_step_stride=stride))
    compiled = compile_reliability(rel, None, M.PlatformConfig(), HORIZON_S,
                                   seed=FS_SEED)
    inj = rel.checkpoint.injector(compiled)
    inside = sorted(s for s in inj.fail_at if s < INJECT_STEPS)
    if not 2 <= len(inside) <= 4:
        raise AssertionError(f"fault steps {sorted(inj.fail_at)}")
    return inj, inside, stride, len(compiled.events)


class f64_compute:
    """Inside: ``Tensor.float()`` leaves an f64 tensor f64, so a model
    whose parameters are f64 computes in f64 where it casts to f32 (the
    norms, the scan, the logits). The witness of 16(e)'s gradients."""

    def __init__(self, torch):
        self.torch, self.cast = torch, torch.Tensor.float

    def __enter__(self):
        cast, f64 = self.cast, self.torch.float64
        self.torch.Tensor.float = (
            lambda t, *a, **k: t if t.dtype == f64 else cast(t, *a, **k))

    def __exit__(self, *exc):
        self.torch.Tensor.float = self.cast


def train_card_vs_cpu(torch, arch):
    """16(e): the smoke config (f32, no TF32) from one CPU init, on the
    card and on the CPU: step 1's gradients within the arch's
    ``TRAIN_GRAD_REL_TOL`` of their global norm, the card's no farther
    from the CPU's f64 gradient than ``TRAIN_GRAD_F64_FACTOR`` times the
    CPU's f32 one is, and ``TRAIN_TWIN_STEPS`` train steps' losses within
    ``TRAIN_LOSS_TOL``. Returns the card-vs-CPU gradients' relative
    error, the card's and the CPU's against f64, and the largest loss
    difference."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = configs.get_smoke_config(arch)
    model = get_model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                total_steps=TRAIN_TWIN_STEPS)
    dcfg = DataConfig(cfg.vocab_size, 8, 64)
    cpu = model.init(0, "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = trainer.trainable(tree_map(lambda p: p.to(dev), cpu))
        g, _, _ = trainer._grad_fn(model, 1)(params, synth_batch(dcfg, 0, dev))
        opt = adamw.init_opt_state(opt_cfg, params)
        step = trainer.make_train_step(cfg, opt_cfg)
        losses = []
        for s in range(TRAIN_TWIN_STEPS):
            params, opt, met = step(params, opt, synth_batch(dcfg, s, dev))
            losses.append(float(met["loss"]))
        runs[dev] = (tree_map(lambda t: t.cpu().double(), g), losses)
    with f64_compute(torch):
        g64, _, _ = trainer._grad_fn(model, 1)(
            trainer.trainable(tree_map(lambda p: p.double(), cpu)),
            synth_batch(dcfg, 0, "cpu"))
    (gc, lc), (gp, lp) = runs["cuda"], runs["cpu"]

    def rel(a, b):
        return float(adamw.global_norm(tree_map(lambda x, y: x - y, a, b))
                     / adamw.global_norm(b))

    errs = rel(gc, gp), rel(gc, g64), rel(gp, g64)
    dloss = max(abs(a - b) for a, b in zip(lc, lp))
    if (not errs[0] < TRAIN_GRAD_REL_TOL[arch]
            or not errs[1] <= TRAIN_GRAD_F64_FACTOR * errs[2]
            or not dloss < TRAIN_LOSS_TOL):
        raise AssertionError(
            f"{arch}: card vs CPU gradients {errs[0]:.3e}, against f64 "
            f"card {errs[1]:.3e} CPU {errs[2]:.3e}, losses {lc} / {lp}")
    return (*errs, dloss)


def feedback_card_vs_cpu(torch, counts):
    """16(e): ``run_feedback_simulation`` of one pinned whole-second day
    (the ground-truth generator, the default platform) with 6 models
    drifting at seasonal amplitude 0 and pinned retrain durations (the
    reference's parity conditions), on the card through the engine
    (``"torch"``: the wave loop, admission by the kernel) and through the
    compaction driver (``"torch-compact"``), and on the CPU through the
    compaction driver (the whole-width CPU loop takes minutes for a day);
    the three results equal bit for bit. Returns the pipelines, triggers,
    the admission launches of the engine's run and the walls."""
    import dataclasses
    from repro_torch.core import metrics, runtime
    from repro_torch.core import model as M
    from repro_torch.core.workload import (generate_empirical_workload,
                                           whole_seconds)
    plat = M.PlatformConfig()
    wl = whole_seconds(generate_empirical_workload(FB_SEED, HORIZON_S),
                       plat.datastore)
    fl = metrics.pack_fleet(runtime.make_model_fleet(
        np.random.default_rng(FB_SEED), 6, drift_scale=60.0))
    fl[:, metrics.FLEET_SEAS_AMP] = 0.0
    kw = dict(window_s=3600.0, workload=wl,
              fleet=runtime.FleetSpec(params=fl),
              trigger=runtime.TriggerSpec(
                  drift_threshold=0.06, cooldown_s=4 * 3600.0,
                  obs_noise=0.005, interval_s=3600.0,
                  retrain_durations=(1800.0, 300.0, 120.0)))
    res, walls, launched = {}, {}, None
    for tag, dev, engine in (("card", "cuda", "torch"),
                             ("card-compact", "cuda", "torch-compact"),
                             ("cpu-compact", "cpu", "torch-compact")):
        for k in counts:
            k.launches = 0
        t0 = time.perf_counter()
        res[tag] = runtime.run_feedback_simulation(
            None, FB_SEED, HORIZON_S, engine=engine, device=dev, **kw)
        walls[tag] = time.perf_counter() - t0
        if tag == "card":
            launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"the feedback run launched {launched}")
    want = res["cpu-compact"]
    if want.n_triggered < 3:
        raise AssertionError(f"{want.n_triggered} triggers")
    for tag in ("card", "card-compact"):
        got = res[tag]
        same = (got.n_exogenous == want.n_exogenous
                and got.n_triggered == want.n_triggered
                and got.retrain_times == want.retrain_times
                and np.array_equal(got.perf_timeline, want.perf_timeline))
        for k, v in dataclasses.asdict(got.records).items():
            w = getattr(want.records, k)
            same = same and (v is None and w is None or
                             np.array_equal(v, w, equal_nan=True))
        if not same:
            raise AssertionError(f"run_feedback_simulation: {tag} differs "
                                 "from the CPU path")
    return wl.n, want.n_triggered, launched["fused_admission"], walls


def phase_training(torch, counts, flash_attention, mamba2_scan):
    """Phase 16: training, checkpoints and crash-restart, the simulator's
    fault schedule driving the launcher, and the card against the CPU."""
    card = card_line()
    t16 = time.perf_counter()
    llama = phase_train_llama(torch, counts, flash_attention, card)
    torch.cuda.empty_cache()
    phase_train_hybrid(torch, counts, mamba2_scan, card)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ra, rb, back = resume_twin(torch, **RESUME)
    if (ra, rb) != (len(RESUME["fault_at"]), 0):
        raise AssertionError(f"16(c) restarts {ra}, {rb}")
    log(f"[16] (c) smoke llama, {RESUME['steps']} steps, checkpoints every "
        f"{RESUME['ckpt_every']}, fault at {list(RESUME['fault_at'])}: "
        f"resumed from step {back}, final "
        f"checkpoint and state == the uninterrupted run's bit for bit "
        f"(deterministic algorithms; {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    inj, inside, stride, n_events = injected_faults()
    ra, rb, back = resume_twin(torch, INJECT_STEPS, RESUME["ckpt_every"],
                               injector=inj)
    if (ra, rb) != (len(inside), 0):
        raise AssertionError(f"16(d) restarts {ra}, {rb}, faults {inside}")
    log(f"[16] (d) {n_events} compiled outages, fault_step_stride "
        f"{stride:.3f} s: faults at steps {inside} of {INJECT_STEPS}, "
        f"{ra} restarts, resumed from steps {back}, final state == the uninterrupted run's bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in ("llama3.2-1b", "zamba2-1.2b"):
            rel, card64, cpu64, dloss = train_card_vs_cpu(torch, arch)
            log(f"[16] (e) smoke {arch} card vs CPU: step 1's gradients "
                f"{rel:.3e} of their norm (< {TRAIN_GRAD_REL_TOL[arch]:g}); "
                f"against the f64 gradient card {card64:.3e}, CPU "
                f"{cpu64:.3e} (card <= {TRAIN_GRAD_F64_FACTOR:g} x CPU); "
                f"{TRAIN_TWIN_STEPS} losses within {dloss:.3e} "
                f"(< {TRAIN_LOSS_TOL:g})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    n, trig, adm, walls = feedback_card_vs_cpu(torch, counts)
    log(f"[16] (e) run_feedback_simulation, one day of {n} pipelines, "
        f"{trig} triggers: card (fused_admission {adm} launches, "
        f"{walls['card']:.1f} s) == card compacted "
        f"({walls['card-compact']:.1f} s) == CPU compacted "
        f"({walls['cpu-compact']:.1f} s), bit for bit "
        f"({time.perf_counter() - t0:.1f} s for (e))")
    log(f"[16] phase 16 in {time.perf_counter() - t16:.1f} s; card: {card}")
    return llama


# ------------------------------------------------------------ phase 17

def report_cells(cells, wall):
    """17(a): the 20 records written, dense ``long_500k`` a skip and every
    other cell counted; prints each cell's FLOPs, bytes, dominant term and
    roofline step on the H100 spec."""
    from repro_torch import configs
    from repro_torch.core import costmodel
    want = {(a, s) for a in configs.ARCHS for s in configs.SHAPES}
    if set(cells) != want:
        raise AssertionError(f"17(a) wrote {sorted(cells)}")
    for (arch, shape), rec in sorted(cells.items()):
        fam = configs.get_config(arch).family
        skip = not configs.cell_supported(fam, shape)[0]
        if rec["status"] != ("skip" if skip else "ok"):
            raise AssertionError(f"17(a) {arch} x {shape}: {rec['status']} "
                                 f"{rec.get('error', '')}")
        if skip:
            log(f"[17] (a) {arch} x {shape}: skip")
            continue
        t = costmodel.roofline_terms(rec)
        log(f"[17] (a) {arch} x {shape}: ok, {rec['flops_per_device']:.4e} "
            f"FLOP, {rec['bytes_accessed_per_device']:.4e} bytes, "
            f"{t['dominant']}-bound, step {t['step_s']:.6g} s on H100 "
            f"(compute {t['compute_s']:.6g} s, memory {t['memory_s']:.6g} "
            f"s), counted in {rec['lower_s']:.1f} s")
    n_ok = sum(r["status"] == "ok" for r in cells.values())
    log(f"[17] (a) {len(cells)} cells ({n_ok} ok, {len(cells) - n_ok} skip) "
        f"counted on the meta device by {DRYRUN_WORKERS} processes in "
        f"{wall:.1f} s")


def catalog_workload(cat, n=CATALOG_JOBS, n_steps=CATALOG_STEPS, seed=1):
    """``examples/accelerator_platform.py``'s platform workload: ``n``
    retraining tasks of the catalog's archs on the learning resource over
    ``CATALOG_DAYS`` days, each duration drawn from its arch's
    distribution, and every time rounded up to a whole second (so the
    engine's f32 and the oracle's f64 agree). Returns the workload's
    columns; ``cat`` maps arch -> Dist (on the CPU)."""
    import torch
    from repro_torch.core import model as M
    archs = sorted(cat)
    rng = np.random.default_rng(seed)
    arrival = np.ceil(np.sort(rng.uniform(0, CATALOG_DAYS * 86400.0, n)))
    pick = rng.integers(0, len(archs), n)
    gen = torch.Generator().manual_seed(seed)
    dur = np.ceil(np.array([float(cat[archs[p]].sample(gen, ()))
                            for p in pick]))
    return dict(
        arrival=arrival, n_tasks=np.ones(n, np.int32),
        task_type=np.full((n, 1), M.TRAIN, np.int32),
        task_res=np.ones((n, 1), np.int32), exec_time=dur[:, None],
        read_bytes=np.zeros((n, 1)), write_bytes=np.zeros((n, 1)),
        framework=pick.astype(np.int32), priority=np.zeros(n, np.float32),
        model_perf=np.zeros(n, np.float32),
        model_size=np.zeros(n, np.float32),
        model_clever=np.zeros(n, np.float32))


def catalog_on_card(torch, counts, root):
    """17(b): the catalog of (a)'s cells, its medians, and its workload
    through ``run_experiment`` on the ``"torch"`` engine at each pod count,
    on the card (the admission kernel launched, no other) and the CPU,
    task times equal bit for bit; prints the queue waits."""
    from repro_torch import configs
    from repro_torch.core import costmodel, experiment
    from repro_torch.core import model as M
    cat = costmodel.accelerator_workload_catalog(n_steps=CATALOG_STEPS,
                                                 root=root)
    if sorted(cat) != sorted(configs.ARCHS):
        raise AssertionError(f"17(b) catalog {sorted(cat)}")
    log("[17] (b) catalog medians (" + f"{CATALOG_STEPS:,} train_4k steps on "
        "H100's roofline): " + ", ".join(
            f"{a} {np.exp(float(d.p0)) / 3600:.2f} h"
            for a, d in sorted(cat.items())))
    wl = M.Workload(**catalog_workload(cat))
    for pods in CATALOG_PODS:
        plat = M.PlatformConfig(resources=(M.ResourceConfig("compute", 1),
                                           M.ResourceConfig("pods", pods)))
        spec = experiment.ExperimentSpec(
            f"catalog-{pods}", platform=plat,
            horizon_s=CATALOG_DAYS * 86400.0, workload=wl)
        torch.cuda.synchronize()
        for k in counts:
            k.launches = 0
        t0 = time.perf_counter()
        card = experiment.run_experiment(spec, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k.__name__: k.launches for k in counts}
        if launched["fused_admission"] <= 0 or any(
                n for name, n in launched.items()
                if name != "fused_admission"):
            raise AssertionError(f"17(b) launched {launched}")
        cpu = experiment.run_experiment(spec, device="cpu")
        for key in ("pipeline", "ready", "start", "finish"):
            if not np.array_equal(getattr(card.records, key),
                                  getattr(cpu.records, key)):
                raise AssertionError(f"17(b) {pods} pods: {key} differs "
                                     "between the card and the CPU")
        wait = card.records.start - card.records.ready
        if not (np.isfinite(card.records.finish).all() and (wait >= 0).all()
                and wait.size == wl.n):
            raise AssertionError(f"17(b) {pods} pods: a task never ran")
        log(f"[17] (b) {pods} pods: mean queue wait {wait.mean() / 3600:.2f} "
            f"h, p95 {np.percentile(wait, 95) / 3600:.2f} h ({wl.n} tasks; "
            f"card {wall:.2f} s, fused_admission "
            f"{launched['fused_admission']} launches) == CPU bit for bit")


def roofline_vs_step(torch, st, card):
    """17(c): 16(a)'s step (llama3.2-1b, ``TRAIN_LLAMA``'s batch x seq,
    remat per block, f32 moments, one microbatch) counted on the meta
    device and priced on the H100 spec, beside 16(a)'s measured warm step.
    A reading, not a gate."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import costmodel
    from repro_torch.launch import dryrun
    cfg = configs.get_config("llama3.2-1b")
    B, S = TRAIN_LLAMA["batch"], TRAIN_LLAMA["seq"]
    step, _ = dryrun.cell_step(cfg, ShapeSpec("16a", "train", S, B))
    c = dryrun.count(step)
    n = cfg.param_count()
    t = costmodel.roofline_terms(dict(
        kind="train", seq_len=S, global_batch=B, n_devices=1, params=n,
        active_params=n, flops_per_device=c["flops"],
        bytes_accessed_per_device=c["bytes"], collectives={}))
    warm = st["warm_step_s"]
    log(f"[17] (c) llama3.2-1b {B} x {S} train step: {c['flops']:.4e} FLOP "
        f"(6 N T {t['model_flops']:.4e}), {c['bytes']:.4e} bytes; roofline "
        f"step {t['step_s']:.4f} s ({t['dominant']}-bound; compute "
        f"{t['compute_s']:.4f} s, memory {t['memory_s']:.4f} s) against "
        f"16(a)'s measured warm step {warm:.4f} s: measured / roofline "
        f"{warm / t['step_s']:.3f}, measured / compute term "
        f"{warm / t['compute_s']:.3f}; card: {card}")
    return t


def serve_dense(torch, counts, flash_attention, card):
    """17(d): ``run_serving`` of each of ``DENSE_SERVE`` at full width in
    bf16 through the flash kernel (one launch per layer of the prefill, no
    other kernel); layer 0's kept q/k/v held against the plain version at
    the bf16 gates (and, at a head dim the kernel takes padded, in f32 at
    1e-5), the three timed. Returns each model's kernel record."""
    import gc
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import attention
    paths = []
    for arch in DENSE_SERVE:
        cfg = configs.get_config(arch)
        tap = CallTap(flash_attention)
        attention.flash_attention = tap
        torch.cuda.synchronize()
        for k in counts:
            k.launches = 0
        try:
            out = serve.run_serving(arch, batch=DENSE_B,
                                    prompt_len=DENSE_PROMPT,
                                    new_tokens=DENSE_NEW, smoke=False,
                                    attn_impl="flash", device="cuda",
                                    seed=DENSE_SEED)
        finally:
            attention.flash_attention = flash_attention
        launched = {k.__name__: k.launches for k in counts}
        if launched["flash_attention"] != cfg.n_layers or any(
                n for name, n in launched.items()
                if name != "flash_attention"):
            raise AssertionError(f"17(d) {arch} launched {launched}, not "
                                 f"flash once per layer ({cfg.n_layers})")
        if not (out["all_in_vocab"] and out["logits_finite"]
                and out["generated_shape"] == [DENSE_B, DENSE_NEW]):
            raise AssertionError(f"17(d) {arch}: {out}")
        log(f"[17] (d) run_serving({arch}, batch={DENSE_B}, prompt_len="
            f"{DENSE_PROMPT}, new_tokens={DENSE_NEW}, bf16, flash, head dim "
            f"{cfg.hd}): {out['n_params']:,} parameters; time to first "
            f"token {out['prefill_s']:.4f} s; decode "
            f"{out['decode_tokens_per_s']:.1f} tokens/s; total "
            f"{out['tokens_per_s']:.1f} tokens/s; flash_attention launches "
            f"{launched['flash_attention']}; card: {card}")
        where = f"on {arch}'s layer-0 prefill inputs"
        rec = time_flash(torch, flash_attention, tap.kept, 17, where)
        if fa.padded_head_dim(cfg.hd) != cfg.hd:
            q, k, v = (t.float() for t in tap.kept)
            err, _ = flash_errs(flash_attention(q, k, v),
                                flash_attention_ref(q, k, v), where + " (f32)")
            if not err <= FLASH_TOL["float32"]:
                raise AssertionError(f"17(d) {arch} f32: {err}")
            log(f"[17] (d) {arch} head dim {cfg.hd} (padded to "
                f"{fa.padded_head_dim(cfg.hd)}) in f32: max |diff| to plain "
                f"{err:.3g} (tol {FLASH_TOL['float32']:g})")
            del q, k, v
        paths.append((f"{arch} prefill", launched["flash_attention"], rec))
        del tap, out
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def profile_fullstack(torch, counts, card):
    """17(e): ``profile_compile_execute`` and ``stage_attribution`` (base,
    + control, + fleet, + probe) on 14(a)'s spec for one replica without
    reliability (the profiler takes no reliability, as the reference's
    does not), its horizon cut to ``PROFILE_HORIZON_S``, ``repeats=1``, on
    the card; only the admission kernel launched."""
    import dataclasses
    from repro_torch.core import engines
    from repro_torch.core.fitting import SimulationParams
    from repro_torch.obs import profile
    params = SimulationParams.load(str(ARTIFACT), device="cuda")
    spec = dataclasses.replace(fullstack_spec(True), reliability=None,
                               n_replicas=1, horizon_s=PROFILE_HORIZON_S)
    wls, comps, fleets, probe, _ = engines._spec_workloads(spec, params,
                                                           "cuda")
    kw = dict(scenario=comps[0], fleet=fleets[0], probe=probe, repeats=1,
              device="cuda")
    for k in counts:
        k.launches = 0
    prof = profile.profile_compile_execute(wls[0], spec.platform, **kw)
    stages = profile.stage_attribution(wls[0], spec.platform, **kw)
    launched = {k.__name__: k.launches for k in counts}
    if launched["fused_admission"] <= 0 or any(
            n for name, n in launched.items() if name != "fused_admission"):
        raise AssertionError(f"17(e) launched {launched}")
    log(f"[17] (e) profile_compile_execute, 14(a)'s spec for one replica "
        f"over {PROFILE_HORIZON_S / 3600:g} h (controller, fleet + trigger, "
        f"probe): cold {prof['cold_s']:.4f} s, execute "
        f"{prof['execute_s']:.4f} s, compile {prof['compile_s']:.4f} s, {prof['waves']} waves, "
        f"{prof['waves_per_s']:.1f} waves/s; card: {card}")
    log("[17] (e) stage_attribution, us per wave: " + ", ".join(
        f"{name} {v['per_wave_us']:.1f} ({v['waves']} waves, "
        f"{v['wall_s']:.4f} s)" for name, v in stages.items()))
    return prof, stages


def phase_cost_model(torch, counts, flash_attention, train_llama):
    """Phase 17 within ``COST_BUDGET_S``: (a) counted in worker processes
    while (c) and (d) run on the card, then (b) and (e). Returns (d)'s
    flash records."""
    import tempfile
    from repro_torch import configs
    from repro_torch.launch import dryrun
    card = card_line()
    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cells_") as root:
        with ThreadPoolExecutor(1) as pool:
            t0 = time.perf_counter()
            cells = pool.submit(dryrun.write_cells, configs.ARCHS,
                                list(configs.SHAPES), root=root,
                                workers=DRYRUN_WORKERS, log=lambda *a: None)
            roofline_vs_step(torch, train_llama, card)
            paths = serve_dense(torch, counts, flash_attention, card)
            cells = cells.result()
            cells_wall = time.perf_counter() - t0
        report_cells(cells, cells_wall)
        catalog_on_card(torch, counts, root)
    profile_fullstack(torch, counts, card)
    wall = time.perf_counter() - t17
    within = "within" if wall <= COST_BUDGET_S else "OVER"
    log(f"[17] phase 17 in {wall:.1f} s ({within} its {COST_BUDGET_S:g} s "
        f"budget); card: {card}")
    return paths


def both_paths(paths, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """One kernel's record over the main paths that launch it: launches
    summed, and each time (``keys``) the launch-weighted mean of the
    paths' (so launches x (ms - bound_ms) is the sum over the paths), with
    each path's own numbers and largest difference under ``paths``."""
    n = sum(launches for _, launches, _ in paths)
    mean = {k: sum(launches * rec[k] for _, launches, rec in paths) / n
            for k in keys}
    return dict(launches=n, **mean, bound_by=paths[0][2]["bound_by"],
                paths=[dict(path=name, launches=launches,
                            max_abs_err=rec["max_abs_err"],
                            **{k: rec[k] for k in keys})
                       for name, launches, rec in paths])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm_logpdf import gmm_logpdf
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.queue_scan import fused_admission, queue_scan
    from repro_torch.kernels.ref import admission_mask_dense

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"[1] card: {card}")
    build_kernels(_build)
    t0 = time.perf_counter()
    inputs = build_ensemble()
    log(f"[1] workloads and scenarios built on the host in "
        f"{time.perf_counter() - t0:.2f} s")

    grid_err = phase_kernels(torch, fused_admission, admission_mask_dense)
    flash_attention.launches = 0
    ens, launches, wall, kept = phase_main_path(torch, fused_admission,
                                                inputs)
    if flash_attention.launches:
        raise AssertionError("the wave loop launched flash_attention")
    rec = time_admission(torch, fused_admission, admission_mask_dense, kept)
    log(f"[3] fused_admission: {launches} launches x {rec['ms']:.6f} ms = "
        f"{100 * launches * rec['ms'] / (wall * 1e3):.2f} % of the "
        f"main path's wall ({100 * launches * rec['device_ms'] / (wall * 1e3):.2f}"
        " % on the device alone)")
    phase_single(torch, fused_admission, inputs, ens)

    flash_grid_err = phase_flash_grid(torch, flash_attention)
    fused_admission.launches = 0
    serve, flash_launches, kept_qkv = phase_serving(torch, flash_attention)
    if fused_admission.launches:
        raise AssertionError("the serving path launched fused_admission")
    phase_serving_twin(torch)
    frec = time_flash(torch, flash_attention, kept_qkv, 6,
                      "on layer 0's inputs of the prefill")
    log(f"[6] flash_attention: {flash_launches} launches x {frec['ms']:.6f} "
        f"ms = {100 * flash_launches * frec['ms'] / (serve['prefill_s'] * 1e3):.2f}"
        " % of the time to first token")

    gmm_grid_err = phase_gmm_grid(torch, gmm_logpdf)
    fit, kept_gmm = phase_fit_path(torch, gmm_logpdf, fused_admission,
                                   flash_attention)
    grec = time_gmm(torch, gmm_logpdf, kept_gmm)
    log(f"[8] gmm_logpdf: {fit['launches']} launches x {grec['ms']:.6f} ms "
        f"= {100 * fit['launches'] * grec['ms'] / (fit['em_s'] * 1e3):.2f} % "
        "of the EM's wall on the card")

    ssd_grid_err = phase_ssd_grid(torch, mamba2_scan)
    counts = (fused_admission, flash_attention, gmm_logpdf, mamba2_scan,
              queue_scan)
    hyb, kept_ssd, kept_hyb_attn = phase_hybrid_forward(torch, mamba2_scan,
                                                        flash_attention,
                                                        counts)
    phase_hybrid_twin(torch, mamba2_scan)
    srec = time_ssd(torch, mamba2_scan, kept_ssd)
    hfrec = time_flash(torch, flash_attention, kept_hyb_attn, 10,
                       "on the first shared-attention inputs of the forward")
    log(f"[10] per forward ({hyb['wall_s']:.4f} s warm): mamba2_scan "
        f"{hyb['ssd_launches']} launches x {srec['ms']:.6f} ms = "
        f"{100 * hyb['ssd_launches'] * srec['ms'] / (hyb['wall_s'] * 1e3):.2f}"
        f" %; flash_attention {hyb['flash_launches']} launches x "
        f"{hfrec['ms']:.6f} ms = "
        f"{100 * hyb['flash_launches'] * hfrec['ms'] / (hyb['wall_s'] * 1e3):.2f}"
        " % of the forward's wall")
    hserve_flash_err = phase_hybrid_serving(torch, flash_attention, counts)
    queue_launches, qrec = phase_queue_sweep(torch, queue_scan, counts)
    phase_engine_oracle(torch, counts)
    fs_launches, fsrec = phase_fullstack(torch, fused_admission,
                                         admission_mask_dense, counts)
    t15 = time.perf_counter()
    ca_launches, carec, _ = phase_compaction(
        torch, fused_admission, admission_mask_dense, counts, inputs, ens,
        wall)
    st_launches, strec, _ = phase_stream(torch, fused_admission,
                                         admission_mask_dense, counts)
    phase_stream_oracle(torch, counts)
    log(f"[15] phase 15 in {time.perf_counter() - t15:.1f} s")
    train_llama = phase_training(torch, counts, flash_attention,
                                 mamba2_scan)
    torch.cuda.empty_cache()
    dense_paths = phase_cost_model(torch, counts, flash_attention,
                                   train_llama)

    kernels = [dict(
        name="fused_admission", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_admission.cu",
        replaces="src/repro/kernels/queue_scan.py:125",
        max_abs_err=max(grid_err, rec["max_abs_err"], fsrec["max_abs_err"],
                        carec["max_abs_err"], strec["max_abs_err"]),
        **both_paths([("wave loop", launches, rec),
                      ("full-stack wave loop", fs_launches, fsrec),
                      ("compacted wave loop", ca_launches, carec),
                      ("streamed wave loop", st_launches, strec)],
                     keys=("ms", "device_ms", "plain_ms", "bound_ms",
                           "library_ms"))), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:25",
        max_abs_err=max(flash_grid_err, frec["max_abs_err"],
                        hfrec["max_abs_err"], hserve_flash_err,
                        *(rec["max_abs_err"] for _, _, rec in dense_paths)),
        **both_paths([("llama prefill", flash_launches, frec),
                      ("hybrid forward", hyb["flash_launches"], hfrec)]
                     + dense_paths)),
        dict(
        name="gmm_logpdf", route="cuda",
        source="src/repro_torch/kernels/csrc/gmm_logpdf.cu",
        replaces="src/repro/kernels/gmm_logpdf.py:21",
        launches=fit["launches"],
        max_abs_err=max(gmm_grid_err, grec["max_abs_err"]),
        ms=grec["ms"], device_ms=grec["device_ms"],
        plain_ms=grec["plain_ms"], bound_ms=grec["bound_ms"],
        bound_by=grec["bound_by"], library_ms=grec["library_ms"]), dict(
        name="mamba2_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba2_scan.cu",
        replaces="src/repro/kernels/mamba2_scan.py:22",
        launches=hyb["ssd_launches"],
        max_abs_err=max(ssd_grid_err, srec["max_abs_err"]),
        ms=srec["ms"], cuda_core_ms=srec["cuda_core_ms"],
        plain_ms=srec["plain_ms"], bound_ms=srec["bound_ms"],
        bound_by=srec["bound_by"], library_ms=None), dict(
        name="queue_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/queue_scan.cu",
        replaces="src/repro/kernels/queue_scan.py:65",
        launches=queue_launches, max_abs_err=qrec["max_abs_err"],
        ms=qrec["ms"], plain_ms=qrec["plain_ms"], bound_ms=qrec["bound_ms"],
        bound_by=qrec["bound_by"], library_ms=None)]
    log("[done] launches x (ms - bound_ms) on each kernel's path: " + ", ".join(
        f"{k['name']} {k['launches'] * (k['ms'] - k['bound_ms']):.3f} ms"
        for k in kernels))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
