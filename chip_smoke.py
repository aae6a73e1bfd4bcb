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
    and loss within ``HYB_TWIN_LOSS_ATOL``; then prefills of
    ``HYB_SHORT_PROMPTS`` tokens under both routes: ``mamba2_scan``
    launched 38 times where the kernel takes the prompt (``kernel_takes``)
    and not at all where it does not (6 and 10 tokens: the chunk is the
    prompt, not a multiple of 4), logits within ``HYB_TWIN_LOGIT_ATOL`` of
    the plain route's. On layer 0's inputs the SSD
    kernel and its plain version are timed with CUDA events, beside the
    bound (no single PyTorch call computes the scan); on the first
    shared-attention inputs the flash kernel and
    ``scaled_dot_product_attention`` are held against the plain version
    and the three timed, beside the bound; each kernel's share of the warm
    forward is printed.
11. Serving zamba2-1.2b at full width (batch 4, 1,024-token prompts, 32 new
    tokens) under the config's ``ssm_impl="xla"``: the prefill runs the
    plain chunked scan from a zero state and the flash kernel 6 times,
    decode the recurrence. Checks: tokens in the
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
    oracle; phase 22 holds it against the port's own heap engine): a
    4-replica one-tenth-day ensemble with whole-second times, mixed
    policies, retries with backoff, a partial-progress replica, a
    resampled-attempt replica and drains below the busy count, through
    ``simulate_ensemble`` on the card and with ``device="cpu"``. Checks:
    every replica retried, then every output key equal bit for bit; prints
    ``engine_card_vs_cpu: identical, ...`` on a line of its own.
14. The full stack: (a) ``run_experiment`` of ``examples/observability.py``'s
    spec (a closed-loop controller, 6 drifting models with a drift
    trigger, a probe every 30 min) with ``examples/reliability_frontier.py``'s
    reliability scaled to one day (2 zones x 4 racks, zone MTBF 12 h,
    rack MTBF 6 h, MTTR 1 h, 2 repair crews, a 20 % spot slice), 32
    replicas of ``FS_HORIZON_S`` (the first 6 h of a day; every stage acts
    on every replica) from the committed ``artifacts/pipesim_params.npz``.
    Checks: one ``simulate_ensemble`` call, the admission kernel and no
    other launched, the stages acted (each replica's controller moves,
    reliability events, triggers and redeploys printed), every replica's
    probe ran its whole grid, and phase 3's invariants (every pipeline
    that entered done, start >= ready, finish >= start, no resource above
    its schedule's largest capacity plus the controller's largest move).
    As in phase 3, every ``SHORT_KEEP_EVERY``-th admission input of the
    run is kept, and on those the kernel is held exactly against its
    plain version and timed beside its bound; ``FS_DENSE_N`` replicas (those on
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
    compacted widths. (b) The first ``STREAM_HORIZON_S`` (6 h) of a
    synthesized day (``SyntheticSource`` from the committed
    ``artifacts/pipesim_params.npz``, blocks of 64, the default platform)
    streamed by ``stream_simulate`` in 2 h windows with phase 14(a)'s
    stages but reliability (which streaming refuses) and failures with
    retries, against ``oneshot_reference`` of the same stream:
    ``parity_drift`` 0.0, the waves and the controller, fleet and probe
    timelines equal; then streamed again with ``overlap`` off,
    bit-identical to the first (``overlap`` on); the kernel held and timed
    on the stream's kept admission inputs. (c) Phase 13's replica 0
    streamed from a pinned source on the card and through the CPU path,
    records equal bit for bit, and the card's stream equal to its
    one-shot run; prints
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
    of ``FB_HORIZON_S`` (12 h) of one pinned whole-second day on the
    card (the engine, then the
    compaction driver) and on the CPU (the compaction driver), equal bit
    for bit, the admission kernel launched on the card's run.

17. The cost-model link, within ``COST_BUDGET_S``: (a) ``launch/dryrun.py``'s
    writer counts the ten archs x the four shapes on the meta
    device (no card; ``DRYRUN_WORKERS`` processes, started at phase 16's
    start where the host has ``DRYRUN_WORKERS + 2`` cores, otherwise at
    phase 17's beside (c) and (d); the core count is printed) into a
    temporary root: every dense, MoE, VLM and audio ``long_500k`` a
    skip, the other 32 cells counted (a train cell's one microbatch taken
    ``TRAIN_MICROBATCHES`` times; the xLSTM's train and prefill cells
    counted at two lengths and depths and extrapolated, ``counted_at``);
    each cell's FLOPs, bytes, dominant term and roofline
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
18. The parity auditor (``repro_torch.analysis``), within
    ``AUDIT_BUDGET_S``: the AST pass; one wave of the smoke spec and of
    14(a)'s full-stack call traced into an FX graph on the card (as run,
    with the admission kernel launched inside the trace, and with the
    plain admission) and on the CPU, each traced wave's operation counts
    by kind printed; the FFMA / DFMA / HFMA2 counts in the SASS of the
    five kernel libraries (``kernel-fma``: ``fused_admission`` and
    ``queue_scan`` must have none; the float kernels' are printed); the
    32-point smoke sweep's recompile checks on both (one call, one
    signature, each row recorded alone runs one program, one library per
    kernel). Fails on any finding neither pragma-suppressed nor in
    ``analysis_baseline_torch.json``, and on card
    findings that differ from the CPU's apart from the card-only rules.
19. The MoE family with MLA, within ``MOE_BUDGET_S``: (a)
    deepseek-v3-671b at full width and 4 layers (3 dense MLA layers, 1
    MoE layer of 256 experts top-8 plus 1 shared; bf16, 15.1 B parameters)
    served by ``ServingEngine`` on the plain attention, then again with
    ``mla_absorbed=True``: TTFT, decode tokens/s, peak GiB after init and
    after generation, and the prefill's MoE ``load_balance_loss`` and
    ``dropped_fraction``; finite logits, tokens in the vocab, no kernel
    launched, and ``attn_impl="flash"`` refused at ``get_model`` with a
    ``ValueError``. (b) llama4-maverick-400b-a17b at full width and 2
    layers (one super block: a dense layer, d_ff 16,384, then a MoE layer
    of 128 experts top-1 plus 1 shared; GQA 40/8; 18.7 B) through the
    flash kernel, which launches once per attention layer of the prefill
    and nothing else; the same prints. (c) The flash kernel on (b)'s
    layer-0 q/k/v (q ``[2, 512, 40, 128]``, kv 8 heads, bf16, causal)
    against its plain version at the bf16 gates, timed beside SDPA and its
    bound. (d) The smoke configs (deepseek with and without
    ``mla_absorbed``, maverick under flash and the plain attention) from
    one CPU init on the card and on the CPU in f32 (no TF32): prefill, 2
    teacher-forced decode steps and ``loss_fn``; each MoE call's ``idx``,
    ``rank`` and ``keep`` equal exactly, logits and losses within
    ``MOE_TWIN_TOL``.
20. The cross-attention families, within ``CROSS_BUDGET_S``: (a)
    llama-3.2-vision-90b at full width (d_model 8,192, GQA 64/8 at head dim
    128, d_ff 28,672, 1,601 patches of width 8,192) and 10 layers (two
    super blocks of 4 self layers and 1 cross layer; bf16, 10.7 B
    parameters), served by ``ServingEngine`` at batch ``CROSS_B``,
    ``CROSS_PROMPT``-token prompts, a random bf16 ``ctx`` and ``CROSS_NEW``
    new tokens through the flash kernel, which launches once per self layer
    of the prefill (8) and nothing else: time to first token, decode
    tokens/s, peak GiB after init and after generation; finite logits,
    tokens in the vocab. (b) seamless-m4t-large-v2 at full width and depth
    (24 encoder + 24 decoder layers, d_model 1,024, 16/16 heads at head dim
    64; 2.0 B) on frames ``[CROSS_B, 4,096, 1,024]``: the same, flash once
    per decoder self layer (24: the encoder's and the cross-attention's
    non-causal attention take the plain path), and the encoder's share of
    the time to first token. (c) The flash kernel on (a)'s and (b)'s
    layer-0 q/k/v (q ``[2, 512, 64, 128]`` over 8 KV heads; ``[2, 512, 16,
    64]`` over 16) against its plain version at the bf16 gates, timed
    beside SDPA and its bound. (d) The smoke configs of both archs from
    one CPU init on the card and on the CPU in f32 (no TF32), under flash
    and the plain attention: prefill of ``CROSS_TWIN_S`` tokens with the
    ``ctx`` or frames, 2 teacher-forced decode steps and ``loss_fn``,
    logits and losses within ``CROSS_TWIN_TOL``.
21. The xLSTM family, the admission rankings and the compression, within
    ``XLSTM_BUDGET_S`` (no kernel on the xLSTM's path: it has no attention
    and no SSD). (a) xlstm-125m at full width and depth (12 layers: 6 super
    blocks of an mLSTM and an sLSTM block, d_model 768, 4 heads of 192;
    bf16, 116.3 M parameters) served by ``ServingEngine`` at batch
    ``XLSTM_B``, ``XLSTM_PROMPT``-token prompts and ``XLSTM_NEW`` new
    tokens: time to first token (the prefill runs the step recurrence over
    every prompt token, as the reference's), decode tokens/s, peak GiB
    after init and after generation; finite logits, tokens in the vocab,
    no kernel launched. (b) It trains at full width through the trainer,
    ``XLSTM_TRAIN``'s 2 steps of 2 x 1,024 tokens (the chunkwise mLSTM's 8
    chunks of 128 with the state handed between them, the sLSTM's 1,024
    steps, remat per super block), the sLSTM's recurrent matrices redrawn
    at 1 / sqrt(hd) (with the reference's 1 / sqrt(H) the backward
    overflows f32 within 256-512 tokens, in both packages): finite losses
    and gradient norms, no kernel launched, the warm step, tokens/s and
    peak GiB. (c) The smoke config from one CPU
    init on the card and on the CPU in f32 (no TF32) at chunk 16 over 64
    tokens: the chunkwise forward's logits and the loss within
    ``XLSTM_TWIN_TOL``, step 1's gradients within it of their norm, and on
    each device a 32-token prefill with 32 teacher-forced decode steps
    within it of the chunkwise forward's logits. (d) The four admission
    modes (``"kernel"``, ``"dense"``, ``"fused"``: one stable sort of a
    packed int64 key; ``"chained"``: three stable argsorts) on ``RANK_R``
    replicas of phase 3's workload over ``RANK_HORIZON_S``: all 8 output
    keys equal bit for bit, the admission kernel launched under
    ``"kernel"`` only, each mode's wall per wave printed (a reading). (e)
    int8 and top-k (``COMP_RATIO``) compression with error feedback for
    ``COMP_ROUNDS`` rounds on random bf16 leaves shaped like one
    full-width llama3.2-1b layer: the int8 codes, ``g_hat``, the error and
    the wire bytes card == CPU bit for bit; ``compressed_psum_pod`` over a
    one-rank NCCL group (an in-process ``HashStore``) == ``group=None``
    bit for bit.
22. The numpy heap engine (``repro_torch.core.des.simulate``, on the
    host), within ``HEAP_BUDGET_S``: (a) on phase 13's oracle ensemble,
    each replica equal to the card's phase 13 run (taken through
    ``batching.batch_trace``) bit for bit on the trace columns
    ``HEAP_ORACLE_KEYS``, and the waves on the replicas without padding
    rows; (b) the same on phase 14(b)'s full-stack oracle ensemble
    (``HEAP_FSO_KEYS``: the controller, reliability, fleet and probe
    timelines too). The CPU tests hold the heap engine bit for bit against
    the reference's ``des.simulate``, so on the card's own machine the
    card's answer is the oracle's; prints ``heap_vs_card: identical, ...``
    on a line of its own. (c) Phase 3's 32 replica days through the heap
    engine once, one after another (every pipeline finished), and
    ``profile_numpy`` of replica 0: its wall, waves and pipelines/s
    beside phase 3's and phase 4's walls from the same call, and replica
    0's ``mean_wait_s`` from both engines (phase 3's times are not whole
    seconds, so there the engines agree only statistically): a reading,
    the serial yardstick of the batched engine.
23. The meshes, within ``MESH_BUDGET_S``, on a one-rank NCCL group (an
    in-process ``HashStore`` rendezvous): (a) llama3.2-1b at full width
    and depth trained by ``run_training`` on the debug mesh ``(1, 1)`` ("data" x
    "model") with FSDP for ``MESH_TRAIN``'s 3 steps of 8 x 1,024 (the
    state DTensors at rest, each parameter gathered, the gradients
    all-reduced over 'data'), its parameters after each step equal bit
    for bit to the meshless step's (run_training's loop without a mesh,
    16(a)'s, from the same seed and batches), both under deterministic
    algorithms; no kernel launched; the warm steps beside 16(a)'s and the
    peak GiB above the baseline. (c) Its final checkpoint restored onto
    the pod mesh ``(1, 1, 1)`` ("pod" x "data" x "model") with
    ``state_shardings`` and onto no mesh, both equal to the in-memory
    state bit for bit. (b) The compressed step (int8, error feedback) on
    the pod mesh for ``MESH_COMP_STEPS`` steps at the same size: finite,
    falling losses and ``wire_bytes_pod`` equal to the leaves' count. (d)
    zamba2's smoke config with ``n_experts=4`` and with MLA from one CPU
    init through the SSD and flash kernels on the card against the CPU
    in f32, within phase 10's twin tolerances, and the MLA prefill
    refused.
24. Serving on a mesh, within ``MESH_SERVE_BUDGET_S``: (a) on a one-rank
    NCCL group, llama3.2-1b at full width in bf16 (phase 6's prompts, 4 x
    1,024, 32 new tokens) through the ``ServingEngine`` on the (1, 1) mesh
    ("data" x "model") and the meshless engine: greedy tokens and the
    logits of the prefill and of each teacher-forced decode step equal bit
    for bit (the size-1 axes split nothing), flash launched once per layer
    in each prefill and no other kernel, each engine's time to first
    token, decode tokens/s and peak GiB above the allocated baseline; the
    flash kernel timed on the mesh prefill's layer-0 inputs; (b) one llama
    layer's decode attention over a ``COMBINE_S``-entry bf16 cache at batch
    ``COMBINE_B``, split into ``COMBINE_BLOCKS`` sequence blocks (the
    production 'model' width) and combined on the card
    (``attention.split_decode``), held against the unsplit decode within
    ``FLASH_ROW_REL_TOL`` of each output row's norm, blocks with no valid
    entry included, both timed; (c) llama's ``decode_32k`` cell counted as
    rank 0 of the 16 x 16 production mesh in a spawned process of the fake
    world (``dryrun.write_cells(..., mesh_name="single")``, while (a) and
    (b) run): its per-device FLOPs, bytes and collective bytes, and its
    cache block, 1/256 of the whole cache, checked.
25. The ten examples of ``examples/torch``, within ``EXAMPLES_BUDGET_S``:
    each example's ``main(device="cuda")`` in this process, one after
    another, at the reference example's constants except the cuts in
    ``EXAMPLE_CUTS`` (printed on each example's line; horizons and steps,
    never a check). ``accelerator_platform`` reads its catalog from 17(a)'s
    cells. Checks: every returned number finite, the fields the reference
    example prints, ``replay_trace``'s windowed replay ``parity_drift``
    0.0 and its exact replay's error 0.0, ``train_lm``'s last loss below
    its first with one restart, and the kernels each example launched
    (``fused_admission`` on the ``"torch"`` sweeps, in the reactive
    autoscaler's planning runs and in the stream, ``gmm_logpdf`` in the
    quickstart's fit; no other). Prints each
    example's wall and its ``fused_admission`` and ``gmm_logpdf``
    launches. These launches stay out of the kernels' JSON record.
26. Tensor and expert parallelism on the card, within ``TP_BUDGET_S``:
    two spawned processes share the card over a ``gloo`` group on CUDA
    tensors (NCCL refuses two ranks on one device), a (1, 2) mesh ("data"
    x "model"). (a) llama3.2-1b at full width served 4 x 1,024 with
    ``TP_NEW`` new tokens (``TP_F32_NEW`` in f32) through the
    ``ServingEngine`` on the mesh: in f32, fed the
    meshless engine's greedy tokens (rank 0 runs it: both ranks hold every
    row), it picks the same token at every step (so its own greedy run
    gives the same tokens) and the logits of its prefill and of each
    decode step are within ``TP_F32_ROW_REL`` of each row's norm of the
    meshless engine's; in bf16 each rank's time to
    first token, decode tokens/s, peak GiB above its baseline and kernel
    launches (flash once per layer per prefill, on 16 query and 4 KV
    heads, nothing else), and flash timed on rank 0's layer-0 inputs. (b)
    One llama3.2-1b training step in f32 at 2 x 1,024 on the mesh: the
    loss within ``TP_LOSS_REL`` of the meshless step's and each rank's
    gradient blocks within ``TP_GRAD_REL`` of their norm, and each leaf
    (or block) within ``TP_LEAF_REL`` of its own. (c) EP: the
    smoke deepseek-v3-671b and llama4-maverick configs in f32 served on
    the mesh and meshless: each MoE call's routing equal exactly, greedy
    tokens equal, logits within ``TP_EP_ROW_REL`` of each row's norm;
    then llama4-maverick at phase 19's cut in bf16 (its blocks drawn
    straight on each rank): time to first token, decode tokens/s and peak
    GiB per rank, all finite. The collectives pass through the host: these
    times are this harness's, not tensor parallelism's on NVLink.
27. Every layer split over 'model', within ``TP_LAYERS_BUDGET_S``: two
    spawned processes of their own (``run_ranks``), as in phase 26, each
    family at full width on the (1, 2) mesh, ``TPL_B`` x ``TPL_PROMPT``
    prompts and ``TPL_NEW`` new tokens (zamba2 ``TPL_HYB_NEW``;
    ``TPL_CASES``): deepseek-v3-671b
    cut to 2 dense MLA layers, plain and absorbed; zamba2-1.2b with the
    SSD and flash kernels (the prefill starts its Mamba blocks from no
    state, so ``mamba2_scan`` runs on each rank's 32 of 64 heads, 38
    launches per prefill, and flash on the shared block's 16 heads, 6);
    seamless-m4t-large-v2 (the encoder, cross-attention and the decoder
    split, its frames cut to 512; flash on the decoder's local heads, 24
    per prefill; the encoder's share of the time to first token);
    xlstm-125m (2 of 4 heads a rank). Each in f32 (``TPL_F32_NEW`` new
    tokens) fed the meshless engine's greedy tokens (zamba2 cut to one
    super block and a tail block; the xLSTM's sLSTM ``r`` rescaled to 1 /
    sqrt(hd), as in 21(b), since at the reference's init the f32 model is
    chaotic, ``tools/xlstm_sensitivity.py``): the same token at
    every step and logits within ``TP_F32_ROW_REL`` of each row's norm;
    then in bf16 (each rank's blocks drawn on the card) the time to first
    token, decode tokens/s, peak GiB above the baseline and the launches,
    every count set to 0 just before the generation and read just after.
    Rank 0 holds ``mamba2_scan`` on its kept local-heads input against
    the plain version and times it beside its bound, and flash likewise
    on zamba2's and seamless' local heads; these paths join the kernels'
    record.

28. FSDP over 'data' and TP over 'model', within ``DP_TP_BUDGET_S``: four
    spawned processes of their own (``run_ranks``) share the card over a
    ``gloo`` group on CUDA tensors, a (2, 2) mesh ("data" x "model"), each
    rank's parameters at rest its blocks over both axes, gathered over
    'data' one block at a time where the model reads them (c10d; the
    gradients reduce-scattered back). (a) llama3.2-1b at full width cut to
    ``DP_TP_LAYERS`` layers, f32, one training step at
    ``DP_TP_TRAIN`` (2 rows per DP rank) against the meshless step (each
    rank in turn runs it on the whole state): the loss within
    ``TP_LOSS_REL``, the grad norm and the pooled gradient blocks within
    ``TP_GRAD_REL``, each leaf's gradient and updated parameter within
    ``TP_LEAF_REL``; the GiB each rank holds allocated at rest after the
    step, at most ``REST_SHARE_MAX`` of the whole state's; each rank's
    peak GiB above its baseline, the DP
    gathers (forward and backward) and reduce-scatters per step and the
    most gathered bytes alive at once. (d) That state saved from the mesh
    (c10d gathers; rank 0 writes on its thread while (b) and (c) run) and
    read back onto the host after them, each rank's blocks bit for bit.
    (b) llama3.2-1b served with its parameters placed by FSDP: f32 at
    ``DP_TP_LAYERS`` layers fed the meshless engine's greedy tokens (as
    26(a)), then bf16 at full width and depth, ``SERVE_B`` x
    ``SERVE_PROMPT`` prompts, ``DP_TP_NEW`` new tokens: time to first
    token, decode tokens/s, peak GiB per rank, the DP gathers, and flash
    once per layer per prefill on each rank's 2 rows and 16 of 32 heads;
    rank 0 holds flash on its layer-0 input against the plain version and
    times it beside its bound and SDPA. (c) The smoke deepseek-v3 and
    llama4-maverick configs served on the mesh, each DP rank routing its
    rows through the c10d ``TokenGroup``: every MoE call's routing, the DP
    ranks' copies joined in row order, equal to the meshless call's;
    tokens equal; logits within ``TP_EP_ROW_REL``. Every gather and
    decode step passes through the host: these times are the harness's.

Each phase's wall is printed on one ``[done]`` line. The last lines are
the kernels' JSON record (a kernel launched on two
main paths, as flash in the llama prefill, the hybrid forward and the
three dense configs', maverick's, the VLM's and seamless' prefills, has
its
launches summed, its times launch-weighted, and each path's numbers under
``paths``), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
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
# the 6 h runs of 14(a) and 15(b) launch about 1,400 times: keep about 24
SHORT_KEEP_EVERY = 60
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
# its prefills of short prompts: the kernel refuses a chunk of 6 or 10 (the
# prompt, shorter than the config's 128), so those take the plain scan
HYB_SHORT_PROMPTS = (6, 8, 10, 16)
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
# fleet + trigger, probe) with 32 replicas, plus
# examples/reliability_frontier.py's reliability scaled to one day
FS_SEED = 3
FS_DENSE_N = 2    # replicas re-run through the plain admission
# 14(a)'s horizon: its wave loop (about 12,000 waves a day at 5-10 ms each,
# host-bound) runs three times, so 6 h keeps the script near half its
# limit; the stages keep their one-day rates
FS_HORIZON_S = 6 * 3600.0
# the full-stack oracle ensemble: whole-second one-tenth days, every stage
FSO_SEED, FSO_LEARNING_CAP = 300, 8
FSO_BURST = 3     # this replica's one model redeploys three times in a wave
FSO_BURST_DRAIN = (1000.0, 3000.0, 0, 0.0)   # compute to zero meanwhile
# three redeploy gains whose f32 sum depends on the order of the adds,
# by one ulp of the model's performance (the reference adds in slot order)
FSO_BURST_GAINS = (0.008586719632148743, 0.018224574625492096,
                   0.004860853310674429)
FSO_BURST_PERF0 = 0.88772327
# phase 15(b): the first 6 h of a synthesized day (as 14(a)'s horizon)
# streamed in 2 h windows, in blocks of 64, so that 6 h hold 4 blocks
STREAM_HORIZON_S = 6 * 3600.0
STREAM_WINDOW_S = 2 * 3600.0
STREAM_BLOCK = 64
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
FB_HORIZON_S = 12 * 3600.0     # 16(e)'s feedback run: 6 triggers
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
# the nine ported archs x the four shapes counted on the meta device by
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
# phase 18, the parity auditor, within its own budget: the AST pass; one
# wave of the smoke spec and of 14(a)'s full-stack call traced on the card
# (as run, the admission kernel launched inside the trace, and with the
# plain admission) and on the CPU; the SASS FMA counts of the five
# libraries (fused_admission and queue_scan must have none); the 32-point
# smoke sweep's recompile checks on both
AUDIT_BUDGET_S = 60.0
# phase 19, the MoE family on the card within its own budget: the two MoE
# archs at full width in bf16, cut in depth only (deepseek-v3-671b to 3
# dense MLA layers + 1 MoE layer, 15.1 B parameters; llama4-maverick to one
# super block, a dense layer then a MoE layer, 18.7 B), random weights from
# MOE_SEED, served by ServingEngine at batch MOE_B, MOE_PROMPT-token prompts
# and MOE_NEW new tokens; then the smoke configs on the card against the
# CPU in f32 (no TF32): prefill of MOE_TWIN_S tokens, 2 teacher-forced
# decode steps and the loss, routing equal exactly, logits and loss within
# MOE_TWIN_TOL (the two devices sum in other orders, ~1e-6 at |logit| ~ 5)
MOE_BUDGET_S = 150.0
MOE_LAYERS = {"deepseek-v3-671b": 4, "llama4-maverick-400b-a17b": 2}
MOE_B, MOE_PROMPT, MOE_NEW, MOE_SEED = 2, 512, 16, 0
MOE_TWIN_S, MOE_TWIN_TOL = 24, 1e-5
# phase 20, the cross-attention families on the card within its own budget:
# llama-3.2-vision-90b at full width cut in depth only (10 layers: two
# super blocks, 10.7 B parameters), seamless-m4t-large-v2 at full width and
# depth, random weights from CROSS_SEED, served by ServingEngine at batch
# CROSS_B, CROSS_PROMPT-token prompts and CROSS_NEW new tokens, with a
# random bf16 ctx (the VLM's 1,601 patches, seamless' 4,096 frames); then
# the smoke configs on the card against the CPU in f32 (no TF32), within
# CROSS_TWIN_TOL (the two devices sum in other orders, ~1e-6 at |logit| ~ 5)
CROSS_BUDGET_S = 120.0
CROSS_LAYERS = {"llama-3.2-vision-90b": 10, "seamless-m4t-large-v2": None}
CROSS_B, CROSS_PROMPT, CROSS_NEW, CROSS_SEED = 2, 512, 16, 0
CROSS_TWIN_S, CROSS_TWIN_TOL = 24, 1e-5
# phase 21, the xLSTM family, the admission rankings and the compression on
# the card within its own budget: xlstm-125m at full width and depth (bf16,
# random weights from XLSTM_SEED) served by ServingEngine at batch
# XLSTM_B, XLSTM_PROMPT-token prompts and XLSTM_NEW new tokens, then trained
# for XLSTM_TRAIN's steps (S > 512: the chunkwise mLSTM runs 8 chunks of
# 128); the smoke config on the card against the CPU in f32 (no TF32)
# within XLSTM_TWIN_TOL (chunk XLSTM_TWIN_CHUNK over XLSTM_TWIN_S tokens);
# the four admission modes on RANK_R replicas of phase 3's workload over
# RANK_HORIZON_S; int8 and top-k compression with error feedback for
# COMP_ROUNDS rounds on leaves shaped like one llama3.2-1b layer
XLSTM_BUDGET_S = 90.0
XLSTM_B, XLSTM_PROMPT, XLSTM_NEW, XLSTM_SEED = 8, 512, 32, 0
XLSTM_TRAIN = dict(steps=2, batch=2, seq=1024, lr=3e-4)
# the reference's init draws the sLSTM's recurrent matrices r [H, hd, hd] at
# 1 / sqrt(H) (its fan-in is the leading axis): its backward overflows f32
# within 256-512 tokens, in the reference as in the port (both checked on
# the CPU), so 21(b) redraws them at 1 / sqrt(hd) by rescaling
XLSTM_TWIN_S, XLSTM_TWIN_CHUNK, XLSTM_TWIN_TOL = 64, 16, 1e-5
RANK_R, RANK_HORIZON_S = 4, 6 * 3600.0
COMP_ROUNDS, COMP_RATIO, COMP_SEED = 3, 0.05, 7
# phase 22, the heap engine on the card's machine, within its own budget:
# the SimTrace columns held bit for bit against the card's phase 13 and
# 14(b) runs (tests/test_torch_engine_oracle.py's), then phase 3's replica
# days once, one after another on the host
HEAP_BUDGET_S = 30.0
HEAP_PROFILE_REPEATS = 3
HEAP_ORACLE_KEYS = ("start", "finish", "ready", "attempts", "completed",
                    "att_start", "att_finish")
HEAP_FSO_KEYS = ("start", "finish", "ready", "attempts", "completed",
                 "arrival", "ctrl_times", "ctrl_caps", "rel_times",
                 "rel_caps", "fleet_perf", "fleet_stale", "fleet_times",
                 "fleet_kind", "fleet_model", "probe_vals")
# the columns compared: every key on each of the 4 replicas, less those a
# replica's heap run does not record (no stage there): replica 2's
# reliability pair, replica 3's controller pair, reliability pair and probe
HEAP_ORACLE_COLUMNS = 4 * len(HEAP_ORACLE_KEYS)            # 28
HEAP_FSO_COLUMNS = 4 * len(HEAP_FSO_KEYS) - 2 - 5          # 57
# phase 23, the meshes on a one-rank NCCL group, within its own budget:
# (a) llama3.2-1b at full width and depth trained through run_training on
# the debug mesh ((1, 1), "data" x "model") with FSDP for MESH_TRAIN's
# steps, each step's parameters held bit for bit against the meshless
# step's (16(a)'s run, under deterministic algorithms), then its final
# checkpoint (c) restored onto the pod mesh ((1, 1, 1), "pod" x "data" x
# "model") and onto no mesh; (b) the compressed step (int8, error
# feedback) on the pod mesh for MESH_COMP_STEPS steps at the same size;
# (d) the hybrid's smoke config with experts and with MLA (MESH_MLA's
# dims: q and k head dim 16 = v's, so flash takes it) through the SSD and
# flash kernels, card against CPU within phase 10's twin tolerances, over
# MESH_HYB_S tokens
MESH_BUDGET_S = 75.0
NCCL_TIMEOUT_S = 300.0    # a one-rank collective that waits longer fails
MESH_TRAIN = dict(steps=3, batch=8, seq=1024, lr=3e-4)
MESH_COMP_STEPS = 2
MESH_HYB_B, MESH_HYB_S, MESH_HYB_SEED = 2, 32, 0
MESH_MLA = dict(use_mla=True, q_rank=32, kv_rank=16, d_nope=8, d_rope=8,
                d_v=16)
# phase 24, serving on a mesh, within its own budget: (a) phase 6's serving
# run through the engine on the (1, 1) mesh and without one, bit for bit;
# (b) one llama layer's decode attention (32 heads, 8 KV heads, head dim
# 64) over a COMBINE_S-entry bf16 cache at batch COMBINE_B in
# COMBINE_BLOCKS blocks, each row's valid entries COMBINE_VALID (the
# second row's last block and all but the third row's first hold none);
# (c) llama's decode_32k cell on the 16 x 16 mesh in the fake world
MESH_SERVE_BUDGET_S = 40.0
COMBINE_B, COMBINE_S, COMBINE_BLOCKS = 8, 32768, 16
COMBINE_HEADS, COMBINE_KV_HEADS, COMBINE_D = 32, 8, 64
COMBINE_VALID = (32768, 30000, 1, 2049, 16384, 32767, 4096, 20000)
# phase 26, tensor and expert parallelism within its own budget: two
# processes sharing the card over gloo on a (1, 2) mesh; llama served at
# phase 6's size and trained one step at TP_TRAIN; the EP twins at
# MOE_TWIN_S tokens, then maverick at phase 19's cut. f32 bounds: the
# ranks sum the partial products in another order (about 1e-7 of a row)
TP_BUDGET_S = 75.0
TP_WORLD = 2
TP_TIMEOUT_S = 240.0      # a rank still running then is killed: the phase fails
TP_TRAIN = dict(batch=2, seq=1024)
# 26(a) generates TP_NEW tokens in bf16 and TP_F32_NEW in f32 (phase 27's
# twins too): every decode step sends some 80 collectives through the
# host, 0.1-0.3 s a step
TP_NEW, TP_F32_NEW = 16, 8
TP_F32_ROW_REL, TP_EP_ROW_REL = 1e-4, 1e-5
TP_LOSS_REL, TP_GRAD_REL, TP_LEAF_REL = 1e-6, 1e-5, 1e-5
TP_EP_ARCHS = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
# phase 27, every layer split over 'model', within its own budget: the two
# processes of phase 26 on a (1, 2) mesh, each family at full width (depth
# cut where TPL_LAYERS says), TPL_B x TPL_PROMPT prompts (the xLSTM's
# TPL_XLSTM_PROMPT: its prefill steps through every token) and TPL_NEW new
# (zamba2: TPL_HYB_NEW; TPL_F32_NEW in f32): in f32 the mesh engine fed the
# meshless engine's greedy tokens must pick them and stay within
# TP_F32_ROW_REL of its logits; in bf16 its numbers and launches. zamba2's
# f32 twin is cut to one super block (one shared-attention application)
# and a tail block. Every decode step sends its collectives through the
# host (zamba2 some 200, 0.44 s a step), so the bf16 runs are short
# phase 28, FSDP over 'data' and TP over 'model' within its own budget:
# four processes sharing the card over gloo on a (2, 2) mesh; llama3.2-1b
# trained one f32 step at DP_TP_LAYERS layers on DP_TP_TRAIN (2 rows per DP
# rank) against the meshless step, its state checkpointed, served with its
# parameters placed by FSDP (bf16 at full depth, DP_TP_NEW new tokens;
# every block is gathered over gloo at each decode step), and the smoke
# MoE configs routed over the DP ranks
DP_TP_BUDGET_S = 75.0
DP_TP_SHAPE = (2, 2)
DP_TP_WORLD = 4
DP_TP_TIMEOUT_S = 300.0
DP_TP_LAYERS = 4
DP_TP_TRAIN = dict(batch=4, seq=1024)
# the most of 28(a)'s whole state (parameters and moments) a rank may hold
# allocated at rest after the step: its quarter and the batch
REST_SHARE_MAX = 0.3
# new tokens of (b) in bf16 and f32 ((c) keeps 26(c)'s MOE_NEW): each
# decode step of (b) gathers every block over gloo through the host (1.4
# GiB a step in bf16, 1.5-3 s)
DP_TP_NEW, DP_TP_F32_NEW = 16, 5
TP_LAYERS_BUDGET_S = 60.0
TP_LAYERS_TIMEOUT_S = 240.0
TPL_B, TPL_PROMPT, TPL_SEED = 2, 512, 0
TPL_NEW, TPL_HYB_NEW, TPL_F32_NEW = 4, 16, 4
TPL_XLSTM_PROMPT = 128
# deepseek's 2 dense layers with no experts: its plan would otherwise end
# in an empty MoE stage, whose init still draws one 14 GB (f32) block
TPL_LAYERS = {"deepseek-v3-671b": dict(n_layers=2, n_dense_layers=2,
                                       n_experts=0),
              # the frames cut from 4,096: the encoder's 24 layers
              # all-reduce [B, n_ctx, 1,024] twice each through the host
              "seamless-m4t-large-v2": dict(n_ctx=512)}
TPL_HYB_TWIN_LAYERS = 7
TPL_CASES = (("mla", "deepseek-v3-671b", {}),
             ("mla_absorbed", "deepseek-v3-671b", {"mla_absorbed": True}),
             ("hybrid", HYB_ARCH, {"ssm_impl": "mamba_kernel",
                                   "attn_impl": "flash"}),
             ("seamless", "seamless-m4t-large-v2", {"attn_impl": "flash"}),
             ("xlstm", "xlstm-125m", {}))
# phase 25: the ten examples of examples/torch, each main() in this
# process on the card; EXAMPLE_CUTS are the keyword arguments that cut an
# example below the reference example's constants (its main()'s defaults):
# at those constants the ten took 154.0 s on an NVIDIA H100 80GB HBM3 at
# 700 W, the model lifecycle's day alone 59.5 s, so the wave-loop horizons
# and the training steps are cut
EXAMPLES_BUDGET_S = 60.0
EXAMPLES = ("quickstart", "capacity_planning", "scheduler_comparison",
            "autoscaling_scenarios", "model_lifecycle", "observability",
            "reliability_frontier", "replay_trace", "accelerator_platform",
            "train_lm")
EXAMPLE_CUTS = {"capacity_planning": {"horizon_s": 3 * 3600.0},
                "autoscaling_scenarios": {"horizon_s": 4 * 3600.0},
                "model_lifecycle": {"horizon_s": 4 * 3600.0},
                "reliability_frontier": {"horizon_s": 3 * 3600.0},
                "replay_trace": {"horizon_s": 1.5 * 3600.0},
                "train_lm": {"steps": 100}}
# the fields each example's return holds (those the reference prints), and
# the examples whose main path launches each kernel (the rest launch none)
EXAMPLE_ROW_FIELDS = {
    "capacity_planning": ("capacity", "util", "mean_wait_s", "p95_wait_s",
                          "ci95"),
    "scheduler_comparison": ("policy", "mean_wait_s", "p95_wait_s",
                             "stale_weighted_wait_s"),
    "autoscaling_scenarios": ("scenario", "p95_wait_s", "deadline_miss_rate",
                              "wait_slo_violation_rate", "total_cost",
                              "util_provisioned"),
    "reliability_frontier": ("spot_frac", "crews", "availability", "cost",
                             "spot_savings", "max_repair_wait_s",
                             "evicted_tasks"),
}
EXAMPLE_ROWS = {"capacity_planning": 5, "scheduler_comparison": 3,
                "autoscaling_scenarios": 5, "reliability_frontier": 12}
EXAMPLE_LAUNCHES = {
    # the reactive autoscaler plans by re-simulating on the device
    "fused_admission": ("capacity_planning", "autoscaling_scenarios",
                        "model_lifecycle", "reliability_frontier",
                        "replay_trace"),
    "gmm_logpdf": ("quickstart",),
}
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


def same_bytes(a, b) -> bool:
    """Equal dtype, shape and bytes (any dtype, either device): -0.0 is not
    0.0 here."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return bool(torch.equal(a.view(-1).view(torch.uint8),
                            b.view(-1).view(torch.uint8)))


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

def build_ensemble(n_replicas=N_REPLICAS, horizon_s=HORIZON_S):
    """The main path's inputs, on the host: ``n_replicas`` workloads of
    ``horizon_s`` (one day) with their compiled scenarios, padded and
    stacked."""
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
    for i in range(n_replicas):
        plat = base.with_capacity("learning_cluster",
                                  LEARNING_CAPS[i % len(LEARNING_CAPS)])
        pol = (des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF)[i % 3]
        wl = generate_empirical_workload(i, horizon_s)
        scen = Scenario(capacity=maint if i % 2 else None,
                        failures=FailureModel(resample_service=i % 4 == 3))
        plats.append(plat)
        wls.append(wl)
        pols.append(pol)
        comps.append(scen.compile(wl, plat, horizon_s, seed=i, policy=pol))
    cols = batching.pad_workloads(wls, plats)
    cols.update(batching.stack_scenarios(
        comps, cols["n_max"], horizon_s,
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

def single_summary(wl, plat, comp, tr):
    """Phase 4's summary of one replica's trace: a schedule, an SLO and
    cost rates."""
    from repro_torch.core import trace
    from repro_torch.ops.accounting import SLOConfig
    return trace.summarize(trace.flatten_trace(tr, wl), plat.capacities,
                           HORIZON_S, schedule=comp.schedule,
                           cost_rates=np.array([0.5, 3.0]), slo=SLOConfig())


def phase_single(torch, fused_admission, inputs, ens):
    """Phase 4; returns its wall and summary."""
    from repro_torch.core import vdes
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
    summ = single_summary(wl, plat, comp, tr)
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
    return wall, summ


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
    loss through the SSD kernel against the plain chunked scan; then the
    prefills of ``HYB_SHORT_PROMPTS`` under both routes."""
    from repro_torch import configs
    from repro_torch.kernels.mamba2_scan import kernel_takes
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
    short = []
    for n in HYB_SHORT_PROMPTS:
        toks = batch["tokens"][:, :n]
        got = {}
        for impl, m in models.items():
            before = mamba2_scan.launches
            with torch.inference_mode():
                got[impl] = m.prefill(params, toks, max_len=n + 1)[0]
            got[impl + "_launches"] = mamba2_scan.launches - before
        c = models["mamba_kernel"].cfg
        takes = kernel_takes(c.cdt, n, c.ssm_head_dim, c.ssm_state,
                             c.ssd_chunk)
        err = float((got["mamba_kernel"][..., :v] - got["xla"][..., :v])
                    .abs().max())
        want = (c.n_layers if takes else 0, 0)
        if (got["mamba_kernel_launches"], got["xla_launches"]) != want \
                or not err <= HYB_TWIN_LOGIT_ATOL:
            raise AssertionError(
                f"f32 prefill of {n} tokens: mamba2_scan launched "
                f"{got['mamba_kernel_launches']} / {got['xla_launches']} "
                f"times, not {want}; logits differ by {err}")
        short.append(f"{n}: {want[0]} launches, max |diff| {err:.3g}")
    log(f"[10] f32 prefills of short prompts under ssm_impl=mamba_kernel "
        f"against xla (the kernel where kernel_takes says so, else the "
        f"plain scan; tol {HYB_TWIN_LOGIT_ATOL}): " + "; ".join(short))
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


def time_ssd(torch, mamba2_scan, kept, tag=10,
             where="on layer 0's inputs of the forward"):
    """On kept bf16 inputs of a path (layer 0's of the forward): the kernel
    (its tensor-core route) and the source's CUDA-core kernel against the
    plain version, then the three timed with CUDA events, and the bound.
    No single PyTorch call computes the SSD scan: no library yardstick."""
    from repro_torch.kernels.ref import mamba2_scan_ref
    x, dt, A, Bm, Cm = kept
    chunk = HYB_CHUNK
    want = mamba2_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
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
    log(f"[{tag}] mamba2_scan {where} (x {list(x.shape)}, B/C {list(Bm.shape)}, {str(x.dtype)[6:]}, chunk "
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
    """zamba2-1.2b served at full width in bf16 under the config's
    ``ssm_impl="xla"``: the prefill runs the plain chunked scan from a zero
    state (as the reference) and the flash kernel in the shared block's 6
    applications; decode runs the recurrence. The
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
        f"{launched['flash_attention']}, mamba2_scan 0 (ssm_impl=xla: the "
        "plain scan); tokens in vocab, logits finite")
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
    number of keys, the largest wave count, the launches and the card's
    outputs."""
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
    return len(ORACLE_KEYS), int(cpu["waves"].max()), launched, card


def phase_engine_oracle(torch, counts):
    """Phase 13; returns the card's outputs, which phase 22 holds against
    the heap engine."""
    t0 = time.perf_counter()
    n_keys, waves, launched, card = engine_card_vs_cpu(torch, counts)
    log(f"[13] the oracle ensemble ({ORACLE_R} replicas x "
        f"{ORACLE_HORIZON_S / 86400:g} day, whole-second times; retries with "
        f"backoff, fail_holds_frac 0.5, resampled attempts, drains below the "
        f"busy count) on the card (fused_admission launches "
        f"{launched['fused_admission']}) and through the CPU path in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"engine_card_vs_cpu: identical, {n_keys} keys, {ORACLE_R} replicas, "
        f"{waves} waves")
    return card


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
    is equal bit for bit. Returns the keys, the largest wave count, the
    launches, the stages' counts and the card's outputs."""
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
    return len(FSO_KEYS), int(cpu["waves"].max()), launched, counts_of, card


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


def fullstack_spec(full: bool, horizon_s: float = FS_HORIZON_S):
    """Phase 14(a)'s spec over ``horizon_s``: every stage on (``full``), or
    none. The stages' rates are scaled to one day whatever the horizon."""
    from repro_torch.core.experiment import ExperimentSpec
    from repro_torch.core.runtime import FleetSpec, TriggerSpec
    from repro_torch.obs.probes import ProbeSpec
    from repro_torch.ops.capacity import ReactiveController
    from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                         RepairSpec, SpotPoolSpec,
                                         TopologySpec)
    H = HORIZON_S
    spec = ExperimentSpec(name="full-stack", horizon_s=horizon_s,
                          seed=FS_SEED, n_replicas=N_REPLICAS)
    if not full:
        return spec
    return ExperimentSpec(
        name="full-stack", horizon_s=horizon_s, seed=FS_SEED,
        n_replicas=N_REPLICAS,
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
    ``SHORT_KEEP_EVERY``-th admission input; returns the result,
    the engine call's keywords, outputs and wall, the total wall and the
    kept admission inputs."""
    from repro_torch.core import vdes
    from repro_torch.core.experiment import run_experiment
    calls = []
    ens = Stopwatch(torch, vdes.simulate_ensemble, keep=calls)
    tap = InputTap(fused_admission, SHORT_KEEP_EVERY)
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
    Returns the full-stack run's admission launches, the kernel's record
    on that run's inputs, the run's ``simulate_ensemble`` keywords and
    (b)'s card outputs, which phase 22 holds against the heap engine."""
    t0 = time.perf_counter()
    n_keys, max_waves, launched_b, per_b, fso_card = fullstack_card_vs_cpu(
        torch, counts)
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
        f"{res.experiment.reliability.name}), {N_REPLICAS} replicas x "
        f"{FS_HORIZON_S / 3600:g} h: "
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
    return n, rec, kw, fso_card


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
    """15(b): ``STREAM_HORIZON_S`` of a synthesized day streamed on the card
    with the full stack but reliability, against the one-shot run of the
    same stream (``parity_drift`` 0.0, the waves and every timeline
    equal), and again with ``overlap`` off, bit-identical to that run
    (``overlap`` on); the kernel held and timed on the stream's kept
    admission inputs."""
    from repro_torch import stream
    from repro_torch.core import vdes
    from repro_torch.core.fitting import SimulationParams
    params = SimulationParams.load(str(ARTIFACT), device="cuda")

    def source(until):
        return stream.SyntheticSource(params, seed=FS_SEED,
                                      block_size=STREAM_BLOCK, until_s=until,
                                      device="cuda")

    kw = stream_kwargs(STREAM_HORIZON_S)
    tap = InputTap(fused_admission, SHORT_KEEP_EVERY)
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    vdes.fused_admission = tap
    try:
        t0 = time.perf_counter()
        sr = stream.stream_simulate(source(STREAM_HORIZON_S), params=params,
                                    device="cuda", overlap=True, **kw)
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
        source(STREAM_HORIZON_S), params=params, device="cuda",
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
    log(f"[15] (b) streamed {STREAM_HORIZON_S / 3600:g} h in "
        f"{STREAM_WINDOW_S / 3600:g} h windows: parity_drift 0.0 against the "
        "one-shot run, "
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

    off = stream.stream_simulate(source(STREAM_HORIZON_S), params=params,
                                 device="cuda", overlap=False, **kw)
    n = same_stream(sr, off)
    log(f"[15] (b) the same stream with overlap off: bit-identical to "
        f"overlap on on {n} fields ({off.n_windows} windows, {off.waves} "
        f"waves; walls on {sr.wall_s:.3f} / off {off.wall_s:.3f} s)")
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


def train_stats(cfg, losses, secs, batch, seq, peak, decreasing=True):
    """The training metrics of one run: warm step time (the median over
    the steps after the first, which holds the allocator's warm-up),
    tokens/s, model FLOP/s from 6 N tokens and peak memory. Checks that
    every loss is finite and (``decreasing``) the last below the first."""
    if not all(np.isfinite(losses)) or (decreasing
                                        and not losses[-1] < losses[0]):
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
    rel = fullstack_spec(True, HORIZON_S).reliability
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


def feedback_run(engine, device):
    """One ``run_feedback_simulation`` of 16(e)'s pinned whole-second day
    (the ground-truth generator, the default platform) with 6 models
    drifting at seasonal amplitude 0 and pinned retrain durations (the
    reference's parity conditions). Returns the pipelines, the result and
    its wall. Module-level, so a spawned process can run it."""
    from repro_torch.core import metrics, runtime
    from repro_torch.core import model as M
    from repro_torch.core.workload import (generate_empirical_workload,
                                           whole_seconds)
    plat = M.PlatformConfig()
    wl = whole_seconds(generate_empirical_workload(FB_SEED, FB_HORIZON_S),
                       plat.datastore)
    fl = metrics.pack_fleet(runtime.make_model_fleet(
        np.random.default_rng(FB_SEED), 6, drift_scale=60.0))
    fl[:, metrics.FLEET_SEAS_AMP] = 0.0
    t0 = time.perf_counter()
    res = runtime.run_feedback_simulation(
        None, FB_SEED, FB_HORIZON_S, engine=engine, device=device,
        window_s=3600.0, workload=wl, fleet=runtime.FleetSpec(params=fl),
        trigger=runtime.TriggerSpec(
            drift_threshold=0.06, cooldown_s=4 * 3600.0, obs_noise=0.005,
            interval_s=3600.0, retrain_durations=(1800.0, 300.0, 120.0)))
    return wl.n, res, time.perf_counter() - t0


def feedback_card_vs_cpu(torch, counts):
    """16(e): :func:`feedback_run` on the card through the engine
    (``"torch"``: the wave loop, admission by the kernel) and through the
    compaction driver (``"torch-compact"``), and on the CPU through the
    compaction driver (the whole-width CPU loop takes minutes for a day)
    in a spawned process while the card runs; the three results equal bit
    for bit. Returns the pipelines, triggers, the admission launches of
    the engine's run and the walls."""
    import dataclasses
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    res, walls, launched = {}, {}, None
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = pool.submit(feedback_run, "torch-compact", "cpu")
        for tag, engine in (("card", "torch"),
                            ("card-compact", "torch-compact")):
            for k in counts:
                k.launches = 0
            n, res[tag], walls[tag] = feedback_run(engine, "cuda")
            if tag == "card":
                launched = {k.__name__: k.launches for k in counts}
        n, res["cpu-compact"], walls["cpu-compact"] = cpu.result()
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
    return n, want.n_triggered, launched["fused_admission"], walls


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
    log(f"[16] (e) run_feedback_simulation, {FB_HORIZON_S / 3600:g} h of "
        f"{n} pipelines, "
        f"{trig} triggers: card (fused_admission {adm} launches, "
        f"{walls['card']:.1f} s) == card compacted "
        f"({walls['card-compact']:.1f} s) == CPU compacted "
        f"({walls['cpu-compact']:.1f} s, in a spawned process beside the "
        f"card's runs), bit for bit "
        f"({time.perf_counter() - t0:.1f} s for (e))")
    log(f"[16] phase 16 in {time.perf_counter() - t16:.1f} s; card: {card}")
    return llama


# ------------------------------------------------------------ phase 17

def report_cells(cells, wall):
    """17(a): the 40 records written, ``long_500k`` a skip for every
    full-attention arch (dense, MoE, VLM and audio: 8) and the other 32
    cells counted, the xLSTM's train and prefill cells by their steps
    (``counted_at``); prints each cell's FLOPs, bytes, dominant term and
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
        by_steps = fam == "ssm" and shape in ("train_4k", "prefill_32k")
        if by_steps != ("counted_at" in rec):
            raise AssertionError(f"17(a) {arch} x {shape}: counted_at "
                                 f"{rec.get('counted_at')}")
        t = costmodel.roofline_terms(rec)
        at = (f", counted at {rec['counted_at']}" if by_steps else "")
        log(f"[17] (a) {arch} x {shape}: ok, {rec['flops_per_device']:.4e} "
            f"FLOP, {rec['bytes_accessed_per_device']:.4e} bytes, "
            f"{t['dominant']}-bound, step {t['step_s']:.6g} s on H100 "
            f"(compute {t['compute_s']:.6g} s, memory {t['memory_s']:.6g} "
            f"s), counted in {rec['lower_s']:.1f} s{at}")
    n_ok = sum(r["status"] == "ok" for r in cells.values())
    if (len(cells), n_ok) != (40, 32):
        raise AssertionError(f"17(a) {len(cells)} cells, {n_ok} counted")
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


class CellCount:
    """17(a)'s count: ``dryrun.write_cells`` of every arch x shape on the
    meta device (no card) by ``DRYRUN_WORKERS`` spawned processes, into a
    temporary root, from a thread that only waits on them. ``result``
    returns the records and the count's own wall; ``close`` waits for the
    count and removes the root."""

    def __init__(self):
        import tempfile
        from repro_torch import configs
        from repro_torch.launch import dryrun
        self._dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cells_")
        self.root = self._dir.name
        self._pool = ThreadPoolExecutor(1)
        self._t0 = time.perf_counter()
        self._future = self._pool.submit(
            self._count, dryrun, configs.ARCHS, list(configs.SHAPES))

    def _count(self, dryrun, archs, shapes):
        cells = dryrun.write_cells(archs, shapes, root=self.root,
                                   workers=DRYRUN_WORKERS,
                                   log=lambda *a: None)
        return cells, time.perf_counter() - self._t0

    def result(self):
        return self._future.result()

    def close(self):
        self._pool.shutdown(wait=True)
        self._dir.cleanup()


def early_cell_count():
    """Starts 17(a)'s count at phase 16 where the host has a core for each
    worker and two to spare (the card's host loop and the CPU twins);
    otherwise phase 17 starts it beside (c) and (d). Returns the count, or
    None."""
    cores = os.cpu_count() or 1
    early = cores >= DRYRUN_WORKERS + 2
    log(f"[16] {cores} CPU cores: 17(a)'s count by {DRYRUN_WORKERS} "
        + ("processes starts now, beside phase 16" if early else
           f"processes waits for phase 17 (fewer than {DRYRUN_WORKERS + 2} "
           "cores)"))
    return CellCount() if early else None


def phase_cost_model(torch, counts, flash_attention, train_llama, cells):
    """Phase 17 within ``COST_BUDGET_S``: (a) counted in worker processes
    (``cells``, started at phase 16 or just before this phase; the caller
    closes it) while (c) and (d) run on the card, then (b) and (e).
    Returns (d)'s flash records."""
    card = card_line()
    t17 = time.perf_counter()
    roofline_vs_step(torch, train_llama, card)
    paths = serve_dense(torch, counts, flash_attention, card)
    records, cells_wall = cells.result()
    report_cells(records, cells_wall)
    catalog_on_card(torch, counts, cells.root)
    profile_fullstack(torch, counts, card)
    wall = time.perf_counter() - t17
    within = "within" if wall <= COST_BUDGET_S else "OVER"
    log(f"[17] phase 17 in {wall:.1f} s ({within} its {COST_BUDGET_S:g} s "
        f"budget); card: {card}")
    return paths


# ------------------------------------------------------------ phase 18

def phase_audit(torch, fs_kw):
    """Phase 18: ``repro_torch.analysis``'s three passes on the card and on
    the CPU. Fails on any finding neither suppressed by a pragma nor in
    ``analysis_baseline_torch.json``, and on a card finding set that
    differs from the CPU's apart from the card-only rules (``kernel-fma``,
    ``kernel-opaque``). The traces launch the admission kernel; phases 3
    and 14 have read their counts before."""
    from repro_torch.analysis import findings as F
    from repro_torch.analysis.__main__ import print_report
    from repro_torch.analysis.ast_audit import audit_tree
    from repro_torch.analysis.harness import (CapturedCall, capture_calls,
                                              smoke_spec)
    from repro_torch.analysis.jaxpr_audit import (CARD_ONLY_RULES,
                                                  finding_keys,
                                                  run_jaxpr_audit)
    from repro_torch.analysis.recompile_audit import run_recompile_audit
    from repro_torch.core.experiment import run_experiment
    root = str(ROOT)
    card = card_line()
    t18 = time.perf_counter()
    ast_fs = audit_tree(root)
    cpu_kw = {k: v.cpu() if torch.is_tensor(v) else v
              for k, v in fs_kw.items()}
    cpu_kw["device"] = "cpu"
    runs = {}
    for dev, kw in (("cuda", fs_kw), ("cpu", cpu_kw)):
        t0 = time.perf_counter()
        with capture_calls() as smoke:
            run_experiment(smoke_spec(engine="torch"), device=dev)
        calls = [("smoke spec", smoke[0]),
                 ("full-stack 14(a)", CapturedCall((), kw))]
        traced = run_jaxpr_audit(
            root, device=dev, calls=calls,
            report=lambda what, value, dev=dev: print_report(
                what, value, prefix=f"[18] {dev}: "))
        t1 = time.perf_counter()
        grid = run_recompile_audit(root, device=dev)
        runs[dev] = F.unique(ast_fs + traced + grid)
        log(f"[18] {dev}: trace pass {t1 - t0:.1f} s, recompile pass "
            f"{time.perf_counter() - t1:.1f} s; {len(traced)} trace and "
            f"{len(grid)} recompile findings")
    active, suppressed = F.split_suppressed(runs["cuda"], root)
    baseline = F.load_baseline(str(ROOT / "analysis_baseline_torch.json"))
    new, accepted, _ = F.reconcile(active, baseline)
    for f in runs["cuda"]:
        state = ("pragma" if f in suppressed else
                 "baselined" if f in accepted else "UNBASELINED")
        log(f"[18] finding ({state}): {f.render()}")
    if new:
        raise AssertionError(f"{len(new)} unbaselined findings on the card: "
                             + "; ".join(f.render() for f in new))
    on_card, on_cpu = finding_keys(runs["cuda"]), finding_keys(runs["cpu"])
    if on_card != on_cpu:
        raise AssertionError(
            f"the card's findings differ from the CPU's: card only "
            f"{sorted(on_card - on_cpu)}, CPU only {sorted(on_cpu - on_card)}")
    card_only = [f for f in runs["cuda"] if f.rule in CARD_ONLY_RULES]
    wall = time.perf_counter() - t18
    within = "within" if wall <= AUDIT_BUDGET_S else "OVER"
    log(f"[18] the parity auditor: {len(runs['cuda'])} findings on the card "
        f"({len(suppressed)} pragma-suppressed, {len(accepted)} baselined, "
        f"0 unbaselined, {len(card_only)} card-only), the same set as the "
        f"CPU's {len(runs['cpu'])}; phase 18 in {wall:.1f} s ({within} its "
        f"{AUDIT_BUDGET_S:g} s budget); card: {card}")


# ------------------------------------------------------------ phase 19

class MoeTap:
    """Stands in for ``models.moe.apply_moe``: runs it and keeps the first
    call's aux values (the prefill's first MoE layer)."""

    def __init__(self, fn):
        self.fn, self.aux = fn, None

    def __call__(self, *args, **kw):
        y, aux = self.fn(*args, **kw)
        if self.aux is None:
            self.aux = {k: v.detach().clone() for k, v in aux.items()}
        return y, aux


def serve_moe(torch, counts, flash_attention, card, arch, impl, variants):
    """19(a)/(b): ``arch`` at full width and ``MOE_LAYERS[arch]`` layers in
    bf16 from ``MOE_SEED``, served by ``ServingEngine`` under each of
    ``variants`` (``(name, config overrides)``) on one parameter tree.
    Each variant generates twice (2 tokens to warm up, then ``MOE_NEW``,
    measured, with the launch counts read around it). Returns the
    measured runs' flash launches and the kept layer-0 q/k/v of the last
    run, after freeing the model."""
    import dataclasses
    import gc
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import attention, moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = configs.get_config(arch, n_layers=MOE_LAYERS[arch], attn_impl=impl)
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(MOE_SEED, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[19] {arch}, {cfg.n_layers} layers at full width (plan "
        f"{model.plan}), bf16: {n_params:,} parameters "
        f"({n_params * 2 / 2**30:.2f} GiB) drawn in {init_s:.2f} s; peak "
        f"{init_gib:.2f} GiB after init; card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
    prompts = random_prompts(cfg.vocab_size, MOE_B, MOE_PROMPT, gen)
    scfg = ServeConfig(batch=MOE_B, max_len=MOE_PROMPT + MOE_NEW + 1)
    n_attn = cfg.n_layers if impl == "flash" else 0
    launches, kept = [], None
    for name, over in variants:
        eng = ServingEngine(dataclasses.replace(cfg, **over), scfg,
                            params=params, device="cuda")
        eng.generate(prompts, 2)
        tap, ftap = MoeTap(moe.apply_moe), CallTap(flash_attention)
        moe.apply_moe, attention.flash_attention = tap, ftap
        torch.cuda.synchronize()
        for k in counts:
            k.launches = 0
        try:
            out = eng.generate(prompts, MOE_NEW)
        finally:
            moe.apply_moe = tap.fn
            attention.flash_attention = flash_attention
        launched = {k.__name__: k.launches for k in counts}
        st = eng.last_stats
        if launched["flash_attention"] != n_attn or any(
                n for kname, n in launched.items()
                if kname != "flash_attention"):
            raise AssertionError(f"19 {arch} {name}: launched {launched}, "
                                 f"not flash {n_attn} times")
        if not (st["logits_finite"] and out.shape == (MOE_B, MOE_NEW)
                and (out >= 0).all() and (out < cfg.vocab_size).all()):
            raise AssertionError(f"19 {arch} {name}: logits finite "
                                 f"{st['logits_finite']}, tokens {out}")
        aux = {k: float(v) for k, v in tap.aux.items()}
        if not all(np.isfinite(v) for v in aux.values()):
            raise AssertionError(f"19 {arch} {name}: aux {aux}")
        log(f"[19] {arch} {name} (attn_impl={impl}), batch {MOE_B}, "
            f"{MOE_PROMPT}-token prompts, {MOE_NEW} new tokens: time to "
            f"first token {st['prefill_s']:.4f} s; decode "
            f"{MOE_B * (MOE_NEW - 1) / st['decode_s']:.1f} tokens/s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB after "
            f"generation; the prefill's MoE layer: load_balance_loss "
            f"{aux['load_balance_loss']:.6f}, dropped_fraction "
            f"{aux['dropped_fraction']:.6f}; flash_attention launches "
            f"{launched['flash_attention']}; logits finite, tokens in the "
            f"vocab; card: {card}")
        launches.append(launched["flash_attention"])
        kept = ftap.kept
        del eng, out
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, kept


def moe_card_vs_cpu(torch):
    """19(d): the smoke MoE configs from one CPU init (f32), on the card
    and on the CPU: prefill of ``MOE_TWIN_S`` tokens, 2 teacher-forced
    decode steps and ``loss_fn``. Each MoE call's routing (``idx``,
    ``rank``, ``keep``) equal exactly; logits and the loss, its cross
    entropy and aux loss within ``MOE_TWIN_TOL``. Returns the largest
    differences and the MoE calls compared."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import get_model
    cases = (("deepseek-v3-671b", ({}, {"mla_absorbed": True})),
             ("llama4-maverick-400b-a17b", ({"attn_impl": "flash"},
                                            {"attn_impl": "xla"})))
    route = moe.route
    worst = {"logits": 0.0, "loss": 0.0}
    n_calls = 0
    for arch, variants in cases:
        base = configs.get_smoke_config(arch)
        cpu_params = get_model(base).init(MOE_SEED, "cpu")
        card_params = tree_map(lambda t: t.to("cuda"), cpu_params)
        toks = torch.from_numpy(np.random.default_rng(MOE_SEED).integers(
            0, base.vocab_size, (2, MOE_TWIN_S + 3)).astype(np.int32))
        S = MOE_TWIN_S
        for over in variants:
            m = get_model(dataclasses.replace(base, **over))
            runs = {}
            for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
                routes = []

                def spy(*a, **kw):
                    r = route(*a, **kw)
                    routes.append({k: r[k].cpu() for k in ("idx", "rank",
                                                           "keep")})
                    return r

                moe.route = spy
                try:
                    t = toks.to(dev)
                    with torch.no_grad():
                        logits, cache = m.prefill(params, t[:, :S], S + 2)
                        out = [logits]
                        for i in range(2):
                            logits, cache = m.decode_step(
                                params, t[:, S + i:S + i + 1], cache, S + i)
                            out.append(logits)
                        loss, met = m.loss_fn(params, {
                            "tokens": t[:, :-1], "labels": t[:, 1:]})
                finally:
                    moe.route = route
                runs[dev] = ([o.cpu() for o in out],
                             [float(v) for v in (loss, met["ce_loss"],
                                                 met["aux_loss"])], routes)
            (lg, lc), (sg, sc), (rg, rc) = zip(runs["cuda"], runs["cpu"])
            if len(rg) != len(rc) or not rg or any(
                    not torch.equal(a[k], b[k])
                    for a, b in zip(rg, rc) for k in a):
                raise AssertionError(f"19(d) {arch} {over}: the card's "
                                     "routing differs from the CPU's")
            d_logits = max(float((a - b).abs().max()) for a, b in zip(lg, lc))
            d_loss = max(abs(a - b) for a, b in zip(sg, sc))
            if not (d_logits <= MOE_TWIN_TOL and d_loss <= MOE_TWIN_TOL):
                raise AssertionError(f"19(d) {arch} {over}: logits "
                                     f"{d_logits}, loss {d_loss}")
            log(f"[19] (d) smoke {arch} {over or 'plain'}: {len(rg)} MoE "
                f"calls routed equally on the card and the CPU; logits "
                f"within {d_logits:.3g}, loss / ce / aux within {d_loss:.3g} "
                f"(tol {MOE_TWIN_TOL:g}); loss {sg[0]:.6f}")
            worst = {"logits": max(worst["logits"], d_logits),
                     "loss": max(worst["loss"], d_loss)}
            n_calls += len(rg)
    return worst, n_calls


def phase_moe(torch, counts, flash_attention):
    """Phase 19 within ``MOE_BUDGET_S``. Returns (b)'s flash path for the
    kernels' line."""
    from repro_torch import configs
    from repro_torch.models.transformer import get_model
    card = card_line()
    t19 = time.perf_counter()
    ds = "deepseek-v3-671b"
    try:
        get_model(configs.get_config(ds, n_layers=MOE_LAYERS[ds],
                                     attn_impl="flash"))
    except ValueError as e:
        log(f"[19] (a) {ds} under attn_impl='flash' refused: {e}")
    else:
        raise AssertionError(f"19(a) {ds}: MLA under flash was not refused")
    serve_moe(torch, counts, flash_attention, card, ds, "xla",
              (("plain MLA", {}), ("absorbed MLA", {"mla_absorbed": True})))
    mv = "llama4-maverick-400b-a17b"
    (launches,), kept = serve_moe(torch, counts, flash_attention, card, mv,
                                  "flash", (("GQA 40/8", {}),))
    rec = time_flash(torch, flash_attention, kept, 19,
                     f"on {mv}'s layer-0 prefill inputs")
    del kept
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst, n_calls = moe_card_vs_cpu(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    wall = time.perf_counter() - t19
    within = "within" if wall <= MOE_BUDGET_S else "OVER"
    log(f"[19] (d) card == CPU routing on {n_calls} MoE calls; logits within "
        f"{worst['logits']:.3g}, losses within {worst['loss']:.3g}; phase 19 "
        f"in {wall:.1f} s ({within} its {MOE_BUDGET_S:g} s budget); card: "
        f"{card}")
    return ("maverick prefill", launches, rec)


# ------------------------------------------------------------ phase 20

def serve_cross(torch, counts, flash_attention, card, arch):
    """20(a)/(b): ``arch`` at full width (and ``CROSS_LAYERS[arch]`` layers)
    in bf16 from ``CROSS_SEED``, served by ``ServingEngine`` through the
    flash kernel with a random bf16 ``ctx``: 2 tokens to warm up, then
    ``CROSS_NEW``, measured, with the launch counts read around it; the
    encoder-decoder's encoder then timed alone on the same frames. Returns
    the measured run's flash launches and the kept layer-0 q/k/v, after
    freeing the model."""
    import gc
    from repro_torch import configs
    from repro_torch.launch.serve import random_ctx, random_prompts
    from repro_torch.models import attention
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    depth = CROSS_LAYERS[arch]
    cfg = configs.get_config(arch, attn_impl="flash",
                             **({} if depth is None else {"n_layers": depth}))
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(CROSS_SEED, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    vlm = cfg.family == "vlm"
    shape = (f"plan {model.plan}" if vlm else
             f"{cfg.n_enc_layers} encoder + {cfg.n_dec_layers} decoder layers")
    log(f"[20] {arch} at full width ({shape}), {cfg.param_dtype}: "
        f"{n_params:,} parameters ({n_params * 2 / 2**30:.2f} GiB in bf16) "
        f"drawn in {init_s:.2f} s; peak "
        f"{init_gib:.2f} GiB after init; card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(CROSS_SEED + 1)
    prompts = random_prompts(cfg.vocab_size, CROSS_B, CROSS_PROMPT, gen)
    ctx = random_ctx(cfg, CROSS_B, gen)
    eng = ServingEngine(cfg, ServeConfig(batch=CROSS_B,
                                         max_len=CROSS_PROMPT + CROSS_NEW + 1),
                        params=params, device="cuda")
    eng.generate(prompts, 2, ctx=ctx)
    n_flash = (model.plan[0][1] * model.plan[0][2] if vlm
               else cfg.n_dec_layers)
    ftap = CallTap(flash_attention)
    attention.flash_attention = ftap
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    try:
        out = eng.generate(prompts, CROSS_NEW, ctx=ctx)
    finally:
        attention.flash_attention = flash_attention
    launched = {k.__name__: k.launches for k in counts}
    st = eng.last_stats
    if launched["flash_attention"] != n_flash or any(
            n for kname, n in launched.items() if kname != "flash_attention"):
        raise AssertionError(f"20 {arch}: launched {launched}, not flash "
                             f"{n_flash} times")
    if not (st["logits_finite"] and out.shape == (CROSS_B, CROSS_NEW)
            and (out >= 0).all() and (out < cfg.vocab_size).all()):
        raise AssertionError(f"20 {arch}: logits finite "
                             f"{st['logits_finite']}, tokens {out}")
    enc = ""
    if not vlm:
        with torch.no_grad():
            model.encode(params, ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(params, ctx)
            torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc = (f"; the encoder alone {enc_s:.4f} s, "
               f"{100 * enc_s / st['prefill_s']:.1f} % of the time to first "
               "token")
    log(f"[20] {arch} (attn_impl=flash), batch {CROSS_B}, {CROSS_PROMPT}-token "
        f"prompts, ctx {list(ctx.shape)} {str(ctx.dtype)[6:]}, {CROSS_NEW} new "
        f"tokens: time to "
        f"first token {st['prefill_s']:.4f} s; decode "
        f"{CROSS_B * (CROSS_NEW - 1) / st['decode_s']:.1f} tokens/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB after "
        f"generation; flash_attention launches per prefill "
        f"{launched['flash_attention']}{enc}; logits finite, tokens in the "
        f"vocab; card: {card}")
    kept = ftap.kept
    del eng, out, params, ctx, ftap
    gc.collect()
    torch.cuda.empty_cache()
    return launched["flash_attention"], kept


def cross_card_vs_cpu(torch, archs=tuple(CROSS_LAYERS)):
    """20(d): the smoke configs of ``archs`` from one CPU init (f32), on
    the card and on the CPU, under flash and the plain attention: prefill
    of ``CROSS_TWIN_S`` tokens with a seeded ``ctx`` (the VLM's patches,
    the encoder-decoder's ``n_ctx`` frames), 2 teacher-forced decode steps
    and ``loss_fn`` (frames of ``S // 4`` there, as ``input_specs`` has
    them). Logits and the loss within ``CROSS_TWIN_TOL``. Returns the
    largest differences and the runs compared."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import get_model
    worst = {"logits": 0.0, "loss": 0.0}
    n_runs = 0
    for arch in archs:
        base = configs.get_smoke_config(arch)
        cpu_params = get_model(base).init(CROSS_SEED, "cpu")
        card_params = tree_map(lambda t: t.to("cuda"), cpu_params)
        rng = np.random.default_rng(CROSS_SEED)
        S = CROSS_TWIN_S
        toks = torch.from_numpy(rng.integers(
            0, base.vocab_size, (2, S + 3)).astype(np.int32))
        vlm = base.family == "vlm"
        width = base.d_ctx if vlm else base.d_model
        ctx = torch.from_numpy(rng.standard_normal(
            (2, base.n_ctx, width)).astype(np.float32))
        frames = torch.from_numpy(rng.standard_normal(
            (2, (S + 2) // 4, width)).astype(np.float32))
        for impl in ("flash", "xla"):
            m = get_model(dataclasses.replace(base, attn_impl=impl))
            runs = {}
            for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
                t = toks.to(dev)
                batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
                         "ctx" if vlm else "frames":
                         (ctx if vlm else frames).to(dev)}
                with torch.no_grad():
                    logits, cache = m.prefill(params, t[:, :S], S + 2,
                                              ctx=ctx.to(dev))
                    out = [logits]
                    for i in range(2):
                        logits, cache = m.decode_step(
                            params, t[:, S + i:S + i + 1], cache, S + i)
                        out.append(logits)
                    loss, _ = m.loss_fn(params, batch)
                runs[dev] = ([o.cpu() for o in out], float(loss))
            (lg, sg), (lc, sc) = runs["cuda"], runs["cpu"]
            d_logits = max(float((a - b).abs().max()) for a, b in zip(lg, lc))
            d_loss = abs(sg - sc)
            if not (d_logits <= CROSS_TWIN_TOL and d_loss <= CROSS_TWIN_TOL):
                raise AssertionError(f"20(d) {arch} {impl}: logits "
                                     f"{d_logits}, loss {d_loss}")
            log(f"[20] (d) smoke {arch} attn_impl={impl}, card vs CPU: "
                f"prefill + 2 decode logits within {d_logits:.3g}, loss "
                f"within {d_loss:.3g} (tol {CROSS_TWIN_TOL:g}); loss "
                f"{sg:.6f}")
            worst = {"logits": max(worst["logits"], d_logits),
                     "loss": max(worst["loss"], d_loss)}
            n_runs += 1
    return worst, n_runs


def phase_cross(torch, counts, flash_attention):
    """Phase 20 within ``CROSS_BUDGET_S``. Returns (c)'s two flash paths
    for the kernels' line."""
    card = card_line()
    t20 = time.perf_counter()
    paths = []
    for arch, name in (("llama-3.2-vision-90b", "vision prefill"),
                       ("seamless-m4t-large-v2", "seamless prefill")):
        launches, kept = serve_cross(torch, counts, flash_attention, card,
                                     arch)
        rec = time_flash(torch, flash_attention, kept, 20,
                         f"on {arch}'s layer-0 prefill inputs")
        paths.append((name, launches, rec))
        del kept
        torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst, n_runs = cross_card_vs_cpu(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    wall = time.perf_counter() - t20
    within = "within" if wall <= CROSS_BUDGET_S else "OVER"
    log(f"[20] (d) card == CPU on {n_runs} smoke runs: logits within "
        f"{worst['logits']:.3g}, losses within {worst['loss']:.3g}; phase 20 "
        f"in {wall:.1f} s ({within} its {CROSS_BUDGET_S:g} s budget); card: "
        f"{card}")
    return paths


# ------------------------------------------------------------ phase 21

def serve_xlstm(torch, counts, card):
    """21(a): xlstm-125m at full width in bf16 from ``XLSTM_SEED``, served by
    ``ServingEngine`` (16-token prompts for 2 tokens to warm up, then
    ``XLSTM_PROMPT``-token prompts and ``XLSTM_NEW`` new tokens, measured):
    no kernel launched (the model has no attention and no SSD); time to
    first token, decode tokens/s, peak GiB after init and after
    generation."""
    import gc
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = configs.get_config("xlstm-125m")
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(XLSTM_SEED, "cuda")
    torch.cuda.synchronize()
    init_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(XLSTM_SEED + 1)
    prompts = random_prompts(cfg.vocab_size, XLSTM_B, XLSTM_PROMPT, gen)
    eng = ServingEngine(cfg, ServeConfig(batch=XLSTM_B,
                                         max_len=XLSTM_PROMPT + XLSTM_NEW + 1),
                        params=params, device="cuda")
    eng.generate(prompts[:, :16], 2)
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    out = eng.generate(prompts, XLSTM_NEW)
    launched = {k.__name__: k.launches for k in counts}
    st = eng.last_stats
    if any(launched.values()):
        raise AssertionError(f"21(a) serving launched {launched}")
    if not (st["logits_finite"] and out.shape == (XLSTM_B, XLSTM_NEW)
            and (out >= 0).all() and (out < cfg.vocab_size).all()):
        raise AssertionError(f"21(a) logits finite {st['logits_finite']}, "
                             f"tokens {out}")
    log(f"[21] (a) xlstm-125m at full width ({model.n_super} super blocks of "
        f"mLSTM + sLSTM, d_model {cfg.d_model}, {cfg.n_heads} heads), "
        f"{cfg.param_dtype}: {n_params:,} parameters; batch {XLSTM_B}, "
        f"{XLSTM_PROMPT}-token prompts, {XLSTM_NEW} new tokens: time to first "
        f"token {st['prefill_s']:.4f} s (the step recurrence over every "
        f"prompt token); decode "
        f"{XLSTM_B * (XLSTM_NEW - 1) / st['decode_s']:.1f} tokens/s; peak "
        f"{init_gib:.2f} GiB after init, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB after "
        f"generation; no kernel launched; logits finite, tokens in the vocab; "
        f"card: {card}")
    del eng, out, params
    gc.collect()
    torch.cuda.empty_cache()


def rescale_slstm_r(torch, params, cfg):
    """The xLSTM's sLSTM recurrent matrices, drawn by the reference's init
    at 1 / sqrt(H), rescaled in place to 1 / sqrt(hd) (``XLSTM_TRAIN``'s
    note; ``tools/xlstm_sensitivity.py``)."""
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    with torch.no_grad():
        for g in "ifzo":
            params["supers"]["slstm"][f"r{g}"].mul_((H / hd) ** 0.5)


def train_xlstm(torch, counts, card):
    """21(b): xlstm-125m at full width through the trainer for
    ``XLSTM_TRAIN``'s steps (bf16 parameters, f32 moments, remat per super
    block; S > 512, so the chunkwise mLSTM runs S / 128 chunks), the
    sLSTM's recurrent matrices rescaled to 1 / sqrt(hd): finite
    losses and gradient norms, no kernel launched; warm step, tokens/s,
    peak GiB."""
    import gc
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    kw = XLSTM_TRAIN
    cfg = configs.get_config("xlstm-125m")
    opt_cfg = adamw.AdamWConfig(lr=kw["lr"], total_steps=kw["steps"],
                                warmup_steps=max(kw["steps"] // 20, 5))
    dcfg = DataConfig(cfg.vocab_size, kw["batch"], kw["seq"])
    torch.cuda.synchronize()
    for k in counts:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_train_state(cfg, opt_cfg, XLSTM_SEED, "cuda")
    params, opt = state.params, state.opt_state
    rescale_slstm_r(torch, params, cfg)
    step = trainer.make_train_step(cfg, opt_cfg)
    losses, secs, norms = [], [], []
    for s in range(kw["steps"]):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, synth_batch(dcfg, s, "cuda"))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launched = {k.__name__: k.launches for k in counts}
    if any(launched.values()):
        raise AssertionError(f"21(b) training launched {launched}")
    if not all(np.isfinite(norms)):
        raise AssertionError(f"21(b) gradient norms {norms}")
    st = train_stats(cfg, losses, secs, kw["batch"], kw["seq"], peak,
                     decreasing=False)
    log(f"[21] (b) xlstm-125m trained at full width: {st['params']:,} "
        f"params, batch {kw['batch']} x {kw['seq']} ({kw['seq'] // 128} "
        f"mLSTM chunks of 128), the sLSTM's r drawn at 1/sqrt("
        f"{cfg.d_model // cfg.n_heads}) (the reference's 1/sqrt("
        f"{cfg.n_heads}) overflows the backward); losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + " (finite), gradient norms "
        + " ".join(f"{x:.4f}" for x in norms)
        + f"; first step {st['first_step_s']:.3f} s, warm step "
        f"{st['warm_step_s']:.4f} s, {st['tokens_per_s']:.0f} tokens/s, "
        f"{st['model_flops_s'] / 1e12:.3f} model TFLOP/s (6 N tokens), peak "
        f"memory {st['peak_gib']:.2f} GiB; no kernel launched; card: {card}")
    del state, params, opt
    gc.collect()
    torch.cuda.empty_cache()


def xlstm_card_vs_cpu(torch):
    """21(c): the smoke config (f32, no TF32, chunk ``XLSTM_TWIN_CHUNK``)
    from one CPU init on the card and on the CPU: the chunkwise forward's
    logits and the loss within ``XLSTM_TWIN_TOL``, step 1's gradients
    within ``XLSTM_TWIN_TOL`` of their global norm; and on each device the
    prefill of half the tokens then teacher-forced decode steps, each
    step's logits within ``XLSTM_TWIN_TOL`` of the chunkwise forward's at
    its position. Returns the largest differences."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = configs.get_smoke_config("xlstm-125m",
                                   attn_q_chunk=XLSTM_TWIN_CHUNK)
    model = get_model(cfg)
    S, half = XLSTM_TWIN_S, XLSTM_TWIN_S // 2
    cpu = model.init(XLSTM_SEED, "cpu")
    batch = synth_batch(DataConfig(cfg.vocab_size, 4, S), 0, "cpu")
    runs = {}
    worst_tf = 0.0
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda p: p.to(dev), cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            logits = model._forward(params, b["tokens"])
            loss = float(model.loss_fn(params, b)[0])
            last, cache = model.prefill(params, b["tokens"][:, :half], S)
            tf = [(last[:, 0] - logits[:, half - 1]).abs().max()]
            for i in range(half, S):
                last, cache = model.decode_step(
                    params, b["tokens"][:, i:i + 1], cache, i)
                tf.append((last[:, 0] - logits[:, i]).abs().max())
        d_tf = float(torch.stack(tf).max())
        if not d_tf <= XLSTM_TWIN_TOL:
            raise AssertionError(f"21(c) {dev}: teacher-forced decode vs the "
                                 f"chunkwise forward {d_tf}")
        worst_tf = max(worst_tf, d_tf)
        g, _, _ = trainer._grad_fn(model, 1)(trainer.trainable(params), b)
        runs[dev] = (logits.cpu(), loss, tree_map(lambda t: t.cpu(), g))
    (lg, sg, gg), (lc, sc, gc_) = runs["cuda"], runs["cpu"]
    d_logits = float((lg - lc).abs().max())
    d_loss = abs(sg - sc)
    d_grad = float(adamw.global_norm(tree_map(lambda a, b: a - b, gg, gc_))
                   / adamw.global_norm(gc_))
    if not (d_logits <= XLSTM_TWIN_TOL and d_loss <= XLSTM_TWIN_TOL
            and d_grad <= XLSTM_TWIN_TOL):
        raise AssertionError(f"21(c) card vs CPU: logits {d_logits}, loss "
                             f"{d_loss}, gradients {d_grad}")
    log(f"[21] (c) smoke xlstm-125m (f32, chunk {XLSTM_TWIN_CHUNK}, "
        f"{S} tokens), card vs CPU: logits within {d_logits:.3g}, loss within "
        f"{d_loss:.3g} (loss {sg:.6f}), step-1 gradients within {d_grad:.3g} "
        f"of their norm; prefill of {half} tokens + {S - half} teacher-forced "
        f"decode steps within {worst_tf:.3g} of the chunkwise forward on both "
        f"devices (tol {XLSTM_TWIN_TOL:g})")
    return dict(logits=d_logits, loss=d_loss, grads=d_grad, decode=worst_tf)


def admission_modes(torch, fused_admission, card):
    """21(d): ``RANK_R`` replicas of phase 3's workload over
    ``RANK_HORIZON_S`` through the engine on the card under each admission
    mode: every output key equal to the ``"kernel"`` run's bit for bit, the
    admission kernel launched under ``"kernel"`` only; prints each mode's
    wall per wave (a reading)."""
    from repro_torch.core import batching, vdes
    _, wls, comps, pols, cols, caps = build_ensemble(RANK_R, RANK_HORIZON_S)
    t = batching.to_tensors(cols, "cuda")
    outs, lines = {}, []
    for mode in vdes.ADMISSION_SORTS:
        torch.cuda.synchronize()
        fused_admission.launches = 0
        t0 = time.perf_counter()
        out = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                     admission_sort=mode, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (fused_admission.launches > 0) != (mode == "kernel"):
            raise AssertionError(f"21(d) {mode}: fused_admission launched "
                                 f"{fused_admission.launches} times")
        outs[mode] = out
        waves = int(out["waves"].max())
        lines.append(f"{mode} {wall:.3f} s / {waves} waves = "
                     f"{1e3 * wall / waves:.3f} ms per wave")
    want = outs["kernel"]
    if set(want) != set(ORACLE_KEYS):
        raise AssertionError(f"21(d) output keys {sorted(want)}")
    for mode, out in outs.items():
        for k in ORACLE_KEYS:
            if not same_bits(out[k], want[k]):
                raise AssertionError(f"21(d) {mode} != kernel: {k}")
    check_invariants(want, wls, comps)
    log(f"[21] (d) admission modes on {RANK_R} replicas x "
        f"{RANK_HORIZON_S / 3600:g} h of phase 3's workload "
        f"({sum(w.n for w in wls)} pipelines): all {len(ORACLE_KEYS)} output "
        "keys equal bit for bit across " + "/".join(vdes.ADMISSION_SORTS)
        + "; fused_admission launched under kernel only; wall per wave: "
        + "; ".join(lines) + f"; card: {card}")


def compression_card_vs_cpu(torch):
    """21(e): int8 and top-k (``COMP_RATIO``) compression with error
    feedback for ``COMP_ROUNDS`` rounds on random bf16 leaves shaped like
    one full-width llama3.2-1b layer: the int8 codes, ``g_hat``, the new
    error and the wire bytes equal on the card and the CPU bit for bit;
    then ``compressed_psum_pod`` over a one-rank NCCL group (in-process
    ``HashStore``) equal to ``group=None``'s bit for bit."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models.common import layer, tree_leaves, tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.parallel import compression as C
    cfg = configs.get_config("llama3.2-1b")
    shapes = tree_map(lambda t: tuple(t.shape),
                      layer(get_model(cfg).init(0, "meta")["stage0"], 0))
    gen = torch.Generator().manual_seed(COMP_SEED)

    def grads():
        return tree_map(lambda sh: (torch.randn(sh, generator=gen) * 1e-3)
                        .to(torch.bfloat16), shapes)

    n_el = sum(int(np.prod(sh)) for sh in tree_leaves(shapes))
    rounds = [grads() for _ in range(COMP_ROUNDS)]
    wires = {}
    for kind in ("int8", "topk"):
        cc = C.CompressionConfig(kind=kind, topk_ratio=COMP_RATIO)
        err = {dev: [e.to(dev) for e in tree_leaves(
            C.init_error_state(cc, rounds[0]))] for dev in ("cuda", "cpu")}
        wires[kind] = 0
        for g in rounds:
            res = {}
            for dev in ("cuda", "cpu"):
                out = []
                for leaf, e in zip(tree_leaves(g), err[dev]):
                    leaf = leaf.to(dev)
                    q = (C.quantize_int8(leaf.float() + e.float())[0]
                         if kind == "int8" else None)
                    out.append((q, *C.compress_leaf(cc, leaf, e)))
                res[dev] = out
                err[dev] = [o[2] for o in out]
            for (qg, hg, eg, wg), (qc, hc, ec, wc) in zip(res["cuda"],
                                                          res["cpu"]):
                if not (wg == wc and same_bytes(hg, hc)
                        and same_bytes(eg, ec)
                        and (qg is None or same_bytes(qg, qc))):
                    raise AssertionError(f"21(e) {kind}: card != CPU")
            wires[kind] += sum(o[3] for o in res["cpu"])
    cc = C.CompressionConfig(kind="topk", topk_ratio=COMP_RATIO)
    g = tree_map(lambda t: t.to("cuda"), rounds[0])
    e0 = C.init_error_state(cc, g)
    want = C.compressed_psum_pod(cc, g, e0)
    with one_rank_nccl(torch):
        got = C.compressed_psum_pod(cc, g, e0, group=dist.group.WORLD)
        torch.cuda.synchronize()
    for a, b in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                    tree_leaves(want[0]) + tree_leaves(want[1])):
        if not same_bytes(a, b):
            raise AssertionError("21(e) one-rank NCCL group != group=None")
    if got[2] != want[2]:
        raise AssertionError(f"21(e) wire bytes {got[2]} != {want[2]}")
    log(f"[21] (e) compression on {len(tree_leaves(shapes))} bf16 leaves "
        f"shaped like one llama3.2-1b layer ({n_el:,} elements), "
        f"{COMP_ROUNDS} rounds with error feedback: int8 codes, g_hat, error "
        f"and wire bytes card == CPU bit for bit (int8 {wires['int8']:,} "
        f"bytes, top-k {COMP_RATIO:g} {wires['topk']:,} bytes against "
        f"{COMP_ROUNDS * 2 * n_el:,} in bf16); compressed_psum_pod over a "
        "one-rank NCCL group == group=None bit for bit")


def phase_xlstm(torch, counts, fused_admission):
    """Phase 21 within ``XLSTM_BUDGET_S``."""
    card = card_line()
    t21 = time.perf_counter()
    serve_xlstm(torch, counts, card)
    train_xlstm(torch, counts, card)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xlstm_card_vs_cpu(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    admission_modes(torch, fused_admission, card)
    compression_card_vs_cpu(torch)
    wall = time.perf_counter() - t21
    within = "within" if wall <= XLSTM_BUDGET_S else "OVER"
    log(f"[21] phase 21 in {wall:.1f} s ({within} its {XLSTM_BUDGET_S:g} s "
        f"budget); card: {card}")


# ------------------------------------------------------------ phase 22

def heap_trace(wl, plat, policy, comp, K, horizon_s, **stages):
    """The heap engine (``des.simulate``) on one replica of a stacked
    ensemble, its scenario's schedule padded to the batch's ``K`` change
    points as the batch runs it (the padding change points fall past the
    horizon, where each only adds a wave)."""
    import dataclasses
    from repro_torch.core import des
    comp = dataclasses.replace(comp,
                               schedule=comp.schedule.padded(K, horizon_s))
    return des.simulate(wl, plat, int(policy), scenario=comp, **stages)


def heap_vs_batched(out, ens, keys, columns, stages=False):
    """22(a) and (b): each replica of a stacked oracle ensemble (``ens``, as
    ``oracle_ensemble()`` or, with ``stages``, ``fullstack_oracle_ensemble()``
    returns it) through the heap engine, against the batched engine's
    outputs ``out`` (tensors on either device) taken through
    ``batching.batch_trace``: every trace column of ``keys`` the heap engine
    records equal bit for bit (NaN equal to NaN; the per-attempt records on
    the heap engine's attempt slots), and the wave counts equal on the
    replicas that need no padding rows (a padding row arrives at
    ``PAD_ARRIVAL`` and runs waves the heap engine never sees). Exactly
    ``columns`` columns must be compared. Returns those replicas, the
    columns compared and the heap engine's wall."""
    from repro_torch.core import batching
    cols, wls, plat = ens[0], ens[3], ens[-1]
    pols, comps = ens[2], ens[4]
    none = [None] * len(wls)
    fleets, probes, rels = ens[5:8] if stages else (none, none, none)
    K = cols["cap_times"].shape[1]
    unpadded = compared = 0
    wall = 0.0
    for i, wl in enumerate(wls):
        st = dict(fleet=fleets[i], probe=probes[i], reliability=rels[i])
        t0 = time.perf_counter()
        want = heap_trace(wl, plat, pols[i], comps[i], K, ORACLE_HORIZON_S,
                          **st)
        wall += time.perf_counter() - t0
        got = batching.batch_trace(out, i, wl, plat.capacities, **st)
        for k in keys:
            w, g = getattr(want, k), getattr(got, k)
            if w is None:
                continue
            if k in ("att_start", "att_finish") and g is not None:
                g = g[..., :w.shape[-1]]
            if g is None or g.shape != w.shape or not np.array_equal(
                    g, w, equal_nan=w.dtype.kind == "f"):
                raise AssertionError(f"replica {i}: the heap engine differs "
                                     f"from the batched engine in {k}")
            compared += 1
        if wl.n == cols["n_max"]:
            if got.waves != want.waves:
                raise AssertionError(f"replica {i}: {got.waves} waves "
                                     f"batched, {want.waves} heap")
            unpadded += 1
    if not unpadded:
        raise AssertionError("every replica has padding rows: no wave count "
                             "was compared")
    if compared != columns:
        raise AssertionError(f"{compared} trace columns compared, "
                             f"{columns} expected")
    return unpadded, compared, wall


def heap_yardstick(inputs, ens, main_wall, single_wall, single_summ, card):
    """22(c): phase 3's replica days through the heap engine once, one
    after another on the host; ``profile_numpy`` of replica 0; replica 0's
    ``mean_wait_s`` beside phase 4's on the card. Readings, not a gate:
    phase 3's times are not whole seconds, where the two engines (f64 on
    the host, f32 on the card) agree only statistically. Fails if a
    replica leaves a pipeline unfinished (phase 3's invariant)."""
    from repro_torch.core import des
    from repro_torch.obs.profile import profile_numpy
    plats, wls, comps, pols = inputs[:4]
    t0 = time.perf_counter()
    trs = [des.simulate(w, p, int(pol), scenario=c)
           for w, p, pol, c in zip(wls, plats, pols, comps)]
    wall = time.perf_counter() - t0
    for i, tr in enumerate(trs):
        if not tr.completed.all():
            raise AssertionError(f"replica {i}: the heap engine left "
                                 f"{int((~tr.completed).sum())} pipelines "
                                 "unfinished")
    waves = np.array([tr.waves for tr in trs])
    n_pipes = sum(w.n for w in wls)
    prof = profile_numpy(wls[0], plats[0], int(pols[0]), scenario=comps[0],
                         repeats=HEAP_PROFILE_REPEATS)
    heap_wait = single_summary(wls[0], plats[0], comps[0],
                               trs[0])["mean_wait_s"]
    card_waves = ens["waves"].cpu().numpy()
    log(f"[22] (c) the heap engine on phase 3's {len(wls)} replica days, "
        f"one after another on the host: wall {wall:.3f} s, waves max "
        f"{int(waves.max())} (sum {int(waves.sum())}), {n_pipes / wall:.1f} "
        f"pipelines/s; phase 3's simulate_ensemble on the card in this call "
        f"{main_wall:.3f} s (waves max {int(card_waves.max())}, sum "
        f"{int(card_waves.sum())}, {n_pipes / main_wall:.1f} pipelines/s), "
        f"{main_wall / wall:.2f}x the heap engine's wall; phase 4's "
        f"simulate_to_trace of replica 0 {single_wall:.3f} s; card: {card}")
    log(f"[22] (c) profile_numpy of replica 0 (repeats "
        f"{HEAP_PROFILE_REPEATS}): wall {prof['wall_s']:.4f} s, "
        f"{prof['waves']} waves, {prof['waves_per_s']:.1f} waves/s; "
        f"replica 0's mean_wait_s: heap engine {heap_wait:.3f}, card "
        f"(phase 4) {single_summ['mean_wait_s']:.3f}")
    return wall


def phase_heap_engine(inputs, ens, main_wall, single, oracle_card,
                      fso_card):
    """Phase 22 within ``HEAP_BUDGET_S``: the heap engine against the card's
    phase 13 and 14(b) runs, then beside phase 3's wall."""
    card = card_line()
    t22 = time.perf_counter()
    n_a, cols_a, heap_a = heap_vs_batched(oracle_card, oracle_ensemble(),
                                          HEAP_ORACLE_KEYS,
                                          HEAP_ORACLE_COLUMNS)
    log(f"[22] (a) the heap engine on phase 13's oracle ensemble "
        f"({ORACLE_R} replicas, {heap_a:.3f} s on the host) == the card's "
        f"run bit for bit: {cols_a} trace columns; waves equal on {n_a} of "
        f"{ORACLE_R} replicas (the others have padding rows)")
    n_b, cols_b, heap_b = heap_vs_batched(
        fso_card, fullstack_oracle_ensemble(), HEAP_FSO_KEYS,
        HEAP_FSO_COLUMNS, stages=True)
    log(f"[22] (b) the heap engine on phase 14(b)'s full-stack oracle "
        f"ensemble ({ORACLE_R} replicas, every stage, {heap_b:.3f} s on the "
        f"host) == the card's run bit for bit: {cols_b} trace columns "
        f"(controller, reliability, fleet and probe timelines included); "
        f"waves equal on {n_b} of {ORACLE_R} replicas (the others have "
        "padding rows)")
    log(f"heap_vs_card: identical, {cols_a + cols_b} columns, "
        f"{2 * ORACLE_R} replicas")
    heap_yardstick(inputs, ens, main_wall, *single, card)
    wall = time.perf_counter() - t22
    within = "within" if wall <= HEAP_BUDGET_S else "OVER"
    log(f"[22] phase 22 in {wall:.1f} s ({within} its {HEAP_BUDGET_S:g} s "
        f"budget); card: {card}")


# ------------------------------------------------------------ phase 23

@contextlib.contextmanager
def one_rank_nccl(torch):
    """A one-rank NCCL group on the card, its rendezvous an in-process
    ``HashStore`` (no file, no socket), destroyed on leaving. A failed init
    raises, and a collective that outlasts ``NCCL_TIMEOUT_S`` fails the
    run: nothing falls back to the CPU."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_same_tree(torch, a, b) -> bool:
    """Two trees equal byte for byte, compared on their device; DTensor
    leaves by their whole value."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = (t.full_tensor() if isinstance(t, DTensor) else t
                for t in (x, y))
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not torch.equal(x.detach().contiguous().view(-1).view(torch.uint8),
                           y.detach().contiguous().view(-1).view(torch.uint8)):
            return False
    return True


def pinned_bytes(torch, tree) -> list:
    """Each leaf's bytes (a DTensor's whole value), in tree order, copied
    into pinned host memory."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import tree_leaves
    out = []
    for t in tree_leaves(tree):
        t = (t.full_tensor() if isinstance(t, DTensor) else t).detach()
        t = t.contiguous().view(-1).view(torch.uint8)
        out.append(torch.empty(t.shape, dtype=torch.uint8,
                               pin_memory=True).copy_(t))
    return out


def mesh_train_twin(torch, arch, smoke, kw, ckpt_dir, counts=()):
    """23(a): ``run_training`` on the debug mesh with FSDP (the state
    DTensors at rest, every leaf gathered, this rank's rows of the batch,
    the gradients averaged over 'data' by NCCL), each step's parameters
    equal bit for bit to the meshless step's after the same step (the
    loop ``run_training`` drives without a mesh, 16(a)'s, from the same
    seed and batches), both under ``torch.use_deterministic_algorithms``;
    no kernel launched, no restart. The parameters are compared as bytes
    in pinned host memory: three full-width copies on the card beside the
    meshed run's state, or their transients, leave the allocator too
    fragmented for the step's 3.9 GiB logits. Returns
    the run's output, its warm step, the meshless warm step and the peak
    GiB above the baseline."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import run_training
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    opt_cfg = adamw.AdamWConfig(lr=kw["lr"], total_steps=kw["steps"],
                                warmup_steps=max(kw["steps"] // 20, 5))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=kw["batch"],
                      seq_len=kw["seq"], family=cfg.family, n_ctx=cfg.n_ctx,
                      d_ctx=cfg.d_ctx, d_model=cfg.d_model)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        st = trainer.init_train_state(cfg, opt_cfg, 0, "cuda")
        step = trainer.make_train_step(cfg, opt_cfg)
        p, o, want, plain_secs = st.params, st.opt_state, [], []
        del st
        for s in range(kw["steps"]):
            t0 = time.perf_counter()
            p, o, m = step(p, o, synth_batch(dcfg, s, "cuda"))
            float(m["loss"])
            plain_secs.append(time.perf_counter() - t0)
            want.append(pinned_bytes(torch, p))
        del p, o, m
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seen = []
        before = [k.launches for k in counts]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run_training(
            arch, smoke=smoke, ckpt_dir=ckpt_dir, ckpt_every=0,
            log_every=1, resume=False, mesh=make_debug_mesh(), fsdp=True,
            on_step=lambda s, state: seen.append(all(
                torch.equal(a, b) for a, b in zip(
                    pinned_bytes(torch, state["params"]), want[s]))), **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        torch.use_deterministic_algorithms(prev)
    if out["restarts"] or seen != [True] * kw["steps"]:
        raise AssertionError(f"23(a) meshed parameters == meshless after "
                             f"each step: {seen}, {out['restarts']} "
                             "restarts")
    if [k.launches for k in counts] != before:
        raise AssertionError("23(a) meshed training launched a kernel")
    secs = [h["sec"] for h in out["history"]]
    losses = [h["loss"] for h in out["history"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"23(a) losses {losses}")
    return dict(cfg=cfg, out=out, losses=losses,
                warm_step_s=float(np.median(secs[1:])),
                plain_warm_step_s=float(np.median(plain_secs[1:])),
                peak_gib=peak / 2 ** 30)


def pod_mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((1, 1, 1), ("pod", "data", "model"))


def restore_twin(torch, cfg, ckpt_dir, step, state):
    """23(c): the checkpoint of ``step`` (written from the meshed state)
    restored onto the pod mesh with ``state_shardings`` and onto no mesh,
    both equal to the in-memory state bit for bit, the first with the
    shardings' placements. Returns both restores' seconds."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.common import tree_items
    from repro_torch.train import trainer
    sh = trainer.state_shardings(cfg, pod_mesh(), fsdp=True)
    onto = {"params": sh["params"], "opt_state": sh["opt_state"]}
    mgr = CheckpointManager(ckpt_dir)
    secs = []
    for shardings in (onto, None):
        t0 = time.perf_counter()
        back = mgr.restore(step, state, shardings)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        leaves = [t for _, t in tree_items(back)]
        if shardings is None:
            placed = not any(isinstance(t, DTensor) for t in leaves)
        else:
            placed = all(isinstance(t, DTensor) and list(t.placements)
                         == s.placements and t.device_mesh.mesh_dim_names
                         == ("pod", "data", "model")
                         for t, (_, s) in zip(leaves, tree_items(shardings)))
        if not (placed and device_same_tree(torch, back, state)):
            raise AssertionError(f"23(c) restored onto "
                                 f"{'no mesh' if shardings is None else 'the pod mesh'}"
                                 " != the in-memory state")
        del back, leaves
    return secs


def compressed_twin(torch, cfg, kw, steps):
    """23(b): the compressed step (int8 with error feedback) on the pod
    mesh with FSDP for ``steps`` steps of ``kw``'s batches: finite, falling
    loss and ``wire_bytes_pod`` equal to the leaves' count (one byte per
    entry and a 4-byte scale per leaf). Returns the losses, the wire bytes
    and the warm step."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression as C
    from repro_torch.train import trainer
    mesh = pod_mesh()
    comp = C.CompressionConfig(kind="int8")
    opt_cfg = adamw.AdamWConfig(lr=kw["lr"], total_steps=steps,
                                warmup_steps=max(steps // 20, 5))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=kw["batch"],
                      seq_len=kw["seq"])
    st = trainer.init_train_state(cfg, opt_cfg, 0, "cuda")
    want_wire = sum(t.numel() + 4 for t in tree_leaves(st.params))
    err = C.init_error_state(comp, st.params)
    sh = trainer.state_shardings(cfg, mesh, fsdp=True)
    placed = trainer.shard_state(
        {"params": st.params, "opt_state": st.opt_state},
        {"params": sh["params"], "opt_state": sh["opt_state"]})
    del st
    step = trainer.make_compressed_train_step(cfg, opt_cfg, mesh, comp,
                                              fsdp=True)
    p, o = placed["params"], placed["opt_state"]
    del placed
    losses, wires, secs = [], [], []
    for s in range(steps):
        t0 = time.perf_counter()
        p, o, err, m = step(p, o, err, synth_batch(dcfg, s, "cuda"))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        wires.append(m["wire_bytes_pod"])
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"23(b) compressed losses {losses}")
    if wires != [want_wire] * steps:
        raise AssertionError(f"23(b) wire bytes {wires} != {want_wire}")
    return losses, want_wire, secs


def hybrid_variants_card_vs_cpu(torch):
    """23(d): zamba2's smoke config with ``n_experts=4`` (the shared block
    stays dense) and with MLA (``MESH_MLA``) from one CPU init, in f32
    (no TF32): the forward through the SSD and flash kernels on the card
    (one SSD launch per Mamba block, one flash launch per shared-block
    application) against the CPU's plain path, logits within
    ``HYB_TWIN_LOGIT_ATOL`` and the loss within ``HYB_TWIN_LOSS_ATOL``;
    the experts' prefill likewise (flash once per application); the MLA
    prefill refused with ``ValueError`` on both devices. Returns each
    variant's (logit err, loss err)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.models.common import cross_entropy_loss, tree_map
    from repro_torch.models.transformer import get_model
    errs = {}
    g = torch.Generator().manual_seed(MESH_HYB_SEED)
    for name, over in (("n_experts=4", dict(n_experts=4)),
                       ("use_mla", MESH_MLA)):
        model = get_model(configs.get_smoke_config(
            HYB_ARCH, ssm_impl="mamba_kernel", attn_impl="flash", **over))
        c = model.cfg
        params = model.init(MESH_HYB_SEED, "cpu")
        card = tree_map(lambda t: t.cuda(), params)
        toks = torch.randint(0, c.vocab_size, (MESH_HYB_B, MESH_HYB_S),
                             generator=g)
        labels = torch.roll(toks, -1, 1)
        got = {}
        for dev, p in (("cuda", card), ("cpu", params)):
            before = (mamba2_scan.launches, flash_attention.launches)
            with torch.inference_mode():
                logits = model._forward(p, toks.to(dev))
                loss = float(cross_entropy_loss(logits, labels.to(dev)))
            n = (mamba2_scan.launches - before[0],
                 flash_attention.launches - before[1])
            want_n = (c.n_layers, model.n_super) if dev == "cuda" else (0, 0)
            if n != want_n:
                raise AssertionError(f"23(d) {name} on {dev}: launches "
                                     f"(ssd, flash) {n}, not {want_n}")
            got[dev] = (logits[..., :c.vocab_size].float().cpu(), loss)
            try:
                with torch.inference_mode():
                    pl, _ = model.prefill(p, toks.to(dev), MESH_HYB_S + 4)
            except ValueError as e:
                if not c.use_mla or "dynamic_update_slice" not in str(e):
                    raise
                pl = None
            else:
                if c.use_mla:
                    raise AssertionError("23(d) the MLA hybrid prefilled")
            got[dev] += (None if pl is None else pl.float().cpu(),)
        lerr = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        loss_err = abs(got["cuda"][1] - got["cpu"][1])
        perr = (0.0 if c.use_mla else
                float((got["cuda"][2] - got["cpu"][2]).abs().max()))
        if not (lerr <= HYB_TWIN_LOGIT_ATOL and perr <= HYB_TWIN_LOGIT_ATOL
                and loss_err <= HYB_TWIN_LOSS_ATOL):
            raise AssertionError(f"23(d) {name}: card vs CPU logits "
                                 f"{lerr}, prefill {perr}, loss {loss_err}")
        errs[name] = (max(lerr, perr), loss_err)
    return errs


def phase_mesh(torch, counts, train_llama):
    """Phase 23 within ``MESH_BUDGET_S``: the meshes, the sharded and
    compressed training steps and restoring across meshes on a one-rank
    NCCL group, then the hybrid's experts and MLA variants."""
    import tempfile
    card = card_line()
    t23 = time.perf_counter()
    arch, kw = "llama3.2-1b", MESH_TRAIN
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d, \
            one_rank_nccl(torch):
        t0 = time.perf_counter()
        st = mesh_train_twin(torch, arch, False, kw, d, counts)
        log(f"[23] (a) {arch} at full width through run_training on the "
            f"debug mesh (1, 1) with FSDP, NCCL: {kw['steps']} steps of "
            f"{kw['batch']} x {kw['seq']}, losses "
            + " ".join(f"{x:.4f}" for x in st["losses"])
            + f"; parameters == the meshless step's bit for bit after each "
            f"step (deterministic algorithms); no kernel launched; warm "
            f"step {st['warm_step_s']:.4f} s meshed, "
            f"{st['plain_warm_step_s']:.4f} s meshless in this phase, "
            f"{train_llama['warm_step_s']:.4f} s in 16(a); peak "
            f"{st['peak_gib']:.2f} GiB above the baseline; final "
            f"checkpoint save {st['out']['save_s']:.2f} s "
            f"({time.perf_counter() - t0:.1f} s); card: {card}")
        t0 = time.perf_counter()
        secs = restore_twin(torch, st["cfg"], d, kw["steps"],
                            st["out"]["state"])
        log(f"[23] (c) that checkpoint restored onto the pod mesh (1, 1, 1) "
            f"with state_shardings in {secs[0]:.2f} s and onto no mesh in "
            f"{secs[1]:.2f} s: both == the in-memory state bit for bit "
            f"({time.perf_counter() - t0:.1f} s)")
        cfg = st["cfg"]
        del st
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        losses, wire, secs = compressed_twin(torch, cfg, kw, MESH_COMP_STEPS)
        log(f"[23] (b) compressed step (int8, error feedback) on the pod mesh "
            f"with FSDP, {MESH_COMP_STEPS} steps of {kw['batch']} x "
            f"{kw['seq']}: losses " + " ".join(f"{x:.4f}" for x in losses)
            + f", wire_bytes_pod {wire:,} per step (== the leaves' count), "
            f"second step {secs[-1]:.4f} s ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        errs = hybrid_variants_card_vs_cpu(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log("[23] (d) smoke zamba2 card (SSD + flash kernels) vs CPU, f32: "
        + "; ".join(f"{k}: logits {a:.3g}, loss {b:.3g}"
                    for k, (a, b) in errs.items())
        + f" (tol {HYB_TWIN_LOGIT_ATOL:g} / {HYB_TWIN_LOSS_ATOL:g}); the "
        f"MLA prefill refused ({time.perf_counter() - t0:.1f} s)")
    wall = time.perf_counter() - t23
    within = "within" if wall <= MESH_BUDGET_S else "OVER"
    log(f"[23] phase 23 in {wall:.1f} s ({within} its {MESH_BUDGET_S:g} s "
        f"budget); card: {card}")


# ------------------------------------------------------------ phase 24

def mesh_serving_twin(torch, counts, flash_attention):
    """24(a): phase 6's serving run through the engine on the (1, 1) mesh
    and without a mesh, each run with every kernel count set to 0 just
    before its generation and read just after; then the logits of the
    prefill and of each decode step, teacher-forced on the generated
    tokens. Returns each engine's numbers and the mesh prefill's layer-0
    flash inputs."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import attention
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    cfg = configs.get_config(SERVE_ARCH, attn_impl="flash")
    params = get_model(cfg).init(SERVE_SEED, "cuda")
    scfg = ServeConfig(batch=SERVE_B, max_len=SERVE_PROMPT + SERVE_NEW + 1)
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    prompts = random_prompts(cfg.vocab_size, SERVE_B, SERVE_PROMPT, gen)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    engines = {"mesh": ServingEngine(cfg, scfg, params=params,
                                     device="cuda", mesh=mesh),
               "meshless": ServingEngine(cfg, scfg, params=params,
                                         device="cuda")}
    for eng in engines.values():      # first-call costs, not counted
        eng.generate(prompts, 2)
    tap = CallTap(flash_attention)
    out = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    attention.flash_attention = tap
    try:
        for name, eng in engines.items():
            torch.cuda.reset_peak_memory_stats()
            for c in counts:
                c.launches = 0
            tokens = eng.generate(prompts, SERVE_NEW)
            launches = {c.__name__: c.launches for c in counts}
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            if name == "mesh":
                kept = tap.kept
            logits, cache = eng.prefill(prompts)
            steps = [logits]
            for i in range(SERVE_NEW - 1):
                tok = torch.from_numpy(tokens[:, i:i + 1]).cuda()
                logits, cache = eng.decode(tok, cache, SERVE_PROMPT + i)
                steps.append(logits)
            out[name] = dict(tokens=tokens, logits=torch.cat(steps, 1),
                             launches=launches, peak_gib=peak,
                             stats=dict(eng.last_stats))
            del cache, steps
    finally:
        attention.flash_attention = flash_attention
    for name, got in out.items():
        others = {k: n for k, n in got["launches"].items()
                  if k != flash_attention.__name__ and n}
        if got["launches"][flash_attention.__name__] != cfg.n_layers \
                or others:
            raise AssertionError(f"24(a) {name}: launches {got['launches']}"
                                 f", not flash once per layer "
                                 f"({cfg.n_layers}) and nothing else")
        if not got["stats"]["logits_finite"]:
            raise AssertionError(f"24(a) {name}: a logit is not finite")
    if not (np.array_equal(out["mesh"]["tokens"], out["meshless"]["tokens"])
            and same_bytes(out["mesh"]["logits"], out["meshless"]["logits"])):
        raise AssertionError("24(a) the engine on the (1, 1) mesh differs "
                             "from the meshless engine")
    return out, kept


def combine_on_card(torch):
    """24(b): the split decode against the unsplit one on the card;
    returns the largest row-relative difference, the empty blocks and the
    two times."""
    import math
    from repro_torch.models import attention as A
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 2)
    B, S, D = COMBINE_B, COMBINE_S, COMBINE_D

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q = draw(B, 1, COMBINE_HEADS, D)
    k, v = draw(B, S, COMBINE_KV_HEADS, D), draw(B, S, COMBINE_KV_HEADS, D)
    valid = torch.tensor(COMBINE_VALID, dtype=torch.int32, device="cuda")
    scale, rep = 1.0 / math.sqrt(D), COMBINE_HEADS // COMBINE_KV_HEADS

    def unsplit():
        return A._decode_core_grouped(q, k, v, valid, scale, rep)

    def split():
        return A.split_decode(q, k, v, valid, COMBINE_BLOCKS)

    want, got = unsplit().float(), split().float()
    rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    if not (bool(torch.isfinite(got).all()) and rel <= FLASH_ROW_REL_TOL):
        raise AssertionError(f"24(b) the combined blocks differ from the "
                             f"unsplit decode by {rel} of a row's norm")
    n = S // COMBINE_BLOCKS
    empty = sum(1 for x in COMBINE_VALID for i in range(COMBINE_BLOCKS)
                if x <= i * n)
    return dict(rel=rel, empty=empty, unsplit_ms=cuda_ms(unsplit, iters=20),
                split_ms=cuda_ms(split, iters=20))


def mesh_cell_in_fake_world(root):
    """24(c): llama's decode_32k cell as rank 0 of the 16 x 16 mesh, in a
    spawned process of the fake world."""
    from repro_torch.launch import dryrun
    recs = dryrun.write_cells([SERVE_ARCH], ["decode_32k"], root=root,
                              force=True, mesh_name="single",
                              log=lambda *a: None)
    return recs[(SERVE_ARCH, "decode_32k")]


def cache_block_bytes(rec):
    """``(rank 0's cache bytes, the whole cache's)`` of the single decode
    record: its argument bytes less rank 0's blocks of the parameters
    (the reference's rules, no FSDP), its token rows and the position."""
    import math
    from repro_torch import configs
    from repro_torch.models.common import tree_items
    from repro_torch.parallel import sharding as Sh
    cfg, spec = configs.get_config(SERVE_ARCH), configs.SHAPES["decode_32k"]
    mesh = Sh.MeshShape(("data", "model"), (16, 16))
    shapes, axes = configs.param_specs(cfg)
    sh = dict(tree_items(Sh.param_shardings(axes, shapes, mesh)))
    params = sum(math.prod(b.stop - b.start for b in sh[p].block(
        tuple(t.shape), (0, 0))) * t.element_size()
        for p, t in tree_items(shapes))
    rows = spec.global_batch // 16 * 4
    whole = 2 * cfg.n_layers * spec.global_batch * spec.seq_len \
        * cfg.n_kv_heads * cfg.hd * 2
    return rec["memory"]["argument_size_in_bytes"] - params - rows - 4, whole


def phase_mesh_serving(torch, counts, flash_attention):
    """Phase 24 within ``MESH_SERVE_BUDGET_S``: serving on a mesh. Returns
    the flash kernel's launches on the mesh engine's generation (the main
    path of serving on a mesh) and its record on that path."""
    import tempfile
    card = card_line()
    t24 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cells_") as d, \
            ThreadPoolExecutor(1) as pool:
        cell = pool.submit(mesh_cell_in_fake_world, d)
        t0 = time.perf_counter()
        with one_rank_nccl(torch):
            out, kept = mesh_serving_twin(torch, counts, flash_attention)
        for name, got in out.items():
            st = got["stats"]
            where = "on the (1, 1) mesh" if name == "mesh" else "meshless"
            log(f"[24] (a) {SERVE_ARCH} at full width, bf16, flash: "
                f"ServingEngine {where}: "
                f"time to first token {st['prefill_s']:.4f} s, decode "
                f"{SERVE_B * (SERVE_NEW - 1) / st['decode_s']:.1f} tokens/s, "
                f"peak {got['peak_gib']:.2f} GiB above the baseline, "
                f"launches {got['launches']}")
        log(f"[24] (a) {SERVE_B} x {SERVE_PROMPT} prompts, {SERVE_NEW} new "
            f"tokens: tokens and the logits of the prefill and {SERVE_NEW - 1}"
            f" decode steps equal bit for bit on the (1, 1) mesh and without "
            f"one ({time.perf_counter() - t0:.1f} s); card: {card}")
        launches = out["mesh"]["launches"][flash_attention.__name__]
        frec = time_flash(torch, flash_attention, kept, 24,
                          "on layer 0's inputs of the prefill on the (1, 1) "
                          "mesh")
        del out, kept
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        comb = combine_on_card(torch)
        log(f"[24] (b) one llama layer's decode attention over a "
            f"{COMBINE_S}-entry bf16 cache at batch {COMBINE_B} "
            f"({COMBINE_HEADS} heads, {COMBINE_KV_HEADS} KV heads, head dim "
            f"{COMBINE_D}) in {COMBINE_BLOCKS} blocks, {comb['empty']} of "
            f"them with no valid entry, combined on the card: within "
            f"{comb['rel']:.3g} of each output row's norm of the unsplit "
            f"decode (tol {FLASH_ROW_REL_TOL:g}); unsplit "
            f"{comb['unsplit_ms']:.4f} ms, split and combined "
            f"{comb['split_ms']:.4f} ms ({time.perf_counter() - t0:.1f} s); "
            f"card: {card}")
        t0 = time.perf_counter()
        rec = cell.result()
    if rec.get("status") != "ok" or rec["n_devices"] != 256:
        raise AssertionError(f"24(c) the single decode_32k record: {rec}")
    cache, whole = cache_block_bytes(rec)
    if cache * 256 != whole:
        raise AssertionError(f"24(c) rank 0 holds {cache} cache bytes, not "
                             f"1/256 of {whole}")
    coll = sum(c["bytes"] for c in rec["collectives"].values())
    log(f"[24] (c) {SERVE_ARCH} x decode_32k as rank 0 of the 16 x 16 mesh "
        f"in the fake world (a spawned process): "
        f"{rec['flops_per_device']:.4e} FLOPs, "
        f"{rec['bytes_accessed_per_device']:.4e} bytes, "
        f"{coll:.4e} collective bytes ("
        + ", ".join(f"{k} {v['count']} x = {v['bytes']:.4e}"
                    for k, v in rec["collectives"].items() if v["count"])
        + f") per device; arguments "
        f"{rec['memory']['argument_size_in_bytes']:.4e} bytes, of which the "
        f"cache block {cache:,} == 1/256 of {whole:,}; counted in "
        f"{rec['lower_s']:.1f} s (waited {time.perf_counter() - t0:.1f} s)")
    wall = time.perf_counter() - t24
    within = "within" if wall <= MESH_SERVE_BUDGET_S else "OVER"
    log(f"[24] phase 24 in {wall:.1f} s ({within} its "
        f"{MESH_SERVE_BUDGET_S:g} s budget); card: {card}")
    return launches, frec


# ------------------------------------------------------------ phase 25

def load_example(name):
    """``examples/torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def all_finite(x) -> bool:
    """Every number in a nest of dicts, lists and tuples is finite."""
    if isinstance(x, dict):
        return all(all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(all_finite(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.dtype.kind not in "fc" or bool(np.isfinite(x).all())
    if isinstance(x, (bool, str)) or x is None:
        return True
    return bool(np.isfinite(float(x)))


def check_example(name, out, archs):
    """The fields the reference example prints, and its own checks."""
    if not all_finite(out):
        raise AssertionError(f"25 {name}: a returned number is not finite")
    if name in EXAMPLE_ROW_FIELDS:
        if len(out) != EXAMPLE_ROWS[name] or any(
                set(r) != set(EXAMPLE_ROW_FIELDS[name]) for r in out):
            raise AssertionError(f"25 {name}: rows {out}")
    elif name == "quickstart":
        want = {"n_tasks", "n_pipelines", "mean_wait_s", "p50_wait_s",
                "p95_wait_s", "p99_wait_s", "utilization"}
        if not (want <= set(out["summary"])
                and out["summary"]["n_pipelines"] > 0
                and out["empirical_pipelines"] > 0):
            raise AssertionError(f"25 {name}: {out}")
    elif name == "model_lifecycle":
        if (len(out["rows"]) != 8 or not out["frontier"]
                or out["drill"] is None
                or not sum(r["n_retrained"] for r in out["rows"])):
            raise AssertionError(f"25 {name}: {out}")
    elif name == "observability":
        if not (out["ticks_sampled"] > 0 and out["rows"]
                and {"run", "pipeline", "task"} <= set(out["span_kinds"])
                and all(os.path.getsize(f) > 0 for f in out["files"])):
            raise AssertionError(f"25 {name}: {out}")
    elif name == "replay_trace":
        if out["parity_drift"] != 0.0 or out["replay_max_err"] != 0.0 or \
                out["recovered_pipelines"] != out["pipelines"]:
            raise AssertionError(f"25 {name}: drift {out['parity_drift']}, "
                                 f"replay error {out['replay_max_err']}")
    elif name == "accelerator_platform":
        if sorted(out["medians_s"]) != sorted(archs) or len(out["rows"]) != 3:
            raise AssertionError(f"25 {name}: {sorted(out['medians_s'])}")
    elif name == "train_lm":
        if not (out["last_loss"] < out["first_loss"]
                and out["restarts"] == 1):
            raise AssertionError(f"25 {name}: {out}")


def example_cuts(mod, kwargs) -> str:
    """The keyword arguments that differ from ``main``'s defaults (the
    reference example's constants), as ``name default -> value``."""
    import inspect
    params = inspect.signature(mod.main).parameters
    return ", ".join(f"{k} {params[k].default:g} -> {v:g}"
                     if isinstance(v, (int, float)) else f"{k} -> {v}"
                     for k, v in kwargs.items()) or "none"


def phase_examples(torch, counts, root, cuts=None):
    """Phase 25 within ``EXAMPLES_BUDGET_S``: each example's ``main`` on the
    card, one after another in this process, at the reference example's
    constants unless ``cuts`` (default ``EXAMPLE_CUTS``) cuts them;
    ``accelerator_platform`` reads the cells under ``root`` (17(a)'s).
    Checks each return (finite numbers, the fields the reference prints,
    its own checks) and the kernels each launched; prints each example's
    wall and launches."""
    import tempfile
    from repro_torch import configs
    cuts = EXAMPLE_CUTS if cuts is None else cuts
    card = card_line()
    t25 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as out_dir:
        extra = {"observability": {"out_dir": out_dir},
                 "replay_trace": {"out_dir": out_dir},
                 "accelerator_platform": {"root": root}}
        for name in EXAMPLES:
            mod = load_example(name)
            kw = dict(cuts.get(name, {}))
            torch.cuda.synchronize()
            for k in counts:
                k.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                out = mod.main(device="cuda", **kw, **extra.get(name, {}))
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launched = {k.__name__: k.launches for k in counts}
            for kname, n in launched.items():
                want = name in EXAMPLE_LAUNCHES.get(kname, ())
                if (n > 0) != want:
                    raise AssertionError(f"25 {name}: {kname} launched {n} "
                                         "times")
            check_example(name, out, configs.ARCHS)
            log(f"[25] {name}: {walls[name]:.2f} s, fused_admission "
                f"{launched['fused_admission']} / gmm_logpdf "
                f"{launched['gmm_logpdf']} launches; cut: "
                f"{example_cuts(mod, kw)}; card: {card}")
    wall = time.perf_counter() - t25
    within = "within" if wall <= EXAMPLES_BUDGET_S else "OVER"
    log(f"[25] phase 25: {len(walls)} examples in {wall:.1f} s ({within} its "
        f"{EXAMPLES_BUDGET_S:g} s budget); card: {card}")
    return walls


# ------------------------------------------------------------ phase 26

def row_rel(got, want) -> float:
    """The largest ``||got - want|| / ||want||`` over the last dim's rows."""
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def teacher_forced(torch, eng, prompts, tokens, prompt_len, ctx=None):
    """The logits of ``eng``'s prefill of ``prompts`` (and ``ctx``) and of
    each decode step fed the generated ``tokens``, joined on the sequence
    dim."""
    logits, cache = eng.prefill(prompts, ctx)
    steps = [logits]
    for i in range(tokens.shape[1] - 1):
        tok = torch.from_numpy(tokens[:, i:i + 1]).cuda()
        logits, cache = eng.decode(tok, cache, prompt_len + i)
        steps.append(logits)
    return torch.cat(steps, 1)


def tp_serve_llama(torch, mesh, rank, counts, flash_attention):
    """26(a) on this rank: llama3.2-1b in f32 on the mesh against the
    meshless engine, then in bf16 its numbers and launches."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import attention
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    scfg = ServeConfig(batch=SERVE_B, max_len=SERVE_PROMPT + TP_NEW)
    f32 = configs.get_config(SERVE_ARCH, attn_impl="flash",
                             param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    twin = mesh_twin(torch, mesh, rank, f32, SERVE_B, SERVE_PROMPT,
                     TP_F32_NEW, SERVE_SEED)
    out = {f"f32_{k}": v for k, v in twin.items()}
    if rank == 0 and not (twin["tokens_equal"]
                          and twin["row_rel"] <= TP_F32_ROW_REL):
        raise AssertionError(f"26(a) f32 on the mesh against meshless: "
                             f"{out}")
    out["f32_s"] = time.perf_counter() - t0
    cfg = configs.get_config(SERVE_ARCH, attn_impl="flash")
    prompts = random_prompts(cfg.vocab_size, SERVE_B, SERVE_PROMPT,
                             torch.Generator(device="cuda").manual_seed(
                                 SERVE_SEED + 1))
    eng = ServingEngine(cfg, scfg, params=get_model(cfg).init(SERVE_SEED,
                                                             "cuda"),
                        device="cuda", mesh=mesh)
    torch.cuda.empty_cache()
    eng.generate(prompts, 2)
    shapes = []
    tap = CallTap(flash_attention)

    def spy(q, k, v, **kw):
        shapes.append((q.shape[2], k.shape[2]))
        return tap(q, k, v, **kw)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    attention.flash_attention = spy
    try:
        for c in counts:
            c.launches = 0
        tokens = eng.generate(prompts, TP_NEW)
        launches = {c.__name__: c.launches for c in counts}
    finally:
        attention.flash_attention = flash_attention
    st = eng.last_stats
    out.update(launches=launches, heads=sorted(set(shapes)),
               bf16_s=time.perf_counter() - t0,
               ttft_s=st["prefill_s"],
               decode_tps=SERVE_B * (TP_NEW - 1) / st["decode_s"],
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               finite=st["logits_finite"], tokens_shape=list(tokens.shape))
    want_heads = [(cfg.n_heads // TP_WORLD, cfg.n_kv_heads // TP_WORLD)]
    others = {k: n for k, n in launches.items()
              if k != flash_attention.__name__ and n}
    if launches[flash_attention.__name__] != cfg.n_layers or others \
            or out["heads"] != want_heads or not out["finite"]:
        raise AssertionError(f"26(a) bf16 on the mesh, rank {rank}: {out}")
    del eng
    if rank == 0:
        out["flash"] = time_flash(torch, flash_attention, tap.kept, 26,
                                  "on layer 0's local heads of the prefill "
                                  "on the (1, 2) mesh, rank 0")
    # the other rank waits here, so that it does not share the card with
    # the timing
    dist.barrier()
    del tap
    torch.cuda.empty_cache()
    return out


def tp_train_llama(torch, mesh, rank):
    """26(b) on this rank: one f32 llama3.2-1b step on the mesh (its loss)
    and its gradient blocks against the meshless step's, pooled and leaf
    by leaf (each against the meshless leaf cut to its block: a small
    leaf wrong by a factor would hide in the pooled norm)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.common import tree_items, tree_leaves, tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = configs.get_config(SERVE_ARCH, param_dtype="float32",
                             compute_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    batch = synth_batch(DataConfig(cfg.vocab_size, TP_TRAIN["batch"],
                                   TP_TRAIN["seq"]), 0, "cuda")
    st = trainer.init_train_state(cfg, opt, SERVE_SEED, "cuda")
    sh = trainer.state_shardings(cfg, mesh)
    placed = trainer.shard_state(
        {"params": st.params, "opt_state": st.opt_state},
        {"params": sh["params"], "opt_state": sh["opt_state"]})
    model = get_model(cfg)
    grads_of = trainer._grad_fn(model, 1)
    want_g, want_loss, _ = grads_of(st.params, batch)
    del st
    torch.cuda.empty_cache()
    step = trainer.make_train_step(cfg, opt, mesh)
    ms = step.pieces["mesh_step"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ms.context(batch, ms.dp):
        got_g, _, _ = grads_of(ms.local(placed["params"]), ms.rows(batch))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    blocks = tree_map(ms.block, want_g, sh["params"])
    sums = {"/".join(path): (float((a.double() - b.double()).square().sum()),
                             float(b.double().square().sum()))
            for (path, a), b in zip(tree_items(got_g), tree_leaves(blocks))}
    num = sum(n for n, _ in sums.values())
    den = sum(d for _, d in sums.values())
    leaf_rel = {k: (n / d) ** 0.5 if d > 0 else (0.0 if n == 0 else
                                                  float("inf"))
                for k, (n, d) in sums.items()}
    worst = sorted(leaf_rel, key=leaf_rel.get, reverse=True)
    split = sum(bool(ms.split_axes(t))
                for t in tree_leaves(placed["params"]))
    del want_g, got_g, blocks
    torch.cuda.empty_cache()
    _, _, metrics = step(placed["params"], placed["opt_state"], batch)
    loss = float(metrics["loss"])
    out = dict(loss=loss, want_loss=float(want_loss),
               loss_rel=abs(loss - float(want_loss)) / abs(float(want_loss)),
               grad_rel=(num / den) ** 0.5, split_leaves=split,
               leaf_rel_max=leaf_rel[worst[0]], worst_leaf=worst[0],
               worst_leaves={k: leaf_rel[k] for k in worst[:4]},
               n_leaves=len(leaf_rel),
               grad_s=grad_s, grad_norm=float(metrics["grad_norm"]))
    if not (out["loss_rel"] <= TP_LOSS_REL and out["grad_rel"] <= TP_GRAD_REL
            and out["leaf_rel_max"] <= TP_LEAF_REL and split > 0):
        raise AssertionError(f"26(b) rank {rank}: {out}")
    del placed, metrics
    torch.cuda.empty_cache()
    return out


def tp_random_params(torch, cfg, mesh, seed):
    """Random parameters from ``seed`` drawn straight into this rank's
    blocks, in the config's dtype, at the model builder's scales (ones for
    the norms, zeros for the biases, 0.02 for the embedding, else
    1/sqrt(fan in)): a leaf whose layer runs split is drawn as this rank's
    'model' block (a stream of its own per rank), any other leaf the same
    on both ranks. (The whole tree of maverick's cut does not fit on the
    card twice.)"""
    import math
    from repro_torch.models.common import tree_items
    from repro_torch.models.transformer import get_model, model_parallel_leaf
    from repro_torch.parallel import sharding as Sh
    model = get_model(cfg)
    shapes, axes = model.init(0, device="meta", with_axes=True)
    sh = dict(tree_items(Sh.param_shardings(axes, shapes, mesh)))
    ax = dict(tree_items(axes))
    mg = Sh.model_group_of(mesh)
    out = {}
    for i, (path, t) in enumerate(tree_items(shapes)):
        shape = list(t.shape)
        d = Sh.model_dim(sh[path].spec)
        split = d is not None and model_parallel_leaf(model, path, mg.size)
        if split:
            shape[d] //= mg.size
        name = path[-1]
        if name.startswith("ln") or "norm" in name:
            leaf = torch.ones(shape, dtype=cfg.pdt, device="cuda")
        elif name.startswith("b_"):
            leaf = torch.zeros(shape, dtype=cfg.pdt, device="cuda")
        else:
            gen = torch.Generator(device="cuda").manual_seed(
                seed * 1_000_003 + 2 * i + (mg.index if split else 0)
                * 1_000_000)
            dims = [n for n, a in zip(t.shape, ax[path]) if a != "layers"]
            scale = 0.02 if name == "embed" else 1.0 / math.sqrt(dims[0])
            leaf = torch.randn(shape, generator=gen, dtype=cfg.pdt,
                               device="cuda").mul_(scale)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out


def tp_experts(torch, mesh, rank, counts, flash_attention):
    """26(c) on this rank: the smoke MoE configs on the mesh against the
    meshless engine (routing, tokens, logits), then maverick at phase
    19's cut on the mesh."""
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import moe
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    route = moe.route
    out = {"twins": {}}
    S = MOE_TWIN_S
    for arch in TP_EP_ARCHS:
        cfg = configs.get_smoke_config(arch)
        params = get_model(cfg).init(MOE_SEED, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
        prompts = random_prompts(cfg.vocab_size, MOE_B, S, gen)
        scfg = ServeConfig(batch=MOE_B, max_len=S + MOE_NEW)
        runs = {}
        for name, m in (("mesh", mesh), ("meshless", None)):
            routes = []

            def spy(*a, **kw):
                r = route(*a, **kw)
                routes.append({k: r[k].cpu() for k in ("idx", "rank",
                                                       "keep")})
                return r

            eng = ServingEngine(cfg, scfg, params=params, device="cuda",
                                mesh=m)
            moe.route = spy
            try:
                tokens = eng.generate(prompts, MOE_NEW)
                logits = teacher_forced(torch, eng, prompts, tokens, S)
            finally:
                moe.route = route
            runs[name] = (tokens, logits, routes)
        (tm, lm, rm), (tw, lw, rw) = runs["mesh"], runs["meshless"]
        got = dict(routes=len(rm), routing_equal=len(rm) == len(rw) > 0
                   and all(torch.equal(a[k], b[k])
                           for a, b in zip(rm, rw) for k in a),
                   tokens_equal=bool(np.array_equal(tm, tw)),
                   row_rel=row_rel(lm, lw))
        if not (got["routing_equal"] and got["tokens_equal"]
                and got["row_rel"] <= TP_EP_ROW_REL):
            raise AssertionError(f"26(c) smoke {arch} rank {rank}: {got}")
        out["twins"][arch] = got
    arch = TP_EP_ARCHS[1]
    cfg = configs.get_config(arch, n_layers=MOE_LAYERS[arch],
                             attn_impl="flash")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = tp_random_params(torch, cfg, mesh, MOE_SEED)
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
    prompts = random_prompts(cfg.vocab_size, MOE_B, MOE_PROMPT, gen)
    eng = ServingEngine(cfg, ServeConfig(batch=MOE_B,
                                         max_len=MOE_PROMPT + MOE_NEW),
                        params=params, device="cuda", mesh=mesh)
    del params
    eng.generate(prompts, 2)
    for c in counts:
        c.launches = 0
    tokens = eng.generate(prompts, MOE_NEW)
    st = eng.last_stats
    out["maverick"] = dict(
        ttft_s=st["prefill_s"],
        decode_tps=MOE_B * (MOE_NEW - 1) / st["decode_s"],
        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
        finite=st["logits_finite"],
        launches={c.__name__: c.launches for c in counts},
        in_vocab=bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()))
    m = out["maverick"]
    if not (m["finite"] and m["in_vocab"] and np.isfinite(
            [m["ttft_s"], m["decode_tps"], m["peak_gib"]]).all()
            and m["launches"][flash_attention.__name__] == cfg.n_layers):
        raise AssertionError(f"26(c) maverick rank {rank}: {m}")
    del eng
    torch.cuda.empty_cache()
    return out


def rank_main(rank, init_file, out_dir, tag, timeout_s, parts,
              shape=(1, TP_WORLD)):
    """One rank of a multi-process phase (a spawned process): joins the
    gloo group (``file://`` rendezvous), builds the ``shape`` ("data" x
    "model") mesh on the card (the (1, 2) mesh unless given),
    runs each part ``(key, fn(torch, mesh, rank, counts))`` in turn and
    writes ``rank<r>.json``: each part's numbers and wall, or the
    traceback that stopped it, and when this function began
    (``entry``, the host's clock) and the seconds it took to reach the
    first part (``setup_s``: torch, the group, the mesh)."""
    entry = time.time()
    import datetime
    import faulthandler
    import traceback
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm_logpdf import gmm_logpdf
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.queue_scan import fused_admission, queue_scan
    from repro_torch.launch.mesh import make_mesh
    counts = (fused_admission, flash_attention, gmm_logpdf, mamba2_scan,
              queue_scan)
    torch.backends.cuda.matmul.allow_tf32 = False
    faulthandler.enable()       # a crash shows its Python stack on stderr
    result = {"walls": {}, "entry": entry}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=int(np.prod(shape)),
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        result["setup_s"] = time.time() - entry
        for key, fn in parts:
            t0 = time.perf_counter()
            result[key] = fn(torch, mesh, rank, counts)
            result["walls"][key] = time.perf_counter() - t0
            print(f"chip_smoke: phase {tag} rank {rank}: ({key}) done in "
                  f"{result['walls'][key]:.1f} s", file=sys.stderr,
                  flush=True)
    except BaseException:
        result["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_rank(rank, init_file, out_dir):
    """One rank of phase 26: (a)-(c)."""
    from repro_torch.kernels.flash_attention import flash_attention
    rank_main(rank, init_file, out_dir, "26", TP_TIMEOUT_S, (
        ("a", lambda torch, mesh, r, counts: tp_serve_llama(
            torch, mesh, r, counts, flash_attention)),
        ("b", lambda torch, mesh, r, counts: tp_train_llama(torch, mesh, r)),
        ("c", lambda torch, mesh, r, counts: tp_experts(
            torch, mesh, r, counts, flash_attention))))


def run_ranks(torch, target, timeout_s, tag, world=TP_WORLD):
    """``target(rank, init_file, out_dir)`` in ``world`` spawned
    processes, joined under ``timeout_s`` (a rank still running then is
    killed and the phase fails): each rank's ``rank<r>.json``, with
    ``spawn_s``, the seconds from the spawn to ``rank_main``'s start.
    Raises on a rank that hung, exited other than 0 or recorded an
    error."""
    import multiprocessing
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as d:
        procs = [ctx.Process(target=target, args=(
            r, os.path.join(d, "rendezvous"), d)) for r in range(world)]
        spawned = time.time()
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        results = []
        for r in range(world):
            path = os.path.join(d, f"rank{r}.json")
            results.append(json.load(open(path)) if os.path.exists(path)
                           else {"error": f"rank {r} wrote no result"})
    if hung:
        raise AssertionError(f"{tag}: {len(hung)} of {world} ranks still "
                             f"ran after {timeout_s:g} s: {results}")
    bad = [f"rank {r} (exit {p.exitcode}):\n{res.get('error')}"
           for r, (p, res) in enumerate(zip(procs, results))
           if "error" in res or p.exitcode != 0]
    if bad:
        raise AssertionError(f"{tag} " + "\n".join(bad))
    for res in results:
        res["spawn_s"] = res["entry"] - spawned
    return results


def log_rank_setup(tag, results, wall):
    """Where a two-process phase's wall went besides its parts: each
    rank's spawn (to ``rank_main``'s start) and set-up (torch, the group,
    the mesh), and its parts' sum."""
    log(f"[{tag}] set-up: " + "; ".join(
        f"rank {r} spawned in {res['spawn_s']:.1f} s, torch, group and "
        f"mesh {res['setup_s']:.1f} s, parts {sum(res['walls'].values()):.1f}"
        f" s" for r, res in enumerate(results)) + f" (the phase {wall:.1f} s)")


def phase_tp(torch, flash_attention):
    """Phase 26 within ``TP_BUDGET_S``: the two ranks in spawned
    processes, joined under ``TP_TIMEOUT_S`` (a rank still running then is
    killed and the phase fails). Returns rank 0's flash launches on (a)'s
    bf16 generation and its record on that path."""
    card = card_line()
    t26 = time.perf_counter()
    results = run_ranks(torch, tp_rank, TP_TIMEOUT_S, "26")
    for r, res in enumerate(results):
        a, b, c = res["a"], res["b"], res["c"]
        f32 = (f"the meshless engine's greedy tokens picked at every step, "
               f"logits within "
               f"{a['f32_row_rel']:.3g} of each row's norm (tol "
               f"{TP_F32_ROW_REL:g})" if r == 0 else "held on rank 0")
        log(f"[26] (a) rank {r}: {SERVE_ARCH} at full width on the (1, "
            f"{TP_WORLD}) mesh over gloo, {SERVE_B} x {SERVE_PROMPT} prompts, "
            f"{TP_NEW} new tokens; f32 ({TP_F32_NEW} new, "
            f"{a['f32_s']:.1f} s): {f32}; bf16 "
            f"({a['bf16_s']:.1f} s): time to first token "
            f"{a['ttft_s']:.4f} s, decode {a['decode_tps']:.1f} tokens/s, "
            f"peak {a['peak_gib']:.2f} GiB above the baseline, launches "
            f"{a['launches']}, flash on (query, KV) heads {a['heads']} "
            f"({res['walls']['a']:.1f} s)")
        log(f"[26] (b) rank {r}: one f32 training step at "
            f"{TP_TRAIN['batch']} x {TP_TRAIN['seq']}: loss {b['loss']:.6f} "
            f"against the meshless {b['want_loss']:.6f} (relative "
            f"{b['loss_rel']:.3g}, tol {TP_LOSS_REL:g}); its "
            f"{b['split_leaves']} 'model'-split gradient blocks and the "
            f"whole leaves within {b['grad_rel']:.3g} of their norm (tol "
            f"{TP_GRAD_REL:g}); leaf by leaf, each within its own norm, "
            f"the worst of {b['n_leaves']} {b['worst_leaf']} at "
            f"{b['leaf_rel_max']:.3g} (tol {TP_LEAF_REL:g}; the next "
            f"{b['worst_leaves']}); forward and backward {b['grad_s']:.3f} s; "
            f"grad norm {b['grad_norm']:.4f} ({res['walls']['b']:.1f} s)")
        twins = "; ".join(
            f"smoke {k}: {v['routes']} MoE calls routed equally, tokens "
            f"equal, logits within {v['row_rel']:.3g}"
            for k, v in c["twins"].items())
        mv = c["maverick"]
        log(f"[26] (c) rank {r}: {twins} (tol {TP_EP_ROW_REL:g}); "
            f"{TP_EP_ARCHS[1]} at {MOE_LAYERS[TP_EP_ARCHS[1]]} layers, bf16, "
            f"{MOE_B} x {MOE_PROMPT}, {MOE_NEW} new, experts split over "
            f"'model': time to first token {mv['ttft_s']:.4f} s, decode "
            f"{mv['decode_tps']:.1f} tokens/s, peak {mv['peak_gib']:.2f} GiB "
            f"above the baseline, launches {mv['launches']} "
            f"({res['walls']['c']:.1f} s)")
    log("[26] the collectives pass through the host (gloo on CUDA tensors, "
        "two processes on one card): these times are this harness's, not "
        "tensor parallelism's over NVLink")
    wall = time.perf_counter() - t26
    log_rank_setup("26", results, wall)
    within = "within" if wall <= TP_BUDGET_S else "OVER"
    log(f"[26] phase 26 in {wall:.1f} s ({within} its {TP_BUDGET_S:g} s "
        f"budget); card: {card}")
    a0 = results[0]["a"]
    return a0["launches"][flash_attention.__name__], a0["flash"]


def mesh_inputs(torch, cfg, batch, prompt, seed):
    """``batch`` prompts of ``prompt`` tokens and the ``ctx`` a family takes
    (the VLM's patches, the encoder-decoder's frames), from ``seed + 1``."""
    from repro_torch.launch.serve import random_ctx, random_prompts
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = random_prompts(cfg.vocab_size, batch, prompt, gen)
    return prompts, random_ctx(cfg, batch, gen)


def mesh_twin(torch, mesh, rank, cfg, batch, prompt, new, seed,
              place=None):
    """The f32 twin of phases 26(a), 27 and 28(b) on this rank: ``cfg``'s
    weights from ``seed`` (the xLSTM's sLSTM ``r`` at 1 / sqrt(hd):
    ``rescale_slstm_r``), the meshless engine's ``new`` greedy tokens and
    its logits on rank 0, the tokens broadcast; the mesh engine (given
    ``place(params)`` where ``place`` is given: DTensors placed on the
    mesh) fed those tokens (teacher-forced) must pick the same token at
    every step, so its own greedy run gives the same tokens. On rank 0:
    ``tokens_equal`` and the largest ``row_rel`` of its rows' logits over
    the vocabulary's columns (a padded head's -1e30 would swamp the rows'
    norms). The cache's length, ``prompt + new``, must be one the 'model'
    axis divides (the sequence splits into ``CacheBlock``s)."""
    import torch.distributed as dist
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    scfg = ServeConfig(batch=batch, max_len=prompt + new)
    params = get_model(cfg).init(seed, "cuda")
    if cfg.family == "ssm":
        # with the reference's 1 / sqrt(H) the f32 model is chaotic: a
        # 1e-7 nudge of its weights moves its logits 0.7 of a row's norm
        # by 128 tokens, 1.6e-05 at 1 / sqrt(hd)
        rescale_slstm_r(torch, params, cfg)
    prompts, ctx = mesh_inputs(torch, cfg, batch, prompt, seed)
    tok = torch.empty((batch, new), dtype=torch.int32, device="cuda")
    if rank == 0:
        eng = ServingEngine(cfg, scfg, params=params, device="cuda")
        tokens = eng.generate(prompts, new, ctx=ctx)
        want = teacher_forced(torch, eng, prompts, tokens, prompt, ctx)
        del eng
        tok.copy_(torch.from_numpy(tokens))
    dist.broadcast(tok, 0)
    tokens = tok.cpu().numpy()
    eng = ServingEngine(cfg, scfg, params=params if place is None
                        else place(params), device="cuda", mesh=mesh)
    got = teacher_forced(torch, eng, prompts, tokens, prompt, ctx)
    rows = eng.rows(torch.arange(batch)).numpy()
    del eng, params
    out = {}
    if rank == 0:
        v = cfg.vocab_size
        out = dict(tokens_equal=bool((got.argmax(-1).cpu().numpy()
                                      == tokens[rows]).all()),
                   row_rel=row_rel(got[..., :v], want[rows][..., :v]))
        del want
    del got
    torch.cuda.empty_cache()
    return out


def tpl_serve(torch, mesh, rank, counts, cfg, prompt, taps):
    """27's bf16 run of ``cfg`` on this rank: each rank's blocks drawn
    straight on the card (``tp_random_params``), 2 tokens to warm up, then
    ``TPL_NEW`` (the hybrid ``TPL_HYB_NEW``) with every kernel count set
    to 0 just before and read just
    after, through ``taps`` (``(module, name, CallTap)``: the kernel
    wrappers the model calls, keeping layer 0's inputs); the time to first
    token, decode tokens/s, peak GiB above the baseline and, for the
    encoder-decoder, its encoder's share of the time to first token."""
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    new = TPL_HYB_NEW if cfg.family == "hybrid" else TPL_NEW
    params = tp_random_params(torch, cfg, mesh, TPL_SEED)
    prompts, ctx = mesh_inputs(torch, cfg, TPL_B, prompt, TPL_SEED)
    eng = ServingEngine(cfg, ServeConfig(batch=TPL_B,
                                         max_len=prompt + new),
                        params=params, device="cuda", mesh=mesh)
    del params
    eng.generate(prompts, 2, ctx=ctx)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in taps]
    for mod, name, tap in taps:
        setattr(mod, name, tap)
    try:
        for c in counts:
            c.launches = 0
        tokens = eng.generate(prompts, new, ctx=ctx)
        launches = {c.__name__: c.launches for c in counts}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    st = eng.last_stats
    out = dict(ttft_s=st["prefill_s"],
               new=new, decode_tps=TPL_B * (new - 1) / st["decode_s"],
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               finite=st["logits_finite"], launches=launches,
               in_vocab=bool(((tokens >= 0)
                              & (tokens < cfg.vocab_size)).all()))
    if cfg.family == "audio":
        ms = eng._mesh.bind()
        model = get_model(cfg)
        # warm: the engine's prefills have just run the encoder on ctx
        with torch.no_grad(), ms.context():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(eng.params, ctx)
            torch.cuda.synchronize()
        out["encoder_s"] = time.perf_counter() - t0
        out["encoder_share"] = out["encoder_s"] / out["ttft_s"]
    del eng
    torch.cuda.empty_cache()
    return out


def tpl_case(torch, mesh, rank, counts, name, arch, over):
    """27's case ``name``: ``arch`` with ``over`` at full width (depth cut by
    ``TPL_LAYERS``), the f32 twin then the bf16 run, each checked; rank 0
    also holds the kernels its layer-0 inputs reached against their plain
    versions and times them (``mamba2_scan`` on its local heads, flash on
    the shared attention's or the decoder's)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.models import attention, ssm
    cfg = configs.get_config(arch, **TPL_LAYERS.get(arch, {}), **over)
    prompt = TPL_XLSTM_PROMPT if cfg.family == "ssm" else TPL_PROMPT
    f32 = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        **({"n_layers": TPL_HYB_TWIN_LAYERS} if cfg.family == "hybrid"
           else {}))
    t0 = time.perf_counter()
    out = {"twin": mesh_twin(torch, mesh, rank, f32, TPL_B, prompt,
                             TPL_F32_NEW, TPL_SEED)}
    out["twin_s"] = time.perf_counter() - t0
    if rank == 0 and not (out["twin"]["tokens_equal"]
                          and out["twin"]["row_rel"] <= TP_F32_ROW_REL):
        raise AssertionError(f"27 {name} f32 on the mesh against meshless: "
                             f"{out['twin']}")
    ftap, stap = CallTap(flash_attention), CallTap(mamba2_scan)
    taps = [(attention, "flash_attention", ftap), (ssm, "mamba2_scan", stap)]
    out.update(tpl_serve(torch, mesh, rank, counts, cfg, prompt, taps))
    want = {c.__name__: 0 for c in counts}
    if cfg.attn_impl == "flash":
        want["flash_attention"] = (cfg.n_layers // cfg.attn_every
                                   if cfg.family == "hybrid"
                                   else cfg.n_dec_layers)
    if cfg.ssm_impl == "mamba_kernel":
        want["mamba2_scan"] = cfg.n_layers
        out["ssd_x"] = list(stap.kept[0].shape)
    if ftap.kept is not None:
        out["flash_q"] = list(ftap.kept[0].shape)
        out["flash_kv"] = list(ftap.kept[1].shape)
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    if out["launches"] != want or not (out["finite"] and out["in_vocab"]) \
            or ("ssd_x" in out and out["ssd_x"][2] != heads // TP_WORLD):
        raise AssertionError(f"27 {name} bf16 on the mesh, rank {rank}: "
                             f"{out}, launches wanted {want}")
    if rank == 0:
        where = f"on layer 0's local heads of {arch}'s prefill on the " \
                f"(1, {TP_WORLD}) mesh, rank 0"
        if stap.kept is not None:
            out["ssd"] = time_ssd(torch, mamba2_scan, stap.kept, 27, where)
        if ftap.kept is not None:
            out["flash"] = time_flash(torch, flash_attention, ftap.kept, 27,
                                      where)
    # the other rank waits here, so that it does not share the card with
    # the timing
    dist.barrier()
    del ftap, stap
    torch.cuda.empty_cache()
    return out


def tpl_rank(rank, init_file, out_dir):
    """One rank of phase 27: each of ``TPL_CASES``."""
    rank_main(rank, init_file, out_dir, "27", TP_LAYERS_TIMEOUT_S, [
        (name, lambda torch, mesh, r, counts, name=name, arch=arch,
         over=over: tpl_case(torch, mesh, r, counts, name, arch, over))
        for name, arch, over in TPL_CASES])


def phase_tp_layers(torch):
    """Phase 27 within ``TP_LAYERS_BUDGET_S``: the two ranks of
    ``tpl_rank`` in spawned processes, joined under
    ``TP_LAYERS_TIMEOUT_S``. Returns rank 0's kernel records on the paths
    it timed: ``{"ssd": (launches, rec), "flash": [(path, launches,
    rec), ...]}``."""
    card = card_line()
    t27 = time.perf_counter()
    results = run_ranks(torch, tpl_rank, TP_LAYERS_TIMEOUT_S, "27")
    for r, res in enumerate(results):
        for name, arch, _ in TPL_CASES:
            c = res[name]
            twin = (f"f32 ({TPL_F32_NEW} new, {c['twin_s']:.1f} s) picks the "
                    f"meshless engine's "
                    f"greedy tokens, logits within "
                    f"{c['twin']['row_rel']:.3g} of each row's norm (tol "
                    f"{TP_F32_ROW_REL:g})" if r == 0 else "f32 held on "
                    "rank 0")
            extra = ""
            if "ssd_x" in c:
                extra += f", mamba2_scan on x {c['ssd_x']} (this rank's heads)"
            if "flash_q" in c:
                extra += (f", flash on q {c['flash_q']}, k/v "
                          f"{c['flash_kv']}")
            if "encoder_s" in c:
                extra += (f", the encoder alone {c['encoder_s']:.4f} s, "
                          f"{100 * c['encoder_share']:.1f} % of the time to "
                          "first token")
            prompt = TPL_XLSTM_PROMPT if arch == "xlstm-125m" else TPL_PROMPT
            log(f"[27] {name} rank {r}: {arch} at full width"
                f"{' (' + str(TPL_LAYERS[arch]) + ')' if arch in TPL_LAYERS else ''}"
                f" on the (1, {TP_WORLD}) mesh over gloo, {TPL_B} x {prompt} "
                f"prompts, {c['new']} new tokens; {twin}; bf16: time to first "
                f"token {c['ttft_s']:.4f} s, decode {c['decode_tps']:.1f} "
                f"tokens/s, peak {c['peak_gib']:.2f} GiB above the baseline, "
                f"launches {c['launches']}{extra} ({res['walls'][name]:.1f} "
                "s)")
    log("[27] the collectives pass through the host (gloo on CUDA tensors, "
        "two processes on one card): these times are this harness's, not "
        "tensor parallelism's over NVLink")
    wall = time.perf_counter() - t27
    log_rank_setup("27", results, wall)
    within = "within" if wall <= TP_LAYERS_BUDGET_S else "OVER"
    log(f"[27] phase 27 in {wall:.1f} s ({within} its "
        f"{TP_LAYERS_BUDGET_S:g} s budget); card: {card}")
    r0 = results[0]
    hyb, sea = r0["hybrid"], r0["seamless"]
    return {"ssd": (hyb["launches"]["mamba2_scan"], hyb["ssd"]),
            "flash": [
                (f"{HYB_ARCH} shared attention on the (1, {TP_WORLD}) mesh, "
                 "rank 0's heads", hyb["launches"]["flash_attention"],
                 hyb["flash"]),
                (f"seamless-m4t-large-v2 decoder self-attention on the (1, "
                 f"{TP_WORLD}) mesh, rank 0's heads",
                 sea["launches"]["flash_attention"], sea["flash"])]}


# ------------------------------------------------------------ phase 28

def fsdp_place(torch, cfg, mesh):
    """``place(params)``: whole parameters (the same on every rank) as
    DTensors placed by the reference's FSDP rules on ``mesh`` (``embed``
    on 'data'), each rank's blocks copied out of the whole leaves (so
    these are freed once the caller drops them)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.parallel import sharding as Sh
    shapes, axes = get_model(cfg).init(0, device="meta", with_axes=True)
    sh = Sh.param_shardings(axes, shapes, mesh, Sh.make_rules(
        fsdp=True, data_axes=Sh.dp_axes(mesh)))

    def one(t, s):
        d = Sh.distribute(t, s)
        return DTensor.from_local(d.to_local().detach().clone(), mesh,
                                  d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return lambda params: tree_map(one, params, sh)


def dptp_train(torch, mesh, rank, out_dir, shared):
    """28(a) on this rank: llama3.2-1b at full width, ``DP_TP_LAYERS``
    layers, f32, its state placed by FSDP on the (2, 2) mesh; one step on
    the global batch against the meshless step (each rank in turn runs it
    on the whole state, and keeps its blocks of the gradient and of the
    updated parameters): the loss, the pooled gradient, every leaf's
    gradient and updated parameter; each rank's peak above its baseline,
    the DP gather's counts and high-water mark. Then (d)'s save of the
    updated state from the mesh (into ``out_dir``), whose read-back
    (:func:`dptp_restore`) comes after (b) and (c): ``shared`` carries
    what it needs."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models.common import tree_items, tree_leaves, tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = configs.get_config(SERVE_ARCH, n_layers=DP_TP_LAYERS,
                             param_dtype="float32", compute_dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    batch = synth_batch(DataConfig(cfg.vocab_size, DP_TP_TRAIN["batch"],
                                   DP_TP_TRAIN["seq"]), 0, "cuda")
    step = trainer.make_train_step(cfg, opt, mesh, fsdp=True)
    ms, finish = step.pieces["mesh_step"], step.pieces["finish"]
    sh = ms.shardings
    laps, t0 = {}, time.perf_counter()
    st = trainer.init_train_state(cfg, opt, SERVE_SEED, "cuda")
    placed = trainer.shard_state(
        {"params": st.params, "opt_state": st.opt_state},
        {"params": sh["params"], "opt_state": sh["opt_state"]})
    # the blocks copied out of the whole leaves (and off their autograd
    # graph), so that these are freed below
    placed = tree_map(lambda t: t.__class__.from_local(
        t.to_local().detach().clone(), mesh, t.placements, run_check=False,
        shape=t.shape, stride=t.stride()), placed)
    laps["init_s"] = time.perf_counter() - t0
    # the meshless step, one rank at a time on the card
    want = {}
    for turn in range(DP_TP_WORLD):
        if rank == turn:
            grads, loss, _ = trainer._grad_fn(get_model(cfg), 1)(st.params,
                                                                batch)
            new_p, new_opt, m = adamw.apply_updates(opt, st.params, grads,
                                                    st.opt_state)
            del new_opt
            want = dict(loss=float(loss), grad_norm=float(m["grad_norm"]),
                        grads=tree_map(ms.block, grads, sh["params"]),
                        params=tree_map(ms.block, new_p, sh["params"]))
            want["grads"] = tree_map(lambda t: t.clone(), want["grads"])
            want["params"] = tree_map(lambda t: t.detach().clone(),
                                      want["params"])
            del grads, new_p, m
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    laps["meshless_s"] = time.perf_counter() - t0 - laps["init_s"]
    del st
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    ms.gather.reset()
    with ms.context(batch, ms.dp):
        grads, loss, metrics = trainer._grad_fn(get_model(cfg), 1)(
            ms.local(placed["params"]), ms.rows(batch))
    ms.gather.forget()
    new_p, new_opt, metrics = finish(placed["params"], placed["opt_state"],
                                     grads, loss, metrics)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    counts = ms.gather.counts()
    sums = {}
    for (path, g), w, p, q in zip(tree_items(grads),
                                  tree_leaves(want["grads"]),
                                  tree_leaves(new_p), tree_leaves(
                                      want["params"])):
        k = "/".join(path)
        sums[k] = tuple(float(x) for x in (
            (g.double() - w.double()).square().sum(),
            w.double().square().sum(),
            (p.to_local().double() - q.double()).square().sum(),
            q.double().square().sum()))

    def rel(n, d):
        return (n / d) ** 0.5 if d > 0 else (0.0 if n == 0 else float("inf"))

    leaf = {k: rel(v[0], v[1]) for k, v in sums.items()}
    upd = {k: rel(v[2], v[3]) for k, v in sums.items()}
    worst = max(leaf, key=leaf.get)
    worst_p = max(upd, key=upd.get)
    out = dict(loss=float(metrics["loss"]), want_loss=want["loss"],
               grad_norm=float(metrics["grad_norm"]),
               want_grad_norm=want["grad_norm"],
               grad_rel=rel(sum(v[0] for v in sums.values()),
                            sum(v[1] for v in sums.values())),
               leaf_rel_max=leaf[worst], worst_leaf=worst,
               param_rel_max=upd[worst_p], worst_param=worst_p,
               n_leaves=len(leaf), step_s=step_s, peak_gib=peak, **laps,
               base_gib=base / 2**30, gather=counts,
               held=sum(t.to_local().numel() for t in tree_leaves(new_p))
               / sum(t.numel() for t in tree_leaves(new_p)))
    out["loss_rel"] = abs(out["loss"] - out["want_loss"]) / abs(
        out["want_loss"])
    out["grad_norm_rel"] = abs(out["grad_norm"] - out["want_grad_norm"]) \
        / out["want_grad_norm"]
    if not (out["loss_rel"] <= TP_LOSS_REL and out["grad_rel"] <= TP_GRAD_REL
            and out["grad_norm_rel"] <= TP_GRAD_REL
            and out["leaf_rel_max"] <= TP_LEAF_REL
            and out["param_rel_max"] <= TP_LEAF_REL
            and counts["gathers"] > 0 and counts["reduce_scatters"] > 0):
        raise AssertionError(f"28(a) rank {rank}: {out}")
    del grads, want, placed, metrics
    torch.cuda.empty_cache()
    # what the rank holds at rest after the step: its blocks of the updated
    # parameters and moments (and the batch), against the whole state
    whole = sum(t.numel() * t.element_size()
                for t in tree_leaves({"p": new_p, "o": new_opt}))
    out.update(rest_gib=torch.cuda.memory_allocated() / 2**30,
               whole_gib=whole / 2**30)
    if out["rest_gib"] > REST_SHARE_MAX * out["whole_gib"]:
        raise AssertionError(f"28(a) rank {rank}: {out}")
    # (d)'s save: the gathers now, rank 0's write on its thread while (b)
    # and (c) run (dptp_restore waits for it)
    t0 = time.perf_counter()
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    state = {"params": new_p, "opt_state": new_opt}
    mgr.save(1, state)
    shared.update(mgr=mgr, save_s=time.perf_counter() - t0,
                  blocks=tree_map(lambda t: t.to_local().cpu(), state),
                  whole=tree_map(lambda t: torch.empty(
                      t.shape, dtype=t.dtype, device="meta"), state),
                  where={"params": sh["params"],
                         "opt_state": sh["opt_state"]}, block=ms.block)
    return out


def dptp_restore(torch, rank, shared):
    """28(d) on this rank: (a)'s state, saved from the (2, 2) mesh, read
    back onto no mesh (the host) once its write has ended, this rank's
    blocks bit for bit."""
    from repro_torch.models.common import tree_leaves, tree_map
    mgr = shared["mgr"]
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    back = mgr.restore(1, tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="cpu"), shared["whole"]))
    same = all(torch.equal(shared["block"](b, w), t) for b, t, w in zip(
        tree_leaves(back), tree_leaves(shared["blocks"]),
        tree_leaves(shared["where"])))
    out = dict(same=same, save_s=shared["save_s"], wait_s=wait_s,
               restore_s=time.perf_counter() - t0 - wait_s,
               gib=sum(t.numel() * t.element_size()
                       for t in tree_leaves(back)) / 2**30)
    if not same:
        raise AssertionError(f"28(d) rank {rank}: {out}")
    shared.clear()
    return out


def dptp_serve(torch, mesh, rank, counts, flash_attention):
    """28(b) on this rank: llama3.2-1b with its parameters placed by FSDP
    on the (2, 2) mesh: in f32 at ``DP_TP_LAYERS`` layers fed the meshless
    engine's greedy tokens (``mesh_twin``), then at full width and depth
    in bf16 its numbers, its DP gathers and its launches (flash once per
    layer per prefill, on this rank's 2 rows and 16 of 32 heads); rank 0
    holds flash on its layer-0 input and times it."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import attention
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    f32 = configs.get_config(SERVE_ARCH, n_layers=DP_TP_LAYERS,
                             attn_impl="flash", param_dtype="float32",
                             compute_dtype="float32")
    t0 = time.perf_counter()
    twin = mesh_twin(torch, mesh, rank, f32, SERVE_B, SERVE_PROMPT,
                     DP_TP_F32_NEW, SERVE_SEED, fsdp_place(torch, f32, mesh))
    out = {f"f32_{k}": v for k, v in twin.items()}
    if rank == 0 and not (twin["tokens_equal"]
                          and twin["row_rel"] <= TP_F32_ROW_REL):
        raise AssertionError(f"28(b) f32 on the (2, 2) mesh against "
                             f"meshless: {out}")
    out["f32_s"] = time.perf_counter() - t0
    cfg = configs.get_config(SERVE_ARCH, attn_impl="flash")
    prompts = random_prompts(cfg.vocab_size, SERVE_B, SERVE_PROMPT,
                             torch.Generator(device="cuda").manual_seed(
                                 SERVE_SEED + 1))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = fsdp_place(torch, cfg, mesh)(get_model(cfg).init(SERVE_SEED,
                                                               "cuda"))
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, ServeConfig(batch=SERVE_B,
                                         max_len=SERVE_PROMPT + DP_TP_NEW),
                        params=params, device="cuda", mesh=mesh)
    del params
    rest = torch.cuda.memory_allocated() - base
    eng.generate(prompts, 1)
    shapes = []
    tap = CallTap(flash_attention)

    def spy(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return tap(q, k, v, **kw)

    gather = eng._mesh.gather
    t0 = time.perf_counter()
    attention.flash_attention = spy
    try:
        for c in counts:
            c.launches = 0
        gather.reset()
        tokens = eng.generate(prompts, DP_TP_NEW)
        launches = {c.__name__: c.launches for c in counts}
    finally:
        attention.flash_attention = flash_attention
    st = eng.last_stats
    out.update(launches=launches, shapes=sorted(set(shapes)),
               bf16_s=time.perf_counter() - t0, ttft_s=st["prefill_s"],
               decode_tps=SERVE_B * (DP_TP_NEW - 1) / st["decode_s"],
               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               rest_gib=rest / 2**30, gather=gather.counts(),
               finite=st["logits_finite"], tokens_shape=list(tokens.shape))
    rows = SERVE_B // DP_TP_SHAPE[0]
    heads = (cfg.n_heads // DP_TP_SHAPE[1], cfg.n_kv_heads // DP_TP_SHAPE[1])
    want = [((rows, SERVE_PROMPT, heads[0], cfg.hd),
             (rows, SERVE_PROMPT, heads[1], cfg.hd))]
    others = {k: n for k, n in launches.items()
              if k != flash_attention.__name__ and n}
    if launches[flash_attention.__name__] != cfg.n_layers or others \
            or [tuple(map(tuple, x)) for x in out["shapes"]] != want \
            or not out["finite"] or out["gather"]["gathers"] == 0:
        raise AssertionError(f"28(b) bf16 on the (2, 2) mesh, rank {rank}: "
                             f"{out}")
    del eng
    if rank == 0:
        out["flash"] = time_flash(torch, flash_attention, tap.kept, 28,
                                  "on layer 0's local rows and heads of the "
                                  "prefill on the (2, 2) mesh, rank 0")
    # the other ranks wait here, so that none shares the card with the
    # timing
    dist.barrier()
    del tap
    torch.cuda.empty_cache()
    return out


def routing_by_copy(r):
    """One MoE call's routing in copy order (token-major, k copies each):
    ``idx`` and each copy's rank within its expert and whether it is kept,
    on the host."""
    out = {"idx": r["idx"].reshape(-1).cpu()}
    for key in ("rank", "keep"):
        v = r[key].new_empty(r[key].shape)
        v[r["order"]] = r[key]
        out[key] = v.cpu()
    return out


def dptp_experts(torch, mesh, rank):
    """28(c) on this rank: the smoke MoE configs served on the (2, 2) mesh
    (each DP rank routes its rows through the c10d ``TokenGroup``) and
    meshless: each MoE call's routing, the DP ranks' copies joined in row
    order, equal to the meshless call's exactly; greedy tokens equal;
    this rank's rows' logits within ``TP_EP_ROW_REL`` of each row's
    norm."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models import moe
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    route = moe.route
    data = mesh.get_group("data")
    out = {}
    for arch in TP_EP_ARCHS:
        cfg = configs.get_smoke_config(arch)
        params = get_model(cfg).init(MOE_SEED, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
        prompts = random_prompts(cfg.vocab_size, MOE_B, MOE_TWIN_S, gen)
        scfg = ServeConfig(batch=MOE_B, max_len=MOE_TWIN_S + MOE_NEW)
        runs = {}
        for name, m in (("mesh", mesh), ("meshless", None)):
            routes = []

            def spy(*a, **kw):
                r = route(*a, **kw)
                routes.append(routing_by_copy(r))
                return r

            eng = ServingEngine(cfg, scfg, params=params, device="cuda",
                                mesh=m)
            moe.route = spy
            try:
                tokens = eng.generate(prompts, MOE_NEW)
                logits = teacher_forced(torch, eng, prompts, tokens,
                                        MOE_TWIN_S)
            finally:
                moe.route = route
            runs[name] = (tokens, logits, routes,
                          eng.rows(torch.arange(MOE_B)).numpy())
        (tm, lm, rm, rows), (tw, lw, rw, _) = runs["mesh"], runs["meshless"]
        joined = []
        for call in rm:
            every = [None] * DP_TP_SHAPE[0]
            dist.all_gather_object(every, call, group=data)
            joined.append({k: torch.cat([e[k] for e in every])
                           for k in call})
        got = dict(routes=len(rm),
                   routing_equal=len(joined) == len(rw) > 0 and all(
                       torch.equal(a[k], b[k])
                       for a, b in zip(joined, rw) for k in a),
                   tokens_equal=bool(np.array_equal(tm, tw)),
                   row_rel=row_rel(lm, lw[rows]))
        if not (got["routing_equal"] and got["tokens_equal"]
                and got["row_rel"] <= TP_EP_ROW_REL):
            raise AssertionError(f"28(c) smoke {arch} rank {rank}: {got}")
        out[arch] = got
        del params
    torch.cuda.empty_cache()
    return out


def dptp_rank(rank, init_file, out_dir):
    """One rank of phase 28: (a) (and (d)'s save), (b), (c), then (d)'s
    read-back, on the (2, 2) mesh."""
    from repro_torch.kernels.flash_attention import flash_attention
    shared = {}
    rank_main(rank, init_file, out_dir, "28", DP_TP_TIMEOUT_S, (
        ("a", lambda torch, mesh, r, counts: dptp_train(torch, mesh, r,
                                                        out_dir, shared)),
        ("b", lambda torch, mesh, r, counts: dptp_serve(
            torch, mesh, r, counts, flash_attention)),
        ("c", lambda torch, mesh, r, counts: dptp_experts(torch, mesh, r)),
        ("d", lambda torch, mesh, r, counts: dptp_restore(torch, r,
                                                          shared))),
        shape=DP_TP_SHAPE)


def phase_dp_tp(torch, flash_attention):
    """Phase 28 within ``DP_TP_BUDGET_S``: the four ranks of ``dptp_rank``
    in spawned processes, joined under ``DP_TP_TIMEOUT_S``. Returns rank
    0's flash launches on (b)'s bf16 generation and its record there."""
    card = card_line()
    t28 = time.perf_counter()
    results = run_ranks(torch, dptp_rank, DP_TP_TIMEOUT_S, "28",
                        world=DP_TP_WORLD)
    mesh = f"{DP_TP_SHAPE} ('data' x 'model') mesh over gloo"
    for r, res in enumerate(results):
        a, b, c = res["a"], res["b"], res["c"]
        g = a["gather"]
        log(f"[28] (a) rank {r}: {SERVE_ARCH} at full width, "
            f"{DP_TP_LAYERS} layers, f32, FSDP on the {mesh}, one step at "
            f"{DP_TP_TRAIN['batch']} x {DP_TP_TRAIN['seq']} "
            f"({a['step_s']:.3f} s): loss {a['loss']:.6f} against the "
            f"meshless {a['want_loss']:.6f} (relative {a['loss_rel']:.3g}, "
            f"tol {TP_LOSS_REL:g}); grad norm {a['grad_norm']:.6f} against "
            f"{a['want_grad_norm']:.6f} ({a['grad_norm_rel']:.3g}); the "
            f"gradient blocks pooled within {a['grad_rel']:.3g} (tol "
            f"{TP_GRAD_REL:g}), leaf by leaf the worst of {a['n_leaves']} "
            f"{a['worst_leaf']} at {a['leaf_rel_max']:.3g}, the updated "
            f"parameters' worst {a['worst_param']} at "
            f"{a['param_rel_max']:.3g} (tol {TP_LEAF_REL:g}); holds "
            f"{100 * a['held']:.2f} % of the parameters and "
            f"{a['rest_gib']:.3f} GiB at rest after the step (the whole "
            f"state {a['whole_gib']:.3f} GiB; most {REST_SHARE_MAX:g} of "
            f"it); peak "
            f"{a['peak_gib']:.3f} GiB above its baseline of "
            f"{a['base_gib']:.3f} GiB (the whole state drawn and placed in "
            f"{a['init_s']:.1f} s, the meshless steps in turn "
            f"{a['meshless_s']:.1f} s); DP gathers per step: forward "
            f"{g['gathers']} ({g['gathered_bytes'] / 2**30:.3f} GiB), "
            f"backward {g['regathers']} ({g['regathered_bytes'] / 2**30:.3f}"
            f" GiB: the remat's recompute and the saved blocks), "
            f"reduce-scatters {g['reduce_scatters']} "
            f"({g['scattered_bytes'] / 2**30:.3f} GiB), the most gathered "
            f"at once {g['high_bytes'] / 2**30:.4f} GiB")
        k = res["d"]
        log(f"[28] (d) rank {r}: (a)'s state ({k['gib']:.2f} GiB) saved "
            f"from the mesh (the gathers and rank 0's host copy "
            f"{k['save_s']:.2f} s in (a), {res['walls']['a']:.1f} s; its "
            f"write ended {k['wait_s']:.2f} s after (c)) and read back onto "
            f"the host in {k['restore_s']:.2f} s, this rank's blocks bit "
            f"for bit ({res['walls']['d']:.1f} s)")
        f32 = (f"the meshless engine's greedy tokens picked at every step, "
               f"logits within {b['f32_row_rel']:.3g} of each row's norm "
               f"(tol {TP_F32_ROW_REL:g})" if r == 0 else "held on rank 0")
        gb = b["gather"]
        log(f"[28] (b) rank {r}: {SERVE_ARCH} with its parameters placed by "
            f"FSDP on the {mesh}, {SERVE_B} x {SERVE_PROMPT} prompts; f32 at "
            f"{DP_TP_LAYERS} layers ({DP_TP_F32_NEW} new, {b['f32_s']:.1f} "
            f"s): "
            f"{f32}; bf16 at full depth, {DP_TP_NEW} new "
            f"({b['bf16_s']:.1f} s): time to first token {b['ttft_s']:.4f} "
            f"s, decode {b['decode_tps']:.2f} tokens/s, peak "
            f"{b['peak_gib']:.3f} GiB above the baseline ({b['rest_gib']:.3f}"
            f" GiB at rest), DP gathers {gb['gathers']} "
            f"({gb['gathered_bytes'] / 2**30:.3f} GiB, the most at once "
            f"{gb['high_bytes'] / 2**20:.1f} MiB), launches {b['launches']}, "
            f"flash on (q, k/v) {b['shapes']} ({res['walls']['b']:.1f} s)")
        log(f"[28] (c) rank {r}: " + "; ".join(
            f"smoke {arch}: {v['routes']} MoE calls, the DP ranks' routing "
            f"joined equal to the meshless, tokens equal, logits within "
            f"{v['row_rel']:.3g}" for arch, v in c.items())
            + f" (tol {TP_EP_ROW_REL:g}; {res['walls']['c']:.1f} s)")
    log("[28] every gather and decode step passes through the host (gloo on "
        "CUDA tensors, four processes on one card): these times are this "
        "harness's, not FSDP's over NVLink")
    wall = time.perf_counter() - t28
    log_rank_setup("28", results, wall)
    within = "within" if wall <= DP_TP_BUDGET_S else "OVER"
    log(f"[28] phase 28 in {wall:.1f} s ({within} its {DP_TP_BUDGET_S:g} s "
        f"budget); card: {card}")
    b0 = results[0]["b"]
    return b0["launches"][flash_attention.__name__], b0["flash"]


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


class PhaseClock:
    """Each phase's wall, from the end of the phase before (``lap``). Each
    lap is also written to standard error, so that a run stopped from
    outside shows there how far it got and when."""

    def __init__(self):
        self.laps = []
        self._t0 = self._t = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        self.laps.append((name, now - self._t))
        self._t = now
        print(f"chip_smoke: phase {name} done in {self.laps[-1][1]:.1f} s, "
              f"{now - self._t0:.1f} s since the start", file=sys.stderr,
              flush=True)


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
    clock = PhaseClock()
    card = card_line()
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"[1] card: {card}")
    build_kernels(_build)
    t0 = time.perf_counter()
    inputs = build_ensemble()
    log(f"[1] workloads and scenarios built on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    clock.lap("1")

    grid_err = phase_kernels(torch, fused_admission, admission_mask_dense)
    clock.lap("2")
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
    clock.lap("3")
    single = phase_single(torch, fused_admission, inputs, ens)
    clock.lap("4")

    flash_grid_err = phase_flash_grid(torch, flash_attention)
    clock.lap("5")
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
    clock.lap("6")

    gmm_grid_err = phase_gmm_grid(torch, gmm_logpdf)
    clock.lap("7")
    fit, kept_gmm = phase_fit_path(torch, gmm_logpdf, fused_admission,
                                   flash_attention)
    grec = time_gmm(torch, gmm_logpdf, kept_gmm)
    log(f"[8] gmm_logpdf: {fit['launches']} launches x {grec['ms']:.6f} ms "
        f"= {100 * fit['launches'] * grec['ms'] / (fit['em_s'] * 1e3):.2f} % "
        "of the EM's wall on the card")
    clock.lap("8")

    ssd_grid_err = phase_ssd_grid(torch, mamba2_scan)
    clock.lap("9")
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
    clock.lap("10")
    hserve_flash_err = phase_hybrid_serving(torch, flash_attention, counts)
    clock.lap("11")
    queue_launches, qrec = phase_queue_sweep(torch, queue_scan, counts)
    clock.lap("12")
    oracle_card = phase_engine_oracle(torch, counts)
    clock.lap("13")
    fs_launches, fsrec, fs_kw, fso_card = phase_fullstack(
        torch, fused_admission, admission_mask_dense, counts)
    clock.lap("14")
    t15 = time.perf_counter()
    ca_launches, carec, _ = phase_compaction(
        torch, fused_admission, admission_mask_dense, counts, inputs, ens,
        wall)
    st_launches, strec, _ = phase_stream(torch, fused_admission,
                                         admission_mask_dense, counts)
    phase_stream_oracle(torch, counts)
    log(f"[15] phase 15 in {time.perf_counter() - t15:.1f} s")
    clock.lap("15")
    cells = early_cell_count()
    try:
        train_llama = phase_training(torch, counts, flash_attention,
                                     mamba2_scan)
        torch.cuda.empty_cache()
        clock.lap("16")
        if cells is None:
            cells = CellCount()
        dense_paths = phase_cost_model(torch, counts, flash_attention,
                                       train_llama, cells)
        clock.lap("17")
        phase_audit(torch, fs_kw)
        clock.lap("18")
        moe_path = phase_moe(torch, counts, flash_attention)
        clock.lap("19")
        cross_paths = phase_cross(torch, counts, flash_attention)
        clock.lap("20")
        phase_xlstm(torch, counts, fused_admission)
        clock.lap("21")
        phase_heap_engine(inputs, ens, wall, single, oracle_card, fso_card)
        clock.lap("22")
        phase_mesh(torch, counts, train_llama)
        clock.lap("23")
        mesh_launches, mesh_frec = phase_mesh_serving(torch, counts,
                                                      flash_attention)
        clock.lap("24")
        # 17(a)'s cells stay until here: the accelerator-platform example
        # reads its catalog from them
        phase_examples(torch, counts, cells.root)
        clock.lap("25")
        tp_launches, tp_frec = phase_tp(torch, flash_attention)
        clock.lap("26")
        tpl = phase_tp_layers(torch)
        clock.lap("27")
        dptp_launches, dptp_frec = phase_dp_tp(torch, flash_attention)
        clock.lap("28")
    finally:
        if cells is not None:
            cells.close()

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
                        *(rec["max_abs_err"] for _, _, rec in
                          dense_paths + cross_paths + tpl["flash"]),
                        moe_path[2]["max_abs_err"], mesh_frec["max_abs_err"],
                        tp_frec["max_abs_err"], dptp_frec["max_abs_err"]),
        **both_paths([("llama prefill", flash_launches, frec),
                      ("hybrid forward", hyb["flash_launches"], hfrec)]
                     + dense_paths + [moe_path] + cross_paths
                     + [("llama prefill on the (1, 1) mesh", mesh_launches,
                         mesh_frec),
                        ("llama prefill on the (1, 2) mesh, rank 0's heads",
                         tp_launches, tp_frec)] + tpl["flash"]
                     + [("llama prefill on the (2, 2) mesh with FSDP, rank "
                         "0's rows and heads", dptp_launches, dptp_frec)])),
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
        max_abs_err=max(ssd_grid_err, srec["max_abs_err"],
                        tpl["ssd"][1]["max_abs_err"]),
        **both_paths([("hybrid forward", hyb["ssd_launches"], srec),
                      (f"{HYB_ARCH} prefill on the (1, 2) mesh, rank 0's "
                       "heads", *tpl["ssd"])],
                     keys=("ms", "cuda_core_ms", "plain_ms", "bound_ms")),
        library_ms=None), dict(
        name="queue_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/queue_scan.cu",
        replaces="src/repro/kernels/queue_scan.py:65",
        launches=queue_launches, max_abs_err=qrec["max_abs_err"],
        ms=qrec["ms"], plain_ms=qrec["plain_ms"], bound_ms=qrec["bound_ms"],
        bound_by=qrec["bound_by"], library_ms=None)]
    log("[done] launches x (ms - bound_ms) on each kernel's path: " + ", ".join(
        f"{k['name']} {k['launches'] * (k['ms'] - k['bound_ms']):.3f} ms"
        for k in kernels))
    log("[done] phase walls: " + ", ".join(
        f"{name} {secs:.1f} s" for name, secs in clock.laps))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
