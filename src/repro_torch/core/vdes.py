"""Batched discrete-event engine in PyTorch (mirrors :mod:`repro.core.vdes`).

State is a struct-of-tensors over ``[R, N]`` (replicas x pipelines). Each
loop iteration — a **wave** — advances every replica's clock to its next
event time and retires *all* events at that instant, in up to six stages:

  1. **event selection** (``_select_events``): the next-event time
     ``t_star [R]`` is the minimum over pending task events, the next
     scheduled capacity change, the next reliability event and the next
     controller, fleet and probe ticks;
  2. **completion/retry** (``_completion_stage``): finishes release slots,
     successful attempts advance the pipeline, failed attempts re-enter the
     arrival path after a deterministic bounded exponential backoff
     ``min(base * mult**k, cap)``; arrivals and successor tasks enqueue;
  3. **control** (``_control_stage``): the pending piecewise-constant
     capacity change applies (a decrease never preempts: free goes
     negative and admission stalls until jobs drain), then the pending
     *reliability event* (a pre-sampled outage / repair / eviction capacity
     delta, recorded into ``rel_act``), then the *closed-loop controller*
     observes the live queue lengths and moves capacity (each integer-target
     move recorded into ``ctrl_act``);
  4. **admission** (``_admission_stage``): one ranked admission round per
     resource, by the hand-written CUDA kernel
     :func:`repro_torch.kernels.queue_scan.fused_admission`
     (``admission_sort="kernel"``), its plain version
     (``admission_sort="dense"``), or the reference's sort-based rankings
     (``"fused"``: one stable sort of a packed int64 key,
     :func:`admission_order`; ``"chained"``: three stable argsorts,
     :func:`admission_order_chained`) and the seat test over the sorted
     resources (:func:`admission_mask_ranked`), all four bit for bit
     equal;
  5. **fleet** (``_fleet_stage``, optional): the model lifecycle (Fig 7).
     Retraining pipelines that completed this wave redeploy their model; at
     drift-evaluation ticks the ``[R, M]`` drift algebra runs, and triggers
     crossing their threshold activate latent pipelines of a preallocated
     retraining pool;
  6. **probe** (``_probe_stage``, optional): at probe ticks the settled
     post-wave state is sampled into an ``[R, E, K]`` f32 buffer.

A stage that is off costs nothing: it is gated in Python, so a run without
controller, reliability, fleet or probe issues exactly the ops of the four
stages. All-zero controller/trigger/probe rows and ``INF``-padded
reliability rows are inert, as in the reference.

**Segment-restart hooks** (for the compaction and streaming drivers,
:mod:`repro_torch.core.compaction` and :mod:`repro_torch.stream`):
``resume`` adopts a carry returned by an earlier ``return_state=True`` call
(perhaps gathered or extended by a driver) in place of the fresh state;
``wave_budget [R]`` and ``time_budget [R]`` stop a replica before a wave
past its budget. Both budgets live on the device and join the per-replica
``active`` mask, so they add no host read inside a segment. A wave
boundary is a consistent cut: the carry is the loop's whole state, and a
cut-and-resumed run equals one call bit for bit.

**The replica axis.** The reference writes one replica and ``jax.vmap``s a
``lax.while_loop`` over it. The batched loop runs until every replica is
finished, and a finished replica is frozen: its state, its wave counter and
tick grids included, stops changing. Here the replica axis is written out:
each wave evaluates the loop condition per replica into an ``active [R]``
mask, computes the stages for all replicas, and commits each state field
with ``torch.where(active, new, old)``. The host reads the mask only every
``sync_every`` waves; the waves a finished batch runs past its end are
inert, so the outputs do not depend on ``sync_every``.

**Exactness.** Times are float32, as in the reference. Every product is
rounded on its own (separate eager ops: no ``torch.compile``, no custom
kernel for the stage arithmetic, which would contract ``a + b*c`` into an
FMA), reductions that feed f32 state are order-independent (min/max,
integer counts, or a sum with at most one nonzero term), and the fleet's
redeploy gains add in slot order, so on integer-time workloads the outputs
equal the reference engines' bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.des import (CTRL_INF, CTRL_INTERVAL, FLEET_ACT_REDEPLOY,
                                  FLEET_ACT_TRIGGER, POLICY_FIFO,
                                  POLICY_PRIORITY, POLICY_SJF, PROBE_INTERVAL,
                                  PROBE_N_MODELS, PROBE_T_END, PROBE_T_FIRST,
                                  TRIG_COOLDOWN, TRIG_DELAY, TRIG_FIELDS,
                                  TRIG_INTERVAL, TRIG_T_END, TRIG_T_FIRST,
                                  TRIG_THRESHOLD, _tick_bound_walk,
                                  probe_channel_count, unpack_controller)
from repro_torch.core.metrics import (FLEET_PERF0, fleet_staleness,
                                      performance_from_terms, seasonal_terms)
from repro_torch.device import resolve_device
from repro_torch.kernels.queue_scan import fused_admission
from repro_torch.kernels.ref import admission_mask_dense

INF = float(CTRL_INF)   # the ONE shared f32 "never" sentinel

# phases
_NOT_ARRIVED, _QUEUED, _RUNNING, _DONE = 0, 1, 2, 3

_NO_RETRY_BACKOFF = (0.0, 2.0, 3600.0)

ADMISSION_SORTS = ("kernel", "dense", "fused", "chained")
PKEY_BITS = 32      # the fused key's policy-key field: f32's bits


def fused_key_widths(n_res: int) -> tuple:
    """``(resource bits, enq_wave bits)`` of the fused ranking's int64 key:
    from the top, the resource (``0 .. n_res``, the sentinel included),
    the policy key's ``PKEY_BITS`` and the enqueue wave in what is left of
    63 bits. Raises ``ValueError``, naming the widths, where no bit is
    left for the wave."""
    rbits = int(n_res).bit_length()
    wbits = 63 - PKEY_BITS - rbits
    if wbits < 1:
        raise ValueError(
            f"the fused admission key does not fit 63 bits: {rbits} "
            f"resource bits (n_res={n_res}) + {PKEY_BITS} pkey bits leave "
            f"{wbits} for enq_wave; use admission_sort='chained'")
    return rbits, wbits


def _canonical_pkey(pkey: torch.Tensor) -> torch.Tensor:
    """-0.0 as +0.0 and every NaN as the one quiet NaN, as JAX's sort
    comparator canonicalizes float keys (a radix sort would order -0.0
    before +0.0)."""
    pkey = torch.where(pkey == 0, 0.0, pkey)
    return torch.where(torch.isnan(pkey), float("nan"), pkey)


def _ordered_bits(pkey: torch.Tensor) -> torch.Tensor:
    """The order-preserving image of f32 ``pkey`` in ``[0, 2**32)`` (int64):
    a negative float's bits inverted, a positive one's sign bit set."""
    b = _canonical_pkey(pkey).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, ~b, b | (1 << 31))


def admission_order(res_q: torch.Tensor, pkey: torch.Tensor,
                    enq_wave: torch.Tensor, n_res: int) -> tuple:
    """The fused ranking (:func:`repro.core.vdes.admission_order`, over the
    rows of ``[R, N]`` keys): ONE stable ``torch.sort`` of the int64 key
    packing ``(resource, pkey, enq_wave)`` (:func:`fused_key_widths`;
    pipeline-id ties resolved by stability). ``res_q`` lies in ``[0,
    n_res]`` and ``enq_wave`` in ``[0, 2**enq_wave_bits)``. Returns
    ``(sorted resources [R, N] i64, permutation [R, N])``."""
    wbits = fused_key_widths(n_res)[1]
    key = ((res_q.to(torch.int64) << (PKEY_BITS + wbits))
           | (_ordered_bits(pkey) << wbits) | enq_wave.to(torch.int64))
    key_s, o = torch.sort(key, dim=1, stable=True)
    return key_s >> (PKEY_BITS + wbits), o


def admission_order_chained(res_q: torch.Tensor, pkey: torch.Tensor,
                            enq_wave: torch.Tensor, n_res: int = 0) -> tuple:
    """The chained ranking (:func:`repro.core.vdes.admission_order_chained`):
    three stable argsorts, by ``enq_wave``, then the (canonical) ``pkey``,
    then the resource. ``n_res`` is unused (the fused ranking's
    signature)."""
    o = torch.sort(enq_wave, dim=1, stable=True).indices
    pk = _canonical_pkey(pkey).gather(1, o)
    o = o.gather(1, torch.sort(pk, dim=1, stable=True).indices)
    o = o.gather(1, torch.sort(res_q.gather(1, o), dim=1,
                               stable=True).indices)
    return res_q.gather(1, o), o


def admission_mask_ranked(rank: Callable, res_q: torch.Tensor,
                          pkey: torch.Tensor, enq_wave: torch.Tensor,
                          free: torch.Tensor) -> torch.Tensor:
    """The admitted ``[R, N]`` mask from a ranking ``rank``
    (:func:`admission_order` or :func:`admission_order_chained`): a job's
    seat is its position within its resource's segment of the sorted
    order, and ``admitted = seat < free[res]`` (the sentinel resource has
    no free slot), scattered back through the permutation. Comparisons, a
    running max and integer differences only."""
    R, N = res_q.shape
    n_res = free.shape[1]
    r_s, o = rank(res_q, pkey, enq_wave, n_res)
    pos = torch.arange(N, dtype=torch.int64, device=res_q.device)
    is_start = torch.ones_like(r_s, dtype=torch.bool)
    is_start[:, 1:] = r_s[:, 1:] != r_s[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    free_ext = torch.cat([free, free.new_zeros((R, 1))], dim=1)
    admit_sorted = (pos - seg_start) < free_ext.gather(1, r_s.to(torch.int64))
    return torch.zeros_like(admit_sorted).scatter(1, o, admit_sorted)


@dataclasses.dataclass(frozen=True)
class VWorkload:
    """Device-resident workload tensors (one replica). ``attempts`` is the
    pre-sampled service-attempt count per task for failure/retry scenarios
    (None = one attempt each)."""

    arrival: torch.Tensor    # [N] f32
    n_tasks: torch.Tensor    # [N] i32
    task_res: torch.Tensor   # [N, T] i32
    service: torch.Tensor    # [N, T] f32
    priority: torch.Tensor   # [N] f32
    attempts: Optional[torch.Tensor] = None   # [N, T] i32

    @staticmethod
    def from_workload(wl: M.Workload, platform: Optional[M.PlatformConfig] = None,
                      attempts: Optional[np.ndarray] = None,
                      device=None) -> "VWorkload":
        platform = platform or M.PlatformConfig()
        dev = resolve_device(device)

        def t(x, dt):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)

        return VWorkload(
            arrival=t(wl.arrival, torch.float32),
            n_tasks=t(wl.n_tasks, torch.int32),
            task_res=t(wl.task_res, torch.int32),
            service=t(wl.service_time(platform.datastore), torch.float32),
            priority=t(wl.priority, torch.float32),
            attempts=None if attempts is None
            else t(attempts, torch.int32),
        )


def simulate(vwl: VWorkload, capacities, policy: int = POLICY_FIFO,
             cap_times=None, cap_vals=None, backoff=None,
             attempt_service=None, policy_dyn=None,
             n_attempt_slots: Optional[int] = None,
             controller=None, fail_holds_frac=None,
             admission_sort: str = "kernel",
             n_ctrl_slots: Optional[int] = None,
             fleet=None, trig=None, obs_noise=None, drift_inc=None,
             pool_gain=None, pool_base=None, n_pool_eff=None,
             probe=None, n_probe_slots: Optional[int] = None,
             rel_times=None, rel_deltas=None,
             n_rel_slots: Optional[int] = None,
             resume=None, wave_budget=None, time_budget=None,
             return_state: bool = False, device=None) -> dict:
    """Run one replica: :func:`simulate_ensemble` with ``R = 1``. Returns
    start/finish/ready ``[N, T]`` (f32; NaN where a task does not exist or
    never ran), attempts, done and the wave count, plus the buffers of the
    stages that are on.

    ``cap_times [K]`` / ``cap_vals [K, nres]`` give a piecewise-constant
    capacity schedule (``cap_times[0]`` must be 0; ``capacities`` is
    ignored when given). ``backoff`` is the ``(base, mult, cap)`` retry
    delay triple. ``attempt_service [N, T, A]`` gives per-attempt service
    times (attempt ``k`` runs slot ``min(k, A-1)``). ``policy_dyn`` (an int)
    overrides ``policy``. With ``n_attempt_slots = A`` the per-attempt
    ``att_start``/``att_finish [N, T, A]`` are recorded too.
    ``fail_holds_frac`` makes a *failing* attempt hold its slot for only
    that fraction of its service time. ``controller [C]``, the fleet group
    (``fleet [M, 6]``, ``trig``, ``obs_noise``/``drift_inc [E, M]``,
    ``pool_gain [P]``, ``pool_base``, ``n_pool_eff``), ``probe`` and
    ``rel_times [RV]`` / ``rel_deltas [RV, nres]`` are one replica's rows of
    :func:`simulate_ensemble`'s stage inputs.

    Segment-restart hooks, as in the reference: ``resume`` (the ``state``
    of an earlier ``return_state=True`` call), ``wave_budget`` (an int: stop
    once the wave counter reaches it), ``time_budget`` (a float: stop
    before any wave whose next-event time exceeds it) and ``return_state``
    (adds ``state``, ``running`` and ``n_keep``). Stopping at a wave
    boundary and resuming from the state is bit for bit the uncut run."""

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    if resume is not None:
        resume = {k: v[None] for k, v in resume.items()}

    res = simulate_ensemble(
        one(vwl.arrival), one(vwl.n_tasks), one(vwl.task_res),
        one(vwl.service), one(vwl.priority), one(capacities), policy,
        attempts=one(vwl.attempts), cap_times=one(cap_times),
        cap_vals=one(cap_vals), backoff=one(backoff),
        policies=one(policy_dyn), attempt_service=one(attempt_service),
        n_attempt_slots=n_attempt_slots, controllers=one(controller),
        fail_holds_frac=one(fail_holds_frac), admission_sort=admission_sort,
        n_ctrl_slots=n_ctrl_slots, fleets=one(fleet), trig=one(trig),
        obs_noise=one(obs_noise), drift_inc=one(drift_inc),
        pool_gain=one(pool_gain), pool_base=one(pool_base),
        n_pool_eff=one(n_pool_eff), probes=one(probe),
        n_probe_slots=n_probe_slots, rel_times=one(rel_times),
        rel_deltas=one(rel_deltas), n_rel_slots=n_rel_slots, resume=resume,
        wave_budget=one(wave_budget), time_budget=one(time_budget),
        return_state=return_state, device=device)
    out = {k: v[0] for k, v in res.items() if k != "state"}
    if return_state:
        out["state"] = {k: v[0] for k, v in res["state"].items()}
    return out


def simulate_to_trace(wl: M.Workload, platform: Optional[M.PlatformConfig] = None,
                      policy: int = POLICY_FIFO, scenario=None,
                      fleet=None, probe=None, reliability=None,
                      device=None) -> M.SimTrace:
    """Convenience: numpy Workload in, SimTrace out (single replica).
    ``scenario`` is a :class:`repro_torch.ops.scenario.CompiledScenario`;
    ``fleet`` a :class:`repro_torch.ops.scenario.CompiledFleet` (``wl`` must
    then be the extended workload carrying the latent retraining-pool rows);
    ``probe`` a :class:`repro_torch.obs.probes.CompiledProbe`;
    ``reliability`` a
    :class:`repro_torch.reliability.compile.CompiledReliability`."""
    from repro_torch.core.des import (ctrl_tick_bound, fleet_trace_columns,
                                      unpack_ctrl_actions, unpack_rel_actions)
    platform = platform or M.PlatformConfig()
    att_start = att_finish = None
    ctrl_times = ctrl_caps = None

    def host(x, dtype=np.float64):
        return x.cpu().numpy().astype(dtype)

    fl = fleet
    if fl is not None and float(np.asarray(fl.trig)[TRIG_INTERVAL]) <= 0.0:
        fl = None
    stage_kw = {}
    if fl is not None:
        stage_kw = dict(fleet=fl.fleet, trig=fl.trig, obs_noise=fl.obs_noise,
                        drift_inc=fl.drift_inc, pool_gain=fl.pool_gain,
                        pool_base=int(fl.pool_base))
    pr = probe
    if pr is not None and \
            float(np.asarray(pr.header)[PROBE_INTERVAL]) <= 0.0:
        pr = None
    if pr is not None:
        hdr = np.asarray(pr.header, np.float32).copy()
        hdr[PROBE_N_MODELS] = np.float32(fl.n_models if fl is not None else 0)
        stage_kw.update(probe=hdr, n_probe_slots=int(pr.n_ticks))
    rel = reliability
    if rel is not None and int(np.asarray(rel.times).shape[0]) == 0:
        rel = None
    if rel is not None:
        stage_kw.update(rel_times=np.asarray(rel.times, np.float32),
                        rel_deltas=np.asarray(rel.deltas, np.int32),
                        n_rel_slots=int(np.asarray(rel.times).shape[0]))
    if scenario is not None:
        vwl = VWorkload.from_workload(wl, platform, attempts=scenario.attempts,
                                      device=device)
        att_svc = scenario.attempt_service
        ctrl = scenario.controller
        frac = float(scenario.fail_holds_frac)
        slots = int(max(np.max(scenario.attempts), 1,
                        att_svc.shape[2] if att_svc is not None else 1))
        if slots == 1:   # no retries: single-attempt records already exact
            slots = None
        n_ctrl = ctrl_tick_bound(ctrl) if ctrl is not None else 0
        res = simulate(vwl, platform.capacities, policy,
                       cap_times=scenario.cap_times,
                       cap_vals=scenario.cap_vals,
                       backoff=scenario.backoff, attempt_service=att_svc,
                       n_attempt_slots=slots,
                       controller=None if ctrl is None
                       else np.asarray(ctrl, np.float32),
                       fail_holds_frac=None if frac >= 1.0 else frac,
                       n_ctrl_slots=n_ctrl if n_ctrl > 0 else None,
                       device=device, **stage_kw)
        caps0 = np.asarray(scenario.cap_vals[0], np.int64)
        attempts = host(res["attempts"], np.int64)
        completed = host(res["done"], bool)
        if slots is not None:
            att_start = host(res["att_start"])
            att_finish = host(res["att_finish"])
        if ctrl is not None and \
                float(np.asarray(ctrl)[CTRL_INTERVAL]) > 0.0:
            # enabled controller: realized timeline present (maybe empty)
            nres = int(scenario.cap_vals.shape[1])
            if n_ctrl > 0:
                ctrl_times, ctrl_caps = unpack_ctrl_actions(
                    host(res["ctrl_act"]), int(res["ctrl_n"]))
            else:
                ctrl_times = np.zeros(0, np.float64)
                ctrl_caps = np.zeros((0, nres), np.int64)
    else:
        vwl = VWorkload.from_workload(wl, platform, device=device)
        res = simulate(vwl, platform.capacities, policy, device=device,
                       **stage_kw)
        caps0 = platform.capacities
        attempts = None
        completed = host(res["done"], bool) if fl is not None else None
    arrival_out = np.asarray(wl.arrival, np.float64)
    cols = {}
    if fl is not None:
        arrival_out, cols = fleet_trace_columns(
            fl, arrival_out, host(res["pool_arr"]), host(res["fleet_act"]),
            int(res["fleet_n"]), host(res["fleet_perf"]),
            host(res["fleet_stale"]))
    if pr is not None:
        cols.update(probe_times=np.asarray(pr.times, np.float64),
                    probe_vals=host(res["probe_vals"]))
    if rel is not None:
        rt, rc = unpack_rel_actions(host(res["rel_act"]), int(res["rel_n"]))
        cols.update(rel_times=rt, rel_caps=rc)
    return M.SimTrace(
        start=host(res["start"]), finish=host(res["finish"]),
        ready=host(res["ready"]),
        n_tasks=wl.n_tasks.astype(np.int64),
        task_res=wl.task_res, task_type=wl.task_type,
        arrival=arrival_out,
        capacities=caps0, attempts=attempts, completed=completed,
        att_start=att_start, att_finish=att_finish,
        ctrl_times=ctrl_times, ctrl_caps=ctrl_caps,
        waves=int(res["waves"]), **cols)


def gain_order_bound(trig, n_pool: int) -> int:
    """The most retraining-pool slots one model can hold in any replica of
    a batch: the number of ordered steps the fleet stage takes to add a
    wave's redeploy gains per model in slot order. A model fires at most
    once per drift-evaluation tick, never within ``cooldown_s`` of its last
    fire, and never beyond the pool (``n_pool``). The cooldown bound leaves
    a relative margin of 1e-6 for the f32 rounding of the gap test.
    ``trig`` is the ``[R, TRIG_FIELDS]`` header batch."""
    trig = np.asarray(torch.as_tensor(trig).cpu(), np.float32).reshape(
        -1, TRIG_FIELDS)
    bound = 0
    for row in trig:
        interval = float(row[TRIG_INTERVAL])
        if interval <= 0.0:
            continue
        first, end = float(row[TRIG_T_FIRST]), float(row[TRIG_T_END])
        fires = min(_tick_bound_walk(interval, first, end,
                                     what="trigger evaluation"), n_pool)
        cooldown = float(row[TRIG_COOLDOWN])
        if cooldown > 0.0:
            fires = min(fires, int(np.floor(
                max(end - first, 0.0) / (cooldown * (1.0 - 1e-6)))) + 1)
        bound = max(bound, fires)
    return bound


def simulate_ensemble(arrival, n_tasks, task_res, service, priority,
                      capacities, policy: int = POLICY_FIFO,
                      attempts=None, cap_times=None, cap_vals=None,
                      backoff=None, policies=None, attempt_service=None,
                      n_attempt_slots: Optional[int] = None,
                      controllers=None, fail_holds_frac=None,
                      admission_sort: str = "kernel",
                      n_ctrl_slots: Optional[int] = None,
                      fleets=None, trig=None, obs_noise=None, drift_inc=None,
                      pool_gain=None, pool_base=None, n_pool_eff=None,
                      probes=None, n_probe_slots: Optional[int] = None,
                      rel_times=None, rel_deltas=None,
                      n_rel_slots: Optional[int] = None,
                      resume=None, wave_budget=None, time_budget=None,
                      return_state: bool = False,
                      sync_every: int = 64, device=None) -> dict:
    """arrival: [R, N]; task_res/service: [R, N, T]; capacities: [R, nres].

    Optional per-replica scenario tensors: ``attempts [R, N, T]``,
    ``cap_times [R, K]`` / ``cap_vals [R, K, nres]``, ``backoff [R, 3]``,
    ``attempt_service [R, N, T, A]`` (per-attempt resampled service times),
    ``fail_holds_frac [R]`` (slot-holding fraction of failing attempts) and
    ``policies [R]`` (i32: an admission policy per replica, overriding
    ``policy``). ``n_attempt_slots`` turns on per-attempt start/finish
    recording. Inputs may be numpy arrays or tensors; they are carried to
    ``device`` (``None``: the card) in the engine's dtypes — see
    :func:`repro_torch.core.batching.to_tensors`.

    Stage inputs, batched as the reference batches them:

    - ``controllers [R, C]``: closed-loop ControllerParams rows (an all-zero
      row disables the controller for that replica); ``n_ctrl_slots`` (the
      largest ``ctrl_tick_bound`` in the batch) records each integer-target
      move into ``ctrl_act [R, E, 1+nres]`` with counts ``ctrl_n [R]``;
    - the model lifecycle: ``fleets [R, M, 6]``, ``trig [R, TRIG_FIELDS]``
      (an interval <= 0 row disables the stage), ``obs_noise``/``drift_inc
      [R, E, M]``, ``pool_gain [R, P]``, ``pool_base [R]``, ``n_pool_eff
      [R]``; returns ``fleet_perf``/``fleet_stale [R, E, M]``, ``fleet_act
      [R, 2P, 3]``, ``fleet_n``, ``pool_arr``/``pool_model [R, P]`` and
      ``pool_next``;
    - ``probes [R, PROBE_FIELDS]`` with ``n_probe_slots``: the telemetry
      buffer ``probe_vals [R, E, K]`` and tick counts ``probe_n``;
    - ``rel_times [R, RV]`` / ``rel_deltas [R, RV, nres]`` with
      ``n_rel_slots`` (padding rows at ``INF`` never fire): the fired-event
      buffer ``rel_act [R, RV, 1+nres]`` and counts ``rel_n``.

    ``admission_sort`` is ``"kernel"`` (the CUDA admission kernel; its
    plain version on CPU tensors), ``"dense"`` (the plain version on any
    device — the on-card reference), ``"fused"`` (one stable sort of a
    packed key per wave; refused where the key does not fit, and the run
    raises ``RuntimeError`` if its wave counter outgrows the key's
    ``enq_wave`` field) or ``"chained"`` (three stable argsorts); all
    four give the same outputs bit for bit. ``sync_every`` is the number of waves
    between host reads of the loop condition.

    Segment-restart hooks, per replica as in the reference: ``resume`` (the
    ``state`` dict of an earlier ``return_state=True`` call, its rows
    perhaps gathered by a driver: same keys and dtypes), ``wave_budget
    [R]`` i32 (a replica stops once its wave counter reaches it),
    ``time_budget [R]`` f32 (a replica stops before any wave whose
    next-event time exceeds it) and ``return_state``, which adds the carry
    as ``state``, the budget-free loop condition as ``running [R]`` and the
    count of rows not DONE (padding included) as ``n_keep [R]``. With a
    hook given, the loop condition is read before the first wave, so a
    zero budget dispatches no wave.

    Returns tensors on ``device``: ``start``/``finish``/``ready
    [R, N, T]`` f32, ``attempts [R, N, T]`` i32 (executed admissions),
    ``done [R, N]`` bool, ``waves [R]`` i32, with ``n_attempt_slots``
    ``att_start``/``att_finish [R, N, T, A]``, and the stage buffers above."""
    if int(sync_every) < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    prog = wave_program(
        arrival, n_tasks, task_res, service, priority, capacities, policy,
        attempts=attempts, cap_times=cap_times, cap_vals=cap_vals,
        backoff=backoff, policies=policies, attempt_service=attempt_service,
        n_attempt_slots=n_attempt_slots, controllers=controllers,
        fail_holds_frac=fail_holds_frac, admission_sort=admission_sort,
        n_ctrl_slots=n_ctrl_slots, fleets=fleets, trig=trig,
        obs_noise=obs_noise, drift_inc=drift_inc, pool_gain=pool_gain,
        pool_base=pool_base, n_pool_eff=n_pool_eff, probes=probes,
        n_probe_slots=n_probe_slots, rel_times=rel_times,
        rel_deltas=rel_deltas, n_rel_slots=n_rel_slots, resume=resume,
        wave_budget=wave_budget, time_budget=time_budget, device=device)
    s = prog.state
    # with a hook the condition is read first, as the reference's
    # while_loop does; without one the loop issues the ops it always has
    if not prog.hooked or prog.going(s):
        while True:
            for _ in range(int(sync_every)):
                s = prog.wave(s)
            if not prog.going(s):
                break
    return prog.results(s, return_state)


class WaveProgram(NamedTuple):
    """:func:`simulate_ensemble`'s wave loop as data (:func:`wave_program`):
    the initial ``state`` (a dict of tensors), ``wave(state) -> state``
    (one wave for every replica, a pure function with no host read),
    ``going(state) -> bool`` (the loop condition, one host read),
    ``hooked`` (a segment-restart hook was given, so the condition is read
    before the first wave) and ``results(state, return_state) -> dict``
    (the outputs of :func:`simulate_ensemble`)."""

    state: dict
    wave: Callable[[dict], dict]
    going: Callable[[dict], bool]
    hooked: bool
    results: Callable[[dict, bool], dict]


def wave_program(arrival, n_tasks, task_res, service, priority,
                 capacities, policy: int = POLICY_FIFO,
                 attempts=None, cap_times=None, cap_vals=None,
                 backoff=None, policies=None, attempt_service=None,
                 n_attempt_slots: Optional[int] = None,
                 controllers=None, fail_holds_frac=None,
                 admission_sort: str = "kernel",
                 n_ctrl_slots: Optional[int] = None,
                 fleets=None, trig=None, obs_noise=None, drift_inc=None,
                 pool_gain=None, pool_base=None, n_pool_eff=None,
                 probes=None, n_probe_slots: Optional[int] = None,
                 rel_times=None, rel_deltas=None,
                 n_rel_slots: Optional[int] = None,
                 resume=None, wave_budget=None, time_budget=None,
                 device=None) -> WaveProgram:
    """The set-up of :func:`simulate_ensemble` (its arguments but
    ``return_state`` and ``sync_every``): the inputs carried to ``device``,
    the initial state and the six stages, returned as a
    :class:`WaveProgram`. ``wave`` is what a tracer or a graph capture
    takes whole (``repro_torch.analysis.jaxpr_audit`` traces it)."""
    dev = resolve_device(device)
    if admission_sort not in ADMISSION_SORTS:
        raise ValueError(f"unknown admission_sort {admission_sort!r}; "
                         f"expected one of {ADMISSION_SORTS}")
    if (cap_times is None) != (cap_vals is None):
        raise ValueError("cap_times and cap_vals must be given together")
    f32, i32 = torch.float32, torch.int32

    def t(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev).contiguous()

    arrival = t(arrival, f32)
    n_tasks = t(n_tasks, i32)
    task_res = t(task_res, i32)
    service = t(service, f32)
    priority = t(priority, f32)
    R, N, T = task_res.shape
    if cap_times is None:
        cap_times = torch.zeros((R, 1), dtype=f32, device=dev)
        cap_vals = t(capacities, i32)[:, None, :]
    cap_times, cap_vals = t(cap_times, f32), t(cap_vals, i32)
    K, nres = cap_vals.shape[1], cap_vals.shape[2]
    bo = t(_NO_RETRY_BACKOFF if backoff is None else backoff, f32)
    bo = bo.expand(R, 3) if bo.dim() == 1 else bo
    bo0, bo1, bo2 = bo[:, 0:1], bo[:, 1:2], bo[:, 2:3]
    att_req = (torch.ones((R, N, T), dtype=i32, device=dev)
               if attempts is None else t(attempts, i32).clamp(min=1))
    pol = None if policies is None else t(policies, i32)[:, None]
    frac = None if fail_holds_frac is None else t(fail_holds_frac, f32)[:, None]
    if attempt_service is not None:
        asvc = t(attempt_service, f32)
        A_svc = asvc.shape[3]
        asvc = asvc.reshape(R, N, T * A_svc)
    rows = torch.arange(R, device=dev)
    ar_T = torch.arange(T, dtype=i32, device=dev)
    ar_res = torch.arange(nres, dtype=i32, device=dev)
    admit = {"kernel": fused_admission, "dense": admission_mask_dense,
             "fused": functools.partial(admission_mask_ranked,
                                        admission_order),
             "chained": functools.partial(admission_mask_ranked,
                                          admission_order_chained),
             }[admission_sort]
    wave_bits = (fused_key_widths(nres)[1] if admission_sort == "fused"
                 else None)

    def take(x, col):
        """``x[r, i, col[r, i]]``: the row's current task column."""
        return x.gather(2, col.long()[..., None])[..., 0]

    def per_res(mask, res):
        """``[R, nres]`` count of rows in ``mask`` on each resource (the
        sentinel ``nres`` matches none)."""
        return (mask[..., None] & (res[..., None] == ar_res)).sum(
            1, dtype=i32)

    def onehot(col):
        return col[..., None] == ar_T

    def tick(t_cur, firing, interval, t_end):
        """Advance a tick grid where it fired, exactly as the reference: a
        tick past ``t_end``, or one that cannot advance past the f32 ulp,
        exhausts the grid."""
        t_nxt = t_cur + interval
        return torch.where(
            firing, torch.where((t_nxt > t_end) | (t_nxt <= t_cur), INF,
                                t_nxt), t_cur)

    def first_tick(enabled, t_first, t_end):
        return torch.where(enabled & (t_first <= t_end), t_first, INF)

    aranges = {}

    def arange(n):
        if n not in aranges:
            aranges[n] = torch.arange(n, dtype=i32, device=dev)
        return aranges[n]

    def write_row(buf, idx, firing, row):
        """``buf[r, idx[r]] = row[r]`` where ``firing[r]``, as a dense
        one-hot write (the reference's ``where`` form)."""
        hit = (arange(buf.shape[1]) == idx[:, None]) & firing[:, None]
        return torch.where(hit[..., None], row[:, None, :], buf)

    def onehot_rows(buf, idx, vals):
        """``buf[r, idx[r, p]] = vals[r, p]`` for live indices (unique per
        replica, values >= 0); ``idx == buf.shape[1]`` drops."""
        m = idx[..., None] == arange(buf.shape[1])          # [R, P, A]
        upd = torch.where(m[..., None], vals[:, :, None, :], -INF).amax(1)
        return torch.where(m.any(1)[..., None], upd, buf)

    s = dict(
        phase=torch.full((R, N), _NOT_ARRIVED, dtype=i32, device=dev),
        task_idx=torch.zeros((R, N), dtype=i32, device=dev),
        t_next=arrival.clone(),
        enq_wave=torch.zeros((R, N), dtype=i32, device=dev),
        attempt=torch.zeros((R, N), dtype=i32, device=dev),
        free=cap_vals[:, 0].clone(),
        cap_idx=torch.ones((R,), dtype=i32, device=dev),
        wave=torch.zeros((R,), dtype=i32, device=dev),
        start=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        finish=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        ready=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        att_out=torch.zeros((R, N, T), dtype=i32, device=dev),
    )
    if n_attempt_slots is not None:
        for k in ("att_start", "att_finish"):
            s[k] = torch.full((R, N, T, n_attempt_slots), float("nan"),
                              dtype=f32, device=dev)
        ar_A = torch.arange(n_attempt_slots, dtype=i32, device=dev)
    wb = None if wave_budget is None else t(wave_budget, i32).reshape(R)
    tb = None if time_budget is None else t(time_budget, f32).reshape(R)
    hooked = resume is not None or wb is not None or tb is not None

    base_keys = set(s)

    def nan_buf(*shape):
        return torch.full(shape, float("nan"), dtype=f32, device=dev)

    has_ctrl = controllers is not None
    rec_ctrl = has_ctrl and n_ctrl_slots is not None and n_ctrl_slots > 0
    if has_ctrl:
        (c_interval, c_cooldown, c_first, c_end, c_high, c_low, c_step,
         c_min, c_max, c_base) = unpack_controller(t(controllers, f32))
        c_enabled = c_interval > 0.0                          # [R]
        base_i = torch.round(c_base).to(i32)                  # [R, nres]
        s["ctrl_cap"] = c_base.clone()                        # continuous
        s["ctrl_tgt"] = base_i.clone()                        # integer
        s["t_eval"] = first_tick(c_enabled, c_first, c_end)
        s["t_act"] = torch.full((R,), -INF, dtype=f32, device=dev)
    if rec_ctrl:
        s["ctrl_act"] = nan_buf(R, n_ctrl_slots, 1 + nres)
        s["ctrl_n"] = torch.zeros((R,), dtype=i32, device=dev)

    has_rel = rel_times is not None and n_rel_slots is not None \
        and n_rel_slots > 0
    if has_rel:
        rel_t = t(rel_times, f32)                             # [R, RV]
        rel_d = t(rel_deltas, i32)                            # [R, RV, nres]
        RV = n_rel_slots
        s["rel_idx"] = torch.zeros((R,), dtype=i32, device=dev)
        s["rel_cum"] = torch.zeros((R, nres), dtype=i32, device=dev)
        s["rel_act"] = nan_buf(R, RV, 1 + nres)
        s["rel_n"] = torch.zeros((R,), dtype=i32, device=dev)

    has_fleet = trig is not None
    if has_fleet:
        trig_t = t(trig, f32)
        f_interval, f_cooldown, f_first, f_end, f_thr, f_delay = (
            trig_t[:, i] for i in (TRIG_INTERVAL, TRIG_COOLDOWN, TRIG_T_FIRST,
                                   TRIG_T_END, TRIG_THRESHOLD, TRIG_DELAY))
        f_enabled = f_interval > 0.0
        fleet_t = t(fleets, f32)                              # [R, M, 6]
        M_ = fleet_t.shape[1]
        obs_t = t(obs_noise, f32)                             # [R, E, M]
        inc_t = t(drift_inc, f32)                             # [R, E, M]
        gain_t = t(pool_gain, f32)                            # [R, P]
        P = gain_t.shape[1]
        E_f = obs_t.shape[1]
        A_f = max(2 * P, 1)       # triggers + redeploys both bounded by P
        pbase = t(pool_base, i32).reshape(R)
        peff = (torch.full((R,), P, dtype=i32, device=dev)
                if n_pool_eff is None else t(n_pool_eff, i32).reshape(R))
        seasons = seasonal_terms(fleet_t, xp=torch)
        n_gain_steps = max(gain_order_bound(trig_t, P), 1)
        ar_G = torch.arange(n_gain_steps, dtype=i32, device=dev)
        ar_P = torch.arange(P, dtype=i32, device=dev)
        ar_M = torch.arange(M_, dtype=i32, device=dev)
        s["fl_perf0"] = fleet_t[..., FLEET_PERF0].clone()
        # the largest rank a done slot took within its model, checked
        # against n_gain_steps after the loop (a rank at or above it would
        # match no column of the ordered fold and lose its gain)
        s["gain_rank"] = torch.full((R,), -1, dtype=i32, device=dev)
        s["fl_dep"] = torch.zeros((R, M_), dtype=f32, device=dev)
        s["fl_acc"] = torch.zeros((R, M_), dtype=f32, device=dev)
        s["fl_dep_tick"] = torch.full((R, M_), -1, dtype=i32, device=dev)
        s["fl_fire"] = torch.full((R, M_), -INF, dtype=f32, device=dev)
        s["t_fleet"] = first_tick(f_enabled, f_first, f_end)
        s["f_tick"] = torch.zeros((R,), dtype=i32, device=dev)
        s["pool_model"] = torch.full((R, P), -1, dtype=i32, device=dev)
        s["pool_next"] = torch.zeros((R,), dtype=i32, device=dev)
        s["pool_arr"] = nan_buf(R, P)
        s["redeployed"] = torch.zeros((R, P), dtype=torch.bool, device=dev)
        s["fleet_perf"] = nan_buf(R, E_f, M_)
        s["fleet_stale"] = nan_buf(R, E_f, M_)
        s["fleet_act"] = nan_buf(R, A_f, 3)     # (time, kind, model id)
        s["fleet_n"] = torch.zeros((R,), dtype=i32, device=dev)

    has_probe = probes is not None and n_probe_slots is not None \
        and n_probe_slots > 0
    if has_probe:
        probe_t = t(probes, f32)
        p_interval = probe_t[:, PROBE_INTERVAL]
        p_end = probe_t[:, PROBE_T_END]
        p_models = torch.round(probe_t[:, PROBE_N_MODELS]).to(i32)
        p_enabled = p_interval > 0.0
        E_p = n_probe_slots
        s["t_probe"] = first_tick(p_enabled, probe_t[:, PROBE_T_FIRST], p_end)
        s["p_tick"] = torch.zeros((R,), dtype=i32, device=dev)
        s["probe_vals"] = nan_buf(R, E_p, probe_channel_count(nres))
        no_delta = torch.zeros((R, nres), dtype=i32, device=dev)
        no_fleet = nan_buf(R)

    # ------------------------------------------------------------ stages

    def _select_events(s):
        """Stage 1: the per-replica next-event time over task events, the
        next scheduled capacity change, the next reliability event and the
        controller, fleet and probe ticks."""
        ci = s["cap_idx"]
        t_cap = torch.where(
            ci < K, cap_times.gather(1, ci.clamp(0, K - 1).long()[:, None])[:, 0],
            INF)
        t_star = torch.minimum(s["t_next"].amin(1), t_cap)
        if has_rel:
            ri = s["rel_idx"]
            t_rel = torch.where(
                ri < RV, rel_t.gather(1, ri.clamp(0, RV - 1).long()[:, None])[:, 0],
                INF)
            t_star = torch.minimum(t_star, t_rel)
        if has_ctrl:
            t_star = torch.minimum(t_star, s["t_eval"])
        if has_fleet:
            t_star = torch.minimum(t_star, s["t_fleet"])
        if has_probe:
            t_star = torch.minimum(t_star, s["t_probe"])
        return t_star, t_cap

    def _running(s, t_star):
        # exit when everything is done OR nothing can ever happen again;
        # remaining fleet and probe ticks keep a replica alive (controller
        # ticks and reliability events do not)
        alive = (s["phase"] != _DONE).any(1)
        if has_fleet:
            alive = alive | (s["t_fleet"] < INF)
        if has_probe:
            alive = alive | (s["t_probe"] < INF)
        return alive & (t_star < INF)

    def _go(s, t_star):
        """The loop condition under the budgets: a wave boundary is a
        consistent cut, so a replica stopped here resumes bit for bit."""
        go = _running(s, t_star)
        if wb is not None:
            go = go & (s["wave"] < wb)
        if tb is not None:
            go = go & (t_star <= tb)
        return go

    def _completion_stage(s, ts):
        """Stage 2: finishes release slots; failed attempts re-enter the
        arrival path after their backoff delay; successful ones advance the
        pipeline; arrivals and successor tasks enqueue."""
        phase, task_idx, t_next = s["phase"], s["task_idx"], s["t_next"]
        finishing = (phase == _RUNNING) & (t_next == ts)
        arriving = (phase == _NOT_ARRIVED) & (t_next == ts)
        tcl0 = task_idx.clamp(0, T - 1)
        s["free"] = s["free"] + per_res(finishing, take(task_res, tcl0))

        att = s["attempt"]
        retrying = finishing & (att + 1 < take(att_req, tcl0))
        succeeding = finishing & ~retrying
        delay = torch.minimum(bo0 * torch.pow(bo1, att.to(f32)), bo2)

        task_idx = task_idx + succeeding.to(i32)
        att = torch.where(retrying, att + 1, torch.where(succeeding, 0, att))
        done_now = succeeding & (task_idx >= n_tasks)
        to_queue = (succeeding & ~done_now) | arriving
        s["phase"] = torch.where(
            done_now, _DONE,
            torch.where(to_queue, _QUEUED,
                        torch.where(retrying, _NOT_ARRIVED, phase)))
        s["t_next"] = torch.where(succeeding | arriving, INF,
                                  torch.where(retrying, ts + delay, t_next))
        s["enq_wave"] = torch.where(to_queue, s["wave"][:, None],
                                    s["enq_wave"])
        s["task_idx"], s["attempt"] = task_idx, att
        s["ready"] = torch.where(
            onehot(task_idx.clamp(0, T - 1)) & to_queue[..., None],
            ts[..., None], s["ready"])

    def _control_stage(s, t_star, t_cap, t_st):
        """Stage 3: the pending scheduled capacity change applies, then the
        pending reliability event applies its capacity delta and is
        recorded, then the closed-loop controller observes the live queue
        lengths and moves capacity (the two at ``t_st``, see ``wave``)."""
        ci = s["cap_idx"]
        cap_changing = (t_cap == t_star) & (ci < K)
        hi = ci.clamp(0, K - 1).long()
        lo = (ci - 1).clamp(0, K - 1).long()
        free = s["free"] + torch.where(
            cap_changing[:, None], cap_vals[rows, hi] - cap_vals[rows, lo], 0)
        cap_idx = ci + cap_changing.to(i32)
        if has_rel:
            # drain semantics, as a scheduled decrease; applied before the
            # controller evaluates, so it sees post-outage capacity
            ri = s["rel_idx"].clamp(0, RV - 1).long()
            rel_firing = (s["rel_idx"] < RV) & (rel_t[rows, ri] == t_st)
            drow = torch.where(rel_firing[:, None], rel_d[rows, ri], 0)
            free = free + drow
            rel_cum = s["rel_cum"] + drow
            # record (t, cumulative delta); cumulative deltas can be
            # negative, so a where-write, not onehot_rows
            rrow = torch.cat([t_st[:, None], rel_cum.to(f32)], 1)
            s["rel_act"] = write_row(s["rel_act"],
                                     s["rel_n"].clamp(max=RV - 1),
                                     rel_firing, rrow)
            s["rel_n"] = torch.clamp(s["rel_n"] + rel_firing.to(i32), max=RV)
            s["rel_cum"] = rel_cum
            s["rel_idx"] = s["rel_idx"] + rel_firing.to(i32)
        if has_ctrl:
            firing = c_enabled & (s["t_eval"] == t_st)
            queued = s["phase"] == _QUEUED
            tcl = s["task_idx"].clamp(0, T - 1)
            qlen = per_res(queued, take(task_res, tcl))
            sched_now = cap_vals[rows, (cap_idx - 1).clamp(0, K - 1).long()]
            cap_eff = sched_now + s["ctrl_tgt"] - base_i
            if has_rel:
                cap_eff = cap_eff + s["rel_cum"]
            per_slot = qlen.to(f32) / cap_eff.clamp(min=1).to(f32)
            can_act = firing & (t_st - s["t_act"] >= c_cooldown)
            cap_f = s["ctrl_cap"]
            new_cap = torch.where(
                per_slot > c_high, cap_f * (1.0 + c_step),
                torch.where(per_slot < c_low, cap_f * (1.0 - c_step), cap_f))
            new_cap = torch.where(
                can_act[:, None], torch.clamp(new_cap, min=c_min, max=c_max),
                cap_f)
            new_tgt = torch.round(new_cap).to(i32)
            changed = can_act & (new_cap != cap_f).any(1)
            if rec_ctrl:
                # an integer-target move is a provisioning action: append
                # (t, target) to the realized timeline
                tgt_changed = can_act & (new_tgt != s["ctrl_tgt"]).any(1)
                row = torch.cat([t_st[:, None], new_tgt.to(f32)], 1)
                s["ctrl_act"] = write_row(
                    s["ctrl_act"], s["ctrl_n"].clamp(max=n_ctrl_slots - 1),
                    tgt_changed, row)
                s["ctrl_n"] = torch.clamp(s["ctrl_n"] + tgt_changed.to(i32),
                                          max=n_ctrl_slots)
            free = free + (new_tgt - s["ctrl_tgt"])
            s["ctrl_cap"], s["ctrl_tgt"] = new_cap, new_tgt
            s["t_act"] = torch.where(changed, t_st, s["t_act"])
            s["t_eval"] = tick(s["t_eval"], firing, c_interval, c_end)
        s["free"], s["cap_idx"] = free, cap_idx

    def _admission_stage(s, ts):
        """Stage 4: one ranked admission round per resource, recording
        start/finish for admitted attempts."""
        att = s["attempt"]
        tcl = s["task_idx"].clamp(0, T - 1)
        queued = s["phase"] == _QUEUED
        res_q = torch.where(queued, take(task_res, tcl), nres)   # sentinel
        if attempt_service is None:
            svc = take(service, tcl)
        else:
            svc = take(asvc, tcl * A_svc + att.clamp(0, A_svc - 1))
        if pol is not None:
            pkey = torch.where(pol == POLICY_PRIORITY, -priority,
                               torch.where(pol == POLICY_SJF, svc, 0.0))
        elif policy == POLICY_PRIORITY:
            pkey = -priority
        elif policy == POLICY_SJF:
            pkey = svc
        else:
            pkey = torch.zeros((R, N), dtype=f32, device=dev)
        admitted = admit(res_q, pkey, s["enq_wave"], s["free"]) & queued

        # a failing attempt (known at admission from the pre-sampled attempt
        # tensor) may hold its slot for only a fraction of the service time
        if frac is None:
            dur = svc
        else:
            will_fail = (att + 1) < take(att_req, tcl)
            dur = torch.where(will_fail, frac * svc, svc)
        t_fin = ts + dur
        adm_col = onehot(tcl) & admitted[..., None]
        s["t_next"] = torch.where(admitted, t_fin, s["t_next"])
        s["phase"] = torch.where(admitted, _RUNNING, s["phase"])
        s["start"] = torch.where(adm_col, ts[..., None], s["start"])
        s["finish"] = torch.where(adm_col, t_fin[..., None], s["finish"])
        # executed attempts: a task stranded mid-retry reports the
        # admissions that actually happened
        s["att_out"] = s["att_out"] + adm_col.to(i32)
        s["free"] = s["free"] - per_res(admitted, res_q)
        if n_attempt_slots is not None:
            ka = att.clamp(0, n_attempt_slots - 1)
            adm_slot = adm_col[..., None] & (ka[..., None, None] == ar_A)
            s["att_start"] = torch.where(adm_slot, ts[..., None, None],
                                         s["att_start"])
            s["att_finish"] = torch.where(adm_slot, t_fin[..., None, None],
                                          s["att_finish"])

    def _redeploy(s, ts, active):
        """Retraining-pool pipelines that completed this wave redeploy
        their model: drift state resets, the slot's presampled gain
        applies, and the redeploy joins the action buffer."""
        p_done = ((s["phase"].gather(1, pool_rows) == _DONE)
                  & (s["pool_model"] >= 0) & ~s["redeployed"] & pool_live)
        if hooked:
            # a replica stopped by a budget, unlike one that finished, has
            # events at its next time: the completion stage (its result
            # dropped) may finish a pool row, whose redeploy must wait for
            # the wave that commits it
            p_done = p_done & active[:, None]
        mdl = s["pool_model"].clamp(0, max(M_ - 1, 0))
        own = p_done[..., None] & (mdl[..., None] == ar_M)     # [R, P, M]
        hit = own.any(1)
        # per-model f32 sum of the done slots' gains in slot order (the
        # reference's order): column k of by_rank holds each model's k-th
        # done slot's gain (a sum over slots with at most one nonzero term,
        # exact in any reduction order), and the columns add in order
        rank = own.to(i32).cumsum(1, dtype=i32) - 1
        kth = torch.where(own[..., None] & (rank[..., None] == ar_G),
                          gain_t[:, :, None, None], 0.0)
        # one nonzero term per sum, the proof above
        by_rank = kth.sum(1)  # parity: allow(loop-reduce)
        gain_m = by_rank[..., 0]
        for k in range(1, n_gain_steps):
            gain_m = gain_m + by_rank[..., k]
        s["gain_rank"] = torch.maximum(
            s["gain_rank"], torch.where(own, rank, -1).amax((1, 2)))
        s["fl_perf0"] = torch.where(
            hit, torch.clamp(s["fl_perf0"] + gain_m, 0.4, 0.995),
            s["fl_perf0"])
        s["fl_dep"] = torch.where(hit, ts, s["fl_dep"])
        s["fl_acc"] = torch.where(hit, 0.0, s["fl_acc"])
        s["fl_dep_tick"] = torch.where(hit, s["f_tick"][:, None],
                                       s["fl_dep_tick"])
        s["redeployed"] = s["redeployed"] | p_done
        rk = p_done.to(i32).cumsum(1, dtype=i32) - 1
        idx = torch.where(p_done, s["fleet_n"][:, None] + rk, A_f)
        vals = torch.stack([ts.expand(R, P), kind_redeploy,
                            s["pool_model"].to(f32)], -1)
        s["fleet_act"] = onehot_rows(s["fleet_act"], idx, vals)
        s["fleet_n"] = s["fleet_n"] + p_done.sum(1, dtype=i32)

    def _fleet_stage(s, t_star, active):
        """Stage 5: the model lifecycle. Retraining-pool pipelines that
        completed this wave redeploy their model (any wave, not just
        ticks); at a drift-evaluation tick the [R, M] drift algebra runs,
        the performance/staleness timelines record, and triggers whose
        observed drift crosses the threshold (outside their cooldown)
        activate latent pool pipelines. f32 arithmetic, op for op the
        reference's. An empty pool (``max_retrains=0``) triggers nothing."""
        ts = t_star[:, None]
        if P:
            _redeploy(s, ts, active)
        # ---- drift-evaluation tick
        firing = f_enabled & (s["t_fleet"] == t_star)
        e = s["f_tick"].clamp(0, E_f - 1)
        el = e.long()
        dt = torch.clamp(ts - s["fl_dep"], min=0.0)
        # drift accrues per COMPLETED interval: dep_tick gates the first
        # accrual after a redeploy (its partial interval is dropped)
        acc_new = torch.where(e[:, None] > s["fl_dep_tick"],
                              s["fl_acc"] + inc_t[rows, el], s["fl_acc"])
        perf = performance_from_terms(s["fl_perf0"], acc_new, dt, *seasons,
                                      xp=torch)
        stale = fleet_staleness(s["fl_perf0"], perf, xp=torch)
        s["fleet_perf"] = write_row(s["fleet_perf"], e, firing, perf)
        s["fleet_stale"] = write_row(s["fleet_stale"], e, firing, stale)
        obs = perf + obs_t[rows, el]
        drift = s["fl_perf0"] - obs
        want = (firing[:, None] & (drift > f_thr[:, None])
                & ((ts - s["fl_fire"]) >= f_cooldown[:, None]))
        rank = want.to(i32).cumsum(1, dtype=i32) - 1
        slot = s["pool_next"][:, None] + rank
        fire = want & (slot < peff[:, None])   # injection budget exhausts
        s["fl_fire"] = torch.where(fire, ts, s["fl_fire"])
        arr_t = t_star + f_delay
        # fired slots are unique per replica (pool_next + distinct ranks)
        m_s = torch.where(fire, slot, P)[..., None] == ar_P    # [R, M, P]
        hit_s = m_s.any(1)
        s["pool_model"] = torch.where(
            hit_s, torch.where(m_s, ar_M[:, None], -1).amax(1),
            s["pool_model"])
        s["pool_arr"] = torch.where(hit_s, arr_t[:, None], s["pool_arr"])
        # activate the latent workload rows: pipeline pool_base + slot
        # arrives at t_star + delay
        if P:
            hit_r = row_in_pool & hit_s.gather(1, row_slot)
            s["t_next"] = torch.where(hit_r, arr_t[:, None], s["t_next"])
        aidx = torch.where(fire, s["fleet_n"][:, None] + rank, A_f)
        avals = torch.stack([ts.expand(R, M_), kind_trigger, model_ids], -1)
        s["fleet_act"] = onehot_rows(s["fleet_act"], aidx, avals)
        n_fire = fire.sum(1, dtype=i32)
        s["fleet_n"] = s["fleet_n"] + n_fire
        s["pool_next"] = s["pool_next"] + n_fire
        s["fl_acc"] = torch.where(firing[:, None], acc_new, s["fl_acc"])
        s["t_fleet"] = tick(s["t_fleet"], firing, f_interval, f_end)
        s["f_tick"] = s["f_tick"] + firing.to(i32)

    def _probe_stage(s, t_star):
        """Stage 6: in-loop telemetry. Runs last in the wave, so it samples
        the settled post-admission/post-fleet state; physics-invisible."""
        firing = p_enabled & (s["t_probe"] == t_star)
        queued = s["phase"] == _QUEUED
        tcl = s["task_idx"].clamp(0, T - 1)
        qlen = per_res(queued, take(task_res, tcl))
        sched_now = cap_vals[rows, (s["cap_idx"] - 1).clamp(0, K - 1).long()]
        delta = s["ctrl_tgt"] - base_i if has_ctrl else no_delta
        rdelta = s["rel_cum"] if has_rel else no_delta
        cap_eff = sched_now + delta + rdelta
        busy = cap_eff - s["free"]                        # running jobs
        if has_fleet:
            # min/max over the entry's own n_models rows (order-independent)
            valid_m = ar_M < p_models[:, None]
            dtp = torch.clamp(t_star[:, None] - s["fl_dep"], min=0.0)
            perf = performance_from_terms(s["fl_perf0"], s["fl_acc"], dtp,
                                          *seasons, xp=torch)
            stale = fleet_staleness(s["fl_perf0"], perf, xp=torch)
            any_m = valid_m.any(1)
            f_perf = torch.where(
                any_m, torch.where(valid_m, perf, INF).amin(1), float("nan"))
            f_stale = torch.where(
                any_m, torch.where(valid_m, stale, -INF).amax(1),
                float("nan"))
        else:
            f_perf = f_stale = no_fleet
        # live-pipelines channel: queued + running pipelines. A bool-count
        # i32 sum is order-independent and exact in f32.
        # parity: allow(probe-reduce)
        live = ((s["phase"] == _QUEUED) | (s["phase"] == _RUNNING)).sum(
            1, dtype=i32)
        row = torch.cat([qlen.to(f32), busy.to(f32), cap_eff.to(f32),
                         delta.to(f32), rdelta.to(f32), f_perf[:, None],
                         f_stale[:, None], live.to(f32)[:, None]], 1)
        s["probe_vals"] = write_row(s["probe_vals"],
                                    s["p_tick"].clamp(0, E_p - 1), firing, row)
        s["t_probe"] = tick(s["t_probe"], firing, p_interval, p_end)
        s["p_tick"] = s["p_tick"] + firing.to(i32)

    if has_fleet:
        # loop invariants of the fleet stage: each slot's workload row, the
        # live slots, each row's slot and the constant action columns
        pool_rows = (pbase[:, None] + ar_P).clamp(0, N - 1).long()
        pool_live = ar_P < peff[:, None]
        off = torch.arange(N, dtype=i32, device=dev) - pbase[:, None]
        row_in_pool = (off >= 0) & (off < P)
        row_slot = off.clamp(0, max(P - 1, 0)).long()
        kind_redeploy = torch.full((R, P), float(FLEET_ACT_REDEPLOY),
                                   dtype=f32, device=dev)
        kind_trigger = torch.full((R, M_), float(FLEET_ACT_TRIGGER),
                                  dtype=f32, device=dev)
        model_ids = ar_M.to(f32).expand(R, M_)

    stage_keys = set(s) - base_keys
    if resume is not None:
        # segment restart: adopt the earlier carry as it is (a driver only
        # gathers, pads or extends rows between segments: same keys, same
        # dtypes)
        s = {k: t(resume[k], v.dtype) for k, v in s.items()}

    # -------------------------------------------------------- wave loop

    def wave(s):
        """One wave for every replica, committed where the replica is still
        running (the vmap-of-while semantics); returns the new state."""
        t_star, t_cap = _select_events(s)
        active = _go(s, t_star)
        new = dict(s)
        ts = t_star[:, None]
        t_st = t_star
        if stage_keys:
            # the stages of a stopped replica (finished, or at its budget)
            # run at a NaN time: it equals no tick or event time, so
            # nothing fires and they leave their own state as it was (no
            # done pool slot waits for its redeploy after a wave; a
            # budget's stop masks the redeploy itself), which therefore
            # needs no commit below
            t_st = torch.where(active, t_star, float("nan"))
        _completion_stage(new, ts)
        _control_stage(new, t_star, t_cap, t_st)
        _admission_stage(new, ts)
        if has_fleet:
            _fleet_stage(new, t_st, active)
        if has_probe:
            _probe_stage(new, t_st)
        new["wave"] = s["wave"] + 1
        return {k: v if k in stage_keys else torch.where(
                    active.view((R,) + (1,) * (v.dim() - 1)), v, s[k])
                for k, v in new.items()}

    def going(s):
        return bool(_go(s, _select_events(s)[0]).any())

    def results(s, return_state):
        res = dict(start=s["start"], finish=s["finish"], ready=s["ready"],
                   attempts=s["att_out"], done=s["phase"] == _DONE,
                   waves=s["wave"])
        if n_attempt_slots is not None:
            res["att_start"] = s["att_start"]
            res["att_finish"] = s["att_finish"]
        if rec_ctrl:
            res["ctrl_act"] = s["ctrl_act"]
            res["ctrl_n"] = s["ctrl_n"]
        if has_rel:
            res["rel_act"] = s["rel_act"]
            res["rel_n"] = s["rel_n"]
        if wave_bits is not None and int(s["wave"].max()) >= 2 ** wave_bits:
            raise RuntimeError(
                f"the run reached wave {int(s['wave'].max())}, beyond the "
                f"fused admission key's {wave_bits} enq_wave bits: its "
                "rankings may be wrong; use admission_sort='chained'")
        if has_fleet:
            top = int(s["gain_rank"].max())
            if top >= n_gain_steps:
                raise RuntimeError(
                    f"a model redeployed {top + 1} retraining-pool slots in "
                    f"one wave, beyond gain_order_bound's {n_gain_steps}: "
                    "their gains were not all added")
            for k in ("fleet_perf", "fleet_stale", "fleet_act", "fleet_n",
                      "pool_arr", "pool_model", "pool_next"):
                res[k] = s[k]
        if has_probe:
            res["probe_vals"] = s["probe_vals"]
            res["probe_n"] = s["p_tick"]
        if return_state:
            res["state"] = s
            # would the loop go on without the budgets?
            res["running"] = _running(s, _select_events(s)[0])
            # rows a driver must keep: padding rows count until their waves
            # run, as dropping them early would change the wave counter
            res["n_keep"] = (s["phase"] != _DONE).sum(1, dtype=i32)
        return res

    return WaveProgram(s, wave, going, hooked, results)
